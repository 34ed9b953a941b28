"""Two-level group message passing (counterpart of
``grouptraj/models/modules.py``; reference ``sgan/models.py:239-294``).

Build M_intra from group labels, run the intra GAT over pedestrians, GPool
to one node per effective group (``r @ intra`` with the row-normalised
membership R), run the inter GAT over the complete group graph, GUnpool
with the same normalised R (``einsum('smn,smf->snf')``, which keeps the
reference's double 1/|g| scaling), concat intra‖inter, project.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from grouptraj_torch.ops.gat import gat
from grouptraj_torch.ops.groups import (
    group_membership, inter_group_adjacency, intra_group_adjacency,
    normalize_adjacency,
)
from grouptraj_torch.ops.linear import linear


class GATLayer(nn.Module):
    """Weights of one reference GraphAttentionLayer: ``W [in, out]`` and
    ``a [2·out, 1]``, stored untransposed as the reference stores them."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.W = nn.Parameter(torch.empty(d_in, d_out))
        self.a = nn.Parameter(torch.empty(2 * d_out, 1))
        for p in (self.W, self.a):   # reference models.py:192-195
            bound = 1.414 * math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
            nn.init.uniform_(p, -bound, bound)

    def tree(self) -> dict:
        return {"W": self.W, "a": self.a}


class GAT(nn.Module):
    """Reference GAT: ``attention_{i}`` heads and ``out_att``."""

    def __init__(self, nfeat: int, nhid: int, nclass: int, nheads: int = 1):
        super().__init__()
        self.nheads = nheads
        for i in range(nheads):
            self.add_module(f"attention_{i}", GATLayer(nfeat, nhid))
        self.out_att = GATLayer(nhid * nheads, nclass)

    def tree(self) -> dict:
        return {"attentions": [getattr(self, f"attention_{i}").tree()
                               for i in range(self.nheads)],
                "out_att": self.out_att.tree()}


class GATEncoder(nn.Module):
    """Reference GATEncoder weights: ``gat_intra``, ``gat_inter``,
    ``out_embedding``."""

    def __init__(self, in_dim: int = 40, hidden_dim: int = 72,
                 out_dim: int = 16, final_dim: int = 24, n_heads: int = 1):
        super().__init__()
        self.gat_intra = GAT(in_dim, hidden_dim, out_dim, n_heads)
        self.gat_inter = GAT(out_dim, hidden_dim, out_dim, n_heads)
        self.out_embedding = nn.Linear(2 * out_dim, final_dim)

    def tree(self) -> dict:
        return {"gat_intra": self.gat_intra.tree(),
                "gat_inter": self.gat_inter.tree(),
                "out_embedding": {"w": self.out_embedding.weight.t(),
                                  "b": self.out_embedding.bias}}


def gat_encoder(params: dict, x: torch.Tensor, labels: torch.Tensor,
                valid: torch.Tensor, alpha: float = 0.2) -> torch.Tensor:
    """- x: [S, N, in_dim] per-ped context features
    - labels: [S, N] group label at t_obs; valid: [S, N]
    Returns [S, N, final_dim], zero at invalid peds."""
    intra = gat(params["gat_intra"], x, intra_group_adjacency(labels, valid),
                alpha)
    r_raw, group_valid = group_membership(labels, valid)
    r = normalize_adjacency(r_raw)
    x_group = r @ intra                                     # GPool  [S, M, F]
    y_group = gat(params["gat_inter"], x_group,
                  inter_group_adjacency(group_valid), alpha)
    inter = torch.einsum("smn,smf->snf", r, y_group)        # GUnpool (Rᵀ @ y)
    out = linear(params["out_embedding"], torch.cat([intra, inter], dim=-1))
    return torch.where(valid[..., None] > 0, out, 0.0)
