"""Group message-passing modules (counterpart of
``grouptraj/models/modules.py``):

- :func:`gat_encoder`, the ``gat`` preset's two-level group GAT (reference
  ``sgan/models.py:239-294``): build M_intra from group labels, run the
  intra GAT over pedestrians, GPool to one node per effective group
  (``r @ intra`` with the row-normalised membership R), run the inter GAT
  over the complete group graph, GUnpool with the same normalised R
  (``einsum('smn,smf->snf')``, which keeps the reference's double 1/|g|
  scaling), concat intra‖inter, project;
- :func:`gat_encoder_mh`, the ``gat-mh`` graph module: one batched
  multi-head GAT stack over the row-normalised intra-group adjacency;
- :func:`gcn_module`, the ``gcn`` preset's graph module, the GCN twin of
  :func:`gat_encoder` (reference ``sgan/models.py:583-712``);
- :func:`gcn_pooling`, the ``gcn-pool`` preset's pool-net (the
  reconstruction of the reference's lost GCNPooling), also the decoder's
  per-step pool-net of a ``gcn`` pooling model with
  ``pool_every_timestep``.

The ``nn.Module`` classes hold the weights under the reference's torch
names; the functions take their ``tree()`` views.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from grouptraj_torch.ops.gat import batch_gat, gat
from grouptraj_torch.ops.gcn import gcn
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


class BatchGATLayer(nn.Module):
    """One layer of the batched multi-head GAT: ``w [K, F_in, F_out]``,
    ``a_src``/``a_dst [K, F_out, 1]``, ``bias [F_out]``."""

    def __init__(self, n_head: int, f_in: int, f_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(n_head, f_in, f_out))
        self.a_src = nn.Parameter(torch.empty(n_head, f_out, 1))
        self.a_dst = nn.Parameter(torch.empty(n_head, f_out, 1))
        self.bias = nn.Parameter(torch.zeros(f_out))
        for p in (self.w, self.a_src, self.a_dst):  # per-head xavier, 1.414
            bound = 1.414 * math.sqrt(6.0 / (p.shape[1] + p.shape[2]))
            nn.init.uniform_(p, -bound, bound)

    def tree(self) -> dict:
        return {"w": self.w, "a_src": self.a_src, "a_dst": self.a_dst,
                "bias": self.bias}


class BatchGAT(nn.Module):
    """The layer stack (``layer_stack.{i}``); layer i maps
    ``n_units[i] · n_heads[i-1]`` features to ``n_units[i+1]`` with
    ``n_heads[i]`` heads."""

    def __init__(self, n_units, n_heads):
        super().__init__()
        self.layer_stack = nn.ModuleList(
            BatchGATLayer(n_heads[i],
                          n_units[i] * n_heads[i - 1] if i else n_units[i],
                          n_units[i + 1])
            for i in range(len(n_units) - 1))

    def tree(self) -> dict:
        return {"layer_stack": [layer.tree() for layer in self.layer_stack]}


class GATEncoderMH(nn.Module):
    """The ``gat-mh`` graph module's weights: ``gat_net``."""

    def __init__(self, n_units=(40, 16, 40), n_heads=(4, 1)):
        super().__init__()
        self.gat_net = BatchGAT(list(n_units), list(n_heads))

    def tree(self) -> dict:
        return {"gat_net": self.gat_net.tree()}


class GCN(nn.Module):
    """Dense GCN weights ``W.{i}`` ([in, out], standard normal as the
    reference's raw ``torch.randn`` entries)."""

    def __init__(self, input_dim: int, hidden_dim: int, out_dim: int,
                 gcn_layers: int = 2):
        super().__init__()
        dims = ([input_dim] + [hidden_dim] * (gcn_layers - 1) + [out_dim]
                if gcn_layers > 1 else [input_dim, out_dim])
        self.W = nn.ParameterList(
            nn.Parameter(torch.randn(d_in, d_out))
            for d_in, d_out in zip(dims[:-1], dims[1:]))

    def tree(self) -> dict:
        return {"W": list(self.W)}


class GCNModule(nn.Module):
    """The ``gcn`` graph module's weights: ``gcn_intra`` in→hidden→out,
    ``gcn_inter`` out→hidden→out, ``out_embedding`` 2·out→final."""

    def __init__(self, input_dim: int = 40, hidden_dim: int = 72,
                 out_dim: int = 16, gcn_layers: int = 2,
                 final_dim: int = 24):
        super().__init__()
        self.gcn_intra = GCN(input_dim, hidden_dim, out_dim, gcn_layers)
        self.gcn_inter = GCN(out_dim, hidden_dim, out_dim, gcn_layers)
        self.out_embedding = nn.Linear(2 * out_dim, final_dim)

    def tree(self) -> dict:
        return {"gcn_intra": self.gcn_intra.tree(),
                "gcn_inter": self.gcn_inter.tree(),
                "out_embedding": {"w": self.out_embedding.weight.t(),
                                  "b": self.out_embedding.bias}}


def gcn_module(params: dict, x: torch.Tensor, labels: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """The ``gcn`` graph module: :func:`gat_encoder`'s two levels with a
    GCN at each, the intra GCN over the row-normalised intra-group
    adjacency and the inter GCN over the row-normalised complete group
    graph. x [S, N, in] -> [S, N, final], zero at invalid peds."""
    a_intra = normalize_adjacency(intra_group_adjacency(labels, valid))
    intra = gcn(params["gcn_intra"], a_intra, x)
    r_raw, group_valid = group_membership(labels, valid)
    r = normalize_adjacency(r_raw)
    x_group = r @ intra                                     # GPool  [S, M, F]
    a_inter = normalize_adjacency(inter_group_adjacency(group_valid))
    y_group = gcn(params["gcn_inter"], a_inter, x_group)
    inter = torch.einsum("smn,smf->snf", r, y_group)        # GUnpool (Rᵀ @ y)
    out = linear(params["out_embedding"], torch.cat([intra, inter], dim=-1))
    return torch.where(valid[..., None] > 0, out, 0.0)


class GCNPooling(nn.Module):
    """The ``gcn-pool`` pool-net's weights: ``spatial_embedding`` 2→E, the
    intra and inter GCNs (E+H)→hidden→bottleneck, ``out_embedding``
    2·bottleneck→bottleneck."""

    def __init__(self, embedding_dim: int = 16, h_dim: int = 32,
                 hidden_dim: int = 72, bottleneck_dim: int = 8,
                 gcn_layers: int = 2):
        super().__init__()
        in_dim = embedding_dim + h_dim
        self.spatial_embedding = nn.Linear(2, embedding_dim)
        self.gcn_pooling_net_intra = GCN(in_dim, hidden_dim, bottleneck_dim,
                                         gcn_layers)
        self.gcn_pooling_net_inter = GCN(in_dim, hidden_dim, bottleneck_dim,
                                         gcn_layers)
        self.out_embedding = nn.Linear(2 * bottleneck_dim, bottleneck_dim)

    def tree(self) -> dict:
        lin = lambda m: {"w": m.weight.t(), "b": m.bias}
        return {"spatial_embedding": lin(self.spatial_embedding),
                "gcn_pooling_net_intra": self.gcn_pooling_net_intra.tree(),
                "gcn_pooling_net_inter": self.gcn_pooling_net_inter.tree(),
                "out_embedding": lin(self.out_embedding)}


def gat_encoder_mh(params: dict, x: torch.Tensor, labels: torch.Tensor,
                   valid: torch.Tensor, alpha: float = 0.2,
                   adj_mode: str = "mix", concat_mode: str = "transpose",
                   norm: bool = False) -> torch.Tensor:
    """The ``gat-mh`` graph module: the batched multi-head GAT stack over
    the row-normalised intra-group adjacency, zero at invalid peds. x
    [S, N, n_units[0]] -> [S, N, n_units[-1]]; the generator follows it
    with ``mlp_decoder_context``."""
    a_intra = normalize_adjacency(intra_group_adjacency(labels, valid))
    out = batch_gat(params["gat_net"], x, a_intra, valid, alpha, adj_mode,
                    concat_mode, norm)
    return torch.where(valid[..., None] > 0, out, 0.0)


def gcn_pooling(params: dict, h: torch.Tensor, last_rel: torch.Tensor,
                labels: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The ``gcn-pool`` pool-net, with the JAX package's recovered
    semantics: per-ped features are the spatial embedding of the LAST
    RELATIVE step beside the encoder state ``[S, N, E+H]``; BOTH GCNs run
    over the row-normalised intra-group adjacency; ``[intra ‖ inter]`` goes
    through ``out_embedding``; zero at invalid peds. h [S, N, H], last_rel
    [S, N, 2] -> [S, N, bottleneck]."""
    v = valid[..., None]
    x = torch.cat([linear(params["spatial_embedding"], last_rel * v), h],
                  dim=-1)
    a_intra = normalize_adjacency(intra_group_adjacency(labels, valid))
    intra = gcn(params["gcn_pooling_net_intra"], a_intra, x)
    inter = gcn(params["gcn_pooling_net_inter"], a_intra, x)
    out = linear(params["out_embedding"], torch.cat([intra, inter], dim=-1))
    return torch.where(v > 0, out, 0.0)
