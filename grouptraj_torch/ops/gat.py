"""Masked dense graph attention, batched over scenes (counterpart of
``grouptraj/ops/gat.py``; reference ``sgan/models.py:184-237``).

The attention logit ``leakyrelu(a · [Wh_i ‖ Wh_j])`` is computed as
``leakyrelu(a₁·Wh_i + a₂·Wh_j)``. Quirks kept for checkpoint parity:
- masked logits get the reference's −9e15 fill before the row softmax;
- LeakyReLU slope ``alpha``;
- ELU after each concatenated head; the out layer skips it and the
  module-level ELU applies instead;
- the module ends in **log_softmax over the feature dim**.
Differentiable by plain autograd; attention dropout (``dropout1``) is not
ported, so the training step refuses a config that sets it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gat_layer(params: dict, x: torch.Tensor, adj_mask: torch.Tensor,
              alpha: float = 0.2, concat: bool = True) -> torch.Tensor:
    """x [S, N, F], adj_mask [S, N, N] bool -> [S, N, F']. Rows whose mask
    is empty softmax to uniform garbage and are masked by the caller."""
    Wh = x @ params["W"].to(x.dtype)
    F_out = Wh.shape[-1]
    a = params["a"].to(x.dtype)
    e = F.leaky_relu((Wh @ a[:F_out, 0])[:, :, None]
                     + (Wh @ a[F_out:, 0])[:, None, :], negative_slope=alpha)
    e = e.masked_fill(~adj_mask, -9e15)
    h = torch.softmax(e, dim=-1) @ Wh
    return F.elu(h) if concat else h


def gat(params: dict, x: torch.Tensor, adj_mask: torch.Tensor,
        alpha: float = 0.2) -> torch.Tensor:
    """Full GAT module: multi-head concat, out layer, ELU, feature
    log_softmax."""
    x = torch.cat([gat_layer(p, x, adj_mask, alpha, True)
                   for p in params["attentions"]], dim=-1)
    x = F.elu(gat_layer(params["out_att"], x, adj_mask, alpha, False))
    return torch.log_softmax(x, dim=-1)
