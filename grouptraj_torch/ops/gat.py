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

:func:`batch_gat` is the batched multi-head GAT of the ``gat-mh`` graph
module (the era-(b) "sgangat-g-*" checkpoints; reference commented
``models.py:296-388``): per-head weights ``w [K, F_in, F_out]``, attention
vectors ``a_src``/``a_dst [K, F_out, 1]`` and a ``bias [F_out]``. Its
quirks are kept: the softmax runs over ALL valid pedestrians of the scene
(no adjacency mask), a non-finite attention value (a scene with no valid
pedestrian) becomes 0, and with ``adj_mode='mix'`` the post-softmax
attention is multiplied by the row-normalised adjacency on the right.
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


def batch_gat_layer(params: dict, x: torch.Tensor, adj_norm: torch.Tensor,
                    valid: torch.Tensor, alpha: float = 0.2,
                    adj_mode: str = "mix") -> torch.Tensor:
    """x [S, N, F_in], adj_norm [S, N, N] row-normalised (zero at padding),
    valid [S, N] -> [S, K, N, F_out]. ``adj_mode``: 'mix' multiplies the
    post-softmax attention by the adjacency (``attn @ adj``), 'none' skips
    it."""
    dt = x.dtype
    h = torch.einsum("snf,kfo->skno", x, params["w"].to(dt))
    src = torch.einsum("skno,koi->skn", h, params["a_src"].to(dt))
    dst = torch.einsum("skno,koi->skn", h, params["a_dst"].to(dt))
    e = torch.nn.functional.leaky_relu(
        src[:, :, :, None] + dst[:, :, None, :], negative_slope=alpha)
    e = e.masked_fill(~(valid[:, None, None, :] > 0), float("-inf"))
    attn = torch.softmax(e, dim=-1)
    attn = torch.where(torch.isfinite(attn), attn, 0.0)
    if adj_mode == "mix":
        attn = torch.einsum("skim,smj->skij", attn, adj_norm)
    elif adj_mode != "none":
        raise ValueError(f"adj_mode must be 'mix' or 'none', got "
                         f"{adj_mode!r}")
    return attn @ h + params["bias"].to(dt)


def _masked_instance_norm(x: torch.Tensor, valid: torch.Tensor,
                          eps: float = 1e-5) -> torch.Tensor:
    """Per-scene, per-feature normalisation over the valid pedestrians
    (``InstanceNorm1d(affine=False)`` on a per-scene ``[1, F, N]`` layout,
    biased variance); zero at padding."""
    v = (valid > 0)[..., None]                              # [S, N, 1]
    cnt = torch.clamp(v.sum(dim=1, keepdim=True), min=1).to(x.dtype)
    mean = torch.where(v, x, 0.0).sum(dim=1, keepdim=True) / cnt
    var = torch.where(v, (x - mean) ** 2, 0.0).sum(dim=1, keepdim=True) / cnt
    return torch.where(v, (x - mean) * torch.rsqrt(var + eps), 0.0)


def batch_gat(params: dict, x: torch.Tensor, adj_norm: torch.Tensor,
              valid: torch.Tensor, alpha: float = 0.2, adj_mode: str = "mix",
              concat_mode: str = "transpose", norm: bool = False
              ) -> torch.Tensor:
    """The stacked batch GAT over ``params["layer_stack"]``: each
    intermediate layer concatenates its heads and applies ELU; the final
    (one-head) layer emits raw features [S, N, F_out]. ``concat_mode``:
    'transpose' concatenates each pedestrian's head features ([K, N, F] ->
    [N, K·F]); 'view' reshapes without transposing, so rows mix
    pedestrians across heads (the reference's commented ``view``).
    ``norm`` applies :func:`_masked_instance_norm` before every layer."""
    if concat_mode not in ("transpose", "view"):
        raise ValueError(f"concat_mode must be 'transpose' or 'view', got "
                         f"{concat_mode!r}")
    S, N = x.shape[:2]
    layers = params["layer_stack"]
    for i, layer in enumerate(layers):
        if norm:
            x = _masked_instance_norm(x, valid)
        out = batch_gat_layer(layer, x, adj_norm, valid, alpha, adj_mode)
        if i + 1 == len(layers):
            x = out[:, 0]                       # final layer: single head
        elif concat_mode == "view":
            x = F.elu(out.reshape(S, N, -1))
        else:
            x = F.elu(out.transpose(1, 2).reshape(S, N, -1))
    return x
