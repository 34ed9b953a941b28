"""PoolHiddenNet social pooling as one masked dense batched op (counterpart
of ``grouptraj/ops/pooling.py``; reference ``sgan/models.py:458-549``).

Per scene, for each pedestrian i, pool over all pedestrians j (including
i) of ``mlp(embed(p_j − p_i) ‖ h_j)`` with an elementwise max. The pre-pool
MLP's hidden width 512 is hardcoded as in the reference, and — because
make_mlp activates after every Linear — its output is post-ReLU.

Implementations (``impl``), all computing the same function:
- ``pair``: the reference-shaped ``[S, N, N, E+H]`` path, the oracle;
- ``fast``: the decomposition — every map before the first ReLU is affine,
  so with ``u = p @ (We W1e)`` and ``a_j = u_j + h_j @ W1h + (be W1e + b1)``
  the first layer is ``z_ij = a_j − u_i`` and only the pair core
  ``max_j(relu(relu(a_j − u_i) @ W2 + b2))`` stays N²; the core runs as
  plain PyTorch (:func:`pool_core`);
- ``kernel``: the same decomposition with the core in the hand-written
  CUDA kernels (:mod:`grouptraj_torch.ops.cuda_pool`, forward and
  backward joined by its ``PoolCore`` autograd function); on CPU tensors
  those wrappers run :func:`pool_core` and :func:`pool_core_bwd_plain`.
  Its product runs in float32 or, as the TPU kernel does at JAX's default
  matmul precision, on bfloat16 operands: :mod:`grouptraj_torch.ops.
  precision` selects the mode, read once a call;
- ``auto``: ``kernel`` for CUDA tensors, ``fast`` otherwise.

All four are differentiable: ``pair`` and ``fast`` by autograd (``amax``
splits a cotangent evenly among ties, as the kernels do), ``kernel`` by
``PoolCore``. The per-pedestrian ``a``/``u`` are two plain matmuls outside
any kernel, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from grouptraj_torch.ops.linear import linear, mlp_forward
from grouptraj_torch.ops.precision import use_bf16

_NEG = -1e9  # mask value for the max (forward-exact for post-ReLU features)
IMPLS = ("pair", "fast", "kernel", "auto")


def pool_hidden_net(params: dict, h: torch.Tensor, end_pos: torch.Tensor,
                    valid: torch.Tensor, activation: str = "relu",
                    batch_norm: bool = False, impl: str = "auto"
                    ) -> torch.Tensor:
    """- h: [S, N, H] hidden states
    - end_pos: [S, N, 2] pooling anchor positions
    - valid: [S, N] {0,1}
    Returns pool_h [S, N, bottleneck] (zeros at invalid i).
    """
    if impl not in IMPLS:
        raise ValueError(f"pool impl {impl!r} is not one of {IMPLS}")
    decomposable = (impl != "pair" and activation == "relu"
                    and not batch_norm
                    and len(params["mlp_pre_pool"]["layers"]) == 2)
    if decomposable:
        return _pool_fast(params, h, end_pos, valid, impl)
    rel = end_pos[:, None, :, :] - end_pos[:, :, None, :]   # p_j − p_i
    rel_emb = linear(params["spatial_embedding"], rel)       # [S, N, N, E]
    hj = h[:, None, :, :].expand(*rel_emb.shape[:3], h.shape[-1])
    feat = mlp_forward(params["mlp_pre_pool"],
                       torch.cat([rel_emb, hj], dim=-1), activation,
                       batch_norm)
    pair_mask = (valid[:, :, None] * valid[:, None, :]) > 0
    feat = feat.masked_fill(~pair_mask[..., None], _NEG)
    pooled = feat.amax(dim=2)                                 # max over j
    return torch.where(valid[..., None] > 0, pooled, 0.0)


def _pool_fast(params: dict, h: torch.Tensor, end_pos: torch.Tensor,
               valid: torch.Tensor, impl: str) -> torch.Tensor:
    """Decomposed PoolHiddenNet: per-ped ``a``/``u`` feed the N²-only core.
    W2/b2 reach the core in the weights' own dtype (the kernel upcasts
    bfloat16 in-kernel). The kernel route takes the precision setting's
    mode (``use_bf16()``) as it stands at this call."""
    We = params["spatial_embedding"]["w"].float()             # [2, E]
    be = params["spatial_embedding"]["b"].float()
    l1, l2 = params["mlp_pre_pool"]["layers"]
    W1 = l1["linear"]["w"].float()                            # [E+H, 512]
    b1 = l1["linear"]["b"].float()
    W2 = l2["linear"]["w"].contiguous()                       # [512, B]
    b2 = l2["linear"]["b"]
    E = We.shape[1]
    Wu = We @ W1[:E]                                          # [2, 512]
    cvec = be @ W1[:E] + b1                                   # [512]
    u = end_pos @ Wu                                          # [S, N, 512]
    a = u + h @ W1[E:] + cvec                                 # [S, N, 512]
    if impl == "kernel" or (impl == "auto" and a.is_cuda):
        from grouptraj_torch.ops.cuda_pool import PoolCore
        pooled, _ = PoolCore.apply(a[None], u[None], W2[None], b2[None],
                                   valid[None].float(), use_bf16())
        pooled = pooled[0]
    else:
        pooled, _ = pool_core(a, u, W2, b2, valid)
    return torch.where(valid[..., None] > 0, pooled, 0.0)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16 (to nearest, ties to even, as JAX's
    ``astype(jnp.bfloat16)``) and back to its own dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def pool_core(a: torch.Tensor, u: torch.Tensor, W2: torch.Tensor,
              b2: torch.Tensor, valid: torch.Tensor, bf16: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """N²-pair core of the decomposed pool, plain PyTorch:
    ``pooled = max_j(mask_j(relu(relu(a_j − u_i) @ W2 + b2)))`` and the tie
    count ``cnt`` = the number of j (masked entries included) whose value
    equals that max — the residual the kernel's backward divides by.

    a/u ``[..., S, N, K]``, W2 ``[..., K, B]``, b2 ``[..., B]``, valid
    ``[..., S, N]`` with matching (or broadcastable) leading replica dims
    -> (pooled, cnt) ``[..., S, N, B]`` in a's dtype. Rows at invalid i hold the
    masked max; callers re-mask them. With ``bf16`` both operands of the
    product, ``relu(a_j − u_i)`` and W2, are rounded to bfloat16 first (the
    TPU kernel's mode at JAX's default matmul precision); their products
    are then exact in float32 and only the sums round."""
    W2, b2 = W2.to(a.dtype), b2.to(a.dtype)
    h1 = torch.relu(a.unsqueeze(-3) - u.unsqueeze(-2))        # [.., S, i, j, K]
    if bf16:
        h1, W2 = _bf16(h1), _bf16(W2)
    o = torch.relu(h1 @ W2.unsqueeze(-3).unsqueeze(-3)
                   + b2[..., None, None, None, :])            # [.., S, i, j, B]
    del h1
    o = o.masked_fill(~(valid[..., None, :, None] > 0), _NEG)
    pooled = o.amax(dim=-2)
    cnt = (o == pooled.unsqueeze(-2)).sum(dim=-2, dtype=a.dtype)
    return pooled, cnt


def pool_core_bwd_plain(a: torch.Tensor, u: torch.Tensor, W2: torch.Tensor,
                        b2: torch.Tensor, valid: torch.Tensor,
                        pooled: torch.Tensor, cnt: torch.Tensor,
                        dpool: torch.Tensor,
                        ties: Optional[torch.Tensor] = None,
                        debug: Optional[dict] = None, bf16: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """Backward of :func:`pool_core`, plain PyTorch, by the backward
    kernel's formula: with ``o`` recomputed as the forward computes it,

        gd  = dpool / max(cnt, 1)
        dq  = gd · [o == pooled] · valid_j · [o > 0] · valid_i
        dh1 = dq @ W2ᵀ,  dz = dh1 · [z > 0]
        da_j = Σ_i dz,  du_i = −Σ_j dz,  dW2 = Σ h1ᵀ dq,  db2 = Σ dq

    per replica -> (da, du ``[..., S, N, K]``, dW2 ``[..., K, B]``, db2
    ``[..., B]``). ``pooled`` and ``cnt`` must come from :func:`pool_core`
    on the same inputs (the equality is exact only against the same
    arithmetic); rows at invalid i carry no gradient whatever ``dpool``
    holds there. ``ties`` (bool ``[..., S, N, N, B]`` over (i, j, b))
    replaces the ``[o == pooled]`` selection — how a comparison hands this
    function the selection another implementation of the forward made.
    ``debug``, when a dict, receives ``ties`` (the selection used, masks
    applied) and ``recount`` (the number of valid j with ``o == pooled``).
    With ``bf16`` the forward is recomputed in its bfloat16 mode and, as
    the TPU kernel's backward does, ``dq`` and W2 are rounded to bfloat16
    for ``dh1``, ``h1`` and ``dq`` for ``dW2``; ``db2`` sums the unrounded
    ``dq``, and ``dz``, ``da`` and ``du`` stay float32."""
    W2, b2 = W2.to(a.dtype), b2.to(a.dtype)
    vj = valid[..., None, :, None] > 0                        # [.., S, 1, j, 1]
    vi = valid[..., :, None, None] > 0                        # [.., S, i, 1, 1]
    z = a.unsqueeze(-3) - u.unsqueeze(-2)                     # [.., S, i, j, K]
    h1 = torch.relu(z)
    if bf16:
        h1, W2 = _bf16(h1), _bf16(W2)
    o = torch.relu(h1 @ W2.unsqueeze(-3).unsqueeze(-3)
                   + b2[..., None, None, None, :])            # [.., S, i, j, B]
    eq = (o == pooled.unsqueeze(-2)) & vj
    sel = (eq if ties is None else ties) & vj & vi & (o > 0)
    if debug is not None:
        debug["ties"] = sel
        debug["recount"] = eq.sum(dim=-2, dtype=a.dtype)
    gd = dpool / torch.clamp(cnt, min=1.0)
    dq = gd.unsqueeze(-2) * sel                               # [.., S, i, j, B]
    dqr = _bf16(dq) if bf16 else dq
    dz = (dqr @ W2.unsqueeze(-3).unsqueeze(-3).transpose(-1, -2)) * (z > 0)
    da = dz.sum(dim=-3)
    du = -dz.sum(dim=-2)
    K, B = W2.shape[-2:]
    lead = W2.shape[:-2]
    dW2 = h1.reshape(*lead, -1, K).transpose(-1, -2) \
        @ dqr.reshape(*lead, -1, B)
    db2 = dq.reshape(*lead, -1, B).sum(dim=-2)
    return da, du, dW2, db2
