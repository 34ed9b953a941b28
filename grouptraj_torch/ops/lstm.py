"""Single-layer LSTM recurrences with hand-written backwards (counterpart
of ``grouptraj/ops/lstm.py``).

Torch gate order (i, f, g, o), weights ``[in, 4H]`` / ``[H, 4H]`` as in the
JAX package. Three routes compute every recurrence, chosen by ``impl``
(:func:`select_impl` resolves it from ``TrainConfig.lstm_impl``):

- ``'scan'`` (the default, and what ``'auto'`` resolves to): plain Python
  loops over time with fused-gate matmuls, in the folded forms the JAX scan
  path runs — the encoder's spatial embedding folded into the input gates
  (:func:`encoder_recurrence`) and the decoder's embedding and hidden2pos
  into one recurrent matrix (:func:`decoder_first_step`,
  :func:`decoder_proj_recurrence`). Each is a ``torch.autograd.Function``
  with the JAX package's backward algebra: the forward saves only the
  per-step ``(h_prev, c_prev)`` (and the inputs), the reverse loop
  recomputes the gates from them and accumulates every weight gradient as
  it goes, so no ``[T, B, 4H]`` gate slab is ever kept. When no argument
  needs a gradient (``torch.no_grad()``: the best-of-k probe decode, the
  d-step's generator forward, serving) the plain loop runs and nothing is
  saved. The Functions are written in the ``setup_context`` form with
  ``generate_vmap_rule``, so they run under ``torch.func.vmap`` (the seed
  axis of ``train/multi.py``): forward and backward are batched as they
  stand, and an argument's need for a gradient is read through vmap's
  wrappers (:func:`_wants_grad`).
- ``'fused'``: the whole time loop in one kernel launch
  (:mod:`grouptraj_torch.ops.cuda_lstm`: K3 forward, K4 backward, the
  counterpart of ``grouptraj/ops/pallas_fused.py``). :func:`lstm_scan`
  forms ``gx = xs @ w_ih + b`` with one matmul and hands the recurrent half
  to the kernel; the folded decoder hands it ``(w_eff, b_eff, h1, c1)``.
  On CUDA tensors the kernels always run; on CPU tensors their plain
  versions below do (:func:`lstm_recurrence_fused_plain`,
  :func:`decoder_recurrence_fused_plain`, :func:`fused_recurrence_bwd_plain`
  — the backward from SAVED post-activation gates and cell states, as the
  kernels do it, not from a recomputed z).
- ``'pallas'``: the LSTM with its input projection inside the kernel
  (:mod:`grouptraj_torch.ops.cuda_lstm_proj`: K5 forward, K6 backward, the
  counterpart of ``grouptraj/ops/pallas_lstm.py``). :func:`lstm_scan`
  hands it xs and both weight matrices; no gx slab is formed. It changes
  the encoders only: the decoder stays on the scan route's folded
  recurrence, as in the JAX package. On CPU tensors the kernels' plain
  versions run (:func:`lstm_proj_fwd_plain`, :func:`lstm_proj_bwd_plain`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable


def _gate_acts(z: torch.Tensor, H: int):
    return (torch.sigmoid(z[..., 0 * H:1 * H]),
            torch.sigmoid(z[..., 1 * H:2 * H]),
            torch.tanh(z[..., 2 * H:3 * H]),
            torch.sigmoid(z[..., 3 * H:4 * H]))


def lstm_gates(z: torch.Tensor, c: torch.Tensor, H: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-activation gates z [..., 4H] and cell c [..., H] -> (h', c')."""
    i, f, g, o = _gate_acts(z, H)
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def lstm_cell(params: dict, x: torch.Tensor, h: torch.Tensor,
              c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step, plain autograd (the stepwise decoder's cell). x
    [B, in], h/c [B, H] -> (h', c'). The gates sum in the JAX package's
    order, ``x W_ih + h W_hh + (b_ih + b_hh)``."""
    gates = x @ params["w_ih"] + h @ params["w_hh"] + (
        params["b_ih"] + params["b_hh"])
    return lstm_gates(gates, c, h.shape[-1])


def _gates_bwd(z, c_prev, dh, dc_in, H):
    """One step of the gate backward, gates recomputed from z: returns
    (dz [B, 4H], dc chained to c_prev, h of this step)."""
    i, f, g, o = _gate_acts(z, H)
    tc = torch.tanh(f * c_prev + i * g)
    do = dh * tc
    dc = dc_in + dh * o * (1.0 - tc * tc)
    dz = torch.cat([dc * g * i * (1.0 - i), dc * c_prev * f * (1.0 - f),
                    dc * i * (1.0 - g * g), do * o * (1.0 - o)], dim=-1)
    return dz, dc * f, o * tc


def _requires_grad(t: torch.Tensor) -> bool:
    """``t.requires_grad``, read on the tensor under vmap's batching
    wrappers (a wrapper itself reports False)."""
    while torch._C._functorch.is_batchedtensor(t):
        t = torch._C._functorch.get_unwrapped(t)
    return t.requires_grad


def _batched(*tensors) -> bool:
    """Whether any of ``tensors`` is batched by ``torch.func.vmap``."""
    return any(torch._C._functorch.is_batchedtensor(t) for t in tensors)


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(_requires_grad(t)
                                           for t in tensors)


# ------------------------------------------------------------------ encoder

def _encoder_loop(w_comp, b_comp, w_hh, xs, keep):
    H = w_hh.shape[0]
    h = xs.new_zeros((xs.shape[1], H))
    c = h
    for x in xs:
        if keep is not None:
            keep.append((h, c))
        h, c = lstm_gates(x @ w_comp + b_comp + h @ w_hh, c, H)
    return h, c


def _stacked(keep):
    """The per-step (h, c) a forward kept -> (hs, cs) ``[T, B, H]``."""
    return (torch.stack([h for h, _ in keep]),
            torch.stack([c for _, c in keep]))


# Each Function returns the states its backward needs as extra outputs
# (hs, cs), marked non-differentiable: the setup_context form sees only
# inputs and outputs. The backwards accumulate out of place, so an
# accumulator that starts unbatched under vmap takes batched terms.

class _EncoderRecurrence(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(w_comp, b_comp, w_hh, xs):
        keep = []
        hT, cT = _encoder_loop(w_comp, b_comp, w_hh, xs, keep)
        return (hT, cT, *_stacked(keep))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, *output[2:])
        ctx.mark_non_differentiable(*output[2:])

    @staticmethod
    @once_differentiable
    def backward(ctx, dh, dc, _dhs, _dcs):
        w_comp, b_comp, w_hh, xs, hs, cs = ctx.saved_tensors
        T, H = xs.shape[0], w_hh.shape[0]
        dwc, dwh = torch.zeros_like(w_comp), torch.zeros_like(w_hh)
        db = torch.zeros_like(b_comp)
        dxs = [None] * T
        for t in reversed(range(T)):
            z = xs[t] @ w_comp + b_comp + hs[t] @ w_hh    # recompute
            dz, dc, _ = _gates_bwd(z, cs[t], dh, dc, H)
            dh = dz @ w_hh.t()
            dwh = dwh + hs[t].t() @ dz
            dwc = dwc + xs[t].t() @ dz
            db = db + dz.sum(dim=0)
            dxs[t] = dz @ w_comp.t()
        return dwc, db, dwh, torch.stack(dxs)


def encoder_recurrence(w_comp: torch.Tensor, b_comp: torch.Tensor,
                       w_hh: torch.Tensor, xs: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoder leg with the folded embedding: ``z_t = x_t @ w_comp + b_comp
    + h @ w_hh`` from zero state over raw xs [T, B, 2] -> (hT, cT)."""
    if _wants_grad(w_comp, b_comp, w_hh, xs):
        return _EncoderRecurrence.apply(w_comp, b_comp, w_hh, xs)[:2]
    return _encoder_loop(w_comp, b_comp, w_hh, xs, None)


# ------------------------------------------------------- decoder, first step

def _first_step(w_r, b1c, w_hh, w_p, b_p, x0, h0):
    H = h0.shape[-1]
    z = x0 @ w_r + h0 @ w_hh + b1c
    h1, c1 = lstm_gates(z, torch.zeros_like(h0), H)
    return h1, c1, h1 @ w_p + b_p


class _DecoderFirstStep(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(w_r, b1c, w_hh, w_p, b_p, x0, h0):
        return _first_step(w_r, b1c, w_hh, w_p, b_p, x0, h0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        w_r, b1c, w_hh, w_p, _, x0, h0 = inputs
        ctx.save_for_backward(w_r, b1c, w_hh, w_p, x0, h0)

    @staticmethod
    @once_differentiable
    def backward(ctx, dh1, dc1, dy1):
        w_r, b1c, w_hh, w_p, x0, h0 = ctx.saved_tensors
        H = h0.shape[-1]
        z = x0 @ w_r + h0 @ w_hh + b1c                    # recompute
        dh = dh1 + dy1 @ w_p.t()
        # c_prev = 0 kills the forget gate's term
        dz, _, h1 = _gates_bwd(z, torch.zeros_like(h0), dh, dc1, H)
        return (x0.t() @ dz, dz.sum(dim=0), h0.t() @ dz, h1.t() @ dy1,
                dy1.sum(dim=0), dz @ w_r.t(), dz @ w_hh.t())


def decoder_first_step(w_r, b1c, w_hh, w_p, b_p, x0, h0):
    """One step from a zero cell with a distinct input path, plus the
    hidden2pos projection: ``z = x0 @ w_r + h0 @ w_hh + b1c``,
    ``(h1, c1) = gates(z, 0)``, ``y1 = h1 @ w_p + b_p`` -> (h1, c1, y1)."""
    args = (w_r, b1c, w_hh, w_p, b_p, x0, h0)
    if _wants_grad(*args):
        return _DecoderFirstStep.apply(*args)
    return _first_step(*args)


# -------------------------------------------------- decoder, folded recurrence

def _proj_loop(w_eff, b_eff, w_p, b_p, h, c, T, keep):
    H = h.shape[-1]
    ys = []
    for _ in range(T):
        if keep is not None:
            keep.append((h, c))
        h, c = lstm_gates(h @ w_eff + b_eff, c, H)
        ys.append(h @ w_p + b_p)
    return torch.stack(ys)


class _DecoderProjRecurrence(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(w_eff, b_eff, w_p, b_p, h1, c1, T):
        keep = []
        ys = _proj_loop(w_eff, b_eff, w_p, b_p, h1, c1, T, keep)
        return (ys, *_stacked(keep))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:3], *output[1:])
        ctx.mark_non_differentiable(*output[1:])
        ctx.T = inputs[-1]

    @staticmethod
    @once_differentiable
    def backward(ctx, dys, _dhs, _dcs):
        w_eff, b_eff, w_p, hs, cs = ctx.saved_tensors
        T, H = ctx.T, w_eff.shape[0]
        dw, db = torch.zeros_like(w_eff), torch.zeros_like(b_eff)
        dwp = torch.zeros_like(w_p)
        dbp = dys.new_zeros(w_p.shape[1])
        dh, dc = torch.zeros_like(hs[0]), torch.zeros_like(cs[0])
        for t in reversed(range(T)):
            z = hs[t] @ w_eff + b_eff                     # recompute
            dh = dh + dys[t] @ w_p.t()
            dz, dc, h2 = _gates_bwd(z, cs[t], dh, dc, H)
            dwp = dwp + h2.t() @ dys[t]
            dbp = dbp + dys[t].sum(dim=0)
            dh = dz @ w_eff.t()
            dw = dw + hs[t].t() @ dz
            db = db + dz.sum(dim=0)
        return dw, db, dwp, dbp, dh, dc, None


def decoder_proj_recurrence(w_eff, b_eff, w_p, b_p, h1, c1, T: int
                            ) -> torch.Tensor:
    """T steps of the folded decoder (``gates = h @ w_eff + b_eff``) with
    hidden2pos fused into each step -> ys [T, B, 2]."""
    if _wants_grad(w_eff, b_eff, w_p, b_p, h1, c1):
        return _DecoderProjRecurrence.apply(w_eff, b_eff, w_p, b_p, h1, c1,
                                            T)[0]
    return _proj_loop(w_eff, b_eff, w_p, b_p, h1, c1, T, None)


# ------------------------------------------------ recurrence over given gx

def _recurrence_loop(w_hh, gx, h, c, keep):
    H = w_hh.shape[0]
    ys = []
    for g in gx:
        if keep is not None:
            keep.append((h, c))
        h, c = lstm_gates(g + h @ w_hh, c, H)
        ys.append(h)
    return torch.stack(ys), h, c


class _LstmRecurrence(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(w_hh, gx, h0, c0):
        keep = []
        out = _recurrence_loop(w_hh, gx, h0, c0, keep)
        return (*out, *_stacked(keep))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], inputs[1], *output[3:])
        ctx.mark_non_differentiable(*output[3:])

    @staticmethod
    @once_differentiable
    def backward(ctx, dys, dh, dc, _dhs, _dcs):
        w_hh, gx, hs, cs = ctx.saved_tensors
        T, H = gx.shape[0], w_hh.shape[0]
        dw = torch.zeros_like(w_hh)
        dgx = [None] * T
        for t in reversed(range(T)):
            z = gx[t] + hs[t] @ w_hh                      # recompute
            dz, dc, _ = _gates_bwd(z, cs[t], dh + dys[t], dc, H)
            dh = dz @ w_hh.t()
            dw = dw + hs[t].t() @ dz
            dgx[t] = dz
        return dw, torch.stack(dgx), dh, dc


def lstm_recurrence(w_hh: torch.Tensor, gx: torch.Tensor, h0: torch.Tensor,
                    c0: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Recurrent half of an LSTM with precomputed input gates, the scan
    route: gx [T, B, 4H] already holds ``x_t @ W_ih + b`` ->
    (ys [T, B, H], hT, cT)."""
    if _wants_grad(w_hh, gx, h0, c0):
        return _LstmRecurrence.apply(w_hh, gx, h0, c0)[:3]
    return _recurrence_loop(w_hh, gx, h0, c0, None)


IMPLS = ("scan", "fused", "pallas")


def select_impl(cfg, tcfg) -> str:
    """The LSTM route of a training run from ``TrainConfig``: ``'scan'``,
    ``'fused'`` and ``'pallas'`` (also ``use_pallas``) are honoured on
    every device, and ``'auto'`` resolves to ``'scan'`` (as in the JAX
    package, which also demotes the kernel routes to ``'scan'`` off the
    TPU; the port runs their kernels on CUDA tensors and their plain
    versions on CPU tensors)."""
    impl = getattr(tcfg, "lstm_impl", "auto")
    if getattr(tcfg, "use_pallas", False):
        impl = "pallas"
    return impl if impl in IMPLS else "scan"


def lstm_scan(params: dict, xs: torch.Tensor,
              h0: Optional[torch.Tensor] = None,
              c0: Optional[torch.Tensor] = None, impl: str = "scan"
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Run the LSTM over time. xs [T, B, in] -> (ys [T, B, H], (hT, cT)),
    zero initial state by default. On ``'scan'`` and ``'fused'`` the
    input-gate products of ALL steps are one ``[T·B, in] @ [in, 4H]``
    matmul, and ``'fused'`` runs the recurrent half in the whole-loop
    kernel; ``'pallas'`` computes the projection inside its kernel, step by
    step, and answers in float32."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    B, H = xs.shape[1], params["w_hh"].shape[0]
    if h0 is None:
        h0 = xs.new_zeros((B, H))
    if c0 is None:
        c0 = xs.new_zeros((B, H))
    if impl == "pallas":
        from grouptraj_torch.ops.cuda_lstm_proj import lstm_scan_proj
        return lstm_scan_proj(params, xs, h0, c0)
    gx = xs @ params["w_ih"] + (params["b_ih"] + params["b_hh"])
    if impl == "fused":
        from grouptraj_torch.ops.cuda_lstm import lstm_recurrence_fused
        return lstm_recurrence_fused(params["w_hh"], gx, h0, c0)
    ys, hT, cT = lstm_recurrence(params["w_hh"], gx, h0, c0)
    return ys, (hT, cT)


# ------------------------------- plain versions of the whole-loop kernels

def _fused_fwd_plain(w, gx, b, h, c, T, save):
    """``z_t = gx_t + h_{t-1} @ w + b``, either of gx and b None."""
    H = w.shape[0]
    ys, gates, cs = [], [], []
    for t in range(T):
        z = h @ w
        if gx is not None:
            z = gx[t] + z
        if b is not None:
            z = z + b
        i, f, g, o = _gate_acts(z, H)
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h)
        if save:
            gates.append(torch.cat([i, f, g, o], dim=-1))
            cs.append(c)
    if save:
        return torch.stack(ys), h, c, torch.stack(gates), torch.stack(cs)
    return torch.stack(ys), h, c, None, None


def lstm_recurrence_fused_plain(w_hh: torch.Tensor, gx: torch.Tensor,
                                h0: torch.Tensor, c0: torch.Tensor,
                                save: bool = False):
    """Plain version of kernel K3, gx variant: ``z_t = gx_t + h_{t-1} @
    w_hh`` over gx [T, B, 4H] -> (ys [T, B, H], hT, cT, gates, cs); with
    ``save`` the residuals of the backward — the post-activation gates
    [T, B, 4H] and the cell states cs [T, B, H] — else None for both."""
    return _fused_fwd_plain(w_hh, gx, None, h0, c0, gx.shape[0], save)


def decoder_recurrence_fused_plain(w_eff: torch.Tensor, b_eff: torch.Tensor,
                                   h1: torch.Tensor, c1: torch.Tensor, T: int,
                                   save: bool = False):
    """Plain version of kernel K3, decoder variant: T steps of ``z_t =
    h_{t-1} @ w_eff + b_eff`` from (h1, c1) -> (ys [T, B, H], hT, cT,
    gates, cs), the residuals as in :func:`lstm_recurrence_fused_plain`."""
    return _fused_fwd_plain(w_eff, None, b_eff, h1, c1, T, save)


def fused_recurrence_bwd_plain(w: torch.Tensor, h0: torch.Tensor,
                               c0: torch.Tensor, ys: torch.Tensor,
                               gates: torch.Tensor, cs: torch.Tensor,
                               dys: Optional[torch.Tensor],
                               dhT: Optional[torch.Tensor],
                               dcT: Optional[torch.Tensor], with_gx: bool):
    """Plain version of kernel K4: back-propagation through time from the
    forward's saved post-activation gates and cell states (nothing is
    recomputed from z), previous states read by index (``ys[t-1]``,
    ``cs[t-1]``; h0, c0 at t = 0). A cotangent that is None counts as zero.
    -> (dgx [T, B, 4H] or None, dw [H, 4H], db [4H] or None, dh0, dc0):
    dgx for the gx variant (``with_gx``), db for the decoder variant."""
    T, _, H = ys.shape
    dh = torch.zeros_like(h0) if dhT is None else dhT
    dc = torch.zeros_like(c0) if dcT is None else dcT
    dw = torch.zeros_like(w)
    db = None if with_gx else w.new_zeros(4 * H)
    dgx = torch.empty_like(gates) if with_gx else None
    for t in reversed(range(T)):
        i, f, g, o = gates[t].split(H, dim=-1)
        c_prev = cs[t - 1] if t else c0
        h_prev = ys[t - 1] if t else h0
        if dys is not None:
            dh = dh + dys[t]
        tc = torch.tanh(f * c_prev + i * g)
        dc = dc + dh * o * (1.0 - tc * tc)
        dz = torch.cat([dc * g * i * (1.0 - i), dc * c_prev * f * (1.0 - f),
                        dc * i * (1.0 - g * g), dh * tc * o * (1.0 - o)],
                       dim=-1)
        dh = dz @ w.t()
        dc = dc * f
        dw += h_prev.t() @ dz
        if with_gx:
            dgx[t] = dz
        else:
            db += dz.sum(dim=0)
    return dgx, dw, db, dh, dc


# ------------------- plain versions of the projection-in-kernel LSTM kernels

def lstm_proj_fwd_plain(w_ih: torch.Tensor, w_hh: torch.Tensor,
                        b: torch.Tensor, xs: torch.Tensor, h0: torch.Tensor,
                        c0: torch.Tensor, save: bool = False):
    """Plain version of kernel K5: ``z_t = x_t @ w_ih + h_{t-1} @ w_hh + b``
    (in that order, as the JAX package's kernel adds them) over xs
    [T, B, D] from (h0, c0) -> (ys [T, B, H], hT, cT, gates, cs), the
    residuals as in :func:`lstm_recurrence_fused_plain` (None unless
    ``save``)."""
    return _fused_fwd_plain(w_hh, xs @ w_ih, b, h0, c0, xs.shape[0], save)


def lstm_proj_bwd_plain(w_ih: torch.Tensor, w_hh: torch.Tensor,
                        xs: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                        ys: torch.Tensor, gates: torch.Tensor,
                        cs: torch.Tensor, dys: Optional[torch.Tensor],
                        dhT: Optional[torch.Tensor],
                        dcT: Optional[torch.Tensor]):
    """Plain version of kernel K6: back-propagation through time from K5's
    saved gates and cell states (:func:`fused_recurrence_bwd_plain` gives
    the per-step dz), then ``dxs[t] = dz_t @ w_ihᵀ``, ``dw_ih = Σ x_tᵀ
    dz_t``, ``db = Σ dz_t``. A cotangent that is None counts as zero.
    -> (dxs [T, B, D], dw_ih [D, 4H], dw_hh [H, 4H], db [4H], dh0, dc0)."""
    dz, dw_hh, _, dh0, dc0 = fused_recurrence_bwd_plain(
        w_hh, h0, c0, ys, gates, cs, dys, dhT, dcT, with_gx=True)
    dz2 = dz.reshape(-1, dz.shape[-1])
    return (dz @ w_ih.t(), xs.reshape(-1, xs.shape[-1]).t() @ dz2, dw_hh,
            dz2.sum(dim=0), dh0, dc0)
