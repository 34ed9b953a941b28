"""The whole-loop LSTM recurrence on Hopper (counterpart of
``grouptraj/ops/pallas_fused.py``).

- :func:`lstm_fused_fwd` is the wrapper of kernel K3,
  ``grouptraj_torch/csrc/lstm_fused_fwd.cu`` (it replaces the TPU kernel
  ``pallas_fused.py:_fwd_kernel``): all T steps in one launch, either
  variant (per-step ``gx`` or a constant bias), the backward's residuals
  written only on request;
- :func:`lstm_fused_bwd` is the wrapper of kernel K4,
  ``grouptraj_torch/csrc/lstm_fused_bwd.cu`` (it replaces
  ``pallas_fused.py:_bwd_kernel``);
- :func:`lstm_recurrence_fused` and :func:`decoder_recurrence_fused` are
  the public functions, the counterparts of ``lstm_recurrence_pallas`` and
  ``decoder_recurrence_pallas``: they upcast their arguments to float32,
  and go through a ``torch.autograd.Function`` that saves the residuals
  when an argument needs a gradient, and straight to the forward wrapper
  (nothing saved) when none does.

Each source note gives its kernel's bound and design. For CUDA tensors a
wrapper checks the inputs, launches its kernel on PyTorch's current stream
and counts the launch (``lstm_fused_fwd.launches``,
``lstm_fused_bwd.launches``); for CPU tensors it runs the plain PyTorch
version in :mod:`grouptraj_torch.ops.lstm`. There is no fallback from a
kernel to its plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from grouptraj_torch.ops import _build
from grouptraj_torch.ops.lstm import (
    _fused_fwd_plain, _wants_grad, fused_recurrence_bwd_plain,
)

HIDDEN_SIZES = (8, 16, 32, 48, 64)     # the widths the kernels are built for


@functools.lru_cache(maxsize=None)
def _fwd_lib() -> ctypes.CDLL:
    lib = _build.load("lstm_fused_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_fused_fwd.argtypes = [p] * 9 + [i] * 5 + [p]
    lib.lstm_fused_fwd.restype = ctypes.c_int
    lib.lstm_fused_fwd_error_string.argtypes = [i]
    lib.lstm_fused_fwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("lstm_fused_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_fused_bwd.argtypes = [p] * 16 + [i] * 5 + [p]
    lib.lstm_fused_bwd.restype = ctypes.c_int
    lib.lstm_fused_bwd_rows_per_block.argtypes = []
    lib.lstm_fused_bwd_rows_per_block.restype = ctypes.c_int
    lib.lstm_fused_bwd_error_string.argtypes = [i]
    lib.lstm_fused_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(ref: torch.Tensor, **tensors) -> None:
    """Each ``name=(tensor or None, shape)``: float32, contiguous, of that
    shape and on ``ref``'s device."""
    for name, (t, shape) in tensors.items():
        if t is None:
            continue
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, w on {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_sizes(T: int, B: int, H: int, cuda: bool) -> None:
    if T < 1 or B < 1:
        raise ValueError(f"T and B must be at least 1, got T={T}, B={B}")
    if cuda and H not in HIDDEN_SIZES:
        raise ValueError(f"the whole-loop LSTM kernels are built for H in "
                         f"{HIDDEN_SIZES}, got H={H}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _aligned16(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t``, or a copy of it at a 16-byte aligned address (a view into
    another tensor's storage may start anywhere)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else 0


def lstm_fused_fwd(w: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                   gx: Optional[torch.Tensor] = None,
                   b: Optional[torch.Tensor] = None, T: Optional[int] = None,
                   save: bool = False):
    """T LSTM steps from (h0, c0) ``[B, H]`` with the recurrent matrix w
    ``[H, 4H]``: ``z_t = gx[t] + h @ w`` (gx ``[T, B, 4H]`` given) or
    ``z_t = b + h @ w`` (b ``[4H]`` and T given). All float32, contiguous.
    -> (ys ``[T, B, H]``, hT, cT, gates, cs); with ``save`` gates
    ``[T, B, 4H]`` (post-activation i, f, g, o) and cs ``[T, B, H]`` are
    the residuals :func:`lstm_fused_bwd` takes, else both are None and
    nothing but ys, hT and cT is written. The kernel reads gx, h0 and c0
    eight bytes at a time: one that does not start at a 16-byte aligned
    address is copied first."""
    if (gx is None) == (b is None):
        raise ValueError("give exactly one of gx and b")
    with_gx = gx is not None
    if with_gx:
        T = gx.shape[0]
    elif T is None:
        raise ValueError("the constant-bias variant needs T")
    if h0.dim() != 2:
        raise ValueError(f"h0 must be [B, H], got {tuple(h0.shape)}")
    B, H = h0.shape
    _check(w, w=(w, (H, 4 * H)), h0=(h0, (B, H)), c0=(c0, (B, H)),
           gx=(gx, (T, B, 4 * H)), b=(b, (4 * H,)))
    _check_sizes(T, B, H, w.is_cuda)
    if not w.is_cuda:
        return _fused_fwd_plain(w, gx, b, h0, c0, T, save)
    gx, h0, c0 = (_aligned16(t) for t in (gx, h0, c0))
    lib = _fwd_lib()
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=w.device)
    ys, hT, cT = new(T, B, H), new(B, H), new(B, H)
    gates = cs = None
    if save:
        gates, cs = new(T, B, 4 * H), new(T, B, H)
    err = lib.lstm_fused_fwd(
        w.data_ptr(), (gx if with_gx else b).data_ptr(), h0.data_ptr(),
        c0.data_ptr(), ys.data_ptr(), hT.data_ptr(), cT.data_ptr(),
        _ptr(gates), _ptr(cs), T, B, H, int(with_gx), _device_index(w),
        torch.cuda.current_stream(w.device).cuda_stream)
    if err:
        raise RuntimeError("lstm_fused_fwd launch failed: "
                           + lib.lstm_fused_fwd_error_string(err).decode())
    lstm_fused_fwd.launches += 1
    return ys, hT, cT, gates, cs


lstm_fused_fwd.launches = 0


def lstm_fused_bwd(w: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                   ys: torch.Tensor, gates: torch.Tensor, cs: torch.Tensor,
                   dys: Optional[torch.Tensor], dhT: Optional[torch.Tensor],
                   dcT: Optional[torch.Tensor], with_gx: bool):
    """Backward of :func:`lstm_fused_fwd` from its arguments, its outputs
    (ys, gates, cs) and the cotangents dys ``[T, B, H]``, dhT, dcT
    ``[B, H]``, each of which may be None (zero) -> (dgx, dw, db, dh0,
    dc0): dgx ``[T, B, 4H]`` for the gx variant (``with_gx``; db is then
    None), db ``[4H]`` for the constant-bias variant (dgx None). The
    kernel copies h0, c0, ys, gates, cs and dys 16 bytes at a time: one
    that does not start at a 16-byte aligned address is copied first."""
    if ys.dim() != 3:
        raise ValueError(f"ys must be [T, B, H], got {tuple(ys.shape)}")
    T, B, H = ys.shape
    _check(w, w=(w, (H, 4 * H)), h0=(h0, (B, H)), c0=(c0, (B, H)),
           ys=(ys, (T, B, H)), gates=(gates, (T, B, 4 * H)),
           cs=(cs, (T, B, H)), dys=(dys, (T, B, H)), dhT=(dhT, (B, H)),
           dcT=(dcT, (B, H)))
    _check_sizes(T, B, H, w.is_cuda)
    if not w.is_cuda:
        return fused_recurrence_bwd_plain(w, h0, c0, ys, gates, cs, dys, dhT,
                                          dcT, with_gx)
    # the kernel copies these by cp.async, 16 bytes at a time
    h0, c0, ys, gates, cs, dys = (
        _aligned16(t) for t in (h0, c0, ys, gates, cs, dys))
    lib = _bwd_lib()
    nb = -(-B // lib.lstm_fused_bwd_rows_per_block())
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=w.device)
    dw, dw_part = new(H, 4 * H), new(nb, H, 4 * H)
    dh0, dc0 = new(B, H), new(B, H)
    dgx = db = db_part = None
    if with_gx:
        dgx = new(T, B, 4 * H)
    else:
        db, db_part = new(4 * H), new(nb, 4 * H)
    err = lib.lstm_fused_bwd(
        w.data_ptr(), h0.data_ptr(), c0.data_ptr(), ys.data_ptr(),
        gates.data_ptr(), cs.data_ptr(), _ptr(dys), _ptr(dhT), _ptr(dcT),
        _ptr(dgx), dw_part.data_ptr(), _ptr(db_part), dw.data_ptr(),
        _ptr(db), dh0.data_ptr(), dc0.data_ptr(), T, B, H, int(with_gx),
        _device_index(w), torch.cuda.current_stream(w.device).cuda_stream)
    if err:
        raise RuntimeError("lstm_fused_bwd launch failed: "
                           + lib.lstm_fused_bwd_error_string(err).decode())
    lstm_fused_bwd.launches += 1
    return dgx, dw, db, dh0, dc0


lstm_fused_bwd.launches = 0


def _contiguous(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.contiguous()


class _LstmRecurrenceFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w_hh, gx, h0, c0):
        ys, hT, cT, gates, cs = lstm_fused_fwd(w_hh, h0, c0, gx=gx,
                                               save=True)
        ctx.save_for_backward(w_hh, h0, c0, ys, gates, cs)
        ctx.set_materialize_grads(False)      # an unused output costs nothing
        return ys, hT, cT

    @staticmethod
    @once_differentiable
    def backward(ctx, dys, dhT, dcT):
        dgx, dw, _, dh0, dc0 = lstm_fused_bwd(
            *ctx.saved_tensors, _contiguous(dys), _contiguous(dhT),
            _contiguous(dcT), with_gx=True)
        return dw, dgx, dh0, dc0


class _DecoderRecurrenceFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w_eff, b_eff, h1, c1, T):
        ys, _, _, gates, cs = lstm_fused_fwd(w_eff, h1, c1, b=b_eff, T=T,
                                             save=True)
        ctx.save_for_backward(w_eff, h1, c1, ys, gates, cs)
        return ys

    @staticmethod
    @once_differentiable
    def backward(ctx, dys):
        _, dw, db, dh1, dc1 = lstm_fused_bwd(
            *ctx.saved_tensors, dys.contiguous(), None, None, with_gx=False)
        return dw, db, dh1, dc1, None


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float().contiguous()


def lstm_recurrence_fused(w_hh: torch.Tensor, gx: torch.Tensor,
                          h0: torch.Tensor, c0: torch.Tensor
                          ) -> Tuple[torch.Tensor,
                                     Tuple[torch.Tensor, torch.Tensor]]:
    """Recurrent half of an LSTM in one launch: gx ``[T, B, 4H]`` already
    holds ``x_t @ W_ih + b_ih + b_hh``. Arguments are upcast to float32.
    -> (ys ``[T, B, H]``, (hT, cT)), float32."""
    args = (_f32(w_hh), _f32(gx), _f32(h0), _f32(c0))
    if _wants_grad(*args):
        ys, hT, cT = _LstmRecurrenceFused.apply(*args)
    else:
        ys, hT, cT, _, _ = lstm_fused_fwd(args[0], args[2], args[3],
                                          gx=args[1])
    return ys, (hT, cT)


def decoder_recurrence_fused(w_eff: torch.Tensor, b_eff: torch.Tensor,
                             h1: torch.Tensor, c1: torch.Tensor, T: int
                             ) -> torch.Tensor:
    """T steps of the folded decoder recurrence ``z_t = h_{t-1} @ w_eff +
    b_eff`` from (h1, c1) in one launch; arguments are upcast to float32.
    -> the stacked hidden states ys ``[T, B, H]`` (h_2 … h_{T+1}),
    float32."""
    args = (_f32(w_eff), _f32(b_eff), _f32(h1), _f32(c1))
    if _wants_grad(*args):
        return _DecoderRecurrenceFused.apply(*args, T)
    return lstm_fused_fwd(args[0], args[2], args[3], b=args[1], T=T)[0]
