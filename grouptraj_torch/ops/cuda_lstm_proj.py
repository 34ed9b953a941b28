"""The LSTM with its input projection inside the kernel, on Hopper
(counterpart of ``grouptraj/ops/pallas_lstm.py``).

- :func:`lstm_proj_fwd` is the wrapper of kernel K5,
  ``grouptraj_torch/csrc/lstm_proj_fwd.cu`` (it replaces the TPU kernel
  ``pallas_lstm.py:_fwd_kernel``): all T steps of ``z_t = x_t @ W_ih +
  h_{t-1} @ W_hh + b`` in one launch, reading xs ``[T, B, D]`` and never
  writing a gx slab, the backward's residuals only on request;
- :func:`lstm_proj_bwd` is the wrapper of kernel K6,
  ``grouptraj_torch/csrc/lstm_proj_bwd.cu`` (it replaces
  ``pallas_lstm.py:_bwd_kernel``): dxs, dW_ih, dW_hh, db, dh0 and dc0 in
  one call;
- :func:`lstm_scan_proj` is the public function, the counterpart of
  ``lstm_scan_pallas``: it forms ``b = b_ih + b_hh`` (so autograd hands db
  to both biases), upcasts to float32, and goes through a
  ``torch.autograd.Function`` that saves the residuals when an argument
  needs a gradient, and straight to the forward wrapper (nothing saved)
  when none does.

Each source note gives its kernel's bound and design. For CUDA tensors a
wrapper checks the inputs, launches its kernel on PyTorch's current stream
and counts the launch (``lstm_proj_fwd.launches``,
``lstm_proj_bwd.launches``); for CPU tensors it runs the plain PyTorch
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
from grouptraj_torch.ops.cuda_lstm import (
    HIDDEN_SIZES, _aligned16, _check, _contiguous, _device_index, _f32, _ptr,
)
from grouptraj_torch.ops.lstm import (
    _wants_grad, lstm_proj_bwd_plain, lstm_proj_fwd_plain,
)

INPUT_SIZES = (4, 8, 16)      # the input widths D the kernels are built for


@functools.lru_cache(maxsize=None)
def _fwd_lib() -> ctypes.CDLL:
    lib = _build.load("lstm_proj_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_proj_fwd.argtypes = [p] * 11 + [i] * 5 + [p]
    lib.lstm_proj_fwd.restype = ctypes.c_int
    lib.lstm_proj_fwd_error_string.argtypes = [i]
    lib.lstm_proj_fwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("lstm_proj_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_proj_bwd.argtypes = [p] * 16 + [i] * 5 + [p]
    lib.lstm_proj_bwd.restype = ctypes.c_int
    lib.lstm_proj_bwd_rows_per_block.argtypes = []
    lib.lstm_proj_bwd_rows_per_block.restype = ctypes.c_int
    lib.lstm_proj_bwd_error_string.argtypes = [i]
    lib.lstm_proj_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_sizes(T: int, B: int, D: int, H: int, cuda: bool) -> None:
    if T < 1 or B < 1:
        raise ValueError(f"T and B must be at least 1, got T={T}, B={B}")
    if cuda and (D not in INPUT_SIZES or H not in HIDDEN_SIZES):
        raise ValueError(f"the projection-in-kernel LSTM kernels are built "
                         f"for D in {INPUT_SIZES} and H in {HIDDEN_SIZES}, "
                         f"got D={D}, H={H}")


def _sizes(xs: torch.Tensor, w_hh: torch.Tensor) -> Tuple[int, int, int, int]:
    if xs.dim() != 3 or w_hh.dim() != 2:
        raise ValueError(f"xs must be [T, B, D] and w_hh [H, 4H], got "
                         f"{tuple(xs.shape)} and {tuple(w_hh.shape)}")
    return (*xs.shape, w_hh.shape[0])


def lstm_proj_fwd(w_ih: torch.Tensor, w_hh: torch.Tensor, b: torch.Tensor,
                  xs: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                  save: bool = False):
    """T LSTM steps ``z_t = x_t @ w_ih + h_{t-1} @ w_hh + b`` over xs
    ``[T, B, D]`` from (h0, c0) ``[B, H]``; w_ih ``[D, 4H]``, w_hh
    ``[H, 4H]``, b ``[4H]``, all float32 and contiguous. -> (ys
    ``[T, B, H]``, hT, cT, gates, cs); with ``save`` gates ``[T, B, 4H]``
    (post-activation i, f, g, o) and cs ``[T, B, H]`` are the residuals
    :func:`lstm_proj_bwd` takes, else both are None and nothing but ys, hT
    and cT is written."""
    T, B, D, H = _sizes(xs, w_hh)
    _check(w_hh, w_ih=(w_ih, (D, 4 * H)), w_hh=(w_hh, (H, 4 * H)),
           b=(b, (4 * H,)), xs=(xs, (T, B, D)), h0=(h0, (B, H)),
           c0=(c0, (B, H)))
    _check_sizes(T, B, D, H, w_hh.is_cuda)
    if not w_hh.is_cuda:
        return lstm_proj_fwd_plain(w_ih, w_hh, b, xs, h0, c0, save)
    # the kernel copies xs by cp.async, 16 bytes at a time
    xs, h0, c0 = (_aligned16(t) for t in (xs, h0, c0))
    lib = _fwd_lib()
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=w_hh.device)
    ys, hT, cT = new(T, B, H), new(B, H), new(B, H)
    gates = cs = None
    if save:
        gates, cs = new(T, B, 4 * H), new(T, B, H)
    err = lib.lstm_proj_fwd(
        w_ih.data_ptr(), w_hh.data_ptr(), b.data_ptr(), xs.data_ptr(),
        h0.data_ptr(), c0.data_ptr(), ys.data_ptr(), hT.data_ptr(),
        cT.data_ptr(), _ptr(gates), _ptr(cs), T, B, D, H,
        _device_index(w_hh), torch.cuda.current_stream(w_hh.device).cuda_stream)
    if err:
        raise RuntimeError("lstm_proj_fwd launch failed: "
                           + lib.lstm_proj_fwd_error_string(err).decode())
    lstm_proj_fwd.launches += 1
    return ys, hT, cT, gates, cs


lstm_proj_fwd.launches = 0


def lstm_proj_bwd(w_ih: torch.Tensor, w_hh: torch.Tensor, xs: torch.Tensor,
                  h0: torch.Tensor, c0: torch.Tensor, ys: torch.Tensor,
                  gates: torch.Tensor, cs: torch.Tensor,
                  dys: Optional[torch.Tensor], dhT: Optional[torch.Tensor],
                  dcT: Optional[torch.Tensor]):
    """Backward of :func:`lstm_proj_fwd` from its arguments, its outputs
    (ys, gates, cs) and the cotangents dys ``[T, B, H]``, dhT, dcT
    ``[B, H]``, each of which may be None (zero) -> (dxs ``[T, B, D]``,
    dw_ih ``[D, 4H]``, dw_hh ``[H, 4H]``, db ``[4H]``, dh0, dc0)."""
    T, B, D, H = _sizes(xs, w_hh)
    _check(w_hh, w_ih=(w_ih, (D, 4 * H)), w_hh=(w_hh, (H, 4 * H)),
           xs=(xs, (T, B, D)), h0=(h0, (B, H)), c0=(c0, (B, H)),
           ys=(ys, (T, B, H)), gates=(gates, (T, B, 4 * H)),
           cs=(cs, (T, B, H)), dys=(dys, (T, B, H)), dhT=(dhT, (B, H)),
           dcT=(dcT, (B, H)))
    _check_sizes(T, B, D, H, w_hh.is_cuda)
    if not w_hh.is_cuda:
        return lstm_proj_bwd_plain(w_ih, w_hh, xs, h0, c0, ys, gates, cs,
                                   dys, dhT, dcT)
    # the kernel copies these by cp.async, 16 bytes at a time
    xs, h0, c0, ys, gates, cs, dys = (
        _aligned16(t) for t in (xs, h0, c0, ys, gates, cs, dys))
    lib = _bwd_lib()
    nb = -(-B // lib.lstm_proj_bwd_rows_per_block())
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=w_hh.device)
    # the weight gradients of one block side by side: dw_ih, dw_hh, db
    n = (D + H + 1) * 4 * H
    dw, part = new(n), new(nb, n)
    dxs, dh0, dc0 = new(T, B, D), new(B, H), new(B, H)
    err = lib.lstm_proj_bwd(
        w_ih.data_ptr(), w_hh.data_ptr(), xs.data_ptr(), h0.data_ptr(),
        c0.data_ptr(), ys.data_ptr(), gates.data_ptr(), cs.data_ptr(),
        _ptr(dys), _ptr(dhT), _ptr(dcT), dxs.data_ptr(), part.data_ptr(),
        dw.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), T, B, D, H,
        _device_index(w_hh), torch.cuda.current_stream(w_hh.device).cuda_stream)
    if err:
        raise RuntimeError("lstm_proj_bwd launch failed: "
                           + lib.lstm_proj_bwd_error_string(err).decode())
    lstm_proj_bwd.launches += 1
    dw_ih, dw_hh, db = dw.split((D * 4 * H, H * 4 * H, 4 * H))
    return (dxs, dw_ih.view(D, 4 * H), dw_hh.view(H, 4 * H), db, dh0, dc0)


lstm_proj_bwd.launches = 0


class _LstmProj(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w_ih, w_hh, b, xs, h0, c0):
        ys, hT, cT, gates, cs = lstm_proj_fwd(w_ih, w_hh, b, xs, h0, c0,
                                              save=True)
        ctx.save_for_backward(w_ih, w_hh, xs, h0, c0, ys, gates, cs)
        ctx.set_materialize_grads(False)      # an unused output costs nothing
        return ys, hT, cT

    @staticmethod
    @once_differentiable
    def backward(ctx, dys, dhT, dcT):
        dxs, dw_ih, dw_hh, db, dh0, dc0 = lstm_proj_bwd(
            *ctx.saved_tensors, _contiguous(dys), _contiguous(dhT),
            _contiguous(dcT))
        return dw_ih, dw_hh, db, dxs, dh0, dc0


def lstm_scan_proj(params: dict, xs: torch.Tensor, h0: torch.Tensor,
                   c0: torch.Tensor
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """:func:`grouptraj_torch.ops.lstm.lstm_scan` with ``impl='pallas'``:
    the LSTM ``params`` (``w_ih`` ``[D, 4H]``, ``w_hh``, ``b_ih``,
    ``b_hh``) over xs ``[T, B, D]`` from (h0, c0), every argument upcast to
    float32. -> (ys ``[T, B, H]``, (hT, cT)), float32."""
    args = (_f32(params["w_ih"]), _f32(params["w_hh"]),
            _f32(params["b_ih"] + params["b_hh"]), _f32(xs), _f32(h0),
            _f32(c0))
    if _wants_grad(*args):
        ys, hT, cT = _LstmProj.apply(*args)
    else:
        ys, hT, cT, _, _ = lstm_proj_fwd(*args)
    return ys, (hT, cT)
