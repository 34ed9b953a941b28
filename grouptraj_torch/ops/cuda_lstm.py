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
  when an argument needs a gradient or is batched under ``torch.func.vmap``,
  and straight to the forward wrapper (nothing saved) otherwise. Under
  vmap the Functions' rule folds the vmapped axis into the rows (one
  launch at K·B rows: the per-sample g-step of a dropout model); a
  batched weight raises.

Each source note gives its kernel's bound and design. For CUDA tensors a
wrapper checks the inputs, launches its kernel on PyTorch's current stream
and counts the launch (``lstm_fused_fwd.launches``,
``lstm_fused_bwd.launches``); for CPU tensors it runs the plain PyTorch
version in :mod:`grouptraj_torch.ops.lstm`. There is no fallback from a
kernel to its plain version.

Widths. :func:`lstm_plan` maps the hidden width H (and, for K5/K6 in
:mod:`grouptraj_torch.ops.cuda_lstm_proj`, the input width D) to the
build that serves it: the register design (``csrc/lstm_fused_*.cu``,
``lstm_proj_*.cu``; H in :data:`HIDDEN_SIZES`, D in :data:`INPUT_SIZES`)
up to H = 64 and D = 16, the wide design (``csrc/lstm_wide_*.cu``; H a
multiple of 8 up to :data:`MAX_H`, D a multiple of 4 up to :data:`MAX_D`)
beyond. A width between the built ones runs zero-padded to the next one:
zero weight rows and columns, zero state and bias. That is exact: a padded
unit's gates are i = f = o = 1/2 and g = 0, so its c and h stay 0 and it
feeds nothing, and its gradients are 0; the wrappers slice every output
back. Past MAX_H or MAX_D the wrappers raise. A launch of the wide design
also counts in ``<wrapper>.launches_wide``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from grouptraj_torch.ops import _build
from grouptraj_torch.ops.lstm import (
    _batched, _fused_fwd_plain, _wants_grad, fused_recurrence_bwd_plain,
)

HIDDEN_SIZES = (8, 16, 32, 48, 64)     # H of the register design's builds
INPUT_SIZES = (4, 8, 16)               # D of the register design's builds
MAX_H, MAX_D = 128, 64                 # the wide design's limits


class LstmPlan(NamedTuple):
    """The build that serves a width: ``design`` 'register' or 'wide', and
    the widths ``H`` and ``D`` (0: no input projection) it runs at, each at
    least the caller's (zero-padded up to it)."""
    design: str
    H: int
    D: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def lstm_plan(H: int, D: int = 0) -> LstmPlan:
    """The kernel build for hidden width H and input width D (K5/K6; 0 for
    K3/K4, which take no input projection): the register design at the
    smallest built H >= H and D >= D where H <= 64 and D <= 16, else the
    wide design at H and D rounded up to multiples of 8 and 4. Raises
    ValueError past H = MAX_H or D = MAX_D."""
    if not 1 <= H <= MAX_H or not 0 <= D <= MAX_D:
        raise ValueError(f"the LSTM kernels take H in [1, {MAX_H}] and, with "
                         f"an input projection, D in [1, {MAX_D}], got "
                         f"H={H}, D={D}")
    if H <= HIDDEN_SIZES[-1] and D <= INPUT_SIZES[-1]:
        return LstmPlan("register", min(h for h in HIDDEN_SIZES if h >= H),
                        min((d for d in INPUT_SIZES if d >= D), default=0)
                        if D else 0)
    return LstmPlan("wide", _round_up(H, 8), _round_up(D, 4))


def pad_units(t: Optional[torch.Tensor], H: int, Hp: int, gates: bool = False,
              rows: Optional[int] = None) -> Optional[torch.Tensor]:
    """``t`` with its last axis (H units, or with ``gates`` the four gates'
    blocks of H) zero-padded to Hp units, and with ``rows`` its first axis
    zero-padded to that many rows; None stays None."""
    if t is None:
        return None
    if gates:
        t = torch.nn.functional.pad(t.unflatten(-1, (4, H)), (0, Hp - H))
        t = t.flatten(-2)
    else:
        t = torch.nn.functional.pad(t, (0, Hp - H))
    if rows is not None:
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 1)
                                    + (0, rows - t.shape[0]))
    return t.contiguous()


def unpad_units(t: Optional[torch.Tensor], H: int, gates: bool = False,
                rows: Optional[int] = None) -> Optional[torch.Tensor]:
    """The inverse of :func:`pad_units`: the first H units (of each gate's
    block) and the first ``rows`` rows, contiguous."""
    if t is None:
        return None
    if rows is not None:
        t = t[:rows]
    if gates:
        t = t.unflatten(-1, (4, -1))[..., :H].flatten(-2)
    else:
        t = t[..., :H]
    return t.contiguous()


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
def _wide_fwd_lib() -> ctypes.CDLL:
    lib = _build.load("lstm_wide_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_wide_fwd.argtypes = [p] * 12 + [i] * 6 + [p]
    lib.lstm_wide_fwd.restype = ctypes.c_int
    lib.lstm_wide_fwd_error_string.argtypes = [i]
    lib.lstm_wide_fwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _wide_bwd_lib() -> ctypes.CDLL:
    lib = _build.load("lstm_wide_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_wide_bwd.argtypes = [p] * 18 + [i] * 6 + [p]
    lib.lstm_wide_bwd.restype = ctypes.c_int
    lib.lstm_wide_bwd_chunks.argtypes = [i] * 5
    lib.lstm_wide_bwd_chunks.restype = ctypes.c_int
    lib.lstm_wide_bwd_wf_floats.argtypes = []
    lib.lstm_wide_bwd_wf_floats.restype = ctypes.c_int
    lib.lstm_wide_bwd_error_string.argtypes = [i]
    lib.lstm_wide_bwd_error_string.restype = ctypes.c_char_p
    return lib


WIDE_MODES = {"gx": 0, "bias": 1, "proj": 2}    # lstm_wide_fwd's modes


def wide_fwd(w_ih, w_hh, pre, xs, h0, c0, T, mode, save):
    """Launch the wide forward (csrc/lstm_wide_fwd.cu) on checked, 16-byte
    aligned CUDA tensors at widths it takes: ``mode`` 'gx' (K3, pre = gx),
    'bias' (K3, pre = b) or 'proj' (K5, pre = b, with w_ih and xs; None
    otherwise). -> (ys, hT, cT, gates, cs), the residuals None unless
    ``save``."""
    B, H = h0.shape
    D = 0 if xs is None else xs.shape[2]
    lib = _wide_fwd_lib()
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=w_hh.device)
    ys, hT, cT = new(T, B, H), new(B, H), new(B, H)
    gates = cs = None
    if save:
        gates, cs = new(T, B, 4 * H), new(T, B, H)
    wf = new((_round_up(D, 8) + H) * 8 * H)
    err = lib.lstm_wide_fwd(
        _ptr(w_ih), w_hh.data_ptr(), pre.data_ptr(), _ptr(xs), h0.data_ptr(),
        c0.data_ptr(), ys.data_ptr(), hT.data_ptr(), cT.data_ptr(),
        _ptr(gates), _ptr(cs), wf.data_ptr(), T, B, D, H, WIDE_MODES[mode],
        _device_index(w_hh),
        torch.cuda.current_stream(w_hh.device).cuda_stream)
    if err:
        raise RuntimeError("lstm_wide_fwd launch failed: "
                           + lib.lstm_wide_fwd_error_string(err).decode())
    return ys, hT, cT, gates, cs


def wide_bwd(w_ih, w_hh, xs, h0, c0, ys, gates, cs, dys, dhT, dcT, dz,
             with_db):
    """Launch the wide backward (csrc/lstm_wide_bwd.cu) on checked, 16-byte
    aligned CUDA tensors at widths it takes: K4 (w_ih and xs None) or K6.
    ``dz`` [T, B, 4H] receives dz (K4's dgx) or is a scratch. -> (dxs or
    None, dw [Kc, 4H], dh0, dc0): dw's rows are dW_ih (D), zeros up to a
    multiple of 8, dW_hh (H), then db in the next row with ``with_db``."""
    T, B, H = ys.shape
    D = 0 if xs is None else xs.shape[2]
    lib = _wide_bwd_lib()
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=w_hh.device)
    kc = _round_up(D, 8) + H + (8 if with_db else 0)
    nch = lib.lstm_wide_bwd_chunks(T, B, D, H, int(with_db))
    wf = new(lib.lstm_wide_bwd_wf_floats())     # W_hhᵀ's split tiles
    part, dw = new(nch, kc, 4 * H), new(kc, 4 * H)
    dxs = new(T, B, D) if D else None
    dh0, dc0 = new(B, H), new(B, H)
    err = lib.lstm_wide_bwd(
        _ptr(w_ih), w_hh.data_ptr(), _ptr(xs), h0.data_ptr(), c0.data_ptr(),
        ys.data_ptr(), gates.data_ptr(), cs.data_ptr(), _ptr(dys), _ptr(dhT),
        _ptr(dcT), dz.data_ptr(), _ptr(dxs), wf.data_ptr(), part.data_ptr(),
        dw.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), T, B, D, H,
        int(with_db), _device_index(w_hh),
        torch.cuda.current_stream(w_hh.device).cuda_stream)
    if err:
        raise RuntimeError("lstm_wide_bwd launch failed: "
                           + lib.lstm_wide_bwd_error_string(err).decode())
    return dxs, dw, dh0, dc0


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


def _check_sizes(T: int, B: int, H: int, cuda: bool) -> Optional[LstmPlan]:
    """Raises on sizes the kernels (``cuda``) or the plain version do not
    take. -> the kernels' plan (:func:`lstm_plan`), None on the CPU."""
    if T < 1 or B < 1:
        raise ValueError(f"T and B must be at least 1, got T={T}, B={B}")
    return lstm_plan(H) if cuda else None


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
    plan = _check_sizes(T, B, H, w.is_cuda)
    if not w.is_cuda:
        return _fused_fwd_plain(w, gx, b, h0, c0, T, save)
    run = functools.partial(_fused_fwd_cuda, design=plan.design)
    if plan.H != H:                         # zero-padded (lstm_plan)
        return fused_fwd_padded(run, plan.H, w, h0, c0, gx, b, T, save)
    return run(w, h0, c0, gx, b, T, save)


def fused_fwd_padded(run, Hp, w, h0, c0, gx, b, T, save):
    """``run(w, h0, c0, gx, b, T, save)`` (K3's launch, or its plain
    version) at Hp units on zero-padded arguments, its outputs sliced back
    to H."""
    H = h0.shape[1]
    out = run(pad_units(w, H, Hp, gates=True, rows=Hp),
              *(pad_units(t, H, Hp) for t in (h0, c0)),
              pad_units(gx, H, Hp, gates=True),
              pad_units(b, H, Hp, gates=True), T, save)
    return tuple(unpad_units(t, H, gates=i == 3) for i, t in enumerate(out))


def _fused_fwd_cuda(w, h0, c0, gx, b, T, save, *, design):
    """lstm_fused_fwd's launch on CUDA tensors at a width ``design``
    takes."""
    B, H = h0.shape
    with_gx = gx is not None
    gx, h0, c0, b = (_aligned16(t) for t in (gx, h0, c0, b))
    if design == "wide":
        out = wide_fwd(None, w, gx if with_gx else b, None, h0, c0, T,
                       "gx" if with_gx else "bias", save)
        lstm_fused_fwd.launches_wide += 1
        lstm_fused_fwd.launches += 1
        return out
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
lstm_fused_fwd.launches_wide = 0


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
    plan = _check_sizes(T, B, H, w.is_cuda)
    if not w.is_cuda:
        return fused_recurrence_bwd_plain(w, h0, c0, ys, gates, cs, dys, dhT,
                                          dcT, with_gx)
    run = functools.partial(_fused_bwd_cuda, design=plan.design)
    if plan.H != H:                         # zero-padded (lstm_plan)
        return fused_bwd_padded(run, plan.H, w, h0, c0, ys, gates, cs, dys,
                                dhT, dcT, with_gx)
    return run(w, h0, c0, ys, gates, cs, dys, dhT, dcT, with_gx)


def fused_bwd_padded(run, Hp, w, h0, c0, ys, gates, cs, dys, dhT, dcT,
                     with_gx):
    """``run(w, h0, c0, ys, gates, cs, dys, dhT, dcT, with_gx)`` (K4's
    launch, or its plain version) at Hp units on zero-padded arguments, its
    outputs sliced back to H."""
    H = h0.shape[1]
    dgx, dw, db, dh0, dc0 = run(
        pad_units(w, H, Hp, gates=True, rows=Hp),
        *(pad_units(t, H, Hp) for t in (h0, c0, ys)),
        pad_units(gates, H, Hp, gates=True),
        *(pad_units(t, H, Hp) for t in (cs, dys, dhT, dcT)), with_gx)
    return (unpad_units(dgx, H, gates=True),
            unpad_units(dw, H, gates=True, rows=H),
            unpad_units(db, H, gates=True), unpad_units(dh0, H),
            unpad_units(dc0, H))


def _fused_bwd_cuda(w, h0, c0, ys, gates, cs, dys, dhT, dcT, with_gx, *,
                    design):
    """lstm_fused_bwd's launch on CUDA tensors at a width ``design``
    takes."""
    T, B, H = ys.shape
    # the kernels copy these by cp.async, 8 or 16 bytes at a time
    h0, c0, ys, gates, cs, dys = (
        _aligned16(t) for t in (h0, c0, ys, gates, cs, dys))
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=w.device)
    if design == "wide":
        dz = new(T, B, 4 * H)               # dgx, or a scratch
        _, dw, dh0, dc0 = wide_bwd(None, w, None, h0, c0, ys, gates, cs, dys,
                                   dhT, dcT, dz, with_db=not with_gx)
        lstm_fused_bwd.launches_wide += 1
        lstm_fused_bwd.launches += 1
        return (dz if with_gx else None, dw[:H],
                None if with_gx else dw[H], dh0, dc0)
    lib = _bwd_lib()
    nb = -(-B // lib.lstm_fused_bwd_rows_per_block())
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
lstm_fused_bwd.launches_wide = 0


def _contiguous(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.contiguous()


def fold_rows(info, in_dims, weights, rows):
    """The batching rule of a row-independent recurrence under
    ``torch.func.vmap``. ``in_dims`` are the Function's, the weights'
    first: the weights (named by ``weights``) must be unbatched (one
    weight for every vmapped replica; a batched one, as a seed-vmapped
    sweep would give, raises NotImplementedError), and each of ``rows``,
    a ``(tensor, row_dim)`` pair, has the vmapped axis merged into its row
    axis, replica-major (an unbatched one is broadcast). -> the folded
    tensors, contiguous."""
    n = info.batch_size
    for name, dim in zip(weights, in_dims):
        if dim is not None:
            raise NotImplementedError(
                f"{name} is batched under vmap (one weight a replica): the "
                f"LSTM kernels' batching rule folds the vmapped axis into "
                f"the rows and needs one shared weight; multi-seed sweeps "
                f"run the 'scan' route")
    out = []
    for (t, row), dim in zip(rows, in_dims[len(weights):]):
        if dim is None:
            t = t.unsqueeze(row).expand(*t.shape[:row], n, *t.shape[row:])
        else:
            t = t.movedim(dim, row)
        out.append(t.reshape(*t.shape[:row], -1, *t.shape[row + 2:])
                   .contiguous())
    return out


def unfold_rows(n: int, t: torch.Tensor, row: int) -> torch.Tensor:
    """The inverse of :func:`fold_rows` on an output: its row axis split
    into (replica, row) -> a view with the vmapped axis at ``row``."""
    return t.view(*t.shape[:row], n, -1, *t.shape[row + 1:])


# The Functions return the residuals their backward needs (gates, cs) as
# extra non-differentiable outputs: the setup_context form, which
# torch.func.vmap requires, sees only inputs and outputs. Each has a vmap
# rule that folds the vmapped axis into the rows (fold_rows): one launch
# at n·B rows, and one autograd node, so the backward is one launch too.

class _LstmRecurrenceFused(torch.autograd.Function):
    @staticmethod
    def forward(w_hh, gx, h0, c0):
        return lstm_fused_fwd(w_hh, h0, c0, gx=gx, save=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        w_hh, _, h0, c0 = inputs
        ys, _, _, gates, cs = output
        ctx.save_for_backward(w_hh, h0, c0, ys, gates, cs)
        ctx.mark_non_differentiable(gates, cs)
        ctx.set_materialize_grads(False)      # an unused output costs nothing

    @staticmethod
    @once_differentiable
    def backward(ctx, dys, dhT, dcT, _dgates, _dcs):
        dgx, dw, _, dh0, dc0 = lstm_fused_bwd(
            *ctx.saved_tensors, _contiguous(dys), _contiguous(dhT),
            _contiguous(dcT), with_gx=True)
        return dw, dgx, dh0, dc0

    @staticmethod
    def vmap(info, in_dims, w_hh, gx, h0, c0):
        gx, h0, c0 = fold_rows(info, in_dims, ("w_hh",),
                               ((gx, 1), (h0, 0), (c0, 0)))
        ys, hT, cT, gates, cs = _LstmRecurrenceFused.apply(w_hh, gx, h0, c0)
        n = info.batch_size
        return ((unfold_rows(n, ys, 1), unfold_rows(n, hT, 0),
                 unfold_rows(n, cT, 0), unfold_rows(n, gates, 1),
                 unfold_rows(n, cs, 1)), (1, 0, 0, 1, 1))


class _DecoderRecurrenceFused(torch.autograd.Function):
    @staticmethod
    def forward(w_eff, b_eff, h1, c1, T):
        ys, _, _, gates, cs = lstm_fused_fwd(w_eff, h1, c1, b=b_eff, T=T,
                                             save=True)
        return ys, gates, cs

    @staticmethod
    def setup_context(ctx, inputs, output):
        w_eff, _, h1, c1, _ = inputs
        ys, gates, cs = output
        ctx.save_for_backward(w_eff, h1, c1, ys, gates, cs)
        ctx.mark_non_differentiable(gates, cs)

    @staticmethod
    @once_differentiable
    def backward(ctx, dys, _dgates, _dcs):
        _, dw, db, dh1, dc1 = lstm_fused_bwd(
            *ctx.saved_tensors, dys.contiguous(), None, None, with_gx=False)
        return dw, db, dh1, dc1, None

    @staticmethod
    def vmap(info, in_dims, w_eff, b_eff, h1, c1, T):
        h1, c1 = fold_rows(info, in_dims[:4], ("w_eff", "b_eff"),
                           ((h1, 0), (c1, 0)))
        out = _DecoderRecurrenceFused.apply(w_eff, b_eff, h1, c1, T)
        return (tuple(unfold_rows(info.batch_size, t, 1) for t in out),
                (1, 1, 1))


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
    if _wants_grad(*args) or _batched(*args):
        ys, hT, cT, _, _ = _LstmRecurrenceFused.apply(*args)
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
    if _wants_grad(*args) or _batched(*args):
        return _DecoderRecurrenceFused.apply(*args, T)[0]
    return lstm_fused_fwd(args[0], args[2], args[3], b=args[1], T=T)[0]
