"""The social-pool pair core on Hopper (counterpart of
``grouptraj/ops/pallas_pool.py``).

- :func:`pool_core_fwd` is the wrapper of kernel K1,
  ``grouptraj_torch/csrc/pool_core_fwd.cu`` (it replaces the TPU kernel
  ``pallas_pool.py:_fwd_kernel``);
- :func:`pool_core_bwd` is the wrapper of kernel K2,
  ``grouptraj_torch/csrc/pool_core_bwd.cu`` (it replaces
  ``pallas_pool.py:_bwd_kernel``);
- :class:`PoolCore` is the ``torch.autograd.Function`` that joins them, the
  counterpart of the ``custom_vjp`` around ``pool_core_pallas``. Its
  ``vmap`` rule folds a ``torch.func.vmap`` axis (the seed axis of
  ``train/multi.py``) into the kernels' replica axis R, as the
  ``custom_vmap`` rules of ``pallas_pool.py`` do: one K1 launch and one K2
  launch per call site whatever the number of replicas.

Each source note gives its kernel's bound and design; both kernels take
their pair tile from ``csrc/pool_core.cuh``, so the backward recomputes the
forward's values bit for bit. Each kernel has two modes, as the TPU
kernels have: float32-exact products (the default) and, with ``bf16``,
bfloat16 operands with float32 accumulation (the TPU kernels' mode at
JAX's default matmul precision; ``PoolCore`` takes it from
:mod:`grouptraj_torch.ops.precision` through ``pooling._pool_fast``). For
CUDA tensors a wrapper checks the inputs, launches its kernel on
PyTorch's current stream and counts the launch by mode
(``pool_core_fwd.launches`` and ``pool_core_fwd.launches_bf16``, the same
on ``pool_core_bwd``); for CPU tensors it runs the plain PyTorch version in
:mod:`grouptraj_torch.ops.pooling` in the same mode. There is no fallback
from a kernel to its plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from grouptraj_torch.ops import _build
from grouptraj_torch.ops.pooling import pool_core, pool_core_bwd_plain

_MAX_SMEM = 232448       # bytes of shared memory one H100 block can use


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("pool_core_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pool_core_fwd.argtypes = [p] * 8 + [i] * 8 + [p]
    lib.pool_core_fwd.restype = ctypes.c_int
    lib.pool_core_fwd_smem_bytes.argtypes = [i, i]   # N, B
    lib.pool_core_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.pool_core_w_frag_floats.argtypes = [i, i]    # K, B
    lib.pool_core_w_frag_floats.restype = ctypes.c_size_t
    lib.pool_core_fwd_error_string.argtypes = [i]
    lib.pool_core_fwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("pool_core_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pool_core_bwd.argtypes = [p] * 19 + [i] * 7 + [p]
    lib.pool_core_bwd.restype = ctypes.c_int
    lib.pool_core_bwd_smem_bytes.argtypes = [i, i]   # N, B
    lib.pool_core_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.pool_core_bwd_w_frag_floats.argtypes = [i, i]    # K, B
    lib.pool_core_bwd_w_frag_floats.restype = ctypes.c_size_t
    lib.pool_core_bwd_grads_smem_bytes.argtypes = [i, i]  # N, B
    lib.pool_core_bwd_grads_smem_bytes.restype = ctypes.c_size_t
    lib.pool_core_bwd_tie_words.argtypes = [i]
    lib.pool_core_bwd_tie_words.restype = ctypes.c_int
    lib.pool_core_bwd_error_string.argtypes = [i]
    lib.pool_core_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(a, u, W2, b2, valid, **same_as_pooled):
    """Shapes, devices, contiguity and types of the core's arguments;
    ``same_as_pooled`` are further float32 ``[R, S, N, B]`` tensors."""
    if a.dim() != 4:
        raise ValueError(f"a must be [R, S, N, K], got {tuple(a.shape)}")
    R, S, N, K = a.shape
    B = W2.shape[-1]
    want = {"a": (a, (R, S, N, K)), "u": (u, (R, S, N, K)),
            "W2": (W2, (R, K, B)), "b2": (b2, (R, B)),
            "valid": (valid, (R, S, N))}
    want.update({k: (t, (R, S, N, B)) for k, t in same_as_pooled.items()})
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("a", a), ("u", u), ("valid", valid),
                    *same_as_pooled.items()):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if W2.dtype not in (torch.float32, torch.bfloat16) or b2.dtype != W2.dtype:
        raise TypeError("W2 and b2 must both be float32 or both bfloat16, "
                        f"got {W2.dtype} and {b2.dtype}")
    if K % 4:
        raise ValueError(f"K={K} must be a multiple of 4 (16-byte rows)")
    if a.data_ptr() % 16 or u.data_ptr() % 16:
        raise ValueError("a and u must be 16-byte aligned")
    return R, S, N, K, B


def _check_smem(smem: int, N: int, B: int) -> None:
    if smem > _MAX_SMEM:
        raise ValueError(f"N={N}, B={B} need {smem} bytes of shared memory "
                         f"per block, more than the {_MAX_SMEM} available")


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else 0


def pool_core_fwd(a: torch.Tensor, u: torch.Tensor, W2: torch.Tensor,
                  b2: torch.Tensor, valid: torch.Tensor, bf16: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replica-stacked pair core: a/u ``[R, S, N, K]`` f32, W2 ``[R, K, B]``
    and b2 ``[R, B]`` (f32 or bf16), valid ``[R, S, N]`` f32 ->
    (pooled, cnt) ``[R, S, N, B]`` f32. Rows at invalid i are undefined
    (zeros past each scene's extent); callers re-mask them. ``bf16``
    selects the bfloat16 mode (``relu(a_j − u_i)`` and W2 rounded to
    bfloat16, float32 accumulation)."""
    R, S, N, K, B = _check(a, u, W2, b2, valid)
    if not a.is_cuda:
        return pool_core(a, u, W2, b2, valid, bf16=bf16)
    lib = _lib()
    _check_smem(lib.pool_core_fwd_smem_bytes(N, B), N, B)
    pooled = torch.empty((R, S, N, B), dtype=torch.float32, device=a.device)
    cnt = torch.empty_like(pooled)
    wf = torch.empty(R * lib.pool_core_w_frag_floats(K, B),
                     dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.pool_core_fwd(
        a.data_ptr(), u.data_ptr(), W2.data_ptr(), b2.data_ptr(),
        valid.data_ptr(), wf.data_ptr(), pooled.data_ptr(), cnt.data_ptr(),
        R, S, N, K, B, int(W2.dtype == torch.bfloat16), int(bf16),
        _device_index(a), stream)
    if err:
        raise RuntimeError("pool_core_fwd launch failed: "
                           + lib.pool_core_fwd_error_string(err).decode())
    if bf16:
        pool_core_fwd.launches_bf16 += 1
    else:
        pool_core_fwd.launches += 1
    return pooled, cnt


pool_core_fwd.launches = 0
pool_core_fwd.launches_bf16 = 0


def pool_core_bwd(a: torch.Tensor, u: torch.Tensor, W2: torch.Tensor,
                  b2: torch.Tensor, valid: torch.Tensor,
                  pooled: torch.Tensor, cnt: torch.Tensor,
                  dpool: torch.Tensor, weight_grads: bool = True,
                  debug: Optional[dict] = None, bf16: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor,
                             Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Backward of the pair core from the forward's arguments, its outputs
    (pooled, cnt) and the cotangent dpool ``[R, S, N, B]`` ->
    (da, du ``[R, S, N, K]``, dW2 ``[R, K, B]``, db2 ``[R, B]``), all f32;
    dW2 and db2 are None when ``weight_grads`` is false (W2/b2 constants).
    Rows at invalid i carry no gradient whatever dpool holds there.

    ``debug``, when a dict, receives what the kernel's first pass found:
    ``recount`` ``[R, S, N, B]`` (how many valid j it saw equal the forward's
    max — equal to ``cnt`` iff it recomputed the forward's values exactly)
    and ``ties`` ``[R, S, N, N, B]`` bool (the (i, j, b) it propagates
    through). On CPU tensors both come from the plain version. ``bf16``
    selects the bfloat16 mode: the forward's recompute in that mode, and
    the cotangent, W2 and ``relu(a_j − u_i)`` rounded to bfloat16 in the
    products of ``dh1`` and ``dW2`` (``db2`` sums the unrounded cotangent).
    """
    R, S, N, K, B = _check(a, u, W2, b2, valid, pooled=pooled, cnt=cnt,
                           dpool=dpool)
    if W2.dtype != torch.float32:
        raise TypeError("pool_core_bwd takes float32 W2/b2 (bfloat16 "
                        f"weights are a serving-only input), got {W2.dtype}")
    if not a.is_cuda:
        da, du, dW2, db2 = pool_core_bwd_plain(a, u, W2, b2, valid, pooled,
                                               cnt, dpool, debug=debug,
                                               bf16=bf16)
        return (da, du, dW2, db2) if weight_grads else (da, du, None, None)
    lib = _bwd_lib()
    _check_smem(max(lib.pool_core_bwd_smem_bytes(N, B),
                    lib.pool_core_bwd_grads_smem_bytes(N, B)), N, B)
    dev = a.device
    NW = lib.pool_core_bwd_tie_words(N)
    f32 = dict(dtype=torch.float32, device=dev)
    bits = torch.zeros((2, R, S, N, B, NW), dtype=torch.int32, device=dev)
    da = torch.empty((R, S, N, K), **f32)
    du = torch.empty_like(da)
    W2t = W2.transpose(1, 2).contiguous()
    dW2 = db2 = dW2p = db2p = recount = None
    if weight_grads:
        dW2, db2 = torch.empty((R, K, B), **f32), torch.empty((R, B), **f32)
        dW2p = torch.empty((R * S, B, K), **f32)
        db2p = torch.empty((R * S, B), **f32)
    if debug is not None:
        recount = torch.empty((R, S, N, B), **f32)
    wf = torch.empty(R * lib.pool_core_bwd_w_frag_floats(K, B), **f32)
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.pool_core_bwd(
        a.data_ptr(), u.data_ptr(), W2.data_ptr(), W2t.data_ptr(),
        b2.data_ptr(), valid.data_ptr(), pooled.data_ptr(), cnt.data_ptr(),
        dpool.data_ptr(), bits[0].data_ptr(), bits[1].data_ptr(),
        ptr(dW2p), ptr(db2p), da.data_ptr(), du.data_ptr(), ptr(dW2),
        ptr(db2), ptr(recount), wf.data_ptr(), R, S, N, K, B, int(bf16),
        _device_index(a), stream)
    if err:
        raise RuntimeError("pool_core_bwd launch failed: "
                           + lib.pool_core_bwd_error_string(err).decode())
    if bf16:
        pool_core_bwd.launches_bf16 += 1
    else:
        pool_core_bwd.launches += 1
    if debug is not None:
        shifts = torch.arange(32, device=dev, dtype=torch.int32)
        ties = ((bits[0][..., None] >> shifts) & 1).bool()   # [R,S,i,B,NW,32]
        debug["ties"] = ties.reshape(R, S, N, B, NW * 32)[..., :N] \
            .transpose(-1, -2)                               # [R,S,i,j,B]
        debug["recount"] = recount
    return da, du, dW2, db2


pool_core_bwd.launches = 0
pool_core_bwd.launches_bf16 = 0


class PoolCore(torch.autograd.Function):
    """``pooled, cnt = PoolCore.apply(a, u, W2, b2, valid[, bf16])``: the
    pair core with its hand-written backward (K1 forward, K2 backward on
    CUDA tensors; the plain versions on CPU tensors). ``cnt`` is not
    differentiable and ``valid`` gets no gradient. ``bf16`` (default False)
    is the mode of both kernels: the backward takes its own forward's,
    whatever the precision setting says by then.

    Under ``torch.func.vmap`` the rule :meth:`vmap` moves each batched
    argument's vmapped dimension to the front, broadcasts an unbatched one
    to the batch size (a weight shared by every replica, the scenes' shared
    ``valid``), merges the two leading axes into R and calls
    :meth:`apply` once on the merged tensors: autograd records one node, so
    the backward is one K2 launch with R = batch × R as well."""

    @staticmethod
    def forward(a, u, W2, b2, valid, bf16=False):
        return pool_core_fwd(a, u, W2, b2, valid, bf16=bool(bf16))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:5], *output)
        ctx.mark_non_differentiable(output[1])
        ctx.bf16 = bool(inputs[5]) if len(inputs) > 5 else False
        ctx.n_inputs = len(inputs)

    @staticmethod
    @once_differentiable
    def backward(ctx, dpool, _dcnt):
        a, u, W2, b2, valid, pooled, cnt = ctx.saved_tensors
        need_w = ctx.needs_input_grad[2] or ctx.needs_input_grad[3]
        da, du, dW2, db2 = pool_core_bwd(a, u, W2, b2, valid, pooled, cnt,
                                         dpool.contiguous(),
                                         weight_grads=need_w, bf16=ctx.bf16)
        return (da, du, dW2, db2) + (None,) * (ctx.n_inputs - 4)

    @staticmethod
    def vmap(info, in_dims, a, u, W2, b2, valid, bf16=False):
        n = info.batch_size

        def fold(t, dim):
            t = (t.expand(n, *t.shape) if dim is None
                 else t.movedim(dim, 0))
            return t.reshape(-1, *t.shape[2:]).contiguous()

        pooled, cnt = PoolCore.apply(*(fold(t, dim) for t, dim in zip(
            (a, u, W2, b2, valid), in_dims)), bf16)
        return ((pooled.view(n, -1, *pooled.shape[1:]),
                 cnt.view(n, -1, *cnt.shape[1:])), (0, 0))
