"""The arithmetic of the tensor-core pool kernels (K1
``csrc/pool_core_fwd.cu`` and K2's recompute, over ``csrc/pool_core.cuh``),
on the CPU: a plain emulation of the kernels' 3xTF32 split, written here
and not in the package (the port keeps one plain version,
``ops/pooling.py``). Every value is rounded to TF32 (10 mantissa bits, to
nearest, ties away from zero, as ``cvt.rna.tf32.f32``), ``x = hi + lo``,
and each product is ``lo_a hi_w + hi_a lo_w + hi_a hi_w``; with bfloat16
weights lo_w is exactly 0 and the kernels run two passes. It is held
against the JAX package's ``grouptraj/ops/pooling.py:pool_core`` at
"highest" precision at the main path's shapes (B = 8 and 48, N = 16 and
64, K = 512), the odd case (N = 70, K = 260, B = 5), a scene wider than
K2's tie-gradient pass stages (N = 256) and a bottleneck wider than one
block's columns (B = 100): the split's error has to fit well inside the
kernels' tolerance on the card (``POOL_ATOL = 1e-4`` in chip_smoke.py).
Tolerance here: 1e-5 of the value scale (max(1, largest |pooled|)); the
split drops lo_a lo_w and the bits of x below hi + lo, ~2^-21 of each
product.
"""

import numpy as np
import pytest
import torch

from grouptraj.ops.pooling import pool_core as jax_pool_core


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: one torch thread a process keeps the workers of
    a parallel test run from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> nearest TF32 value, ties away from zero (cvt.rna)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _pool_3xtf32(a, u, W2, b2, valid):
    """pooled of the pair core with the kernels' split products."""
    xh, xl = _split(torch.relu(a[:, None, :, :] - u[:, :, None, :]))
    wh, wl = _split(W2)
    acc = xl @ wh + xh @ wl + xh @ wh                       # [S, i, j, B]
    o = torch.relu(acc + b2)
    o = o.masked_fill(~(valid[:, None, :, None] > 0), -torch.inf)
    return o.amax(dim=2)


def _data(S, N, K, B, seed, bf16=False):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(S, N, K)).astype(np.float32)
    u = rng.normal(size=(S, N, K)).astype(np.float32)
    W2 = (rng.normal(size=(K, B)) / np.sqrt(K)).astype(np.float32)
    b2 = rng.normal(size=(B,)).astype(np.float32)
    if bf16:
        W2 = torch.from_numpy(W2).bfloat16().float().numpy()
        b2 = torch.from_numpy(b2).bfloat16().float().numpy()
    valid = (rng.uniform(size=(S, N)) > 0.3).astype(np.float32)
    valid[0] = 1.0
    return a, u, W2, b2, valid


def _compare(S, N, K, B, seed, bf16=False):
    a, u, W2, b2, valid = _data(S, N, K, B, seed, bf16)
    got = _pool_3xtf32(*map(torch.from_numpy, (a, u, W2, b2, valid)))
    ref = torch.from_numpy(np.array(jax_pool_core(a, u, W2, b2, valid)))
    rows = torch.from_numpy(valid) > 0
    scale = max(1.0, ref[rows].abs().max().item())
    err = (got - ref)[rows].abs().max().item()
    assert err <= 1e-5 * scale, (err, scale)
    return W2


@pytest.mark.parametrize("S,N,K,B,bf16", [
    (3, 13, 36, 5, False), (2, 64, 512, 48, False), (4, 16, 512, 8, False),
    (2, 64, 512, 8, False), (2, 70, 260, 5, False), (1, 256, 64, 48, False),
    (2, 40, 512, 100, False), (2, 64, 512, 8, True)],
    ids=["small_odd", "full_width_B48", "serving_N16_B8", "G_pool_N64_B8",
         "odd_N70_K260_B5", "wide_N256_B48", "wide_B100", "bf16_B8"])
def test_split_emulation_matches_jax(S, N, K, B, bf16):
    _compare(S, N, K, B, seed=N + B, bf16=bf16)


def test_split_emulation_bf16_weights_needs_two_passes():
    W2 = _compare(2, 40, 512, 48, seed=3, bf16=True)
    hi, lo = _split(torch.from_numpy(W2))
    assert torch.equal(hi, torch.from_numpy(W2))          # bf16 fits in TF32
    assert not lo.any()                                   # lo_w pass is zero
