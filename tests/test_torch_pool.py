"""The port's social pooling against the JAX package on the CPU.

- The plain pair core ``grouptraj_torch.ops.pooling.pool_core`` (pooled and
  the tie count ``cnt``) and the kernel wrapper on CPU tensors against the
  TPU kernel's forward ``grouptraj.ops.pallas_pool._core_fwd``, run in
  Pallas interpret mode as tests/test_pallas_pool.py runs it, including its
  tie cases.
- ``pool_hidden_net`` (``pair`` and ``fast``) against the JAX function.

Tolerances: pooled atol 1e-5 (float32 both sides, summation order differs
over K=64); ``cnt`` must be equal, since ties come from equal inputs (ReLU
zeros, duplicated rows) that give bit-equal values on either side.
pool_hidden_net atol 1e-5 plus rtol 1e-5: its outputs reach ~16 and are
float32 sums over the 512-wide hidden layer, ~1e-6 relative apart.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from grouptraj.ops.pooling import init_pool_hidden_net
from grouptraj.ops.pooling import pool_hidden_net as jax_pool_hidden_net
from grouptraj_torch.ops import cuda_pool
from grouptraj_torch.ops.pooling import pool_core, pool_hidden_net

PP = importlib.import_module("grouptraj.ops.pallas_pool")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: one torch thread a process keeps the workers of
    a parallel test run from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    orig = PP.pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(PP.pl, "pallas_call", patched)


def _t(x):
    return torch.from_numpy(np.array(x))


def _data(R=1, S=3, N=13, K=64, B=8, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(R, S, N, K)).astype(np.float32)
    u = rng.normal(size=(R, S, N, K)).astype(np.float32)
    W2 = (rng.normal(size=(R, K, B)) / np.sqrt(K)).astype(np.float32)
    b2 = rng.normal(size=(R, B)).astype(np.float32)
    valid = (rng.uniform(size=(S, N)) > 0.3).astype(np.float32)
    valid[0] = 1.0                      # one scene fully valid
    valid[1] = 0.0                      # one with a single valid ped
    valid[1, 0] = 1.0
    return a, u, W2, b2, valid


def _case(name):
    if name == "B8":
        return _data(B=8, seed=0)
    if name == "B16":
        return _data(N=8, B=16, seed=1)
    if name == "R2":
        return _data(R=2, seed=2)
    if name == "relu_ties":             # negative pre-activations: 0-ties
        a, u, W2, b2, valid = _data(seed=3)
        return a, u, W2, b2 - 3.0, valid
    if name == "duplicate_rows":        # exact positive ties across j-tiles
        a, u, W2, b2, valid = _data(N=24, seed=4)
        for dst, src in ((2, 1), (17, 0), (22, 3)):
            a[:, :, dst] = a[:, :, src]
        valid[:, [0, 1, 2, 3, 17, 22]] = 1.0
        return a, u, W2, b2, valid
    if name == "pad_scene":             # an all-invalid scene and holes
        a, u, W2, b2, valid = _data(S=4, seed=5)
        valid[2] = 0.0
        return a, u, W2, b2, valid
    raise ValueError(name)


CASES = ["B8", "B16", "R2", "relu_ties", "duplicate_rows", "pad_scene"]


@pytest.mark.parametrize("name", CASES)
def test_pool_core_matches_pallas_forward(name):
    a, u, W2, b2, valid = _case(name)
    R, S, N, _ = a.shape
    B = W2.shape[-1]
    validR = np.broadcast_to(valid, (R, S, N))
    ref, _, ref_cnt = PP._core_fwd(a, u, W2, b2, validR)
    ref_cnt = np.asarray(ref_cnt)[:, :S, :N, :B]
    rows = validR > 0                   # invalid i rows are re-masked by callers
    impls = {"pool_core": pool_core(_t(a), _t(u), _t(W2), _t(b2), _t(validR)),
             "wrapper": cuda_pool.pool_core_fwd(
                 _t(a), _t(u), _t(W2), _t(b2), _t(np.ascontiguousarray(validR)))}
    for impl, (pooled, cnt) in impls.items():
        np.testing.assert_allclose(pooled.numpy()[rows], np.asarray(ref)[rows],
                                   atol=1e-5, rtol=0, err_msg=impl)
        np.testing.assert_array_equal(cnt.numpy()[rows], ref_cnt[rows],
                                      err_msg=impl)
    if name in ("relu_ties", "duplicate_rows"):
        assert (impls["pool_core"][1].numpy()[rows] > 1).any()


def test_wrapper_launches_nothing_on_cpu():
    a, u, W2, b2, valid = _case("B8")
    before = cuda_pool.pool_core_fwd.launches
    cuda_pool.pool_core_fwd(_t(a), _t(u), _t(W2), _t(b2), _t(valid[None]))
    assert cuda_pool.pool_core_fwd.launches == before


def test_wrapper_checks_inputs():
    a, u, W2, b2, valid = (_t(x) for x in _case("B8"))
    with pytest.raises(ValueError):
        cuda_pool.pool_core_fwd(a[0], u, W2, b2, valid[None])
    with pytest.raises(TypeError):
        cuda_pool.pool_core_fwd(a.double(), u, W2, b2, valid[None])
    with pytest.raises(ValueError):
        cuda_pool.pool_core_fwd(a, u, W2.transpose(1, 2).contiguous(), b2,
                                valid[None])


@pytest.mark.parametrize("impl", ["pair", "fast", "kernel"])
def test_pool_hidden_net_matches(impl):
    S, N, E, H, B = 4, 21, 16, 32, 8
    rng = np.random.default_rng(7)
    p = init_pool_hidden_net(jax.random.PRNGKey(0), E, H, B)
    h = rng.normal(size=(S, N, H)).astype(np.float32)
    pos = (4.0 * rng.normal(size=(S, N, 2))).astype(np.float32)
    valid = (rng.uniform(size=(S, N)) > 0.4).astype(np.float32)
    ref = jax_pool_hidden_net(p, h, pos, valid, impl="pair")
    out = pool_hidden_net(jax.tree_util.tree_map(_t, p), _t(h), _t(pos),
                          _t(valid), impl=impl)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    fast = jax_pool_hidden_net(p, h, pos, valid, impl="fast")
    np.testing.assert_allclose(out.numpy(), np.asarray(fast), atol=1e-5,
                               rtol=1e-5)
