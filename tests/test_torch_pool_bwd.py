"""The port's social-pool backward against the JAX package on the CPU.

- ``pool_core_bwd_plain`` (the plain version of the backward kernel) and
  the ``PoolCore`` autograd function (which runs the plain versions on CPU
  tensors) against ``jax.vjp`` of ``grouptraj.ops.pooling.pool_core`` and
  against the TPU kernel's backward ``pallas_pool._core_bwd`` in Pallas
  interpret mode, including ReLU-zero ties and duplicate-row ties, holes in
  ``valid``, a pad scene, R = 2 and B = 48;
- ``torch.autograd.gradcheck`` of the pair formula in float64;
- ``pool_hidden_net`` gradients (``pair``, ``fast``, ``kernel``) against the
  JAX ``pool_hidden_net``.

Tolerances: da/du 1e-5 and dW2/db2 1e-4, relative to the largest reference
entry (float32 on both sides; the sums run in another order, and dW2/db2
sum over every pair of every scene). Cotangents are zero at invalid rows,
as the callers' re-mask makes them; that the port ignores a non-zero one
there is checked separately.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grouptraj.ops.pooling import init_pool_hidden_net
from grouptraj.ops.pooling import pool_core as jax_pool_core
from grouptraj.ops.pooling import pool_hidden_net as jax_pool_hidden_net
from grouptraj_torch.ops.cuda_pool import PoolCore, pool_core_bwd
from grouptraj_torch.ops.pooling import (
    pool_core, pool_core_bwd_plain, pool_hidden_net,
)

PP = importlib.import_module("grouptraj.ops.pallas_pool")
TOL = {"da": 1e-5, "du": 1e-5, "dW2": 1e-4, "db2": 1e-4}


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
    valid = (rng.uniform(size=(R, S, N)) > 0.3).astype(np.float32)
    valid[:, 0] = 1.0                   # one scene fully valid
    valid[:, 1] = 0.0                   # one with a single valid ped
    valid[:, 1, 0] = 1.0
    return a, u, W2, b2, valid


def _case(name):
    if name in ("N13_B8", "N8_B16", "N24_B8", "N12_B48"):
        N, B = (int(x[1:]) for x in name.split("_"))
        return _data(N=N, B=B, seed=N + B)
    if name == "R2":
        return _data(R=2, seed=2)
    if name == "relu_ties":             # negative pre-activations: 0-ties
        a, u, W2, b2, valid = _data(seed=3)
        return a, u, W2, b2 - 3.0, valid
    if name == "duplicate_rows":        # exact positive ties across j-tiles
        a, u, W2, b2, valid = _data(N=24, seed=4)
        for dst, src in ((2, 1), (17, 0), (22, 3)):
            a[:, :, dst] = a[:, :, src]
        valid[:, :, [0, 1, 2, 3, 17, 22]] = 1.0
        return a, u, W2, b2, valid
    if name == "pad_scene_and_holes":   # an all-invalid scene, interior holes
        a, u, W2, b2, valid = _data(S=4, N=20, seed=5)
        valid[:, 2] = 0.0
        valid[:, 3] = 1.0
        valid[:, 3, 1::3] = 0.0
        return a, u, W2, b2, valid
    raise ValueError(name)


CASES = ["N13_B8", "N8_B16", "N24_B8", "N12_B48", "R2", "relu_ties",
         "duplicate_rows", "pad_scene_and_holes"]


def _cotangent(valid, B, seed=11):
    """dpool [R, S, N, B], zero at invalid rows (the callers' re-mask)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=valid.shape + (B,)) * valid[..., None]
            ).astype(np.float32)


@jax.jit
def _jax_vjp_one(a, u, W2, b2, valid, dpool):
    _, vjp = jax.vjp(lambda *x: jax_pool_core(*x, valid), a, u, W2, b2)
    return vjp(dpool)


def _jax_vjp(a, u, W2, b2, valid, dpool):
    """Per replica, the VJP of the JAX package's plain core (jitted once
    per shape: cases of equal shapes share the compiled reference)."""
    outs = [[np.asarray(g) for g in _jax_vjp_one(a[r], u[r], W2[r], b2[r],
                                                  valid[r], dpool[r])]
            for r in range(a.shape[0])]
    return [np.stack(g) for g in zip(*outs)]


@jax.jit
def _pallas_bwd(a, u, W2, b2, valid, dpool):
    """The TPU kernels' forward and backward (interpreted), jitted once
    per shape: cases of equal shapes share the traced kernels."""
    _, pooled_padded, cnt_padded = PP._core_fwd(a, u, W2, b2, valid)
    return PP._core_bwd(a, u, W2, b2, valid, pooled_padded, cnt_padded,
                        dpool)


def _assert_grads(got, ref, what):
    for (name, tol), g, r in zip(TOL.items(), got, ref):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(
            g, r, rtol=0, atol=tol * max(1.0, np.abs(r).max()),
            err_msg=f"{what} {name}")


@pytest.mark.parametrize("name", CASES)
def test_plain_backward_matches_jax_vjp(name):
    a, u, W2, b2, valid = _case(name)
    dpool = _cotangent(valid, W2.shape[-1])
    ref = _jax_vjp(a, u, W2, b2, valid, dpool)
    ta, tu, tW, tb, tv, td = (_t(x) for x in (a, u, W2, b2, valid, dpool))
    pooled, cnt = pool_core(ta, tu, tW, tb, tv)
    _assert_grads(pool_core_bwd_plain(ta, tu, tW, tb, tv, pooled, cnt, td),
                  ref, "plain")
    _assert_grads(pool_core_bwd(ta, tu, tW, tb, tv, pooled, cnt, td),
                  ref, "wrapper")
    leaves = [x.clone().requires_grad_() for x in (ta, tu, tW, tb)]
    out, out_cnt = PoolCore.apply(*leaves, tv)
    assert not out_cnt.requires_grad
    _assert_grads(torch.autograd.grad(out, leaves, td), ref, "PoolCore")
    if name in ("relu_ties", "duplicate_rows"):
        rows = valid > 0
        assert (cnt.numpy()[rows] > 1).any()
    if name == "duplicate_rows":        # positive ties share the cotangent
        assert ((cnt.numpy() > 1) & (pooled.numpy() > 0))[valid > 0].any()


@pytest.mark.parametrize("name", CASES)
def test_plain_backward_matches_pallas_backward(name):
    a, u, W2, b2, valid = _case(name)
    dpool = _cotangent(valid, W2.shape[-1])
    ref = [np.asarray(g) for g in _pallas_bwd(a, u, W2, b2, valid, dpool)]
    ta, tu, tW, tb, tv, td = (_t(x) for x in (a, u, W2, b2, valid, dpool))
    pooled, cnt = pool_core(ta, tu, tW, tb, tv)
    _assert_grads(pool_core_bwd_plain(ta, tu, tW, tb, tv, pooled, cnt, td),
                  ref, "plain vs pallas")


def test_backward_ignores_cotangent_at_invalid_rows():
    a, u, W2, b2, valid = _case("pad_scene_and_holes")
    B = W2.shape[-1]
    dpool = _cotangent(valid, B)
    noisy = dpool + (1.0 - valid[..., None]) * 7.0
    ta, tu, tW, tb, tv = (_t(x) for x in (a, u, W2, b2, valid))
    pooled, cnt = pool_core(ta, tu, tW, tb, tv)
    clean = pool_core_bwd_plain(ta, tu, tW, tb, tv, pooled, cnt, _t(dpool))
    dirty = pool_core_bwd_plain(ta, tu, tW, tb, tv, pooled, cnt, _t(noisy))
    for c, d in zip(clean, dirty):
        assert torch.equal(c, d)
    # rows and columns of invalid pedestrians receive nothing
    assert (clean[0].numpy()[valid == 0] == 0).all()
    assert (clean[1].numpy()[valid == 0] == 0).all()


def test_backward_debug_outputs_and_weightless_call():
    a, u, W2, b2, valid = _case("duplicate_rows")
    dpool = _cotangent(valid, W2.shape[-1])
    ta, tu, tW, tb, tv, td = (_t(x) for x in (a, u, W2, b2, valid, dpool))
    pooled, cnt = pool_core(ta, tu, tW, tb, tv)
    dbg = {}
    full = pool_core_bwd(ta, tu, tW, tb, tv, pooled, cnt, td, debug=dbg)
    rows = tv > 0
    assert torch.equal(dbg["recount"][rows], cnt[rows])
    want = torch.where(rows[..., None] & (pooled > 0), cnt, 0.0)
    assert torch.equal(dbg["ties"].sum(-2).float(), want)
    # handing the selection back reproduces the result
    again = pool_core_bwd_plain(ta, tu, tW, tb, tv, pooled, cnt, td,
                                ties=dbg["ties"])
    for x, y in zip(full, again):
        assert torch.equal(x, y)
    da, du, dW2, db2 = pool_core_bwd(ta, tu, tW, tb, tv, pooled, cnt, td,
                                     weight_grads=False)
    assert dW2 is None and db2 is None
    assert torch.equal(da, full[0]) and torch.equal(du, full[1])
    with pytest.raises(TypeError):
        pool_core_bwd(ta, tu, tW.bfloat16(), tb.bfloat16(), tv, pooled, cnt,
                      td)
    with pytest.raises(ValueError):
        pool_core_bwd(ta, tu, tW, tb, tv, pooled, cnt, td[..., :4])


def test_poolcore_skips_weight_grads_for_constant_weights():
    a, u, W2, b2, valid = _case("N13_B8")
    ta, tu, tW, tb, tv = (_t(x) for x in (a, u, W2, b2, valid))
    ta.requires_grad_()
    tu.requires_grad_()
    out, _ = PoolCore.apply(ta, tu, tW, tb, tv)
    out.sum().backward()
    assert ta.grad is not None and tu.grad is not None
    assert tW.grad is None and tb.grad is None


def test_pair_formula_gradcheck_float64():
    """The backward formula is the derivative of the forward: numeric
    differences of ``pool_core`` in float64 (distinct values, no ties)."""

    class Core(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, u, W2, b2, valid):
            pooled, cnt = pool_core(a, u, W2, b2, valid)
            ctx.save_for_backward(a, u, W2, b2, valid, pooled, cnt)
            return pooled

        @staticmethod
        def backward(ctx, dpool):
            return (*pool_core_bwd_plain(*ctx.saved_tensors, dpool), None)

    rng = np.random.default_rng(0)
    mk = lambda *s: torch.from_numpy(rng.normal(size=s)).requires_grad_()
    a, u, W2, b2 = mk(2, 5, 6), mk(2, 5, 6), mk(6, 3), mk(3)
    valid = torch.ones(2, 5, dtype=torch.float64)
    valid[1, 3:] = 0
    masked = lambda *x: Core.apply(*x, valid) * valid[..., None]
    assert torch.autograd.gradcheck(masked, (a, u, W2, b2), eps=1e-6,
                                    atol=1e-6)


@pytest.fixture(scope="module")
def pool_hidden_net_case():
    """Inputs and the JAX package's gradients (``impl='pair'``, jitted),
    shared by the three port implementations."""
    S, N, E, H, B = 3, 11, 16, 32, 8
    rng = np.random.default_rng(7)
    p = init_pool_hidden_net(jax.random.PRNGKey(0), E, H, B)
    h = rng.normal(size=(S, N, H)).astype(np.float32)
    pos = (4.0 * rng.normal(size=(S, N, 2))).astype(np.float32)
    valid = (rng.uniform(size=(S, N)) > 0.4).astype(np.float32)
    w = np.sin(np.arange(S * N * B, dtype=np.float32)).reshape(S, N, B)

    def jax_loss(p, h, pos):
        return jnp.sum(jax_pool_hidden_net(p, h, pos, valid, impl="pair") * w)

    grads = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2)))(p, h, pos)
    return p, h, pos, valid, w, grads


@pytest.mark.parametrize("impl", ["pair", "fast", "kernel"])
def test_pool_hidden_net_gradients_match(impl, pool_hidden_net_case):
    p, h, pos, valid, w, (gp, gh, gpos) = pool_hidden_net_case
    tp = jax.tree_util.tree_map(lambda x: _t(x).requires_grad_(), p)
    th, tpos = _t(h).requires_grad_(), _t(pos).requires_grad_()
    out = pool_hidden_net(tp, th, tpos, _t(valid), impl=impl)
    (out * _t(w)).sum().backward()
    pairs = [(th.grad, gh, "h"), (tpos.grad, gpos, "pos")]
    pairs += [(t.grad, r, "param") for t, r in zip(
        jax.tree_util.tree_leaves(tp), jax.tree_util.tree_leaves(gp))]
    for got, ref, name in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(
            got.numpy(), ref, rtol=0, atol=1e-4 * max(1.0, np.abs(ref).max()),
            err_msg=f"{impl} {name}")
