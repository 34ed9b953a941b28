"""The port's whole-loop LSTM recurrences (``impl='fused'``) against
``grouptraj/ops/pallas_fused.py`` on the CPU.

The JAX side runs its Pallas kernels in interpret mode (``pallas_call``
patched to ``interpret=True``, as tests/test_pallas_fused.py does); the
port's CPU tensors take the plain PyTorch versions of kernels K3 and K4
(``lstm_recurrence_fused_plain``, ``decoder_recurrence_fused_plain``,
``fused_recurrence_bwd_plain``), which the CUDA kernels are held against on
the card (tests/test_torch_cuda.py, chip_smoke.py). Inputs come from numpy
seeds and go through both sides.

Tolerances: forward 1e-5 absolute (float32 on both sides, H ≤ 48 products
per gate over T ≤ 20 steps); every gradient 1e-4 of its largest entry, the
limit of the JAX package's own kernel tests.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grouptraj.ops.pallas_fused as PF
from grouptraj_torch.config import TrainConfig
from grouptraj_torch.ops import cuda_lstm as CL
from grouptraj_torch.ops import lstm as TL

JL = importlib.import_module("grouptraj.ops.lstm")


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
    orig = PF.pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(PF.pl, "pallas_call", patched)


def _t(x):
    return torch.from_numpy(np.array(x))


def _lstm_inputs(T, B, D, H, seed):
    """LSTM parameters at torch's init scale, xs and a non-zero state."""
    rng = np.random.default_rng(seed)
    u = lambda *s: (rng.uniform(-1, 1, s) / np.sqrt(H)).astype(np.float32)
    p = {"w_ih": u(D, 4 * H), "w_hh": u(H, 4 * H), "b_ih": u(4 * H),
         "b_hh": u(4 * H)}
    n = lambda *s: (0.5 * rng.normal(size=s)).astype(np.float32)
    return p, n(T, B, D), n(B, H), n(B, H)


def _decoder_inputs(T, B, H, seed):
    rng = np.random.default_rng(seed)
    n = lambda scale, *s: (scale * rng.normal(size=s)).astype(np.float32)
    return n(0.3, H, 4 * H), n(0.1, 4 * H), n(1.0, B, H), n(1.0, B, H)


def _close_grads(got, ref, what):
    for i, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        err = np.abs(g.numpy() - r).max()
        assert err <= 1e-4 * np.abs(r).max(), (what, i, err, np.abs(r).max())


@pytest.mark.parametrize("T,B,D,H", [(8, 100, 16, 32), (5, 9, 4, 8),
                                     (20, 40, 16, 48)])
def test_lstm_recurrence_forward_matches_pallas(T, B, D, H):
    p, xs, h0, c0 = _lstm_inputs(T, B, D, H, seed=T + B)
    gx = xs @ p["w_ih"] + (p["b_ih"] + p["b_hh"])
    ys_j, (h_j, c_j) = PF.lstm_recurrence_pallas(p["w_hh"], gx, h0, c0)
    before = CL.lstm_fused_fwd.launches
    ys, (hT, cT) = CL.lstm_recurrence_fused(_t(p["w_hh"]), _t(gx), _t(h0),
                                            _t(c0))
    assert CL.lstm_fused_fwd.launches == before       # no kernel on the CPU
    assert ys.shape == (T, B, H) and ys.dtype == torch.float32
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), atol=1e-5)
    np.testing.assert_allclose(hT.numpy(), np.asarray(h_j), atol=1e-5)
    np.testing.assert_allclose(cT.numpy(), np.asarray(c_j), atol=1e-5)
    np.testing.assert_array_equal(hT.numpy(), ys[-1].numpy())


@pytest.mark.parametrize("T,B,H", [(11, 70, 32), (7, 9, 16)])
def test_decoder_recurrence_forward_matches_pallas(T, B, H):
    w, b, h1, c1 = _decoder_inputs(T, B, H, seed=T + H)
    ref = PF.decoder_recurrence_pallas(w, b, h1, c1, T)
    ys = CL.decoder_recurrence_fused(_t(w), _t(b), _t(h1), _t(c1), T)
    assert ys.shape == (T, B, H)
    np.testing.assert_allclose(ys.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("T,B,D,H", [(8, 50, 16, 32), (6, 16, 8, 16)])
def test_lstm_recurrence_backward_matches_pallas(T, B, D, H):
    """The loss of tests/test_pallas_fused.py: ys, hT and cT all carry a
    cotangent, so dhT and dcT are non-zero."""
    p, xs, h0, c0 = _lstm_inputs(T, B, D, H, seed=T * B)
    gx = xs @ p["w_ih"] + (p["b_ih"] + p["b_hh"])

    def loss_jax(w_hh, gx, h0, c0):
        ys, (h, c) = PF.lstm_recurrence_pallas(w_hh, gx, h0, c0)
        return jnp.sum(ys ** 2) + jnp.sum(h * c)

    ref = jax.grad(loss_jax, argnums=(0, 1, 2, 3))(p["w_hh"], gx, h0, c0)
    leaves = [_t(a).requires_grad_() for a in (p["w_hh"], gx, h0, c0)]
    ys, (h, c) = CL.lstm_recurrence_fused(*leaves)
    got = torch.autograd.grad((ys ** 2).sum() + (h * c).sum(), leaves)
    _close_grads(got, ref, "lstm_recurrence_fused")


def test_decoder_recurrence_backward_matches_pallas():
    T, B, H = 11, 24, 32
    args = _decoder_inputs(T, B, H, seed=3)

    def loss_jax(w, b, h1, c1):
        return jnp.sum(jnp.sin(PF.decoder_recurrence_pallas(w, b, h1, c1, T)))

    ref = jax.grad(loss_jax, argnums=(0, 1, 2, 3))(*args)
    leaves = [_t(a).requires_grad_() for a in args]
    ys = CL.decoder_recurrence_fused(*leaves, T)
    got = torch.autograd.grad(torch.sin(ys).sum(), leaves)
    _close_grads(got, ref, "decoder_recurrence_fused")


@pytest.mark.parametrize("with_gx,cotangents", [
    (True, "all"), (True, "hT only"), (True, "ys only"), (False, "all")])
def test_plain_backward_matches_autograd_of_plain_forward(with_gx,
                                                          cotangents):
    """K4's plain version (from saved gates and cell states) against
    PyTorch's autograd through K3's plain version; a cotangent that is
    None counts as zero."""
    T, B, H = 6, 13, 8
    rng = np.random.default_rng(7)
    n = lambda *s: _t((0.5 * rng.normal(size=s)).astype(np.float32))
    w, h0, c0 = n(H, 4 * H), n(B, H), n(B, H)
    gx, b = (n(T, B, 4 * H), None) if with_gx else (None, n(4 * H))
    dys = n(T, B, H) if cotangents in ("all", "ys only") else None
    dhT = n(B, H) if with_gx and cotangents in ("all", "hT only") else None
    dcT = n(B, H) if with_gx and cotangents == "all" else None

    leaves = [t.clone().requires_grad_() for t in (w, gx if with_gx else b,
                                                   h0, c0)]
    if with_gx:
        ys, hT, cT, _, _ = TL.lstm_recurrence_fused_plain(*leaves)
    else:
        ys, hT, cT, _, _ = TL.decoder_recurrence_fused_plain(*leaves, T)
    loss = sum((o * d).sum() for o, d in ((ys, dys), (hT, dhT), (cT, dcT))
               if d is not None)
    ref = torch.autograd.grad(loss, leaves)

    with torch.no_grad():
        ys, _, _, gates, cs = TL._fused_fwd_plain(w, gx, b, h0, c0, T, True)
        dgx, dw, db, dh0, dc0 = TL.fused_recurrence_bwd_plain(
            w, h0, c0, ys, gates, cs, dys, dhT, dcT, with_gx)
    assert (dgx is None) == (not with_gx) and (db is None) == with_gx
    got = (dw, dgx if with_gx else db, dh0, dc0)
    for g, r in zip(got, ref):
        assert (g - r).abs().max() <= 1e-5 * max(1.0, r.abs().max())


def test_residuals_saved_only_when_a_gradient_is_wanted():
    p, xs, h0, c0 = _lstm_inputs(5, 7, 4, 8, seed=1)
    args = [_t(a) for a in (p["w_hh"], xs @ p["w_ih"], h0, c0)]
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        CL.lstm_recurrence_fused(*args)                # no leaf wants a grad
        leaves = [a.clone().requires_grad_() for a in args]
        with torch.no_grad():
            ys, _ = CL.lstm_recurrence_fused(*leaves)
        assert not saved and not ys.requires_grad
        ys, _ = CL.lstm_recurrence_fused(*leaves)
        assert ys.requires_grad
        # w, h0, c0, ys, gates [T, B, 4H], cs
        assert sorted(tuple(t.shape) for t in saved) == sorted(
            [(8, 32), (7, 8), (7, 8), (5, 7, 8), (5, 7, 32), (5, 7, 8)])
    assert TL.lstm_recurrence_fused_plain(*args)[3:] == (None, None)
    gates, cs = TL.lstm_recurrence_fused_plain(*args, save=True)[3:]
    assert gates.shape == (5, 7, 32) and cs.shape == (5, 7, 8)


def test_low_precision_arguments_are_upcast():
    """The bfloat16 no-grad legs: the kernel's public functions work and
    answer in float32 on the bfloat16-rounded values."""
    w, b, h1, c1 = (_t(a).bfloat16() for a in _decoder_inputs(7, 9, 16, 5))
    with torch.no_grad():
        ys = CL.decoder_recurrence_fused(w, b, h1, c1, 7)
        ref = CL.decoder_recurrence_fused(w.float(), b.float(), h1.float(),
                                          c1.float(), 7)
    assert ys.dtype == torch.float32
    assert torch.equal(ys, ref)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    w, b, h1, c1 = (_t(a) for a in _decoder_inputs(3, 4, 8, 0))
    with pytest.raises(TypeError):
        CL.lstm_fused_fwd(w.double(), h1, c1, b=b, T=3)
    with pytest.raises(ValueError):
        CL.lstm_fused_fwd(w, h1, c1, b=b[:-1], T=3)
    with pytest.raises(ValueError):
        CL.lstm_fused_fwd(w, h1, c1, b=b, T=0)
    with pytest.raises(ValueError):
        CL.lstm_fused_fwd(w, h1, c1)                   # neither gx nor b
    with pytest.raises(ValueError):
        CL.lstm_fused_fwd(w.t(), h1, c1, b=b, T=3)     # shape / contiguity
    with pytest.raises(ValueError):
        CL._check_sizes(3, 4, 129, cuda=True)          # H past the kernels'
    CL._check_sizes(3, 4, 129, cuda=False)         # the plain version takes it


@pytest.mark.parametrize("impl", ["scan", "fused"])
def test_lstm_scan_matches_jax(impl, monkeypatch):
    """``lstm_scan`` of the port against the JAX package's, with the
    backend reported as a TPU so that JAX 'fused' reaches its Pallas kernel
    (on the CPU it would demote itself to the scan)."""
    T, B, D, H = 6, 10, 4, 8
    p, xs, h0, c0 = _lstm_inputs(T, B, D, H, seed=11)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    calls = []
    orig = PF.lstm_recurrence_pallas
    monkeypatch.setattr(PF, "lstm_recurrence_pallas",
                        lambda *a: calls.append(1) or orig(*a))

    def loss_jax(p, xs, h0, c0):
        ys, (h, c) = JL.lstm_scan(p, xs, h0, c0, impl=impl)
        return jnp.sum(ys ** 2) + jnp.sum(h * c), (ys, h, c)

    (_, (ys_j, h_j, c_j)), ref = jax.value_and_grad(
        loss_jax, argnums=(0, 1, 2, 3), has_aux=True)(p, xs, h0, c0)
    assert bool(calls) == (impl == "fused")

    tp = {k: _t(v).requires_grad_() for k, v in p.items()}
    leaves = [_t(a).requires_grad_() for a in (xs, h0, c0)]
    ys, (h, c) = TL.lstm_scan(tp, *leaves, impl=impl)
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(ys_j),
                               atol=1e-5)
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(c_j), atol=1e-5)
    names = sorted(tp)
    got = torch.autograd.grad((ys ** 2).sum() + (h * c).sum(),
                              [tp[k] for k in names] + leaves)
    _close_grads(got, [ref[0][k] for k in names] + list(ref[1:]),
                 f"lstm_scan {impl}")
    # zero state by default, as the JAX package
    ys0, _ = TL.lstm_scan(tp, leaves[0], impl=impl)
    ys0_j, _ = JL.lstm_scan(p, xs, impl=impl)
    np.testing.assert_allclose(ys0.detach().numpy(), np.asarray(ys0_j),
                               atol=1e-5)


@pytest.mark.parametrize("lstm_impl,use_pallas,want", [
    ("auto", False, "scan"), ("scan", False, "scan"),
    ("fused", False, "fused"), ("something else", False, "scan"),
    ("pallas", False, "pallas"), ("fused", True, "pallas")])
def test_select_impl(lstm_impl, use_pallas, want):
    tcfg = TrainConfig(lstm_impl=lstm_impl, use_pallas=use_pallas)
    assert TL.select_impl(None, tcfg) == want


def test_lstm_scan_refuses_unported_routes():
    """An unknown route raises; ``'pallas'`` (ported: kernels K5/K6) runs
    and agrees with ``'scan'``."""
    p, xs, h0, c0 = _lstm_inputs(2, 3, 4, 8, seed=0)
    tp = {k: _t(v) for k, v in p.items()}
    with pytest.raises(ValueError):
        TL.lstm_scan(tp, _t(xs), impl="auto")
    for state in ((), (_t(h0), _t(c0))):
        ys, (h, c) = TL.lstm_scan(tp, _t(xs), *state, impl="pallas")
        ys_s, (h_s, c_s) = TL.lstm_scan(tp, _t(xs), *state, impl="scan")
        for x, y in ((ys, ys_s), (h, h_s), (c, c_s)):
            assert (x - y).abs().max() <= 1e-5
