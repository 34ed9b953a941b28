"""The port's projection-in-kernel LSTM (``impl='pallas'``) against
``grouptraj/ops/pallas_lstm.py`` on the CPU.

The JAX side runs its Pallas kernels in interpret mode (``pallas_call``
patched to ``interpret=True``, as tests/test_pallas_lstm.py does) and the
patch counts the kernels it traces, so a silent scan cannot pass; the
port's CPU tensors take the plain PyTorch versions of kernels K5 and K6
(``lstm_proj_fwd_plain``, ``lstm_proj_bwd_plain``), which the CUDA kernels
are held against on the card (tests/test_torch_cuda.py, chip_smoke.py).
Inputs come from numpy seeds and go through both sides.

Tolerances: forward outputs and residuals 1e-5 absolute (float32 on both
sides, at most 16 + 48 products per gate over T ≤ 20 steps); every
gradient 1e-5 of its largest entry (sums in another order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grouptraj.ops.pallas_lstm as PL
from grouptraj.ops.lstm import lstm_scan as jax_lstm_scan
from grouptraj_torch.ops import cuda_lstm_proj as CP
from grouptraj_torch.ops import lstm as TL


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: one torch thread a process keeps the workers of
    a parallel test run from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def traced(monkeypatch):
    """pallas_call in interpret mode; the list counts the kernels traced."""
    calls = []
    orig = PL.pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(PL.pl, "pallas_call", patched)
    return calls


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


def _close_grads(got, ref, what):
    for name, g, r in zip(("w_ih", "w_hh", "b_ih", "b_hh", "xs", "h0", "c0"),
                          got, ref):
        r = np.asarray(r)
        err = np.abs(g.numpy() - r).max()
        assert err <= 1e-5 * np.abs(r).max(), (what, name, err)


@pytest.mark.parametrize("T,B,D,H", [(8, 100, 16, 32), (5, 8, 4, 8),
                                     (20, 33, 16, 48), (6, 16, 8, 16)])
def test_forward_residuals_and_gradients_match_pallas(T, B, D, H, traced):
    """From a non-zero state, every output (ys, hT, cT) and residual
    (gates, cs) of the forward, and the gradients of all seven inputs for a
    loss on ys, hT and cT (so that dys, dhT and dcT are all non-zero)."""
    p, xs, h0, c0 = _lstm_inputs(T, B, D, H, seed=T * B + D)
    names = ("w_ih", "w_hh", "b_ih", "b_hh")

    def jax_fn(w_ih, w_hh, b_ih, b_hh, xs, h0, c0):
        ys, (h, c) = jax_lstm_scan(dict(zip(names, (w_ih, w_hh, b_ih, b_hh))),
                                   xs, h0, c0, impl="pallas")
        return ys, h, c

    args = [p[k] for k in names] + [xs, h0, c0]
    (ys_j, h_j, c_j), vjp = jax.vjp(jax_fn, *args)
    rng = np.random.default_rng(T)
    cot = [rng.normal(size=np.shape(o)).astype(np.float32)
           for o in (ys_j, h_j, c_j)]
    ref = vjp(tuple(jnp.asarray(c) for c in cot))
    b = p["b_ih"] + p["b_hh"]
    _, _, _, gates_j, cs_j = PL._lstm_pallas_fwd_impl(p["w_ih"], p["w_hh"], b,
                                                      xs, h0, c0)
    assert len(traced) == 3                  # forward, backward, forward

    leaves = [_t(a).requires_grad_() for a in args]
    before = (CP.lstm_proj_fwd.launches, CP.lstm_proj_bwd.launches)
    ys, (h, c) = TL.lstm_scan(dict(zip(names, leaves[:4])), *leaves[4:],
                              impl="pallas")
    for x, y in ((ys, ys_j), (h, h_j), (c, c_j)):
        np.testing.assert_allclose(x.detach().numpy(), np.asarray(y),
                                   atol=1e-5)
    got = torch.autograd.grad((ys, h, c), leaves, [_t(a) for a in cot])
    _close_grads(got, ref, f"T={T} B={B} D={D} H={H}")
    # no kernel on the CPU
    assert (CP.lstm_proj_fwd.launches, CP.lstm_proj_bwd.launches) == before

    _, _, _, gates, cs = CP.lstm_proj_fwd(*(_t(a) for a in (
        p["w_ih"], p["w_hh"], b, xs, h0, c0)), save=True)
    np.testing.assert_allclose(gates.numpy(), np.asarray(gates_j)[:, :B],
                               atol=1e-5)
    np.testing.assert_allclose(cs.numpy(), np.asarray(cs_j)[:, :B], atol=1e-5)


def test_zero_state_by_default(traced):
    p, xs, _, _ = _lstm_inputs(7, 12, 8, 16, seed=4)
    ys_j, (h_j, c_j) = jax_lstm_scan(p, xs, impl="pallas")
    assert traced
    ys, (h, c) = TL.lstm_scan({k: _t(v) for k, v in p.items()}, _t(xs),
                              impl="pallas")
    assert ys.shape == (7, 12, 16) and ys.dtype == torch.float32
    for x, y in ((ys, ys_j), (h, h_j), (c, c_j)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-5)


@pytest.mark.parametrize("cotangents", ["all", "hT only"])
def test_plain_backward_matches_autograd_of_plain_forward(cotangents):
    """K6's plain version (from the saved gates and cell states) against
    PyTorch's autograd through K5's plain version; a cotangent that is None
    counts as zero."""
    T, B, D, H = 6, 13, 4, 8
    rng = np.random.default_rng(7)
    n = lambda *s: _t((0.5 * rng.normal(size=s)).astype(np.float32))
    w_ih, w_hh, b = n(D, 4 * H), n(H, 4 * H), n(4 * H)
    xs, h0, c0 = n(T, B, D), n(B, H), n(B, H)
    dys = n(T, B, H) if cotangents == "all" else None
    dhT = n(B, H)
    dcT = n(B, H) if cotangents == "all" else None

    leaves = [t.clone().requires_grad_() for t in (w_ih, w_hh, b, xs, h0,
                                                   c0)]
    ys, hT, cT, _, _ = TL.lstm_proj_fwd_plain(*leaves)
    loss = sum((o * d).sum() for o, d in ((ys, dys), (hT, dhT), (cT, dcT))
               if d is not None)
    ref = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        ys, _, _, gates, cs = TL.lstm_proj_fwd_plain(w_ih, w_hh, b, xs, h0,
                                                     c0, save=True)
        dxs, dw_ih, dw_hh, db, dh0, dc0 = TL.lstm_proj_bwd_plain(
            w_ih, w_hh, xs, h0, c0, ys, gates, cs, dys, dhT, dcT)
    for g, r in zip((dw_ih, dw_hh, db, dxs, dh0, dc0), ref):
        assert g.shape == r.shape
        assert (g - r).abs().max() <= 1e-5 * max(1.0, r.abs().max())


def test_residuals_saved_only_when_a_gradient_is_wanted():
    p, xs, h0, c0 = _lstm_inputs(5, 7, 4, 8, seed=1)
    params = {k: _t(v) for k, v in p.items()}
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        TL.lstm_scan(params, _t(xs), impl="pallas")     # no leaf wants a grad
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        with torch.no_grad():
            ys, _ = TL.lstm_scan(leaves, _t(xs), impl="pallas")
        assert not saved and not ys.requires_grad
        ys, (hT, _) = TL.lstm_scan(leaves, _t(xs), _t(h0), _t(c0),
                                   impl="pallas")
        assert ys.requires_grad
        # w_ih, w_hh, xs, h0, c0, ys, gates [T, B, 4H], cs (and what the
        # bias sum and the upcasts save: nothing)
        assert sorted(tuple(t.shape) for t in saved) == sorted(
            [(4, 32), (8, 32), (5, 7, 4), (7, 8), (7, 8), (5, 7, 8),
             (5, 7, 32), (5, 7, 8)])
    # a loss on hT alone: the backward runs with dys and dcT None
    grads = torch.autograd.grad(hT.sum(), list(leaves.values()))
    assert all(torch.isfinite(g).all() for g in grads)
    assert TL.lstm_proj_fwd_plain(*(_t(a) for a in (
        p["w_ih"], p["w_hh"], p["b_ih"], xs, h0, c0)))[3:] == (None, None)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    p, xs, h0, c0 = _lstm_inputs(3, 4, 4, 8, seed=0)
    w_ih, w_hh, b, xs, h0, c0 = (_t(a) for a in (p["w_ih"], p["w_hh"],
                                                 p["b_ih"], xs, h0, c0))
    with pytest.raises(TypeError):
        CP.lstm_proj_fwd(w_ih.double(), w_hh, b, xs, h0, c0)
    with pytest.raises(ValueError):
        CP.lstm_proj_fwd(w_ih, w_hh, b[:-1], xs, h0, c0)
    with pytest.raises(ValueError):
        CP.lstm_proj_fwd(w_ih, w_hh, b, xs[:0], h0, c0)         # T = 0
    with pytest.raises(ValueError):
        CP.lstm_proj_fwd(w_ih, w_hh, b, xs[0], h0, c0)          # not [T, B, D]
    with pytest.raises(ValueError):
        CP.lstm_proj_fwd(w_ih.t().contiguous().t(), w_hh, b,
                         xs.transpose(0, 1).contiguous().transpose(0, 1),
                         h0, c0)                             # not contiguous
    with pytest.raises(ValueError):
        CP._check_sizes(3, 4, 2, 32, cuda=True)          # D the kernels lack
    with pytest.raises(ValueError):
        CP._check_sizes(3, 4, 16, 12, cuda=True)         # H the kernels lack
    CP._check_sizes(3, 4, 2, 12, cuda=False)     # the plain version takes it
