"""The arithmetic of the tensor-core LSTM kernels (the backwards K6,
``csrc/lstm_proj_bwd.cu``, and K4, ``csrc/lstm_fused_bwd.cu``, and the
forwards K3, ``csrc/lstm_fused_fwd.cu``, and K5, ``csrc/lstm_proj_fwd.cu``)
on the CPU: a plain emulation of the kernels' 3xTF32 products, written here
and not in the package (the port keeps one plain version of each,
``ops/lstm.py:lstm_proj_bwd_plain``, ``fused_recurrence_bwd_plain``,
``_fused_fwd_plain`` and ``lstm_proj_fwd_plain``).
Per step a kernel forms dz in float32, splits it into TF32 hi + lo (10
mantissa bits, to nearest, ties away from zero, as ``cvt.rna.tf32.f32``),
and runs its two products as ``lo_a hi_b + hi_a lo_b + hi_a hi_b``: K6
``[dh_carry | dxs] = dz · [W_hh ; W_ih]ᵀ`` and ``[dW_hh ; dW_ih] += [h |
x]ᵀ · dz``, K4 ``dh_carry = dz · Wᵀ`` and ``dW += hᵀ · dz``; db is a
float32 column sum and K4's dgx the float32 dz.

K6's emulation is held against the JAX package's LSTM
(``grouptraj/ops/lstm.py:lstm_scan``, its scan route: the same function as
``pallas_lstm.py``'s kernels, without interpret mode) at "highest"
precision, with dys, dhT and dcT all non-zero, at the encoders' widths (D =
16, H = 32 and 48, batch cut) and at the smallest and widest widths built
(D = 4, H = 8; D = 16, H = 64). K4's is held against the JAX package's
``pallas_fused.py`` kernels themselves, run in interpret mode, at the
encoders' widths (H = 32 and 48, gx variant, dys, dhT and dcT all
non-zero), the decoder variant (H = 32, dys) and the widest width (H = 64).
The split's error has to fit well inside the kernels' tolerance on the card
(``LSTM_BWD_RTOL = 1e-4`` in chip_smoke.py). Tolerance here: 1e-5 of each
gradient's largest entry; the split drops lo_a lo_b and the bits below hi +
lo, ~2^-21 of each product.

K3's step is ``z = pre + (lo_h hi_W + hi_h lo_W + hi_h hi_W)`` (pre = gx_t
or b, the product summed from zero) with the gate math as the kernel forms
it (each activation from one exp and one correctly rounded reciprocal),
held against the forward rules of ``pallas_fused.py``'s
``lstm_recurrence_pallas`` and ``decoder_recurrence_pallas`` (their
``_fwd_kernel``, in interpret mode, which also give the residuals gates and
cs) at the encoders' widths (gx variant), the decoder variant and the
widest width, every output within 1e-5 absolute (``LSTM_FWD_ATOL`` in
chip_smoke.py, the kernel's tolerance on the card).

K5's step is ``z = (lo_a hi_W + hi_a lo_W + hi_a hi_W) + b`` with ``a =
[x_t | h_{t-1}]`` and ``W = [W_ih ; W_hh]`` (the product from zero, d
before h, b last: the JAX kernel's order) and K3's gate math, held against
``pallas_lstm.py:_lstm_pallas_fwd_impl`` (its ``_fwd_kernel``, in interpret
mode, which also gives the residuals) at the encoders' widths (D = 16, H =
32 and 48), the smallest (D = 4, H = 8: half a k-step of x, which the
kernel pads with zeros) and the widest (H = 64), every output within 1e-5
absolute.
"""

import jax
import numpy as np
import pytest
import torch

import grouptraj.ops.pallas_fused as PF
import grouptraj.ops.pallas_lstm as PL
from grouptraj.ops.lstm import lstm_scan as jax_lstm_scan
from grouptraj_torch.ops.lstm import _fused_fwd_plain, lstm_proj_fwd_plain


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


def _product(a, b):
    """a @ b as K6's mma sums it: lo_a hi_b + hi_a lo_b + hi_a hi_b."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return al @ bh + ah @ bl + ah @ bh


def _dz(gates_t, cp, dht, dc):
    """One step's dz [B, 4H] and dc_carry, in float32, as the kernels form
    them in the first product's accumulator layout."""
    gi, gf, gg, go = gates_t.split(gates_t.shape[-1] // 4, dim=-1)
    tc = torch.tanh(gf * cp + gi * gg)
    dcc = dc + dht * go * (1 - tc * tc)
    dz = torch.cat([dcc * gg * gi * (1 - gi), dcc * cp * gf * (1 - gf),
                    dcc * gi * (1 - gg * gg), dht * tc * go * (1 - go)],
                   dim=-1)
    return dz, dcc * gf


def _k6_3xtf32(w_ih, w_hh, xs, h0, c0, ys, gates, cs, dys, dhT, dcT):
    """K6's backward with its products split as on the tensor cores.
    -> (dxs, dw_ih, dw_hh, db, dh0, dc0)."""
    T, _, D = xs.shape
    H = w_hh.shape[0]
    wcat_t = torch.cat([w_hh, w_ih]).t()                   # [4H, H + D]
    dh, dc = dhT.clone(), dcT.clone()
    dw = torch.zeros(H + D, 4 * H)
    db = torch.zeros(4 * H)
    dxs = torch.empty_like(xs)
    for t in reversed(range(T)):
        cp = cs[t - 1] if t else c0
        hp = ys[t - 1] if t else h0
        dz, dc = _dz(gates[t], cp, dh + dys[t], dc)
        db = db + dz.sum(dim=0)
        out = _product(dz, wcat_t)                         # [B, H + D]
        dh, dxs[t] = out[:, :H], out[:, H:]
        dw = dw + _product(torch.cat([hp, xs[t]], dim=-1).t(), dz)
    return dxs, dw[H:], dw[:H], db, dh, dc


def _k4_3xtf32(w, h0, c0, ys, gates, cs, dys, dhT, dcT, with_gx):
    """K4's backward with its products split as on the tensor cores; a
    cotangent that is None counts as zero. -> (dgx or None, dw, db or None,
    dh0, dc0)."""
    T = ys.shape[0]
    dh = torch.zeros_like(h0) if dhT is None else dhT.clone()
    dc = torch.zeros_like(c0) if dcT is None else dcT.clone()
    dw = torch.zeros_like(w)
    db = None if with_gx else torch.zeros(w.shape[1])
    dgx = torch.empty_like(gates) if with_gx else None
    for t in reversed(range(T)):
        cp = cs[t - 1] if t else c0
        hp = ys[t - 1] if t else h0
        dz, dc = _dz(gates[t], cp, dh + (0 if dys is None else dys[t]), dc)
        if with_gx:
            dgx[t] = dz
        else:
            db = db + dz.sum(dim=0)
        dh = _product(dz, w.t())
        dw = dw + _product(hp.t(), dz)
    return dgx, dw, db, dh, dc


def _forward(step, h0, c0, T):
    """T steps of a forward kernel with its gate math as the kernels form
    it: sigmoid(x) = 1 / (1 + exp(-x)), x clamped at -80, and tanh(x) = 2
    sigmoid(2x) - 1; ``step(t, h)`` gives z_t. -> (ys, hT, cT, gates,
    cs)."""
    H = h0.shape[1]
    sigmoid = lambda x: 1 / (1 + torch.exp(-x.clamp(min=-80)))
    tanh = lambda x: 2 * sigmoid(2 * x) - 1
    h, c, ys, gates, cs = h0, c0, [], [], []
    for t in range(T):
        zi, zf, zg, zo = step(t, h).split(H, dim=-1)
        i, f, g, o = sigmoid(zi), sigmoid(zf), tanh(zg), sigmoid(zo)
        c = f * c + i * g
        h = o * tanh(c)
        ys.append(h)
        gates.append(torch.cat([i, f, g, o], dim=-1))
        cs.append(c)
    return torch.stack(ys), h, c, torch.stack(gates), torch.stack(cs)


def _k3_3xtf32(w, gx, b, h0, c0, T):
    """K3's forward with its product split as on the tensor cores, ``z =
    pre + split product`` (pre = gx_t, or b where gx is None)."""
    return _forward(lambda t, h: (gx[t] if gx is not None else b)
                    + _product(h, w), h0, c0, T)


def _k5_3xtf32(w_ih, w_hh, b, xs, h0, c0):
    """K5's forward: ``z = [x_t | h] · [W_ih ; W_hh]`` split as on the
    tensor cores, from zero, then ``+ b``."""
    w = torch.cat([w_ih, w_hh])
    return _forward(lambda t, h: _product(torch.cat([xs[t], h], dim=-1), w)
                    + b, h0, c0, xs.shape[0])


def _close(got, want):
    for name, g in got.items():
        r = np.asarray(want[name])
        err = np.abs(g.numpy() - r).max()
        assert err <= 1e-5 * np.abs(r).max(), (name, err)


@pytest.mark.parametrize("T,B,D,H", [(20, 64, 16, 48), (8, 64, 16, 32),
                                     (5, 9, 4, 8), (4, 33, 16, 64)])
def test_split_emulation_matches_jax(T, B, D, H):
    rng = np.random.default_rng(T * B + H)
    u = lambda *s: (rng.uniform(-1, 1, s) / np.sqrt(H)).astype(np.float32)
    n = lambda *s: (0.5 * rng.normal(size=s)).astype(np.float32)
    p = {"w_ih": u(D, 4 * H), "w_hh": u(H, 4 * H), "b_ih": u(4 * H),
         "b_hh": u(4 * H)}
    xs, h0, c0 = n(T, B, D), n(B, H), n(B, H)
    dys, dhT, dcT = n(T, B, H), n(B, H), n(B, H)

    def jax_fn(w_ih, w_hh, b_ih, b_hh, xs, h0, c0):
        params = {"w_ih": w_ih, "w_hh": w_hh, "b_ih": b_ih, "b_hh": b_hh}
        ys, (h, c) = jax_lstm_scan(params, xs, h0, c0, impl="scan")
        return ys, h, c

    args = [p[k] for k in ("w_ih", "w_hh", "b_ih", "b_hh")] + [xs, h0, c0]
    _, vjp = jax.vjp(jax_fn, *args)
    ref = vjp((dys, dhT, dcT))

    t = lambda x: torch.from_numpy(np.asarray(x))
    w_ih, w_hh = t(p["w_ih"]), t(p["w_hh"])
    ys, _, _, gates, cs = lstm_proj_fwd_plain(
        w_ih, w_hh, t(p["b_ih"]) + t(p["b_hh"]), t(xs), t(h0), t(c0), True)
    dxs, dw_ih, dw_hh, db, dh0, dc0 = _k6_3xtf32(
        w_ih, w_hh, t(xs), t(h0), t(c0), ys, gates, cs, t(dys), t(dhT),
        t(dcT))
    want = {"dw_ih": ref[0], "dw_hh": ref[1], "db": ref[2], "dxs": ref[4],
            "dh0": ref[5], "dc0": ref[6]}
    got = {"dw_ih": dw_ih, "dw_hh": dw_hh, "db": db, "dxs": dxs, "dh0": dh0,
           "dc0": dc0}
    _close(got, want)


@pytest.mark.parametrize("T,B,H,with_gx", [(20, 40, 48, True),
                                           (8, 64, 32, True),
                                           (11, 40, 32, False),
                                           (4, 33, 64, True)])
def test_k4_split_emulation_matches_pallas(monkeypatch, T, B, H, with_gx):
    orig = PF.pl.pallas_call

    def interpreted(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(PF.pl, "pallas_call", interpreted)
    rng = np.random.default_rng(T * B + H)
    n = lambda scale, *s: (scale * rng.normal(size=s)).astype(np.float32)
    w, h0, c0 = n(1 / np.sqrt(H), H, 4 * H), n(0.5, B, H), n(0.5, B, H)
    gx_or_b = n(0.5, T, B, 4 * H) if with_gx else n(0.1, 4 * H)
    dys, dhT, dcT = n(0.5, T, B, H), n(0.5, B, H), n(0.5, B, H)
    if with_gx:
        _, vjp = jax.vjp(lambda *a: PF.lstm_recurrence_pallas(*a),
                         w, gx_or_b, h0, c0)
        dw_j, dgx_j, dh0_j, dc0_j = vjp((dys, (dhT, dcT)))
        want = {"dgx": dgx_j, "dw": dw_j, "dh0": dh0_j, "dc0": dc0_j}
    else:
        _, vjp = jax.vjp(
            lambda *a: PF.decoder_recurrence_pallas(*a, T), w, gx_or_b, h0,
            c0)
        dw_j, db_j, dh0_j, dc0_j = vjp(dys)
        want = {"dw": dw_j, "db": db_j, "dh0": dh0_j, "dc0": dc0_j}
        dhT = dcT = None

    t = lambda x: None if x is None else torch.from_numpy(np.asarray(x))
    gx, b = (t(gx_or_b), None) if with_gx else (None, t(gx_or_b))
    ys, _, _, gates, cs = _fused_fwd_plain(t(w), gx, b, t(h0), t(c0), T,
                                           True)
    dgx, dw, db, dh0, dc0 = _k4_3xtf32(t(w), t(h0), t(c0), ys, gates, cs,
                                       t(dys), t(dhT), t(dcT), with_gx)
    got = {"dw": dw, "dh0": dh0, "dc0": dc0}
    got.update({"dgx": dgx} if with_gx else {"db": db})
    _close(got, want)


@pytest.mark.parametrize("T,B,H,with_gx", [(20, 40, 48, True),
                                           (8, 64, 32, True),
                                           (11, 40, 32, False),
                                           (4, 33, 64, True)])
def test_k3_split_emulation_matches_pallas(monkeypatch, T, B, H, with_gx):
    orig = PF.pl.pallas_call

    def interpreted(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(PF.pl, "pallas_call", interpreted)
    rng = np.random.default_rng(T * B + H + 1)
    n = lambda scale, *s: (scale * rng.normal(size=s)).astype(np.float32)
    w, h0, c0 = n(1 / np.sqrt(H), H, 4 * H), n(0.5, B, H), n(0.5, B, H)
    gx_or_b = n(1.0, T, B, 4 * H) if with_gx else n(0.1, 4 * H)
    if with_gx:
        (ys, hT, cT), res = PF._lstm_recur_fwd(w, gx_or_b, h0, c0)
        want = {"ys": ys, "hT": hT, "cT": cT}
    else:
        ys, res = PF._dec_recur_fwd(w, gx_or_b, h0, c0, T)
        want = {"ys": ys}
    want["gates"], want["cs"] = res[4][:, :B], res[5][:, :B]

    t = lambda x: torch.from_numpy(np.asarray(x))
    gx, b = (t(gx_or_b), None) if with_gx else (None, t(gx_or_b))
    ys, hT, cT, gates, cs = _k3_3xtf32(t(w), gx, b, t(h0), t(c0), T)
    got = {"ys": ys, "gates": gates, "cs": cs}
    if with_gx:
        got.update(hT=hT, cT=cT)
    for name, g in got.items():
        err = np.abs(g.numpy() - np.asarray(want[name])).max()
        assert err <= 1e-5, (name, err)


@pytest.mark.parametrize("T,B,D,H", [(20, 40, 16, 48), (8, 64, 16, 32),
                                     (5, 9, 4, 8), (4, 33, 16, 64)])
def test_k5_split_emulation_matches_pallas(monkeypatch, T, B, D, H):
    orig = PL.pl.pallas_call

    def interpreted(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(PL.pl, "pallas_call", interpreted)
    rng = np.random.default_rng(T * B + D + H)
    n = lambda scale, *s: (scale * rng.normal(size=s)).astype(np.float32)
    w_ih, w_hh = n(1 / np.sqrt(H), D, 4 * H), n(1 / np.sqrt(H), H, 4 * H)
    b, xs, h0, c0 = n(0.1, 4 * H), n(1.0, T, B, D), n(0.5, B, H), n(0.5, B, H)
    ys, hT, cT, gates, cs = PL._lstm_pallas_fwd_impl(w_ih, w_hh, b, xs, h0,
                                                     c0)
    want = {"ys": ys, "hT": hT, "cT": cT, "gates": gates[:, :B],
            "cs": cs[:, :B]}

    t = lambda x: torch.from_numpy(np.asarray(x))
    got = dict(zip(("ys", "hT", "cT", "gates", "cs"), _k5_3xtf32(
        t(w_ih), t(w_hh), t(b), t(xs), t(h0), t(c0))))
    for name, g in got.items():
        err = np.abs(g.numpy() - np.asarray(want[name])).max()
        assert err <= 1e-5, (name, err)
