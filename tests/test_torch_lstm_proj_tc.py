"""The arithmetic of the tensor-core LSTM backwards (K6,
``csrc/lstm_proj_bwd.cu``, and K4, ``csrc/lstm_fused_bwd.cu``) on the CPU:
a plain emulation of the kernels' 3xTF32 products, written here and not in
the package (the port keeps one plain version of each,
``ops/lstm.py:lstm_proj_bwd_plain`` and ``fused_recurrence_bwd_plain``).
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
"""

import jax
import numpy as np
import pytest
import torch

import grouptraj.ops.pallas_fused as PF
from grouptraj.ops.lstm import lstm_scan as jax_lstm_scan
from grouptraj_torch.ops.lstm import _fused_fwd_plain, lstm_proj_fwd_plain


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
