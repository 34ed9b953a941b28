"""The arithmetic of the tensor-core LSTM backward (K6,
``csrc/lstm_proj_bwd.cu``) on the CPU: a plain emulation of the kernel's
3xTF32 products, written here and not in the package (the port keeps one
plain version, ``ops/lstm.py:lstm_proj_bwd_plain``). Per step the kernel
forms dz in float32, splits it into TF32 hi + lo (10 mantissa bits, to
nearest, ties away from zero, as ``cvt.rna.tf32.f32``), and runs
``[dh_carry | dxs] = dz · [W_hh ; W_ih]ᵀ`` and ``[dW_hh ; dW_ih] += [h |
x]ᵀ · dz`` as ``lo_a hi_b + hi_a lo_b + hi_a hi_b``; db is a float32 column
sum. The emulation is held against the JAX package's LSTM
(``grouptraj/ops/lstm.py:lstm_scan``, its scan route: the same function as
``pallas_lstm.py``'s kernels, without interpret mode) at "highest"
precision, with dys, dhT and dcT all non-zero, at the encoders' widths (D =
16, H = 32 and 48, batch cut) and at the smallest and widest widths built
(D = 4, H = 8; D = 16, H = 64): the split's error has to fit well inside
the kernel's tolerance on the card (``LSTM_BWD_RTOL = 1e-4`` in
chip_smoke.py). Tolerance here: 1e-5 of each gradient's largest entry; the
split drops lo_a lo_b and the bits below hi + lo, ~2^-21 of each product.
"""

import jax
import numpy as np
import pytest
import torch

from grouptraj.ops.lstm import lstm_scan as jax_lstm_scan
from grouptraj_torch.ops.lstm import lstm_proj_fwd_plain


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
        gi, gf, gg, go = gates[t].split(H, dim=-1)
        cp = cs[t - 1] if t else c0
        hp = ys[t - 1] if t else h0
        dht = dh + dys[t]
        tc = torch.tanh(gf * cp + gi * gg)
        dcc = dc + dht * go * (1 - tc * tc)
        dz = torch.cat([dcc * gg * gi * (1 - gi), dcc * cp * gf * (1 - gf),
                        dcc * gi * (1 - gg * gg), dht * tc * go * (1 - go)],
                       dim=-1)
        dc = dcc * gf
        db = db + dz.sum(dim=0)
        out = _product(dz, wcat_t)                         # [B, H + D]
        dh, dxs[t] = out[:, :H], out[:, H:]
        dw = dw + _product(torch.cat([hp, xs[t]], dim=-1).t(), dz)
    return dxs, dw[H:], dw[:H], db, dh, dc


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
    for name, g in got.items():
        r = np.asarray(want[name])
        err = np.abs(g.numpy() - r).max()
        assert err <= 1e-5 * np.abs(r).max(), (name, err)
