"""The port's losses against ``grouptraj/losses.py`` on the CPU, on the
same numpy inputs. The label-smoothing scalar y ~ U(0.7, 1.2) is drawn by
JAX from the key the JAX loss uses and injected into the port's.

Tolerance 1e-6 relative (float32 elementwise math and short sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grouptraj import losses as JL
from grouptraj_torch import losses as TL

K, S, N, T = 3, 4, 5, 6


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture
def data():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    valid = (rng.uniform(size=(S, N)) > 0.3).astype(np.float32)
    valid[1] = 0.0                                    # an empty scene
    loss_mask = np.repeat(valid[:, :, None], T, 2)
    loss_mask[0, 0, :2] = 0.0
    return dict(pred_k=f(K, S, N, T, 2), pred=f(S, N, T, 2), gt=f(S, N, T, 2),
                scores_a=f(S, N) * 2, scores_b=f(S, N) * 2, valid=valid,
                loss_mask=loss_mask)


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def _label(key):
    return float(jax.random.uniform(key, (), minval=0.7, maxval=1.2))


@pytest.mark.parametrize("masked", [False, True])
def test_bce_and_gan_losses(data, masked):
    key = jax.random.PRNGKey(3)
    y = _label(key)
    assert 0.7 <= y <= 1.2
    mask = data["valid"] if masked else None
    tmask = _t(mask) if masked else None
    a, b = data["scores_a"], data["scores_b"]
    target = (data["scores_b"] > 0).astype(np.float32)
    _close(TL.bce_loss(_t(a), _t(target), tmask),
           JL.bce_loss(a, target, mask))
    _close(TL.gan_g_loss(_t(a), y, tmask), JL.gan_g_loss(a, key, mask))
    _close(TL.gan_d_loss(_t(a), _t(b), y, tmask),
           JL.gan_d_loss(a, b, key, mask))
    # a tensor label (a device-side draw) gives the same as the float
    _close(TL.gan_d_loss(_t(a), _t(b), torch.tensor(y), tmask),
           JL.gan_d_loss(a, b, key, mask))


@pytest.mark.parametrize("mode", ["sum", "average", "raw"])
def test_l2_loss(data, mode):
    _close(TL.l2_loss(_t(data["pred"]), _t(data["gt"]),
                      _t(data["loss_mask"]), mode),
           JL.l2_loss(data["pred"], data["gt"], data["loss_mask"], mode))


def test_l2_loss_rejects_unknown_mode(data):
    with pytest.raises(ValueError):
        TL.l2_loss(_t(data["pred"]), _t(data["gt"]), _t(data["loss_mask"]),
                   "mean")


@pytest.mark.parametrize("mode", ["sum", "raw"])
@pytest.mark.parametrize("consider", [False, True])
def test_displacement_errors(data, mode, consider):
    c = data["valid"] if consider else None
    tc = _t(c) if consider else None
    _close(TL.displacement_error(_t(data["pred"]), _t(data["gt"]), tc, mode),
           JL.displacement_error(data["pred"], data["gt"], c, mode))
    _close(TL.final_displacement_error(_t(data["pred"][:, :, -1]),
                                       _t(data["gt"][:, :, -1]), tc, mode),
           JL.final_displacement_error(data["pred"][:, :, -1],
                                       data["gt"][:, :, -1], c, mode))


def test_variety_losses(data):
    pk, gt, lm, v = (data[k] for k in ("pred_k", "gt", "loss_mask", "valid"))
    tpk, tgt, tlm, tv = (_t(x) for x in (pk, gt, lm, v))
    w = 0.7
    _close(TL.variety_l2_loss(tpk, tgt, tlm, tv, w),
           JL.variety_l2_loss(pk, gt, lm, v, w))
    per_scene, denom = TL.variety_l2_parts(tpk, tgt, tlm, tv, w)
    ref_ps, ref_den = JL.variety_l2_parts(pk, gt, lm, v, w)
    _close(per_scene, ref_ps)
    _close(denom, ref_den)
    assert float(denom[1]) == 0.0                     # the empty scene
    one = TL.variety_scene_l2(tpk[1], tgt, tlm, tv, w)
    _close(one, JL.variety_scene_l2(pk[1], gt, lm, v, w))
    _close(one, per_scene[1])
    _close(TL.variety_from_scene_l2(per_scene.amin(0), denom),
           JL.variety_from_scene_l2(jnp.min(ref_ps, axis=0), ref_den))


def test_variety_loss_gradient_matches(data):
    """The min over k routes the cotangent to the best sample per scene."""
    pk, gt, lm, v = (data[k] for k in ("pred_k", "gt", "loss_mask", "valid"))
    ref = jax.grad(lambda p: JL.variety_l2_loss(p, gt, lm, v))(pk)
    tpk = _t(pk).requires_grad_()
    TL.variety_l2_loss(tpk, _t(gt), _t(lm), _t(v)).backward()
    _close(tpk.grad, ref)
