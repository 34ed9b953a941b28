"""The port's generator and Predictor against the JAX package on the zoo
checkpoint ``zara1_12`` (the ``gat`` preset at full width), float32 on the
CPU, with the same injected noise on both sides.

Tolerances: the context (encoder → pool → GAT) atol 1e-5, float32 both
sides with a different summation order; positions atol 1e-4 m, since
12-step cumulative sums of the decoder's displacements (coordinates of a
few metres) carry the per-step rounding forward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grouptraj.compat import config_from_checkpoint_args as jax_config
from grouptraj.compat import import_generator
from grouptraj.models.generator import generator_context as jax_context
from grouptraj.models.generator import generator_sample_many as jax_sample
from grouptraj.models.generator import sample_noises as jax_sample_noises
from grouptraj.serve import Predictor as JaxPredictor
from grouptraj.train.checkpoint import load_checkpoint as jax_load
from grouptraj_torch.compat import (
    config_from_checkpoint_args, generator_state,
)
from grouptraj_torch.models.generator import TrajectoryGenerator
from grouptraj_torch.serve import Predictor

CKPT = "models/grouptraj/zara1_12_with_model.pt"
K = 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: one torch thread a process keeps the workers of
    a parallel test run from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def zoo():
    ckpt = jax_load(CKPT)
    state = ckpt["g_best_state"]
    return state, jax_config(ckpt["args"], state)


def _scene(n, seed):
    r = np.random.default_rng(seed)
    steps = r.normal(scale=0.3, size=(n, 8, 2)).astype(np.float32)
    return np.cumsum(steps, axis=1) + r.normal(
        scale=3.0, size=(n, 1, 2)).astype(np.float32)


def _batch(S=3, N=8, seed=0):
    """Scenes of 8, 5 and 2 pedestrians with two groups and ungrouped
    pedestrians, padded to [S, N]."""
    rng = np.random.default_rng(seed)
    obs = np.zeros((S, N, 8, 2), np.float32)
    valid = np.zeros((S, N), np.float32)
    grp = np.zeros((S, N), np.float32)
    for s, n in enumerate((8, 5, 2)[:S]):
        obs[s, :n] = _scene(n, seed + s)
        valid[s, :n] = 1
        grp[s, :n] = rng.integers(0, 3, n)
    rel = np.zeros_like(obs)
    rel[:, :, 1:] = obs[:, :, 1:] - obs[:, :, :-1]
    rel *= valid[..., None, None]
    return obs, rel, grp, valid


def test_context_and_sample_many_match(zoo):
    state, cfg = zoo
    params = import_generator(state)
    obs, rel, grp, valid = _batch()
    keys = jax.random.split(jax.random.PRNGKey(1), K)
    ctx_ref = jax_context(params, cfg, obs, rel, grp, valid, keys[0],
                          train=False)
    pred_ref = jax_sample(params, cfg, ctx_ref, obs, rel, grp, valid, keys,
                          train=False)
    noises = jax_sample_noises(cfg, keys, 3, 8, jnp.float32)

    model = TrajectoryGenerator(cfg).eval()
    model.load_state_dict(generator_state(state))
    t = lambda x: torch.from_numpy(np.array(x))
    with torch.no_grad():
        ctx = model.generator_context(t(obs), t(rel), t(grp), t(valid))
        pred = model.generator_sample_many(ctx, t(rel), t(valid), K,
                                           user_noises=t(noises))
    np.testing.assert_allclose(ctx.numpy(), np.asarray(ctx_ref), atol=1e-5,
                               rtol=0)
    assert pred.shape == (K, 3, 8, cfg.pred_len, 2)
    np.testing.assert_allclose(np.cumsum(pred.numpy(), axis=-2),
                               np.cumsum(np.asarray(pred_ref), axis=-2),
                               atol=1e-4, rtol=0)


def test_predictor_matches_jax_predictor(zoo):
    state, cfg = zoo
    scenes = [_scene(7, 10), _scene(3, 11), _scene(12, 12)]
    groups = [np.array([1, 1, 0, 2, 2, 2, 0], np.float32), None,
              np.arange(12, dtype=np.float32) % 3]
    key = jax.random.PRNGKey(5)
    ref = JaxPredictor(import_generator(state), cfg, num_samples=K,
                       param_dtype=None).predict_batch(scenes, groups, key)
    port = Predictor(state, cfg, num_samples=K, param_dtype=None,
                     device="cpu")
    S, N = port._s_bucket(3), port._bucket(12)
    noises = jax_sample_noises(cfg, jax.random.split(key, K), S, N,
                               jnp.float32)
    out = port.predict_batch(scenes, groups, noises=np.array(noises))
    for o, r, s in zip(out, ref, scenes):
        assert o.shape == (K, s.shape[0], cfg.pred_len, 2)
        np.testing.assert_allclose(o, np.asarray(r), atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def predictor(zoo):
    state, cfg = zoo
    return Predictor(state, cfg, num_samples=K, param_dtype=None,
                     device="cpu")


def test_buckets(predictor):
    assert [predictor._bucket(n) for n in (1, 8, 9, 33, 64, 65, 130)] == [
        8, 8, 16, 64, 64, 128, 192]
    assert [predictor._s_bucket(s) for s in (1, 2, 5, 64, 257)] == [
        1, 4, 16, 64, 512]
    outs = predictor.predict_batch([_scene(3, 1), _scene(11, 2)])
    assert [o.shape for o in outs] == [(K, 3, 12, 2), (K, 11, 12, 2)]
    assert all(np.isfinite(o).all() for o in outs)


def test_pad_scenes_do_not_perturb(predictor):
    """All-invalid pad scenes (the s_bucket filler) leave the real scenes'
    outputs bit-identical: scenes are independent through the model."""
    a, b, c = _scene(3, 20), _scene(4, 21), _scene(5, 22)
    noises = torch.randn((K, 4, 8, 8), generator=torch.Generator().manual_seed(0))
    two = predictor.predict_batch([a, b], noises=noises)
    three = predictor.predict_batch([a, b, c], noises=noises)  # same S=4
    np.testing.assert_array_equal(two[0], three[0])
    np.testing.assert_array_equal(two[1], three[1])


def test_bad_shape_raises(predictor):
    with pytest.raises(ValueError):
        predictor.predict(np.zeros((4, 5, 2), np.float32))


def test_bf16_weights_stay_close(zoo, predictor):
    """Default bfloat16 weights, upcast at each use: finite and close to
    float32 serving on the same noise. bf16 rounds every weight by up to
    2^-9 relative; on these scenes that moves positions by ~4 cm on
    average and ~20 cm at most over the 12-step horizon, so the bounds are
    0.1 m mean and 0.5 m max."""
    state, cfg = zoo
    bf16 = Predictor(state, cfg, num_samples=K, device="cpu")
    assert bf16.model.encoder.encoder.weight_hh_l0.dtype == torch.bfloat16
    scenes = [_scene(6, 30), _scene(9, 31)]
    noises = torch.randn((K, 4, 16, 8), generator=torch.Generator().manual_seed(1))
    ref = predictor.predict_batch(scenes, noises=noises)
    out = bf16.predict_batch(scenes, noises=noises)
    d = np.concatenate([np.linalg.norm(o - r, axis=-1).ravel()
                        for o, r in zip(out, ref)])
    assert all(np.isfinite(o).all() for o in out)
    assert d.mean() < 0.1 and d.max() < 0.5


def test_default_device_needs_cuda(zoo, monkeypatch):
    state, cfg = zoo
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(state, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor.from_checkpoint(CKPT, device="cuda")


def test_other_pool_impls_agree(zoo, predictor):
    """pool_impl 'pair' (the reference-shaped oracle) serves the same
    futures as the default decomposed path."""
    state, cfg = zoo
    pair = Predictor(state, dataclasses.replace(cfg, pool_impl="pair"),
                     num_samples=K, param_dtype=None, device="cpu")
    scenes = [_scene(5, 40), _scene(7, 41)]
    noises = torch.randn((K, 4, 8, 8), generator=torch.Generator().manual_seed(2))
    for o, r in zip(pair.predict_batch(scenes, noises=noises),
                    predictor.predict_batch(scenes, noises=noises)):
        np.testing.assert_allclose(o, r, atol=1e-4, rtol=0)


def test_port_config_equals_jax_config(zoo):
    state, cfg = zoo
    ckpt_args = jax_load(CKPT)["args"]
    port_cfg = config_from_checkpoint_args(ckpt_args, state)
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(cfg)
