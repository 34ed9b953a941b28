"""The port's graph modules of the ``gat-mh`` and ``gcn-pool`` models
against the JAX package on the CPU, float32 both sides:

- ``batch_gat`` (both ``adj_mode``s, both ``concat_mode``s, ``norm`` on and
  off, padded scenes and an all-padding scene), ``gat_encoder_mh``,
  ``gcn`` and ``gcn_pooling`` at atol 1e-5 on the same inputs and weights;
- the 6 zoo files of those models: the generator context at atol 1e-5 and
  the k-sample positions at atol 1e-4 m with JAX's noise injected (the
  12-step cumulative sums of a few metres carry each step's rounding);
- ``params_from_jax`` of both models equals ``export_state_dicts``.
"""

import glob
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grouptraj.compat import config_from_checkpoint_args as jax_config
from grouptraj.compat import import_generator
from grouptraj.compat.torch_import import export_state_dicts
from grouptraj.config import MODEL_PRESETS, ModelConfig as JaxModelConfig
from grouptraj.models import init_generator
from grouptraj.models.generator import generator_context as jax_context
from grouptraj.models.generator import generator_sample_many as jax_sample
from grouptraj.models.generator import sample_noises as jax_sample_noises
from grouptraj.models.modules import gat_encoder_mh as jax_gat_encoder_mh
from grouptraj.models.modules import gcn_pooling as jax_gcn_pooling
from grouptraj.models.modules import init_gat_encoder_mh, init_gcn_pooling
from grouptraj.ops.groups import intra_group_adjacency as jax_intra
from grouptraj.ops.groups import normalize_adjacency as jax_normalize
from grouptraj.train.checkpoint import load_checkpoint as jax_load
from grouptraj_torch.compat import (
    config_from_checkpoint_args, generator_state, params_from_jax,
)
from grouptraj_torch.models.generator import TrajectoryGenerator
from grouptraj_torch.models.modules import gat_encoder_mh, gcn_pooling
from grouptraj_torch.ops.gat import batch_gat
from grouptraj_torch.ops.gcn import gcn

JAX_GAT = importlib.import_module("grouptraj.ops.gat")
JAX_GCN = importlib.import_module("grouptraj.ops.gcn")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPH_ZOO = sorted(
    p for p in glob.glob(os.path.join(ROOT, "models/grouptraj/*.pt"))
    if os.path.basename(p)[:-len("_with_model.pt")] in {
        "univ_12", "univ_8", "univ_12_gatmh", "zara2_12", "zara2_12_gatmh",
        "zara1_12_gcnpool"})
K = 4


def _name(path):
    return os.path.basename(path)[:-len("_with_model.pt")]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops here are small. With torch's default of a thread
    per core, the workers of a parallel test run spin against each other
    (an eval pass measured ~125x slower with six workers); one thread a
    process avoids that."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree(x):
    return jax.tree_util.tree_map(_t, jax.device_get(x))


def _batch(seed=0, S=4, N=10, To=8):
    """Scenes of 10, 6, 1 and 0 pedestrians (the last all padding), group
    labels in {0, 1, 2, 3}, random-walk observations."""
    r = np.random.default_rng(seed)
    valid = np.zeros((S, N), np.float32)
    for s, n in enumerate((10, 6, 1, 0)[:S]):
        valid[s, :n] = 1
    steps = r.normal(scale=0.3, size=(S, N, To, 2)).astype(np.float32)
    obs = (np.cumsum(steps, axis=2)
           + r.normal(scale=3.0, size=(S, N, 1, 2)).astype(np.float32))
    obs *= valid[..., None, None]
    rel = np.zeros_like(obs)
    rel[:, :, 1:] = obs[:, :, 1:] - obs[:, :, :-1]
    grp = (r.integers(0, 4, (S, N)) * valid).astype(np.float32)
    return obs, rel, grp, valid


@pytest.mark.parametrize("norm", [False, True], ids=["plain", "norm"])
@pytest.mark.parametrize("adj_mode,concat_mode",
                         [("mix", "transpose"), ("mix", "view"),
                          ("none", "transpose"), ("none", "view")])
def test_batch_gat(adj_mode, concat_mode, norm):
    """float32 without ``norm``; float64 both sides with it. The attention
    logit ``leakyrelu(src_i + dst_j)`` softmaxed over j hardly depends on
    i, so a layer's rows are nearly equal across a scene's pedestrians,
    and the instance norm before the next layer scales their differences
    (and the rounding of either side) by up to 1/sqrt(eps) = 316: the
    float32 results of two correct implementations differ by ~1e-4 there,
    float64 ones by ~1e-11."""
    r = np.random.default_rng(1)
    dtype = np.float64 if norm else np.float32
    with jax.enable_x64(norm):
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, dtype)),
            JAX_GAT.init_batch_gat(jax.random.PRNGKey(2), [12, 6, 7, 5],
                                   [3, 2, 1]))
        # a non-zero bias, so that it is held too
        params["layer_stack"][0]["bias"] = jnp.asarray(
            r.normal(size=6).astype(dtype))
        _, _, grp, valid = _batch(3)
        x = r.normal(size=(4, 10, 12)).astype(dtype) * valid[..., None]
        adj = jax_normalize(jax_intra(jnp.asarray(grp), jnp.asarray(valid)))
        adj = jnp.asarray(np.asarray(adj, dtype))
        ref = JAX_GAT.batch_gat(params, x, adj, valid.astype(dtype), 0.2,
                                adj_mode=adj_mode, concat_mode=concat_mode,
                                norm=norm)
        assert ref.dtype == dtype
        got = batch_gat(_tree(params), _t(x), _t(adj), _t(valid), 0.2,
                        adj_mode, concat_mode, norm)
    assert got.shape == (4, 10, 5) and got.numpy().dtype == dtype
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_gat_encoder_mh():
    params = init_gat_encoder_mh(jax.random.PRNGKey(4), (40, 16, 40), (4, 1))
    _, _, grp, valid = _batch(5)
    x = np.random.default_rng(6).normal(size=(4, 10, 40)).astype(np.float32)
    for kw in ({}, {"adj_mode": "none", "concat_mode": "view",
                    "norm": True}):
        ref = jax_gat_encoder_mh(params, x, grp, valid, 0.2, **kw)
        got = gat_encoder_mh(_tree(params), _t(x), _t(grp), _t(valid), 0.2,
                             **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=0)
        assert not got.numpy()[valid == 0].any()


def test_gcn_and_gcn_pooling():
    r = np.random.default_rng(7)
    obs, rel, grp, valid = _batch(8)
    adj = jax_normalize(jax_intra(jnp.asarray(grp), jnp.asarray(valid)))
    gparams = JAX_GCN.init_gcn(jax.random.PRNGKey(9), 12, 20, 6, 3)
    x = r.normal(size=(4, 10, 12)).astype(np.float32)
    np.testing.assert_allclose(
        gcn(_tree(gparams), _t(adj), _t(x)).numpy(),
        np.asarray(JAX_GCN.gcn(gparams, adj, x)), atol=1e-5, rtol=1e-6)
    pparams = init_gcn_pooling(jax.random.PRNGKey(10), 16, 32, 72, 16, 2)
    h = r.normal(size=(4, 10, 32)).astype(np.float32) * valid[..., None]
    last_rel = rel[:, :, -1]
    ref = np.asarray(jax_gcn_pooling(pparams, h, last_rel, grp, valid))
    got = gcn_pooling(_tree(pparams), _t(h), _t(last_rel), _t(grp),
                      _t(valid)).numpy()
    # GCN weights are standard normal: features of a few hundred
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-6)
    assert not got[valid == 0].any()


@pytest.mark.parametrize("preset", ["gat-mh", "gcn-pool"])
def test_params_from_jax_graph_presets(preset):
    cfg = (JaxModelConfig(graph_module="gat-mh", mlp_decoder_context=True)
           if preset == "gat-mh" else MODEL_PRESETS["gcn-pool"])
    params = jax.device_get(init_generator(jax.random.PRNGKey(11), cfg))
    ref = export_state_dicts(params, "generator")
    out = params_from_jax(params)
    assert list(out) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    sd = TrajectoryGenerator(cfg).state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: v.shape for k, v in out.items()}


@pytest.mark.parametrize("path", GRAPH_ZOO, ids=_name)
def test_zoo_context_and_positions(path):
    ckpt = jax_load(path)
    state = ckpt["g_best_state"]
    cfg = jax_config(ckpt["args"], state)
    assert cfg.graph_module in ("gat-mh", "none")
    params = import_generator(state)
    obs, rel, grp, valid = _batch(12)
    keys = jax.random.split(jax.random.PRNGKey(13), K)
    ctx_ref = jax_context(params, cfg, obs, rel, grp, valid, keys[0],
                          train=False)
    pred_ref = jax_sample(params, cfg, ctx_ref, obs, rel, grp, valid, keys,
                          train=False)
    noises = jax_sample_noises(cfg, keys, 4, 10, jnp.float32)

    model = TrajectoryGenerator(config_from_checkpoint_args(
        ckpt["args"], state)).eval()
    model.load_state_dict(generator_state(state))
    with torch.no_grad():
        ctx = model.generator_context(_t(obs), _t(rel), _t(grp), _t(valid))
        pred = model.generator_sample_many(ctx, _t(rel), _t(valid), K,
                                           user_noises=_t(noises))
    np.testing.assert_allclose(ctx.numpy(), np.asarray(ctx_ref), atol=1e-5,
                               rtol=0)
    assert pred.shape == (K, 4, 10, cfg.pred_len, 2)
    np.testing.assert_allclose(np.cumsum(pred.numpy(), axis=-2),
                               np.cumsum(np.asarray(pred_ref), axis=-2),
                               atol=1e-4, rtol=0)
