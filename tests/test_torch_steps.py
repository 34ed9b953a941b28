"""The port's training step against ``grouptraj/train/steps.py`` on the
CPU: from one JAX ``init_train_state`` (bridged with ``params_from_jax``),
one synthetic batch (S=4, N=6, best_k=3, narrow widths) and the draws taken
with JAX — ``sample_noises`` and ``uniform(k_label)`` under the key splits
of ``build_d_step`` / ``build_g_step`` — and injected into the port.

Tolerances (float32 on both sides, ``bf16_nograd=False`` for parity):
losses 1e-5 relative; parameters 1e-6 absolute after one d-step and one
g-step (one Adam step moves a weight by at most its learning rate, 1e-3 for
D and 1e-4 for G, so this is 0.1-1% of a step). Adam's first step is
lr·g/(|g| + 1e-8): where a gradient is zero to rounding (|g| below 1e-8,
seen as a reference update under half a learning rate — a handful of the
inter-group attention weights) it turns rounding noise of 1e-10 in g into
1e-6 of the step, so those entries are held to 5% of the learning rate
instead; 1e-4 absolute after
three iterations (differences compound through Adam's normalisation); sparse vs
dense 1e-5 (another accumulation order over differently shaped batches).
With ``bf16_nograd=True`` only the no-grad legs change: the g-step equals
the float32 one to 1e-5 when the per-scene argmin agrees, and the d-step's
loss stays within 5% (bfloat16 decode of the fake sample).
"""

import copy
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from grouptraj.config import ModelConfig as JaxModelConfig
from grouptraj.config import TrainConfig as JaxTrainConfig
from grouptraj.models.generator import sample_noises as jax_sample_noises
from grouptraj.parallel.data_parallel import synthetic_batch
from grouptraj.train.steps import build_d_step, build_g_step
from grouptraj.train.steps import init_train_state as jax_init_train_state
from grouptraj_torch.compat import (
    discriminator_state, generator_state, params_from_jax, params_to_jax,
)
from grouptraj_torch.config import ModelConfig, TrainConfig
from grouptraj_torch.models.discriminator import TrajectoryDiscriminator
from grouptraj_torch.models.generator import TrajectoryGenerator
from grouptraj_torch.train import steps as TS
from grouptraj_torch.train.device_data import (
    gather_batch, synthetic_device_data,
)

NARROW = dict(embedding_dim=8, encoder_h_dim_g=16, decoder_h_dim_g=16,
              noise_dim=(4,), bottleneck_dim=4, hidden_units=12,
              graph_out_dim=8, encoder_h_dim_d=12, mlp_dim=16, obs_len=4,
              pred_len=5)
TRAIN = dict(best_k=3, batch_size=4, bf16_nograd=False)
S, N, ITERS = 4, 6, 3
JCFG, JTCFG = JaxModelConfig(**NARROW), JaxTrainConfig(**TRAIN)
CFG, TCFG = ModelConfig(**NARROW), TrainConfig(**TRAIN)

# the references skip LLVM's expensive passes, which changes no value;
# XLA's backend optimization level 0 (test_torch_presets.py's cheaper
# pipeline) is not used: it moves the rounding noise of the inter-group
# attention vectors' gradients, which Adam's first step turns into moves
# of up to lr, beyond this file's 5% of lr
_jit = functools.partial(jax.jit, compiler_options=dict(
    xla_llvm_disable_expensive_passes=True))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: one torch thread a process keeps the workers of
    a parallel test run from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_state(params, kind):
    return params_from_jax(jax.device_get(params), kind)


def _draws(it):
    """The draws of iteration ``it`` and the keys that give them to the
    JAX steps (same splits as build_d_step / build_g_step)."""
    key_d, key_g = jax.random.PRNGKey(100 + it), jax.random.PRNGKey(200 + it)
    k_gen, k_label, _ = jax.random.split(key_d, 3)
    d = dict(noise=_t(jax_sample_noises(JCFG, k_gen[None], S, N,
                                        np.float32)[0]),
             label=float(jax.random.uniform(k_label, (), minval=0.7,
                                            maxval=1.2)))
    k_label, k_samples, _ = jax.random.split(key_g, 3)
    sample_keys = jax.random.split(k_samples, TRAIN["best_k"])
    g = dict(noises=_t(jax_sample_noises(JCFG, sample_keys, S, N,
                                         np.float32)),
             label=float(jax.random.uniform(k_label, (), minval=0.7,
                                            maxval=1.2)))
    return key_d, key_g, d, g


@pytest.fixture(scope="module")
def jax_state():
    """The JAX package's initial train state, shared by the module."""
    state = jax_init_train_state(jax.random.PRNGKey(0), JCFG, JTCFG)
    # lift the classifier's last bias so D's trailing ReLU lets scores and
    # gradients through (at the raw init most scores are clipped to 0)
    state.d_params["real_classifier"]["layers"][-1]["linear"]["b"] += 1.0
    return state


@pytest.fixture(scope="module")
def jax_run(jax_state):
    """ITERS iterations of the JAX d-step + g-step: the initial state, and
    after each iteration the losses and both parameter trees."""
    state = jax_state
    batch = synthetic_batch(S, N, JCFG.obs_len, JCFG.pred_len, seed=5)
    d_step = _jit(build_d_step(JCFG, JTCFG))
    g_step = _jit(build_g_step(JCFG, JTCFG))
    init = (_np_state(state.g_params, "generator"),
            _np_state(state.d_params, "discriminator"))
    history = []
    for it in range(ITERS):
        key_d, key_g, _, _ = _draws(it)
        state, ld = d_step(state, batch, key_d)
        state, lg = g_step(state, batch, key_g)
        losses = {k: float(v) for k, v in {**ld, **lg}.items()}
        history.append((losses, _np_state(state.g_params, "generator"),
                        _np_state(state.d_params, "discriminator")))
    return init, {k: np.asarray(v) for k, v in batch.items()}, history


def _port_state(init, tcfg=TCFG, cfg=CFG):
    g, d = TrajectoryGenerator(cfg), TrajectoryDiscriminator(cfg)
    g.load_state_dict(generator_state(init[0]))
    d.load_state_dict(discriminator_state(init[1]))
    return TS.train_state_from_modules(g, d, tcfg)


def _batch(arrays):
    return {k: _t(v) for k, v in arrays.items()}


def _assert_params(module, ref, atol, what, init=None, lr=None):
    """``init`` and ``lr`` mark a first Adam step: entries the reference
    moved by less than lr / 2 (|g| < 1e-8) are held to 5% of lr."""
    got = module.state_dict()
    assert set(got) == set(ref)
    for k, r in ref.items():
        diff = np.abs(got[k].numpy() - r)
        tol = np.full_like(r, atol)
        if init is not None:
            tol[np.abs(r - init[k]) < lr / 2] = 0.05 * lr
        assert (diff <= tol).all(), (what, k, diff.max())


def _assert_losses(got, ref, rtol=1e-5):
    assert set(got) == set(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(float(got[k]), r, rtol=rtol, atol=1e-7,
                                   err_msg=k)


def test_one_iteration_matches_jax(jax_run):
    init, arrays, history = jax_run
    state, batch = _port_state(init), _batch(arrays)
    _, _, d_draw, g_draw = _draws(0)
    g_before = copy.deepcopy(state.g.state_dict())
    d_init = copy.deepcopy(state.d.state_dict())
    losses = TS.d_step(state, batch, CFG, TCFG, **d_draw)
    for k, v in state.g.state_dict().items():         # the d-step leaves G
        assert torch.equal(v, g_before[k]), k
    assert all(p.grad is None for p in state.g.parameters())
    d_before = copy.deepcopy(state.d.state_dict())
    losses.update(TS.g_step(state, batch, CFG, TCFG, **g_draw))
    for k, v in state.d.state_dict().items():         # the g-step leaves D
        assert torch.equal(v, d_before[k]), k
    assert all(p.grad is None for p in state.d.parameters())
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0
               and not v.requires_grad for v in losses.values())
    ref_losses, ref_g, ref_d = history[0]
    _assert_losses(losses, ref_losses)
    assert ref_losses["norm_d"] > 0 and ref_losses["G_discriminator_loss"] > 0
    _assert_params(state.d, ref_d, 1e-6, "D", init[1], TCFG.d_learning_rate)
    _assert_params(state.g, ref_g, 1e-6, "G", init[0], TCFG.g_learning_rate)
    # both moved
    assert any(not torch.equal(v, g_before[k])
               for k, v in state.g.state_dict().items())
    assert any(not torch.equal(v, d_init[k])
               for k, v in state.d.state_dict().items())


def test_clip_engages_and_matches_optax(jax_run):
    """The reference run's generator norm exceeds the clip threshold, so
    the parameters above were matched THROUGH the clip; here the formula
    itself, against torch's own (different) clip."""
    _, _, history = jax_run
    assert history[0][0]["norm_g"] > TCFG.clipping_threshold_g
    grads = [torch.tensor([3.0, 4.0]), torch.tensor([[12.0]])]
    norm = TS.global_norm(grads)
    assert float(norm) == 13.0
    clipped = TS.clip_by_global_norm(grads, norm, 2.0)
    np.testing.assert_allclose(clipped[0].numpy(),
                               np.float32([3.0, 4.0]) / np.float32(13.0) * 2)
    same = TS.clip_by_global_norm(grads, norm, 20.0)
    assert all(torch.equal(a, b) for a, b in zip(same, grads))
    off = TS.clip_by_global_norm(grads, norm, 0.0)
    assert all(a is b for a, b in zip(off, grads))


def test_three_iterations_match_jax(jax_run):
    """Through train_iterations on a device-resident dataset whose first S
    scenes are the batch, the draws injected per iteration."""
    init, arrays, history = jax_run
    state = _port_state(init)
    pad1 = lambda a: np.concatenate([a, np.zeros((1,) + a.shape[1:],
                                                 a.dtype)])
    data = {
        "xy": pad1(np.concatenate([arrays["obs"], arrays["pred"]], 2)),
        "rel": pad1(np.concatenate([arrays["obs_rel"], arrays["pred_rel"]],
                                   2)),
        "group_end": pad1(arrays["group"]), "valid": pad1(arrays["valid"]),
        "loss_mask": pad1(arrays["loss_mask"]),
        "non_linear": pad1(arrays["non_linear"].astype(np.float32))}
    data = {k: _t(v) for k, v in data.items()}
    idx = torch.arange(S).expand(ITERS, 2, S)
    draws = [{"d": [_draws(it)[2]], "g": [_draws(it)[3]]}
             for it in range(ITERS)]
    out = TS.train_iterations(state, data, idx, CFG, TCFG, draws=draws)
    assert all(v.shape == (ITERS,) for v in out.values())
    for it, (ref_losses, _, _) in enumerate(history):
        _assert_losses({k: v[it] for k, v in out.items()}, ref_losses,
                       rtol=1e-4)
    _assert_params(state.g, history[-1][1], 1e-4, "G after 3 iterations")
    _assert_params(state.d, history[-1][2], 1e-4, "D after 3 iterations")


def test_sparse_equals_dense(jax_run):
    init, arrays, _ = jax_run
    batch = _batch(arrays)
    _, _, _, g_draw = _draws(0)
    dense_cfg = dataclasses.replace(TCFG, sparse_best_k=False)
    sparse, dense = _port_state(init), _port_state(init, dense_cfg)
    ls = TS.g_step(sparse, batch, CFG, TCFG, **g_draw)
    ld = TS.g_step(dense, batch, CFG, dense_cfg, **g_draw)
    _assert_losses(ls, {k: float(v) for k, v in ld.items()})
    _assert_params(sparse.g, {k: v.numpy() for k, v in
                              dense.g.state_dict().items()}, 1e-5,
                   "sparse vs dense")


def test_bf16_nograd_steps(jax_run):
    init, arrays, _ = jax_run
    batch = _batch(arrays)
    _, _, d_draw, g_draw = _draws(0)
    bf_cfg = dataclasses.replace(TCFG, bf16_nograd=True)
    f32, bf16 = _port_state(init), _port_state(init, bf_cfg)
    ld32 = TS.d_step(f32, batch, CFG, TCFG, **d_draw)
    ld16 = TS.d_step(bf16, batch, CFG, bf_cfg, **d_draw)
    assert np.isfinite(float(ld16["D_total_loss"]))
    np.testing.assert_allclose(float(ld16["D_total_loss"]),
                               float(ld32["D_total_loss"]), rtol=5e-2)
    # the g-step from the SAME state on both sides: only the probe decode
    # differs, and the update comes from the float32 re-decode
    f32, bf16 = _port_state(init), _port_state(init, bf_cfg)
    lg32 = TS.g_step(f32, batch, CFG, TCFG, **g_draw)
    lg16 = TS.g_step(bf16, batch, CFG, bf_cfg, **g_draw)
    assert all(np.isfinite(float(v)) for v in lg16.values())
    _assert_losses(lg16, {k: float(v) for k, v in lg32.items()})
    _assert_params(bf16.g, {k: v.numpy() for k, v in
                            f32.g.state_dict().items()}, 1e-5, "bf16 vs f32")
    assert all(p.dtype == torch.float32 for p in bf16.g.parameters())


def test_generator_forward_matches_jax(jax_run, jax_state):
    """generator_forward = context + one sample, on an injected noise."""
    from grouptraj.models import generator_forward as jax_generator_forward
    init, arrays, _ = jax_run
    _, _, d_draw, _ = _draws(0)
    ref = _jit(lambda g, *a: jax_generator_forward(g, JCFG, *a))(
        jax_state.g_params, arrays["obs"], arrays["obs_rel"],
        arrays["group"], arrays["valid"], jax.random.PRNGKey(1),
        d_draw["noise"].numpy())
    b = _batch(arrays)
    g = _port_state(init).g
    with torch.no_grad():
        out = g.generator_forward(b["obs"], b["obs_rel"], b["group"],
                                  b["valid"], user_noise=d_draw["noise"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    drawn = g.generator_forward(b["obs"], b["obs_rel"], b["group"],
                                b["valid"],
                                generator=torch.Generator().manual_seed(0))
    assert drawn.shape == out.shape and drawn.requires_grad


def test_ema_follows_generator(jax_run):
    init, arrays, _ = jax_run
    tcfg = dataclasses.replace(TCFG, g_ema_decay=0.9)
    state = _port_state(init, tcfg)
    before = {k: v.clone() for k, v in state.ema_g.items()}
    _, _, _, g_draw = _draws(0)
    TS.g_step(state, _batch(arrays), CFG, tcfg, **g_draw)
    for k, p in state.g.named_parameters():
        np.testing.assert_allclose(
            state.ema_g[k].numpy(),
            (0.9 * before[k] + 0.1 * p.detach()).numpy(), rtol=1e-6,
            atol=1e-8)
    assert _port_state(init).ema_g is None


def test_draws_come_from_the_generator_when_not_injected():
    """init_train_state and the steps are reproducible from seeded
    torch.Generators, and gather_batch pads with the null scene."""
    def run():
        gen = torch.Generator().manual_seed(3)
        state = TS.init_train_state(CFG, TCFG, generator=gen, device="cpu")
        data = synthetic_device_data(5, N, CFG.obs_len, CFG.pred_len, seed=1,
                                     device="cpu")
        idx = torch.tensor([[[0, 1, 2, 5], [3, 4, 5, 5]]])
        out = TS.train_iterations(state, data, idx, CFG, TCFG, generator=gen)
        return out, state, data

    (a, sa, data), (b, sb, _) = run(), run()
    for k in a:
        assert torch.equal(a[k], b[k]) and torch.isfinite(a[k]).all()
    for (k, x), (_, y) in zip(sa.g.state_dict().items(),
                              sb.g.state_dict().items()):
        assert torch.equal(x, y), k
    null = gather_batch(data, torch.tensor([5]), CFG.obs_len)
    assert all(float(v.abs().sum()) == 0 for v in null.values())
    assert null["obs"].shape == (1, N, CFG.obs_len, 2)


def test_dropout_configs_raise(jax_run):
    """``dropout1``, once refused, trains: the g-step's per-sample forward
    (``generator_forward`` under ``torch.func.vmap`` over the samples'
    noise and JAX's keep-masks) equals grouptraj's ``generator_forward``
    vmapped over the same sample keys, positions at 1e-4 m; a d-step and a
    g-step drawing their masks from a generator give finite losses."""
    from grouptraj.models.generator import generator_forward as jax_forward

    init, arrays, _ = jax_run
    cfg = dataclasses.replace(CFG, dropout1=0.1)
    jcfg = dataclasses.replace(JCFG, dropout1=0.1)
    state = _port_state(init, cfg=cfg)
    b = _batch(arrays)
    jparams = jax.tree_util.tree_map(np.asarray, params_to_jax(init[0]))
    keys = jax.random.split(jax.random.PRNGKey(9), TRAIN["best_k"])
    orig = jax.random.bernoulli

    def one(p, a, k):
        masks = []
        with pytest.MonkeyPatch.context() as m:
            m.setattr(jax.random, "bernoulli",
                      lambda *x: masks.append(orig(*x)) or masks[-1])
            pred = jax_forward(p, jcfg, a["obs"], a["obs_rel"], a["group"],
                               a["valid"], k)
        return pred, masks

    # positions only: XLA's cheaper CPU pipeline (test_torch_presets.py's)
    # moves no value beyond the last bits
    preds_ref, stacked = jax.jit(
        jax.vmap(one, in_axes=(None, None, 0)), compiler_options=dict(
            xla_backend_optimization_level=0,
            xla_llvm_disable_expensive_passes=True))(jparams, arrays, keys)
    masks = TS.stacked_sample_masks(cfg, TRAIN["best_k"], S, N, None, "cpu",
                                    [[np.asarray(m[i]) for m in stacked]
                                     for i in range(TRAIN["best_k"])])
    assert masks
    with torch.no_grad():
        preds = TS._per_sample_preds(
            state.g, b, _t(jax_sample_noises(jcfg, keys, S, N, np.float32)),
            masks, "scan")
    np.testing.assert_allclose(preds.numpy(), np.asarray(preds_ref),
                               rtol=0, atol=1e-4)
    gen = torch.Generator().manual_seed(3)
    losses = {**TS.d_step(state, b, cfg, TCFG, gen),
              **TS.g_step(state, b, cfg, TCFG, gen)}
    assert all(bool(torch.isfinite(v)) for v in losses.values())


# the zoo's other two models at narrow widths: gat-mh's first layer takes
# the context (encoder_h 16 + bottleneck 4), gcn-pool's GCNPooling is 12
# wide
OTHER_MODELS = {
    "gat-mh": dict(NARROW, graph_module="gat-mh", mlp_decoder_context=True,
                   mh_n_units=(20, 8, 12), mh_n_heads=(2, 1)),
    "gcn-pool": dict(NARROW, pooling_type="gcn", graph_module="none",
                     mlp_decoder_context=True, bottleneck_dim=6,
                     gcn_hidden_dim=12),
}


@pytest.mark.parametrize("model", sorted(OTHER_MODELS))
def test_other_models_one_iteration_match_jax(model):
    """One d-step + g-step of the gat-mh and gcn-pool models from one JAX
    init, the draws injected: losses 1e-5 relative, parameters 1e-6
    absolute (5% of lr where the reference moved a weight by less than
    lr / 2, as in test_one_iteration_matches_jax). params_to_jax inverts
    params_from_jax on both generators, bit for bit."""
    jcfg, cfg = JaxModelConfig(**OTHER_MODELS[model]), ModelConfig(
        **OTHER_MODELS[model])
    state = jax_init_train_state(jax.random.PRNGKey(0), jcfg, JTCFG)
    state.d_params["real_classifier"]["layers"][-1]["linear"]["b"] += 1.0
    init = (_np_state(state.g_params, "generator"),
            _np_state(state.d_params, "discriminator"))
    back = params_to_jax(init[0], "generator")      # and the inverse
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(state.g_params)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(back),
        jax.tree_util.tree_leaves(jax.device_get(state.g_params))))
    batch = synthetic_batch(S, N, jcfg.obs_len, jcfg.pred_len, seed=5)
    key_d, key_g, d_draw, g_draw = _draws(0)
    state, ld = _jit(build_d_step(jcfg, JTCFG))(state, batch, key_d)
    state, lg = _jit(build_g_step(jcfg, JTCFG))(state, batch, key_g)
    ref_losses = {k: float(v) for k, v in {**ld, **lg}.items()}
    assert ref_losses["norm_d"] > 0 and ref_losses["norm_g"] > 0

    port = _port_state(init, cfg=cfg)
    b = _batch({k: np.asarray(v) for k, v in batch.items()})
    losses = TS.d_step(port, b, cfg, TCFG, **d_draw)
    losses.update(TS.g_step(port, b, cfg, TCFG, **g_draw))
    _assert_losses(losses, ref_losses)
    _assert_params(port.d, _np_state(state.d_params, "discriminator"), 1e-6,
                   f"{model} D", init[1], TCFG.d_learning_rate)
    _assert_params(port.g, _np_state(state.g_params, "generator"), 1e-6,
                   f"{model} G", init[0], TCFG.g_learning_rate)
