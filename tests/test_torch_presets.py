"""The port's other presets and paths against the JAX package on the CPU:
the ``gcn`` (GCNModule graph module), ``sgan-p`` (pool + context MLP) and
``sgan`` (no pooling, with the ``local`` discriminator) presets, and the
``gat`` preset with ``pool_every_timestep`` over a PoolHiddenNet and over a
GCNPooling pool-net (the stepwise decoder that re-pools every step).

Widths are the presets' own (G H=32, pool 512→8, decoder MLP 40→64→32, D
H=48 with pool 64→512→48); scenes are tiny (S=4, N=6) and the sequences
short (4 observed, 6 predicted steps). Weights come from one JAX init
(``params_from_jax``), the draws from JAX's key splits, injected into the
port (``user_noises``, ``label``). Tolerances, float32 at "highest"
precision on both sides: context 1e-5 of its largest entry (the GCN's
standard-normal weights make features of ~10^3); positions 1e-4 m; the
discriminator's scores 1e-5; one d-step + g-step: losses 1e-5 relative,
each gradient 1e-6 of its network's largest entry (3e-5 in a network with
a GCN), and the parameters after the step 1e-6 plus what that gradient
bound can move Adam's first step ``lr·g/(|g| + 1e-8)`` — nothing where a
gradient is well above the bound, up to 2 lr where it is within it (the
GAT attention vectors' gradients are zero to rounding, so their first
step is noise of either sign; test_torch_steps.py's caveat). The JAX
gradients come from its own steps, built with an identity optimizer, and
its own clip + Adam applied to them. The references compile with XLA's
cheaper CPU pipeline, which changes no value beyond the last bits. One
case runs the JAX decoder's per-step pool through the Pallas kernel K1 in
interpret mode.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from grouptraj.compat import config_from_checkpoint_args as jax_config
from grouptraj.compat.torch_import import export_state_dicts
from grouptraj.config import MODEL_PRESETS as JAX_PRESETS
from grouptraj.config import ModelConfig as JaxModelConfig
from grouptraj.config import TrainConfig as JaxTrainConfig
from grouptraj.models import init_generator
from grouptraj.models.discriminator import discriminator_forward
from grouptraj.models.generator import generator_context as jax_context
from grouptraj.models.generator import generator_sample_many as jax_sample
from grouptraj.models.generator import sample_noises as jax_sample_noises
from grouptraj.ops.lstm import lstm_cell as jax_lstm_cell
from grouptraj.parallel.data_parallel import synthetic_batch
from grouptraj.train.steps import build_d_step, build_g_step
from grouptraj.train.steps import init_train_state as jax_init_train_state
from grouptraj_torch.compat import (
    adam_from_optax, config_from_checkpoint_args, discriminator_state,
    generator_state, optax_from_adam, params_from_jax, params_to_jax,
)
from grouptraj_torch.config import MODEL_PRESETS, ModelConfig, TrainConfig
from grouptraj_torch.models.discriminator import TrajectoryDiscriminator
from grouptraj_torch.models.generator import (
    TrajectoryGenerator, _decode_folded,
)
from grouptraj_torch.ops.linear import linear
from grouptraj_torch.ops.lstm import lstm_cell
from grouptraj_torch.train import steps as TS
from grouptraj_torch.utils import relative_to_abs

PP = importlib.import_module("grouptraj.ops.pallas_pool")
JSTEPS = importlib.import_module("grouptraj.train.steps")
SHORT = dict(obs_len=4, pred_len=6)
# name -> (preset, changes)
MODELS = {
    "gcn": ("gcn", {}),
    "sgan-p": ("sgan-p", {}),
    "sgan": ("sgan", {"d_type": "local"}),
    "gat-pet": ("gat", {"pool_every_timestep": True}),
    "gat-gcnpool-pet": ("gat", {"pool_every_timestep": True,
                                "pooling_type": "gcn"}),
}
TRAIN = dict(best_k=3, batch_size=4, bf16_nograd=False)
# the references are small: XLA's cheaper CPU compile halves this file's
# time and changes no value beyond the last bits
_jit = functools.partial(jax.jit, compiler_options=dict(
    xla_backend_optimization_level=0, xla_llvm_disable_expensive_passes=True))
JTCFG, TCFG = JaxTrainConfig(**TRAIN), TrainConfig(**TRAIN)
S, N = 4, 6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: one torch thread a process keeps the workers of
    a parallel test run from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name):
    preset, changes = MODELS[name]
    return (dataclasses.replace(JAX_PRESETS[preset], **SHORT, **changes),
            dataclasses.replace(MODEL_PRESETS[preset], **SHORT, **changes))


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_state(params, kind):
    return params_from_jax(jax.device_get(params), kind)


def _draws(jcfg):
    """One iteration's keys and draws (the splits of build_d_step and
    build_g_step, as tests/test_torch_steps.py takes them)."""
    key_d, key_g = jax.random.PRNGKey(100), jax.random.PRNGKey(200)
    k_gen, k_label, _ = jax.random.split(key_d, 3)
    d = dict(noise=_t(jax_sample_noises(jcfg, k_gen[None], S, N,
                                        np.float32)[0]),
             label=float(jax.random.uniform(k_label, (), minval=0.7,
                                            maxval=1.2)))
    k_label, k_samples, _ = jax.random.split(key_g, 3)
    sample_keys = jax.random.split(k_samples, TRAIN["best_k"])
    g = dict(noises=_t(jax_sample_noises(jcfg, sample_keys, S, N,
                                         np.float32)),
             label=float(jax.random.uniform(k_label, (), minval=0.7,
                                            maxval=1.2)))
    return key_d, key_g, d, g


def _jax_state(jcfg):
    state = jax_init_train_state(jax.random.PRNGKey(0), jcfg, JTCFG)
    # lift the classifier's last bias so D's trailing ReLU lets scores and
    # gradients through
    state.d_params["real_classifier"]["layers"][-1]["linear"]["b"] += 1.0
    return state


def _modules(cfg, g_sd, d_sd):
    g, d = TrajectoryGenerator(cfg), TrajectoryDiscriminator(cfg)
    g.load_state_dict(generator_state(g_sd))
    d.load_state_dict(discriminator_state(d_sd))
    return g, d


def _step(tx, apply, grads, opt, params):
    """``tx``'s update of ``params`` by ``grads``, jitted (one compile
    instead of one per leaf operation) -> (params, opt)."""
    @_jit
    def run(grads, opt, params):
        upd, opt = tx.update(grads, opt, params)
        return apply(params, upd), opt
    return run(grads, opt, params)


def _jax_iteration(jcfg, state, batch, monkeypatch):
    """One JAX d-step + g-step, and the gradients each step took. The steps
    are built with an identity optimizer and ``optax.apply_updates``
    patched to hand back the update, so a step returns its gradients in
    place of the parameters; the package's own chain (clip + Adam,
    ``make_optimizers``) is then applied to them, as the step applies it.
    -> (losses, (D grads, G grads), (D, G) after the steps)."""
    key_d, key_g, _, _ = _draws(jcfg)
    g_tx, d_tx = JSTEPS.make_optimizers(JTCFG)
    apply = optax.apply_updates
    ident = optax.GradientTransformation(lambda p: optax.EmptyState(),
                                         lambda u, s, p=None: (u, s))
    with monkeypatch.context() as m:
        m.setattr(JSTEPS, "make_optimizers", lambda tcfg: (ident, ident))
        m.setattr(JSTEPS.optax, "apply_updates", lambda p, u: u)
        out, ld = _jit(build_d_step(jcfg, JTCFG))(state, batch, key_d)
        d_grads = out.d_params
        d_params, d_opt = _step(d_tx, apply, d_grads, state.d_opt,
                                state.d_params)
        state = state._replace(d_params=d_params, d_opt=d_opt)
        out, lg = _jit(build_g_step(jcfg, JTCFG))(state, batch, key_g)
    g_grads = out.g_params
    g_params, _ = _step(g_tx, apply, g_grads, state.g_opt, state.g_params)
    return ({k: float(v) for k, v in {**ld, **lg}.items()},
            (_np_state(d_grads, "discriminator"),
             _np_state(g_grads, "generator")),
            (_np_state(state.d_params, "discriminator"),
             _np_state(g_params, "generator")))


def _assert_grads(module, grads, ref, what):
    """Each gradient tensor within 1e-6 of the network's largest entry, or
    3e-5 in a network with a GCN (standard-normal weights: features of
    ~10^3, whose float32 rounding reaches 1.2e-5 of the largest gradient
    in the per-step gcn-pooling generator). -> that bound."""
    names = [n for n, _ in module.named_parameters()]
    assert set(names) == set(ref), what
    rtol = 3e-5 if any(".W." in n for n in names) else 1e-6
    bound = rtol * max(np.abs(r).max() for r in ref.values())
    for n, g in zip(names, grads):
        err = np.abs(g.numpy() - ref[n]).max()
        assert err <= bound, (what, n, err / bound * rtol)
    return bound


def _assert_params(module, ref, grads, bound, lr, what):
    """After one Adam step: 1e-6 plus what the gradients' ``bound`` can
    move Adam's first step, ``lr·g/(|g| + eps)``, whose slope
    ``eps/(|g| + eps)²`` is largest nearest zero — so ``lr · min(2,
    eps·bound / (max(|g| − bound, 0) + eps)²)`` for a reference gradient
    g: negligible where |g| is well above the bound, up to 2 lr (either
    sign) where g is within it."""
    got = module.state_dict()
    assert set(got) == set(ref), what
    eps = 1e-8
    for k, r in ref.items():
        diff = np.abs(got[k].numpy() - r)
        near = np.maximum(np.abs(grads[k]) - bound, 0.0) + eps
        tol = 1e-6 + lr * np.minimum(2.0, eps * bound / near ** 2)
        assert (diff <= tol).all(), (what, k, diff.max())


def _forward_fn(jcfg):
    """The JAX context, k=3 positions and D's real scores, jitted once."""
    @_jit
    def run(g_params, d_params, b, keys):
        ctx = jax_context(g_params, jcfg, b["obs"], b["obs_rel"], b["group"],
                          b["valid"], keys[0], train=False)
        preds = jax_sample(g_params, jcfg, ctx, b["obs"], b["obs_rel"],
                           b["group"], b["valid"], keys, train=False)
        scores = discriminator_forward(
            d_params, jcfg, jnp.concatenate([b["obs"], b["pred"]], 2),
            jnp.concatenate([b["obs_rel"], b["pred_rel"]], 2), b["valid"],
            train=False)
        return ctx, preds, scores
    return run


@pytest.mark.parametrize("name", sorted(MODELS))
def test_preset_matches_jax(name, monkeypatch):
    """Context, positions of ``generator_sample_many`` and D's scores, then
    one d-step + g-step, against grouptraj from one init and one set of
    draws. The per-step models' g-step takes the dense best-of-k path, as
    the JAX step does (it never re-decodes with ``generator_sample``)."""
    jcfg, cfg = _configs(name)
    state = _jax_state(jcfg)
    init = (_np_state(state.g_params, "generator"),
            _np_state(state.d_params, "discriminator"))
    batch = synthetic_batch(S, N, jcfg.obs_len, jcfg.pred_len, seed=5)
    b = {k: _t(v) for k, v in batch.items()}
    g, d = _modules(cfg, *init)
    assert hasattr(d, "pool_net") == (cfg.d_type == "global")
    assert hasattr(g.decoder, "pool_net") == cfg.pool_every_timestep

    keys = jax.random.split(jax.random.PRNGKey(13), 3)
    ctx_ref, preds_ref, scores_ref = (np.asarray(x) for x in _forward_fn(
        jcfg)(state.g_params, state.d_params, batch, keys))
    noises = _t(jax_sample_noises(jcfg, keys, S, N, jnp.float32))
    with torch.no_grad():
        ctx = g.generator_context(b["obs"], b["obs_rel"], b["group"],
                                  b["valid"])
        preds = g.generator_sample_many(ctx, b["obs_rel"], b["valid"], 3,
                                        user_noises=noises, obs=b["obs"],
                                        group_end=b["group"])
        scores = d(torch.cat([b["obs"], b["pred"]], 2),
                   torch.cat([b["obs_rel"], b["pred_rel"]], 2), b["valid"])
    np.testing.assert_allclose(
        ctx.numpy(), ctx_ref, rtol=0,
        atol=1e-5 * max(1.0, np.abs(ctx_ref).max()))
    last = b["obs"][None, :, :, -1]
    np.testing.assert_allclose(
        relative_to_abs(preds, last).numpy(),
        relative_to_abs(_t(preds_ref), last).numpy(), rtol=0, atol=1e-4)
    valid = batch["valid"] > 0
    assert (scores_ref[valid] > 0).any()
    np.testing.assert_allclose(scores.numpy()[valid], scores_ref[valid],
                               rtol=1e-5, atol=1e-5)

    ref, (d_grads, g_grads), (d_ref, g_ref) = _jax_iteration(
        jcfg, state, batch, monkeypatch)
    assert ref["norm_d"] > 0 and ref["norm_g"] > 0
    _, _, d_draw, g_draw = _draws(jcfg)
    port = TS.train_state_from_modules(g, d, TCFG)
    d_bound = _assert_grads(d, TS.d_gradients(port, b, cfg, TCFG,
                                              **d_draw)[1], d_grads,
                            f"{name} D")
    losses = TS.d_step(port, b, cfg, TCFG, **d_draw)
    g_bound = _assert_grads(g, TS.g_gradients(port, b, cfg, TCFG,
                                              **g_draw)[1], g_grads,
                            f"{name} G")
    redecodes, sample = [], g.generator_sample
    monkeypatch.setattr(g, "generator_sample",
                        lambda *a, **k: redecodes.append(1) or sample(*a, **k))
    losses.update(TS.g_step(port, b, cfg, TCFG, **g_draw))
    assert bool(redecodes) != cfg.pool_every_timestep   # sparse vs dense
    assert set(losses) == set(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(float(losses[k]), r, rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    _assert_params(port.d, d_ref, d_grads, d_bound, TCFG.d_learning_rate,
                   f"{name} D")
    _assert_params(port.g, g_ref, g_grads, g_bound, TCFG.g_learning_rate,
                   f"{name} G")


def test_per_step_pool_through_interpreted_pallas_kernel(monkeypatch):
    """The JAX decoder's per-step pool through the TPU kernel K1
    (``pool_impl='pallas'``, interpreted; the kernel is traced inside the
    decode loop) against the port's decoder on the CPU, both from one
    context: positions at 1e-4 m."""
    traced = []
    orig = PP.pl.pallas_call

    def patched(*a, **k):
        traced.append(1)
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(PP.pl, "pallas_call", patched)
    jcfg, cfg = _configs("gat-pet")
    jcfg = dataclasses.replace(jcfg, pool_impl="pallas")
    params = jax.device_get(init_generator(jax.random.PRNGKey(4), jcfg))
    batch = synthetic_batch(S, N, jcfg.obs_len, jcfg.pred_len, seed=6)
    ctx = np.random.default_rng(6).normal(
        size=(S, N, jcfg.decoder_context_dim)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    preds_ref = _jit(lambda p, c, b, k: jax_sample(
        p, jcfg, c, b["obs"], b["obs_rel"], b["group"], b["valid"], k,
        train=False))(params, ctx, batch, keys)
    assert traced
    g = TrajectoryGenerator(cfg)
    g.load_state_dict(generator_state(params_from_jax(params)))
    b = {k: _t(v) for k, v in batch.items()}
    with torch.no_grad():
        preds = g.generator_sample_many(
            _t(ctx), b["obs_rel"], b["valid"], 3, obs=b["obs"],
            group_end=b["group"],
            user_noises=_t(jax_sample_noises(jcfg, keys, S, N, jnp.float32)))
    last = b["obs"][None, :, :, -1]
    np.testing.assert_allclose(
        relative_to_abs(preds, last).numpy(),
        relative_to_abs(_t(preds_ref), last).numpy(), rtol=0, atol=1e-4)


def test_stepwise_decoder_matches_folded_without_pooling():
    """With the flag off the decoder's folded recurrence (on every route's
    CPU version) equals a brute-force embed → lstm_cell → hidden2pos loop
    (the port's counterpart of tests/test_models.py::
    test_decode_folded_matches_stepwise); lstm_cell equals the JAX one."""
    cfg = ModelConfig()
    jparams = jax.device_get(init_generator(jax.random.PRNGKey(7),
                                            JaxModelConfig()))
    g = TrajectoryGenerator(cfg)
    g.load_state_dict(generator_state(params_from_jax(jparams)))
    dec = g.decoder.tree()
    rng = np.random.default_rng(0)
    Sd, Nd, H = 3, 8, cfg.decoder_h_dim_g
    h0 = torch.from_numpy(rng.normal(size=(Sd, Nd, H)).astype(np.float32))
    rel0 = torch.from_numpy(rng.normal(size=(Sd, Nd, 2)).astype(np.float32))
    valid = torch.from_numpy((rng.random((Sd, Nd)) < 0.8).astype(np.float32))
    c0 = torch.from_numpy(rng.normal(size=(Sd * Nd, H)).astype(np.float32))
    x = linear(dec["spatial_embedding"], rel0.reshape(-1, 2))
    with torch.no_grad():
        got_cell = lstm_cell(dec["lstm"], x, h0.reshape(-1, H), c0)
    ref_cell = jax_lstm_cell(jparams["decoder"]["lstm"], x.detach().numpy(),
                             h0.reshape(-1, H).numpy(), c0.numpy())
    for a, r in zip(got_cell, ref_cell):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)

    with torch.no_grad():
        h, c = h0.reshape(Sd * Nd, H), torch.zeros(Sd * Nd, H)
        rel, rels = rel0.reshape(Sd * Nd, 2), []
        for _ in range(cfg.pred_len):
            h, c = lstm_cell(dec["lstm"],
                             linear(dec["spatial_embedding"], rel), h, c)
            rel = linear(dec["hidden2pos"], h)
            rels.append(rel)
        want = torch.stack(rels, 1).reshape(Sd, Nd, cfg.pred_len, 2) \
            * valid[..., None, None]
        for impl in ("scan", "fused", "pallas"):
            got = _decode_folded(dec, cfg, h0, rel0, valid, impl)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=impl)


def test_new_trees_round_trip_with_adam_moments():
    """For every new model: ``params_from_jax`` gives
    ``export_state_dicts``' keys in its order and the port module's names
    and shapes; ``params_to_jax`` inverts it bit for bit; the Adam moments
    of a stepped port optimizer cross as an optax state over the JAX
    package's own tree and back. A gcn-era reference file's config
    resolves as in grouptraj, and its dead ``mlp_decoder_context`` is
    dropped on load."""
    for name in MODELS:
        jcfg, cfg = _configs(name)
        state = jax_init_train_state(jax.random.PRNGKey(1), jcfg, JTCFG)
        for kind, params, opt, clip in (
                ("generator", state.g_params, state.g_opt,
                 JTCFG.clipping_threshold_g),
                ("discriminator", state.d_params, state.d_opt,
                 JTCFG.clipping_threshold_d)):
            tree = jax.device_get(params)
            sd = params_from_jax(tree, kind)
            assert list(sd) == list(export_state_dicts(tree, kind)), name
            back = params_to_jax(sd, kind)
            assert (jax.tree_util.tree_structure(back)
                    == jax.tree_util.tree_structure(tree)), (name, kind)
            assert all(np.array_equal(a, b) for a, b in zip(
                jax.tree_util.tree_leaves(back),
                jax.tree_util.tree_leaves(tree))), (name, kind)
            module = (TrajectoryGenerator if kind == "generator"
                      else TrajectoryDiscriminator)(cfg)
            assert {k: tuple(v.shape) for k, v in
                    module.state_dict().items()} == {
                k: v.shape for k, v in sd.items()}, (name, kind)
            adam = torch.optim.Adam(module.parameters(), lr=1e-3)
            for p in module.parameters():
                p.grad = torch.randn_like(p)
            adam.step()
            saved = optax_from_adam(adam, module, kind, clip)
            # optax's chain layout, moments over the JAX package's tree
            assert [len(x) for x in (saved, saved[-1])] == [
                len(x) for x in (opt, opt[-1])], (name, kind)
            for m in ("mu", "nu"):
                assert (jax.tree_util.tree_structure(
                    getattr(saved[-1][0], m)) == jax.tree_util.tree_structure(
                    getattr(opt[-1][0], m))), (name, kind, m)
            fresh = torch.optim.Adam(module.parameters(), lr=1e-3)
            assert adam_from_optax(saved, fresh, module, kind)
            for p in module.parameters():
                for k in ("exp_avg", "exp_avg_sq"):
                    assert torch.equal(fresh.state[p][k], adam.state[p][k])

    era_b = export_state_dicts(jax.device_get(init_generator(
        jax.random.PRNGKey(2), JAX_PRESETS["gcn"])), "generator")
    era_b.update({f"mlp_decoder_context.{i}.{w}": np.zeros(s, np.float32)
                  for i, w, s in ((0, "weight", (64, 40)), (0, "bias", (64,)),
                                  (2, "weight", (24, 64)),
                                  (2, "bias", (24,)))})
    args = {"pooling_type": "pool_net", "noise_dim": [8]}
    cfg = config_from_checkpoint_args(args, era_b)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_config(args, era_b))
    assert cfg.graph_module == "gcn" and not cfg.mlp_decoder_context
    TrajectoryGenerator(cfg).load_state_dict(generator_state(era_b))


def test_missing_inputs_and_unported_options_raise():
    """The per-step decoder without ``obs``/``group_end`` is a loud error;
    batch_norm, the non-ReLU activations and dropout, once refused, match
    grouptraj: a batch_norm + leakyrelu + dropout per-step decoder's k=3
    positions in eval mode (BN on the tiled batch, no dropout) and in
    training mode with JAX's keep-masks (each step's pool, then its MLP,
    drawn at the tiled shape and shared by the samples)."""
    from grouptraj_torch.ops.linear import InjectedMasks

    _, cfg = _configs("gat-pet")
    g = TrajectoryGenerator(cfg)
    ctx = torch.zeros(1, 2, cfg.decoder_context_dim)
    with pytest.raises(ValueError, match="obs= and group_end="):
        g.generator_sample_many(ctx, torch.zeros(1, 2, cfg.obs_len, 2),
                                torch.ones(1, 2), 2)
    with pytest.raises(ValueError, match="pooling_type"):
        TrajectoryGenerator(dataclasses.replace(cfg, pooling_type="none"))

    opts = dict(batch_norm=True, activation="leakyrelu", dropout=0.2)
    jcfg, cfg = (dataclasses.replace(c, **opts) for c in _configs("gat-pet"))
    # the JAX package's initialisation drawn by the port (its eager JAX
    # initialiser compiles one program per leaf), carried over
    g = TrajectoryGenerator(cfg)
    TS.init_parameters(g, torch.Generator().manual_seed(4))
    params = params_to_jax(g.state_dict())
    batch = synthetic_batch(S, N, jcfg.obs_len, jcfg.pred_len, seed=6)
    b = {k: _t(v) for k, v in batch.items()}
    ctx = np.random.default_rng(6).normal(
        size=(S, N, jcfg.decoder_context_dim)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    noises = _t(jax_sample_noises(jcfg, keys, S, N, jnp.float32))
    last = b["obs"][None, :, :, -1]

    def unrolled_scan(f, init, xs, **_):
        """``lax.scan`` as a Python loop, so the decoder's per-step draws
        are values of the traced program, not of a loop body."""
        carry, ys = init, []
        for i in range(jax.tree_util.tree_leaves(xs)[0].shape[0]):
            carry, y = f(carry, jax.tree_util.tree_map(lambda x: x[i], xs))
            ys.append(y)
        return carry, jax.tree_util.tree_map(lambda *a: jnp.stack(a), *ys)

    def run(p, c, b, train):
        return jax_sample(p, jcfg, c, b["obs"], b["obs_rel"], b["group"],
                          b["valid"], keys, train=train)

    preds_ref = _jit(functools.partial(run, train=False))(params, ctx, batch)
    with pytest.MonkeyPatch.context() as m:
        orig, masks = jax.random.bernoulli, []
        m.setattr(jax.random, "bernoulli",
                  lambda *a: masks.append(orig(*a)) or masks[-1])
        m.setattr(jax.lax, "scan", unrolled_scan)
        train_ref, masks = _jit(lambda *a: (run(*a, train=True), masks))(
            params, ctx, batch)
    assert len(masks) == 4 * jcfg.pred_len
    masks = [np.asarray(x) for x in masks]
    with torch.no_grad():
        for mode, ref, src in ((False, preds_ref, None),
                               (True, train_ref, InjectedMasks(masks))):
            g.train(mode)
            preds = g.generator_sample_many(
                _t(ctx), b["obs_rel"], b["valid"], 3, obs=b["obs"],
                group_end=b["group"], user_noises=noises, masks=src)
            np.testing.assert_allclose(
                relative_to_abs(preds, last).numpy(),
                relative_to_abs(_t(np.asarray(ref)), last).numpy(), rtol=0,
                atol=1e-4, err_msg=f"train={mode}")
