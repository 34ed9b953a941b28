"""Dropout in the port's multi-seed sweeps (``train/multi.py:train_many``
with ``dropout`` or ``dropout1``) on the CPU: each replica draws its own
keep-masks from its own generator in ``train()``'s order, and the
g-step's per-sample forward runs as a vmap over the samples nested in the
seed vmap.

- Step level against the JAX package: ``jax.vmap`` over two seeds of
  ``grouptraj.train.steps.build_d_step`` / ``build_g_step`` from
  grouptraj's per-seed init, every draw taken with JAX (keep-masks recorded
  as tests/test_torch_options.py records them, ``[2, ...]`` and
  ``[2, best_k, ...]``) and injected into ``d_step_many`` /
  ``g_step_many``. Losses 1e-5 relative, gradients 1e-6 of the network's
  largest entry, the weights after the steps as test_torch_options.py
  holds them (1e-6 plus what the gradient bound can move Adam's step).
- Sweep against single runs in the port: ``train_iterations_many`` of two
  seeds against each replica's ``train_iterations`` on the same batches
  and draws (each from a generator at the same state): losses and norms
  1e-5 relative, the replicas' gradients at 1e-5 of the largest entry (a
  vmapped matmul rounds differently), the generators left at one state.
- ``train_many`` end to end on tests/test_torch_multi.py's toy split: a
  1-seed dropout sweep equals ``train()``, a resumed dropout1 sweep the
  uninterrupted one, at that file's tolerances.

Narrow widths (tests/test_torch_options.py's for the step level), two
seeds, one torch thread.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_multi as M
import test_torch_options as O
from grouptraj.config import ModelConfig as JaxModelConfig
from grouptraj.models.discriminator import discriminator_forward as jax_disc
from grouptraj.models.generator import generator_context as jax_context
from grouptraj.models.generator import generator_forward as jax_forward
from grouptraj.models.generator import (
    generator_sample as jax_generator_sample,
)
from grouptraj.models.generator import sample_noises as jax_sample_noises
from grouptraj.parallel.data_parallel import synthetic_batch
from grouptraj.train.steps import build_d_step, build_g_step
from grouptraj_torch.compat import discriminator_state, generator_state
from grouptraj_torch.config import ModelConfig
from grouptraj_torch.models.discriminator import TrajectoryDiscriminator
from grouptraj_torch.models.generator import TrajectoryGenerator
from grouptraj_torch.ops.linear import InjectedMasks
from grouptraj_torch.train import loop as LOOP
from grouptraj_torch.train import multi as MULTI
from grouptraj_torch.train import steps as TS
from grouptraj_torch.train.device_data import (
    gather_batch, synthetic_device_data,
)

DROPOUTS = {"dropout": dict(dropout=0.2), "dropout1": dict(dropout1=0.2)}
SEEDS = [5, 6]
S, N = O.S, O.N
TCFG, JTCFG = O.TCFG, O.JTCFG
BEST_K = TCFG.best_k

data_root = M.data_root

# Losses are held to 1e-5 relative, and to 1e-6 absolute where a loss sits
# near 0: the g-step's adversarial loss is a mean of O(1) BCE terms that
# cancel (seed 6 of the dropout model: -0.0304). There the port's sweep is
# 7.7e-7 from JAX's (2.5e-5 relative), and the port's single-seed g_step on
# the same weights and draws 7.5e-7: the seed axis adds nothing. D's first
# Adam step moves a weight whose gradient is rounding noise by up to lr
# (test_torch_options.py's _assert_params), and the g-step scores on that D.
LOSS_ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: one torch thread a process keeps the workers of
    a parallel test run from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name):
    changes = dict(O.NARROW, **DROPOUTS[name])
    return JaxModelConfig(**changes), ModelConfig(**changes)


def _seed(tree, i):
    return jax.tree_util.tree_map(lambda x: x[i], tree)


def _jax_reference(jcfg, batch, monkeypatch):
    """Everything the JAX side gives a model's step-level test, from one
    compiled program over both seeds (``jax.vmap``): grouptraj's per-seed
    init as its train_many draws it (D's last classifier bias lifted by 1,
    a live discriminator); each seed's draws under the key splits of
    build_d_step / build_g_step (tests/test_torch_options.py's
    ``_references``): the d-step's noise, label and keep-masks (the
    generator leg's, then D's), the g-step's noises, label, per-sample
    masks ``[best_k, ...]`` and D's masks; and one d-step + g-step with
    the gradients each took (test_torch_options.py's identity optimizer,
    the package's clip + Adam applied to the gradients). -> (initial
    states, draws as tensors ``[2, ...]``, per seed (losses, (D grads, G
    grads), (D, G) after the steps))."""
    To = jcfg.obs_len + jcfg.pred_len
    traj = lambda s: jnp.zeros((s, N, To, 2), jnp.float32)
    b = batch
    label = lambda k: jax.random.uniform(k, (), minval=0.7, maxval=1.2)
    init_keys = jnp.stack([jax.random.split(jax.random.PRNGKey(s))[1]
                           for s in SEEDS])
    kd = jnp.stack([jax.random.PRNGKey(100 + s) for s in SEEDS])
    kg = jnp.stack([jax.random.PRNGKey(200 + s) for s in SEEDS])

    def draws(g_params, d_params, kd, kg):
        k_gen, k_dlabel, k_ddisc = jax.random.split(kd, 3)
        k_glabel, k_samples, k_gdisc = jax.random.split(kg, 3)
        samples = jax.random.split(k_samples, BEST_K)
        with O._recording() as d_masks:
            ctx = jax_context(g_params, jcfg, b["obs"], b["obs_rel"],
                              b["group"], b["valid"], k_gen)
            jax_generator_sample(g_params, jcfg, ctx, b["obs"], b["obs_rel"],
                                 b["group"], b["valid"], k_gen)
            jax_disc(d_params, jcfg, traj(2 * S), traj(2 * S),
                     jnp.concatenate([b["valid"]] * 2), k_ddisc)

        def sample_masks(k):
            with O._recording() as ms:
                jax_forward(g_params, jcfg, b["obs"], b["obs_rel"],
                            b["group"], b["valid"], k)
            return ms

        with O._recording() as gd_masks:
            jax_disc(d_params, jcfg, traj(S), traj(S), b["valid"], k_gdisc)
        return dict(
            d=dict(noise=jax_sample_noises(jcfg, k_gen[None], S, N,
                                           jnp.float32)[0],
                   label=label(k_dlabel), masks=d_masks),
            g=dict(noises=jax_sample_noises(jcfg, samples, S, N,
                                            jnp.float32),
                   label=label(k_glabel),
                   sample_masks=jax.vmap(sample_masks)(samples),
                   d_masks=gd_masks))

    # the init compiles apart: at XLA's optimization level 0 the init and
    # the steps in one program moved D's gradient norm by 2e-3 relative
    # (13.880 against 13.907, which the default level and the steps
    # compiled apart both give)
    states = O._cheap_jit(jax.vmap(
        lambda k: O.JSTEPS.init_train_state(k, jcfg, JTCFG)))(init_keys)
    states.d_params["real_classifier"]["layers"][-1]["linear"]["b"] += 1.0
    g_tx, d_tx = O.JSTEPS.make_optimizers(JTCFG)
    apply = optax.apply_updates
    ident = optax.GradientTransformation(lambda p: optax.EmptyState(),
                                         lambda u, s, p=None: (u, s))
    with monkeypatch.context() as m:
        m.setattr(O.JSTEPS, "make_optimizers", lambda tcfg: (ident, ident))
        m.setattr(O.JSTEPS.optax, "apply_updates", lambda p, u: u)
        d_step = build_d_step(jcfg, JTCFG)
        g_step = build_g_step(jcfg, JTCFG)

        def one(state, kd, kg):
            init = state
            out, ld = d_step(state, batch, kd)
            d_grads = out.d_params
            upd, d_opt = d_tx.update(d_grads, state.d_opt, state.d_params)
            state = state._replace(d_params=apply(state.d_params, upd),
                                   d_opt=d_opt)
            out, lg = g_step(state, batch, kg)
            g_grads = out.g_params
            upd, _ = g_tx.update(g_grads, state.g_opt, state.g_params)
            return (init.g_params, init.d_params,
                    draws(init.g_params, init.d_params, kd, kg),
                    ({**ld, **lg}, d_grads, g_grads, state.d_params,
                     apply(state.g_params, upd)))

        g0, d0, drawn, (losses, d_grads, g_grads, d_params, g_params) = (
            jax.tree_util.tree_map(np.asarray, O._cheap_jit(jax.vmap(one))(
                states, kd, kg)))
    for kind in ("d", "g"):
        for k, v in drawn[kind].items():
            drawn[kind][k] = ([O._t(x) for x in v] if isinstance(v, list)
                              else O._t(v))
    refs = [({k: float(v[i]) for k, v in losses.items()},
             (O._np_state(_seed(d_grads, i), "discriminator"),
              O._np_state(_seed(g_grads, i), "generator")),
             (O._np_state(_seed(d_params, i), "discriminator"),
              O._np_state(_seed(g_params, i), "generator")))
            for i in range(len(SEEDS))]
    return (g0, d0), drawn, refs


@pytest.mark.parametrize("name", sorted(DROPOUTS))
def test_sweep_steps_match_grouptraj_vmapped_steps(name, monkeypatch):
    """Two seeds' d-step + g-step through ``d_step_many`` / ``g_step_many``
    with JAX's recorded masks against ``jax.vmap`` of grouptraj's steps;
    the masks' shapes are those of ``d_mask_shapes``,
    ``sample_mask_shapes`` and ``disc_mask_shapes``."""
    jcfg, cfg = _configs(name)
    batch = synthetic_batch(S, N, jcfg.obs_len, jcfg.pred_len, seed=5)
    b = {k: O._t(v) for k, v in batch.items()}
    (g0, d0), draws, refs = _jax_reference(jcfg, batch, monkeypatch)
    for shapes, masks, lead in (
            (TS.d_mask_shapes(cfg, S, N), draws["d"]["masks"], 1),
            (TS.sample_mask_shapes(cfg, S, N), draws["g"]["sample_masks"], 2),
            (TS.disc_mask_shapes(cfg, S, N), draws["g"]["d_masks"], 1)):
        assert [s for s, _ in shapes] == [tuple(m.shape[lead:])
                                          for m in masks]
    assert draws["d"]["masks"] and draws["g"]["sample_masks"]

    mods = []
    for i in range(len(SEEDS)):
        g, d = TrajectoryGenerator(cfg), TrajectoryDiscriminator(cfg)
        g.load_state_dict(generator_state(O._np_state(_seed(g0, i),
                                                      "generator")))
        d.load_state_dict(discriminator_state(O._np_state(
            _seed(d0, i), "discriminator")))
        mods.append(TS.train_state_from_modules(g, d, TCFG))
    st = TS.stack_states(mods, TCFG)
    dd, gd = draws["d"], draws["g"]

    def grads(loss_fn, args, params):
        loss = TS.replica_map(st, loss_fn, *args)
        loss = loss[-1] if isinstance(loss, tuple) else loss
        return torch.autograd.grad(loss.sum(), list(params.values()))

    d_grads = grads(lambda g, d, z, y, ms: TS.d_loss(
        g, d, b, cfg, TCFG, z, y, "scan", InjectedMasks(ms)),
        (dd["noise"], dd["label"], dd["masks"]), st.d_params)
    d_bounds = [O._assert_grads(st.d, [x[i] for x in d_grads], ref[1][0],
                                f"{name} D seed {s}")
                for i, (s, ref) in enumerate(zip(SEEDS, refs))]
    losses = TS.d_step_many(st, b, cfg, TCFG, impl="scan", **dd)
    g_grads = grads(lambda g, d, z, y, sm, dm: TS.g_loss(
        g, d, b, cfg, TCFG, z, y, "scan", sm, InjectedMasks(dm)),
        (gd["noises"], gd["label"], gd["sample_masks"], gd["d_masks"]),
        st.g_params)
    g_bounds = [O._assert_grads(st.g, [x[i] for x in g_grads], ref[1][1],
                                f"{name} G seed {s}")
                for i, (s, ref) in enumerate(zip(SEEDS, refs))]
    losses.update(TS.g_step_many(st, b, cfg, TCFG, impl="scan", **gd))
    for i, (s, (ref, (dg, gg), (d_ref, g_ref))) in enumerate(zip(SEEDS,
                                                                   refs)):
        assert ref["norm_d"] > 0 and ref["norm_g"] > 0
        assert set(losses) == set(ref)
        for k, r in ref.items():
            np.testing.assert_allclose(float(losses[k][i]), r, rtol=1e-5,
                                       atol=LOSS_ATOL,
                                       err_msg=f"{name} {s} {k}")
        one = TS.unstack_state(st, i, TCFG, "cpu")
        O._assert_params(one.d, d_ref, dg, d_bounds[i], TCFG.d_learning_rate,
                         f"{name} D seed {s}")
        O._assert_params(one.g, g_ref, gg, g_bounds[i], TCFG.g_learning_rate,
                         f"{name} G seed {s}")


def _live_states(cfg, seeds):
    """The port's fresh states of ``seeds``, D's last classifier bias
    lifted by 1 (a live discriminator)."""
    states = [TS.init_train_state(cfg, TCFG, torch.Generator().manual_seed(s),
                                  device="cpu") for s in seeds]
    with torch.no_grad():
        for st in states:
            [m for m in st.d.real_classifier.modules()
             if isinstance(m, torch.nn.Linear)][-1].bias += 1.0
    return states


def _per_sample(stacked):
    """Stacked per-sample masks ``[best_k, ...]`` -> best_k lists."""
    return [[m[k] for m in stacked] for k in range(BEST_K)]


@pytest.mark.parametrize("name", sorted(DROPOUTS))
def test_sweep_matches_single_runs(name):
    """Two seeds: the gradients of ``d_loss``/``g_loss`` under
    ``replica_map`` with each replica's draws (``replica_draws``) against
    ``d_gradients``/``g_gradients`` with the same draws injected, 1e-5 of
    the largest entry; then two iterations of ``train_iterations_many``
    against each replica's ``train_iterations``, every draw from a
    generator at the same state: losses and norms 1e-5 relative, each
    generator left where the single run leaves it (the same draws, masks
    included, in the same order)."""
    _, cfg = _configs(name)
    n = 5
    data = synthetic_device_data(8, n, cfg.obs_len, cfg.pred_len, seed=3,
                                 device="cpu")
    idx = torch.randint(0, 8, (2, 2, S),
                        generator=torch.Generator().manual_seed(0))
    st = TS.stack_states(_live_states(cfg, SEEDS), TCFG)
    singles = _live_states(cfg, SEEDS)
    b = gather_batch(data, idx[0, 0], cfg.obs_len)
    gens = [torch.Generator().manual_seed(30 + i) for i in range(2)]
    for kind, loss_fn, params, single in (
            ("d", lambda g, d, z, y, ms: TS.d_loss(
                g, d, b, cfg, TCFG, z, y, "scan", InjectedMasks(ms)),
             st.d_params, TS.d_gradients),
            ("g", lambda g, d, z, y, sm, dm: TS.g_loss(
                g, d, b, cfg, TCFG, z, y, "scan", sm, InjectedMasks(dm)),
             st.g_params, TS.g_gradients)):
        draws = [TS.replica_draws(kind, cfg, TCFG, S, n, g, "cpu")
                 for g in gens]
        loss = TS.replica_map(st, loss_fn,
                              *TS._stack_draws(draws, "cpu").values())
        loss = loss[-1] if isinstance(loss, tuple) else loss
        grads = torch.autograd.grad(loss.sum(), list(params.values()))
        for i, state in enumerate(singles):
            kw = dict(draws[i])
            if kind == "g":
                kw["sample_masks"] = _per_sample(kw["sample_masks"])
            ref = single(state, b, cfg, TCFG, impl="scan", **kw)[1]
            top = max(float(r.abs().max()) for r in ref)
            assert top > 0
            for key, g, r in zip(params, grads, ref):
                np.testing.assert_allclose(g[i].numpy(), r.numpy(), rtol=0,
                                           atol=1e-5 * top,
                                           err_msg=f"{name} {kind} {key}")

    gens = [torch.Generator().manual_seed(10 + i) for i in range(2)]
    many = TS.train_iterations_many(st, data, idx, cfg, TCFG, gens)
    for i, state in enumerate(singles):
        gen = torch.Generator().manual_seed(10 + i)
        one = TS.train_iterations(state, data, idx, cfg, TCFG, gen,
                                  impl="scan")
        assert set(one) == set(many)
        for k, v in one.items():
            np.testing.assert_allclose(many[k][i].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"{name} seed {i} {k}")
        assert torch.equal(gen.get_state(), gens[i].get_state())


@pytest.mark.parametrize("case", ["one_seed", "resume"])
def test_train_many_dropout_end_to_end(case, data_root, tmp_path):
    """On the toy split: a 1-seed sweep of the dropout model equals
    ``train()`` of that seed (test_torch_multi.py's bounds: histories 1e-6
    relative, weights 1e-6 absolute, the inter-group attention vectors 2 lr
    an iteration); a dropout1 sweep interrupted at t=4 and resumed to 6
    equals the uninterrupted one, each replica's generator state too."""
    if case == "one_seed":
        cfg = dataclasses.replace(M.CFG, dropout=0.2)
        s = SEEDS[1]
        tcfg = M._small(str(tmp_path / "one"), num_iterations=4, seed=s)
        many = MULTI.train_many(cfg, tcfg, [s], device="cpu")[s]
        one = LOOP.train(cfg, M._small(str(tmp_path / "train"),
                                       num_iterations=4, seed=s),
                         device="cpu")
        M._same_histories(many, one, 1e-6)
        M._same_weights(many, one, 1e-6,
                        noisy_atol=2 * tcfg.g_learning_rate * 4)
        return
    cfg = dataclasses.replace(M.CFG, dropout1=0.2)
    full = MULTI.train_many(cfg, M._small(str(tmp_path / "full")), SEEDS,
                            device="cpu")
    out = str(tmp_path / "resumed")
    MULTI.train_many(cfg, M._small(out, num_iterations=4), SEEDS,
                     device="cpu")
    resumed = MULTI.train_many(cfg, M._small(
        out, restore_from_checkpoint=True), SEEDS, device="cpu")
    for s in SEEDS:
        a, b = full[s], resumed[s]
        assert b["restore_ts"] == [4] and b["counters"]["t"] == 6
        M._same_histories(b, a, 1e-6)
        M._same_weights(b, a, 1e-6)
        assert np.array_equal(a[MULTI.RNG_KEY], b[MULTI.RNG_KEY])


def test_mask_shapes_and_metric_sweep():
    """``d_mask_shapes`` is the generator leg's masks, then D's: one
    stacked call at 2S, or with batch_norm fake then real at S; dropout1
    leaves D without masks. The sweep's metric pass runs in eval mode and
    draws no mask: each replica's sums equal ``make_check_accuracy_sweep``
    of its own state and its generator ends where a single pass leaves
    it."""
    for opts in (dict(dropout=0.2), dict(dropout=0.2, batch_norm=True),
                 dict(dropout1=0.2)):
        cfg = ModelConfig(**O.NARROW, **opts)
        leg = TS.sample_mask_shapes(cfg, S, N)
        disc = TS.disc_mask_shapes(cfg, S, N)
        if cfg.batch_norm:
            assert TS.d_mask_shapes(cfg, S, N) == leg + disc + disc
        else:
            assert TS.d_mask_shapes(cfg, S, N) == \
                leg + TS.disc_mask_shapes(cfg, 2 * S, N)
        assert bool(disc) == bool(cfg.dropout)
    _, cfg = _configs("dropout")
    data = synthetic_device_data(8, 5, cfg.obs_len, cfg.pred_len, seed=4,
                                 device="cpu")
    idx = torch.arange(8).view(2, S)
    st = TS.stack_states(_live_states(cfg, SEEDS), TCFG)
    gens = [torch.Generator().manual_seed(20 + i) for i in range(2)]
    sums = TS.check_accuracy_sweep_many(st, data, idx, cfg, gens)
    sweep = TS.make_check_accuracy_sweep(cfg)
    for i in range(2):
        gen = torch.Generator().manual_seed(20 + i)
        ref = sweep(TS.unstack_state(st, i, TCFG, "cpu"), data, idx, gen)
        for k, v in ref.items():
            np.testing.assert_allclose(float(sums[k][i]), float(v),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        assert torch.equal(gen.get_state(), gens[i].get_state())
