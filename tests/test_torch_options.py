"""The port's MLP options against the JAX package on the CPU: batch_norm
(masked batch statistics, in evaluation too), the ``'leakyrelu'`` and
``'none'`` activations, ``dropout`` (the pool's and the MLPs') and the
GAT's ``dropout1``, with the per-sample g-step dropout needs; the batching
rules of the LSTM kernels' Functions (K3-K6) under ``torch.func.vmap``;
BatchNorm entries in the state dicts, the Adam moments and the checkpoints
of both packages; and the noise options ``noise_type='uniform'`` and
``noise_mix_type='ped'``.

The gat preset at narrow widths (S=4, N=6, best_k=3), weights from one JAX
init (``params_from_jax``), the draws taken with JAX and injected into the
port: the noise and label as tests/test_torch_steps.py takes them, and
dropout's keep-masks recorded from ``jax.random.bernoulli`` while the JAX
forward functions are traced under the keys the JAX steps split — per
sample key for the g-step's vmapped forward, whose masks the vmap draws
from the same keys. The steps themselves are the JAX package's, jitted.

Tolerances, float32 at "highest" precision: context 1e-5, positions
1e-4 m, D scores 1e-5; one d-step + g-step: losses 1e-5 relative, every
gradient 1e-6 of its network's largest entry (3e-5 with batch_norm: the
reference's jitted and eager runs differ by 1.2e-5 there, see
:func:`test_option_model_matches_jax`), the parameters after the step as
tests/test_torch_presets.py holds them (1e-6 plus what the gradient bound
can move Adam's step).
"""

import contextlib
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from grouptraj.compat.torch_import import export_state_dicts
from grouptraj.config import ModelConfig as JaxModelConfig
from grouptraj.config import TrainConfig as JaxTrainConfig
from grouptraj.models import init_discriminator, init_generator
from grouptraj.models.discriminator import discriminator_forward as jax_disc
from grouptraj.models.generator import generator_context as jax_context
from grouptraj.models.generator import generator_forward as jax_forward
from grouptraj.models.generator import (
    generator_sample as jax_generator_sample,
)
from grouptraj.models.generator import generator_sample_many as jax_sample
from grouptraj.models.generator import sample_noises as jax_sample_noises
from grouptraj.models.modules import gat_encoder_mh as jax_gat_encoder_mh
from grouptraj.models.modules import init_gat_encoder_mh
from grouptraj.parallel.data_parallel import synthetic_batch
from grouptraj.train.steps import build_d_step, build_g_step
from grouptraj_torch.compat import (
    config_from_checkpoint_args, discriminator_state, generator_state,
    params_from_jax, params_to_jax,
)
from grouptraj_torch.config import ModelConfig, TrainConfig
from grouptraj_torch.models.discriminator import TrajectoryDiscriminator
from grouptraj_torch.models.generator import (
    TrajectoryGenerator, sample_noises,
)
from grouptraj_torch.models.modules import gat_encoder_mh
from grouptraj_torch.ops import cuda_lstm, cuda_lstm_proj
from grouptraj_torch.ops.linear import InjectedMasks, mlp_forward
from grouptraj_torch.train import checkpoint as CK
from grouptraj_torch.train import steps as TS
from grouptraj_torch.utils import relative_to_abs

JSTEPS = importlib.import_module("grouptraj.train.steps")
JCK = importlib.import_module("grouptraj.train.checkpoint")
jlinear = importlib.import_module("grouptraj.ops.linear")

NARROW = dict(embedding_dim=8, encoder_h_dim_g=16, decoder_h_dim_g=16,
              noise_dim=(4,), bottleneck_dim=4, hidden_units=12,
              graph_out_dim=8, encoder_h_dim_d=12, mlp_dim=16, obs_len=4,
              pred_len=5)
TRAIN = dict(best_k=3, batch_size=4, bf16_nograd=False)
JTCFG, TCFG = JaxTrainConfig(**TRAIN), TrainConfig(**TRAIN)
OPTIONS = {"batch_norm": dict(batch_norm=True),
           "leakyrelu": dict(activation="leakyrelu"),
           "dropout": dict(dropout=0.2),
           "dropout1": dict(dropout1=0.2)}
S, N, K = 4, 6, 20

# the references skip LLVM's expensive passes, which changes no value, and
# compile at XLA's backend optimization level 0 (tests/test_torch_presets.
# py's cheaper pipeline, half the time) but for the batch_norm model's
# steps: there that level moves the G gradients by 1.4e-4 of the largest
# entry (the statistics amplify rounding, see test_option_model_matches_jax)
_jit = functools.partial(jax.jit, compiler_options=dict(
    xla_llvm_disable_expensive_passes=True))


_cheap_jit = functools.partial(jax.jit, compiler_options=dict(
    xla_backend_optimization_level=0, xla_llvm_disable_expensive_passes=True))


def _jit_for(jcfg):
    return _jit if jcfg.batch_norm else _cheap_jit


def _jax_state(jcfg, cfg, seed):
    """A JAX TrainState of fresh weights, drawn by the port's
    ``init_parameters`` (the JAX package's initialisation; eager JAX
    initialisers compile one small program per leaf) and carried over by
    ``params_to_jax``; Adam from zero."""
    st = TS.init_train_state(cfg, TCFG, torch.Generator().manual_seed(seed),
                             device="cpu")
    g_params, d_params = (
        jax.tree_util.tree_map(jnp.asarray, params_to_jax(m.state_dict(), k))
        for m, k in ((st.g, "generator"), (st.d, "discriminator")))
    g_tx, d_tx = JSTEPS.make_optimizers(JTCFG)
    return JSTEPS.TrainState(g_params, d_params, _jit(g_tx.init)(g_params),
                             _jit(d_tx.init)(d_params))


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


@contextlib.contextmanager
def _recording():
    """Every ``jax.random.bernoulli`` result appended, in call order, to
    the yielded list. Under jit the masks are returned as outputs, so XLA
    compiles the draws and drops whatever else only they needed."""
    masks = []
    orig = jax.random.bernoulli

    def rec(key, p=0.5, shape=None, mode="low"):
        out = orig(key, p, shape, mode)
        masks.append(out)
        return out

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax.random, "bernoulli", rec)
        yield masks


def _close(got, ref, atol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=atol,
                               err_msg=what)


def test_mlp_forward_and_gat_options_match_jax():
    """``mlp_forward`` for every activation, with batch_norm masked and
    unmasked, and with JAX's dropout masks injected; the ``gat-mh``
    encoder's dropout (the batched GAT's attention and activations); an
    injected mask of the wrong shape raises."""
    rng = np.random.default_rng(0)
    p = jlinear.init_mlp(jax.random.PRNGKey(0), [12, 20, 7], batch_norm=True)
    for layer in p["layers"]:           # BN weights away from 1 and 0
        shape = layer["bn_scale"].shape
        layer["bn_scale"] = jnp.asarray(rng.uniform(0.5, 1.5, shape),
                                        jnp.float32)
        layer["bn_bias"] = jnp.asarray(rng.normal(size=shape), jnp.float32)
    tree = jax.tree_util.tree_map(_t, p)
    x = rng.normal(size=(3, 5, 12)).astype(np.float32)
    mask = np.ones((3, 5), np.float32)
    mask[0, 3:] = mask[2, 1:] = 0.0
    key = jax.random.PRNGKey(3)
    acts = ("relu", "leakyrelu", "none")
    labels = np.array([[0, 3, 3, 5, 0, 5], [2, 0, 2, 2, 0, 0]], np.float32)
    valid = np.array([[1, 1, 1, 1, 1, 0], [1, 1, 1, 1, 0, 0]], np.float32)
    h = rng.normal(size=(2, 6, 10)).astype(np.float32)
    # the gat preset's gat_encoder is held in the dropout1 model's test
    gats = {"gat-mh": (jax_gat_encoder_mh, gat_encoder_mh,
                       init_gat_encoder_mh(jax.random.PRNGKey(2), (10, 8, 6),
                                           (3, 1)))}

    @_cheap_jit
    def refs(p, x, mask, gat_params):
        plain = {(a, bn, m): jlinear.mlp_forward(
                     p, x, a, bn, mask=mask if m else None, train=False)
                 for a in acts for bn, m in ((False, False), (True, False),
                                             (True, True))}
        dropped = {}
        for a in acts:
            with _recording() as masks:
                out = jlinear.mlp_forward(p, x, a, True, 0.3, key, mask=mask)
            dropped[a] = (out, masks)
        for name, (jfn, _, _) in gats.items():
            with _recording() as masks:
                out = jfn(gat_params[name], h, labels, valid, 0.2, 0.25, key,
                          True)
            dropped[name] = (out, masks)
        return plain, dropped

    plain, dropped = jax.tree_util.tree_map(np.asarray, refs(
        p, x, mask, {k: v[2] for k, v in gats.items()}))
    for (a, bn, m), ref in plain.items():
        got = mlp_forward(tree, _t(x), a, bn, mask=_t(mask) if m else None)
        _close(got, ref, 1e-5, f"{a} bn={bn} mask={m}")
    for a in acts:
        ref, masks = dropped[a]
        src = InjectedMasks(masks)
        _close(mlp_forward(tree, _t(x), a, True, 0.3, mask=_t(mask),
                           masks=src), ref, 1e-5, f"{a} dropout")
        assert src.used == len(masks) == 2
    for name, (_, fn, init) in gats.items():
        ref, masks = dropped[name]
        assert masks
        src = InjectedMasks(masks)
        got = fn(jax.tree_util.tree_map(_t, init), _t(h), _t(labels),
                 _t(valid), 0.2, dropout=0.25, masks=src)
        _close(got, ref, 1e-5 * max(1.0, np.abs(ref).max()), name)
        assert src.used == len(masks)
    with pytest.raises(ValueError, match="shape"):
        mlp_forward(tree, _t(x), "relu", False, 0.3,
                    masks=InjectedMasks([np.ones((3, 5, 7), bool)]))


def _configs(name):
    changes = dict(NARROW, **OPTIONS[name])
    return JaxModelConfig(**changes), ModelConfig(**changes)


def _with_moments(opt, seed):
    """An optax chain state whose Adam has taken 3 steps: random moments
    (a resumed run's)."""
    rng = np.random.default_rng(seed)

    def fill(s):
        if not isinstance(s, optax.ScaleByAdamState):
            return s
        return s._replace(
            count=jnp.asarray(3, jnp.int32),
            mu=jax.tree_util.tree_map(lambda x: jnp.asarray(
                rng.normal(0, 1e-3, x.shape), jnp.float32), s.mu),
            nu=jax.tree_util.tree_map(lambda x: jnp.asarray(
                rng.uniform(1e-6, 1e-4, x.shape), jnp.float32), s.nu))

    return jax.tree_util.tree_map(
        fill, opt, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))


KEYS = dict(d=jax.random.PRNGKey(100), g=jax.random.PRNGKey(200),
            eval=jax.random.PRNGKey(13))


def _references(jcfg, state, batch):
    """Everything the JAX side gives one model's test, from one compiled
    program: the eval-mode context, k=20 positions (and their noise) and
    D's real scores; the training-mode context with its masks; and one
    iteration's draws under the key splits of build_d_step / build_g_step
    — the d-step's noise, label and keep-masks (the generator leg's, then
    D's: one stacked call, or fake then real with batch_norm), the
    g-step's noises, label, per-sample masks (``generator_forward``'s
    masks vmapped over the sample keys, as the step draws them) and D's
    masks. The training-mode context is the d-step's generator leg's."""
    To = jcfg.obs_len + jcfg.pred_len
    traj = lambda s: jnp.zeros((s, N, To, 2), jnp.float32)
    k_gen, k_dlabel, k_ddisc = jax.random.split(KEYS["d"], 3)
    k_glabel, k_samples, k_gdisc = jax.random.split(KEYS["g"], 3)
    samples = jax.random.split(k_samples, TRAIN["best_k"])
    keys = jax.random.split(KEYS["eval"], K)
    label = lambda k: jax.random.uniform(k, (), minval=0.7, maxval=1.2)

    @_cheap_jit
    def run(g_params, d_params, b):
        out = {}
        ctx = jax_context(g_params, jcfg, b["obs"], b["obs_rel"], b["group"],
                          b["valid"], keys[0], train=False)
        out["eval"] = dict(
            ctx=ctx, noises=jax_sample_noises(jcfg, keys, S, N, jnp.float32),
            preds=jax_sample(g_params, jcfg, ctx, b["obs"], b["obs_rel"],
                             b["group"], b["valid"], keys, train=False),
            scores=jax_disc(
                d_params, jcfg, jnp.concatenate([b["obs"], b["pred"]], 2),
                jnp.concatenate([b["obs_rel"], b["pred_rel"]], 2),
                b["valid"], train=False))
        # the d-step's generator leg is generator_forward(k_gen): its
        # context, then its sample, under one key
        with _recording() as d_masks:
            ctx = jax_context(g_params, jcfg, b["obs"], b["obs_rel"],
                              b["group"], b["valid"], k_gen)
            n_ctx = len(d_masks)
            jax_generator_sample(g_params, jcfg, ctx, b["obs"], b["obs_rel"],
                                 b["group"], b["valid"], k_gen)
            if jcfg.batch_norm:
                for k in jax.random.split(k_ddisc):
                    jax_disc(d_params, jcfg, traj(S), traj(S), b["valid"], k)
            else:
                jax_disc(d_params, jcfg, traj(2 * S), traj(2 * S),
                         jnp.concatenate([b["valid"]] * 2), k_ddisc)
        out["train"] = dict(ctx=ctx, masks=d_masks[:n_ctx])

        def sample_masks(k):
            with _recording() as ms:
                jax_forward(g_params, jcfg, b["obs"], b["obs_rel"],
                            b["group"], b["valid"], k)
            return ms

        with _recording() as gd_masks:
            jax_disc(d_params, jcfg, traj(S), traj(S), b["valid"], k_gdisc)
        out["d"] = dict(noise=jax_sample_noises(jcfg, k_gen[None], S, N,
                                                jnp.float32)[0],
                        label=label(k_dlabel), masks=d_masks)
        out["g"] = dict(noises=jax_sample_noises(jcfg, samples, S, N,
                                                 jnp.float32),
                        label=label(k_glabel),
                        sample_masks=jax.vmap(sample_masks)(samples),
                        d_masks=gd_masks)
        return out

    out = jax.tree_util.tree_map(np.asarray, run(state.g_params,
                                                 state.d_params, batch))
    for kind, noise in (("d", "noise"), ("g", "noises")):
        out[kind][noise] = _t(out[kind][noise])
        out[kind]["label"] = float(out[kind]["label"])
    stacked = out["g"]["sample_masks"]           # per mask [best_k, ...]
    out["g"]["sample_masks"] = [[m[i] for m in stacked]
                                for i in range(TRAIN["best_k"])]
    return out


def _jax_iteration(jcfg, state, batch, monkeypatch):
    """One JAX d-step + g-step and the gradients each took, one compiled
    program: the steps are built with an identity optimizer and
    ``optax.apply_updates`` patched to hand back the update, so a step
    returns its gradients in place of the parameters; the package's own
    clip + Adam is applied to them, as the step applies it. -> (losses,
    (D grads, G grads), (D, G) after the steps)."""
    g_tx, d_tx = JSTEPS.make_optimizers(JTCFG)
    apply = optax.apply_updates
    ident = optax.GradientTransformation(lambda p: optax.EmptyState(),
                                         lambda u, s, p=None: (u, s))
    with monkeypatch.context() as m:
        m.setattr(JSTEPS, "make_optimizers", lambda tcfg: (ident, ident))
        m.setattr(JSTEPS.optax, "apply_updates", lambda p, u: u)
        d_step = build_d_step(jcfg, JTCFG)
        g_step = build_g_step(jcfg, JTCFG)

        @_jit_for(jcfg)
        def run(state, batch):
            out, ld = d_step(state, batch, KEYS["d"])
            d_grads = out.d_params
            upd, d_opt = d_tx.update(d_grads, state.d_opt, state.d_params)
            state = state._replace(d_params=apply(state.d_params, upd),
                                   d_opt=d_opt)
            out, lg = g_step(state, batch, KEYS["g"])
            g_grads = out.g_params
            upd, _ = g_tx.update(g_grads, state.g_opt, state.g_params)
            return ({**ld, **lg}, d_grads, g_grads, state.d_params,
                    apply(state.g_params, upd))

        losses, d_grads, g_grads, d_params, g_params = run(state, batch)
    return ({k: float(v) for k, v in losses.items()},
            (_np_state(d_grads, "discriminator"),
             _np_state(g_grads, "generator")),
            (_np_state(d_params, "discriminator"),
             _np_state(g_params, "generator")))


def _assert_grads(module, grads, ref, what, rtol=1e-6):
    """Each gradient within ``rtol`` of the network's largest entry -> that
    bound."""
    names = [n for n, _ in module.named_parameters()]
    ref = {k: v for k, v in ref.items()
           if not k.endswith(("running_mean", "running_var"))}
    assert set(names) == set(ref), what
    bound = rtol * max(np.abs(r).max() for r in ref.values())
    for n, g in zip(names, grads):
        err = np.abs(g.numpy() - ref[n]).max()
        assert err <= bound, (what, n, err / bound * rtol)
    return bound


def _assert_params(module, ref, grads, bound, lr, what):
    """After one Adam step: 1e-6 plus what the gradients' ``bound`` can
    move a first Adam step (tests/test_torch_presets.py's bound; a step
    from existing moments moves less)."""
    got = {k: v for k, v in module.state_dict().items()
           if not k.endswith(("running_mean", "running_var"))}
    ref = {k: v for k, v in ref.items()
           if not k.endswith(("running_mean", "running_var"))}
    assert set(got) == set(ref), what
    for k, r in ref.items():
        diff = np.abs(got[k].numpy() - r)
        near = np.maximum(np.abs(grads[k]) - bound, 0.0) + 1e-8
        tol = 1e-6 + lr * np.minimum(2.0, 1e-8 * bound / near ** 2)
        assert (diff <= tol).all(), (what, k, diff.max())


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_option_model_matches_jax(name, monkeypatch):
    """Context and k=20 positions in eval mode (BN on the batch, no
    dropout), the training-mode context with JAX's masks, D's scores, then
    one d-step + g-step with every draw injected. The batch_norm model
    starts from a JAX-written checkpoint whose Adams have taken 3 steps
    (resumed with its moments); the dropout models' g-step runs the
    per-sample forward, under vmap, against JAX's vmapped one."""
    jcfg, cfg = _configs(name)
    # BatchNorm's statistics amplify float32 rounding (1/std), and a
    # rounding-level change can move a ReLU or a max across its kink: the
    # JAX d-step's own jitted and eager D gradients differ by 1.2e-5 of the
    # largest entry from this init (by 2e-3 from seed 3), and the port sits
    # as close (1.1e-5). The batch_norm model's gradients are held to 3e-5
    # of the largest, the bound the GCN models take.
    rtol = 3e-5 if cfg.batch_norm else 1e-6
    state = _jax_state(jcfg, cfg, 0)
    state.d_params["real_classifier"]["layers"][-1]["linear"]["b"] += 1.0
    if name == "batch_norm":
        state = state._replace(g_opt=_with_moments(state.g_opt, 1),
                               d_opt=_with_moments(state.d_opt, 2))
        ckpt = JCK.checkpoint_from_state(JCK.new_checkpoint({}), state)
        port = CK.state_from_checkpoint(ckpt, cfg, TCFG, device="cpu")
        assert port.g_opt.state and port.d_opt.state
    else:
        g, d = TrajectoryGenerator(cfg), TrajectoryDiscriminator(cfg)
        g.load_state_dict(generator_state(_np_state(state.g_params,
                                                    "generator")))
        d.load_state_dict(discriminator_state(_np_state(
            state.d_params, "discriminator")))
        port = TS.train_state_from_modules(g, d, TCFG)
    g, d = port.g, port.d
    batch = synthetic_batch(S, N, jcfg.obs_len, jcfg.pred_len, seed=5)
    b = {k: _t(v) for k, v in batch.items()}

    refs = _references(jcfg, state, batch)
    ev = refs["eval"]
    with torch.no_grad():
        g.eval()
        d.eval()
        ctx = g.generator_context(b["obs"], b["obs_rel"], b["group"],
                                  b["valid"])
        preds = g.generator_sample_many(ctx, b["obs_rel"], b["valid"], K,
                                        user_noises=_t(ev["noises"]))
        scores = d(torch.cat([b["obs"], b["pred"]], 2),
                   torch.cat([b["obs_rel"], b["pred_rel"]], 2), b["valid"])
        _close(ctx, ev["ctx"], 1e-5, "eval context")
        last = b["obs"][None, :, :, -1]
        _close(relative_to_abs(preds, last),
               relative_to_abs(_t(ev["preds"]), last), 1e-4, "positions")
        valid = batch["valid"] > 0
        assert (ev["scores"][valid] > 0).any()
        np.testing.assert_allclose(scores.numpy()[valid],
                                   ev["scores"][valid], rtol=1e-5,
                                   atol=1e-5, err_msg="scores")
        g.train()
        d.train()
        masks = refs["train"]["masks"]
        assert bool(masks) == name.startswith("dropout")
        src = InjectedMasks(masks)
        _close(g.generator_context(b["obs"], b["obs_rel"], b["group"],
                                   b["valid"], masks=src),
               refs["train"]["ctx"], 1e-5, "train context")
        assert src.used == len(masks)

    d_draw, g_draw = refs["d"], refs["g"]
    ref, (d_grads, g_grads), (d_ref, g_ref) = _jax_iteration(
        jcfg, state, batch, monkeypatch)
    assert ref["norm_d"] > 0 and ref["norm_g"] > 0
    d_bound = _assert_grads(d, TS.d_gradients(port, b, cfg, TCFG,
                                              **d_draw)[1], d_grads,
                            f"{name} D", rtol)
    losses = TS.d_step(port, b, cfg, TCFG, **d_draw)
    g_bound = _assert_grads(g, TS.g_gradients(port, b, cfg, TCFG,
                                              **g_draw)[1], g_grads,
                            f"{name} G", rtol)
    losses.update(TS.g_step(port, b, cfg, TCFG, **g_draw))
    assert set(losses) == set(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(float(losses[k]), r, rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    _assert_params(d, d_ref, d_grads, d_bound, TCFG.d_learning_rate,
                   f"{name} D")
    _assert_params(g, g_ref, g_grads, g_bound, TCFG.g_learning_rate,
                   f"{name} G")


def test_lstm_kernel_vmap_rules_fold_rows():
    """K3/K4 (the gx recurrence and the folded decoder) and K5/K6 through
    their Functions under ``torch.func.vmap`` (their plain versions on CPU
    tensors): outputs and every gradient equal a loop over the vmapped
    samples; an unbatched input inside the vmap stays unbatched; a batched
    weight raises NotImplementedError."""
    gen = torch.Generator().manual_seed(0)
    T, B, H, D, n = 5, 6, 8, 4, 3
    r = lambda *s: torch.randn(*s, generator=gen).requires_grad_()
    w, b, w_ih = r(H, 4 * H), r(4 * H), r(D, 4 * H)
    h0, c0 = r(n, B, H), r(n, B, H)
    gx, xs = r(n, T, B, 4 * H), r(n, T, B, D)
    proj = {"w_ih": w_ih, "w_hh": w, "b_ih": b, "b_hh": b * 0.5}
    cases = {
        "decoder": (lambda h, c: (cuda_lstm.decoder_recurrence_fused(
            w, b, h, c, T),), (h0, c0)),
        "gx": (lambda g, h: cuda_lstm.lstm_recurrence_fused(
            w, g, h, c0[0])[0:1] + cuda_lstm.lstm_recurrence_fused(
            w, g, h, c0[0])[1], (gx, h0)),
        "proj": (lambda x, h: (lambda o: (o[0], *o[1]))(
            cuda_lstm_proj.lstm_scan_proj(proj, x, h, c0[1])), (xs, h0)),
    }
    for name, (fn, args) in cases.items():
        got = torch.func.vmap(fn)(*args)
        loop = [fn(*(a[i] for a in args)) for i in range(n)]
        ref = [torch.stack([o[j] for o in loop]) for j in range(len(got))]
        leaves = [w, b, w_ih, *args]
        gg = torch.autograd.grad(sum((o * o).sum() for o in got), leaves,
                                 allow_unused=True, retain_graph=True)
        gr = torch.autograd.grad(sum((o * o).sum() for o in ref), leaves,
                                 allow_unused=True)
        for x, y in zip(got, ref):
            _close(x, y.detach(), 1e-6, name)
        for x, y in zip(gg, gr):
            assert (x is None) == (y is None), name
            if x is not None:
                _close(x, y, 1e-5 * max(1.0, float(y.abs().max())), name)
    # the encoder inside a per-sample vmap: its inputs are shared
    shared = torch.func.vmap(lambda h: cuda_lstm.lstm_recurrence_fused(
        w, gx[0], h0[0], c0[0])[0] + h.sum())(h0)
    _close(shared[0] - h0[0].sum(),
           cuda_lstm.lstm_recurrence_fused(w, gx[0], h0[0], c0[0])[0]
           .detach(), 1e-6)
    with pytest.raises(NotImplementedError, match="batched under vmap"):
        torch.func.vmap(lambda ww: cuda_lstm.decoder_recurrence_fused(
            ww, b, h0[0], c0[0], T))(torch.randn(n, H, 4 * H))
    with pytest.raises(NotImplementedError, match="batched under vmap"):
        torch.func.vmap(lambda wi: cuda_lstm_proj.lstm_scan_proj(
            dict(proj, w_ih=wi), xs[0], h0[0], c0[0]))(
            torch.randn(n, D, 4 * H))


def test_batch_norm_compat_both_ways(tmp_path):
    """BatchNorm trees cross both ways: ``params_from_jax`` equals
    ``export_state_dicts`` (names, order, values; the running statistics
    0/1), the port's modules take exactly those names and shapes, and
    ``params_to_jax`` gives the tree back. A grouptraj-written file of a
    batch_norm + dropout model loads into the port with its Adam moments;
    the port's file of it loads in grouptraj, weights and moments equal.
    The config round-trips every option."""
    # every MLP of the port: the pool's, the per-step decoder's pool and
    # mlp, mlp_decoder_context (after the batched GAT), D's pool and
    # classifier
    opts = dict(graph_module="gat-mh", mlp_decoder_context=True,
                pool_every_timestep=True, batch_norm=True, dropout=0.1,
                dropout1=0.2, activation="leakyrelu")
    jcfg, cfg = JaxModelConfig(**opts), ModelConfig(**opts)
    rng = np.random.default_rng(5)
    for kind, init, module in (
            ("generator", init_generator, TrajectoryGenerator),
            ("discriminator", init_discriminator, TrajectoryDiscriminator)):
        # the JAX initialiser's tree (traced, not run), filled with numbers
        tree = jax.tree_util.tree_map(
            lambda t: rng.normal(size=t.shape).astype(t.dtype),
            jax.eval_shape(lambda k: init(k, jcfg), jax.random.PRNGKey(5)))
        ref = export_state_dicts(tree, kind)
        out = params_from_jax(tree, kind)
        assert list(out) == list(ref), kind
        for k in ref:
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
        assert any(".running_var" in k for k in ref)
        sd = module(cfg).state_dict()
        assert {k: tuple(v.shape) for k, v in sd.items()} == {
            k: v.shape for k, v in out.items()}, kind
        back = params_to_jax(out, kind)
        assert jax.tree_util.tree_structure(back) == \
            jax.tree_util.tree_structure(tree)
        for x, y in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(x, y)
    args = {"resolved_model_config": dataclasses.asdict(jcfg)}
    assert config_from_checkpoint_args(args) == cfg

    jcfg, cfg = _configs("batch_norm")
    jcfg = dataclasses.replace(jcfg, dropout=0.1)
    cfg = dataclasses.replace(cfg, dropout=0.1)
    state = _jax_state(jcfg, cfg, 4)
    state = state._replace(g_opt=_with_moments(state.g_opt, 3),
                           d_opt=_with_moments(state.d_opt, 4))
    JCK.save_checkpoint(JCK.checkpoint_from_state(JCK.new_checkpoint(
        {"resolved_model_config": dataclasses.asdict(jcfg)}), state),
        str(tmp_path), "jax")
    ckpt = CK.load_checkpoint(str(tmp_path / "jax_with_model.pt"))
    port = CK.state_from_checkpoint(
        ckpt, config_from_checkpoint_args(ckpt["args"]), TCFG, device="cpu")
    for opt, module, jopt, kind in ((port.g_opt, port.g, state.g_opt,
                                     "generator"),
                                    (port.d_opt, port.d, state.d_opt,
                                     "discriminator")):
        adam = [s for s in jax.tree_util.tree_leaves(
            jopt, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)][0]
        mu = params_from_jax(jax.device_get(adam.mu), kind)
        for name, p in module.named_parameters():
            st = opt.state[p]
            assert int(st["step"]) == 3
            np.testing.assert_array_equal(st["exp_avg"].numpy(), mu[name])
    CK.save_checkpoint(CK.checkpoint_from_state(
        CK.new_checkpoint({}), port, TCFG), str(tmp_path), "port")
    back = JCK.state_from_checkpoint(
        JCK.load_checkpoint(str(tmp_path / "port_with_model.pt")), jcfg,
        JTCFG)
    for x, y in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(state)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("mix", ["global", "ped"])
def test_noise_options_match_jax(mix):
    """``noise_type`` gaussian and uniform under ``noise_mix_type`` ``mix``:
    the k=20 serving positions from JAX's ``sample_noises`` (bit-equal to
    its in-decode draws) against grouptraj's own draws from the same keys,
    and the port's ``sample_noises``: shape, sharing across a scene's
    pedestrians ('global') or not ('ped'), range and moments beside
    JAX's."""
    batch = synthetic_batch(S, N, NARROW["obs_len"], NARROW["pred_len"],
                            seed=7)
    b = {k: _t(v) for k, v in batch.items()}
    keys = jax.random.split(jax.random.PRNGKey(11), K)
    many = jax.random.split(jax.random.PRNGKey(2), 400)
    for noise_type in ("gaussian", "uniform"):
        opts = dict(NARROW, noise_type=noise_type, noise_mix_type=mix)
        jcfg, cfg = JaxModelConfig(**opts), ModelConfig(**opts)
        g = TrajectoryGenerator(cfg).eval()
        TS.init_parameters(g, torch.Generator().manual_seed(1))
        params = jax.tree_util.tree_map(
            jnp.asarray, params_to_jax(g.state_dict(), "generator"))

        @_jit_for(jcfg)
        def refs(p, b):
            ctx = jax_context(p, jcfg, b["obs"], b["obs_rel"], b["group"],
                              b["valid"], train=False)
            return (ctx, jax_sample(p, jcfg, ctx, b["obs"], b["obs_rel"],
                                    b["group"], b["valid"], keys,
                                    train=False),
                    jax_sample_noises(jcfg, keys, S, N, jnp.float32),
                    jax_sample_noises(jcfg, many, S, N, jnp.float32))

        ctx_ref, preds_ref, z, jz = (np.asarray(x) for x in refs(params,
                                                                 batch))
        with torch.no_grad():
            preds = g.generator_sample_many(_t(ctx_ref), b["obs_rel"],
                                            b["valid"], K, user_noises=_t(z))
        last = b["obs"][None, :, :, -1]
        _close(relative_to_abs(preds, last),
               relative_to_abs(_t(preds_ref), last), 1e-4, noise_type)

        pz = sample_noises(cfg, len(many), S, N,
                           torch.Generator().manual_seed(2)).numpy()
        assert pz.shape == jz.shape == (len(many), S, N,
                                        cfg.noise_first_dim)
        for zz in (jz, pz):
            shared = (zz == zz[:, :, :1]).all()
            assert shared == (mix == "global"), (noise_type, mix)
            flat = zz[:, :, 0].ravel()
            std = 1.0 if noise_type == "gaussian" else 1.0 / np.sqrt(3.0)
            assert abs(flat.mean()) < 0.05 and abs(flat.std() - std) < 0.05
            if noise_type == "uniform":
                assert flat.min() >= -1.0 and flat.max() < 1.0
