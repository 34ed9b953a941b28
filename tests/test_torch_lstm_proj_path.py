"""The ``impl='pallas'`` path of the port as a whole against the JAX
package's ``impl='pallas'`` on the CPU, at narrow widths: the generator's
context, the K-tiled best-of-k decode, the discriminator, and one d-step +
g-step, from the same bridged weights and injected draws.

``lstm_scan(impl='pallas')`` reaches the JAX package's Pallas kernels on
any backend, so only ``pallas_call`` is patched, to interpret mode, and the
patch counts the kernels traced; ``pool_impl='fast'`` keeps the pool off
its own Pallas kernel. The JAX steps run under ``jax.jit`` as in
tests/test_torch_steps.py. The port runs the plain versions of kernels K5
and K6 (CPU tensors). On this route only the encoders change: both
packages decode on the scan route's folded recurrence.

Tolerances (float32 on both sides): context 1e-5; positions 1e-4 m; scores
1e-5; losses 1e-5 relative; parameters after one d-step and one g-step
1e-6 absolute. Entries whose gradient is zero to rounding (a handful of the
inter-group attention weights, see tests/test_torch_steps.py) are checked
for that alone: their gradients are rounding noise of 1e-10 to 1e-9 whose
sign differs even between the port's own routes, and Adam's first step,
lr·g/(|g| + 1e-8), turns that into anything up to a tenth of a learning
rate, so the port's step there must, like the reference's, stay under half
a learning rate.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import grouptraj.ops.pallas_lstm as PL
from grouptraj.config import ModelConfig as JaxModelConfig
from grouptraj.config import TrainConfig as JaxTrainConfig
from grouptraj.models.discriminator import discriminator_forward
from grouptraj.models.generator import (
    generator_context, generator_sample_many,
)
from grouptraj.models.generator import sample_noises as jax_sample_noises
from grouptraj.parallel.data_parallel import synthetic_batch
from grouptraj.train.steps import build_d_step, build_g_step
from grouptraj.train.steps import init_train_state as jax_init_train_state
from grouptraj_torch.compat import (
    discriminator_state, generator_state, params_from_jax,
)
from grouptraj_torch.config import ModelConfig, TrainConfig
from grouptraj_torch.models.discriminator import TrajectoryDiscriminator
from grouptraj_torch.models.generator import TrajectoryGenerator
from grouptraj_torch.ops import cuda_lstm_proj as CP
from grouptraj_torch.train import steps as TS

NARROW = dict(embedding_dim=8, encoder_h_dim_g=16, decoder_h_dim_g=16,
              noise_dim=(4,), bottleneck_dim=4, hidden_units=12,
              graph_out_dim=8, encoder_h_dim_d=8, mlp_dim=16, obs_len=4,
              pred_len=5)
TRAIN = dict(best_k=3, batch_size=4, bf16_nograd=False, lstm_impl="pallas")
S, N = 4, 6
JCFG = JaxModelConfig(pool_impl="fast", **NARROW)
JTCFG = JaxTrainConfig(**TRAIN)
CFG, TCFG = ModelConfig(**NARROW), TrainConfig(**TRAIN)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_state(params, kind):
    return params_from_jax(jax.device_get(params), kind)


def _draws():
    """The draws of one iteration, taken with JAX under the key splits of
    build_d_step / build_g_step, and the keys that reproduce them there."""
    key_d, key_g = jax.random.PRNGKey(100), jax.random.PRNGKey(200)
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
    return key_d, key_g, sample_keys, d, g


@pytest.fixture(scope="module")
def jax_pallas():
    """The JAX package's ``impl='pallas'`` results through its
    (interpreted) Pallas LSTM kernels."""
    traced = []
    orig_call = PL.pl.pallas_call

    def interpreted(*a, **k):
        k["interpret"] = True
        traced.append(1)
        return orig_call(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PL.pl, "pallas_call", interpreted)
        state = jax_init_train_state(jax.random.PRNGKey(0), JCFG, JTCFG)
        # lift the classifier's last bias so D's trailing ReLU lets scores
        # and gradients through
        state.d_params["real_classifier"]["layers"][-1]["linear"]["b"] += 1.0
        batch = synthetic_batch(S, N, JCFG.obs_len, JCFG.pred_len, seed=5)
        key_d, key_g, sample_keys, _, g_draw = _draws()
        out = {"init": (_np_state(state.g_params, "generator"),
                        _np_state(state.d_params, "discriminator")),
               "batch": {k: np.asarray(v) for k, v in batch.items()}}
        b = batch
        ctx = generator_context(state.g_params, JCFG, b["obs"], b["obs_rel"],
                                b["group"], b["valid"], impl="pallas")
        out["ctx"] = np.asarray(ctx)
        out["preds"] = np.asarray(generator_sample_many(
            state.g_params, JCFG, ctx, b["obs"], b["obs_rel"], b["group"],
            b["valid"], sample_keys, impl="pallas",
            user_noises=g_draw["noises"].numpy()))
        traj = np.concatenate([b["obs"], b["pred"]], axis=2)
        traj_rel = np.concatenate([b["obs_rel"], b["pred_rel"]], axis=2)
        out["scores"] = np.asarray(discriminator_forward(
            state.d_params, JCFG, traj, traj_rel, b["valid"], impl="pallas"))
        assert len(traced) == 2                  # the two encoders, forward
        d_step = jax.jit(build_d_step(JCFG, JTCFG, "pallas"))
        g_step = jax.jit(build_g_step(JCFG, JTCFG, "pallas"))
        state, ld = d_step(state, batch, key_d)
        state, lg = g_step(state, batch, key_g)
        # d: G encoder, D encoder and its backward; g: both encoders and
        # both backwards
        assert len(traced) == 2 + 3 + 4
        out["losses"] = {k: float(v) for k, v in {**ld, **lg}.items()}
        out["after"] = (_np_state(state.g_params, "generator"),
                        _np_state(state.d_params, "discriminator"))
    return out


def _port_state(init, tcfg=TCFG):
    g, d = TrajectoryGenerator(CFG), TrajectoryDiscriminator(CFG)
    g.load_state_dict(generator_state(init[0]))
    d.load_state_dict(discriminator_state(init[1]))
    return TS.train_state_from_modules(g, d, tcfg)


def _batch(arrays):
    return {k: _t(v) for k, v in arrays.items()}


def _data(arrays):
    """The batch as a device-resident dataset of S scenes."""
    data = {
        "xy": np.concatenate([arrays["obs"], arrays["pred"]], 2),
        "rel": np.concatenate([arrays["obs_rel"], arrays["pred_rel"]], 2),
        "group_end": arrays["group"], "valid": arrays["valid"],
        "loss_mask": arrays["loss_mask"],
        "non_linear": arrays["non_linear"].astype(np.float32)}
    return {k: _t(v) for k, v in data.items()}


def _assert_params(module, ref, atol, what, init, lr):
    """Every entry within ``atol`` of the reference, except those the
    reference moved by less than lr / 2: under Adam's first step,
    lr·g/(|g| + 1e-8), that is a gradient below 1e-8, zero to rounding.
    There the port must have moved by less than lr / 2 as well."""
    got = module.state_dict()
    assert set(got) == set(ref)
    for k, r in ref.items():
        x = got[k].numpy()
        zero = np.abs(r - init[k]) < lr / 2
        diff = np.abs(x - r)[~zero]
        assert (diff <= atol).all(), (what, k, diff.max())
        assert (np.abs(x - init[k])[zero] < lr / 2).all(), (what, k)


def test_context_and_samples_match_jax_pallas(jax_pallas):
    state, b = _port_state(jax_pallas["init"]), _batch(jax_pallas["batch"])
    noises = _draws()[4]["noises"]
    with torch.no_grad():
        ctx = state.g.generator_context(b["obs"], b["obs_rel"], b["group"],
                                        b["valid"], impl="pallas")
        preds = state.g.generator_sample_many(
            ctx, b["obs_rel"], b["valid"], TRAIN["best_k"],
            user_noises=noises, impl="pallas")
        one = state.g.generator_sample(ctx, b["obs_rel"], b["valid"],
                                       user_noise=noises[1], impl="pallas")
    np.testing.assert_allclose(ctx.numpy(), jax_pallas["ctx"], atol=1e-5)
    assert preds.shape == (TRAIN["best_k"], S, N, CFG.pred_len, 2)
    np.testing.assert_allclose(preds.numpy(), jax_pallas["preds"], atol=1e-4)
    # the K-tiled decode is the per-sample decode, row for row
    np.testing.assert_allclose(one.numpy(), preds[1].numpy(), atol=1e-6)
    assert (preds.numpy()[:, jax_pallas["batch"]["valid"] == 0] == 0).all()


def test_discriminator_matches_jax_pallas(jax_pallas):
    state, b = _port_state(jax_pallas["init"]), _batch(jax_pallas["batch"])
    traj = torch.cat([b["obs"], b["pred"]], dim=2)
    traj_rel = torch.cat([b["obs_rel"], b["pred_rel"]], dim=2)
    with torch.no_grad():
        scores = state.d(traj, traj_rel, b["valid"], impl="pallas")
    np.testing.assert_allclose(scores.numpy(), jax_pallas["scores"],
                               atol=1e-5)
    assert (jax_pallas["scores"] > 0).any()


def test_one_iteration_matches_jax_pallas(jax_pallas):
    init = jax_pallas["init"]
    state, batch = _port_state(init), _batch(jax_pallas["batch"])
    _, _, _, d_draw, g_draw = _draws()
    losses = TS.d_step(state, batch, CFG, TCFG, **d_draw)   # impl from TCFG
    losses.update(TS.g_step(state, batch, CFG, TCFG, **g_draw))
    ref = jax_pallas["losses"]
    assert set(losses) == set(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(float(losses[k]), r, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert ref["norm_d"] > 0 and ref["G_discriminator_loss"] > 0
    _assert_params(state.d, jax_pallas["after"][1], 1e-6, "D", init[1],
                   TCFG.d_learning_rate)
    _assert_params(state.g, jax_pallas["after"][0], 1e-6, "G", init[0],
                   TCFG.g_learning_rate)


def test_an_iteration_calls_the_kernel_wrappers(jax_pallas, monkeypatch):
    """Through ``train_iterations`` with ``lstm_impl='pallas'`` both
    encoders of both steps go through the kernels' wrappers: K5's four
    times (d: G encoder without grad, D encoder; g: G encoder, D encoder),
    the residuals saved for the three that a backward follows, K6's three
    times; with ``'scan'`` never."""
    calls = {"fwd": 0, "fwd_saved": 0, "bwd": 0}
    fwd, bwd = CP.lstm_proj_fwd, CP.lstm_proj_bwd

    def counting_fwd(*a, **k):
        calls["fwd"] += 1
        calls["fwd_saved"] += bool(k.get("save"))
        return fwd(*a, **k)

    def counting_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(CP, "lstm_proj_fwd", counting_fwd)
    monkeypatch.setattr(CP, "lstm_proj_bwd", counting_bwd)
    data = _data(jax_pallas["batch"])
    idx = torch.arange(S).expand(1, 2, S)
    gen = torch.Generator().manual_seed(0)
    bf16 = dataclasses.replace(TCFG, bf16_nograd=True)
    out = TS.train_iterations(_port_state(jax_pallas["init"], bf16), data,
                              idx, CFG, bf16, generator=gen)
    assert calls == {"fwd": 4, "fwd_saved": 3, "bwd": 3}
    assert all(torch.isfinite(v).all() for v in out.values())
    scan = dataclasses.replace(TCFG, lstm_impl="scan")
    TS.train_iterations(_port_state(jax_pallas["init"], scan), data, idx,
                        CFG, scan, generator=gen)
    assert calls == {"fwd": 4, "fwd_saved": 3, "bwd": 3}


def test_pallas_and_scan_routes_agree(jax_pallas):
    """The same bridged weights on both routes: one iteration's losses and
    gradients agree to rounding (the encoder's embedding is folded on one
    and not on the other), and the decoder is the scan route's on both —
    from a bfloat16 context it decodes in bfloat16 and equals ``'scan'`` bit
    for bit."""
    init, batch = jax_pallas["init"], _batch(jax_pallas["batch"])
    _, _, _, d_draw, g_draw = _draws()
    results = {}
    for impl in ("scan", "pallas"):
        state = _port_state(init)
        ld, gd = TS.d_gradients(state, batch, CFG, TCFG, impl=impl, **d_draw)
        lg, gg = TS.g_gradients(state, batch, CFG, TCFG, impl=impl, **g_draw)
        results[impl] = ({**ld, **lg}, list(gd) + list(gg))
    for k, v in results["scan"][0].items():
        np.testing.assert_allclose(float(results["pallas"][0][k]), float(v),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    for a, b in zip(results["pallas"][1], results["scan"][1]):
        assert (a - b).abs().max() <= 1e-5 * max(1.0, b.abs().max())

    g = _port_state(init).g
    ctx = _t(jax_pallas["ctx"]).bfloat16()
    with torch.no_grad():
        preds = {impl: g.generator_sample_many(
            ctx, batch["obs_rel"], batch["valid"], TRAIN["best_k"],
            user_noises=g_draw["noises"], impl=impl)
            for impl in ("scan", "pallas")}
    pallas = preds["pallas"]
    assert torch.equal(pallas, pallas.bfloat16().float())   # bf16 arithmetic
    assert torch.equal(pallas, preds["scan"])
