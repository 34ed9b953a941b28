"""The ``impl='fused'`` path of the port as a whole against the JAX
package's ``impl='fused'`` on the CPU, at narrow widths: the generator's
context, the K-tiled best-of-k decode, the discriminator, and one d-step +
g-step, from the same bridged weights and injected draws.

On the CPU the JAX package demotes ``'fused'`` to its scan functions, so
the reference is made to reach its Pallas kernels: ``jax.default_backend``
is patched to report ``"tpu"`` and ``pallas_call`` to run in interpret
mode, with ``pool_impl='fast'`` on the JAX side so that the pool does not
pick its own Pallas kernel. The fixture checks that the Pallas recurrences
were really traced. The JAX steps run under ``jax.jit`` as in
tests/test_torch_steps.py. The port runs the plain versions of kernels K3
and K4 (CPU tensors).

Tolerances (float32 on both sides): context 1e-5; positions 1e-4 m; scores
1e-5; losses 1e-5 relative; parameters after one d-step and one g-step
1e-6 absolute, entries whose gradient is zero to rounding held to 5% of
the learning rate (see tests/test_torch_steps.py). ``'fused'`` and
``'scan'`` are different algebra for the encoder (the embedding is not
folded), so the port's two routes agree to 1e-5, not bit for bit.
"""

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

import grouptraj.ops.pallas_fused as PF
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
from grouptraj_torch.ops import cuda_lstm as CL
from grouptraj_torch.ops import cuda_lstm_proj as CP
from grouptraj_torch.train import steps as TS

NARROW = dict(embedding_dim=8, encoder_h_dim_g=16, decoder_h_dim_g=16,
              noise_dim=(4,), bottleneck_dim=4, hidden_units=12,
              graph_out_dim=8, encoder_h_dim_d=8, mlp_dim=16, obs_len=4,
              pred_len=5)
TRAIN = dict(best_k=3, batch_size=4, bf16_nograd=False, lstm_impl="fused")
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
def jax_fused():
    """The JAX package's ``impl='fused'`` results through its (interpreted)
    Pallas recurrences."""
    traced = {"lstm": 0, "decoder": 0}
    orig_call = PF.pl.pallas_call
    orig_lstm, orig_dec = (PF.lstm_recurrence_pallas,
                           PF.decoder_recurrence_pallas)

    def interpreted(*a, **k):
        k["interpret"] = True
        return orig_call(*a, **k)

    def counted(name, fn):
        def wrapper(*a):
            traced[name] += 1
            return fn(*a)
        return wrapper

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        mp.setattr(PF.pl, "pallas_call", interpreted)
        mp.setattr(PF, "lstm_recurrence_pallas", counted("lstm", orig_lstm))
        mp.setattr(PF, "decoder_recurrence_pallas",
                   counted("decoder", orig_dec))
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
                                b["group"], b["valid"], impl="fused")
        out["ctx"] = np.asarray(ctx)
        out["preds"] = np.asarray(generator_sample_many(
            state.g_params, JCFG, ctx, b["obs"], b["obs_rel"], b["group"],
            b["valid"], sample_keys, impl="fused",
            user_noises=g_draw["noises"].numpy()))
        traj = np.concatenate([b["obs"], b["pred"]], axis=2)
        traj_rel = np.concatenate([b["obs_rel"], b["pred_rel"]], axis=2)
        out["scores"] = np.asarray(discriminator_forward(
            state.d_params, JCFG, traj, traj_rel, b["valid"], impl="fused"))
        assert traced == {"lstm": 2, "decoder": 1}
        d_step = jax.jit(build_d_step(JCFG, JTCFG, "fused"))
        g_step = jax.jit(build_g_step(JCFG, JTCFG, "fused"))
        state, ld = d_step(state, batch, key_d)
        state, lg = g_step(state, batch, key_g)
        # d: G encoder, D encoder | G decode; g: G encoder, D encoder |
        # probe decode, re-decode
        assert traced == {"lstm": 6, "decoder": 4}
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


def _assert_params(module, ref, atol, what, init, lr):
    """Entries the reference moved by less than lr / 2 (|g| < 1e-8 under
    Adam's first step) are held to 5% of lr."""
    got = module.state_dict()
    assert set(got) == set(ref)
    for k, r in ref.items():
        diff = np.abs(got[k].numpy() - r)
        tol = np.full_like(r, atol)
        tol[np.abs(r - init[k]) < lr / 2] = 0.05 * lr
        assert (diff <= tol).all(), (what, k, diff.max())


def test_context_and_samples_match_jax_fused(jax_fused):
    state, b = _port_state(jax_fused["init"]), _batch(jax_fused["batch"])
    noises = _draws()[4]["noises"]
    with torch.no_grad():
        ctx = state.g.generator_context(b["obs"], b["obs_rel"], b["group"],
                                        b["valid"], impl="fused")
        preds = state.g.generator_sample_many(
            ctx, b["obs_rel"], b["valid"], TRAIN["best_k"],
            user_noises=noises, impl="fused")
        one = state.g.generator_sample(ctx, b["obs_rel"], b["valid"],
                                       user_noise=noises[1], impl="fused")
    np.testing.assert_allclose(ctx.numpy(), jax_fused["ctx"], atol=1e-5)
    assert preds.shape == (TRAIN["best_k"], S, N, CFG.pred_len, 2)
    np.testing.assert_allclose(preds.numpy(), jax_fused["preds"], atol=1e-4)
    # the K-tiled decode is the per-sample decode, row for row
    np.testing.assert_allclose(one.numpy(), preds[1].numpy(), atol=1e-6)
    assert (preds.numpy()[:, jax_fused["batch"]["valid"] == 0] == 0).all()


def test_discriminator_matches_jax_fused(jax_fused):
    state, b = _port_state(jax_fused["init"]), _batch(jax_fused["batch"])
    traj = torch.cat([b["obs"], b["pred"]], dim=2)
    traj_rel = torch.cat([b["obs_rel"], b["pred_rel"]], dim=2)
    with torch.no_grad():
        scores = state.d(traj, traj_rel, b["valid"], impl="fused")
    np.testing.assert_allclose(scores.numpy(), jax_fused["scores"], atol=1e-5)
    assert (jax_fused["scores"] > 0).any()


def test_one_iteration_matches_jax_fused(jax_fused):
    init = jax_fused["init"]
    state, batch = _port_state(init), _batch(jax_fused["batch"])
    _, _, _, d_draw, g_draw = _draws()
    g_before = copy.deepcopy(state.g.state_dict())
    losses = TS.d_step(state, batch, CFG, TCFG, **d_draw)   # impl from TCFG
    for k, v in state.g.state_dict().items():           # the d-step leaves G
        assert torch.equal(v, g_before[k]), k
    losses.update(TS.g_step(state, batch, CFG, TCFG, impl="fused", **g_draw))
    ref = jax_fused["losses"]
    assert set(losses) == set(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(float(losses[k]), r, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert ref["norm_d"] > 0 and ref["G_discriminator_loss"] > 0
    _assert_params(state.d, jax_fused["after"][1], 1e-6, "D", init[1],
                   TCFG.d_learning_rate)
    _assert_params(state.g, jax_fused["after"][0], 1e-6, "G", init[0],
                   TCFG.g_learning_rate)


def test_an_iteration_calls_the_kernel_wrappers(jax_fused, monkeypatch):
    """Through ``train_iterations`` with ``lstm_impl='fused'`` every
    recurrence goes through the kernels' wrappers: K3's seven times (d: G
    encoder, G decoder, D encoder; g: G encoder, probe decode, re-decode,
    D encoder), K4's four times, the residuals saved only for the four
    forwards that a backward follows; with ``'scan'`` never."""
    calls = {"fwd": 0, "fwd_saved": 0, "bwd": 0}
    fwd, bwd = CL.lstm_fused_fwd, CL.lstm_fused_bwd

    def counting_fwd(*a, **k):
        calls["fwd"] += 1
        calls["fwd_saved"] += bool(k.get("save"))
        return fwd(*a, **k)

    def counting_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(CL, "lstm_fused_fwd", counting_fwd)
    monkeypatch.setattr(CL, "lstm_fused_bwd", counting_bwd)
    arrays = jax_fused["batch"]
    data = {
        "xy": np.concatenate([arrays["obs"], arrays["pred"]], 2),
        "rel": np.concatenate([arrays["obs_rel"], arrays["pred_rel"]], 2),
        "group_end": arrays["group"], "valid": arrays["valid"],
        "loss_mask": arrays["loss_mask"],
        "non_linear": arrays["non_linear"].astype(np.float32)}
    data = {k: _t(v) for k, v in data.items()}
    idx = torch.arange(S).expand(1, 2, S)
    gen = torch.Generator().manual_seed(0)
    bf16 = dataclasses.replace(TCFG, bf16_nograd=True)
    out = TS.train_iterations(_port_state(jax_fused["init"], bf16), data,
                              idx, CFG, bf16, generator=gen)
    assert calls == {"fwd": 7, "fwd_saved": 4, "bwd": 4}
    assert all(torch.isfinite(v).all() for v in out.values())
    scan = dataclasses.replace(TCFG, lstm_impl="scan")
    TS.train_iterations(_port_state(jax_fused["init"], scan), data, idx, CFG,
                        scan, generator=gen)
    assert calls == {"fwd": 7, "fwd_saved": 4, "bwd": 4}


def test_same_weights_serve_both_routes(jax_fused):
    """No new parameters: the same bridged state dict runs ``'scan'`` and
    ``'fused'``, and the two routes agree to rounding (the encoder's
    embedding is folded on one and not on the other)."""
    init = jax_fused["init"]
    batch = _batch(jax_fused["batch"])
    _, _, _, d_draw, g_draw = _draws()
    results = {}
    for impl in ("scan", "fused"):
        state = _port_state(init)
        assert set(state.g.state_dict()) == set(generator_state(init[0]))
        assert set(state.d.state_dict()) == set(discriminator_state(init[1]))
        ld, gd = TS.d_gradients(state, batch, CFG, TCFG, impl=impl, **d_draw)
        lg, gg = TS.g_gradients(state, batch, CFG, TCFG, impl=impl, **g_draw)
        results[impl] = ({**ld, **lg}, list(gd) + list(gg))
    for k, v in results["scan"][0].items():
        np.testing.assert_allclose(float(results["fused"][0][k]), float(v),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    for a, b in zip(results["fused"][1], results["scan"][1]):
        assert (a - b).abs().max() <= 1e-5 * max(1.0, b.abs().max())


def test_bf16_nograd_legs_on_the_fused_route(jax_fused):
    """Only the no-grad legs change (they decode from bfloat16-rounded
    state and weights, in float32 inside the kernel's function): the g-step
    equals the float32 one when the per-scene argmin agrees, the d-step's
    loss stays within 5%."""
    init, batch = jax_fused["init"], _batch(jax_fused["batch"])
    _, _, _, d_draw, g_draw = _draws()
    bf_cfg = dataclasses.replace(TCFG, bf16_nograd=True)
    ld32, _ = TS.d_gradients(_port_state(init), batch, CFG, TCFG, **d_draw)
    ld16, _ = TS.d_gradients(_port_state(init), batch, CFG, bf_cfg, **d_draw)
    np.testing.assert_allclose(float(ld16["D_total_loss"]),
                               float(ld32["D_total_loss"]), rtol=5e-2)
    lg32, g32 = TS.g_gradients(_port_state(init), batch, CFG, TCFG, **g_draw)
    lg16, g16 = TS.g_gradients(_port_state(init), batch, CFG, bf_cfg,
                               **g_draw)
    for k, v in lg32.items():
        np.testing.assert_allclose(float(lg16[k]), float(v), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    for a, b in zip(g16, g32):
        assert a.dtype == torch.float32
        assert (a - b).abs().max() <= 1e-5 * max(1.0, b.abs().max())


def test_pallas_route_raises_through_the_steps(jax_fused, monkeypatch):
    """``lstm_impl='pallas'`` (ported: kernels K5/K6) is taken by the
    steps when ``impl`` is left None — both encoders of both steps go
    through K5's wrapper — and both run to finite losses."""
    calls = []
    fwd = CP.lstm_proj_fwd
    monkeypatch.setattr(CP, "lstm_proj_fwd",
                        lambda *a, **k: calls.append(1) or fwd(*a, **k))
    state, batch = _port_state(jax_fused["init"]), _batch(jax_fused["batch"])
    tcfg = dataclasses.replace(TCFG, lstm_impl="pallas")
    _, _, _, d_draw, g_draw = _draws()
    losses = TS.d_step(state, batch, CFG, tcfg, **d_draw)
    losses.update(TS.g_step(state, batch, CFG, tcfg, **g_draw))
    assert len(calls) == 4
    assert all(bool(torch.isfinite(v)) for v in losses.values())
