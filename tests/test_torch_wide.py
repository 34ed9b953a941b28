"""K3-K6 at every LSTM width the JAX kernels take, on the CPU: the port's
recurrences at widths past the register design's (H up to 128, D up to
64) and between its built widths, against ``grouptraj/ops/pallas_fused.py``
and ``pallas_lstm.py`` in interpret mode; the width rule
(``cuda_lstm.lstm_plan``) and its refusals; the zero padding's exactness;
one d-step + g-step of the JAX package's H=128 / D=32 scale configuration
(``tools/scale_bench.py``) on ``'fused'`` and ``'pallas'``.

On the CPU the port runs the kernels' plain versions; the CUDA kernels
(``csrc/lstm_wide_*.cu`` past H = 64 or D = 16, the register design below)
are held against those on the card (tests/test_torch_cuda.py,
chip_smoke.py's wide phase). The JAX references are jitted once per shape
and module.

Tolerances (float32 on both sides): forwards 1e-5 absolute; gradients 1e-4
of each tensor's largest entry (the JAX package's own kernel tests'
limit), as in tests/test_torch_fused.py; the padded plain versions against
the unpadded ones 1e-6 (the same sums with zero terms added), padded units
exactly zero; the steps' losses 1e-5 relative and parameters 1e-6, as in
tests/test_torch_fused_path.py, an entry whose gradient is within rounding
of zero held to 5% of lr and the inter-group attention vectors to 2 lr
(``_assert_params``).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grouptraj.ops.pallas_fused as PF
import grouptraj.ops.pallas_lstm as PL
from grouptraj.config import ModelConfig as JaxModelConfig
from grouptraj.config import TrainConfig as JaxTrainConfig
from grouptraj.models.generator import sample_noises as jax_sample_noises
from grouptraj.ops.lstm import lstm_scan as jax_lstm_scan
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
from grouptraj_torch.ops import lstm as TL
from grouptraj_torch.train import steps as TS

# the scale study's widths (tools/scale_bench.py: "H=128"), at S=2, N=8
SCALE = dict(encoder_h_dim_g=128, decoder_h_dim_g=128, encoder_h_dim_d=128,
             embedding_dim=32, noise_dim=(16,))
TRAIN = dict(best_k=3, batch_size=2, bf16_nograd=False)
S, N = 2, 8
JCFG = JaxModelConfig(pool_impl="fast", **SCALE)
CFG = ModelConfig(**SCALE)

# the inter-group GAT's attention vectors: gradients at the rounding level
# (the complete inter-group graph's row softmax drops the source half)
NOISY = ("gatencoder.gat_inter.attention_0.a",
         "gatencoder.gat_inter.out_att.a")

# the references compile with XLA's cheap CPU pipeline (as in
# tests/test_torch_presets.py; 28% less CPU time for this file), which
# moves only rounding
_jit = functools.partial(jax.jit, compiler_options=dict(
    xla_llvm_disable_expensive_passes=True,
    xla_backend_optimization_level=0))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: one torch thread a process keeps the workers of
    a parallel test run from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret_mode(monkeypatch):
    """Both Pallas modules' kernels in interpret mode; the list counts the
    kernels traced, so that a silent scan cannot pass."""
    traced = []
    for mod in (PF, PL):
        orig = mod.pl.pallas_call

        def patched(*a, _orig=orig, **k):
            k["interpret"] = True
            traced.append(1)
            return _orig(*a, **k)

        monkeypatch.setattr(mod.pl, "pallas_call", patched)
    return traced


def _t(x):
    return torch.from_numpy(np.array(x))


def _close_grads(got, ref, what):
    for i, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        err = np.abs(g.numpy() - r).max()
        assert err <= 1e-4 * np.abs(r).max(), (what, i, err)


@_jit
def _jax_recurrences(w, gx, h0, c0, b, cot_ys, cot_dec):
    """Both whole-loop recurrences' outputs and VJPs in one program."""
    def enc(w, gx, h0, c0):
        ys, (h, c) = PF.lstm_recurrence_pallas(w, gx, h0, c0)
        return jnp.sum(ys * cot_ys) + jnp.sum(h * c), (ys, h, c)

    def dec(w, b, h0, c0):
        ys = PF.decoder_recurrence_pallas(w, b, h0, c0, cot_dec.shape[0])
        return jnp.sum(ys * cot_dec), ys

    (_, e_out), e_grad = jax.value_and_grad(enc, (0, 1, 2, 3),
                                            has_aux=True)(w, gx, h0, c0)
    (_, d_out), d_grad = jax.value_and_grad(dec, (0, 1, 2, 3),
                                            has_aux=True)(w, b, h0, c0)
    return e_out, e_grad, d_out, d_grad


@pytest.mark.parametrize("widths", [(12, 40), (72, 128)])
def test_fused_recurrences_match_pallas_at_every_width(widths,
                                                       interpret_mode):
    """The port's 'fused' recurrences (the plain K3/K4 on CPU tensors) at
    widths between the register design's builds (12, 40) and past them
    (72, 128), forward and backward, from a non-zero state."""
    for H in widths:
        _hold_recurrences(H)
    assert interpret_mode                       # the Pallas kernels ran


def _hold_recurrences(H):
    T, Td, B = 5, 4, 9
    rng = np.random.default_rng(H)
    n = lambda s, *sh: (s * rng.normal(size=sh)).astype(np.float32)
    w, gx, h0, c0 = n(H ** -0.5, H, 4 * H), n(1, T, B, 4 * H), n(.5, B, H), \
        n(.5, B, H)
    b, cot_ys, cot_dec = n(.1, 4 * H), n(1, T, B, H), n(1, Td, B, H)
    e_out, e_grad, d_out, d_grad = _jax_recurrences(w, gx, h0, c0, b,
                                                    cot_ys, cot_dec)
    leaves = [_t(a).requires_grad_() for a in (w, gx, h0, c0)]
    ys, (h, c) = CL.lstm_recurrence_fused(*leaves)
    for got, ref in zip((ys, h, c), e_out):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   atol=1e-5)
    loss = (ys * _t(cot_ys)).sum() + (h * c).sum()
    _close_grads(torch.autograd.grad(loss, leaves), e_grad, f"lstm H={H}")
    leaves = [_t(a).requires_grad_() for a in (w, b, h0, c0)]
    ys = CL.decoder_recurrence_fused(*leaves, Td)
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(d_out),
                               atol=1e-5)
    _close_grads(torch.autograd.grad((ys * _t(cot_dec)).sum(), leaves),
                 d_grad, f"decoder H={H}")


@_jit
def _jax_scan_pallas(params, xs, h0, c0, cot):
    def f(params, xs, h0, c0):
        ys, (h, c) = jax_lstm_scan(params, xs, h0, c0, impl="pallas")
        return jnp.sum(ys * cot) + jnp.sum(h * c), ys

    (_, ys), grads = jax.value_and_grad(f, (0, 1, 2, 3), has_aux=True)(
        params, xs, h0, c0)
    return ys, grads


def test_lstm_scan_proj_matches_pallas_at_wide_widths(interpret_mode):
    """``lstm_scan(impl='pallas')`` (the plain K5/K6 on CPU tensors) at
    (D, H) = (12, 40) (padded in the register design), (32, 128) (the scale
    configuration's encoders) and (64, 128) (the widest), forward and the
    gradients of all seven inputs."""
    names = ("w_ih", "w_hh", "b_ih", "b_hh")
    for D, H in ((12, 40), (32, 128), (64, 128)):
        T, B = 5, 7
        rng = np.random.default_rng(D + H)
        u = lambda *s: (rng.uniform(-1, 1, s) / np.sqrt(H)).astype(
            np.float32)
        n = lambda *s: (0.5 * rng.normal(size=s)).astype(np.float32)
        p = {"w_ih": u(D, 4 * H), "w_hh": u(H, 4 * H), "b_ih": u(4 * H),
             "b_hh": u(4 * H)}
        xs, h0, c0, cot = n(T, B, D), n(B, H), n(B, H), n(T, B, H)
        ys_j, (gp, *g_rest) = _jax_scan_pallas(p, xs, h0, c0, cot)
        leaves = {k: _t(v).requires_grad_() for k, v in p.items()}
        rest = [_t(a).requires_grad_() for a in (xs, h0, c0)]
        ys, (h, c) = TL.lstm_scan(leaves, *rest, impl="pallas")
        np.testing.assert_allclose(ys.detach().numpy(), np.asarray(ys_j),
                                   atol=1e-5)
        got = torch.autograd.grad((ys * _t(cot)).sum() + (h * c).sum(),
                                  list(leaves.values()) + rest)
        _close_grads(got, [gp[k] for k in names] + list(g_rest),
                     f"D={D} H={H}")
    assert interpret_mode


def test_width_rule_and_its_refusals():
    """``lstm_plan``: the register design at its next built width up to
    H = 64 and D = 16, the wide design at multiples of 8 (H) and 4 (D) up
    to 128 and 64; the wrappers' size checks raise past those on CUDA and
    take any width on the CPU."""
    P = CL.LstmPlan
    table = {(1, 0): P("register", 8, 0), (12, 0): P("register", 16, 0),
             (40, 0): P("register", 48, 0), (64, 0): P("register", 64, 0),
             (65, 0): P("wide", 72, 0), (100, 0): P("wide", 104, 0),
             (128, 0): P("wide", 128, 0), (12, 2): P("register", 16, 4),
             (40, 12): P("register", 48, 16), (64, 16): P("register", 64, 16),
             (64, 17): P("wide", 64, 20), (8, 20): P("wide", 8, 20),
             (100, 12): P("wide", 104, 12), (128, 32): P("wide", 128, 32),
             (128, 64): P("wide", 128, 64)}
    for (H, D), plan in table.items():
        assert CL.lstm_plan(H, D) == plan, (H, D)
    for H, D in ((129, 0), (0, 0), (128, 65), (256, 32)):
        with pytest.raises(ValueError, match="128"):
            CL.lstm_plan(H, D)
    assert CL._check_sizes(3, 4, 100, cuda=True) == P("wide", 104, 0)
    with pytest.raises(ValueError):
        CL._check_sizes(3, 4, 129, cuda=True)            # H past the limit
    assert CL._check_sizes(3, 4, 129, cuda=False) is None
    assert CP._check_sizes(3, 4, 32, 128, cuda=True) == P("wide", 128, 32)
    with pytest.raises(ValueError):
        CP._check_sizes(3, 4, 65, 32, cuda=True)          # D past the limit
    with pytest.raises(ValueError):
        CP._check_sizes(3, 4, 16, 129, cuda=True)         # H past the limit
    assert CP._check_sizes(3, 4, 65, 129, cuda=False) is None


def test_zero_padding_is_exact():
    """The wrappers' padded branches (``fused_fwd_padded`` and its three
    siblings) with the plain versions in place of the launches: the padded
    units' h, c and gradients are exactly zero inside, and the sliced
    results equal the unpadded plain versions', forward and backward."""
    T, B, D, H, Hp = 4, 6, 6, 10, 24
    rng = np.random.default_rng(0)
    n = lambda *s: _t((0.5 * rng.normal(size=s)).astype(np.float32))
    w, w_ih, h0, c0 = n(H, 4 * H), n(D, 4 * H), n(B, H), n(B, H)
    gx, b, xs = n(T, B, 4 * H), n(4 * H), n(T, B, D)
    dys, dhT, dcT = n(T, B, H), n(B, H), n(B, H)
    padded = []

    def fwd_plain(w, h0, c0, gx, b, T, save):
        out = TL._fused_fwd_plain(w, gx, b, h0, c0, T, save)
        padded.append(out)
        return out

    def bwd_plain(*args):
        out = TL.fused_recurrence_bwd_plain(*args)
        padded.append(out)
        return out

    for gx_, b_, with_gx in ((gx, None, True), (None, b, False)):
        ref = TL._fused_fwd_plain(w, gx_, b_, h0, c0, T, True)
        got = CL.fused_fwd_padded(fwd_plain, Hp, w, h0, c0, gx_, b_, T, True)
        ys_p, hT_p, cT_p, _, cs_p = padded[-1]
        for t in (ys_p, hT_p, cT_p, cs_p):
            assert t[..., H:].abs().max() == 0
        for x, y in zip(got, ref):
            assert x.shape == y.shape and (x - y).abs().max() <= 1e-6
        ys, _, _, gates, cs = ref
        args = (w, h0, c0, ys, gates, cs, dys, None if not with_gx else dhT,
                None if not with_gx else dcT, with_gx)
        ref = TL.fused_recurrence_bwd_plain(*args)
        got = CL.fused_bwd_padded(bwd_plain, Hp, *args)
        dgx_p, dw_p, db_p, dh0_p, dc0_p = padded[-1]
        assert dw_p[H:].abs().max() == 0 and dh0_p[:, H:].abs().max() == 0
        assert dw_p.unflatten(1, (4, Hp))[..., H:].abs().max() == 0
        for x, y in zip(got, ref):
            assert (x is None) == (y is None)
            if x is not None:
                assert x.shape == y.shape
                assert (x - y).abs().max() <= 1e-6 * max(1, y.abs().max())
    plan = CL.LstmPlan("wide", Hp, 12)
    ref = TL.lstm_proj_fwd_plain(w_ih, w, b, xs, h0, c0, True)
    got = CP.proj_fwd_padded(
        lambda *a: TL.lstm_proj_fwd_plain(*a), plan, w_ih, w, b, xs, h0, c0,
        True)
    for x, y in zip(got, ref):
        assert x.shape == y.shape and (x - y).abs().max() <= 1e-6
    ys, _, _, gates, cs = ref
    args = (w_ih, w, xs, h0, c0, ys, gates, cs, dys, dhT, dcT)
    ref = TL.lstm_proj_bwd_plain(*args)
    got = CP.proj_bwd_padded(lambda *a: TL.lstm_proj_bwd_plain(*a), plan,
                             *args)
    for x, y in zip(got, ref):
        assert x.shape == y.shape
        assert (x - y).abs().max() <= 1e-6 * max(1, y.abs().max())


def _np_state(params, kind):
    return params_from_jax(jax.device_get(params), kind)


def _draws(jcfg):
    """One iteration's draws, taken with JAX under build_d_step's and
    build_g_step's key splits (tests/test_torch_fused_path.py)."""
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


@pytest.fixture(scope="module")
def jax_steps():
    """One d-step + g-step of the scale configuration on each kernel route
    of the JAX package, through its interpreted Pallas kernels ('fused'
    reached by reporting a TPU backend, as tests/test_torch_fused_path.py
    does)."""
    out = {}
    for impl in ("fused", "pallas"):
        traced = []
        tcfg = JaxTrainConfig(lstm_impl=impl, **TRAIN)
        with pytest.MonkeyPatch.context() as mp:
            for mod in (PF, PL):
                orig = mod.pl.pallas_call

                def patched(*a, _orig=orig, **k):
                    k["interpret"] = True
                    traced.append(1)
                    return _orig(*a, **k)

                mp.setattr(mod.pl, "pallas_call", patched)
            if impl == "fused":
                mp.setattr(jax, "default_backend", lambda: "tpu")
            state = jax_init_train_state(jax.random.PRNGKey(0), JCFG, tcfg)
            # lift the classifier's last bias so D's trailing ReLU lets
            # scores and gradients through
            state.d_params["real_classifier"]["layers"][-1]["linear"][
                "b"] += 1.0
            batch = synthetic_batch(S, N, JCFG.obs_len, JCFG.pred_len,
                                    seed=5)
            init = (_np_state(state.g_params, "generator"),
                    _np_state(state.d_params, "discriminator"))
            key_d, key_g, _, _ = _draws(JCFG)
            state, ld = _jit(build_d_step(JCFG, tcfg, impl))(state, batch,
                                                             key_d)
            state, lg = _jit(build_g_step(JCFG, tcfg, impl))(state, batch,
                                                             key_g)
            assert traced                        # the Pallas kernels ran
        out[impl] = dict(
            init=init, batch={k: np.asarray(v) for k, v in batch.items()},
            losses={k: float(v) for k, v in {**ld, **lg}.items()},
            after=(_np_state(state.g_params, "generator"),
                   _np_state(state.d_params, "discriminator")))
    return out


def _assert_params(module, ref, what, init, lr):
    """Within 1e-6; entries the reference moved by less than 0.95 lr within
    5% of lr. Adam's first step moves an entry by lr |g| / (|g| + eps), eps
    = 1e-8, so those have |g| < 19 eps = 1.9e-7, within float32 rounding of
    zero beside the networks' largest entries (~0.5 and ~10), and the step
    turns that rounding into up to a few % of lr. At these widths such
    entries also lie between lr / 2 and 0.95 lr, where
    tests/test_torch_fused_path.py's narrower networks have none. The
    inter-group GAT's attention vectors (NOISY), whose whole gradient is
    rounding noise, within 2 lr, as in tests/test_torch_multi.py."""
    got = module.state_dict()
    assert set(got) == set(ref)
    for k, r in ref.items():
        diff = np.abs(got[k].numpy() - r)
        tol = np.full_like(r, 2 * lr if k in NOISY else 1e-6)
        tol[np.abs(r - init[k]) < 0.95 * lr] = max(0.05 * lr, tol.max())
        assert (diff <= tol).all(), (what, k, diff.max())


@pytest.mark.parametrize("impl", ["fused", "pallas"])
def test_scale_configuration_iteration_matches_jax(impl, jax_steps):
    """One d-step + g-step of the H=128 / D=32 scale configuration on the
    port's ``impl`` route (every recurrence at H = 128 through the kernels'
    wrappers, which on the card take the wide design) against the JAX
    package's same route, from the same bridged weights and draws."""
    ref = jax_steps[impl]
    tcfg = TrainConfig(lstm_impl=impl, **TRAIN)
    g, d = TrajectoryGenerator(CFG), TrajectoryDiscriminator(CFG)
    g.load_state_dict(generator_state(ref["init"][0]))
    d.load_state_dict(discriminator_state(ref["init"][1]))
    state = TS.train_state_from_modules(g, d, tcfg)
    batch = {k: _t(v) for k, v in ref["batch"].items()}
    _, _, d_draw, g_draw = _draws(JCFG)
    g_before = copy.deepcopy(state.g.state_dict())
    losses = TS.d_step(state, batch, CFG, tcfg, **d_draw)
    for k, v in state.g.state_dict().items():          # the d-step leaves G
        assert torch.equal(v, g_before[k]), k
    losses.update(TS.g_step(state, batch, CFG, tcfg, **g_draw))
    assert set(losses) == set(ref["losses"])
    for k, r in ref["losses"].items():
        np.testing.assert_allclose(float(losses[k]), r, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert ref["losses"]["norm_d"] > 0
    _assert_params(state.d, ref["after"][1], "D", ref["init"][1],
                   tcfg.d_learning_rate)
    _assert_params(state.g, ref["after"][0], "G", ref["init"][0],
                   tcfg.g_learning_rate)
