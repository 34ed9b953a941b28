"""The social-pool core's bfloat16 mode against the JAX package on the CPU.

At JAX's default matmul precision the TPU kernels K1/K2
(``grouptraj/ops/pallas_pool.py``) round both operands of the pair product,
and in the backward ``dq``, W2 and ``h1``, to bfloat16 with float32
accumulation; the port's mode (``grouptraj_torch.ops.precision``, the
setting at ``"default"``) does the same. Here the port's plain versions
(``pool_core``, ``pool_core_bwd_plain`` and ``PoolCore``, which runs them on
CPU tensors) are held against the JAX kernels run in Pallas interpret mode
under ``jax.default_matmul_precision("default")``; every JAX reference is
jitted, so each shape and precision traces once.

Tolerances, the bfloat16 products being exact in float32 on both sides and
only the order of the sums differing: pooled 1e-6 of its largest value and
``cnt`` equal on valid rows; da, du, dW2 and db2 1e-5 of each tensor's
largest entry; on inputs whose products and sums are exact (quantized
grids) bit for bit. The zoo checkpoint ``zara1_12`` through the whole
generator: context 1e-5, k=20 positions 1e-4 m (test_torch_serve.py's).
One d-step + g-step of the ``gat`` preset at narrow widths: losses 1e-5
relative, gradients and parameters as tests/test_torch_presets.py holds
them (1e-6, with Adam's first step on gradients that are rounding noise
excepted).
"""

import dataclasses
import functools
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_presets as P
from grouptraj.compat import config_from_checkpoint_args as jax_config
from grouptraj.compat import import_generator
from grouptraj.config import ModelConfig as JaxModelConfig
from grouptraj.models.generator import generator_context as jax_context
from grouptraj.models.generator import generator_sample_many as jax_sample
from grouptraj.models.generator import sample_noises as jax_sample_noises
from grouptraj.parallel.data_parallel import synthetic_batch
from grouptraj.train.checkpoint import load_checkpoint as jax_load
from grouptraj.train.steps import init_train_state as jax_init_train_state
from grouptraj_torch.compat import config_from_checkpoint_args, generator_state
from grouptraj_torch.config import ModelConfig
from grouptraj_torch.models.generator import TrajectoryGenerator
from grouptraj_torch.ops import precision as PREC
from grouptraj_torch.ops.cuda_pool import PoolCore, pool_core_fwd
from grouptraj_torch.ops.pooling import pool_core, pool_core_bwd_plain
from grouptraj_torch.train import steps as TS

PP = importlib.import_module("grouptraj.ops.pallas_pool")
CKPT = "models/grouptraj/zara1_12_with_model.pt"
NARROW = dict(embedding_dim=8, encoder_h_dim_g=16, decoder_h_dim_g=16,
              noise_dim=(4,), bottleneck_dim=4, hidden_units=12,
              graph_out_dim=8, encoder_h_dim_d=12, mlp_dim=16, obs_len=4,
              pred_len=5)
# the references skip LLVM's expensive passes, which changes no value; XLA's
# backend optimization level 0 (test_torch_presets.py's cheaper pipeline)
# is not used: at that level the interpreted kernels' bfloat16 products
# come out up to 3e-4 off in the zoo generator's context
_jit = functools.partial(jax.jit, compiler_options=dict(
    xla_llvm_disable_expensive_passes=True))
GRADS = ("da", "du", "dW2", "db2")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    """The TPU kernels in Pallas interpret mode, counting their traces."""
    orig = PP.pl.pallas_call
    traced = []

    def patched(*a, **k):
        traced.append(1)
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(PP.pl, "pallas_call", patched)
    return traced


@_jit
def _jax_fwd(a, u, W2, b2, valid):
    """K1 on replica-stacked inputs -> (out, padded cnt)."""
    out, _, cnt = PP._core_fwd(a, u, W2, b2, valid)
    return out, cnt


@_jit
def _jax_vjp(a, u, W2, b2, valid, dpool):
    """pool_core_pallas (K1, its custom VJP K2) -> (out, (da, du, dW2,
    db2))."""
    out, vjp = jax.vjp(lambda *x: PP.pool_core_pallas(*x, valid), a, u, W2,
                       b2)
    return out, vjp(dpool)


def _t(x):
    return torch.from_numpy(np.array(x))


def _data(R=1, S=3, N=40, K=64, B=8, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(R, S, N, K)).astype(np.float32)
    u = rng.normal(size=(R, S, N, K)).astype(np.float32)
    W2 = (rng.normal(size=(R, K, B)) / np.sqrt(K)).astype(np.float32)
    b2 = rng.normal(size=(R, B)).astype(np.float32)
    valid = (rng.uniform(size=(R, S, N)) > 0.3).astype(np.float32)
    valid[:, 0] = 1.0                   # one scene fully valid
    valid[:, 1] = 0.0                   # one with a single valid ped
    valid[:, 1, 0] = 1.0
    return a, u, W2, b2, valid


def _quantized(B, seed):
    """a, u multiples of 1/2 in [-2, 2], W2 in {-1/4, 0, 1/4}, b2 multiples
    of 1/2: exact in bfloat16, every product and sum exact in float32."""
    a, u, W2, b2, valid = _data(B=B, seed=seed)
    rng = np.random.default_rng(seed + 100)
    q = lambda lo, hi, den, x: (rng.integers(lo, hi + 1, size=x.shape)
                                / den).astype(np.float32)
    return (q(-4, 4, 2, a), q(-4, 4, 2, u), q(-1, 1, 4, W2), q(-4, 4, 2, b2),
            valid)


def _case(name):
    if name == "B8":
        return _data(B=8, seed=0)
    if name == "B48":
        return _data(B=48, seed=1)
    if name == "R2":
        return _data(R=2, seed=2)
    if name == "bf16_W2":
        return _data(seed=3)
    if name == "relu_ties":             # negative pre-activations: 0-ties
        a, u, W2, b2, valid = _data(seed=4)
        return a, u, W2, b2 - 3.0, valid
    raise ValueError(name)


def _fwd_default(a, u, W2, b2, valid):
    """JAX's K1 at "default" -> (pooled, cnt) [R, S, N, B]."""
    R, S, N, _ = a.shape
    B = W2.shape[-1]
    with jax.default_matmul_precision("default"):
        out, cnt = _jax_fwd(a, u, W2, b2, valid)
    return np.asarray(out), np.asarray(cnt)[:, :S, :N, :B]


def _dpool(valid, B, seed, cnt=None):
    """A cotangent, zero at invalid rows as the callers' re-mask makes it.
    Given the forward's tie counts ``cnt``, ``cnt`` times a multiple of
    1/8, so that its even share among the ties, dpool / max(cnt, 1), is
    exact in bfloat16 and every sum of the backward exact in float32."""
    rng = np.random.default_rng(seed)
    if cnt is None:
        d = rng.normal(size=valid.shape + (B,))
    else:
        d = rng.integers(-8, 9, size=cnt.shape) / 8 * np.maximum(cnt, 1)
    return (d * valid[..., None]).astype(np.float32)


@pytest.mark.parametrize("name", ["B8", "B48", "R2", "bf16_W2"])
def test_bf16_forward_matches_pallas_default(name):
    a, u, W2, b2, valid = _case(name)
    if name == "bf16_W2":               # the serving weights' type
        W2j, b2j = W2.astype(jnp.bfloat16), b2.astype(jnp.bfloat16)
        tW, tb = (_t(x.astype(np.float32)).bfloat16() for x in (W2j, b2j))
    else:
        W2j, b2j, tW, tb = W2, b2, _t(W2), _t(b2)
    ref, ref_cnt = _fwd_default(a, u, W2j, b2j, valid)
    rows = valid > 0
    ins = (_t(a), _t(u), tW, tb, _t(valid))
    for impl, (pooled, cnt) in {
            "pool_core": pool_core(*ins, bf16=True),
            "wrapper": pool_core_fwd(*ins, bf16=True)}.items():
        np.testing.assert_allclose(
            pooled.numpy()[rows], ref[rows], rtol=0,
            atol=1e-6 * np.abs(ref[rows]).max(), err_msg=impl)
        np.testing.assert_array_equal(cnt.numpy()[rows], ref_cnt[rows],
                                      err_msg=impl)


def _port_grads(a, u, W2, b2, valid, dpool):
    """(pool_core_bwd_plain, PoolCore's autograd) gradients in the bf16
    mode on R = 1 inputs, each as (da, du, dW2, db2) without the R axis."""
    ins = [_t(x) for x in (a, u, W2, b2, valid)]
    pooled, cnt = pool_core(*ins, bf16=True)
    plain = pool_core_bwd_plain(*ins, pooled, cnt, _t(dpool), bf16=True)
    leaves = [x.clone().requires_grad_() for x in ins[:4]]
    out, _ = PoolCore.apply(*leaves, ins[4], True)
    auto = torch.autograd.grad(out, leaves, _t(dpool))
    return {"pool_core_bwd_plain": [g[0].numpy() for g in plain],
            "PoolCore": [g[0].numpy() for g in auto]}


@pytest.mark.parametrize("name", ["B8", "B48", "relu_ties"])
def test_bf16_backward_matches_pallas_vjp(name):
    a, u, W2, b2, valid = _case(name)
    dpool = _dpool(valid, W2.shape[-1], seed=7)
    with jax.default_matmul_precision("default"):
        _, ref = _jax_vjp(a[0], u[0], W2[0], b2[0], valid[0], dpool[0])
    for impl, got in _port_grads(a, u, W2, b2, valid, dpool).items():
        for key, x, r in zip(GRADS, got, ref):
            r = np.asarray(r)
            np.testing.assert_allclose(x, r, rtol=0,
                                       atol=1e-5 * np.abs(r).max(),
                                       err_msg=f"{impl} {key}")


@pytest.mark.parametrize("B", [8, 48])
def test_bf16_quantized_inputs_bit_equal(B):
    """Inputs exact in bfloat16 whose products and partial sums float32
    adds exactly, and a cotangent whose shares among ties are too: the
    forward and every gradient equal JAX's bit for bit, ties included."""
    a, u, W2, b2, valid = _quantized(B, seed=B)
    ref, ref_cnt = _fwd_default(a, u, W2, b2, valid)
    pooled, cnt = pool_core(*(_t(x) for x in (a, u, W2, b2, valid)),
                            bf16=True)
    rows = valid > 0
    np.testing.assert_array_equal(pooled.numpy()[rows], ref[rows])
    np.testing.assert_array_equal(cnt.numpy()[rows], ref_cnt[rows])
    assert (ref_cnt[rows] > 1).any()
    dpool = _dpool(valid, B, seed=B, cnt=ref_cnt)
    with jax.default_matmul_precision("default"):
        _, ref = _jax_vjp(a[0], u[0], W2[0], b2[0], valid[0], dpool[0])
    for impl, got in _port_grads(a, u, W2, b2, valid, dpool).items():
        for key, x, r in zip(GRADS, got, ref):
            np.testing.assert_array_equal(x, np.asarray(r),
                                          err_msg=f"{impl} {key}")


def test_bf16_mode_takes_effect():
    """On random inputs the bf16 mode moves pooled on both sides: the port's
    bf16 core differs from its exact one, JAX's "default" result from its
    "highest" one (the jitted kernel retraced under the new precision)."""
    a, u, W2, b2, valid = _case("B8")
    rows = valid > 0
    ins = [_t(x) for x in (a, u, W2, b2, valid)]
    port = [pool_core(*ins, bf16=bf)[0].numpy()[rows] for bf in (False, True)]
    assert np.abs(port[0] - port[1]).max() > 1e-4
    default, _ = _fwd_default(a, u, W2, b2, valid)
    with jax.default_matmul_precision("highest"):
        highest = np.asarray(_jax_fwd(a, u, W2, b2, valid)[0])
    assert np.abs(default[rows] - highest[rows]).max() > 1e-4
    np.testing.assert_allclose(port[0], highest[rows], rtol=0, atol=1e-5)


def test_precision_setting(monkeypatch):
    """The setting's truth table is ``_use_bf16``'s for every name that
    function knows; the env var sets the initial value ("highest" without
    it); the context manager restores the old value, also after an error;
    an unknown name raises and changes nothing."""
    names = [None, "default", "high", "highest", "bfloat16", "tensorfloat32",
             "float32", "fastest", "bfloat16_3x"]
    for name in names:
        with monkeypatch.context() as m:
            m.setattr(PP, "jax", types.SimpleNamespace(config=types.
                      SimpleNamespace(jax_default_matmul_precision=name)))
            want = PP._use_bf16()
        with PREC.default_matmul_precision(name):
            assert PREC.use_bf16() == want, name
    assert sorted(map(str, names)) == sorted(
        map(str, PREC.BF16_NAMES + PREC.EXACT_NAMES))

    assert PREC.get_default_matmul_precision() == "highest"
    try:
        monkeypatch.setenv(PREC.ENV, "default")
        importlib.reload(PREC)
        assert PREC.get_default_matmul_precision() == "default"
        assert PREC.use_bf16()
        monkeypatch.setenv(PREC.ENV, "bf16")
        with pytest.raises(ValueError):
            importlib.reload(PREC)
    finally:
        monkeypatch.delenv(PREC.ENV)
        importlib.reload(PREC)
    assert PREC.get_default_matmul_precision() == "highest"

    with PREC.default_matmul_precision("tensorfloat32"):
        assert PREC.use_bf16()
        with pytest.raises(RuntimeError):
            with PREC.default_matmul_precision("float32"):
                assert not PREC.use_bf16()
                raise RuntimeError
        assert PREC.get_default_matmul_precision() == "tensorfloat32"
    assert not PREC.use_bf16()
    with pytest.raises(ValueError):
        PREC.set_default_matmul_precision("BF16_BF16_F32")
    assert PREC.get_default_matmul_precision() == "highest"


def test_zoo_checkpoint_bf16_matches_jax_default(interpret_mode):
    """zara1_12 (the ``gat`` preset at full width): the context and k=20
    positions (JAX's draws injected) of the port in the bf16 mode, its pool
    on the kernel route's CPU version, against grouptraj at "default" with
    its pool in the interpreted K1."""
    ckpt = jax_load(CKPT)
    state = ckpt["g_best_state"]
    jcfg = dataclasses.replace(jax_config(ckpt["args"], state),
                               pool_impl="pallas")
    b = synthetic_batch(3, 40, jcfg.obs_len, jcfg.pred_len, seed=9)
    obs, rel, grp, valid = b["obs"], b["obs_rel"], b["group"], b["valid"]
    keys = jax.random.split(jax.random.PRNGKey(1), 20)

    @_jit
    def reference(params, keys):
        ctx = jax_context(params, jcfg, obs, rel, grp, valid, keys[0],
                          train=False)
        return ctx, jax_sample(params, jcfg, ctx, obs, rel, grp, valid, keys,
                               train=False)

    with jax.default_matmul_precision("default"):
        ctx_ref, pred_ref = reference(import_generator(state), keys)
    assert interpret_mode
    noises = jax_sample_noises(jcfg, keys, 3, 40, jnp.float32)
    cfg = dataclasses.replace(config_from_checkpoint_args(ckpt["args"], state),
                              pool_impl="kernel")
    model = TrajectoryGenerator(cfg).eval()
    model.load_state_dict(generator_state(state))
    with torch.no_grad(), PREC.default_matmul_precision("default"):
        ctx = model.generator_context(_t(obs), _t(rel), _t(grp), _t(valid))
        pred = model.generator_sample_many(ctx, _t(rel), _t(valid), 20,
                                           user_noises=_t(noises))
    np.testing.assert_allclose(ctx.numpy(), np.asarray(ctx_ref), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(np.cumsum(pred.numpy(), axis=-2),
                               np.cumsum(np.asarray(pred_ref), axis=-2),
                               rtol=0, atol=1e-4)


def _assert_grads(module, grads, ref, what):
    """Each gradient tensor within 1e-5 of the network's largest entry:
    the pool's dW2 sums the exact bfloat16 products of every tie entry in
    another order on either side, 1.2e-6 of the discriminator's largest
    gradient apart at the default precision (1.3e-7 at "highest").
    -> that bound."""
    names = [n for n, _ in module.named_parameters()]
    assert set(names) == set(ref), what
    bound = 1e-5 * max(np.abs(r).max() for r in ref.values())
    for n, g in zip(names, grads):
        err = np.abs(g.numpy() - ref[n]).max()
        assert err <= bound, (what, n, err / bound * 1e-5)
    return bound


def _draws(jcfg):
    """test_torch_presets.py's ``_draws``, its JAX side jitted once (run
    eagerly its small ops compile one by one, seconds in all)."""
    @_jit
    def jax_draws():
        key_d, key_g = jax.random.PRNGKey(100), jax.random.PRNGKey(200)
        k_gen, k_label_d, _ = jax.random.split(key_d, 3)
        k_label_g, k_samples, _ = jax.random.split(key_g, 3)
        sample_keys = jax.random.split(k_samples, P.TRAIN["best_k"])
        uniform = functools.partial(jax.random.uniform, shape=(),
                                    minval=0.7, maxval=1.2)
        return (key_d, key_g,
                jax_sample_noises(jcfg, k_gen[None], P.S, P.N,
                                  np.float32)[0], uniform(k_label_d),
                jax_sample_noises(jcfg, sample_keys, P.S, P.N, np.float32),
                uniform(k_label_g))

    key_d, key_g, noise, label_d, noises, label_g = jax_draws()
    return (key_d, key_g, dict(noise=_t(noise), label=float(label_d)),
            dict(noises=_t(noises), label=float(label_g)))


def test_training_step_bf16_matches_jax_default(monkeypatch, interpret_mode):
    """One d-step + g-step of the ``gat`` preset at narrow widths, K1/K2 in
    the bf16 mode on both sides (JAX's interpreted at "default", the
    port's plain versions through PoolCore), from one init and one set of
    draws: losses, gradients and the parameters after the steps (1e-6
    plus what the gradients' bound can move Adam's first step,
    test_torch_presets.py's rule). Four scenes of 64 pedestrians: the
    interpreted kernels unroll fewer scenes a block than at
    test_torch_presets.py's N = 6, and compile twice as fast."""
    monkeypatch.setattr(P, "N", 64)     # the batch and the draws' noise
    monkeypatch.setattr(P, "_jit", _jit)
    monkeypatch.setattr(P, "_draws", _draws)
    jcfg = JaxModelConfig(**NARROW, pool_impl="pallas")
    cfg = ModelConfig(**NARROW, pool_impl="kernel")
    state = _jit(jax_init_train_state, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jcfg, P.JTCFG)
    # lift the classifier's last bias, as test_torch_presets.py does
    state.d_params["real_classifier"]["layers"][-1]["linear"]["b"] += 1.0
    init = (P._np_state(state.g_params, "generator"),
            P._np_state(state.d_params, "discriminator"))
    batch = synthetic_batch(P.S, P.N, jcfg.obs_len, jcfg.pred_len, seed=5)
    with jax.default_matmul_precision("default"):
        ref, (d_grads, g_grads), (d_ref, g_ref) = P._jax_iteration(
            jcfg, state, batch, monkeypatch)
    assert interpret_mode
    b = {k: _t(v) for k, v in batch.items()}
    g, d = P._modules(cfg, *init)
    port = TS.train_state_from_modules(g, d, P.TCFG)
    _, _, d_draw, g_draw = _draws(jcfg)
    with PREC.default_matmul_precision("default"):
        d_bound = _assert_grads(d, TS.d_gradients(
            port, b, cfg, P.TCFG, **d_draw)[1], d_grads, "D")
        losses = TS.d_step(port, b, cfg, P.TCFG, **d_draw)
        g_bound = _assert_grads(g, TS.g_gradients(
            port, b, cfg, P.TCFG, **g_draw)[1], g_grads, "G")
        losses.update(TS.g_step(port, b, cfg, P.TCFG, **g_draw))
    assert set(losses) == set(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(float(losses[k]), r, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    P._assert_params(port.d, d_ref, d_grads, d_bound,
                     P.TCFG.d_learning_rate, "D")
    P._assert_params(port.g, g_ref, g_grads, g_bound,
                     P.TCFG.g_learning_rate, "G")


def test_vmap_carries_the_mode():
    """PoolCore under torch.func.vmap over R = 2 replicas in the bf16 mode
    equals two single bf16 calls (forward and all four gradients) and not
    the exact mode."""
    g = torch.Generator().manual_seed(0)
    n, S_, N, K, B = 2, 2, 5, 16, 4
    a, u = (torch.randn(n, S_, N, K, generator=g).requires_grad_()
            for _ in range(2))
    W2 = torch.randn(n, K, B, generator=g).requires_grad_()
    b2 = torch.randn(B, generator=g).requires_grad_()
    valid = (torch.rand(S_, N, generator=g) > 0.3).float()
    valid[:, 0] = 1.0
    vi = valid > 0

    def one(a, u, W2, bf16=True):
        p, c = PoolCore.apply(a[None], u[None], W2[None], b2[None],
                              valid[None], bf16)
        return p[0], c[0]

    pooled, cnt = torch.func.vmap(one)(a, u, W2)
    dp = torch.randn(pooled.shape, generator=g)
    grads = torch.autograd.grad((pooled * dp).sum(), [a, u, W2, b2])
    db2 = torch.zeros(B)
    for i in range(n):
        x = [t[i].detach().requires_grad_() for t in (a, u, W2)]
        p, c = one(*x)
        assert torch.equal(p[vi], pooled[i][vi])
        assert torch.equal(c[vi], cnt[i][vi])
        assert not torch.equal(one(*x, bf16=False)[0][vi], pooled[i][vi])
        ref = torch.autograd.grad((p * dp[i]).sum(), [*x, b2])
        for r, got in zip(ref[:3], grads[:3]):
            assert torch.allclose(r, got[i], rtol=0, atol=1e-6)
        db2 += ref[3]
    assert torch.allclose(db2, grads[3], rtol=0, atol=1e-6)
