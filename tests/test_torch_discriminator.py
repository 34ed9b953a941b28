"""The port's TrajectoryDiscriminator against
``grouptraj.models.discriminator.discriminator_forward`` on the CPU at a
narrow width: scores, input gradients and parameter gradients from the same
weights (bridged with ``params_from_jax``) and the same numpy inputs.

Tolerances: scores 1e-5, gradients 1e-4 relative to the largest reference
entry (float32 both sides; the 512-wide pool hidden layer and 20 LSTM steps
sum in another order).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grouptraj.compat.torch_import import export_state_dicts
from grouptraj.config import ModelConfig as JaxConfig
from grouptraj.models import discriminator_forward, init_discriminator
from grouptraj_torch.compat import (
    discriminator_state, params_from_jax, params_to_jax,
)
from grouptraj_torch.config import ModelConfig
from grouptraj_torch.models.discriminator import TrajectoryDiscriminator
from grouptraj_torch.train.steps import init_parameters

NARROW = dict(embedding_dim=8, encoder_h_dim_d=12, mlp_dim=16, obs_len=4,
              pred_len=5)
S, N = 3, 7


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


def _setup(pool_impl="auto"):
    jcfg = JaxConfig(**NARROW)
    cfg = ModelConfig(**NARROW, pool_impl=pool_impl)
    params = init_discriminator(jax.random.PRNGKey(1), jcfg)
    # lift the classifier's last bias so the trailing ReLU lets scores (and
    # their gradients) through on most rows
    params["real_classifier"]["layers"][-1]["linear"]["b"] += 1.0
    model = TrajectoryDiscriminator(cfg)
    model.load_state_dict(discriminator_state(
        params_from_jax(jax.device_get(params), "discriminator")))
    rng = np.random.default_rng(2)
    T = cfg.obs_len + cfg.pred_len
    rel = rng.normal(scale=0.3, size=(S, N, T, 2)).astype(np.float32)
    traj = np.cumsum(rel, axis=2) + rng.normal(size=(S, N, 1, 2)).astype(
        np.float32)
    valid = (rng.uniform(size=(S, N)) > 0.3).astype(np.float32)
    valid[0] = 1.0
    return jcfg, params, model, traj, rel, valid


def test_bridge_matches_export_state_dicts():
    _, params, model, *_ = _setup()
    params = jax.device_get(params)
    ref = export_state_dicts(params, "discriminator")
    out = params_from_jax(params, "discriminator")
    assert list(out) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: v.shape for k, v in out.items()}


@pytest.mark.parametrize("pool_impl", ["pair", "fast", "kernel"])
def test_scores_and_gradients_match(pool_impl):
    jcfg, params, model, traj, rel, valid = _setup(pool_impl)
    w = np.cos(np.arange(S * N, dtype=np.float32)).reshape(S, N) * valid

    def loss(p, traj, rel):
        return jnp.sum(discriminator_forward(p, jcfg, traj, rel, valid) * w)

    ref_scores = np.asarray(discriminator_forward(params, jcfg, traj, rel,
                                                  valid))
    gp, gtraj, grel = jax.grad(loss, argnums=(0, 1, 2))(params, traj, rel)

    ttraj, trel = _t(traj).requires_grad_(), _t(rel).requires_grad_()
    scores = model(ttraj, trel, _t(valid))
    assert (scores >= 0).all()                        # the trailing ReLU
    assert (scores[_t(valid) > 0] > 0).any()
    np.testing.assert_allclose(scores.detach().numpy(), ref_scores,
                               atol=1e-5, rtol=1e-5)
    (scores * _t(w)).sum().backward()

    def close(got, ref, name):
        ref = np.asarray(ref)
        np.testing.assert_allclose(
            got, ref, rtol=0, atol=1e-4 * max(1.0, np.abs(ref).max()),
            err_msg=name)

    close(ttraj.grad.numpy(), gtraj, "traj")
    close(trel.grad.numpy(), grel, "traj_rel")
    ref_grads = params_from_jax(jax.device_get(gp), "discriminator")
    got = dict(model.named_parameters())
    assert set(got) == set(ref_grads)
    for k, r in ref_grads.items():
        close(got[k].grad.numpy(), r, k)


def test_unported_variants_raise():
    """The variants once refused now match grouptraj: batch_norm (its
    statistics over the valid rows, in evaluation too) and, in training
    mode, dropout with JAX's keep-masks injected in its order of draws (the
    pool's two layers, then the classifier's)."""
    from grouptraj_torch.ops.linear import InjectedMasks

    rng = np.random.default_rng(2)
    T = NARROW["obs_len"] + NARROW["pred_len"]
    rel = rng.normal(scale=0.3, size=(S, N, T, 2)).astype(np.float32)
    traj = np.cumsum(rel, axis=2)
    valid = (rng.uniform(size=(S, N)) > 0.3).astype(np.float32)
    valid[0] = 1.0
    for opts in (dict(batch_norm=True), dict(dropout=0.5)):
        jcfg, cfg = JaxConfig(**NARROW, **opts), ModelConfig(**NARROW, **opts)
        # the JAX package's initialisation drawn by the port (its eager
        # JAX initialiser compiles one program per leaf), carried over
        model = TrajectoryDiscriminator(cfg)
        init_parameters(model, torch.Generator().manual_seed(1))
        params = params_to_jax(model.state_dict(), "discriminator")
        params["real_classifier"]["layers"][-1]["linear"]["b"] += 1.0
        model.load_state_dict(discriminator_state(
            params_from_jax(params, "discriminator")))
        orig = jax.random.bernoulli

        @functools.partial(jax.jit, compiler_options=dict(
            xla_backend_optimization_level=0,
            xla_llvm_disable_expensive_passes=True))
        def forward(p):
            """D's training-mode scores and, as outputs, every keep-mask
            it draws (``jax.random.bernoulli`` recorded while tracing)."""
            masks = []
            with pytest.MonkeyPatch.context() as m:
                m.setattr(jax.random, "bernoulli",
                          lambda *a: masks.append(orig(*a)) or masks[-1])
                return discriminator_forward(p, jcfg, traj, rel, valid,
                                             jax.random.PRNGKey(4)), masks

        ref, masks = jax.tree_util.tree_map(np.asarray, forward(params))
        assert len(masks) == (4 if cfg.dropout else 0)
        with torch.no_grad():
            got = model(_t(traj), _t(rel), _t(valid),
                        masks=InjectedMasks(masks))
            np.testing.assert_allclose(got.numpy(), ref, atol=1e-5,
                                       rtol=1e-5, err_msg=str(opts))
            model.eval()
            ref = np.asarray(discriminator_forward(params, jcfg, traj, rel,
                                                   valid, train=False))
            np.testing.assert_allclose(model(_t(traj), _t(rel), _t(valid)),
                                       ref, atol=1e-5, rtol=1e-5,
                                       err_msg=str(opts))
