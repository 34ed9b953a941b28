"""The port's LSTM recurrences with hand-written backwards against the JAX
package on the CPU: each ``torch.autograd.Function`` of
``grouptraj_torch.ops.lstm`` against ``jax.grad`` of its counterpart in
``grouptraj.ops.lstm`` and against PyTorch's autograd of the same plain
loop, and that nothing is saved for a backward under ``torch.no_grad``.

Tolerance 1e-5 relative to the largest reference entry: float32 on both
sides, a few hundred accumulated products per entry in another order.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grouptraj_torch.ops import lstm as TL

JL = importlib.import_module("grouptraj.ops.lstm")
H, B, T = 8, 7, 5


def _t(x):
    return torch.from_numpy(np.array(x))


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [(0.5 * rng.normal(size=s)).astype(np.float32) for s in shapes]


CASES = {
    # name: (argument shapes, jax function, port function, plain loop)
    "encoder_recurrence": (
        [(2, 4 * H), (4 * H,), (H, 4 * H), (T, B, 2)],
        lambda *a: JL.encoder_recurrence(*a),
        lambda *a: TL.encoder_recurrence(*a),
        lambda *a: TL._encoder_loop(*a, None)),
    "decoder_first_step": (
        [(2, 4 * H), (4 * H,), (H, 4 * H), (H, 2), (2,), (B, 2), (B, H)],
        lambda *a: JL.decoder_first_step(*a),
        lambda *a: TL.decoder_first_step(*a),
        lambda *a: TL._first_step(*a)),
    "decoder_proj_recurrence": (
        [(H, 4 * H), (4 * H,), (H, 2), (2,), (B, H), (B, H)],
        lambda *a: JL.decoder_proj_recurrence(*a, T),
        lambda *a: TL.decoder_proj_recurrence(*a, T),
        lambda *a: TL._proj_loop(*a, T, None)),
}


def _weights(outs, seed=99):
    """Fixed cotangents: one random array per output."""
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    rng = np.random.default_rng(seed)
    return [rng.normal(size=tuple(o.shape)).astype(np.float32) for o in outs]


def _torch_grads(fn, arrays):
    leaves = [_t(a).requires_grad_() for a in arrays]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * _t(w)).sum() for o, w in zip(outs, _weights(outs)))
    return [o.detach().numpy() for o in outs], torch.autograd.grad(loss,
                                                                   leaves)


@pytest.mark.parametrize("name", list(CASES))
def test_function_matches_jax_grad_and_autograd(name):
    shapes, jax_fn, port_fn, plain_fn = CASES[name]
    arrays = _arrays(shapes, seed=len(name))

    def jax_loss(*a):
        outs = jax_fn(*a)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.sum(o * w) for o, w in zip(outs, _weights(outs)))

    ref = jax.grad(jax_loss, argnums=tuple(range(len(arrays))))(*arrays)
    outs, got = _torch_grads(port_fn, arrays)
    plain_outs, plain = _torch_grads(plain_fn, arrays)
    jax_outs = jax_fn(*arrays)
    jax_outs = jax_outs if isinstance(jax_outs, tuple) else (jax_outs,)
    for o, p, j in zip(outs, plain_outs, jax_outs):
        np.testing.assert_array_equal(o, p)           # same loop, same values
        np.testing.assert_allclose(o, np.asarray(j), atol=1e-6, rtol=1e-5)
    for i, (g, p, r) in enumerate(zip(got, plain, ref)):
        r = np.asarray(r)
        atol = 1e-5 * max(1.0, np.abs(r).max())
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=atol,
                                   err_msg=f"{name} arg {i} vs jax.grad")
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=0, atol=atol,
                                   err_msg=f"{name} arg {i} vs autograd")


@pytest.mark.parametrize("name", list(CASES))
def test_nothing_saved_without_grad(name):
    shapes, _, port_fn, _ = CASES[name]
    arrays = _arrays(shapes, seed=1)
    saved = []

    def pack(t):
        saved.append(t)
        return t

    leaves = [_t(a).requires_grad_() for a in arrays]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        with torch.no_grad():
            outs = port_fn(*leaves)
        assert not saved
        outs = outs if isinstance(outs, tuple) else (outs,)
        assert not any(o.requires_grad for o in outs)
        port_fn(*[_t(a) for a in arrays])             # no leaf wants a grad
        assert not saved
        port_fn(*leaves)                              # with grad: states kept
        assert saved


def test_bfloat16_decode_runs_in_bfloat16():
    shapes = CASES["decoder_proj_recurrence"][0]
    args = [_t(a).bfloat16() for a in _arrays(shapes, seed=2)]
    with torch.no_grad():
        ys = TL.decoder_proj_recurrence(*args, T)
    assert ys.dtype == torch.bfloat16 and ys.shape == (T, B, 2)
    ref = TL.decoder_proj_recurrence(*[a.float() for a in args], T)
    assert (ys.float() - ref).abs().max() < 0.1
