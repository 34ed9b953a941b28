"""The port's dense ops (grouptraj_torch.ops, models.modules) against the JAX
package on the same numpy inputs, float32 on the CPU.

Tolerance: atol 1e-5 on O(1) values. Both sides compute in float32 (the
JAX side at "highest" matmul precision, tests/conftest.py) and differ only
in summation order, a few ulp per op.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grouptraj.models.modules import gat_encoder as jax_gat_encoder
from grouptraj.models.modules import init_gat_encoder
from grouptraj.utils import relative_to_abs as jax_relative_to_abs
from grouptraj_torch.models.modules import gat_encoder
from grouptraj_torch.ops import gat, groups, linear, lstm
from grouptraj_torch.utils import relative_to_abs

# grouptraj.ops re-exports functions under its submodules' names
jgat, jgroups, jlinear, jlstm = (
    importlib.import_module(f"grouptraj.ops.{m}")
    for m in ("gat", "groups", "linear", "lstm"))

ATOL = 1e-5


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


def _tree(tree):
    return jax.tree_util.tree_map(_t, tree)


def _close(port, ref, atol=ATOL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_allclose(port, np.asarray(ref), atol=atol, rtol=0)


def _scene_labels():
    """Two groups (labels 3 and 5, the 5s non-adjacent), label-0 peds and
    padding; the second scene has one group whose first member is a
    label-0-adjacent ped, the third is all padding."""
    labels = np.array([[0, 3, 3, 5, 0, 5, 5, 0],
                       [2, 0, 2, 2, 0, 0, 0, 0],
                       [0, 0, 0, 0, 0, 0, 0, 0]], np.float32)
    valid = np.array([[1, 1, 1, 1, 1, 1, 1, 0],
                      [1, 1, 1, 1, 1, 0, 0, 0],
                      [0, 0, 0, 0, 0, 0, 0, 0]], np.float32)
    return labels, valid


def test_linear_and_mlp_match():
    rng = np.random.default_rng(0)
    p = jlinear.init_mlp(jax.random.PRNGKey(0), [12, 20, 7])
    x = rng.normal(size=(3, 5, 12)).astype(np.float32)
    _close(linear.linear(_tree(p["layers"][0]["linear"]), _t(x)),
           jlinear.linear(p["layers"][0]["linear"], x))
    _close(linear.mlp_forward(_tree(p), _t(x)), jlinear.mlp_forward(p, x))
    with pytest.raises(NotImplementedError):
        linear.mlp_forward(_tree(p), _t(x), activation="leakyrelu")


def test_groups_match():
    labels, valid = _scene_labels()
    lt, vt = _t(labels), _t(valid)
    np.testing.assert_array_equal(
        groups.intra_group_adjacency(lt, vt).numpy(),
        np.asarray(jgroups.intra_group_adjacency(labels, valid)))
    r, gv = groups.group_membership(lt, vt)
    jr, jgv = jgroups.group_membership(labels, valid)
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(jgv))
    # the first valid member names the group: ped 1 for label 3, ped 3 for 5
    assert r[0, 1].nonzero().flatten().tolist() == [1, 2]
    assert r[0, 3].nonzero().flatten().tolist() == [3, 5, 6]
    np.testing.assert_array_equal(
        groups.inter_group_adjacency(gv).numpy(),
        np.asarray(jgroups.inter_group_adjacency(jgv)))
    _close(groups.normalize_adjacency(r), jgroups.normalize_adjacency(jr))


@pytest.mark.parametrize("nheads", [1, 2])
def test_gat_matches(nheads):
    rng = np.random.default_rng(1)
    labels, valid = _scene_labels()
    mask = jgroups.intra_group_adjacency(labels, valid)
    p = jgat.init_gat(jax.random.PRNGKey(1), 10, 12, 6, nheads)
    x = rng.normal(size=(3, 8, 10)).astype(np.float32)
    m = _t(np.asarray(mask))
    _close(gat.gat_layer(_tree(p["attentions"][0]), _t(x), m, 0.2),
           jgat.gat_layer(p["attentions"][0], x, mask, 0.2))
    _close(gat.gat(_tree(p), _t(x), m, 0.2), jgat.gat(p, x, mask, 0.2))


def test_gat_encoder_matches():
    rng = np.random.default_rng(2)
    labels, valid = _scene_labels()
    p = init_gat_encoder(jax.random.PRNGKey(2), 40, 72, 16, 24)
    x = rng.normal(size=(3, 8, 40)).astype(np.float32)
    ref = jax_gat_encoder(p, x, labels, valid, 0.2, train=False)
    out = gat_encoder(_tree(p), _t(x), _t(labels), _t(valid), 0.2)
    _close(out, ref)
    assert (out[valid == 0] == 0).all()


def _lstm_weights(rng, d_in, H):
    s = 1.0 / np.sqrt(H)
    f = lambda *shape: rng.uniform(-s, s, shape).astype(np.float32)
    return f(d_in, 4 * H), f(H, 4 * H), f(4 * H)


def test_lstm_gates_match():
    rng = np.random.default_rng(3)
    z = rng.normal(size=(6, 4 * 5)).astype(np.float32)
    c = rng.normal(size=(6, 5)).astype(np.float32)
    for port, ref in zip(lstm.lstm_gates(_t(z), _t(c), 5),
                         jlstm.lstm_gates(z, c, 5)):
        _close(port, ref)


def test_encoder_recurrence_matches():
    rng = np.random.default_rng(4)
    w_comp, w_hh, b = _lstm_weights(rng, 2, 32)
    xs = rng.normal(scale=0.3, size=(8, 10, 2)).astype(np.float32)
    ref = jlstm.encoder_recurrence(w_comp, b, w_hh, xs)
    out = lstm.encoder_recurrence(_t(w_comp), _t(b), _t(w_hh), _t(xs))
    for port, r in zip(out, ref):
        _close(port, r)


def test_decoder_steps_match():
    rng = np.random.default_rng(5)
    H = 32
    w_r, w_hh, b = _lstm_weights(rng, 2, H)
    w_p = rng.normal(scale=0.2, size=(H, 2)).astype(np.float32)
    b_p = rng.normal(scale=0.1, size=(2,)).astype(np.float32)
    x0 = rng.normal(scale=0.3, size=(10, 2)).astype(np.float32)
    h0 = rng.normal(size=(10, H)).astype(np.float32)
    ref = jlstm.decoder_first_step(w_r, b, w_hh, w_p, b_p, x0, h0)
    out = lstm.decoder_first_step(*map(_t, (w_r, b, w_hh, w_p, b_p, x0, h0)))
    for port, r in zip(out, ref):
        _close(port, r)
    w_eff = w_hh + w_p @ w_r
    ref_ys = jlstm.decoder_proj_recurrence(w_eff, b, w_p, b_p, ref[0],
                                           ref[1], 11)
    ys = lstm.decoder_proj_recurrence(*map(_t, (w_eff, b, w_p, b_p,
                                                ref[0], ref[1])), 11)
    assert ys.shape == (11, 10, 2)
    _close(ys, ref_ys)


def test_relative_to_abs_matches():
    rng = np.random.default_rng(6)
    rel = rng.normal(size=(3, 4, 12, 2)).astype(np.float32)
    start = rng.normal(size=(3, 4, 2)).astype(np.float32)
    _close(relative_to_abs(_t(rel), _t(start)),
           jax_relative_to_abs(jnp.asarray(rel), jnp.asarray(start)))
