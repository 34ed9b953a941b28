"""The port's multi-seed sweeps (``grouptraj_torch/train/multi.py``) against
``grouptraj/train/multi.py`` on the CPU, on the toy split of
``tests/test_multi.py`` (4 pedestrians walking in two groups, 21 train and
6 val windows) at narrow widths, one scene-size bucket.

grouptraj's ``train_many`` trains seeds 5 and 6 (discriminators alive) for
6 iterations (dispatches of 2, print every iteration, checkpoint every 2,
EMA on); the port's ``train_many`` trains them from the same initial
weights (grouptraj's per-seed init, handed in for the port's) on the draws
JAX takes: each replica's key chain of ``grouptraj.train.multi``, which is
``train()``'s except that a checkpoint event splits the key twice,
injected through ``train_many(draws=...)``.

Tolerances (float32 on both sides), those of ``tests/test_torch_loop.py``
and for its reasons: losses, metrics and grad norms 1e-5 relative to each
history's largest entry; counters and timestamps equal; weights and EMA
1e-4 absolute after six iterations; Adam moments 1e-5 of their optimizer's
largest moment, not 1e-6 as there: that file resumes four iterations from
a checkpoint, this one trains six from a fresh init, and over those six
D's moments drift by up to 5.5e-6 of the largest between the packages'
``train()`` as well, on the same weights and draws. Within the port
(1-seed sweep against ``train()``, a resumed sweep against an
uninterrupted one): histories 1e-6 relative, weights 1e-6 absolute, except
where a gradient is rounding noise (the inter-group GAT's attention
vectors, ROADMAP §3 "Optimizer": the inter-group graph is complete, so the
row softmax drops the source half of each vector and its gradient is zero
but for rounding): a vmapped matmul rounds differently from a plain one
and each Adam step moves such a weight by up to about lr in either run,
so those two vectors are held to 2 lr an iteration (1.35 lr measured
after four iterations).
"""

import dataclasses
import logging
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from grouptraj.config import ModelConfig as JaxModelConfig
from grouptraj.config import TrainConfig as JaxTrainConfig
from grouptraj.models.generator import sample_noises as jax_sample_noises
from grouptraj.train import multi as JMULTI
from grouptraj.train.checkpoint import load_checkpoint as jax_load
from grouptraj.train.checkpoint import (
    state_from_checkpoint as jax_state_from_checkpoint,
)
from grouptraj.train.steps import init_train_state as jax_init_train_state
from grouptraj_torch.compat import (
    discriminator_state, generator_state, params_from_jax,
)
from grouptraj_torch.config import ModelConfig, TrainConfig
from grouptraj_torch.ops.cuda_pool import PoolCore
from grouptraj_torch.train import checkpoint as CK
from grouptraj_torch.train import loop as LOOP
from grouptraj_torch.train import multi as MULTI
from grouptraj_torch.train import steps as TS
from grouptraj_torch.train.device_data import (
    gather_batch, synthetic_device_data,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(embedding_dim=8, encoder_h_dim_g=16, decoder_h_dim_g=16,
              noise_dim=(4,), bottleneck_dim=4, hidden_units=12,
              graph_out_dim=8, encoder_h_dim_d=12, mlp_dim=16)
SEEDS, S = [5, 6], 4
TRAIN = dict(dataset_name="toy", batch_size=S, num_epochs=0,
             num_iterations=6, checkpoint_every=2, print_every=1, best_k=3,
             checkpoint_name="ck", num_samples_check=30,
             steps_per_dispatch=2, n_buckets=1, bf16_nograd=False,
             g_ema_decay=0.5, seed=SEEDS[0])
JCFG, CFG = JaxModelConfig(**NARROW), ModelConfig(**NARROW)
RTOL = 1e-5
# the inter-group GAT's attention vectors: gradients at the rounding level
NOISY = ("gatencoder.gat_inter.attention_0.a",
         "gatencoder.gat_inter.out_att.a")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: one thread a process keeps the workers of a
    parallel test run from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """tests/test_multi.py's toy split under ``root/toy``."""
    root = tmp_path_factory.mktemp("datasets")
    rng = np.random.default_rng(0)
    for split, nframes in (("train", 40), ("val", 25)):
        d = root / "toy" / split
        d.mkdir(parents=True)
        rows = []
        for t in range(nframes):
            for p in (1, 2, 3, 4):
                x = 0.1 * t + p + 0.01 * rng.standard_normal()
                y = 0.05 * t - p
                rows.append(f"{t*10.0}\t{p}.0\t{x:.4f}\t{y:.4f}\t{p % 2}.0")
        (d / "toy.txt").write_text("\n".join(rows) + "\n")
    mp = pytest.MonkeyPatch()
    mp.setenv("GROUPTRAJ_DATA_DIR", str(root))
    yield str(root)
    mp.undo()


def _t(x):
    return torch.from_numpy(np.array(x))


def _uniform(key):
    return float(jax.random.uniform(key, (), minval=0.7, maxval=1.2))


def _noise(keys, N):
    return _t(jax_sample_noises(JCFG, keys, S, N, np.float32))


class JaxSweepDraws(LOOP.Draws):
    """One replica's draws in ``grouptraj.train.multi.train_many``: its
    chain starts from the key left after the init split; a dispatch and a
    sweep batch draw as in ``train()`` (tests/test_torch_loop.py); an
    event splits the chain twice."""

    def __init__(self, seed, N, best_k, n_val, n_train):
        self.key = jax.random.split(jax.random.PRNGKey(seed))[0]
        self.N, self.best_k, self.n = N, best_k, (n_val, n_train)

    def iterations(self, n):
        self.key, sub = jax.random.split(self.key)
        out = []
        for k in jax.random.split(sub, n):
            k, kd = jax.random.split(k)
            k, kg = jax.random.split(k)
            k_gen, k_label, _ = jax.random.split(kd, 3)
            d = dict(noise=_noise(k_gen[None], self.N)[0],
                     label=_uniform(k_label))
            k_label, k_samples, _ = jax.random.split(kg, 3)
            g = dict(noises=_noise(jax.random.split(k_samples, self.best_k),
                                   self.N), label=_uniform(k_label))
            out.append({"d": [d], "g": [g]})
        return out

    def sweeps(self):
        self.key, k1 = jax.random.split(self.key)
        self.key, k2 = jax.random.split(self.key)
        return self._sweep(k1, self.n[0]), self._sweep(k2, self.n[1])

    def _sweep(self, key, n_batches):
        keys = jax.random.split(key, n_batches)

        def draw(i, S_, N_):
            k_gen, k_label = jax.random.split(keys[i])
            return (_t(jax_sample_noises(JCFG, k_gen[None], S_, N_,
                                         np.float32))[0], _uniform(k_label))
        return draw


def _port_state(jstate, tcfg):
    g, d = TS.TrajectoryGenerator(CFG), TS.TrajectoryDiscriminator(CFG)
    g.load_state_dict(generator_state(params_from_jax(
        jax.device_get(jstate.g_params), "generator")))
    d.load_state_dict(discriminator_state(params_from_jax(
        jax.device_get(jstate.d_params), "discriminator")))
    return TS.train_state_from_modules(g, d, tcfg)


@pytest.fixture(scope="module")
def sweeps(data_root, tmp_path_factory):
    """grouptraj's train_many and the port's from grouptraj's initial
    weights with JAX's draws -> (jax ckpts, port ckpts, jax dir, port dir).
    """
    out = str(tmp_path_factory.mktemp("sweeps"))
    jdir, pdir = os.path.join(out, "jax"), os.path.join(out, "port")
    ref = JMULTI.train_many(JCFG, JaxTrainConfig(**TRAIN, output_dir=jdir),
                            SEEDS)
    tcfg = TrainConfig(**TRAIN, output_dir=pdir)
    inits = iter([_port_state(jax_init_train_state(
        jax.random.split(jax.random.PRNGKey(s))[1], JCFG,
        JaxTrainConfig(**TRAIN)), tcfg) for s in SEEDS])
    _, train_loader, val_loader = LOOP.build_loaders(CFG, tcfg)
    N = train_loader.dense.n_max
    n_val = -(-val_loader.dense.num_seq // S)
    _, nb_limit = LOOP.make_train_eval_subset(tcfg, train_loader.dense)
    mp = pytest.MonkeyPatch()
    mp.setattr(MULTI, "init_train_state", lambda *a, **k: next(inits))
    try:
        got = MULTI.train_many(CFG, tcfg, SEEDS, device="cpu", draws=[
            JaxSweepDraws(s, N, tcfg.best_k, n_val, nb_limit)
            for s in SEEDS])
    finally:
        mp.undo()
    return ref, got, jdir, pdir


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max(initial=0.0)
                 / max(np.abs(ref).max(initial=0.0), 1e-30))


def _adam(opt_state):
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu")][0]


def _same_histories(got, ref, rtol, keys=("losses_ts", "sample_ts",
                                          "counters", "best_t",
                                          "best_t_nl")):
    for key in keys:
        assert got[key] == ref[key], key
    for key in ("G_losses", "D_losses", "metrics_val", "metrics_train"):
        assert set(got[key]) == set(ref[key]), key
        for k, v in ref[key].items():
            assert len(got[key][k]) == len(v) > 0
            assert _rel(got[key][k], v) <= rtol, (key, k)
    for key in ("norm_g", "norm_d"):
        assert len(got[key]) == len(ref[key]) > 0
        assert _rel(got[key], ref[key]) <= rtol, key


def _same_weights(got, ref, atol, noisy_atol=None,
                  kinds=("g_state", "d_state", "g_best_state",
                         "d_best_nl_state", "g_ema_state")):
    for kind in kinds:
        assert set(got[kind]) == set(ref[kind]), kind
        for k, v in ref[kind].items():
            tol = noisy_atol if noisy_atol and k in NOISY else atol
            np.testing.assert_allclose(got[kind][k], v, rtol=0, atol=tol,
                                       err_msg=f"{kind} {k}")


def test_sweep_matches_grouptraj_train_many(sweeps):
    """Per seed: histories 1e-5 relative, weights, best states and EMA
    1e-4 absolute; the files carry the sweep's args."""
    ref, got, _, pdir = sweeps
    assert set(got) == set(ref) == set(SEEDS)
    for s in SEEDS:
        _same_histories(got[s], ref[s], RTOL, keys=(
            "losses_ts", "sample_ts", "restore_ts", "counters", "best_t",
            "best_t_nl"))
        assert got[s]["counters"]["t"] == 6
        assert ref[s]["D_losses"]["D_data_loss"][0] != pytest.approx(
            2 * np.log(2))                                # D is alive
        _same_weights(got[s], ref[s], 1e-4)
        assert got[s]["args"]["seed"] == s
        assert got[s]["args"]["sweep_seeds"] == SEEDS
        assert os.path.isfile(os.path.join(pdir, f"s{s}", "ck_no_model.pt"))
    a, b = (np.concatenate([np.ravel(v) for v in got[s]["g_state"].values()])
            for s in SEEDS)
    assert not np.allclose(a, b)                  # the replicas differ


def _moments_close(got, ref, tol, where):
    for opt, kind in (("g_optim_state", "generator"),
                      ("d_optim_state", "discriminator")):
        r, g = _adam(ref[opt]), _adam(got[opt])
        assert int(g.count) == int(r.count) == 6
        for moment in ("mu", "nu"):
            gm = params_from_jax(getattr(g, moment), kind)
            rm = params_from_jax(getattr(r, moment), kind)
            assert set(gm) == set(rm)
            top = max(np.abs(v).max() for v in rm.values())
            assert top > 0
            for k in rm:
                assert np.abs(gm[k] - rm[k]).max() <= tol * top, \
                    (where, opt, moment, k)


def test_sweep_adam_moments_match_grouptraj(sweeps):
    """Each replica's Adam moments within 1e-5 of its optimizer's largest
    moment. Six iterations from a fresh init drift D's moments by up to
    5.5e-6 of the largest between the packages' ``train()`` as well, on
    the same weights and draws (the same comparison without the seed
    axis), so this bound is the packages', not the sweep's."""
    ref, got, _, _ = sweeps
    for s in SEEDS:
        _moments_close(got[s], ref[s], 1e-5, s)


def _small(out, **kw):
    return TrainConfig(**dict(TRAIN, output_dir=out, **kw))


def test_one_seed_sweep_matches_train(data_root, tmp_path):
    """A sweep of [s] is train() with seed s: the same init and draws from
    one generator; histories 1e-6 relative, weights 1e-6 absolute (the
    inter-group attention vectors 2 lr an iteration)."""
    s = SEEDS[1]
    tcfg = _small(str(tmp_path / "one"), num_iterations=4, seed=s)
    many = MULTI.train_many(CFG, tcfg, [s], device="cpu")[s]
    one = LOOP.train(CFG, _small(str(tmp_path / "train"), num_iterations=4,
                                 seed=s), device="cpu")
    _same_histories(many, one, 1e-6)
    _same_weights(many, one, 1e-6,
                  noisy_atol=2 * tcfg.g_learning_rate * 4)


def test_resumed_sweep_matches_uninterrupted(data_root, tmp_path):
    """Interrupted at t=4 and resumed to 6: equal histories, weights and
    generator states (each replica's chain comes back from its file).
    Stopped at t=3, inside a dispatch of 2: the resume trains 4 to 6."""
    full = MULTI.train_many(CFG, _small(str(tmp_path / "full")), SEEDS,
                            device="cpu")
    out = str(tmp_path / "resumed")
    MULTI.train_many(CFG, _small(out, num_iterations=4), SEEDS, device="cpu")
    resumed = MULTI.train_many(CFG, _small(out, restore_from_checkpoint=True),
                               SEEDS, device="cpu")
    for s in SEEDS:
        a, b = full[s], resumed[s]
        assert b["restore_ts"] == [4] and b["counters"]["t"] == 6
        _same_histories(b, a, 1e-6)
        _same_weights(b, a, 1e-6)
        assert np.array_equal(a[MULTI.RNG_KEY], b[MULTI.RNG_KEY])
        for kind in ("g_optim_state", "d_optim_state"):
            for x, y in zip(jax.tree_util.tree_leaves(a[kind]),
                            jax.tree_util.tree_leaves(b[kind])):
                np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)
    # stopped after a dispatch its own num_iterations cut short (t=3 with
    # dispatches of 2): the resume replays that dispatch and trains 4..6
    out = str(tmp_path / "partial")
    MULTI.train_many(CFG, _small(out, num_iterations=3), SEEDS, device="cpu")
    part = MULTI.train_many(CFG, _small(out, restore_from_checkpoint=True),
                            SEEDS, device="cpu")
    for s in SEEDS:
        assert part[s]["restore_ts"] == [3]
        assert part[s]["losses_ts"] == [2, 3, 5, 6]     # dispatch ends
        assert len(part[s]["norm_g"]) == 6


def test_each_package_restores_the_others_sweep(sweeps, tmp_path, caplog):
    """A port-written sweep restores in grouptraj with its Adam moments; a
    grouptraj-written one restores in the port, with fresh per-seed
    chains and a warning, to the file's weights and moments."""
    ref, got, jdir, pdir = sweeps
    cks = JMULTI._load_sweep_checkpoints(pdir, SEEDS, "ck")
    for s, ck in zip(SEEDS, cks):
        jstate = jax_state_from_checkpoint(ck, JCFG, JaxTrainConfig(**TRAIN))
        g = params_from_jax(jax.device_get(jstate.g_params), "generator")
        for k, v in got[s]["g_state"].items():
            assert np.array_equal(g[k], v), k
        assert int(_adam(jstate.g_opt).count) == 6
        assert ck["args"]["sweep_seeds"] == SEEDS
    out = str(tmp_path / "from_jax")
    shutil.copytree(jdir, out)
    with caplog.at_level(logging.WARNING, logger=MULTI.__name__):
        back, st = MULTI.train_many(
            CFG, _small(out, restore_from_checkpoint=True), SEEDS,
            device="cpu", return_state=True)
    assert any("fresh per-seed generator chain" in r.message
               for r in caplog.records)
    for i, s in enumerate(SEEDS):
        assert back[s]["restore_ts"] == [6]
        _same_weights(back[s], ref[s], 0.0, kinds=("g_state", "d_state"))
        r = params_from_jax(_adam(ref[s]["d_optim_state"]).mu,
                            "discriminator")
        for name, leaf in st.d_params.items():
            m = st.d_opt.state[leaf]["exp_avg"][i].numpy()
            assert np.array_equal(m, r[name]), name


def test_pool_core_vmap_rule_folds_replicas():
    """PoolCore under vmap over 3 replicas with different weights (b2
    shared, valid shared) against a loop of R = 1 calls, on CPU tensors:
    the forward and all four gradients within 1e-6."""
    g = torch.Generator().manual_seed(0)
    n, S_, N, K, B = 3, 2, 5, 8, 4
    a, u = (torch.randn(n, S_, N, K, generator=g).requires_grad_()
            for _ in range(2))
    W2 = torch.randn(n, K, B, generator=g).requires_grad_()
    b2 = torch.randn(B, generator=g).requires_grad_()
    valid = (torch.rand(S_, N, generator=g) > 0.3).float()
    valid[0, 0] = 1.0

    def one(a, u, W2):
        p, c = PoolCore.apply(a[None], u[None], W2[None], b2[None],
                              valid[None])
        return p[0], c[0]

    pooled, cnt = torch.func.vmap(one)(a, u, W2)
    dp = torch.randn(pooled.shape, generator=g)
    grads = torch.autograd.grad((pooled * dp).sum(), [a, u, W2, b2])
    db2 = torch.zeros(B)
    vi = valid > 0
    for i in range(n):
        x = [t[i].detach().requires_grad_() for t in (a, u, W2)]
        b = b2.detach().requires_grad_()
        p, c = PoolCore.apply(x[0][None], x[1][None], x[2][None], b[None],
                              valid[None])
        assert torch.allclose(p[0][vi], pooled[i][vi], rtol=0, atol=1e-6)
        assert torch.equal(c[0][vi], cnt[i][vi])
        ref = torch.autograd.grad((p[0] * dp[i]).sum(), [*x, b])
        for r, got in zip(ref[:3], grads[:3]):
            assert torch.allclose(r, got[i], rtol=0, atol=1e-6)
        db2 += ref[3]
    assert torch.allclose(db2, grads[3], rtol=0, atol=1e-6)


def _refusal_dir(data_root, tmp_path):
    """A 2-iteration sweep of SEEDS, written by the port."""
    out = str(tmp_path / "sweep")
    MULTI.train_many(CFG, _small(out, num_iterations=2), SEEDS, device="cpu")
    return out


def _retime(out, seed, t):
    path = os.path.join(out, f"s{seed}")
    ck = CK.load_checkpoint(os.path.join(path, "ck_with_model.pt"))
    ck["counters"]["t"] = t
    CK.save_checkpoint(ck, path, "ck")


def test_batch_norm_sweep_steps_match_single_steps():
    """A batch_norm + leakyrelu model through the sweep's steps (two seeds
    stacked, the d-step's fake and real scored apart under the seed vmap)
    equals each seed's own steps: the gradients of ``d_loss``/``g_loss``
    under ``replica_map`` against ``d_gradients``/``g_gradients`` at 1e-5
    of the largest entry (a vmapped matmul rounds differently), and the
    losses of ``d_step_many``/``g_step_many`` against ``d_step``/``g_step``
    at 1e-5 relative."""
    cfg = ModelConfig(**NARROW, batch_norm=True, activation="leakyrelu")
    tcfg = TrainConfig(**TRAIN)
    states = [TS.init_train_state(cfg, tcfg, torch.Generator().manual_seed(
        s), device="cpu") for s in SEEDS]
    st = TS.stack_states(states, tcfg)
    data = synthetic_device_data(8, 5, cfg.obs_len, cfg.pred_len, seed=3,
                                 device="cpu")
    b = gather_batch(data, torch.tensor([0, 1, 2, 3]), cfg.obs_len)
    gens = [torch.Generator().manual_seed(10 + i) for i in range(2)]
    dd = [TS.d_draws(cfg, S, 5, g, "cpu") for g in gens]
    gd = [TS.g_draws(cfg, tcfg, S, 5, g, "cpu") for g in gens]

    def check_grads(loss_fn, draws, stacked, single):
        loss = TS.replica_map(st, loss_fn, *TS._stack_draws(draws,
                                                            "cpu").values())
        if isinstance(loss, tuple):
            loss = loss[-1]
        grads = torch.autograd.grad(loss.sum(), list(stacked.values()))
        for i, state in enumerate(states):
            ref = single(state, b, cfg, tcfg, impl="scan", **draws[i])[1]
            top = max(float(r.abs().max()) for r in ref)
            for name, g, r in zip(stacked, grads, ref):
                np.testing.assert_allclose(g[i].numpy(), r.numpy(), rtol=0,
                                           atol=1e-5 * top, err_msg=name)

    check_grads(lambda g, d, z, y: TS.d_loss(g, d, b, cfg, tcfg, z, y,
                                             "scan"),
                dd, st.d_params, TS.d_gradients)
    many = TS.d_step_many(st, b, cfg, tcfg, impl="scan",
                          **TS._stack_draws(dd, "cpu"))
    ones = [TS.d_step(state, b, cfg, tcfg, impl="scan", **dd[i])
            for i, state in enumerate(states)]
    check_grads(lambda g, d, z, y: TS.g_loss(g, d, b, cfg, tcfg, z, y,
                                             "scan"),
                gd, st.g_params, TS.g_gradients)
    many.update(TS.g_step_many(st, b, cfg, tcfg, impl="scan",
                               **TS._stack_draws(gd, "cpu")))
    for i, state in enumerate(states):
        ones[i].update(TS.g_step(state, b, cfg, tcfg, impl="scan", **gd[i]))
        for k, v in ones[i].items():
            np.testing.assert_allclose(float(many[k][i]), float(v),
                                       rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("case", [
    "duplicate", "partial", "mismatch", "unequal_t", "beyond", "devices",
    "dropout", "cli"])
def test_refusals_and_cli(case, data_root, tmp_path):
    if case == "dropout":
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
            MULTI.train_many(dataclasses.replace(CFG, dropout1=0.1),
                             _small(str(tmp_path)), SEEDS, device="cpu")
    elif case == "duplicate":
        with pytest.raises(ValueError, match="duplicate"):
            MULTI.train_many(CFG, _small(str(tmp_path)), [5, 5],
                             device="cpu")
    elif case == "devices":
        with pytest.raises(NotImplementedError, match="queue 1 item 10"):
            MULTI.train_many(CFG, _small(str(tmp_path), num_devices=2),
                             SEEDS, device="cpu")
    elif case == "cli":
        out = str(tmp_path / "cli")
        cmd = [sys.executable, "-m", "grouptraj_torch.train.cli_many",
               "--seeds", "5,6", "--device", "cpu", "--dataset_name", "toy",
               "--batch_size", "4", "--num_epochs", "0", "--num_iterations",
               "2", "--best_k", "2", "--print_every", "1",
               "--checkpoint_every", "2", "--steps_per_dispatch", "2",
               "--num_samples_check", "20", "--n_buckets", "1",
               "--output_dir", out, "--checkpoint_name", "ck"]
        env = dict(os.environ, GROUPTRAJ_DATA_DIR=data_root,
                   OMP_NUM_THREADS="1")
        r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
        for s in SEEDS:
            ck = CK.load_checkpoint(os.path.join(out, f"s{s}",
                                                 "ck_with_model.pt"))
            assert ck["counters"]["t"] == 2 and ck["args"]["seed"] == s
            assert ck["args"]["sweep_seeds"] == SEEDS
            assert ck["args"]["device"] == "cpu"
            assert os.path.isfile(os.path.join(out, f"s{s}",
                                               "ck_no_model.pt"))
    else:
        out = _refusal_dir(data_root, tmp_path)
        seeds, match, iters = SEEDS, None, 6
        if case == "partial":
            shutil.rmtree(os.path.join(out, "s6"))
            match = "partial sweep"
        elif case == "mismatch":
            seeds, match = SEEDS[::-1], "seed-set mismatch"
        elif case == "unequal_t":
            _retime(out, SEEDS[1], 4)
            match = "inconsistent member counters"
        else:
            iters, match = 1, "num_iterations"
        with pytest.raises(ValueError, match=match):
            MULTI.train_many(CFG, _small(out, num_iterations=iters,
                                         restore_from_checkpoint=True),
                             seeds, device="cpu")
