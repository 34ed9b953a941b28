"""The port's training loop, index streams, checkpoints and CLI against
``grouptraj/train/loop.py``, ``device_data.py`` and ``checkpoint.py`` on
the CPU, on the toy split of ``tests/test_loop.py`` (4 pedestrians walking
in two groups, 21 train and 6 val windows) at narrow widths, one scene-size
bucket.

grouptraj's ``train()`` writes a checkpoint after 2 iterations (non-zero
Adam moments); both packages' ``train()`` resume from that file to 6
iterations (dispatches of 2, print every iteration, checkpoint every 2),
the port on the draws JAX takes: the key chain of ``grouptraj.train.loop``
re-derived (per dispatch, per iteration, per d-/g-step as
``build_train_chunk``, ``build_d_step`` and ``build_g_step`` split it; per
sweep batch as ``build_check_accuracy_sweep`` does) and injected through
``train(draws=...)``. Seed 5, whose discriminator scores are alive (its
trailing ReLU leaves some seeds with no gradient).

Tolerances (float32 on both sides): losses, metrics and grad norms 1e-5
relative to each history's largest entry; event timestamps and counters
equal; weights 1e-4 absolute after the six iterations (the multi-iteration
tolerance of ``test_torch_steps.py``: Adam turns rounding noise in
near-zero gradients into up to ~1e-5 of a step); Adam moments 1e-6 of
the largest moment of their optimizer (G's or D's ``mu``, ``nu``),
``count`` equal. Not per tensor: the GAT's ``out_att.a`` vectors have
gradients at the rounding level (the same weights test_torch_steps.py
exempts), so their moments are rounding noise and differ by up to 98% of
their own size, 7e-8 of G's largest moment; every other tensor is within
3e-6 of its own largest entry. A step taken in both packages from one
port-written file: weights 1e-6 absolute.
"""

import functools
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import optax
from grouptraj.config import ModelConfig as JaxModelConfig
from grouptraj.config import TrainConfig as JaxTrainConfig
from grouptraj.models.generator import sample_noises as jax_sample_noises
from grouptraj.train import device_data as JDD
from grouptraj.train import loop as JLOOP
from grouptraj.train.checkpoint import load_checkpoint as jax_load
from grouptraj.train.checkpoint import (
    state_from_checkpoint as jax_state_from_checkpoint,
)
from grouptraj.train.steps import build_d_step, build_g_step
from grouptraj_torch.compat import (
    optax_from_adam, params_from_jax, params_to_jax,
)
from grouptraj_torch.config import ModelConfig, TrainConfig
from grouptraj_torch.train import checkpoint as CK
from grouptraj_torch.train import device_data as DD
from grouptraj_torch.train import loop as LOOP
from grouptraj_torch.train import steps as TS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(embedding_dim=8, encoder_h_dim_g=16, decoder_h_dim_g=16,
              noise_dim=(4,), bottleneck_dim=4, hidden_units=12,
              graph_out_dim=8, encoder_h_dim_d=12, mlp_dim=16)
SEED, S = 5, 4
TRAIN = dict(dataset_name="toy", batch_size=S, num_epochs=0,
             num_iterations=2, checkpoint_every=2, print_every=1, best_k=3,
             checkpoint_name="ck", num_samples_check=30,
             steps_per_dispatch=2, n_buckets=1, bf16_nograd=False, seed=SEED)
JCFG, CFG = JaxModelConfig(**NARROW), ModelConfig(**NARROW)
RTOL = 1e-5

# the references compile with XLA's cheaper CPU pipeline (as
# test_torch_presets.py's do), which changes no value beyond the last bits
_jit = functools.partial(jax.jit, compiler_options=dict(
    xla_backend_optimization_level=0, xla_llvm_disable_expensive_passes=True))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: one thread a process keeps the workers of a
    parallel test run from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_toy(root):
    """tests/test_loop.py's toy split under ``root/toy``."""
    rng = np.random.default_rng(0)
    for split, nframes in (("train", 40), ("val", 25)):
        d = os.path.join(root, "toy", split)
        os.makedirs(d, exist_ok=True)
        rows = []
        for t in range(nframes):
            for p in (1, 2, 3, 4):
                x = 0.1 * t + p + 0.01 * rng.standard_normal()
                y = 0.05 * t - p
                rows.append(f"{t*10.0}\t{p}.0\t{x:.4f}\t{y:.4f}\t{p % 2}.0")
        with open(os.path.join(d, "toy.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("datasets"))
    write_toy(root)
    mp = pytest.MonkeyPatch()
    mp.setenv("GROUPTRAJ_DATA_DIR", root)
    yield root
    mp.undo()


def _t(x):
    return torch.from_numpy(np.array(x))


def _uniform(key):
    return float(jax.random.uniform(key, (), minval=0.7, maxval=1.2))


def _noise(keys, N):
    return _t(jax_sample_noises(JCFG, keys, S, N, np.float32))


def d_draw(key, N):
    """build_d_step's draws from its key."""
    k_gen, k_label, _ = jax.random.split(key, 3)
    return dict(noise=_noise(k_gen[None], N)[0], label=_uniform(k_label))


def g_draw(key, N, best_k):
    """build_g_step's draws from its key."""
    k_label, k_samples, _ = jax.random.split(key, 3)
    return dict(noises=_noise(jax.random.split(k_samples, best_k), N),
                label=_uniform(k_label))


class JaxDraws(LOOP.Draws):
    """The draws of a fresh ``grouptraj.train.loop.train`` process (one
    d-step and one g-step an iteration)."""

    def __init__(self, seed, N, best_k, n_val, n_train):
        self.key = jax.random.split(jax.random.PRNGKey(seed))[0]
        self.N, self.best_k, self.n = N, best_k, (n_val, n_train)

    def iterations(self, n):
        self.key, sub = jax.random.split(self.key)
        out = []
        for k in jax.random.split(sub, n):
            k, kd = jax.random.split(k)
            k, kg = jax.random.split(k)
            out.append({"d": [d_draw(kd, self.N)],
                        "g": [g_draw(kg, self.N, self.best_k)]})
        return out

    def sweeps(self):
        self.key, k1, k2 = jax.random.split(self.key, 3)
        return self._sweep(k1, self.n[0]), self._sweep(k2, self.n[1])

    @staticmethod
    def _sweep(key, n_batches):
        keys = jax.random.split(key, n_batches)

        def draw(i, S_, N_):
            k_gen, k_label = jax.random.split(keys[i])
            return (_t(jax_sample_noises(JCFG, k_gen[None], S_, N_,
                                         np.float32))[0], _uniform(k_label))
        return draw


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max(initial=0.0)
                 / max(np.abs(ref).max(initial=0.0), 1e-30))


def _adam(opt_state):
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu")][0]


@pytest.fixture(scope="module")
def runs(data_root, tmp_path_factory):
    """grouptraj trains 2 iterations; both packages resume from its file
    to 6. -> (jax checkpoint, port checkpoint, port state, port's dir)."""
    out = str(tmp_path_factory.mktemp("runs"))
    jdir, pdir = os.path.join(out, "jax"), os.path.join(out, "port")
    first = JLOOP.train(JCFG, JaxTrainConfig(**TRAIN, output_dir=jdir))
    assert min(first["norm_d"]) > 0 and first["counters"]["t"] == 2
    os.makedirs(pdir)
    shutil.copy(os.path.join(jdir, "ck_with_model.pt"), pdir)
    more = dict(TRAIN, num_iterations=6)
    ref = JLOOP.train(JCFG, JaxTrainConfig(**more, output_dir=jdir))
    tcfg = TrainConfig(**more, output_dir=pdir)
    _, train_loader, val_loader = LOOP.build_loaders(CFG, tcfg)
    N = train_loader.dense.n_max
    n_val = -(-val_loader.dense.num_seq // S)
    _, nb_limit = LOOP.make_train_eval_subset(tcfg, train_loader.dense)
    got, state = LOOP.train(CFG, tcfg, device="cpu", return_state=True,
                            draws=JaxDraws(SEED, N, tcfg.best_k, n_val,
                                           nb_limit))
    return ref, got, state, pdir


@pytest.mark.parametrize("seed,num_seq,batch", [(0, 21, 4), (7, 64, 64)])
def test_index_streams_match_grouptraj(seed, num_seq, batch):
    """IndexStream, BucketScheduler, _sweep_indices and
    make_train_eval_subset draw bit-identical indices."""
    a, b = (iter(DD.IndexStream(num_seq, batch, seed=seed)),
            iter(JDD.IndexStream(num_seq, batch, seed=seed)))
    for _ in range(3 * -(-num_seq // batch) + 1):
        x, y = next(a), next(b)
        assert x.dtype == y.dtype == np.int32 and np.array_equal(x, y)
    sizes = [num_seq, num_seq // 2 + 1, 5]
    p = DD.BucketScheduler(sizes, batch, seed=seed)
    j = JDD.BucketScheduler(sizes, batch, seed=seed)
    for chunk in (1, 3, 2, 5):
        (pb, pi), (jb, ji) = p.next_dispatch(chunk, 2), j.next_dispatch(
            chunk, 2)
        assert pb == jb and np.array_equal(pi, ji) and p.epoch == j.epoch
    order = np.random.default_rng(seed).permutation(num_seq)
    for o in (None, order):
        assert np.array_equal(LOOP._sweep_indices(num_seq, batch, o),
                              JLOOP._sweep_indices(num_seq, batch, o))

    class Dense:
        valid = (np.random.default_rng(seed).random((num_seq, 8)) > 0.4
                 ).astype(np.float32)

    Dense.num_seq = num_seq
    tcfg = dict(seed=seed, num_samples_check=40, batch_size=batch)
    (pr, pn), (jr, jn) = (
        LOOP.make_train_eval_subset(TrainConfig(**tcfg), Dense),
        JLOOP.make_train_eval_subset(JaxTrainConfig(**tcfg), Dense))
    assert pn == jn and np.array_equal(pr.permutation(num_seq),
                                       jr.permutation(num_seq))


def test_device_dataset_and_check_accuracy_match_grouptraj(data_root):
    """device_dataset bit for bit; check_accuracy over a loader, whole and
    limited to num_samples_check, from one JAX init with JAX's draws."""
    from grouptraj.data import DenseDataset as JaxDense
    from grouptraj.data import DenseLoader as JaxLoader
    from grouptraj.data import TrajectoryDataset as JaxDataset
    from grouptraj.train.steps import check_accuracy as jax_check_accuracy
    from grouptraj.train.steps import init_train_state
    from grouptraj.train.steps import make_check_accuracy_step as jax_step
    from grouptraj_torch.compat import discriminator_state, generator_state
    from grouptraj_torch.data import (
        DenseDataset, DenseLoader, TrajectoryDataset,
    )
    from grouptraj_torch.models.discriminator import TrajectoryDiscriminator
    from grouptraj_torch.models.generator import TrajectoryGenerator
    path = os.path.join(data_root, "toy", "train")
    dense, jdense = (DenseDataset(TrajectoryDataset(path), 8),
                     JaxDense(JaxDataset(path), 8))
    got = DD.device_dataset(dense, 8, device="cpu")
    ref = JDD.device_dataset(jdense, 8)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert np.array_equal(got[k].numpy(), np.asarray(v)), k
    assert float(got["valid"][-1].abs().sum()) == 0       # the null scene

    jstate = init_train_state(jax.random.PRNGKey(0), JCFG,
                              JaxTrainConfig(**TRAIN))
    jstate.d_params["real_classifier"]["layers"][-1]["linear"]["b"] += 1.0
    g, d = TrajectoryGenerator(CFG), TrajectoryDiscriminator(CFG)
    g.load_state_dict(generator_state(params_from_jax(
        jax.device_get(jstate.g_params), "generator")))
    d.load_state_dict(discriminator_state(params_from_jax(
        jax.device_get(jstate.d_params), "discriminator")))
    state = TS.train_state_from_modules(g, d, TrainConfig(**TRAIN))
    key = jax.random.PRNGKey(7)
    subs = []
    for _ in range(-(-dense.num_seq // S)):
        key, sub = jax.random.split(key)
        subs.append(sub)

    def draws(i, S_, N_):
        k_gen, k_label = jax.random.split(subs[i])
        return (_t(jax_sample_noises(JCFG, k_gen[None], S_, N_,
                                     np.float32))[0], _uniform(k_label))

    args = TrainConfig(**TRAIN)                  # num_samples_check 30
    for limit in (False, True):
        ref = jax_check_accuracy(args, JaxLoader(jdense, S, shuffle=False),
                                 jstate, jax_step(JCFG),
                                 jax.random.PRNGKey(7), limit=limit)
        got = TS.check_accuracy(args, DenseLoader(dense, S, shuffle=False),
                                state, TS.make_check_accuracy_step(CFG),
                                device="cpu", draws=draws, limit=limit)
        assert set(got) == set(ref) and ref["ade"] > 0
        for k, v in ref.items():
            assert abs(got[k] - v) <= RTOL * max(abs(v), 1e-6), (limit, k)
    assert ref["d_loss"] != pytest.approx(2 * np.log(2))  # D is alive


def test_profile_and_timing_leave_the_run_unchanged(data_root, tmp_path,
                                                    monkeypatch, caplog):
    """With profile_dir the traced iterations run as their own dispatch
    under torch.profiler (a Chrome trace each), with timing each dispatch
    is synchronised and logged; neither changes a number. A data-parallel
    rank other than 0 (``is_writer()`` false) writes no trace and no
    checkpoint."""
    import logging
    monkeypatch.setattr(LOOP, "PROFILE_ITERS", (1, 3))
    base = dict(TRAIN, num_iterations=4, checkpoint_every=4, n_buckets=2,
                steps_per_dispatch=4)
    plain = LOOP.train(CFG, TrainConfig(**base, output_dir=str(
        tmp_path / "a")), device="cpu")
    prof = str(tmp_path / "prof")
    with caplog.at_level(logging.INFO, logger=LOOP.__name__):
        traced = LOOP.train(CFG, TrainConfig(
            **base, output_dir=str(tmp_path / "b"), profile_dir=prof,
            timing=True), device="cpu")
    assert os.listdir(prof) == ["trace_1_3.json"]
    assert sum("chunk of 4 iterations took" in r.message
               for r in caplog.records) == 1
    assert traced["norm_g"] == plain["norm_g"]
    assert traced["G_losses"] == plain["G_losses"]
    assert traced["metrics_val"] == plain["metrics_val"]
    monkeypatch.setattr(LOOP, "is_writer", lambda: False)
    quiet = LOOP.train(CFG, TrainConfig(
        **base, output_dir=str(tmp_path / "c"),
        profile_dir=str(tmp_path / "prof_c")), device="cpu")
    assert not (tmp_path / "c").exists()
    assert not (tmp_path / "prof_c").exists()
    assert quiet["G_losses"] == plain["G_losses"]


def test_resumed_loop_matches_grouptraj(runs):
    ref, got, _, _ = runs
    for key in ("losses_ts", "sample_ts", "restore_ts", "counters", "best_t",
                "best_t_nl"):
        assert got[key] == ref[key], key
    assert got["restore_ts"] == [2] and got["counters"]["t"] == 6
    for key in ("G_losses", "D_losses", "metrics_val", "metrics_train"):
        assert set(got[key]) == set(ref[key]), key
        for k, v in ref[key].items():
            assert len(got[key][k]) == len(v) == 3
            assert _rel(got[key][k], v) <= RTOL, (key, k)
    for key in ("norm_g", "norm_d"):
        assert len(got[key]) == len(ref[key]) == 6
        assert _rel(got[key], ref[key]) <= RTOL, key
    assert max(ref["norm_d"]) > 0 and ref["D_losses"]["D_data_loss"][0] \
        != pytest.approx(2 * np.log(2))                  # D is alive
    for kind in ("g_state", "d_state", "g_best_state", "d_best_nl_state"):
        assert set(got[kind]) == set(ref[kind]), kind
        for k, v in ref[kind].items():
            np.testing.assert_allclose(got[kind][k], v, rtol=0, atol=1e-4,
                                       err_msg=f"{kind} {k}")


def test_resumed_adam_moments_match_grouptraj(runs):
    ref, got, _, _ = runs
    for opt, kind in (("g_optim_state", "generator"),
                      ("d_optim_state", "discriminator")):
        r, g = _adam(ref[opt]), _adam(got[opt])
        assert type(g).__name__ == "ScaleByAdamState"
        assert int(g.count) == int(r.count) == 6
        assert np.asarray(g.count).dtype == np.int32
        # the same chain, tree for tree (the port's stand-in classes have
        # optax's names and fields)
        assert [type(x).__name__ for x in jax.tree_util.tree_leaves(
            got[opt], is_leaf=lambda x: x == () or hasattr(x, "mu"))] == \
            [type(x).__name__ for x in jax.tree_util.tree_leaves(
                ref[opt], is_leaf=lambda x: x == () or hasattr(x, "mu"))]
        for moment in ("mu", "nu"):
            gm = params_from_jax(getattr(g, moment), kind)
            rm = params_from_jax(getattr(r, moment), kind)
            assert set(gm) == set(rm)
            top = max(np.abs(v).max() for v in rm.values())
            assert top > 0
            for k in rm:
                assert np.abs(gm[k] - rm[k]).max() <= 1e-6 * top, \
                    (opt, moment, k)


def test_port_file_steps_on_in_grouptraj(runs, data_root):
    """A port-written file restores in grouptraj with optax classes and the
    port's moments; one more d-step + g-step there matches the port's."""
    _, _, state, pdir = runs
    path = os.path.join(pdir, "ck_with_model.pt")
    tcfg, jtcfg = TrainConfig(**TRAIN), JaxTrainConfig(**TRAIN)
    jstate = jax_state_from_checkpoint(jax_load(path), JCFG, jtcfg)
    assert isinstance(jstate.g_opt[0], optax.EmptyState)
    assert isinstance(jstate.g_opt[1][0], optax.ScaleByAdamState)
    assert isinstance(jstate.d_opt[0][0], optax.ScaleByAdamState)
    for opt, module, tree, kind in (
            (state.g_opt, state.g, jstate.g_opt[1][0], "generator"),
            (state.d_opt, state.d, jstate.d_opt[0][0], "discriminator")):
        assert int(tree.count) == 6
        for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            named = params_from_jax(getattr(tree, moment), kind)
            for name, p in module.named_parameters():
                assert np.array_equal(named[name],
                                      opt.state[p][key].numpy()), name
            assert all(float(opt.state[p]["step"]) == 6
                       for p in module.parameters())

    from grouptraj_torch.data import DenseDataset, TrajectoryDataset
    dense = DenseDataset(TrajectoryDataset(
        os.path.join(data_root, "toy", "train")), 8)
    data = DD.device_dataset(dense, CFG.obs_len, device="cpu")
    idx = torch.tensor([[[3, 0, 7, 11], [5, 20, 1, 21]]])
    batches = [DD.gather_batch(data, idx[0, j], CFG.obs_len)
               for j in range(2)]
    key_d, key_g = jax.random.PRNGKey(31), jax.random.PRNGKey(32)
    draws = [{"d": [d_draw(key_d, 8)], "g": [g_draw(key_g, 8, 3)]}]
    TS.train_iterations(state, data, idx, CFG, tcfg, draws=draws)
    jb = [{k: v.numpy() for k, v in b.items()} for b in batches]
    jstate, _ = _jit(build_d_step(JCFG, jtcfg))(jstate, jb[0], key_d)
    jstate, _ = _jit(build_g_step(JCFG, jtcfg))(jstate, jb[1], key_g)
    for module, params, kind in ((state.g, jstate.g_params, "generator"),
                                 (state.d, jstate.d_params,
                                  "discriminator")):
        ref = params_from_jax(jax.device_get(params), kind)
        for k, v in module.state_dict().items():
            np.testing.assert_allclose(v.numpy(), ref[k], rtol=0, atol=1e-6,
                                       err_msg=k)


def test_grouptraj_file_restores_into_port(runs, data_root, tmp_path):
    """A JAX-written file restores into the port with its moments, not a
    fresh Adam; a file whose moments do not fit the model starts fresh;
    the small file lacks every KEY_BLACKLIST entry."""
    ref, got, _, pdir = runs
    jpath = os.path.join(os.path.dirname(pdir), "jax", "ck_with_model.pt")
    ckpt = CK.load_checkpoint(jpath)
    adam_g = _adam(ref["g_optim_state"])
    tcfg = TrainConfig(**TRAIN)
    state = CK.state_from_checkpoint(ckpt, CFG, tcfg, device="cpu")
    for opt, module, kind, clip in (
            (state.g_opt, state.g, "generator", tcfg.clipping_threshold_g),
            (state.d_opt, state.d, "discriminator",
             tcfg.clipping_threshold_d)):
        adam = _adam(ref["g_optim_state" if kind == "generator"
                         else "d_optim_state"])
        mu = params_from_jax(adam.mu, kind)
        for name, p in module.named_parameters():
            assert np.array_equal(opt.state[p]["exp_avg"].numpy(), mu[name])
            assert float(opt.state[p]["step"]) == int(adam.count) == 6
        # and back: the port's export is the file's tree, bit for bit
        back = _adam(optax_from_adam(opt, module, kind, clip))
        for a, b in zip(jax.tree_util.tree_leaves(back.nu),
                        jax.tree_util.tree_leaves(adam.nu)):
            assert np.array_equal(a, b)
    tree = params_to_jax(state.g.state_dict(), "generator")
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(adam_g.mu)
    for module, kind in ((state.g, "generator"), (state.d, "discriminator")):
        # the modules' own JAX-layout views agree with params_to_jax
        a, b = params_to_jax(module.state_dict(), kind), module.tree()
        assert jax.tree_util.tree_structure(a) == \
            jax.tree_util.tree_structure(b)
        assert all(np.array_equal(x, y.detach().numpy()) for x, y in zip(
            jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))
    wrong = dict(ckpt, g_state={k: v for k, v in ckpt["g_state"].items()})
    wrong["g_optim_state"] = got["d_optim_state"]
    fresh = CK.state_from_checkpoint(wrong, CFG, tcfg, device="cpu")
    assert len(fresh.g_opt.state) == 0 and len(fresh.d_opt.state) > 0
    small = CK.load_checkpoint(os.path.join(pdir, "ck_no_model.pt"))
    assert small is not None and not set(CK.KEY_BLACKLIST) & set(small)
    assert small["counters"]["t"] == 6 and "metrics_val" in small


def test_cli_trains_resumes_and_refuses_many_devices(data_root, tmp_path):
    from grouptraj_torch.train import cli
    out = str(tmp_path / "cli")
    base = [sys.executable, "-m", "grouptraj_torch.train.cli", "--device",
            "cpu", "--dataset_name", "toy", "--batch_size", "4",
            "--num_epochs", "0", "--best_k", "2", "--print_every", "1",
            "--checkpoint_every", "2", "--steps_per_dispatch", "2",
            "--num_samples_check", "20", "--n_buckets", "1",
            "--output_dir", out, "--checkpoint_name", "ck"]
    env = dict(os.environ, GROUPTRAJ_DATA_DIR=data_root, OMP_NUM_THREADS="1")
    for iters in ("2", "3"):
        r = subprocess.run(base + ["--num_iterations", iters], cwd=ROOT,
                           env=env, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    for name in ("ck_with_model.pt", "ck_no_model.pt"):
        assert os.path.isfile(os.path.join(out, name))
    ckpt = CK.load_checkpoint(os.path.join(out, "ck_with_model.pt"))
    assert ckpt["counters"]["t"] == 3 and ckpt["restore_ts"] == [2]
    assert ckpt["args"]["device"] == "cpu"
    assert ckpt["args"]["resolved_model_config"]["graph_module"] == "gat"
    with pytest.raises(ValueError, match=r"torchrun --nproc_per_node 2"):
        cli.main(["--device", "cpu", "--num_devices", "2"])
