"""Bo20 evaluation of the port against ``grouptraj.eval`` on all 15 zoo
checkpoints, and the port's ``evaluate_model`` CLI on the CPU.

The split is synthetic (``grouptraj_torch.data.synthetic``: three
ETH/UCY-format files, 2-12 pedestrians present, pairs and triples sharing
group labels); the real ETH/UCY test splits are not in the repository.
Both packages evaluate the same windows with the same weights; JAX's own
per-batch draws (``key, sub = split(key)``, then ``sample_noises`` over
``split(sub, k)``) are injected into the port through its ``noises`` seam.
ADE and FDE agree to 1e-5 relative on the ``'scan'`` and the ``'fused'``
route (on the CPU the latter runs its kernels' plain versions; the JAX
package's ``'fused'`` takes its scan off the TPU, so its scan is the
reference for both), for ``evaluate`` and ``evaluate_bucketed``.

Each JAX eval step is jitted once per distinct config (five across the
zoo) and batch shape, not once per file: ``make_eval_step`` is memoised
for the module.
"""

import dataclasses
import functools
import glob
import importlib
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grouptraj.compat import config_from_checkpoint_args as jax_config
from grouptraj.compat import import_generator
from grouptraj.data import DenseDataset as JaxDenseDataset
from grouptraj.data import DenseLoader as JaxDenseLoader
from grouptraj.data import TrajectoryDataset as JaxTrajectoryDataset
from grouptraj.models.generator import sample_noises as jax_sample_noises
from grouptraj.train.checkpoint import load_checkpoint as jax_load
from grouptraj_torch.data import DenseDataset, DenseLoader, TrajectoryDataset
from grouptraj_torch.data.synthetic import write_scene_files
from grouptraj_torch.eval import evaluate, evaluate_bucketed
from grouptraj_torch.eval.evaluate_model import get_generator
from grouptraj_torch.compat import params_from_jax
from grouptraj_torch.train.checkpoint import load_checkpoint
from scripts.evaluate_model import get_generator as jax_get_generator

JAX_EVAL = importlib.import_module("grouptraj.eval.evaluate")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = sorted(glob.glob(os.path.join(ROOT, "models/grouptraj/*.pt")))
K = 20
BATCH = 8
SEED = 3
RTOL = 1e-5


def _name(path):
    return os.path.basename(path)[:-len("_with_model.pt")]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops here are small. With torch's default of a thread
    per core, the workers of a parallel test run spin against each other
    (an eval pass measured ~125x slower with six workers); one thread a
    process avoids that."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _jit_once_per_config():
    mp = pytest.MonkeyPatch()
    mp.setattr(JAX_EVAL, "make_eval_step",
               functools.lru_cache(maxsize=None)(JAX_EVAL.make_eval_step))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    write_scene_files(str(root / "zara1" / "test"), n_files=3, frames=45,
                      max_peds=12, seed=5)
    return root


@functools.lru_cache(maxsize=None)
def _datasets(split_dir, pred_len):
    return (TrajectoryDataset(split_dir, pred_len=pred_len),
            JaxTrajectoryDataset(split_dir, pred_len=pred_len,
                                 use_native=False))


class _JaxDraws:
    """The noises JAX's eval draws for batch i, in order: ``key, sub =
    split(key)``, then ``sample_noises(cfg, split(sub, k), S, N)``."""

    def __init__(self, cfg, seed):
        self.cfg, self.key, self.i = cfg, jax.random.PRNGKey(seed), 0

    def __call__(self, i, S, N):
        assert i == self.i
        self.i += 1
        self.key, sub = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax_sample_noises(
            self.cfg, jax.random.split(sub, K), S, N, jnp.float32)))


@pytest.mark.parametrize("path", ZOO, ids=_name)
def test_zoo_bo20_matches(path, split):
    ref_ckpt = jax_load(path)
    state = ref_ckpt["g_state"]
    cfg = jax_config(ref_ckpt["args"], state)
    params = import_generator(state)
    pcfg, model = get_generator(load_checkpoint(path))
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(cfg)
    dset, jdset = _datasets(str(split / "zara1" / "test"), cfg.pred_len)
    assert len(dset) == len(jdset) > 2 * BATCH

    key = jax.random.PRNGKey(SEED)
    ref = {"loader": JAX_EVAL.evaluate(
               cfg, JaxDenseLoader(JaxDenseDataset(jdset), BATCH,
                                   shuffle=False),
               params, K, key=key),
           "bucketed": JAX_EVAL.evaluate_bucketed(
               cfg, jdset, params, K, batch_size=BATCH, n_buckets=3,
               key=key)}
    for impl in ("scan", "fused"):
        got = {"loader": evaluate(
                   model, DenseLoader(DenseDataset(dset), BATCH,
                                      shuffle=False),
                   K, noises=_JaxDraws(cfg, SEED), impl=impl,
                   device="cpu"),
               "bucketed": evaluate_bucketed(
                   model, dset, K, batch_size=BATCH, n_buckets=3,
                   noises=_JaxDraws(cfg, SEED), impl=impl, device="cpu")}
        for how in ref:
            np.testing.assert_allclose(got[how], ref[how], rtol=RTOL, atol=0,
                                       err_msg=f"{impl} {how}")
    assert all(np.isfinite(v).all() and v[0] > 0 for v in ref.values())


@pytest.mark.parametrize("name", ["zara1_12", "univ_12", "hotel_8"])
def test_get_generator_picks_the_scripts_state(name):
    """``--use_ema`` / ``--use_best`` pick the state the JAX script picks
    (``g_ema_state`` when present and asked for, then ``g_best_state``,
    else ``g_state``): the same config and, weight for weight, the same
    generator."""
    path = os.path.join(ROOT, f"models/grouptraj/{name}_with_model.pt")
    ckpt, ref_ckpt = load_checkpoint(path), jax_load(path)
    for use_best, use_ema in ((0, 0), (1, 0), (0, 1), (1, 1)):
        cfg, model = get_generator(ckpt, use_best, use_ema)
        jcfg, params = jax_get_generator(ref_ckpt, use_best, use_ema)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        want = params_from_jax(jax.device_get(params))
        got = model.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_default_draws_are_seeded(split):
    """Without injected noise the draws come from a torch.Generator seeded
    by ``seed``: the same seed gives the same numbers, another seed others
    (at the same estimator, so close)."""
    _, model = get_generator(load_checkpoint(ZOO[0]))
    dset, _ = _datasets(str(split / "zara1" / "test"), model.cfg.pred_len)
    run = lambda seed: evaluate_bucketed(model, dset, K, batch_size=BATCH,
                                         seed=seed, device="cpu")
    a, b, c = run(0), run(0), run(1)
    assert a == b and a != c
    np.testing.assert_allclose(a, c, rtol=0.2)


def test_evaluate_model_cli_runs_on_cpu(split):
    """``python -m grouptraj_torch.eval.evaluate_model`` on a zoo file
    prints the reference's result line with finite ADE/FDE equal (at the
    printed 2 decimals) to ``evaluate_bucketed`` at the CLI's seed."""
    path = os.path.join(ROOT, "models/grouptraj/zara1_12_gcnpool_with_model.pt")
    env = dict(os.environ, GROUPTRAJ_DATA_DIR=str(split), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "grouptraj_torch.eval.evaluate_model",
         "--model_path", path, "--device", "cpu", "--use_best", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    m = re.search(r"^Dataset: zara1, Pred Len: 12, ADE: (\S+), FDE: (\S+)$",
                  r.stdout, re.M)
    assert m, r.stdout
    ade, fde = float(m.group(1)), float(m.group(2))
    assert np.isfinite([ade, fde]).all() and ade > 0
    ckpt = load_checkpoint(path)
    _, model = get_generator(ckpt, use_best=True)
    dset, _ = _datasets(str(split / "zara1" / "test"), 12)
    want = evaluate_bucketed(model, dset, K, batch_size=64, device="cpu")
    assert (m.group(1), m.group(2)) == tuple(f"{v:.2f}" for v in want)
