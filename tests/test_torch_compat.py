"""The port's checkpoint loading and weight carry-over against the JAX
package, and the port's independence from it.

- ``params_from_jax`` equals ``grouptraj.compat.export_state_dicts`` key
  for key (exact: both only transpose and copy);
- every zoo checkpoint loads through the port's own unpickler (no optax,
  no JAX) and resolves to the same config as in grouptraj;
- every file (``gat``, ``gat-mh``, ``gcn-pool``) builds a Predictor with
  the checkpoint's weights that predicts finite positions;
- a JAX ``TrainState``'s generator and discriminator trees round-trip
  through ``params_from_jax`` into the port's modules and back out of
  their ``tree()`` views;
- importing the port (and running chip_smoke.py without a card) loads
  none of jax, optax or grouptraj; the source scan names the modules it
  must have seen.
"""

import ast
import dataclasses
import glob
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from grouptraj.compat import config_from_checkpoint_args as jax_config
from grouptraj.compat import import_generator
from grouptraj.compat.torch_import import export_state_dicts
from grouptraj.config import MODEL_PRESETS
from grouptraj.models import init_generator
from grouptraj.train.checkpoint import load_checkpoint as jax_load
from grouptraj.config import TrainConfig as JaxTrainConfig
from grouptraj.train.steps import init_train_state as jax_init_train_state
from grouptraj_torch.compat import (
    config_from_checkpoint_args, discriminator_state, generator_state,
    params_from_jax,
)
from grouptraj_torch.config import MODEL_PRESETS as PORT_PRESETS
from grouptraj_torch.config import ModelConfig
from grouptraj_torch.models.discriminator import TrajectoryDiscriminator
from grouptraj_torch.models.generator import TrajectoryGenerator
from grouptraj_torch.serve import Predictor
from grouptraj_torch.train.checkpoint import load_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = sorted(glob.glob(os.path.join(ROOT, "models/grouptraj/*.pt")))
GAT_ZOO = {"eth_12", "eth_8", "hotel_12", "hotel_8", "univ_12_gat",
           "zara1_12", "zara1_8", "zara2_12_gat", "zara2_8"}
FORBIDDEN = ("jax", "jaxlib", "optax", "grouptraj")


def _name(path):
    return os.path.basename(path)[:-len("_with_model.pt")]


def test_params_from_jax_matches_export_state_dicts():
    params = jax.device_get(init_generator(jax.random.PRNGKey(0),
                                           MODEL_PRESETS["gat"]))
    ref = export_state_dicts(params, "generator")
    out = params_from_jax(params)
    assert list(out) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    # and the port's generator takes exactly these names and shapes
    sd = TrajectoryGenerator(MODEL_PRESETS["gat"]).state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: v.shape for k, v in out.items()}


def test_params_from_jax_rejects_other_presets():
    """Every preset's tree is ported, a batch_norm MLP's too: the
    ``gcn`` preset with batch_norm (its context MLP's BatchNorm1d entries
    at make_mlp's indices, the running statistics 0 and 1) bridges to
    exactly ``export_state_dicts``' names, order and values, which the
    port's generator takes."""
    cfg = dataclasses.replace(MODEL_PRESETS["gcn"], batch_norm=True)
    params = jax.device_get(init_generator(jax.random.PRNGKey(0), cfg))
    ref = export_state_dicts(params, "generator")
    out = params_from_jax(params)
    assert list(out) == list(ref)
    assert any(k.endswith(".running_mean") for k in out)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    port_cfg = dataclasses.replace(PORT_PRESETS["gcn"], batch_norm=True)
    sd = TrajectoryGenerator(port_cfg).state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: v.shape for k, v in out.items()}


def test_train_state_bridge_round_trips():
    """G and D of a JAX TrainState load into the port's modules, whose
    JAX-shaped ``tree()`` views then hold the JAX leaves again, exactly."""
    state = jax_init_train_state(jax.random.PRNGKey(3), MODEL_PRESETS["gat"],
                                 JaxTrainConfig())
    g, d = TrajectoryGenerator(ModelConfig()), TrajectoryDiscriminator(
        ModelConfig())
    g.load_state_dict(generator_state(
        params_from_jax(jax.device_get(state.g_params))))
    d.load_state_dict(discriminator_state(
        params_from_jax(jax.device_get(state.d_params), "discriminator")))
    for module, ref in ((g, state.g_params), (d, state.d_params)):
        got, treedef = jax.tree_util.tree_flatten(module.tree())
        want, ref_def = jax.tree_util.tree_flatten(ref)
        assert treedef == ref_def
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    with pytest.raises(NotImplementedError):
        params_from_jax(jax.device_get(state.g_params), "discriminator")
    with pytest.raises(ValueError):
        params_from_jax(jax.device_get(state.g_params), "critic")


def test_zoo_loads_and_configs_match():
    assert len(ZOO) == 15
    for path in ZOO:
        ckpt, ref = load_checkpoint(path), jax_load(path)
        for key in ("g_state", "g_best_state"):
            assert ckpt[key].keys() == ref[key].keys(), (path, key)
            for k, v in ref[key].items():
                np.testing.assert_array_equal(ckpt[key][k], v)
        cfg = config_from_checkpoint_args(ckpt["args"], ckpt["g_best_state"])
        jcfg = jax_config(ref["args"], ref["g_best_state"])
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), path
        assert (cfg.graph_module == "gat") == (_name(path) in GAT_ZOO)


@pytest.mark.parametrize("path", ZOO, ids=_name)
def test_zoo_predictor(path):
    p = Predictor.from_checkpoint(path, num_samples=2, param_dtype=None,
                                  device="cpu")
    # the loaded weights are the checkpoint's, dead gcn_module keys aside
    ref = params_from_jax(jax.device_get(
        import_generator(jax_load(path)["g_best_state"])))
    sd = p.model.state_dict()
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    xy = np.cumsum(np.full((3, 8, 2), 0.1, np.float32), axis=1)
    out = p.predict(xy)
    assert out.shape == (2, 3, p.cfg.pred_len, 2) and np.isfinite(out).all()


# modules of the data, eval and graph slice the walk must import
NEW_MODULES = ("grouptraj_torch.data.reader", "grouptraj_torch.data._native",
               "grouptraj_torch.data.dataset", "grouptraj_torch.data.batching",
               "grouptraj_torch.data.loader", "grouptraj_torch.data.synthetic",
               "grouptraj_torch.eval.evaluate",
               "grouptraj_torch.eval.evaluate_model",
               "grouptraj_torch.ops.gcn", "grouptraj_torch.ops.gat",
               "grouptraj_torch.models.modules", "grouptraj_torch.train.loop",
               "grouptraj_torch.train.cli", "grouptraj_torch.train.multi",
               "grouptraj_torch.train.cli_many")


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys, grouptraj_torch\n"
        "for m in pkgutil.walk_packages(grouptraj_torch.__path__,"
        " 'grouptraj_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules"
        f" if m.split('.')[0] in {FORBIDDEN!r})\n"
        f"missing = [m for m in {NEW_MODULES!r} if m not in sys.modules]\n"
        "print(bad, missing)\n"
        "sys.exit(1 if bad or missing else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax():
    """Lazy imports inside functions included."""
    files = glob.glob(os.path.join(ROOT, "grouptraj_torch/**/*.py"),
                      recursive=True) + [os.path.join(ROOT, "chip_smoke.py")]
    seen = {os.path.relpath(f, ROOT) for f in files}
    assert {"chip_smoke.py", "grouptraj_torch/losses.py",
            "grouptraj_torch/models/discriminator.py",
            "grouptraj_torch/train/steps.py",
            "grouptraj_torch/train/device_data.py",
            "grouptraj_torch/ops/cuda_pool.py",
            "grouptraj_torch/ops/lstm.py"} | {
                m.replace(".", "/") + ".py" for m in NEW_MODULES} <= seen
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] not in FORBIDDEN, (path, mod)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA chip_smoke.py exits non-zero and prints no result;
    copied alone into an empty directory it fails the same way."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok": true' not in r.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    r = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok": true' not in r.stdout
