"""Checkpoints in the JAX package's schema (counterpart of
``grouptraj/train/checkpoint.py``; reference ``scripts/train.py:246-271``).

One dict holds the arg snapshot, the per-key loss histories, the
timestamped metric histories, the grad-norm histories, the counters, the
current, best-by-ADE and best-by-ADE_nl states and both optimizer states;
it is written twice per event, ``<name>_with_model.pt`` and the
weights-stripped ``<name>_no_model.pt``, each by an atomic rename.
``g_state``/``d_state`` (and ``g_ema_state``) are torch-named numpy state
dicts and ``g_optim_state``/``d_optim_state`` optax states
(``compat.optax_from_adam``), so each package loads the other's files,
Adam moments included.

grouptraj pickles its optimizer states as optax classes. The port writes
its stand-ins for them (``compat.EmptyState``, ``compat.ScaleByAdamState``)
under optax's module and class names without importing optax, which the
port's machines need not have, and reads them back as the stand-ins; every
other ``optax.*`` / ``jax.*`` class in a file is stubbed, importing
nothing. numpy >= 2 module paths (``numpy._core``) map onto ``numpy.core``
where an older numpy lacks them. Reference PyTorch checkpoints (zip
archives or legacy torch pickles) go through ``torch.load``.
"""

from __future__ import annotations

import importlib.util
import io
import os
import pickle
from collections import defaultdict
from typing import Optional, Union

import numpy as np
import torch

from grouptraj_torch.compat.torch_import import (
    OPTAX_CLASSES, adam_from_optax, discriminator_state, generator_state,
    optax_from_adam,
)
from grouptraj_torch.config import ModelConfig, TrainConfig
from grouptraj_torch.models.discriminator import TrajectoryDiscriminator
from grouptraj_torch.models.generator import TrajectoryGenerator
from grouptraj_torch.train.steps import TrainState, train_state_from_modules
from grouptraj_torch.utils import resolve_device

KEY_BLACKLIST = [
    "g_state", "d_state", "g_best_state", "g_best_nl_state",
    "g_optim_state", "d_optim_state", "d_best_state", "d_best_nl_state",
    "g_ema_state",
]
_STATE_KEYS = ("g_state", "d_state", "g_best_state", "g_best_nl_state",
               "d_best_state", "d_best_nl_state")
_HISTORY_KEYS = ("G_losses", "D_losses", "metrics_val", "metrics_train")
_HAS_NUMPY_CORE = importlib.util.find_spec("numpy._core") is not None
_BY_OPTAX_NAME = {where: cls for cls, where in OPTAX_CLASSES.items()}


def new_checkpoint(args: dict) -> dict:
    """A fresh checkpoint dict (reference ``train.py:246-271``)."""
    return {
        "args": dict(args),
        "G_losses": defaultdict(list),
        "D_losses": defaultdict(list),
        "losses_ts": [],
        "metrics_val": defaultdict(list),
        "metrics_train": defaultdict(list),
        "sample_ts": [],
        "restore_ts": [],
        "norm_g": [],
        "norm_d": [],
        "counters": {"t": None, "epoch": None},
        "g_state": None, "g_optim_state": None,
        "d_state": None, "d_optim_state": None,
        "g_best_state": None, "d_best_state": None, "best_t": None,
        "g_best_nl_state": None, "d_best_nl_state": None, "best_t_nl": None,
    }


def _numpy_state(named) -> dict:
    """Tensors by name -> host numpy copies (later steps must not reach a
    saved state)."""
    return {k: v.detach().cpu().numpy().copy() for k, v in named}


def checkpoint_from_state(ckpt: dict, state: TrainState,
                          tcfg: TrainConfig) -> dict:
    """Write ``state``'s weights and optimizer moments into ``ckpt``."""
    ckpt["g_state"] = _numpy_state(state.g.state_dict().items())
    ckpt["d_state"] = _numpy_state(state.d.state_dict().items())
    ckpt["g_optim_state"] = optax_from_adam(
        state.g_opt, state.g, "generator", tcfg.clipping_threshold_g)
    ckpt["d_optim_state"] = optax_from_adam(
        state.d_opt, state.d, "discriminator", tcfg.clipping_threshold_d)
    if state.ema_g is not None:
        ckpt["g_ema_state"] = _numpy_state(state.ema_g.items())
    return ckpt


def state_from_checkpoint(ckpt: dict, cfg: ModelConfig, tcfg: TrainConfig,
                          device: Union[str, torch.device, None] = None
                          ) -> TrainState:
    """A TrainState on ``device`` (default ``cuda``) from a checkpoint of
    either package. Each optimizer resumes its saved Adam moments, or
    starts fresh when the file has none or their shapes do not match the
    model (grouptraj's ``_opt_compatible``). With ``g_ema_decay > 0`` the
    EMA resumes from ``g_ema_state``, or from the restored weights when
    the file has none."""
    dev = resolve_device(device)
    g = TrajectoryGenerator(cfg)
    g.load_state_dict(generator_state(ckpt["g_state"]))
    d = TrajectoryDiscriminator(cfg)
    d.load_state_dict(discriminator_state(ckpt["d_state"]))
    state = train_state_from_modules(g.to(dev), d.to(dev), tcfg)
    for opt_state, opt, module, kind in (
            (ckpt.get("g_optim_state"), state.g_opt, state.g, "generator"),
            (ckpt.get("d_optim_state"), state.d_opt, state.d,
             "discriminator")):
        if opt_state is not None:
            adam_from_optax(opt_state, opt, module, kind)
    if state.ema_g is not None and ckpt.get("g_ema_state") is not None:
        saved = generator_state(ckpt["g_ema_state"])
        state.ema_g = {k: saved[k].to(dev) for k in state.ema_g}
    return state


class _Pickler(pickle._Pickler):
    """Writes the optax stand-ins as a global by optax's names, without
    the import check that would fail where optax is absent."""

    def save_global(self, obj, name=None):
        where = OPTAX_CLASSES.get(obj)
        if where is None:
            return super().save_global(obj, name)
        self.save(where[0])
        self.save(where[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def save_checkpoint(ckpt: dict, output_dir: str, name: str) -> None:
    """Write ``<name>_with_model.pt`` and ``<name>_no_model.pt`` (the
    same dict without the :data:`KEY_BLACKLIST` entries) atomically."""
    os.makedirs(output_dir, exist_ok=True)
    _atomic_pickle(ckpt, os.path.join(output_dir, f"{name}_with_model.pt"))
    small = {k: v for k, v in ckpt.items() if k not in KEY_BLACKLIST}
    _atomic_pickle(small, os.path.join(output_dir, f"{name}_no_model.pt"))


def _atomic_pickle(obj, path: str) -> None:
    buf = io.BytesIO()
    _Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getbuffer())
    os.replace(tmp, path)


class _Stub(tuple):
    """Stand-in for an optax/jax class in a pickle: takes whatever the
    pickle passes and keeps it, importing nothing."""

    def __new__(cls, *args):
        return tuple.__new__(cls, args)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in ("optax", "jax", "jaxlib"):
            return _BY_OPTAX_NAME.get((module, name)) or type(
                name, (_Stub,), {"__module__": module})
        if module.startswith("numpy._core") and not _HAS_NUMPY_CORE:
            module = "numpy.core" + module[len("numpy._core"):]
        return super().find_class(module, name)


def _load_torch(path: str) -> dict:
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    for k in _STATE_KEYS:
        state = ckpt.get(k)
        if state is not None:
            ckpt[k] = {name: t.detach().cpu().numpy()
                       for name, t in state.items()}
    return ckpt


def load_checkpoint(path: str) -> Optional[dict]:
    """Load a grouptraj or port pickle, or a reference torch checkpoint ->
    dict, or None when the file does not exist. Weight states are
    torch-named numpy arrays in every case; the histories are
    ``defaultdict(list)``s."""
    if not os.path.isfile(path):
        return None
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic in (b"PK", b"\x80\x02"):
        ckpt = _load_torch(path)
    else:
        try:
            with open(path, "rb") as f:
                ckpt = _Unpickler(f).load()
        except (pickle.UnpicklingError, EOFError):
            ckpt = _load_torch(path)
    if not isinstance(ckpt, dict):
        raise pickle.UnpicklingError(f"not a checkpoint dict: {type(ckpt)}")
    for k in _STATE_KEYS:
        if ckpt.get(k) is not None:
            ckpt[k] = {name: np.asarray(v) for name, v in ckpt[k].items()}
    for k in _HISTORY_KEYS:
        if k in ckpt and not isinstance(ckpt[k], defaultdict):
            ckpt[k] = defaultdict(list, ckpt[k])
    return ckpt
