"""Small utilities (counterparts of ``grouptraj/utils.py``)."""

from __future__ import annotations

import os
from typing import Optional, Union

import torch


def int_tuple(s: str) -> tuple:
    """argparse type: '8' or '8,16' -> (8,) / (8, 16)."""
    return tuple(int(i) for i in s.split(","))


def bool_flag(s: str) -> bool:
    """argparse type accepting '0'/'1'."""
    if s == "1":
        return True
    if s == "0":
        return False
    raise ValueError('Invalid value "%s" for bool flag (should be 0 or 1)' % s)


def get_dset_path(dset_name: str, dset_type: str) -> str:
    """Resolve a dataset split directory ``<root>/<name>/<split>``. The
    roots, in order: ``GROUPTRAJ_DATA_DIR``, ``<repo>/datasets_group`` and
    the reference's read-only dataset mount, the JAX package's candidates.
    When none holds the split, the path under the first root is returned,
    so the error that follows names it."""
    candidates = []
    env = os.environ.get("GROUPTRAJ_DATA_DIR")
    if env:
        candidates.append(env)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    candidates.append(os.path.join(here, "datasets_group"))
    candidates.append("/root/reference/datasets_group")
    for root in candidates:
        path = os.path.join(root, dset_name, dset_type)
        if os.path.isdir(path):
            return path
    return os.path.join(candidates[0], dset_name, dset_type)


def relative_to_abs(rel_traj: torch.Tensor, start_pos: torch.Tensor
                    ) -> torch.Tensor:
    """Cumulative-sum relative displacements onto a start position
    (``grouptraj/utils.py:relative_to_abs``): rel_traj [..., T, 2],
    start_pos [..., 2] -> [..., T, 2] absolute positions."""
    return torch.cumsum(rel_traj, dim=-2) + start_pos[..., None, :]


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for (or implied) and absent — the
    port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev
