"""ETH/UCY txt parsing and sliding-window extraction (counterpart of
``grouptraj/data/reader.py``; reference ``sgan/data/trajectories_GCN.py``).

Pure numpy, with the reference's windowing semantics kept exactly:
full-presence filtering, 4-decimal rounding before the relative transform,
``min_ped`` strictly-greater filtering, the quadratic ``poly_fit``
non-linearity flag, the off-by-one extra window and the "dataset has no
labeling" assert. :func:`load_dir` takes the native engine
(:mod:`grouptraj_torch.data._native`) when it builds and this numpy path
otherwise; :func:`windowing_backend` says which one ran last.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import List, Optional

import numpy as np

from grouptraj_torch.data import _native

_backend: Optional[str] = None


def windowing_backend() -> Optional[str]:
    """``'native'`` or ``'numpy'``: the path the last :func:`load_dir`
    took (None before the first call)."""
    return _backend


def read_file(path: str, delim: str = "\t") -> np.ndarray:
    """Parse a tab (else whitespace) separated trajectory txt into a
    float64 array. The reference splits on tab whatever ``delim`` says."""
    rows = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) == 1:
                parts = line.split()
            rows.append([float(x) for x in parts])
    return np.asarray(rows, dtype=np.float64)


def poly_fit(traj: np.ndarray, traj_len: int, threshold: float) -> float:
    """1.0 if the last ``traj_len`` steps deviate from a least-squares
    quadratic: the x and y residuals summed reach ``threshold``."""
    t = np.linspace(0, traj_len - 1, traj_len)
    res_x = np.polyfit(t, traj[0, -traj_len:], 2, full=True)[1]
    res_y = np.polyfit(t, traj[1, -traj_len:], 2, full=True)[1]
    return 1.0 if res_x + res_y >= threshold else 0.0


@dataclasses.dataclass
class RawWindow:
    """One sliding window (a 'scene'): every ped present for the full
    window. Ped-major, time second: ``xy [n, T, 2]``; ``rel`` the
    frame-to-frame delta with 0 at t=0; ``group [n, T]``; ``non_linear
    [n]``; ``loss_mask [n, T]`` (all ones by construction)."""

    xy: np.ndarray
    rel: np.ndarray
    group: np.ndarray
    non_linear: np.ndarray
    loss_mask: np.ndarray

    @property
    def num_peds(self) -> int:
        return self.xy.shape[0]


def extract_windows(
    data: np.ndarray,
    obs_len: int = 8,
    pred_len: int = 12,
    skip: int = 1,
    threshold: float = 0.002,
    min_ped: int = 1,
    group_required: bool = True,
) -> List[RawWindow]:
    """Slide a ``seq_len``-frame window over one file's rows (columns
    frame, ped, x, y[, group]):
    - windows start every ``skip`` frames over
      ``range(0, num_sequences*skip+1, skip)`` (the reference's off-by-one
      extra window is kept);
    - a ped is kept iff it appears in ALL ``seq_len`` frames of the window;
    - coordinates are rounded to 4 decimals BEFORE the relative transform;
    - a window is kept iff strictly more than ``min_ped`` peds survive.
    Without a group column, ``group_required=True`` raises the reference's
    assert and ``False`` substitutes zeros."""
    seq_len = obs_len + pred_len
    out: List[RawWindow] = []
    if data.size == 0:
        return out
    if data.shape[1] < 5:
        if group_required:
            raise AssertionError("dataset has no labeling")
        data = np.concatenate(
            [data[:, :4], np.zeros((data.shape[0], 1))], axis=1)

    frames = np.unique(data[:, 0])
    frame_index = {f: i for i, f in enumerate(frames.tolist())}
    frame_data = [data[data[:, 0] == f] for f in frames]
    num_sequences = int(math.ceil((len(frames) - seq_len + 1) / skip))

    for idx in range(0, num_sequences * skip + 1, skip):
        window_frames = frame_data[idx:idx + seq_len]
        if not window_frames:
            continue
        curr = np.concatenate(window_frames, axis=0)
        peds = np.unique(curr[:, 1])
        xy_list, rel_list, g_list, nl_list = [], [], [], []
        for ped_id in peds:
            ped_rows = curr[curr[:, 1] == ped_id]
            ped_rows = np.around(ped_rows, decimals=4)
            pad_front = frame_index[ped_rows[0, 0]] - idx
            pad_end = frame_index[ped_rows[-1, 0]] - idx + 1
            if pad_end - pad_front != seq_len or ped_rows.shape[0] != seq_len:
                continue
            vals = ped_rows[:, 2:]            # [T, >=3] : x, y, group
            xy = vals[:, :2]
            rel = np.zeros_like(xy)
            rel[1:] = xy[1:] - xy[:-1]
            xy_list.append(xy)
            rel_list.append(rel)
            g_list.append(vals[:, 2])
            nl_list.append(poly_fit(vals.T, pred_len, threshold))
        n = len(xy_list)
        if n > min_ped:
            out.append(RawWindow(
                xy=np.stack(xy_list).astype(np.float32),
                rel=np.stack(rel_list).astype(np.float32),
                group=np.stack(g_list).astype(np.float32),
                non_linear=np.asarray(nl_list, dtype=np.float32),
                loss_mask=np.ones((n, seq_len), dtype=np.float32),
            ))
    return out


def load_dir(
    data_dir: str,
    obs_len: int = 8,
    pred_len: int = 12,
    skip: int = 1,
    threshold: float = 0.002,
    min_ped: int = 1,
    group_required: bool = True,
    use_native: Optional[bool] = None,
) -> List[RawWindow]:
    """Windows of every file in a directory, files in sorted order.

    ``use_native``: None takes the native engine when its library builds
    and the numpy path otherwise; True requires the native engine (raises
    OSError when it cannot be built); False takes the numpy path."""
    global _backend
    files = sorted(
        os.path.join(data_dir, f) for f in os.listdir(data_dir)
        if os.path.isfile(os.path.join(data_dir, f)))
    if use_native is None:
        use_native = _native.available()
    elif use_native and not _native.available():
        raise OSError(f"use_native=True, but the native windowing library "
                      f"is unavailable: {_native.error()}")
    windows: List[RawWindow] = []
    for path in files:
        if use_native:
            windows.extend(_native.extract_windows_file(
                path, obs_len, pred_len, skip, threshold, min_ped,
                group_required))
        else:
            windows.extend(extract_windows(
                read_file(path), obs_len, pred_len, skip, threshold,
                min_ped, group_required))
    _backend = "native" if use_native else "numpy"
    return windows
