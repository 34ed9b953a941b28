"""TrajectoryDataset: the eager in-RAM dataset of sliding windows
(counterpart of ``grouptraj/data/dataset.py``; reference
``sgan/data/trajectories_GCN.py:77-204``).

The whole split is windowed at construction. The ragged per-scene view is
kept for parity checks; evaluation and training consume the dense padded
arrays of :mod:`grouptraj_torch.data.batching`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from grouptraj_torch.data.reader import RawWindow, load_dir

Window = RawWindow


class TrajectoryDataset:
    def __init__(
        self,
        data_dir: str,
        obs_len: int = 8,
        pred_len: int = 12,
        skip: int = 1,
        threshold: float = 0.002,
        min_ped: int = 1,
        delim: str = "\t",
        group_required: bool = True,
        use_native: Optional[bool] = None,
    ):
        self.data_dir = data_dir
        self.obs_len = obs_len
        self.pred_len = pred_len
        self.seq_len = obs_len + pred_len
        self.skip = skip
        self.delim = delim
        self.windows: List[RawWindow] = load_dir(
            data_dir, obs_len, pred_len, skip, threshold, min_ped,
            group_required, use_native=use_native)
        self.num_seq = len(self.windows)

    def __len__(self) -> int:
        return self.num_seq

    @property
    def max_peds(self) -> int:
        return max((w.num_peds for w in self.windows), default=0)

    @property
    def total_peds(self) -> int:
        return sum(w.num_peds for w in self.windows)

    def __getitem__(self, index: int):
        """The reference's ragged item: obs/pred trajectories ``[n, 2, T]``
        (ped, xy, time), their relative steps, the velocities ``rel * 2.5``
        (2.5 fps), group labels ``[n, 1, T]``, non-linear flags and the
        loss mask."""
        w = self.windows[index]
        xy = np.transpose(w.xy, (0, 2, 1))        # [n, 2, T]
        rel = np.transpose(w.rel, (0, 2, 1))
        g = w.group[:, None, :]                   # [n, 1, T]
        o = self.obs_len
        return [
            xy[:, :, :o], xy[:, :, o:],
            rel[:, :, :o], rel[:, :, o:],
            rel[:, :, :o] * 2.5, rel[:, :, o:] * 2.5,
            g[:, :, :o], g[:, :, o:],
            w.non_linear, w.loss_mask,
        ]

    def scene_sizes(self) -> np.ndarray:
        return np.asarray([w.num_peds for w in self.windows], dtype=np.int32)

    def seq_start_end(self) -> List[Tuple[int, int]]:
        """Offsets of each scene in the reference's concatenated layout."""
        sizes = self.scene_sizes()
        cum = np.concatenate([[0], np.cumsum(sizes)])
        return [(int(s), int(e)) for s, e in zip(cum[:-1], cum[1:])]
