"""Scene-padded dense batching (counterpart of
``grouptraj/data/batching.py``).

A batch is a set of fixed-shape numpy arrays ``[S, N_max, ...]`` with a
validity mask, in place of the reference's concatenated pedestrian axis
with ``seq_start_end`` offsets. The arrays stay numpy here; the evaluation
moves each batch to the device.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional, Sequence

import numpy as np

from grouptraj_torch.data.dataset import TrajectoryDataset
from grouptraj_torch.utils import round_up


class DenseBatch(NamedTuple):
    """One dense batch. S = scenes, N = padded peds/scene, To/Tp = obs/pred
    len. float32 throughout; ``valid`` marks real pedestrians and padded
    entries are zero. The model takes ``obs_g[..., -1]`` as the group
    label."""

    obs: np.ndarray        # [S, N, To, 2] absolute positions
    pred: np.ndarray       # [S, N, Tp, 2]
    obs_rel: np.ndarray    # [S, N, To, 2]
    pred_rel: np.ndarray   # [S, N, Tp, 2]
    obs_g: np.ndarray      # [S, N, To]
    pred_g: np.ndarray     # [S, N, Tp]
    non_linear: np.ndarray  # [S, N]
    loss_mask: np.ndarray  # [S, N, To+Tp]
    valid: np.ndarray      # [S, N] float32 {0,1}

    @property
    def end_pos(self) -> np.ndarray:
        return self.obs[..., -1, :]

    @property
    def end_group(self) -> np.ndarray:
        return self.obs_g[..., -1]

    @property
    def num_peds(self) -> np.ndarray:
        return self.valid.sum()


class DenseDataset:
    """A dataset (or the ``indices`` subset of its windows) pre-padded into
    contiguous dense arrays; batching is then fancy-indexing."""

    def __init__(self, dset: TrajectoryDataset, n_max: int = 0,
                 indices: Optional[Sequence[int]] = None):
        """``n_max`` <= 0 pads to the largest scene rounded up to 8 (at
        least 8); a smaller ``n_max`` than the largest scene raises."""
        self.obs_len, self.pred_len = dset.obs_len, dset.pred_len
        T = dset.seq_len
        windows = (dset.windows if indices is None
                   else [dset.windows[i] for i in indices])
        max_peds = max((w.num_peds for w in windows), default=1)
        if n_max <= 0:
            n_max = max(8, round_up(max_peds, 8))
        if max_peds > n_max:
            raise ValueError(
                f"n_max={n_max} < largest scene ({max_peds} peds)")
        self.n_max = n_max
        S = len(windows)
        self.num_seq = S
        self.xy = np.zeros((S, n_max, T, 2), np.float32)
        self.rel = np.zeros((S, n_max, T, 2), np.float32)
        self.group = np.zeros((S, n_max, T), np.float32)
        self.non_linear = np.zeros((S, n_max), np.float32)
        self.loss_mask = np.zeros((S, n_max, T), np.float32)
        self.valid = np.zeros((S, n_max), np.float32)
        for i, w in enumerate(windows):
            n = w.num_peds
            self.xy[i, :n] = w.xy
            self.rel[i, :n] = w.rel
            self.group[i, :n] = w.group
            self.non_linear[i, :n] = w.non_linear
            self.loss_mask[i, :n] = w.loss_mask
            self.valid[i, :n] = 1.0

    def gather(self, idx: Sequence[int], pad_to: Optional[int] = None
               ) -> DenseBatch:
        """A DenseBatch of the scenes ``idx``, padded with all-invalid
        scenes to ``pad_to`` scenes when given."""
        idx = np.asarray(idx, dtype=np.int64)
        o = self.obs_len
        take = lambda a: a[idx]
        xy, rel, g = take(self.xy), take(self.rel), take(self.group)
        nl, lm, v = take(self.non_linear), take(self.loss_mask), take(self.valid)
        if pad_to is not None and len(idx) < pad_to:
            pad = pad_to - len(idx)
            zf = lambda a: np.concatenate(
                [a, np.zeros((pad,) + a.shape[1:], a.dtype)], axis=0)
            xy, rel, g, nl, lm, v = map(zf, (xy, rel, g, nl, lm, v))
        return DenseBatch(
            obs=xy[:, :, :o], pred=xy[:, :, o:],
            obs_rel=rel[:, :, :o], pred_rel=rel[:, :, o:],
            obs_g=g[:, :, :o], pred_g=g[:, :, o:],
            non_linear=nl, loss_mask=lm, valid=v)


class DenseLoader:
    """Fixed-shape batch iterator: every batch has ``batch_size`` scene
    slots, the last partial one padded with invalid scenes (or dropped with
    ``drop_last``). The shuffle draws from ``np.random.default_rng(seed)``,
    so the batch order equals the JAX package's at the same seed."""

    def __init__(self, dense: DenseDataset, batch_size: int = 64,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False):
        self.dense = dense
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n, b = self.dense.num_seq, self.batch_size
        return n // b if self.drop_last else -(-n // b)

    def __iter__(self) -> Iterator[DenseBatch]:
        order = np.arange(self.dense.num_seq)
        if self.shuffle:
            self._rng.shuffle(order)
        b = self.batch_size
        for start in range(0, len(order), b):
            chunk = order[start:start + b]
            if len(chunk) < b and self.drop_last:
                return
            yield self.dense.gather(chunk, pad_to=b)
