"""Device-resident dataset: upload once, index batches on the device
(counterpart of ``grouptraj/train/device_data.py``).

The ETH/UCY datasets are tiny dense-padded, so the whole dataset lives on
the device and every training iteration receives only integer scene
indices; the batch gather is an ``index_select`` on the device. An extra
all-zero "null scene" at index ``num_seq`` lets partial batches pad with
fully-masked scenes without host logic.

:func:`device_dataset` uploads a dense dataset, :func:`gather_batch`
assembles a batch from it, and :func:`synthetic_device_data` stands in
where no dataset is present. The training loop's index streams,
:class:`IndexStream` and the scene-size :class:`BucketScheduler` over
:func:`make_buckets`, draw with numpy's ``default_rng`` exactly as the JAX
package's do, so both packages visit the same scenes in the same order.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from grouptraj_torch.utils import resolve_device, round_up


def device_dataset(dense, obs_len: int,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Dict[str, torch.Tensor]:
    """Upload a DenseDataset to ``device`` (default ``cuda``), with the
    all-zero null scene appended at index ``num_seq``."""
    dev = resolve_device(device)
    pad1 = lambda a: np.concatenate(
        [a, np.zeros((1,) + a.shape[1:], a.dtype)], axis=0)
    arrays = {
        "xy": dense.xy, "rel": dense.rel,
        "group_end": dense.group[:, :, obs_len - 1],
        "loss_mask": dense.loss_mask, "non_linear": dense.non_linear,
        "valid": dense.valid,
    }
    return {k: torch.from_numpy(pad1(v)).to(dev) for k, v in arrays.items()}


def gather_batch(data: Dict[str, torch.Tensor], idx: torch.Tensor,
                 obs_len: int) -> Dict[str, torch.Tensor]:
    """Batch assembly on the device from scene indices ``[S]``."""
    take = lambda a: a.index_select(0, idx)
    xy, rel = take(data["xy"]), take(data["rel"])
    return dict(
        obs=xy[:, :, :obs_len], pred=xy[:, :, obs_len:],
        obs_rel=rel[:, :, :obs_len], pred_rel=rel[:, :, obs_len:],
        group=take(data["group_end"]),
        valid=take(data["valid"]),
        loss_mask=take(data["loss_mask"]),
        non_linear=take(data["non_linear"]),
    )


def synthetic_device_data(num_seq: int, N: int, obs_len: int = 8,
                          pred_len: int = 12, seed: int = 0,
                          device: Optional[Union[str, torch.device]] = None
                          ) -> Dict[str, torch.Tensor]:
    """A synthetic dataset on ``device`` (default ``cuda``), made with numpy
    from ``seed``, with the schema and the values of
    ``grouptraj.parallel.data_parallel.synthetic_device_data`` (the trailing
    all-zero null scene included): random-walk trajectories of scale 0.1,
    the second half of each scene's slots valid with probability 0.7, group
    labels in {0, 1, 2}."""
    dev = resolve_device(device)
    r = np.random.default_rng(seed)
    T = obs_len + pred_len
    rel = r.normal(scale=0.1, size=(num_seq, N, T, 2)).astype(np.float32)
    xy = np.cumsum(rel, axis=2)
    valid = np.ones((num_seq, N), np.float32)
    valid[:, N // 2:] = (r.random((num_seq, N - N // 2)) > 0.3)
    group = (r.integers(0, 3, (num_seq, N)) * valid).astype(np.float32)
    non_linear = ((r.random((num_seq, N)) > 0.5) * valid).astype(np.float32)
    pad1 = lambda a: np.concatenate(
        [a, np.zeros((1,) + a.shape[1:], np.float32)], axis=0)
    arrays = {
        "xy": xy, "rel": rel, "group_end": group,
        "loss_mask": np.repeat(valid[:, :, None], T, 2),
        "non_linear": non_linear, "valid": valid,
    }
    return {k: torch.from_numpy(pad1(v)).to(dev) for k, v in arrays.items()}


def make_buckets(dset, n_buckets: int, batch_size: int):
    """Partition a dataset's window indices into at most ``n_buckets`` by
    pedestrian count -> ``[(width, indices), ...]`` sorted by width.
    Widths are the count quantiles rounded up to 8 (the largest scene's
    among them); a bucket with fewer scenes than one batch merges into the
    next wider one, so every batch pads only to its bucket's width."""
    counts = np.array([w.num_peds for w in dset.windows])
    top = max(8, round_up(int(counts.max()), 8))
    if n_buckets <= 1:
        return [(top, np.arange(len(counts)))]
    qs = np.quantile(counts, [(i + 1) / n_buckets
                              for i in range(n_buckets - 1)])
    widths = sorted({max(8, round_up(int(q), 8)) for q in qs} | {top})
    buckets = []
    prev = 0
    carry = np.array([], dtype=np.int64)
    for w in widths:
        idx = np.nonzero((counts > prev) & (counts <= w))[0]
        idx = np.concatenate([carry, idx])
        prev = w
        if len(idx) < batch_size and w != widths[-1]:
            carry = idx                      # too small: merge upward
            continue
        carry = np.array([], dtype=np.int64)
        if len(idx):
            buckets.append((w, idx))
    if len(carry):
        if buckets:
            w, idx = buckets[-1]
            buckets[-1] = (w, np.concatenate([idx, carry]))
        else:
            buckets.append((widths[-1], carry))
    return buckets


class BucketScheduler:
    """Deficit scheduler over per-bucket index streams: each dispatch draws
    ``chunk × steps_per_iter`` batches from ONE bucket (so a dispatch runs
    at that bucket's pad width), the bucket with the least progress
    relative to its share of the scenes, so that in the long run every
    scene is visited at the rate of unbucketed shuffling."""

    def __init__(self, bucket_sizes, batch_size: int, seed: int = 0):
        self.weights = [max(s, 1) for s in bucket_sizes]
        self.total = sum(self.weights)
        self.streams = [iter(IndexStream(s, batch_size, seed=seed + 977 * b))
                        for b, s in enumerate(bucket_sizes)]
        self.done = [0] * len(bucket_sizes)
        # one aggregate "epoch" = the batches one shuffle of every bucket
        # yields, IndexStream's definition unbucketed
        self._batches = 0
        self._batches_per_epoch = sum(
            -(-max(s, 1) // batch_size) for s in bucket_sizes)

    @property
    def epoch(self) -> int:
        """1-based; increments when the aggregate stream starts a new pass
        over every scene."""
        return 1 + self._batches // self._batches_per_epoch

    def next_dispatch(self, chunk: int, steps_per_iter: int):
        """-> (bucket id, ``[chunk, steps_per_iter, batch_size]`` int32
        scene indices into that bucket's dataset)."""
        b = min(range(len(self.done)),
                key=lambda i: self.done[i] / self.weights[i])
        idx = np.stack([
            np.stack([next(self.streams[b]) for _ in range(steps_per_iter)])
            for _ in range(chunk)])
        self.done[b] += chunk
        self._batches += chunk * steps_per_iter
        return b, idx


class IndexStream:
    """Continuous epoch-reshuffled stream of ``[batch_size]`` int32
    scene-index arrays; a partial tail pads with the null-scene index.
    ``epoch`` counts the shuffles started."""

    def __init__(self, num_seq: int, batch_size: int, seed: int = 0,
                 shuffle: bool = True):
        self.num_seq = num_seq
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self.epoch = 0

    def __iter__(self):
        while True:
            order = np.arange(self.num_seq)
            if self.shuffle:
                self._rng.shuffle(order)
            self.epoch += 1
            for start in range(0, self.num_seq, self.batch_size):
                chunk = order[start:start + self.batch_size]
                if len(chunk) < self.batch_size:
                    pad = np.full(self.batch_size - len(chunk), self.num_seq,
                                  dtype=np.int64)
                    chunk = np.concatenate([chunk, pad])
                yield chunk.astype(np.int32)
