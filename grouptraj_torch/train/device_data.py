"""Device-resident dataset: upload once, index batches on the device
(counterpart of ``grouptraj/train/device_data.py``).

The ETH/UCY datasets are tiny dense-padded, so the whole dataset lives on
the device and every training iteration receives only integer scene
indices; the batch gather is an ``index_select`` on the device. An extra
all-zero "null scene" at index ``num_seq`` lets partial batches pad with
fully-masked scenes without host logic.

This module holds what the training step needs: :func:`gather_batch` and
the synthetic dataset the step is driven on where no dataset is present.
Bucketing and the index streams arrive with the training loop.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from grouptraj_torch.utils import resolve_device


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
