"""``data_loader(args, path)`` (counterpart of ``grouptraj/data/loader.py``;
reference ``sgan/data/loader.py``): ``(TrajectoryDataset, DenseLoader)``.
``args`` is anything with the reference's flag attributes (a TrainConfig,
an argparse Namespace, a class)."""

from __future__ import annotations

from grouptraj_torch.data.batching import DenseDataset, DenseLoader
from grouptraj_torch.data.dataset import TrajectoryDataset


def data_loader(args, path, shuffle: bool = True, group_required: bool = True):
    get = lambda name, default: getattr(args, name, default)
    dset = TrajectoryDataset(
        path,
        obs_len=get("obs_len", 8),
        pred_len=get("pred_len", 12),
        skip=get("skip", 1),
        delim=get("delim", "\t"),
        group_required=group_required,
    )
    dense = DenseDataset(dset, n_max=get("n_max", 0))
    loader = DenseLoader(
        dense,
        batch_size=get("batch_size", 64),
        shuffle=shuffle,
        seed=get("seed", 0),
    )
    return dset, loader
