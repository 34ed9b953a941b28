"""The port's data layer against ``grouptraj.data``: windows, the ragged
dataset, dense arrays, batch order, ``data_loader`` and ``make_buckets``
are bit-identical (numpy both sides, the same arithmetic), on the
numpy and the native windowing paths.

Inputs: the conftest's ``tiny_dataset_dir`` (one 25-frame file, two groups,
a late joiner) and a directory of three synthetic ETH/UCY-format files
(``grouptraj_torch.data.synthetic``: pairs and triples sharing labels,
pedestrians joining and leaving) plus a 4-column file without labels.
"""

import os

import numpy as np
import pytest

from grouptraj.data import DenseDataset as JaxDenseDataset
from grouptraj.data import DenseLoader as JaxDenseLoader
from grouptraj.data import TrajectoryDataset as JaxTrajectoryDataset
from grouptraj.data import data_loader as jax_data_loader
from grouptraj.data.reader import extract_windows as jax_extract_windows
from grouptraj.data.reader import load_dir as jax_load_dir
from grouptraj.data.reader import read_file as jax_read_file
from grouptraj.train.device_data import make_buckets as jax_make_buckets
from grouptraj.utils import get_dset_path as jax_get_dset_path
from grouptraj_torch import utils
from grouptraj_torch.data import (
    DenseDataset, DenseLoader, TrajectoryDataset, data_loader,
    extract_windows, load_dir, read_file, windowing_backend,
)
from grouptraj_torch.data import _native
from grouptraj_torch.data.synthetic import write_scene_files
from grouptraj_torch.train.device_data import make_buckets

FIELDS = ("xy", "rel", "group", "non_linear", "loss_mask")


@pytest.fixture(scope="module")
def multi_dir(tmp_path_factory):
    """Three 5-column files (up to 14 present) and one 4-column file."""
    d = tmp_path_factory.mktemp("multi")
    write_scene_files(str(d), n_files=3, frames=70, max_peds=14, seed=3)
    with open(d / "zz_unlabeled.txt", "w") as f:
        for t in range(30):
            for ped in (1, 2, 3):
                f.write(f"{10.0 * t}\t{float(ped)}\t{0.1 * t + ped}\t"
                        f"{0.05 * t * ped}\n")
    return str(d)


@pytest.fixture(scope="module")
def labeled_dir(multi_dir, tmp_path_factory):
    """The three 5-column files alone."""
    d = tmp_path_factory.mktemp("labeled")
    for name in sorted(os.listdir(multi_dir))[:3]:
        os.symlink(os.path.join(multi_dir, name), d / name)
    return str(d)


def _same_windows(got, ref):
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        for k in FIELDS:
            x, y = getattr(a, k), getattr(b, k)
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=k)


def test_read_and_extract_windows_match(labeled_dir, tiny_dataset_dir):
    files = [os.path.join(tiny_dataset_dir, "scene.txt")] + [
        os.path.join(labeled_dir, f) for f in sorted(os.listdir(labeled_dir))]
    for path in files:
        data = read_file(path)
        np.testing.assert_array_equal(data, jax_read_file(path))
        for kw in ({}, {"skip": 2, "min_ped": 2}, {"obs_len": 8,
                                                   "pred_len": 8}):
            _same_windows(extract_windows(data, **kw),
                          jax_extract_windows(data, **kw))


@pytest.mark.parametrize("use_native", [False, True],
                         ids=["numpy", "native"])
def test_load_dir_matches(use_native, labeled_dir, tiny_dataset_dir):
    """Both paths of the port against the JAX package's numpy path."""
    for d in (tiny_dataset_dir, labeled_dir):
        got = load_dir(d, use_native=use_native)
        assert windowing_backend() == ("native" if use_native else "numpy")
        _same_windows(got, jax_load_dir(d, use_native=False))


@pytest.mark.parametrize("use_native", [False, True],
                         ids=["numpy", "native"])
def test_group_required(use_native, multi_dir):
    """A 4-column file raises "dataset has no labeling" as grouptraj
    does; without the requirement its labels are zeros and the labelled
    files keep theirs."""
    with pytest.raises(AssertionError, match="no labeling"):
        load_dir(multi_dir, use_native=use_native)
    with pytest.raises(AssertionError, match="no labeling"):
        jax_load_dir(multi_dir, use_native=False)
    got = load_dir(multi_dir, group_required=False, use_native=use_native)
    _same_windows(got, jax_load_dir(multi_dir, group_required=False,
                                    use_native=False))
    assert any(w.group.any() for w in got)
    assert not got[-1].group.any()


def test_native_unavailable_raises_only_when_asked(monkeypatch,
                                                   tiny_dataset_dir):
    """use_native=True raises when the library cannot be built; None takes
    the numpy path and says so."""
    monkeypatch.setattr(_native, "SRC", _native.SRC.with_name("missing.cpp"))
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_error", None)
    with pytest.raises(OSError, match="unavailable"):
        load_dir(tiny_dataset_dir, use_native=True)
    _same_windows(load_dir(tiny_dataset_dir),
                  jax_load_dir(tiny_dataset_dir, use_native=False))
    assert windowing_backend() == "numpy"


def test_dataset_items_match(labeled_dir, tiny_dataset_dir):
    for d in (tiny_dataset_dir, labeled_dir):
        dset = TrajectoryDataset(d)
        ref = JaxTrajectoryDataset(d, use_native=False)
        assert (len(dset), dset.max_peds, dset.total_peds) == (
            len(ref), ref.max_peds, ref.total_peds)
        np.testing.assert_array_equal(dset.scene_sizes(), ref.scene_sizes())
        assert dset.seq_start_end() == ref.seq_start_end()
        for i in range(len(dset)):
            for a, b in zip(dset[i], ref[i]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_max,subset", [(0, False), (64, False),
                                          (0, True)],
                         ids=["derived", "n_max64", "indices"])
def test_dense_dataset_matches(n_max, subset, labeled_dir):
    dset = TrajectoryDataset(labeled_dir)
    ref = JaxTrajectoryDataset(labeled_dir, use_native=False)
    idx = (np.random.default_rng(1).permutation(len(dset))[:17]
           if subset else None)
    got, want = (DenseDataset(dset, n_max, idx),
                 JaxDenseDataset(ref, n_max, idx))
    assert (got.n_max, got.num_seq) == (want.n_max, want.num_seq)
    for k in ("xy", "rel", "group", "non_linear", "loss_mask", "valid"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    with pytest.raises(ValueError):
        DenseDataset(dset, n_max=4)


def test_loader_batch_order_matches(labeled_dir):
    """Shuffled batches at a seed, two epochs, padding and drop_last."""
    dset = TrajectoryDataset(labeled_dir)
    ref = JaxTrajectoryDataset(labeled_dir, use_native=False)
    for kw in ({"batch_size": 8, "seed": 7},
               {"batch_size": 5, "shuffle": False},
               {"batch_size": 6, "seed": 2, "drop_last": True}):
        got = DenseLoader(DenseDataset(dset), **kw)
        want = JaxDenseLoader(JaxDenseDataset(ref), **kw)
        assert len(got) == len(want)
        for _ in range(2):
            batches = list(zip(got, want))
            assert len(batches) == len(want)
            for a, b in batches:
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
                np.testing.assert_array_equal(a.end_group, b.end_group)

    class Args:
        obs_len, pred_len, skip, batch_size, seed, n_max = 8, 12, 1, 4, 3, 0

    (d1, l1), (d2, l2) = (data_loader(Args, labeled_dir),
                          jax_data_loader(Args, labeled_dir))
    assert len(d1) == len(d2)
    for a, b in zip(l1, l2):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_make_buckets_matches(labeled_dir, tiny_dataset_dir):
    for d in (labeled_dir, tiny_dataset_dir):
        dset = TrajectoryDataset(d)
        ref = JaxTrajectoryDataset(d, use_native=False)
        for n_buckets, batch_size in ((1, 8), (2, 4), (3, 8), (3, 64),
                                      (5, 2)):
            got = make_buckets(dset, n_buckets, batch_size)
            want = jax_make_buckets(ref, n_buckets, batch_size)
            assert [w for w, _ in got] == [w for w, _ in want]
            for (_, a), (_, b) in zip(got, want):
                np.testing.assert_array_equal(a, b)


def test_utils(monkeypatch, tmp_path):
    assert utils.int_tuple("8") == (8,)
    assert utils.int_tuple("8,16") == (8, 16)
    assert utils.bool_flag("1") is True and utils.bool_flag("0") is False
    with pytest.raises(ValueError):
        utils.bool_flag("yes")
    (tmp_path / "zara1" / "test").mkdir(parents=True)
    monkeypatch.setenv("GROUPTRAJ_DATA_DIR", str(tmp_path))
    assert utils.get_dset_path("zara1", "test") == str(
        tmp_path / "zara1" / "test")
    # a missing split names the first candidate
    assert utils.get_dset_path("eth", "val") == str(tmp_path / "eth" / "val")
    for name, split in (("zara1", "test"), ("eth", "val")):
        assert utils.get_dset_path(name, split) == jax_get_dset_path(
            name, split)
