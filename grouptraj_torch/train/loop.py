"""Training loop: the alternating D/G schedule with validation checkpoints
(counterpart of ``grouptraj/train/loop.py``; reference
``scripts/train.py:142-392``).

An iteration is ``d_steps`` discriminator updates then ``g_steps``
generator updates, each on its own batch. The whole dense dataset lives on
the device and each dispatch of ``steps_per_dispatch`` iterations is one
:func:`steps.train_iterations` call on integer scene indices, drawn by the
same numpy streams as the JAX package's (scene-size buckets by default).
The losses stay on the device until a print event; the grad norms are read
back in bulk. Every ``print_every`` iterations the last losses are logged,
every ``checkpoint_every`` the val and train metric sweeps run, the best
states by val ADE and ADE_nl are kept and both checkpoint files are
written; the final save follows the loop. A resumed run keeps
``restore_ts`` and offsets its epoch by the restored one.

Randomness goes through a seam: without ``draws`` every draw comes from a
``torch.Generator`` seeded with ``tcfg.seed`` (after the initial weights);
a :class:`Draws` replaces each dispatch's per-iteration draws and each
sweep's per-batch draws, so a test can inject the JAX package's.

Runs on ``cuda`` unless ``device`` names another device; the LSTM route is
``select_impl(cfg, tcfg)``.

Data parallelism over scenes (``num_devices > 1``, ``parallel/mesh.py``):
one process a rank, in a process group of ``num_devices`` ranks made
before the call (``torchrun`` with ``train.cli``, or
``parallel.data_parallel.spawn``). ``num_devices=0`` is the group's world
size, else every visible CUDA device (1 on the CPU), as the JAX package's
0 is every device of its one process; but the port runs one process a
rank, so several cards without a group raise with the launch recipe.
Every rank builds the same index streams and runs each dispatch on its
block of every batch's scenes, the steps summing over the ranks; the
metric sweeps run on each rank's block of each batch and sum their sums;
rank 0 alone writes the files (checkpoints and profiler traces), and every
rank loads a resumed one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from grouptraj_torch.config import ModelConfig, TrainConfig
from grouptraj_torch.data.batching import DenseDataset, DenseLoader
from grouptraj_torch.data.dataset import TrajectoryDataset
from grouptraj_torch.ops.lstm import select_impl
from grouptraj_torch.parallel.mesh import (
    DPGroup, barrier, get_dp_group, is_writer, replicate_state,
    set_dp_group, shard_scenes, world_group,
)
from grouptraj_torch.train import checkpoint as ckpt_lib
from grouptraj_torch.train.device_data import (
    BucketScheduler, IndexStream, device_dataset, make_buckets,
)
from grouptraj_torch.train.steps import (
    SweepDraws, init_train_state, make_check_accuracy_sweep, read_sums,
    summarize_check_accuracy, train_iterations,
)
from grouptraj_torch.utils import get_dset_path, resolve_device, round_up

logger = logging.getLogger(__name__)

# iterations traced with TrainConfig.profile_dir
PROFILE_ITERS = (50, 60)


class Draws:
    """The loop's randomness seam, called in the loop's order:
    :meth:`iterations` once per dispatch, :meth:`sweeps` once per
    checkpoint event."""

    def iterations(self, n: int) -> Sequence[dict]:
        """The draws of the dispatch's ``n`` iterations, one
        ``{"d": [...], "g": [...]}`` each (``steps.train_iterations``)."""
        raise NotImplementedError

    def sweeps(self) -> Tuple[SweepDraws, SweepDraws]:
        """The val sweep's and the train sweep's per-batch draws."""
        raise NotImplementedError


def build_loaders(cfg: ModelConfig, tcfg: TrainConfig):
    """Train and val loaders sharing one padded width."""
    train_path = get_dset_path(tcfg.dataset_name, "train")
    val_path = get_dset_path(tcfg.dataset_name, "val")
    logger.info("Initializing train dataset")
    train_dset = TrajectoryDataset(train_path, cfg.obs_len, cfg.pred_len,
                                   tcfg.skip, delim=tcfg.delim)
    logger.info("Initializing val dataset")
    val_dset = TrajectoryDataset(val_path, cfg.obs_len, cfg.pred_len,
                                 tcfg.skip, delim=tcfg.delim)
    n_max = tcfg.n_max or max(
        8, round_up(max(train_dset.max_peds, val_dset.max_peds), 8))
    train_loader = DenseLoader(DenseDataset(train_dset, n_max),
                               tcfg.batch_size, shuffle=True, seed=tcfg.seed)
    val_loader = DenseLoader(DenseDataset(val_dset, n_max), tcfg.batch_size,
                             shuffle=False)
    return train_dset, train_loader, val_loader


def _sweep_indices(num_seq: int, batch_size: int,
                   order: Optional[np.ndarray] = None) -> np.ndarray:
    """``[n_batches, batch_size]`` int32 scene indices covering ``order``
    (or 0..num_seq), the partial tail padded with the null-scene index."""
    if order is None:
        order = np.arange(num_seq)
    nb = max(1, -(-len(order) // batch_size))
    pad = nb * batch_size - len(order)
    full = np.concatenate([order, np.full(pad, num_seq, dtype=order.dtype)])
    return full.astype(np.int32).reshape(nb, batch_size)


def make_train_eval_subset(tcfg: TrainConfig, train_dense):
    """The train-split sweep's size: a fixed batch count covering about
    ``num_samples_check`` valid trajectories. Returns ``(eval_rng,
    nb_limit)``; each event draws its subset order from ``eval_rng``."""
    eval_rng = np.random.default_rng(tcfg.seed + 7919)
    valid_per_scene = train_dense.valid.sum(axis=1)
    csum = np.cumsum(valid_per_scene[eval_rng.permutation(
        train_dense.num_seq)])
    need = int(np.searchsorted(csum, tcfg.num_samples_check) + 1)
    nb_limit = max(1, -(-min(need, train_dense.num_seq)
                        // tcfg.batch_size))
    return eval_rng, nb_limit


class DispatchSource:
    """Training-batch index source: scene-size buckets (``sched``/``datas``/
    ``buckets``) or one shuffled stream at one width (``stream``/``data``).
    ``tcfg`` is the possibly adjusted config (an explicit ``n_max`` turns
    the buckets off)."""

    def __init__(self, tcfg, sched=None, datas=None, buckets=None,
                 stream=None, data=None):
        self.tcfg = tcfg
        self.sched = sched
        self.datas = datas
        self.buckets = buckets
        self.stream = stream
        self.index_iter = iter(stream) if stream is not None else None
        self.data = data


def make_dispatch_source(cfg: ModelConfig, tcfg: TrainConfig, train_dset,
                         train_loader, device=None) -> DispatchSource:
    dev = resolve_device(device)
    if tcfg.n_max and tcfg.n_buckets > 1:
        # an explicit n_max asks for one fixed pad width
        logger.info("--n_max %d set: disabling scene-size buckets and "
                    "padding every batch to that width", tcfg.n_max)
        tcfg = dataclasses.replace(tcfg, n_buckets=1)
    if tcfg.n_buckets > 1:
        buckets = make_buckets(train_dset, tcfg.n_buckets, tcfg.batch_size)
        datas = [device_dataset(DenseDataset(train_dset, w, indices=idx),
                                cfg.obs_len, dev) for w, idx in buckets]
        sched = BucketScheduler([len(idx) for _, idx in buckets],
                                tcfg.batch_size, seed=tcfg.seed)
        logger.info("Scene-size buckets (width, scenes): %s",
                    [(w, len(i)) for w, i in buckets])
        return DispatchSource(tcfg, sched=sched, datas=datas,
                              buckets=buckets)
    data = device_dataset(train_loader.dense, cfg.obs_len, dev)
    stream = IndexStream(train_loader.dense.num_seq, tcfg.batch_size,
                         seed=tcfg.seed, shuffle=True)
    return DispatchSource(tcfg, stream=stream, data=data)


def num_devices(tcfg: TrainConfig, dev: torch.device
                ) -> Tuple[int, Optional[DPGroup]]:
    """``tcfg.num_devices`` resolved (0: the world size of the group in
    force; without one every visible CUDA device when ``dev`` is a card,
    else 1) and that group (the one installed, else ``torch.distributed``'s
    default one; None if neither exists)."""
    dp = get_dp_group() or world_group()
    n = tcfg.num_devices
    if n <= 0:
        if dp is not None:
            n = dp.world
        else:
            n = torch.cuda.device_count() if dev.type == "cuda" else 1
    return n, dp


def _check_devices(tcfg: TrainConfig, dev: torch.device,
                   entry: str = "grouptraj_torch.train.cli"
                   ) -> Optional[DPGroup]:
    """The group ``train()`` (or ``train_many``) shards over: None on one
    device; for ``num_devices > 1`` the group in force, which must have
    that many ranks, each holding ``batch_size / num_devices`` scenes of a
    batch. ``entry`` is the module the launch recipe names."""
    n, dp = num_devices(tcfg, dev)
    if n == 1:
        return None
    if tcfg.batch_size % n:
        raise ValueError(f"batch_size={tcfg.batch_size} must be divisible "
                         f"by num_devices={n}")
    if dp is None or dp.world != n:
        raise ValueError(
            f"num_devices={tcfg.num_devices}"
            f"{f' (every visible card: {n})' if tcfg.num_devices <= 0 else ''}"
            f" trains on {n} ranks of a process group, and "
            f"{'none is' if dp is None else f'one of {dp.world} is'} made: "
            f"launch one process a rank, e.g. `torchrun --nproc_per_node "
            f"{n} -m {entry} --num_devices {n} ...` "
            f"(--dist_backend nccl, one card a rank), or make the group "
            f"with grouptraj_torch.parallel.mesh.init_data_parallel "
            f"before the call")
    return dp


def train(cfg: ModelConfig, tcfg: TrainConfig,
          args_snapshot: Optional[dict] = None,
          device: Union[str, torch.device, None] = None,
          draws: Optional[Draws] = None, return_state: bool = False):
    """Run training -> the final checkpoint dict, or ``(checkpoint,
    TrainState)`` with ``return_state``. With ``num_devices > 1`` this is
    one rank of a data-parallel run (the module's docstring); ``draws``
    then gives the global batch's draws, which each rank slices."""
    dev = resolve_device(device)
    prev = set_dp_group(_check_devices(tcfg, dev))
    try:
        return _train(cfg, tcfg, args_snapshot, dev, draws, return_state)
    finally:
        set_dp_group(prev)


def _train(cfg, tcfg, args_snapshot, dev, draws, return_state):
    dp = get_dp_group()
    impl = select_impl(cfg, tcfg)
    train_dset, train_loader, val_loader = build_loaders(cfg, tcfg)

    iterations_per_epoch = len(train_dset) / tcfg.batch_size / tcfg.d_steps
    num_iterations = tcfg.num_iterations
    if tcfg.num_epochs:
        num_iterations = int(iterations_per_epoch * tcfg.num_epochs)
    logger.info("There are %s iterations per epoch", iterations_per_epoch)

    acc_sweep = make_check_accuracy_sweep(cfg, impl)
    gen = torch.Generator(device=dev).manual_seed(tcfg.seed)
    state = init_train_state(cfg, tcfg, generator=gen, device=dev)

    if args_snapshot is None:
        args_snapshot = {**dataclasses.asdict(cfg), **dataclasses.asdict(tcfg)}
    # the resolved ModelConfig beside the raw flags, so eval rebuilds the
    # exact model (compat.config_from_checkpoint_args)
    args_snapshot = dict(args_snapshot)
    args_snapshot["resolved_model_config"] = dataclasses.asdict(cfg)

    restore_path = None
    if tcfg.checkpoint_start_from:
        restore_path = tcfg.checkpoint_start_from
    elif tcfg.restore_from_checkpoint:
        restore_path = os.path.join(
            tcfg.output_dir, f"{tcfg.checkpoint_name}_with_model.pt")
    ckpt = ckpt_lib.load_checkpoint(restore_path) if restore_path else None
    t, epoch = 0, 0
    if ckpt is not None and ckpt.get("g_state") is not None:
        logger.info("Restoring from checkpoint %s", restore_path)
        state = ckpt_lib.state_from_checkpoint(ckpt, cfg, tcfg, dev)
        t = ckpt["counters"]["t"] or 0
        epoch = ckpt["counters"]["epoch"] or 0
        ckpt["restore_ts"].append(t)
    else:
        ckpt = ckpt_lib.new_checkpoint(args_snapshot)
    replicate_state(state)
    # the streams' epoch counters start at 0 in this process: offset them
    # by the restored epoch
    epoch0 = epoch

    # the metric sweeps run over device-resident copies, uploaded once;
    # each event sends a small index array and reads the sums back once
    val_data = device_dataset(val_loader.dense, cfg.obs_len, dev)
    train_eval_data = device_dataset(train_loader.dense, cfg.obs_len, dev)
    val_idx_host = _sweep_indices(val_loader.dense.num_seq, tcfg.batch_size)
    eval_rng, nb_limit = make_train_eval_subset(tcfg, train_loader.dense)

    def shard(idx):
        """This rank's scenes of every batch of ``idx`` [..., S] -> the
        device."""
        if dp is not None:
            idx = shard_scenes(idx, dp.rank, dp.world)
        return torch.from_numpy(np.ascontiguousarray(idx)).to(dev,
                                                              torch.long)

    def run_sweep(data, idx_host, sweep_draws):
        sums = read_sums(acc_sweep(state, data, shard(idx_host), gen,
                                   sweep_draws))
        return summarize_check_accuracy(sums, len(idx_host), cfg.pred_len)

    def save():
        """Rank 0 writes both files; the others wait until it has."""
        if is_writer():
            ckpt_lib.save_checkpoint(ckpt, tcfg.output_dir,
                                     tcfg.checkpoint_name)
        barrier()

    # per-iteration grad norms stay on the device until an event
    pending = {"norm_d": [], "norm_g": []}

    def drain_norms():
        for k, vals in pending.items():
            if vals:
                ckpt[k].extend(torch.cat(vals).tolist())
                vals.clear()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run_chunk(t, idx, data, chunk_draws):
        """``train_iterations`` over the dispatch; with ``profile_dir`` the
        iterations of PROFILE_ITERS run apart, under torch.profiler on the
        writer (rank 0)."""
        lo, hi = PROFILE_ITERS
        n = len(idx)
        cuts = [0, n]
        if tcfg.profile_dir:
            cuts = sorted({0, n} | {min(max(x - t, 0), n) for x in (lo, hi)})
        parts = []
        for a, b in zip(cuts[:-1], cuts[1:]):
            traced = (bool(tcfg.profile_dir) and lo <= t + a < hi
                      and is_writer())
            with _profiled(tcfg.profile_dir, dev,
                           f"trace_{t + a}_{t + b}.json" if traced else None):
                parts.append(train_iterations(
                    state, data, idx[a:b], cfg, tcfg, gen,
                    None if chunk_draws is None else chunk_draws[a:b], impl))
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    spi = tcfg.d_steps + tcfg.g_steps
    chunk = max(1, tcfg.steps_per_dispatch)
    src = make_dispatch_source(cfg, tcfg, train_dset, train_loader, dev)
    tcfg = src.tcfg
    sched, datas, buckets = src.sched, src.datas, src.buckets
    stream, index_iter, data = src.stream, src.index_iter, src.data

    t0 = time.time()
    t_window_start, window_t0 = t, time.time()
    window_traj = 0          # scene slots x pad width dispatched
    logged_epoch = 0
    while t < num_iterations:
        this_chunk = min(chunk, num_iterations - t)
        if stream is None:
            bucket_id, idx = sched.next_dispatch(this_chunk, spi)
            data = datas[bucket_id]
            window_traj += this_chunk * tcfg.batch_size * buckets[bucket_id][0]
            cur_epoch = epoch0 + sched.epoch
        else:
            idx = np.stack([
                np.stack([next(index_iter) for _ in range(spi)])
                for _ in range(this_chunk)])
            window_traj += (this_chunk * tcfg.batch_size
                            * train_loader.dense.n_max)
            cur_epoch = epoch0 + stream.epoch
        if cur_epoch != logged_epoch:
            logged_epoch = cur_epoch
            logger.info("Starting epoch %d", logged_epoch)

        if tcfg.timing:
            sync()
            t1 = time.time()
        chunk_draws = (None if draws is None
                       else list(draws.iterations(this_chunk)))
        losses = run_chunk(t, shard(idx), data, chunk_draws)
        if tcfg.timing:
            sync()
            logger.info("chunk of %d iterations took %.4f", this_chunk,
                        time.time() - t1)
        for k in pending:
            if k in losses:
                pending[k].append(losses[k])

        t_prev = t
        t += this_chunk

        if t_prev // tcfg.print_every != t // tcfg.print_every:
            drain_norms()           # the read-back syncs the device
            last = {k: v[-1] for k, v in losses.items()}
            host_losses = dict(zip(last, torch.stack(
                list(last.values())).tolist()))
            dt = time.time() - window_t0
            steps_done = t - t_window_start
            sps = steps_done / dt if dt > 0 and steps_done else 0.0
            logger.info("t = %d / %d (%.2f iters/s, %.0f traj/s)",
                        t, num_iterations, sps,
                        window_traj / dt if dt > 0 else 0.0)
            t_window_start, window_t0 = t, time.time()
            window_traj = 0
            for k, v in sorted(host_losses.items()):
                if k.startswith("D_"):
                    logger.info("  [D] %s: %.3f", k, v)
                    ckpt["D_losses"][k].append(v)
                elif k.startswith("G_"):
                    logger.info("  [G] %s: %.3f", k, v)
                    ckpt["G_losses"][k].append(v)
            ckpt["losses_ts"].append(t)

        if t_prev // tcfg.checkpoint_every != t // tcfg.checkpoint_every:
            drain_norms()
            epoch = (epoch0 + stream.epoch if stream is not None
                     else logged_epoch)
            ckpt["counters"]["t"] = t
            ckpt["counters"]["epoch"] = epoch
            ckpt["sample_ts"].append(t)
            val_draws, train_draws = (draws.sweeps() if draws is not None
                                      else (None, None))
            logger.info("Checking stats on val ...")
            metrics_val = run_sweep(val_data, val_idx_host, val_draws)
            logger.info("Checking stats on train ...")
            train_idx = _sweep_indices(
                train_loader.dense.num_seq, tcfg.batch_size,
                order=eval_rng.permutation(
                    train_loader.dense.num_seq))[:nb_limit]
            metrics_train = run_sweep(train_eval_data, train_idx,
                                      train_draws)
            for k, v in sorted(metrics_val.items()):
                logger.info("  [val] %s: %.3f", k, v)
                ckpt["metrics_val"][k].append(v)
            for k, v in sorted(metrics_train.items()):
                logger.info("  [train] %s: %.3f", k, v)
                ckpt["metrics_train"][k].append(v)

            min_ade = min(ckpt["metrics_val"]["ade"])
            min_ade_nl = min(ckpt["metrics_val"]["ade_nl"])
            ckpt = ckpt_lib.checkpoint_from_state(ckpt, state, tcfg)
            if metrics_val["ade"] == min_ade:
                logger.info("New low for avg_disp_error")
                ckpt["best_t"] = t
                ckpt["g_best_state"] = ckpt["g_state"]
                ckpt["d_best_state"] = ckpt["d_state"]
            if metrics_val["ade_nl"] == min_ade_nl:
                logger.info("New low for avg_disp_error_nl")
                ckpt["best_t_nl"] = t
                ckpt["g_best_nl_state"] = ckpt["g_state"]
                ckpt["d_best_nl_state"] = ckpt["d_state"]
            save()
            logger.info("Saved checkpoint to %s", tcfg.output_dir)
            window_t0, t_window_start = time.time(), t
            window_traj = 0

    sync()
    drain_norms()
    logger.info("Training done in %.1fs", time.time() - t0)
    ckpt["counters"]["t"] = t
    ckpt["counters"]["epoch"] = epoch
    ckpt = ckpt_lib.checkpoint_from_state(ckpt, state, tcfg)
    if ckpt.get("g_best_state") is None:
        ckpt["g_best_state"] = ckpt["g_state"]
        ckpt["d_best_state"] = ckpt["d_state"]
    save()
    return (ckpt, state) if return_state else ckpt


@contextlib.contextmanager
def _profiled(profile_dir: str, dev: torch.device, name: Optional[str]):
    """torch.profiler around the block, its Chrome trace written to
    ``profile_dir/name``; nothing when ``name`` is None."""
    if name is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    path = os.path.join(profile_dir, name)
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)
