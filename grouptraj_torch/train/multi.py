"""Multi-seed sweeps: N replicas of one configuration trained as one program
on one device (counterpart of ``grouptraj/train/multi.py``).

The replicas' weights, Adam moments and EMA are stacked on a leading seed
axis (:class:`steps.StackedState`); every d-step, g-step and metric sweep
runs the models once under ``torch.func.vmap`` over that axis
(:func:`steps.replica_map`), so a sweep makes the launches of one run, each
N times wider. The pool's kernels K1/K2 take the seed axis as their replica
axis R (``ops/cuda_pool.py:PoolCore.vmap``): one K1 and one K2 launch per
call site with R = N. The LSTMs run on the ``'scan'`` route whatever
``lstm_impl`` says, as in the JAX package (its Pallas LSTMs are not
validated under the seed vmap; here the whole-loop kernels' Functions have
no vmap rule).

Semantics against N runs of ``train()``: replica i's initial weights and
draws are those of ``train()`` with ``seed = seeds[i]`` (one
``torch.Generator`` per replica, drawn outside the vmap in a step's order);
all replicas share one batch schedule, seeded by ``tcfg.seed``. The clip
and Adam act per replica. Each seed writes the standard checkpoint files to
``<output_dir>/s<seed>/`` in the JAX package's schema, with ``args["seed"]``
and ``args["sweep_seeds"]``, and its generator's state under
:data:`RNG_KEY`.

Resume (``restore_from_checkpoint`` or ``checkpoint_start_from=<sweep
dir>``) restores the stacked states, counters and histories, each
replica's generator (so a resumed sweep reproduces the uninterrupted one)
and fast-forwards the host's batch schedule and the train-sweep subset
draws. A sweep written by the JAX package restores with fresh per-seed
chains and a warning (its files carry JAX keys, ``rng_key_vec``). Refused:
duplicate seeds, a partial sweep, a seed-set mismatch, members at
different t, t beyond ``num_iterations``, ``num_devices > 1``.

Randomness goes through the seam of ``loop.train``: ``draws``, one
:class:`loop.Draws` per seed, replaces each replica's draws.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from grouptraj_torch.config import ModelConfig, TrainConfig
from grouptraj_torch.ops.lstm import select_impl
from grouptraj_torch.train import checkpoint as ckpt_lib
from grouptraj_torch.train.device_data import device_dataset
from grouptraj_torch.train.loop import (
    Draws, _check_devices, _sweep_indices, build_loaders,
    make_dispatch_source, make_train_eval_subset,
)
from grouptraj_torch.train.steps import (
    check_accuracy_sweep_many, check_sweepable, init_train_state,
    stack_states,
    summarize_check_accuracy, train_iterations_many, unstack_state,
)
from grouptraj_torch.utils import resolve_device

logger = logging.getLogger(__name__)

# a replica's torch.Generator state (uint8) in its checkpoint
RNG_KEY = "torch_rng_state"


def _load_sweep_checkpoints(restore_dir: str, seeds: List[int],
                            ckpt_name: str) -> Optional[List[dict]]:
    """The per-seed checkpoints of an interrupted sweep from
    ``<restore_dir>/s<seed>/``; None when no member exists. Refuses a
    partial sweep, a seed-set mismatch and members at different t (the
    replicas share one schedule)."""
    paths = [os.path.join(restore_dir, f"s{s}", f"{ckpt_name}_with_model.pt")
             for s in seeds]
    present = [os.path.exists(p) for p in paths]
    if not any(present):
        return None
    if not all(present):
        missing = [s for s, ok in zip(seeds, present) if not ok]
        raise ValueError(
            f"partial sweep checkpoint in {restore_dir}: seeds {missing} "
            f"missing; delete the s*/ dirs to start fresh or restore with "
            f"the original seed set")
    cks = [ckpt_lib.load_checkpoint(p) for p in paths]
    for s, ck in zip(seeds, cks):
        saved = ck["args"].get("sweep_seeds")
        if saved is not None and list(saved) != list(seeds):
            raise ValueError(
                f"sweep seed-set mismatch: checkpoint s{s} was part of "
                f"sweep {saved}, requested {list(seeds)}")
    ts = {ck["counters"]["t"] for ck in cks}
    if len(ts) != 1:
        raise ValueError(
            f"inconsistent member counters t={sorted(ts)} in {restore_dir}")
    return cks


def train_many(cfg: ModelConfig, tcfg: TrainConfig, seeds: Sequence[int],
               args_snapshot: Optional[dict] = None,
               device: Union[str, torch.device, None] = None,
               draws: Optional[Sequence[Draws]] = None,
               return_state: bool = False):
    """Train one replica per seed at once -> ``{seed: checkpoint}``, or
    ``(checkpoints, StackedState)`` with ``return_state``. Runs on ``cuda``
    unless ``device`` names another device."""
    seeds = list(seeds)
    if len(set(seeds)) != len(seeds):
        raise ValueError(f"duplicate seeds: {seeds}")
    if draws is not None and len(draws) != len(seeds):
        raise ValueError(f"{len(draws)} Draws for {len(seeds)} seeds")
    dev = resolve_device(device)
    _check_devices(tcfg, dev)
    check_sweepable(cfg)
    impl = select_impl(cfg, tcfg)
    if impl != "scan":
        logger.info("train_many: lstm_impl %s -> scan (vmap-safe)", impl)
        impl = "scan"
    n_seeds = len(seeds)
    train_dset, train_loader, val_loader = build_loaders(cfg, tcfg)

    iterations_per_epoch = len(train_dset) / tcfg.batch_size / tcfg.d_steps
    num_iterations = tcfg.num_iterations
    if tcfg.num_epochs:
        num_iterations = int(iterations_per_epoch * tcfg.num_epochs)
    logger.info("There are %s iterations per epoch; %d seeds vmapped",
                iterations_per_epoch, n_seeds)

    # per-replica chains: each seed's generator as train() seeds it
    gens = [torch.Generator(device=dev).manual_seed(s) for s in seeds]
    states = [init_train_state(cfg, tcfg, generator=g, device=dev)
              for g in gens]

    if args_snapshot is None:
        args_snapshot = {**dataclasses.asdict(cfg), **dataclasses.asdict(tcfg)}
    args_snapshot = dict(args_snapshot)
    args_snapshot["resolved_model_config"] = dataclasses.asdict(cfg)
    ckpts = {}
    for s in seeds:
        ckpts[s] = ckpt_lib.new_checkpoint(
            dict(args_snapshot, seed=s, sweep_seeds=list(seeds)))

    restore_dir = tcfg.checkpoint_start_from or (
        tcfg.output_dir if tcfg.restore_from_checkpoint else None)
    t_restored = 0
    if restore_dir:
        cks = _load_sweep_checkpoints(restore_dir, seeds,
                                      tcfg.checkpoint_name)
        if cks is None and tcfg.checkpoint_start_from:
            raise ValueError(
                f"checkpoint_start_from={restore_dir!r}: no sweep member "
                f"checkpoints (s<seed>/{tcfg.checkpoint_name}"
                f"_with_model.pt) found to restore from")
        if cks is not None:
            t_restored = cks[0]["counters"]["t"] or 0
            logger.info("Resuming %d-seed sweep from %s at t=%d",
                        n_seeds, restore_dir, t_restored)
            states = [ckpt_lib.state_from_checkpoint(ck, cfg, tcfg, dev)
                      for ck in cks]
            if all(ck.get(RNG_KEY) is not None for ck in cks):
                for g, ck in zip(gens, cks):
                    g.set_state(torch.from_numpy(np.asarray(ck[RNG_KEY],
                                                            np.uint8)))
            else:
                logger.warning(
                    "sweep checkpoints lack %s (written by grouptraj or "
                    "an older port); resuming with a fresh per-seed "
                    "generator chain", RNG_KEY)
            for ck, s in zip(cks, seeds):
                ck["restore_ts"].append(t_restored)
                ckpts[s] = ck
    st = stack_states(states, tcfg)
    del states

    val_data = device_dataset(val_loader.dense, cfg.obs_len, dev)
    train_eval_data = device_dataset(train_loader.dense, cfg.obs_len, dev)
    val_idx_host = _sweep_indices(val_loader.dense.num_seq, tcfg.batch_size)
    eval_rng, nb_limit = make_train_eval_subset(tcfg, train_loader.dense)

    def run_sweeps(data, idx_host, sweep_draws):
        idx = torch.from_numpy(idx_host).to(dev, torch.long)
        sums = check_accuracy_sweep_many(st, data, idx, cfg, gens,
                                         sweep_draws, impl)
        keys = list(sums)
        host = dict(zip(keys, torch.stack([sums[k] for k in keys]).tolist()))
        return [summarize_check_accuracy({k: v[i] for k, v in host.items()},
                                         len(idx_host), cfg.pred_len)
                for i in range(n_seeds)]

    spi = tcfg.d_steps + tcfg.g_steps
    chunk = max(1, tcfg.steps_per_dispatch)
    src = make_dispatch_source(cfg, tcfg, train_dset, train_loader, dev)
    tcfg = src.tcfg
    sched, datas = src.sched, src.datas
    stream, index_iter, data = src.stream, src.index_iter, src.data

    # per-iteration grad norms stay on the device until an event
    pending = {"norm_d": [], "norm_g": []}

    def drain_norms():
        for k, vals in pending.items():
            if vals:
                rows = torch.cat(vals, dim=1).tolist()    # [n_seeds, total]
                for s, row in zip(seeds, rows):
                    ckpts[s][k].extend(row)
                vals.clear()

    def save(t, epoch, mvals=None):
        """Every replica's checkpoint at t: counters, generator state,
        weights and moments, best states; with ``mvals`` (an event) the
        metric histories and the best-state tracking too."""
        for i, s in enumerate(seeds):
            ck = ckpts[s]
            ck["counters"]["t"] = t
            ck["counters"]["epoch"] = epoch
            ck[RNG_KEY] = gens[i].get_state().numpy().copy()
            ck = ckpt_lib.checkpoint_from_state(
                ck, unstack_state(st, i, tcfg, "cpu"), tcfg)
            if mvals is not None:
                if mvals[i]["ade"] == min(ck["metrics_val"]["ade"]):
                    ck["best_t"] = t
                    ck["g_best_state"] = ck["g_state"]
                    ck["d_best_state"] = ck["d_state"]
                if mvals[i]["ade_nl"] == min(ck["metrics_val"]["ade_nl"]):
                    ck["best_t_nl"] = t
                    ck["g_best_nl_state"] = ck["g_state"]
                    ck["d_best_nl_state"] = ck["d_state"]
            elif ck.get("g_best_state") is None:
                ck["g_best_state"] = ck["g_state"]
                ck["d_best_state"] = ck["d_state"]
            ckpt_lib.save_checkpoint(ck, os.path.join(tcfg.output_dir,
                                                      f"s{s}"),
                                     tcfg.checkpoint_name)

    t = 0
    if t_restored > num_iterations:
        raise ValueError(
            f"restored sweep is at t={t_restored} > num_iterations="
            f"{num_iterations}; raise --num_iterations/--num_epochs (or "
            f"start fresh) instead of retraining restored states")
    # fast-forward the host's schedule and the train-sweep subset draws
    # to the restore point, dispatch by dispatch as the interrupted run
    # drew them (its last dispatch may have been cut short by its own
    # num_iterations: the JAX package's min(chunk, num_iterations - t)
    # overshoots t_restored there and skips iterations)
    while t < t_restored:
        this_chunk = min(chunk, t_restored - t)
        if stream is None:
            sched.next_dispatch(this_chunk, spi)
        else:
            for _ in range(spi * this_chunk):
                next(index_iter)
        t_prev = t
        t += this_chunk
        if t_prev // tcfg.checkpoint_every != t // tcfg.checkpoint_every:
            eval_rng.permutation(train_loader.dense.num_seq)

    t0 = time.time()
    logged_epoch = (ckpts[seeds[0]]["counters"]["epoch"] or 0) \
        if t_restored else 0
    t_window_start, window_t0 = t, time.time()
    while t < num_iterations:
        this_chunk = min(chunk, num_iterations - t)
        if stream is None:
            bucket_id, idx = sched.next_dispatch(this_chunk, spi)
            data = datas[bucket_id]
            cur_epoch = sched.epoch
        else:
            idx = np.stack([
                np.stack([next(index_iter) for _ in range(spi)])
                for _ in range(this_chunk)])
            cur_epoch = stream.epoch
        if cur_epoch != logged_epoch:
            logged_epoch = cur_epoch
            logger.info("Starting epoch %d", logged_epoch)

        chunk_draws = (None if draws is None
                       else [list(d.iterations(this_chunk)) for d in draws])
        losses = train_iterations_many(
            st, data, torch.from_numpy(idx).to(dev, torch.long), cfg, tcfg,
            gens, chunk_draws, impl)
        for k in pending:
            if k in losses:
                pending[k].append(losses[k])
        t_prev = t
        t += this_chunk

        if t_prev // tcfg.print_every != t // tcfg.print_every:
            drain_norms()
            keys = sorted(k for k in losses if k.startswith(("D_", "G_")))
            last = torch.stack([losses[k][:, -1] for k in keys]).tolist()
            dt = time.time() - window_t0
            steps_done = t - t_window_start
            logger.info(
                "t = %d / %d (%.2f iters/s x %d seeds = %.2f seed-iters/s)",
                t, num_iterations, steps_done / dt if dt > 0 else 0,
                n_seeds, steps_done * n_seeds / dt if dt > 0 else 0)
            t_window_start, window_t0 = t, time.time()
            for k, vals in zip(keys, last):
                logger.info("  %s: %s", k, [round(v, 3) for v in vals])
                hist = "D_losses" if k.startswith("D_") else "G_losses"
                for s, v in zip(seeds, vals):
                    ckpts[s][hist][k].append(v)
            for s in seeds:
                ckpts[s]["losses_ts"].append(t)

        if t_prev // tcfg.checkpoint_every != t // tcfg.checkpoint_every:
            drain_norms()
            sweep_draws = ([d.sweeps() for d in draws] if draws is not None
                           else None)
            logger.info("Checking stats on val ...")
            mvals = run_sweeps(val_data, val_idx_host,
                               sweep_draws and [v for v, _ in sweep_draws])
            train_idx = _sweep_indices(
                train_loader.dense.num_seq, tcfg.batch_size,
                order=eval_rng.permutation(
                    train_loader.dense.num_seq))[:nb_limit]
            mtrains = run_sweeps(train_eval_data, train_idx,
                                 sweep_draws and [tr for _, tr in sweep_draws])
            for i, s in enumerate(seeds):
                ck = ckpts[s]
                ck["sample_ts"].append(t)
                for k, v in sorted(mvals[i].items()):
                    ck["metrics_val"][k].append(v)
                for k, v in sorted(mtrains[i].items()):
                    ck["metrics_train"][k].append(v)
            save(t, logged_epoch, mvals)
            logger.info("val ADE per seed: %s",
                        {s: round(mvals[i]["ade"], 3)
                         for i, s in enumerate(seeds)})
            window_t0, t_window_start = time.time(), t

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    drain_norms()
    logger.info("Training done in %.1fs (%d seeds)", time.time() - t0,
                n_seeds)
    save(t, logged_epoch)
    return (ckpts, st) if return_state else ckpts
