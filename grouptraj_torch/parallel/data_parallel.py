"""Data-parallel ranks: a launcher, the rank functions and a dry run
(counterpart of ``grouptraj/parallel/data_parallel.py``).

:func:`spawn` starts ``world`` processes with ``torch.multiprocessing``
(the spawn start method), each joining one process group through a
``file://`` store (no TCP port, so runs side by side cannot collide) with
one torch thread, then calling ``fn(rank, world, device, *args)``; an
exception in a rank raises in the caller. The rank functions below are
what the tests and ``chip_smoke.py`` run on each rank. They live in the
port so that a spawned child imports ``torch`` and ``grouptraj_torch``
only. Each installs the group (``mesh.set_dp_group``), works on its scenes
and writes its results with ``torch.save`` to ``<out_dir>/rank<r>.pt``:

- :func:`steps_rank`: per job, one d-step and one g-step from given
  weights on a given batch with given (global) draws, and the gradients
  of each;
- :func:`iterations_rank`: :func:`run_iterations`, ``train_iterations``
  from a seeded state with a seeded generator, per LSTM route, with the
  launch counts, ms an iteration and the all-reduce's ms and bytes;
- :func:`train_rank`: ``train()`` runs (a resume among them) on a split
  on disk, with their histories, weights, Adam state and launches;
- :func:`sweep_steps_rank`: :func:`steps_rank` for a multi-seed sweep's
  stacked steps (``steps.d_step_many`` / ``g_step_many``), each seed's
  draws given;
- :func:`sweep_rank`: the multi-seed sweep, :func:`run_iterations_many`
  (``train_iterations_many`` from seeded states) and ``train_many`` runs
  (a resume among them) on a split on disk;
- :func:`cli_rank`: the training CLI, or the sweep CLI, as ``torchrun``
  starts it;
- :func:`each_rank`: several of them in one spawn.

:func:`dryrun_data_parallel` is ``dryrun_multichip``'s counterpart: n gloo
ranks on the CPU through :func:`run_iterations` at two bucket widths, and
(its stage 4) a 2-seed sweep through :func:`run_iterations_many` at the
same widths, each against the same in one process.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import shutil
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from grouptraj_torch.config import ModelConfig, TrainConfig
from grouptraj_torch.parallel.mesh import (
    all_reduce_grads, check_backend, get_dp_group, init_data_parallel,
    replicate_state, set_dp_group, shard_scenes, world_group,
)

# what train_rank keeps of a checkpoint: its histories and counters
HISTORY_KEYS = ("D_losses", "G_losses", "norm_d", "norm_g", "metrics_val",
                "metrics_train", "losses_ts", "sample_ts", "restore_ts",
                "counters", "best_t", "best_t_nl")


def spawn(fn: Callable, world: int, backend: str = "gloo",
          device_of_rank: Optional[Callable[[int], object]] = None,
          init_file: Optional[str] = None, args: Sequence = ()) -> None:
    """Run ``fn(rank, world, device, *args)`` on ``world`` ranks, rank r on
    ``device_of_rank(r)`` (default: the CPU), in a ``backend`` group whose
    rendezvous is the file ``init_file`` (it must not exist yet; default:
    one in a fresh temporary directory, removed after). ``fn`` and
    ``args`` are pickled by reference: a module-level function of an
    importable module. Returns when every rank has; a rank's exception
    raises here."""
    devices = [str(torch.device("cpu" if device_of_rank is None
                                else device_of_rank(r)))
               for r in range(world)]
    check_backend(backend, devices)
    tmp = None
    if init_file is None:
        tmp = tempfile.mkdtemp(prefix="grouptraj_dp_")
        init_file = os.path.join(tmp, "store")
    if os.path.exists(init_file):
        raise ValueError(f"{init_file} exists: a file store is made by its "
                         f"first rank, and an old one would be joined")
    try:
        mp.start_processes(
            _rank_main, args=(fn, world, backend, devices,
                              "file://" + os.path.abspath(init_file),
                              tuple(args)),
            nprocs=world, join=True, start_method="spawn")
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(rank, fn, world, backend, devices, init_method, args):
    torch.set_num_threads(1)
    init_data_parallel(world, rank, backend, init_method, devices[rank])
    try:
        fn(rank, world, devices[rank], *args)
    finally:
        dist.destroy_process_group()


def _save(out_dir: str, rank: int, result: dict) -> None:
    """``result`` and, under ``"foreign_modules"``, the JAX-side modules
    this rank imported (none: a rank imports torch and the port only)."""
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "optax", "grouptraj"))
    torch.save({**result, "foreign_modules": foreign},
               os.path.join(out_dir, f"rank{rank}.pt"))


def load_results(out_dir: str, world: int) -> list:
    """The results the ranks' :func:`_save` wrote, by rank."""
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=True) for r in range(world)]


def _on(x, dev):
    """Injected draws (tensors, arrays, lists of them, floats) on ``dev``."""
    if isinstance(x, dict):
        return {k: _on(v, dev) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_on(v, dev) for v in x]
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return torch.as_tensor(x).to(dev)
    return x


def _cpu(named) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in named}


def _tf32_off(dev: torch.device) -> None:
    """Float32 products in full float32 on a card, as the one-process runs
    that a rank is held against take them."""
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class StepsJob:
    """:func:`steps_rank`'s inputs: the configs, G's and D's weights
    (state dicts), a batch (numpy arrays ``[S, ...]``, the global one) and
    the d-step's and g-step's draws (``steps.d_step`` / ``g_step``
    keywords, at the global batch's shapes)."""
    cfg: ModelConfig
    tcfg: TrainConfig
    g_state: dict
    d_state: dict
    batch: dict
    d_draw: dict
    g_draw: dict


def steps_rank(rank: int, world: int, device, jobs: Dict[str, StepsJob],
               out_dir: str) -> None:
    """For each job: one d-step and one g-step on this rank's scenes of
    ``job.batch``, each step's gradients (``d_gradients`` /
    ``g_gradients``, summed over the ranks), the losses and both networks'
    weights after the steps -> saved by the job's name."""
    dev = torch.device(device)
    prev = set_dp_group(world_group())
    try:
        out = {name: _steps(rank, world, dev, job)
               for name, job in jobs.items()}
    finally:
        set_dp_group(prev)
    _save(out_dir, rank, out)


def _steps(rank: int, world: int, dev: torch.device, job: StepsJob) -> dict:
    from grouptraj_torch.models.discriminator import TrajectoryDiscriminator
    from grouptraj_torch.models.generator import TrajectoryGenerator
    from grouptraj_torch.train import steps as TS
    g = TrajectoryGenerator(job.cfg).to(dev)
    d = TrajectoryDiscriminator(job.cfg).to(dev)
    g.load_state_dict(job.g_state)
    d.load_state_dict(job.d_state)
    state = TS.train_state_from_modules(g, d, job.tcfg)
    b = {k: shard_scenes(torch.as_tensor(v), rank, world, axis=0).to(dev)
         for k, v in job.batch.items()}
    d_draw, g_draw = _on(job.d_draw, dev), _on(job.g_draw, dev)
    replicate_state(state)
    d_grads = TS.d_gradients(state, b, job.cfg, job.tcfg, **d_draw)[1]
    losses = TS.d_step(state, b, job.cfg, job.tcfg, **d_draw)
    g_grads = TS.g_gradients(state, b, job.cfg, job.tcfg, **g_draw)[1]
    losses.update(TS.g_step(state, b, job.cfg, job.tcfg, **g_draw))
    return {
        "losses": {k: float(v) for k, v in losses.items()},
        "d_grads": _cpu(zip([n for n, _ in d.named_parameters()], d_grads)),
        "g_grads": _cpu(zip([n for n, _ in g.named_parameters()], g_grads)),
        "d": _cpu(d.state_dict().items()), "g": _cpu(g.state_dict().items())}


@dataclasses.dataclass
class SweepStepsJob:
    """:func:`sweep_steps_rank`'s inputs: the configs, each seed's G and D
    weights (state dicts), a batch (numpy arrays ``[S, ...]``, the global
    one) and each seed's d-step and g-step draws (the per-step dicts of
    ``steps.train_iterations``, at the global batch's shapes)."""
    cfg: ModelConfig
    tcfg: TrainConfig
    g_states: List[dict]
    d_states: List[dict]
    batch: dict
    d_draws: List[dict]
    g_draws: List[dict]


def sweep_steps_rank(rank: int, world: int, device,
                     jobs: Dict[str, SweepStepsJob], out_dir: str) -> None:
    """For each job: the seeds' states stacked, one d-step and one g-step
    of the sweep (``d_step_many`` / ``g_step_many``) on this rank's scenes
    of ``job.batch``, each step's stacked gradients (summed over the
    ranks), the losses ``[N]`` and every seed's weights after the steps ->
    saved by the job's name."""
    dev = torch.device(device)
    prev = set_dp_group(world_group())
    try:
        out = {name: _sweep_steps(rank, world, dev, job)
               for name, job in jobs.items()}
    finally:
        set_dp_group(prev)
    _save(out_dir, rank, out)


def _sweep_steps(rank: int, world: int, dev: torch.device,
                 job: SweepStepsJob) -> dict:
    from grouptraj_torch.models.discriminator import TrajectoryDiscriminator
    from grouptraj_torch.models.generator import TrajectoryGenerator
    from grouptraj_torch.train import steps as TS
    cfg, tcfg = job.cfg, job.tcfg
    states = []
    for g_state, d_state in zip(job.g_states, job.d_states):
        g = TrajectoryGenerator(cfg).to(dev)
        d = TrajectoryDiscriminator(cfg).to(dev)
        g.load_state_dict(g_state)
        d.load_state_dict(d_state)
        states.append(replicate_state(TS.train_state_from_modules(g, d,
                                                                  tcfg)))
    st = TS.stack_states(states, tcfg)
    b = {k: shard_scenes(torch.as_tensor(v), rank, world, axis=0).to(dev)
         for k, v in job.batch.items()}
    S, N = b["valid"].shape
    kw = {kind: TS._stack_draws([
        TS.replica_draws(kind, cfg, tcfg, S, N, None, dev, **_on(x, dev))
        for x in per_seed], dev)
        for kind, per_seed in (("d", job.d_draws), ("g", job.g_draws))}
    d_grads = TS.d_gradients_many(st, b, cfg, tcfg, impl="scan",
                                  **kw["d"])[1]
    losses = TS.d_step_many(st, b, cfg, tcfg, impl="scan", **kw["d"])
    g_grads = TS.g_gradients_many(st, b, cfg, tcfg, impl="scan",
                                  **kw["g"])[1]
    losses.update(TS.g_step_many(st, b, cfg, tcfg, impl="scan", **kw["g"]))
    seeds = []
    for i in range(len(states)):
        one = TS.unstack_state(st, i, tcfg, "cpu")
        seeds.append({"g": _cpu(one.g.state_dict().items()),
                      "d": _cpu(one.d.state_dict().items())})
    return {"losses": _cpu(losses.items()),
            "d_grads": _cpu(zip(st.d_params, d_grads)),
            "g_grads": _cpu(zip(st.g_params, g_grads)), "seeds": seeds}


def _kernel_wrappers() -> tuple:
    """K1-K6's wrappers; each counts its launches in ``.launches``."""
    from grouptraj_torch.ops.cuda_lstm import lstm_fused_bwd, lstm_fused_fwd
    from grouptraj_torch.ops.cuda_lstm_proj import (
        lstm_proj_bwd, lstm_proj_fwd,
    )
    from grouptraj_torch.ops.cuda_pool import pool_core_bwd, pool_core_fwd
    return (pool_core_fwd, pool_core_bwd, lstm_fused_fwd, lstm_fused_bwd,
            lstm_proj_fwd, lstm_proj_bwd)


def _kernel_counts() -> Dict[str, int]:
    return {f.__name__: f.launches for f in _kernel_wrappers()}


def _reset_counts() -> None:
    for f in _kernel_wrappers():
        f.launches = 0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_iterations(cfg, tcfg, runs: Sequence, state_seed: int,
                   gen_seed: int, impl: str, device, warm: int = 0) -> dict:
    """``train_iterations`` of a state initialised from ``state_seed``,
    drawing from a generator seeded ``gen_seed``, over ``runs``: (the
    keywords of ``device_data.synthetic_device_data``, scene indices
    ``[iterations, d_steps + g_steps, S]`` of the global batch) in turn, on
    this rank's scenes of each batch when a group is installed. The first
    ``warm`` iterations run before the launch counts are set to 0 and the
    clock starts. -> the losses and norms ``{name: [iterations]}``, the
    weights, the launches and ms an iteration after ``warm``, the
    generator's state, and the all-reduce's calls and bytes."""
    from grouptraj_torch.train.steps import init_train_state, train_iterations
    dev = torch.device(device)
    state = init_train_state(cfg, tcfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(state_seed))
    replicate_state(state)
    gen = torch.Generator(device=dev).manual_seed(gen_seed)
    out = _timed_runs(lambda data, idx: train_iterations(
        state, data, idx, cfg, tcfg, gen, impl=impl), runs, dev, warm, 0)
    return dict(out, g=_cpu(state.g.named_parameters()),
                d=_cpu(state.d.named_parameters()),
                generator=gen.get_state())


def run_iterations_many(cfg, tcfg, runs: Sequence, state_seeds: Sequence,
                        gen_seeds: Sequence, device, warm: int = 0) -> dict:
    """:func:`run_iterations` for a multi-seed sweep:
    ``train_iterations_many`` (the ``'scan'`` route, train_many's) of the
    states initialised from ``state_seeds`` (one a replica, replicated over
    the ranks, stacked), replica i drawing from a generator seeded
    ``gen_seeds[i]``. -> the losses and norms ``{name: [N, iterations]}``,
    the stacked weights and Adam moments, the launches and ms an iteration
    after ``warm``, the generators' states and the all-reduce's calls and
    bytes."""
    from grouptraj_torch.train.steps import (
        init_train_state, stack_states, train_iterations_many,
    )
    dev = torch.device(device)
    states = [replicate_state(init_train_state(
        cfg, tcfg, device=dev,
        generator=torch.Generator(device=dev).manual_seed(s)))
        for s in state_seeds]
    st = stack_states(states, tcfg)
    del states
    gens = [torch.Generator(device=dev).manual_seed(s) for s in gen_seeds]
    out = _timed_runs(lambda data, idx: train_iterations_many(
        st, data, idx, cfg, tcfg, gens), runs, dev, warm, 1)
    return dict(out, **stacked_tensors(st),
                generators=[g.get_state() for g in gens])


def stacked_tensors(st) -> dict:
    """A StackedState's weights (``"g"``, ``"d"``: ``{name: [N, ...]}``) and
    Adam moments (``"adam"``: ``{"<g|d>.<name>.<key>": tensor}``) on the
    CPU."""
    adam = {}
    for part, params, opt in (("g", st.g_params, st.g_opt),
                              ("d", st.d_params, st.d_opt)):
        for name, p in params.items():
            for k, v in opt.state.get(p, {}).items():
                adam[f"{part}.{name}.{k}"] = v.detach().to("cpu", copy=True)
    return {"g": _cpu(st.g_params.items()), "d": _cpu(st.d_params.items()),
            "adam": adam}


def _timed_runs(step: Callable, runs: Sequence, dev: torch.device, warm: int,
                axis: int) -> dict:
    """``step(data, idx)`` over ``runs`` (the keywords of
    ``device_data.synthetic_device_data``, scene indices ``[iterations,
    d_steps + g_steps, S]`` of the global batch) in turn, on this rank's
    scenes of each batch when a group is installed; the first ``warm``
    iterations before the launch counts are set to 0 and the clock starts.
    -> the histories concatenated on their iteration ``axis``, the
    launches, iterations, ms an iteration and the all-reduce's calls and
    bytes after ``warm``."""
    from grouptraj_torch.train.device_data import synthetic_device_data
    dp = get_dp_group()
    hist, todo = [], []
    for spec, idx in runs:
        data = synthetic_device_data(**spec, device=dev)
        if dp is not None:
            idx = shard_scenes(np.asarray(idx), dp.rank, dp.world)
        todo.append((data, torch.as_tensor(np.ascontiguousarray(idx),
                                           dtype=torch.long, device=dev)))
    data, idx = todo[0]
    if warm:
        hist.append(step(data, idx[:warm]))
        todo[0] = (data, idx[warm:])
    _sync(dev)
    _reset_counts()
    calls0, bytes0 = (dp.calls, dp.bytes) if dp is not None else (0, 0)
    t0 = time.perf_counter()
    for data, idx in todo:
        hist.append(step(data, idx))
    _sync(dev)
    seconds = time.perf_counter() - t0
    iters = sum(len(idx) for _, idx in todo)
    return {
        "history": {k: torch.cat([h[k] for h in hist], dim=axis).cpu()
                    for k in hist[0]},
        "launches": _kernel_counts(), "iterations": iters,
        "ms_per_iter": seconds * 1e3 / iters,
        "reduce_calls": (dp.calls - calls0) if dp is not None else 0,
        "reduce_bytes": (dp.bytes - bytes0) if dp is not None else 0}


def time_all_reduce(numel: int, device, reps: int = 20) -> float:
    """ms of one :func:`mesh.all_reduce_grads` of ``numel`` float32 values
    (the device synchronised around ``reps`` calls, after a warm-up)."""
    dev = torch.device(device)
    buf = [torch.ones(numel, device=dev)]
    all_reduce_grads(buf)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        all_reduce_grads(buf)
    _sync(dev)
    return (time.perf_counter() - t0) * 1e3 / reps


def iterations_rank(rank: int, world: int, device, job: dict,
                    out_dir: str) -> None:
    """:func:`run_iterations` of ``job`` (its keywords but ``impl``) on
    this rank for each route of ``job["impls"]``, TF32 off; with
    ``job["time_reduce"]`` also the ms of one all-reduce of a step's mean
    size."""
    job = dict(job)
    impls = job.pop("impls")
    time_reduce = job.pop("time_reduce", False)
    dev = torch.device(device)
    _tf32_off(dev)
    prev = set_dp_group(world_group())
    try:
        out = {impl: run_iterations(impl=impl, device=dev, **job)
               for impl in impls}
        if time_reduce:
            calls = sum(r["reduce_calls"] for r in out.values())
            numel = sum(r["reduce_bytes"] for r in out.values()) // (
                4 * calls)
            out["reduce_ms"] = time_all_reduce(numel, dev)
            out["reduce_numel"] = numel
    finally:
        set_dp_group(prev)
    _save(out_dir, rank, out)


def train_rank(rank: int, world: int, device, job: dict,
               out_dir: str) -> None:
    """``train()`` on this rank with ``job["cfg"]`` for each run of
    ``job["runs"]`` (:func:`_train_runs`; a restore loads rank 0's
    checkpoint file), TF32 off. -> each run's checkpoint histories and
    counters (:data:`HISTORY_KEYS`), weights, Adam state, launches,
    seconds and all-reduce calls and bytes."""
    from grouptraj_torch.train.loop import train

    def run(tcfg, dev):
        ckpt, state = train(job["cfg"], tcfg, device=dev, return_state=True)
        adam = {}
        for part, module, opt in (("g", state.g, state.g_opt),
                                  ("d", state.d, state.d_opt)):
            for name, p in module.named_parameters():
                for k, v in opt.state[p].items():
                    adam[f"{part}.{name}.{k}"] = v.detach().cpu()
        return {"ckpt": _histories(ckpt),
                "g": _cpu(state.g.named_parameters()),
                "d": _cpu(state.d.named_parameters()), "adam": adam}

    dev = torch.device(device)
    _tf32_off(dev)
    prev = set_dp_group(world_group())
    try:
        runs = _train_runs(rank, dev, job, run, os.path.join(
            "rank0", f"{job['tcfg'].checkpoint_name}_with_model.pt"))
    finally:
        set_dp_group(prev)
    _save(out_dir, rank, {"runs": runs})


def sweep_rank(rank: int, world: int, device, job: dict,
               out_dir: str) -> None:
    """A multi-seed sweep on this rank, TF32 off:

    - for each entry of ``job.get("iterations", {})``,
      :func:`run_iterations_many` of its keywords (``"iterations"`` in the
      result, by the entry's name);
    - ``train_many`` of ``job["seeds"]`` with ``job["cfg"]`` for each run
      of ``job.get("runs", ())`` (:func:`_train_runs`; a restore loads
      rank 0's sweep directory): per run each seed's checkpoint histories
      and counters (:data:`HISTORY_KEYS`) and generator state, the stacked
      weights and Adam moments, the launches, the seconds and the
      all-reduce's calls and bytes (``"runs"``)."""
    from grouptraj_torch.train.multi import RNG_KEY, train_many

    def run(tcfg, dev):
        ckpts, st = train_many(job["cfg"], tcfg, job["seeds"], device=dev,
                               return_state=True)
        return dict(stacked_tensors(st), ckpt={
            s: {**_histories(ck), RNG_KEY: torch.from_numpy(ck[RNG_KEY])}
            for s, ck in ckpts.items()})

    dev = torch.device(device)
    _tf32_off(dev)
    prev = set_dp_group(world_group())
    try:
        out = {"iterations": {
            name: run_iterations_many(device=dev, **kw)
            for name, kw in job.get("iterations", {}).items()},
            "runs": _train_runs(rank, dev, job, run, "rank0")
            if job.get("runs") else []}
    finally:
        set_dp_group(prev)
    _save(out_dir, rank, out)


def _train_runs(rank: int, dev: torch.device, job: dict, run: Callable,
                restore_from: str) -> List[dict]:
    """``run(tcfg, dev)`` (a ``train()`` or ``train_many`` call -> what it
    records) for each (num_iterations, restore) of ``job["runs"]`` in
    turn, ``tcfg`` being ``job["tcfg"]`` at that many iterations with its
    own output directory a rank, ``<output_dir>/rank<r>`` (so the files
    show which rank wrote), and on a restore ``restore_from`` under
    ``<output_dir>`` (rank 0's files); the split under ``job["data_dir"]``
    (``GROUPTRAJ_DATA_DIR``). -> per run its record with the launches,
    the seconds and the installed group's all-reduce calls and bytes."""
    os.environ["GROUPTRAJ_DATA_DIR"] = job["data_dir"]
    base, dp = job["tcfg"], get_dp_group()
    out = []
    for iters, restore in job["runs"]:
        tcfg = dataclasses.replace(
            base, num_iterations=iters,
            output_dir=os.path.join(base.output_dir, f"rank{rank}"),
            checkpoint_start_from=(os.path.join(base.output_dir,
                                                restore_from)
                                   if restore else None))
        _sync(dev)
        _reset_counts()
        calls0, bytes0 = dp.calls, dp.bytes
        t0 = time.perf_counter()
        rec = run(tcfg, dev)
        _sync(dev)
        out.append(dict(rec, seconds=time.perf_counter() - t0,
                        launches=_kernel_counts(),
                        reduce_calls=dp.calls - calls0,
                        reduce_bytes=dp.bytes - bytes0))
    return out


def _histories(ckpt: dict) -> dict:
    return {k: (dict(ckpt[k]) if isinstance(ckpt[k], dict) else ckpt[k])
            for k in HISTORY_KEYS}


def cli_rank(rank: int, world: int, device, job: dict, out_dir: str) -> None:
    """``python -m grouptraj_torch.train.<job["entry"]>`` (``cli``, the
    default, or ``cli_many``) with ``job["argv"]`` on this rank as
    ``torchrun`` would start it (``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``
    set; the CLI joins the group already made), the split under
    ``job["data_dir"]``: its checkpoint's histories and counters (by seed
    for ``cli_many``)."""
    entry = job.get("entry", "cli")
    main = importlib.import_module(f"grouptraj_torch.train.{entry}").main
    os.environ.update(GROUPTRAJ_DATA_DIR=job["data_dir"],
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    out = main(list(job["argv"]))
    _save(out_dir, rank, {"ckpt": (
        {s: _histories(ck) for s, ck in out.items()}
        if entry == "cli_many" else _histories(out))})


def each_rank(rank: int, world: int, device, calls: Sequence) -> None:
    """Several rank functions in one spawn (one process start): ``fn(rank,
    world, device, job, out_dir)`` for each ``(fn, job, out_dir)`` of
    ``calls`` in turn."""
    for fn, job, out_dir in calls:
        fn(rank, world, device, job, out_dir)


def dryrun_data_parallel(n_ranks: int = 2) -> None:
    """Data-parallel dry run on ``n_ranks`` gloo ranks on the CPU: the
    gat preset at narrow widths (best_k 3, batch 2 scenes a rank),
    :func:`run_iterations` over two bucket widths (12 scenes at N=8, then 6
    at N=16, 2 iterations each, as ``dryrun_multichip``'s production
    stage) and, in the same spawn, :func:`run_iterations_many` of two
    seeds over the same batches (its stage 4: the seed vmap over the
    scene shards), each against the same in one process: every loss and
    norm within 1e-5 of its history's largest, every weight within 1e-6.
    The inter-group attention vectors, whose gradients are rounding noise
    that Adam's steps scale up to about lr, are held to lr an iteration.
    Raises AssertionError on a mismatch."""
    cfg = ModelConfig(embedding_dim=8, encoder_h_dim_g=16, decoder_h_dim_g=16,
                      noise_dim=(4,), bottleneck_dim=4, hidden_units=12,
                      graph_out_dim=8, encoder_h_dim_d=12, mlp_dim=16)
    tcfg = TrainConfig(best_k=3, batch_size=2 * n_ranks, bf16_nograd=False)
    rng = np.random.default_rng(0)
    runs = [(dict(num_seq=num_seq, N=width, seed=width),
             rng.integers(0, num_seq, (2, 2, tcfg.batch_size)))
            for width, num_seq in ((8, 12), (16, 6))]
    job = dict(cfg=cfg, tcfg=tcfg, runs=runs, state_seed=6, gen_seed=7)
    # replica 0 is the state and draws of the single-seed stage
    many = dict(cfg=cfg, tcfg=tcfg, runs=runs, state_seeds=(6, 7),
                gen_seeds=(7, 8))
    one = run_iterations(impl="scan", device="cpu", **job)
    one_many = run_iterations_many(device="cpu", **many)
    out = tempfile.mkdtemp(prefix="grouptraj_dryrun_")
    try:
        dirs = [os.path.join(out, k) for k in ("iters", "many")]
        for d in dirs:
            os.makedirs(d)
        spawn(each_rank, n_ranks, "gloo",
              init_file=os.path.join(out, "store"),
              args=([(iterations_rank, dict(job, impls=("scan",)), dirs[0]),
                     (sweep_rank, dict(iterations={"dryrun": many}),
                      dirs[1])],))
        ranks, sweeps = (load_results(d, n_ranks) for d in dirs)
    finally:
        shutil.rmtree(out, ignore_errors=True)

    def hold(where, got, ref, pick, noisy):
        for k, h in ref["history"].items():
            h, g = pick(h), pick(got["history"][k])
            err = (g - h).abs().max() / max(h.abs().max(), 1e-12)
            assert err <= 1e-5, f"{where}: {k} {g} against one process {h}"
        for part, lr in (("g", tcfg.g_learning_rate),
                         ("d", tcfg.d_learning_rate)):
            for name, w in ref[part].items():
                err = (pick(got[part][name]) - pick(w)).abs()
                tol = torch.where(noisy(part, name),
                                  lr * ref["iterations"], 1e-6)
                assert (err <= tol).all(), \
                    f"{where}: {part}.{name} off by {err.max()}"

    # the sweep's noise is where the one-process Adam's gradient RMS is
    # under 1e-6 of its network's largest (the inter-group vectors, and
    # here the intra-group output vector too)
    def rms(part, i, name):
        return one_many["adam"][f"{part}.{name}.exp_avg_sq"][i].sqrt()

    for r in range(n_ranks):
        hold(f"rank {r}", ranks[r]["scan"], one, lambda x: x,
             lambda part, name: torch.tensor(".gat_inter." in name
                                             and name.endswith(".a")))
        for i in range(len(many["state_seeds"])):
            top = {part: max(rms(part, i, n).max() for n in one_many[part])
                   for part in ("g", "d")}
            hold(f"rank {r} seed {i} of the sweep",
                 sweeps[r]["iterations"]["dryrun"], one_many,
                 lambda x, i=i: x[i],
                 lambda part, name, i=i, top=top: rms(part, i, name)
                 < 1e-6 * top[part])
