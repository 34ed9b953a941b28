"""Times the LSTM kernels K3 (``lstm_fused_fwd``, the whole-loop
recurrence), K4 (``lstm_fused_bwd``, its backward), K5 (``lstm_proj_fwd``,
the LSTM with its input projection in the kernel) and K6
(``lstm_proj_bwd``, K5's backward) of one checkout of this port on one CUDA
card, at the shapes chip_smoke.py times, so that two versions of a kernel
can be compared on one card in one run:

    python3 grouptraj_torch/proj_times.py                  # this checkout
    python3 grouptraj_torch/proj_times.py --root OTHER     # another one
    python3 grouptraj_torch/proj_times.py --kernel K5      # K5 only
    python3 grouptraj_torch/proj_times.py --shapes wide    # H = 128 shapes

``--root`` is the directory that holds the other checkout's
``grouptraj_torch/`` (its kernels are built there); the inputs and the
timers are this script's and this checkout's chip_smoke.py's, the same for
every root. Inputs as chip_smoke.py's check_lstm (K3 at its six main
shapes, ``LSTM_MAIN``, residuals saved where the training step saves them;
K4 at those of them that save residuals: a non-zero initial state, K3's
residuals, a cotangent on hT only for the encoders and on ys for the
decoder) and check_proj (K5 at its four main shapes, ``PROJ_MAIN``, with
or without residuals as the main paths save them; K6 at those that save
them: K5's residuals, a cotangent on hT only) make them. With ``--shapes
wide`` the shapes are chip_smoke.py's ``WIDE_LSTM`` and ``WIDE_PROJ`` (the
H=128 / D=32 scale configuration's, which run the wide design,
csrc/lstm_wide_*.cu). Per shape it prints one JSON line:

- ``ms``: chip_smoke.py's ``time_ms`` (median of 20 single-call CUDA-event
  times, each call queued behind a ~1 ms sleep kernel, so the events hold
  device work only);
- ``device_ms``: torch.profiler's device time per call (mean of 20), every
  kernel and fill of the call; ``kernels``: the same by kernel (the
  kernel's own and the block-order sum of its partials).

Run the versions in turns (A, B, B, A) in one session: cards differ, and
a card below its power limit's maximum runs slower under load.

With ``--iteration fused`` (or ``pallas``) it times instead the JAX
package's H=128 scale configuration's training iteration on that route
(chip_smoke.py's wide phase: ``WIDE_MODEL``, S=64, N=128, batch 64,
best_k 20, float32 no-grad legs, seeded weights): one JSON line with the
wall ms an iteration (median of 5 synchronised runs of 3 iterations) and
torch.profiler's device ms an iteration by kernel over 3 iterations. Run
the checkouts in turns here too:

    python3 grouptraj_torch/proj_times.py --iteration fused --root OTHER

With ``--compare`` (and ``--root OTHER``) nothing is timed: each kernel
call runs once on this checkout's kernels and once on OTHER's, on the same
inputs, and one JSON line a shape says of each output whether the two are
bit-equal or how far apart they are (largest absolute difference):

    python3 grouptraj_torch/proj_times.py --shapes wide --kernel K3 \
        --root OTHER --compare
"""

import argparse
import functools
import importlib
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def k3_calls(cs, seed, shapes):
    """(shape name, one K3 call) at each of ``shapes`` (chip_smoke's
    LSTM_MAIN or WIDE_LSTM)."""
    import torch
    from grouptraj_torch.ops.cuda_lstm import lstm_fused_fwd
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for name, T, B, H, with_gx, save, _ in shapes:
        w, h0, c0, gx, b, _ = cs.lstm_inputs(gen, T, B, H, with_gx)
        yield name, lambda: lstm_fused_fwd(w, h0, c0, gx=gx, b=b, T=T,
                                           save=save)


def k4_calls(cs, seed, shapes):
    """(shape name, one K4 call) at each of ``shapes`` that saves
    residuals."""
    import torch
    from grouptraj_torch.ops.cuda_lstm import lstm_fused_bwd, lstm_fused_fwd
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for name, T, B, H, with_gx, save, cot in shapes:
        if not save:
            continue
        w, h0, c0, gx, b, cots = cs.lstm_inputs(gen, T, B, H, with_gx)
        ys, _, _, gates, cs_ = lstm_fused_fwd(w, h0, c0, gx=gx, b=b, T=T,
                                              save=True)
        given = [c if use else None for c, use in zip(cots, cot)]
        bargs = (w, h0, c0, ys, gates, cs_, *given, with_gx)
        yield name, lambda: lstm_fused_bwd(*bargs)


def k5_calls(cs, seed, shapes):
    """(shape name, one K5 call) at each of ``shapes`` (chip_smoke's
    PROJ_MAIN or WIDE_PROJ)."""
    import torch
    from grouptraj_torch.ops.cuda_lstm_proj import lstm_proj_fwd
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for name, T, B, D, H, save in shapes:
        args = cs.proj_inputs(gen, T, B, D, H)
        yield name, lambda: lstm_proj_fwd(*args, save=save)


def k6_calls(cs, seed, shapes):
    """(shape name, one K6 call) at each of ``shapes`` that saves
    residuals."""
    import torch
    from grouptraj_torch.ops.cuda_lstm_proj import lstm_proj_bwd, lstm_proj_fwd
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for name, T, B, D, H, save in shapes:
        if not save:
            continue
        w_ih, w_hh, b, xs, h0, c0 = cs.proj_inputs(gen, T, B, D, H)
        ys, _, _, gates, cs_ = lstm_proj_fwd(w_ih, w_hh, b, xs, h0, c0,
                                             save=True)
        dhT = torch.randn(B, H, generator=gen, device="cuda")
        bargs = (w_ih, w_hh, xs, h0, c0, ys, gates, cs_, None, dhT, None)
        yield name, lambda: lstm_proj_bwd(*bargs)


def iteration_times(cs, impl):
    """The scale configuration's training iteration on route ``impl``,
    from one seeded state (chip_smoke's wide phase): wall ms an iteration
    and device ms an iteration by kernel."""
    import copy
    import dataclasses
    import statistics
    import time
    import torch
    from grouptraj_torch.config import ModelConfig, TrainConfig
    from grouptraj_torch.train.device_data import (
        gather_batch, synthetic_device_data,
    )
    from grouptraj_torch.train.steps import (
        train_iterations, train_state_from_modules,
    )
    cfg = dataclasses.replace(ModelConfig(), **cs.WIDE_MODEL)
    tcfg = dataclasses.replace(TrainConfig(), bf16_nograd=False)
    data = synthetic_device_data(256, cs.WIDE_N, seed=5, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    idx = torch.randint(0, 256, (cs.WIDE_ITERS, 2, tcfg.batch_size),
                        generator=gen, device="cuda")
    batch = gather_batch(data, idx[0, 0], cfg.obs_len)
    state, _, _ = cs.alive_state(cfg, tcfg, batch, gen)

    def run():
        st = train_state_from_modules(copy.deepcopy(state.g),
                                      copy.deepcopy(state.d), tcfg)
        g = torch.Generator(device="cuda").manual_seed(31)
        train_iterations(st, data, idx, cfg, tcfg, g, impl=impl)

    run()
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / cs.WIDE_ITERS)
    by_kernel = cs.device_ms_by_kernel(run, reps=1)
    return statistics.median(walls), {
        k: v / cs.WIDE_ITERS for k, v in by_kernel.items()}


def use_checkout(root):
    """Import ``grouptraj_torch`` from the checkout at ``root`` from now on
    (the modules imported so far are dropped; the kernel calls import
    theirs when they run)."""
    for name in list(sys.modules):
        if name == "grouptraj_torch" or name.startswith("grouptraj_torch."):
            del sys.modules[name]
    sys.path.insert(0, root)
    importlib.invalidate_caches()


def outputs_of(calls):
    """{shape: the call's outputs, None kept as None} for each call."""
    return {name: tuple(None if t is None else t.clone() for t in run())
            for name, run in calls}


def compare(kernels, other):
    """Each kernel's calls on this checkout and on ``other``, one JSON line
    a shape: per output "equal" or the largest absolute difference."""
    import torch
    for kernel, make in kernels:
        use_checkout(HERE)
        mine = outputs_of(make())
        use_checkout(other)
        theirs = outputs_of(make())
        torch.cuda.synchronize()
        for name, outs in mine.items():
            verdict = []
            for x, y in zip(outs, theirs[name]):
                if x is None or y is None:
                    verdict.append(None if x is y else "given by one only")
                elif torch.equal(x, y):
                    verdict.append("equal")
                else:
                    verdict.append((x - y).abs().max().item())
            print(json.dumps({"kernel": kernel, "shape": name,
                              "outputs": verdict}))
        del mine, theirs
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose grouptraj_torch is timed")
    ap.add_argument("--kernel", choices=("K3", "K4", "K5", "K6", "all"),
                    default="all")
    ap.add_argument("--shapes", choices=("main", "wide"), default="main",
                    help="chip_smoke's LSTM_MAIN / PROJ_MAIN, or WIDE_LSTM "
                         "/ WIDE_PROJ")
    ap.add_argument("--iteration", choices=("fused", "pallas"),
                    help="time the scale configuration's training "
                         "iteration on this route instead")
    ap.add_argument("--compare", action="store_true",
                    help="no timing: this checkout's outputs against "
                         "--root's on the same inputs")
    ap.add_argument("--seed", type=int, default=None,
                    help="input seed (default: chip_smoke's, 7 for K3 and "
                         "K4 and 11 for K5 and K6)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")

    if args.iteration:
        use_checkout(root)
        import grouptraj_torch
        wall, by_kernel = iteration_times(cs, args.iteration)
        wide = {k[:60]: v for k, v in by_kernel.items()
                if "lstm_wide" in k or "split_" in k or "reduce_part" in k}
        print(json.dumps({"route": args.iteration,
                          "root": os.path.dirname(grouptraj_torch.__file__),
                          "wall_ms": wall,
                          "device_ms": sum(by_kernel.values()),
                          "wide_kernels_ms": wide}))
        return
    lstm, proj = ((cs.LSTM_MAIN, cs.PROJ_MAIN) if args.shapes == "main"
                  else (cs.WIDE_LSTM, cs.WIDE_PROJ))
    kernels = []
    for kernel, calls, shapes, seed in (("K3", k3_calls, lstm, 7),
                                        ("K4", k4_calls, lstm, 7),
                                        ("K5", k5_calls, proj, 11),
                                        ("K6", k6_calls, proj, 11)):
        if args.kernel in (kernel, "all"):
            kernels.append((kernel, functools.partial(
                calls, cs, seed if args.seed is None else args.seed,
                shapes)))
    if args.compare:
        if root == HERE:
            cs.fail("--compare needs --root OTHER")
        print(f"proj_times: {HERE} against {root}")
        compare(kernels, root)
        return
    use_checkout(root)
    import grouptraj_torch
    print(f"proj_times: timing {os.path.dirname(grouptraj_torch.__file__)}")
    for kernel, make in kernels:
        calls = make()
        for name, run in calls:
            ms = cs.time_ms(run)
            by_kernel = cs.device_ms_by_kernel(run)
            print(json.dumps({"kernel": kernel, "shape": name, "ms": ms,
                              "device_ms": sum(by_kernel.values()),
                              "kernels": {k[:80]: v
                                          for k, v in by_kernel.items()}}))
            del run
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
