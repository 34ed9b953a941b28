"""Times the social-pool kernels K1 (``pool_core_fwd``) and K2
(``pool_core_bwd``) of one checkout of this port on one CUDA card, at the
shapes chip_smoke.py times, so that two versions of the kernels can be
compared in one machine session:

    python3 grouptraj_torch/pool_times.py                  # this checkout
    python3 grouptraj_torch/pool_times.py --root OTHER     # another one

``--root`` is the directory that holds the other checkout's
``grouptraj_torch/`` (its kernels are built there); the inputs, the masks
and the timers are this script's and chip_smoke.py's, the same for every
root. Per shape it prints one JSON line:

- ``ms``: chip_smoke.py's ``time_ms`` (median of 20 single-call CUDA-event
  times, each call queued behind a ~1 ms sleep kernel, so the events hold
  device work only);
- ``device_ms``: torch.profiler's device time per call (mean of 20), every
  kernel, copy and fill of the call; ``kernels``: the same by kernel.

Run the versions in turns (A, B, B, A) in one session: cards differ, and
a card below its power limit's maximum runs slower under load.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, S, N, pedestrians per scene lo..hi, B): chip_smoke.py's timed shapes
FWD_SHAPES = (("S64_N64_B8", 64, 64, 2, 57, 8),
              ("S256_N16_B8", 256, 16, 2, 16, 8),
              ("S128_N64_B48", 128, 64, 2, 57, 48),
              ("S64_N64_B48", 64, 64, 2, 57, 48),
              ("S64_N64_B8_dense", 64, 64, 64, 64, 8))
BWD_SHAPES = (("S64_N64_B8", 64, 64, 2, 57, 8),
              ("S128_N64_B48", 128, 64, 2, 57, 48),
              ("S64_N64_B48", 64, 64, 2, 57, 48),
              ("S256_N16_B8", 256, 16, 2, 16, 8))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose grouptraj_torch is timed")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, HERE]
    import numpy as np
    import torch
    import chip_smoke as cs
    from grouptraj_torch.ops.cuda_pool import pool_core_bwd, pool_core_fwd
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    import grouptraj_torch
    print(f"pool_times: timing {os.path.dirname(grouptraj_torch.__file__)}")

    rng = np.random.default_rng(args.seed)
    for kind, shapes in (("K1", FWD_SHAPES), ("K2", BWD_SHAPES)):
        for name, S, N, lo, hi, B in shapes:
            valid = cs.realistic_valid(rng, S, N, lo, hi)
            ins = cs.pool_inputs(rng, valid, B=B)
            if kind == "K1":
                run = lambda: pool_core_fwd(*ins)
            else:
                pooled, cnt = pool_core_fwd(*ins)
                dpool = torch.randn(pooled.shape, device="cuda",
                                    generator=torch.Generator("cuda")
                                    .manual_seed(args.seed))
                run = lambda: pool_core_bwd(*ins, pooled, cnt, dpool)
            ms = cs.time_ms(run)
            kernels = cs.device_ms_by_kernel(run)
            print(json.dumps({"kernel": kind, "shape": name, "ms": ms,
                              "device_ms": sum(kernels.values()),
                              "kernels": {k[:80]: v
                                          for k, v in kernels.items()}}))
            del ins, run
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
