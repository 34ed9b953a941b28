"""Times kernel K6 (``lstm_proj_bwd``, the backward of the LSTM with its
input projection in the kernel) of one checkout of this port on one CUDA
card, at the encoder shapes chip_smoke.py times, so that two versions of the
kernel can be compared in one machine session:

    python3 grouptraj_torch/proj_times.py                  # this checkout
    python3 grouptraj_torch/proj_times.py --root OTHER     # another one

``--root`` is the directory that holds the other checkout's
``grouptraj_torch/`` (its kernels are built there); the inputs and the
timers are this script's and this checkout's chip_smoke.py's, the same for
every root. Inputs as chip_smoke.py's check_proj makes them (a non-zero
initial state, K5's residuals, a cotangent on hT only). Per shape it prints
one JSON line:

- ``ms``: chip_smoke.py's ``time_ms`` (median of 20 single-call CUDA-event
  times, each call queued behind a ~1 ms sleep kernel, so the events hold
  device work only);
- ``device_ms``: torch.profiler's device time per call (mean of 20), every
  kernel and fill of the call; ``kernels``: the same by kernel (K6's own
  and the block-order sum of its partials).

Run the versions in turns (A, B, B, A) in one session: cards differ, and
a card below its power limit's maximum runs slower under load.
"""

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, T, B, D, H): chip_smoke.py's timed shapes that run K6
SHAPES = (("G_encoder_T8_B4096_D16_H32", 8, 4096, 16, 32),
          ("D_encoder_T20_B4096_D16_H48", 20, 4096, 16, 48),
          ("D_encoder_T20_B8192_D16_H48", 20, 8192, 16, 48))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose grouptraj_torch is timed")
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    import grouptraj_torch
    from grouptraj_torch.ops.cuda_lstm_proj import lstm_proj_bwd, lstm_proj_fwd
    print(f"proj_times: timing {os.path.dirname(grouptraj_torch.__file__)}")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    for name, T, B, D, H in SHAPES:
        w_ih, w_hh = r(D, 4 * H) / H ** 0.5, r(H, 4 * H) / H ** 0.5
        b, xs, h0, c0 = 0.1 * r(4 * H), r(T, B, D), 0.5 * r(B, H), 0.5 * r(B, H)
        ys, _, _, gates, cs_ = lstm_proj_fwd(w_ih, w_hh, b, xs, h0, c0,
                                             save=True)
        bargs = (w_ih, w_hh, xs, h0, c0, ys, gates, cs_, None, r(B, H), None)
        run = lambda: lstm_proj_bwd(*bargs)
        ms = cs.time_ms(run)
        kernels = cs.device_ms_by_kernel(run)
        print(json.dumps({"kernel": "K6", "shape": name, "ms": ms,
                          "device_ms": sum(kernels.values()),
                          "kernels": {k[:80]: v
                                      for k, v in kernels.items()}}))
        del bargs, run
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
