"""Times the LSTM backward kernels K4 (``lstm_fused_bwd``, the whole-loop
recurrence's backward) and K6 (``lstm_proj_bwd``, the backward of the LSTM
with its input projection in the kernel) of one checkout of this port on one
CUDA card, at the shapes chip_smoke.py times, so that two versions of a
kernel can be compared in one machine session:

    python3 grouptraj_torch/proj_times.py                  # this checkout
    python3 grouptraj_torch/proj_times.py --root OTHER     # another one
    python3 grouptraj_torch/proj_times.py --kernel K4      # K4 only

``--root`` is the directory that holds the other checkout's
``grouptraj_torch/`` (its kernels are built there); the inputs and the
timers are this script's and this checkout's chip_smoke.py's, the same for
every root. Inputs as chip_smoke.py's check_lstm (K4: a non-zero initial
state, K3's residuals, a cotangent on hT only for the encoders and on ys
for the decoder) and check_proj (K6: K5's residuals, a cotangent on hT
only) make them. Per shape it prints one JSON line:

- ``ms``: chip_smoke.py's ``time_ms`` (median of 20 single-call CUDA-event
  times, each call queued behind a ~1 ms sleep kernel, so the events hold
  device work only);
- ``device_ms``: torch.profiler's device time per call (mean of 20), every
  kernel and fill of the call; ``kernels``: the same by kernel (the
  kernel's own and the block-order sum of its partials).

Run the versions in turns (A, B, B, A) in one session: cards differ, and
a card below its power limit's maximum runs slower under load.
"""

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, T, B, H, gx variant): chip_smoke.py's timed shapes that run K4
K4_SHAPES = (("G_encoder_T8_B4096_H32", 8, 4096, 32, True),
             ("D_encoder_T20_B4096_H48", 20, 4096, 48, True),
             ("D_encoder_T20_B8192_H48", 20, 8192, 48, True),
             ("decoder_T11_B8192_H32", 11, 8192, 32, False))
# (name, T, B, D, H): chip_smoke.py's timed shapes that run K6
K6_SHAPES = (("G_encoder_T8_B4096_D16_H32", 8, 4096, 16, 32),
             ("D_encoder_T20_B4096_D16_H48", 20, 4096, 16, 48),
             ("D_encoder_T20_B8192_D16_H48", 20, 8192, 16, 48))


def k4_calls(cs, seed):
    """(shape name, one K4 call) at each of K4_SHAPES."""
    import torch
    from grouptraj_torch.ops.cuda_lstm import lstm_fused_bwd, lstm_fused_fwd
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for name, T, B, H, with_gx in K4_SHAPES:
        w, h0, c0, gx, b, (dys, dhT, _) = cs.lstm_inputs(gen, T, B, H,
                                                         with_gx)
        ys, _, _, gates, cs_ = lstm_fused_fwd(w, h0, c0, gx=gx, b=b, T=T,
                                              save=True)
        cot = (None, dhT, None) if with_gx else (dys, None, None)
        bargs = (w, h0, c0, ys, gates, cs_, *cot, with_gx)
        yield name, lambda: lstm_fused_bwd(*bargs)


def k6_calls(seed):
    """(shape name, one K6 call) at each of K6_SHAPES."""
    import torch
    from grouptraj_torch.ops.cuda_lstm_proj import lstm_proj_bwd, lstm_proj_fwd
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    for name, T, B, D, H in K6_SHAPES:
        w_ih, w_hh = r(D, 4 * H) / H ** 0.5, r(H, 4 * H) / H ** 0.5
        b, xs, h0, c0 = 0.1 * r(4 * H), r(T, B, D), 0.5 * r(B, H), 0.5 * r(B, H)
        ys, _, _, gates, cs_ = lstm_proj_fwd(w_ih, w_hh, b, xs, h0, c0,
                                             save=True)
        bargs = (w_ih, w_hh, xs, h0, c0, ys, gates, cs_, None, r(B, H), None)
        yield name, lambda: lstm_proj_bwd(*bargs)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose grouptraj_torch is timed")
    ap.add_argument("--kernel", choices=("K4", "K6", "all"), default="all")
    ap.add_argument("--seed", type=int, default=None,
                    help="input seed (default: chip_smoke's, 7 for K4 and "
                         "11 for K6)")
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
    print(f"proj_times: timing {os.path.dirname(grouptraj_torch.__file__)}")

    kernels = []
    if args.kernel in ("K4", "all"):
        kernels.append(("K4", k4_calls(cs, 7 if args.seed is None
                                        else args.seed)))
    if args.kernel in ("K6", "all"):
        kernels.append(("K6", k6_calls(11 if args.seed is None
                                       else args.seed)))
    for kernel, calls in kernels:
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
