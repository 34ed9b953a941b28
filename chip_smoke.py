"""Drive the PyTorch/CUDA port (grouptraj_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Phases, each of which fails the run on any error:
1. device: the card's name and power limit; TF32 off for matmuls and cuDNN;
2. build: every kernel under grouptraj_torch/csrc/ with nvcc, timed, with
   ptxas's registers, shared memory and spills; the count of tensor-core
   (HMMA) instructions in the pool kernels', K3's, K4's, K5's and K6's SASS
   (cuobjdump), which must not be 0 for K1's and K2's tile kernels and for
   any instance of K3, K4, K5 or K6, and the bfloat16 HMMA
   (HMMA.16816.F32.BF16) in their tiles, present in every bf16-mode
   instance and in no exact-mode one;
3. kernel: K1 (the social-pool pair core, csrc/pool_core_fwd.cu)
   against its plain PyTorch version on the card: the serving buckets, the
   per-step decoder's pool in a best-of-20 decode (S=1,280, N=64), the
   discriminator's B=48 at S=128 and S=64 (N=64), R=2, ragged masks with
   holes and pad scenes, ReLU and duplicate-row ties, bf16 weights at B=8
   and 48, odd sizes (N=70, K=260, B=5), B=100 (two launches), N=256 at
   B=48; then K2 (its backward, csrc/pool_core_bwd.cu) against its plain
   version at the training shapes (S=64/N=64/B=8, S=128/N=64/B=48,
   S=256/N=16, and the per-step decoder's S=1,280/N=64/B=8), R=2, holes, pad scenes, odd sizes, ReLU-zero,
   duplicate-row and exact-input ties, N=256 at B=48 (too wide to stage a
   scene in shared memory), a cotangent that is non-zero at invalid rows,
   and the recount of the forward's tie counts; kernel and plain times by
   CUDA events beside the float32-core and the tensor-core bound, and K2's
   four kernels timed apart by torch.profiler; then K3 (the
   whole-loop LSTM recurrence, csrc/lstm_fused_fwd.cu)
   and K4 (its backward, csrc/lstm_fused_bwd.cu), both variants, against
   their plain versions at the full-width shapes of the training step and
   of serving (generator encoder T=8/B=4,096/H=32, discriminator encoder
   T=20/B=8,192/H=48, decoder T=11 at B=8,192 with residuals and at
   B=81,920 without) and at odd sizes (B=1, B=70, T=1, H=8, 16 and 64, a
   ragged B=4,097 at H=8 and 64, all cotangents non-zero or only dhT);
   times beside the float32-core and the tensor-core bound, and
   torch.nn.LSTM (cuDNN) beside matmul + K3 (+ K4) at the encoder shapes;
   then K5 (the LSTM with its input projection in the kernel,
   csrc/lstm_proj_fwd.cu) and K6 (its backward, csrc/lstm_proj_bwd.cu)
   against their plain versions at the encoders' full-width shapes
   (generator T=8/B=4,096/D=16/H=32 with residuals and, as served, without;
   discriminator T=20/D=16/H=48 at B=8,192 and 4,096, a cotangent on hT
   only) and at odd sizes (B=1, B=70, T=1, D=4 and 8, H=8, 16 and 64, all
   cotangents non-zero or only dhT), non-zero initial states throughout;
   times beside the float32-core and the tensor-core bound, and
   torch.nn.LSTM's forward and forward +
   backward beside K5 and K5 + K6 at the encoder shapes;
4. serve: the zoo checkpoint zara1_12 (the ``gat`` preset at full width)
   served at k=20 through Predictor.predict_batch on realistic scenes at
   the (S=64, N=64) and (S=256, N=16) buckets, with the launch counts of
   that run; then the same predictor forced to the plain pool core, the
   port on the CPU on a small batch, the default bf16 predictor, and
   serving throughput per bucket; then the same generator through
   generator_context + generator_sample_many with impl='fused' (K3 for the
   encoder and the decoder) and with impl='pallas' (K5 for the encoder)
   against impl='scan': positions and ms per call of the three routes, in
   turns;
5. profile: torch.profiler over three bf16 calls at S=64, N=64 — device
   busy share and time by kernel (table in chiprun_out/profile_serve.txt);
6. eval: a synthetic ETH/UCY-format split (3 files, ~1,600 windows of
   2-48 pedestrians) windowed by the port's TrajectoryDataset on the
   native path, checked bit-identical to its numpy path; evaluate_bucketed
   (3 buckets, batch 64, k=20) for the zoo's zara1_12 (gat), univ_12
   (gat-mh) and zara1_12_gcnpool on the scan, fused and pallas routes with
   shared injected noises, with the launch counts of each route's run:
   kernel routes against scan and, on the first batch of each bucket, the
   card against the port on the CPU (ADE/FDE within 1e-4 relative); ms
   per pass and windows/s of each route in turns; a profile of one
   fused batch (chiprun_out/profile_eval_fused.txt); the univ_12 and
   zara1_12_gcnpool Predictors on the card against the CPU;
7. train: ModelConfig()/TrainConfig() at full width (batch 64, best_k=20)
   from a seeded state on synthetic device-resident data: one iteration's
   losses and every parameter gradient with the kernels against the plain
   pool core, and on a small batch against the port on the CPU; then
   one iteration with lstm_impl='fused' (K3 x7, K4 x4) and one with
   lstm_impl='pallas' (K5 x4, K6 x3) against 'scan' and against the same
   route on the kernels' plain versions; then train_iterations at (S=64,
   N=64) and (S=64, N=16) on the three routes in turns (scan, fused,
   pallas, pallas, fused, scan, each from the same state; TRAIN_ITERS
   iterations a run) with the launch counts of each run, iterations per
   second and ms per d-step and g-step; then torch.profiler over three
   iterations of each route (tables in chiprun_out/profile_train.txt,
   profile_train_fused.txt and profile_train_pallas.txt);
8. loop: the training loop, ``train()``, of the gat preset at full width
   (batch 64, best_k=20, 3 scene-size buckets, dispatches of 20
   iterations, print every 20, checkpoint every 40, seed 6) on a
   synthetic ETH/UCY-format split (three train files, ~1,600 windows; one
   shorter val file): 80 iterations on 'fused' (K1-K4), resumed from its
   file to 100, and 40 on 'pallas' (K1, K2, K5, K6), each with its launch
   counts (at least the per-iteration counts times the iterations), finite
   losses, norms and metrics and both checkpoint files; the file reloads
   into a state whose Adam moments and steps equal the run's bit for bit;
   the saved state's val sweep on the card against the CPU with injected
   draws (1e-4 relative); evaluate_bucketed of g_best_state on the card;
   it/s of each run, ms per sweep event and ms per checkpoint save;
9. presets: the ``gat`` preset with ``pool_every_timestep`` (the decoder
   re-pools at every step: K1 on each of the 12 steps at K·S = 1,280
   scenes, and in the dense g-step K2 on each) served at k=20 through the
   Predictor at (S=64, N=64) and trained (batch 64, best_k=20) on 'scan'
   and 'fused'; then the ``gcn``, ``sgan-p`` and ``sgan`` (local
   discriminator) presets served and trained one iteration each on
   'fused': every model against the plain pool (K1/K2's wrappers swapped
   for their plain versions over scene chunks) and against the CPU on a
   small batch, with launch counts, ms per call, it/s, peak memory and a
   profile of the per-step paths (chiprun_out/profile_serve_pet.txt,
   profile_train_pet.txt);
10. many: multi-seed sweeps, ``train_many`` (the replicas' weights stacked
   on a seed axis, every step under torch.func.vmap, K1/K2 taking the seed
   axis as their replica axis R), the gat preset at full width: each
   replica of a 4-seed sweep against a 1-seed sweep of its own seed for 2
   iterations (TF32 off), K1 x4 and K2 x3 an iteration at R = 4; K1 and K2
   at those R = 4 shapes against their plain versions, timed beside their
   bounds; seed-iterations per second at N = 1, 2 and 4 seeds in turns
   beside train()'s step, the busy share (chiprun_out/
   profile_train_many.txt) and the peak memory of a 4-seed iteration;
   train_many of 4 seeds on a synthetic split (batch 64, best_k 20, 3
   buckets) for 20 iterations with its launches, resumed from its files
   to 30;
11. options: the MLP options of ModelConfig on the ``gat`` preset at
   full width, from the training CLI's flags ``--batch_norm 1``,
   ``--dropout1 0.2`` and ``--dropout 0.2``, and ``activation=
   'leakyrelu'``: a k=20 serving call in eval mode at S=64/N=64, one
   training iteration on 'fused' against the plain kernels and against
   the CPU with one set of keep-masks, 3 iterations on 'fused' and 1 on
   'pallas' (``--dropout`` at N=16) with launches, ms, peak memory and
   busy share; the dropout1 g-step's per-sample forward (vmap over the 20
   samples) runs K3/K4 at 81,920 folded rows, held against their plain
   versions at that shape and timed beside their bounds, and K1/K2 once,
   unbatched (options_phase);
12. many dropout: dropout in multi-seed sweeps (many_dropout_phase):
   train_many of the gat preset from ``--dropout1 0.2`` at full width,
   4 seeds, each drawing its keep-masks from its own generator in
   train()'s order, the g-step's per-sample vmap nested in the seed vmap:
   one 4-seed iteration against each seed's single-seed step on the same
   draws (K1 x4 and K2 x3 at R = 4), K1 and K2 at those shapes against
   their plain versions with bounds, seed-iterations per second at N = 1,
   2 and 4 in turns, peak memory and busy share
   (chiprun_out/profile_train_many_dropout1.txt), train_many of it on a
   synthetic split with its launches; then the ``--dropout 0.2`` model at
   N=16 (its pool's pair path launches no kernel) trained by train_many
   and resumed from its files;
13. dp: data parallelism over scenes (dp_phase) on the one card, two gloo
   ranks on cuda:0 spawned by grouptraj_torch.parallel.data_parallel
   (NCCL refuses two ranks on one device): the gat preset at full width,
   batch 64 (32 scenes a rank), on 'scan' and 'fused', each rank's
   iterations against one process on the same draws (K1 x4 and K2 x3 an
   iteration on each rank), ms an iteration per rank beside the
   one-process step, the all-reduce's bytes and ms (one card, gloo through
   the host: not a multi-card speed); K1 and K2 at a rank's S=32 shapes
   against their plain versions; train() of 20 iterations on the two ranks
   with a checkpoint rank 0 alone writes and that reloads; one iteration
   on the nccl backend at world size 1;
13b. many dp: multi-seed sweeps over the data-parallel ranks
   (many_dp_phase): the gat preset at full width, 2 seeds, batch 64 on two
   gloo ranks on cuda:0 (32 scenes each), train_iterations_many on each
   rank against the same sweep in one process (K1 x4 and K2 x3 an
   iteration on each rank, at R = 2), the ``--dropout1 0.2`` model's sweep
   iteration likewise, K1 and K2 at a rank's R = 2 shapes against their
   plain versions with bounds, train_many on the ranks for 10 iterations
   resumed from rank 0's sweep directory to 20 (rank 0 alone writes the
   s<seed>/ files), and one sweep iteration on nccl at world size 1;
14. bf16: K1 and K2 in their bf16 mode (the TPU kernels' at JAX's default
   matmul precision; ``grouptraj_torch.ops.precision``) against their
   plain versions in that mode at S=64/N=64/B=8, S=256/N=16/B=8,
   S=128/N=64/B=48, S=1,280/N=64/B=8 and R=4/S=128/N=64/B=48 (kernel_bf16_phase,
   run after K2's phase), each timed beside the exact mode on the same
   inputs, its plain version and its bf16 bound, quantized inputs bit-equal,
   bf16 weights; then, last, the paths with the setting at "default"
   (bf16_paths_phase): the zoo Predictor with float32 and bfloat16
   weights, a 'fused' training iteration, the per-step pooling model's
   serving call and iteration, one step of a 2-seed train_iterations_many,
   each with its bf16-mode launches, its drift from the exact mode and,
   for the per-step paths and the f32 serving call, ms per call in either
   mode in turns;
15. wide: K3-K6 at the widths past the register design's (wide_phase, run
   before bf16's paths): the JAX package's H=128 / D=32 / N=128 scale
   configuration's shapes (encoders T=8/B=8,192 and T=20/B=16,384, the
   decoder T=11 at B=16,384 with residuals and at B=163,840 without) and
   widths between the built ones (H=40, H=100, D=12), each against its
   plain version, bit for bit on a repeat and on misaligned views, timed
   beside its bounds and nn.LSTM; that configuration served at k=20 and
   trained 3 iterations on the three routes in turns against 'scan', with
   launches (every K3-K6 launch a wide one), ms, peak memory and the busy
   share of a fused and a pallas iteration; K1 and K2 at its shapes
   (S=64/N=128/B=8 and 128, S=128/N=128/B=128) against their plain
   versions.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository beside it, the script exits non-zero and prints no result.
"""

import contextlib
import dataclasses
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(HERE, "models", "grouptraj", "zara1_12_with_model.pt")
K = 20                       # best-of-k samples served per call
FP32_PEAK = 67e12            # H100 SXM float32 (non-tensor) FLOP/s
TF32_PEAK = 495e12           # H100 SXM TF32 tensor-core FLOP/s, dense
# float32 operations per (pair, k) beside the pool kernels' mma: subtract,
# ReLU, and the split hi = tf32(x), lo = tf32(x - hi)
TC_ELEMENTWISE_OPS = 5
HBM_BW = 3.35e12             # H100 SXM HBM bytes/s
BF16_PEAK = 989e12           # H100 SXM bf16 tensor-core FLOP/s, dense
# float32 operations per (pair, k) beside the bf16 mode's mma: subtract,
# ReLU and the rounding to bfloat16
BF16_ELEMENTWISE_OPS = 3
# K1/K2 in the bf16 mode against their plain versions (kernel_bf16_phase):
# pooled and each of K2's tensors, max |Δ| relative to the reference's
# largest entry (the same exact bf16 products summed in another order)
BF16_RTOL = 1e-5
SLEEP_CYCLES = 2_000_000     # ~1 ms of GPU clock: the stream's lead in time_ms
POOL_ATOL = 1e-4             # kernel vs plain, pooled (see check_kernel)
BWD_RTOL = {"da": 1e-5, "du": 1e-5, "dW2": 1e-4, "db2": 1e-4}  # check_bwd
SERVE_ATOL = 1e-3            # metres, kernel vs plain pool end to end
NEAR_TIE_ATOL = 1e-5         # check_kernel(near_ties=True): a near-tie
# device functions of K1 and K2 (the weight split they share, K1's tile,
# K2's three passes), K3 and K4 (two), K4's and K6's block-order sum, K5
# and K6, and the wide design of K3-K6 (its weight splits, the forward, the
# backward's recurrence, weight gradients and dxs), as a trace names them
PORT_KERNELS = ("split_w_kernel", "pool_core_fwd_kernel", "ties_kernel",
                "tie_grads_kernel", "weight_reduce_kernel",
                "lstm_fused_fwd_kernel", "lstm_fused_bwd_kernel",
                "reduce_partials_kernel", "lstm_proj_fwd_kernel",
                "lstm_proj_bwd_kernel", "split_fwd_kernel",
                "split_bwd_kernel", "lstm_wide_fwd_kernel",
                "lstm_wide_bwd_kernel", "lstm_wide_dw_kernel",
                "lstm_wide_dx_kernel")
# iterations of a training run on each LSTM route
TRAIN_ITERS = {"scan": 10, "fused": 30, "pallas": 20}
LSTM_FWD_ATOL = 1e-5         # K3/K5 vs plain: float32 sums of <= 80 products
LSTM_BWD_RTOL = 1e-4         # K4/K6 vs plain, of each tensor's largest entry
# float32 operations per (step, row, unit) beside the matrix products: the
# forward's 4 adds, 5 activations, 4 for c and h; the backward's tanh,
# cell, carries and the four dz (each activation counted once)
LSTM_GATE_OPS = {"fwd": 13, "bwd": 25}
# one training iteration, kernels vs plain pool and card vs CPU: losses
# relative; each gradient tensor's max |Δ| relative to its largest entry
# (float32 sums in other orders through 20-step LSTMs and the 512-wide
# pool; a selection that flips between two j within rounding of each other
# moves one of ~10^5 pool maxima, a few 10^-3 of a tensor's gradient)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-2
# serving buckets driven: name -> (scenes S, width N, largest scene)
BUCKETS = {"S64_N64": (64, 64, 57), "S256_N16": (256, 16, 16)}


def kernel_name(line):
    """``pool_core_fwd_kernel<6,f32,0>`` (NT, weights, bf16 mode),
    ``ties_kernel<6,1>`` (NT, bf16 mode), ``lstm_fused_fwd_kernel<32,0,0>``
    (H, WITH_GX, SAVE), ``lstm_fused_bwd_kernel<48,1>`` (H, WITH_GX),
    ``lstm_proj_fwd_kernel<16,48,1>`` (D, H, SAVE) or
    ``lstm_proj_bwd_kernel<16,48>``, ``lstm_wide_fwd_kernel<2,1>`` (mode:
    0 K3 gx, 1 K3 decoder, 2 K5; SAVE), ``lstm_wide_bwd_kernel``,
    ``lstm_wide_dw_kernel``, ``lstm_wide_dx_kernel`` or the wide design's
    ``split_fwd_kernel`` / ``split_bwd_kernel`` from a line that names a
    pool kernel's, K3's, K4's, K5's or K6's mangled symbol (ptxas or
    cuobjdump; the base name alone from a profiler's demangled one); None
    for other kernels."""
    m = re.search(r"(lstm_wide_fwd_kernel)(?:ILi(\d+)ELb([01])E)?", line)
    if m is None:
        m = re.search(r"(lstm_wide_(?:bwd|dw|dx)_kernel|split_(?:fwd|bwd)"
                      r"_kernel)", line)
    if m is None:
        m = re.search(
            r"(lstm_fused_fwd_kernel)(?:ILi(\d+)ELb([01])ELb([01])E)?", line)
    if m is None:
        m = re.search(
            r"(lstm_proj_fwd_kernel)(?:ILi(\d+)ELi(\d+)ELb([01])E)?", line)
    if m is None:
        m = re.search(r"(lstm_fused_bwd_kernel)(?:ILi(\d+)ELb([01])E)?", line)
    if m is None:
        m = re.search(r"(lstm_proj_bwd_kernel)(?:ILi(\d+)ELi(\d+)E)?", line)
    if m is not None:
        args = [x for x in m.groups()[1:] if x is not None]
        return m.group(1) + (f"<{','.join(args)}>" if args else "")
    m = re.search(r"((?:split_w|pool_core_fwd|ties|tie_grads|weight_reduce)"
                  r"_kernel)(?:I((?:L[ib]\d+E|13__nv_bfloat16|f)+)E)?", line)
    if m is None:
        return None
    args = [num or ("bf16" if bf else "f32") for num, bf in re.findall(
        r"L[ib](\d+)E|(13__nv_bfloat16)|f", m.group(2) or "")]
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


# libraries whose SASS sass_hmma reads, and the kernels among them that
# must run on the tensor cores: K1's tile, K2's ties pass, K3-K6
HMMA_LIBS = ("pool_core_fwd", "pool_core_bwd", "lstm_fused_fwd",
             "lstm_fused_bwd", "lstm_proj_fwd", "lstm_proj_bwd",
             "lstm_wide_fwd", "lstm_wide_bwd")
HMMA_KERNELS = ("pool_core_fwd_kernel", "ties_kernel",
                "lstm_fused_fwd_kernel", "lstm_fused_bwd_kernel",
                "lstm_proj_fwd_kernel", "lstm_proj_bwd_kernel",
                "lstm_wide_fwd_kernel", "lstm_wide_bwd_kernel",
                "lstm_wide_dw_kernel", "lstm_wide_dx_kernel")
# K1's and K2's pair tiles, each instantiated in both modes
BF16_TILES = ("pool_core_fwd_kernel", "ties_kernel")


def sass_hmma(libs):
    """The count of HMMA (tensor-core mma) instructions in each kernel of
    the pool libraries', K3's, K4's, K5's and K6's SASS, by cuobjdump
    beside nvcc; fails if K1's or K2's tile kernel or any instance of K3,
    K4, K5 or K6 has none, or if a bf16-mode instance of K1's or K2's tile
    (last template argument 1) has no bfloat16 HMMA (HMMA.16816.F32.BF16)
    or an exact-mode one has any. -> (HMMA counts, bf16 HMMA counts of the
    pool tiles); (None, None) where the toolkit has no cuobjdump."""
    from grouptraj_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.isfile(tool):
        print(f"sass: no cuobjdump at {tool}; HMMA count not taken")
        return None, None
    counts, bf16 = {}, {}
    for lib in HMMA_LIBS:
        sass = subprocess.run([tool, "-sass", str(libs[lib])],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
        fn = None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = kernel_name(line)
                if fn is not None:
                    counts[fn] = 0
                    if fn.startswith(BF16_TILES):
                        bf16[fn] = 0
            elif fn is not None and "HMMA" in line:
                counts[fn] += 1
                if fn in bf16 and "HMMA.16816.F32.BF16" in line:
                    bf16[fn] += 1
    print("sass HMMA: " + " ".join(f"{f}={c}" for f, c in counts.items()))
    print("sass bf16 HMMA (HMMA.16816.F32.BF16): "
          + " ".join(f"{f}={c}" for f, c in bf16.items()))
    for kernel in HMMA_KERNELS:
        tiles = [c for f, c in counts.items() if f.startswith(kernel)]
        if not tiles or min(tiles) == 0:
            fail(f"{kernel} runs no tensor-core instruction (HMMA)")
    modes = {f.rstrip(">").split(",")[-1] for f in bf16}
    if modes != {"0", "1"}:
        fail(f"the pool tiles' instances are not of both modes: {sorted(bf16)}")
    for f, c in bf16.items():
        if (c > 0) != f.endswith(",1>"):
            fail(f"{f}: {c} bfloat16 HMMA, against its mode")
    return counts, bf16


def fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(2)


def time_ms(fn, reps=20, warmup=3):
    """Median of ``reps`` single-call CUDA-event times (ms), after warm-up.
    Before each call a ~1 ms sleep kernel holds the stream, so the events
    bracket the call's device work and not the host's time to enqueue it
    (a pool wrapper takes ~60 us of host time, longer than its kernel at
    the serving shapes)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ----------------------------------------------------------------- scenes

def scene_sizes(rng, S, lo, hi):
    """Pedestrians per scene, uniform in [lo, hi], with one scene at hi so
    the batch lands in the bucket of that width."""
    sizes = rng.integers(lo, hi + 1, S)
    sizes[0] = hi
    return sizes


def realistic_valid(rng, S, N, lo, hi, R=1):
    """A [R, S, N] mask of scenes with lo..hi pedestrians (scene_sizes)."""
    import numpy as np
    v = np.zeros((R, S, N))
    for r in range(R):
        for s, n in enumerate(scene_sizes(rng, S, lo, hi)):
            v[r, s, :n] = 1
    return v


def make_scenes(rng, sizes):
    """ETH/UCY-like observed windows: 8 frames at 0.4 s, walking speeds
    around 1.3 m/s in a 15 m square, small heading noise, and group labels
    shared by pairs and triples (0 = ungrouped)."""
    import numpy as np
    scenes, groups = [], []
    for n in sizes:
        start = rng.uniform(0, 15, (n, 1, 2))
        heading = rng.uniform(0, 2 * np.pi, (n, 1))
        speed = rng.normal(1.3, 0.3, (n, 1)) * 0.4
        v = np.stack([np.cos(heading), np.sin(heading)], -1) * speed[..., None]
        steps = v + rng.normal(0, 0.05, (n, 8, 2))
        scenes.append((start + np.cumsum(steps, axis=1)).astype(np.float32))
        groups.append((rng.integers(0, max(2, n // 3), n)
                       * (rng.uniform(size=n) < 0.6)).astype(np.float32))
    return scenes, groups


# ----------------------------------------------------------------- kernel

def pool_inputs(rng, valid, K_=512, B=8, R=1, bf16=False):
    """a/u/W2/b2 on the card for a [R, S, N] mask: a and u at the scale the
    zoo's pool produces, W2 scaled by 1/sqrt(K)."""
    import numpy as np
    import torch
    R_, S, N = valid.shape
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    a, u = f(R_, S, N, K_), f(R_, S, N, K_)
    W2, b2 = f(R_, K_, B) / K_ ** 0.5, f(R_, B)
    if bf16:
        W2, b2 = W2.bfloat16(), b2.bfloat16()
    cuda = lambda t: t.cuda().contiguous()
    return (cuda(a), cuda(u), cuda(W2), cuda(b2),
            cuda(torch.from_numpy(valid.astype(np.float32))))


def _bounds(pairs, K_, B, passes, extra_ops, nbytes, peak=TF32_PEAK,
            elementwise=TC_ELEMENTWISE_OPS):
    """Least times (ms) for pair work on these inputs, both against every
    input read and every output written once over HBM bandwidth:

    - float32 cores: K·(2+2B) operations per valid pair (subtract, ReLU,
      B multiply-adds) plus ``extra_ops``, over FP32_PEAK;
    - tensor cores: the pair products (2·B per pair and k) times the
      ``passes`` of the 3xTF32 split over ``peak`` (TF32_PEAK; for the
      bf16 mode one pass over BF16_PEAK), and beside them (the two units
      run at once, so the larger counts) the subtract, the ReLU and the
      split or rounding (``elementwise`` per pair and k) plus
      ``extra_ops`` over FP32_PEAK.

    ``bound_ms`` is the smaller of the two; ``bound_by`` says whether bytes
    or operations set it and ``bound_unit`` which units' bound it is."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_f32 = (pairs * K_ * (2 + 2 * B) + extra_ops) / FP32_PEAK * 1e3
    t_tc = max(pairs * K_ * 2 * B * passes / peak,
               (pairs * K_ * elementwise + extra_ops) / FP32_PEAK) * 1e3
    f32, tc = max(t_f32, t_bytes), max(t_tc, t_bytes)
    unit, t_ops = ("tensor-core", t_tc) if tc <= f32 else ("float32", t_f32)
    return dict(bound_ms=min(f32, tc),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_unit=unit, bound_f32_ms=f32, bound_tc_ms=tc)


def _valid_pairs(valid):
    nv = valid.sum(-1).double()
    return float((nv * nv).sum())


def pool_bound_ms(a, W2, valid, outputs_bytes, bf16=False):
    """Least time for the pair core on these inputs (:func:`_bounds`):
    the valid pairs' operations, with 3 split passes for float32 weights
    and 2 for bfloat16 (in the bf16 mode one pass at the bf16 rate),
    against reading a, u, W2, b2, valid and writing the outputs once."""
    import torch
    R, S, N, K_ = a.shape
    B = W2.shape[-1]
    nbytes = (2 * a.numel() * 4 + W2.numel() * W2.element_size()
              + B * R * W2.element_size() + valid.numel() * 4
              + outputs_bytes)
    if bf16:
        return _bounds(_valid_pairs(valid), K_, B, 1, 0.0, nbytes,
                       BF16_PEAK, BF16_ELEMENTWISE_OPS)
    passes = 3 if W2.dtype == torch.float32 else 2
    return _bounds(_valid_pairs(valid), K_, B, passes, 0.0, nbytes)


def check_kernel(name, a, u, W2, b2, valid, expect_ties=False,
                 near_ties=False, bf16=False):
    """Kernel vs plain on the card. pooled within POOL_ATOL: float32 sums
    of K=512 products in different orders, values of a few units; cnt
    equal, since ties come from equal inputs that give bit-equal values in
    both. Only valid rows count (invalid rows are re-masked by callers).
    With ``near_ties`` (inputs taken from training, where a max may lie
    within rounding of another value) a row whose cnt differs passes if
    the kernel's count is at least 1 and at most the number of j whose
    plain value lies within NEAR_TIE_ATOL of the plain max: the two
    orders of summation resolved a near-tie differently. With ``bf16``
    both run in the bf16 mode and pooled must lie within BF16_RTOL of the
    plain version's largest value."""
    import torch
    from grouptraj_torch.ops.cuda_pool import pool_core_fwd
    from grouptraj_torch.ops.pooling import pool_core
    pooled, cnt = pool_core_fwd(a, u, W2, b2, valid, bf16=bf16)
    ref, ref_cnt = pool_core(a, u, W2, b2, valid, bf16=bf16)
    torch.cuda.synchronize()
    rows = valid > 0
    err = (pooled - ref)[rows].abs().max().item() if rows.any() else 0.0
    tol = (BF16_RTOL * max(1.0, ref[rows].abs().max().item()) if bf16
           else POOL_ATOL)
    cnt_bad = int((cnt != ref_cnt)[rows].sum())
    if cnt_bad and near_ties:
        rnd = (lambda t: t.bfloat16().float()) if bf16 else (lambda t: t)
        o = torch.relu(rnd(torch.relu(a.unsqueeze(-3) - u.unsqueeze(-2)))
                       @ rnd(W2.float())[:, None, None]
                       + b2.float()[:, None, None, None])
        o = o.masked_fill(~(valid[..., None, :, None] > 0), -1e9)
        near = ((o - ref.unsqueeze(-2)).abs() <= NEAR_TIE_ATOL).sum(-2)
        del o
        odd = (cnt != ref_cnt) & rows[..., None] & ~((cnt >= 1)
                                                     & (cnt <= near))
        print(f"kernel {name}: {cnt_bad} cnt entries differ from the plain "
              f"version's, {cnt_bad - int(odd.sum())} of them at near-ties")
        cnt_bad = int(odd.sum())
    pad = valid.sum(-1) == 0
    pad_ok = bool((pooled[pad] == 0).all() and (cnt[pad] == 0).all())
    ties = int((ref_cnt[rows] > 1).sum())
    print(f"kernel {name}: shape a={tuple(a.shape)} B={W2.shape[-1]} "
          f"W2={str(W2.dtype)[6:]} mode={'bf16' if bf16 else 'exact'} "
          f"max_abs_err={err:.3e} (tolerance {tol:.1e}) "
          f"cnt_mismatch={cnt_bad} tie_entries={ties} pad_scenes="
          f"{int(pad.sum())} pad_zero={pad_ok}")
    if not (err <= tol and cnt_bad == 0 and pad_ok):
        fail(f"kernel case {name} disagrees with the plain version")
    if expect_ties and ties == 0:
        fail(f"kernel case {name} produced no ties to check")
    return err


def _bound_text(b):
    return (f"bound_ms={b['bound_ms']:.4f} ({b['bound_by']}, "
            f"{b['bound_unit']}; float32 {b['bound_f32_ms']:.4f}, "
            f"tensor-core {b['bound_tc_ms']:.4f})")


def kernel_phase(rng):
    import numpy as np
    from grouptraj_torch.ops.cuda_pool import pool_core_fwd
    from grouptraj_torch.ops.pooling import pool_core

    errs, timed = [], {}
    # serving's buckets, and the per-step decoder's pool in a best-of-20
    # decode: K·S = 1,280 scenes a step
    main_cases = {"S64_N64_B8": realistic_valid(rng, 64, 64, 2, 57),
                  "S256_N16_B8": realistic_valid(rng, 256, 16, 2, 16),
                  "S1280_N64_B8": realistic_valid(rng, 1280, 64, 2, 57)}
    # the discriminator's pool (B=48): the d-step's 2S = 128 scenes and the
    # g-step's S = 64
    b48_cases = {"S128_N64_B48": realistic_valid(rng, 128, 64, 2, 57),
                 "S64_N64_B48": realistic_valid(rng, 64, 64, 2, 57)}
    for name, valid in list(main_cases.items()) + list(b48_cases.items()):
        args = pool_inputs(rng, valid, B=48 if name in b48_cases else 8)
        errs.append(check_kernel(name, *args))
        out_bytes = 2 * args[0].shape[0] * args[0].shape[1] \
            * args[0].shape[2] * args[2].shape[-1] * 4
        bound = pool_bound_ms(args[0], args[2], args[4], out_bytes)
        ms = time_ms(lambda: pool_core_fwd(*args))
        plain_ms = time_ms(lambda: pool_core(*args))
        timed[name] = dict(ms=ms, plain_ms=plain_ms, **bound)
        print(f"kernel {name} time: kernel_ms={ms:.4f} plain_ms="
              f"{plain_ms:.4f} {_bound_text(bound)} "
              f"kernel/bound={ms / bound['bound_ms']:.2f}")
    full = np.ones((1, 64, 64))
    args = pool_inputs(rng, full)
    errs.append(check_kernel("S64_N64_B8_dense", *args))
    bound = pool_bound_ms(args[0], args[2], args[4], 2 * 64 * 64 * 8 * 4)
    ms = time_ms(lambda: pool_core_fwd(*args))
    print(f"kernel S64_N64_B8_dense time: kernel_ms={ms:.4f} "
          f"{_bound_text(bound)} kernel/bound={ms / bound['bound_ms']:.2f}")
    errs.append(check_kernel("B48", *pool_inputs(rng, main_cases[
        "S64_N64_B8"], B=48)))
    errs.append(check_kernel("R2", *pool_inputs(
        rng, np.concatenate([realistic_valid(rng, 16, 32, 2, 32)] * 2), R=2)))
    holes = realistic_valid(rng, 32, 40, 2, 40)
    holes[0, :, 1::3] = 0                        # interior invalid j
    holes[0, 5:9] = 0                            # all-invalid pad scenes
    errs.append(check_kernel("holes_and_pad_scenes", *pool_inputs(rng, holes)))
    a, u, W2, b2, v = pool_inputs(rng, realistic_valid(rng, 16, 24, 6, 24))
    errs.append(check_kernel("relu_ties", a, u, W2, b2 - 3.0, v,
                             expect_ties=True))
    a, u, W2, b2, v = pool_inputs(rng, np.ones((1, 8, 40)))
    for dst, src in ((2, 1), (33, 0), (39, 3)):   # duplicates, across j-chunks
        a[:, :, dst] = a[:, :, src]
    errs.append(check_kernel("duplicate_rows", a, u, W2, b2, v,
                             expect_ties=True))
    errs.append(check_kernel("bf16_weights", *pool_inputs(
        rng, main_cases["S64_N64_B8"], bf16=True)))
    errs.append(check_kernel("bf16_weights_B48", *pool_inputs(
        rng, b48_cases["S128_N64_B48"], B=48, bf16=True)))
    errs.append(check_kernel("wide_B100", *pool_inputs(
        rng, realistic_valid(rng, 8, 40, 3, 40), B=100)))
    errs.append(check_kernel("odd_N70_K260_B5", *pool_inputs(
        rng, realistic_valid(rng, 5, 70, 3, 70), K_=260, B=5)))
    errs.append(check_kernel("wide_N256_B48", *pool_inputs(
        rng, realistic_valid(rng, 4, 256, 100, 256), B=48)))
    return max(errs), timed


def bwd_bound_ms(a, W2, valid, pooled, cnt, bf16=False):
    """Least time for the pool backward on these inputs (:func:`_bounds`).
    Operations: the recompute of every valid pair (as the forward, float32
    weights: 3 split passes; in the bf16 mode one pass at the bf16 rate)
    plus, for each (i, j, b) that reached a positive max at a valid i
    (Σ cnt there), ~6 float32 operations per k (subtract, test,
    multiply-add into da and du, ReLU and multiply-add into dW2; 7 in the
    bf16 mode, which rounds the ReLU). Bytes: a, u, pooled, cnt, dpool,
    valid, W2, b2 read and da, du, dW2, db2 written once."""
    R, S, N, K_ = a.shape
    B = W2.shape[-1]
    live = (valid[..., None] > 0) & (pooled > 0)
    entries = float(cnt[live].double().sum())
    nbytes = 4 * (4 * a.numel() + 3 * pooled.numel() + valid.numel()
                  + 2 * (W2.numel() + R * B))
    if bf16:
        return _bounds(_valid_pairs(valid), K_, B, 1, entries * K_ * 7,
                       nbytes, BF16_PEAK, BF16_ELEMENTWISE_OPS)
    return _bounds(_valid_pairs(valid), K_, B, 3, entries * K_ * 6, nbytes)


def check_bwd(name, rng, a, u, W2, b2, valid, expect_ties=False,
              exact=False, bf16=False):
    """K2 vs its plain version on the card, on K1's (pooled, cnt).

    1. recount: the number of valid j the backward's recompute found equal
       to the forward's max must equal the forward's cnt at every valid
       row — any difference means the two kernels do not compute bit-equal
       pair values, which would silently zero gradients.
    2. selection: the (i, j, b) the kernel propagates through number cnt
       where the max is positive at a valid i, and none elsewhere.
    3. values: da, du, dW2, db2 against pool_core_bwd_plain given that
       selection, max |Δ| ≤ BWD_RTOL · max(1, max |ref|) (float32 sums in
       another order). The plain version cannot take the forward kernel's
       pooled for its own ``o == pooled`` test: its matmul rounds
       differently, so equality fails by an ulp, and a selection made from
       its own forward flips wherever two j lie within rounding of each
       other (about once per 10⁵-10⁶ maxima). With ``exact`` inputs (every
       product and partial sum representable, see quantized_inputs) there
       is no rounding: then the plain forward must equal K1 bit for bit
       and the plain backward runs literally, with its own selection.
    The cotangent is non-zero at invalid rows too, which must not matter,
    and a second call without the weight gradients must give the same
    da/du. With ``bf16`` K1, K2 and the plain versions all run in the bf16
    mode, each tensor within BF16_RTOL of its largest reference entry."""
    import torch
    from grouptraj_torch.ops.cuda_pool import pool_core_bwd, pool_core_fwd
    from grouptraj_torch.ops.pooling import pool_core, pool_core_bwd_plain
    pooled, cnt = pool_core_fwd(a, u, W2, b2, valid, bf16=bf16)
    dpool = torch.from_numpy(rng.integers(-8, 9, size=tuple(pooled.shape))
                             .astype("float32") / 8).cuda()
    dbg = {}
    out = pool_core_bwd(a, u, W2, b2, valid, pooled, cnt, dpool, debug=dbg,
                        bf16=bf16)
    da2, du2, none_w, none_b = pool_core_bwd(a, u, W2, b2, valid, pooled,
                                             cnt, dpool, weight_grads=False,
                                             bf16=bf16)
    torch.cuda.synchronize()
    rows = valid > 0
    recount_bad = int((dbg["recount"] != cnt)[rows].sum())
    ties = dbg["ties"]
    want = torch.where(rows[..., None] & (pooled > 0), cnt, 0.0)
    sel_bad = int((ties.sum(-2) != want).sum())
    same = bool(torch.equal(out[0], da2) and torch.equal(out[1], du2)
                and none_w is None and none_b is None)
    if exact:
        ref_pooled, ref_cnt = pool_core(a, u, W2, b2, valid, bf16=bf16)
        fwd_equal = bool(torch.equal(pooled[rows], ref_pooled[rows])
                         and torch.equal(cnt[rows], ref_cnt[rows]))
        ref = pool_core_bwd_plain(a, u, W2, b2, valid, ref_pooled, ref_cnt,
                                  dpool, bf16=bf16)
    else:
        fwd_equal = True
        ref = pool_core_bwd_plain(a, u, W2, b2, valid, pooled, cnt, dpool,
                                  ties=ties, bf16=bf16)
    rtol = dict.fromkeys(BWD_RTOL, BF16_RTOL) if bf16 else BWD_RTOL
    errs, ok = {}, True
    for key, x, r in zip(BWD_RTOL, out, ref):
        errs[key] = (x - r).abs().max().item()
        ok &= errs[key] <= rtol[key] * max(1.0, r.abs().max().item())
        ok &= bool(torch.isfinite(x).all())
    n_ties = int((want > 1).sum())
    print(f"kernel bwd {name}: shape a={tuple(a.shape)} B={W2.shape[-1]} "
          f"mode={'bf16' if bf16 else 'exact'} "
          f"recount_mismatch={recount_bad} selection_mismatch={sel_bad} "
          f"entries={int(ties.sum())} positive_tie_entries={n_ties} "
          + " ".join(f"{k}_err={v:.3e}" for k, v in errs.items())
          + f" weightless_same={same}"
          + (f" forward_bit_equal={fwd_equal}" if exact else ""))
    if not (ok and recount_bad == 0 and sel_bad == 0 and same and fwd_equal):
        fail(f"backward kernel case {name} disagrees with the plain version")
    if expect_ties and n_ties == 0:
        fail(f"backward kernel case {name} produced no positive ties")
    return max(errs.values())


def device_ms_by_kernel(run, reps=20):
    """torch.profiler's device time per call of ``run`` by kernel (ms,
    mean over ``reps`` calls after two warm-up calls): {kernel: ms}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(events[0],
            "self_device_time_total") else "self_cuda_time_total")
    return {e.key: getattr(e, attr) / 1e3 / reps for e in events
            if str(e.device_type).endswith("CUDA") and getattr(e, attr) > 0}


K2_KERNELS = ("split_w", "ties", "tie_grads", "weight_reduce")


def bwd_phase_ms(args, pooled, cnt, dpool):
    """Device ms per call of each of K2's four kernels (the weight split,
    the ties pass, the tie gradients, the weight sum), by torch.profiler."""
    from grouptraj_torch.ops.cuda_pool import pool_core_bwd
    by_kernel = device_ms_by_kernel(
        lambda: pool_core_bwd(*args, pooled, cnt, dpool))
    phases = {name: sum(ms for key, ms in by_kernel.items()
                        if kernel_name(key) == f"{name}_kernel")
              for name in K2_KERNELS}
    if not all(phases.values()):
        fail(f"the profile of K2 misses a kernel: {sorted(by_kernel)}")
    return phases


def quantized_inputs(rng, valid, K_=512, B=8):
    """Inputs on coarse binary grids (a, u multiples of 1/2 in [-2, 2], W2
    in {-1/4, 0, 1/4}, b2 multiples of 1/2): every product is a multiple
    of 1/8 and every partial sum stays below 2^10, so float32 adds them
    exactly in any order. Kernel and plain version then agree bit for bit,
    and equal pair values — exact positive ties — are common."""
    import numpy as np
    import torch
    R_, S, N = valid.shape
    q = lambda lo, hi, den, *s: torch.from_numpy(
        (rng.integers(lo, hi + 1, size=s) / den).astype(np.float32))
    cuda = lambda t: t.cuda().contiguous()
    return (cuda(q(-4, 4, 2, R_, S, N, K_)), cuda(q(-4, 4, 2, R_, S, N, K_)),
            cuda(q(-1, 1, 4, R_, K_, B)), cuda(q(-4, 4, 2, R_, B)),
            cuda(torch.from_numpy(valid.astype(np.float32))))


def kernel_bwd_phase(rng):
    import numpy as np
    import torch
    from grouptraj_torch.ops.cuda_pool import pool_core_bwd, pool_core_fwd
    from grouptraj_torch.ops.pooling import pool_core_bwd_plain

    errs, timed = [], {}
    main_cases = {"S64_N64_B8": (realistic_valid(rng, 64, 64, 2, 57), 8),
                  "S128_N64_B48": (realistic_valid(rng, 128, 64, 2, 57), 48),
                  "S256_N16_B8": (realistic_valid(rng, 256, 16, 2, 16), 8),
                  # the per-step decoder's backward in the dense g-step
                  "S1280_N64_B8": (realistic_valid(rng, 1280, 64, 2, 57),
                                   8)}
    for name, (valid, B) in main_cases.items():
        args = pool_inputs(rng, valid, B=B)
        errs.append(check_bwd(name, rng, *args))
        pooled, cnt = pool_core_fwd(*args)
        dpool = torch.randn_like(pooled)
        bound = bwd_bound_ms(args[0], args[2], args[4], pooled, cnt)
        ms = time_ms(lambda: pool_core_bwd(*args, pooled, cnt, dpool))
        ms_in = time_ms(lambda: pool_core_bwd(*args, pooled, cnt, dpool,
                                              weight_grads=False))
        plain_ms = time_ms(lambda: pool_core_bwd_plain(*args, pooled, cnt,
                                                       dpool),
                           reps=5, warmup=1)
        phases = bwd_phase_ms(args, pooled, cnt, dpool)
        timed[name] = dict(ms=ms, plain_ms=plain_ms, phases=phases, **bound)
        print(f"kernel bwd {name} time: kernel_ms={ms:.4f} "
              f"inputs_only_ms={ms_in:.4f} plain_ms={plain_ms:.4f} "
              f"{_bound_text(bound)} kernel/bound={ms / bound['bound_ms']:.2f}"
              " phases_ms " + " ".join(f"{k}={v:.4f}"
                                       for k, v in phases.items()))
        del pooled, cnt, dpool, args
        torch.cuda.empty_cache()
    errs.append(check_bwd("R2_B16", rng, *pool_inputs(
        rng, realistic_valid(rng, 16, 32, 2, 32, R=2), R=2, B=16)))
    holes = realistic_valid(rng, 32, 40, 2, 40)
    holes[0, :, 1::3] = 0                        # interior invalid j
    holes[0, 5:9] = 0                            # all-invalid pad scenes
    errs.append(check_bwd("holes_and_pad_scenes", rng,
                          *pool_inputs(rng, holes)))
    a, u, W2, b2, v = pool_inputs(rng, realistic_valid(rng, 16, 24, 6, 24))
    errs.append(check_bwd("relu_ties", rng, a, u, W2, b2 - 3.0, v))
    a, u, W2, b2, v = pool_inputs(rng, np.ones((1, 8, 40)))
    for dst, src in ((2, 1), (33, 0), (39, 3)):   # duplicates, across j-chunks
        a[:, :, dst] = a[:, :, src]
    errs.append(check_bwd("duplicate_rows", rng, a, u, W2, b2, v,
                          expect_ties=True))
    errs.append(check_bwd("odd_N70_K260_B5", rng, *pool_inputs(
        rng, realistic_valid(rng, 5, 70, 3, 70), K_=260, B=5)))
    errs.append(check_bwd("exact_inputs", rng, *quantized_inputs(
        rng, realistic_valid(rng, 16, 40, 6, 40)), expect_ties=True,
        exact=True))
    errs.append(check_bwd("exact_inputs_B48", rng, *quantized_inputs(
        rng, realistic_valid(rng, 8, 64, 20, 64), B=48), expect_ties=True,
        exact=True))
    # wider than the tie-gradient pass stages in shared memory
    errs.append(check_bwd("wide_N256_B48", rng, *pool_inputs(
        rng, realistic_valid(rng, 4, 256, 100, 256), B=48)))
    return max(errs), timed


# ------------------------------------------------------------ lstm kernels

# K3/K4 at the shapes the main paths give them (timed): name, T, B, H, gx
# variant, residuals saved, cotangents (dys, dhT, dcT) given to K4
_ENC, _DEC = (False, True, False), (True, False, False)
LSTM_MAIN = (
    ("G_encoder_T8_B4096_H32", 8, 4096, 32, True, True, _ENC),
    ("D_encoder_T20_B4096_H48", 20, 4096, 48, True, True, _ENC),
    ("D_encoder_T20_B8192_H48", 20, 8192, 48, True, True, _ENC),
    ("decoder_T11_B4096_H32_nograd", 11, 4096, 32, False, False, _DEC),
    ("decoder_T11_B8192_H32", 11, 8192, 32, False, True, _DEC),
    ("decoder_T11_B81920_H32_nograd", 11, 81920, 32, False, False, _DEC))


def lstm_inputs(gen, T, B, H, with_gx):
    """w, h0, c0 and gx or b on the card at the scale the models give them
    (weights ~1/sqrt(H), states of a few tenths), plus cotangents."""
    import torch
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    w, h0, c0 = r(H, 4 * H) / H ** 0.5, 0.5 * r(B, H), 0.5 * r(B, H)
    gx = r(T, B, 4 * H) if with_gx else None
    b = None if with_gx else 0.1 * r(4 * H)
    return w, h0, c0, gx, b, (r(T, B, H), r(B, H), r(B, H))


def _unit_bounds(products, gate_ops, t_bytes):
    """The bound of a kernel that runs its matrix products (``products``
    float32 operations) on the tensor cores, beside the same work on the
    float32 cores: the float32-core bound (all operations over FP32_PEAK)
    and the tensor-core one (the products' 3 TF32 passes over TF32_PEAK and,
    beside them, the gate math over FP32_PEAK), each against the bytes;
    ``bound_ms`` is the smaller."""
    t_f32 = (products + gate_ops) / FP32_PEAK * 1e3
    t_tc = max(3 * products / TF32_PEAK, gate_ops / FP32_PEAK) * 1e3
    f32, tc = max(t_f32, t_bytes), max(t_tc, t_bytes)
    unit, t_ops = ("tensor-core", t_tc) if tc <= f32 else ("float32", t_f32)
    return dict(bound_ms=min(f32, tc),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_unit=unit, bound_f32_ms=f32, bound_tc_ms=tc)


def lstm_bound_ms(kind, T, B, H, with_gx, save=False, cot=(True, True, True)):
    """Least time for K3 (``kind='fwd'``) or K4 (``'bwd'``) on these shapes.
    Operations: the recurrent product 2*T*B*H*4H (twice that backward:
    dz @ W^T and h^T dz) plus LSTM_GATE_OPS per (step, row, unit). Bytes,
    each once over HBM bandwidth: forward w, gx or b, h0, c0 read and ys,
    hT, cT (and gates, cs when saved) written; backward w, h0, c0, ys,
    gates, cs and the cotangents given read, dgx (or db), dw, dh0, dc0
    written. Both kernels run their products on the tensor cores: both
    units' bounds as :func:`_unit_bounds` gives them."""
    tbh = T * B * H
    if kind == "fwd":
        floats = (4 * H * H + (4 * tbh if with_gx else 4 * H) + 4 * B * H
                  + tbh + (5 * tbh if save else 0))
        return _unit_bounds(2 * tbh * 4 * H, LSTM_GATE_OPS["fwd"] * tbh,
                            4 * floats / HBM_BW * 1e3)
    floats = (8 * H * H + 4 * B * H + 6 * tbh
              + (tbh if cot[0] else 0) + (cot[1] + cot[2]) * B * H
              + (4 * tbh if with_gx else 4 * H))
    return _unit_bounds(4 * tbh * 4 * H, LSTM_GATE_OPS["bwd"] * tbh,
                        4 * floats / HBM_BW * 1e3)


def hold_pair(label, name, desc, fwd, plain_fwd, save, backward, keys, cot,
              bound, timed):
    """A forward kernel, then its backward on the forward's residuals,
    against their plain versions on the card. Forward outputs (ys, hT, cT,
    gates, cs) within LSTM_FWD_ATOL; each gradient (named by ``keys``)
    within LSTM_BWD_RTOL of its largest entry; all finite.
    ``backward(out)`` gives the kernel and plain backward calls on the
    forward's outputs, ``cot`` which of (dys, dhT, dcT) they are given,
    ``bound(kind)`` the least time of 'fwd' or 'bwd' (a dict with
    ``bound_ms`` and ``bound_by``, and both units' bounds as
    :func:`_unit_bounds` gives them). With ``timed`` (a dict)
    the median kernel and plain times and the bounds are stored under
    ``name``."""
    import torch
    out, ref = fwd(), plain_fwd()
    torch.cuda.synchronize()
    if (out[3] is None) != (not save) or (out[4] is None) != (not save):
        fail(f"{label} case {name}: residuals do not follow the save flag")
    ferr = max((x - y).abs().max().item() for x, y in zip(out, ref)
               if x is not None)
    ok = ferr <= LSTM_FWD_ATOL and all(bool(torch.isfinite(x).all())
                                       for x in out if x is not None)
    msg = (f"kernel {label} {name}: {desc}, residuals "
           f"{'saved' if save else 'not saved'}: fwd max_abs_err={ferr:.3e}")
    calls = {"fwd": (fwd, plain_fwd)}
    berr = brel = 0.0
    if save:
        calls["bwd"] = backward(out)
        got, want = (call() for call in calls["bwd"])
        torch.cuda.synchronize()
        for key, x, y in zip(keys, got, want):
            if (x is None) != (y is None):
                fail(f"{label} case {name}: {key} given by one side only")
            if x is None:
                continue
            err = (x - y).abs().max().item()
            rel = err / max(y.abs().max().item(), 1e-30)
            berr, brel = max(berr, err), max(brel, rel)
            ok &= (x.shape == y.shape and rel <= LSTM_BWD_RTOL
                   and bool(torch.isfinite(x).all()))
        msg += (f"; bwd cotangents (dys, dhT, dcT)={tuple(map(int, cot))} "
                f"max_abs_err={berr:.3e} worst max|d|/max|ref|={brel:.3e}")
    print(msg)
    if not ok:
        fail(f"{label} kernel case {name} disagrees with the plain version")
    if timed is not None:
        timed[name] = {}
        for kind, (kernel, plain) in calls.items():
            e = timed[name][kind] = dict(
                ms=time_ms(kernel), plain_ms=time_ms(plain, reps=5, warmup=1),
                **bound(kind))
            print(f"kernel {label} {name} {kind} time: kernel_ms="
                  f"{e['ms']:.4f} plain_ms={e['plain_ms']:.4f} "
                  f"{_bound_text(e)} "
                  f"kernel/bound={e['ms'] / e['bound_ms']:.2f}")
    return ferr, berr


def check_lstm(name, gen, T, B, H, with_gx, save=True, cot=(True, True, True),
               timed=None):
    """K3, then K4 on K3's residuals, against their plain versions on the
    card (hold_pair). ``cot`` says which of (dys, dhT, dcT) are given (the
    decoder variant takes dys only)."""
    from grouptraj_torch.ops.cuda_lstm import lstm_fused_bwd, lstm_fused_fwd
    from grouptraj_torch.ops.lstm import (
        _fused_fwd_plain, fused_recurrence_bwd_plain,
    )
    w, h0, c0, gx, b, cots = lstm_inputs(gen, T, B, H, with_gx)
    cot = cot if with_gx else (True, False, False)
    given = [c if use else None for c, use in zip(cots, cot)]

    def backward(out):
        ys, _, _, gates, cs = out
        args = (w, h0, c0, ys, gates, cs, *given, with_gx)
        return (lambda: lstm_fused_bwd(*args),
                lambda: fused_recurrence_bwd_plain(*args))

    return hold_pair(
        "lstm", name,
        f"T={T} B={B} H={H} {'gx' if with_gx else 'decoder'} variant",
        lambda: lstm_fused_fwd(w, h0, c0, gx=gx, b=b, T=T, save=save),
        lambda: _fused_fwd_plain(w, gx, b, h0, c0, T, save), save, backward,
        ("dgx", "dw", "db", "dh0", "dc0"), cot,
        lambda kind: lstm_bound_ms(kind, T, B, H, with_gx, save, cot), timed)


def library_lstm(gen, name, T, B, D, H):
    """torch.nn.LSTM (cuDNN, TF32 off), the one PyTorch call that computes
    what K5 (+ K6) compute, beside both kernel routes at an encoder's shape,
    the input projection included everywhere: forward without grad, forward
    with grad (what a training forward keeps), and forward + backward from a
    cotangent on hT. Timed here only; the port never calls it."""
    import torch
    from grouptraj_torch.ops.lstm import lstm_scan
    lib = torch.nn.LSTM(D, H).cuda()
    params = {"w_ih": lib.weight_ih_l0.t(), "w_hh": lib.weight_hh_l0.t(),
              "b_ih": lib.bias_ih_l0, "b_hh": lib.bias_hh_l0}
    xs = torch.randn(T, B, D, generator=gen, device="cuda",
                     requires_grad=True)
    leaves = list(lib.parameters()) + [xs]
    ones = torch.ones(B, H, device="cuda")
    out = {}
    with torch.no_grad():
        ref = lib(xs)[1][0][0]
        errs = {impl: (ref - lstm_scan(params, xs, impl=impl)[1][0]).abs()
                .max().item() for impl in ("fused", "pallas")}
        out["library_fwd_ms"] = time_ms(lambda: lib(xs))
        for impl in ("fused", "pallas"):
            out[f"{impl}_route_fwd_ms"] = time_ms(
                lambda: lstm_scan(params, xs, impl=impl))
    out["library_fwd_train_ms"] = time_ms(lambda: lib(xs))
    out["library_fwd_bwd_ms"] = time_ms(
        lambda: torch.autograd.grad(lib(xs)[1][0][0], leaves, ones))
    for impl in ("fused", "pallas"):
        out[f"{impl}_route_fwd_bwd_ms"] = time_ms(
            lambda: torch.autograd.grad(
                lstm_scan(params, xs, impl=impl)[1][0], leaves, ones))
    print(f"library lstm {name}: T={T} B={B} D={D} H={H} nn.LSTM fwd "
          f"{out['library_fwd_ms']:.4f} ms (with grad "
          f"{out['library_fwd_train_ms']:.4f}), matmul+K3 fwd "
          f"{out['fused_route_fwd_ms']:.4f} ms, K5 fwd "
          f"{out['pallas_route_fwd_ms']:.4f} ms; nn.LSTM fwd+bwd "
          f"{out['library_fwd_bwd_ms']:.4f} ms, matmul+K3+K4 fwd+bwd "
          f"{out['fused_route_fwd_bwd_ms']:.4f} ms, K5+K6 fwd+bwd "
          f"{out['pallas_route_fwd_bwd_ms']:.4f} ms; max |hT - hT_cudnn| "
          + " ".join(f"{k}={v:.3e}" for k, v in errs.items()))
    if not max(errs.values()) <= 1e-4:
        fail(f"library lstm {name}: a kernel route disagrees with nn.LSTM")
    return out


def lstm_kernel_phase():
    """K3 and K4 at the shapes the main paths give them (timed), then odd
    sizes. Returns the largest absolute errors and the timings."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(7)
    timed, ferrs, berrs = {}, [], []
    for name, T, B, H, with_gx, save, cot in LSTM_MAIN:
        f, b = check_lstm(name, gen, T, B, H, with_gx, save, cot, timed)
        ferrs.append(f)
        berrs.append(b)
        torch.cuda.empty_cache()
    odd = [("B1", 5, 1, 32, True), ("B1_decoder", 5, 1, 32, False),
           ("B70", 8, 70, 32, True), ("B70_decoder", 11, 70, 32, False),
           ("T1", 1, 33, 48, True), ("T1_decoder", 1, 33, 32, False),
           ("H8", 5, 9, 8, True), ("H8_decoder", 7, 9, 8, False),
           ("H16", 6, 16, 16, True), ("H16_decoder", 7, 9, 16, False),
           ("H64", 4, 40, 64, True), ("H64_decoder", 3, 40, 64, False),
           ("B4097_H8", 3, 4097, 8, True),
           ("B4097_H64_decoder", 4, 4097, 64, False)]
    for name, T, B, H, with_gx in odd:       # dys, dhT and dcT all non-zero
        f, b = check_lstm(name, gen, T, B, H, with_gx)
        ferrs.append(f)
        berrs.append(b)
    f, b = check_lstm("only_dys", gen, 6, 50, 32, True, cot=_DEC)
    library = {
        "G_encoder_T8_B4096_H32": library_lstm(gen, "G_encoder", 8, 4096,
                                               16, 32),
        "D_encoder_T20_B8192_H48": library_lstm(gen, "D_encoder", 20, 8192,
                                                16, 48)}
    return max(ferrs + [f]), max(berrs + [b]), timed, library


def proj_bound_ms(kind, T, B, D, H, save=False, cot=(True, True, True)):
    """Least time for K5 (``kind='fwd'``) or K6 (``'bwd'``) on these
    shapes. Operations: the products 2*T*B*(D+H)*4H (twice that backward:
    dz @ W_hh^T, h^T dz, dz @ W_ih^T, x^T dz) plus LSTM_GATE_OPS per (step,
    row, unit). Bytes, each once over HBM bandwidth: forward w_ih, w_hh, b,
    xs, h0, c0 read and ys, hT, cT (and gates, cs when saved) written;
    backward w_ih, w_hh, xs, h0, c0, ys, gates, cs and the cotangents given
    read, dxs, dw_ih, dw_hh, db, dh0, dc0 written. Both kernels run their
    products on the tensor cores: both units' bounds as
    :func:`_unit_bounds` gives them."""
    tbh, tbd, w = T * B * H, T * B * D, (D + H) * 4 * H
    if kind == "fwd":
        floats = (w + 4 * H + tbd + 4 * B * H + tbh
                  + (5 * tbh if save else 0))
        return _unit_bounds(2 * T * B * w, LSTM_GATE_OPS["fwd"] * tbh,
                            4 * floats / HBM_BW * 1e3)
    floats = (2 * w + 4 * H + 2 * tbd + 4 * B * H + 6 * tbh
              + (tbh if cot[0] else 0) + (cot[1] + cot[2]) * B * H)
    return _unit_bounds(4 * T * B * w, LSTM_GATE_OPS["bwd"] * tbh,
                        4 * floats / HBM_BW * 1e3)


# K5/K6 at the shapes the encoders give them on the main paths (timed):
# name, T, B, D, H, residuals saved
PROJ_MAIN = (
    ("G_encoder_T8_B4096_D16_H32", 8, 4096, 16, 32, True),
    ("G_encoder_T8_B4096_D16_H32_nograd", 8, 4096, 16, 32, False),
    ("D_encoder_T20_B4096_D16_H48", 20, 4096, 16, 48, True),
    ("D_encoder_T20_B8192_D16_H48", 20, 8192, 16, 48, True))


def proj_inputs(gen, T, B, D, H):
    """w_ih, w_hh, b, xs, h0, c0 on the card at the scale the models give
    them (weights ~1/sqrt(H), states of a few tenths)."""
    import torch
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    w_ih, w_hh = r(D, 4 * H) / H ** 0.5, r(H, 4 * H) / H ** 0.5
    return (w_ih, w_hh, 0.1 * r(4 * H), r(T, B, D), 0.5 * r(B, H),
            0.5 * r(B, H))


def check_proj(name, gen, T, B, D, H, save=True, cot=(True, True, True),
               timed=None):
    """K5, then K6 on K5's residuals, against their plain versions on the
    card (hold_pair), from a non-zero initial state. ``cot`` says which of
    (dys, dhT, dcT) are given."""
    import torch
    from grouptraj_torch.ops.cuda_lstm_proj import lstm_proj_bwd, lstm_proj_fwd
    from grouptraj_torch.ops.lstm import (
        lstm_proj_bwd_plain, lstm_proj_fwd_plain,
    )
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    args = w_ih, w_hh, b, xs, h0, c0 = proj_inputs(gen, T, B, D, H)

    def backward(out):
        ys, _, _, gates, cs = out
        given = [r(T, B, H) if cot[0] else None,
                 r(B, H) if cot[1] else None, r(B, H) if cot[2] else None]
        bargs = (w_ih, w_hh, xs, h0, c0, ys, gates, cs, *given)
        return (lambda: lstm_proj_bwd(*bargs),
                lambda: lstm_proj_bwd_plain(*bargs))

    return hold_pair(
        "proj", name, f"T={T} B={B} D={D} H={H}",
        lambda: lstm_proj_fwd(*args, save=save),
        lambda: lstm_proj_fwd_plain(*args, save=save), save, backward,
        ("dxs", "dw_ih", "dw_hh", "db", "dh0", "dc0"), cot,
        lambda kind: proj_bound_ms(kind, T, B, D, H, save, cot), timed)


def proj_kernel_phase():
    """K5 and K6 at the shapes the encoders give them on the main paths
    (timed), then odd sizes. Returns the largest absolute errors and the
    timings."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(11)
    timed, ferrs, berrs = {}, [], []
    hT_only = (False, True, False)
    for name, T, B, D, H, save in PROJ_MAIN:
        f, b = check_proj(name, gen, T, B, D, H, save, hT_only, timed)
        ferrs.append(f)
        berrs.append(b)
        torch.cuda.empty_cache()
    odd = [("B1", 5, 1, 16, 32), ("B70", 8, 70, 16, 32), ("T1", 1, 33, 16, 48),
           ("D4_H8", 5, 9, 4, 8), ("D8_H16", 6, 16, 8, 16),
           ("D16_H64", 4, 40, 16, 64), ("D4_H64", 3, 40, 4, 64),
           ("D8_H48_B70", 7, 70, 8, 48)]
    for name, T, B, D, H in odd:             # dys, dhT and dcT all non-zero
        f, b = check_proj(name, gen, T, B, D, H)
        ferrs.append(f)
        berrs.append(b)
    f, b = check_proj("odd_hT_only", gen, 6, 50, 8, 32, cot=hT_only)
    return max(ferrs + [f]), max(berrs + [b]), timed


# ----------------------------------------------------------------- serve

def serve_phase(batches, noises):
    import numpy as np
    import torch
    from grouptraj_torch.compat import config_from_checkpoint_args
    from grouptraj_torch.serve import Predictor
    from grouptraj_torch.train.checkpoint import load_checkpoint

    ckpt = load_checkpoint(CKPT)
    state = ckpt["g_best_state"]
    cfg = config_from_checkpoint_args(ckpt["args"], state)
    print(f"serve: {os.path.relpath(CKPT, HERE)} graph_module="
          f"{cfg.graph_module} encoder_h={cfg.encoder_h_dim_g} "
          f"bottleneck={cfg.bottleneck_dim} k={K}")
    p32 = Predictor.from_checkpoint(CKPT, num_samples=K, param_dtype=None,
                                    device="cuda")

    # the main path: every count at 0 just before, read just after
    reset_counts()
    out32 = {b: p32.predict_batch(sc, gr, noises=noises[b])
             for b, (sc, gr) in batches.items()}
    torch.cuda.synchronize()
    launches = all_counts()
    print(f"serve main path launches: {json.dumps(launches)}")
    if launches["pool_core_fwd"] == 0:
        fail("the serving path never launched pool_core_fwd")
    if launches["lstm_fused_fwd"] or launches["lstm_proj_fwd"]:
        fail("the Predictor serves on the scan route: it must not launch K3 "
             "or K5")
    for b, outs in out32.items():
        sizes = [s.shape[0] for s in batches[b][0]]
        if not all(o.shape == (K, n, cfg.pred_len, 2)
                   and np.isfinite(o).all() for o, n in zip(outs, sizes)):
            fail(f"serve {b}: outputs not finite or of the wrong shape")

    plain = Predictor(state, dataclasses.replace(cfg, pool_impl="fast"),
                      num_samples=K, param_dtype=None, device="cuda")
    for b, (sc, gr) in batches.items():
        ref = plain.predict_batch(sc, gr, noises=noises[b])
        d = max(np.abs(o - r).max() for o, r in zip(out32[b], ref))
        print(f"serve {b}: kernel vs plain pool max |dpos| = {d:.3e} m "
              f"(tolerance {SERVE_ATOL} m)")
        if not d <= SERVE_ATOL:
            fail(f"serve {b}: kernel path disagrees with the plain pool")

    # a small input against the port on the CPU (plain pool, CPU kernels)
    sc, gr = batches["S64_N64"][0][:4], batches["S64_N64"][1][:4]
    small_noise = noises["S64_N64"][:, :4]
    cpu = Predictor(state, cfg, num_samples=K, param_dtype=None,
                    device="cpu")
    ref = cpu.predict_batch(sc, gr, noises=small_noise.cpu())
    got = p32.predict_batch(sc, gr, noises=small_noise)
    d = max(np.abs(o - r).max() for o, r in zip(got, ref))
    print(f"serve small batch: GPU vs CPU max |dpos| = {d:.3e} m "
          f"(tolerance {SERVE_ATOL} m)")
    if not d <= SERVE_ATOL:
        fail("the GPU path disagrees with the CPU path on a small batch")

    p16 = Predictor.from_checkpoint(CKPT, num_samples=K, device="cuda")
    for b, (sc, gr) in batches.items():
        out = p16.predict_batch(sc, gr, noises=noises[b])
        if not all(np.isfinite(o).all() for o in out):
            fail(f"serve {b}: bf16 outputs are not finite")
        d = np.concatenate([np.linalg.norm(o - r, axis=-1).ravel()
                            for o, r in zip(out, out32[b])])
        print(f"serve {b}: bf16 vs f32 displacement mean={d.mean():.4f} m "
              f"max={d.max():.4f} m")

    call_ms = {}
    for name, pred in (("bf16", p16), ("f32", p32)):
        for b, (sc, gr) in batches.items():
            n_traj = K * sum(s.shape[0] for s in sc)
            for _ in range(2):
                pred.predict_batch(sc, gr)
            secs = []
            for _ in range(10):
                t0 = time.perf_counter()
                pred.predict_batch(sc, gr)        # returns host arrays: synced
                secs.append(time.perf_counter() - t0)
            med = statistics.median(secs)
            call_ms[f"{name}_{b}"] = med * 1e3
            print(f"serve throughput {name} {b}: {n_traj / med:.0f} traj/s "
                  f"({med * 1e3:.2f} ms per predict_batch, {n_traj} "
                  f"trajectories)")
    return launches, p16, p32, call_ms


def lstm_counts():
    from grouptraj_torch.ops.cuda_lstm import lstm_fused_bwd, lstm_fused_fwd
    from grouptraj_torch.ops.cuda_lstm_proj import lstm_proj_bwd, lstm_proj_fwd
    return {"lstm_fused_fwd": lstm_fused_fwd.launches,
            "lstm_fused_bwd": lstm_fused_bwd.launches,
            "lstm_proj_fwd": lstm_proj_fwd.launches,
            "lstm_proj_bwd": lstm_proj_bwd.launches}


def reset_counts():
    from grouptraj_torch.ops.cuda_lstm import lstm_fused_bwd, lstm_fused_fwd
    from grouptraj_torch.ops.cuda_lstm_proj import lstm_proj_bwd, lstm_proj_fwd
    from grouptraj_torch.ops.cuda_pool import pool_core_bwd, pool_core_fwd
    for wrapper in (pool_core_fwd, pool_core_bwd, lstm_fused_fwd,
                    lstm_fused_bwd, lstm_proj_fwd, lstm_proj_bwd):
        wrapper.launches = 0
    pool_core_fwd.launches_bf16 = pool_core_bwd.launches_bf16 = 0
    for wrapper in (lstm_fused_fwd, lstm_fused_bwd, lstm_proj_fwd,
                    lstm_proj_bwd):
        wrapper.launches_wide = 0


def all_counts():
    from grouptraj_torch.ops.cuda_pool import pool_core_bwd, pool_core_fwd
    return {"pool_core_fwd": pool_core_fwd.launches,
            "pool_core_bwd": pool_core_bwd.launches, **lstm_counts()}


def bf16_counts():
    """K1's and K2's launches in their bf16 mode (all_counts counts the
    exact mode's)."""
    from grouptraj_torch.ops.cuda_pool import pool_core_bwd, pool_core_fwd
    return {"pool_core_fwd_bf16": pool_core_fwd.launches_bf16,
            "pool_core_bwd_bf16": pool_core_bwd.launches_bf16}


def serve_fused_phase(predictor, batches, noises):
    """Serving on the kernel routes: the Predictor's float32 generator
    driven through generator_context + generator_sample_many with
    impl='fused' and with impl='pallas' (the Predictor itself has no such
    knob, as in the JAX package), on the padded batches predict_batch
    builds, against impl='scan'. Each route's main path runs with every
    count at 0 just before it and is read just after."""
    import numpy as np
    import torch
    from grouptraj_torch.utils import relative_to_abs

    model, cfg = predictor.model, predictor.cfg

    @torch.inference_mode()
    def call(tensors, z, impl):
        """Device tensors in, host array out: one serving call's work."""
        obs, rel, grp, valid = tensors
        ctx = model.generator_context(obs, rel, grp, valid, impl=impl)
        preds = model.generator_sample_many(ctx, rel, valid, K,
                                            user_noises=z, impl=impl)
        return relative_to_abs(preds, obs[None, :, :, -1, :]).cpu().numpy()

    tensors = {b: predictor.pad_batch(*batches[b]) for b in BUCKETS}
    # per call: K3 for the encoder and the decoder, or K5 for the encoder;
    # K1 once on either
    want = {"fused": {"lstm_fused_fwd": 2, "pool_core_fwd": 1},
            "pallas": {"lstm_proj_fwd": 1, "pool_core_fwd": 1}}
    launches, out = {}, {}
    for impl, per_call in want.items():
        reset_counts()
        out[impl] = {b: call(tensors[b], noises[b], impl) for b in BUCKETS}
        torch.cuda.synchronize()
        launches[impl] = all_counts()
        print(f"serve {impl} main path launches: "
              f"{json.dumps(launches[impl])}")
        expect = {k_: per_call.get(k_, 0) * len(BUCKETS)
                  for k_ in launches[impl]}
        if launches[impl] != expect:
            fail(f"serving on the {impl} route must launch {per_call} per "
                 f"call and nothing else")
    call_ms = {}
    reset_counts()
    for b, (S, N, _) in BUCKETS.items():
        ref = call(tensors[b], noises[b], "scan")
        rows = tensors[b][3].cpu().numpy() > 0
        for impl in want:
            o = out[impl][b]
            d = np.abs(o - ref)[:, rows].max()
            if o.shape != (K, S, N, cfg.pred_len, 2) \
                    or not np.isfinite(o).all():
                fail(f"serve {impl} {b}: outputs not finite or of the "
                     f"wrong shape")
            print(f"serve {impl} {b}: {impl} vs scan max |dpos| = {d:.3e} m "
                  f"(tolerance {SERVE_ATOL} m)")
            if not d <= SERVE_ATOL:
                fail(f"serve {impl} {b}: the {impl} route disagrees with "
                     f"scan")
        n_traj = K * int(rows.sum())
        secs = {"scan": [], "fused": [], "pallas": []}
        for impl in ("scan", "fused", "pallas", "pallas", "fused",
                     "scan"):                                  # in turns
            call(tensors[b], noises[b], impl)                 # warm
            for _ in range(5):
                t0 = time.perf_counter()
                call(tensors[b], noises[b], impl)   # host arrays: synced
                secs[impl].append(time.perf_counter() - t0)
        for impl, v in secs.items():
            med = statistics.median(v)
            call_ms[f"{impl}_{b}"] = med * 1e3
            print(f"serve {impl} route f32 {b}: {med * 1e3:.2f} ms per call "
                  f"(context + k={K} decode + copy to the host, median of "
                  f"10), {n_traj / med:.0f} traj/s")
    calls = 2 * 6 * len(BUCKETS)     # each kernel route: two turns of six
    if lstm_counts() != {"lstm_fused_fwd": 2 * calls, "lstm_fused_bwd": 0,
                         "lstm_proj_fwd": calls, "lstm_proj_bwd": 0}:
        fail("the scan route launched an LSTM kernel, or a kernel route "
             "skipped its kernel")
    return launches, call_ms, lambda impl: call(
        tensors["S64_N64"], noises["S64_N64"], impl)


def profile_phase(run, unit, out_name, wall_ms):
    """torch.profiler over three steady calls of ``run`` (after one
    warm-up): device time by kernel, and the device's busy share of the
    unprofiled wall time per call (``wall_ms``). -> that share, None where
    the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(events[0],
            "self_device_time_total") else "self_cuda_time_total")
    # device activities only: ranges such as Optimizer.step#Adam.step are
    # drawn on the device's timeline over the kernels they enclose
    dev = sorted(((getattr(e, attr), e.key, e.count) for e in events
                  if str(e.device_type).endswith("CUDA")
                  and not getattr(e, "is_user_annotation", False)
                  and not e.key.startswith("Optimizer.")), reverse=True)
    busy_ms = sum(t for t, _, _ in dev) / 3e3
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", out_name), "w") as f:
        f.write(events.table(sort_by=attr, row_limit=60))
    if busy_ms == 0:
        kinds = sorted({str(e.device_type) for e in events})
        print(f"profile {unit}: no device time in the trace (not "
              f"measured); event device types {kinds}")
        return None
    print(f"profile: per {unit} device busy={busy_ms:.3f} ms of "
          f"wall {wall_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% busy), "
          f"{sum(c for _, _, c in dev) // 3} device activities")
    for t, key, count in dev[:12]:
        print(f"profile:   {t / 3e3:8.4f} ms/call {100 * t / 3e3 / busy_ms:5.1f}%"
              f" x{count // 3} {key[:80]}")
    own = {name: sum(t for t, key, _ in dev if name in key) / 3e3
           for name in PORT_KERNELS}
    print(f"profile: the port's kernels per {unit}: "
          + " ".join(f"{name}={ms:.4f}ms" for name, ms in own.items() if ms)
          + f" total={sum(own.values()):.4f}ms "
          f"({100 * sum(own.values()) / busy_ms:.1f}% of device busy, "
          f"{100 * sum(own.values()) / wall_ms:.1f}% of wall)")
    return busy_ms / wall_ms


# ----------------------------------------------------------------- eval

EVAL_CKPTS = ("zara1_12", "univ_12", "zara1_12_gcnpool")   # gat, gat-mh, gcn-pool
EVAL_ROUTES = ("scan", "fused", "pallas")
EVAL_BATCH = 64
EVAL_BUCKETS = 3
EVAL_RTOL = 1e-4             # ADE / FDE: kernel routes vs scan, card vs CPU


def _ckpt(name):
    return os.path.join(HERE, "models", "grouptraj", f"{name}_with_model.pt")


def eval_phase(batches):
    """Bo20 evaluation through the port's data layer and evaluate_bucketed
    on a synthetic ETH/UCY-format split: windowing on the native path
    (bit-identical to the numpy path), then three zoo models (gat, gat-mh,
    gcn-pool) on the three LSTM routes with shared injected noises; each
    route's main path runs with every count at 0 just before it and is
    read just after. Then a few batches against the port on the CPU, and
    the gat-mh and gcn-pool Predictors against the CPU."""
    import math
    import shutil
    import tempfile
    import numpy as np
    import torch
    from grouptraj_torch.compat import config_from_checkpoint_args
    from grouptraj_torch.data import TrajectoryDataset, _native
    from grouptraj_torch.data import windowing_backend
    from grouptraj_torch.data.batching import DenseDataset, DenseLoader
    from grouptraj_torch.data.synthetic import write_scene_files
    from grouptraj_torch.eval import evaluate, evaluate_bucketed
    from grouptraj_torch.eval.evaluate_model import get_generator
    from grouptraj_torch.serve import Predictor
    from grouptraj_torch.train.checkpoint import load_checkpoint
    from grouptraj_torch.train.device_data import make_buckets

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    if not _native.available():                   # g++ at first use
        fail(f"eval: the native windowing library did not build: "
             f"{_native.error()}")
    build_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="grouptraj_eval_")
    try:
        write_scene_files(tmp, n_files=3, frames=560, max_peds=57, seed=0)
        t0 = time.perf_counter()
        dset = TrajectoryDataset(tmp, use_native=True)
        native_s = time.perf_counter() - t0
        backend = windowing_backend()
        t0 = time.perf_counter()
        ref = TrajectoryDataset(tmp, use_native=False)
        numpy_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp)
    if backend != "native":
        fail(f"eval: windowing ran on the {backend} path, not native")
    if len(dset) != len(ref) or not all(
            np.array_equal(getattr(a, k), getattr(b, k))
            for a, b in zip(dset.windows, ref.windows)
            for k in ("xy", "rel", "group", "non_linear", "loss_mask")):
        fail("eval: native windows differ from the numpy path's")
    sizes = dset.scene_sizes()
    buckets = make_buckets(dset, EVAL_BUCKETS, EVAL_BATCH)
    widths = [w for w, idx in buckets
              for _ in range(math.ceil(len(idx) / EVAL_BATCH))]
    print(f"eval data: {len(dset)} windows of {sizes.min()}-{sizes.max()} "
          f"pedestrians (median {int(np.median(sizes))}) from 3 synthetic "
          f"files; windowing path {backend} {native_s * 1e3:.1f} ms (its "
          f"g++ build {build_s:.1f} s before), numpy "
          f"{numpy_s * 1e3:.1f} ms, bit-identical; buckets "
          f"{[(w, len(i)) for w, i in buckets]}, {len(widths)} batches "
          f"of {EVAL_BATCH}")

    # one noise tensor per batch, shared by every model and route
    gen = torch.Generator(device="cuda").manual_seed(3)
    table = [torch.randn((K, EVAL_BATCH, w, 8), generator=gen, device="cuda")
             for w in widths]

    def noises(i, S, N):
        if table[i].shape[1:3] != (S, N):
            fail(f"eval: batch {i} is [{S}, {N}], the noise table's "
                 f"{tuple(table[i].shape)}")
        return table[i]

    # the parity subset: the first batch of each bucket
    sub = [next(iter(DenseLoader(DenseDataset(dset, w, indices=idx),
                                 EVAL_BATCH, shuffle=False)))
           for w, idx in buckets]
    sub_noise = [torch.randn((K, EVAL_BATCH, b.valid.shape[1], 8),
                             generator=gen, device="cuda") for b in sub]
    per_batch = {"scan": {}, "fused": {"lstm_fused_fwd": 2},
                 "pallas": {"lstm_proj_fwd": 1}}
    launches = {impl: dict.fromkeys(all_counts(), 0) for impl in EVAL_ROUTES}
    pass_ms = {}
    for name in EVAL_CKPTS:
        cfg, model = get_generator(load_checkpoint(_ckpt(name)))
        model = model.to("cuda").eval()
        want_k1 = 0 if cfg.pooling_type == "gcn" else 1
        out = {}
        for impl in EVAL_ROUTES:       # the main path of each route
            reset_counts()
            out[impl] = evaluate_bucketed(
                model, dset, K, EVAL_BATCH, EVAL_BUCKETS, noises=noises,
                impl=impl, device="cuda")
            torch.cuda.synchronize()
            counts = all_counts()
            for k_, v in counts.items():
                launches[impl][k_] += v
            expect = {k_: len(widths) * per_batch[impl].get(k_, 0)
                      for k_ in counts}
            expect["pool_core_fwd"] = len(widths) * want_k1
            print(f"eval {name} {impl} main path launches: "
                  f"{json.dumps(counts)}")
            if counts != expect:
                fail(f"eval {name} {impl}: launches {counts}, expected "
                     f"{expect} ({per_batch[impl]} and K1 x{want_k1} a "
                     f"batch)")
            if not all(math.isfinite(v) and v > 0 for v in out[impl]):
                fail(f"eval {name} {impl}: ADE/FDE {out[impl]} not finite")
        for impl in ("fused", "pallas"):
            d = max(abs(a / b - 1) for a, b in zip(out[impl], out["scan"]))
            print(f"eval {name}: {impl} ADE/FDE {out[impl][0]:.6f}/"
                  f"{out[impl][1]:.6f} vs scan {out['scan'][0]:.6f}/"
                  f"{out['scan'][1]:.6f}, max relative diff {d:.2e} "
                  f"(tolerance {EVAL_RTOL})")
            if not d <= EVAL_RTOL:
                fail(f"eval {name}: the {impl} route disagrees with scan")

        # a few batches against the port on the CPU (plain versions)
        cpu_model = get_generator(load_checkpoint(_ckpt(name)))[1]
        ref = evaluate(cpu_model, sub, K, noises=lambda i, S, N:
                       sub_noise[i].cpu(), impl="scan", device="cpu")
        for impl in EVAL_ROUTES:
            got = evaluate(model, sub, K, noises=lambda i, S, N:
                           sub_noise[i], impl=impl, device="cuda")
            d = max(abs(a / b - 1) for a, b in zip(got, ref))
            print(f"eval {name} {impl}: card vs CPU on {len(sub)} batches "
                  f"max relative diff {d:.2e} (tolerance {EVAL_RTOL})")
            if not d <= EVAL_RTOL:
                fail(f"eval {name}: the card ({impl}) disagrees with the CPU")

        # wall time per pass, the routes in turns
        secs = {impl: [] for impl in EVAL_ROUTES}
        for impl in EVAL_ROUTES + EVAL_ROUTES[::-1]:
            t0 = time.perf_counter()
            evaluate_bucketed(model, dset, K, EVAL_BATCH, EVAL_BUCKETS,
                              noises=noises, impl=impl, device="cuda")
            secs[impl].append(time.perf_counter() - t0)   # read back: synced
        for impl, v in secs.items():
            med = statistics.median(v)
            pass_ms[f"{name}_{impl}"] = med * 1e3
            print(f"eval {name} {impl}: {med * 1e3:.1f} ms per pass "
                  f"(median of 2), {len(dset) / med:.0f} windows/s, "
                  f"{med * 1e3 / len(widths):.2f} ms per batch")
        if name == "univ_12":              # one batch of the widest bucket
            def run():
                return evaluate(model, sub[-1:], K, noises=lambda i, S, N:
                                sub_noise[-1], impl="fused", device="cuda")
            run()
            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                run()                                    # read back: synced
                walls.append(time.perf_counter() - t0)
            wall = statistics.median(walls) * 1e3
            print(f"eval {name} fused: {wall:.2f} ms per batch of the "
                  f"widest bucket (median of 5)")
            profile_phase(run, "eval batch (univ_12, fused, widest bucket)",
                          "profile_eval_fused.txt", wall)
        del model, cpu_model

    # the gat-mh and gcn-pool Predictors, card against CPU
    sc, gr = batches["S64_N64"][0][:8], batches["S64_N64"][1][:8]
    for name in ("univ_12", "zara1_12_gcnpool"):
        ckpt = load_checkpoint(_ckpt(name))
        cfg = config_from_checkpoint_args(ckpt["args"], ckpt["g_best_state"])
        card = Predictor(ckpt["g_best_state"], cfg, num_samples=K,
                         param_dtype=None, device="cuda")
        cpu = Predictor(ckpt["g_best_state"], cfg, num_samples=K,
                        param_dtype=None, device="cpu")
        S, N = card._s_bucket(len(sc)), card._bucket(max(map(len, sc)))
        z = torch.randn((K, S, N, 8), generator=gen, device="cuda")
        got = card.predict_batch(sc, gr, noises=z)
        want = cpu.predict_batch(sc, gr, noises=z.cpu())
        d = max(np.abs(o - r).max() for o, r in zip(got, want))
        print(f"eval Predictor {name} ({cfg.graph_module}, "
              f"{cfg.pooling_type}): card vs CPU max |dpos| = {d:.3e} m "
              f"(tolerance {SERVE_ATOL} m)")
        if not (d <= SERVE_ATOL and all(np.isfinite(o).all() for o in got)):
            fail(f"eval Predictor {name}: the card disagrees with the CPU")

    for impl, kernel in (("scan", "pool_core_fwd"), ("fused", "lstm_fused_fwd"),
                         ("pallas", "lstm_proj_fwd")):
        if launches[impl][kernel] == 0 or launches[impl]["pool_core_fwd"] == 0:
            fail(f"eval: the {impl} route launched {kernel} or K1 no time")
    print(f"eval launches per batch (pool_net models): K1 1, K3 2 on fused, "
          f"K5 1 on pallas; totals {json.dumps(launches)}; the phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches, pass_ms


# ----------------------------------------------------------------- train

def _grad_report(what, names, got, ref, floor=1e-6, rtol=TRAIN_GRAD_RTOL):
    """Largest per-tensor max |Δ| / max |ref| over the gradient tensors;
    fails beyond ``rtol``. A tensor whose gradient is zero to rounding
    (the inter-group attention vectors: ~1e-10 beside 1e-2 elsewhere) is
    measured against ``floor`` of the largest gradient entry of its
    network instead of its own."""
    import torch
    ref = [r.to(g.device) for g, r in zip(got, ref)]
    top = {net: max(r.abs().max().item() for n, r in zip(names, ref)
                    if n[0] == net) for net in "DG"}
    worst, worst_name, zero = 0.0, "", 0
    for name, g, r in zip(names, got, ref):
        if not torch.isfinite(g).all():
            fail(f"{what}: gradient of {name} is not finite")
        zero += int(r.abs().max().item() == 0)
        scale = max(r.abs().max().item(), floor * top[name[0]], 1e-30)
        rel = (g - r).abs().max().item() / scale
        if rel > worst:
            worst, worst_name = rel, name
    print(f"{what}: {len(names)} gradient tensors ({zero} all-zero; largest "
          f"entry D {top['D']:.3e}, G {top['G']:.3e}), worst max|d|/max|ref|"
          f" = {worst:.3e} ({worst_name}; tolerance {rtol})")
    if not worst <= rtol:
        fail(f"{what}: parameter gradients disagree")
    if top["D"] == 0 or top["G"] == 0:
        fail(f"{what}: a network's gradient is zero everywhere: nothing "
             "was compared")


def _loss_report(what, got, ref):
    worst = 0.0
    for k, v in got.items():
        a, b = float(v), float(ref[k])
        if not (a == a and abs(a) != float("inf")):
            fail(f"{what}: loss {k} is not finite")
        worst = max(worst, abs(a - b) / max(abs(b), 1e-12))
    print(f"{what}: losses " + " ".join(f"{k}={float(v):.6f}"
                                        for k, v in got.items())
          + f" worst rel diff = {worst:.3e} (tolerance {TRAIN_LOSS_RTOL})")
    if not worst <= TRAIN_LOSS_RTOL:
        fail(f"{what}: losses disagree")


def _one_iteration(state, batch, cfg, tcfg, noise, noises, label,
                   impl="scan"):
    """Losses and gradients of one d-step and one g-step from ``state``,
    nothing updated."""
    from grouptraj_torch.train.steps import d_gradients, g_gradients
    ld, gd = d_gradients(state, batch, cfg, tcfg, noise=noise, label=label,
                         impl=impl)
    lg, gg = g_gradients(state, batch, cfg, tcfg, noises=noises, label=label,
                         impl=impl)
    names = [f"D.{k}" for k, _ in state.d.named_parameters()] \
        + [f"G.{k}" for k, _ in state.g.named_parameters()]
    return {**ld, **lg}, names, list(gd) + list(gg)


def alive_state(cfg, tcfg, batch, gen):
    """A seeded state whose discriminator is alive on most of ``batch``.
    The discriminator's score passes a trailing ReLU (a quirk the port
    keeps), so about every second initialisation scores 0 everywhere and
    has no gradient at all; take the first seed from 2 up whose scores are
    positive on at least half the valid rows, so that comparisons of
    gradients compare something. -> (state, seed, alive share)."""
    import torch
    from grouptraj_torch.train.steps import init_train_state
    for seed in range(2, 34):
        gen.manual_seed(seed)
        state = init_train_state(cfg, tcfg, generator=gen, device="cuda")
        with torch.no_grad():
            scores = state.d(torch.cat([batch["obs"], batch["pred"]], 2),
                             torch.cat([batch["obs_rel"], batch["pred_rel"]],
                                       2), batch["valid"])
        alive = (scores[batch["valid"] > 0] > 0).float().mean().item()
        if alive >= 0.5:
            return state, seed, alive
    fail("no seed in 2..33 gave a discriminator with positive scores")


def train_phase():
    import copy
    import torch
    from grouptraj_torch.config import ModelConfig, TrainConfig
    from grouptraj_torch.ops.cuda_pool import pool_core_bwd, pool_core_fwd
    from grouptraj_torch.train.device_data import (
        gather_batch, synthetic_device_data,
    )
    from grouptraj_torch.train.steps import (
        d_step, g_step, train_iterations, train_state_from_modules,
    )

    cfg, tcfg = ModelConfig(), TrainConfig()
    S, k = tcfg.batch_size, tcfg.best_k
    data = {64: synthetic_device_data(256, 64, seed=3, device="cuda"),
            16: synthetic_device_data(256, 16, seed=4, device="cuda")}
    gen = torch.Generator(device="cuda").manual_seed(1)
    idx = {N: torch.randint(0, 256, (max(TRAIN_ITERS.values()), 2, S),
                            generator=gen,
                            device="cuda") for N in data}
    batch = gather_batch(data[64], idx[64][0, 0], cfg.obs_len)
    state, seed, alive = alive_state(cfg, tcfg, batch, gen)
    n_par = sum(p.numel() for m in (state.g, state.d)
                for p in m.parameters())
    print(f"train: gat preset at full width (G H={cfg.encoder_h_dim_g}, "
          f"D H={cfg.encoder_h_dim_d}, pool 512 -> {cfg.bottleneck_dim} / "
          f"{cfg.encoder_h_dim_d}), {n_par} parameters, batch {S}, "
          f"best_k {k}, sparse_best_k {tcfg.sparse_best_k}, bf16_nograd "
          f"{tcfg.bf16_nograd}; seed {seed} (discriminator scores positive "
          f"on {100 * alive:.0f}% of the first batch)")

    # (a) one iteration, kernels vs the plain pool core, exact float32
    f32 = dataclasses.replace(tcfg, bf16_nograd=False)
    draw = dict(noise=torch.randn((S, 64, 8), generator=gen, device="cuda"),
                noises=torch.randn((k, S, 64, 8), generator=gen,
                                   device="cuda"), label=0.9)
    fwd0, bwd0 = pool_core_fwd.launches, pool_core_bwd.launches
    losses, names, grads = _one_iteration(state, batch, cfg, f32, **draw)
    torch.cuda.synchronize()
    per_iter = (pool_core_fwd.launches - fwd0, pool_core_bwd.launches - bwd0)
    plain_cfg = dataclasses.replace(cfg, pool_impl="fast")
    plain = train_state_from_modules(copy.deepcopy(state.g),
                                     copy.deepcopy(state.d), f32)
    plain.g.cfg = plain.d.cfg = plain_cfg
    ref_losses, _, ref_grads = _one_iteration(plain, batch, plain_cfg, f32,
                                              **draw)
    if (pool_core_fwd.launches - fwd0, pool_core_bwd.launches - bwd0) \
            != per_iter:
        fail("the plain-pool iteration launched a pool kernel")
    _loss_report("train S64_N64 kernels vs plain pool", losses, ref_losses)
    _grad_report("train S64_N64 kernels vs plain pool", names, grads,
                 ref_grads)
    del plain, ref_grads, grads

    # (b) a small batch, the card against the port on the CPU
    small = gather_batch(data[16], idx[16][0, 0, :8], cfg.obs_len)
    sdraw = dict(noise=draw["noise"][:8, :16].contiguous(),
                 noises=draw["noises"][:, :8, :16].contiguous(), label=0.9)
    losses, names, grads = _one_iteration(state, small, cfg, f32, **sdraw)
    cpu = train_state_from_modules(copy.deepcopy(state.g).cpu(),
                                   copy.deepcopy(state.d).cpu(), f32)
    ref_losses, _, ref_grads = _one_iteration(
        cpu, {k_: v.cpu() for k_, v in small.items()}, cfg, f32,
        **{k_: v.cpu() if hasattr(v, "cpu") else v
           for k_, v in sdraw.items()})
    _loss_report("train S8_N16 GPU vs CPU", losses, ref_losses)
    _grad_report("train S8_N16 GPU vs CPU", names, grads, ref_grads)
    del cpu, ref_grads, grads

    # (c) one iteration on each kernel route (fused: K3 x7, K4 x4; pallas:
    # K5 x4, K6 x3) against the scan route, and against the same route with
    # its kernels' wrappers replaced by their plain versions
    losses, names, grads = _one_iteration(state, batch, cfg, f32, **draw)
    routes = {"fused": ({"lstm_fused_fwd": 7, "lstm_fused_bwd": 4},
                        plain_lstm_kernels),
              "pallas": ({"lstm_proj_fwd": 4, "lstm_proj_bwd": 3},
                         plain_lstm_proj_kernels)}
    for impl, (launched, plain_kernels) in routes.items():
        before = lstm_counts()
        k_losses, _, k_grads = _one_iteration(state, batch, cfg, f32, **draw,
                                              impl=impl)
        torch.cuda.synchronize()
        per_iter = {k_: v - before[k_] for k_, v in lstm_counts().items()}
        print(f"train S64_N64 {impl}: one iteration launched "
              + json.dumps(per_iter))
        if per_iter != {k_: launched.get(k_, 0) for k_ in per_iter}:
            fail(f"a {impl} iteration must launch {launched} and no other "
                 f"LSTM kernel")
        _loss_report(f"train S64_N64 {impl} vs scan", k_losses, losses)
        _grad_report(f"train S64_N64 {impl} vs scan", names, k_grads, grads)
        with plain_kernels():
            p_losses, _, p_grads = _one_iteration(state, batch, cfg, f32,
                                                  **draw, impl=impl)
        if lstm_counts() != {k_: v + before[k_] for k_, v in
                             per_iter.items()}:
            fail(f"the plain {impl} iteration launched an LSTM kernel")
        _loss_report(f"train S64_N64 {impl} kernels vs plain {impl}",
                     k_losses, p_losses)
        _grad_report(f"train S64_N64 {impl} kernels vs plain {impl}", names,
                     k_grads, p_grads)
        del k_grads, p_grads
    del grads

    # (d) the main paths: train_iterations with the defaults on the three
    # routes, in turns, every run from a copy of the same state; the widest
    # bucket first; every count at 0 just before a run, read just after
    launches, it_ms = {}, {}
    for N in (64, 16):
        tag = f"S{S}_N{N}"
        ms = {"scan": [], "fused": [], "pallas": []}
        for impl in ("scan", "fused", "pallas", "pallas", "fused", "scan"):
            iters = TRAIN_ITERS[impl]
            run = train_state_from_modules(copy.deepcopy(state.g),
                                           copy.deepcopy(state.d), tcfg)
            train_iterations(run, data[N], idx[N][:2], cfg, tcfg, gen,
                             impl=impl)                          # warm
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            out = train_iterations(run, data[N], idx[N][:iters], cfg, tcfg,
                                   gen, impl=impl)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = all_counts()
            per = {k_: v / iters for k_, v in counts.items()}
            want = {"pool_core_fwd": 4, "pool_core_bwd": 3,
                    "lstm_fused_fwd": 7 * (impl == "fused"),
                    "lstm_fused_bwd": 4 * (impl == "fused"),
                    "lstm_proj_fwd": 4 * (impl == "pallas"),
                    "lstm_proj_bwd": 3 * (impl == "pallas")}
            print(f"train {tag} {impl} main path launches: "
                  f"{json.dumps(counts)} over {iters} iterations")
            if per != want:
                fail(f"train {tag} {impl}: launches per iteration {per}, "
                     f"expected {want}")
            launches.setdefault((impl, N), counts)
            for name, v in out.items():
                if v.shape != (iters,) or not torch.isfinite(v).all():
                    fail(f"train {tag} {impl}: loss {name} is not finite "
                         f"over the run")
            last = {name: round(float(v[-1]), 5) for name, v in out.items()}
            ms[impl].append(secs * 1e3 / iters)
            print(f"train {tag} {impl}: {iters / secs:.1f} it/s "
                  f"({ms[impl][-1]:.2f} ms per iteration); last losses "
                  f"{json.dumps(last)}")
        b = gather_batch(data[N], idx[N][0, 0], cfg.obs_len)
        for impl in ("scan", "fused", "pallas"):
            it_ms[(impl, N)] = statistics.mean(ms[impl])
            d_ms = time_ms(lambda: d_step(run, b, cfg, tcfg, gen, impl=impl),
                           reps=10)
            g_ms = time_ms(lambda: g_step(run, b, cfg, tcfg, gen, impl=impl),
                           reps=10)
            print(f"train {tag} {impl}: mean of its two runs "
                  f"{1e3 / it_ms[(impl, N)]:.1f} it/s; d-step {d_ms:.3f} ms, "
                  f"g-step {g_ms:.3f} ms (CUDA events around one step, "
                  f"median of 10)")
        print(f"train {tag}: fused/scan = "
              f"{it_ms[('scan', N)] / it_ms[('fused', N)]:.2f}x it/s, "
              f"pallas/scan = "
              f"{it_ms[('scan', N)] / it_ms[('pallas', N)]:.2f}x it/s")

    # (e) where one iteration's time goes, on each route
    for impl, out_name in (("scan", "profile_train.txt"),
                           ("fused", "profile_train_fused.txt"),
                           ("pallas", "profile_train_pallas.txt")):
        profile_phase(lambda: train_iterations(state, data[64], idx[64][:1],
                                               cfg, tcfg, gen, impl=impl),
                      f"training iteration S{S}_N64 {impl}", out_name,
                      it_ms[(impl, 64)])
    return {impl: launches[(impl, 64)] for impl in TRAIN_ITERS}


# ----------------------------------------------------------------- loop

# train() runs of the loop phase: route -> iterations (the fused run is
# resumed from its file to LOOP_RESUME)
LOOP_ITERS = {"fused": 80, "pallas": 40}
LOOP_RESUME = 100
LOOP_SEED = 6                # its discriminator is alive (the train phase)
LOOP_RTOL = 1e-4             # val sweep metrics, card vs CPU
# launches per training iteration on each route, at least
LOOP_PER_ITER = {"fused": {"pool_core_fwd": 4, "pool_core_bwd": 3,
                           "lstm_fused_fwd": 7, "lstm_fused_bwd": 4},
                 "pallas": {"pool_core_fwd": 4, "pool_core_bwd": 3,
                            "lstm_proj_fwd": 4, "lstm_proj_bwd": 3}}


def _adam_equal(a, b):
    """Two TrainStates' Adam moments and steps are equal bit for bit."""
    import torch
    for opt_a, mod_a, opt_b, mod_b in ((a.g_opt, a.g, b.g_opt, b.g),
                                       (a.d_opt, a.d, b.d_opt, b.d)):
        pb = dict(mod_b.named_parameters())
        for name, p in mod_a.named_parameters():
            sa, sb = opt_a.state[p], opt_b.state[pb[name]]
            if set(sa) != {"step", "exp_avg", "exp_avg_sq"} or set(sb) != \
                    set(sa) or not all(torch.equal(sa[k], sb[k])
                                       for k in sa):
                return False
    return True


def loop_phase(smi):
    """The training loop through train() on a synthetic ETH/UCY-format
    split: the gat preset at full width on 'fused' (K1-K4) for
    LOOP_ITERS iterations, then resumed from its file to LOOP_RESUME, and
    on 'pallas' (K1, K2, K5, K6), every count at 0 just before each run
    and read just after; the files, the reloaded Adam state against the
    run's own, the val sweep of the saved state on the card against the
    CPU with injected draws, and evaluate_bucketed of g_best_state. Prints
    it/s of each run, ms per sweep event and ms per checkpoint save."""
    import math
    import shutil
    import tempfile
    import numpy as np
    import torch
    from grouptraj_torch.config import ModelConfig, TrainConfig
    from grouptraj_torch.data import TrajectoryDataset
    from grouptraj_torch.data.synthetic import write_scene_files
    from grouptraj_torch.eval import evaluate_bucketed
    from grouptraj_torch.eval.evaluate_model import get_generator
    from grouptraj_torch.train import checkpoint as CK
    from grouptraj_torch.train import loop as LOOP
    from grouptraj_torch.train.device_data import device_dataset
    from grouptraj_torch.train.steps import (
        read_sums, summarize_check_accuracy,
    )

    t_phase = time.perf_counter()
    timed = {"dispatch": [], "sweep": [], "save": []}

    def timing(kind, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            timed[kind].append(time.perf_counter() - t0)
            return out
        return run

    def timed_sweep_factory(*args, **kw):
        return timing("sweep", make_sweep(*args, **kw))

    make_sweep = LOOP.make_check_accuracy_sweep
    tmp = tempfile.mkdtemp(prefix="grouptraj_loop_")
    saved_env = os.environ.get("GROUPTRAJ_DATA_DIR")
    os.environ["GROUPTRAJ_DATA_DIR"] = tmp
    try:
        write_scene_files(os.path.join(tmp, "synth", "train"), n_files=3,
                          frames=560, max_peds=57, seed=0)
        # one shorter val file: its sweep also runs on the CPU below
        write_scene_files(os.path.join(tmp, "synth", "val"), n_files=1,
                          frames=200, max_peds=57, seed=1)
        cfg = ModelConfig()
        base = dict(dataset_name="synth", batch_size=64, best_k=20,
                    n_buckets=3, steps_per_dispatch=20, print_every=20,
                    checkpoint_every=40, num_epochs=0, seed=LOOP_SEED,
                    output_dir=os.path.join(tmp, "out"))
        runs, results = {}, {}
        for name, impl, iters in (
                ("fused", "fused", LOOP_ITERS["fused"]),
                ("fused_resumed", "fused", LOOP_RESUME),
                ("pallas", "pallas", LOOP_ITERS["pallas"])):
            tcfg = TrainConfig(**base, num_iterations=iters, lstm_impl=impl,
                               checkpoint_name=impl)
            for k in timed:
                timed[k].clear()
            with _swapped(LOOP, make_check_accuracy_sweep=timed_sweep_factory,
                          train_iterations=timing("dispatch",
                                                  LOOP.train_iterations)), \
                    _swapped(CK, save_checkpoint=timing(
                        "save", CK.save_checkpoint)):
                torch.cuda.synchronize()
                reset_counts()
                t0 = time.perf_counter()
                ckpt, state = LOOP.train(cfg, tcfg, device="cuda",
                                         return_state=True)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = all_counts()
            ran = iters - (LOOP_ITERS["fused"] if name == "fused_resumed"
                           else 0)
            runs[name] = counts
            results[name] = (tcfg, ckpt, state)
            want = {k: v * ran for k, v in LOOP_PER_ITER[impl].items()}
            print(f"loop {name}: train() {ran} iterations on {impl}, "
                  f"launches {json.dumps(counts)}")
            short = {k: counts[k] for k in want if counts[k] < want[k]}
            if short or not all(counts[k] for k in want):
                fail(f"loop {name}: launches {short} below {want}")
            hist = ([v for vals in ckpt["G_losses"].values() for v in vals]
                    + [v for vals in ckpt["D_losses"].values() for v in vals]
                    + ckpt["norm_g"] + ckpt["norm_d"]
                    + [v for vals in ckpt["metrics_val"].values()
                       for v in vals])
            if not hist or not all(math.isfinite(v) for v in hist):
                fail(f"loop {name}: a loss, norm or metric is not finite")
            if max(ckpt["norm_d"]) <= 0:
                fail(f"loop {name}: the discriminator had no gradient")
            for suffix in ("_with_model.pt", "_no_model.pt"):
                if not os.path.isfile(os.path.join(
                        tcfg.output_dir, tcfg.checkpoint_name + suffix)):
                    fail(f"loop {name}: {tcfg.checkpoint_name}{suffix} "
                         f"was not written")
            n_events = len(timed["sweep"]) // 2
            disp = sum(timed["dispatch"])
            print(f"loop {name}: {ran / wall:.2f} it/s over the run "
                  f"({wall:.2f} s wall), {ran / disp:.2f} it/s in its "
                  f"{len(timed['dispatch'])} dispatches; "
                  f"{1e3 * sum(timed['sweep']) / max(n_events, 1):.1f} ms "
                  f"per sweep event ({n_events} events, val + train); "
                  f"{1e3 * statistics.mean(timed['save']):.1f} ms per "
                  f"checkpoint save ({len(timed['save'])} saves); "
                  f"last val ade {ckpt['metrics_val']['ade'][-1]:.4f}; "
                  f"{smi}")

        # the resume and the reloaded Adam state
        tcfg, ckpt, state = results["fused_resumed"]
        if ckpt["counters"]["t"] != LOOP_RESUME or \
                LOOP_ITERS["fused"] not in ckpt["restore_ts"]:
            fail(f"loop: the resumed run ended at {ckpt['counters']} with "
                 f"restore_ts {ckpt['restore_ts']}")
        path = os.path.join(tcfg.output_dir, "fused_with_model.pt")
        loaded = CK.load_checkpoint(path)
        reloaded = CK.state_from_checkpoint(loaded, cfg, tcfg, "cuda")
        if not _adam_equal(state, reloaded):
            fail("loop: the reloaded Adam state differs from the run's")
        small = CK.load_checkpoint(os.path.join(tcfg.output_dir,
                                                "fused_no_model.pt"))
        if set(CK.KEY_BLACKLIST) & set(small):
            fail("loop: the small checkpoint holds model states")
        print(f"loop: resumed to t={ckpt['counters']['t']} (restore_ts "
              f"{ckpt['restore_ts']}); fused_with_model.pt reloads with Adam "
              f"exp_avg/exp_avg_sq/step equal bit for bit (step "
              f"{int(next(iter(reloaded.g_opt.state.values()))['step'])})")

        # the val sweep of the saved state, card against CPU, same draws
        _, _, val_loader = LOOP.build_loaders(cfg, tcfg)
        dense = val_loader.dense
        idx = LOOP._sweep_indices(dense.num_seq, tcfg.batch_size)
        gen = torch.Generator().manual_seed(2)
        draws = [(torch.randn((tcfg.batch_size, dense.n_max, 8),
                              generator=gen), 0.7 + 0.5 * i / len(idx))
                 for i in range(len(idx))]
        metrics = {}
        t_cpu = 0.0
        for dev in ("cuda", "cpu"):
            st = CK.state_from_checkpoint(loaded, cfg, tcfg, dev)
            sweep = make_sweep(cfg, "fused")
            t0 = time.perf_counter()
            sums = sweep(st, device_dataset(dense, cfg.obs_len, dev),
                         torch.from_numpy(idx).to(dev, torch.long),
                         draws=lambda i, S, N: (draws[i][0].to(dev),
                                                draws[i][1]))
            metrics[dev] = summarize_check_accuracy(read_sums(sums),
                                                    len(idx), cfg.pred_len)
            t_cpu = time.perf_counter() - t0
        worst = max(abs(metrics["cuda"][k] - v) / max(abs(v), 1e-12)
                    for k, v in metrics["cpu"].items())
        print(f"loop: val sweep of the saved state ({dense.num_seq} "
              f"windows, {len(idx)} batches, fused) card vs CPU: worst "
              f"relative difference {worst:.2e} (limit {LOOP_RTOL}); ade "
              f"{metrics['cuda']['ade']:.6f} / {metrics['cpu']['ade']:.6f}; "
              f"the CPU sweep took {t_cpu:.1f} s")
        if not worst <= LOOP_RTOL:
            fail(f"loop: val sweep card vs CPU {metrics}")

        # evaluate_bucketed of the best state, on the card
        _, model = get_generator(loaded, use_best=True)
        dset = TrajectoryDataset(os.path.join(tmp, "synth", "val"))
        ade, fde = evaluate_bucketed(model, dset, 20, batch_size=64,
                                     n_buckets=3, seed=0, impl="fused",
                                     device="cuda")
        if not (math.isfinite(ade) and math.isfinite(fde)):
            fail(f"loop: evaluate_bucketed of g_best_state gave {ade}, {fde}")
        print(f"loop: evaluate_bucketed of g_best_state (t="
              f"{loaded['best_t']}) on the card: ADE {ade:.4f} FDE "
              f"{fde:.4f}; the phase took "
              f"{time.perf_counter() - t_phase:.1f} s")
    finally:
        shutil.rmtree(tmp)
        if saved_env is None:
            os.environ.pop("GROUPTRAJ_DATA_DIR", None)
        else:
            os.environ["GROUPTRAJ_DATA_DIR"] = saved_env
    return {"fused": {k: runs["fused"][k] + runs["fused_resumed"][k]
                      for k in runs["fused"]}, "pallas": runs["pallas"]}


# ----------------------------------------------------------------- presets

PET_ITERS = 3                # timed iterations of a per-step training run
PLAIN_CHUNK = 128            # scenes per call of a plain pool reference


def plain_pool_kernels():
    """Within the block the wrappers of K1 and K2 run their plain PyTorch
    versions on the card, over chunks of PLAIN_CHUNK scenes (a check's
    reference, never the port's path): the plain versions hold [S, N, N,
    512] slabs, 10.7 GB at the per-step decoder's S = 1,280. Scenes are
    independent; the weight gradients sum over the chunks."""
    import torch
    from grouptraj_torch.ops import cuda_pool
    from grouptraj_torch.ops.pooling import pool_core, pool_core_bwd_plain

    def chunked(fn, a, u, W2, b2, *per_scene):
        """fn over scene chunks; a, u and ``per_scene`` [R, S, ...]."""
        cut = lambda t, s: t[:, s:s + PLAIN_CHUNK]
        outs = [fn(cut(a, s), cut(u, s), W2, b2,
                   *[cut(t, s) for t in per_scene])
                for s in range(0, a.shape[1], PLAIN_CHUNK)]
        return tuple(torch.cat(p, 1) if p[0].dim() == a.dim() else sum(p)
                     for p in zip(*outs))

    def fwd(a, u, W2, b2, valid, bf16=False):
        return chunked(functools.partial(pool_core, bf16=bf16), a, u, W2,
                       b2, valid)

    def bwd(a, u, W2, b2, valid, pooled, cnt, dpool, weight_grads=True,
            debug=None, bf16=False):
        da, du, dW2, db2 = chunked(
            functools.partial(pool_core_bwd_plain, bf16=bf16), a, u, W2, b2,
            valid, pooled, cnt, dpool)
        return (da, du, dW2, db2) if weight_grads else (da, du, None, None)

    return _swapped(cuda_pool, pool_core_fwd=fwd, pool_core_bwd=bwd)


def _positions_report(what, got, ref):
    import numpy as np
    d = max(np.abs(o - r).max() for o, r in zip(got, ref)) if got else 0.0
    print(f"{what}: max |dpos| = {d:.3e} m (tolerance {SERVE_ATOL} m)")
    if not d <= SERVE_ATOL:
        fail(f"{what}: positions disagree")


def presets_phase(batches, noises):
    """The per-step pooling decoder and the other presets at full width.

    1. The ``gat`` preset with ``pool_every_timestep`` (upstream
       Social-GAN's per-step pooling; G H=32, pool 48→512→8, decoder MLP
       40→64→32; D H=48, pool 64→512→48), seeded weights, k=20:
       ``Predictor.predict_batch`` at (S=64, N=64) with realistic scenes,
       its K1 launches (the context and every decode step at K·S = 1,280
       scenes), kernel vs plain pool, card vs CPU on four small scenes,
       ms per call, peak memory and a profile; then training (batch 64,
       best_k=20: the dense best-of-k path) — one iteration's losses and
       gradients, kernels vs plain pool and card vs CPU on a small batch —
       and PET_ITERS iterations of ``train_iterations`` on 'scan' and on
       'fused' with their launches, it/s and peak memory, and a profile.
    2. ``gcn``, ``sgan-p`` and ``sgan`` (with the local discriminator):
       one k=20 serving call (context + decode on 'fused') and one
       training iteration on 'fused' each at S=64, N=64, against the
       plain pool and the CPU as above, with the kernels each launched.

    -> launch counts of the main paths serve_pet, train_pet,
    train_pet_fused, serve_presets and train_presets (each driven with the
    counts at 0 just before it and read just after)."""
    import copy
    import numpy as np
    import torch
    from grouptraj_torch.config import MODEL_PRESETS, ModelConfig, TrainConfig
    from grouptraj_torch.serve import Predictor
    from grouptraj_torch.train.device_data import (
        gather_batch, synthetic_device_data,
    )
    from grouptraj_torch.train.steps import (
        train_iterations, train_state_from_modules,
    )
    from grouptraj_torch.utils import relative_to_abs

    t_phase = time.perf_counter()
    tcfg = TrainConfig()
    S, k = tcfg.batch_size, tcfg.best_k
    f32 = dataclasses.replace(tcfg, bf16_nograd=False)
    data = synthetic_device_data(256, 64, seed=7, device="cuda")
    data16 = synthetic_device_data(16, 16, seed=8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    idx = torch.randint(0, 256, (PET_ITERS + 1, 2, S), generator=gen,
                        device="cuda")
    batch = gather_batch(data, idx[0, 0], 8)
    small = gather_batch(data16, torch.arange(4, device="cuda"), 8)
    draw = dict(noise=torch.randn((S, 64, 8), generator=gen, device="cuda"),
                noises=torch.randn((k, S, 64, 8), generator=gen,
                                   device="cuda"), label=0.9)
    sdraw = dict(noise=draw["noise"][:4, :16].contiguous(),
                 noises=draw["noises"][:, :4, :16].contiguous(), label=0.9)
    cpu = lambda t: t.cpu() if hasattr(t, "cpu") else t
    sc, gr = batches["S64_N64"]
    z = noises["S64_N64"]
    few = [i for i, s in enumerate(sc) if s.shape[0] <= 16][:4]
    few_sc, few_gr = [sc[i] for i in few], [gr[i] for i in few]
    z_few = z[:, :4, :16].contiguous()

    def iteration_checks(what, state, cfg, impl):
        """One iteration's losses and gradients: kernels vs plain pool at
        S=64/N=64, card vs CPU on a 4-scene N=16 batch."""
        got = _one_iteration(state, batch, cfg, f32, **draw, impl=impl)
        with plain_pool_kernels():
            ref = _one_iteration(state, batch, cfg, f32, **draw, impl=impl)
        _loss_report(f"{what} kernels vs plain pool", got[0], ref[0])
        _grad_report(f"{what} kernels vs plain pool", got[1], got[2], ref[2])
        del got, ref
        got = _one_iteration(state, small, cfg, f32, **sdraw, impl=impl)
        host = train_state_from_modules(copy.deepcopy(state.g).cpu(),
                                        copy.deepcopy(state.d).cpu(), f32)
        ref = _one_iteration(host, {k_: v.cpu() for k_, v in small.items()},
                             cfg, f32, **{k_: cpu(v)
                                          for k_, v in sdraw.items()},
                             impl=impl)
        _loss_report(f"{what} S4_N16 GPU vs CPU", got[0], ref[0])
        _grad_report(f"{what} S4_N16 GPU vs CPU", got[1], got[2], ref[2])

    # 1. gat + pool_every_timestep
    pet = ModelConfig(pool_every_timestep=True)
    state, seed, alive = alive_state(pet, tcfg, batch, gen)
    print(f"presets: gat + pool_every_timestep at full width (decoder "
          f"pool {pet.embedding_dim + pet.decoder_h_dim_g} -> 512 -> "
          f"{pet.bottleneck_dim}, decoder MLP "
          f"{pet.decoder_h_dim_g + pet.bottleneck_dim} -> {pet.mlp_dim} -> "
          f"{pet.decoder_h_dim_g}), seed {seed} (D positive on "
          f"{100 * alive:.0f}%)")
    sd = {k_: v.detach() for k_, v in state.g.state_dict().items()}
    p = Predictor(sd, pet, num_samples=K, param_dtype=None, device="cuda")
    p.predict_batch(sc, gr, noises=z)                          # warm
    torch.cuda.synchronize()
    reset_counts()
    out = p.predict_batch(sc, gr, noises=z)
    torch.cuda.synchronize()
    serve_pet = all_counts()
    print(f"serve_pet main path launches (one k={K} call, S=64, N=64): "
          f"{json.dumps(serve_pet)}")
    if serve_pet["pool_core_fwd"] < 1 + pet.pred_len:
        fail("the per-step serving call must launch K1 for the context "
             "and on every decode step")
    if not all(np.isfinite(o).all() and o.shape == (K, s.shape[0],
                                                    pet.pred_len, 2)
               for o, s in zip(out, sc)):
        fail("serve_pet: outputs not finite or of the wrong shape")
    with plain_pool_kernels():
        ref = p.predict_batch(sc, gr, noises=z)
    _positions_report("serve_pet S64_N64 kernel vs plain pool", out, ref)
    host = Predictor(sd, pet, num_samples=K, param_dtype=None, device="cpu")
    _positions_report("serve_pet S4_N16 GPU vs CPU",
                      p.predict_batch(few_sc, few_gr, noises=z_few),
                      host.predict_batch(few_sc, few_gr,
                                         noises=z_few.cpu()))
    secs = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(5):
        t0 = time.perf_counter()
        p.predict_batch(sc, gr, noises=z)              # host arrays: synced
        secs.append(time.perf_counter() - t0)
    serve_ms = statistics.median(secs) * 1e3
    n_traj = K * sum(s.shape[0] for s in sc)
    print(f"serve_pet S64_N64: {serve_ms:.2f} ms per predict_batch (median "
          f"of 5), {n_traj / serve_ms * 1e3:.0f} traj/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_phase(lambda: p.predict_batch(sc, gr, noises=z),
                  "per-step serving call", "profile_serve_pet.txt", serve_ms)
    del p, host, out, ref

    iteration_checks("train_pet S64_N64", state, pet, "scan")
    launches, it_ms = {}, {}
    for impl in ("scan", "fused"):
        run = train_state_from_modules(copy.deepcopy(state.g),
                                       copy.deepcopy(state.d), tcfg)
        train_iterations(run, data, idx[:1], pet, tcfg, gen, impl=impl)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = train_iterations(run, data, idx[1:], pet, tcfg, gen, impl=impl)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[impl] = all_counts()
        per = {k_: v / PET_ITERS for k_, v in launches[impl].items()}
        it_ms[impl] = secs * 1e3 / PET_ITERS
        print(f"train_pet {impl} main path launches: "
              f"{json.dumps(launches[impl])} over {PET_ITERS} iterations; "
              f"{PET_ITERS / secs:.2f} it/s ({it_ms[impl]:.1f} ms per "
              f"iteration), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        # K1 on every decode step of both steps; K2 on every decode step
        # of the g-step's backward but the last (its re-pooled state feeds
        # no output), besides the context's and D's pools
        if per["pool_core_fwd"] < 2 * pet.pred_len or \
                per["pool_core_bwd"] < pet.pred_len - 1:
            fail(f"train_pet {impl}: K1 must run on every decode step of "
                 f"both steps and K2 on the g-step's decode steps, got "
                 f"{per} per iteration")
        for name, v in out.items():
            if not torch.isfinite(v).all():
                fail(f"train_pet {impl}: loss {name} is not finite")
    profile_phase(lambda: train_iterations(state, data, idx[:1], pet, tcfg,
                                           gen, impl="fused"),
                  "per-step training iteration fused",
                  "profile_train_pet.txt", it_ms["fused"])

    # 2. the other presets, on 'fused'
    @torch.inference_mode()
    def serve_call(model, tensors, noise):
        obs, rel, grp, valid = tensors
        ctx = model.generator_context(obs, rel, grp, valid, impl="fused")
        preds = model.generator_sample_many(ctx, rel, valid, K,
                                            user_noises=noise, impl="fused",
                                            obs=obs, group_end=grp)
        return list(relative_to_abs(preds, obs[None, :, :, -1, :])
                    .cpu().numpy().transpose(1, 0, 2, 3, 4))

    serve_presets, train_presets = {}, {}
    add = lambda acc, c: acc.update({k_: acc.get(k_, 0) + v
                                     for k_, v in c.items()})
    for name in ("gcn", "sgan-p", "sgan"):
        cfg = MODEL_PRESETS[name]
        if name == "sgan":
            cfg = dataclasses.replace(cfg, d_type="local")
        state, seed, alive = alive_state(cfg, tcfg, batch, gen)
        sd = {k_: v.detach() for k_, v in state.g.state_dict().items()}
        p = Predictor(sd, cfg, num_samples=K, param_dtype=None,
                      device="cuda")
        tensors = p.pad_batch(sc, gr)
        serve_call(p.model, tensors, z)                        # warm
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = serve_call(p.model, tensors, z)
        call_ms = (time.perf_counter() - t0) * 1e3
        counts = all_counts()
        add(serve_presets, counts)
        with plain_pool_kernels():
            ref = serve_call(p.model, tensors, z)
        _positions_report(f"serve {name} S64_N64 kernel vs plain pool", out,
                          ref)
        host = Predictor(sd, cfg, num_samples=K, param_dtype=None,
                         device="cpu")
        _positions_report(
            f"serve {name} S4_N16 GPU vs CPU",
            serve_call(p.model, p.pad_batch(few_sc, few_gr), z_few),
            serve_call(host.model, host.pad_batch(few_sc, few_gr),
                       z_few.cpu()))
        print(f"serve {name} fused: launches {json.dumps(counts)}, "
              f"{call_ms:.2f} ms per call (one, synchronised by the copy "
              f"out); seed {seed}")
        iteration_checks(f"train {name} fused S64_N64", state, cfg, "fused")
        run = train_state_from_modules(copy.deepcopy(state.g),
                                       copy.deepcopy(state.d), tcfg)
        train_iterations(run, data, idx[:1], cfg, tcfg, gen, impl="fused")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = train_iterations(run, data, idx[1:2], cfg, tcfg, gen,
                               impl="fused")
        torch.cuda.synchronize()
        it = (time.perf_counter() - t0) * 1e3
        counts = all_counts()
        add(train_presets, counts)
        if not all(torch.isfinite(v).all() for v in out.values()):
            fail(f"train {name}: a loss is not finite")
        pools = ("no pool kernel (no pooling in G, the local D)"
                 if counts["pool_core_fwd"] == 0 else
                 f"K1 x{counts['pool_core_fwd']}, "
                 f"K2 x{counts['pool_core_bwd']}")
        print(f"train {name} fused: one iteration {it:.1f} ms, launches "
              f"{json.dumps(counts)}: {pools}")
    print(f"presets phase: {time.perf_counter() - t_phase:.1f} s")
    return {"serve_pet": serve_pet, "train_pet": launches["scan"],
            "train_pet_fused": launches["fused"],
            "serve_presets": serve_presets, "train_presets": train_presets}


@contextlib.contextmanager
def _swapped(module, **fns):
    """Within the block ``module``'s attributes are ``fns``."""
    saved = {k: getattr(module, k) for k in fns}
    for k, fn in fns.items():
        setattr(module, k, fn)
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(module, k, fn)


def plain_lstm_kernels():
    """Within the block the wrappers of K3 and K4 run their plain PyTorch
    versions on the card (a check's reference, never the port's path)."""
    from grouptraj_torch.ops import cuda_lstm
    from grouptraj_torch.ops.lstm import (
        _fused_fwd_plain, fused_recurrence_bwd_plain,
    )
    return _swapped(
        cuda_lstm, lstm_fused_bwd=fused_recurrence_bwd_plain,
        lstm_fused_fwd=lambda w, h0, c0, gx=None, b=None, T=None, save=False:
        _fused_fwd_plain(w, gx, b, h0, c0,
                         gx.shape[0] if gx is not None else T, save))


def plain_lstm_proj_kernels():
    """Within the block the wrappers of K5 and K6 run their plain PyTorch
    versions on the card (a check's reference, never the port's path)."""
    from grouptraj_torch.ops import cuda_lstm_proj
    from grouptraj_torch.ops.lstm import (
        lstm_proj_bwd_plain, lstm_proj_fwd_plain,
    )
    return _swapped(cuda_lstm_proj, lstm_proj_fwd=lstm_proj_fwd_plain,
                    lstm_proj_bwd=lstm_proj_bwd_plain)


# ----------------------------------------------------------------- bf16

# K1/K2's bf16 mode at the main paths' shapes: name -> (S, N, B, R); the
# masks are realistic (2 to 57 pedestrians a scene at N=64, 2 to 16 at 16)
BF16_SHAPES = {"S64_N64_B8": (64, 64, 8, 1), "S256_N16_B8": (256, 16, 8, 1),
               "S128_N64_B48": (128, 64, 48, 1),
               "S1280_N64_B8": (1280, 64, 8, 1),
               "R4_S128_N64_B48": (128, 64, 48, 4)}


def kernel_bf16_phase(rng):
    """K1 and K2 in their bf16 mode (the TPU kernels' at JAX's default
    matmul precision) against their plain versions in that mode, TF32
    off: at each BF16_SHAPES shape K1 (pooled within BF16_RTOL, cnt equal
    on valid rows but for reported near-ties) and K2 on its own selection
    (check_bwd: recount, selection, each tensor within BF16_RTOL), each
    timed beside the exact mode on the same inputs, its plain version and
    its bf16 bound; the bf16 mode differs from the exact one; quantized
    inputs (exact in bfloat16: K1 bit-equal with the plain version, K2 on
    the plain selection) at B=8 and 48; bf16 weights.
    -> (K1's worst error, K2's worst error, {"fwd"|"bwd": {shape: times}})"""
    import torch
    from grouptraj_torch.ops.cuda_pool import pool_core_bwd, pool_core_fwd
    from grouptraj_torch.ops.pooling import pool_core, pool_core_bwd_plain

    t_phase = time.perf_counter()
    errs, timed = {"fwd": [], "bwd": []}, {"fwd": {}, "bwd": {}}
    for name, (S, N, B, R) in BF16_SHAPES.items():
        valid = realistic_valid(rng, S, N, 2, 16 if N == 16 else 57, R=R)
        args = pool_inputs(rng, valid, B=B, R=R)
        errs["fwd"].append(check_kernel(f"bf16 {name}", *args,
                                        near_ties=True, bf16=True))
        bound = pool_bound_ms(args[0], args[2], args[4],
                              2 * args[0][..., :1].numel() * B * 4, bf16=True)
        ms = time_ms(lambda: pool_core_fwd(*args, bf16=True))
        exact_ms = time_ms(lambda: pool_core_fwd(*args))
        plain_ms = time_ms(lambda: pool_core(*args, bf16=True), reps=5,
                           warmup=1)
        timed["fwd"][name] = dict(ms=ms, exact_ms=exact_ms,
                                  plain_ms=plain_ms, **bound)
        pooled, cnt = pool_core_fwd(*args, bf16=True)
        moved = (pooled - pool_core_fwd(*args)[0]).abs().max().item()
        print(f"kernel bf16 {name} time: kernel_ms={ms:.4f} exact_mode_ms="
              f"{exact_ms:.4f} plain_ms={plain_ms:.4f} {_bound_text(bound)}"
              f" kernel/bound={ms / bound['bound_ms']:.2f}; bf16 vs exact "
              f"mode max |dpooled| = {moved:.3e}")
        if moved == 0:
            fail(f"bf16 {name}: the bf16 mode computed the exact mode's "
                 f"values")

        errs["bwd"].append(check_bwd(f"bf16 {name}", rng, *args, bf16=True))
        dpool = torch.randn_like(pooled)
        bound = bwd_bound_ms(args[0], args[2], args[4], pooled, cnt,
                             bf16=True)
        ms = time_ms(lambda: pool_core_bwd(*args, pooled, cnt, dpool,
                                           bf16=True))
        xp, xc = pool_core_fwd(*args)
        exact_ms = time_ms(lambda: pool_core_bwd(*args, xp, xc, dpool))
        plain_ms = time_ms(lambda: pool_core_bwd_plain(
            *args, pooled, cnt, dpool, bf16=True), reps=5, warmup=1)
        timed["bwd"][name] = dict(ms=ms, exact_ms=exact_ms,
                                  plain_ms=plain_ms, **bound)
        print(f"kernel bwd bf16 {name} time: kernel_ms={ms:.4f} "
              f"exact_mode_ms={exact_ms:.4f} plain_ms={plain_ms:.4f} "
              f"{_bound_text(bound)} kernel/bound={ms / bound['bound_ms']:.2f}")
        del args, pooled, cnt, dpool, xp, xc
        torch.cuda.empty_cache()
    errs["bwd"].append(check_bwd("bf16 exact_inputs", rng, *quantized_inputs(
        rng, realistic_valid(rng, 16, 40, 6, 40)), expect_ties=True,
        exact=True, bf16=True))
    errs["bwd"].append(check_bwd("bf16 exact_inputs_B48", rng,
                                 *quantized_inputs(rng, realistic_valid(
                                     rng, 8, 64, 20, 64), B=48),
                                 expect_ties=True, exact=True, bf16=True))
    errs["fwd"].append(check_kernel("bf16 bf16_weights", *pool_inputs(
        rng, realistic_valid(rng, 64, 64, 2, 57), bf16=True), near_ties=True,
        bf16=True))
    errs["fwd"].append(check_kernel("bf16 bf16_weights_B48", *pool_inputs(
        rng, realistic_valid(rng, 128, 64, 2, 57), B=48, bf16=True),
        near_ties=True, bf16=True))
    print(f"kernel bf16: the phase took {time.perf_counter() - t_phase:.1f} s")
    return max(errs["fwd"]), max(errs["bwd"]), timed


def bf16_paths_phase(batches, noises):
    """Every path that reaches the pool core, run with the precision
    setting at "default" (K1/K2 in their bf16 mode) right after the same
    call in the exact mode: the zoo's zara1_12 Predictor at k=20 with float32
    and with bfloat16 weights (S=64, N=64); one 'fused' training iteration
    (losses and gradients, nothing updated) of the gat preset at full
    width; the gat preset with pool_every_timestep served at k=20 and one
    of its iterations; one train_iterations_many step of a 2-seed sweep.
    Each bf16 run has every count at 0 just before and read just after:
    K1's bf16 count (and K2's where there is a backward) must not be 0 and
    no exact-mode pool launch may happen. Prints each path's drift from
    the exact mode (max |Δposition|, losses) and, for the zoo's f32
    serving call and the per-step paths (the port's only kernel-bound
    ones), wall ms per call in either mode, in turns. -> {path: counts}"""
    import numpy as np
    import torch
    from grouptraj_torch.config import ModelConfig, TrainConfig
    from grouptraj_torch.ops.precision import default_matmul_precision
    from grouptraj_torch.serve import Predictor
    from grouptraj_torch.train.device_data import (
        gather_batch, synthetic_device_data,
    )
    from grouptraj_torch.train.steps import (
        init_train_state, stack_states, train_iterations_many,
    )

    t_phase = time.perf_counter()
    sc, gr = batches["S64_N64"]
    z = noises["S64_N64"]
    launches = {}

    def both(path, run, backward):
        """run() in the exact mode, then in the bf16 mode with the counts
        at 0 just before and read just after -> (exact, bf16) outputs."""
        exact = run()
        torch.cuda.synchronize()
        reset_counts()
        with default_matmul_precision("default"):
            out = run()
        torch.cuda.synchronize()
        counts = {**all_counts(), **bf16_counts()}
        print(f"bf16 {path} main path launches: {json.dumps(counts)}")
        if counts["pool_core_fwd_bf16"] == 0 or (
                backward and counts["pool_core_bwd_bf16"] == 0):
            fail(f"bf16 {path}: the bf16 mode's K1/K2 were not launched")
        if counts["pool_core_fwd"] or counts["pool_core_bwd"]:
            fail(f"bf16 {path}: an exact-mode pool launch under the bf16 "
                 f"setting")
        launches[path] = counts
        return exact, out

    def positions(path, exact, out):
        if not all(np.isfinite(o).all() for o in out):
            fail(f"bf16 {path}: outputs not finite")
        d = max(np.abs(o - r).max() for o, r in zip(out, exact))
        print(f"bf16 {path}: bf16 vs exact mode max |dpos| = {d:.3e} m")

    def turns(path, run):
        """Median wall ms per run() in the exact and the bf16 mode, in
        turns (exact, bf16, bf16, exact; a warm-up call and 3 timed)."""
        secs = {"exact": [], "bf16": []}
        for mode in ("exact", "bf16", "bf16", "exact"):
            with default_matmul_precision(
                    "highest" if mode == "exact" else "default"):
                run()
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run()
                    torch.cuda.synchronize()
                    secs[mode].append(time.perf_counter() - t0)
        ms = {m: statistics.median(v) * 1e3 for m, v in secs.items()}
        print(f"bf16 {path} time: exact mode {ms['exact']:.2f} ms, bf16 mode "
              f"{ms['bf16']:.2f} ms per call (median of 6, in turns; "
              f"bf16/exact {ms['bf16'] / ms['exact']:.3f})")

    def losses(path, exact, out):
        if not all(np.isfinite(float(v)) for v in out.values()):
            fail(f"bf16 {path}: losses not finite")
        d = {k: abs(float(out[k]) - float(v)) / max(abs(float(v)), 1e-12)
             for k, v in exact.items()}
        print(f"bf16 {path}: bf16 vs exact mode relative |dloss| "
              + " ".join(f"{k}={v:.3e}" for k, v in d.items()))

    for tag, dtype in (("f32", None), ("bf16_weights", "bfloat16")):
        kw = {} if dtype else {"param_dtype": None}
        p = Predictor.from_checkpoint(CKPT, num_samples=K, device="cuda",
                                      **kw)
        positions(f"serve_{tag}", *both(
            f"serve_{tag}", lambda: p.predict_batch(sc, gr, noises=z),
            False))
        if dtype is None:
            turns("serve_f32", lambda: p.predict_batch(sc, gr, noises=z))
        del p

    cfg, tcfg = ModelConfig(), TrainConfig()
    S, k = tcfg.batch_size, tcfg.best_k
    data = synthetic_device_data(256, 64, seed=3, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(21)
    idx = torch.randint(0, 256, (1, 2, S), generator=gen, device="cuda")
    batch = gather_batch(data, idx[0, 0], cfg.obs_len)
    draw = dict(noise=torch.randn((S, 64, 8), generator=gen, device="cuda"),
                noises=torch.randn((k, S, 64, 8), generator=gen,
                                   device="cuda"), label=0.9)
    state, _, _ = alive_state(cfg, tcfg, batch, gen)
    losses("train_fused", *both("train_fused", lambda: _one_iteration(
        state, batch, cfg, tcfg, **draw, impl="fused")[0], True))

    pet = ModelConfig(pool_every_timestep=True)
    state, _, _ = alive_state(pet, tcfg, batch, gen)
    sd = {k_: v.detach() for k_, v in state.g.state_dict().items()}
    p = Predictor(sd, pet, num_samples=K, param_dtype=None, device="cuda")
    positions("serve_pet", *both(
        "serve_pet", lambda: p.predict_batch(sc, gr, noises=z), False))
    turns("serve_pet", lambda: p.predict_batch(sc, gr, noises=z))
    losses("train_pet", *both("train_pet", lambda: _one_iteration(
        state, batch, pet, tcfg, **draw)[0], True))
    turns("train_pet (losses and gradients of one iteration)",
          lambda: _one_iteration(state, batch, pet, tcfg, **draw))
    del p, state

    seeds = (6, 7)

    def sweep():
        st = stack_states([init_train_state(
            cfg, tcfg, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(s))
            for s in seeds], tcfg)
        gens = [torch.Generator(device="cuda").manual_seed(1000 + s)
                for s in seeds]
        out = train_iterations_many(st, data, idx, cfg, tcfg, gens)
        return {f"{name}_s{s}": v[i, -1] for name, v in out.items()
                for i, s in enumerate(seeds)}
    losses("train_many", *both("train_many", sweep, True))
    print(f"bf16 paths: the phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ----------------------------------------------------------------- many

MANY_SEEDS = (6, 7, 8, 9)    # the sweep's replica seeds (6: the loop's)
MANY_ITERS = 20              # the sweep's first run, resumed to MANY_RESUME
MANY_RESUME = 30
MANY_RATE_ITERS = 10         # timed iterations a run, the rates in turns
MANY_RTOL = 1e-4             # a replica against its 1-seed sweep, TF32 off
# train_many's launches per iteration, each at R = the number of seeds
MANY_PER_ITER = {"pool_core_fwd": 4, "pool_core_bwd": 3}


def _noisy(name):
    """The inter-group GAT's attention vectors: their gradients are
    rounding noise (the inter-group graph is complete, so the row softmax
    drops the source half), which each Adam step turns into a move of up
    to about lr."""
    return name.startswith("gatencoder.gat_inter.") and name.endswith(".a")


class _Recorded:
    """A K1/K2 wrapper that hands each call's arguments to ``record``
    first. ``launches`` is the wrapped function's: its body counts through
    the module's name, which is this object while it stands there."""

    def __init__(self, fn, record):
        self.fn, self.record = fn, record

    launches = property(lambda self: self.fn.launches,
                        lambda self, v: setattr(self.fn, "launches", v))
    launches_bf16 = property(
        lambda self: self.fn.launches_bf16,
        lambda self, v: setattr(self.fn, "launches_bf16", v))
    launches_wide = property(
        lambda self: self.fn.launches_wide,
        lambda self, v: setattr(self.fn, "launches_wide", v))

    def __call__(self, *args, **kw):
        self.record(self.fn, args)
        return self.fn(*args, **kw)


@contextlib.contextmanager
def _pool_calls():
    """Within the block K1's and K2's wrappers record their calls: yields
    ``(calls, first)``; ``calls`` gets (kind, R, S, N, B) for each call,
    ``first[(kind, S, B)]`` the cloned arguments of that shape's first."""
    from grouptraj_torch.ops import cuda_pool
    fwd, bwd = cuda_pool.pool_core_fwd, cuda_pool.pool_core_bwd
    calls, first = [], {}

    def record(fn, args):
        kind = "fwd" if fn is fwd else "bwd"
        a, W2 = args[0], args[2]
        R, S, N, _ = a.shape
        calls.append((kind, R, S, N, W2.shape[-1]))
        key = (kind, S, W2.shape[-1])
        if key not in first:
            first[key] = [t.detach().clone() for t in args]

    with _swapped(cuda_pool, pool_core_fwd=_Recorded(fwd, record),
                  pool_core_bwd=_Recorded(bwd, record)):
        yield calls, first


def _hold_pool_shapes(label, first, rng, n, smi):
    """K1 and K2 at the shapes ``first`` holds (:func:`_pool_calls`' first
    call of each, R = ``n``) against their plain versions, timed beside
    their bounds -> {(kind, tag): timing}."""
    from grouptraj_torch.ops.cuda_pool import pool_core_bwd, pool_core_fwd
    from grouptraj_torch.ops.pooling import pool_core, pool_core_bwd_plain
    timed = {}
    for (kind, S_, B), args in sorted(first.items()):
        tag = f"R{n}_S{S_}_N{args[0].shape[2]}_B{B}"
        a, u, W2, b2, valid = args[:5]
        if kind == "fwd":
            err = check_kernel(f"{label} {tag}", a, u, W2, b2, valid,
                               near_ties=True)
            out_bytes = 2 * a[..., :1].numel() * B * 4
            bound = pool_bound_ms(a, W2, valid, out_bytes)
            ms = time_ms(lambda: pool_core_fwd(a, u, W2, b2, valid))
            plain_ms = time_ms(lambda: pool_core(a, u, W2, b2, valid))
        else:
            err = check_bwd(f"{label} {tag}", rng, a, u, W2, b2, valid)
            pooled, cnt, dpool = args[5:8]
            bound = bwd_bound_ms(a, W2, valid, pooled, cnt)
            ms = time_ms(lambda: pool_core_bwd(a, u, W2, b2, valid, pooled,
                                               cnt, dpool))
            plain_ms = time_ms(lambda: pool_core_bwd_plain(
                a, u, W2, b2, valid, pooled, cnt, dpool))
        timed[(kind, tag)] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                                  **bound)
        print(f"{label} K{1 if kind == 'fwd' else 2} {tag} time: kernel_ms="
              f"{ms:.4f} plain_ms={plain_ms:.4f} {_bound_text(bound)} "
              f"kernel/bound={ms / bound['bound_ms']:.2f}; {smi}")
    return timed


def _sweep_rates(label, cfg, tcfg, base, data, idx, gen, gens, smi,
                 profile_name):
    """Seed-iterations per second of ``train_iterations_many`` over the
    ``idx`` iterations at N = 1, 2 and all of ``base``'s states (stacked
    from their first N, replica i drawing from ``gens[i]``) in turns
    beside ``train_iterations`` of ``base[0]`` (train()'s step, drawing
    from ``gen``), all on 'scan'; then the peak memory and a profile
    (``chiprun_out/<profile_name>``) of one iteration at all N. -> the
    rates by N ('train' for the single state)."""
    import copy
    import torch
    from grouptraj_torch.train.steps import (
        stack_states, train_iterations, train_iterations_many,
        train_state_from_modules,
    )
    n_all, iters = len(base), len(idx)
    S, N = idx.shape[2], data["valid"].shape[1]
    ms_it = {}
    for n in ("train", 1, 2, n_all, n_all, 2, 1, "train"):
        if n == "train":
            run = train_state_from_modules(copy.deepcopy(base[0].g),
                                           copy.deepcopy(base[0].d), tcfg)
            step = lambda ix: train_iterations(run, data, ix, cfg, tcfg, gen,
                                               impl="scan")
        else:
            run = stack_states(base[:n], tcfg)
            g = gens[:n]
            step = lambda ix: train_iterations_many(run, data, ix, cfg, tcfg,
                                                    g)
        step(idx[:2])                                            # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(idx)
        torch.cuda.synchronize()
        ms_it.setdefault(n, []).append(
            (time.perf_counter() - t0) * 1e3 / iters)
        del run, step
    one = statistics.mean(ms_it["train"])
    rates = {n: (1 if n == "train" else n) * 1e3 / statistics.mean(v)
             for n, v in ms_it.items()}
    print(f"{label}: seed-iterations per second at S{S}_N{N} ('scan', "
          f"{iters} iterations a run, the mean of two runs in "
          f"turns): train() {rates['train']:.2f} it/s ({one:.1f} ms); "
          + "; ".join(f"N={n} {rates[n]:.2f} ({statistics.mean(ms_it[n]):.1f}"
                      f" ms an iteration)" for n in (1, 2, n_all))
          + f"; N={n_all}/N=1 = {rates[n_all] / rates[1]:.2f}x; {smi}")
    run = stack_states(base, tcfg)
    train_iterations_many(run, data, idx[:1], cfg, tcfg, gens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train_iterations_many(run, data, idx[:1], cfg, tcfg, gens)
    torch.cuda.synchronize()
    print(f"{label}: peak memory of one {n_all}-seed iteration "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_phase(lambda: train_iterations_many(run, data, idx[:1], cfg,
                                                tcfg, gens),
                  f"{n_all}-seed iteration S{S}_N{N}", profile_name,
                  statistics.mean(ms_it[n_all]))
    return rates


def _train_many_runs(label, cfg, seeds, runs, per_iter, smi, max_peds=57,
                     **sweep):
    """``train_many`` of ``seeds`` on a synthetic ETH/UCY-format split (3
    train files of 560 frames and a val file of 200, at most ``max_peds``
    pedestrians at a time; batch 64, best_k 20, checkpoints named 'many',
    the ``sweep`` fields of TrainConfig) for each (iterations, restore) of
    ``runs`` in order, into one output directory, each with the counts at
    0 just before and read just after: K2 exactly ``per_iter``'s count an
    iteration, K1 at least its count (the metric sweeps add more), every
    call at R = len(seeds); s<seed>/ files, finite histories, a resume's
    restore_ts; the files hold each replica's generator state. -> the
    first run's launches."""
    import math
    import shutil
    import tempfile
    import torch
    from grouptraj_torch.config import TrainConfig
    from grouptraj_torch.data.synthetic import write_scene_files
    from grouptraj_torch.train import checkpoint as CK
    from grouptraj_torch.train import multi as MULTI

    n = len(seeds)
    k1, k2 = per_iter["pool_core_fwd"], per_iter["pool_core_bwd"]
    tmp = tempfile.mkdtemp(prefix="grouptraj_many_")
    saved_env = os.environ.get("GROUPTRAJ_DATA_DIR")
    os.environ["GROUPTRAJ_DATA_DIR"] = tmp
    try:
        write_scene_files(os.path.join(tmp, "synth", "train"), n_files=3,
                          frames=560, max_peds=max_peds, seed=0)
        write_scene_files(os.path.join(tmp, "synth", "val"), n_files=1,
                          frames=200, max_peds=max_peds, seed=1)
        sweep = dict(dataset_name="synth", batch_size=64, best_k=20,
                     num_epochs=0, seed=seeds[0],
                     output_dir=os.path.join(tmp, "out"),
                     checkpoint_name="many", **sweep)
        launches, done = None, 0
        for iters, restore in runs:
            tc = TrainConfig(**sweep, num_iterations=iters,
                             restore_from_checkpoint=restore)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            with _pool_calls() as (seen, _):
                ckpts = MULTI.train_many(cfg, tc, seeds, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = all_counts()
            ran = iters - done
            launches = launches or counts
            rs = sorted({r for _, r, *_ in seen})
            print(f"{label}: train_many of {n} seeds, {ran} iterations"
                  f"{' (resumed)' if restore else ''}: launches "
                  f"{json.dumps(counts)} at R {rs}; {ran * n / wall:.2f} "
                  f"seed-iterations/s over the run ({wall:.2f} s wall, "
                  f"sweeps and saves included); {smi}")
            if (counts["pool_core_bwd"] != k2 * ran
                    or counts["pool_core_fwd"] < k1 * ran
                    or any(r != n for r in rs) or (k1 and not rs)):
                fail(f"{label}: train_many launched {counts} at R {rs}; "
                     f"expected K2 = {k2 * ran}, K1 >= {k1 * ran}, R = {n}")
            for s in seeds:
                ck = ckpts[s]
                hist = ([v for h in ("G_losses", "D_losses", "metrics_val")
                         for vals in ck[h].values() for v in vals]
                        + ck["norm_g"] + ck["norm_d"])
                if not hist or not all(math.isfinite(v) for v in hist):
                    fail(f"{label}: seed {s}: a loss, norm or metric is not "
                         f"finite")
                if ck["counters"]["t"] != iters or ck["args"]["seed"] != s \
                        or (restore and ck["restore_ts"] != [done]):
                    fail(f"{label}: seed {s} ended at {ck['counters']} with "
                         f"restore_ts {ck['restore_ts']}")
                for suffix in ("_with_model.pt", "_no_model.pt"):
                    if not os.path.isfile(os.path.join(
                            tc.output_dir, f"s{s}", "many" + suffix)):
                        fail(f"{label}: s{s}/many{suffix} was not written")
            if not any(max(ckpts[s]["norm_d"]) > 0 for s in seeds):
                fail(f"{label}: no replica's discriminator had a gradient")
            done = iters
        loaded = CK.load_checkpoint(os.path.join(tc.output_dir,
                                                 f"s{seeds[0]}",
                                                 "many_with_model.pt"))
        if loaded.get(MULTI.RNG_KEY) is None:
            fail(f"{label}: the checkpoint holds no generator state")
        print(f"{label}: trained to t={done}; last val ade per seed "
              + json.dumps({s: ckpts[s]["metrics_val"]["ade"][-1:]
                            for s in seeds}))
    finally:
        shutil.rmtree(tmp)
        if saved_env is None:
            os.environ.pop("GROUPTRAJ_DATA_DIR", None)
        else:
            os.environ["GROUPTRAJ_DATA_DIR"] = saved_env
    return launches


def _replicas_report(label, what, seeds, out, st, refs, tcfg):
    """Each replica of a sweep (``out``: its histories ``[N, iters]``,
    ``st``: its StackedState) against its reference run ``refs[i]`` =
    (histories ``[iters]``, {"g"|"d": {name: weight}}): losses and norms
    within MANY_RTOL of each history's largest entry, weights within lr/10
    (the inter-group attention vectors 2 lr an iteration, 4 lr)."""
    lr = {"g": tcfg.g_learning_rate, "d": tcfg.d_learning_rate}
    worst = {"history": 0.0, "weights": 0.0, "noisy": 0.0}
    for i, (s, (hist, params)) in enumerate(zip(seeds, refs)):
        for k, ref in hist.items():
            d = (out[k][i] - ref).abs().max().item() / max(
                ref.abs().max().item(), 1e-12)
            worst["history"] = max(worst["history"], d)
            if not d <= MANY_RTOL:
                fail(f"{label}: seed {s} {k} {out[k][i].tolist()} against "
                     f"{what}: {ref.tolist()}")
        for part, stacked in (("g", st.g_params), ("d", st.d_params)):
            for name, w in params[part].items():
                d = (stacked[name][i] - w).abs().max().item()
                key, tol = (("noisy", 2 * 2 * lr[part]) if _noisy(name)
                            else ("weights", lr[part] / 10))
                worst[key] = max(worst[key], d / lr[part])
                if not d <= tol:
                    fail(f"{label}: seed {s} {part}.{name} differs by "
                         f"{d:.3e} from {what} (limit {tol:.1e})")
    print(f"{label}: each replica against {what}: losses and norms worst "
          f"{worst['history']:.2e} of the history's largest (limit "
          f"{MANY_RTOL}); weights worst {worst['weights']:.2e} lr (limit "
          f"0.1 lr), the inter-group attention vectors {worst['noisy']:.2e}"
          f" lr (limit 4 lr)")


def many_phase(rng, smi):
    """Multi-seed sweeps, ``train_many`` (the replicas' weights stacked on
    a seed axis, every step under torch.func.vmap, K1/K2 taking the seed
    axis as their replica axis R), the gat preset at full width:

    (a) each replica of a 4-seed sweep against a 1-seed sweep of its own
        seed for 2 iterations (float32 no-grad legs, TF32 off): losses and
        norms within MANY_RTOL of each history's largest entry, weights
        within lr/10 (the inter-group attention vectors 2 lr an
        iteration); K1 x4 and K2 x3 an iteration, every launch at R = 4;
    (b) K1 and K2 at the R = 4 shapes that iteration gave them, against
        their plain versions, timed beside their bounds;
    (c) seed-iterations per second of train_iterations_many at N = 1, 2
        and 4 seeds in turns, beside train()'s step (train_iterations, one
        state) on the same route ('scan': train_many's); the device-busy
        share of a 4-seed iteration (chiprun_out/profile_train_many.txt)
        and its peak memory;
    (d) train_many of MANY_SEEDS on a synthetic ETH/UCY-format split
        (batch 64, best_k 20, 3 buckets; dispatches of 10, a checkpoint
        every 10) for MANY_ITERS iterations with the counts at 0 just
        before and read just after (K1 at least 4 and K2 exactly 3 an
        iteration, all at R = 4), then resumed from its files to
        MANY_RESUME: s<seed>/ files, finite histories, the resume's
        restore_ts and generator states.
    Returns the launches of the run in (d)."""
    import torch
    from grouptraj_torch.config import ModelConfig, TrainConfig
    from grouptraj_torch.train.device_data import synthetic_device_data
    from grouptraj_torch.train.steps import (
        init_train_state, stack_states, train_iterations_many,
    )

    t_phase = time.perf_counter()
    cfg, tcfg = ModelConfig(), TrainConfig()
    S, n4 = tcfg.batch_size, len(MANY_SEEDS)
    data = synthetic_device_data(256, 64, seed=3, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    idx = torch.randint(0, 256, (MANY_RATE_ITERS, 2, S), generator=gen,
                        device="cuda")

    def states(seeds, tc):
        return [init_train_state(cfg, tc, device="cuda", generator=torch.
                                 Generator(device="cuda").manual_seed(s))
                for s in seeds]

    def gens(seeds):
        return [torch.Generator(device="cuda").manual_seed(1000 + s)
                for s in seeds]

    # (a) a 4-seed sweep against 1-seed sweeps, two iterations
    f32 = dataclasses.replace(tcfg, bf16_nograd=False)
    seeds = list(MANY_SEEDS)
    st4 = stack_states(states(seeds, f32), f32)
    torch.cuda.synchronize()
    reset_counts()
    with _pool_calls() as (seen, first):
        out4 = train_iterations_many(st4, data, idx[:2], cfg, f32,
                                     gens(seeds))
    torch.cuda.synchronize()
    counts = all_counts()
    want = {k: 2 * v for k, v in MANY_PER_ITER.items()}
    rs = sorted({r for _, r, *_ in seen})
    print(f"many: 4-seed sweep, 2 iterations (float32 no-grad legs): "
          f"launches {json.dumps(counts)}, replica axis R {rs}, shapes "
          f"{sorted(set(seen))}")
    if {k: counts[k] for k in want} != want or rs != [n4] or any(
            counts[k] for k in counts if k not in want):
        fail(f"many: a 4-seed iteration must launch {MANY_PER_ITER} (x2) "
             f"at R = {n4} and no LSTM kernel, got {counts} at R {rs}")
    refs = []
    for s in seeds:
        st1 = stack_states(states([s], f32), f32)
        out1 = train_iterations_many(st1, data, idx[:2], cfg, f32,
                                     gens([s]))
        refs.append(({k: v[0] for k, v in out1.items()},
                     {part: {k: v[0] for k, v in p.items()} for part, p in
                      (("g", st1.g_params), ("d", st1.d_params))}))
        del st1
    _replicas_report("many", "a 1-seed sweep of its seed, 2 iterations",
                     seeds, out4, st4, refs, f32)

    # (b) K1 and K2 at the R = 4 shapes of that iteration
    timed = _hold_pool_shapes("many", first, rng, n4, smi)
    del seen, first, st4, out4

    # (c) rates in turns, a profile and the peak memory of N = 4
    rates = _sweep_rates("many", cfg, tcfg, states(seeds, tcfg), data, idx,
                         gen, gens(seeds), smi, "profile_train_many.txt")

    # (d) train_many on a synthetic split, with a save and a resume
    launches = _train_many_runs(
        "many", cfg, seeds, ((MANY_ITERS, False), (MANY_RESUME, True)),
        MANY_PER_ITER, smi, n_buckets=3, steps_per_dispatch=10,
        print_every=10, checkpoint_every=10)
    print(f"many: the phase took {time.perf_counter() - t_phase:.1f} s")
    return launches, timed, rates


# ----------------------------------------------------------------- main

# ----------------------------------------------------------------- options

OPT_ITERS = {"fused": 3, "pallas": 1}   # timed iterations a route


def _option_draws(cfg, tcfg, S, N, gen):
    """One iteration's draws with its keep-masks on tape -> (draws,
    replay): ``replay(device)`` gives the same draws again (masks
    replayed, on ``device``)."""
    from grouptraj_torch.ops.linear import (
        DrawnMasks, InjectedMasks, KeepMasks,
    )
    from grouptraj_torch.train import steps as TS

    class Taped(KeepMasks):
        """Draws from ``gen`` and keeps every mask, so that a reference
        run can replay them."""

        def __init__(self):
            self.src, self.tape = DrawnMasks(gen), []

        def keep(self, shape, keep, device):
            self.tape.append(self.src.keep(shape, keep, device))
            return self.tape[-1]

    dev = "cuda"
    d = TS.d_draws(cfg, S, N, gen, dev)
    g = TS.g_draws(cfg, tcfg, S, N, gen, dev)
    sample = None
    if cfg.dropout or cfg.dropout1:
        stacked = TS.stacked_sample_masks(cfg, tcfg.best_k, S, N, gen, dev)
        sample = [[m[i] for m in stacked] for i in range(tcfg.best_k)]
    tapes = [Taped(), Taped()]
    draws = dict(d=dict(d, masks=tapes[0]),
                 g=dict(g, sample_masks=sample, d_masks=tapes[1]))

    def replay(device):
        mv = lambda t: t.to(device) if hasattr(t, "to") else t
        return dict(
            d={**{k: mv(v) for k, v in d.items()},
               "masks": InjectedMasks([mv(m) for m in tapes[0].tape])},
            g={**{k: mv(v) for k, v in g.items()},
               "sample_masks": None if sample is None else
               [[mv(m) for m in ms] for ms in sample],
               "d_masks": InjectedMasks([mv(m) for m in tapes[1].tape])})
    return draws, replay


def _option_iteration(state, batch, cfg, tcfg, draws, impl):
    """Losses and gradients of one d-step and one g-step from ``state``
    with the given draws (masks included), nothing updated."""
    from grouptraj_torch.train.steps import d_gradients, g_gradients
    ld, gd = d_gradients(state, batch, cfg, tcfg, impl=impl, **draws["d"])
    lg, gg = g_gradients(state, batch, cfg, tcfg, impl=impl, **draws["g"])
    names = [f"D.{k}" for k, _ in state.d.named_parameters()] \
        + [f"G.{k}" for k, _ in state.g.named_parameters()]
    return {**ld, **lg}, names, list(gd) + list(gg)


class _RecordedKw(_Recorded):
    """:class:`_Recorded` for a wrapper called with keywords: ``record``
    gets them too."""

    def __call__(self, *args, **kw):
        self.record(self.fn, args, kw)
        return self.fn(*args, **kw)


@contextlib.contextmanager
def _kernel_calls():
    """Within the block K1's and K2's wrappers record the replica count R
    of every call and K3's wrapper the (T, rows, variant, residuals) of
    every call. Yields ``(pool, lstm)``: pool a list of (kind, R), lstm a
    list of those tuples."""
    from grouptraj_torch.ops import cuda_lstm, cuda_pool
    fwd, bwd = cuda_pool.pool_core_fwd, cuda_pool.pool_core_bwd
    pool, lstm = [], []

    def record(fn, args):
        pool.append(("K1" if fn is fwd else "K2", args[0].shape[0]))

    def record_k3(fn, args, kw):
        gx, h0 = kw.get("gx"), args[1]
        lstm.append((gx.shape[0] if gx is not None else kw["T"],
                     h0.shape[0], "gx" if gx is not None else "decoder",
                     kw.get("save", False)))

    with _swapped(cuda_pool, pool_core_fwd=_Recorded(fwd, record),
                  pool_core_bwd=_Recorded(bwd, record)), \
            _swapped(cuda_lstm, lstm_fused_fwd=_RecordedKw(
                cuda_lstm.lstm_fused_fwd, record_k3)):
        yield pool, lstm


def options_phase(batches, noises, smi):
    """The MLP options of ModelConfig on the ``gat`` preset at full width
    (G H=32, pool 48→512→8, GAT 72→16→24; D H=48, pool 64→512→48), each
    from the first seed whose discriminator is alive, configured from the
    training CLI's flags: ``--batch_norm 1``, ``--dropout1 0.2``,
    ``--dropout 0.2`` (the JAX package's own test values), and
    ``activation='leakyrelu'``. For each:

    (a) serving: one k=20 ``Predictor.predict_batch`` at S=64/N=64 in eval
        mode (BN on the batch's statistics, no dropout) with its launches,
        against the plain pool and, on four small scenes, the CPU
        (positions within SERVE_ATOL); ms per call and peak memory;
    (b) training (batch 64, best_k 20; S=64/N=64, with ``--dropout``
        S=64/N=16, since its pool's pair path under the per-sample vmap
        holds [20, S, N, N, 512] slabs): one iteration's losses and
        gradients on 'fused' with every kernel against the plain pool and
        the plain LSTMs on the card, with one set of keep-masks (taped,
        replayed), and on a 4-scene N=16 batch against the CPU; then
        OPT_ITERS['fused'] iterations of train_iterations on 'fused' and
        OPT_ITERS['pallas'] on 'pallas' with their launches, ms per
        iteration, peak memory, and the busy share of a 'fused' iteration.
    With ``--dropout1`` the pool stays decomposed: the g-step's per-sample
    forward (torch.func.vmap over the 20 samples) runs the decoder's K3/K4
    at 20·S·N rows through the LSTM Functions' vmap rule, held against
    their plain versions at that shape and timed beside their bounds; its
    pool runs K1/K2 once, unbatched (R = 1): the pool's inputs are the
    same for every sample, the first draw comes after it. Fails if K1,
    K2, K3 or K4 is launched 0 times on the dropout1 'fused' path, or K5
    or K6 on a 'pallas' path. -> (paths' launches, K3/K4 timings at the
    folded rows)."""
    import copy
    import numpy as np
    import torch
    from grouptraj_torch.config import ModelConfig, TrainConfig
    from grouptraj_torch.serve import Predictor
    from grouptraj_torch.train.device_data import (
        gather_batch, synthetic_device_data,
    )
    from grouptraj_torch.train.steps import (
        train_iterations, train_state_from_modules,
    )

    t_phase = time.perf_counter()
    tcfg = TrainConfig()
    f32 = dataclasses.replace(tcfg, bf16_nograd=False)
    S = tcfg.batch_size
    configs = {"batch_norm": _cli_config("--batch_norm", "1"),
               "dropout1": _cli_config("--dropout1", "0.2"),
               "dropout": _cli_config("--dropout", "0.2"),
               "leakyrelu": dataclasses.replace(ModelConfig(),
                                                activation="leakyrelu")}
    widths = {"dropout": 16}
    data = {N: synthetic_device_data(256, N, seed=7 + N, device="cuda")
            for N in (64, 16)}
    small = gather_batch(synthetic_device_data(16, 16, seed=9,
                                               device="cuda"),
                         torch.arange(4, device="cuda"), 8)
    gen = torch.Generator(device="cuda").manual_seed(13)
    sc, gr = batches["S64_N64"]
    z = noises["S64_N64"]
    few = [i for i, s in enumerate(sc) if s.shape[0] <= 16][:4]
    few_sc, few_gr = [sc[i] for i in few], [gr[i] for i in few]
    z_few = z[:, :4, :16].contiguous()
    paths, folded = {}, {}
    for name, cfg in configs.items():
        N = widths.get(name, 64)
        idx = torch.randint(0, 256, (OPT_ITERS["fused"] + 1, 2, S),
                            generator=gen, device="cuda")
        batch = gather_batch(data[N], idx[0, 0], 8)
        state, seed, alive = alive_state(cfg, tcfg, batch, gen)
        print(f"options {name}: seed {seed} (D positive on "
              f"{100 * alive:.0f}%), batch_norm={cfg.batch_norm} "
              f"activation={cfg.activation} dropout={cfg.dropout} "
              f"dropout1={cfg.dropout1}; {smi}")

        # (a) serving
        sd = {k_: v.detach() for k_, v in state.g.state_dict().items()}
        p = Predictor(sd, cfg, num_samples=K, param_dtype=None,
                      device="cuda")
        p.predict_batch(sc, gr, noises=z)                      # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = p.predict_batch(sc, gr, noises=z)
        call_ms = (time.perf_counter() - t0) * 1e3
        paths[f"serve_{name}"] = all_counts()
        if not all(np.isfinite(o).all() and o.shape == (K, s.shape[0],
                                                        cfg.pred_len, 2)
                   for o, s in zip(out, sc)):
            fail(f"options serve {name}: outputs not finite or of the "
                 "wrong shape")
        with plain_pool_kernels():
            ref = p.predict_batch(sc, gr, noises=z)
        _positions_report(f"options serve {name} S64_N64 kernel vs plain "
                          "pool", out, ref)
        host = Predictor(sd, cfg, num_samples=K, param_dtype=None,
                         device="cpu")
        _positions_report(f"options serve {name} S4_N16 GPU vs CPU",
                          p.predict_batch(few_sc, few_gr, noises=z_few),
                          host.predict_batch(few_sc, few_gr,
                                             noises=z_few.cpu()))
        print(f"options serve {name} S64_N64: launches "
              f"{json.dumps(paths[f'serve_{name}'])}, {call_ms:.2f} ms per "
              f"predict_batch (one call), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")
        del p, host, out, ref

        # (b) one iteration against the plain kernels and the CPU
        draws, replay = _option_draws(cfg, f32, S, N, gen)
        with _kernel_calls() as (pool_calls, k3_calls):
            got = _option_iteration(state, batch, cfg, f32, draws, "fused")
        with plain_pool_kernels(), plain_lstm_kernels():
            ref = _option_iteration(state, batch, cfg, f32,
                                    replay("cuda"), "fused")
        what = f"options train {name} fused S64_N{N}"
        # BatchNorm's statistics amplify rounding (1/std) and a rounding-
        # level change crosses ReLU and max kinks: the JAX package's own
        # jitted and eager BN gradients differ by 1.2e-5 of the largest
        # entry (tests/test_torch_options.py); on the 4-scene batch below,
        # on the CPU, the port's 'scan' and 'fused' routes differ by
        # 4.7e-4 of D's largest entry and a 1e-7 relative change of the
        # weights moves D's gradient by 5.5e-3 of it. A BN model's
        # gradient tensors are held against their network's largest
        # entry, at 1e-2 on the card and 5e-2 card vs CPU
        floor = 1.0 if cfg.batch_norm else 1e-6
        cpu_rtol = 5e-2 if cfg.batch_norm else TRAIN_GRAD_RTOL
        _loss_report(f"{what} kernels vs plain", got[0], ref[0])
        _grad_report(f"{what} kernels vs plain", got[1], got[2], ref[2],
                     floor)
        del got, ref
        sdraws, sreplay = _option_draws(cfg, f32, 4, 16, gen)
        got = _option_iteration(state, small, cfg, f32, sdraws, "fused")
        host = train_state_from_modules(copy.deepcopy(state.g).cpu(),
                                        copy.deepcopy(state.d).cpu(), f32)
        ref = _option_iteration(host, {k_: v.cpu() for k_, v in
                                       small.items()}, cfg, f32,
                                sreplay("cpu"), "fused")
        _loss_report(f"options train {name} S4_N16 GPU vs CPU", got[0],
                     ref[0])
        _grad_report(f"options train {name} S4_N16 GPU vs CPU", got[1],
                     got[2], ref[2], floor, cpu_rtol)
        del got, ref, host
        if name == "dropout1":
            print(f"options dropout1: one iteration's K1/K2 calls (kernel, "
                  f"R) {pool_calls}; K3 calls (T, rows, variant, "
                  f"residuals) {sorted(set(k3_calls))}")
            rows = f32.best_k * S * N
            if not any(c[1] == rows and c[2] == "decoder" and c[3]
                       for c in k3_calls):
                fail(f"options dropout1: the per-sample decoder must run "
                     f"K3 once at {rows} rows with residuals")
            folded = _options_lstm_checks(rows, smi)

        # timed iterations on both routes
        for impl, n in OPT_ITERS.items():
            run = train_state_from_modules(copy.deepcopy(state.g),
                                           copy.deepcopy(state.d), tcfg)
            train_iterations(run, data[N], idx[:1], cfg, tcfg, gen,
                             impl=impl)                        # warm
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            losses = train_iterations(run, data[N], idx[1:1 + n], cfg, tcfg,
                                      gen, impl=impl)
            torch.cuda.synchronize()
            it_ms = (time.perf_counter() - t0) * 1e3 / n
            counts = paths[f"train_{name}_{impl}"] = all_counts()
            if not all(bool(torch.isfinite(v).all())
                       for v in losses.values()):
                fail(f"options train {name} {impl}: a loss is not finite")
            print(f"options train {name} {impl} S64_N{N}: launches "
                  f"{json.dumps(counts)} over {n} iteration(s), "
                  f"{it_ms:.1f} ms per iteration, peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                  f"{smi}")
            if impl == "pallas" and not (counts["lstm_proj_fwd"]
                                         and counts["lstm_proj_bwd"]):
                fail(f"options train {name} pallas: K5 and K6 must run")
            if impl == "fused":
                profile_phase(lambda: train_iterations(
                    run, data[N], idx[:1], cfg, tcfg, gen, impl="fused"),
                    f"options {name} fused iteration",
                    f"profile_options_{name}.txt", it_ms)
            del run
    fused = paths["train_dropout1_fused"]
    if not all(fused[k_] for k_ in ("pool_core_fwd", "pool_core_bwd",
                                    "lstm_fused_fwd", "lstm_fused_bwd")):
        fail(f"options: K1, K2, K3 and K4 must each run on the dropout1 "
             f"'fused' path, got {fused}")
    print(f"options phase: {time.perf_counter() - t_phase:.1f} s")
    return paths, folded


def _options_lstm_checks(rows, smi):
    """K3/K4 at the per-sample decoder's folded rows (T=11, H=32,
    residuals saved) against their plain versions, timed beside their
    bounds."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(21)
    folded = {}
    name = f"options_decoder_T11_B{rows}_H32"
    k3_err, k4_err = check_lstm(name, gen, 11, rows, 32, False, save=True,
                                timed=folded)
    for kind, e in folded[name].items():
        e["max_abs_err"] = k3_err if kind == "fwd" else k4_err
        print(f"options K{3 if kind == 'fwd' else 4} {name} {kind}: "
              f"kernel_ms={e['ms']:.4f} plain_ms={e['plain_ms']:.4f} "
              f"bound_ms={e['bound_ms']:.4f} ({e['bound_by']}); {smi}")
    return folded


# ------------------------------------------------------- dropout sweeps

MD_RATE_ITERS = 4            # timed iterations a run of the dropout1 rates
MD_ITERS = 4                 # train_many of the dropout1 model
MD_DROPOUT_RUNS = ((4, False), (6, True))  # the dropout model's, resumed
MD_DROPOUT_N = 16            # the dropout model's width (options_phase's)


def _cli_config(*flags):
    """The ModelConfig ``python -m grouptraj_torch.train.cli`` makes from
    ``flags``."""
    from grouptraj_torch.train import cli
    return cli.configs_from_args(cli.build_parser().parse_args(list(flags)))[0]


def many_dropout_phase(rng, smi):
    """Dropout in multi-seed sweeps: ``train_many`` of the gat preset at
    full width from the training CLI's ``--dropout1 0.2`` (batch 64,
    best_k 20, S=64/N=64), the seeds MANY_SEEDS. Each replica draws its
    noise, labels and keep-masks from its own generator in train()'s
    order (``steps.replica_draws``); the g-step's per-sample forward is a
    vmap over the 20 samples nested in the seed vmap.

    (a) one 4-seed iteration of train_iterations_many (float32 no-grad
        legs, TF32 off) against each seed's single-seed step,
        train_iterations from the same init with a generator seeded as the
        replica's: losses, norms and weights as many_phase holds them
        (:func:`_replicas_report`), and each replica's generator left
        where its single run leaves it (the same draws, keep-masks
        included, in the same order); K1 x4 and K2 x3, all at R = 4, and
        no LSTM kernel (the route is 'scan');
    (b) K1 and K2 at those R = 4 shapes against their plain versions,
        timed beside their bounds;
    (c) seed-iterations per second at N = 1, 2 and 4 in turns beside
        train()'s step, the peak memory and the busy share of a 4-seed
        iteration (chiprun_out/profile_train_many_dropout1.txt);
    (d) train_many of the dropout1 model on a synthetic split for MD_ITERS
        iterations with its launches (K2 exactly 3 an iteration, K1 at
        least 4, at R = 4);
    (e) the ``--dropout 0.2`` model at N = MD_DROPOUT_N (the width
        options_phase gives it: the pool's pair path holds [4, 20, 64, N,
        N, 512] slabs under the two vmaps): one 4-seed iteration launches
        no pool kernel (the pair path, as in train()), then train_many for
        4 iterations, resumed from its files to 6 (scenes of at most 16
        pedestrians, one bucket).
    -> (launches of the runs in (d) and (e), K1/K2 timings at R = 4)."""
    import torch
    from grouptraj_torch.config import TrainConfig
    from grouptraj_torch.train.device_data import synthetic_device_data
    from grouptraj_torch.train.steps import (
        init_train_state, stack_states, train_iterations,
        train_iterations_many,
    )

    t_phase = time.perf_counter()
    cfg = _cli_config("--dropout1", "0.2")
    tcfg = TrainConfig()
    f32 = dataclasses.replace(tcfg, bf16_nograd=False)
    S, seeds = tcfg.batch_size, list(MANY_SEEDS)
    n4 = len(seeds)
    data = synthetic_device_data(256, 64, seed=3, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    idx = torch.randint(0, 256, (MD_RATE_ITERS, 2, S), generator=gen,
                        device="cuda")

    def states(cfg, seeds, tc):
        return [init_train_state(cfg, tc, device="cuda", generator=torch.
                                 Generator(device="cuda").manual_seed(s))
                for s in seeds]

    def gens(seeds):
        return [torch.Generator(device="cuda").manual_seed(1000 + s)
                for s in seeds]

    # (a) one 4-seed iteration against single-seed steps
    st4, g4 = stack_states(states(cfg, seeds, f32), f32), gens(seeds)
    torch.cuda.synchronize()
    reset_counts()
    with _pool_calls() as (seen, first):
        out4 = train_iterations_many(st4, data, idx[:1], cfg, f32, g4)
    torch.cuda.synchronize()
    counts = all_counts()
    rs = sorted({r for _, r, *_ in seen})
    print(f"many dropout1: 4-seed iteration (float32 no-grad legs): "
          f"launches {json.dumps(counts)}, replica axis R {rs}, shapes "
          f"{sorted(set(seen))}")
    if {k: counts[k] for k in MANY_PER_ITER} != MANY_PER_ITER \
            or rs != [n4] or any(counts[k] for k in counts
                                 if k not in MANY_PER_ITER):
        fail(f"many dropout1: a 4-seed iteration must launch "
             f"{MANY_PER_ITER} at R = {n4} and no LSTM kernel, got {counts} "
             f"at R {rs}")
    refs = []
    for i, s in enumerate(seeds):
        one, g1 = states(cfg, [s], f32)[0], gens([s])[0]
        hist = train_iterations(one, data, idx[:1], cfg, f32, g1,
                                impl="scan")
        if not torch.equal(g1.get_state(), g4[i].get_state()):
            fail(f"many dropout1: seed {s}'s generator ended elsewhere than "
                 f"its single run's: the replica drew other draws")
        refs.append(({k: v for k, v in hist.items()},
                     {"g": dict(one.g.named_parameters()),
                      "d": dict(one.d.named_parameters())}))
    _replicas_report("many dropout1", "its seed's single-seed step, one "
                     "iteration on the same draws", seeds, out4, st4, refs,
                     f32)
    del refs, one

    # (b) K1 and K2 at the R = 4 shapes of that iteration
    timed = _hold_pool_shapes("many dropout1", first, rng, n4, smi)
    del seen, first, st4, out4

    # (c) rates in turns, a profile and the peak memory of N = 4
    rates = _sweep_rates("many dropout1", cfg, tcfg,
                         states(cfg, seeds, tcfg), data, idx, gen,
                         gens(seeds), smi, "profile_train_many_dropout1.txt")

    # (d) train_many of the dropout1 model
    launches = {"train_many_dropout1": _train_many_runs(
        "many dropout1", cfg, seeds, ((MD_ITERS, False),), MANY_PER_ITER,
        smi, n_buckets=3, steps_per_dispatch=2, print_every=2,
        checkpoint_every=MD_ITERS)}

    # (e) the dropout model at N = 16: the pair path, then train_many
    cfg = _cli_config("--dropout", "0.2")
    small = synthetic_device_data(256, MD_DROPOUT_N, seed=4, device="cuda")
    st4 = stack_states(states(cfg, seeds, tcfg), tcfg)
    train_iterations_many(st4, small, idx[:1], cfg, tcfg, gens(seeds))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = train_iterations_many(st4, small, idx[1:2], cfg, tcfg, gens(seeds))
    torch.cuda.synchronize()
    it_ms = (time.perf_counter() - t0) * 1e3
    counts = all_counts()
    print(f"many dropout: 4-seed iteration at S{S}_N{MD_DROPOUT_N}: "
          f"launches {json.dumps(counts)}, {it_ms:.1f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")
    if any(counts.values()) or not all(bool(torch.isfinite(v).all())
                                       for v in out.values()):
        fail(f"many dropout: the pool's pair path launches no kernel and "
             f"the losses are finite; got {counts}")
    del st4, out
    launches["train_many_dropout"] = _train_many_runs(
        "many dropout", cfg, seeds, MD_DROPOUT_RUNS,
        {"pool_core_fwd": 0, "pool_core_bwd": 0}, smi,
        max_peds=MD_DROPOUT_N, n_buckets=1, steps_per_dispatch=2,
        print_every=2, checkpoint_every=2)
    print(f"many dropout phase: {time.perf_counter() - t_phase:.1f} s")
    return launches, timed, rates


# ------------------------------------------------------- data parallelism

DP_WORLD = 2                 # gloo ranks, both on cuda:0
DP_ITERS = 2                 # timed iterations a route, after one warm-up
DP_LOOP_ITERS = 20           # train() on the ranks, a checkpoint at the end
DP_RTOL = MANY_RTOL          # a rank against one process, TF32 off
# launches a rank takes an iteration, each on its S = 64 / 2 scenes
DP_PER_ITER = MANY_PER_ITER


DP_ROUNDING_LR = 0.5         # lr: where a change of rounding alone moves
                             # a weight (the worst read on an H100: 0.12 lr)
DP_MAX_NEAR_TIES = 8         # such entries a rank, the attention vectors
                             # apart (read on an H100: 1 and 2)


def _seed_axis(res):
    """A one-seed run's results (``data_parallel.run_iterations``) in the
    form of a sweep's (``run_iterations_many``): a seed axis of 1."""
    return {"history": {k: v[None] for k, v in res["history"].items()},
            "generators": [res["generator"]],
            **{p: {n: w[None] for n, w in res[p].items()} for p in "gd"}}


def _dp_report(label, ranks, one, tcfg, seeds=None, alts=None):
    """Each rank's run against the one-process run ``one``: of
    ``data_parallel.run_iterations``, or with ``seeds`` of
    ``run_iterations_many``'s sweep of those seeds, held seed by seed.
    Losses and norms within DP_RTOL of each history's largest entry, the
    generators left in the same state (the same draws), every seed's
    discriminator alive in ``one`` (a gradient in some iteration);
    weights within lr/10, but within DP_ROUNDING_LR lr where a change of
    rounding alone moves them: the inter-group attention vectors (their
    gradients are rounding noise, which Adam turns into steps of up to lr)
    and, with ``alts`` (seed i's 1-seed sweep in one process: the same
    arithmetic but for the vmapped products' width), every other entry
    that ``alts[i]`` moves by more than lr/100 from ``one``, such as one
    fed by a near-tie of the pool's max that the two resolve otherwise: at
    most DP_MAX_NEAR_TIES such entries a rank."""
    import torch
    if seeds is None:
        ranks, one, seeds = [_seed_axis(r) for r in ranks], _seed_axis(one), [
            None]
    lr = {"g": tcfg.g_learning_rate, "d": tcfg.d_learning_rate}
    worst = {"history": 0.0, "weights": 0.0, "noisy": 0.0, "near_ties": 0.0}
    ties = [0] * len(ranks)
    for i, seed in enumerate(seeds):
        of = "" if seed is None else f" seed {seed}"
        if not one["history"]["norm_d"][i].max() > 0:
            fail(f"{label}:{of} the discriminator had no gradient in one "
                 f"process")
        for r, got in enumerate(ranks):
            for k, ref in one["history"].items():
                d = (got["history"][k][i] - ref[i]).abs().max().item() / max(
                    ref[i].abs().max().item(), 1e-12)
                worst["history"] = max(worst["history"], d)
                if not d <= DP_RTOL:
                    fail(f"{label}: rank {r}{of} {k} "
                         f"{got['history'][k][i].tolist()} against one "
                         f"process {ref[i].tolist()}")
            for part in ("g", "d"):
                for name, w in one[part].items():
                    err = (got[part][name][i] - w[i]).abs() / lr[part]
                    if _noisy(name):
                        key, tie = "noisy", torch.zeros_like(err, dtype=bool)
                    else:
                        key = "weights"
                        tie = (torch.zeros_like(err, dtype=bool)
                               if alts is None else
                               (alts[i][part][name][0] - w[i]).abs()
                               > lr[part] / 100)
                    ties[r] += int(tie.sum())
                    worst[key] = max(worst[key], float(
                        torch.where(tie, 0.0, err).max()))
                    worst["near_ties"] = max(worst["near_ties"], float(
                        torch.where(tie, err, 0.0).max()))
                    tol = torch.where(tie, DP_ROUNDING_LR, 0.1) if \
                        key == "weights" else torch.full_like(
                            err, DP_ROUNDING_LR)
                    if not (err <= tol).all():
                        j = int((err - tol).argmax())
                        fail(f"{label}: rank {r}{of} {part}.{name}[{j}] "
                             f"differs by {err.flatten()[j]:.3e} lr from one"
                             f" process (limit {tol.flatten()[j]} lr)")
            if not torch.equal(got["generators"][i], one["generators"][i]):
                fail(f"{label}: rank {r}'s generator{of} ended elsewhere "
                     f"than one process's: it drew other draws")
    if max(ties) > DP_MAX_NEAR_TIES:
        fail(f"{label}: {ties} weight entries a rank moved by a change of "
             f"rounding alone, more than {DP_MAX_NEAR_TIES}")
    print(f"{label}: each rank against one process"
          f"{'' if seeds == [None] else f' seed by seed {seeds}'}, every "
          f"discriminator alive: losses and norms worst "
          f"{worst['history']:.2e} of the history's largest (limit "
          f"{DP_RTOL}); weights worst {worst['weights']:.2e} lr (limit 0.1 "
          f"lr), the inter-group attention vectors {worst['noisy']:.2e} lr "
          f"(limit {DP_ROUNDING_LR} lr)"
          + ("" if alts is None else
             f", entries a change of rounding alone moves (the 1-seed "
             f"sweeps): {ties} a rank (limit {DP_MAX_NEAR_TIES}), worst "
             f"{worst['near_ties']:.2e} lr (limit {DP_ROUNDING_LR} lr)")
          + "; generators equal")


def dp_phase(rng, smi):
    """Data parallelism over scenes (``grouptraj_torch.parallel``,
    ``train()``'s ``num_devices > 1``) on the one card: DP_WORLD gloo ranks
    on cuda:0, spawned by ``data_parallel.spawn`` (NCCL refuses two ranks
    on one device; gloo sums CUDA tensors through the host), TF32 off. The
    times are one card's with gloo through the host, not a multi-card
    speed.

    (a) the gat preset at full width, batch 64 (32 scenes a rank), best_k
        20, S=64/N=64 synthetic data, float32 no-grad legs: on 'scan' and
        'fused', one warm-up and DP_ITERS iterations of train_iterations
        (``data_parallel.run_iterations``) on each rank against the same in
        one process, generators seeded alike (every draw global, sliced by
        the rank): losses, norms and weights held by :func:`_dp_report`; K1
        x4 and K2 x3 an iteration on each rank; ms an iteration on each
        rank beside the one-process step, the all-reduce's bytes a step
        and ms a call;
    (b) K1 and K2 at a rank's shapes (S=32) against their plain versions,
        timed beside their bounds;
    (c) train() of DP_LOOP_ITERS iterations on the ranks ('fused', the
        loop phase's synthetic split, 3 buckets, a checkpoint event at the
        end): launches, finite histories, rank 0 alone saving, its file
        reloading;
    (d) the nccl backend at world size 1, in this process: one 'scan'
        iteration with the group installed, every all-reduce through
        NCCL.
    -> (launches of (a), (c) and (d) by path, summed over the ranks; K1/K2
    timings at the rank's shapes)."""
    import math
    import shutil
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from grouptraj_torch.config import ModelConfig, TrainConfig
    from grouptraj_torch.data.synthetic import write_scene_files
    from grouptraj_torch.parallel import data_parallel as DPL
    from grouptraj_torch.parallel.mesh import (
        init_data_parallel, set_dp_group, shard_scenes,
    )
    from grouptraj_torch.train import checkpoint as CK
    from grouptraj_torch.train.device_data import synthetic_device_data
    from grouptraj_torch.train.steps import init_train_state, train_iterations

    t_phase = time.perf_counter()
    cfg = ModelConfig()
    f32 = dataclasses.replace(TrainConfig(), bf16_nograd=False)
    S, impls = f32.batch_size, ("scan", "fused")
    spec = dict(num_seq=256, N=64, seed=3)
    idx = np.random.default_rng(5).integers(0, 256, (1 + DP_ITERS, 2, S))
    job = dict(cfg=cfg, tcfg=f32, runs=[(spec, idx)], state_seed=LOOP_SEED,
               gen_seed=7, warm=1)
    tmp = tempfile.mkdtemp(prefix="grouptraj_dp_")
    try:
        root = os.path.join(tmp, "data")
        write_scene_files(os.path.join(root, "synth", "train"), n_files=3,
                          frames=560, max_peds=57, seed=0)
        write_scene_files(os.path.join(root, "synth", "val"), n_files=1,
                          frames=200, max_peds=57, seed=1)
        loop_tcfg = TrainConfig(
            dataset_name="synth", batch_size=64, best_k=20, n_buckets=3,
            steps_per_dispatch=10, print_every=10,
            checkpoint_every=DP_LOOP_ITERS, num_epochs=0, seed=LOOP_SEED,
            lstm_impl="fused", checkpoint_name="dp", num_devices=DP_WORLD,
            output_dir=os.path.join(tmp, "out"))
        outs = {k: os.path.join(tmp, k) for k in ("iters", "loop")}
        for d in outs.values():
            os.makedirs(d)
        t0 = time.perf_counter()
        DPL.spawn(DPL.each_rank, DP_WORLD, "gloo",
                  device_of_rank=lambda r: "cuda:0",
                  init_file=os.path.join(tmp, "store"),
                  args=([(DPL.iterations_rank,
                          dict(job, impls=impls, time_reduce=True),
                          outs["iters"]),
                         (DPL.train_rank,
                          dict(cfg=cfg, tcfg=loop_tcfg, data_dir=root,
                               runs=[(DP_LOOP_ITERS, False)]),
                          outs["loop"])],))
        spawn_s = time.perf_counter() - t0
        ranks = DPL.load_results(outs["iters"], DP_WORLD)
        loop_ranks = DPL.load_results(outs["loop"], DP_WORLD)
        for r in ranks + loop_ranks:
            if r["foreign_modules"]:
                fail(f"dp: a rank imported {r['foreign_modules']}")

        # (a) each rank against one process, launches, times
        launches = {}
        for impl in impls:
            one = DPL.run_iterations(impl=impl, device="cuda", **job)
            got = [r[impl] for r in ranks]
            want = {k: v * DP_ITERS for k, v in DP_PER_ITER.items()}
            for r, res in enumerate(got):
                have = {k: res["launches"][k] for k in want}
                if have != want:
                    fail(f"dp {impl}: rank {r} launched {have} in "
                         f"{DP_ITERS} iterations, not {want}")
            print(f"dp {impl}: launches a rank in {DP_ITERS} iterations "
                  f"{[json.dumps(res['launches']) for res in got]}")
            _dp_report(f"dp {impl}", got, one, f32)
            launches[impl] = {k: sum(res["launches"][k] for res in got)
                              for k in got[0]["launches"]}
            calls, nbytes = got[0]["reduce_calls"], got[0]["reduce_bytes"]
            print(f"dp {impl}: ms an iteration on {DP_WORLD} gloo ranks "
                  f"sharing cuda:0 (32 scenes each) "
                  + ", ".join(f"rank {r} {res['ms_per_iter']:.1f}"
                              for r, res in enumerate(got))
                  + f"; one process, 64 scenes: {one['ms_per_iter']:.1f}; "
                  f"all-reduce {calls // DP_ITERS} calls and "
                  f"{nbytes // DP_ITERS} bytes an iteration ({nbytes // calls}"
                  f" bytes a step); one card, gloo through the host, not a "
                  f"multi-card speed; {smi}")
        print(f"dp: one all-reduce of {ranks[0]['reduce_numel']} float32 "
              f"values (a step's mean) {ranks[0]['reduce_ms']:.3f} ms "
              f"(rank 0; rank 1 {ranks[1]['reduce_ms']:.3f} ms); gloo on "
              f"one card; {smi}")

        # (b) K1 and K2 at a rank's shapes: rank 0's scenes, one process
        st = init_train_state(cfg, f32, device="cuda", generator=torch.
                              Generator(device="cuda").manual_seed(LOOP_SEED))
        data = synthetic_device_data(**spec, device="cuda")
        shard = torch.as_tensor(shard_scenes(idx[:1], 0, DP_WORLD),
                                device="cuda")
        with _pool_calls() as (seen, first):
            train_iterations(st, data, shard, cfg, f32, torch.Generator(
                device="cuda").manual_seed(7), impl="scan")
        torch.cuda.synchronize()
        print(f"dp: a rank's K1/K2 calls {sorted(set(seen))}")
        # the rank's 32 scenes, and the d-step's discriminator scoring real
        # and fake of them in one stacked call
        if sorted({s_ for _, _, s_, _, _ in seen}) != [S // DP_WORLD,
                                                        2 * S // DP_WORLD]:
            fail(f"dp: a rank's pool calls are not at S={S // DP_WORLD} "
                 f"(and {2 * S // DP_WORLD}, D's real | fake)")
        timed = _hold_pool_shapes("dp", first, rng, 1, smi)
        del st, data, seen, first

        # (c) train() on the ranks
        runs = [r["runs"][0] for r in loop_ranks]
        for r, run in enumerate(runs):
            c = run["launches"]
            if c["pool_core_bwd"] != 3 * DP_LOOP_ITERS or \
                    c["pool_core_fwd"] < 4 * DP_LOOP_ITERS:
                fail(f"dp loop: rank {r} launched {c} in {DP_LOOP_ITERS} "
                     f"iterations")
            h = run["ckpt"]
            vals = ([v for vs in h["G_losses"].values() for v in vs]
                    + [v for vs in h["D_losses"].values() for v in vs]
                    + h["norm_g"] + h["norm_d"]
                    + [v for vs in h["metrics_val"].values() for v in vs])
            if h["counters"]["t"] != DP_LOOP_ITERS or not vals \
                    or not all(math.isfinite(v) for v in vals):
                fail(f"dp loop: rank {r} ended at {h['counters']} with "
                     f"histories {vals}")
        if runs[0]["ckpt"] != runs[1]["ckpt"]:
            fail("dp loop: the ranks' histories differ")
        # each rank trains into <output_dir>/rank<r>: only rank 0 writes
        written = {d: sorted(os.listdir(os.path.join(loop_tcfg.output_dir,
                                                     d)))
                   for d in sorted(os.listdir(loop_tcfg.output_dir))}
        if written != {"rank0": ["dp_no_model.pt", "dp_with_model.pt"]}:
            fail(f"dp loop: the ranks wrote {written}, not rank 0's two "
                 f"files alone")
        path = os.path.join(loop_tcfg.output_dir, "rank0", "dp_with_model.pt")
        st = CK.state_from_checkpoint(CK.load_checkpoint(path), cfg,
                                      loop_tcfg, "cuda")
        for part, module in (("g", st.g), ("d", st.d)):
            for name, w in module.named_parameters():
                if not torch.equal(w.detach().cpu(), runs[0][part][name]):
                    fail(f"dp loop: {path} holds another {part}.{name} "
                         f"than the run's")
        launches["loop"] = {k: sum(run["launches"][k] for run in runs)
                            for k in runs[0]["launches"]}
        print(f"dp loop: train() of {DP_LOOP_ITERS} iterations on "
              f"{DP_WORLD} gloo ranks ('fused'), launches a rank "
              f"{[json.dumps(run['launches']) for run in runs]}, "
              f"{[round(run['seconds'], 1) for run in runs]} s; rank "
              f"0 wrote {written['rank0']}, rank 1 nothing; dp_with_model.pt "
              f"reloads the run's weights; last val ade "
              f"{runs[0]['ckpt']['metrics_val']['ade'][-1]:.4f}; the spawn "
              f"with (a) took {spawn_s:.1f} s")

        # (d) nccl at world size 1, in this process (a process start costs
        # ~8 s on the card's host)
        t0 = time.perf_counter()
        prev = set_dp_group(init_data_parallel(
            1, 0, "nccl", "file://" + os.path.join(tmp, "store_nccl"),
            "cuda:0"))
        try:
            res = DPL.run_iterations(**dict(job, runs=[(spec, idx[:1])],
                                            warm=0), impl="scan",
                                     device="cuda")
        finally:
            set_dp_group(prev)
            dist.destroy_process_group()
        if {k: res["launches"][k] for k in DP_PER_ITER} != DP_PER_ITER \
                or res["reduce_calls"] != 2 or not all(
                    bool(torch.isfinite(v).all())
                    for v in res["history"].values()):
            fail(f"dp nccl: one iteration at world size 1 gave {res}")
        launches["nccl"] = res["launches"]
        print(f"dp nccl: world size 1, one 'scan' iteration, "
              f"{res['reduce_calls']} all-reduces through NCCL "
              f"({res['reduce_bytes']} bytes), launches "
              f"{json.dumps(res['launches'])}; "
              f"{time.perf_counter() - t0:.1f} s with the group's set-up")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"dp phase: {time.perf_counter() - t_phase:.1f} s")
    paths = {"train_dp": {k: launches["scan"][k] + launches["fused"][k]
                          for k in launches["scan"]},
             "loop_dp": launches["loop"], "train_dp_nccl": launches["nccl"]}
    return paths, timed


# ------------------------------------- sweeps over data-parallel ranks

MDP_SEEDS = (6, 7)           # the sweep's seeds: both discriminators alive
MDP_D1_SEEDS = (6, 10)       # the dropout1 sweep's: both discriminators
                             # alive (7's, 8's and 9's have no gradient)
MDP_ITERS = 2                # timed iterations, after one warm-up
MDP_RUNS = ((10, False), (20, True))   # train_many on the ranks, resumed


def many_dp_phase(rng, smi):
    """Multi-seed sweeps over data-parallel scene shards (``train_many``
    with ``num_devices > 1``: the seed vmap outside, the ranks inside) on
    the one card: DP_WORLD gloo ranks on cuda:0 spawned by
    ``data_parallel.spawn`` (``sweep_rank``), TF32 off; one card with
    gloo through the host, not a multi-card speed.

    (a) the gat preset at full width, batch 64 (32 scenes a rank), best_k
        20, 'scan', the seeds MDP_SEEDS, S=64/N=64 synthetic data, float32
        no-grad legs: one warm-up and MDP_ITERS iterations of
        train_iterations_many (``data_parallel.run_iterations_many``) on
        each rank against the same sweep in one process, every replica's
        generator seeded alike (every draw global, sliced by the rank):
        losses and norms within DP_RTOL, weights within lr/10 but where a
        change of rounding alone moves them, generators equal
        (:func:`_dp_report`); K1 x4 and K2 x3 an iteration on
        each rank; ms an iteration on each rank beside the one-process
        sweep, the all-reduce's calls and bytes;
    (b) the ``--dropout1 0.2`` model's sweep of the seeds MDP_D1_SEEDS, one
        iteration on the ranks (the per-sample vmap nested in the seed
        vmap, its keep-masks drawn at the global batch's shapes and sliced)
        against one process, held as (a);
    (c) K1 and K2 at a rank's shapes (R = 2 seeds, S = 32, D's stacked
        real | fake call at 64) against their plain versions, timed beside
        their bounds;
    (d) train_many of the seeds on the loop phase's synthetic split
        (batch 64, best_k 20, 3 buckets, dispatches of 10, a checkpoint
        every 10) on the ranks for MDP_RUNS: 10 iterations, then resumed
        from rank 0's sweep directory to 20 (each rank writes into
        ``<output_dir>/rank<r>``: rank 0's holds the s<seed>/ files, rank
        1's nothing); K2 exactly 3 and K1 at least 4 an iteration on each
        rank, finite histories, the ranks' histories and generator states
        equal;
    (e) the nccl backend at world size 1, in this process: one sweep
        iteration with the group installed, both all-reduces through NCCL.
    -> (launches of (a)+(b), (d) and (e) by path, summed over the ranks;
    K1/K2 timings at the rank's shapes)."""
    import math
    import shutil
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from grouptraj_torch.config import ModelConfig, TrainConfig
    from grouptraj_torch.data.synthetic import write_scene_files
    from grouptraj_torch.parallel import data_parallel as DPL
    from grouptraj_torch.parallel.mesh import (
        init_data_parallel, set_dp_group, shard_scenes,
    )
    from grouptraj_torch.train.device_data import synthetic_device_data
    from grouptraj_torch.train.multi import RNG_KEY
    from grouptraj_torch.train.steps import (
        init_train_state, stack_states, train_iterations_many,
    )

    t_phase = time.perf_counter()
    cfg = ModelConfig()
    f32 = dataclasses.replace(TrainConfig(), bf16_nograd=False)
    S, seeds = f32.batch_size, list(MDP_SEEDS)
    gen_seeds = [1000 + s for s in seeds]
    spec = dict(num_seq=256, N=64, seed=3)
    idx = np.random.default_rng(5).integers(0, 256, (1 + MDP_ITERS, 2, S))
    job = dict(cfg=cfg, tcfg=f32, runs=[(spec, idx)], state_seeds=seeds,
               gen_seeds=gen_seeds, warm=1)
    d1job = dict(job, cfg=_cli_config("--dropout1", "0.2"),
                 state_seeds=list(MDP_D1_SEEDS),
                 gen_seeds=[1000 + s for s in MDP_D1_SEEDS],
                 runs=[(spec, idx[:1])], warm=0)
    per_iter = {k: v * MDP_ITERS for k, v in DP_PER_ITER.items()}
    tmp = tempfile.mkdtemp(prefix="grouptraj_many_dp_")
    try:
        root = os.path.join(tmp, "data")
        write_scene_files(os.path.join(root, "synth", "train"), n_files=3,
                          frames=560, max_peds=57, seed=0)
        write_scene_files(os.path.join(root, "synth", "val"), n_files=1,
                          frames=200, max_peds=57, seed=1)
        loop_tcfg = TrainConfig(
            dataset_name="synth", batch_size=64, best_k=20, n_buckets=3,
            steps_per_dispatch=10, print_every=10, checkpoint_every=10,
            num_epochs=0, seed=seeds[0], checkpoint_name="mdp",
            num_devices=DP_WORLD, output_dir=os.path.join(tmp, "out"))
        out = os.path.join(tmp, "ranks")
        os.makedirs(out)
        t0 = time.perf_counter()
        DPL.spawn(DPL.sweep_rank, DP_WORLD, "gloo",
                  device_of_rank=lambda r: "cuda:0",
                  init_file=os.path.join(tmp, "store"),
                  args=(dict(iterations={"gat": job, "dropout1": d1job},
                             cfg=cfg, tcfg=loop_tcfg, seeds=seeds,
                             data_dir=root, runs=MDP_RUNS), out))
        spawn_s = time.perf_counter() - t0
        ranks = DPL.load_results(out, DP_WORLD)
        for r in ranks:
            if r["foreign_modules"]:
                fail(f"many dp: a rank imported {r['foreign_modules']}")

        # (a) and (b): each rank's sweep against one process
        launches = {}
        for name, want in (("gat", per_iter), ("dropout1", DP_PER_ITER)):
            kw = job if name == "gat" else d1job
            one = DPL.run_iterations_many(device="cuda", **kw)
            alts = [DPL.run_iterations_many(device="cuda", **dict(
                kw, state_seeds=[s], gen_seeds=[g]))
                for s, g in zip(kw["state_seeds"], kw["gen_seeds"])]
            got = [r["iterations"][name] for r in ranks]
            for r, res in enumerate(got):
                have = {k: res["launches"][k] for k in want}
                if have != want or any(res["launches"][k] for k in
                                       res["launches"] if k not in want):
                    fail(f"many dp {name}: rank {r} launched "
                         f"{res['launches']} in {res['iterations']} "
                         f"iterations, not {want} and no LSTM kernel")
            print(f"many dp {name}: launches a rank in {got[0]['iterations']}"
                  f" iteration(s) {[json.dumps(res['launches']) for res in got]}")
            _dp_report(f"many dp {name}", got, one, f32, kw["state_seeds"],
                       alts)
            launches[name] = {k: sum(res["launches"][k] for res in got)
                              for k in got[0]["launches"]}
            calls, nbytes = got[0]["reduce_calls"], got[0]["reduce_bytes"]
            print(f"many dp {name}: ms an iteration of the {len(seeds)}-seed "
                  f"sweep on {DP_WORLD} gloo ranks sharing cuda:0 (32 scenes "
                  f"each) " + ", ".join(f"rank {r} {res['ms_per_iter']:.1f}"
                                        for r, res in enumerate(got))
                  + f"; one process, 64 scenes: {one['ms_per_iter']:.1f}; "
                  f"all-reduce {calls} calls and {nbytes} bytes in "
                  f"{got[0]['iterations']} iteration(s) ({nbytes // calls} "
                  f"bytes a step); one card, gloo through the host, not a "
                  f"multi-card speed; {smi}")
            del one, alts, got

        # (c) K1 and K2 at a rank's shapes: rank 0's scenes, one process
        st = stack_states([init_train_state(
            cfg, f32, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(s))
            for s in seeds], f32)
        data = synthetic_device_data(**spec, device="cuda")
        shard = torch.as_tensor(shard_scenes(idx[:1], 0, DP_WORLD),
                                device="cuda")
        with _pool_calls() as (seen, first):
            train_iterations_many(st, data, shard, cfg, f32, [
                torch.Generator(device="cuda").manual_seed(s)
                for s in gen_seeds])
        torch.cuda.synchronize()
        print(f"many dp: a rank's K1/K2 calls {sorted(set(seen))}")
        if sorted({r_ for _, r_, *_ in seen}) != [len(seeds)] or sorted(
                {s_ for _, _, s_, _, _ in seen}) != [S // DP_WORLD,
                                                     2 * S // DP_WORLD]:
            fail(f"many dp: a rank's pool calls are not at R = {len(seeds)}"
                 f" and S = {S // DP_WORLD} (and {2 * S // DP_WORLD}, D's "
                 f"real | fake)")
        timed = _hold_pool_shapes("many dp", first, rng, len(seeds), smi)
        del st, data, seen, first

        # (d) train_many on the ranks, resumed from rank 0's files
        runs = [r["runs"] for r in ranks]
        done = 0
        for j, (iters, restore) in enumerate(MDP_RUNS):
            ran = iters - done
            for r, rank in enumerate(runs):
                run = rank[j]
                c = run["launches"]
                if c["pool_core_bwd"] != 3 * ran or \
                        c["pool_core_fwd"] < 4 * ran:
                    fail(f"many dp loop: rank {r} launched {c} in {ran} "
                         f"iterations")
                for s in seeds:
                    h = run["ckpt"][s]
                    vals = ([v for vs in h["G_losses"].values() for v in vs]
                            + [v for vs in h["D_losses"].values()
                               for v in vs] + h["norm_g"] + h["norm_d"]
                            + [v for vs in h["metrics_val"].values()
                               for v in vs])
                    if h["counters"]["t"] != iters or not vals or not all(
                            math.isfinite(v) for v in vals) or (
                            restore and h["restore_ts"] != [done]):
                        fail(f"many dp loop: rank {r} seed {s} ended at "
                             f"{h['counters']} (restore_ts "
                             f"{h['restore_ts']}) with histories {vals}")
            for s in seeds:
                a, b = (rank[j]["ckpt"][s] for rank in runs)
                if {k: v for k, v in a.items() if k != RNG_KEY} != {
                        k: v for k, v in b.items() if k != RNG_KEY} \
                        or not torch.equal(a[RNG_KEY], b[RNG_KEY]):
                    fail(f"many dp loop: the ranks' histories or generator "
                         f"states of seed {s} differ")
            print(f"many dp loop: train_many of {len(seeds)} seeds, "
                  f"{ran} iterations{' (resumed)' if restore else ''} on "
                  f"{DP_WORLD} gloo ranks, launches a rank "
                  f"{[json.dumps(rank[j]['launches']) for rank in runs]}, "
                  f"{[round(rank[j]['seconds'], 1) for rank in runs]} s, "
                  f"all-reduce {runs[0][j]['reduce_calls']} calls; {smi}")
            done = iters
        written = {d: sorted(os.listdir(os.path.join(loop_tcfg.output_dir,
                                                     d)))
                   for d in sorted(os.listdir(loop_tcfg.output_dir))}
        files = ["mdp_no_model.pt", "mdp_with_model.pt"]
        if written != {"rank0": [f"s{s}" for s in seeds]} or any(
                sorted(os.listdir(os.path.join(loop_tcfg.output_dir,
                                               "rank0", f"s{s}"))) != files
                for s in seeds):
            fail(f"many dp loop: the ranks wrote {written}, not rank 0's "
                 f"s<seed>/ files alone")
        launches["loop"] = {k: sum(rank[j]["launches"][k] for rank in runs
                                   for j in range(len(MDP_RUNS)))
                            for k in runs[0][0]["launches"]}
        print(f"many dp loop: rank 0 wrote {written['rank0']} with {files}"
              f", rank 1 nothing; last val ade per seed "
              + json.dumps({s: runs[0][-1]["ckpt"][s]["metrics_val"]["ade"]
                            [-1:] for s in seeds})
              + f"; the spawn took {spawn_s:.1f} s")

        # (e) nccl at world size 1, in this process
        t0 = time.perf_counter()
        prev = set_dp_group(init_data_parallel(
            1, 0, "nccl", "file://" + os.path.join(tmp, "store_nccl"),
            "cuda:0"))
        try:
            res = DPL.run_iterations_many(**dict(
                job, runs=[(spec, idx[:1])], warm=0), device="cuda")
        finally:
            set_dp_group(prev)
            dist.destroy_process_group()
        if {k: res["launches"][k] for k in DP_PER_ITER} != DP_PER_ITER \
                or res["reduce_calls"] != 2 or not all(
                    bool(torch.isfinite(v).all())
                    for v in res["history"].values()):
            fail(f"many dp nccl: one sweep iteration at world size 1 gave "
                 f"{res['launches']}, {res['reduce_calls']} all-reduces, "
                 f"{res['history']}")
        launches["nccl"] = res["launches"]
        print(f"many dp nccl: world size 1, one {len(seeds)}-seed sweep "
              f"iteration, {res['reduce_calls']} all-reduces through NCCL "
              f"({res['reduce_bytes']} bytes), launches "
              f"{json.dumps(res['launches'])}; "
              f"{time.perf_counter() - t0:.1f} s with the group's set-up")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"many dp phase: {time.perf_counter() - t_phase:.1f} s")
    paths = {"train_many_dp": {k: launches["gat"][k] + launches["dropout1"][k]
                               for k in launches["gat"]},
             "train_many_dp_loop": launches["loop"],
             "train_many_dp_nccl": launches["nccl"]}
    return paths, timed


# ----------------------------------------------------------------- wide

# The JAX package's scale configuration (tools/scale_bench.py's "H=128" and
# "N=128" rows): every LSTM 128 wide, embedding 32, noise 16, the gat preset
# otherwise, at N = 128 (synthetic_device_data's scenes, as the scale study
# draws them), batch 64, best_k 20.
WIDE_MODEL = dict(encoder_h_dim_g=128, decoder_h_dim_g=128,
                  encoder_h_dim_d=128, embedding_dim=32, noise_dim=(16,))
WIDE_N = 128
WIDE_ITERS = 3               # training iterations a route, from one state
# K3/K4 at the shapes the scale configuration gives them (timed): name, T,
# B, H, gx variant, residuals saved, cotangents (dys, dhT, dcT) to K4
WIDE_LSTM = (
    ("G_encoder_T8_B8192_H128", 8, 8192, 128, True, True, _ENC),
    ("D_encoder_T20_B16384_H128", 20, 16384, 128, True, True, _ENC),
    ("decoder_T11_B16384_H128", 11, 16384, 128, False, True, _DEC),
    ("decoder_T11_B163840_H128_nograd", 11, 163840, 128, False, False,
     _DEC))
# K5/K6 at the encoders' shapes (timed): name, T, B, D, H, residuals saved
WIDE_PROJ = (
    ("G_encoder_T8_B8192_D32_H128", 8, 8192, 32, 128, True),
    ("D_encoder_T20_B16384_D32_H128", 20, 16384, 32, 128, True))
# widths between the built ones (zero-padded: lstm_plan), small B
WIDE_ODD_LSTM = (("H40", 5, 70, 40, True), ("H40_decoder", 4, 33, 40, False),
                 ("H100", 4, 33, 100, True),
                 ("H100_decoder", 3, 70, 100, False))
WIDE_ODD_PROJ = (("D12_H100", 4, 33, 12, 100), ("D12_H40", 5, 70, 12, 40))
# one iteration of the scale configuration: route -> wide launches
WIDE_PER_ITER = {"fused": {"lstm_fused_fwd_wide": 7,
                           "lstm_fused_bwd_wide": 4},
                 "pallas": {"lstm_proj_fwd_wide": 4,
                            "lstm_proj_bwd_wide": 3}}
WIDE_PER_CALL = {"fused": {"lstm_fused_fwd_wide": 2},
                 "pallas": {"lstm_proj_fwd_wide": 1}}
# the wide backward's kernels (K4's and K6's): recurrence, dW, dxs
WIDE_BWD_KERNELS = ("lstm_wide_bwd_kernel", "lstm_wide_dw_kernel",
                    "lstm_wide_dx_kernel")


def wide_counts():
    """K3-K6's launches of the wide design (all_counts counts them too)."""
    from grouptraj_torch.ops.cuda_lstm import lstm_fused_bwd, lstm_fused_fwd
    from grouptraj_torch.ops.cuda_lstm_proj import lstm_proj_bwd, lstm_proj_fwd
    return {f"{w.__name__}_wide": w.launches_wide
            for w in (lstm_fused_fwd, lstm_fused_bwd, lstm_proj_fwd,
                      lstm_proj_bwd)}


def _shifted(t):
    """A copy of t in a view that starts 4 bytes off a 16-byte boundary."""
    import torch
    buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def _repeats(label, call, args, shift):
    """``call(*args)`` twice, bit for bit, and once more with the arguments
    at the indices ``shift`` as views off a 16-byte boundary (the wrapper
    copies them), bit for bit with the first."""
    import torch
    first, second = call(*args), call(*args)
    moved = list(args)
    for i in shift:
        if moved[i] is not None:
            moved[i] = _shifted(moved[i])
    third = call(*moved)
    torch.cuda.synchronize()
    for x, y, z in zip(first, second, third):
        if (x is None) != (y is None) or (x is None) != (z is None):
            fail(f"{label}: an output is given by one call only")
        if x is not None and not (torch.equal(x, y) and torch.equal(x, z)):
            fail(f"{label}: a repeat or a misaligned view changed the bits")
    print(f"{label}: repeat and misaligned views bit for bit")


def _wide_lstm_case(name, gen, T, B, H, with_gx, save, cot, timed):
    """check_lstm, then K3 and K4 repeated and on misaligned views."""
    from grouptraj_torch.ops.cuda_lstm import lstm_fused_bwd, lstm_fused_fwd
    errs = check_lstm(name, gen, T, B, H, with_gx, save, cot, timed)
    w, h0, c0, gx, b, cots = lstm_inputs(gen, T, B, H, with_gx)
    given = [c if use else None for c, use in
             zip(cots, cot if with_gx else _DEC)]
    _repeats(f"wide K3 {name}",
             lambda w, h0, c0, gx, b: lstm_fused_fwd(w, h0, c0, gx=gx, b=b,
                                                    T=T, save=save),
             (w, h0, c0, gx, b), (1, 2, 3, 4))
    if save:
        ys, _, _, gates, cs = lstm_fused_fwd(w, h0, c0, gx=gx, b=b, T=T,
                                             save=True)
        _repeats(f"wide K4 {name}", lstm_fused_bwd,
                 (w, h0, c0, ys, gates, cs, *given, with_gx),
                 (1, 2, 3, 4, 5, 6))
    return errs


def _wide_proj_case(name, gen, T, B, D, H, save, cot, timed):
    """check_proj, then K5 and K6 repeated and on misaligned views."""
    import torch
    from grouptraj_torch.ops.cuda_lstm_proj import lstm_proj_bwd, lstm_proj_fwd
    errs = check_proj(name, gen, T, B, D, H, save, cot, timed)
    w_ih, w_hh, b, xs, h0, c0 = proj_inputs(gen, T, B, D, H)
    _repeats(f"wide K5 {name}",
             lambda *a: lstm_proj_fwd(*a, save=True),
             (w_ih, w_hh, b, xs, h0, c0), (2, 3, 4, 5))
    ys, _, _, gates, cs = lstm_proj_fwd(w_ih, w_hh, b, xs, h0, c0, save=True)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    given = [r(T, B, H) if cot[0] else None, r(B, H) if cot[1] else None,
             r(B, H) if cot[2] else None]
    _repeats(f"wide K6 {name}", lstm_proj_bwd,
             (w_ih, w_hh, xs, h0, c0, ys, gates, cs, *given),
             (2, 3, 4, 5, 6, 7, 8))
    return errs


def wide_phase(rng, smi):
    """K3-K6 at every width the JAX kernels take, driven by the JAX
    package's H=128 / D=32 / N=128 scale configuration (WIDE_MODEL):

    (a) K3/K4 and K5/K6 alone at the shapes that configuration gives them
        (WIDE_LSTM, WIDE_PROJ) and at widths between the built ones (H=40
        and H=100, D=12): each against its plain version at check_lstm's /
        check_proj's tolerances, bit for bit on a repeat and on misaligned
        views, the full shapes timed beside their bounds; nn.LSTM at D=32,
        H=128 beside both kernel routes (library_lstm);
    (b) the configuration's main paths, scan / fused / pallas / pallas /
        fused / scan in turns, from copies of one live state: one k=20
        serving call (context + folded decode + copy to the host) with
        positions against 'scan' within SERVE_ATOL; one iteration's losses
        and every gradient against 'scan' (TRAIN_LOSS_RTOL,
        TRAIN_GRAD_RTOL of each tensor's largest entry) and WIDE_ITERS
        iterations of train_iterations with their losses against 'scan';
        every count at 0 before a run and read after it (K3-K6 only in
        their wide design); ms a call and an iteration, peak memory, and
        the busy share of a fused and a pallas iteration
        (chiprun_out/profile_train_wide_<route>.txt);
    (c) K1 and K2 at the shapes (b)'s fused iteration gave them (S64_N128_B8
        and S128_N128_B128) against their plain versions, timed beside
        their bounds.
    Returns (launches by path, K3-K6 timings, library timings, K1/K2
    timings, largest errors)."""
    import copy
    import numpy as np
    import torch
    from grouptraj_torch.config import ModelConfig, TrainConfig
    from grouptraj_torch.train.device_data import (
        gather_batch, synthetic_device_data,
    )
    from grouptraj_torch.train.steps import (
        train_iterations, train_state_from_modules,
    )
    from grouptraj_torch.utils import relative_to_abs

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(23)
    before = wide_counts()
    lstm_timed, proj_timed, errs = {}, {}, {"fwd": [], "bwd": [],
                                            "pfwd": [], "pbwd": []}
    for name, T, B, H, with_gx, save, cot in WIDE_LSTM:
        f, b = _wide_lstm_case(name, gen, T, B, H, with_gx, save, cot,
                               lstm_timed)
        errs["fwd"].append(f)
        errs["bwd"].append(b)
        torch.cuda.empty_cache()
    for name, T, B, H, with_gx in WIDE_ODD_LSTM:
        f, b = _wide_lstm_case(f"odd_{name}", gen, T, B, H, with_gx, True,
                               (True, True, True), None)
        errs["fwd"].append(f)
        errs["bwd"].append(b)
    hT_only = (False, True, False)
    for name, T, B, D, H, save in WIDE_PROJ:
        f, b = _wide_proj_case(name, gen, T, B, D, H, save, hT_only,
                               proj_timed)
        errs["pfwd"].append(f)
        errs["pbwd"].append(b)
        torch.cuda.empty_cache()
    for name, T, B, D, H in WIDE_ODD_PROJ:
        f, b = _wide_proj_case(f"odd_{name}", gen, T, B, D, H, True,
                               (True, True, True), None)
        errs["pfwd"].append(f)
        errs["pbwd"].append(b)
    alone = {k: v - before[k] for k, v in wide_counts().items()}
    print(f"wide kernels alone: wide launches {json.dumps(alone)}")
    if min(alone.values()) == 0:
        fail("wide: a wide shape did not run the wide design")
    library = {
        "G_encoder_T8_B8192_D32_H128": library_lstm(
            gen, "wide G_encoder", 8, 8192, 32, 128),
        "D_encoder_T20_B16384_D32_H128": library_lstm(
            gen, "wide D_encoder", 20, 16384, 32, 128)}
    torch.cuda.empty_cache()

    # (b) the scale configuration on the three routes
    cfg = dataclasses.replace(ModelConfig(), **WIDE_MODEL)
    tcfg = dataclasses.replace(TrainConfig(), bf16_nograd=False)
    S, k = tcfg.batch_size, tcfg.best_k
    data = synthetic_device_data(256, WIDE_N, seed=5, device="cuda")
    gen.manual_seed(2)
    idx = torch.randint(0, 256, (WIDE_ITERS, 2, S), generator=gen,
                        device="cuda")
    batch = gather_batch(data, idx[0, 0], cfg.obs_len)
    state, seed, alive = alive_state(cfg, tcfg, batch, gen)
    n_par = sum(p.numel() for m in (state.g, state.d)
                for p in m.parameters())
    print(f"wide: the scale configuration {json.dumps(WIDE_MODEL)} (gat "
          f"preset otherwise), {n_par} parameters, S={S} N={WIDE_N}, "
          f"best_k {k}, float32 no-grad legs; seed {seed} (discriminator "
          f"scores positive on {100 * alive:.0f}% of the first batch)")
    z = torch.randn((k, S, WIDE_N, cfg.noise_dim[0]), generator=gen,
                    device="cuda")
    draw = dict(noise=torch.randn((S, WIDE_N, cfg.noise_dim[0]),
                                  generator=gen, device="cuda"),
                noises=torch.randn((k, S, WIDE_N, cfg.noise_dim[0]),
                                   generator=gen, device="cuda"), label=0.9)

    @torch.inference_mode()
    def serve(impl):
        ctx = state.g.generator_context(batch["obs"], batch["obs_rel"],
                                        batch["group"], batch["valid"],
                                        impl=impl)
        preds = state.g.generator_sample_many(ctx, batch["obs_rel"],
                                              batch["valid"], k,
                                              user_noises=z, impl=impl)
        return relative_to_abs(preds, batch["obs"][None, :, :, -1, :]) \
            .cpu().numpy()

    def train(impl):
        run = train_state_from_modules(copy.deepcopy(state.g),
                                       copy.deepcopy(state.d), tcfg)
        g = torch.Generator(device="cuda").manual_seed(31)
        return train_iterations(run, data, idx, cfg, tcfg, g, impl=impl)

    launches, out, ms, peak = {}, {}, {}, {}
    for impl in ("scan", "fused", "pallas"):
        for what, fn, per in (("serve", serve, WIDE_PER_CALL),
                              ("train", train, WIDE_PER_ITER)):
            fn(impl)                                           # warm
            torch.cuda.synchronize()
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = fn(impl)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = {**all_counts(), **wide_counts()}
            n = 1 if what == "serve" else WIDE_ITERS
            # every K3-K6 launch of the configuration is a wide one
            want = {key: v * n for key, v in per.get(impl, {}).items()}
            want.update({key[:-len("_wide")]: v for key, v in want.items()})
            lstm = {key: v for key, v in counts.items()
                    if key.startswith("lstm_")}
            print(f"wide {what} {impl}: launches {json.dumps(counts)}; "
                  f"{secs * 1e3 / n:.2f} ms a "
                  f"{'call' if what == 'serve' else 'iteration'}, peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                  f"{smi}")
            if lstm != {key: want.get(key, 0) for key in lstm} \
                    or counts["pool_core_fwd"] == 0 or (
                        what == "train" and counts["pool_core_bwd"] == 0):
                fail(f"wide {what} {impl}: LSTM launches {lstm}, expected "
                     f"{want} and no other, and K1 (and K2) above 0")
            launches[f"wide_{what}_{impl}"] = counts
            out[(what, impl)] = res
            ms[(what, impl)] = [secs * 1e3 / n]
            peak[(what, impl)] = torch.cuda.max_memory_allocated()
    rows = batch["valid"].cpu().numpy() > 0
    ref = out[("serve", "scan")]
    for impl in ("fused", "pallas"):
        o = out[("serve", impl)]
        d = np.abs(o - ref)[:, rows].max()
        print(f"wide serve {impl} vs scan: max |dpos| = {d:.3e} m "
              f"(tolerance {SERVE_ATOL} m)")
        if o.shape != ref.shape or not np.isfinite(o).all() \
                or not d <= SERVE_ATOL:
            fail(f"wide serve {impl}: disagrees with scan")
        for key, v in out[("train", impl)].items():
            r = out[("train", "scan")][key]
            rel = ((v - r).abs() / r.abs().clamp_min(1e-12)).max().item()
            print(f"wide train {impl} vs scan: {key} over {WIDE_ITERS} "
                  f"iterations {[round(float(x), 6) for x in v]} worst rel "
                  f"diff {rel:.3e} (tolerance {TRAIN_LOSS_RTOL})")
            if not (bool(torch.isfinite(v).all()) and rel <= TRAIN_LOSS_RTOL):
                fail(f"wide train {impl}: {key} disagrees with scan")
    losses, names, grads = _one_iteration(state, batch, cfg, tcfg, **draw)
    for impl in ("fused", "pallas"):
        k_losses, _, k_grads = _one_iteration(state, batch, cfg, tcfg,
                                              **draw, impl=impl)
        _loss_report(f"wide train S{S}_N{WIDE_N} {impl} vs scan", k_losses,
                     losses)
        _grad_report(f"wide train S{S}_N{WIDE_N} {impl} vs scan", names,
                     k_grads, grads)
        del k_grads
    del grads
    for impl in ("pallas", "fused", "scan"):          # the second turn
        for what, fn in (("serve", serve), ("train", train)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(impl)
            torch.cuda.synchronize()
            n = 1 if what == "serve" else WIDE_ITERS
            ms[(what, impl)].append((time.perf_counter() - t0) * 1e3 / n)
    for (what, impl), v in ms.items():
        print(f"wide {what} {impl}: {statistics.mean(v):.2f} ms a "
              f"{'call' if what == 'serve' else 'iteration'} (mean of the "
              f"two turns {[round(x, 2) for x in v]}), peak "
              f"{peak[(what, impl)] / 2**30:.2f} GiB")
    busy = {impl: profile_phase(
        lambda: train_iterations(
            train_state_from_modules(copy.deepcopy(state.g),
                                     copy.deepcopy(state.d), tcfg),
            data, idx[:1], cfg, tcfg, gen, impl=impl),
        f"wide training iteration {impl}",
        f"profile_train_wide_{impl}.txt",
        statistics.mean(ms[("train", impl)])) for impl in ("fused", "pallas")}

    # (c) K1 and K2 at the shapes of a fused iteration
    with _pool_calls() as (seen, first):
        train("fused")
    torch.cuda.synchronize()
    print(f"wide: K1/K2 calls of {WIDE_ITERS} fused iterations (kind, R, S, "
          f"N, B): {sorted(set(seen))}")
    pool_timed = _hold_pool_shapes("wide", first, rng, 1, smi)
    print(f"wide phase: {time.perf_counter() - t_phase:.1f} s")
    paths = {key: v for key, v in launches.items() if "scan" not in key}
    return paths, lstm_timed, proj_timed, library, pool_timed, {
        key: max(v) for key, v in errs.items()}, busy, ms, peak


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    if not os.path.isdir(os.path.join(HERE, "grouptraj_torch")):
        fail("run from a checkout of the repository: grouptraj_torch/ "
             "is not beside this script")
    sys.path.insert(0, HERE)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()} torch {torch.__version__} cuda "
          f"{torch.version.cuda}")

    from grouptraj_torch.ops import _build
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"build: {len(libs)} kernel source(s) in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        log = path.parent / f"{path.name}.log"
        fn = ""
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "Compiling entry function" in line:
                fn = kernel_name(line) or ""
            elif "registers" in line or "spill" in line:
                print(f"build {name} {fn}: {line.strip()}")

    hmma, hmma_bf16 = sass_hmma(libs)

    rng = np.random.default_rng(0)
    max_err, timed = kernel_phase(rng)
    bwd_err, bwd_timed = kernel_bwd_phase(rng)
    bf16_err, bf16_bwd_err, bf16_timed = kernel_bf16_phase(rng)
    k3_err, k4_err, lstm_timed, lstm_library = lstm_kernel_phase()
    k5_err, k6_err, proj_timed = proj_kernel_phase()

    batches = {b: make_scenes(rng, scene_sizes(rng, S, 2, hi))
               for b, (S, N, hi) in BUCKETS.items()}
    gen = torch.Generator(device="cuda").manual_seed(1)
    noises = {b: torch.randn((K, S, N, 8), generator=gen, device="cuda")
              for b, (S, N, _) in BUCKETS.items()}
    serve_launches, p16, p32, call_ms = serve_phase(batches, noises)
    route_serve_launches, route_call_ms, route_call = serve_fused_phase(
        p32, batches, noises)
    sc, gr = batches["S64_N64"]
    profile_phase(lambda: p16.predict_batch(sc, gr, noises=noises["S64_N64"]),
                  "predict_batch", "profile_serve.txt",
                  call_ms["bf16_S64_N64"])
    profile_phase(lambda: route_call("fused"), "fused serving call f32",
                  "profile_serve_fused.txt", route_call_ms["fused_S64_N64"])
    del p16, p32, route_call
    eval_launches, _ = eval_phase(batches)
    train_launches = train_phase()
    loop_launches = loop_phase(smi.splitlines()[0])
    preset_launches = presets_phase(batches, noises)
    many_launches, many_timed, _ = many_phase(rng, smi.splitlines()[0])
    option_launches, option_folded = options_phase(
        batches, noises, smi.splitlines()[0])
    md_launches, md_timed, _ = many_dropout_phase(rng, smi.splitlines()[0])
    dp_launches, dp_timed = dp_phase(rng, smi.splitlines()[0])
    mdp_launches, mdp_timed = many_dp_phase(rng, smi.splitlines()[0])
    (wide_launches, wide_lstm, wide_proj, wide_library, wide_pool, wide_err,
     _, _, _) = wide_phase(rng, smi.splitlines()[0])
    bf16_paths = bf16_paths_phase(batches, noises)

    # launches: every main path, each driven with the counts at 0 just
    # before it and read just after it: serving through the Predictor (scan
    # route), serving on the fused and on the pallas route, and
    # train_iterations at S=64, N=64 on the three routes (TRAIN_ITERS
    # iterations each), eval on the three routes, train() on the fused
    # and pallas routes (LOOP_ITERS, the fused run with its resume), the
    # per-step pooling model's serving call and PET_ITERS iterations on
    # 'scan' and 'fused', and the other presets' serving calls and
    # iterations (presets_phase), and train_many's sweep of four seeds
    # (many_phase, K1/K2 at R = 4), and the MLP options' serving calls
    # and 'fused' and 'pallas' iterations (options_phase: K3/K4 at 20·S·N
    # rows in the dropout1 model's per-sample g-step), and train_many of
    # the dropout1 model (K1/K2 at R = 4 under the nested vmap) and of the
    # dropout model (the pair pool: K1 in its metric sweeps only)
    # (many_dropout_phase), and data parallelism over scenes: train_iterations
    # on two gloo ranks on 'scan' and 'fused' (K1/K2 at each rank's 32
    # scenes), train() on the ranks and one iteration on nccl at world size
    # 1 (dp_phase, the launches summed over the ranks), and train_many over
    # the ranks: a 2-seed sweep's iterations without dropout and with
    # dropout1 (K1/K2 at R = 2 on each rank's 32 scenes), train_many on the
    # ranks with a resume and a sweep iteration on nccl at world size 1
    # (many_dp_phase, summed over the ranks), and the H=128 / D=32 / N=128
    # scale configuration's serving call and iterations on the fused and
    # pallas routes, which run K3-K6 in their wide design only (wide_phase;
    # the wide entries below count those launches). No
    # single PyTorch call computes K1-K4's functions, so their library_ms
    # is null; the nearest call for K3/K4,
    # torch.nn.LSTM with the input projection on both sides, is under
    # "nearest_library". nn.LSTM computes exactly K5's function (and its
    # backward K6's): K5's library_ms is its forward with grad at the
    # discriminator encoder's shape, K6's its forward + backward less that.
    # K1's and K2's bf16 mode are entries of their own, their launches
    # those of bf16_paths_phase's paths (the setting at "default"); on the
    # paths above, in the default exact mode, their counts are 0.
    paths = {"serve": serve_launches,
             "serve_fused": route_serve_launches["fused"],
             "serve_pallas": route_serve_launches["pallas"],
             "train": train_launches["scan"],
             "train_fused": train_launches["fused"],
             "train_pallas": train_launches["pallas"],
             "eval": eval_launches["scan"],
             "eval_fused": eval_launches["fused"],
             "eval_pallas": eval_launches["pallas"],
             "loop_fused": loop_launches["fused"],
             "loop_pallas": loop_launches["pallas"], **preset_launches,
             "train_many": many_launches,
             **{f"options_{k}": v for k, v in option_launches.items()},
             **md_launches, **dp_launches, **mdp_launches, **wide_launches}
    # K1/K2 at the R = 4 shapes of a 4-seed training iteration, without
    # dropout and with dropout1, at a data-parallel rank's shapes, and at
    # a rank's shapes of a 2-seed sweep over the ranks
    many_shapes, md_shapes, dp_shapes, mdp_shapes = (
        {kind: {tag: t for (k_, tag), t in t_.items() if k_ == kind}
         for kind in ("fwd", "bwd")}
        for t_ in (many_timed, md_timed, dp_timed, mdp_timed))

    def entry(name, source, replaces, err, shape, t, library_ms=None,
              by_paths=paths, **more):
        by_path = {path: counts[name] for path, counts in by_paths.items()}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": err,
                "shape": shape, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": library_ms, **more}

    k3_shape, k4_shape = ("decoder_T11_B81920_H32_nograd",
                          "D_encoder_T20_B8192_H48")
    k56_shape = "D_encoder_T20_B8192_D16_H48"
    d_lib = lstm_library["D_encoder_T20_B8192_H48"]
    def tc_more(t, timed_shapes, kernel):
        return dict(bound_f32_ms=t["bound_f32_ms"],
                    bound_tc_ms=t["bound_tc_ms"], bound_unit=t["bound_unit"],
                    shapes=timed_shapes,
                    hmma=None if hmma is None else {
                        f: c for f, c in hmma.items() if f.startswith(kernel)})

    record = {"kernels": [
        entry("pool_core_fwd", "grouptraj_torch/csrc/pool_core_fwd.cu",
              "grouptraj/ops/pallas_pool.py:160", max_err, "S64_N64_B8",
              timed["S64_N64_B8"],
              shapes_train_many=many_shapes["fwd"],
              shapes_train_many_dropout1=md_shapes["fwd"],
              shapes_train_dp=dp_shapes["fwd"],
              shapes_train_many_dp=mdp_shapes["fwd"],
              **tc_more(timed["S64_N64_B8"], timed,
                          "pool_core_fwd_kernel")),
        entry("pool_core_bwd", "grouptraj_torch/csrc/pool_core_bwd.cu",
              "grouptraj/ops/pallas_pool.py:206", bwd_err, "S128_N64_B48",
              bwd_timed["S128_N64_B48"],
              phases=bwd_timed["S128_N64_B48"]["phases"],
              shapes_train_many=many_shapes["bwd"],
              shapes_train_many_dropout1=md_shapes["bwd"],
              shapes_train_dp=dp_shapes["bwd"],
              shapes_train_many_dp=mdp_shapes["bwd"],
              **tc_more(bwd_timed["S128_N64_B48"], bwd_timed,
                          "ties_kernel")),
        entry("lstm_fused_fwd", "grouptraj_torch/csrc/lstm_fused_fwd.cu",
              "grouptraj/ops/pallas_fused.py:118", k3_err, k3_shape,
              lstm_timed[k3_shape]["fwd"], nearest_library=lstm_library,
              shapes_options={n: t["fwd"] for n, t in option_folded.items()},
              **tc_more(lstm_timed[k3_shape]["fwd"],
                        {n: t["fwd"] for n, t in lstm_timed.items()},
                        "lstm_fused_fwd_kernel")),
        entry("lstm_fused_bwd", "grouptraj_torch/csrc/lstm_fused_bwd.cu",
              "grouptraj/ops/pallas_fused.py:180", k4_err, k4_shape,
              lstm_timed[k4_shape]["bwd"], nearest_library=lstm_library,
              shapes_options={n: t["bwd"] for n, t in option_folded.items()},
              **tc_more(lstm_timed[k4_shape]["bwd"],
                          {n: t["bwd"] for n, t in lstm_timed.items()
                           if "bwd" in t}, "lstm_fused_bwd_kernel")),
        entry("lstm_proj_fwd", "grouptraj_torch/csrc/lstm_proj_fwd.cu",
              "grouptraj/ops/pallas_lstm.py:45", k5_err, k56_shape,
              proj_timed[k56_shape]["fwd"],
              library_ms=d_lib["library_fwd_train_ms"],
              **tc_more(proj_timed[k56_shape]["fwd"],
                        {n: t["fwd"] for n, t in proj_timed.items()},
                        "lstm_proj_fwd_kernel")),
        entry("lstm_proj_bwd", "grouptraj_torch/csrc/lstm_proj_bwd.cu",
              "grouptraj/ops/pallas_lstm.py:71", k6_err, k56_shape,
              proj_timed[k56_shape]["bwd"],
              library_ms=(d_lib["library_fwd_bwd_ms"]
                          - d_lib["library_fwd_train_ms"]),
              **tc_more(proj_timed[k56_shape]["bwd"],
                          {n: t["bwd"] for n, t in proj_timed.items()
                           if "bwd" in t}, "lstm_proj_bwd_kernel")),
        entry("pool_core_fwd_bf16", "grouptraj_torch/csrc/pool_core_fwd.cu",
              "grouptraj/ops/pallas_pool.py:160", bf16_err, "S64_N64_B8",
              bf16_timed["fwd"]["S64_N64_B8"], by_paths=bf16_paths,
              exact_ms=bf16_timed["fwd"]["S64_N64_B8"]["exact_ms"],
              hmma_bf16=hmma_bf16,
              **tc_more(bf16_timed["fwd"]["S64_N64_B8"], bf16_timed["fwd"],
                        "pool_core_fwd_kernel")),
        entry("pool_core_bwd_bf16", "grouptraj_torch/csrc/pool_core_bwd.cu",
              "grouptraj/ops/pallas_pool.py:206", bf16_bwd_err,
              "S128_N64_B48", bf16_timed["bwd"]["S128_N64_B48"],
              by_paths=bf16_paths,
              exact_ms=bf16_timed["bwd"]["S128_N64_B48"]["exact_ms"],
              **tc_more(bf16_timed["bwd"]["S128_N64_B48"], bf16_timed["bwd"],
                        "ties_kernel"))]}
    # K3-K6 in their wide design (csrc/lstm_wide_*.cu): entries of their
    # own, timed at the scale configuration's shapes, their launches those
    # of wide_phase's fused and pallas paths; K1/K2 held at that
    # configuration's shapes beside them
    w3, w4 = "decoder_T11_B163840_H128_nograd", "D_encoder_T20_B16384_H128"
    w56 = "D_encoder_T20_B16384_D32_H128"
    w_lib = wide_library[w56]
    wide_shapes = {kind: {tag: t for (k_, tag), t in wide_pool.items()
                          if k_ == kind} for kind in ("fwd", "bwd")}
    record["kernels"][0]["shapes_wide"] = wide_shapes["fwd"]
    record["kernels"][1]["shapes_wide"] = wide_shapes["bwd"]
    record["kernels"] += [
        entry("lstm_fused_fwd_wide", "grouptraj_torch/csrc/lstm_wide_fwd.cu",
              "grouptraj/ops/pallas_fused.py:118", wide_err["fwd"], w3,
              wide_lstm[w3]["fwd"], by_paths=wide_launches,
              nearest_library=wide_library,
              **tc_more(wide_lstm[w3]["fwd"],
                        {n: t["fwd"] for n, t in wide_lstm.items()},
                        "lstm_wide_fwd_kernel")),
        entry("lstm_fused_bwd_wide", "grouptraj_torch/csrc/lstm_wide_bwd.cu",
              "grouptraj/ops/pallas_fused.py:180", wide_err["bwd"], w4,
              wide_lstm[w4]["bwd"], by_paths=wide_launches,
              nearest_library=wide_library,
              **tc_more(wide_lstm[w4]["bwd"],
                        {n: t["bwd"] for n, t in wide_lstm.items()
                         if "bwd" in t}, WIDE_BWD_KERNELS)),
        entry("lstm_proj_fwd_wide", "grouptraj_torch/csrc/lstm_wide_fwd.cu",
              "grouptraj/ops/pallas_lstm.py:45", wide_err["pfwd"], w56,
              wide_proj[w56]["fwd"], by_paths=wide_launches,
              library_ms=w_lib["library_fwd_train_ms"],
              **tc_more(wide_proj[w56]["fwd"],
                        {n: t["fwd"] for n, t in wide_proj.items()},
                        "lstm_wide_fwd_kernel")),
        entry("lstm_proj_bwd_wide", "grouptraj_torch/csrc/lstm_wide_bwd.cu",
              "grouptraj/ops/pallas_lstm.py:71", wide_err["pbwd"], w56,
              wide_proj[w56]["bwd"], by_paths=wide_launches,
              library_ms=(w_lib["library_fwd_bwd_ms"]
                          - w_lib["library_fwd_train_ms"]),
              **tc_more(wide_proj[w56]["bwd"],
                        {n: t["bwd"] for n, t in wide_proj.items()
                         if "bwd" in t}, WIDE_BWD_KERNELS))]
    for kernel in record["kernels"]:
        if kernel["launches"] == 0:
            fail(f"{kernel['name']} was launched on no main path")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
