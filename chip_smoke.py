"""Drive the PyTorch/CUDA port (grouptraj_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Phases, each of which fails the run on any error:
1. device: the card's name and power limit; TF32 off for matmuls and cuDNN;
2. build: every kernel under grouptraj_torch/csrc/ with nvcc, timed, with
   ptxas's registers, shared memory and spills; the count of tensor-core
   (HMMA) instructions in the pool kernels', K4's and K6's SASS
   (cuobjdump), which must not be 0 for K1's and K2's tile kernels and for
   any instance of K4 or K6;
3. kernel: K1 (the social-pool pair core, csrc/pool_core_fwd.cu)
   against its plain PyTorch version on the card: the serving buckets, the
   discriminator's B=48 at S=128 and S=64 (N=64), R=2, ragged masks with
   holes and pad scenes, ReLU and duplicate-row ties, bf16 weights at B=8
   and 48, odd sizes (N=70, K=260, B=5), B=100 (two launches), N=256 at
   B=48; then K2 (its backward, csrc/pool_core_bwd.cu) against its plain
   version at the training shapes (S=64/N=64/B=8, S=128/N=64/B=48,
   S=256/N=16), R=2, holes, pad scenes, odd sizes, ReLU-zero,
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
   times beside the bound (K4: the float32-core and the tensor-core
   bound), and torch.nn.LSTM (cuDNN) beside matmul + K3 (+ K4) at the
   encoder shapes;
   then K5 (the LSTM with its input projection in the kernel,
   csrc/lstm_proj_fwd.cu) and K6 (its backward, csrc/lstm_proj_bwd.cu)
   against their plain versions at the encoders' full-width shapes
   (generator T=8/B=4,096/D=16/H=32 with residuals and, as served, without;
   discriminator T=20/D=16/H=48 at B=8,192 and 4,096, a cotangent on hT
   only) and at odd sizes (B=1, B=70, T=1, D=4 and 8, H=8, 16 and 64, all
   cotangents non-zero or only dhT), non-zero initial states throughout;
   times beside the bound (K6: the float32-core and the tensor-core
   bound), and torch.nn.LSTM's forward and forward +
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
6. train: ModelConfig()/TrainConfig() at full width (batch 64, best_k=20)
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
   profile_train_fused.txt and profile_train_pallas.txt).

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository beside it, the script exits non-zero and prints no result.
"""

import contextlib
import dataclasses
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
SLEEP_CYCLES = 2_000_000     # ~1 ms of GPU clock: the stream's lead in time_ms
POOL_ATOL = 1e-4             # kernel vs plain, pooled (see check_kernel)
BWD_RTOL = {"da": 1e-5, "du": 1e-5, "dW2": 1e-4, "db2": 1e-4}  # check_bwd
SERVE_ATOL = 1e-3            # metres, kernel vs plain pool end to end
# device functions of K1 and K2 (the weight split they share, K1's tile,
# K2's three passes), K3 and K4 (two), K4's and K6's block-order sum, K5
# and K6, as a trace names them
PORT_KERNELS = ("split_w_kernel", "pool_core_fwd_kernel", "ties_kernel",
                "tie_grads_kernel", "weight_reduce_kernel",
                "lstm_fused_fwd_kernel", "lstm_fused_bwd_kernel",
                "reduce_partials_kernel", "lstm_proj_fwd_kernel",
                "lstm_proj_bwd_kernel")
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
    """``pool_core_fwd_kernel<6,f32>``, ``lstm_fused_bwd_kernel<48,1>``
    (H, WITH_GX) or ``lstm_proj_bwd_kernel<16,48>`` from a line that names
    a pool kernel's, K4's or K6's mangled symbol (ptxas or cuobjdump; the
    base name alone from a profiler's demangled one); None for other
    kernels."""
    m = re.search(r"(lstm_fused_bwd_kernel)(?:ILi(\d+)ELb([01])E)?", line)
    if m is None:
        m = re.search(r"(lstm_proj_bwd_kernel)(?:ILi(\d+)ELi(\d+)E)?", line)
    if m is not None:
        return m.group(1) + (f"<{m.group(2)},{m.group(3)}>"
                             if m.group(2) else "")
    m = re.search(r"((?:split_w|pool_core_fwd|ties|tie_grads|weight_reduce)"
                  r"_kernel)(?:I(?:L[ib](\d+)E)?(f|13__nv_bfloat16)?E)?", line)
    if m is None:
        return None
    args = [x for x in (m.group(2), {None: None, "f": "f32"}.get(
        m.group(3), "bf16")) if x]
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


# libraries whose SASS sass_hmma reads, and the kernels among them that
# must run on the tensor cores: K1's tile, K2's ties pass, K4, K6
HMMA_LIBS = ("pool_core_fwd", "pool_core_bwd", "lstm_fused_bwd",
             "lstm_proj_bwd")
HMMA_KERNELS = ("pool_core_fwd_kernel", "ties_kernel",
                "lstm_fused_bwd_kernel", "lstm_proj_bwd_kernel")


def sass_hmma(libs):
    """The count of HMMA (tensor-core mma) instructions in each kernel of
    the pool libraries', K4's and K6's SASS, by cuobjdump beside nvcc;
    fails if K1's or K2's tile kernel or any instance of K4 or K6 has none.
    None where the toolkit has no cuobjdump."""
    from grouptraj_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.isfile(tool):
        print(f"sass: no cuobjdump at {tool}; HMMA count not taken")
        return None
    counts = {}
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
            elif fn is not None and "HMMA" in line:
                counts[fn] += 1
    print("sass HMMA: " + " ".join(f"{f}={c}" for f, c in counts.items()))
    for kernel in HMMA_KERNELS:
        tiles = [c for f, c in counts.items() if f.startswith(kernel)]
        if not tiles or min(tiles) == 0:
            fail(f"{kernel} runs no tensor-core instruction (HMMA)")
    return counts


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


def _bounds(pairs, K_, B, passes, extra_ops, nbytes):
    """Least times (ms) for pair work on these inputs, both against every
    input read and every output written once over HBM bandwidth:

    - float32 cores: K·(2+2B) operations per valid pair (subtract, ReLU,
      B multiply-adds) plus ``extra_ops``, over FP32_PEAK;
    - tensor cores: the pair products (2·B per pair and k) times the
      ``passes`` of the 3xTF32 split over TF32_PEAK, and beside them (the
      two units run at once, so the larger counts) the subtract, the ReLU
      and the split (TC_ELEMENTWISE_OPS per pair and k) plus ``extra_ops``
      over FP32_PEAK.

    ``bound_ms`` is the smaller of the two; ``bound_by`` says whether bytes
    or operations set it and ``bound_unit`` which units' bound it is."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_f32 = (pairs * K_ * (2 + 2 * B) + extra_ops) / FP32_PEAK * 1e3
    t_tc = max(pairs * K_ * 2 * B * passes / TF32_PEAK,
               (pairs * K_ * TC_ELEMENTWISE_OPS + extra_ops) / FP32_PEAK) * 1e3
    f32, tc = max(t_f32, t_bytes), max(t_tc, t_bytes)
    unit, t_ops = ("tensor-core", t_tc) if tc <= f32 else ("float32", t_f32)
    return dict(bound_ms=min(f32, tc),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_unit=unit, bound_f32_ms=f32, bound_tc_ms=tc)


def _valid_pairs(valid):
    nv = valid.sum(-1).double()
    return float((nv * nv).sum())


def pool_bound_ms(a, W2, valid, outputs_bytes):
    """Least time for the pair core on these inputs (:func:`_bounds`):
    the valid pairs' operations, with 3 split passes for float32 weights
    and 2 for bfloat16, against reading a, u, W2, b2, valid and writing the
    outputs once."""
    import torch
    R, S, N, K_ = a.shape
    B = W2.shape[-1]
    nbytes = (2 * a.numel() * 4 + W2.numel() * W2.element_size()
              + B * R * W2.element_size() + valid.numel() * 4
              + outputs_bytes)
    passes = 3 if W2.dtype == torch.float32 else 2
    return _bounds(_valid_pairs(valid), K_, B, passes, 0.0, nbytes)


def check_kernel(name, a, u, W2, b2, valid, expect_ties=False):
    """Kernel vs plain on the card. pooled within POOL_ATOL: float32 sums
    of K=512 products in different orders, values of a few units; cnt
    equal, since ties come from equal inputs that give bit-equal values in
    both. Only valid rows count (invalid rows are re-masked by callers)."""
    import torch
    from grouptraj_torch.ops.cuda_pool import pool_core_fwd
    from grouptraj_torch.ops.pooling import pool_core
    pooled, cnt = pool_core_fwd(a, u, W2, b2, valid)
    ref, ref_cnt = pool_core(a, u, W2, b2, valid)
    torch.cuda.synchronize()
    rows = valid > 0
    err = (pooled - ref)[rows].abs().max().item() if rows.any() else 0.0
    cnt_bad = int((cnt != ref_cnt)[rows].sum())
    pad = valid.sum(-1) == 0
    pad_ok = bool((pooled[pad] == 0).all() and (cnt[pad] == 0).all())
    ties = int((ref_cnt[rows] > 1).sum())
    print(f"kernel {name}: shape a={tuple(a.shape)} B={W2.shape[-1]} "
          f"W2={str(W2.dtype)[6:]} max_abs_err={err:.3e} "
          f"cnt_mismatch={cnt_bad} tie_entries={ties} pad_scenes="
          f"{int(pad.sum())} pad_zero={pad_ok}")
    if not (err <= POOL_ATOL and cnt_bad == 0 and pad_ok):
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
    main_cases = {"S64_N64_B8": realistic_valid(rng, 64, 64, 2, 57),
                  "S256_N16_B8": realistic_valid(rng, 256, 16, 2, 16)}
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


def bwd_bound_ms(a, W2, valid, pooled, cnt):
    """Least time for the pool backward on these inputs (:func:`_bounds`).
    Operations: the recompute of every valid pair (as the forward, float32
    weights: 3 split passes) plus, for each (i, j, b) that reached a
    positive max at a valid i (Σ cnt there), ~6 float32 operations per k
    (subtract, test, multiply-add into da and du, ReLU and multiply-add
    into dW2). Bytes: a, u, pooled, cnt, dpool, valid, W2, b2 read and da,
    du, dW2, db2 written once."""
    R, S, N, K_ = a.shape
    B = W2.shape[-1]
    live = (valid[..., None] > 0) & (pooled > 0)
    entries = float(cnt[live].double().sum())
    nbytes = 4 * (4 * a.numel() + 3 * pooled.numel() + valid.numel()
                  + 2 * (W2.numel() + R * B))
    return _bounds(_valid_pairs(valid), K_, B, 3, entries * K_ * 6, nbytes)


def check_bwd(name, rng, a, u, W2, b2, valid, expect_ties=False,
              exact=False):
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
    da/du."""
    import torch
    from grouptraj_torch.ops.cuda_pool import pool_core_bwd, pool_core_fwd
    from grouptraj_torch.ops.pooling import pool_core, pool_core_bwd_plain
    pooled, cnt = pool_core_fwd(a, u, W2, b2, valid)
    dpool = torch.from_numpy(rng.integers(-8, 9, size=tuple(pooled.shape))
                             .astype("float32") / 8).cuda()
    dbg = {}
    out = pool_core_bwd(a, u, W2, b2, valid, pooled, cnt, dpool, debug=dbg)
    da2, du2, none_w, none_b = pool_core_bwd(a, u, W2, b2, valid, pooled,
                                             cnt, dpool, weight_grads=False)
    torch.cuda.synchronize()
    rows = valid > 0
    recount_bad = int((dbg["recount"] != cnt)[rows].sum())
    ties = dbg["ties"]
    want = torch.where(rows[..., None] & (pooled > 0), cnt, 0.0)
    sel_bad = int((ties.sum(-2) != want).sum())
    same = bool(torch.equal(out[0], da2) and torch.equal(out[1], du2)
                and none_w is None and none_b is None)
    if exact:
        ref_pooled, ref_cnt = pool_core(a, u, W2, b2, valid)
        fwd_equal = bool(torch.equal(pooled[rows], ref_pooled[rows])
                         and torch.equal(cnt[rows], ref_cnt[rows]))
        ref = pool_core_bwd_plain(a, u, W2, b2, valid, ref_pooled, ref_cnt,
                                  dpool)
    else:
        fwd_equal = True
        ref = pool_core_bwd_plain(a, u, W2, b2, valid, pooled, cnt, dpool,
                                  ties=ties)
    errs, ok = {}, True
    for key, x, r in zip(BWD_RTOL, out, ref):
        errs[key] = (x - r).abs().max().item()
        ok &= errs[key] <= BWD_RTOL[key] * max(1.0, r.abs().max().item())
        ok &= bool(torch.isfinite(x).all())
    n_ties = int((want > 1).sum())
    print(f"kernel bwd {name}: shape a={tuple(a.shape)} B={W2.shape[-1]} "
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
                  "S256_N16_B8": (realistic_valid(rng, 256, 16, 2, 16), 8)}
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
    written. Forward: ``bound_ms`` and ``bound_by``, all operations over
    the float32 peak. Backward, which runs its products on the tensor
    cores: both units' bounds as :func:`_unit_bounds` gives them."""
    tbh = T * B * H
    if kind == "fwd":
        ops = 2 * tbh * 4 * H + LSTM_GATE_OPS["fwd"] * tbh
        floats = (4 * H * H + (4 * tbh if with_gx else 4 * H) + 4 * B * H
                  + tbh + (5 * tbh if save else 0))
        t_ops, t_bytes = ops / FP32_PEAK * 1e3, 4 * floats / HBM_BW * 1e3
        return dict(bound_ms=max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes")
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
    ``bound_ms`` and ``bound_by``, and for K4 and K6 both units' bounds as
    :func:`_unit_bounds` gives them). With ``timed`` (a dict) the median
    kernel and plain times and the bounds are stored under ``name``."""
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
            text = (_bound_text(e) if "bound_unit" in e else
                    f"bound_ms={e['bound_ms']:.4f} ({e['bound_by']})")
            print(f"kernel {label} {name} {kind} time: kernel_ms="
                  f"{e['ms']:.4f} plain_ms={e['plain_ms']:.4f} {text} "
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
    enc, dec = (False, True, False), (True, False, False)
    main = [   # name, T, B, H, gx variant, residuals, cotangents given
        ("G_encoder_T8_B4096_H32", 8, 4096, 32, True, True, enc),
        ("D_encoder_T20_B4096_H48", 20, 4096, 48, True, True, enc),
        ("D_encoder_T20_B8192_H48", 20, 8192, 48, True, True, enc),
        ("decoder_T11_B4096_H32_nograd", 11, 4096, 32, False, False, dec),
        ("decoder_T11_B8192_H32", 11, 8192, 32, False, True, dec),
        ("decoder_T11_B81920_H32_nograd", 11, 81920, 32, False, False, dec)]
    for name, T, B, H, with_gx, save, cot in main:
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
    f, b = check_lstm("only_dys", gen, 6, 50, 32, True, cot=dec)
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
    read, dxs, dw_ih, dw_hh, db, dh0, dc0 written. Forward: ``bound_ms``
    and ``bound_by``, all operations over the float32 peak. Backward, which
    runs its products on the tensor cores: both units' bounds as
    :func:`_unit_bounds` gives them."""
    tbh, tbd, w = T * B * H, T * B * D, (D + H) * 4 * H
    if kind == "fwd":
        ops = 2 * T * B * w + LSTM_GATE_OPS["fwd"] * tbh
        floats = (w + 4 * H + tbd + 4 * B * H + tbh
                  + (5 * tbh if save else 0))
        t_ops, t_bytes = ops / FP32_PEAK * 1e3, 4 * floats / HBM_BW * 1e3
        return dict(bound_ms=max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes")
    floats = (2 * w + 4 * H + 2 * tbd + 4 * B * H + 6 * tbh
              + (tbh if cot[0] else 0) + (cot[1] + cot[2]) * B * H)
    return _unit_bounds(4 * T * B * w, LSTM_GATE_OPS["bwd"] * tbh,
                        4 * floats / HBM_BW * 1e3)


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
    w_ih, w_hh = r(D, 4 * H) / H ** 0.5, r(H, 4 * H) / H ** 0.5
    b, xs, h0, c0 = 0.1 * r(4 * H), r(T, B, D), 0.5 * r(B, H), 0.5 * r(B, H)
    args = (w_ih, w_hh, b, xs, h0, c0)

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
    main = [   # name, T, B, D, H, residuals
        ("G_encoder_T8_B4096_D16_H32", 8, 4096, 16, 32, True),
        ("G_encoder_T8_B4096_D16_H32_nograd", 8, 4096, 16, 32, False),
        ("D_encoder_T20_B4096_D16_H48", 20, 4096, 16, 48, True),
        ("D_encoder_T20_B8192_D16_H48", 20, 8192, 16, 48, True)]
    for name, T, B, D, H, save in main:
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


def all_counts():
    from grouptraj_torch.ops.cuda_pool import pool_core_bwd, pool_core_fwd
    return {"pool_core_fwd": pool_core_fwd.launches,
            "pool_core_bwd": pool_core_bwd.launches, **lstm_counts()}


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
    unprofiled wall time per call (``wall_ms``)."""
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
        return
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


# ----------------------------------------------------------------- train

def _grad_report(what, names, got, ref):
    """Largest per-tensor max |Δ| / max |ref| over the gradient tensors;
    fails beyond TRAIN_GRAD_RTOL. A tensor whose gradient is zero to
    rounding (the inter-group attention vectors: ~1e-10 beside 1e-2
    elsewhere) is measured against 1e-6 of the largest gradient entry of
    its network instead of its own."""
    import torch
    ref = [r.to(g.device) for g, r in zip(got, ref)]
    top = {net: max(r.abs().max().item() for n, r in zip(names, ref)
                    if n[0] == net) for net in "DG"}
    worst, worst_name, zero = 0.0, "", 0
    for name, g, r in zip(names, got, ref):
        if not torch.isfinite(g).all():
            fail(f"{what}: gradient of {name} is not finite")
        zero += int(r.abs().max().item() == 0)
        scale = max(r.abs().max().item(), 1e-6 * top[name[0]], 1e-30)
        rel = (g - r).abs().max().item() / scale
        if rel > worst:
            worst, worst_name = rel, name
    print(f"{what}: {len(names)} gradient tensors ({zero} all-zero; largest "
          f"entry D {top['D']:.3e}, G {top['G']:.3e}), worst max|d|/max|ref|"
          f" = {worst:.3e} ({worst_name}; tolerance {TRAIN_GRAD_RTOL})")
    if not worst <= TRAIN_GRAD_RTOL:
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


def train_phase():
    import copy
    import torch
    from grouptraj_torch.config import ModelConfig, TrainConfig
    from grouptraj_torch.ops.cuda_pool import pool_core_bwd, pool_core_fwd
    from grouptraj_torch.train.device_data import (
        gather_batch, synthetic_device_data,
    )
    from grouptraj_torch.train.steps import (
        d_step, g_step, init_train_state, train_iterations,
        train_state_from_modules,
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
    # The discriminator's score passes a trailing ReLU (a quirk the port
    # keeps), so about every second initialisation scores 0 everywhere and
    # has no gradient at all. Take the first seed whose discriminator is
    # alive on most of the first batch, so the comparisons below compare
    # something.
    for seed in range(2, 34):
        gen.manual_seed(seed)
        state = init_train_state(cfg, tcfg, generator=gen, device="cuda")
        with torch.no_grad():
            scores = state.d(torch.cat([batch["obs"], batch["pred"]], 2),
                             torch.cat([batch["obs_rel"], batch["pred_rel"]],
                                       2), batch["valid"])
        alive = (scores[batch["valid"] > 0] > 0).float().mean().item()
        if alive >= 0.5:
            break
    else:
        fail("no seed in 2..33 gave a discriminator with positive scores")
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


# ----------------------------------------------------------------- main

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

    hmma = sass_hmma(libs)

    rng = np.random.default_rng(0)
    max_err, timed = kernel_phase(rng)
    bwd_err, bwd_timed = kernel_bwd_phase(rng)
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
    train_launches = train_phase()

    # launches: every main path, each driven with the counts at 0 just
    # before it and read just after it: serving through the Predictor (scan
    # route), serving on the fused and on the pallas route, and
    # train_iterations at S=64, N=64 on the three routes (TRAIN_ITERS
    # iterations each). No single PyTorch call computes K1-K4's functions,
    # so their library_ms is null; the nearest call for K3/K4,
    # torch.nn.LSTM with the input projection on both sides, is under
    # "nearest_library". nn.LSTM computes exactly K5's function (and its
    # backward K6's): K5's library_ms is its forward with grad at the
    # discriminator encoder's shape, K6's its forward + backward less that.
    paths = {"serve": serve_launches,
             "serve_fused": route_serve_launches["fused"],
             "serve_pallas": route_serve_launches["pallas"],
             "train": train_launches["scan"],
             "train_fused": train_launches["fused"],
             "train_pallas": train_launches["pallas"]}

    def entry(name, source, replaces, err, shape, t, library_ms=None,
              **more):
        by_path = {path: counts[name] for path, counts in paths.items()}
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
              **tc_more(timed["S64_N64_B8"], timed,
                          "pool_core_fwd_kernel")),
        entry("pool_core_bwd", "grouptraj_torch/csrc/pool_core_bwd.cu",
              "grouptraj/ops/pallas_pool.py:206", bwd_err, "S128_N64_B48",
              bwd_timed["S128_N64_B48"],
              phases=bwd_timed["S128_N64_B48"]["phases"],
              **tc_more(bwd_timed["S128_N64_B48"], bwd_timed,
                          "ties_kernel")),
        entry("lstm_fused_fwd", "grouptraj_torch/csrc/lstm_fused_fwd.cu",
              "grouptraj/ops/pallas_fused.py:118", k3_err, k3_shape,
              lstm_timed[k3_shape]["fwd"],
              shapes={n: t["fwd"] for n, t in lstm_timed.items()},
              nearest_library=lstm_library),
        entry("lstm_fused_bwd", "grouptraj_torch/csrc/lstm_fused_bwd.cu",
              "grouptraj/ops/pallas_fused.py:180", k4_err, k4_shape,
              lstm_timed[k4_shape]["bwd"], nearest_library=lstm_library,
              **tc_more(lstm_timed[k4_shape]["bwd"],
                          {n: t["bwd"] for n, t in lstm_timed.items()
                           if "bwd" in t}, "lstm_fused_bwd_kernel")),
        entry("lstm_proj_fwd", "grouptraj_torch/csrc/lstm_proj_fwd.cu",
              "grouptraj/ops/pallas_lstm.py:45", k5_err, k56_shape,
              proj_timed[k56_shape]["fwd"],
              library_ms=d_lib["library_fwd_train_ms"],
              shapes={n: t["fwd"] for n, t in proj_timed.items()}),
        entry("lstm_proj_bwd", "grouptraj_torch/csrc/lstm_proj_bwd.cu",
              "grouptraj/ops/pallas_lstm.py:71", k6_err, k56_shape,
              proj_timed[k56_shape]["bwd"],
              library_ms=(d_lib["library_fwd_bwd_ms"]
                          - d_lib["library_fwd_train_ms"]),
              **tc_more(proj_timed[k56_shape]["bwd"],
                          {n: t["bwd"] for n, t in proj_timed.items()
                           if "bwd" in t}, "lstm_proj_bwd_kernel"))]}
    for kernel in record["kernels"]:
        if kernel["launches"] == 0:
            fail(f"{kernel['name']} was launched on no main path")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
