// LSTM with its input projection in the kernel, forward (kernel K5 of the
// port).
//
// Replaces the TPU kernel grouptraj/ops/pallas_lstm.py:_fwd_kernel
// (launched from _lstm_pallas_fwd_impl; public lstm_scan_pallas). All T
// steps of a single-layer LSTM run in one launch, torch gate order
// (i, f, g, o):
//
//   z_t = x_t @ W_ih + h_{t-1} @ W_hh + b       (x_t [B, D] read from xs)
//   c_t = f * c_{t-1} + i * g,  h_t = o * tanh(c_t)
//
// It writes ys [T, B, H], hT, cT [B, H] and, on request, the residuals of
// the backward (K6): the post-activation gates [T, B, 4H] and the cell
// states cs [T, B, H]. The input projection x_t @ W_ih is computed here, per
// step, from xs [T, B, D]: no gx slab [T, B, 4H] (126 MB for the
// discriminator's encoder in the d-step) is ever written or read.
//
// Bound on an H100 SXM (chip_smoke.py:proj_bound_ms gives both units').
// Operations: the products 2*T*B*(D + H)*4H, as 3xTF32 on the tensor cores
// (three TF32 passes at 495 TFLOP/s) or on the float32 cores (67 TFLOP/s),
// beside the gate math on the float32 cores. Bytes: xs, the weights, h0, c0
// read, ys, hT, cT (and gates, cs) written once over 3.35 TB/s. The
// discriminator's encoder in the d-step (T = 20, B = 8,192, D = 16, H = 48,
// residuals saved) is 4.0 GFLOP of products, 0.060 ms on the float32 cores
// and 0.024 on the tensor cores, against 206 MB, 0.061 ms: on the tensor
// cores every encoder shape is bound by its bytes.
//
// Design: K3's (lstm_fused_fwd.cu) with the input projection added. A
// block owns one m16 tile, kR = 16 batch rows, for all T steps, and has one
// warp per unit tile: warp q owns units 8q .. 8q+7, i.e. the n-tiles q,
// H/8 + q, 2H/8 + q and 3H/8 + q (the four gates of those units), so the
// mma accumulators of a lane hold all four gates of the same 2 rows x 2
// units, and c, the gate math and the bias stay in registers. Per step
//
//   z = [x_t | h_{t-1}] · [W_ih ; W_hh] + b      (the product from zero)
//
// runs as mma.sync m16n8k8 TF32 with float32 accumulate in the 3xTF32
// split x = hi + lo (tc_tf32.cuh; lo_a hi_W + hi_a lo_W + hi_a hi_W, which
// keeps float32 accuracy), k ascending over d and then over h, with b added
// last: the JAX kernel's order x W_ih + h W_hh + b. The warp's W_hh
// fragments, split once, sit in registers for the whole loop (2H a lane);
// its W_ih fragments, split once, sit in shared memory, one float4 {hi, hi,
// lo, lo} per (gate, k-step, lane), each lane reading back only its own
// (in registers they would cost 2D = 32 more a lane and, at H = 48, the
// second block an SM). h_t, split into hi/lo by the lanes that produce it,
// is written as one float4 {hi, hi, lo, lo} per unit pair into a
// double-buffered tile with a row stride of 16 mod 32 floats; x arrives by
// cp.async into a ring of three steps (t + 2 is copied while step t runs;
// zeros past B and T), rows of 8 mod 32 floats, and each warp splits the x
// fragments it reads. D = 4 fills half a k-step: the ring's columns 4..7
// and W_ih's fragment rows past D are zeros. ys, gates and cs are stored
// from the registers, a quad of lanes writing one row's 8 consecutive
// units. One __syncthreads a step. Activations: sigmoid_acc and tanh_acc
// (lstm_fused.cuh), each one expf and one correctly rounded reciprocal;
// never build with --use_fast_math: parity with the plain PyTorch version
// at 1e-5 rests on them. Registers: 132-150 at H = 32 (two blocks an SM;
// K3's budget of four spilled and was 6% slower), 168 at H = 48 (two; 4-12
// bytes of spills), 193-212 at H = 64.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, from
// grouptraj_torch/proj_times.py --kernel K5): 0.107 ms at the d-step shape
// against the float32-core design's 0.176-0.177, 1.65-1.97x at the four
// main shapes. There both products together cost ~0.023 ms (taken out:
// 0.084), the x product alone ~0.017, the activations ~0.011; what is
// left, 0.084 against 0.061 ms of bytes, is the stores and the step's
// barrier. Timed and not kept: W_ih's fragments in registers (spills at H
// = 48, 1.27x slower; with one block an SM, 1.37x), x split once a step
// into a shared tile, x_{t+1} W_ih issued during step t, separate x
// accumulators, W_ih raw and split on read.

#include "lstm_proj.cuh"
#include "tc_tf32.cuh"

namespace {

using namespace lstm_fused;
using namespace tc_tf32;

constexpr int kR = 16;       // batch rows a block: one m16 tile
constexpr int kStages = 3;   // x ring: steps t, t + 1, t + 2

template <int D, int H>
struct Fwd {
  static constexpr int G = 4 * H;           // gate columns
  static constexpr int KH = H / 8;          // k-steps over h
  static constexpr int KX = (D + 7) / 8;    // k-steps over x (D = 4: one)
  static constexpr int kWarps = H / 8;      // one per unit tile
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int SA = stride16(2 * H);  // floats a row of the h tile
  static constexpr int SX = stride8(8 * KX);  // floats a row of an x stage
  static constexpr int kChunks = kR * D / 4;  // 16-byte chunks of a stage
  static constexpr int kCopies = (kChunks + kThreads - 1) / kThreads;
  // dynamic shared memory: the double-buffered h tile, the ring of x
  // stages and the warps' split W_ih fragments
  static constexpr size_t smem = sizeof(float) * (2 * kR * SA +
                                                  kStages * kR * SX) +
                                 sizeof(float4) * kWarps * 4 * KX * 32;
  // blocks an SM that the register budget must allow (<= 170 registers a
  // thread at H = 48, 2H of them the W_hh fragments; at H = 32 <= 255: the
  // encoders' B = 4,096 is one wave at two blocks an SM, and K3's budget of
  // four spilled)
  static constexpr int kMinBlocks = H == 64 ? 1 : 2;
};

template <int D, int H, bool SAVE>
__global__ void __launch_bounds__(Fwd<D, H>::kThreads, Fwd<D, H>::kMinBlocks)
lstm_proj_fwd_kernel(const float* __restrict__ w_ih,
                     const float* __restrict__ w_hh,
                     const float* __restrict__ b,
                     const float* __restrict__ xs,
                     const float* __restrict__ h0,
                     const float* __restrict__ c0, float* __restrict__ ys,
                     float* __restrict__ hT, float* __restrict__ cT,
                     float* __restrict__ gates, float* __restrict__ cs, int T,
                     int B) {
  using F = Fwd<D, H>;
  constexpr int G = F::G, KH = F::KH, KX = F::KX, SA = F::SA, SX = F::SX;
  extern __shared__ __align__(16) float smem[];
  float* sh = smem;                  // [2][kR][SA]: split h_{t-1}, h_t
  float* sx = smem + 2 * kR * SA;    // [kStages][kR][SX]: x_s
  const int tid = threadIdx.x, lane = tid & 31, q = tid >> 5;
  // [4][KX][32] of warp q: its W_ih fragments, split
  float4* swi = reinterpret_cast<float4*>(sx + kStages * kR * SX) +
                q * 4 * KX * 32;

  const int gid = lane >> 2, tig = lane & 3;
  const int u = 8 * q + 2 * tig;                 // this lane's units u, u+1
  const int row0 = (int)blockIdx.x * kR;
  const int rows[2] = {row0 + gid, row0 + gid + 8};
  const bool live[2] = {rows[0] < B, rows[1] < B};

  // x_s of the block's rows into stage s % kStages by cp.async (zeros past
  // B and for s >= T), one commit group; thread tid copies chunks tid, tid +
  // kThreads, ... every step
  auto stage = [&](int s) {
    float* dst = sx + (s % kStages) * kR * SX;
#pragma unroll
    for (int k = 0; k < F::kCopies; ++k) {
      const int idx = tid + k * F::kThreads, r = idx / (D / 4);
      const int col = 4 * (idx % (D / 4));
      if (idx < F::kChunks) {
        const bool ok = row0 + r < B && s < T;
        const float* src =
            xs + (ok ? ((size_t)s * B + row0 + r) * D + col : 0);
        cp_async16(dst + r * SX + col, src, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  stage(0);
  stage(1);
  if (D % 8 != 0) {  // the ring's columns D .. 8 KX - 1, never copied to
    constexpr int P = 8 * KX - D;
    for (int i = tid; i < kStages * kR * P; i += F::kThreads)
      sx[(i / P) * SX + D + i % P] = 0.f;
  }

  // B fragments of n-tile (gate g, unit tile q) at k-step ks: b0 / b1 at
  // column g*H + 8q + gid, rows k = 8 ks + 2 tig and + 1 (the A fragment
  // takes the same permutation of k); W_ih's rows past D are zeros
  float wh[4][KH][2], wl[4][KH][2];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
#pragma unroll
    for (int ks = 0; ks < KH; ++ks)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float x = w_hh[(8 * ks + 2 * tig + p) * G + g * H + 8 * q + gid];
        wh[g][ks][p] = __uint_as_float(tf32(x));
        wl[g][ks][p] = __uint_as_float(tf32(x - wh[g][ks][p]));
      }
#pragma unroll
    for (int kx = 0; kx < KX; ++kx) {
      float x[2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int d = 8 * kx + 2 * tig + p;
        x[p] = d < D ? w_ih[d * G + g * H + 8 * q + gid] : 0.f;
      }
      swi[(g * KX + kx) * 32 + lane] = split2(x[0], x[1]);
    }
  }

  // Cell e of a lane: row rows[e / 2], unit u + e % 2, element e of the
  // mma accumulators. bias[g][p]: b at unit u + p.
  float c[4], h[4], bias[4][2];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int p = 0; p < 2; ++p) bias[g][p] = b[g * H + u + p];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t at = (size_t)rows[r] * H + u;
    float2 hv = make_float2(0.f, 0.f), cv = hv;
    if (live[r]) {
      hv = *reinterpret_cast<const float2*>(h0 + at);
      cv = *reinterpret_cast<const float2*>(c0 + at);
    }
    c[2 * r] = cv.x;
    c[2 * r + 1] = cv.y;
    *reinterpret_cast<float4*>(&sh[(gid + 8 * r) * SA + 2 * u]) =
        split2(hv.x, hv.y);
  }
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    stage(t + 2);   // into the stage that step t - 1 read
    const float* a = sh + (t & 1) * kR * SA;
    const float* xa = sx + (t % kStages) * kR * SX;
    float acc[4][4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
#pragma unroll
    for (int kx = 0; kx < KX; ++kx) {
      const float* xr = xa + gid * SX + 8 * kx + 2 * tig;
      const float2 x0 = *reinterpret_cast<const float2*>(xr);
      const float2 x1 = *reinterpret_cast<const float2*>(xr + 8 * SX);
      const float xv[4] = {x0.x, x1.x, x0.y, x1.y};
      uint32_t ah[4], al[4];
      split(xv, ah, al);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float4 wf = swi[(g * KX + kx) * 32 + lane];
        mma_tf32(acc[g], al, wf.x, wf.y);
        mma_tf32(acc[g], ah, wf.z, wf.w);
        mma_tf32(acc[g], ah, wf.x, wf.y);
      }
    }
#pragma unroll
    for (int ks = 0; ks < KH; ++ks) {
      const float* ar = a + gid * SA + 16 * ks + 4 * tig;
      const float4 x0 = *reinterpret_cast<const float4*>(ar);
      const float4 x1 = *reinterpret_cast<const float4*>(ar + 8 * SA);
      const uint32_t ah[4] = {__float_as_uint(x0.x), __float_as_uint(x1.x),
                              __float_as_uint(x0.y), __float_as_uint(x1.y)};
      const uint32_t al[4] = {__float_as_uint(x0.z), __float_as_uint(x1.z),
                              __float_as_uint(x0.w), __float_as_uint(x1.w)};
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        mma_tf32(acc[g], al, wh[g][ks][0], wh[g][ks][1]);
        mma_tf32(acc[g], ah, wl[g][ks][0], wl[g][ks][1]);
        mma_tf32(acc[g], ah, wh[g][ks][0], wh[g][ks][1]);
      }
    }
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] += bias[g][e & 1];

    float act[4][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      act[0][e] = sigmoid_acc(acc[0][e]);
      act[1][e] = sigmoid_acc(acc[1][e]);
      act[2][e] = tanh_acc(acc[2][e]);
      act[3][e] = sigmoid_acc(acc[3][e]);
      c[e] = act[1][e] * c[e] + act[0][e] * act[2][e];
      h[e] = act[3][e] * tanh_acc(c[e]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (live[r]) {
        const size_t at = (size_t)t * B + rows[r];
        *reinterpret_cast<float2*>(ys + at * H + u) =
            make_float2(h[2 * r], h[2 * r + 1]);
        if (SAVE) {
#pragma unroll
          for (int g = 0; g < 4; ++g)
            *reinterpret_cast<float2*>(gates + at * G + g * H + u) =
                make_float2(act[g][2 * r], act[g][2 * r + 1]);
          *reinterpret_cast<float2*>(cs + at * H + u) =
              make_float2(c[2 * r], c[2 * r + 1]);
        }
      }
      *reinterpret_cast<float4*>(
          &sh[((t + 1) & 1) * kR * SA + (gid + 8 * r) * SA + 2 * u]) =
          split2(h[2 * r], h[2 * r + 1]);
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();  // h_t and x_{t+1} are in, every read of h_{t-1} and
                      // x_t is done
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (live[r]) {
      const size_t at = (size_t)rows[r] * H + u;
      *reinterpret_cast<float2*>(hT + at) = make_float2(h[2 * r], h[2 * r + 1]);
      *reinterpret_cast<float2*>(cT + at) = make_float2(c[2 * r], c[2 * r + 1]);
    }
  }
}

template <int D, int H, bool SAVE>
cudaError_t launch(const float* w_ih, const float* w_hh, const float* b,
                   const float* xs, const float* h0, const float* c0,
                   float* ys, float* hT, float* cT, float* gates, float* cs,
                   int T, int B, cudaStream_t stream) {
  constexpr size_t smem = Fwd<D, H>::smem;
  auto kernel = lstm_proj_fwd_kernel<D, H, SAVE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(B + kR - 1) / kR, Fwd<D, H>::kThreads, smem, stream>>>(
      w_ih, w_hh, b, xs, h0, c0, ys, hT, cT, gates, cs, T, B);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// w_ih: [D, 4H]; w_hh: [H, 4H]; b: [4H]; xs: [T, B, D]; h0, c0: [B, H];
// ys: [T, B, H]; hT, cT: [B, H]; gates [T, B, 4H] and cs [T, B, H]: both
// given (the residuals are saved) or both null. All float32 and contiguous,
// xs, h0 and c0 at 16-byte aligned addresses (xs copied 16 bytes at a time,
// h0 and c0 read 8 bytes at a time at even offsets); T >= 1, B >= 1, D in
// {4, 8, 16}, H in {8, 16, 32, 48, 64}. Returns the CUDA error of the launch
// (0 = cudaSuccess).
int lstm_proj_fwd(const float* w_ih, const float* w_hh, const float* b,
                  const float* xs, const float* h0, const float* c0, float* ys,
                  float* hT, float* cT, float* gates, float* cs, int T, int B,
                  int D, int H, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (T < 1 || B < 1 || (gates == nullptr) != (cs == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool save = gates != nullptr;
  LSTM_PROJ_DISPATCH_D(
      D, LSTM_FUSED_DISPATCH_H(
             H, err = (save ? launch<kD, kH, true>(w_ih, w_hh, b, xs, h0, c0,
                                                   ys, hT, cT, gates, cs, T,
                                                   B, st)
                            : launch<kD, kH, false>(w_ih, w_hh, b, xs, h0, c0,
                                                    ys, hT, cT, gates, cs, T,
                                                    B, st))));
  return (int)err;
}

const char* lstm_proj_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
