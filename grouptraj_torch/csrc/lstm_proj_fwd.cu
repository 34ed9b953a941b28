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
// Bound on an H100. Operations: 2*T*B*(D + H)*4H multiply-adds' worth plus
// the gate math, float32 on the CUDA cores (67 TFLOP/s). Bytes: xs read, ys
// (and gates, cs) written once over 3.35 TB/s. Without residuals (serving,
// the d-step's generator encoder) it is operation-bound: the discriminator's
// encoder at T = 20, B = 8,192, D = 16, H = 48 needs 4.1 GFLOP (62 us)
// against 42 MB (13 us); with residuals the 157 MB of gates and cs bring the
// two bounds level.
//
// Design, right and simple first (no tensor cores). The tiling of
// lstm_fused.cuh (K3): one block owns 32 batch rows for all T steps, thread
// (rg, j) carries hidden unit j of four rows. W_hh and W_ih stay in shared
// memory for the whole loop, one float4 of the four gates per (k, j) and
// per (d, j); the block's h tile and x tile are double-buffered in shared
// memory, transposed and padded, so a thread reads its four rows' h[k] or
// x[d] with one broadcast 16-byte load. Each step the block stages x_{t+1}
// (32 rows x D, one coalesced read of contiguous memory) beside the product
// of step t, and one __syncthreads closes the step. Per k or d a thread
// makes two 16-byte shared loads for 16 explicit fmaf, d then k ascending,
// then adds b.

#include "lstm_proj.cuh"

namespace {

using namespace lstm_fused;
using namespace lstm_proj;

constexpr int kStride = kRows + 4;  // floats per k (or d) of a tile (padded)

template <int D, int H>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float4) * (H + D) * H + sizeof(float) * 2 * (H + D) * kStride;
}

// x_t of the block's rows into a transposed tile [d][row]; rows past B read
// as zeros (they are computed and never stored).
template <int D>
__device__ __forceinline__ void stage_x(float* dst, const float* __restrict__ x,
                                        int row_base, int B, int tid,
                                        int threads) {
  for (int idx = tid; idx < kRows * D; idx += threads) {
    const int r = idx / D, d = idx % D;
    dst[d * kStride + r] =
        row_base + r < B ? x[(size_t)row_base * D + idx] : 0.f;
  }
}

template <int D, int H, bool SAVE>
__global__ void __launch_bounds__(H* kGroups)
lstm_proj_fwd_kernel(const float* __restrict__ w_ih,
                     const float* __restrict__ w_hh,
                     const float* __restrict__ b,
                     const float* __restrict__ xs,
                     const float* __restrict__ h0,
                     const float* __restrict__ c0, float* __restrict__ ys,
                     float* __restrict__ hT, float* __restrict__ cT,
                     float* __restrict__ gates, float* __restrict__ cs, int T,
                     int B) {
  extern __shared__ float4 smem4[];
  float4* swh = smem4;                                     // [k][j] gates
  float4* swi = smem4 + H * H;                             // [d][j] gates
  float* sh = reinterpret_cast<float*>(swi + D * H);       // [2][k][row]
  float* sx = sh + 2 * H * kStride;                        // [2][d][row]

  constexpr int kThreads = H * kGroups;
  const int tid = threadIdx.x, j = tid % H, rg = tid / H;
  const int row_base = blockIdx.x * kRows;
  const int row0 = row_base + rg * kRowsPerThread;

  stage_gate_matrix<H>(swh, w_hh, tid, kThreads);
  stage_input_matrix<D, H>(swi, w_ih, tid, kThreads);
  stage_x<D>(sx, xs, row_base, B, tid, kThreads);

  float c[kRowsPerThread], h[kRowsPerThread], bias[4];
#pragma unroll
  for (int rr = 0; rr < kRowsPerThread; ++rr) {
    const int row = row0 + rr;
    const bool live = row < B;
    c[rr] = live ? c0[(size_t)row * H + j] : 0.f;
    h[rr] = live ? h0[(size_t)row * H + j] : 0.f;
  }
  *reinterpret_cast<float4*>(sh + j * kStride + rg * kRowsPerThread) =
      make_float4(h[0], h[1], h[2], h[3]);
#pragma unroll
  for (int g = 0; g < 4; ++g) bias[g] = b[g * H + j];
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* hcur = sh + (t & 1) * H * kStride;
    float* hnext = sh + ((t + 1) & 1) * H * kStride;
    const float* xcur = sx + (t & 1) * D * kStride;
    if (t + 1 < T)  // the other buffer was last read in step t - 1
      stage_x<D>(sx + ((t + 1) & 1) * D * kStride, xs + (size_t)(t + 1) * B * D,
                 row_base, B, tid, kThreads);

    float acc[kRowsPerThread][4];
#pragma unroll
    for (int rr = 0; rr < kRowsPerThread; ++rr)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[rr][g] = 0.f;

#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float4 wd = swi[d * H + j];
      const float4 xd4 = *reinterpret_cast<const float4*>(
          xcur + d * kStride + rg * kRowsPerThread);
      const float xd[kRowsPerThread] = {xd4.x, xd4.y, xd4.z, xd4.w};
#pragma unroll
      for (int rr = 0; rr < kRowsPerThread; ++rr) {
        acc[rr][0] = fmaf(xd[rr], wd.x, acc[rr][0]);
        acc[rr][1] = fmaf(xd[rr], wd.y, acc[rr][1]);
        acc[rr][2] = fmaf(xd[rr], wd.z, acc[rr][2]);
        acc[rr][3] = fmaf(xd[rr], wd.w, acc[rr][3]);
      }
    }
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const float4 wk = swh[k * H + j];
      const float4 hk4 = *reinterpret_cast<const float4*>(
          hcur + k * kStride + rg * kRowsPerThread);
      const float hk[kRowsPerThread] = {hk4.x, hk4.y, hk4.z, hk4.w};
#pragma unroll
      for (int rr = 0; rr < kRowsPerThread; ++rr) {
        acc[rr][0] = fmaf(hk[rr], wk.x, acc[rr][0]);
        acc[rr][1] = fmaf(hk[rr], wk.y, acc[rr][1]);
        acc[rr][2] = fmaf(hk[rr], wk.z, acc[rr][2]);
        acc[rr][3] = fmaf(hk[rr], wk.w, acc[rr][3]);
      }
    }

#pragma unroll
    for (int rr = 0; rr < kRowsPerThread; ++rr) {
      const int row = row0 + rr;
      const float gi = sigmoid_f(acc[rr][0] + bias[0]);
      const float gf = sigmoid_f(acc[rr][1] + bias[1]);
      const float gg = tanhf(acc[rr][2] + bias[2]);
      const float go = sigmoid_f(acc[rr][3] + bias[3]);
      c[rr] = gf * c[rr] + gi * gg;
      h[rr] = go * tanhf(c[rr]);
      if (row < B) {
        const size_t at = (size_t)t * B + row;
        ys[at * H + j] = h[rr];
        if (SAVE) {
          float* gt = gates + at * (4 * H) + j;
          gt[0] = gi;
          gt[H] = gf;
          gt[2 * H] = gg;
          gt[3 * H] = go;
          cs[at * H + j] = c[rr];
        }
      }
    }
    *reinterpret_cast<float4*>(hnext + j * kStride + rg * kRowsPerThread) =
        make_float4(h[0], h[1], h[2], h[3]);
    __syncthreads();  // h_t and x_{t+1} are whole; h_{t-1}, x_t are read
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerThread; ++rr) {
    const int row = row0 + rr;
    if (row < B) {
      hT[(size_t)row * H + j] = h[rr];
      cT[(size_t)row * H + j] = c[rr];
    }
  }
}

template <int D, int H, bool SAVE>
cudaError_t launch(const float* w_ih, const float* w_hh, const float* b,
                   const float* xs, const float* h0, const float* c0,
                   float* ys, float* hT, float* cT, float* gates, float* cs,
                   int T, int B, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D, H>();
  auto kernel = lstm_proj_fwd_kernel<D, H, SAVE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + kRows - 1) / kRows;
  kernel<<<blocks, H * kGroups, smem, stream>>>(w_ih, w_hh, b, xs, h0, c0, ys,
                                                hT, cT, gates, cs, T, B);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// w_ih: [D, 4H]; w_hh: [H, 4H]; b: [4H]; xs: [T, B, D]; h0, c0: [B, H];
// ys: [T, B, H]; hT, cT: [B, H]; gates [T, B, 4H] and cs [T, B, H]: both
// given (the residuals are saved) or both null. All float32 and contiguous;
// T >= 1, B >= 1, D in {4, 8, 16}, H in {8, 16, 32, 48, 64}. Returns the
// CUDA error of the launch (0 = cudaSuccess).
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
