// Social-pool pair core, forward (kernel K1 of the port).
//
// Replaces the TPU kernel grouptraj/ops/pallas_pool.py:_fwd_kernel
// (launched from _core_fwd, public pool_core_pallas). For every replica r,
// scene s and pedestrian i it computes
//
//   pooled[r,s,i,:] = max over valid j of relu(relu(a[r,s,j,:] - u[r,s,i,:]) @ W2[r] + b2[r])
//   cnt[r,s,i,:]    = number of valid j whose value equals that max
//
// with K-wide a/u (512 in the generator's pool) and any bottleneck B. The
// count is the residual the backward (K2) divides the cotangent by, so
// every tie counts, including the common ties at exactly 0 after the ReLU.
// A scene's extent n_s = last valid j + 1 bounds both loops: rows i >= n_s
// are written as zeros (callers re-mask invalid rows), invalid j below n_s
// are skipped, and pad scenes (n_s = 0) do no work.
//
// Bound on an H100: the pair work is n_pairs * K * (2 + 2B) operations in
// float32 on the CUDA cores (67 TFLOP/s) against reading a and u once
// (2 * S * N * K * 4 bytes at 3.35 TB/s). At S=64, N=64, K=512, B=8 with
// every pedestrian valid that is 2.4 GOP (36 us) against 16.8 MB (5 us):
// the kernel is bound by
// operations, and nothing of the [S, N, N, K] pair tensor ever reaches
// device memory.
//
// Design, right and simple first (no tensor cores yet): the tile layout,
// staging and inner product of pool_core.cuh, shared with the backward so
// that both compute bit-equal pair values. Per thread, a running
// (max, count) over its j; lanes then merge by shuffles:
// m = max(m1, m2), c = [m1 == m] c1 + [m2 == m] c2. Every pair sums over k
// in the same order wherever its j lands, so duplicate rows tie exactly.

#include "pool_core.cuh"

namespace {

using namespace pool_core;

template <typename W>
__global__ void __launch_bounds__(kThreads)
pool_core_fwd_kernel(const float* __restrict__ a, const float* __restrict__ u,
                     const W* __restrict__ w2, const W* __restrict__ b2,
                     const float* __restrict__ valid,
                     float* __restrict__ pooled, float* __restrict__ cnt,
                     int S, int N, int K, int B) {
  extern __shared__ float4 smem4[];
  const Smem sm = carve(reinterpret_cast<float*>(smem4), K);
  __shared__ int s_n;
  __shared__ float s_b[kBC];

  const int g = blockIdx.x;  // r * S + s
  const int r = g / S;
  const int i_tile = blockIdx.y * kRowsPerBlock;
  const int b0 = blockIdx.z * kBC;
  const int nb = min(kBC, B - b0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row0 = (size_t)g * N;

  const int n = scene_extent(valid + row0, sm.sv, &s_n, N);

  if (i_tile >= n) {  // the whole tile lies past the scene's extent
    const int rows = min(kRowsPerBlock, N - i_tile);
    for (int t = tid; t < rows * nb; t += kThreads) {
      const size_t o = (row0 + i_tile + t / nb) * B + b0 + t % nb;
      pooled[o] = 0.f;
      cnt[o] = 0.f;
    }
    return;
  }

  stage_weights(sm.sw, s_b, w2, b2, r, K, B, b0, nb);

  const int i0 = i_tile + warp * kRowsPerWarp;
  const bool warp_active = i0 < n;
  const Rows urow = warp_rows(u, row0, i0, N, K);

  float m[kRowsPerWarp][kBC], c[kRowsPerWarp][kBC];
#pragma unroll
  for (int ii = 0; ii < kRowsPerWarp; ++ii)
#pragma unroll
    for (int b = 0; b < kBC; ++b) {
      m[ii][b] = -INFINITY;
      c[ii][b] = 0.f;
    }

  for (int jc = 0; jc < n; jc += kJ) {
    __syncthreads();  // the previous chunk is consumed (and sw/s_b staged)
    stage_a(sm.sa, a + (row0 + jc) * K, min(kJ, n - jc), K);
    __syncthreads();
    const int j = jc + lane;
    if (!warp_active || j >= n || !(sm.sv[j] > 0.f)) continue;

    float o[kRowsPerWarp][kBC];
    pair_tile(o, sm.sa + lane * (K + kPad), sm.sw, s_b, urow, K);
#pragma unroll
    for (int ii = 0; ii < kRowsPerWarp; ++ii)
#pragma unroll
      for (int b = 0; b < kBC; ++b) {
        if (o[ii][b] > m[ii][b]) {
          m[ii][b] = o[ii][b];
          c[ii][b] = 1.f;
        } else if (o[ii][b] == m[ii][b]) {
          c[ii][b] += 1.f;
        }
      }
  }

  // merge the lanes' (max, count); lanes without a valid j hold (-inf, 0)
#pragma unroll
  for (int ii = 0; ii < kRowsPerWarp; ++ii)
#pragma unroll
    for (int b = 0; b < kBC; ++b) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[ii][b], off);
        const float co = __shfl_xor_sync(0xffffffffu, c[ii][b], off);
        const float mn = fmaxf(m[ii][b], mo);
        c[ii][b] = (m[ii][b] == mn ? c[ii][b] : 0.f) + (mo == mn ? co : 0.f);
        m[ii][b] = mn;
      }
    }

  if (lane == 0) {
#pragma unroll
    for (int ii = 0; ii < kRowsPerWarp; ++ii) {
      const int i = i0 + ii;
      if (i >= N) break;
      const bool live = i < n;
#pragma unroll
      for (int b = 0; b < kBC; ++b) {
        if (b >= nb) break;
        const size_t o = (row0 + i) * B + b0 + b;
        pooled[o] = live ? m[ii][b] : 0.f;
        cnt[o] = live ? c[ii][b] : 0.f;
      }
    }
  }
}

template <typename W>
cudaError_t launch(const float* a, const float* u, const void* w2,
                   const void* b2, const float* valid, float* pooled,
                   float* cnt, int R, int S, int N, int K, int B,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(N, K);
  auto kernel = pool_core_fwd_kernel<W>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(R * S, (N + kRowsPerBlock - 1) / kRowsPerBlock,
                  (B + kBC - 1) / kBC);
  kernel<<<grid, kThreads, smem, stream>>>(
      a, u, static_cast<const W*>(w2), static_cast<const W*>(b2), valid,
      pooled, cnt, S, N, K, B);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs at these sizes (the wrapper checks it
// against the card's limit before launching).
size_t pool_core_fwd_smem_bytes(int N, int K) { return smem_bytes(N, K); }

// a, u: [R*S, N, K] f32; w2: [R, K, B] and b2: [R, B], both f32 (w_bf16 = 0)
// or both bf16 (w_bf16 = 1); valid: [R*S, N] f32; pooled, cnt: [R*S, N, B]
// f32. All contiguous, K % 4 == 0, 16-byte aligned. Returns the CUDA error
// of the launch (0 = cudaSuccess).
int pool_core_fwd(const float* a, const float* u, const void* w2,
                  const void* b2, const float* valid, float* pooled,
                  float* cnt, int R, int S, int N, int K, int B, int w_bf16,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R * S == 0 || N == 0 || B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = w_bf16 ? launch<__nv_bfloat16>(a, u, w2, b2, valid, pooled, cnt, R,
                                       S, N, K, B, st)
               : launch<float>(a, u, w2, b2, valid, pooled, cnt, R, S, N, K,
                               B, st);
  return (int)err;
}

const char* pool_core_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
