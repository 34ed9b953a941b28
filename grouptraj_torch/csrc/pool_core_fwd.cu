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
// Bound on an H100: the pair products are n_pairs * K * 2B operations. On
// the tensor cores in 3xTF32 (495 TFLOP/s, three passes for float32
// weights, two for bfloat16) beside the subtract, ReLU and split of every
// (pair, k) on the CUDA cores (67 TFLOP/s), against reading a and u once
// (2 * S * N * K * 4 bytes at 3.35 TB/s). At S=64, N=64, K=512 with every
// pedestrian valid that is 10 us of split and ReLU and 5 us of bytes
// against 13 us of mma at B=8 and 78 us at B=48: bound by the tensor
// cores. Nothing of the [S, N, N, K] pair tensor reaches device memory.
// In the bfloat16 mode (the TPU kernel's at JAX's default matmul
// precision: relu(a - u) and W2 rounded to bfloat16, float32 accumulate)
// the products are one pass at the bf16 rate (989 TFLOP/s) beside a
// subtract, ReLU and round per (pair, k): 2 us of mma at B=8 and 13 us at
// B=48 against 6 us of elementwise work and 5 us of bytes, so the CUDA
// cores bound it at B=8 and the tensor cores at B=48.
//
// Design (pool_core.cuh, shared with the backward so that both compute
// bit-equal pair values): one block of 16 warps per (replica*scene, 8-row
// i-tile) owns all B columns (up to 48; wider B launches again per 48
// columns), walks the scene's j in passes of 32 and K in chunks of 64
// (B <= 16, two blocks an SM) or 32 through a cp.async ring, and feeds
// mma.sync with A fragments it forms in registers. Each thread keeps a running (max, count) for its (i, b)
// positions over its warp's j; the 16 warps merge through shared
// memory: m = max over warps, c = sum of the c whose m equals it. Every
// (i, b) goes through the same sequence of products whatever its j, so
// duplicate rows tie exactly.

#include "pool_core.cuh"

namespace {

using namespace pool_core;

template <int NT, typename W, bool kBf16>
__global__ void __launch_bounds__(kThreads, min_blocks(NT))
pool_core_fwd_kernel(const float* __restrict__ a, const float* __restrict__ u,
                     const float* __restrict__ wf, const W* __restrict__ b2,
                     const float* __restrict__ valid,
                     float* __restrict__ pooled, float* __restrict__ cnt,
                     int S, int N, int K, int B, int col0) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* sv = ring + kStages * stage_floats(NT);
  __shared__ int s_n;
  __shared__ float s_b[8 * NT];

  const int g = blockIdx.x;  // r * S + s
  const int r = g / S;
  const int i_tile = blockIdx.y * kTI;
  const int b0 = col0 + blockIdx.z * kColsMax;
  const int nb = min(8 * NT, B - b0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row0 = (size_t)g * N;

  const int n = scene_extent(valid + row0, sv, &s_n, N);

  if (i_tile >= n) {  // the whole tile lies past the scene's extent
    const int rows = min(kTI, N - i_tile);
    for (int t = tid; t < rows * nb; t += kThreads) {
      const size_t o = (row0 + i_tile + t / nb) * B + b0 + t % nb;
      pooled[o] = 0.f;
      cnt[o] = 0.f;
    }
    return;
  }
  stage_bias<NT>(s_b, b2, r, B, b0, nb);

  // running (max, count) at (i_tile + lane / 4, 8t + 2 (lane % 4) + e)
  float mx[NT][2], c[NT][2];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx[t][e] = -INFINITY;
      c[t][e] = 0.f;
    }
  const int cb = 2 * (lane & 3);

  // a pass's sums -> its pair values -> the running (max, count)
  auto fold = [&](int pass, double (&acc)[NT][4]) {
    const int ja = pass * kJB + warp * kJW;
    const bool va = ja < n && sv[ja] > 0.f;
    const bool vb = ja + 1 < n && sv[ja + 1] > 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bias = s_b[8 * t + cb + e];
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // h = 0: j_a, h = 1: j_b
          if (!(h ? vb : va)) continue;
          const float o = pair_value(acc[t][2 * h + e], bias);
          if (o > mx[t][e]) {
            mx[t][e] = o;
            c[t][e] = 1.f;
          } else if (o == mx[t][e]) {
            c[t][e] += 1.f;
          }
        }
      }
  };
  pair_passes<NT, mode_of<W>(kBf16)>(
      a + row0 * K, u + row0 * K, wf + r * w_frag_floats(K, B), n, K,
      (B + 7) / 8, b0 / 8, i_tile, ring, fold);

  // merge the warps' (max, count) through the ring, now free
  float* mm = ring;                        // [kWarps][NT][32][2]
  float* mc = ring + kWarps * NT * 64;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int sl = ((warp * NT + t) * 32 + lane) * 2 + e;
      mm[sl] = mx[t][e];
      mc[sl] = c[t][e];
    }
  __syncthreads();
  for (int sl = tid; sl < NT * 64; sl += kThreads) {
    float M = -INFINITY, C = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, mm[w * NT * 64 + sl]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      C += mm[w * NT * 64 + sl] == M ? mc[w * NT * 64 + sl] : 0.f;
    const int ln = (sl >> 1) & 31;
    const int i = i_tile + (ln >> 2);
    const int col = 8 * (sl >> 6) + 2 * (ln & 3) + (sl & 1);
    if (i >= N || col >= nb) continue;
    const size_t o = (row0 + i) * B + b0 + col;
    pooled[o] = i < n ? M : 0.f;
    cnt[o] = i < n ? C : 0.f;
  }
}

template <typename W>
cudaError_t launch(const float* a, const float* u, const void* w2,
                   const void* b2, const float* valid, float* wf,
                   float* pooled, float* cnt, int R, int S, int N, int K,
                   int B, bool bf16, cudaStream_t stream) {
  cudaError_t err = bf16 ? split_w<W, true>(w2, wf, R, K, B, stream)
                         : split_w<W, false>(w2, wf, R, K, B, stream);
  if (err != cudaSuccess) return err;
  return for_column_launches(B, [&](auto nt, int col0, int groups) {
    constexpr int NT = decltype(nt)::value;
    auto kernel = bf16 ? pool_core_fwd_kernel<NT, W, true>
                       : pool_core_fwd_kernel<NT, W, false>;
    const size_t smem =
        sizeof(float) * (kStages * (size_t)stage_floats(NT) + N);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(R * S, (N + kTI - 1) / kTI, groups);
    kernel<<<grid, kThreads, smem, stream>>>(
        a, u, wf, static_cast<const W*>(b2), valid, pooled, cnt, S, N, K, B,
        col0);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// Shared memory one block needs at these sizes.
size_t pool_core_fwd_smem_bytes(int N, int B) { return smem_bytes(N, B); }

// Floats of the split-W2 scratch one replica needs.
size_t pool_core_w_frag_floats(int K, int B) { return w_frag_floats(K, B); }

// a, u: [R*S, N, K] f32; w2: [R, K, B] and b2: [R, B], both f32 (w_bf16 = 0)
// or both bf16 (w_bf16 = 1); valid: [R*S, N] f32; wf: scratch of
// R * pool_core_w_frag_floats(K, B) f32; pooled, cnt: [R*S, N, B] f32. All
// contiguous, K % 4 == 0, 16-byte aligned. bf16 = 1 selects the bfloat16
// mode of the product, 0 the float32-exact one. Returns the CUDA error of
// the first launch that failed (0 = cudaSuccess).
int pool_core_fwd(const float* a, const float* u, const void* w2,
                  const void* b2, const float* valid, float* wf,
                  float* pooled, float* cnt, int R, int S, int N, int K,
                  int B, int w_bf16, int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R * S == 0 || N == 0 || B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = w_bf16 ? launch<__nv_bfloat16>(a, u, w2, b2, valid, wf, pooled, cnt,
                                       R, S, N, K, B, bf16 != 0, st)
               : launch<float>(a, u, w2, b2, valid, wf, pooled, cnt, R, S, N,
                               K, B, bf16 != 0, st);
  return (int)err;
}

const char* pool_core_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
