// The pair tile both social-pool kernels compute: the forward (K1,
// pool_core_fwd.cu) and the backward's recompute (K2, pool_core_bwd.cu).
//
//   o[i, j, b] = relu(sum_k relu(a[j, k] - u[i, k]) * W2[k, b] + b2[b])
//
// The backward finds the j that reached the forward's max by testing
// o == pooled, so it must reproduce o bit for bit. Both kernels therefore
// take the tile layout, the staging and the inner product from this header:
// one subtraction, one fmaxf and one explicit fmaf per (k, b), k ascending
// from a zero accumulator, then one add of the bias and one fmaxf. Nothing
// is left for the compiler to contract or reorder, and a pair's value does
// not depend on the block, warp or lane its (i, j) lands in.
//
// Layout: one block of 4 warps per (replica*scene, 16-row i-tile, 8-column
// b-chunk); each warp owns 4 rows i, each lane one column j of a 32-wide
// j-chunk, so a thread holds a 4x8 tile of o. The block stages its W2 chunk
// (K x 8) and each a-chunk (32 x K, rows padded by 4 floats so 16-byte
// loads are free of bank conflicts) in shared memory; u rows are
// warp-uniform and come through the read-only cache as broadcasts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace pool_core {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kRowsPerWarp * kWarps;  // i-tile
constexpr int kJ = 32;                                 // j-chunk (one per lane)
constexpr int kBC = 8;                                 // b-chunk
constexpr int kPad = 4;                                // a-row padding (floats)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Dynamic shared memory of one block: [kJ][K + kPad] a-chunk, [K][kBC] W2
// chunk, [N] valid flags.
inline size_t smem_bytes(int N, int K) {
  return sizeof(float) * ((size_t)kJ * (K + kPad) + (size_t)K * kBC + N);
}

struct Smem {
  float* sa;  // [kJ][K + kPad]
  float* sw;  // [K][kBC]
  float* sv;  // [N]
};

__device__ __forceinline__ Smem carve(float* base, int K) {
  Smem s;
  s.sa = base;
  s.sw = s.sa + kJ * (K + kPad);
  s.sv = s.sw + K * kBC;
  return s;
}

// Copies the scene's valid flags to shared memory and returns its extent
// n = last valid j + 1 (0 for a pad scene). All threads of the block call
// it; it synchronises.
__device__ __forceinline__ int scene_extent(const float* __restrict__ valid_row,
                                            float* sv, int* s_n, int N) {
  const int tid = threadIdx.x;
  if (tid == 0) *s_n = 0;
  __syncthreads();
  for (int j = tid; j < N; j += kThreads) {
    const float v = valid_row[j];
    sv[j] = v;
    if (v > 0.f) atomicMax(s_n, j + 1);
  }
  __syncthreads();
  return *s_n;
}

// Stages columns [b0, b0 + nb) of replica r's W2 and b2 as float32, zero
// beyond nb. The caller synchronises before reading them.
template <typename W>
__device__ __forceinline__ void stage_weights(float* sw, float* s_b,
                                              const W* __restrict__ w2,
                                              const W* __restrict__ b2, int r,
                                              int K, int B, int b0, int nb) {
  const int tid = threadIdx.x;
  const W* wr = w2 + (size_t)r * K * B;
  for (int t = tid; t < K * kBC; t += kThreads) {
    const int k = t / kBC, c = t % kBC;
    sw[t] = c < nb ? to_f32(wr[(size_t)k * B + b0 + c]) : 0.f;
  }
  if (tid < kBC)
    s_b[tid] = tid < nb ? to_f32(b2[(size_t)r * B + b0 + tid]) : 0.f;
}

// Stages `rows` rows of a (from a_rows, K floats apart) into the padded
// chunk. The caller synchronises around it.
__device__ __forceinline__ void stage_a(float* sa,
                                        const float* __restrict__ a_rows,
                                        int rows, int K) {
  const int k4 = K / 4;
  for (int t = threadIdx.x; t < rows * k4; t += kThreads) {
    const int jj = t / k4, kk = t % k4;
    reinterpret_cast<float4*>(sa + jj * (K + kPad))[kk] =
        reinterpret_cast<const float4*>(a_rows + (size_t)jj * K)[kk];
  }
}

// The u rows of the warp's four pedestrians i.
struct Rows {
  const float* p[kRowsPerWarp];
};

// Rows i0 .. i0 + 3 of scene row0's u, clamped to the last row (rows past
// N are computed on a copy of row N - 1 and never stored).
__device__ __forceinline__ Rows warp_rows(const float* __restrict__ u,
                                          size_t row0, int i0, int N, int K) {
  Rows r;
#pragma unroll
  for (int ii = 0; ii < kRowsPerWarp; ++ii)
    r.p[ii] = u + (row0 + min(i0 + ii, N - 1)) * K;
  return r;
}

// o[ii][b] for this lane's column j (its staged row `aj`) against the
// warp's four rows i (`urow`), over the staged W2 chunk and bias.
__device__ __forceinline__ void pair_tile(float (&o)[kRowsPerWarp][kBC],
                                          const float* aj, const float* sw,
                                          const float* s_b, const Rows& urow,
                                          int K) {
  float acc[kRowsPerWarp][kBC];
#pragma unroll
  for (int ii = 0; ii < kRowsPerWarp; ++ii)
#pragma unroll
    for (int b = 0; b < kBC; ++b) acc[ii][b] = 0.f;

  const float4* aj4 = reinterpret_cast<const float4*>(aj);
  const float4* sw4 = reinterpret_cast<const float4*>(sw);
  const int k4 = K / 4;
  for (int kq = 0; kq < k4; ++kq) {
    const float4 av = aj4[kq];
    float w[4][kBC];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 lo = sw4[(4 * kq + kk) * 2];
      const float4 hi = sw4[(4 * kq + kk) * 2 + 1];
      w[kk][0] = lo.x; w[kk][1] = lo.y; w[kk][2] = lo.z; w[kk][3] = lo.w;
      w[kk][4] = hi.x; w[kk][5] = hi.y; w[kk][6] = hi.z; w[kk][7] = hi.w;
    }
#pragma unroll
    for (int ii = 0; ii < kRowsPerWarp; ++ii) {
      const float4 uv = __ldg(reinterpret_cast<const float4*>(urow.p[ii]) + kq);
      const float h[4] = {fmaxf(av.x - uv.x, 0.f), fmaxf(av.y - uv.y, 0.f),
                          fmaxf(av.z - uv.z, 0.f), fmaxf(av.w - uv.w, 0.f)};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int b = 0; b < kBC; ++b)
          acc[ii][b] = fmaf(h[kk], w[kk][b], acc[ii][b]);
    }
  }
#pragma unroll
  for (int ii = 0; ii < kRowsPerWarp; ++ii)
#pragma unroll
    for (int b = 0; b < kBC; ++b) o[ii][b] = fmaxf(acc[ii][b] + s_b[b], 0.f);
}

}  // namespace pool_core
