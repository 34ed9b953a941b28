// The pair tile both social-pool kernels compute: the forward (K1,
// pool_core_fwd.cu) and the backward's recompute (K2, pool_core_bwd.cu).
//
//   o[i, j, b] = relu(sum_k relu(a[j, k] - u[i, k]) * W2[k, b] + b2[b])
//
// The backward finds the j that reached the forward's max by testing
// o == pooled, so it must reproduce o bit for bit. Both kernels therefore
// take the tile, the fragment mapping, the split and the k order from this
// header, and a pair's value does not depend on the block or warp its j
// lands in: for a given (i, b) the pair sits in row i % 8 (j even) or
// 8 + i % 8 (j odd) and column b % 8 of the same sequence of m16n8
// products, and the tensor cores compute every row of a product alike
// (chip_smoke's duplicate_rows case ties j of both parities).
//
// The pair product runs on the tensor cores (mma.sync m16n8k8, TF32 in,
// float32 out). The m16 rows of one mma are 8 rows i (the block's
// i-tile) against two columns j (rows 0-7: i against j_a, rows 8-15: i
// against j_b); the n8 columns are 8 columns b. The A operand
// relu(a[j, k] - u[i, k]) is formed in registers straight in the fragment
// layout, once per (pair, k) for every column of the bottleneck: a block
// owns up to 48 columns (6 n-tiles) at once, B is padded to a multiple of 8
// with zero weights, and the padded columns are never stored.
//
// Float32 accuracy from TF32 tensor cores (3xTF32): x = hi + lo with
// hi = tf32(x), lo = tf32(x - hi) (round to nearest, ties away). Each
// k-step sums lo_a*hi_w, hi_a*lo_w, hi_a*hi_w, in this order, from zero on
// the tensor cores, and that 8-k partial joins the pair's running sum in
// float64; the bias is added there and the pair rounded to float32 once.
// The tensor cores' own accumulation truncates: over all of K it costs
// several times float32's rounding error, and a float32 running sum still
// ~10 ulp at worst, enough to merge two maxima 2 ulp apart into a tie the
// exact values do not have. (A float pair summed by TwoSum, as accurate,
// was 1.2x slower: the tile is bound by instruction issue, and it takes
// six float32 adds where float64 takes a conversion and an add.) bfloat16
// weights fit in TF32 (lo_w = 0), so that pass is skipped.
// mma.sync rather than wgmma: B is 8..48 wide, the A operand is computed
// per element, and a 16-row tile keeps its generation in registers simple.
// A warp holds one m16 tile (two j) for all 48 columns: 24 float64
// accumulators and the running (max, count) fit in 128 registers.
//
// Staging: W2 is split once per call, by split_w_kernel, into hi/lo
// fragments in the order the mma reads them ([K/8][B/8][32 lanes][4]). The
// block of 16 warps then walks (pass of 32 j) x (chunk of 64 k for
// B <= 16, 32 k above) steps through a three-stage ring in shared memory:
// a (the pass's 32 rows j), u (the tile's 8 rows i) and the chunk's W
// fragments all arrive by
// cp.async (a and u zero-filled past K and past the scene's extent), two
// steps ahead of the products that read them. One __syncthreads per step.
// In shared memory a k-step's 8 values k0 + {2t, 2t + 1} sit side by side
// (float2 loads): the k order inside a step is a relabelling that A and W
// share, the same in both kernels.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "tc_tf32.cuh"

namespace pool_core {

using namespace tc_tf32;

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kTI = 8;                  // rows i per block (the i-tile)
constexpr int kJW = 2;                  // j per warp and pass: one m16 tile
constexpr int kJB = kJW * kWarps;       // j per pass (32)
constexpr int kKCMax = 64;              // k per chunk, at most
constexpr int kNTMax = 6;               // n-tiles (8 columns) per block
constexpr int kColsMax = 8 * kNTMax;    // B <= 48 in one pass
constexpr int kSlot = 4;                // floats per lane and W fragment:
                                        // hi b0, hi b1, lo b0, lo b1
constexpr int kStages = 3;              // ring depth

// A tile of nt n-tiles. Narrow tiles (B <= 16) have few products per
// k-step: they take 64 k per chunk (half the syncs and copy round trips of
// 32) and are compiled for two resident blocks (64 registers a thread), so
// one block's wait overlaps the other's products. Wide tiles take 32 k, so
// their W fragments fit the stage, and hold one block of 128 registers.
// The chunking changes no value: a pair sums the same 8-k steps in the
// same order.
__host__ __device__ constexpr int chunk_k(int nt) { return nt <= 2 ? 64 : 32; }
__host__ __device__ constexpr int min_blocks(int nt) { return nt <= 2 ? 2 : 1; }
// staged row stride in floats: float2 loads free of bank conflicts
__host__ __device__ constexpr int row_stride(int nt) { return chunk_k(nt) + 8; }

// floats of one ring stage: a [kJB][row], u [kTI][row], W fragments
__host__ __device__ constexpr int stage_floats(int nt) {
  return (kJB + kTI) * row_stride(nt) + chunk_k(nt) / 8 * nt * 32 * kSlot;
}

// Dynamic shared memory of the largest block of the launches that cover B
// columns (for_column_launches): the ring (reused for the merge over warps
// at the end) and the scene's N valid flags.
inline size_t smem_bytes(int N, int B) {
  int ring = B >= kColsMax ? stage_floats(kNTMax) : 0;
  if (B % kColsMax) ring = std::max(ring, stage_floats((B % kColsMax + 7) / 8));
  return sizeof(float) * (kStages * (size_t)ring + N);
}

// mma k-steps of K padded to whole chunks of kKCMax (at least one): every
// chunk size reads its W fragments in bounds
__host__ __device__ inline int k_steps(int K) {
  return (K > 0 ? (K + kKCMax - 1) / kKCMax : 1) * (kKCMax / 8);
}

// floats of one replica's split W2 fragments: k_steps x ceil(B / 8)
// n-tiles x 32 lanes x kSlot
__host__ __device__ inline size_t w_frag_floats(int K, int B) {
  return (size_t)k_steps(K) * ((B + 7) / 8) * 32 * kSlot;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Copies the scene's valid flags to shared memory and returns its extent
// n = last valid j + 1 (0 for a pad scene). All threads of the block call
// it; it synchronises.
__device__ __forceinline__ int scene_extent(const float* __restrict__ valid_row,
                                            float* sv, int* s_n, int N) {
  const int tid = threadIdx.x;
  if (tid == 0) *s_n = 0;
  __syncthreads();
  for (int j = tid; j < N; j += blockDim.x) {
    const float v = valid_row[j];
    sv[j] = v;
    if (v > 0.f) atomicMax(s_n, j + 1);
  }
  __syncthreads();
  return *s_n;
}

// Columns [b0, b0 + nb) of replica r's b2 as float32, zero up to 8 * NT.
// Read after the next __syncthreads.
template <int NT, typename W>
__device__ __forceinline__ void stage_bias(float* s_b, const W* __restrict__ b2,
                                           int r, int B, int b0, int nb) {
  const int tid = threadIdx.x;
  if (tid < 8 * NT)
    s_b[tid] = tid < nb ? to_f32(b2[(size_t)r * B + b0 + tid]) : 0.f;
}

// W2 [R, K, B] (float32 or bfloat16) -> wf [R][KS][T][32][kSlot], KS =
// padded K / 8 k-steps, T = ceil(B / 8) n-tiles: for k-step ks, n-tile t
// and lane, {hi b0, hi b1, lo b0, lo b1} of the B fragment, b0 / b1 at
// k = 8 ks + 2 (lane % 4) + {0, 1}, column 8 t + lane / 4; zeros past K
// and B. hi = tf32(w), lo = tf32(w - hi) (0 for bfloat16, exact in TF32).
template <typename W>
__global__ void __launch_bounds__(256)
split_w_kernel(const W* __restrict__ w2, float* __restrict__ wf, int R,
               int K, int B, int KS, int T) {
  const size_t total = (size_t)R * KS * T * 64;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int half = (int)(e & 1), lane = (int)((e >> 1) & 31);
    size_t q = e >> 6;
    const int t = (int)(q % T);
    q /= T;
    const int ks = (int)(q % KS), r = (int)(q / KS);
    const int k = 8 * ks + 2 * (lane & 3) + half, col = 8 * t + (lane >> 2);
    const float w =
        (k < K && col < B) ? to_f32(w2[((size_t)r * K + k) * B + col]) : 0.f;
    const uint32_t hi = tf32(w);
    float* slot = wf + (e >> 1) * kSlot;
    slot[half] = __uint_as_float(hi);
    slot[2 + half] = __uint_as_float(tf32(w - __uint_as_float(hi)));
  }
}

// Launches split_w_kernel for all R replicas (wf holds R * w_frag_floats).
template <typename W>
cudaError_t split_w(const void* w2, float* wf, int R, int K, int B,
                    cudaStream_t stream) {
  const int KS = k_steps(K);
  const size_t total = (size_t)R * KS * ((B + 7) / 8) * 64;
  const int blocks = (int)((total + 255) / 256 < 1024 ? (total + 255) / 256
                                                       : 1024);
  split_w_kernel<W><<<blocks, 256, 0, stream>>>(static_cast<const W*>(w2), wf,
                                                R, K, B, KS, (B + 7) / 8);
  return cudaGetLastError();
}

// One step's cp.async into stage `st`: the pass's a rows j0 .. j0 + 31 and
// the tile's u rows i0 .. i0 + 7, columns k0 .. k0 + chunk_k(NT) - 1 (rows
// at or past the extent n and columns past K arrive as zeros:
// relu(0 - 0) = 0), and the chunk's k-steps' W fragments of n-tiles
// t0 .. t0 + NT - 1 of the replica's wf (T n-tiles a k-step).
template <int NT>
__device__ __forceinline__ void issue_step(float* st, const float* __restrict__ a,
                                           const float* __restrict__ u,
                                           const float* __restrict__ wf,
                                           int j0, int i0, int n, int k0,
                                           int K, int T, int t0) {
  constexpr int kSeg = chunk_k(NT) / 4, kRow = row_stride(NT);
  for (int q = threadIdx.x; q < (kJB + kTI) * kSeg; q += kThreads) {
    const int row = q / kSeg, k = k0 + 4 * (q % kSeg);
    const bool is_a = row < kJB;
    const int x = is_a ? j0 + row : i0 + row - kJB;
    const bool ok = x < n && k < K;
    cp_async16(st + row * kRow + (k - k0),
               (is_a ? a : u) + (ok ? (size_t)x * K + k : 0), ok);
  }
  float* sw = st + (kJB + kTI) * kRow;
  const int ks0 = k0 / 8;
  for (int q = threadIdx.x; q < chunk_k(NT) / 8 * NT * 32; q += kThreads) {
    const int s = q / (NT * 32), rem = q % (NT * 32);
    cp_async16(sw + (s * NT * 32 + rem) * kSlot,
               wf + (((size_t)(ks0 + s) * T + t0) * 32 + rem) * kSlot, true);
  }
}

// The products of one staged chunk into the warp's accumulators.
// The warp's m-tile of the chunk: acc[t] holds the float64 sums of rows
// (i, j_a) / (i, j_b), j_a = the warp's first j of the pass, j_b = j_a + 1,
// and columns 8t .. 8t + 7, in the C fragment's order.
template <int NT, bool kSplitW>
__device__ __forceinline__ void chunk_mma(double (&acc)[NT][4],
                                          const float* st, int warp,
                                          int lane) {
  constexpr int kKS = chunk_k(NT) / 8, kRow = row_stride(NT);
  const float* sa = st + warp * kJW * kRow;
  const float* su = st + kJB * kRow;
  const float* sw = st + (kJB + kTI) * kRow;
  const int gid = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
  for (int s = 0; s < kKS; ++s) {
    const float2 uv =
        *reinterpret_cast<const float2*>(su + gid * kRow + 8 * s + c);
    const float2 av = *reinterpret_cast<const float2*>(sa + 8 * s + c);
    const float2 bv = *reinterpret_cast<const float2*>(sa + kRow + 8 * s + c);
    // A fragment: a0 (i, j_a, k), a1 (i, j_b, k), a2 (i, j_a, k'),
    // a3 (i, j_b, k') with k, k' the thread's pair of k
    const float x[4] = {fmaxf(av.x - uv.x, 0.f), fmaxf(bv.x - uv.x, 0.f),
                        fmaxf(av.y - uv.y, 0.f), fmaxf(bv.y - uv.y, 0.f)};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[e] = tf32(x[e]);
      lo[e] = tf32(x[e] - __uint_as_float(hi[e]));
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float* slot = sw + ((s * NT + t) * 32 + lane) * kSlot;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      if (kSplitW) {
        const float4 w = *reinterpret_cast<const float4*>(slot);
        mma_tf32(d, lo, w.x, w.y);
        mma_tf32(d, hi, w.z, w.w);
        mma_tf32(d, hi, w.x, w.y);
      } else {  // bfloat16 weights: lo_w = 0
        const float2 w = *reinterpret_cast<const float2*>(slot);
        mma_tf32(d, lo, w.x, w.y);
        mma_tf32(d, hi, w.x, w.y);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] += (double)d[e];
    }
  }
}

// The pair value from its float64 sum: one rounding, then the ReLU.
__device__ __forceinline__ float pair_value(double sum, float bias) {
  return fmaxf((float)(sum + (double)bias), 0.f);
}

// Every pair of the block's i-tile (rows i_tile .. i_tile + 7) with every j
// below the extent n, over all K, for n-tiles t0 .. t0 + NT - 1 of the
// replica's split W2 fragments wf (T n-tiles a k-step). After each pass of
// 32 j, epi(pass, acc) sees the pre-bias float64 sums; the accumulators
// then restart from zero. `ring` holds kStages * stage_floats(NT) floats; on
// return every thread is past its last read of it.
template <int NT, bool kSplitW, typename Epi>
__device__ __forceinline__ void pair_passes(const float* __restrict__ a,
                                            const float* __restrict__ u,
                                            const float* __restrict__ wf,
                                            int n, int K, int T, int t0,
                                            int i_tile, float* ring, Epi&& epi) {
  constexpr int kStage = stage_floats(NT);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kKC = chunk_k(NT);
  const int nchunk = max(1, (K + kKC - 1) / kKC);
  const int nsteps = (n + kJB - 1) / kJB * nchunk;

  double acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.0;

  auto issue = [&](int step) {  // one commit group per step, empty past the end
    if (step < nsteps) {
      const int c = step % nchunk;
      issue_step<NT>(ring + (step % kStages) * kStage, a, u, wf,
                     step / nchunk * kJB, i_tile, n, c * kKC, K, T, t0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  issue(0);
  issue(1);
  for (int step = 0; step < nsteps; ++step) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();  // this step's stage is in; step - 1's is free again
    issue(step + 2);
    // a warp whose j_a lies at or past the extent skips the products
    // (warp-uniform); its pairs are never read
    if (step / nchunk * kJB + warp * kJW < n)
      chunk_mma<NT, kSplitW>(acc, ring + (step % kStages) * kStage, warp,
                             lane);
    if ((step + 1) % nchunk == 0) {
      epi(step / nchunk, acc);
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.0;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// Calls f(std::integral_constant<int, NT>{}, col0, groups) for every launch
// that covers B columns: groups of 48 columns with NT = 6, then one group
// for the remaining B % 48 columns with the n-tiles they need. Returns the
// first error.
template <typename F>
cudaError_t for_column_launches(int B, F&& f) {
  const int full = B / kColsMax, rest = B % kColsMax;
  cudaError_t err = cudaSuccess;
  if (full) err = f(std::integral_constant<int, kNTMax>{}, 0, full);
  if (err != cudaSuccess || rest == 0) return err;
  const int col0 = full * kColsMax;
  switch ((rest + 7) / 8) {
    case 1: return f(std::integral_constant<int, 1>{}, col0, 1);
    case 2: return f(std::integral_constant<int, 2>{}, col0, 1);
    case 3: return f(std::integral_constant<int, 3>{}, col0, 1);
    case 4: return f(std::integral_constant<int, 4>{}, col0, 1);
    case 5: return f(std::integral_constant<int, 5>{}, col0, 1);
    default: return f(std::integral_constant<int, 6>{}, col0, 1);
  }
}

}  // namespace pool_core
