// Social-pool pair core, backward (kernel K2 of the port).
//
// Replaces the TPU kernel grouptraj/ops/pallas_pool.py:_bwd_kernel
// (launched from _core_bwd, the custom VJP of pool_core_pallas). From the
// forward's inputs, its outputs pooled and cnt, and the cotangent dpool it
// computes, per replica r and scene s, with o[i,j,:] the pair value the
// forward maximised over j,
//
//   gd[i,b]   = dpool[i,b] / max(cnt[i,b], 1)        (ties share evenly)
//   dq[i,j,b] = gd[i,b] [o[i,j,b] == pooled[i,b]] [o > 0] valid_i valid_j
//   dz[i,j,k] = sum_b dq[i,j,b] W2[k,b] [a[j,k] - u[i,k] > 0]
//   da[j,k]   = sum_i dz[i,j,k]          du[i,k] = -sum_j dz[i,j,k]
//   dW2[k,b]  = sum_{s,i,j} relu(a[j,k] - u[i,k]) dq[i,j,b]
//   db2[b]    = sum_{s,i,j} dq[i,j,b]
//
// Rows at invalid i carry no gradient (the forward leaves them to the
// caller's re-mask, whose cotangent there is zero); this kernel drops them
// explicitly, so a dpool that is not zero there changes nothing.
//
// dq is sparse: for each (i, b) only the cnt[i,b] tying j are non-zero,
// usually one, and none where the max is the ReLU's 0. The TPU kernel
// multiplies the dense [TI*TJ, 128] dq block because its matrix unit makes
// that free; on CUDA cores the dense dq @ W2^T and h1^T dq would cost twice
// the forward on top of the recompute. So this design recomputes o, records
// WHICH j tie, and only then touches the K axis for those entries:
//
// 1. ties: the forward's grid and tile (pool_core.cuh, so o is bit-equal
//    to the forward's and the == test is exact). A thread that finds
//    o == pooled, o > 0 at valid i sets bit j of ties[g,i,b,:] and bit i of
//    tiesT[g,j,b,:] with atomicOr (exact in any order). It also recounts
//    every o == pooled, zeros included, which must equal the forward's cnt.
// 2. rows: one block per (scene, pedestrian, side). The du side walks the
//    set bits j of ties[g,i,:,:], the da side the set bits i of
//    tiesT[g,j,:,:]; each thread owns four k and adds gd W2[k,b] [z > 0] in
//    a fixed order (b, then partner ascending), reading W2 from a [B, K]
//    transpose the wrapper passes so that the loads are contiguous. Every
//    row is written, so rows without work come out as zeros.
// 3. weights: one block per (scene, b) sums relu(z) gd over the scene's
//    ties into a per-scene partial [g, b, K] (and the db2 partial); a last
//    kernel adds the S partials of each replica in scene order.
//
// No float atomics: every sum has a fixed order, so the result is the same
// from run to run.
//
// Bound on an H100: the recompute is the forward's n_pairs * K * (2 + 2B)
// float32 operations (67 TFLOP/s); the tie entries add ~6 K each, a few
// percent. The bytes are a, u, pooled, cnt, dpool read and da, du written
// once (4 * S * N * K * 4 bytes dominate) at 3.35 TB/s. At S=64, N=64,
// K=512, B=8 fully valid: 2.4 GOP (36 us) against 33.6 MB (10 us) -- bound
// by operations.

#include <stdint.h>

#include "pool_core.cuh"

namespace {

using namespace pool_core;

// ---------------------------------------------------------------- 1. ties

__global__ void __launch_bounds__(kThreads)
ties_kernel(const float* __restrict__ a, const float* __restrict__ u,
            const float* __restrict__ w2, const float* __restrict__ b2,
            const float* __restrict__ valid, const float* __restrict__ pooled,
            uint32_t* __restrict__ ties, uint32_t* __restrict__ tiesT,
            float* __restrict__ recount, int S, int N, int K, int B, int NW) {
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

  if (i_tile >= n) {  // past the extent: no ties (the bit sets start zeroed)
    if (recount != nullptr) {
      const int rows = min(kRowsPerBlock, N - i_tile);
      for (int t = tid; t < rows * nb; t += kThreads)
        recount[(row0 + i_tile + t / nb) * B + b0 + t % nb] = 0.f;
    }
    return;
  }

  stage_weights(sm.sw, s_b, w2, b2, r, K, B, b0, nb);

  const int i0 = i_tile + warp * kRowsPerWarp;
  const bool warp_active = i0 < n;
  const Rows urow = warp_rows(u, row0, i0, N, K);

  // the forward's max per (row, b); -1 where there is none, which no o >= 0
  // equals
  float p[kRowsPerWarp][kBC], c[kRowsPerWarp][kBC];
  bool vi[kRowsPerWarp];
#pragma unroll
  for (int ii = 0; ii < kRowsPerWarp; ++ii) {
    const int i = i0 + ii;
    vi[ii] = i < n && sm.sv[i] > 0.f;
#pragma unroll
    for (int b = 0; b < kBC; ++b) {
      p[ii][b] = (i < n && b < nb) ? __ldg(pooled + (row0 + i) * B + b0 + b)
                                   : -1.f;
      c[ii][b] = 0.f;
    }
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
        if (o[ii][b] != p[ii][b]) continue;
        c[ii][b] += 1.f;
        if (o[ii][b] > 0.f && vi[ii]) {
          const int i = i0 + ii;
          atomicOr(ties + ((row0 + i) * B + b0 + b) * NW + (j >> 5),
                   1u << (j & 31));
          atomicOr(tiesT + ((row0 + j) * B + b0 + b) * NW + (i >> 5),
                   1u << (i & 31));
        }
      }
  }

  if (recount == nullptr) return;
#pragma unroll
  for (int ii = 0; ii < kRowsPerWarp; ++ii)
#pragma unroll
    for (int b = 0; b < kBC; ++b)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        c[ii][b] += __shfl_xor_sync(0xffffffffu, c[ii][b], off);
  if (lane == 0) {
#pragma unroll
    for (int ii = 0; ii < kRowsPerWarp; ++ii) {
      const int i = i0 + ii;
      if (i >= N) break;
#pragma unroll
      for (int b = 0; b < kBC; ++b) {
        if (b >= nb) break;
        recount[(row0 + i) * B + b0 + b] = i < n ? c[ii][b] : 0.f;
      }
    }
  }
}

// ---------------------------------------------------------------- 2. rows

constexpr int kRowThreads = 128;

// side 0: du[g,row,:] from ties (partners are j); side 1: da[g,row,:] from
// tiesT (partners are i). Dynamic shared memory: B * NW words.
__global__ void __launch_bounds__(kRowThreads)
rows_kernel(const float* __restrict__ a, const float* __restrict__ u,
            const float* __restrict__ w2t, const float* __restrict__ cnt,
            const float* __restrict__ dpool,
            const uint32_t* __restrict__ ties,
            const uint32_t* __restrict__ tiesT, float* __restrict__ da,
            float* __restrict__ du, int S, int N, int K, int B, int NW) {
  extern __shared__ uint32_t s_bits[];  // [B][NW]
  const int g = blockIdx.x, row = blockIdx.y, side = blockIdx.z;
  const int r = g / S;
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)g * N;

  const uint32_t* bits = (side ? tiesT : ties) + (row0 + row) * B * NW;
  for (int t = tid; t < B * NW; t += kRowThreads) s_bits[t] = bits[t];
  __syncthreads();

  const float* own = (side ? a : u) + (row0 + row) * K;
  const float* others = (side ? u : a) + row0 * K;
  float* out = (side ? da : du) + (row0 + row) * K;
  const float* wt = w2t + (size_t)r * B * K;  // W2 transposed: [B][K]
  const float sign = side ? 1.f : -1.f;

  for (int k = tid * 4; k < K; k += kRowThreads * 4) {
    const float4 ov = *reinterpret_cast<const float4*>(own + k);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int b = 0; b < B; ++b)
      for (int w = 0; w < NW; ++w) {
        uint32_t word = s_bits[b * NW + w];
        while (word) {
          const int partner = w * 32 + __ffs(word) - 1;
          word &= word - 1;
          const int i = side ? partner : row;
          const size_t e = (row0 + i) * B + b;
          const float gd = sign * dpool[e] / fmaxf(cnt[e], 1.f);
          const float4 pv =
              *reinterpret_cast<const float4*>(others + (size_t)partner * K + k);
          // z = a_j - u_i: the own row is a_j on the da side, u_i on the du
          const float z[4] = {side ? ov.x - pv.x : pv.x - ov.x,
                              side ? ov.y - pv.y : pv.y - ov.y,
                              side ? ov.z - pv.z : pv.z - ov.z,
                              side ? ov.w - pv.w : pv.w - ov.w};
          const float4 wv =
              *reinterpret_cast<const float4*>(wt + (size_t)b * K + k);
          const float w[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            if (z[kk] > 0.f) acc[kk] += gd * w[kk];
        }
      }
    *reinterpret_cast<float4*>(out + k) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

// ------------------------------------------------------------- 3. weights

// One block per (scene g, column b): dw2p[g,b,:] and db2p[g,b]. Dynamic
// shared memory: N * NW words (the ties of column b, every row i).
__global__ void __launch_bounds__(kRowThreads)
weight_partials_kernel(const float* __restrict__ a, const float* __restrict__ u,
                       const float* __restrict__ cnt,
                       const float* __restrict__ dpool,
                       const uint32_t* __restrict__ ties,
                       float* __restrict__ dw2p, float* __restrict__ db2p,
                       int N, int K, int B, int NW) {
  extern __shared__ uint32_t s_bits[];  // [N][NW]
  const int g = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)g * N;

  for (int t = tid; t < N * NW; t += kRowThreads)
    s_bits[t] = ties[((row0 + t / NW) * B + b) * NW + t % NW];
  __syncthreads();

  float* out = dw2p + ((size_t)g * B + b) * K;
  for (int k = tid * 4; k < K; k += kRowThreads * 4) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < N; ++i) {
      float4 uv = make_float4(0.f, 0.f, 0.f, 0.f);
      float gd = 0.f;
      bool loaded = false;
      for (int w = 0; w < NW; ++w) {
        uint32_t word = s_bits[i * NW + w];
        while (word) {
          const int j = w * 32 + __ffs(word) - 1;
          word &= word - 1;
          if (!loaded) {
            const size_t e = (row0 + i) * B + b;
            gd = dpool[e] / fmaxf(cnt[e], 1.f);
            uv = *reinterpret_cast<const float4*>(u + (row0 + i) * K + k);
            loaded = true;
          }
          const float4 av =
              *reinterpret_cast<const float4*>(a + (row0 + j) * K + k);
          acc[0] += gd * fmaxf(av.x - uv.x, 0.f);
          acc[1] += gd * fmaxf(av.y - uv.y, 0.f);
          acc[2] += gd * fmaxf(av.z - uv.z, 0.f);
          acc[3] += gd * fmaxf(av.w - uv.w, 0.f);
        }
      }
    }
    *reinterpret_cast<float4*>(out + k) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }

  if (tid == 0) {
    float db = 0.f;
    for (int i = 0; i < N; ++i) {
      int hits = 0;
      for (int w = 0; w < NW; ++w) hits += __popc(s_bits[i * NW + w]);
      if (hits) {
        const size_t e = (row0 + i) * B + b;
        db += (float)hits * (dpool[e] / fmaxf(cnt[e], 1.f));
      }
    }
    db2p[(size_t)g * B + b] = db;
  }
}

// dw2[r,k,b] = sum_s dw2p[r*S+s,b,k] and db2[r,b] = sum_s db2p[r*S+s,b], in
// scene order. Grid (ceil(K / threads), B, R).
__global__ void __launch_bounds__(kRowThreads)
weight_reduce_kernel(const float* __restrict__ dw2p,
                     const float* __restrict__ db2p, float* __restrict__ dw2,
                     float* __restrict__ db2, int S, int K, int B) {
  const int k = blockIdx.x * kRowThreads + threadIdx.x;
  const int b = blockIdx.y, r = blockIdx.z;
  if (k < K) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s)
      acc += dw2p[(((size_t)r * S + s) * B + b) * K + k];
    dw2[((size_t)r * K + k) * B + b] = acc;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += db2p[((size_t)r * S + s) * B + b];
    db2[(size_t)r * B + b] = acc;
  }
}

}  // namespace

extern "C" {

// Shared memory one block of the ties pass needs (the forward's tile).
size_t pool_core_bwd_smem_bytes(int N, int K) { return smem_bytes(N, K); }

// Words of one tie bit set: ceil(N / 32).
int pool_core_bwd_tie_words(int N) { return (N + 31) / 32; }

// a, u, da, du: [R*S, N, K] f32; w2: [R, K, B], its transpose w2t:
// [R, B, K], b2: [R, B] f32; valid: [R*S, N] f32; pooled, cnt, dpool:
// [R*S, N, B] f32. Scratch from the caller: ties, tiesT [R*S, N, B, NW] uint32, ZEROED; dw2p [R*S, B, K] and
// db2p [R*S, B] f32 (unused when dw2 is null). dw2 [R, K, B] and db2 [R, B]
// may both be null: the weight gradients are then skipped. recount
// [R*S, N, B] f32 may be null. All contiguous, K % 4 == 0, 16-byte aligned.
// Returns the CUDA error of the first launch that failed (0 = cudaSuccess).
int pool_core_bwd(const float* a, const float* u, const float* w2,
                  const float* w2t, const float* b2, const float* valid,
                  const float* pooled,
                  const float* cnt, const float* dpool, uint32_t* ties,
                  uint32_t* tiesT, float* dw2p, float* db2p, float* da,
                  float* du, float* dw2, float* db2, float* recount, int R,
                  int S, int N, int K, int B, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R * S == 0 || N == 0 || B == 0 || K == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = R * S, NW = (N + 31) / 32;

  const size_t smem = smem_bytes(N, K);
  err = cudaFuncSetAttribute(
      ties_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ties_kernel<<<dim3(G, (N + kRowsPerBlock - 1) / kRowsPerBlock,
                     (B + kBC - 1) / kBC),
                kThreads, smem, st>>>(a, u, w2, b2, valid, pooled, ties, tiesT,
                                      recount, S, N, K, B, NW);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  rows_kernel<<<dim3(G, N, 2), kRowThreads, sizeof(uint32_t) * B * NW, st>>>(
      a, u, w2t, cnt, dpool, ties, tiesT, da, du, S, N, K, B, NW);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if (dw2 == nullptr) return 0;
  weight_partials_kernel<<<dim3(G, B), kRowThreads, sizeof(uint32_t) * N * NW,
                           st>>>(a, u, cnt, dpool, ties, dw2p, db2p, N, K, B,
                                 NW);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  weight_reduce_kernel<<<dim3((K + kRowThreads - 1) / kRowThreads, B, R),
                         kRowThreads, 0, st>>>(dw2p, db2p, dw2, db2, S, K, B);
  return (int)cudaGetLastError();
}

const char* pool_core_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
