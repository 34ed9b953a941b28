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
// that free; here the dense dq @ W2^T and h1^T dq would cost twice the
// forward on top of the recompute. So this design recomputes o, records
// WHICH j tie, and only then touches the K axis for those entries:
//
// 0. split_w_kernel (pool_core.cuh): W2 into the hi/lo fragments of the
//    tile, as the forward does.
// 1. ties: the forward's grid and tile (pool_core.cuh, so o is bit-equal
//    to the forward's and the == test is exact). A thread that finds
//    o == pooled, o > 0 at valid i sets bit j of ties[g,i,b,:] and bit i of
//    tiesT[g,j,b,:] with atomicOr (exact in any order). It also recounts
//    every o == pooled, zeros included, which must equal the forward's cnt.
// 2. tie_grads: one block of 16 warps per (scene, 128 k) stages the
//    scene's a and u rows, W2's columns and gd in shared memory (a scene
//    too wide for it, N > 164 at B=48, reads them from L2 instead) and
//    walks the scene's set bits: du rows over ties (b, then j ascending), da
//    rows over tiesT (b, then i ascending), and per column b the scene's
//    partial dW2 and db2 (i, then j ascending). Every row is written, so
//    rows without work come out as zeros.
// 3. weight_reduce: the S partials of each replica added in scene order.
//
// No float atomics: every sum has a fixed order, so the result is the same
// from run to run.
//
// The bfloat16 mode (the TPU kernel's at JAX's default matmul precision)
// splits W2 and runs the ties pass in K1's bfloat16 mode (pool_core.cuh),
// so the == test stays exact, and tie_grads rounds gd (the entries of dq),
// W2 and relu(a - u) to bfloat16 before its multiply-adds, as the TPU
// kernel rounds dq, W2 and h1 in dh1 = dq W2^T and dW2 = h1^T dq. A product
// of two bfloat16 values is exact in float32, so only the order of the
// sums differs from it; db2 sums the unrounded gd, dz stays float32.
//
// Bound on an H100: the recompute is the forward's (pool_core_fwd.cu: the
// pair products in 3xTF32 on the tensor cores beside the subtract, ReLU and
// split of every (pair, k) on the CUDA cores); the tie entries add ~6 K
// float32 operations each, a few percent. The bytes are a, u, pooled, cnt,
// dpool read and da, du written once (4 * S * N * K * 4 bytes dominate) at
// 3.35 TB/s. At S=64, N=64, K=512 fully valid: 10 us of split and ReLU and
// 34 MB (10 us) against 13 us of mma at B=8 and 78 us at B=48 -- bound by
// the tensor cores.

#include <stdint.h>

#include "pool_core.cuh"

namespace {

using namespace pool_core;

// ---------------------------------------------------------------- 1. ties

// The forward's blocks and tile (pool_core.cuh), f32 weights only, in the
// forward's mode.
template <int NT, bool kBf16>
__global__ void __launch_bounds__(kThreads, min_blocks(NT))
ties_kernel(const float* __restrict__ a, const float* __restrict__ u,
            const float* __restrict__ wf, const float* __restrict__ b2,
            const float* __restrict__ valid, const float* __restrict__ pooled,
            uint32_t* __restrict__ ties, uint32_t* __restrict__ tiesT,
            float* __restrict__ recount, int S, int N, int K, int B, int NW,
            int col0) {
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

  if (i_tile >= n) {  // past the extent: no ties (the bit sets start zeroed)
    if (recount != nullptr) {
      const int rows = min(kTI, N - i_tile);
      for (int t = tid; t < rows * nb; t += kThreads)
        recount[(row0 + i_tile + t / nb) * B + b0 + t % nb] = 0.f;
    }
    return;
  }
  stage_bias<NT>(s_b, b2, r, B, b0, nb);

  // the forward's max at (i, 8t + cb + e); -1 where there is none, which no
  // o >= 0 equals
  const int i = i_tile + (lane >> 2), cb = 2 * (lane & 3);
  const bool vi = i < n && sv[i] > 0.f;
  float p[NT][2], c[NT][2];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * t + cb + e;
      p[t][e] = (i < n && col < nb) ? __ldg(pooled + (row0 + i) * B + b0 + col)
                                    : -1.f;
      c[t][e] = 0.f;
    }

  // a pass's sums -> its pair values -> the recount and the tie bits
  auto match = [&](int pass, double (&acc)[NT][4]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // h = 0: j_a, h = 1: j_b
      const int j = pass * kJB + warp * kJW + h;
      if (!(j < n && sv[j] > 0.f)) continue;
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * t + cb + e;
          const float o = pair_value(acc[t][2 * h + e], s_b[col]);
          if (o != p[t][e]) continue;
          c[t][e] += 1.f;
          if (o > 0.f && vi) {
            atomicOr(ties + ((row0 + i) * B + b0 + col) * NW + (j >> 5),
                     1u << (j & 31));
            atomicOr(tiesT + ((row0 + j) * B + b0 + col) * NW + (i >> 5),
                     1u << (i & 31));
          }
        }
    }
  };
  pair_passes<NT, mode_of<float>(kBf16)>(a + row0 * K, u + row0 * K,
                                         wf + r * w_frag_floats(K, B), n, K,
                                         (B + 7) / 8, b0 / 8, i_tile, ring,
                                         match);

  if (recount == nullptr) return;
  // sum the warps' counts through the ring, now free, in warp order
  float* mc = ring;  // [kWarps][NT][32][2]
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      mc[((warp * NT + t) * 32 + lane) * 2 + e] = c[t][e];
  __syncthreads();
  for (int sl = tid; sl < NT * 64; sl += kThreads) {
    float C = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) C += mc[w * NT * 64 + sl];
    const int ln = (sl >> 1) & 31;
    const int ii = i_tile + (ln >> 2);
    const int col = 8 * (sl >> 6) + 2 * (ln & 3) + (sl & 1);
    if (ii < N && col < nb)
      recount[(row0 + ii) * B + b0 + col] = ii < n ? C : 0.f;
  }
}

// ------------------------------------------------- 2. the tie entries

constexpr int kRowThreads = 128;        // weight_reduce_kernel
constexpr int kGradThreads = 512;
constexpr int kGradWarps = kGradThreads / 32;
constexpr int kGradK = 4 * 32;          // k per block: four per lane
constexpr size_t kGradSmemMax = 220 * 1024;  // staged rows up to this; the
                                             // H100 gives a block 227 KB

// Dynamic shared memory of tie_grads_kernel with the scene staged: its a
// and u rows and W2's columns for the block's 128 k, gd per (i, b), the
// valid flags.
inline size_t grads_staged_bytes(int N, int B) {
  return sizeof(float) *
         ((size_t)2 * N * kGradK + (size_t)B * kGradK + (size_t)N * B + N);
}

// Whether a block stages the scene (it fits in kGradSmemMax); otherwise it
// reads the rows, W2 and gd from device memory, with the same sums in the
// same order.
inline bool grads_staged(int N, int B) {
  return grads_staged_bytes(N, B) <= kGradSmemMax;
}

inline size_t grads_smem_bytes(int N, int B) {
  return grads_staged(N, B) ? grads_staged_bytes(N, B) : sizeof(float) * N;
}

// The scene's tie entries for k = 128 * blockIdx.y + 4 * lane .. + 3, in
// three walks over the bit sets, rows and columns spread over 16 warps:
//   du[i] = sum over b, then j ascending in ties[i, b], of
//           -gd[i, b] W2[k, b] [a_j - u_i > 0]
//   da[j] = sum over b, then i ascending in tiesT[j, b], of
//           gd[i, b] W2[k, b] [a_j - u_i > 0]
//   dw2p[g, b] = sum over i, then j ascending, of gd[i, b] relu(a_j - u_i)
//   db2p[g, b] = sum over i of (ties of (i, b)) gd[i, b]   (blockIdx.y == 0)
// with gd = dpool / max(cnt, 1); with kBf16 gd, W2 and relu(a_j - u_i)
// are rounded to bfloat16 in the sums of du, da and dw2p (not in db2p).
// With kStaged the block first copies the
// scene's rows below its extent, W2's columns and gd to shared memory, so
// an entry costs shared loads only; scenes too wide for that read them
// from device memory (L2) instead. A warp fetches 32 bit-set words at once
// (a lane each) and walks the non-zero ones in order by ballot and
// shuffle. Every row below N is written (zeros where there is no entry);
// the weight walk is skipped when dw2p is null.
template <bool kStaged, bool kBf16>
__global__ void __launch_bounds__(kGradThreads)
tie_grads_kernel(const float* __restrict__ a, const float* __restrict__ u,
                 const float* __restrict__ w2t, const float* __restrict__ valid,
                 const float* __restrict__ cnt, const float* __restrict__ dpool,
                 const uint32_t* __restrict__ ties,
                 const uint32_t* __restrict__ tiesT, float* __restrict__ da,
                 float* __restrict__ du, float* __restrict__ dw2p,
                 float* __restrict__ db2p, int S, int N, int K, int B,
                 int NW) {
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);  // [N][kGradK] (kStaged)
  float* u_s = a_s + (size_t)N * kGradK;         // [N][kGradK]
  float* w_s = u_s + (size_t)N * kGradK;         // [B][kGradK]
  float* gd_s = w_s + (size_t)B * kGradK;        // [N][B]
  float* sv = kStaged ? gd_s + (size_t)N * B : a_s;  // [N]
  __shared__ int s_n;
  const int g = blockIdx.x, r = g / S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.y * kGradK, kk = 4 * lane;
  const bool kin = k0 + kk < K;  // K % 4 == 0: all four k or none
  const size_t row0 = (size_t)g * N;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* a_g = a + row0 * K + k0;  // the block's k of row 0
  const float* u_g = u + row0 * K + k0;
  const float* w_g = w2t + (size_t)r * B * K + k0;

  // the lane's four k of row `row` (staged: of s; else of the rows at g)
  auto row4 = [&](const float* s, const float* gr, int row) -> float4 {
    if (kStaged) return reinterpret_cast<const float4*>(s + row * kGradK)[lane];
    return kin ? __ldg(reinterpret_cast<const float4*>(gr + (size_t)row * K) +
                       lane)
               : zero;
  };
  auto gd_at = [&](int i, int b) -> float {
    if (kStaged) return gd_s[i * B + b];
    const size_t q = (row0 + i) * B + b;
    return dpool[q] / fmaxf(cnt[q], 1.f);
  };
  // an operand of the products, rounded to bfloat16 in that mode
  auto op = [](float x) { return kBf16 ? bf16_round(x) : x; };

  const int n = scene_extent(valid + row0, sv, &s_n, N);
  const int nw = (n + 31) / 32;  // words that can hold a set bit
  if (kStaged) {
    for (int q = tid; q < n * 32; q += kGradThreads) {
      const int row = q / 32, k = k0 + 4 * (q % 32);
      const size_t off = (row0 + row) * K + k;
      reinterpret_cast<float4*>(a_s)[q] =
          k < K ? *reinterpret_cast<const float4*>(a + off) : zero;
      reinterpret_cast<float4*>(u_s)[q] =
          k < K ? *reinterpret_cast<const float4*>(u + off) : zero;
    }
    for (int q = tid; q < B * 32; q += kGradThreads) {
      const int b = q / 32, k = k0 + 4 * (q % 32);
      reinterpret_cast<float4*>(w_s)[q] =
          k < K ? *reinterpret_cast<const float4*>(
                      w2t + ((size_t)r * B + b) * K + k)
                : zero;
    }
    for (int q = tid; q < n * B; q += kGradThreads)
      gd_s[q] = dpool[row0 * B + q] / fmaxf(cnt[row0 * B + q], 1.f);
    __syncthreads();
  }

  for (int side = 0; side < 2; ++side) {  // 0: du over ties, 1: da over tiesT
    const float* own_s = side ? a_s : u_s;
    const float* other_s = side ? u_s : a_s;
    const float* own_g = side ? a_g : u_g;
    const float* other_g = side ? u_g : a_g;
    for (int row = warp; row < N; row += kGradWarps) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      if (row < n) {
        const float4 ov = row4(own_s, own_g, row);
        const float o[4] = {ov.x, ov.y, ov.z, ov.w};
        const uint32_t* bits = (side ? tiesT : ties) + (row0 + row) * B * NW;
        const int nq = B * nw;  // words (b, wd) in order, 32 at a time
        for (int q0 = 0; q0 < nq; q0 += 32) {
          const int q = q0 + lane;
          const uint32_t mine = q < nq ? bits[q / nw * NW + q % nw] : 0u;
          uint32_t live = __ballot_sync(0xffffffffu, mine != 0u);
          while (live) {
            const int src = __ffs(live) - 1;
            live &= live - 1;
            uint32_t word = __shfl_sync(0xffffffffu, mine, src);
            const int b = (q0 + src) / nw, base = (q0 + src) % nw * 32;
            const float4 wv = row4(w_s, w_g, b);
            const float w[4] = {op(wv.x), op(wv.y), op(wv.z), op(wv.w)};
            while (word) {
              const int partner = base + __ffs(word) - 1;
              word &= word - 1;
              const float gd = op(side ? gd_at(partner, b) : -gd_at(row, b));
              const float4 pv = row4(other_s, other_g, partner);
              const float p[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const float z = side ? o[c] - p[c] : p[c] - o[c];  // a_j - u_i
                if (z > 0.f) acc[c] += gd * w[c];
              }
            }
          }
        }
      }
      if (kin)
        *reinterpret_cast<float4*>((side ? da : du) + (row0 + row) * K + k0 +
                                   kk) = make_float4(acc[0], acc[1], acc[2],
                                                     acc[3]);
    }
  }

  if (dw2p == nullptr) return;
  for (int b = warp; b < B; b += kGradWarps) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    float db = 0.f;
    const int nq = n * nw;  // words (i, wd) in order, 32 at a time
    const uint32_t* bits = ties + (row0 * B + b) * NW;  // row i at i * B * NW
    int cur_i = -1, hits = 0;
    for (int q0 = 0; q0 < nq; q0 += 32) {
      const int q = q0 + lane;
      const uint32_t mine =
          q < nq ? bits[(size_t)(q / nw) * B * NW + q % nw] : 0u;
      uint32_t live = __ballot_sync(0xffffffffu, mine != 0u);
      while (live) {
        const int src = __ffs(live) - 1;
        live &= live - 1;
        uint32_t word = __shfl_sync(0xffffffffu, mine, src);
        const int i = (q0 + src) / nw, base = (q0 + src) % nw * 32;
        if (i != cur_i) {  // row cur_i is done: its share of db2
          if (hits) db += (float)hits * gd_at(cur_i, b);
          cur_i = i;
          hits = 0;
        }
        hits += __popc(word);
        const float gd = op(gd_at(i, b));
        const float4 uv = row4(u_s, u_g, i);
        while (word) {
          const int j = base + __ffs(word) - 1;
          word &= word - 1;
          const float4 av = row4(a_s, a_g, j);
          acc[0] += gd * op(fmaxf(av.x - uv.x, 0.f));
          acc[1] += gd * op(fmaxf(av.y - uv.y, 0.f));
          acc[2] += gd * op(fmaxf(av.z - uv.z, 0.f));
          acc[3] += gd * op(fmaxf(av.w - uv.w, 0.f));
        }
      }
    }
    if (hits) db += (float)hits * gd_at(cur_i, b);
    if (kin)
      *reinterpret_cast<float4*>(dw2p + ((size_t)g * B + b) * K + k0 + kk) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    if (blockIdx.y == 0 && lane == 0) db2p[(size_t)g * B + b] = db;
  }
}

// ------------------------------------------------------------- 3. weights

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
size_t pool_core_bwd_smem_bytes(int N, int B) { return smem_bytes(N, B); }

// Shared memory one block of the tie-gradient pass needs.
size_t pool_core_bwd_grads_smem_bytes(int N, int B) {
  return grads_smem_bytes(N, B);
}

// Floats of the split-W2 scratch one replica needs.
size_t pool_core_bwd_w_frag_floats(int K, int B) {
  return w_frag_floats(K, B);
}

// Words of one tie bit set: ceil(N / 32).
int pool_core_bwd_tie_words(int N) { return (N + 31) / 32; }

// a, u, da, du: [R*S, N, K] f32; w2: [R, K, B], its transpose w2t:
// [R, B, K], b2: [R, B] f32; valid: [R*S, N] f32; pooled, cnt, dpool:
// [R*S, N, B] f32. Scratch from the caller: ties, tiesT [R*S, N, B, NW]
// uint32, ZEROED; dw2p [R*S, B, K] and db2p [R*S, B] f32 (unused when dw2
// is null); wf: R * pool_core_bwd_w_frag_floats(K, B) f32 for the split
// W2. dw2 [R, K, B] and db2 [R, B] may both be null: the weight gradients
// are then skipped. recount [R*S, N, B] f32 may be null. All contiguous,
// K % 4 == 0, 16-byte aligned. bf16 = 1 selects the bfloat16 mode (the
// forward's), 0 the float32-exact one. Returns the CUDA error of the first
// call that failed (0 = cudaSuccess).
int pool_core_bwd(const float* a, const float* u, const float* w2,
                  const float* w2t, const float* b2, const float* valid,
                  const float* pooled, const float* cnt, const float* dpool,
                  uint32_t* ties, uint32_t* tiesT, float* dw2p, float* db2p,
                  float* da, float* du, float* dw2, float* db2,
                  float* recount, float* wf, int R, int S, int N, int K,
                  int B, int bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R * S == 0 || N == 0 || B == 0 || K == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = R * S, NW = (N + 31) / 32;

  err = bf16 ? split_w<float, true>(w2, wf, R, K, B, st)
             : split_w<float, false>(w2, wf, R, K, B, st);
  if (err != cudaSuccess) return (int)err;
  err = for_column_launches(B, [&](auto nt, int col0, int groups) {
    constexpr int NT = decltype(nt)::value;
    auto kernel = bf16 ? ties_kernel<NT, true> : ties_kernel<NT, false>;
    const size_t smem =
        sizeof(float) * (kStages * (size_t)stage_floats(NT) + N);
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(G, (N + kTI - 1) / kTI, groups), kThreads, smem, st>>>(
        a, u, wf, b2, valid, pooled, ties, tiesT, recount, S, N, K, B, NW,
        col0);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;

  const bool staged = grads_staged(N, B);
  auto grads = bf16 ? (staged ? tie_grads_kernel<true, true>
                              : tie_grads_kernel<false, true>)
                    : (staged ? tie_grads_kernel<true, false>
                              : tie_grads_kernel<false, false>);
  const size_t gsmem = grads_smem_bytes(N, B);
  err = cudaFuncSetAttribute(grads, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)gsmem);
  if (err != cudaSuccess) return (int)err;
  grads<<<dim3(G, (K + kGradK - 1) / kGradK), kGradThreads, gsmem, st>>>(
      a, u, w2t, valid, cnt, dpool, ties, tiesT, da, du, dw2p, db2p, S, N, K,
      B, NW);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (dw2 != nullptr) {
    weight_reduce_kernel<<<dim3((K + kRowThreads - 1) / kRowThreads, B, R),
                           kRowThreads, 0, st>>>(dw2p, db2p, dw2, db2, S, K,
                                                 B);
    err = cudaGetLastError();
  }
  return (int)err;
}

const char* pool_core_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
