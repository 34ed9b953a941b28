// Shared pieces of the wide LSTM kernels (K3-K6 at 64 < H <= 128, and K5/K6
// at D > 16): lstm_wide_fwd.cu (K3's and K5's forward) and lstm_wide_bwd.cu
// (K4's and K6's backward).
//
// Why a design of its own. The register design (lstm_fused_fwd.cu and its
// three siblings) keeps the split recurrent matrix in registers (2H floats
// a lane in the forwards) or in shared memory (the backwards) and the
// backwards' partial dW in registers for all T steps. At H = 128, W_hh
// [128, 512] is 256 KB in float32 and 512 KB as its 3xTF32 hi/lo pair:
// more than the 227 KB of shared memory a block may use, and 2H = 256
// registers a lane. So here W (and, backward, Wᵀ) is split once per call
// by a small kernel into a global scratch, in the order the mma.sync
// m16n8k8 B fragments are read (one float4 {hi, hi, lo, lo} a lane and
// fragment, 512 contiguous bytes a warp), and every warp streams its own
// fragments from L2 at every step. A block owns many batch rows (64
// forward, 32 backward) so that each fragment read from L2 feeds several
// m-tiles. The weight gradients leave the recurrence: the backward writes
// dz [T, B, 4H] (dgx itself, or a scratch slab) and two hand-written
// 3xTF32 kernels form dW = Σ [x | h_{t-1} | 1]ᵀ dz (split-K over row
// chunks, partial sums added in chunk order) and dxs = dz W_ihᵀ. No float
// atomics anywhere: every result repeats bit for bit.

#pragma once

#include "lstm_fused.cuh"
#include "tc_tf32.cuh"

namespace lstm_wide {

using namespace lstm_fused;
using namespace tc_tf32;

constexpr int kMaxH = 128;                    // widest hidden width served
constexpr int kMaxD = 64;                     // widest input width served
constexpr int kMaxThreads = 32 * kMaxH / 8;   // one warp per 8 units: 512

// x rounded up to a multiple of m
__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// an 8-byte cp.async (zeros when !full)
__device__ __forceinline__ void cp_async8(float* dst, const float* src,
                                          bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 8 : 0));
}

// The split B fragments of a product with n over N columns: fragment (ks,
// nt, lane) is float4 {hi(k0), hi(k0 + 1), lo(k0), lo(k0 + 1)} of B[k][n]
// at n = 8 nt + gid, k0 = 8 ks + 2 tig (gid = lane / 4, tig = lane % 4), at
// index (ks * (N / 8) + nt) * 32 + lane. The A fragments read the same
// permutation of k (a float2 at columns k0, k0 + 1 of rows gid and gid + 8).
//
// Forward: B = [W_ih ; W_hh] ([Dp + H, 4H], W_ih's rows D .. Dp - 1 zero;
// Dp = 0 without an input projection).
__global__ void split_fwd_kernel(const float* __restrict__ w_ih,
                                 const float* __restrict__ w_hh, int D,
                                 int Dp, int H, float4* __restrict__ wf) {
  const int G = 4 * H, NT = G / 8, KS = (Dp + H) / 8;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= KS * NT * 32) return;
  const int lane = idx & 31, nt = (idx >> 5) % NT, ks = (idx >> 5) / NT;
  const int n = 8 * nt + (lane >> 2), k0 = 8 * ks + 2 * (lane & 3);
  auto at = [&](int k) {
    return k < Dp ? (k < D ? w_ih[(size_t)k * G + n] : 0.f)
                  : w_hh[(size_t)(k - Dp) * G + n];
  };
  wf[idx] = split2(at(k0), at(k0 + 1));
}

// Backward: B[k][n] = W_hh[n][k] (k over 4H, n over H): dh = dz W_hhᵀ.
__global__ void split_bwd_kernel(const float* __restrict__ w_hh, int H,
                                 float4* __restrict__ wf) {
  const int G = 4 * H, NT = H / 8, KS = G / 8;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= KS * NT * 32) return;
  const int lane = idx & 31, nt = (idx >> 5) % NT, ks = (idx >> 5) / NT;
  const int n = 8 * nt + (lane >> 2), k0 = 8 * ks + 2 * (lane & 3);
  wf[idx] = split2(w_hh[(size_t)n * G + k0], w_hh[(size_t)n * G + k0 + 1]);
}

// the widths the wide kernels take: H a multiple of 8 in [8, 128], D a
// multiple of 4 in [0, 64] (0: no input projection)
inline bool widths_ok(int D, int H) {
  return H % 8 == 0 && H >= 8 && H <= kMaxH && D % 4 == 0 && D >= 0 &&
         D <= kMaxD;
}

}  // namespace lstm_wide
