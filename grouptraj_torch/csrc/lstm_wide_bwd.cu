// Whole-loop LSTM backward at the wide widths: kernel K4 (both variants) and
// kernel K6 for H in (64, 128], and K6 for D in (16, 64], of the port.
//
// Replaces the TPU kernels grouptraj/ops/pallas_fused.py:_bwd_kernel (K4:
// dgx or db, dW, dh0, dc0) and grouptraj/ops/pallas_lstm.py:_bwd_kernel
// (K6: dxs, dW_ih, dW_hh, db, dh0, dc0) at the widths whose weights do not
// fit the register design (lstm_fused_bwd.cu, lstm_proj_bwd.cu).
// Back-propagation through time from what the forward saved (the
// post-activation gates [T, B, 4H] and the cell states cs [T, B, H]; h_{t-1}
// = ys[t-1], c_{t-1} = cs[t-1], h0 and c0 at t = 0, read by index):
//
//   dh = dh_carry + dys[t];  tc = tanh(f c_prev + i g)
//   dc = dc_carry + dh o (1 - tc^2)
//   dz = [dc g i (1-i), dc c_prev f (1-f), dc i (1-g^2), dh tc o (1-o)]
//   dh_carry = dz W_hhᵀ,  dc_carry = dc f
//   [dW_ih ; dW_hh ; db] = Σ_t [x_t | h_{t-1} | 1]ᵀ dz_t,  dxs[t] = dz_t W_ihᵀ
//
// Bound on an H100 SXM (chip_smoke.py:lstm_bound_ms / proj_bound_ms): the
// products 4 T B (D + H) 4H as 3xTF32 beside the bytes of the residuals
// read and dgx / dxs written once; the encoders of the H = 128 scale
// configuration are bound by their operations.
//
// Design (lstm_wide.cuh says why it differs from the register design).
// Three hand-written kernels, no library call:
//  1. lstm_wide_bwd_kernel, the recurrence. W_hhᵀ is split once per call
//     (split_bwd_kernel) into a global scratch of B fragments. A block owns
//     kR = 32 batch rows (two m16 tiles) for all T steps and has one warp per
//     8 units: warp q's accumulators of dh_carry = dz · W_hhᵀ (mma.sync
//     m16n8k8, 3xTF32, k over 4H ascending) hold the cells (2 rows x 2
//     units an m-tile) whose four gates' dz the same lane forms at the next
//     step, so dh_carry and dc_carry never leave the registers. The step's
//     gates, c_prev and dys are copied by each lane into its own shared
//     slots by 8-byte cp.async a step ahead. dz is written raw into a shared
//     tile (the product's A, split as it is read) and from the registers to
//     device memory: dgx itself for K4's gx variant, else a scratch slab.
//     Two __syncthreads a step.
//  2. lstm_wide_dw_kernel: the weight gradients [Kc, 4H] = Pᵀ dz over the
//     T·B rows, P = [x_t | h_{t-1} | 1 | 0] gathered by row (Kc = Dp + H (+ 8
//     for db)), 3xTF32 mma.sync over 64 x 128 output tiles, split-K over row
//     chunks; each chunk leaves a partial and reduce_partials_kernel sums
//     them in chunk order, so the result repeats from run to run.
//  3. lstm_wide_dx_kernel (K6): dxs = dz · W_ihᵀ, 3xTF32 mma.sync over 64 x
//     64 output tiles, k over 4H ascending.

#include "lstm_wide.cuh"

namespace {

using namespace lstm_wide;

constexpr int kMT = 2;           // m16 tiles a block of the recurrence
constexpr int kR = 16 * kMT;     // batch rows a block of the recurrence
constexpr int kSlots = 6;        // a cell pair's inputs: 4 gates, c_prev, dys

// dynamic shared memory of the recurrence: the dz tile and the lanes' slots
__host__ __device__ inline size_t rec_smem(int H) {
  return sizeof(float) * ((size_t)kR * stride8(4 * H) +
                          2 * (kMT * 2 * kSlots) * (32 * H / 8));
}

__global__ void __launch_bounds__(kMaxThreads, 1)
lstm_wide_bwd_kernel(const float4* __restrict__ wf,
                     const float* __restrict__ c0,
                     const float* __restrict__ gates,
                     const float* __restrict__ cs,
                     const float* __restrict__ dys,
                     const float* __restrict__ dhT,
                     const float* __restrict__ dcT, float* __restrict__ dz,
                     float* __restrict__ dh0, float* __restrict__ dc0, int T,
                     int B, int H) {
  const int G = 4 * H, NT = H / 8, KS = G / 8, SZ = stride8(G);
  const int nthr = blockDim.x;
  extern __shared__ __align__(16) float smem[];
  float* sz = smem;                                        // dz [kR][SZ]
  float2* slot = reinterpret_cast<float2*>(smem + kR * SZ);  // [..][nthr]

  const int tid = threadIdx.x, lane = tid & 31, q = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int u = 8 * q + 2 * tig;              // this lane's units u, u + 1
  const int row0 = (int)blockIdx.x * kR;
  auto at = [&](int m, int r, int j) -> float2& {
    return slot[((m * 2 + r) * kSlots + j) * nthr + tid];
  };

  // step s's gates, c_{s-1} and dys[s] of this lane's cells into its slots
  // (zeros past B; no dys copied when it is null)
  auto stage = [&](int s) {
    const float* cprev = s > 0 ? cs + (size_t)(s - 1) * B * H : c0;
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 16 * m + gid + 8 * r;
        const bool ok = row < B;
        const size_t rw = ok ? row : 0;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          cp_async8(reinterpret_cast<float*>(&at(m, r, g)),
                    gates + ((size_t)s * B + rw) * G + g * H + u, ok);
        cp_async8(reinterpret_cast<float*>(&at(m, r, 4)),
                  cprev + rw * H + u, ok);
        if (dys != nullptr)
          cp_async8(reinterpret_cast<float*>(&at(m, r, 5)),
                    dys + ((size_t)s * B + rw) * H + u, ok);
      }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  stage(T - 1);

  // Cell e of a lane in m-tile m: row 16 m + gid + 8 (e / 2), unit u + e % 2.
  float carry[kMT][4], dc[kMT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + 16 * m + gid + 8 * (e >> 1);
      const size_t i = (size_t)row * H + u + (e & 1);
      carry[m][e] = row < B && dhT != nullptr ? dhT[i] : 0.f;
      dc[m][e] = row < B && dcT != nullptr ? dcT[i] : 0.f;
    }

  for (int t = T - 1; t >= 0; --t) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int lr = 16 * m + gid + 8 * r, row = row0 + lr;
        const float2 gv[4] = {at(m, r, 0), at(m, r, 1), at(m, r, 2),
                              at(m, r, 3)};
        const float2 cpv = at(m, r, 4);
        const float2 dyv = dys != nullptr ? at(m, r, 5) : make_float2(0.f, 0.f);
        float d[4][2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int e = 2 * r + p;
          const float gi = p ? gv[0].y : gv[0].x, gf = p ? gv[1].y : gv[1].x;
          const float gg = p ? gv[2].y : gv[2].x, go = p ? gv[3].y : gv[3].x;
          const float cp = p ? cpv.y : cpv.x;
          const float dht = carry[m][e] + (p ? dyv.y : dyv.x);
          const float tc = tanhf(gf * cp + gi * gg);
          const float dcc = dc[m][e] + dht * go * (1.f - tc * tc);
          d[0][p] = dcc * gg * gi * (1.f - gi);
          d[1][p] = dcc * cp * gf * (1.f - gf);
          d[2][p] = dcc * gi * (1.f - gg * gg);
          d[3][p] = dht * tc * go * (1.f - go);
          dc[m][e] = dcc * gf;
        }
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float2 v = make_float2(d[g][0], d[g][1]);
          if (row < B)
            __stcs(reinterpret_cast<float2*>(
                       dz + ((size_t)t * B + row) * G + g * H + u), v);
          *reinterpret_cast<float2*>(sz + lr * SZ + g * H + u) = v;
        }
      }
    __syncthreads();            // dz is whole
    if (t > 0) stage(t - 1);    // this lane's slots are read

    // dh_carry = dz · W_hhᵀ: n-tile q (this warp's units), k over 4H
    float acc[kMT][4];
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;
#pragma unroll 4
    for (int ks = 0; ks < KS; ++ks) {
      const float4 bq = __ldg(wf + ((size_t)ks * NT + q) * 32 + lane);
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const float* p = sz + (16 * m + gid) * SZ + 8 * ks + 2 * tig;
        const float2 x0 = *reinterpret_cast<const float2*>(p);
        const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * SZ);
        const float xv[4] = {x0.x, x1.x, x0.y, x1.y};
        uint32_t ah[4], al[4];
        split(xv, ah, al);
        mma_tf32(acc[m], al, bq.x, bq.y);
        mma_tf32(acc[m], ah, bq.z, bq.w);
        mma_tf32(acc[m], ah, bq.x, bq.y);
      }
    }
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) carry[m][e] = acc[m][e];
    __syncthreads();            // the dz tile is read
  }

#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * m + gid + 8 * r;
      if (row < B) {
        const size_t i = (size_t)row * H + u;
        *reinterpret_cast<float2*>(dh0 + i) =
            make_float2(carry[m][2 * r], carry[m][2 * r + 1]);
        *reinterpret_cast<float2*>(dc0 + i) =
            make_float2(dc[m][2 * r], dc[m][2 * r + 1]);
      }
    }
}

// ------------------------------------------------------ weight gradients

constexpr int kGemmThreads = 256;    // 8 warps
constexpr int kRB = 16;              // rows (k) a stage of the dW kernel
constexpr int kBM = 64, kBN = 128;   // dW output tile: Kc x 4H
constexpr int kSP = kBM + 8;         // row strides, 8 mod 32
constexpr int kSN = kBN + 8;
constexpr int kTargetBlocks = 2 * 132;   // two blocks an SM of an H100

// The row chunks of the dW kernel: enough for kTargetBlocks blocks over
// the output tiles, at least kRB rows each. -> (chunks, rows a chunk).
__host__ inline void dw_chunks(int rows, int Kc, int G, int* nch, int* rpc) {
  const int tiles = (Kc + kBM - 1) / kBM * ((G + kBN - 1) / kBN);
  int n = (kTargetBlocks + tiles - 1) / tiles;
  const int most = (rows + kRB - 1) / kRB;
  n = n < 1 ? 1 : (n > most ? most : n);
  *rpc = round_up((rows + n - 1) / n, kRB);
  *nch = (rows + *rpc - 1) / *rpc;
}

// part[chunk][kc][n] = Σ over the chunk's rows ρ = t B + b of P[ρ][kc]
// dz[ρ][n], P[ρ] = [x_t (Dp columns, zeros past D) | h_{t-1} (H) | 1, 0 x 7
// (with_db)]; kc < Kc, n < 4H.
__global__ void __launch_bounds__(kGemmThreads)
lstm_wide_dw_kernel(const float* __restrict__ xs,
                    const float* __restrict__ h0,
                    const float* __restrict__ ys,
                    const float* __restrict__ dz, float* __restrict__ part,
                    int T, int B, int D, int H, int Kc, int with_db,
                    int rpc) {
  const int G = 4 * H, Dp = round_up(D, 8), rows = T * B;
  __shared__ __align__(16) float sp[2][kRB][kSP];
  __shared__ __align__(16) float sd[2][kRB][kSN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;     // warp tile: 32 x 32
  const int kc0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int rbeg = blockIdx.z * rpc;
  const int rend = min(rows, rbeg + rpc);

  // the stage of rows [r0, r0 + kRB) into buffer bf
  auto load = [&](int bf, int r0) {
#pragma unroll
    for (int k = 0; k < kRB * kBM / 4 / kGemmThreads; ++k) {
      const int i = tid + k * kGemmThreads;
      const int r = i / (kBM / 4), col = 4 * (i % (kBM / 4));
      const int rho = r0 + r, kc = kc0 + col;
      float* dst = &sp[bf][r][col];
      const bool live = rho < rend && kc < Kc;
      if (live && kc < Dp) {
        cp_async16(dst, kc < D ? xs + (size_t)rho * D + kc : xs, kc < D);
      } else if (live && kc < Dp + H) {
        const int j = kc - Dp;
        const float* src = rho >= B ? ys + (size_t)(rho - B) * H + j
                                    : h0 + (size_t)rho * H + j;
        cp_async16(dst, src, true);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(
            live && with_db && kc == Dp + H ? 1.f : 0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int k = 0; k < kRB * kBN / 4 / kGemmThreads; ++k) {
      const int i = tid + k * kGemmThreads;
      const int r = i / (kBN / 4), col = 4 * (i % (kBN / 4));
      const int rho = r0 + r, n = n0 + col;
      const bool ok = rho < rend && n < G;
      cp_async16(&sd[bf][r][col], dz + (ok ? (size_t)rho * G + n : 0), ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  int bf = 0;
  if (rbeg < rend) load(0, rbeg);
  for (int r0 = rbeg; r0 < rend; r0 += kRB, bf ^= 1) {
    if (r0 + kRB < rend) {
      load(bf ^ 1, r0 + kRB);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    // the stage's sums from zero, then added to the running sums: the
    // tensor cores' accumulation truncates, and a chunk has thousands of
    // rows
    float sacc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[i][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kRB / 8; ++ks) {
      const int k = 8 * ks + tig;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = 32 * wm + 16 * i + gid;
        const float xv[4] = {sp[bf][k][m], sp[bf][k][m + 8], sp[bf][k + 4][m],
                             sp[bf][k + 4][m + 8]};
        split(xv, ah[i], al[i]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 32 * wn + 8 * j + gid;
        const float b0 = sd[bf][k][n], b1 = sd[bf][k + 4][n];
        const float h0v = __uint_as_float(tf32(b0));
        const float h1v = __uint_as_float(tf32(b1));
        const float l0v = __uint_as_float(tf32(b0 - h0v));
        const float l1v = __uint_as_float(tf32(b1 - h1v));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_tf32(sacc[i][j], al[i], h0v, h1v);
          mma_tf32(sacc[i][j], ah[i], l0v, l1v);
          mma_tf32(sacc[i][j], ah[i], h0v, h1v);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += sacc[i][j][e];
    __syncthreads();   // buffer bf is read before it is loaded again
  }

  float* out = part + (size_t)blockIdx.z * Kc * G;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kc = kc0 + 32 * wm + 16 * i + gid + 8 * h;
        const int n = n0 + 32 * wn + 8 * j + 2 * tig;
        if (kc < Kc && n < G)
          *reinterpret_cast<float2*>(out + (size_t)kc * G + n) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
}

// dxs[ρ][d] = Σ_c dz[ρ][c] W_ih[d][c] over the T·B rows: output tiles of 64
// rows x 64 columns (d < D), k = c over 4H in stages of 32.
constexpr int kXM = 64, kXN = 64, kXK = 32, kSK = kXK + 4;  // 4 mod 32

__global__ void __launch_bounds__(kGemmThreads)
lstm_wide_dx_kernel(const float* __restrict__ dz,
                    const float* __restrict__ w_ih, float* __restrict__ dxs,
                    int rows, int D, int H) {
  const int G = 4 * H;
  __shared__ __align__(16) float sa[2][kXM][kSK];
  __shared__ __align__(16) float sw[2][kXN][kSK];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;     // warp tile: 16 x 32
  const int r0 = blockIdx.x * kXM;

  auto load = [&](int bf, int c0) {
#pragma unroll
    for (int k = 0; k < kXM * kXK / 4 / kGemmThreads; ++k) {
      const int i = tid + k * kGemmThreads;
      const int r = i / (kXK / 4), col = 4 * (i % (kXK / 4));
      const bool ok = r0 + r < rows;
      cp_async16(&sa[bf][r][col],
                 dz + (ok ? (size_t)(r0 + r) * G + c0 + col : 0), ok);
      const bool wok = r < D;
      cp_async16(&sw[bf][r][col],
                 w_ih + (wok ? (size_t)r * G + c0 + col : 0), wok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  int bf = 0;
  load(0, 0);
  for (int c0 = 0; c0 < G; c0 += kXK, bf ^= 1) {
    if (c0 + kXK < G) {
      load(bf ^ 1, c0 + kXK);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kXK / 8; ++ks) {
      const int k = 8 * ks + tig, m = 16 * wm + gid;
      const float xv[4] = {sa[bf][m][k], sa[bf][m + 8][k], sa[bf][m][k + 4],
                           sa[bf][m + 8][k + 4]};
      uint32_t ah[4], al[4];
      split(xv, ah, al);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 32 * wn + 8 * j + gid;
        const float b0 = sw[bf][n][k], b1 = sw[bf][n][k + 4];
        const float h0v = __uint_as_float(tf32(b0));
        const float h1v = __uint_as_float(tf32(b1));
        mma_tf32(acc[j], al, h0v, h1v);
        mma_tf32(acc[j], ah, __uint_as_float(tf32(b0 - h0v)),
                 __uint_as_float(tf32(b1 - h1v)));
        mma_tf32(acc[j], ah, h0v, h1v);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 16 * wm + gid + 8 * h;
      const int d = 32 * wn + 8 * j + 2 * tig;
      if (r < rows && d < D)
        *reinterpret_cast<float2*>(dxs + (size_t)r * D + d) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
}

}  // namespace

extern "C" {

// The rows of the weight gradients, Kc = round_up(D, 8) + H (+ 8 with db),
// and the partials' chunks: part holds [chunks, Kc, 4H] floats.
int lstm_wide_bwd_chunks(int T, int B, int D, int H, int with_db) {
  int nch, rpc;
  dw_chunks(T * B, round_up(D, 8) + H + (with_db ? 8 : 0), 4 * H, &nch,
            &rpc);
  return nch;
}

// K4 (D = 0; w_ih, xs and dxs null) or K6 (D in [4, 64], a multiple of 4).
// w_hh: [H, 4H]; h0, c0: [B, H]; ys, cs: [T, B, H] and gates [T, B, 4H] as
// the forward wrote them; dys [T, B, H], dhT, dcT [B, H]: each may be null
// (zero). Outputs: dz [T, B, 4H] (K4's dgx, or a scratch); dxs [T, B, D]
// (K6); dw [Kc, 4H]: rows 0 .. D - 1 dW_ih, round_up(D, 8) .. + H - 1
// dW_hh, then db (with_db) in the next row; dh0, dc0 [B, H]. Scratch: wf
// of 4H * H * 2 floats, part of lstm_wide_bwd_chunks() * Kc * 4H floats.
// All float32 and contiguous at 16-byte aligned addresses; T >= 1, B >= 1,
// H a multiple of 8 in [8, 128]. Returns the CUDA error of the launches
// (0 = cudaSuccess).
int lstm_wide_bwd(const float* w_ih, const float* w_hh, const float* xs,
                  const float* h0, const float* c0, const float* ys,
                  const float* gates, const float* cs, const float* dys,
                  const float* dhT, const float* dcT, float* dz, float* dxs,
                  float* wf, float* part, float* dw, float* dh0, float* dc0,
                  int T, int B, int D, int H, int with_db, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (T < 1 || B < 1 || !widths_ok(D, H) ||
      (D > 0) != (w_ih != nullptr && xs != nullptr && dxs != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = 4 * H, rows = T * B;
  const int Kc = round_up(D, 8) + H + (with_db ? 8 : 0);
  const int n = G / 8 * (H / 8) * 32;
  split_bwd_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      w_hh, H, reinterpret_cast<float4*>(wf));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem = rec_smem(H);
  err = cudaFuncSetAttribute(lstm_wide_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  lstm_wide_bwd_kernel<<<(B + kR - 1) / kR, 32 * H / 8, smem, st>>>(
      reinterpret_cast<const float4*>(wf), c0, gates, cs, dys, dhT, dcT, dz,
      dh0, dc0, T, B, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  int nch, rpc;
  dw_chunks(rows, Kc, G, &nch, &rpc);
  const dim3 grid((Kc + kBM - 1) / kBM, (G + kBN - 1) / kBN, nch);
  lstm_wide_dw_kernel<<<grid, kGemmThreads, 0, st>>>(
      xs, h0, ys, dz, part, T, B, D, H, Kc, with_db, rpc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr int kSumThreads = 128;
  reduce_partials_kernel<<<(Kc * G + kSumThreads - 1) / kSumThreads,
                           kSumThreads, 0, st>>>(part, dw, nch, Kc * G);
  err = cudaGetLastError();
  if (err != cudaSuccess || D == 0) return (int)err;

  lstm_wide_dx_kernel<<<(rows + kXM - 1) / kXM, kGemmThreads, 0, st>>>(
      dz, w_ih, dxs, rows, D, H);
  return (int)cudaGetLastError();
}

const char* lstm_wide_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
