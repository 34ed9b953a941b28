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
// configuration are bound by their operations (3xTF32 at wgmma's rate).
// The recurrence alone moves the gates and cell states in and dz out, so
// it is bound by bytes; the products of both passes run on wgmma, the only
// way to the card's TF32 rate (mma.sync runs at about half of it).
//
// Design. Every wide H runs at kHP = 128 units (zero past H: a padded
// unit's dz is 0 and its row of W_hh is 0). Four hand-written kernels, no
// library call, no float atomics (every result repeats bit for bit). On
// this card a warpgroup's own ALU work and loads do not overlap its wgmma
// (its issue waits while the tensor cores are busy:
// grouptraj_torch/probes/wgmma_overlap.cu), so what must overlap the
// products comes from another warpgroup or sits between the issues.
//  1. split_bwd_kernel: W_hhᵀ split once per call into 3xTF32 hi/lo wgmma B
//     tiles, in the order the recurrence reads them (32 KB a k-chunk).
//  2. lstm_wide_bwd_kernel, the recurrence: a block of 64 batch rows for
//     all T steps, one consumer and one producer warpgroup.
//     dh_carry = dz W_hhᵀ runs as wgmma.m64n128k8 with dz as the A operand
//     straight from registers: the lane that holds dh[r][u] in the
//     accumulator (rows gid, gid + 8; units 8 j + 2 tig, + 1) forms the
//     four gates' dz of those cells, which are its A fragments of the
//     k-steps of unit block j once k is permuted (k-slot tig holds unit
//     8 j + 2 tig, slot tig + 4 unit 8 j + 2 tig + 1; the B tiles are
//     written that way). A k-chunk is one unit block: 4 k-steps (one a
//     gate) x 3 products. The producer brings each chunk's B tiles by bulk
//     copy and its inputs (gates, c_{t-1}, dys) by cp.async into rings of
//     three stages on mbarriers; the consumer runs the gate math of chunk
//     c + 1 between the wgmma issues of chunk c. Each chunk's products are
//     summed from zero and the chunks added in float32 (the tensor cores
//     truncate as they accumulate). The carries dh and dc sit in each
//     consumer lane's own shared-memory slots (the registers hold the
//     chunk's accumulator and the step's running sum); dz is written once,
//     as K4's dgx or as the slab the next pass reads. (128 rows a block,
//     each W chunk feeding two consumer warpgroups, leaves no shared
//     memory for the input rings.)
//  3. lstm_wide_dw_kernel<DX>: [dW_ih ; dW_hh] = Pᵀ dz in one pass over dz,
//     P = [x_t | h_{t-1}] by row. A block owns 128 columns of dz (two
//     warpgroups of 64) and a chunk of rows; it computes dWᵀ for all of P's
//     columns (DX of x, zero-padded to a power of two, and 128 of h) as
//     wgmma.m64n{DX,128}k8, dz as A (read from its staged tile, split in
//     registers) and P as B, transposed and split into K-major tiles (TF32
//     wgmma takes no other) between the previous stage's issues. So dz is
//     read once and P once a 128-column slice. db is the column sum of the
//     same A fragments. Split-K over row chunks: each chunk leaves a
//     partial, and reduce_partials_kernel sums them in chunk order. Each
//     stage's sums start from zero.
//  4. lstm_wide_dx_kernel (K6): dxs = dz W_ihᵀ, 3xTF32 mma.sync over 64 x 64
//     output tiles, each 32-k stage summed from zero.

#include "lstm_wide.cuh"
#include "wgmma_tf32.cuh"

namespace {

using namespace lstm_wide;
using namespace wgmma_tf32_ops;

constexpr int kHP = kMaxH;            // units every wide H runs at
constexpr int kNB = kHP / 8;          // unit blocks: the recurrence's k-chunks
constexpr int kTileB = kHP * 32;      // bytes of a k-step's B tile (hi or lo)
constexpr int kChunkB = 8 * kTileB;   // a k-chunk: 4 gates x {hi, lo}
constexpr int kStages = 3;            // the ring of k-chunks

// W_hhᵀ as the recurrence's B tiles: chunk j, gate g, part p (0 hi, 1 lo)
// at floats (8 j + 2 g + p) kTileB / 4; a tile is K-major over kHP columns
// n (dh's units) and 8 k-slots, slot l holding unit u = 8 j + 2 l (l < 4)
// or 8 j + 2 (l - 4) + 1 of gate g: B[l][n] = W_hh[n][g H + u], zero past
// H. Core matrix (n / 8, l / 4) at 256 (n / 8) + 128 (l / 4) bytes, column
// n % 8 at 16 (n % 8), slot l % 4 at 4 (l % 4): LBO 128, SBO 256.
__global__ void split_bwd_kernel(const float* __restrict__ w_hh, int H,
                                 float* __restrict__ wt) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;  // (j, g, n, l)
  if (idx >= kNB * 4 * kHP * 8) return;
  const int l = idx & 7, n = (idx >> 3) % kHP, jg = (idx >> 3) / kHP;
  const int g = jg & 3, j = jg >> 2;
  const int u = 8 * j + (l < 4 ? 2 * l : 2 * (l - 4) + 1);
  const float v = n < H && u < H ? w_hh[(size_t)n * 4 * H + g * H + u] : 0.f;
  const float hi = __uint_as_float(tf32(v));
  const size_t off = (size_t)(8 * j + 2 * g) * (kTileB / 4) + (n >> 3) * 64 +
                     (l >> 2) * 32 + (n & 7) * 4 + (l & 3);
  wt[off] = hi;
  wt[off + kTileB / 4] = __uint_as_float(tf32(v - hi));
}

// The recurrence's block: one consumer warpgroup (64 rows) and one
// producer warpgroup. A chunk's inputs in shared memory: row r (of the
// block's 64) at kInRow r floats, its four gates' 8 units at 8 g,
// c_{t-1}'s at 32, dys's at 40 (a row stride of 56 floats: the float2
// reads of 4 rows x 4 lanes a half-warp hit 32 banks once).
constexpr int kConsumers = 128;
constexpr int kProducers = 128;
constexpr int kThreads = kConsumers + kProducers;
constexpr int kInRow = 56;
constexpr int kInBuf = 64 * kInRow;                   // floats a chunk
constexpr int kInStages = 3;

// dynamic shared memory of the recurrence: the ring of W chunks, the ring
// of input chunks, each consumer lane's carry and dc slots (a float4 of its
// four cells a unit block), and the two rings' barriers
constexpr size_t kRecSmem =
    (size_t)kStages * kChunkB + (size_t)kInStages * kInBuf * 4 +
    2 * (size_t)kNB * kConsumers * 16 +
    2 * (kStages + kInStages) * sizeof(uint64_t);

// cp.async arrive: `bar` receives this thread's arrival once its cp.async
// copies so far have landed (the barrier's count includes it)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_addr(bar)) : "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
lstm_wide_bwd_kernel(const float* __restrict__ wt,
                     const float* __restrict__ c0,
                     const float* __restrict__ gates,
                     const float* __restrict__ cs,
                     const float* __restrict__ dys,
                     const float* __restrict__ dhT,
                     const float* __restrict__ dcT, float* __restrict__ dz,
                     float* __restrict__ dh0, float* __restrict__ dc0, int T,
                     int B, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  float* in = reinterpret_cast<float*>(smem + kStages * kChunkB);
  float4* carry = reinterpret_cast<float4*>(in + kInStages * kInBuf);
  float4* dcs = carry + kNB * kConsumers;
  uint64_t* w_full = reinterpret_cast<uint64_t*>(dcs + kNB * kConsumers);
  uint64_t* w_empty = w_full + kStages;
  uint64_t* in_full = w_empty + kStages;
  uint64_t* in_empty = in_full + kInStages;

  const int tid = threadIdx.x, lane = tid & 31;
  const int row0 = (int)blockIdx.x * 64;
  const int G = 4 * H, total = T * kNB;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&w_full[s], 1);
      mbar_init(&w_empty[s], kConsumers);
    }
    for (int s = 0; s < kInStages; ++s) {
      mbar_init(&in_full[s], kProducers);
      mbar_init(&in_empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // The producer warpgroup: chunk c's W tiles (bulk copy, thread 0) and
    // inputs (cp.async, 6 pieces of 16 bytes a thread: 64 rows x 6
    // segments of 32 bytes; zeros past B and H, and for dys when it is
    // null), each into its ring once the consumers have released the
    // stage.
    const int pt = tid - kConsumers;
    for (int c = 0; c < total; ++c) {
      const int s = c % kStages, si = c % kInStages;
      if (pt == 0) {
        if (c >= kStages)
          mbar_wait(&w_empty[s], (uint32_t)(c / kStages - 1) & 1u);
        mbar_expect_tx(&w_full[s], kChunkB);
        bulk_copy(ring + s * kChunkB, wt + (size_t)(c % kNB) * (kChunkB / 4),
                  kChunkB, &w_full[s]);
      }
      if (c >= kInStages)
        mbar_wait(&in_empty[si], (uint32_t)(c / kInStages - 1) & 1u);
      const int t = T - 1 - c / kNB, u = 8 * (c % kNB);
      const float* srcs[3] = {
          gates + (size_t)t * B * G + u,
          (t > 0 ? cs + (size_t)(t - 1) * B * H : c0) + u,
          dys != nullptr ? dys + (size_t)t * B * H + u : c0};
      float* dst = in + si * kInBuf;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const int i = pt + kProducers * k;       // of 64 rows x 12 pieces
        const int r = i / 12, p = i % 12, seg = p >> 1, half = p & 1;
        const int row = row0 + r;
        const bool ok = row < B && u < H && (seg < 5 || dys != nullptr);
        const float* src =
            seg < 4 ? srcs[0] + (size_t)row * G + seg * H
                    : srcs[seg - 3] + (size_t)row * H;
        cp_async16(dst + r * kInRow + 8 * seg + 4 * half,
                   ok ? src + 4 * half : c0, ok);
      }
      cp_async_arrive(&in_full[si]);
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    return;
  }

  const int gid = lane >> 2, tig = lane & 3;
  // this lane's rows: r0 and r0 + 8 (warp w: rows 16 w .. of the block's 64)
  const int rl = 16 * (tid >> 5) + gid, r0 = row0 + rl;
  const bool ok0 = r0 < B, ok1 = r0 + 8 < B;
  const size_t i0 = ok0 ? r0 : 0, i1 = ok1 ? r0 + 8 : 0;

  // the carries at t = T - 1: dhT and dcT (zero when null or padded);
  // cell e of a unit block: row r0 + 8 (e / 2), unit 8 j + 2 tig + e % 2
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    const int u = 8 * j + 2 * tig;
    float h[4] = {0.f, 0.f, 0.f, 0.f}, d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = (e < 2 ? ok0 : ok1) && u < H;
      const size_t i = (e < 2 ? i0 : i1) * H + u + (e & 1);
      if (ok && dhT != nullptr) h[e] = dhT[i];
      if (ok && dcT != nullptr) d[e] = dcT[i];
    }
    carry[j * kConsumers + tid] = make_float4(h[0], h[1], h[2], h[3]);
    dcs[j * kConsumers + tid] = make_float4(d[0], d[1], d[2], d[3]);
  }

  float acc[kHP / 2], sum[kHP / 2];
#pragma unroll
  for (int e = 0; e < kHP / 2; ++e) acc[e] = sum[e] = 0.f;
  uint32_t ah[4][4], al[4][4];
  float x[4][4], xn[4][4];   // dz of gate g at cell e: this chunk's, the next

  // the gate math of cells e in [e0, e0 + 2) (row r0 + 8 (e0 / 2)) of chunk
  // cc (its step's unit block j) into y, dz to device memory
  auto gate_math = [&](int cc, int j, int e0, float (&y)[4][4]) {
    const int t = T - 1 - cc / kNB, u = 8 * j + 2 * tig, h = e0 >> 1;
    const float* p = in + (cc % kInStages) * kInBuf + (rl + 8 * h) * kInRow +
                     2 * tig;
    float4* slot = carry + j * kConsumers + tid;
    const float2 gi2 = *reinterpret_cast<const float2*>(p);
    const float2 gf2 = *reinterpret_cast<const float2*>(p + 8);
    const float2 gg2 = *reinterpret_cast<const float2*>(p + 16);
    const float2 go2 = *reinterpret_cast<const float2*>(p + 24);
    const float2 cp2 = *reinterpret_cast<const float2*>(p + 32);
    const float2 dy2 = *reinterpret_cast<const float2*>(p + 40);
    const float4 h4 = slot[0];
    float4 c4 = slot[kNB * kConsumers];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = e0 + q;
      const float gi = q ? gi2.y : gi2.x, gf = q ? gf2.y : gf2.x;
      const float gg = q ? gg2.y : gg2.x, go = q ? go2.y : go2.x;
      const float cpe = q ? cp2.y : cp2.x;
      const float hc = h ? (q ? h4.w : h4.z) : (q ? h4.y : h4.x);
      float& dcr = h ? (q ? c4.w : c4.z) : (q ? c4.y : c4.x);
      const float dht = hc + (q ? dy2.y : dy2.x);
      const float tc = tanh_acc(gf * cpe + gi * gg);
      const float dcc = dcr + dht * go * (1.f - tc * tc);
      y[0][e] = dcc * gg * gi * (1.f - gi);
      y[1][e] = dcc * cpe * gf * (1.f - gf);
      y[2][e] = dcc * gi * (1.f - gg * gg);
      y[3][e] = dht * tc * go * (1.f - go);
      dcr = dcc * gf;
    }
    float* dcw = reinterpret_cast<float*>(slot + kNB * kConsumers);
    *reinterpret_cast<float2*>(dcw + 2 * h) =
        h ? make_float2(c4.z, c4.w) : make_float2(c4.x, c4.y);
    // predicated stores, no branch: a branch between wgmma issues would
    // serialize them
    const bool st = u < H && (h ? ok1 : ok0);
    float* d = dz + ((size_t)t * B + (h ? i1 : i0)) * G + u;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      if (st)
        __stcs(reinterpret_cast<float2*>(d + g * H),
               make_float2(y[g][e0], y[g][e0 + 1]));
  };

  // chunk cc's inputs: landed, then (after both halves' gate math) freed
  auto inputs_ready = [&](int cc) {
    mbar_wait(&in_full[cc % kInStages], (uint32_t)(cc / kInStages) & 1u);
  };
  auto inputs_done = [&](int cc) { mbar_arrive(&in_empty[cc % kInStages]); };

  // chunk cc's products done: into the running sum, its W stage released
  auto finish = [&](int cc) {
    wg_wait0();
    fence_regs(acc);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      fence_regs(ah[g]);
      fence_regs(al[g]);
    }
#pragma unroll
    for (int e = 0; e < kHP / 2; ++e) sum[e] += acc[e];
    mbar_arrive(&w_empty[cc % kStages]);
  };

  // Chunk c's products are issued gate by gate, with the gate math of
  // chunk c + 1 between them (a warpgroup's wgmma issue waits while the
  // tensor cores are busy: the gate math fills that time). The first
  // chunk of a step waits for the step before it to finish (its carries).
  int c = 0;
  for (int t = T - 1; t >= 0; --t) {
#pragma unroll
    for (int j = 0; j < kNB; ++j, ++c) {
      if (j == 0) {
        if (c > 0) {
          // step t + 1's sum is whole: it is this step's dh_carry
          finish(c - 1);
#pragma unroll
          for (int b = 0; b < kNB; ++b) {
            carry[b * kConsumers + tid] = make_float4(
                sum[4 * b], sum[4 * b + 1], sum[4 * b + 2], sum[4 * b + 3]);
            sum[4 * b] = sum[4 * b + 1] = sum[4 * b + 2] = sum[4 * b + 3] = 0.f;
          }
        }
        inputs_ready(c);
        gate_math(c, 0, 0, x);
        gate_math(c, 0, 2, x);
        inputs_done(c);
      }
      const bool ahead = j + 1 < kNB;   // chunk c + 1 in this step
      mbar_wait(&w_full[c % kStages], (uint32_t)(c / kStages) & 1u);
      if (j > 0) finish(c - 1);
      if (ahead) inputs_ready(c + 1);
      // gate g's A fragment: (r0, slot tig) = cell 0, (r0 + 8, tig) = cell
      // 2, (r0, tig + 4) = cell 1, (r0 + 8, tig + 4) = cell 3
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float v[4] = {x[g][0], x[g][2], x[g][1], x[g][3]};
        split(v, ah[g], al[g]);
      }
      wg_fence();
      const uint32_t base = smem_addr(ring + (c % kStages) * kChunkB);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const uint64_t bh = desc_b(base + 2 * g * kTileB, 128, 256);
        const uint64_t bl = desc_b(base + (2 * g + 1) * kTileB, 128, 256);
        wgmma_tf32<kHP>(acc, al[g], bh, g > 0);
        wgmma_tf32<kHP>(acc, ah[g], bl, 1);
        wgmma_tf32<kHP>(acc, ah[g], bh, 1);
        if (ahead && g < 2) gate_math(c + 1, j + 1, 2 * g, xn);
      }
      wg_commit();
      if (ahead) {
        inputs_done(c + 1);
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) x[g][e] = xn[g][e];
      }
    }
  }
  finish(total - 1);

#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    const int u = 8 * j + 2 * tig;
    if (u >= H) continue;
    const float4 c4 = dcs[j * kConsumers + tid];
    if (ok0) {
      *reinterpret_cast<float2*>(dh0 + i0 * H + u) =
          make_float2(sum[4 * j], sum[4 * j + 1]);
      *reinterpret_cast<float2*>(dc0 + i0 * H + u) = make_float2(c4.x, c4.y);
    }
    if (ok1) {
      *reinterpret_cast<float2*>(dh0 + i1 * H + u) =
          make_float2(sum[4 * j + 2], sum[4 * j + 3]);
      *reinterpret_cast<float2*>(dc0 + i1 * H + u) = make_float2(c4.z, c4.w);
    }
  }
}

// ------------------------------------------------------ weight gradients

constexpr int kGR = 32;              // rows (the sum's k) a stage
constexpr int kGN = 128;             // dz columns a block: two warpgroups
constexpr int kDzS = kGN + 8;        // dz tile row stride, 8 mod 32
// P's B tiles: K-major core matrices of 8 columns x 4 rows, the two row
// halves LBO bytes apart and the column groups SBO apart: 160 and 304 make
// the transposing stores (8 rows x 16 columns a warp) hit 32 banks once
constexpr int kLbo = 160, kSbo = 304;

// dynamic shared memory of the dW pass with DX columns of x: three stages
// of dz, two of raw P and two of P's hi and lo tiles
__host__ __device__ constexpr int raw_stride(int dx) {
  return stride16(dx + kHP);
}
__host__ __device__ constexpr size_t dw_smem(int dx) {
  return sizeof(float) * (3 * (size_t)kGR * kDzS +
                          2 * (size_t)kGR * raw_stride(dx)) +
         4 * (size_t)(kGR / 8) * ((dx + kHP) / 8) * kSbo;
}

// part[chunk][kc][n] = Σ over the chunk's rows ρ = t B + b of P[ρ][kc]
// dz[ρ][n] (n < 4H; rows kc: x's 0 .. Dp - 1 (zeros past D), h's Dp .. Dp +
// H - 1, then with_db Σ dz[ρ][n] in row Dp + H and zeros up to Kc). Two
// warpgroups, dz's columns 64 each. Stage st's products are issued k-step by
// k-step, and between them each warp transposes its part of stage st + 1's
// P (a warpgroup's wgmma issue waits while the tensor cores are busy: the
// transposes fill that time); stage st + 2 loads meanwhile.
template <int DX>
__global__ void __launch_bounds__(2 * 128, 1)
lstm_wide_dw_kernel(const float* __restrict__ xs,
                    const float* __restrict__ h0,
                    const float* __restrict__ ys,
                    const float* __restrict__ dz, float* __restrict__ part,
                    int T, int B, int D, int H, int Kc, int with_db,
                    int rpc) {
  constexpr int kW = DX + kHP;              // P's staged columns
  constexpr int kRS = raw_stride(DX);
  constexpr int kTile = (kW / 8) * kSbo;    // bytes of a k-step's tile
  constexpr int kItems = (kGR / 8) * ((kW + 15) / 16);  // transpose items
  extern __shared__ __align__(128) unsigned char smem[];
  float* sdz = reinterpret_cast<float*>(smem);          // [3][kGR][kDzS]
  float* raw = sdz + 3 * kGR * kDzS;                    // [2][kGR][kRS]
  // P's tiles: [stage buffer][hi, lo][k-step][kTile bytes]
  unsigned char* tiles0 =
      reinterpret_cast<unsigned char*>(raw + 2 * kGR * kRS);

  const int G = 4 * H, Dp = round_up(D, 8), rows = T * B;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = (int)blockIdx.x * kGN;
  const int rbeg = (int)blockIdx.y * rpc;
  const int rend = min(rows, rbeg + rpc);
  const int nst = (rend - rbeg + kGR - 1) / kGR;
  const int nl = 16 * warp + gid;     // this lane's columns nl, nl + 8

  // stage st's rows of dz's columns and of raw P, into dz buffer st % 3
  // and raw buffer st % 2
  auto load = [&](int st) {
    const int r0 = rbeg + st * kGR;
    float* d = sdz + (st % 3) * kGR * kDzS;
#pragma unroll
    for (int k = 0; k < kGR * kGN / 4 / 256; ++k) {
      const int i = tid + 256 * k;
      const int r = i / (kGN / 4), col = 4 * (i % (kGN / 4));
      const int rho = r0 + r, n = n0 + col;
      const bool ok = rho < rend && n < G;
      cp_async16(d + r * kDzS + col, dz + (ok ? (size_t)rho * G + n : 0), ok);
    }
    float* p = raw + (st & 1) * kGR * kRS;
    for (int i = tid; i < kGR * kW / 4; i += 256) {
      const int r = i / (kW / 4), col = 4 * (i % (kW / 4));
      const int rho = r0 + r;
      const float* src = xs;
      bool ok = false;
      if (col < DX) {
        ok = rho < rend && col < D;
        if (ok) src = xs + (size_t)rho * D + col;
      } else {
        const int j = col - DX;
        ok = rho < rend && j < H;
        if (ok)
          src = rho >= B ? ys + (size_t)(rho - B) * H + j
                         : h0 + (size_t)rho * H + j;
      }
      cp_async16(p + r * kRS + col, ok ? src : dz, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // transpose item w of stage st's raw P into its hi and lo B tiles
  // (buffer st % 2): column c of P is the tile's column, row ρ its k
  // (k-step ρ / 8, slot ρ % 8); an item is 8 rows x 16 columns a warp
  auto transpose = [&](int st, int w) {
    const float* p = raw + (st & 1) * kGR * kRS;
    unsigned char* tiles = tiles0 + (st & 1) * 2 * (kGR / 8) * kTile;
    const int rs = lane >> 2, q = lane & 3;
    const int ks = w % (kGR / 8), cb = w / (kGR / 8);
    const int r = 8 * ks + rs, col = 16 * cb + 4 * q;
    if constexpr (kW % 16 != 0) {
      if (col >= kW) return;
    }
    const float4 v = *reinterpret_cast<const float4*>(p + r * kRS + col);
    const float vv[4] = {v.x, v.y, v.z, v.w};
    unsigned char* t = tiles + ks * kTile + (rs >> 2) * kLbo + (rs & 3) * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int cc = col + e;
      float* dst =
          reinterpret_cast<float*>(t + (cc >> 3) * kSbo + (cc & 7) * 16);
      const float hi = __uint_as_float(tf32(vv[e]));
      dst[0] = hi;
      dst[(kGR / 8) * kTile / 4] = __uint_as_float(tf32(vv[e] - hi));
    }
  };

  float acc_h[kHP / 2], sum_h[kHP / 2];
  float acc_x[DX > 0 ? DX / 2 : 1], sum_x[DX > 0 ? DX / 2 : 1];
#pragma unroll
  for (int e = 0; e < kHP / 2; ++e) acc_h[e] = sum_h[e] = 0.f;
#pragma unroll
  for (int e = 0; e < (DX > 0 ? DX / 2 : 1); ++e) acc_x[e] = sum_x[e] = 0.f;
  float db0 = 0.f, db1 = 0.f;
  uint32_t ah[kGR / 8][4], al[kGR / 8][4];

  load(0);
  if (nst > 1)
    load(1);
  else
    asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();
  for (int w = warp; w < kItems; w += 8) transpose(0, w);
  fence_async_smem();
  for (int st = 0; st < nst; ++st) {
    // stage st + 1 landed; stage st's tiles are whole; stage st - 1's
    // products are done (so its tiles, its raw P and dz are free)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (st + 2 < nst) load(st + 2);
    const float* d = sdz + (st % 3) * kGR * kDzS;
    float s0 = 0.f, s1 = 0.f;
    wg_fence();
    const uint32_t base =
        smem_addr(tiles0 + (st & 1) * 2 * (kGR / 8) * kTile);
#pragma unroll
    for (int ks = 0; ks < kGR / 8; ++ks) {
      const float* q = d + (8 * ks + tig) * kDzS + nl;
      const float v[4] = {q[0], q[8], q[4 * kDzS], q[4 * kDzS + 8]};
      s0 += v[0] + v[2];
      s1 += v[1] + v[3];
      split(v, ah[ks], al[ks]);
      const uint32_t hb = base + ks * kTile;
      const uint32_t lb = hb + (kGR / 8) * kTile;
      if constexpr (DX > 0) {
        wgmma_tf32<DX>(acc_x, al[ks], desc_b(hb, kLbo, kSbo), ks > 0);
        wgmma_tf32<DX>(acc_x, ah[ks], desc_b(lb, kLbo, kSbo), 1);
        wgmma_tf32<DX>(acc_x, ah[ks], desc_b(hb, kLbo, kSbo), 1);
      }
      const uint32_t off = (DX / 8) * kSbo;
      wgmma_tf32<kHP>(acc_h, al[ks], desc_b(hb + off, kLbo, kSbo), ks > 0);
      wgmma_tf32<kHP>(acc_h, ah[ks], desc_b(lb + off, kLbo, kSbo), 1);
      wgmma_tf32<kHP>(acc_h, ah[ks], desc_b(hb + off, kLbo, kSbo), 1);
      // this warp's share of stage st + 1's transposes, a quarter a k-step
      // (no branch between wgmma issues: past the items the last one is
      // done again, and after the last stage the transposes are of no
      // stage and go unread)
#pragma unroll
      for (int m = 0; m < (kItems + 31) / 32; ++m)
        transpose(st + 1, min(warp + 8 * ks + 32 * m, kItems - 1));
    }
    wg_commit();
    fence_async_smem();
    wg_wait0();
    fence_regs(acc_h);
    if constexpr (DX > 0) fence_regs(acc_x);
#pragma unroll
    for (int ks = 0; ks < kGR / 8; ++ks) {
      fence_regs(ah[ks]);
      fence_regs(al[ks]);
    }
#pragma unroll
    for (int e = 0; e < kHP / 2; ++e) sum_h[e] += acc_h[e];
    if constexpr (DX > 0) {
#pragma unroll
      for (int e = 0; e < DX / 2; ++e) sum_x[e] += acc_x[e];
    }
    db0 += s0;
    db1 += s1;
  }

  // the accumulator's row is dz's column n, its column P's column c
  float* out = part + (size_t)blockIdx.y * Kc * G;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int n = n0 + nl + 8 * hh;
    if (n >= G) continue;
    if constexpr (DX > 0) {
#pragma unroll
      for (int j = 0; j < DX / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kc = 8 * j + 2 * tig + e;
          if (kc < Dp) out[(size_t)kc * G + n] = sum_x[4 * j + 2 * hh + e];
        }
    }
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int u = 8 * j + 2 * tig + e;
        if (u < H) out[(size_t)(Dp + u) * G + n] = sum_h[4 * j + 2 * hh + e];
      }
  }
  if (with_db) {
    db0 += __shfl_xor_sync(0xffffffffu, db0, 1);
    db0 += __shfl_xor_sync(0xffffffffu, db0, 2);
    db1 += __shfl_xor_sync(0xffffffffu, db1, 1);
    db1 += __shfl_xor_sync(0xffffffffu, db1, 2);
    if (tig < 2) {
      const int n = n0 + nl + 8 * tig;
      if (n < G)
        for (int kc = Dp + H; kc < Kc; ++kc)
          out[(size_t)kc * G + n] = kc == Dp + H ? (tig ? db1 : db0) : 0.f;
    }
  }
}

// dxs[ρ][d] = Σ_c dz[ρ][c] W_ih[d][c] over the T·B rows: output tiles of 64
// rows x 64 columns (d < D), k = c over 4H in stages of 32, each stage's
// products summed from zero.
constexpr int kGemmThreads = 256;
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
    float sacc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
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
        mma_tf32(sacc[j], al, h0v, h1v);
        mma_tf32(sacc[j], ah, __uint_as_float(tf32(b0 - h0v)),
                 __uint_as_float(tf32(b1 - h1v)));
        mma_tf32(sacc[j], ah, h0v, h1v);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += sacc[j][e];
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

// the x columns of the dW pass: round_up(D, 8) rounded up to a power of two
// (0 without an input projection)
__host__ inline int dw_dx(int D) {
  const int dp = round_up(D, 8);
  return dp == 0 ? 0 : dp <= 8 ? 8 : dp <= 16 ? 16 : dp <= 32 ? 32 : 64;
}

// The row chunks of the dW pass: enough for one block an SM over the
// column slices, at least kGR rows each. -> (chunks, rows a chunk).
__host__ inline void dw_chunks(int rows, int G, int* nch, int* rpc) {
  constexpr int kSMs = 132;
  const int slices = (G + kGN - 1) / kGN;
  int n = (kSMs + slices - 1) / slices;
  const int most = (rows + kGR - 1) / kGR;
  n = n < 1 ? 1 : (n > most ? most : n);
  *rpc = round_up((rows + n - 1) / n, kGR);
  *nch = (rows + *rpc - 1) / *rpc;
}

template <int DX>
cudaError_t launch_dw(const float* xs, const float* h0, const float* ys,
                      const float* dz, float* part, int T, int B, int D,
                      int H, int Kc, int with_db, cudaStream_t st) {
  const size_t smem = dw_smem(DX);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_wide_dw_kernel<DX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int nch, rpc;
  dw_chunks(T * B, 4 * H, &nch, &rpc);
  const dim3 grid((4 * H + kGN - 1) / kGN, nch);
  lstm_wide_dw_kernel<DX><<<grid, 256, smem, st>>>(xs, h0, ys, dz, part, T,
                                                   B, D, H, Kc, with_db, rpc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The rows of the weight gradients, Kc = round_up(D, 8) + H (+ 8 with db),
// and the partials' chunks: part holds [chunks, Kc, 4H] floats.
int lstm_wide_bwd_chunks(int T, int B, int D, int H, int with_db) {
  int nch, rpc;
  dw_chunks(T * B, 4 * H, &nch, &rpc);
  return nch;
}

// The floats of the scratch wf: W_hhᵀ's split B tiles at kHP units.
int lstm_wide_bwd_wf_floats() { return kNB * kChunkB / 4; }

// K4 (D = 0; w_ih, xs and dxs null) or K6 (D in [4, 64], a multiple of 4).
// w_hh: [H, 4H]; h0, c0: [B, H]; ys, cs: [T, B, H] and gates [T, B, 4H] as
// the forward wrote them; dys [T, B, H], dhT, dcT [B, H]: each may be null
// (zero). Outputs: dz [T, B, 4H] (K4's dgx, or a scratch); dxs [T, B, D]
// (K6); dw [Kc, 4H]: rows 0 .. D - 1 dW_ih, round_up(D, 8) .. + H - 1
// dW_hh, then db (with_db) in the next row; dh0, dc0 [B, H]. Scratch: wf
// of lstm_wide_bwd_wf_floats() floats, part of lstm_wide_bwd_chunks() * Kc
// * 4H floats. All float32 and contiguous; xs, h0, c0, ys, gates, cs, dys,
// dz and wf at 16-byte aligned addresses; T >= 1, B >= 1, H a multiple of
// 8 in [8, 128]. Returns the CUDA error of the launches (0 = cudaSuccess).
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
  const int n = kNB * 4 * kHP * 8;
  split_bwd_kernel<<<(n + 255) / 256, 256, 0, st>>>(w_hh, H, wf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(lstm_wide_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kRecSmem);
  if (err != cudaSuccess) return (int)err;
  lstm_wide_bwd_kernel<<<(B + 63) / 64, kThreads, kRecSmem, st>>>(
      wf, c0, gates, cs, dys, dhT, dcT, dz, dh0, dc0, T, B, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  switch (dw_dx(D)) {
    case 0: err = launch_dw<0>(xs, h0, ys, dz, part, T, B, D, H, Kc, with_db,
                               st); break;
    case 8: err = launch_dw<8>(xs, h0, ys, dz, part, T, B, D, H, Kc, with_db,
                               st); break;
    case 16: err = launch_dw<16>(xs, h0, ys, dz, part, T, B, D, H, Kc,
                                 with_db, st); break;
    case 32: err = launch_dw<32>(xs, h0, ys, dz, part, T, B, D, H, Kc,
                                 with_db, st); break;
    default: err = launch_dw<64>(xs, h0, ys, dz, part, T, B, D, H, Kc,
                                 with_db, st); break;
  }
  if (err != cudaSuccess) return (int)err;
  int nch, rpc;
  dw_chunks(rows, G, &nch, &rpc);
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
