// Whole-loop LSTM recurrence, backward (kernel K4 of the port).
//
// Replaces the TPU kernel grouptraj/ops/pallas_fused.py:_bwd_kernel
// (launched from _run_bwd). Back-propagation through time in one launch,
// in reverse time, from what the forward (K3, lstm_fused_fwd.cu) saved: the
// post-activation gates [T, B, 4H] and the cell states cs [T, B, H]; the
// previous states are read by index (h_{t-1} = ys[t-1], c_{t-1} = cs[t-1],
// h0 and c0 at t = 0), never copied into shifted arrays. Per step
//
//   dh   = dh_carry + dys[t]
//   c    = f * c_prev + i * g,  tc = tanh(c)
//   dc   = dc_carry + dh * o * (1 - tc^2)
//   dz   = [dc*g*i*(1-i), dc*c_prev*f*(1-f), dc*i*(1-g^2), dh*tc*o*(1-o)]
//   dh_carry = dz @ W^T,  dc_carry = dc * f
//   dW  += h_{t-1}^T dz,  db += sum_rows dz  (decoder variant)
//   dgx[t] = dz                              (gx variant)
//
// and at the end dh0 = dh_carry, dc0 = dc_carry. dys, dhT and dcT may be
// null (a cotangent that is zero everywhere is never read).
//
// Bound on an H100 SXM at the discriminator encoder's d-step shape (T = 20,
// B = 8,192, H = 48, gx variant, a cotangent on hT only): the two products
// are 6.04 GFLOP; on the float32 cores (67 TFLOP/s), with the gate math,
// 0.093 ms; on the tensor cores as 3xTF32 (three TF32 products at 495
// TFLOP/s) 0.037 ms. The bytes set the bound either way: gates, cs, ys
// read and dgx written once, 322 MB at 3.35 TB/s, 0.0963 ms
// (chip_smoke.py:lstm_bound_ms gives both). The decoder variant (no dgx)
// is byte-bound too.
//
// Design: K6's (lstm_proj_bwd.cu) without the input projection. One block
// of 8 warps owns kR = 32 batch rows (two m16 tiles) for all T steps. Both
// products of a step run on the tensor cores as mma.sync m16n8k8 TF32 with
// float32 accumulate, in the 3xTF32 split x = hi + lo (tc_tf32.cuh;
// lo*hi + hi*lo + hi*hi), which keeps float32 accuracy:
//  1. dh_carry = dz · Wᵀ (m = 32, n = H, k = 4H). Warp w owns m-tile w % 2
//     and n-tiles w / 2, w / 2 + 4, ...: A (dz) read once per k-step, B for
//     its n-tiles. The lane that holds dh_carry[r][j] in the accumulator
//     keeps it there and forms the four gates' dz of (r, j) at the next
//     step; dc_carry and db's partial sums sit beside it in registers. The
//     gx variant writes dgx[t] from that float32 dz straight from the
//     registers: a quad of lanes stores one row's 8 units of a gate, one
//     whole 32-byte sector, and nothing waits for the store.
//  2. dW += h_{t-1}ᵀ · dz (m = H padded to 16, n = 4H, k = the block's 32
//     rows). Warp w owns the n-tiles (8 gate columns) w, w + 8, ... for all
//     m-tiles; its accumulators stay in registers for all T steps and are
//     the block's partial dW at the end. h_{t-1} is split into hi/lo once a
//     step for all warps.
// No branch sits between the mma of a k-loop: a warp's n-tile count is a
// template argument of (1)'s loop, chosen once a step, and every warp has
// all of (2)'s n-tiles where they divide evenly (H >= 16). A branch there
// costs a WARPSYNC before each mma (4% of the time at H = 48).
// Shared memory: W split once per block into hi/lo in the order the mma
// reads its B fragments (float32, split on read, where the pair does not
// fit: H = 64); one dz tile per step, split into hi/lo as it is written and
// read as A of (1) and B of (2); the step's gates, c_prev and dys and the
// h_{t-1} tile with its lo. Step t-1's inputs arrive by cp.async (zero-
// filled past B) while step t's products run: the gates, c_prev and dys
// tiles are consumed by the dz formation before the copy is issued, the h
// tile is double-buffered; each thread copies the same columns of one row
// every step. Two __syncthreads a step. Row strides are 8 mod 32 floats, so
// the fragment reads hit 32 banks. Dynamic shared memory: 192 KB at H = 48
// (149-170 registers: one block an SM), 108 KB at H = 32 (101-102
// registers: two blocks an SM), 208 KB at H = 64 (W split on read). A
// block leaves its dW (and db) as partial rows [block][H][4H] ([block]
// [4H]), stored with an L2 evict-last hint: where the grid runs in two
// waves, the first wave's rows must stay in L2 through the second wave's
// streams until the block-order sum, a second small kernel, reads them. No
// float atomics anywhere: the result is the same from run to run.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, from
// grouptraj_torch/proj_times.py --kernel K4): 0.224 ms at the d-step shape
// (0.197-0.199 of it this kernel, 0.018 the sum of 256 partial rows),
// against the float32-core design's 0.312-0.313. Taking out both
// products' mma, or all copies and the dgx stores, each shortens the
// one-wave B = 4,096 shape by a quarter or less; a second block an SM
// hides much of the rest (H = 32: forced to one block an SM the two-wave
// decoder shape is 1.34x slower), but 16 warps a block, two independently
// synchronised warp groups or a copy issued a step earlier did not shorten
// it at H = 48.

#include <type_traits>

#include "lstm_fused.cuh"
#include "tc_tf32.cuh"

namespace {

using namespace lstm_fused;
using namespace tc_tf32;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kR = 32;              // batch rows per block: two m16 tiles
constexpr int kSmemMax = 232448;    // bytes of shared memory a block may use

template <int H>
struct Geom {
  static constexpr int G = 4 * H;                     // gate columns
  static constexpr int NT1 = H / 8;                   // (1)'s n: dh_carry
  static constexpr int KS1 = G / 8;
  static constexpr int NTW1 = (NT1 + 3) / 4;          // (1)'s n-tiles a warp
  static constexpr int MP2 = (H + 15) / 16 * 16;      // (2)'s m: h, padded
  static constexpr int MT2 = MP2 / 16;
  static constexpr int NT2 = G / 8;
  static constexpr int NTW2 = (NT2 + kWarps - 1) / kWarps;  // (2)'s a warp
  // whether warp w's i-th n-tile of (2), w + kWarps i, exists: for every
  // warp where the n-tiles divide evenly (H >= 16), so that the compiler
  // sees no branch around those mma
  static __device__ bool has2(int w, int i) {
    return NT2 % kWarps == 0 || w + kWarps * i < NT2;
  }
  static constexpr int KS2 = kR / 8;
  static constexpr int SZ = stride8(G);    // dz hi, dz lo, gates
  static constexpr int SH = stride8(H);    // c_prev, dys
  static constexpr int SX = stride8(MP2);  // [h_{t-1} | 0]: two buffers, lo
  static constexpr int kTiles = 3 * kR * SZ + 2 * kR * SH + 3 * kR * SX;
  static constexpr int kFrags = KS1 * NT1 * 32;
  static constexpr bool kPair =
      sizeof(float) * (kTiles + 4 * kFrags) <= (size_t)kSmemMax;
  static constexpr int SL = kPair ? 4 : 2;  // floats a lane and W fragment
  static constexpr size_t kSmem = sizeof(float) * (kTiles + SL * kFrags);
  static_assert(kSmem <= (size_t)kSmemMax, "K4's tiles exceed shared memory");
};

__device__ __forceinline__ float pick(float2 v, int q) { return q ? v.y : v.x; }

// a store that asks L2 to keep the line: a block of the first wave leaves
// its partial rows long before the block-order sum reads them, and the
// second wave streams its gates and dgx through L2 meanwhile
__device__ __forceinline__ void store_kept(float* p, float2 v) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(policy));
  asm volatile("st.global.L2::cache_hint.v2.f32 [%0], {%1, %2}, %3;\n"
               ::"l"(p), "f"(v.x), "f"(v.y), "l"(policy) : "memory");
}

template <int H, bool WITH_GX>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fused_bwd_kernel(const float* __restrict__ w,
                      const float* __restrict__ h0,
                      const float* __restrict__ c0,
                      const float* __restrict__ ys,
                      const float* __restrict__ gates,
                      const float* __restrict__ cs,
                      const float* __restrict__ dys,
                      const float* __restrict__ dhT,
                      const float* __restrict__ dcT, float* __restrict__ dgx,
                      float* __restrict__ dw_part, float* __restrict__ db_part,
                      float* __restrict__ dh0, float* __restrict__ dc0, int T,
                      int B) {
  using Gm = Geom<H>;
  constexpr int G = Gm::G, NT1 = Gm::NT1, NTW1 = Gm::NTW1, MT2 = Gm::MT2;
  constexpr int NT2 = Gm::NT2, NTW2 = Gm::NTW2, SL = Gm::SL;
  constexpr int SZ = Gm::SZ, SH = Gm::SH, SX = Gm::SX, MP2 = Gm::MP2;

  extern __shared__ __align__(16) float smem[];
  float* sw = smem;                     // W's B fragments [KS1][NT1][32][SL]
  float* szh = sw + SL * Gm::kFrags;    // dz hi [kR][SZ]
  float* szl = szh + kR * SZ;           // dz lo
  float* sg = szl + kR * SZ;            // gates [kR][SZ]
  float* scp = sg + kR * SZ;            // c_prev [kR][SH]
  float* sdy = scp + kR * SH;           // dys [kR][SH]
  float* shp = sdy + kR * SH;           // [2][kR][SX]: h_{t-1} | 0, then hi
  float* shl = shp + 2 * kR * SX;       // [kR][SX]: lo of h_{t-1} | 0

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int row_base = blockIdx.x * kR;
  const int mt = warp & 1, nt0 = warp >> 1;   // (1): m-tile, first n-tile

  // cp.async of step s's inputs: gates[s], c_{s-1}, dys[s] and h_{s-1}
  // (into h buffer s % 2); one commit group. Thread (sr, sc) copies the
  // 16-byte chunks sc, sc + kCT, ... of row sr: the same rows and columns
  // every step, so a copy costs no address arithmetic beyond the step's.
  constexpr int kCT = kThreads / kR;    // threads a row
  static_assert(G / 4 % kCT == 0, "a row's gate chunks split evenly");
  const int sr = tid / kCT, sc = tid % kCT;
  const bool sok = row_base + sr < B;
  const size_t srow = sok ? row_base + sr : 0;  // rows past B: read nothing
  auto stage = [&](int s) {
    float* hb = shp + (s & 1) * kR * SX;
    const float* gsrc = gates + ((size_t)s * B + srow) * G + 4 * sc;
    float* gd = sg + sr * SZ + 4 * sc;
#pragma unroll
    for (int k = 0; k < G / 4 / kCT; ++k)
      cp_async16(gd + 4 * kCT * k, gsrc + 4 * kCT * k, sok);
    const size_t off = srow * H + 4 * sc;
    const float* cprev = (s > 0 ? cs + (size_t)(s - 1) * B * H : c0) + off;
    const float* hprev = (s > 0 ? ys + (size_t)(s - 1) * B * H : h0) + off;
#pragma unroll
    for (int k = 0; k < (H / 4 + kCT - 1) / kCT; ++k) {
      const int c = 4 * (sc + kCT * k);
      if (c >= H) break;
      cp_async16(scp + sr * SH + c, cprev + 4 * kCT * k, sok);
      cp_async16(hb + sr * SX + c, hprev + 4 * kCT * k, sok);
      if (dys != nullptr)
        cp_async16(sdy + sr * SH + c,
                   dys + (size_t)s * B * H + off + 4 * kCT * k, sok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  stage(T - 1);  // the first step's copy runs while W is split

  // W [H, 4H] -> fragments: b0 / b1 of n-tile nt, k-step ks and lane
  // (gid, tig) at n = 8 nt + gid, k = 8 ks + 2 tig + {0, 1}. The loads go
  // out kBatch at a time: one after another, each would wait for L2.
  constexpr int kW = H * G, kBatch = 16;
  for (int i0 = tid; i0 < kW; i0 += kBatch * kThreads) {
    float wv[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int idx = i0 + k * kThreads;
      wv[k] = idx < kW ? w[idx] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int idx = i0 + k * kThreads, n = idx / G, c = idx % G;
      if (idx >= kW) break;
      const int half = c & 1, lw = (n % 8) * 4 + (c % 8) / 2;
      float* slot = sw + (((c / 8) * NT1 + n / 8) * 32 + lw) * SL;
      if (Gm::kPair) {
        const uint32_t hi = tf32(wv[k]);
        slot[half] = __uint_as_float(hi);
        slot[2 + half] = __uint_as_float(tf32(wv[k] - __uint_as_float(hi)));
      } else {
        slot[half] = wv[k];
      }
    }
  }
  if (dys == nullptr)
    for (int i = tid; i < kR * SH; i += kThreads) sdy[i] = 0.f;
  constexpr int kPad = MP2 - H;         // zero columns of the h tiles
  if constexpr (kPad > 0)
    for (int i = tid; i < 3 * kR * kPad; i += kThreads)
      shp[(i / kPad) * SX + H + i % kPad] = 0.f;

  // (1)'s tile i is n-tile nt0 + 4 i (while below H / 8). Element e of a
  // tile: row 16 mt + gid + 8 (e / 2), unit 8 nt + 2 tig + e % 2.
  float carry[NTW1][4], dc[NTW1][4], db[NTW1][4][2];
#pragma unroll
  for (int i = 0; i < NTW1; ++i) {
    const int nt = nt0 + 4 * i;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row_base + 16 * mt + gid + 8 * (e >> 1);
      const size_t at = (size_t)row * H + 8 * nt + 2 * tig + (e & 1);
      const bool live = nt < NT1 && row < B;
      carry[i][e] = live && dhT != nullptr ? dhT[at] : 0.f;
      dc[i][e] = live && dcT != nullptr ? dcT[at] : 0.f;
      db[i][e][0] = db[i][e][1] = 0.f;
    }
  }
  float acc2[NTW2][MT2][4];
#pragma unroll
  for (int i = 0; i < NTW2; ++i)
#pragma unroll
    for (int m = 0; m < MT2; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[i][m][e] = 0.f;

  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    // h_{t-1} split into hi (in place) and lo, once for all warps' A
    // fragments of (2)
    {
      float* hb = shp + (t & 1) * kR * SX;
      for (int i = 2 * tid; i < kR * SX; i += 2 * kThreads) {
        const float2 v = *reinterpret_cast<const float2*>(hb + i);
        float2 hi, lo;
        hi.x = __uint_as_float(tf32(v.x));
        hi.y = __uint_as_float(tf32(v.y));
        lo.x = __uint_as_float(tf32(v.x - hi.x));
        lo.y = __uint_as_float(tf32(v.y - hi.y));
        *reinterpret_cast<float2*>(hb + i) = hi;
        *reinterpret_cast<float2*>(shl + i) = lo;
      }
    }
    // dz of the (row, unit) pairs of this lane's dh tiles, split into the
    // shared dz tile (and, gx variant, written to dgx[t]); rows past B are
    // zeros throughout
#pragma unroll
    for (int i = 0; i < NTW1; ++i) {
      const int nt = nt0 + 4 * i;
      if (nt >= NT1) continue;            // warp-uniform
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * mt + gid + 8 * h, j = 8 * nt + 2 * tig;
        float2 gv[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          gv[g] = *reinterpret_cast<const float2*>(sg + r * SZ + g * H + j);
        const float2 cpv = *reinterpret_cast<const float2*>(scp + r * SH + j);
        const float2 dyv = *reinterpret_cast<const float2*>(sdy + r * SH + j);
        float dz[4][2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int e = 2 * h + q;
          const float gi = pick(gv[0], q), gf = pick(gv[1], q);
          const float gg = pick(gv[2], q), go = pick(gv[3], q);
          const float cp = pick(cpv, q);
          const float dht = carry[i][e] + pick(dyv, q);
          const float tc = tanhf(gf * cp + gi * gg);
          const float dcc = dc[i][e] + dht * go * (1.f - tc * tc);
          dz[0][q] = dcc * gg * gi * (1.f - gi);
          dz[1][q] = dcc * cp * gf * (1.f - gf);
          dz[2][q] = dcc * gi * (1.f - gg * gg);
          dz[3][q] = dht * tc * go * (1.f - go);
          dc[i][e] = dcc * gf;
        }
        const int row = row_base + r;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          if (WITH_GX) {
            if (row < B)
              __stcs(reinterpret_cast<float2*>(
                         dgx + ((size_t)t * B + row) * G + g * H + j),
                     make_float2(dz[g][0], dz[g][1]));
          } else {
            db[i][g][0] += dz[g][0];
            db[i][g][1] += dz[g][1];
          }
          float2 hi, lo;
          hi.x = __uint_as_float(tf32(dz[g][0]));
          hi.y = __uint_as_float(tf32(dz[g][1]));
          lo.x = __uint_as_float(tf32(dz[g][0] - hi.x));
          lo.y = __uint_as_float(tf32(dz[g][1] - hi.y));
          *reinterpret_cast<float2*>(szh + r * SZ + g * H + j) = hi;
          *reinterpret_cast<float2*>(szl + r * SZ + g * H + j) = lo;
        }
      }
    }
    __syncthreads();  // dz is whole; gates, c_prev and dys are consumed
    if (t > 0) stage(t - 1);

    // (1) dh_carry = dz · Wᵀ over the warp's NM n-tiles; the lo terms and
    // hi*hi in two accumulators (two dependency chains), summed at the end
    auto product1 = [&](auto tiles) {
      constexpr int NM = decltype(tiles)::value;
      float acc1[NM][2][4];
#pragma unroll
      for (int i = 0; i < NM; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc1[i][0][e] = acc1[i][1][e] = 0.f;
#pragma unroll 8
      for (int ks = 0; ks < Gm::KS1; ++ks) {
        const int a0 = (16 * mt + gid) * SZ + 8 * ks + 2 * tig;
        const int a1 = a0 + 8 * SZ;
        const float2 h0v = *reinterpret_cast<const float2*>(szh + a0);
        const float2 h1v = *reinterpret_cast<const float2*>(szh + a1);
        const float2 l0v = *reinterpret_cast<const float2*>(szl + a0);
        const float2 l1v = *reinterpret_cast<const float2*>(szl + a1);
        const uint32_t ah[4] = {
            __float_as_uint(h0v.x), __float_as_uint(h1v.x),
            __float_as_uint(h0v.y), __float_as_uint(h1v.y)};
        const uint32_t al[4] = {
            __float_as_uint(l0v.x), __float_as_uint(l1v.x),
            __float_as_uint(l0v.y), __float_as_uint(l1v.y)};
#pragma unroll
        for (int i = 0; i < NM; ++i) {
          const int nt = nt0 + 4 * i;
          const float* slot = sw + ((ks * NT1 + nt) * 32 + lane) * SL;
          float4 wf;
          if (Gm::kPair) {
            wf = *reinterpret_cast<const float4*>(slot);
          } else {
            const float2 v = *reinterpret_cast<const float2*>(slot);
            wf.x = __uint_as_float(tf32(v.x));
            wf.y = __uint_as_float(tf32(v.y));
            wf.z = __uint_as_float(tf32(v.x - wf.x));
            wf.w = __uint_as_float(tf32(v.y - wf.y));
          }
          mma_tf32(acc1[i][1], al, wf.x, wf.y);
          mma_tf32(acc1[i][1], ah, wf.z, wf.w);
          mma_tf32(acc1[i][0], ah, wf.x, wf.y);
        }
      }
#pragma unroll
      for (int i = 0; i < NM; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          carry[i][e] = acc1[i][1][e] + acc1[i][0][e];
    };
    // All NTW1 n-tiles, or one fewer where they do not divide evenly (H =
    // 48: n-tiles 4, 5 go to the first two warp pairs); the choice is made
    // once, outside the k-loop, so that no branch sits between the mma.
    if (NT1 % 4 == 0 || nt0 + 4 * (NTW1 - 1) < NT1)
      product1(std::integral_constant<int, NTW1>{});
    else if constexpr (NTW1 > 1)
      product1(std::integral_constant<int, NTW1 - 1>{});

    // (2) dW += h_{t-1}ᵀ · dz: k = the block's rows, b0 / b1 at rows
    // 8 ks + tig and + 4
    const float* hb = shp + (t & 1) * kR * SX;   // hi of h_{t-1}
#pragma unroll
    for (int ks = 0; ks < Gm::KS2; ++ks) {
      const int r0 = 8 * ks + tig;
      float bh[NTW2][2], bl[NTW2][2];
#pragma unroll
      for (int i = 0; i < NTW2; ++i) {
        const int col = 8 * (warp + 8 * i) + gid;
        if (!Gm::has2(warp, i)) continue;
        bh[i][0] = szh[r0 * SZ + col];
        bh[i][1] = szh[(r0 + 4) * SZ + col];
        bl[i][0] = szl[r0 * SZ + col];
        bl[i][1] = szl[(r0 + 4) * SZ + col];
      }
#pragma unroll
      for (int m = 0; m < MT2; ++m) {
        const int u = 16 * m + gid;
        const int a0 = r0 * SX + u, a1 = (r0 + 4) * SX + u;
        const uint32_t ah[4] = {
            __float_as_uint(hb[a0]), __float_as_uint(hb[a0 + 8]),
            __float_as_uint(hb[a1]), __float_as_uint(hb[a1 + 8])};
        const uint32_t al[4] = {
            __float_as_uint(shl[a0]), __float_as_uint(shl[a0 + 8]),
            __float_as_uint(shl[a1]), __float_as_uint(shl[a1 + 8])};
#pragma unroll
        for (int i = 0; i < NTW2; ++i) {
          if (!Gm::has2(warp, i)) continue;
          mma_tf32(acc2[i][m], al, bh[i][0], bh[i][1]);
          mma_tf32(acc2[i][m], ah, bl[i][0], bl[i][1]);
          mma_tf32(acc2[i][m], ah, bh[i][0], bh[i][1]);
        }
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // dz is consumed; step t - 1's inputs are in
  }

#pragma unroll
  for (int i = 0; i < NTW1; ++i) {
    const int nt = nt0 + 4 * i;
    if (nt >= NT1) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_base + 16 * mt + gid + 8 * h;
      if (row < B) {
        const size_t at = (size_t)row * H + 8 * nt + 2 * tig;
        *reinterpret_cast<float2*>(dh0 + at) =
            make_float2(carry[i][2 * h], carry[i][2 * h + 1]);
        *reinterpret_cast<float2*>(dc0 + at) =
            make_float2(dc[i][2 * h], dc[i][2 * h + 1]);
      }
    }
  }
  // this block's partial dW [H][4H]
  float* p = dw_part + (size_t)blockIdx.x * (H * G);
#pragma unroll
  for (int i = 0; i < NTW2; ++i) {
    if (!Gm::has2(warp, i)) continue;
    const int col = 8 * (warp + 8 * i) + 2 * tig;
#pragma unroll
    for (int m = 0; m < MT2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int u = 16 * m + gid + 8 * h;
        if (u < H)
          store_kept(p + u * G + col,
                     make_float2(acc2[i][m][2 * h], acc2[i][m][2 * h + 1]));
      }
  }
  if constexpr (!WITH_GX) {
    // db: a lane's rows, then the m-tile's 16 rows by shuffles (fixed
    // order), then the two m-tiles through shared memory (the dz tile, now
    // free)
    float* sdb = szh;
#pragma unroll
    for (int i = 0; i < NTW1; ++i) {
      const int nt = nt0 + 4 * i;
      if (nt >= NT1) continue;
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float v = db[i][g][q];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (gid == 0) sdb[mt * G + g * H + 8 * nt + 2 * tig + q] = v;
        }
    }
    __syncthreads();
    for (int c = tid; c < G; c += kThreads)
      db_part[(size_t)blockIdx.x * G + c] = sdb[c] + sdb[G + c];
  }
}

template <int H, bool WITH_GX>
cudaError_t launch(const float* w, const float* h0, const float* c0,
                   const float* ys, const float* gates, const float* cs,
                   const float* dys, const float* dhT, const float* dcT,
                   float* dgx, float* dw_part, float* db_part, float* dw,
                   float* db, float* dh0, float* dc0, int T, int B,
                   cudaStream_t stream) {
  constexpr size_t smem = Geom<H>::kSmem;
  auto kernel = lstm_fused_bwd_kernel<H, WITH_GX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + kR - 1) / kR;
  kernel<<<blocks, kThreads, smem, stream>>>(w, h0, c0, ys, gates, cs, dys,
                                             dhT, dcT, dgx, dw_part, db_part,
                                             dh0, dc0, T, B);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int kSumThreads = 128;
  constexpr int n = 4 * H * H;
  reduce_partials_kernel<<<(n + kSumThreads - 1) / kSumThreads, kSumThreads,
                           0, stream>>>(dw_part, dw, blocks, n);
  err = cudaGetLastError();
  if (err != cudaSuccess || WITH_GX) return err;
  reduce_partials_kernel<<<(4 * H + kSumThreads - 1) / kSumThreads,
                           kSumThreads, 0, stream>>>(db_part, db, blocks,
                                                     4 * H);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Batch rows one block owns: the partials are [ceil(B / rows), ...].
int lstm_fused_bwd_rows_per_block() { return kR; }

// w: [H, 4H]; h0, c0: [B, H]; ys, cs: [T, B, H] and gates [T, B, 4H] as the
// forward wrote them; dys [T, B, H], dhT, dcT [B, H]: each may be null
// (zero). Outputs: dgx [T, B, 4H] (with_gx = 1) or db [4H] with its partials
// db_part [nb, 4H] (with_gx = 0); dw [H, 4H] with dw_part [nb, H, 4H];
// dh0, dc0 [B, H]; nb = ceil(B / lstm_fused_bwd_rows_per_block()). All
// float32 and contiguous, h0, c0, ys, gates, cs and dys at 16-byte aligned
// addresses (they are copied by cp.async); T >= 1, B >= 1, H in {8, 16,
// 32, 48, 64}. Returns the CUDA error of the launches (0 = cudaSuccess).
int lstm_fused_bwd(const float* w, const float* h0, const float* c0,
                   const float* ys, const float* gates, const float* cs,
                   const float* dys, const float* dhT, const float* dcT,
                   float* dgx, float* dw_part, float* db_part, float* dw,
                   float* db, float* dh0, float* dc0, int T, int B, int H,
                   int with_gx, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (with_gx) {
    LSTM_FUSED_DISPATCH_H(
        H, err = (launch<kH, true>(w, h0, c0, ys, gates, cs, dys, dhT, dcT,
                                   dgx, dw_part, db_part, dw, db, dh0, dc0, T,
                                   B, st)));
  } else {
    LSTM_FUSED_DISPATCH_H(
        H, err = (launch<kH, false>(w, h0, c0, ys, gates, cs, dys, dhT, dcT,
                                    dgx, dw_part, db_part, dw, db, dh0, dc0,
                                    T, B, st)));
  }
  return (int)err;
}

const char* lstm_fused_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
