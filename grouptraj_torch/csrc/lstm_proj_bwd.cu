// LSTM with its input projection in the kernel, backward (kernel K6 of the
// port).
//
// Replaces the TPU kernel grouptraj/ops/pallas_lstm.py:_bwd_kernel
// (launched from _bwd_rule). Back-propagation through time in one launch,
// in reverse time, from what the forward (K5, lstm_proj_fwd.cu) saved: the
// post-activation gates [T, B, 4H] and the cell states cs [T, B, H]; the
// previous states are read by index (h_{t-1} = ys[t-1], c_{t-1} = cs[t-1],
// h0 and c0 at t = 0), never copied into shifted arrays. Per step
//
//   dh   = dh_carry + dys[t]
//   c    = f * c_prev + i * g,  tc = tanh(c)
//   dc   = dc_carry + dh * o * (1 - tc^2)
//   dz   = [dc*g*i*(1-i), dc*c_prev*f*(1-f), dc*i*(1-g^2), dh*tc*o*(1-o)]
//   [dh_carry | dxs[t]] = dz @ [W_hh ; W_ih]^T,  dc_carry = dc * f
//   [dW_hh ; dW_ih] += [h_{t-1} | x_t]^T dz,     db += sum_rows dz
//
// and at the end dh0 = dh_carry, dc0 = dc_carry. dys, dhT and dcT may be
// null (a cotangent that is zero everywhere is never read).
//
// Bound on an H100 SXM at the discriminator encoder's d-step shape (T = 20,
// B = 8,192, D = 16, H = 48, a cotangent on hT only): the four products are
// 8.05 GFLOP. On the float32 cores (67 TFLOP/s), with the gate math, that
// is 0.123 ms. On the tensor cores as 3xTF32 (three TF32 products at 495
// TFLOP/s) it is 0.049 ms, so the bytes set the bound: xs, ys, gates, cs
// and the cotangents read and dxs written once, 218 MB at 3.35 TB/s,
// 0.065 ms (chip_smoke.py:proj_bound_ms gives both).
//
// Design. One block of 8 warps owns kR = 32 batch rows (two m16 tiles) for
// all T steps, one block an SM. Both products of a step run on the tensor
// cores as mma.sync m16n8k8 TF32 with float32 accumulate, in the 3xTF32
// split x = hi + lo (tc_tf32.cuh; lo*hi + hi*lo + hi*hi), which keeps
// float32 accuracy:
//  1. [dh_carry | dxs[t]] = dz · Wcatᵀ, Wcat = [W_hh ; W_ih] as one
//     [(H + D), 4H] matrix, n padded to a multiple of 8. Warp w owns m-tile
//     w % 2 and n-tiles w / 2, w / 2 + 4, ...: A (dz) read once per k-step,
//     B for its n-tiles. The lane that holds dh_carry[r][j] in the
//     accumulator keeps it there and forms the four gates' dz of (r, j) at
//     the next step; dc_carry and db's partial sums sit beside it in
//     registers. The dxs columns go to device memory from the accumulator.
//  2. [dW_hh ; dW_ih] += [h_{t-1} | x_t]ᵀ · dz, m = H + D padded to 16, k =
//     the block's 32 rows. Warp w owns the n-tiles (8 gate columns) w, w + 8,
//     ... for all m-tiles; its accumulators stay in registers for all T steps
//     and are the block's partial row at the end.
// Shared memory: Wcat split once per block into hi/lo in the order the mma
// reads its B fragments (float32, split on read, where the pair does not
// fit: H = 64); one dz tile per step, split into hi/lo as it is written and
// read as A of (1) and B of (2); the step's gates, c_prev, dys and
// [h_{t-1} | x_t]. Step t-1's inputs arrive by cp.async (zero-filled past
// B) while step t's products run: the gates, c_prev and dys tiles are
// consumed by the dz formation before the copy is issued, the [h | x] tile
// is double-buffered. Two __syncthreads a step. Row strides are 8 mod 32
// floats, so the fragment reads hit 32 banks. Wcat is split in every block
// (a few hundred operations a thread, once per call) rather than by a
// separate kernel into a scratch buffer: it keeps the library's interface.
// A block leaves its dW_ih, dW_hh and db side by side as one partial row
// [block][(D + H + 1) * 4H]; a second small kernel sums the rows in block
// order. No float atomics anywhere: the result is the same from run to run.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, from
// grouptraj_torch/proj_times.py): 0.264-0.268 ms at the d-step shape
// (0.231-0.236 of it this kernel, 0.025 the sum of 256 partial rows),
// against the float32-core design's 0.578-0.582. Taking out either
// product's mma shortens the one-wave shape (B = 4,096) by 0.036-0.042 of
// 0.125 ms: each product is ~a third, the dz formation, the copies and the
// two barriers of a step the rest. At 203 registers and ~212 KB of shared
// memory one block runs per SM, so B = 8,192 takes two waves.

#include "lstm_proj.cuh"
#include "tc_tf32.cuh"

namespace {

using namespace lstm_fused;
using namespace tc_tf32;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kR = 32;              // batch rows per block: two m16 tiles
constexpr int kSmemMax = 232448;    // bytes of shared memory a block may use

template <int D, int H>
struct Geom {
  static constexpr int G = 4 * H;                     // gate columns
  static constexpr int NP = (H + D + 7) / 8 * 8;      // (1)'s n: dh | dxs
  static constexpr int NT1 = NP / 8;
  static constexpr int KS1 = G / 8;
  static constexpr int NTW1 = (NT1 + 3) / 4;          // (1)'s n-tiles a warp
  static constexpr int NP2 = (H + D + 15) / 16 * 16;  // (2)'s m: h | x
  static constexpr int MT2 = NP2 / 16;
  static constexpr int NT2 = G / 8;
  static constexpr int NTW2 = (NT2 + kWarps - 1) / kWarps;  // (2)'s a warp
  static constexpr int KS2 = kR / 8;
  static constexpr int SZ = stride8(G);    // dz hi, dz lo, gates
  static constexpr int SH = stride8(H);    // c_prev, dys
  static constexpr int SX = stride8(NP2);  // [h_{t-1} | x_t | 0], two buffers
  static constexpr int kTiles = 3 * kR * SZ + 2 * kR * SH + 2 * kR * SX;
  static constexpr int kFrags = KS1 * NT1 * 32;
  static constexpr bool kPair =
      sizeof(float) * (kTiles + 4 * kFrags) <= (size_t)kSmemMax;
  static constexpr int SL = kPair ? 4 : 2;  // floats a lane and W fragment
  static constexpr size_t kSmem = sizeof(float) * (kTiles + SL * kFrags);
  static_assert(kSmem <= (size_t)kSmemMax, "K6's tiles exceed shared memory");
};

__device__ __forceinline__ float pick(float2 v, int q) { return q ? v.y : v.x; }

template <int D, int H>
__global__ void __launch_bounds__(kThreads, 1)
lstm_proj_bwd_kernel(const float* __restrict__ w_ih,
                     const float* __restrict__ w_hh,
                     const float* __restrict__ xs,
                     const float* __restrict__ h0,
                     const float* __restrict__ c0,
                     const float* __restrict__ ys,
                     const float* __restrict__ gates,
                     const float* __restrict__ cs,
                     const float* __restrict__ dys,
                     const float* __restrict__ dhT,
                     const float* __restrict__ dcT, float* __restrict__ dxs,
                     float* __restrict__ part, float* __restrict__ dh0,
                     float* __restrict__ dc0, int T, int B) {
  using Gm = Geom<D, H>;
  constexpr int G = Gm::G, NT1 = Gm::NT1, NTW1 = Gm::NTW1, MT2 = Gm::MT2;
  constexpr int NT2 = Gm::NT2, NTW2 = Gm::NTW2, SL = Gm::SL;
  constexpr int SZ = Gm::SZ, SH = Gm::SH, SX = Gm::SX, NP2 = Gm::NP2;

  extern __shared__ __align__(16) float smem[];
  float* sw = smem;                     // Wcat's B fragments [KS1][NT1][32][SL]
  float* szh = sw + SL * Gm::kFrags;    // dz hi [kR][SZ]
  float* szl = szh + kR * SZ;           // dz lo
  float* sg = szl + kR * SZ;            // gates [kR][SZ]
  float* scp = sg + kR * SZ;            // c_prev [kR][SH]
  float* sdy = scp + kR * SH;           // dys [kR][SH]
  float* shx = sdy + kR * SH;           // [2][kR][SX]: h_{t-1} | x_t | 0

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int row_base = blockIdx.x * kR;
  const int mt = warp & 1, nt0 = warp >> 1;   // (1): m-tile, first n-tile

  // cp.async of step s's inputs: gates[s], c_{s-1}, dys[s] and h_{s-1}, x_s
  // (into [h | x] buffer s % 2); one commit group
  auto stage = [&](int s) {
    float* hx = shx + (s & 1) * kR * SX;
    const size_t at = (size_t)s * B;
    for (int q = tid; q < kR * (G / 4); q += kThreads) {
      const int r = q / (G / 4), c = 4 * (q % (G / 4)), row = row_base + r;
      const bool ok = row < B;
      cp_async16(sg + r * SZ + c, gates + (ok ? (at + row) * G + c : 0), ok);
    }
    const float* cprev = s > 0 ? cs + (at - B) * H : c0;
    const float* hprev = s > 0 ? ys + (at - B) * H : h0;
    for (int q = tid; q < kR * (H / 4); q += kThreads) {
      const int r = q / (H / 4), c = 4 * (q % (H / 4)), row = row_base + r;
      const bool ok = row < B;
      const size_t off = ok ? (size_t)row * H + c : 0;
      cp_async16(scp + r * SH + c, cprev + off, ok);
      cp_async16(hx + r * SX + c, hprev + off, ok);
      if (dys != nullptr)
        cp_async16(sdy + r * SH + c, dys + (ok ? at * H + off : 0), ok);
    }
    for (int q = tid; q < kR * (D / 4); q += kThreads) {
      const int r = q / (D / 4), c = 4 * (q % (D / 4)), row = row_base + r;
      const bool ok = row < B;
      cp_async16(hx + r * SX + H + c, xs + (ok ? (at + row) * D + c : 0), ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  stage(T - 1);  // the first step's copy runs while Wcat is split

  // Wcat [(H + D), 4H] -> fragments: b0 / b1 of n-tile nt, k-step ks and
  // lane (gid, tig) at n = 8 nt + gid, k = 8 ks + 2 tig + {0, 1}. The loads
  // go out kBatch at a time: one after another, each would wait for L2.
  constexpr int kW = Gm::NP * G, kBatch = 16;
  for (int i0 = tid; i0 < kW; i0 += kBatch * kThreads) {
    float wv[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int idx = i0 + k * kThreads, n = idx / G;
      wv[k] = idx >= kW || n >= H + D ? 0.f
              : n < H ? w_hh[idx] : w_ih[idx - H * G];
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
  constexpr int kPad = NP2 - H - D;     // zero columns of the [h | x] tiles
  if constexpr (kPad > 0)
    for (int i = tid; i < 2 * kR * kPad; i += kThreads)
      shx[(i / kPad) * SX + H + D + i % kPad] = 0.f;

  // (1)'s tile i is n-tile nt0 + 4 i: dh_carry where below H / 8, else dxs.
  // Element e of a tile: row 16 mt + gid + 8 (e / 2), column 2 tig + e % 2.
  float carry[NTW1][4], dc[NTW1][4], db[NTW1][4][2];
#pragma unroll
  for (int i = 0; i < NTW1; ++i) {
    const int nt = nt0 + 4 * i;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row_base + 16 * mt + gid + 8 * (e >> 1);
      const size_t at = (size_t)row * H + 8 * nt + 2 * tig + (e & 1);
      const bool live = nt < H / 8 && row < B;
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
    // dz of the (row, unit) pairs of this lane's dh tiles, split into the
    // shared dz tile; rows past B are zeros throughout
#pragma unroll
    for (int i = 0; i < NTW1; ++i) {
      const int nt = nt0 + 4 * i;
      if (nt >= H / 8) continue;          // warp-uniform
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
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float2 hi, lo;
          db[i][g][0] += dz[g][0];
          db[i][g][1] += dz[g][1];
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

    // (1) [dh_carry | dxs[t]] = dz · Wcatᵀ; the lo terms and hi*hi in two
    // accumulators (two dependency chains), summed at the end
    float acc1[NTW1][2][4];
#pragma unroll
    for (int i = 0; i < NTW1; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[i][0][e] = acc1[i][1][e] = 0.f;
#pragma unroll 8
    for (int ks = 0; ks < Gm::KS1; ++ks) {
      const int a0 = (16 * mt + gid) * SZ + 8 * ks + 2 * tig, a1 = a0 + 8 * SZ;
      const float2 h0v = *reinterpret_cast<const float2*>(szh + a0);
      const float2 h1v = *reinterpret_cast<const float2*>(szh + a1);
      const float2 l0v = *reinterpret_cast<const float2*>(szl + a0);
      const float2 l1v = *reinterpret_cast<const float2*>(szl + a1);
      const uint32_t ah[4] = {__float_as_uint(h0v.x), __float_as_uint(h1v.x),
                              __float_as_uint(h0v.y), __float_as_uint(h1v.y)};
      const uint32_t al[4] = {__float_as_uint(l0v.x), __float_as_uint(l1v.x),
                              __float_as_uint(l0v.y), __float_as_uint(l1v.y)};
#pragma unroll
      for (int i = 0; i < NTW1; ++i) {
        const int nt = nt0 + 4 * i;
        if (nt >= NT1) continue;          // warp-uniform
        const float* slot = sw + ((ks * NT1 + nt) * 32 + lane) * SL;
        float4 w;
        if (Gm::kPair) {
          w = *reinterpret_cast<const float4*>(slot);
        } else {
          const float2 v = *reinterpret_cast<const float2*>(slot);
          w.x = __uint_as_float(tf32(v.x));
          w.y = __uint_as_float(tf32(v.y));
          w.z = __uint_as_float(tf32(v.x - w.x));
          w.w = __uint_as_float(tf32(v.y - w.y));
        }
        mma_tf32(acc1[i][1], al, w.x, w.y);
        mma_tf32(acc1[i][1], ah, w.z, w.w);
        mma_tf32(acc1[i][0], ah, w.x, w.y);
      }
    }
#pragma unroll
    for (int i = 0; i < NTW1; ++i) {
      const int nt = nt0 + 4 * i;
      if (nt >= NT1) continue;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = acc1[i][1][e] + acc1[i][0][e];
      if (nt < H / 8) {
#pragma unroll
        for (int e = 0; e < 4; ++e) carry[i][e] = v[e];
      } else {
        const int d = 8 * nt - H + 2 * tig;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row_base + 16 * mt + gid + 8 * h;
          if (d < D && row < B)
            *reinterpret_cast<float2*>(dxs + ((size_t)t * B + row) * D + d) =
                make_float2(v[2 * h], v[2 * h + 1]);
        }
      }
    }

    // (2) [dW_hh ; dW_ih] += [h_{t-1} | x_t]ᵀ · dz: k = the block's rows,
    // b0 / b1 at rows 8 ks + tig and + 4
    const float* hx = shx + (t & 1) * kR * SX;
#pragma unroll
    for (int ks = 0; ks < Gm::KS2; ++ks) {
      const int r0 = 8 * ks + tig;
      float bh[NTW2][2], bl[NTW2][2];
#pragma unroll
      for (int i = 0; i < NTW2; ++i) {
        const int col = 8 * (warp + 8 * i) + gid;
        if (warp + 8 * i >= NT2) continue;
        bh[i][0] = szh[r0 * SZ + col];
        bh[i][1] = szh[(r0 + 4) * SZ + col];
        bl[i][0] = szl[r0 * SZ + col];
        bl[i][1] = szl[(r0 + 4) * SZ + col];
      }
#pragma unroll
      for (int m = 0; m < MT2; ++m) {
        const int u = 16 * m + gid;
        const float x[4] = {hx[r0 * SX + u], hx[r0 * SX + u + 8],
                            hx[(r0 + 4) * SX + u], hx[(r0 + 4) * SX + u + 8]};
        uint32_t ah[4], al[4];
        split(x, ah, al);
#pragma unroll
        for (int i = 0; i < NTW2; ++i) {
          if (warp + 8 * i >= NT2) continue;
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
    if (nt >= H / 8) continue;
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
  // this block's partial row: dW_ih [D][4H], dW_hh [H][4H], db [4H]
  float* p = part + (size_t)blockIdx.x * ((D + H + 1) * G);
#pragma unroll
  for (int i = 0; i < NTW2; ++i) {
    if (warp + 8 * i >= NT2) continue;
    const int col = 8 * (warp + 8 * i) + 2 * tig;
#pragma unroll
    for (int m = 0; m < MT2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int u = 16 * m + gid + 8 * h;
        if (u < H + D)
          *reinterpret_cast<float2*>(p + (u < H ? D + u : u - H) * G + col) =
              make_float2(acc2[i][m][2 * h], acc2[i][m][2 * h + 1]);
      }
  }
  // db: a lane's rows, then the m-tile's 16 rows by shuffles (fixed order),
  // then the two m-tiles through shared memory (the dz tile, now free)
  float* sdb = szh;
#pragma unroll
  for (int i = 0; i < NTW1; ++i) {
    const int nt = nt0 + 4 * i;
    if (nt >= H / 8) continue;
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
    p[(D + H) * G + c] = sdb[c] + sdb[G + c];
}

template <int D, int H>
cudaError_t launch(const float* w_ih, const float* w_hh, const float* xs,
                   const float* h0, const float* c0, const float* ys,
                   const float* gates, const float* cs, const float* dys,
                   const float* dhT, const float* dcT, float* dxs, float* part,
                   float* dw, float* dh0, float* dc0, int T, int B,
                   cudaStream_t stream) {
  constexpr size_t smem = Geom<D, H>::kSmem;
  auto kernel = lstm_proj_bwd_kernel<D, H>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + kR - 1) / kR;
  kernel<<<blocks, kThreads, smem, stream>>>(w_ih, w_hh, xs, h0, c0, ys,
                                             gates, cs, dys, dhT, dcT, dxs,
                                             part, dh0, dc0, T, B);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int kSumThreads = 128;
  constexpr int n = (D + H + 1) * 4 * H;
  reduce_partials_kernel<<<(n + kSumThreads - 1) / kSumThreads, kSumThreads,
                           0, stream>>>(part, dw, blocks, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Batch rows one block owns: the partials are [ceil(B / rows), ...].
int lstm_proj_bwd_rows_per_block() { return kR; }

// w_ih: [D, 4H]; w_hh: [H, 4H]; xs: [T, B, D]; h0, c0: [B, H]; ys, cs:
// [T, B, H] and gates [T, B, 4H] as the forward wrote them; dys [T, B, H],
// dhT, dcT [B, H]: each may be null (zero). Outputs: dxs [T, B, D]; dw
// [(D + H + 1) * 4H] = dW_ih [D, 4H], dW_hh [H, 4H], db [4H] side by side,
// with its partials part [nb, (D + H + 1) * 4H], nb = ceil(B /
// lstm_proj_bwd_rows_per_block()); dh0, dc0 [B, H]. All float32 and
// contiguous, xs, h0, c0, ys, gates, cs and dys at 16-byte aligned
// addresses (they are copied by cp.async); T >= 1, B >= 1, D in {4, 8,
// 16}, H in {8, 16, 32, 48, 64}. Returns the CUDA error of the launches
// (0 = cudaSuccess).
int lstm_proj_bwd(const float* w_ih, const float* w_hh, const float* xs,
                  const float* h0, const float* c0, const float* ys,
                  const float* gates, const float* cs, const float* dys,
                  const float* dhT, const float* dcT, float* dxs, float* part,
                  float* dw, float* dh0, float* dc0, int T, int B, int D,
                  int H, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  LSTM_PROJ_DISPATCH_D(
      D, LSTM_FUSED_DISPATCH_H(
             H, err = (launch<kD, kH>(w_ih, w_hh, xs, h0, c0, ys, gates, cs,
                                      dys, dhT, dcT, dxs, part, dw, dh0, dc0,
                                      T, B, st))));
  return (int)err;
}

const char* lstm_proj_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
