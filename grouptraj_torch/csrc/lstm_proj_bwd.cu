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
//   dh_carry = dz @ W_hh^T,  dc_carry = dc * f,  dxs[t] = dz @ W_ih^T
//   dW_hh += h_{t-1}^T dz,  dW_ih += x_t^T dz,  db += sum_rows dz
//
// and at the end dh0 = dh_carry, dc0 = dc_carry. dys, dhT and dcT may be
// null (a cotangent that is zero everywhere is never read).
//
// Bound on an H100. Operations: the four products, 4*T*B*(D + H)*4H
// multiply-adds' worth, plus the gate math, float32 on the CUDA cores.
// Bytes: xs, ys, gates, cs (and the cotangents given) read, dxs written
// once. The discriminator's encoder in the d-step (T = 20, B = 8,192,
// D = 16, H = 48) needs 8.1 GFLOP (0.12 ms) against 210 MB (0.06 ms): it is
// operation-bound.
//
// Design, right and simple first. The tiling of lstm_fused.cuh (one block
// per 32 batch rows, thread (rg, j) for unit j of four rows), four phases
// per step with two __syncthreads:
//  1. thread (rg, j) forms dz of unit j for its four rows from registers
//     (dh_carry, dc_carry) and global memory, and puts dz (one float4 of the
//     four gates per (row, j), rows padded to H + 1 float4) and h_{t-1}
//     into shared memory; the block stages x_t's 32 rows beside them;
//  2. as (rg, k = j) it takes dh_carry[row][k] as the 4H-long dot of dz[row]
//     with W_hh[k], W_hh staged once as float4 per (j, k) (as K4);
//  3. the block's 32 x D entries of dxs[t] are spread over all threads,
//     neighbouring threads on neighbouring d (coalesced stores), each the
//     4H-long dot of dz[row] with W_ih[d], W_ih staged once as float4 per
//     (j, d);
//  4. as (kg = rg, j) it adds h_{t-1}[row][k] * dz[row][., j] and
//     x_t[row][d] * dz[row][., j] over the block's 32 rows into its
//     accumulators of dW_hh[k][., j] (k in kg*H/8 ..) and dW_ih[d][., j]
//     (d = kg, kg + 8), and dz into db[., j]; they stay in registers across
//     all T steps.
// A block leaves its dW_ih, dW_hh and db side by side as one partial row
// [block][(D + H + 1) * 4H]; a second small kernel sums the rows in block
// order. No float atomics anywhere: the result is the same from run to run.

#include "lstm_proj.cuh"

namespace {

using namespace lstm_fused;
using namespace lstm_proj;

// float4 per row of the dz tile: H, padded by one so that the threads of
// phase 3, on neighbouring rows, read it without bank conflicts
template <int H>
constexpr int kZStride = H + 1;

template <int D, int H>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float4) * (H * H + D * H + kRows * kZStride<H>) +
         sizeof(float) * kRows * (H + D);
}

template <int D, int H>
__global__ void __launch_bounds__(H* kGroups)
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
  static_assert(H % kGroups == 0, "H must be a multiple of 8");
  constexpr int kThreads = H * kGroups;
  constexpr int kPerThread = H / kGroups;                // k's of dW_hh
  constexpr int kDPerThread = (D + kGroups - 1) / kGroups;  // d's of dW_ih
  constexpr int kZ = kZStride<H>;

  extern __shared__ float4 smem4[];
  float4* swht = smem4;                     // [j][k] gates of W_hh[k][. + j]
  float4* swit = swht + H * H;              // [j][d] gates of W_ih[d][. + j]
  float4* sdz = swit + D * H;               // [row][j] gates of dz, padded
  float* shp = reinterpret_cast<float*>(sdz + kRows * kZ);  // [row][k]
  float* sx = shp + kRows * H;                               // [row][d]

  const int tid = threadIdx.x, j = tid % H, rg = tid / H;
  const int row_base = blockIdx.x * kRows;
  const int row0 = row_base + rg * kRowsPerThread;
  const int k0 = rg * kPerThread;

  stage_gate_matrix<H, true>(swht, w_hh, tid, kThreads);
  stage_input_matrix<D, H, true>(swit, w_ih, tid, kThreads);

  float dh[kRowsPerThread], dc[kRowsPerThread];
#pragma unroll
  for (int rr = 0; rr < kRowsPerThread; ++rr) {
    const int row = row0 + rr;
    const bool live = row < B;
    dh[rr] = (live && dhT != nullptr) ? dhT[(size_t)row * H + j] : 0.f;
    dc[rr] = (live && dcT != nullptr) ? dcT[(size_t)row * H + j] : 0.f;
  }
  float dwh[kPerThread][4], dwi[kDPerThread][4], dbacc[4] = {0.f, 0.f, 0.f,
                                                             0.f};
#pragma unroll
  for (int g = 0; g < 4; ++g) {
#pragma unroll
    for (int kk = 0; kk < kPerThread; ++kk) dwh[kk][g] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDPerThread; ++dd) dwi[dd][g] = 0.f;
  }

  for (int t = T - 1; t >= 0; --t) {
    // phase 1: dz of this step, elementwise; x_t of the block's rows
#pragma unroll
    for (int rr = 0; rr < kRowsPerThread; ++rr) {
      const int row = row0 + rr;
      float4 dz = make_float4(0.f, 0.f, 0.f, 0.f);
      float hp = 0.f;
      if (row < B) {
        const size_t at = (size_t)t * B + row;
        const float* gt = gates + at * (4 * H) + j;
        const float gi = gt[0], gf = gt[H], gg = gt[2 * H], go = gt[3 * H];
        const size_t prev = ((size_t)(t - 1) * B + row) * H + j;
        const float cp = t > 0 ? cs[prev] : c0[(size_t)row * H + j];
        hp = t > 0 ? ys[prev] : h0[(size_t)row * H + j];
        const float dht =
            dh[rr] + (dys != nullptr ? dys[at * H + j] : 0.f);
        const float tc = tanhf(gf * cp + gi * gg);
        const float dcc = dc[rr] + dht * go * (1.f - tc * tc);
        dz.x = dcc * gg * gi * (1.f - gi);
        dz.y = dcc * cp * gf * (1.f - gf);
        dz.z = dcc * gi * (1.f - gg * gg);
        dz.w = dht * tc * go * (1.f - go);
        dc[rr] = dcc * gf;
      }
      const int r = rg * kRowsPerThread + rr;
      sdz[r * kZ + j] = dz;  // zeros at rows past B: they add nothing below
      shp[r * H + j] = hp;
    }
    const float* xt = xs + ((size_t)t * B + row_base) * D;
    for (int idx = tid; idx < kRows * D; idx += kThreads)
      sx[idx] = row_base + idx / D < B ? xt[idx] : 0.f;
    __syncthreads();

    // phase 2: dh_carry[row][k = j] = dz[row] . W_hh[k]
#pragma unroll
    for (int rr = 0; rr < kRowsPerThread; ++rr) dh[rr] = 0.f;
#pragma unroll 4
    for (int jj = 0; jj < H; ++jj) {
      const float4 wv = swht[jj * H + j];
#pragma unroll
      for (int rr = 0; rr < kRowsPerThread; ++rr) {
        const float4 d = sdz[(rg * kRowsPerThread + rr) * kZ + jj];
        dh[rr] = fmaf(d.x, wv.x, dh[rr]);
        dh[rr] = fmaf(d.y, wv.y, dh[rr]);
        dh[rr] = fmaf(d.z, wv.z, dh[rr]);
        dh[rr] = fmaf(d.w, wv.w, dh[rr]);
      }
    }

    // phase 3: dxs[t][row][d] = dz[row] . W_ih[d]
    float* dxt = dxs + ((size_t)t * B + row_base) * D;
    for (int idx = tid; idx < kRows * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      float acc = 0.f;
#pragma unroll 4
      for (int jj = 0; jj < H; ++jj) {
        const float4 dz = sdz[r * kZ + jj];
        const float4 wv = swit[jj * D + d];
        acc = fmaf(dz.x, wv.x, acc);
        acc = fmaf(dz.y, wv.y, acc);
        acc = fmaf(dz.z, wv.z, acc);
        acc = fmaf(dz.w, wv.w, acc);
      }
      if (row_base + r < B) dxt[idx] = acc;
    }

    // phase 4: dW_hh[k][. + j] += h_{t-1}[row][k] * dz[row][. + j],
    // dW_ih[d][. + j] += x_t[row][d] * dz[row][. + j], db[. + j] += dz
#pragma unroll 2
    for (int r = 0; r < kRows; ++r) {
      const float4 d = sdz[r * kZ + j];
      dbacc[0] += d.x;
      dbacc[1] += d.y;
      dbacc[2] += d.z;
      dbacc[3] += d.w;
#pragma unroll
      for (int kk = 0; kk < kPerThread; ++kk) {
        const float hv = shp[r * H + k0 + kk];
        dwh[kk][0] = fmaf(hv, d.x, dwh[kk][0]);
        dwh[kk][1] = fmaf(hv, d.y, dwh[kk][1]);
        dwh[kk][2] = fmaf(hv, d.z, dwh[kk][2]);
        dwh[kk][3] = fmaf(hv, d.w, dwh[kk][3]);
      }
#pragma unroll
      for (int dd = 0; dd < kDPerThread; ++dd) {
        const int di = rg + dd * kGroups;
        if (di < D) {
          const float xv = sx[r * D + di];
          dwi[dd][0] = fmaf(xv, d.x, dwi[dd][0]);
          dwi[dd][1] = fmaf(xv, d.y, dwi[dd][1]);
          dwi[dd][2] = fmaf(xv, d.z, dwi[dd][2]);
          dwi[dd][3] = fmaf(xv, d.w, dwi[dd][3]);
        }
      }
    }
    __syncthreads();  // sdz, shp and sx are consumed before the next step's
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerThread; ++rr) {
    const int row = row0 + rr;
    if (row < B) {
      dh0[(size_t)row * H + j] = dh[rr];
      dc0[(size_t)row * H + j] = dc[rr];
    }
  }
  // this block's partial row: dW_ih [D][4H], dW_hh [H][4H], db [4H]
  float* p = part + (size_t)blockIdx.x * ((D + H + 1) * 4 * H);
#pragma unroll
  for (int dd = 0; dd < kDPerThread; ++dd) {
    const int di = rg + dd * kGroups;
    if (di < D) {
      float* o = p + (size_t)di * (4 * H) + j;
      o[0] = dwi[dd][0];
      o[H] = dwi[dd][1];
      o[2 * H] = dwi[dd][2];
      o[3 * H] = dwi[dd][3];
    }
  }
#pragma unroll
  for (int kk = 0; kk < kPerThread; ++kk) {
    float* o = p + (size_t)(D + k0 + kk) * (4 * H) + j;
    o[0] = dwh[kk][0];
    o[H] = dwh[kk][1];
    o[2 * H] = dwh[kk][2];
    o[3 * H] = dwh[kk][3];
  }
  if (rg == 0) {
    float* o = p + (size_t)(D + H) * (4 * H) + j;
    o[0] = dbacc[0];
    o[H] = dbacc[1];
    o[2 * H] = dbacc[2];
    o[3 * H] = dbacc[3];
  }
}

template <int D, int H>
cudaError_t launch(const float* w_ih, const float* w_hh, const float* xs,
                   const float* h0, const float* c0, const float* ys,
                   const float* gates, const float* cs, const float* dys,
                   const float* dhT, const float* dcT, float* dxs, float* part,
                   float* dw, float* dh0, float* dc0, int T, int B,
                   cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<D, H>();
  auto kernel = lstm_proj_bwd_kernel<D, H>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + kRows - 1) / kRows;
  kernel<<<blocks, H * kGroups, smem, stream>>>(w_ih, w_hh, xs, h0, c0, ys,
                                                gates, cs, dys, dhT, dcT, dxs,
                                                part, dh0, dc0, T, B);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int kThreads = 128;
  constexpr int n = (D + H + 1) * 4 * H;
  reduce_partials_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                           stream>>>(part, dw, blocks, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Batch rows one block owns: the partials are [ceil(B / rows), ...].
int lstm_proj_bwd_rows_per_block() { return kRows; }

// w_ih: [D, 4H]; w_hh: [H, 4H]; xs: [T, B, D]; h0, c0: [B, H]; ys, cs:
// [T, B, H] and gates [T, B, 4H] as the forward wrote them; dys [T, B, H],
// dhT, dcT [B, H]: each may be null (zero). Outputs: dxs [T, B, D]; dw
// [(D + H + 1) * 4H] = dW_ih [D, 4H], dW_hh [H, 4H], db [4H] side by side,
// with its partials part [nb, (D + H + 1) * 4H], nb = ceil(B /
// lstm_proj_bwd_rows_per_block()); dh0, dc0 [B, H]. All float32 and
// contiguous; T >= 1, B >= 1, D in {4, 8, 16}, H in {8, 16, 32, 48, 64}.
// Returns the CUDA error of the launches (0 = cudaSuccess).
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
