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
// Bound on an H100. Operations: 4*T*B*H*4H multiply-adds' worth (dz @ W^T
// and h^T dz) plus the gate math, float32 on the CUDA cores. Bytes: gates,
// cs, ys, dys read and dgx written once. The discriminator's encoder in the
// d-step (T = 20, B = 8,192, H = 48) moves 126 MB of gates in and 126 MB of
// dgx out: it is byte-bound; the decoder variant (no dgx) is
// operation-bound.
//
// Design, right and simple first. The tiling of lstm_fused.cuh, three
// phases per step with two __syncthreads:
//  1. thread (rg, j) forms dz of unit j for its four rows from registers
//     (dh_carry, dc_carry) and global memory, writes dgx, and puts dz (one
//     float4 of the four gates per (row, j)) and h_{t-1} into shared memory;
//  2. the same thread, now as (rg, k = j), takes dh_carry[row][k] as the
//     4H-long dot of dz[row] with W[k], W staged once as float4 per (j, k):
//     the carry never leaves registers;
//  3. as (kg = rg, j) it adds h_{t-1}[row][k] * dz[row][., j] over the
//     block's 32 rows into its H/8 * 4 accumulators of dW[k][., j], k in
//     kg*H/8 .. ; those stay in registers across all T steps.
// A block leaves its dW (and db) as partials [block][H][4H]; a second small
// kernel sums them in block order. No float atomics anywhere: the result
// is the same from run to run.

#include "lstm_fused.cuh"

namespace {

using namespace lstm_fused;

template <int H>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float4) * H * H + sizeof(float4) * kRows * H +
         sizeof(float) * kRows * H;
}

template <int H, bool WITH_GX>
__global__ void __launch_bounds__(H* kGroups)
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
  static_assert(H % kGroups == 0, "H must be a multiple of 8");
  constexpr int kPerThread = H / kGroups;  // k's of dW one thread owns

  extern __shared__ float4 smem4[];
  float4* swt = smem4;                       // [j][k] gates of W[k][. + j]
  float4* sdz = smem4 + H * H;               // [row][j] gates of dz
  float* shp = reinterpret_cast<float*>(sdz + kRows * H);  // [row][k]

  const int tid = threadIdx.x, j = tid % H, rg = tid / H;
  const int row0 = blockIdx.x * kRows + rg * kRowsPerThread;
  const int k0 = rg * kPerThread;

  stage_gate_matrix<H, true>(swt, w, tid, H * kGroups);

  float dh[kRowsPerThread], dc[kRowsPerThread];
#pragma unroll
  for (int rr = 0; rr < kRowsPerThread; ++rr) {
    const int row = row0 + rr;
    const bool live = row < B;
    dh[rr] = (live && dhT != nullptr) ? dhT[(size_t)row * H + j] : 0.f;
    dc[rr] = (live && dcT != nullptr) ? dcT[(size_t)row * H + j] : 0.f;
  }
  float dwacc[kPerThread][4], dbacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < kPerThread; ++kk)
#pragma unroll
    for (int g = 0; g < 4; ++g) dwacc[kk][g] = 0.f;

  for (int t = T - 1; t >= 0; --t) {
    // phase 1: dz of this step, elementwise
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
        if (WITH_GX) {
          float* dg = dgx + at * (4 * H) + j;
          dg[0] = dz.x;
          dg[H] = dz.y;
          dg[2 * H] = dz.z;
          dg[3 * H] = dz.w;
        }
      }
      const int r = rg * kRowsPerThread + rr;
      sdz[r * H + j] = dz;  // zeros at rows past B: they add nothing below
      shp[r * H + j] = hp;
    }
    __syncthreads();

    // phase 2: dh_carry[row][k = j] = dz[row] . W[k]
#pragma unroll
    for (int rr = 0; rr < kRowsPerThread; ++rr) dh[rr] = 0.f;
#pragma unroll 4
    for (int jj = 0; jj < H; ++jj) {
      const float4 wv = swt[jj * H + j];
#pragma unroll
      for (int rr = 0; rr < kRowsPerThread; ++rr) {
        const float4 d = sdz[(rg * kRowsPerThread + rr) * H + jj];
        dh[rr] = fmaf(d.x, wv.x, dh[rr]);
        dh[rr] = fmaf(d.y, wv.y, dh[rr]);
        dh[rr] = fmaf(d.z, wv.z, dh[rr]);
        dh[rr] = fmaf(d.w, wv.w, dh[rr]);
      }
    }

    // phase 3: dW[k][. + j] += h_{t-1}[row][k] * dz[row][. + j]
#pragma unroll 2
    for (int r = 0; r < kRows; ++r) {
      const float4 d = sdz[r * H + j];
      if (!WITH_GX) {
        dbacc[0] += d.x;
        dbacc[1] += d.y;
        dbacc[2] += d.z;
        dbacc[3] += d.w;
      }
#pragma unroll
      for (int kk = 0; kk < kPerThread; ++kk) {
        const float hv = shp[r * H + k0 + kk];
        dwacc[kk][0] = fmaf(hv, d.x, dwacc[kk][0]);
        dwacc[kk][1] = fmaf(hv, d.y, dwacc[kk][1]);
        dwacc[kk][2] = fmaf(hv, d.z, dwacc[kk][2]);
        dwacc[kk][3] = fmaf(hv, d.w, dwacc[kk][3]);
      }
    }
    __syncthreads();  // sdz and shp are consumed before the next step's
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerThread; ++rr) {
    const int row = row0 + rr;
    if (row < B) {
      dh0[(size_t)row * H + j] = dh[rr];
      dc0[(size_t)row * H + j] = dc[rr];
    }
  }
  float* dwp = dw_part + (size_t)blockIdx.x * (4 * H * H);
#pragma unroll
  for (int kk = 0; kk < kPerThread; ++kk) {
    float* o = dwp + (size_t)(k0 + kk) * (4 * H) + j;
    o[0] = dwacc[kk][0];
    o[H] = dwacc[kk][1];
    o[2 * H] = dwacc[kk][2];
    o[3 * H] = dwacc[kk][3];
  }
  if (!WITH_GX && rg == 0) {
    float* o = db_part + (size_t)blockIdx.x * (4 * H) + j;
    o[0] = dbacc[0];
    o[H] = dbacc[1];
    o[2 * H] = dbacc[2];
    o[3 * H] = dbacc[3];
  }
}

template <int H, bool WITH_GX>
cudaError_t launch(const float* w, const float* h0, const float* c0,
                   const float* ys, const float* gates, const float* cs,
                   const float* dys, const float* dhT, const float* dcT,
                   float* dgx, float* dw_part, float* db_part, float* dw,
                   float* db, float* dh0, float* dc0, int T, int B,
                   cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<H>();
  auto kernel = lstm_fused_bwd_kernel<H, WITH_GX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + kRows - 1) / kRows;
  kernel<<<blocks, H * kGroups, smem, stream>>>(w, h0, c0, ys, gates, cs, dys,
                                                dhT, dcT, dgx, dw_part,
                                                db_part, dh0, dc0, T, B);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int kThreads = 128;
  const int n = 4 * H * H;
  reduce_partials_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                           stream>>>(dw_part, dw, blocks, n);
  err = cudaGetLastError();
  if (err != cudaSuccess || WITH_GX) return err;
  reduce_partials_kernel<<<(4 * H + kThreads - 1) / kThreads, kThreads, 0,
                           stream>>>(db_part, db, blocks, 4 * H);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Batch rows one block owns: the partials are [ceil(B / rows), ...].
int lstm_fused_bwd_rows_per_block() { return kRows; }

// w: [H, 4H]; h0, c0: [B, H]; ys, cs: [T, B, H] and gates [T, B, 4H] as the
// forward wrote them; dys [T, B, H], dhT, dcT [B, H]: each may be null
// (zero). Outputs: dgx [T, B, 4H] (with_gx = 1) or db [4H] with its partials
// db_part [nb, 4H] (with_gx = 0); dw [H, 4H] with dw_part [nb, H, 4H];
// dh0, dc0 [B, H]; nb = ceil(B / lstm_fused_bwd_rows_per_block()). All
// float32 and contiguous; T >= 1, B >= 1, H in {8, 16, 32, 48, 64}.
// Returns the CUDA error of the launches (0 = cudaSuccess).
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
