// Whole-loop LSTM forward at the wide widths: kernel K3 (both variants) and
// kernel K5 for H in (64, 128], and K5 for D in (16, 64], of the port.
//
// Replaces the TPU kernels grouptraj/ops/pallas_fused.py:_fwd_kernel
// (K3: z_t = gx_t + h_{t-1} W, or b + h_{t-1} W) and
// grouptraj/ops/pallas_lstm.py:_fwd_kernel (K5: z_t = x_t W_ih +
// h_{t-1} W_hh + b) at the widths whose weights do not fit the register
// design (lstm_fused_fwd.cu, lstm_proj_fwd.cu): all T steps in one launch,
// torch gate order (i, f, g, o), c_t = f c_{t-1} + i g, h_t = o tanh(c_t);
// ys [T, B, H], hT, cT and, on request, the backward's residuals (the
// post-activation gates [T, B, 4H] and cs [T, B, H]).
//
// Bound on an H100 SXM (chip_smoke.py:lstm_bound_ms / proj_bound_ms). The
// products 2 T B (D + H) 4H as 3xTF32 (three TF32 passes at 495 TFLOP/s)
// beside the bytes of xs or gx, the states and the outputs: the k=20 probe
// decode of the H = 128 scale configuration (T = 11, B = 163,840, no
// residuals) is bound by its operations (~1.4 ms), the encoders with their
// residuals by their bytes.
//
// Design (lstm_wide.cuh says why it differs from the register design). The
// weights are split once per call by split_fwd_kernel into a global scratch
// of B fragments. A block owns kR = 64 batch rows (four m16 tiles) for all T
// steps and has one warp per 8 units: warp q owns units 8q .. 8q+7, i.e. the
// n-tiles q, H/8 + q, 2H/8 + q and 3H/8 + q, so the accumulators of a lane
// hold all four gates of the same cells (2 rows x 2 units an m-tile) and
// the gate math, c and the residual stores run from registers, as in K3. Per
// step, z = [x_t | h_{t-1}] · [W_ih ; W_hh] from zero, k ascending (x first,
// then h: the JAX kernels' order), as mma.sync m16n8k8 TF32 with float32
// accumulate in the 3xTF32 split (lo_a hi_W + hi_a lo_W + hi_a hi_W), each
// k-step's products summed by the tensor cores from zero and added to z in
// float32: the tensor cores truncate as they accumulate, and one
// accumulator over all D + H products (192 at D = 64, H = 128) ended 3-4x
// further from the exact answer than float32 does; then + gx_t or + b.
// Each k-step a warp reads its four B fragments (one float4 a lane each)
// straight from L2 and uses each on the four m-tiles; the A fragments come
// from shared memory and are split as they are read. h_t is
// written raw into a double-buffered tile (rows of 8 mod 32 floats); x_t
// (K5) arrives by cp.async into a ring of three steps; gx_t (K3) is copied
// by each lane into its own shared slots by 8-byte cp.async at the top of
// the step and read after the products, so that no barrier guards it. One
// __syncthreads a step. Activations: sigmoid_acc and tanh_acc
// (lstm_fused.cuh); never build with --use_fast_math.

#include "lstm_wide.cuh"

namespace {

using namespace lstm_wide;

constexpr int kMT = 4;           // m16 tiles a block
constexpr int kR = 16 * kMT;     // batch rows a block
constexpr int kStages = 3;       // x ring: steps t, t + 1, t + 2

enum Mode { kGx = 0, kBias = 1, kProj = 2 };

// dynamic shared memory of a launch: the double-buffered h tile, the x ring
// (kProj) or the lanes' gx slots (kGx)
__host__ __device__ inline size_t fwd_smem(int mode, int D, int H) {
  const int Dp = round_up(D, 8);
  size_t floats = 2 * kR * stride8(H);
  if (mode == kProj) floats += kStages * kR * stride8(Dp);
  if (mode == kGx) floats += 2 * (kMT * 8) * (32 * H / 8);
  return sizeof(float) * floats;
}

template <int MODE, bool SAVE>
__global__ void __launch_bounds__(kMaxThreads, 1)
lstm_wide_fwd_kernel(const float4* __restrict__ wf,
                     const float* __restrict__ pre,
                     const float* __restrict__ xs,
                     const float* __restrict__ h0,
                     const float* __restrict__ c0, float* __restrict__ ys,
                     float* __restrict__ hT, float* __restrict__ cT,
                     float* __restrict__ gates, float* __restrict__ cs,
                     int T, int B, int D, int H) {
  const int G = 4 * H, NTg = H / 8, NT = G / 8;
  const int Dp = MODE == kProj ? round_up(D, 8) : 0;
  const int KX = Dp / 8, KS = KX + H / 8;
  const int SA = stride8(H), SX = stride8(Dp);
  const int nthr = blockDim.x;
  extern __shared__ __align__(16) float smem[];
  float* sh = smem;                          // [2][kR][SA]: h_{t-1}, h_t
  float* sx = sh + 2 * kR * SA;              // kProj: [kStages][kR][SX]
  float2* sg = reinterpret_cast<float2*>(sx);  // kGx: [kMT * 8][nthr]

  const int tid = threadIdx.x, lane = tid & 31, q = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int u = 8 * q + 2 * tig;              // this lane's units u, u + 1
  const int row0 = (int)blockIdx.x * kR;

  // x_s of the block's rows into stage s % kStages (zeros past B and T)
  auto stage_x = [&](int s) {
    float* dst = sx + (s % kStages) * kR * SX;
    const int cpr = D / 4;                    // 16-byte chunks a row
    for (int i = tid; i < kR * cpr; i += nthr) {
      const int r = i / cpr, col = 4 * (i % cpr);
      const bool ok = row0 + r < B && s < T;
      const float* src = xs + (ok ? ((size_t)s * B + row0 + r) * D + col : 0);
      cp_async16(dst + r * SX + col, src, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // gx_s of this lane's cells into its own slots (zeros past B); a loop
  // over the m-tiles, not unrolled: 32 addresses held across the step
  // spill
  auto stage_gx = [&](int s) {
#pragma unroll 1
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 16 * m + gid + 8 * r;
        const bool ok = row < B;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float* src =
              pre + (ok ? ((size_t)s * B + row) * G + g * H + u : 0);
          cp_async8(reinterpret_cast<float*>(
                        sg + ((m * 2 + r) * 4 + g) * nthr + tid),
                    src, ok);
        }
      }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  if (MODE == kProj) {
    stage_x(0);
    stage_x(1);
    const int P = Dp - D;                     // columns never copied to
    for (int i = tid; i < kStages * kR * P; i += nthr)
      sx[(i / P) * SX + D + i % P] = 0.f;
  }
  if (MODE == kGx) stage_gx(0);

  // Cell e of a lane in m-tile m: row 16 m + gid + 8 (e / 2), unit u + e %
  // 2, element e of the m-tile's accumulators.
  float c[kMT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lr = 16 * m + gid + 8 * r, row = row0 + lr;
      float2 hv = make_float2(0.f, 0.f), cv = hv;
      if (row < B) {
        hv = *reinterpret_cast<const float2*>(h0 + (size_t)row * H + u);
        cv = *reinterpret_cast<const float2*>(c0 + (size_t)row * H + u);
      }
      c[m][2 * r] = cv.x;
      c[m][2 * r + 1] = cv.y;
      *reinterpret_cast<float2*>(sh + lr * SA + u) = hv;
    }
  if (MODE == kProj) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    if (MODE == kGx && t > 0) stage_gx(t);   // slots read by step t - 1
    if (MODE == kProj) stage_x(t + 2);       // the stage step t - 1 read
    const float* ha = sh + (t & 1) * kR * SA;
    const float* xa = sx + (t % kStages) * kR * SX;
    float acc[kMT][4][4];
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][g][e] = 0.f;
#pragma unroll 1
    for (int ks = 0; ks < KS; ++ks) {
      float4 bq[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        bq[g] = __ldg(wf + ((size_t)ks * NT + g * NTg + q) * 32 + lane);
      const bool in_x = ks < KX;
      const float* ar = in_x ? xa + 8 * ks : ha + 8 * (ks - KX);
      const int st = in_x ? SX : SA;
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const float* p = ar + (16 * m + gid) * st + 2 * tig;
        const float2 x0 = *reinterpret_cast<const float2*>(p);
        const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * st);
        const float xv[4] = {x0.x, x1.x, x0.y, x1.y};
        uint32_t ah[4], al[4];
        split(xv, ah, al);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(part, al, bq[g].x, bq[g].y);
          mma_tf32(part, ah, bq[g].z, bq[g].w);
          mma_tf32(part, ah, bq[g].x, bq[g].y);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][g][e] += part[e];
        }
      }
    }
    if (MODE == kGx) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    float* hn = sh + ((t + 1) & 1) * kR * SA;
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      // z = acc + gx_t (from this lane's slots) or acc + b
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if (MODE == kGx) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 v = sg[((m * 2 + r) * 4 + g) * nthr + tid];
            acc[m][g][2 * r] += v.x;
            acc[m][g][2 * r + 1] += v.y;
          }
        } else {
          const float2 bv = __ldg(reinterpret_cast<const float2*>(pre + g * H + u));
          acc[m][g][0] += bv.x;
          acc[m][g][1] += bv.y;
          acc[m][g][2] += bv.x;
          acc[m][g][3] += bv.y;
        }
      }
      float act[4][4], h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        act[0][e] = sigmoid_acc(acc[m][0][e]);
        act[1][e] = sigmoid_acc(acc[m][1][e]);
        act[2][e] = tanh_acc(acc[m][2][e]);
        act[3][e] = sigmoid_acc(acc[m][3][e]);
        c[m][e] = act[1][e] * c[m][e] + act[0][e] * act[2][e];
        h[e] = act[3][e] * tanh_acc(c[m][e]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int lr = 16 * m + gid + 8 * r, row = row0 + lr;
        if (row < B) {
          const size_t at = (size_t)t * B + row;
          *reinterpret_cast<float2*>(ys + at * H + u) =
              make_float2(h[2 * r], h[2 * r + 1]);
          if (SAVE) {
#pragma unroll
            for (int g = 0; g < 4; ++g)
              *reinterpret_cast<float2*>(gates + at * G + g * H + u) =
                  make_float2(act[g][2 * r], act[g][2 * r + 1]);
            *reinterpret_cast<float2*>(cs + at * H + u) =
                make_float2(c[m][2 * r], c[m][2 * r + 1]);
          }
        }
        *reinterpret_cast<float2*>(hn + lr * SA + u) =
            make_float2(h[2 * r], h[2 * r + 1]);
      }
    }
    if (MODE == kProj) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();  // h_t (and x_{t+1}) are in; h_{t-1}, x_t are read
  }
  if (MODE == kProj) asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  const float* hl = sh + (T & 1) * kR * SA;   // h_{T-1}
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lr = 16 * m + gid + 8 * r, row = row0 + lr;
      if (row < B) {
        const size_t at = (size_t)row * H + u;
        *reinterpret_cast<float2*>(hT + at) =
            *reinterpret_cast<const float2*>(hl + lr * SA + u);
        *reinterpret_cast<float2*>(cT + at) =
            make_float2(c[m][2 * r], c[m][2 * r + 1]);
      }
    }
}

template <int MODE, bool SAVE>
cudaError_t launch(const float4* wf, const float* pre, const float* xs,
                   const float* h0, const float* c0, float* ys, float* hT,
                   float* cT, float* gates, float* cs, int T, int B, int D,
                   int H, cudaStream_t st) {
  const size_t smem = fwd_smem(MODE, D, H);
  auto kernel = lstm_wide_fwd_kernel<MODE, SAVE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(B + kR - 1) / kR, 32 * H / 8, smem, st>>>(
      wf, pre, xs, h0, c0, ys, hT, cT, gates, cs, T, B, D, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// mode 0 (K3, gx variant): pre = gx [T, B, 4H]; mode 1 (K3, decoder
// variant): pre = b [4H]; mode 2 (K5): pre = b [4H], w_ih [D, 4H] and xs
// [T, B, D] (both null otherwise, D = 0). w_hh: [H, 4H]; h0, c0: [B, H];
// ys: [T, B, H]; hT, cT: [B, H]; gates [T, B, 4H] and cs [T, B, H]: both
// given (the residuals are saved) or both null; wf: a scratch of
// (round_up(D, 8) + H) * 4H * 2 floats at a 16-byte aligned address. All
// float32 and contiguous, pre, xs, h0 and c0 at 16-byte aligned addresses;
// T >= 1, B >= 1, H a multiple of 8 in [8, 128], D a multiple of 4 in
// [4, 64] (mode 2). Returns the CUDA error of the launches (0 =
// cudaSuccess).
int lstm_wide_fwd(const float* w_ih, const float* w_hh, const float* pre,
                  const float* xs, const float* h0, const float* c0,
                  float* ys, float* hT, float* cT, float* gates, float* cs,
                  float* wf, int T, int B, int D, int H, int mode, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (mode != kProj) D = 0;
  if (T < 1 || B < 1 || mode < 0 || mode > 2 || !widths_ok(D, H) ||
      (mode == kProj && (D < 4 || w_ih == nullptr || xs == nullptr)) ||
      (gates == nullptr) != (cs == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Dp = round_up(D, 8);
  const int n = (Dp + H) / 8 * (4 * H / 8) * 32;
  split_fwd_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      w_ih, w_hh, D, Dp, H, reinterpret_cast<float4*>(wf));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float4* w4 = reinterpret_cast<const float4*>(wf);
  const bool save = gates != nullptr;
#define WIDE_FWD_LAUNCH(M)                                                   \
  err = save ? launch<M, true>(w4, pre, xs, h0, c0, ys, hT, cT, gates, cs, \
                               T, B, D, H, st)                             \
             : launch<M, false>(w4, pre, xs, h0, c0, ys, hT, cT, gates,    \
                                cs, T, B, D, H, st)
  if (mode == kGx) {
    WIDE_FWD_LAUNCH(kGx);
  } else if (mode == kBias) {
    WIDE_FWD_LAUNCH(kBias);
  } else {
    WIDE_FWD_LAUNCH(kProj);
  }
#undef WIDE_FWD_LAUNCH
  return (int)err;
}

const char* lstm_wide_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
