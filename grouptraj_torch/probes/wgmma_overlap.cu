// Probe: does a warpgroup's own ALU work overlap its TF32 wgmma on this
// card? One or two warpgroups each run, per iteration, the recurrence's
// k-chunk of products (12 wgmma.m64n128k8, 3xTF32 over 4 k-steps, B tiles
// in shared memory as lstm_wide_bwd.cu lays them out), then a chain of
// `alu` dependent FFMAs pinned between the commit and the wait, then the
// wait. Prints SM cycles an iteration (clock64). Build and run on the card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o /tmp/wgmma_overlap grouptraj_torch/probes/wgmma_overlap.cu && \
//       /tmp/wgmma_overlap
//
// Full overlap would give max(products, chain); a sum means the warpgroup
// issues nothing else while its products run.

#include <cstdio>

#include "../csrc/tc_tf32.cuh"
#include "../csrc/wgmma_tf32.cuh"

using namespace wgmma_tf32_ops;
using namespace tc_tf32;

constexpr int kChunk = 32768;    // a k-chunk's hi and lo B tiles, bytes

__global__ void __launch_bounds__(256, 1)
probe(float* out, long long* cyc, int iters, int alu) {
  extern __shared__ __align__(128) unsigned char sm[];
  float* f = reinterpret_cast<float*>(sm);
  for (int i = threadIdx.x; i < kChunk / 4 + 256; i += blockDim.x)
    f[i] = 0.001f * (i % 97);
  __syncthreads();
  fence_async_smem();
  float acc[64];
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  uint32_t a[4][4];
  for (int g = 0; g < 4; ++g)
    for (int e = 0; e < 4; ++e) a[g][e] = tf32(0.5f + threadIdx.x * 1e-3f);
  volatile float* vf = f + kChunk / 4 + threadIdx.x;
  const uint32_t base = smem_addr(sm);
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    wg_fence();
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const uint64_t bh = desc_b(base + 2 * g * 4096, 128, 256);
      const uint64_t bl = desc_b(base + (2 * g + 1) * 4096, 128, 256);
      wgmma_tf32<128>(acc, a[g], bh, 1);
      wgmma_tf32<128>(acc, a[g], bl, 1);
      wgmma_tf32<128>(acc, a[g], bh, 1);
    }
    wg_commit();
    float x = *vf;                 // the chain starts after the commit
    for (int k = 0; k < alu; ++k) x = fmaf(x, 1.0001f, 0.5f);
    *vf = x;                       // and ends before the wait
    wg_wait0();
    fence_regs(acc);
    for (int g = 0; g < 4; ++g) fence_regs(a[g]);
  }
  const long long t1 = clock64();
  float s = 0.f;
  for (int e = 0; e < 64; ++e) s += acc[e];
  out[threadIdx.x] = s;
  if (threadIdx.x % 128 == 0) cyc[threadIdx.x / 128] = t1 - t0;
}

int main() {
  float* out;
  long long* cyc;
  cudaMalloc(&out, 256 * sizeof(float));
  cudaMalloc(&cyc, 2 * sizeof(long long));
  const int smem = kChunk + 256 * 4 + 1024, iters = 2000;
  cudaFuncSetAttribute(probe, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  for (int wgs : {1, 2})
    for (int alu : {0, 150, 300, 600}) {
      probe<<<1, 128 * wgs, smem>>>(out, cyc, iters, alu);
      long long h[2] = {0, 0};
      cudaMemcpy(h, cyc, wgs * sizeof(long long), cudaMemcpyDeviceToHost);
      printf("%d warpgroup(s), %3d dependent FFMA between commit and wait: "
             "%.1f cycles an iteration (%s)\n", wgs, alu,
             (double)h[0] / iters, cudaGetErrorString(cudaGetLastError()));
    }
  return 0;
}
