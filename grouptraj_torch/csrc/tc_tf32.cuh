// Tensor-core helpers shared by the kernels that run 3xTF32 products on
// mma.sync (the pool pair tile, pool_core.cuh; the LSTM forwards K3,
// lstm_fused_fwd.cu, and K5, lstm_proj_fwd.cu, and backwards K4,
// lstm_fused_bwd.cu, and K6, lstm_proj_bwd.cu): a 16-byte cp.async, the
// TF32 rounding of the split x = hi + lo, one m16n8k8 TF32 product with
// float32 accumulate, and the shared-memory row strides of the LSTM tiles.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc_tf32 {

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0));
}

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero:
// cvt.rna.tf32.f32's rounding) by two integer operations, which issue
// faster than the conversion; finite x only.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// the split x = hi + lo of an A fragment, each part a TF32 value
__device__ __forceinline__ void split(const float (&x)[4], uint32_t (&hi)[4],
                                      uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hi[e] = tf32(x[e]);
    lo[e] = tf32(x[e] - __uint_as_float(hi[e]));
  }
}

// {hi.x, hi.y, lo.x, lo.y} of the split of (x, y)
__device__ __forceinline__ float4 split2(float x, float y) {
  const float hx = __uint_as_float(tf32(x)), hy = __uint_as_float(tf32(y));
  return make_float4(hx, hy, __uint_as_float(tf32(x - hx)),
                     __uint_as_float(tf32(y - hy)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b0)),
        "r"(__float_as_uint(b1)));
}

// a row stride (floats) >= n that is 8 mod 32: float2 reads of 8 rows x 4
// lanes and float reads of 4 rows x 8 lanes each hit 32 banks once
__host__ __device__ constexpr int stride8(int n) {
  return n + ((8 - n % 32) + 32) % 32;
}

// a row stride (floats) >= n that is 16 mod 32: float4 accesses of 2 rows x
// 4 lanes (a quarter warp) hit 32 banks once
__host__ __device__ constexpr int stride16(int n) {
  return n + ((16 - n % 32) + 32) % 32;
}

}  // namespace tc_tf32
