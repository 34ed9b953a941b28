// Shared pieces of the projection-in-kernel LSTM kernels (K5 forward,
// lstm_proj_fwd.cu; K6 backward, lstm_proj_bwd.cu) beyond those of the
// whole-loop recurrence (lstm_fused.cuh): the forward's staging of the input
// matrix W_ih [D, 4H] and the dispatch over the input widths built.

#pragma once

#include "lstm_fused.cuh"

namespace lstm_proj {

// Shared layout of the input matrix W_ih [D, 4H] as one float4 (i, f, g, o)
// per (d, unit), lanes over j at fixed d: element W_ih[d][g*H + j] goes to
// slot d*H + j, component g.
template <int D, int H>
__device__ __forceinline__ void stage_input_matrix(float4* dst,
                                                   const float* __restrict__ w,
                                                   int tid, int threads) {
  float* out = reinterpret_cast<float*>(dst);
  for (int idx = tid; idx < 4 * D * H; idx += threads) {
    const int d = idx / (4 * H), col = idx % (4 * H);
    const int g = col / H, j = col % H;
    out[(d * H + j) * 4 + g] = w[idx];
  }
}

}  // namespace lstm_proj

// Calls CALL with `constexpr int kD` for the input widths the kernels are
// built for; any other D gives cudaErrorInvalidValue (the wrapper refuses it
// before it gets here).
#define LSTM_PROJ_DISPATCH_D(D_, ...)                     \
  switch (D_) {                                           \
    case 4: { constexpr int kD = 4; __VA_ARGS__; } break;   \
    case 8: { constexpr int kD = 8; __VA_ARGS__; } break;   \
    case 16: { constexpr int kD = 16; __VA_ARGS__; } break; \
    default: err = cudaErrorInvalidValue;                 \
  }
