// Shared pieces of the projection-in-kernel LSTM kernels (K5 forward,
// lstm_proj_fwd.cu; K6 backward, lstm_proj_bwd.cu) beyond those of the
// whole-loop recurrence (lstm_fused.cuh): the dispatch over the input
// widths built.

#pragma once

#include "lstm_fused.cuh"

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
