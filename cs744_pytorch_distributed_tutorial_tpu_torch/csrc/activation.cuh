// The activation of the grouped matmul's fused epilogue, shared by its FFMA
// kernel (gmm.cu) and its tensor-core kernel (gmm_tc.cu), so both routes
// apply the same arithmetic: jax.nn.gelu's default tanh form in fp32.
// ops/_build.py hashes this header with every source that includes it.

#pragma once

#include <math.h>

__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}
