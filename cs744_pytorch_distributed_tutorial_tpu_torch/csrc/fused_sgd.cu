// Fused SGD(momentum, weight decay) update for one fp32 parameter tensor.
//
// Replaces the TPU kernel cs744_pytorch_distributed_tutorial_tpu/ops/fused_sgd.py
// (_kernel, launched per leaf from _update_leaf through pl.pallas_call).
// Exact torch-SGD semantics, in fp32:
//
//     g' = g + wd * p
//     m' = mu * m + g'
//     p' = p - lr * m'
//
// What bounds it: it is an elementwise pass with 6 flops per element and
// 20 bytes of traffic (read p, m, g; write p, m), so device-memory
// bandwidth is the only limit. The design moves each byte once: 16-byte
// (float4) loads and stores where all three pointers are 16-byte aligned,
// a scalar tail for the last n % 4 elements, and a grid-stride loop so a
// fixed grid covers any size. p and m are updated IN PLACE, as the JAX
// kernel aliases its outputs onto its inputs (input_output_aliases={0: 0,
// 1: 1}); nothing is allocated. The Pallas kernel's (rows, 128) padding
// is a TPU tiling fact and is not carried over.
//
// The arithmetic uses the _rn intrinsics so that nvcc does not contract
// it into FMAs: each step rounds exactly as the plain PyTorch version
// (ops/fused_sgd.py::fused_sgd_plain) rounds it.
//
// Plain C interface, loaded with ctypes: the launch runs on the caller's
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void sgd_one(float& p, float& m, float g, float lr,
                                        float mu, float wd) {
  const float ge = __fadd_rn(g, __fmul_rn(wd, p));
  m = __fadd_rn(__fmul_rn(mu, m), ge);
  p = __fsub_rn(p, __fmul_rn(lr, m));
}

__global__ void fused_sgd_f32_kernel(float* __restrict__ p,
                                     float* __restrict__ m,
                                     const float* __restrict__ g, int64_t n,
                                     int64_t n_vec, float lr, float mu,
                                     float wd) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* m4 = reinterpret_cast<float4*>(m);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  for (int64_t i = tid; i < n_vec; i += stride) {
    float4 pv = p4[i];
    float4 mv = m4[i];
    const float4 gv = __ldg(g4 + i);
    sgd_one(pv.x, mv.x, gv.x, lr, mu, wd);
    sgd_one(pv.y, mv.y, gv.y, lr, mu, wd);
    sgd_one(pv.z, mv.z, gv.z, lr, mu, wd);
    sgd_one(pv.w, mv.w, gv.w, lr, mu, wd);
    m4[i] = mv;
    p4[i] = pv;
  }
  for (int64_t i = 4 * n_vec + tid; i < n; i += stride) {
    float pv = p[i];
    float mv = m[i];
    sgd_one(pv, mv, g[i], lr, mu, wd);
    m[i] = mv;
    p[i] = pv;
  }
}

}  // namespace

extern "C" int fused_sgd_f32(void* p, void* m, const void* g, int64_t n,
                             float lr, float mu, float wd, void* stream) {
  if (n <= 0) return 0;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(m) |
        reinterpret_cast<uintptr_t>(g)) & 15u) == 0;
  const int64_t n_vec = aligned ? n / 4 : 0;
  const int threads = 256;
  const int64_t work = n_vec > 0 ? n_vec : n;
  // 132 SMs x 8 resident blocks of 256 threads keeps every SM's load
  // queue full; larger tensors take the grid-stride loop.
  const int64_t max_blocks = 132 * 8;
  int64_t blocks = (work + threads - 1) / threads;
  if (blocks > max_blocks) blocks = max_blocks;
  fused_sgd_f32_kernel<<<(unsigned)blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<float*>(m),
      static_cast<const float*>(g), n, n_vec, lr, mu, wd);
  return (int)cudaGetLastError();
}
