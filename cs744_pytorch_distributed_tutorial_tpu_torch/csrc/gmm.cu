// Grouped matrix product with a per-group bias (and gelu) epilogue, the
// forward of dropless MoE's expert FFN:
//   out[r] = act(lhs[r] @ rhs[g(r)] + bias[g(r)])
// lhs [M, K] and rhs [E, K, N] fp32 or bf16 (one dtype), bias [E, N] fp32,
// group_sizes int32 [E] on the device, out [M, N] fp32 or bf16. Row r belongs to
// group g(r) under the contiguous layout (group e holds rows [start_e, end_e),
// start_0 = 0, end_e = start_e + group_sizes[e], clamped to M); rows from
// sum(group_sizes) to M belong to the last group, as the TPU wrapper's padding
// does. Products summed in fp32, the bias added in fp32, gelu (tanh form,
// jax.nn.gelu's default) in fp32, then one rounding to out's dtype.
//
// Replaces the TPU kernel cs744_pytorch_distributed_tutorial_tpu/ops/gmm.py::
// _gmm_fused_kernel (launched from _gmm_fused_fwd_impl through pl.pallas_call),
// without its with_z output (the pre-activation the backward needs). The TPU
// kernel walks a scalar-prefetched schedule of (row tile, group) visits over a
// sequential grid axis and writes each visit's rows of its output tile. Here a
// block owns one output tile: it reads the E + 1 group offsets from the device
// (never from the host: the launch needs no synchronisation), then visits only
// the groups that overlap its rows, in order, each visit masking lhs rows of
// other groups to zero and reading that group's rhs[e] slab into the same fp32
// sums. Each row gets exactly its own group's products (the masked rows add
// exact zeros), so the epilogue adds the row's own group's bias. Empty groups
// and groups outside the tile cost nothing; a tile straddling b boundaries pays
// b extra passes over K, at most M/BM + E - 1 passes in all a column of tiles.
//
// What bounds it: at the MoE path's prefill (lhs [4096, 512] bf16, rhs
// [8, 512, 1024]) 4.29 GFLOP over about 21 MB: operations on the BF16 tensor
// cores (4.3 us), and 64 us on the FP32 units this kernel uses (FFMA). At decode
// (M 32) the expert weights dominate the bytes (8.4 MB if every expert is hit,
// 2.5 us). A simple kernel first, as int8_matmul.cu:
//
// - 256 threads a block; a 64 x 64 output tile with a 4 x 4 register tile a
//   thread, or 8 x 32 with one output a thread when M <= 64 (decode: 128
//   blocks for N 1024 and 64 for N 512, against 16 and 8 with the large
//   tile, and each 8-row tile overlaps fewer groups, so a block makes fewer
//   passes over K);
// - a 32-deep K slice a step in shared memory, lhs stored transposed, both
//   widened to fp32; ragged M, K and N edges zero-filled and masked.
//
// Left for later work: tensor cores (mma on bf16 tiles), cp.async pipelining,
// a visit schedule that balances blocks.
//
// Plain C interface, loaded with ctypes: the launch runs on the caller's
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDepth = 32;  // K per step
constexpr int kMaxGroups = 64;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x)));
}

// Output tile BM x BN; thread (ty, tx) owns rows ty*TM + i and columns
// tx + j*(BN/TN).
template <typename In, typename Out, int BM, int BN, int TM, int TN, bool kGelu>
__global__ void __launch_bounds__(kThreads)
gmm_fused_kernel(const In* __restrict__ lhs, const In* __restrict__ rhs,
                 const float* __restrict__ bias, const int* __restrict__ group_sizes,
                 Out* __restrict__ out, int M, int K, int N, int E) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "one output tile per block");
  constexpr int NX = BN / TN;  // threads along N
  __shared__ int ends[kMaxGroups];  // end row of each group, clamped; ends[E-1] = M
  __shared__ int row_group[BM];
  __shared__ float xs[kDepth][BM + 4];  // lhs slice, transposed
  __shared__ float ws[kDepth][BN];      // rhs[e] slice
  const int tid = threadIdx.x;
  const int tx = tid % NX, ty = tid / NX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  if (tid == 0) {
    int64_t acc = 0;
    for (int e = 0; e < E; ++e) {
      acc += group_sizes[e];
      ends[e] = (int)(acc < M ? acc : M);
    }
    ends[E - 1] = M;
  }
  __syncthreads();
  if (tid < BM) {
    int g = 0;
    while (g < E - 1 && ends[g] <= m0 + tid) ++g;
    row_group[tid] = g;
  }
  __syncthreads();

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int e = 0; e < E; ++e) {
    const int start = e ? ends[e - 1] : 0;
    const int lo = start > m0 ? start : m0;
    const int hi = ends[e] < m0 + BM ? ends[e] : m0 + BM;
    if (lo >= hi) continue;  // the same for every thread of the block
    const In* w = rhs + (int64_t)e * K * N;
    for (int k0 = 0; k0 < K; k0 += kDepth) {
      for (int i = tid; i < BM * kDepth; i += kThreads) {
        const int r = i / kDepth, c = i % kDepth;
        const int m = m0 + r, k = k0 + c;
        xs[c][r] = (m >= lo && m < hi && k < K) ? to_f32(lhs[(int64_t)m * K + k]) : 0.f;
      }
      for (int i = tid; i < kDepth * BN; i += kThreads) {
        const int r = i / BN, c = i % BN;
        const int k = k0 + r, n = n0 + c;
        ws[r][c] = (k < K && n < N) ? to_f32(w[(int64_t)k * N + n]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kDepth; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + j * NX];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    const int m = m0 + r;
    if (m >= M) continue;
    const float* brow = bias + (int64_t)row_group[r] * N;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * NX;
      if (n >= N) continue;
      float v = acc[i][j] + brow[n];
      if (kGelu) v = gelu_tanh(v);
      out[(int64_t)m * N + n] = from_f32<Out>(v);
    }
  }
}

template <typename In, typename Out, int BM, int BN, int TM, int TN>
cudaError_t launch(const void* lhs, const void* rhs, const float* bias, const int* gs,
                   void* out, int M, int K, int N, int E, bool gelu, cudaStream_t stream) {
  const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM));
  const In* l = static_cast<const In*>(lhs);
  const In* r = static_cast<const In*>(rhs);
  Out* o = static_cast<Out*>(out);
  if (gelu)
    gmm_fused_kernel<In, Out, BM, BN, TM, TN, true>
        <<<grid, kThreads, 0, stream>>>(l, r, bias, gs, o, M, K, N, E);
  else
    gmm_fused_kernel<In, Out, BM, BN, TM, TN, false>
        <<<grid, kThreads, 0, stream>>>(l, r, bias, gs, o, M, K, N, E);
  return cudaGetLastError();
}

template <typename In, typename Out>
cudaError_t launch_t(const void* lhs, const void* rhs, const float* bias, const int* gs,
                     void* out, int M, int K, int N, int E, bool gelu, cudaStream_t stream) {
  if (M <= 64)
    return launch<In, Out, 8, 32, 1, 1>(lhs, rhs, bias, gs, out, M, K, N, E, gelu, stream);
  return launch<In, Out, 64, 64, 4, 4>(lhs, rhs, bias, gs, out, M, K, N, E, gelu, stream);
}

}  // namespace

// out [M, N] (fp32, or bf16 if out_bf16) = act(lhs [M, K] @ rhs[g] [K, N] +
// bias[g]) with lhs and rhs fp32 (or bf16 if in_bf16), bias fp32 [E, N] and
// group_sizes int32 [E], all contiguous; gelu != 0 applies the tanh gelu.
extern "C" int gmm_fused(const void* lhs, const void* rhs, const void* bias,
                         const void* group_sizes, void* out, int64_t M, int64_t K, int64_t N,
                         int64_t E, int64_t gelu, int64_t in_bf16, int64_t out_bf16,
                         void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (E < 1 || E > kMaxGroups || K < 0 || M > 65535LL * 64 || K >= (1LL << 31) ||
      N >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(bias);
  const int* gs = static_cast<const int*>(group_sizes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = (int)M, k = (int)K, n = (int)N, e = (int)E;
  const bool g = gelu != 0;
  cudaError_t err;
  if (in_bf16)
    err = out_bf16 ? launch_t<__nv_bfloat16, __nv_bfloat16>(lhs, rhs, b, gs, out, m, k, n, e, g, s)
                   : launch_t<__nv_bfloat16, float>(lhs, rhs, b, gs, out, m, k, n, e, g, s);
  else
    err = out_bf16 ? launch_t<float, __nv_bfloat16>(lhs, rhs, b, gs, out, m, k, n, e, g, s)
                   : launch_t<float, float>(lhs, rhs, b, gs, out, m, k, n, e, g, s);
  return (int)err;
}
