// Weight-only int8 matrix product: out [M, N] = (x [M, K] @ q [K, N]) * scale [N],
// x and out fp32 or bf16, q int8, scale fp32, every product summed in fp32.
//
// Replaces the TPU kernel cs744_pytorch_distributed_tutorial_tpu/ops/quant.py::
// _kernel (launched from int8_matmul through pl.pallas_call): the weight
// travels from device memory as int8 and is widened only on chip; the
// per-output-channel scale multiplies the fp32 sum after the dot, and the
// result is cast to x's dtype (round to nearest even for bf16), as there.
// Widening int8 to bf16 or fp32 is exact (|q| <= 127), and a bf16 x widens to
// fp32 exactly, so each product is exact and only the order of the fp32 sums
// differs from the plain version.
//
// What bounds it: at decode (x [16, 768] bf16, q [768, 50304], the GPT-2-small
// head) it reads 38.6 MB of weight for 1.2 GFLOP: bound by bytes (about 12 us
// at 3.35 TB/s). At a prompt pass (x [2048, 768]) it does 158 GFLOP: bound by
// operations. This kernel runs the products on the FP32 units (FFMA), not on
// the tensor cores: a simple design that is right first.
//
// - One block of 256 threads per output tile: 64 x 64 with a 4 x 4 register
//   tile a thread, or 16 x 128 with 2 x 4 when M <= 16 (decode), so that a
//   decode step spreads the weight over 393 blocks without idle rows.
// - Each step of K loads a 32-deep slice: x rows widened to fp32 and stored
//   transposed, the int8 weight rows 8 bytes a thread (one coalesced load when
//   N is a multiple of 8) and widened to fp32 in shared memory.
// - Any M, K and N: the ragged edges are masked (zero-filled tiles, guarded
//   stores). The TPU code's fallback for K not a multiple of 128 is not needed.
//
// The tensor cores took over bf16 x with K a multiple of 8 and N of 16:
// int8_matmul_tc.cu (wgmma with the widened weight as the B operand;
// ops/quant.py::tc_route picks). This kernel keeps fp32 x and the other
// shapes. Left for later work here: a pipeline of tiles in flight, split-K.
//
// Plain C interface, loaded with ctypes: the launch runs on the caller's
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDepth = 32;  // K per step

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

// Output tile BM x BN; thread (ty, tx) owns rows ty*TM + i and columns
// tx + j*(BN/TN).
template <typename T, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, T* __restrict__ out, int M, int K,
                   int N, int vec) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "one output tile per block");
  static_assert(BN % 8 == 0, "weight rows load 8 codes a thread");
  constexpr int NX = BN / TN;  // threads along N
  __shared__ float xs[kDepth][BM + 4];             // x slice, transposed
  __shared__ __align__(16) float ws[kDepth][BN];   // widened weight slice
  const int tid = threadIdx.x;
  const int tx = tid % NX, ty = tid / NX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kDepth) {
    for (int i = tid; i < BM * kDepth; i += kThreads) {
      const int r = i / kDepth, c = i % kDepth;
      const int m = m0 + r, k = k0 + c;
      xs[c][r] = (m < M && k < K) ? to_f32(x[(int64_t)m * K + k]) : 0.f;
    }
    for (int i = tid; i < kDepth * BN / 8; i += kThreads) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const int k = k0 + r, n = n0 + c;
      const int8_t* src = q + (int64_t)k * N + n;
      float w[8];
      if (vec && k < K && n + 8 <= N) {
        const int2 raw = *reinterpret_cast<const int2*>(src);
        const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) w[j] = (float)b[j];
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) w[j] = (k < K && n + j < N) ? (float)src[j] : 0.f;
      }
      *reinterpret_cast<float4*>(&ws[r][c]) = make_float4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<float4*>(&ws[r][c + 4]) = make_float4(w[4], w[5], w[6], w[7]);
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

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * NX;
      if (n < N) out[(int64_t)m * N + n] = from_f32<T>(acc[i][j] * scale[n]);
    }
  }
}

template <typename T, int BM, int BN, int TM, int TN>
cudaError_t launch(const void* x, const int8_t* q, const float* scale, void* out, int M,
                   int K, int N, int vec, cudaStream_t stream) {
  const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM));
  int8_matmul_kernel<T, BM, BN, TM, TN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), q, scale, static_cast<T*>(out), M, K, N, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* x, const int8_t* q, const float* scale, void* out, int M,
                     int K, int N, int vec, cudaStream_t stream) {
  if (M <= 16) return launch<T, 16, 128, 2, 4>(x, q, scale, out, M, K, N, vec, stream);
  return launch<T, 64, 64, 4, 4>(x, q, scale, out, M, K, N, vec, stream);
}

}  // namespace

// out [M, N] (x's dtype) from x [M, K] (fp32, or bf16 if bf16 != 0), q int8
// [K, N] and scale fp32 [N], all contiguous.
extern "C" int int8_matmul(const void* x, const void* q, const void* scale, void* out,
                           int64_t M, int64_t K, int64_t N, int64_t bf16, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (M > 65535LL * 64 || K >= (1LL << 31) || N >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  const int vec = (N % 8 == 0) && (reinterpret_cast<uintptr_t>(q) % 8 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = bf16 ? launch_t<__nv_bfloat16>(x, qp, sp, out, (int)M, (int)K, (int)N, vec, s)
                         : launch_t<float>(x, qp, sp, out, (int)M, (int)K, (int)N, vec, s);
  return (int)err;
}
