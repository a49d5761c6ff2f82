// Grouped matrix products of dropless MoE's expert FFN, forward and backward:
//
//   gmm_fused  out[r] = act(lhs[r] @ rhs[g(r)] + bias[g(r)]), and optionally
//              z[r] = lhs[r] @ rhs[g(r)] + bias[g(r)] (the pre-activation);
//   gmm        out[r] = lhs[r] @ rhs[g(r)] in fp32, rhs read as stored or
//              transposed through its strides (the backward's dlhs);
//   tgmm       out[e] = sum over the rows r of group e of lhs[r]^T (x) dout[r],
//              [E, K, N] in fp32 (the backward's drhs);
//   colsum     out[e] = sum over the rows r of group e of dout[r], [E, N] in
//              fp32 (the backward's dbias: tgmm's function on an all-ones
//              [M, 1] lhs, which is never materialised).
//
// Row r belongs to group g(r) under the contiguous layout (group e holds rows
// [start_e, end_e), start_0 = 0, end_e = start_e + group_sizes[e], clamped to M);
// rows from sum(group_sizes) to M belong to the last group, as the TPU
// wrapper's padding does. group_sizes is int32 [E] on the device: no launch
// needs the host to know the offsets, so none synchronises. Products are summed
// in fp32, bf16 operands widened to fp32 on load (exact).
//
// Replaces the TPU kernels of cs744_pytorch_distributed_tutorial_tpu/ops/gmm.py:
// _gmm_fused_kernel (with its with_z output), _gmm_kernel and _tgmm_kernel
// (the latter also as _segment_sum_rows, the bias gradient). The TPU kernels
// walk a scalar-prefetched schedule of (row tile, group) visits over a
// sequential grid axis and carry sums in VMEM between visits. Here blocks run
// in parallel and carry nothing between them:
//
// - gmm_fused and gmm: a block owns one output tile. Each warp finds the
//   groups that overlap its rows from group_sizes in device memory
//   (groups.cuh: 32 sizes a step, so any number of groups is taken, and no
//   table of them is kept), and the block visits them in order, each visit
//   masking lhs rows of other groups to zero and
//   reading that group's rhs[e] slab into the same fp32 sums. Each row gets
//   exactly its own group's products (the masked rows add exact zeros), so the
//   epilogue adds the row's own group's bias. A tile straddling b boundaries
//   pays b extra passes over K. With kTransW the rhs slab [K, N] is read from
//   an [E, N, K] array (dlhs = dout @ rhs[e]^T reads rhs [E, K', N'] as it is
//   stored, no transposed copy), threads along K so the reads stay coalesced,
//   into a shared tile padded by one column against bank conflicts.
// - tgmm: a block owns (group e, a 64 x 64 tile of [K, N]) and walks the
//   group's rows in order, 32 rows a step staged in shared memory (lhs and
//   dout both read along their rows), each thread adding the rows' outer
//   products into its 4 x 4 sums one row after the other. A group whose size
//   is not positive writes zeros (the TPU kernel never visits such a group and
//   its wrapper zeroes it; the last group's rows past the sum then count for
//   nothing, as there).
// - colsum: a block owns 32 columns of one group; 8 lanes of 32 threads each
//   sum every 8th row of the group in order, and the 8 partials are added in
//   lane order. Both reductions run in a fixed order, so two runs are bitwise
//   equal.
//
// What bounds them: at the MoE training path (lhs [32768, 512] against
// [8, 512, 1024], and [32768, 1024] against [8, 1024, 512]) each gmm and tgmm
// call is 34.4 GFLOP over fp32 operands (the backward's dout is fp32): 0.51 ms
// on the FP32 units (67 TFLOP/s), above the bytes (about 0.2 GB, 0.06 ms).
// These kernels use FP32 FFMA on 64 x 64 tiles with a 4 x 4 register tile a
// thread; colsum reads dout once (134 MB at N 1024: bytes, 0.04 ms). At decode
// (M 32) gmm_fused is bound by the expert weights' bytes. A simple kernel
// first:
//
// - 256 threads a block; a 64 x 64 output tile with a 4 x 4 register tile a
//   thread, or 8 x 32 with one output a thread when M <= 64 (decode: more
//   blocks, and each 8-row tile overlaps fewer groups);
// - a 32-deep K (or row) slice a step in shared memory, widened to fp32;
//   ragged M, K and N edges zero-filled and masked.
//
// gmm and tgmm here are the FFMA route: ops/gmm.py::tc_pieces sends calls
// with a bf16 operand beside dout and rows of 16 bytes to the tensor-core
// kernels of gmm_tc.cu instead (dout as three exact bf16 pieces), and keeps
// these for fp32 operands and odd widths.
//
// gmm_fused here is the forward's FFMA route: ops/gmm.py::fused_tc_route sends
// bf16 calls with rows of 16 bytes (and enough rows) to gmm_tc.cu's
// gmm_fused_tc_kernel instead, which applies the same epilogue (gelu_tanh
// from activation.cuh) to wgmma sums.
//
// Left for later work: cp.async pipelining, a visit schedule that balances
// blocks.
//
// Plain C interface, loaded with ctypes: every launch runs on the caller's
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "activation.cuh"
#include "groups.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kDepth = 32;  // K (gmm) or rows (tgmm) per step
constexpr int kColLanes = 8;  // colsum: row lanes a block
constexpr int kColWidth = kThreads / kColLanes;  // colsum: columns a block

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

// Rows [start, end) of group e, as the forward's layout clamps them.
__device__ __forceinline__ void group_rows(const int* group_sizes, int e, int E, int M,
                                           int* start, int* end) {
  int64_t acc = 0;
  for (int j = 0; j < e; ++j) acc += group_sizes[j];
  const int64_t hi = acc + group_sizes[e];
  *start = (int)(acc < M ? acc : M);
  *end = e == E - 1 ? M : (int)(hi < M ? hi : M);
}

// Output tile BM x BN; thread (ty, tx) owns rows ty*TM + i and columns
// tx + j*(BN/TN). In is lhs's type, W rhs's; kTransW reads rhs[e] [K, N] from
// an [E, N, K] array. With kZ the pre-activation goes to z as well.
template <typename In, typename W, typename Out, int BM, int BN, int TM, int TN, bool kBias,
          bool kGelu, bool kZ, bool kTransW>
__global__ void __launch_bounds__(kThreads)
gmm_fused_kernel(const In* __restrict__ lhs, const W* __restrict__ rhs,
                 const float* __restrict__ bias, const int* __restrict__ group_sizes,
                 Out* __restrict__ out, Out* __restrict__ z, int M, int K, int N, int E) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "one output tile per block");
  constexpr int NX = BN / TN;  // threads along N
  constexpr int WS = kTransW ? BN + 1 : BN;  // row stride of the rhs tile
  __shared__ int row_group[BM];
  __shared__ float xs[kDepth][BM + 4];  // lhs slice, transposed
  __shared__ float ws[kDepth][WS];      // rhs[e] slice
  const int tid = threadIdx.x;
  const int tx = tid % NX, ty = tid / NX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // Every warp walks the groups that meet the tile's rows, in order: the
  // same visits for every thread of the block. (Listing them in shared
  // memory first, as gmm_tc.cu does, measured slower here.)
  int e, lo, hi;
  for (groups::GroupWalk walk(group_sizes, E, M, m0, m0 + BM); walk.next(&e, &lo, &hi);) {
    if (kBias)
      for (int r = lo - m0 + tid; r < hi - m0; r += kThreads) row_group[r] = e;
    const W* w = rhs + (int64_t)e * K * N;
    for (int k0 = 0; k0 < K; k0 += kDepth) {
      for (int i = tid; i < BM * kDepth; i += kThreads) {
        const int r = i / kDepth, c = i % kDepth;
        const int m = m0 + r, k = k0 + c;
        xs[c][r] = (m >= lo && m < hi && k < K) ? to_f32(lhs[(int64_t)m * K + k]) : 0.f;
      }
      if (kTransW) {
        for (int i = tid; i < kDepth * BN; i += kThreads) {
          const int c = i / kDepth, r = i % kDepth;  // threads along K: coalesced
          const int k = k0 + r, n = n0 + c;
          ws[r][c] = (k < K && n < N) ? to_f32(w[(int64_t)n * K + k]) : 0.f;
        }
      } else {
        for (int i = tid; i < kDepth * BN; i += kThreads) {
          const int r = i / BN, c = i % BN;
          const int k = k0 + r, n = n0 + c;
          ws[r][c] = (k < K && n < N) ? to_f32(w[(int64_t)k * N + n]) : 0.f;
        }
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
  if (kBias) __syncthreads();  // row_group is whole (a K of 0 runs no step)

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    const int m = m0 + r;
    if (m >= M) continue;
    const float* brow = kBias ? bias + (int64_t)row_group[r] * N : nullptr;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * NX;
      if (n >= N) continue;
      float v = acc[i][j];
      if (kBias) v += brow[n];
      if (kZ) z[(int64_t)m * N + n] = from_f32<Out>(v);
      if (kGelu) v = gelu_tanh(v);
      out[(int64_t)m * N + n] = from_f32<Out>(v);
    }
  }
}

template <typename In, typename W, typename Out, int BM, int BN, int TM, int TN, bool kBias,
          bool kTransW>
cudaError_t launch(const void* lhs, const void* rhs, const float* bias, const int* gs,
                   void* out, void* z, int M, int K, int N, int E, bool gelu,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM));
  const In* l = static_cast<const In*>(lhs);
  const W* r = static_cast<const W*>(rhs);
  Out* o = static_cast<Out*>(out);
  Out* zo = static_cast<Out*>(z);
  if constexpr (!kBias)
    gmm_fused_kernel<In, W, Out, BM, BN, TM, TN, false, false, false, kTransW>
        <<<grid, kThreads, 0, stream>>>(l, r, bias, gs, o, zo, M, K, N, E);
  else if (gelu && zo)
    gmm_fused_kernel<In, W, Out, BM, BN, TM, TN, true, true, true, kTransW>
        <<<grid, kThreads, 0, stream>>>(l, r, bias, gs, o, zo, M, K, N, E);
  else if (gelu)
    gmm_fused_kernel<In, W, Out, BM, BN, TM, TN, true, true, false, kTransW>
        <<<grid, kThreads, 0, stream>>>(l, r, bias, gs, o, zo, M, K, N, E);
  else
    gmm_fused_kernel<In, W, Out, BM, BN, TM, TN, true, false, false, kTransW>
        <<<grid, kThreads, 0, stream>>>(l, r, bias, gs, o, zo, M, K, N, E);
  return cudaGetLastError();
}

template <typename In, typename W, typename Out, bool kBias, bool kTransW>
cudaError_t launch_t(const void* lhs, const void* rhs, const float* bias, const int* gs,
                     void* out, void* z, int M, int K, int N, int E, bool gelu,
                     cudaStream_t stream) {
  if (M <= 64)
    return launch<In, W, Out, 8, 32, 1, 1, kBias, kTransW>(lhs, rhs, bias, gs, out, z, M, K, N,
                                                           E, gelu, stream);
  return launch<In, W, Out, 64, 64, 4, 4, kBias, kTransW>(lhs, rhs, bias, gs, out, z, M, K, N,
                                                          E, gelu, stream);
}

// dW tile BK x BN of group blockIdx.z; thread (ty, tx) owns rows ty*TK + i of
// K and columns tx + j*(BN/TN).
template <typename L, int BK, int BN, int TK, int TN>
__global__ void __launch_bounds__(kThreads)
tgmm_kernel(const L* __restrict__ lhs, const float* __restrict__ dout,
            const int* __restrict__ group_sizes, float* __restrict__ out, int M, int K, int N,
            int E) {
  static_assert((BK / TK) * (BN / TN) == kThreads, "one output tile per block");
  constexpr int NX = BN / TN;
  __shared__ float xs[kDepth][BK];  // lhs rows, along K
  __shared__ float ds[kDepth][BN];  // dout rows, along N
  const int tid = threadIdx.x;
  const int tx = tid % NX, ty = tid / NX;
  const int e = blockIdx.z, k0 = blockIdx.y * BK, n0 = blockIdx.x * BN;
  int start, end;
  group_rows(group_sizes, e, E, M, &start, &end);
  if (group_sizes[e] <= 0) end = start;  // an empty group's gradient is zero

  float acc[TK][TN];
#pragma unroll
  for (int i = 0; i < TK; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int r0 = start; r0 < end; r0 += kDepth) {
    for (int i = tid; i < kDepth * BK; i += kThreads) {
      const int rr = i / BK, c = i % BK;
      const int m = r0 + rr, k = k0 + c;
      xs[rr][c] = (m < end && k < K) ? to_f32(lhs[(int64_t)m * K + k]) : 0.f;
    }
    for (int i = tid; i < kDepth * BN; i += kThreads) {
      const int rr = i / BN, c = i % BN;
      const int m = r0 + rr, n = n0 + c;
      ds[rr][c] = (m < end && n < N) ? dout[(int64_t)m * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < kDepth; ++rr) {  // the group's rows in order
      float a[TK], b[TN];
#pragma unroll
      for (int i = 0; i < TK; ++i) a[i] = xs[rr][ty * TK + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ds[rr][tx + j * NX];
#pragma unroll
      for (int i = 0; i < TK; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* o = out + (int64_t)e * K * N;
#pragma unroll
  for (int i = 0; i < TK; ++i) {
    const int k = k0 + ty * TK + i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * NX;
      if (n < N) o[(int64_t)k * N + n] = acc[i][j];
    }
  }
}

// out[e, n] = sum of dout[r, n] over group e's rows: lane l of the block sums
// rows start + l, start + l + kColLanes, ... in order; then the lanes' sums are
// added in lane order.
__global__ void __launch_bounds__(kThreads)
colsum_kernel(const float* __restrict__ dout, const int* __restrict__ group_sizes,
              float* __restrict__ out, int M, int N, int E) {
  __shared__ float part[kColLanes][kColWidth];
  const int tid = threadIdx.x;
  const int c = tid % kColWidth, lane = tid / kColWidth;
  const int e = blockIdx.y, n = blockIdx.x * kColWidth + c;
  int start, end;
  group_rows(group_sizes, e, E, M, &start, &end);
  if (group_sizes[e] <= 0) end = start;
  float acc = 0.f;
  if (n < N) {
#pragma unroll 8
    for (int m = start + lane; m < end; m += kColLanes) acc += dout[(int64_t)m * N + n];
  }
  part[lane][c] = acc;
  __syncthreads();
  if (lane == 0 && n < N) {
    float s = part[0][c];
#pragma unroll
    for (int l = 1; l < kColLanes; ++l) s += part[l][c];
    out[(int64_t)e * N + n] = s;
  }
}

bool bad_shape(int64_t M, int64_t K, int64_t N, int64_t E) {
  return E < 1 || K < 0 || M > 65535LL * 64 || M >= (1LL << 31) ||
         K >= (1LL << 31) || N >= (1LL << 31);
}

}  // namespace

// out [M, N] (fp32, or bf16 if out_bf16) = act(lhs [M, K] @ rhs[g] [K, N] +
// bias[g]) with lhs and rhs fp32 (or bf16 if in_bf16), bias fp32 [E, N] and
// group_sizes int32 [E], all contiguous; gelu != 0 applies the tanh gelu. z,
// if not null, receives the pre-activation in out's dtype (gelu only).
extern "C" int gmm_fused(const void* lhs, const void* rhs, const void* bias,
                         const void* group_sizes, void* out, void* z, int64_t M, int64_t K,
                         int64_t N, int64_t E, int64_t gelu, int64_t in_bf16, int64_t out_bf16,
                         void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (bad_shape(M, K, N, E) || (z && !gelu)) return (int)cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(bias);
  const int* gs = static_cast<const int*>(group_sizes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = (int)M, k = (int)K, n = (int)N, e = (int)E;
  const bool g = gelu != 0;
  using bf16 = __nv_bfloat16;
  if (in_bf16)
    return (int)(out_bf16
                     ? launch_t<bf16, bf16, bf16, true, false>(lhs, rhs, b, gs, out, z, m, k, n,
                                                               e, g, s)
                     : launch_t<bf16, bf16, float, true, false>(lhs, rhs, b, gs, out, z, m, k,
                                                                n, e, g, s));
  return (int)(out_bf16
                   ? launch_t<float, float, bf16, true, false>(lhs, rhs, b, gs, out, z, m, k, n,
                                                               e, g, s)
                   : launch_t<float, float, float, true, false>(lhs, rhs, b, gs, out, z, m, k,
                                                                n, e, g, s));
}

// out [M, N] fp32 = lhs [M, K] @ rhs[g] [K, N], lhs fp32 (or bf16 if
// lhs_bf16), rhs fp32 (or bf16 if rhs_bf16); with trans_rhs the rhs array is
// [E, N, K] and rhs[g] is its transpose. Taken: lhs fp32 under a transposed
// fp32 or bf16 rhs (the backward's dlhs), lhs and rhs of one dtype as stored
// (grouped_matmul's forward).
extern "C" int gmm(const void* lhs, const void* rhs, const void* group_sizes, void* out,
                   int64_t M, int64_t K, int64_t N, int64_t E, int64_t lhs_bf16,
                   int64_t rhs_bf16, int64_t trans_rhs, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (bad_shape(M, K, N, E)) return (int)cudaErrorInvalidValue;
  const int* gs = static_cast<const int*>(group_sizes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = (int)M, k = (int)K, n = (int)N, e = (int)E;
  using bf16 = __nv_bfloat16;
  if (trans_rhs && !lhs_bf16)
    return (int)(rhs_bf16 ? launch_t<float, bf16, float, false, true>(lhs, rhs, nullptr, gs, out,
                                                                      nullptr, m, k, n, e, false,
                                                                      s)
                          : launch_t<float, float, float, false, true>(lhs, rhs, nullptr, gs,
                                                                       out, nullptr, m, k, n, e,
                                                                       false, s));
  if (!trans_rhs && lhs_bf16 == rhs_bf16)
    return (int)(lhs_bf16 ? launch_t<bf16, bf16, float, false, false>(lhs, rhs, nullptr, gs,
                                                                      out, nullptr, m, k, n, e,
                                                                      false, s)
                          : launch_t<float, float, float, false, false>(lhs, rhs, nullptr, gs,
                                                                        out, nullptr, m, k, n,
                                                                        e, false, s));
  return (int)cudaErrorInvalidValue;
}

// out [E, K, N] fp32: per group, lhs[rows]^T @ dout[rows] with lhs [M, K] fp32
// (or bf16 if lhs_bf16) and dout [M, N] fp32; zero for a group whose size is
// not positive.
extern "C" int tgmm(const void* lhs, const void* dout, const void* group_sizes, void* out,
                    int64_t M, int64_t K, int64_t N, int64_t E, int64_t lhs_bf16,
                    void* stream) {
  if (K <= 0 || N <= 0) return 0;
  if (bad_shape(M, K, N, E) || M < 0 || K > 65535LL * 64) return (int)cudaErrorInvalidValue;
  constexpr int BK = 64, BN = 64;
  const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((K + BK - 1) / BK), (unsigned)E);
  const int* gs = static_cast<const int*>(group_sizes);
  const float* d = static_cast<const float*>(dout);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lhs_bf16)
    tgmm_kernel<__nv_bfloat16, BK, BN, 4, 4><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(lhs), d, gs, o, (int)M, (int)K, (int)N, (int)E);
  else
    tgmm_kernel<float, BK, BN, 4, 4><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(lhs), d, gs, o, (int)M, (int)K, (int)N, (int)E);
  return (int)cudaGetLastError();
}

// out [E, N] fp32: per group, the column sums of dout [M, N] fp32 over its
// rows; zero for a group whose size is not positive.
extern "C" int colsum(const void* dout, const void* group_sizes, void* out, int64_t M,
                      int64_t N, int64_t E, void* stream) {
  if (N <= 0) return 0;
  if (bad_shape(M, 1, N, E) || M < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((N + kColWidth - 1) / kColWidth), (unsigned)E);
  colsum_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dout), static_cast<const int*>(group_sizes),
      static_cast<float*>(out), (int)M, (int)N, (int)E);
  return (int)cudaGetLastError();
}
