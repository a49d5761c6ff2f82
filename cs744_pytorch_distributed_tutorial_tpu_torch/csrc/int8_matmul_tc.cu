// Weight-only int8 matrix product on Hopper's tensor cores, for bf16
// activations: out [M, N] = bf16((x [M, K] @ bf16(q [K, N])) * scale [N]), q
// int8, scale fp32, every product summed in fp32.
//
// Replaces the TPU kernel cs744_pytorch_distributed_tutorial_tpu/ops/quant.py::
// _kernel (launched from int8_matmul through pl.pallas_call) on the bf16 route,
// where csrc/int8_matmul.cu's FFMA kernel ran before (it still takes fp32
// activations and the shapes this kernel does not: K not a multiple of 8, N
// not a multiple of 16). The weight travels from device memory as int8 and is
// widened only on chip; the per-output-channel scale multiplies the fp32 sum
// after the dot, and the result is rounded to bf16 (to nearest even), as
// there. Widening int8 to bf16 is exact (|q| <= 127), so a bf16 wgmma with
// fp32 accumulation forms exactly the TPU kernel's products: only the order
// of the fp32 sums differs.
//
// What bounds it, at the GPT-2-small head: a prompt pass (x [2048, 768], q
// [768, 50304]) does 158.2 GFLOP and moves about 248 MB (the weight 38.6 MB,
// the bf16 output 206 MB): 0.160 ms at the bf16 tensor-core peak (989
// TFLOP/s) against 0.074 ms of bytes, so operations bound it (on an NVIDIA
// H100 80GB HBM3 the FFMA kernel took 5.86 ms and cuBLAS on the widened
// weight 0.82 ms). A decode step (x [16, 768]) is bound by the weight's
// bytes: 38.6 MB, 0.0121 ms at 3.35 TB/s.
//
// The design (simple and right first):
// - A block owns an output tile of 64 W rows x 128 columns: W = 2 consumer
//   warpgroups of 64 rows (W = 1 when M <= 64: a decode step's 16 rows pad one
//   warpgroup, not two) and a producer warpgroup, one thread of which issues
//   every TMA load into a ring of 4 stages on full/empty mbarriers. A stage
//   holds 64 of the contraction: x's [64 W rows][64] bf16 box (K-major, 128-
//   byte swizzle) and q's [64 K rows][128] int8 box (N contiguous, no swizzle).
//   The grid walks the row tiles fastest, so the blocks in flight share a few
//   columns of q in L2 (10 % faster at a prompt pass than columns fastest, in
//   paired runs on an NVIDIA H100 80GB HBM3 at 700 W).
// - The consumers widen a stage's int8 box into a bf16 buffer laid out as two
//   [64 K][64 N] boxes, 128-byte swizzled as TMA would have loaded them (the
//   16-byte group g of row k stored at g ^ (k % 8)): the MN-major B operand
//   that wgmma's descriptor reads (transpose bit, LBO = a box). The widening
//   is generic-proxy stores, so each thread issues fence.proxy.async.shared::
//   cta before the named barrier after which wgmma (the async proxy) reads
//   them; without the fence the tensor cores may read stale bytes.
// - Two widened buffers in turn: while one stage's wgmma m64n128k16 run
//   (A = x from shared memory, B = the widened weight), the consumers widen
//   the next stage's int8 box into the other buffer; one named barrier a
//   stage, after the wait, hands both buffers over.
// - Sums: each stage's four products go into a fresh accumulator, which is
//   then added into fp32 sums in registers by round-to-nearest adds. The
//   tensor cores' additions in one long accumulator chain do not round to
//   nearest (gmm_tc.cu found a 4,000-row chain outside its 1e-5 limit);
//   promoted once a stage, the chain is at most 4 products long.
// - Ragged edges: TMA zero-fills x's rows past M, and x's columns and q's rows
//   past K; the stores are clipped at M and N. The epilogue multiplies by
//   scale[n] and rounds to bf16.
// - The route rule (ops/quant.py::tc_route): bf16 x, K a multiple of 8 and N
//   a multiple of 16 (TMA's 16-byte row strides of x and q), 16-byte-aligned
//   x and q, and M at least the rule's threshold (its measurement is in
//   PERF.md).
//
// Left for later work: a persistent grid, overlapping the epilogue with the
// next tile's loads, TMA stores of the output, swapping A and B for decode
// (out^T = q^T x^T, so that 16 rows of x become n16 rather than padding m64),
// split-K for decode, and widening by byte permutes rather than conversions.
//
// Plain C interface, loaded with ctypes: the launch runs on the caller's
// stream, does not synchronise, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape or pointer this kernel does not take).
// The Hopper primitives are in hopper.cuh.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kChunk = 64;           // contraction a stage: one 128-byte row of x
constexpr int kTileN = 128;          // output columns of a block
constexpr int kStages = 4;
constexpr int kBox = 64 * 128;       // [64 rows][128 bytes]: 8 KB
constexpr int kQ = kChunk * kTileN;  // an int8 [64 K][128 N] stage: 8 KB
constexpr int kWide = 2 * kBox;      // its widened bf16: two [64 K][64 N] boxes

template <int W>
__host__ __device__ constexpr int stage_bytes() {
  return W * kBox + kQ;  // x's 64 W rows, then q
}

template <int W>
constexpr int smem_bytes() {
  return kSwizzleBytes + kStages * stage_bytes<W>() + 2 * kWide;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Consumer thread t of kThreads widens its 16-byte pieces of the int8 stage
// q8 ([64 K][128 N], row k at 128 k) into wide: column n of row k goes to box
// n / 64, row k, 16-byte group (n % 64) / 8 ^ (k % 8).
template <int kThreads>
__device__ __forceinline__ void widen(const uint8_t* q8, uint8_t* wide, int t) {
#pragma unroll
  for (int j = 0; j < kQ / 16 / kThreads; ++j) {
    const int i = t + j * kThreads;
    const int k = i / 8, c = i % 8;  // row k, int8 columns 16 c ... 16 c + 15
    const int4 raw = *reinterpret_cast<const int4*>(q8 + 16 * i);
    const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
    uint32_t w[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      w[e] = pack_bf16(static_cast<float>(v[2 * e]), static_cast<float>(v[2 * e + 1]));
    uint8_t* row = wide + (c / 4) * kBox + k * 128;
    const int g = 2 * (c % 4);
    *reinterpret_cast<uint4*>(row + ((g ^ (k % 8)) * 16)) = make_uint4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<uint4*>(row + (((g + 1) ^ (k % 8)) * 16)) =
        make_uint4(w[4], w[5], w[6], w[7]);
  }
}

__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

template <int W>
__global__ void __launch_bounds__(128 * (1 + W), 1)
int8_matmul_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_q, const float* __restrict__ scale,
                      bf16* __restrict__ out, int M, int K, int N) {
  constexpr int kRows = 64 * W, kStage = stage_bytes<W>(), kConsumers = 128 * W;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  uint8_t* ring = ring_base(smem_raw);
  uint8_t* wide = ring + kStages * kStage;  // two buffers of kWide
  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.x * kRows, n0 = blockIdx.y * kTileN;  // row tiles fastest
  const int nk = (K + kChunk - 1) / kChunk;

  if (tid == 0) init_ring<kStages>(full, empty, 4 * W);
  __syncthreads();

  if (wg == 0) {  // producer
    if (tid == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int kc = 0; kc < nk; ++kc) {
        mbar_wait(&empty[s], ph ^ 1);
        uint8_t* st = ring + s * kStage;
        mbar_expect_tx(&full[s], kStage);
        tma_load(st, &map_x, &full[s], kc * kChunk, m0, 0);
        tma_load(st + W * kBox, &map_q, &full[s], n0, kc * kChunk, 0);
        if (++s == kStages) s = 0, ph ^= 1;
      }
    }
    return;
  }

  const int ct = tid - 128, cw = wg - 1, lane = tid % 32;
  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.f;

  mbar_wait(&full[0], 0);
  widen<kConsumers>(ring + W * kBox, wide, ct);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  consumers_sync(kConsumers);
  int s = 0;
  uint32_t ph = 0;
  for (int kc = 0; kc < nk; ++kc) {
    const uint8_t* st = ring + s * kStage;
    const uint8_t* wb = wide + (kc & 1) * kWide;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      wgmma_m64n128k16<0, 1>(acc, desc(st + cw * kBox + kk * 32, 16),
                             desc(wb + kk * 16 * 128, kBox), kk);
    wgmma_commit();
    int s2 = s + 1;
    uint32_t ph2 = ph;
    if (s2 == kStages) s2 = 0, ph2 ^= 1;
    if (kc + 1 < nk) {  // widen the next stage while the tensor cores run
      mbar_wait(&full[s2], ph2);
      widen<kConsumers>(ring + s2 * kStage + W * kBox, wide + ((kc + 1) & 1) * kWide, ct);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    wgmma_wait_all();
    fence_acc(acc);
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] += acc[i];
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // x read by wgmma, q widened
    consumers_sync(kConsumers);  // the next buffer is written, this one read
    s = s2;
    ph = ph2;
  }

  // Thread (warp w, lane l) holds rows 16 w + l / 4 (+ 8) and columns 8 c + 2
  // (l % 4) (+ 1) of its warpgroup's 64 rows at sum[4 c + 2 h + j].
  const int t = tid % 128;
  const int r = m0 + 64 * cw + (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const int col = n0 + 8 * c + 2 * (t % 4);
    if (col >= N) continue;  // N even: col + 1 < N too
    const float s0 = scale[col], s1 = scale[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      if (row < M)
        *reinterpret_cast<uint32_t*>(out + static_cast<int64_t>(row) * N + col) =
            pack_bf16(sum[4 * c + 2 * h] * s0, sum[4 * c + 2 * h + 1] * s1);
    }
  }
}

// A map of the row-major [rows, cols] tensor at ptr (row_bytes apart) as a 3-D
// map of dims (cols, rows, 1), read in boxes of box0 x box1.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int64_t cols,
              int64_t rows, int64_t row_bytes, int box0, int box1, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows), 1};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_bytes),
                                 static_cast<cuuint64_t>(row_bytes * rows)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box0), static_cast<cuuint32_t>(box1), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int W>
cudaError_t launch(const void* x, const void* q, const float* scale, bf16* out, int64_t M,
                   int64_t K, int64_t N, cudaStream_t stream) {
  CUtensorMap mx, mq;
  if (!make_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, 2 * K, kChunk, 64 * W,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&mq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, K, N, kTileN, kChunk,
                CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((M + 64 * W - 1) / (64 * W)),
                  static_cast<unsigned>((N + kTileN - 1) / kTileN));
  constexpr int smem = smem_bytes<W>();
  cudaError_t err = cudaFuncSetAttribute(int8_matmul_tc_kernel<W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int8_matmul_tc_kernel<W><<<grid, 128 * (1 + W), smem, stream>>>(
      mx, mq, scale, out, static_cast<int>(M), static_cast<int>(K), static_cast<int>(N));
  return cudaGetLastError();
}

}  // namespace

// out [M, N] bf16 (contiguous) from x [M, K] bf16 and q int8 [K, N] (both
// contiguous, 16-byte aligned; K a multiple of 8, N of 16) and scale fp32 [N].
extern "C" int int8_matmul_tc(const void* x, const void* q, const void* scale, void* out,
                              int64_t M, int64_t K, int64_t N, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || K % 8 || N % 16 || K >= (1LL << 31) || M >= (1LL << 31) - 128 ||
      (N + kTileN - 1) / kTileN > 65535 || misaligned(x) || misaligned(q))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sp = static_cast<const float*>(scale);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = M <= 64 ? launch<1>(x, q, sp, o, M, K, N, s)
                                  : launch<2>(x, q, sp, o, M, K, N, s);
  return static_cast<int>(err);
}
