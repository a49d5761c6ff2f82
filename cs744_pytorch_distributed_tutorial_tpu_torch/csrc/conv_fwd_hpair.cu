// 3x3 stride-1 SAME convolution forward, NHWC bf16, C = 64, in the H-pair-packed
// form, on Hopper's tensor cores (wgmma on bf16 tiles that TMA brings into
// shared memory):
//
//     out = unpack(lhs @ w_packed),  w_packed [12C, 2C] bf16,
//     lhs[(b, m, w), (r, dx, c)] = x[b, 2m - 1 + r, w + dx - 1, c]  (zero outside),
//     out[b, 2m, w, :] = columns 0:C,  out[b, 2m + 1, w, :] = columns C:2C,
//
// summed in fp32 and rounded once to bf16. With w_packed from pack_weights (the
// even row's taps r 0-2, the odd row's r 1-3, zero blocks elsewhere) this is
// the 3x3 SAME conv; the kernel computes the function for any w_packed, its
// zero blocks multiplied like the rest.
//
// Replaces the TPU kernel benchmarks/probe_fwd_hpair.py::_fwd_kernel (the
// probe's pallas_call). Its packing of two output rows into one 128-wide
// product filled the TPU's 128-lane MXU; here it only sets N = 128, a natural
// wgmma width, and costs a quarter of the multiply-adds (12 taps where a conv
// needs 9). The TPU kernel's block-batch grid and its loop over row pairs in
// VMEM do not carry over.
//
// The GEMM. M = B * H/2 * W output pixels of row pairs, (b, m, w); K = 12
// taps x 64 channels; N = 128. A tile is 128 rows of M: P = 128 / W whole row
// pairs of one image (W 8 to 128, a power of two). Its A operand for tap (r,
// dx) is one TMA box of x seen as the 5-D tensor [B][H/2][2][W][C] (a free
// view of NHWC): box {C 64, W, 1, P, 1} at (0, dx - 1, row parity, m0 + pair
// shift, b), where input row 2m - 1 + r is pair m + floor((r - 1) / 2) at
// parity (r + 1) % 2. TMA's zero fill outside the tensor, at negative
// coordinates too, is the SAME padding: column -1 and W, rows -1 and H. Every
// box starts at channel 0, so its innermost coordinate sits on 16 bytes (TMA
// faults otherwise). Each box row is one 128-byte bf16 row of 64 channels,
// 128-byte swizzled: a K-major A operand for wgmma as it lands, no im2col
// written anywhere.
//
// The weights. w_packed (192 KB) is loaded once a block into shared memory
// as 24 boxes of 64 x 64 (per tap its two 64-column halves, MN-major for
// wgmma's B); the block is persistent (one a SM, tiles strided over the
// grid), so each block reads it from L2 once. The 227 KB of shared memory
// then leave room for two 16 KB stages of A.
//
// Layout of a block (384 threads): warpgroup 0 is the producer, one thread of
// which issues every TMA load; warpgroups 1 and 2 are consumers, each running
// wgmma.m64n128k16 on 64 of the tile's 128 rows, 4 k steps a tap. Each tap's
// products go into a fresh accumulator that is added into fp32 sums in
// registers by round-to-nearest adds (gmm_tc.cu's note: the tensor cores'
// own long chains of additions do not round to nearest). The epilogue rounds
// the sums to bf16 and writes columns 0:64 to row 2m and 64:128 to row 2m+1,
// bf16 pairs straight from the accumulator's registers.
//
// What bounds it: at the probe's [4096, 32, 32, 64] the packed product is
// 4.123e11 FLOP, 0.417 ms at the bf16 peak (989 TFLOP/s), against 1.07 GB of
// x, out and w_packed (0.321 ms at 3.35 TB/s): operations. A library conv does
// 9/12 of those operations and is bound by the bytes (0.321 ms), so this form
// cannot beat a library conv at its bound. Beyond that: each x row reaches
// shared memory 12 times (once a tap) from L2, 3.2 GB at this shape, through
// a ring of only two 16 KB stages beside the resident weights, so L2 latency
// and bandwidth, not the tensor cores, are expected to set the pace.
//
// Left for later work: reading each input row once a tile and forming the
// column shifts in shared memory, a cluster of two blocks each holding half
// of w_packed with A multicast (a deeper ring), overlapping one tile's
// epilogue with the next tile's products, and TMA stores.
//
// Plain C interface, loaded with ctypes: the launch runs on the caller's
// stream, does not synchronise, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape or pointer it does not take). The caller
// allocates the output; the tensor maps are encoded on the host per call
// (hopper.cuh's encode_tiled).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 384;             // a producer and two consumer warpgroups
constexpr int kC = 64;                    // channels in and out: one 128-byte row
constexpr int kTaps = 12;                 // (r 0-3) x (dx 0-2)
constexpr int kRows = 128;                // lhs rows (output pixel pairs) a tile
constexpr int kWBox = kC * kC * 2;        // a 64 x 64 box of w_packed: 8 KB
constexpr int kWTap = 2 * kWBox;          // a tap's 64 rows x 128 columns: 16 KB
constexpr int kWBytes = kTaps * kWTap;    // all of w_packed: 192 KB
constexpr int kATile = kRows * kC * 2;    // a tap's 128 lhs rows: 16 KB
constexpr int kStages = 2;
constexpr int kSmem = kWBytes + kStages * kATile + kSwizzleBytes;

// Block: tiles blockIdx.x, + gridDim.x, ... of the B * tiles_per_image tiles;
// tile (b, j) holds row pairs j P ... j P + P - 1 of image b (those past H/2
// read zeros and are not stored).
__global__ void __launch_bounds__(kThreads, 1)
conv_fwd_hpair_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w, bf16* __restrict__ out, int H,
                      int W, int pairs_per_tile, int tiles_per_image, int tiles) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], wfull;
  uint8_t* wsm = ring_base(smem_raw);
  uint8_t* ring = wsm + kWBytes;
  const int tid = threadIdx.x, wg = tid / 128;

  if (tid == 0) {
    mbar_init(&wfull, 1);
    init_ring<kStages>(full, empty);  // its fence covers wfull too
  }
  __syncthreads();

  if (wg == 0) {  // producer
    if (tid == 0) {
      mbar_expect_tx(&wfull, kWBytes);
      for (int t = 0; t < kTaps; ++t)
        for (int half = 0; half < 2; ++half)
          tma_load(wsm + t * kWTap + half * kWBox, &map_w, &wfull, half * kC, t * kC, 0);
      int s = 0;
      uint32_t ph = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int b = tile / tiles_per_image;
        const int m0 = (tile - b * tiles_per_image) * pairs_per_tile;
        for (int t = 0; t < kTaps; ++t) {
          const int r = t / 3, dx = t - 3 * r;
          mbar_wait(&empty[s], ph ^ 1);
          mbar_expect_tx(&full[s], kATile);
          // Input row 2m - 1 + r: parity (r + 1) % 2 of pair m + floor((r - 1) / 2).
          tma_load(ring + s * kATile, &map_x, &full[s], 0, dx - 1, (r + 1) & 1,
                   m0 + ((r + 1) >> 1) - 1, b);
          if (++s == kStages) s = 0, ph ^= 1;
        }
      }
    }
    return;
  }

  const int cw = wg - 1;  // consumer: the tile's rows 64 cw ... 64 cw + 63
  const int t128 = tid % 128;
  // Accumulator layout of wgmma m64nN: thread (warp w, lane l) holds rows 16 w
  // + l / 4 (+ 8 h) and columns 8 c + 2 (l % 4) (+ j) at sum[4 c + 2 h + j].
  const int row = 64 * cw + (t128 / 32) * 16 + (t128 % 32) / 4;
  const int col = 2 * (t128 % 4);
  const int pairs = H / 2;
  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  mbar_wait(&wfull, 0);
  int s = 0;
  uint32_t ph = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_image;
    const int m0 = (tile - b * tiles_per_image) * pairs_per_tile;
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.f;
    for (int t = 0; t < kTaps; ++t) {
      mbar_wait(&full[s], ph);
      const uint8_t* a = ring + s * kATile + cw * (kATile / 2);
      const uint8_t* wt = wsm + t * kWTap;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kC / 16; ++kk)
        wgmma_m64n128k16<0, 1>(acc, desc(a + kk * 32, 16), desc(wt + kk * 16 * 128, kWBox), kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc);
      if (tid % 32 == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] += acc[i];
      if (++s == kStages) s = 0, ph ^= 1;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = row + 8 * h;
      const int p = rr / W, w = rr - p * W;
      const int m = m0 + p;
      if (m >= pairs) continue;
      bf16* even = out + ((static_cast<int64_t>(b) * H + 2 * m) * W + w) * kC;
      bf16* odd = even + static_cast<int64_t>(W) * kC;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        bf16* dst = (c < 8 ? even : odd) + ((8 * c + col) & (kC - 1));
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(sum[4 * c + 2 * h], sum[4 * c + 2 * h + 1]);
      }
    }
  }
}

// A bf16 tensor map of rank dims (dims[0] contiguous, packed), read in boxes
// of box[], 128-byte swizzled; coordinates outside the tensor read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int rank, const int64_t* dims, const int* box) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  cuuint64_t d[5], strides[4];
  cuuint32_t b[5], unit[5] = {1, 1, 1, 1, 1};
  int64_t pitch = 2;
  for (int i = 0; i < rank; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    b[i] = static_cast<cuuint32_t>(box[i]);
    if (i) strides[i - 1] = static_cast<cuuint64_t>(pitch);
    pitch *= dims[i];
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), d, strides, b,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// out [B, H, W, C] bf16 (contiguous NHWC) = the packed product of x [B, H, W,
// C] bf16 (contiguous NHWC) with w_packed [12C, 2C] bf16 (contiguous), C =
// 64, H even, W in {8, 16, 32, 64, 128}; x and w_packed 16-byte aligned, out
// 4-byte aligned. At most grid_limit blocks (the caller passes the SM count).
extern "C" int conv3x3_fwd_hpair(const void* x, const void* w_packed, void* out, int64_t B,
                                 int64_t H, int64_t W, int64_t C, int64_t grid_limit,
                                 void* stream) {
  if (B <= 0) return 0;
  if (C != kC || H < 2 || H % 2 || (W != 8 && W != 16 && W != 32 && W != 64 && W != 128) ||
      grid_limit < 1 || B * H >= (1LL << 31) || misaligned(x) || misaligned(w_packed) ||
      reinterpret_cast<uintptr_t>(out) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t pairs_per_tile = kRows / W;
  const int64_t tiles_per_image = (H / 2 + pairs_per_tile - 1) / pairs_per_tile;
  const int64_t tiles = B * tiles_per_image;
  if (tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mw;
  const int64_t dims_x[5] = {kC, W, 2, H / 2, B}, dims_w[3] = {2 * kC, kTaps * kC, 1};
  const int box_x[5] = {kC, static_cast<int>(W), 1, static_cast<int>(pairs_per_tile), 1};
  const int box_w[3] = {kC, kC, 1};
  if (!make_map(&mx, x, 5, dims_x, box_x) || !make_map(&mw, w_packed, 3, dims_w, box_w))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(conv_fwd_hpair_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(tiles < grid_limit ? tiles : grid_limit);
  conv_fwd_hpair_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      mx, mw, static_cast<bf16*>(out), static_cast<int>(H), static_cast<int>(W),
      static_cast<int>(pairs_per_tile), static_cast<int>(tiles_per_image),
      static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}
