// Weight gradient of a 3x3 SAME convolution (NCHW, no bias), stride 1 or 2, on
// Hopper's tensor cores (wgmma on bf16 tiles that TMA brings into shared
// memory):
//
//     dW^T[K, 9C] = G^T[K, M] . im2col[M, 9C],   M = B * Ho * Wo,
//     im2col[(b, y, x), (tap, c)] = X[b, c, s*y + ky - p, s*x + kx - p]
//
// with p = 1 at stride 1 and p = 0 at stride 2 (flax SAME on even H, W pads
// (0, 1)), zero where the input row or column falls outside the image.
//
// Replaces the TPU kernels cs744_pytorch_distributed_tutorial_tpu/ops/fused_conv.py
// _wgrad_kernel_s1 and _wgrad_kernel_s2 on the route ops/fused_conv.py::tc_route
// gives it (fp32 or bf16 x and g whose output rows Wo are a multiple of 8,
// 16-byte-aligned pointers); fused_conv.cu's FFMA kernel keeps the rest (such
// as 6 x 6 images and 4 x 4 outputs).
//
// The layout. In NCHW both operands are K-major in wgmma's sense: the
// reduction over (y, x) is contiguous for a fixed (b, k) of g and a fixed
// (b, c) of x. The reduction runs in chunks of 64 positions of one image's
// output plane (a 128-byte row of bf16; the last chunk of a plane that is
// not a multiple of 64 reads g's zeros past it). A block owns one tap (ky,
// kx), 128 output channels k and 128 input channels c. Its A tile is g [128
// k][64 positions], read in place for bf16. Its B tile comes from a pre-pass
// that writes x as planes [Ho + 1][Wo] of the output grid, one for each kx
// (and each row parity ky % 2 at stride 2): plane (py, kx)[1 + y][x] =
// x[s y + py, s x + kx - p], zero where that column lies outside the image,
// and row 0 zeros. Tap (ky, kx) then reads its plane at rows y + 1 + sy (sy
// = ky - 1 at stride 1, ky / 2 at stride 2): a TMA box of the flattened plane
// starting at j0 + (1 + sy) Wo, a whole number of rows. The zero row above,
// and TMA's zero fill past the plane's end, are the SAME padding above and
// below the image; the planes' own zeros are the padding left and right. So
// every box starts at a multiple of 8 elements: TMA faults on a box whose
// innermost start is not on 16 bytes (a column shift of one element read in
// place did). No im2col is ever written; stride 2 is the same kernel over
// x's parity planes (the de-interleaved planes the JAX kernel reads).
//
// Precision. fp32 x and g go through error-compensated products: the
// pre-passes write each as two bf16 pieces, v = h + l with h = bf16(v) and l
// = bf16(v - h) (both rounded to nearest), and the tensor cores sum h_x h_g +
// h_x l_g + l_x h_g in fp32. The dropped l_x l_g and the pieces' rounding
// leave about 2^-16 of each product, a few 1e-6 of max|dW| on random data,
// against chip_smoke.py's limit of 1e-4 x max|plain|. bf16 inputs are one
// exact piece each (one product; g read in place). Each stage's
// products go into a fresh wgmma accumulator that is then added into fp32
// sums in registers by round-to-nearest adds (the tensor cores' own additions
// in a long chain do not round to nearest; gmm_tc.cu's note).
//
// Parallelism. The output is small ([128, 1152] or [256, 2304] at ResNet-18's
// shapes: 9-36 tiles of 128 x 128), so the chunks of M are split over
// gridDim.z into S slices that fill the SMs once; each block writes its fp32
// partial to a workspace [S, 9, K, C] (coalesced rows of c), and a second
// kernel sums the slices in order and writes dW [K, C, 3, 3] (the tap's
// stride of 9). No atomics: two runs give the same bits.
//
// Layout of a block (384 threads, one block an SM): warpgroup 0 is the
// producer, one thread of which issues every TMA load into a ring of stages
// (192 KB: 3 stages of the fp32 route's four 16 KB boxes, 6 of bf16's two);
// warpgroups 1 and 2 are consumers, each issuing wgmma.m64n128k16 on 64 of
// the block's 128 output channels.
//
// What bounds it: at ResNet-18's routed shapes (x [256, 128, 16, 16] -> 128
// and x [256, 256, 8, 8] -> 256) a call is 19.33 GFLOP on about 68 MB of fp32
// inputs; the fp32 route's three bf16 passes take 0.059 ms at the bf16 peak
// (989 TFLOP/s), the pre-passes move about 210 MB more (the planes: 3 column
// shifts x 2 pieces x 17/16 rows of x; g's pieces; 0.06 ms), and each block
// reads its A and B tiles from L2 for its one tap, so L2 bandwidth, not the
// tensor cores, sets the pace.
//
// Left for later work: a block owning several taps (one A tile for all of
// them), a persistent grid, cutting the pieces and the column shifts in
// shared memory instead of the pre-passes, and TMA stores.
//
// Plain C interface, loaded with ctypes: every launch runs on the caller's
// stream, does not synchronise, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape or pointer it does not take). The caller
// allocates the pieces and the workspace; TMA descriptors are encoded on the
// host per call (hopper.cuh's encode_tiled).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 384;              // a producer and two consumer warpgroups
constexpr int kTile = 128;                 // output channels k and input channels c a block
constexpr int kChunk = 64;                 // positions a stage: one 128-byte row
constexpr int kBox = kTile * kChunk * 2;   // a 128 x 64 bf16 box: 16 KB
constexpr int kRing = 192 * 1024;          // shared memory of the ring
constexpr int64_t kPrepBlocks = 132 * 16;  // 16 blocks an SM, grid-stride

// A stage with P pieces: P boxes of g (A) and P of x (B).
__host__ __device__ constexpr int stage_bytes(int P) { return 2 * P * kBox; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// The P bf16 pieces of eight values v to dst + o and dst + n + o (16-byte
// stores): piece 0 is bf16(v), piece 1 (P == 2) bf16(v - piece 0).
template <int P>
__device__ __forceinline__ void put_pieces8(bf16* dst, int64_t n, int64_t o, const float (&v)[8]) {
  alignas(16) bf16 hi[8], lo[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    hi[i] = __float2bfloat16_rn(v[i]);
    lo[i] = __float2bfloat16_rn(v[i] - __bfloat162float(hi[i]));
  }
  *reinterpret_cast<uint4*>(dst + o) = *reinterpret_cast<const uint4*>(hi);
  if (P == 2) *reinterpret_cast<uint4*>(dst + n + o) = *reinterpret_cast<const uint4*>(lo);
}

// g [n] -> its P bf16 pieces [P][n], eight values a thread (n % 8 == 0,
// src and dst 16-byte aligned).
template <int P>
__global__ void __launch_bounds__(256)
wgrad_split_kernel(const float* __restrict__ src, bf16* __restrict__ dst, int64_t n) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n / 8;
       i += step) {
    const float4 a = reinterpret_cast<const float4*>(src)[2 * i];
    const float4 b = reinterpret_cast<const float4*>(src)[2 * i + 1];
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    put_pieces8<P>(dst, n, 8 * i, v);
  }
}

// x [B, C, H, W] -> the P bf16 pieces of its tap planes [P][B][planes][C][(Ho
// + 1) * Wo] (n elements a piece): plane (py, kx) (index 3 py + kx; py = 0
// at stride 1), row 1 + y, column x holds x[s y + py, s x + kx - (s == 1)],
// zero outside the image; row 0 is zeros. A thread writes eight neighbouring
// columns of one row (Wo % 8 == 0), 16 bytes a piece.
template <typename T, int kStride, int P>
__global__ void __launch_bounds__(256)
wgrad_planes_kernel(const T* __restrict__ src, bf16* __restrict__ dst, int64_t n, int C, int H,
                    int W) {
  constexpr int kPlanes = kStride == 1 ? 3 : 6, kPad = kStride == 1 ? 1 : 0;
  const int Wo = W / kStride, len = (H / kStride + 1) * Wo;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n / 8;
       i += step) {
    const int64_t o = 8 * i;
    const int64_t plane_c = o / len;  // (b, u, c)
    const int pos = static_cast<int>(o - plane_c * len);
    const int64_t bu = plane_c / C;
    const int c = static_cast<int>(plane_c - bu * C);
    const int64_t b = bu / kPlanes;
    const int u = static_cast<int>(bu - b * kPlanes), py = u / 3, kx = u - 3 * (u / 3);
    const int y = pos / Wo - 1, x0 = pos - (pos / Wo) * Wo;
    const int h = kStride * y + py;
    const bool row_ok = y >= 0 && h < H;
    const T* row = src + ((b * C + c) * H + (row_ok ? h : 0)) * static_cast<int64_t>(W);
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int w = kStride * (x0 + j) + kx - kPad;
      v[j] = row_ok && w >= 0 && w < W ? to_f32(row[w]) : 0.f;
    }
    put_pieces8<P>(dst, n, o, v);
  }
}

// Block (c tile, tap + 9 * k tile, slice): the slice's chunks of g pieces
// [P*B][K][HoWo] against the tap planes [P*B*planes][C][(Ho+1)*Wo] (both 3-D
// maps), into work[slice][tap][K][C].
template <int P>
__global__ void __launch_bounds__(kThreads, 1)
wgrad_tc_kernel(const __grid_constant__ CUtensorMap map_g,
                const __grid_constant__ CUtensorMap map_x, float* __restrict__ work, int B,
                int C, int K, int Wo, int HoWo, int stride, int chunks_per_split) {
  const int planes = stride == 1 ? 3 : 6;
  constexpr int kStage = stage_bytes(P);
  constexpr int kStages = kRing / kStage;
  constexpr int kProducts = P == 1 ? 1 : 3;  // h h, h_g l_x, l_g h_x
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  uint8_t* ring = ring_base(smem_raw);
  const int tid = threadIdx.x, wg = tid / 128;
  const int c0 = blockIdx.x * kTile;
  const int tap = blockIdx.y % 9, k0 = (blockIdx.y / 9) * kTile;
  const int ky = tap / 3, kx = tap % 3;
  // The tap's plane (py, kx) and its first row: 1 + the row shift.
  const int plane = stride == 1 ? kx : (ky & 1) * 3 + kx;
  const int shift = (1 + (stride == 1 ? ky - 1 : ky >> 1)) * Wo;
  const int nch = (HoWo + kChunk - 1) / kChunk;  // chunks an image
  const int q0 = blockIdx.z * chunks_per_split;
  const int q1 = min(B * nch, q0 + chunks_per_split);

  if (tid == 0) init_ring<kStages>(full, empty);
  __syncthreads();

  if (wg == 0) {  // producer
    if (tid == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int q = q0; q < q1; ++q) {
        const int b = q / nch, j0 = (q - b * nch) * kChunk;
        mbar_wait(&empty[s], ph ^ 1);
        uint8_t* st = ring + s * kStage;
        mbar_expect_tx(&full[s], kStage);
        for (int p = 0; p < P; ++p) {
          tma_load(st + p * kBox, &map_g, &full[s], j0, k0, p * B + b);
          tma_load(st + (P + p) * kBox, &map_x, &full[s], j0 + shift, c0,
                   (p * B + b) * planes + plane);
        }
        if (++s == kStages) s = 0, ph ^= 1;
      }
    }
    return;
  }

  const int cw = wg - 1;  // consumer: output channels k0 + 64 cw ... + 63
  const int t = tid % 128;
  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.f;
  int s = 0;
  uint32_t ph = 0;
  for (int q = q0; q < q1; ++q) {
    mbar_wait(&full[s], ph);
    const uint8_t* st = ring + s * kStage;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int pr = 0; pr < kProducts; ++pr) {
      const int pa = pr == 2 ? 1 : 0, pb = pr == 1 ? 1 : 0;
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        const uint64_t da = desc(st + pa * kBox + cw * (kBox / 2) + kk * 32, 16);
        const uint64_t db = desc(st + (P + pb) * kBox + kk * 32, 16);
        wgmma_m64n128k16<0, 0>(acc, da, db, pr | kk);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc);
    if (tid % 32 == 0) mbar_arrive(&empty[s]);
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] += acc[i];
    if (++s == kStages) s = 0, ph ^= 1;
  }

  // Accumulator layout of wgmma m64nN: thread (warp w, lane l) holds rows
  // 16 w + l / 4 (+ 8) and columns 8 c + 2 (l % 4) (+ 1) at sum[4 c + 2 h + j].
  float* o = work + (static_cast<int64_t>(blockIdx.z) * 9 + tap) * K * C;
  const int r = k0 + 64 * cw + (t / 32) * 16 + (t % 32) / 4;
  const int cb = c0 + 2 * (t % 4);
#pragma unroll
  for (int c = 0; c < 16; ++c) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = r + 8 * h;
      if (k >= K) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = cb + 8 * c + j;
        if (col < C) o[static_cast<int64_t>(k) * C + col] = sum[4 * c + 2 * h + j];
      }
    }
  }
}

// out[k, c, tap] = sum over slices z in order of work[z][tap][k][c].
__global__ void __launch_bounds__(256)
wgrad_tc_sum_kernel(const float* __restrict__ work, float* __restrict__ out, int K, int C,
                    int splits) {
  const int64_t kc = static_cast<int64_t>(K) * C, n = 9 * kc;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += work[z * n + i];
    const int64_t tap = i / kc;
    out[(i - tap * kc) * 9 + tap] = s;
  }
}

// A bf16 tensor map of rank dims (dims[0] contiguous, packed), read in boxes
// of box[], 128-byte swizzled; coordinates outside the tensor read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int rank, const int64_t* dims, const int* box) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  cuuint64_t d[4], strides[3];
  cuuint32_t b[4], unit[4] = {1, 1, 1, 1};
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

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Blocks of 256 threads for n elements, eight a thread.
unsigned prep_blocks(int64_t n) {
  const int64_t blocks = ceil_div(n / 8, 256);
  return static_cast<unsigned>(blocks < kPrepBlocks ? blocks : kPrepBlocks);
}

template <typename T, int kStride, int P>
cudaError_t planes(const void* src, void* dst, int64_t n, int64_t C, int64_t H, int64_t W,
                   cudaStream_t s) {
  wgrad_planes_kernel<T, kStride, P><<<prep_blocks(n), 256, 0, s>>>(
      static_cast<const T*>(src), static_cast<bf16*>(dst), n, static_cast<int>(C),
      static_cast<int>(H), static_cast<int>(W));
  return cudaGetLastError();
}

template <int P>
constexpr int main_smem() {
  return (kRing / stage_bytes(P)) * stage_bytes(P) + kSwizzleBytes;
}

template <int P>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(wgrad_tc_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              main_smem<P>());
}

template <int P>
cudaError_t main_pass(const CUtensorMap& mg, const CUtensorMap& mx, float* work, int64_t B,
                      int64_t C, int64_t K, int64_t Wo, int64_t HoWo, int64_t stride,
                      int64_t splits, cudaStream_t s) {
  constexpr int smem = main_smem<P>();
  const int64_t chunks = B * ceil_div(HoWo, kChunk);
  const dim3 grid(static_cast<unsigned>(ceil_div(C, kTile)),
                  static_cast<unsigned>(9 * ceil_div(K, kTile)), static_cast<unsigned>(splits));
  wgrad_tc_kernel<P><<<grid, kThreads, smem, s>>>(
      mg, mx, work, static_cast<int>(B), static_cast<int>(C), static_cast<int>(K),
      static_cast<int>(Wo), static_cast<int>(HoWo), static_cast<int>(stride),
      static_cast<int>(ceil_div(chunks, splits)));
  return cudaGetLastError();
}

}  // namespace

// How many slices of the chunks of M the tensor-core wgrad splits into: one
// block an SM over the 9 * ceil(K / 128) * ceil(C / 128) output tiles, at
// most one slice a chunk. The caller sizes the workspace from it.
extern "C" int64_t conv3x3_wgrad_tc_splits(int64_t B, int64_t C, int64_t K, int64_t Ho,
                                           int64_t Wo, int64_t num_sms) {
  const int64_t tiles = 9 * ceil_div(C, kTile) * ceil_div(K, kTile);
  const int64_t chunks = B * ceil_div(Ho * Wo, kChunk);
  int64_t s = num_sms / tiles;
  if (s > chunks) s = chunks;
  if (s > 65535) s = 65535;
  return s < 1 ? 1 : s;
}

// dW [K, C, 3, 3] fp32 into `out` from x [B, C, H, W] and g [B, K, H/s, W/s],
// both fp32 (bf16 == 0) or both bf16 (bf16 == 1), contiguous, W/s a multiple
// of 8. Scratch from the caller: work [splits, 9, K, C] fp32; xp [P, B,
// planes, C, (H/s + 1) * W/s] bf16, the tap planes (P = 2 pieces for fp32, 1
// for bf16; planes 3 at stride 1, 6 at stride 2); gp [2, B, K, H/s * W/s]
// bf16 for fp32 (g's pieces), unused for bf16 (g is read in place). g (for
// bf16) and the scratch must be 16-byte aligned.
extern "C" int conv3x3_wgrad_tc(const void* x, const void* g, void* out, void* work, void* xp,
                                void* gp, int64_t B, int64_t C, int64_t H, int64_t W, int64_t K,
                                int64_t stride, int64_t bf16_in, int64_t splits, void* stream) {
  if (B <= 0 || C <= 0 || K <= 0 || H <= 0 || W <= 0) return 0;
  if ((stride != 1 && stride != 2) || H % stride || W % stride)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t Ho = H / stride, Wo = W / stride, HoWo = Ho * Wo;
  const int P = bf16_in ? 1 : 2, nplanes = stride == 1 ? 3 : 6;
  const void* gs = bf16_in ? g : gp;
  const int64_t nx = P * B * nplanes * C * (Ho + 1) * Wo, ng = B * K * HoWo;
  if (Wo % 8 || splits < 1 || splits > 65535 || B * nplanes * P >= (1LL << 31) ||
      nx >= (1LL << 40) || (Ho + 1) * Wo >= (1LL << 31) ||
      B * ceil_div(HoWo, kChunk) >= (1LL << 31) || 9 * ceil_div(K, kTile) > 65535 ||
      ceil_div(C, kTile) > 65535 || misaligned(xp) || misaligned(gs) ||
      (!bf16_in && (misaligned(g) || misaligned(gp))))
    return static_cast<int>(cudaErrorInvalidValue);
  // The host's work first (the tensor maps, the main kernel's shared memory),
  // so the four launches follow one another without a gap on the card.
  CUtensorMap mg, mx;
  const int64_t dims_g[3] = {HoWo, K, P * B}, dims_x[3] = {(Ho + 1) * Wo, C, P * B * nplanes};
  const int box[3] = {kChunk, kTile, 1};
  if (!make_map(&mg, gs, 3, dims_g, box) || !make_map(&mx, xp, 3, dims_x, box))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = P == 1 ? allow_smem<1>() : allow_smem<2>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t nplane = nx / P;  // elements of one piece of the planes
  if (bf16_in)
    err = stride == 1 ? planes<bf16, 1, 1>(x, xp, nplane, C, H, W, s)
                      : planes<bf16, 2, 1>(x, xp, nplane, C, H, W, s);
  else
    err = stride == 1 ? planes<float, 1, 2>(x, xp, nplane, C, H, W, s)
                      : planes<float, 2, 2>(x, xp, nplane, C, H, W, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!bf16_in) {
    wgrad_split_kernel<2><<<prep_blocks(ng), 256, 0, s>>>(static_cast<const float*>(g),
                                                         static_cast<bf16*>(gp), ng);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  float* wk = static_cast<float*>(work);
  err = P == 1 ? main_pass<1>(mg, mx, wk, B, C, K, Wo, HoWo, stride, splits, s)
               : main_pass<2>(mg, mx, wk, B, C, K, Wo, HoWo, stride, splits, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = 9 * K * C;
  const int64_t blocks = ceil_div(n, 256) < 4096 ? ceil_div(n, 256) : 4096;
  wgrad_tc_sum_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      wk, static_cast<float*>(out), static_cast<int>(K), static_cast<int>(C),
      static_cast<int>(splits));
  return static_cast<int>(cudaGetLastError());
}
