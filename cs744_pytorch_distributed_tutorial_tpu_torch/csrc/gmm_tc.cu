// Grouped matrix products of dropless MoE's expert FFN on Hopper's tensor
// cores (wgmma on bf16 tiles that TMA brings into shared memory):
//
//   split    fp32 x [n] -> three bf16 pieces [3, n]: h1 = bf16(x),
//            h2 = bf16(x - h1), h3 = bf16(x - h1 - h2), each rounded to
//            nearest from the running remainder;
//   gmm_tc   out[r] = sum_p a_p[r] @ rhs[g(r)] in fp32, a [P, M, K] bf16 (the
//            P pieces of dout, or one bf16 lhs), rhs read as [E, N, K]
//            (K-major: the backward's dlhs = dout @ rhs^T, rhs [E, K', N']
//            read in place) or as stored, [E, K, N] (grouped_matmul's bf16
//            forward, one piece);
//   tgmm_tc  out[e] = sum over the rows r of group e of lhs[r]^T (x)
//            sum_p b_p[r], [E, K, N] fp32, lhs [M, K] bf16, b [P, M, N] bf16
//            (the backward's drhs);
//   gmm_fused_tc  out[r] = act(lhs[r] @ rhs[g(r)] + bias[g(r)]) in bf16 or
//            fp32, and optionally z[r] = lhs[r] @ rhs[g(r)] + bias[g(r)] (the
//            pre-activation, for the backward's gelu'), lhs [M, K] and rhs
//            [E, K, N] bf16 (grouped_matmul_fused's forward).
//
// Replaces the TPU kernels of cs744_pytorch_distributed_tutorial_tpu/ops/gmm.py
// _gmm_kernel (dlhs, and grouped_matmul's forward) and _tgmm_kernel (drhs), as
// _gmm_bwd_core calls them, and _gmm_fused_kernel (with and without its with_z
// output), where csrc/gmm.cu's FFMA kernels ran before. Rows belong to groups
// as there: group e holds rows [start_e, end_e) of the contiguous layout, rows
// from sum(group_sizes) to M belong to the last group, and the offsets are
// read from group_sizes on the device (no launch synchronises with the host).
//
// Why the products are exact. The JAX backward multiplies an fp32 dout by a
// bf16 operand widened to fp32 (rhs for dlhs, lhs for drhs). An fp32 x is
// exactly h1 + h2 + h3: h1 takes x's top 8 significant bits by
// round-to-nearest, x - h1 is exact in fp32 and needs at most 16 bits, h2
// takes 8 of them and leaves at most 8, which h3 holds exactly (a value whose
// bits fall below bf16's subnormals is the exception; such gradients vanish
// in every product). A bf16 x bf16 product has at most 16 significant bits,
// so each piece's product with the other operand is exact in fp32, and three
// bf16 wgmma passes into one fp32 sum add exactly the products the FFMA kernel
// adds: only the order of the sums differs. A dout that arrives in bf16 (no
// activation: w_out's gradient) is its own single piece. An infinite x splits
// into (inf, NaN, NaN), so such a row gives NaN where FFMA gives inf.
//
// The route rules (ops/gmm.py, functions of dtypes and shapes): tc_pieces
// gives gmm_tc and tgmm_tc a call when the operand that is not dout is bf16
// and every row TMA reads is a multiple of 16 bytes (K and N multiples of 8)
// from 16-byte-aligned base pointers; dout then takes 1 piece if it is bf16
// and 3 if fp32. fused_tc_route gives gmm_fused_tc a forward with bf16 lhs and
// rhs under the same row rule and at least FUSED_TC_MIN_ROWS rows. Anything
// else (fp32 operands, odd widths, the forward below its row threshold) takes
// gmm.cu's FFMA kernels, unchanged.
//
// Layout of a block (384 threads, one block an SM): warpgroup 0 is the
// producer, one thread of which issues every TMA load into a ring of stages
// in shared memory, each completed on a full mbarrier and released on an
// empty one; warpgroups 1 and 2 are consumers, each issuing wgmma.m64n128k16
// (bf16 in, fp32 accumulate) on 64 rows of a 128 x 128 output tile. A stage
// holds 64 of the contraction: each operand comes in boxes of 64 bf16 wide
// (one 128-byte row, 128-byte swizzle, read by wgmma descriptors of the same
// swizzle), and the ring fills 192 KB (6 stages for one piece, 3 for three).
//
// - gmm_tc and gmm_fused_tc (one mainloop): a block owns a 128 x 128 output
//   tile. It visits every group that overlaps its rows, in order (listed in
//   shared memory by the block's first warp from group_sizes in device
//   memory, 32 sizes a step: groups.cuh; any number of groups), each visit
//   a full pass over K with that group's rhs[e] into a fresh sum, and stores
//   only that group's rows: each row is written once, from exactly its own
//   group's products (a tile that straddles b boundaries pays b extra
//   passes; at most E - 1 a call). A and
//   dlhs's B are K-major; the forward's B (rhs as stored) is MN-major, read
//   through the descriptor's transpose bit. gmm_tc stores a visit's fp32 sums;
//   gmm_fused_tc's epilogue adds bias[e] of the visit's group e in fp32,
//   stores z rounded to the output type, applies gelu_tanh (activation.cuh,
//   the FFMA kernel's function) and rounds once: the rounding points of
//   _gmm_fused_kernel. Each row is written once, by its own group's visit.
// - tgmm_tc: a block owns (group e, a 128 x 128 tile of [K, N]) and walks the
//   group's rows in order, 64 a stage; the boxes start at the group's first
//   row (TMA takes any coordinate). Both operands are MN-major (lhs^T and the
//   pieces, read along their rows). In the group's last stage the consumers
//   zero the rows at or past its end in shared memory (then fence.proxy.async
//   before wgmma reads them). A group whose size is not positive writes zeros.
//   The sum runs in one fixed order, so two runs are bitwise equal. One pass,
//   no split of a group's rows: at the MoE path's shapes the grid is 256
//   blocks (about two waves whose length follows the group sizes).
// - Each stage's products (64 of the contraction, times the pieces) go into
//   a fresh wgmma accumulator, which is then added into fp32 sums in
//   registers by ordinary round-to-nearest adds. The tensor cores' own
//   additions inside one long accumulator chain do not round to nearest:
//   left to carry a whole 4,000-row tgmm sum they broke the 1e-5 x
//   max|plain| limit on the card; promoted once a stage they stay inside it.
// - split: one thread converts four values (16-byte loads, 8-byte stores of
//   each piece).
//
// What bounds gmm_fused_tc: bytes at the MoE path's shapes. A prefill layer
// (lhs [4096, 512] against [8, 512, 1024], gelu, then [4096, 1024] against
// [8, 1024, 512]) moves about 42 MB for 8.6 GFLOP (0.0125 ms of bytes); the
// training forward with z (lhs [32768, 512]) reads 34 MB and writes 134 MB
// (0.053 ms of bytes, 0.035 of bf16 operations). At decode (32 routed rows)
// the expert weights are the bytes, and a 128-row tile leaves most of the
// tensor cores' rows empty.
//
// What bounds them, at the MoE training path (M = 32768 routed rows; w_in:
// [32768, 512] against [8, 512, 1024], w_out: [32768, 1024] against [8, 1024,
// 512]; 34.4 GFLOP of products a call): bytes over 3.35 TB/s against 2 M K N
// over the bf16 tensor-core peak (989 TFLOP/s, 0.035 ms). With three pieces
// the passes cost three times that (0.104 ms), above the bytes (about 0.06
// ms); with one piece (w_out) the bytes bound. split reads 4 and writes 6
// bytes an element (335 MB at [32768, 1024]: 0.10 ms).
//
// Left for later work: a persistent grid walking tiles (the epilogue of one
// under the loads of the next), TMA stores of the fused epilogue's out and z
// (staged in shared memory; the register layout writes 16-byte pieces of
// eight rows a warp), a swap-AB decode variant of gmm_fused_tc (the experts'
// columns as wgmma's rows, the few tokens as n8/n16), TMA multicast of rhs
// across a cluster, fusing split into the gelu backward, and splitting tgmm's
// large groups across blocks.
//
// Plain C interface, loaded with ctypes: every launch runs on the caller's
// stream, does not synchronise, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape or pointer these kernels do not take).
// TMA descriptors are encoded on the host per call, from pointers and shapes
// only, through the driver's cuTensorMapEncodeTiled (found with
// cudaGetDriverEntryPoint[ByVersion], so the library links nothing new), and
// passed as __grid_constant__ parameters. The Hopper primitives (mbarriers,
// TMA loads, wgmma) are shared with flash_attention_tc.cu in hopper.cuh.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "activation.cuh"
#include "groups.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 384;             // a producer and two consumer warpgroups
constexpr int kTile = 128;                // output tile rows and columns
constexpr int kChunk = 64;                // contraction a stage: one 128-byte row
constexpr int kBox = kChunk * kChunk * 2;  // a 64 x 64 bf16 box: 8 KB
constexpr int kRing = 192 * 1024;         // shared memory of the ring

// Bytes of a stage with P pieces: gmm_tc's 128 rows of each piece and 128 of
// rhs; tgmm_tc's two 64-column boxes of lhs and of each piece.
__host__ __device__ constexpr int gmm_stage_bytes(int P) { return (P + 1) * kTile * kChunk * 2; }
__host__ __device__ constexpr int tgmm_stage_bytes(int P) { return (1 + P) * 2 * kBox; }

// A consumer's accumulator fragment of wgmma m64nN: thread (warp w, lane l)
// holds rows 16 w + l / 4 (+ 8) and columns 8 c + 2 (l % 4) (+ 1) at
// d[4 c + 2 h + j], h the row half, j the column.
__device__ __forceinline__ void store_tile(const float (&v)[64], float* out, int row0, int col0,
                                           int row_lo, int row_hi, int ncols, int64_t ld) {
  const int t = threadIdx.x % 128;
  const int r = row0 + (t / 32) * 16 + (t % 32) / 4;
  const int c0 = col0 + 2 * (t % 4);
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const int col = c0 + 8 * c;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      if (row >= row_lo && row < row_hi && col < ncols)  // ncols even: col + 1 < ncols
        *reinterpret_cast<float2*>(out + row * ld + col) =
            make_float2(v[4 * c + 2 * h], v[4 * c + 2 * h + 1]);
    }
  }
}

// The mainloop of gmm_tc_kernel and gmm_fused_tc_kernel: the producer
// warpgroup feeds the ring; each consumer warpgroup sums its 64 rows of every
// group visit and hands the sums to store(sum, e, row0, lo, hi), which writes
// the rows [lo, hi) of group e among rows row0 ... row0 + 63, columns n0 ...
// n0 + 127 (n0 = blockIdx.x * kTile).
template <int P, bool kBMN, typename Store>
__device__ __forceinline__ void gmm_tc_mainloop(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                                const int* __restrict__ group_sizes, int M, int K,
                                                int E, Store store) {
  constexpr int kA = kTile * kChunk * 2;  // one piece's 128 rows: 16 KB
  constexpr int kStage = gmm_stage_bytes(P);
  constexpr int kStages = kRing / kStage;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ int visit_e[kTile], visit_lo[kTile], visit_hi[kTile];  // the groups that meet the tile
  __shared__ int visits;
  uint8_t* ring = ring_base(smem_raw);
  const int tid = threadIdx.x, wg = tid / 128;
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  const int row_hi = m0 + kTile < M ? m0 + kTile : M;
  const int nk = (K + kChunk - 1) / kChunk;

  if (tid < 32) {  // the first warp lists the groups that meet the tile's rows
    const int n = groups::list_groups(group_sizes, E, M, m0, row_hi, visit_e, visit_lo,
                                      visit_hi, kTile);
    if (tid == 0) {
      visits = n;
      init_ring<kStages>(full, empty);
    }
  }
  __syncthreads();

  if (wg == 0) {  // producer
    if (tid == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int v = 0; v < visits; ++v) {
        const int e = visit_e[v];
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(&empty[s], ph ^ 1);
          uint8_t* st = ring + s * kStage;
          mbar_expect_tx(&full[s], kStage);
          for (int p = 0; p < P; ++p)
            tma_load(st + p * kA, map_a, &full[s], kc * kChunk, m0, p);
          uint8_t* b = st + P * kA;
          if (kBMN) {  // rhs [E, K, N]: two boxes of 64 columns, 64 rows of K
            tma_load(b, map_b, &full[s], n0, kc * kChunk, e);
            tma_load(b + kBox, map_b, &full[s], n0 + kChunk, kc * kChunk, e);
          } else {  // rhs [E, N, K]: 128 rows of N, 64 of K
            tma_load(b, map_b, &full[s], kc * kChunk, n0, e);
          }
          if (++s == kStages) s = 0, ph ^= 1;
        }
      }
    }
    return;
  }

  const int cw = wg - 1;  // consumer: rows m0 + 64 cw ... + 63
  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.f;
  int s = 0;
  uint32_t ph = 0;
  for (int v = 0; v < visits; ++v) {
    const int e = visit_e[v], lo = visit_lo[v], hi = visit_hi[v];
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.f;
    for (int kc = 0; kc < nk; ++kc) {
      mbar_wait(&full[s], ph);
      const uint8_t* st = ring + s * kStage;
      const uint8_t* b = st + P * kA;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk) {
          const uint64_t da = desc(st + p * kA + cw * (kA / 2) + kk * 32, 16);
          const uint64_t db = kBMN ? desc(b + kk * 16 * 128, kBox) : desc(b + kk * 32, 16);
          wgmma_m64n128k16<0, kBMN ? 1 : 0>(acc, da, db, p | kk);
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
    store(sum, e, m0 + 64 * cw, lo, hi);
  }
}

template <int P, bool kBMN>
__global__ void __launch_bounds__(kThreads, 1)
gmm_tc_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
              const int* __restrict__ group_sizes, float* __restrict__ out, int M, int K, int N,
              int E) {
  gmm_tc_mainloop<P, kBMN>(&map_a, &map_b, group_sizes, M, K, E,
                           [&](const float (&v)[64], int, int row0, int lo, int hi) {
                             store_tile(v, out, row0, blockIdx.x * kTile, lo, hi, N, N);
                           });
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// grouped_matmul_fused's forward: out = act(lhs @ rhs[e] + bias[e]) with lhs
// [M, K] bf16 (K-major) and rhs [E, K, N] bf16 as stored (MN-major), the
// epilogue in fp32 on the promoted sums of each group visit: add the row's
// own group's bias (each visit stores only its group's rows, so a tile that
// straddles a boundary adds each group's bias to its own rows), store the
// pre-activation z rounded to the output type (kZ), apply gelu_tanh (kGelu),
// round once to the output type (kOutBf16: bf16, else fp32). The rounding
// points of _gmm_fused_kernel and of grouped_matmul_fused_plain.
template <int kOutBf16, bool kGelu, bool kZ>
__global__ void __launch_bounds__(kThreads, 1)
gmm_fused_tc_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b, const float* __restrict__ bias,
                    const int* __restrict__ group_sizes, void* __restrict__ out_raw,
                    void* __restrict__ z_raw, int M, int K, int N, int E) {
  using Out = typename std::conditional<kOutBf16 != 0, bf16, float>::type;
  Out* out = static_cast<Out*>(out_raw);
  Out* z = static_cast<Out*>(z_raw);
  gmm_tc_mainloop<1, true>(
      &map_a, &map_b, group_sizes, M, K, E,
      [&](const float (&v)[64], int e, int row0, int lo, int hi) {
        // The accumulator layout of store_tile: rows r, r + 8; column pairs.
        const int t = threadIdx.x % 128;
        const int r = row0 + (t / 32) * 16 + (t % 32) / 4;
        const int c0 = blockIdx.x * kTile + 2 * (t % 4);
        const float* brow = bias + static_cast<int64_t>(e) * N;
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const int col = c0 + 8 * c;
          if (col >= N) continue;  // N even: col + 1 < N
          const float b0 = brow[col], b1 = brow[col + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r + 8 * h;
            if (row < lo || row >= hi) continue;
            float a0 = v[4 * c + 2 * h] + b0, a1 = v[4 * c + 2 * h + 1] + b1;
            const int64_t off = static_cast<int64_t>(row) * N + col;
            if (kZ) store2(z + off, a0, a1);
            if (kGelu) a0 = gelu_tanh(a0), a1 = gelu_tanh(a1);
            store2(out + off, a0, a1);
          }
        }
      });
}

template <int P>
__global__ void __launch_bounds__(kThreads, 1)
tgmm_tc_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
               const int* __restrict__ group_sizes, float* __restrict__ out, int M, int K, int N,
               int E) {
  constexpr int kStage = tgmm_stage_bytes(P);
  constexpr int kStages = kRing / kStage;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  uint8_t* ring = ring_base(smem_raw);
  const int tid = threadIdx.x, wg = tid / 128;
  const int n0 = blockIdx.x * kTile, k0 = blockIdx.y * kTile, e = blockIdx.z;
  float* o = out + static_cast<int64_t>(e) * K * N;

  int64_t acc0 = 0;
  for (int j = 0; j < e; ++j) acc0 += group_sizes[j];
  const int start = static_cast<int>(acc0 < M ? acc0 : M);
  const int64_t hi0 = acc0 + group_sizes[e];
  int end = e == E - 1 ? M : static_cast<int>(hi0 < M ? hi0 : M);
  if (group_sizes[e] <= 0) end = start;  // an empty group's gradient is zero
  if (end <= start) {
    for (int i = tid; i < kTile * kTile; i += kThreads) {
      const int k = k0 + i / kTile, n = n0 + i % kTile;
      if (k < K && n < N) o[static_cast<int64_t>(k) * N + n] = 0.f;
    }
    return;
  }
  if (tid == 0) init_ring<kStages>(full, empty);
  __syncthreads();
  const int nc = (end - start + kChunk - 1) / kChunk;

  if (wg == 0) {  // producer
    if (tid == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int c = 0; c < nc; ++c) {
        const int r0 = start + c * kChunk;
        mbar_wait(&empty[s], ph ^ 1);
        uint8_t* st = ring + s * kStage;
        mbar_expect_tx(&full[s], kStage);
        tma_load(st, &map_a, &full[s], k0, r0, 0);
        tma_load(st + kBox, &map_a, &full[s], k0 + kChunk, r0, 0);
        for (int p = 0; p < P; ++p) {
          uint8_t* b = st + 2 * kBox + p * 2 * kBox;
          tma_load(b, &map_b, &full[s], n0, r0, p);
          tma_load(b + kBox, &map_b, &full[s], n0 + kChunk, r0, p);
        }
        if (++s == kStages) s = 0, ph ^= 1;
      }
    }
    return;
  }

  const int cw = wg - 1;  // consumer: rows k0 + 64 cw ... + 63 of dW
  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.f;
  int s = 0;
  uint32_t ph = 0;
  for (int c = 0; c < nc; ++c) {
    mbar_wait(&full[s], ph);
    uint8_t* st = ring + s * kStage;
    const int valid = min(kChunk, end - (start + c * kChunk));
    if (valid < kChunk) {
      // The group's last stage: zero the rows at or past its end (each row
      // of a box is 128 bytes, whatever the swizzle) in every box.
      const int row_vecs = (kChunk - valid) * 128 / 16;
      for (int i = tid - 128; i < (2 + 2 * P) * row_vecs; i += 256) {
        const int box = i / row_vecs, v = i % row_vecs;
        *reinterpret_cast<uint4*>(st + box * kBox + valid * 128 + v * 16) = make_uint4(0, 0, 0, 0);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync 1, 256;" ::: "memory");
    }
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        const uint64_t da = desc(st + cw * kBox + kk * 16 * 128, kBox);
        const uint64_t db = desc(st + 2 * kBox + p * 2 * kBox + kk * 16 * 128, kBox);
        wgmma_m64n128k16<1, 1>(acc, da, db, p | kk);
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
  store_tile(sum, o, k0 + 64 * cw, n0, 0, K, N, N);
}

__device__ __forceinline__ void split1(float x, bf16* h1, bf16* h2, bf16* h3) {
  *h1 = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(*h1);
  *h2 = __float2bfloat16_rn(r);
  *h3 = __float2bfloat16_rn(r - __bfloat162float(*h2));
}

// out[p * n + i] = piece p of x[i]; kVec: four values a thread, x 16-byte and
// the pieces 8-byte aligned.
template <bool kVec>
__global__ void __launch_bounds__(256) split_kernel(const float* __restrict__ x,
                                                    bf16* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (kVec) {
    for (; i < n / 4; i += stride) {
      const float4 v = reinterpret_cast<const float4*>(x)[i];
      alignas(8) bf16 h[3][4];
      split1(v.x, &h[0][0], &h[1][0], &h[2][0]);
      split1(v.y, &h[0][1], &h[1][1], &h[2][1]);
      split1(v.z, &h[0][2], &h[1][2], &h[2][2]);
      split1(v.w, &h[0][3], &h[1][3], &h[2][3]);
#pragma unroll
      for (int p = 0; p < 3; ++p)
        *reinterpret_cast<uint2*>(out + p * n + 4 * i) = *reinterpret_cast<const uint2*>(h[p]);
    }
  } else {
    for (; i < n; i += stride) split1(x[i], out + i, out + n + i, out + 2 * n + i);
  }
}

// A map of the bf16 tensor [d2, d1, d0] (d0 contiguous, packed) read in
// boxes of [1, box1, box0], 128-byte swizzled; out-of-range rows and
// columns read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int64_t d0, int64_t d1, int64_t d2, int box0,
              int box1) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0), static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d0 * 2),
                                 static_cast<cuuint64_t>(d0 * d1 * 2)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box0), static_cast<cuuint32_t>(box1), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int stage_bytes, dim3 grid, cudaStream_t stream,
                   Args... args) {
  const int smem = (kRing / stage_bytes) * stage_bytes + kSwizzleBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

constexpr int64_t kMaxRows = (1LL << 31) - kTile;
constexpr int64_t kSplitBlocks = 132 * 16;  // 16 blocks an SM, grid-stride

}  // namespace

// out [M, N] fp32 = sum_p a[p] @ rhs[g] with a [P, M, K] bf16 (P = pieces, 1
// or 3), rhs bf16 [E, N, K] read transposed (rhs_mn_major 0: the backward's
// dlhs) or [E, K, N] as stored (1: the forward), group_sizes int32 [E]; K
// and N multiples of 8, a and rhs 16-byte aligned, all contiguous.
extern "C" int gmm_tc(const void* a, const void* rhs, const void* group_sizes, void* out,
                      int64_t M, int64_t K, int64_t N, int64_t E, int64_t pieces,
                      int64_t rhs_mn_major, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (E < 1 || K <= 0 || K % 8 || N % 8 || M > kMaxRows || N > kMaxRows ||
      K > kMaxRows || (pieces != 1 && pieces != 3) || (rhs_mn_major && pieces != 1) ||
      (M + kTile - 1) / kTile > 65535 || misaligned(a) || misaligned(rhs))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma, mb;
  const bool ok = make_map(&ma, a, K, M, pieces, kChunk, kTile) &&
                  (rhs_mn_major ? make_map(&mb, rhs, N, K, E, kChunk, kChunk)
                                : make_map(&mb, rhs, K, N, E, kChunk, kTile));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((N + kTile - 1) / kTile),
                  static_cast<unsigned>((M + kTile - 1) / kTile));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  float* o = static_cast<float*>(out);
  const int m = static_cast<int>(M), k = static_cast<int>(K), n = static_cast<int>(N),
            e = static_cast<int>(E);
  cudaError_t err;
  if (rhs_mn_major)
    err = launch(gmm_tc_kernel<1, true>, gmm_stage_bytes(1), grid, s, ma, mb, gs, o, m, k, n, e);
  else if (pieces == 1)
    err = launch(gmm_tc_kernel<1, false>, gmm_stage_bytes(1), grid, s, ma, mb, gs, o, m, k, n, e);
  else
    err = launch(gmm_tc_kernel<3, false>, gmm_stage_bytes(3), grid, s, ma, mb, gs, o, m, k, n, e);
  return static_cast<int>(err);
}

// out [M, N] (bf16 if out_bf16, else fp32) = act(lhs [M, K] @ rhs[g] [K, N] +
// bias[g]) with lhs and rhs bf16, bias fp32 [E, N], group_sizes int32 [E];
// gelu != 0 applies the tanh gelu; z, if not null, receives the
// pre-activation in out's type (gelu only). K and N multiples of 8, lhs and
// rhs 16-byte aligned, all contiguous.
extern "C" int gmm_fused_tc(const void* lhs, const void* rhs, const void* bias,
                            const void* group_sizes, void* out, void* z, int64_t M, int64_t K,
                            int64_t N, int64_t E, int64_t gelu, int64_t out_bf16, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (E < 1 || K <= 0 || K % 8 || N % 8 || M > kMaxRows || N > kMaxRows ||
      K > kMaxRows || (M + kTile - 1) / kTile > 65535 || (z && !gelu) || misaligned(lhs) ||
      misaligned(rhs))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma, mb;
  if (!make_map(&ma, lhs, K, M, 1, kChunk, kTile) || !make_map(&mb, rhs, N, K, E, kChunk, kChunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((N + kTile - 1) / kTile),
                  static_cast<unsigned>((M + kTile - 1) / kTile));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const int* gs = static_cast<const int*>(group_sizes);
  const int m = static_cast<int>(M), k = static_cast<int>(K), n = static_cast<int>(N),
            e = static_cast<int>(E);
  const int sb = gmm_stage_bytes(1);
  cudaError_t err;
#define GMM_FUSED_TC(OUT, GELU, Z) \
  launch(gmm_fused_tc_kernel<OUT, GELU, Z>, sb, grid, s, ma, mb, b, gs, out, z, m, k, n, e)
  if (out_bf16)
    err = z ? GMM_FUSED_TC(1, true, true) : gelu ? GMM_FUSED_TC(1, true, false)
                                                 : GMM_FUSED_TC(1, false, false);
  else
    err = z ? GMM_FUSED_TC(0, true, true) : gelu ? GMM_FUSED_TC(0, true, false)
                                                 : GMM_FUSED_TC(0, false, false);
#undef GMM_FUSED_TC
  return static_cast<int>(err);
}

// out [E, K, N] fp32: per group, lhs[rows]^T @ sum_p b[p][rows] with lhs [M,
// K] bf16 and b [P, M, N] bf16 (P = pieces, 1 or 3); zero for a group whose
// size is not positive. K and N multiples of 8, lhs and b 16-byte aligned.
extern "C" int tgmm_tc(const void* lhs, const void* b, const void* group_sizes, void* out,
                       int64_t M, int64_t K, int64_t N, int64_t E, int64_t pieces, void* stream) {
  if (K <= 0 || N <= 0) return 0;
  if (E < 1 || M <= 0 || K % 8 || N % 8 || M > kMaxRows || N > kMaxRows ||
      (K + kTile - 1) / kTile > 65535 || (pieces != 1 && pieces != 3) || misaligned(lhs) ||
      misaligned(b))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma, mb;
  if (!make_map(&ma, lhs, K, M, 1, kChunk, kChunk) ||
      !make_map(&mb, b, N, M, pieces, kChunk, kChunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((N + kTile - 1) / kTile),
                  static_cast<unsigned>((K + kTile - 1) / kTile), static_cast<unsigned>(E));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  float* o = static_cast<float*>(out);
  const int m = static_cast<int>(M), k = static_cast<int>(K), n = static_cast<int>(N),
            e = static_cast<int>(E);
  const cudaError_t err =
      pieces == 1
          ? launch(tgmm_tc_kernel<1>, tgmm_stage_bytes(1), grid, s, ma, mb, gs, o, m, k, n, e)
          : launch(tgmm_tc_kernel<3>, tgmm_stage_bytes(3), grid, s, ma, mb, gs, o, m, k, n, e);
  return static_cast<int>(err);
}

// out [3, n] bf16: the three pieces of x [n] fp32 (contiguous).
extern "C" int split_bf16(const void* x, void* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  const float* xf = static_cast<const float*>(x);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0 && !misaligned(x) && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  const int64_t blocks = (vec ? n / 4 : n) / 256 + 1;
  const unsigned grid = static_cast<unsigned>(blocks < kSplitBlocks ? blocks : kSplitBlocks);
  if (vec)
    split_kernel<true><<<grid, 256, 0, s>>>(xf, o, n);
  else
    split_kernel<false><<<grid, 256, 0, s>>>(xf, o, n);
  return static_cast<int>(cudaGetLastError());
}
