// The flash-attention backward on Hopper's tensor cores, for bf16 inputs:
// dq, and dk with dv, on [B, T, H, D] (head_dim 64 or 128), given the
// forward's final lse and delta = rowsum(do * out) ([B*H, T] fp32).
//
// Replaces the TPU kernels of cs744_pytorch_distributed_tutorial_tpu/ops/
// flash_attention.py _dq_kernel (flash_dq) and _dkv_kernel (flash_dkv), where
// csrc/flash_attention.cu's FFMA kernels ran before (they still take fp32
// inputs, head_dim 32 and strides TMA cannot read). Per (batch, head), with
// s = (q . k) * D**-0.5 masked to -1e30 above the diagonal when causal:
//
//   p = exp(s - lse),  ds = p * (do . v - delta)
//   dq = scale * bf16(ds) @ k,  dk = scale * bf16(ds)^T @ q,  dv = bf16(p)^T @ do
//
// The TPU kernels multiply bf16 operands with fp32 sums (preferred_element_type)
// and round p and ds to bf16 before their second product (.astype), so a bf16
// wgmma with fp32 accumulation forms exactly their products: only the order
// of the fp32 sums differs, and with it the bf16 rounding of a p or ds whose
// sum lands near a tie.
//
// What bounds them: at the LM path's shape (B 16, T 1024, H 12, D 64, causal)
// dq does 38.7 and dk/dv 51.6 GFLOP of products against about 100 MB of
// inputs and outputs, some 400 operations a byte: operations at the bf16
// tensor-core peak (989 TFLOP/s: 0.039 and 0.052 ms). The FFMA kernels ran
// them on the FP32 units (67 TFLOP/s) from tiles widened to fp32 in shared
// memory, loaded between two __syncthreads().
//
// The design:
// - A block owns 64 * W rows (W consumer warpgroups of 64 rows: W = 2 at
//   head_dim 64, 1 at 128) and a producer warpgroup: 128 * (1 + W) threads,
//   one block an SM. dq's block owns query rows, and the producer streams K
//   and V tiles of 64 keys; dk/dv's owns key rows, and the producer streams Q
//   and dO tiles of 64 queries with their lse and delta rows. The owned rows
//   (Q and dO, or K and V) are loaded once. One thread issues every TMA load
//   into a ring of 4 stages on full/empty mbarriers; nothing of [T, T] shape
//   reaches device memory.
// - dq, per key tile: S = Q K^T and dP = dO V^T by wgmma m64n64k16 with both
//   operands in shared memory (K-major, 128-byte swizzle); P and dS in the
//   accumulators' registers; dS packed to bf16 in registers, where the
//   accumulator's layout is already wgmma's A-fragment layout, and dQ += dS K
//   by wgmma with A in registers and K read MN-major (the descriptor's
//   transpose bit).
// - dk/dv, per query tile: the transposed scores S^T = K Q^T and dP^T = V
//   dO^T, so that P^T and dS^T are born in registers as A fragments; dV +=
//   bf16(P^T) dO and dK += bf16(dS^T) Q with dO and Q read MN-major. At
//   head_dim 128 the two [64, 128] fp32 accumulators take 128 registers a
//   thread: one consumer warpgroup a block (a 256-thread block may use up to
//   255 registers) rather than spills. At head_dim 64, two consumer
//   warpgroups with the same four accumulators need more than a 384-thread
//   block's 168 registers a thread: the producer warpgroup hands registers
//   over (setmaxnreg: 40 for the producer, 232 for each consumer).
// - Causal: tiles wholly above the diagonal are skipped (by the block, and by
//   a warpgroup whose rows they miss), the diagonal tiles masked. Keys at or
//   past T (which TMA zero-fills, giving s = 0) are masked, as are query rows
//   at or past T, whose lse and delta lie outside [B*H, T] and are not read.
//   Stores of dq, dk and dv are clipped at T.
// - Layout: q, k, v and do are read in place through their (b, t, h) strides
//   by 4-D tensor maps (D, H, T, B) encoded per call; a 64-wide box is one
//   128-byte swizzled row (head_dim 128: two boxes a row). Outputs are
//   written [B, T, H, D] contiguous.
// - Deterministic: dq is owned by its query tile, dk and dv by their key
//   tile; no atomics, one fixed order of the sums, so two runs are bitwise
//   equal. (Fusing dq into the dk/dv pass with fp32 atomics, as
//   FlashAttention-2/3 do, saves two of the seven products but changes bits
//   from run to run.)
// - Sums: each output is one accumulator chain over up to T / 64 tiles, in
//   the tensor cores' own additions; the outputs are rounded to bf16 (the
//   measured gap to the plain version stands in PERF.md).
//
// Left for later work: a persistent grid, overlapping one tile's elementwise
// pass with the next tile's products (two consumer warpgroups in turn),
// staging the outputs through shared memory for TMA stores.
//
// Plain C interface, loaded with ctypes: every launch runs on the caller's
// stream, does not synchronise, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape, stride or pointer these kernels do not
// take). The Hopper primitives are in hopper.cuh.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kTile = 64;                    // rows of a streamed tile and of a warpgroup
constexpr int kRowBytes = 128;               // a box row: 64 bf16
constexpr int kTileBox = kTile * kRowBytes;  // a [64 rows][64] box: 8 KB
constexpr int kStages = 4;
constexpr float kLog2e = 1.4426950408889634f;

// Consumer warpgroups a block (see the note).
template <int D>
__host__ __device__ constexpr int consumers() {
  return D == 64 ? 2 : 1;
}

// dk/dv at head_dim 64 holds four [64, 64] fp32 accumulators a consumer
// thread (128 registers) beside its addresses: more than the 168 registers
// a thread of a 384-thread block gets at launch (it spilled). Its producer
// warpgroup gives registers back and its consumers take them.
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
template <int D>
__host__ __device__ constexpr bool rebalance_dkv() {
  return consumers<D>() == 2;
}

struct Params {
  const float* lse;    // [B*H, T]
  const float* delta;  // [B*H, T]
  bf16* out0;          // dq, or dk
  bf16* out1;          // dv
  int64_t osb, ost, osh;  // the outputs' strides (elements)
  int T, H;
  float scale;  // D**-0.5
  int causal;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// s = A [64 rows, D] . B [64 rows, D]^T, both K-major in D / 64 boxes:
// A's a_box bytes apart, B's one [64][64] box apart.
template <int D>
__device__ __forceinline__ void scores(float (&s)[32], const uint8_t* a, int a_box,
                                       const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk / 4, off = (kk % 4) * 32;
    wgmma_m64n64k16<0, 0>(s, desc(a + box * a_box + off, 16), desc(b + box * kTileBox + off, 16),
                          kk > 0);
  }
}

// acc += A [64 rows, 64 deep] . B [64 deep, D]: A in registers (frag[kk]
// holds depth 16 kk ... + 15), B a tile of 64 rows read MN-major from D / 64
// boxes of [64][64].
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 2], const uint32_t (&frag)[4][4],
                                           const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = desc(b + kk * 16 * kRowBytes, kTileBox);
    if constexpr (D == 64)
      wgmma_rs_m64n64k16<1>(acc, frag[kk], db, 1);
    else
      wgmma_rs_m64n128k16<1>(acc, frag[kk], db, 1);
  }
}

__device__ __forceinline__ void fence_frags(uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) fence_regs(f[kk]);
}

// Stores a consumer's accumulator (64 rows of D columns) times mul as bf16
// at rows row0 ... row0 + 63 of out (row stride ld), rows at or past T
// clipped. Thread (warp w, lane l) holds rows 16 w + l / 4 (+ 8) and columns
// 8 c + 2 (l % 4) (+ 1) at acc[4 c + 2 h + j].
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], bf16* out, int64_t ld,
                                           int row0, int T, float mul) {
  const int t = threadIdx.x % 128;
  const int r = row0 + (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= T) continue;
    bf16* o = out + static_cast<int64_t>(r + 8 * h) * ld + 2 * (t % 4);
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(o + 8 * c) =
          pack_bf16(acc[4 * c + 2 * h] * mul, acc[4 * c + 2 * h + 1] * mul);
  }
}

// -------------------------------------------------------------------- dq
template <int D>
__global__ void __launch_bounds__(128 * (1 + consumers<D>()), 1)
flash_dq_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_g,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v, Params a) {
  constexpr int kW = consumers<D>(), kBoxes = D / 64;
  constexpr int kRows = 64 * kW;               // query rows of the block
  constexpr int kRowBox = kRows * kRowBytes;   // a [kRows][64] box
  constexpr int kStage = 2 * kBoxes * kTileBox;  // K and V
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], qbar;
  uint8_t* qs = ring_base(smem_raw);  // Q: kBoxes boxes of kRowBox
  uint8_t* gs = qs + kBoxes * kRowBox;  // dO
  uint8_t* ring = gs + kBoxes * kRowBox;
  const int tid = threadIdx.x, wg = tid / 128;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int nq = (a.T + kRows - 1) / kRows;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kRows;  // longest causal rows first
  const int ntiles = (a.T + kTile - 1) / kTile;
  const int nk = a.causal ? min(ntiles, (q0 + kRows + kTile - 1) / kTile) : ntiles;

  if (tid == 0) {
    mbar_init(&qbar, 1);
    init_ring<kStages>(full, empty, 4 * kW);
  }
  __syncthreads();

  if (wg == 0) {  // producer
    if (tid == 0) {
      mbar_expect_tx(&qbar, 2 * kBoxes * kRowBox);
      for (int x = 0; x < kBoxes; ++x) {
        tma_load(qs + x * kRowBox, &map_q, &qbar, 64 * x, h, q0, b);
        tma_load(gs + x * kRowBox, &map_g, &qbar, 64 * x, h, q0, b);
      }
      int s = 0;
      uint32_t ph = 0;
      for (int j = 0; j < nk; ++j) {
        mbar_wait(&empty[s], ph ^ 1);
        uint8_t* st = ring + s * kStage;
        mbar_expect_tx(&full[s], kStage);
        for (int x = 0; x < kBoxes; ++x) {
          tma_load(st + x * kTileBox, &map_k, &full[s], 64 * x, h, j * kTile, b);
          tma_load(st + (kBoxes + x) * kTileBox, &map_v, &full[s], 64 * x, h, j * kTile, b);
        }
        if (++s == kStages) s = 0, ph ^= 1;
      }
    }
    return;
  }

  const int cw = wg - 1, lane = tid % 32;
  const int first = q0 + 64 * cw;                      // this warpgroup's rows: first ... + 63
  const int r0 = first + 16 * ((tid / 32) % 4) + lane / 4;  // this thread's rows: r0, r0 + 8
  const int64_t row_base = static_cast<int64_t>(bh) * a.T;
  float lse2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    lse2[hh] = r < a.T ? a.lse[row_base + r] * kLog2e : 0.f;
    dl[hh] = r < a.T ? a.delta[row_base + r] : 0.f;
  }
  const float sl2 = a.scale * kLog2e;
  const uint8_t* qa = qs + cw * 64 * kRowBytes;  // this warpgroup's 64 rows of each box
  const uint8_t* ga = gs + cw * 64 * kRowBytes;
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  mbar_wait(&qbar, 0);
  int s = 0;
  uint32_t ph = 0;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kTile;
    mbar_wait(&full[s], ph);
    const uint8_t* st = ring + s * kStage;
    if (!a.causal || k0 <= first + 63) {
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      wgmma_fence();
      scores<D>(sc, qa, kRowBox, st);
      scores<D>(dp, ga, kRowBox, st + kBoxes * kTileBox);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(sc);
      fence_acc(dp);
      uint32_t ds[4][4];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int hh = (i / 2) % 2, r = r0 + 8 * hh;
        const int c = k0 + 8 * (i / 4) + 2 * (lane % 4);
        float v[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const bool keep = r < a.T && c + jj < a.T && (!a.causal || c + jj <= r);
          const float p = keep ? exp2f(sc[i + jj] * sl2 - lse2[hh]) : 0.f;
          v[jj] = p * (dp[i + jj] - dl[hh]);
        }
        ds[i / 8][(i % 8) / 2] = pack_bf16(v[0], v[1]);
      }
      fence_acc(dq);
      wgmma_fence();
      accumulate<D>(dq, ds, st);  // K, read MN-major
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(dq);
      fence_frags(ds);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (++s == kStages) s = 0, ph ^= 1;
  }
  store_rows<D>(dq, a.out0 + b * a.osb + h * a.osh, a.ost, first, a.T, a.scale);
}

// ---------------------------------------------------------------- dk, dv
template <int D>
__global__ void __launch_bounds__(128 * (1 + consumers<D>()), 1)
flash_dkv_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_g,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, Params a) {
  constexpr int kW = consumers<D>(), kBoxes = D / 64;
  constexpr int kRows = 64 * kW;  // key rows of the block
  constexpr int kRowBox = kRows * kRowBytes;
  constexpr int kTma = 2 * kBoxes * kTileBox;  // Q and dO of a stage
  constexpr int kStage = kTma + 1024;          // then lse and delta rows, 64 fp32 each
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], kvbar;
  uint8_t* ks = ring_base(smem_raw);  // K: kBoxes boxes of kRowBox
  uint8_t* vs = ks + kBoxes * kRowBox;
  uint8_t* ring = vs + kBoxes * kRowBox;
  const int tid = threadIdx.x, wg = tid / 128;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int k0 = static_cast<int>(blockIdx.y) * kRows;  // longest causal columns first
  const int ntiles = (a.T + kTile - 1) / kTile;
  const int qb0 = a.causal ? k0 / kTile : 0;
  const int n = ntiles - qb0;
  const int64_t row_base = static_cast<int64_t>(bh) * a.T;

  if (tid == 0) {
    mbar_init(&kvbar, 1);
    init_ring<kStages>(full, empty, 4 * kW);
  }
  __syncthreads();

  if (wg == 0) {  // producer: warp 0 (lane 0 issues the TMA loads)
    if constexpr (rebalance_dkv<D>())
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid < 32) {
      if (tid == 0) {
        mbar_expect_tx(&kvbar, 2 * kBoxes * kRowBox);
        for (int x = 0; x < kBoxes; ++x) {
          tma_load(ks + x * kRowBox, &map_k, &kvbar, 64 * x, h, k0, b);
          tma_load(vs + x * kRowBox, &map_v, &kvbar, 64 * x, h, k0, b);
        }
      }
      int s = 0;
      uint32_t ph = 0;
      for (int i = 0; i < n; ++i) {
        const int q0 = (qb0 + i) * kTile;
        mbar_wait(&empty[s], ph ^ 1);
        uint8_t* st = ring + s * kStage;
        float* ls = reinterpret_cast<float*>(st + kTma);
        for (int r = tid; r < kTile; r += 32) {
          const bool in = q0 + r < a.T;
          ls[r] = in ? a.lse[row_base + q0 + r] * kLog2e : 0.f;
          ls[kTile + r] = in ? a.delta[row_base + q0 + r] : 0.f;
        }
        __syncwarp();  // the lanes' rows, then lane 0's arrival releases them
        if (tid == 0) {
          mbar_expect_tx(&full[s], kTma);
          for (int x = 0; x < kBoxes; ++x) {
            tma_load(st + x * kTileBox, &map_q, &full[s], 64 * x, h, q0, b);
            tma_load(st + (kBoxes + x) * kTileBox, &map_g, &full[s], 64 * x, h, q0, b);
          }
        }
        if (++s == kStages) s = 0, ph ^= 1;
      }
    }
    return;
  }

  if constexpr (rebalance_dkv<D>())
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int cw = wg - 1, lane = tid % 32;
  const int first = k0 + 64 * cw;                          // this warpgroup's keys
  const int kr0 = first + 16 * ((tid / 32) % 4) + lane / 4;  // this thread's keys: kr0, kr0 + 8
  const float sl2 = a.scale * kLog2e;
  const uint8_t* ka = ks + cw * 64 * kRowBytes;
  const uint8_t* va = vs + cw * 64 * kRowBytes;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(&kvbar, 0);
  int s = 0;
  uint32_t ph = 0;
  for (int i = 0; i < n; ++i) {
    const int q0 = (qb0 + i) * kTile;
    mbar_wait(&full[s], ph);
    const uint8_t* st = ring + s * kStage;
    if (!a.causal || q0 + kTile - 1 >= first) {
      float sc[32], dp[32];  // transposed: [key][query]
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = dp[e] = 0.f;
      wgmma_fence();
      scores<D>(sc, ka, kRowBox, st);
      scores<D>(dp, va, kRowBox, st + kBoxes * kTileBox);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(sc);
      fence_acc(dp);
      const float* ls = reinterpret_cast<const float*>(st + kTma);
      uint32_t pf[4][4], sf[4][4];
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int hh = (e / 2) % 2, key = kr0 + 8 * hh;
        const int qc = 8 * (e / 4) + 2 * (lane % 4);  // query column in the tile
        const float2 lse2 = *reinterpret_cast<const float2*>(ls + qc);
        const float2 dl = *reinterpret_cast<const float2*>(ls + kTile + qc);
        float pv[2], dsv[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int q = q0 + qc + jj;
          const bool keep = key < a.T && q < a.T && (!a.causal || key <= q);
          const float p =
              keep ? exp2f(sc[e + jj] * sl2 - (jj ? lse2.y : lse2.x)) : 0.f;
          pv[jj] = p;
          dsv[jj] = p * (dp[e + jj] - (jj ? dl.y : dl.x));
        }
        pf[e / 8][(e % 8) / 2] = pack_bf16(pv[0], pv[1]);
        sf[e / 8][(e % 8) / 2] = pack_bf16(dsv[0], dsv[1]);
      }
      fence_acc(dv);
      fence_acc(dk);
      wgmma_fence();
      accumulate<D>(dv, pf, st + kBoxes * kTileBox);  // dO, read MN-major
      accumulate<D>(dk, sf, st);                      // Q, read MN-major
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(dv);
      fence_acc(dk);
      fence_frags(pf);
      fence_frags(sf);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (++s == kStages) s = 0, ph ^= 1;
  }
  const int64_t off = b * a.osb + h * a.osh;
  store_rows<D>(dk, a.out0 + off, a.ost, first, a.T, a.scale);
  store_rows<D>(dv, a.out1 + off, a.ost, first, a.T, 1.f);
}

// ------------------------------------------------------------- launching
// A map of the bf16 [B, T, H, D] tensor at ptr with (b, t, h) strides s (in
// elements; d contiguous), as dims (D, H, T, B), read in boxes of 64 d x
// `rows` t, 128-byte swizzled; rows past T read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, const int64_t* s, int64_t B, int64_t T, int64_t H,
              int64_t D, int rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s[2] * 2),
                                 static_cast<cuuint64_t>(s[1] * 2),
                                 static_cast<cuuint64_t>(s[0] * 2)};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

enum Which { kDq = 0, kDkv = 1 };

template <int D>
void* kernel_of(Which w) {
  return w == kDq ? reinterpret_cast<void*>(flash_dq_tc_kernel<D>)
                  : reinterpret_cast<void*>(flash_dkv_tc_kernel<D>);
}

template <int D>
int smem_bytes(Which w) {
  constexpr int kOwned = 2 * (D / 64) * 64 * consumers<D>() * kRowBytes;  // Q+dO, or K+V
  const int stage = 2 * (D / 64) * kTileBox + (w == kDkv ? 1024 : 0);
  return kSwizzleBytes + kOwned + kStages * stage;
}

template <int D>
cudaError_t launch_d(Which w, const void* const* ptrs, const int64_t* strides, Params& p,
                     int64_t B, int64_t T, int64_t H, cudaStream_t stream) {
  constexpr int kRows = 64 * consumers<D>();
  // dq owns query rows (Q, dO in boxes of kRows) and streams K, V tiles;
  // dk/dv the other way round.
  const int q_rows = w == kDq ? kRows : kTile, k_rows = w == kDq ? kTile : kRows;
  CUtensorMap maps[4];
  const int rows[4] = {q_rows, k_rows, k_rows, q_rows};  // q, k, v, do
  for (int i = 0; i < 4; ++i)
    if (!make_map(&maps[i], ptrs[i], strides + 3 * i, B, T, H, D, rows[i]))
      return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(B * H), static_cast<unsigned>((T + kRows - 1) / kRows));
  const int threads = 128 * (1 + consumers<D>()), smem = smem_bytes<D>(w);
  cudaError_t err = cudaFuncSetAttribute(kernel_of<D>(w),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (w == kDkv && rebalance_dkv<D>()) {
    // setmaxnreg.inc takes registers from the block's pool: refuse to launch
    // (rather than hang) if the compiled kernel leaves the pool too small.
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel_of<D>(w));
    if (err != cudaSuccess) return err;
    if (attr.numRegs * threads < 128 * kProducerRegs + (threads - 128) * kConsumerRegs)
      return cudaErrorInvalidValue;
  }
  if (w == kDq)
    flash_dq_tc_kernel<D><<<grid, threads, smem, stream>>>(maps[0], maps[3], maps[1], maps[2], p);
  else
    flash_dkv_tc_kernel<D><<<grid, threads, smem, stream>>>(maps[0], maps[3], maps[1], maps[2],
                                                            p);
  return cudaGetLastError();
}

// ptrs: q, k, v, do; strides: (sb, st, sh) of each, then of the outputs.
int run(Which w, const void* const* ptrs, const float* lse, const float* delta, void* out0,
        void* out1, const int64_t* strides, int64_t B, int64_t T, int64_t H, int64_t D,
        int64_t causal, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  if ((D != 64 && D != 128) || B * H >= (1LL << 31) || T >= (1LL << 31) - 256 ||
      (T + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 4; ++i) {
    if (misaligned(ptrs[i])) return static_cast<int>(cudaErrorInvalidValue);
    for (int j = 0; j < 3; ++j) {
      const int64_t s = strides[3 * i + j];
      if (s <= 0 || s % 8 || s >= (1LL << 39)) return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  Params p{};
  p.lse = lse;
  p.delta = delta;
  p.out0 = static_cast<bf16*>(out0);
  p.out1 = static_cast<bf16*>(out1);
  p.osb = strides[12];
  p.ost = strides[13];
  p.osh = strides[14];
  p.T = static_cast<int>(T);
  p.H = static_cast<int>(H);
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  p.causal = static_cast<int>(causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = D == 64 ? launch_d<64>(w, ptrs, strides, p, B, T, H, s)
                                  : launch_d<128>(w, ptrs, strides, p, B, T, H, s);
  return static_cast<int>(err);
}

}  // namespace

// dq [B,T,H,D] bf16 (contiguous) from q, k, v, dO [B,T,H,D] bf16 (d
// contiguous, (b, t, h) strides multiples of 8 elements, 16-byte-aligned
// pointers) and lse, delta [B*H, T] fp32; D 64 or 128.
extern "C" int flash_dq_tc(const void* q, const void* k, const void* v, const void* g,
                           const float* lse, const float* delta, void* dq,
                           const int64_t* strides, int64_t B, int64_t T, int64_t H, int64_t D,
                           int64_t causal, void* stream) {
  const void* ptrs[4] = {q, k, v, g};
  return run(kDq, ptrs, lse, delta, dq, nullptr, strides, B, T, H, D, causal, stream);
}

// dk, dv [B,T,H,D] bf16 (contiguous) from the same inputs.
extern "C" int flash_dkv_tc(const void* q, const void* k, const void* v, const void* g,
                            const float* lse, const float* delta, void* dk, void* dv,
                            const int64_t* strides, int64_t B, int64_t T, int64_t H, int64_t D,
                            int64_t causal, void* stream) {
  const void* ptrs[4] = {q, k, v, g};
  return run(kDkv, ptrs, lse, delta, dk, dv, strides, B, T, H, D, causal, stream);
}
