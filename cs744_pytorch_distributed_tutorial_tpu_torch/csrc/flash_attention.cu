// Flash attention on [B, T, H, D]: the forward with its row logsumexp, and
// the two backward kernels (dq; dk and dv), fp32 or bf16 inputs.
//
// Replaces the TPU kernels of cs744_pytorch_distributed_tutorial_tpu/ops/
// flash_attention.py: _kernel (the forward, launched from _forward through
// pl.pallas_call), _dq_kernel (flash_dq) and _dkv_kernel (flash_dkv). They
// compute, per (batch, head), with s = (q . k) * D**-0.5 and the causal mask
// s = -1e30 where key > query:
//
//   forward  online softmax over key tiles: m, l, acc in fp32;
//            out = acc / l, lse = m + log(l)
//   dq       p = exp(s - lse), ds = p * (do . v - delta), dq = scale * ds @ k
//   dk, dv   dv = p^T @ do, dk = scale * ds^T @ q
//
// where delta = rowsum(do * out) comes from the caller. In bf16, p is
// rounded to bf16 before its product with v or do, and ds before its product
// with k or q, as the TPU kernels' .astype() calls do; all sums are fp32.
//
// What bounds it: at the LM path's shape (B 16, T 1024, H 12, D 64, causal,
// bf16) the forward does 25.8 GFLOP against about 100 MB of inputs and
// outputs, some 250 operations a byte: bound by operations. These kernels
// run the products on the FP32 units (FFMA, 67 TFLOP/s), not on the tensor
// cores (989 TFLOP/s in bf16): a simple design that is right first.
//
// - One block of 256 threads per (b*h, 64-row tile): a query tile for the
//   forward and dq, a key tile for dk/dv. The other operand's tiles stream
//   through shared memory in a loop inside the block, the TPU grid's
//   sequential axis; nothing of [T, T] shape reaches device memory.
// - Every 64 x 64 tile product gives each thread a 4 x 4 register tile (rows
//   ty*4 + i, columns tx + 16j), accumulated with FFMA in fp32. The row
//   operand is kept transposed in shared memory ([depth][64 + 4]: one
//   16-byte load gives a thread its four rows), the column operand in its
//   natural layout with an odd row stride (D + 1: conflict-free loads).
// - Softmax statistics stay in registers, reduced over the 16 threads that
//   share a row with warp shuffles.
// - Causal tiles above the diagonal are skipped; rows and keys past T are
//   masked, so any T works. dq is owned by its query tile and dk, dv by
//   their key tile: no atomics, the same bits every run.
// - Inputs are read in place through their (b, t, h) strides (the last
//   dimension contiguous), widened to fp32 on load; outputs are written
//   [B, T, H, D] contiguous, lse as [B*H, T] fp32.
//
// The tensor cores took over bf16 inputs at head_dim 64 and 128 with strides
// TMA can read: flash_attention_tc.cu, the forward and the backward
// (ops/flash_attention.py::tc_route picks). These kernels keep fp32 inputs,
// head_dim 32 and the other strides. Left for later work here: a pipeline
// of tiles in flight.
//
// Plain C interface, loaded with ctypes: the launches run on the caller's
// stream, do not synchronise, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;        // rows of a tile: queries or keys
constexpr int kThreads = 256;     // 16 x 16 threads, a 4 x 4 tile each
constexpr int kLdT = kBlock + 4;  // row stride of a transposed tile
constexpr float kNeg = -1e30f;    // the TPU kernels' mask value

struct Layout {  // element (b, t, h, d) at b*sb + t*st + h*sh + d
  int64_t sb, st, sh;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* g;  // the output cotangent dO (backward only)
  void* out0;     // forward: o; dq: dq; dkv: dk
  void* out1;     // dkv: dv
  float* lse;     // [B*H, T]: written by the forward, read by the backward
  const float* delta;  // [B*H, T]
  Layout lq, lk, lv, lg, lo;
  int T, H;
  float scale;
  int causal;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype
}

// v rounded to T's precision, kept in fp32.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f32(from_f32<T>(v)); }

// Rows [row0, row0 + 64) of head (b, h) of x into shared memory as fp32,
// zero past T. Transposed: dst[d * kLdT + r]; natural: dst[r * (D + 1) + d].
template <typename T, int D, bool kTransposed>
__device__ __forceinline__ void load_tile(const void* src, const Layout& L, int b,
                                          int h, int row0, int T_, float* dst) {
  const T* base = static_cast<const T*>(src) + b * L.sb + h * L.sh;
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int t = row0 + r;
    const float val = t < T_ ? to_f32(base[(int64_t)t * L.st + d]) : 0.f;
    if (kTransposed) dst[d * kLdT + r] = val;
    else dst[r * (D + 1) + d] = val;
  }
}

// acc[i][j] += sum_{e < kDepth} A[e * kLdT + ty*4 + i] * B[(tx + 16j) * kBc + e * kBe]
template <int NJ, int kDepth, int kBc, int kBe>
__device__ __forceinline__ void tile_fma(const float* A, const float* B,
                                         float (&acc)[4][NJ], int ty, int tx) {
#pragma unroll 4
  for (int e = 0; e < kDepth; ++e) {
    const float4 a = *reinterpret_cast<const float4*>(A + e * kLdT + ty * 4);
    float bv[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) bv[j] = B[(tx + 16 * j) * kBc + e * kBe];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      acc[0][j] = fmaf(a.x, bv[j], acc[0][j]);
      acc[1][j] = fmaf(a.y, bv[j], acc[1][j]);
      acc[2][j] = fmaf(a.z, bv[j], acc[2][j]);
      acc[3][j] = fmaf(a.w, bv[j], acc[3][j]);
    }
  }
}

// Reductions over the 16 threads of a half-warp (the threads of one row).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Stores vals[0..3] (rows ty*4 .. ty*4+3) at dst[col * kLdT + ty*4].
__device__ __forceinline__ void store_col4(float* dst, int col, int ty, float a, float b,
                                           float c, float d) {
  *reinterpret_cast<float4*>(dst + col * kLdT + ty * 4) = make_float4(a, b, c, d);
}

template <typename T, int D>
__device__ __forceinline__ void store_rows(void* dst, const Layout& L, int b, int h, int r,
                                           int tx, const float (&vals)[D / 16], float mul) {
  T* base = static_cast<T*>(dst) + b * L.sb + (int64_t)r * L.st + h * L.sh;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) base[tx + 16 * j] = from_f32<T>(vals[j] * mul);
}

// ---------------------------------------------------------------- forward
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  constexpr int NO = D / 16;
  extern __shared__ float smem[];
  float* Qt = smem;                   // [D][kLdT]
  float* Ks = Qt + D * kLdT;          // [64][D + 1]
  float* Vs = Ks + kBlock * (D + 1);  // [64][D + 1]
  float* Pt = Vs + kBlock * (D + 1);  // [64 keys][kLdT]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int nq = (a.T + kBlock - 1) / kBlock;
  const int qt = nq - 1 - (int)blockIdx.y;  // the longest causal rows first
  const int q0 = qt * kBlock;

  load_tile<T, D, true>(a.q, a.lq, b, h, q0, a.T, Qt);
  float m[4], l[4], o[4][NO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NO; ++j) o[i][j] = 0.f;
  }
  const int nk = a.causal ? qt + 1 : nq;
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * kBlock;
    __syncthreads();  // the previous tile's reads of Ks, Vs, Pt are done
    load_tile<T, D, false>(a.k, a.lk, b, h, k0, a.T, Ks);
    load_tile<T, D, false>(a.v, a.lv, b, h, k0, a.T, Vs);
    __syncthreads();
    float s[4][4] = {};
    tile_fma<4, D, D + 1, 1>(Qt, Ks, s, ty, tx);
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        float x = s[i][j] * a.scale;
        if (c >= a.T || (a.causal && c > r)) x = kNeg;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = expf(s[i][j] - m_new);
        ps += p[i][j];
      }
      l[i] = corr * l[i] + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NO; ++j) o[i][j] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store_col4(Pt, tx + 16 * j, ty, round_to<T>(p[0][j]), round_to<T>(p[1][j]),
                 round_to<T>(p[2][j]), round_to<T>(p[3][j]));
    __syncthreads();
    tile_fma<NO, kBlock, 1, D + 1>(Pt, Vs, o, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= a.T) continue;
    store_rows<T, D>(a.out0, a.lo, b, h, r, tx, o[i], 1.f / l[i]);
    if (tx == 0) a.lse[(int64_t)bh * a.T + r] = m[i] + logf(l[i]);
  }
}

// -------------------------------------------------------------------- dq
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Args a) {
  constexpr int NO = D / 16;
  extern __shared__ float smem[];
  float* Qt = smem;                   // [D][kLdT]
  float* Gt = Qt + D * kLdT;          // [D][kLdT]: dO
  float* Ks = Gt + D * kLdT;          // [64][D + 1]
  float* Vs = Ks + kBlock * (D + 1);  // [64][D + 1]
  float* St = Vs + kBlock * (D + 1);  // [64 keys][kLdT]: ds
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int nq = (a.T + kBlock - 1) / kBlock;
  const int qt = nq - 1 - (int)blockIdx.y;
  const int q0 = qt * kBlock;

  load_tile<T, D, true>(a.q, a.lq, b, h, q0, a.T, Qt);
  load_tile<T, D, true>(a.g, a.lg, b, h, q0, a.T, Gt);
  float lse[4], delta[4], acc[4][NO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    lse[i] = r < a.T ? a.lse[(int64_t)bh * a.T + r] : 0.f;
    delta[i] = r < a.T ? a.delta[(int64_t)bh * a.T + r] : 0.f;
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[i][j] = 0.f;
  }
  const int nk = a.causal ? qt + 1 : nq;
  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * kBlock;
    __syncthreads();
    load_tile<T, D, false>(a.k, a.lk, b, h, k0, a.T, Ks);
    load_tile<T, D, false>(a.v, a.lv, b, h, k0, a.T, Vs);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    tile_fma<4, D, D + 1, 1>(Qt, Ks, s, ty, tx);
    tile_fma<4, D, D + 1, 1>(Gt, Vs, dp, ty, tx);
    float ds[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        float x = s[i][j] * a.scale;
        if (a.causal && c > r) x = kNeg;
        float p = expf(x - lse[i]);
        if (r >= a.T || c >= a.T) p = 0.f;
        ds[i][j] = round_to<T>(p * (dp[i][j] - delta[i]));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store_col4(St, tx + 16 * j, ty, ds[0][j], ds[1][j], ds[2][j], ds[3][j]);
    __syncthreads();
    tile_fma<NO, kBlock, 1, D + 1>(St, Ks, acc, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r < a.T) store_rows<T, D>(a.out0, a.lo, b, h, r, tx, acc[i], a.scale);
  }
}

// ---------------------------------------------------------------- dk, dv
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Args a) {
  constexpr int NO = D / 16;
  extern __shared__ float smem[];
  float* Kt = smem;                   // [D][kLdT]
  float* Vt = Kt + D * kLdT;          // [D][kLdT]
  float* Qs = Vt + D * kLdT;          // [64][D + 1]
  float* Gs = Qs + kBlock * (D + 1);  // [64][D + 1]: dO
  float* Pq = Gs + kBlock * (D + 1);  // [64 queries][kLdT]: p
  float* Sq = Pq + kBlock * kLdT;     // [64 queries][kLdT]: ds
  float* lse_s = Sq + kBlock * kLdT;  // [64]
  float* delta_s = lse_s + kBlock;    // [64]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int kt = blockIdx.y;  // the longest causal columns (kt = 0) first
  const int k0 = kt * kBlock;
  const int nq = (a.T + kBlock - 1) / kBlock;

  load_tile<T, D, true>(a.k, a.lk, b, h, k0, a.T, Kt);
  load_tile<T, D, true>(a.v, a.lv, b, h, k0, a.T, Vt);
  float dk[4][NO], dv[4][NO];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NO; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int qb = a.causal ? kt : 0; qb < nq; ++qb) {
    const int q0 = qb * kBlock;
    __syncthreads();
    load_tile<T, D, false>(a.q, a.lq, b, h, q0, a.T, Qs);
    load_tile<T, D, false>(a.g, a.lg, b, h, q0, a.T, Gs);
    if (threadIdx.x < kBlock) {
      const int r = q0 + threadIdx.x;
      lse_s[threadIdx.x] = r < a.T ? a.lse[(int64_t)bh * a.T + r] : 0.f;
      delta_s[threadIdx.x] = r < a.T ? a.delta[(int64_t)bh * a.T + r] : 0.f;
    }
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};  // transposed: [key][query]
    tile_fma<4, D, D + 1, 1>(Kt, Qs, s, ty, tx);
    tile_fma<4, D, D + 1, 1>(Vt, Gs, dp, ty, tx);
    float p[4][4], ds[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rl = tx + 16 * j, r = q0 + rl;
      const float lse = lse_s[rl], delta = delta_s[rl];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = k0 + ty * 4 + i;
        float x = s[i][j] * a.scale;
        if (a.causal && c > r) x = kNeg;
        float pv = expf(x - lse);
        if (r >= a.T || c >= a.T) pv = 0.f;
        p[i][j] = round_to<T>(pv);
        ds[i][j] = round_to<T>(pv * (dp[i][j] - delta));
      }
      store_col4(Pq, rl, ty, p[0][j], p[1][j], p[2][j], p[3][j]);
      store_col4(Sq, rl, ty, ds[0][j], ds[1][j], ds[2][j], ds[3][j]);
    }
    __syncthreads();
    tile_fma<NO, kBlock, 1, D + 1>(Pq, Gs, dv, ty, tx);
    tile_fma<NO, kBlock, 1, D + 1>(Sq, Qs, dk, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty * 4 + i;
    if (c >= a.T) continue;
    store_rows<T, D>(a.out0, a.lo, b, h, c, tx, dk[i], a.scale);
    store_rows<T, D>(a.out1, a.lo, b, h, c, tx, dv[i], 1.f);
  }
}

// ------------------------------------------------------------- launching
enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <int D>
constexpr size_t smem_bytes(Which w) {
  const size_t t = (size_t)D * kLdT, n = (size_t)kBlock * (D + 1), p = (size_t)kBlock * kLdT;
  return sizeof(float) * (w == kFwd ? t + 2 * n + p
                          : w == kDq ? 2 * t + 2 * n + p
                                     : 2 * t + 2 * n + 2 * p + 2 * kBlock);
}

template <typename T, int D>
cudaError_t launch_t(Which w, const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(w);
  const dim3 grid((unsigned)(B * a.H), (unsigned)((a.T + kBlock - 1) / kBlock));
  void (*kernel)(Args) = w == kFwd ? flash_fwd_kernel<T, D>
                         : w == kDq ? flash_dq_kernel<T, D>
                                    : flash_dkv_kernel<T, D>;
  // Above 48 KB a block's shared memory must be asked for (per device, so
  // at every launch: the call costs far less than the kernel).
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(Which w, const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_t<T, 32>(w, a, B, stream);
    case 64: return launch_t<T, 64>(w, a, B, stream);
    case 128: return launch_t<T, 128>(w, a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

Layout layout_at(const int64_t* s, int i) { return Layout{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

int run(Which w, Args& a, int64_t B, int64_t T, int64_t H, int64_t D, int64_t causal,
        int64_t bf16, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  a.T = (int)T;
  a.H = (int)H;
  a.causal = (int)causal;
  a.scale = (float)(1.0 / sqrt((double)D));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = bf16 ? launch_d<__nv_bfloat16>(w, a, (int)B, (int)D, s)
                         : launch_d<float>(w, a, (int)B, (int)D, s);
  return (int)err;
}

}  // namespace

// strides: (sb, st, sh) of each tensor in argument order, then of the
// outputs (all outputs share one contiguous [B, T, H, D] layout).

// o [B,T,H,D] and lse [B*H, T] fp32 from q, k, v [B,T,H,D].
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                         const int64_t* strides, int64_t B, int64_t T, int64_t H,
                         int64_t D, int64_t causal, int64_t bf16, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.out0 = o; a.lse = lse;
  a.lq = layout_at(strides, 0); a.lk = layout_at(strides, 1);
  a.lv = layout_at(strides, 2); a.lo = layout_at(strides, 3);
  return run(kFwd, a, B, T, H, D, causal, bf16, stream);
}

// dq [B,T,H,D] from q, k, v, dO [B,T,H,D] and lse, delta [B*H, T] fp32.
extern "C" int flash_dq(const void* q, const void* k, const void* v, const void* g,
                        const float* lse, const float* delta, void* dq,
                        const int64_t* strides, int64_t B, int64_t T, int64_t H,
                        int64_t D, int64_t causal, int64_t bf16, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.g = g; a.out0 = dq;
  a.lse = const_cast<float*>(lse); a.delta = delta;
  a.lq = layout_at(strides, 0); a.lk = layout_at(strides, 1);
  a.lv = layout_at(strides, 2); a.lg = layout_at(strides, 3);
  a.lo = layout_at(strides, 4);
  return run(kDq, a, B, T, H, D, causal, bf16, stream);
}

// dk, dv [B,T,H,D] from the same inputs.
extern "C" int flash_dkv(const void* q, const void* k, const void* v, const void* g,
                         const float* lse, const float* delta, void* dk, void* dv,
                         const int64_t* strides, int64_t B, int64_t T, int64_t H,
                         int64_t D, int64_t causal, int64_t bf16, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.g = g; a.out0 = dk; a.out1 = dv;
  a.lse = const_cast<float*>(lse); a.delta = delta;
  a.lq = layout_at(strides, 0); a.lk = layout_at(strides, 1);
  a.lv = layout_at(strides, 2); a.lg = layout_at(strides, 3);
  a.lo = layout_at(strides, 4);
  return run(kDkv, a, B, T, H, D, causal, bf16, stream);
}
