// Paged-attention decode: one step of q [B, 1, Hq, D] against the KV pools
// [num_pages, page_size, Hkv, D] of the serving engine, through each slot's
// page table row and depth pos[b], reading only the slot's live rows.
//
// Replaces the TPU kernel cs744_pytorch_distributed_tutorial_tpu/ops/
// paged_attention.py::_decode_kernel (launched from paged_attention through
// pl.pallas_call). Per (slot b, KV head h), for the group of query heads
// h*group .. h*group + group - 1 (GQA: the pools are never widened), over
// keys 0 .. pos[b]:
//
//   s = (q . k) * D**-0.5                          fp32
//   online softmax: m, l, acc in fp32 over chunks of keys
//   float pools: p rounded to the pool dtype before p @ v, out = acc / l in
//                the pool dtype
//   int8 pools:  q and k in fp32, s *= k_scale after the dot, p * v_scale in
//                place of p, v in fp32, out = acc / l in q's dtype
//
// as the TPU kernel computes them (its masked keys, k > pos, weigh exactly
// 0; here they are not read at all). Position 0 is always visible, so l > 0:
// a parked slot or one at depth 0 gives no NaN.
//
// What bounds it: the live KV rows it must read (2 * (pos + 1) * D elements
// per slot and KV head, plus the row scales for int8) over 3.35 TB/s: a few
// microseconds a layer at the serving engine's shape (16 slots, 4 KV heads,
// D 64, depths up to 511), so a launch costs more than the bytes.
//
// - The TPU kernel's grid (slot, kv head, page) with clamped index maps is
//   how a TPU avoids a gather; here one block of 128 threads per (kv head,
//   slot) loops over the slot's live keys in chunks of 32. Each key's pool
//   row is looked up in the block's own page-table row, so any page_size
//   works and no dead page is touched; pages_per_slot narrows the table.
// - A chunk of K and V is widened to fp32 in shared memory (K with row
//   stride D + 1: conflict-free), the group's scores are dot products over
//   D, one warp per query head updates the softmax statistics with warp
//   shuffles, and each thread accumulates up to D/8 outputs of the [group, D]
//   accumulator in registers (group <= 16).
//
// Left for later work: more blocks per slot (split the keys, merge the
// partial softmaxes), vector loads, and fewer launches a step (a CUDA graph
// of the decode step).
//
// Plain C interface, loaded with ctypes: the launch runs on the caller's
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 32;  // keys a pass: one per lane in the softmax update
constexpr int kMaxGroup = 16;
constexpr float kNeg = -1e30f;  // the TPU kernel's mask value

struct Args {
  const void* q;         // [B, Hq, D] contiguous
  const void* kp;        // [num_pages, page_size, Hkv, D] contiguous
  const void* vp;
  const float* ks;       // [num_pages, page_size, Hkv] (int8 pools only)
  const float* vs;
  const int32_t* table;  // [B, table_stride]; the first n_pages columns are read
  const int32_t* pos;    // [B]
  void* out;             // [B, Hq, D]
  int table_stride, n_pages, page_size, hkv, group, num_pages;
  float scale;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// KV: the pools' element type; Q: q's; Out: the output's.
template <typename KV, typename Q, typename Out, int D, bool kQuant>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(Args a) {
  constexpr int kOut = kMaxGroup * D / kThreads;  // accumulator slots a thread
  __shared__ float qs[kMaxGroup * D];
  __shared__ float kt[kChunk][D + 1];
  __shared__ float vt[kChunk][D];
  __shared__ float ps[kMaxGroup][kChunk];
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup], corr_s[kMaxGroup];
  __shared__ float ksc[kChunk], vsc[kChunk];
  __shared__ int64_t rows[kChunk];

  const int h = blockIdx.x, b = blockIdx.y;
  const int G = a.group, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int pos = a.pos[b];
  const int n_keys = min(pos + 1, a.n_pages * a.page_size);
  const int64_t head0 = ((int64_t)b * a.hkv + h) * G;  // first query head of the group
  const Q* qb = static_cast<const Q*>(a.q) + head0 * D;
  const KV* kp = static_cast<const KV*>(a.kp);
  const KV* vp = static_cast<const KV*>(a.vp);
  const int32_t* table = a.table + (int64_t)b * a.table_stride;

  for (int i = tid; i < G * D; i += kThreads) qs[i] = to_f32(qb[i]);
  if (tid < G) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  float acc[kOut];
#pragma unroll
  for (int o = 0; o < kOut; ++o) acc[o] = 0.f;

  for (int k0 = 0; k0 < n_keys; k0 += kChunk) {
    const int nk = min(kChunk, n_keys - k0);
    if (tid < kChunk) {
      int64_t r = 0;
      if (tid < nk) {
        const int key = k0 + tid;
        // A page index outside the pool is clamped into it, as the TPU
        // kernel's index maps clamp: the read stays inside the pool.
        const int page = min(max(table[key / a.page_size], 0), a.num_pages - 1);
        r = (int64_t)page * a.page_size + key % a.page_size;
      }
      rows[tid] = r;
      if constexpr (kQuant) {
        ksc[tid] = tid < nk ? a.ks[r * a.hkv + h] : 0.f;
        vsc[tid] = tid < nk ? a.vs[r * a.hkv + h] : 0.f;
      }
    }
    __syncthreads();
    for (int i = tid; i < kChunk * D; i += kThreads) {
      const int j = i / D, d = i % D;
      float kv = 0.f, vv = 0.f;
      if (j < nk) {
        const int64_t off = (rows[j] * a.hkv + h) * D + d;
        kv = to_f32(kp[off]);
        vv = to_f32(vp[off]);
      }
      kt[j][d] = kv;
      vt[j][d] = vv;
    }
    __syncthreads();
    for (int i = tid; i < G * kChunk; i += kThreads) {
      const int g = i / kChunk, j = i % kChunk;
      float s = kNeg;
      if (j < nk) {
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot = fmaf(qs[g * D + d], kt[j][d], dot);
        s = dot * a.scale;
        if constexpr (kQuant) s *= ksc[j];
      }
      ps[g][j] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kThreads / 32) {
      const float s = ps[g][lane];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float corr = expf(m_prev - m_new);
      const float p = lane < nk ? expf(s - m_new) : 0.f;
      const float p_sum = warp_sum(p);
      if constexpr (kQuant) {
        ps[g][lane] = p * vsc[lane];
      } else {
        ps[g][lane] = round_to<KV>(p);
      }
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = corr * l_s[g] + p_sum;
        corr_s[g] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      const int idx = tid + o * kThreads;
      if (idx < G * D) {
        const int g = idx / D, d = idx % D;
        float dot = 0.f;
        for (int j = 0; j < nk; ++j) dot = fmaf(ps[g][j], vt[j][d], dot);
        acc[o] = acc[o] * corr_s[g] + dot;
      }
    }
    __syncthreads();
  }

  Out* out = static_cast<Out*>(a.out) + head0 * D;
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    const int idx = tid + o * kThreads;
    if (idx < G * D) out[idx] = from_f32<Out>(acc[o] / l_s[idx / D]);
  }
}

template <typename KV, typename Q, typename Out, bool kQuant>
cudaError_t launch_d(const Args& a, int B, int D, cudaStream_t stream) {
  const dim3 grid((unsigned)a.hkv, (unsigned)B);
  switch (D) {
    case 32: paged_decode_kernel<KV, Q, Out, 32, kQuant><<<grid, kThreads, 0, stream>>>(a); break;
    case 64: paged_decode_kernel<KV, Q, Out, 64, kQuant><<<grid, kThreads, 0, stream>>>(a); break;
    case 128: paged_decode_kernel<KV, Q, Out, 128, kQuant><<<grid, kThreads, 0, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// out [B, Hq, D] from q [B, Hq, D] and the pools of num_pages pages; kv_kind
// 0 = fp32 pools (q fp32), 1 = bf16 pools (q bf16), 2 = int8 pools with fp32
// row-scale pools (q fp32, or bf16 if q_bf16 != 0; out in q's dtype). All
// contiguous; table [B, table_stride] int32, of which the first n_pages
// columns are read; pos [B] int32.
extern "C" int paged_attention(const void* q, const void* kp, const void* vp, const void* ks,
                               const void* vs, const void* table, const void* pos, void* out,
                               int64_t B, int64_t hkv, int64_t group, int64_t D,
                               int64_t page_size, int64_t num_pages, int64_t table_stride,
                               int64_t n_pages, int64_t kv_kind, int64_t q_bf16, void* stream) {
  if (B <= 0 || hkv <= 0) return 0;
  if (group < 1 || group > kMaxGroup || page_size < 1 || num_pages < 1 || n_pages < 1 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = q; a.kp = kp; a.vp = vp;
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.table = static_cast<const int32_t*>(table);
  a.pos = static_cast<const int32_t*>(pos);
  a.out = out;
  a.table_stride = (int)table_stride;
  a.n_pages = (int)n_pages;
  a.page_size = (int)page_size;
  a.num_pages = (int)num_pages;
  a.hkv = (int)hkv;
  a.group = (int)group;
  a.scale = (float)(1.0 / sqrt((double)D));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (kv_kind == 0) {
    err = launch_d<float, float, float, false>(a, (int)B, (int)D, s);
  } else if (kv_kind == 1) {
    err = launch_d<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16, false>(a, (int)B, (int)D, s);
  } else if (kv_kind == 2) {
    err = q_bf16 ? launch_d<int8_t, __nv_bfloat16, __nv_bfloat16, true>(a, (int)B, (int)D, s)
                 : launch_d<int8_t, float, float, true>(a, (int)B, (int)D, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
