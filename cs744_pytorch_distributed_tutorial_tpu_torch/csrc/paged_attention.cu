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
//   softmax over spans of keys, each with its own max m_s; l, acc in fp32,
//   the spans merged by exp(m_s - m)
//   float pools: p = exp(s - m_s) rounded to the pool dtype before p @ v,
//                out = acc / l in the pool dtype
//   int8 pools:  q and k in fp32, s *= k_scale after the dot, p * v_scale in
//                place of p, v in fp32, out = acc / l in q's dtype
//
// as the TPU kernel computes them (its masked keys, k > pos, weigh exactly
// 0; here they are not read at all). Position 0 is always visible, so l > 0:
// a parked slot or one at depth 0 gives no NaN.
//
// What bounds it: the live KV rows it must read (2 * (pos + 1) * D elements
// per slot and KV head, plus the row scales for int8) over 3.35 TB/s: about
// a microsecond a layer at the serving engine's shape (16 slots, 4 KV heads,
// D 64, depths up to 511, 3.9 MB in bf16), so what counts is how many rows
// are in flight at once, and the launches.
//
// Design: a grid (Hkv, B, S) whose block owns one span of kSpan keys of one
// slot and KV head; a block whose span starts past the slot's last live key
// exits at once. The serving shape puts 16 x 4 x 8 blocks on the card
// (those of live spans run). Each key's row is looked up in the slot's
// page-table row (any page size; a span need not align with pages; no page
// past the live range is read; a page index outside the pool is clamped
// into it). The block gathers its span's K rows (16-byte cp.async, D * elt
// bytes a row, the int8 row scales by 4-byte cp.async) as one stage and its
// V rows as a second, both in flight at once: V's gather overlaps the
// scores and the softmax, and the other resident blocks' gathers overlap
// this block's math. Staged rows are padded by 16 bytes, so the scores'
// 16-byte reads (a thread a (query head, key) pair) hit distinct banks. One
// warp a query head takes the span's max, p = exp(s - span max) (rounded to
// the pool dtype for float pools) and l; each thread sums up to 16 outputs
// of the group's [G, D] p @ v. The block writes its partial acc [G, D], m
// and l in fp32 to a workspace [B, Hq, S, D + 2]; paged_decode_merge_kernel,
// launched next from the same call, rescales the live spans' partials by
// exp(m_s - m) and sums them in span order (deterministic, no atomics),
// then writes acc / l rounded once to the output dtype. Only live spans are
// read, so a span with no live key contributes nothing. The pools must be
// 16-byte aligned (the wrapper checks).
//
// Plain C interface, loaded with ctypes: the launches run on the caller's
// stream, do not synchronise, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
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
  float* ws;             // [B, Hq, n_split, D + 2] partials
  int table_stride, n_pages, page_size, hkv, group, num_pages, n_split;
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

constexpr int kSpan = 64;  // keys a block (two a lane in the softmax)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// dot + q[0 .. n) . (the n values packed in w), summed in element order.
__device__ __forceinline__ float dot16(const uint4& w, const float* q, float dot, float) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) dot = fmaf(q[i], __uint_as_float(u[i]), dot);
  return dot;
}
__device__ __forceinline__ float dot16(const uint4& w, const float* q, float dot, __nv_bfloat16) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dot = fmaf(q[2 * i], __uint_as_float(u[i] << 16), dot);
    dot = fmaf(q[2 * i + 1], __uint_as_float(u[i] & 0xffff0000u), dot);
  }
  return dot;
}
__device__ __forceinline__ float dot16(const uint4& w, const float* q, float dot, int8_t) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
      dot = fmaf(q[4 * i + b], (float)(int8_t)(u[i] >> (8 * b)), dot);
  }
  return dot;
}

template <typename KV, int D>
constexpr int split_smem_bytes() {
  // K and V stages (padded rows), then q, p and the two scale rows in fp32.
  return 2 * kSpan * (D * (int)sizeof(KV) + 16) +
         4 * (kMaxGroup * D + kMaxGroup * kSpan + 2 * kSpan);
}

// One span of kSpan keys of slot b, KV head h: its partial acc [G, D], m and
// l into a.ws. KV: the pools' element type; Q: q's.
template <typename KV, typename Q, int D, bool kQuant>
__global__ void __launch_bounds__(kThreads) paged_decode_split_kernel(Args a) {
  constexpr int kRowBytes = D * (int)sizeof(KV);
  constexpr int kRow = kRowBytes + 16;       // a staged row's stride: bank-conflict free
  constexpr int kPieces = kRowBytes / 16;    // 16-byte copies a row
  constexpr int kPer = 16 / (int)sizeof(KV);  // elements a copy
  constexpr int kOut = kMaxGroup * D / kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* k_st = smem;
  unsigned char* v_st = k_st + kSpan * kRow;
  float* qs = reinterpret_cast<float*>(v_st + kSpan * kRow);  // [G][D]
  float* ps = qs + kMaxGroup * D;                              // [G][kSpan]
  float* ksc = ps + kMaxGroup * kSpan;
  float* vsc = ksc + kSpan;
  __shared__ int64_t rows[kSpan];
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup];

  const int h = blockIdx.x, b = blockIdx.y, span = blockIdx.z;
  const int n_keys = min(a.pos[b] + 1, a.n_pages * a.page_size);
  const int k0 = span * kSpan;
  if (k0 >= n_keys) return;  // the whole block: no live key in this span
  const int nk = min(kSpan, n_keys - k0);
  const int G = a.group, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int64_t head0 = ((int64_t)b * a.hkv + h) * G;  // first query head of the group
  const int32_t* table = a.table + (int64_t)b * a.table_stride;

  if (tid < kSpan) {
    int64_t r = 0;
    if (tid < nk) {
      const int key = k0 + tid;
      // A page index outside the pool is clamped into it, as the TPU
      // kernel's index maps clamp: the read stays inside the pool.
      const int page = min(max(table[key / a.page_size], 0), a.num_pages - 1);
      r = (int64_t)page * a.page_size + key % a.page_size;
    }
    rows[tid] = r;
  }
  __syncthreads();
  const unsigned char* kp = static_cast<const unsigned char*>(a.kp);
  const unsigned char* vp = static_cast<const unsigned char*>(a.vp);
  for (int i = tid; i < nk * kPieces; i += kThreads) {
    const int j = i / kPieces, c = i % kPieces;
    cp_async16(k_st + j * kRow + c * 16, kp + (rows[j] * a.hkv + h) * kRowBytes + c * 16);
  }
  if constexpr (kQuant) {
    if (tid < nk) cp_async4(ksc + tid, a.ks + rows[tid] * a.hkv + h);
  }
  cp_async_commit();
  for (int i = tid; i < nk * kPieces; i += kThreads) {
    const int j = i / kPieces, c = i % kPieces;
    cp_async16(v_st + j * kRow + c * 16, vp + (rows[j] * a.hkv + h) * kRowBytes + c * 16);
  }
  if constexpr (kQuant) {
    if (tid < nk) cp_async4(vsc + tid, a.vs + rows[tid] * a.hkv + h);
  }
  cp_async_commit();
  const Q* qb = static_cast<const Q*>(a.q) + head0 * D;
  for (int i = tid; i < G * D; i += kThreads) qs[i] = to_f32(qb[i]);
  cp_async_wait<1>();  // this thread's K copies have landed
  __syncthreads();     // and everyone's

  for (int i = tid; i < G * kSpan; i += kThreads) {
    const int g = i / kSpan, j = i % kSpan;
    float s = kNeg;
    if (j < nk) {
      const unsigned char* krow = k_st + j * kRow;
      const float* qg = qs + g * D;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kPieces; ++c)
        dot = dot16(*reinterpret_cast<const uint4*>(krow + c * 16), qg + c * kPer, dot, KV{});
      s = dot * a.scale;
      if constexpr (kQuant) s *= ksc[j];
    }
    ps[g * kSpan + j] = s;
  }
  __syncthreads();
  for (int g = warp; g < G; g += kThreads / 32) {
    float* row = ps + g * kSpan;
    const float s0 = row[lane], s1 = row[lane + 32];
    const float m = warp_max(fmaxf(s0, s1));
    const float p0 = lane < nk ? expf(s0 - m) : 0.f;
    const float p1 = lane + 32 < nk ? expf(s1 - m) : 0.f;
    const float l = warp_sum(p0 + p1);
    if constexpr (kQuant) {
      row[lane] = p0;  // times v_scale in p @ v, once the V stage has landed
      row[lane + 32] = p1;
    } else {
      row[lane] = round_to<KV>(p0);
      row[lane + 32] = round_to<KV>(p1);
    }
    if (lane == 0) {
      m_s[g] = m;
      l_s[g] = l;
    }
  }
  cp_async_wait<0>();  // the V stage
  __syncthreads();

  float* ws = a.ws + (head0 * a.n_split + span) * (D + 2);  // head g at + g * n_split * (D + 2)
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    const int idx = tid + o * kThreads;
    if (idx < G * D) {
      const int g = idx / D, d = idx % D;
      const float* p = ps + g * kSpan;
      float dot = 0.f;
      for (int j = 0; j < nk; ++j) {
        float pj = p[j];
        if constexpr (kQuant) pj *= vsc[j];
        dot = fmaf(pj, to_f32(reinterpret_cast<const KV*>(v_st + j * kRow)[d]), dot);
      }
      float* w = ws + (int64_t)g * a.n_split * (D + 2);
      w[d] = dot;
      if (d == 0) {
        w[D] = m_s[g];
        w[D + 1] = l_s[g];
      }
    }
  }
}

// out [B, Hq, D] from the live spans' partials of each (slot, query head):
// rescaled by exp(m_s - m) and summed in span order, then acc / l rounded
// once. Grid (Hq, B), D threads.
template <typename Out, int D>
__global__ void __launch_bounds__(D) paged_decode_merge_kernel(Args a) {
  const int hq = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int n_keys = min(a.pos[b] + 1, a.n_pages * a.page_size);
  const int live = (n_keys + kSpan - 1) / kSpan;
  const int64_t head = (int64_t)b * a.hkv * a.group + hq;
  const float* w = a.ws + head * a.n_split * (D + 2);
  float m = kNeg;
  for (int s = 0; s < live; ++s) m = fmaxf(m, w[s * (D + 2) + D]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < live; ++s) {
    const float* ws = w + s * (D + 2);
    const float c = expf(ws[D] - m);
    l = fmaf(c, ws[D + 1], l);
    acc = fmaf(c, ws[d], acc);
  }
  static_cast<Out*>(a.out)[head * D + d] = from_f32<Out>(acc / l);
}

template <typename KV, typename Q, typename Out, bool kQuant, int D>
cudaError_t launch_split_d(const Args& a, int B, cudaStream_t stream, int64_t* launches) {
  constexpr int smem = split_smem_bytes<KV, D>();
  // Once per instance (thread-safe static init): above 48 KB needs opting in.
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_decode_split_kernel<KV, Q, D, kQuant>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return attr;
  paged_decode_split_kernel<KV, Q, D, kQuant>
      <<<dim3((unsigned)a.hkv, (unsigned)B, (unsigned)a.n_split), kThreads, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launches;
  paged_decode_merge_kernel<Out, D>
      <<<dim3((unsigned)(a.hkv * a.group), (unsigned)B), D, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launches;
  return err;
}

template <typename KV, typename Q, typename Out, bool kQuant>
cudaError_t launch_split(const Args& a, int B, int D, cudaStream_t stream, int64_t* launches) {
  switch (D) {
    case 32: return launch_split_d<KV, Q, Out, kQuant, 32>(a, B, stream, launches);
    case 64: return launch_split_d<KV, Q, Out, kQuant, 64>(a, B, stream, launches);
    case 128: return launch_split_d<KV, Q, Out, kQuant, 128>(a, B, stream, launches);
    default: return cudaErrorInvalidValue;
  }
}

Args make_args(const void* q, const void* kp, const void* vp, const void* ks, const void* vs,
               const void* table, const void* pos, void* out, int64_t hkv, int64_t group,
               int64_t D, int64_t page_size, int64_t num_pages, int64_t table_stride,
               int64_t n_pages) {
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
  return a;
}

bool bad_shape(int64_t B, int64_t group, int64_t page_size, int64_t num_pages, int64_t n_pages) {
  return group < 1 || group > kMaxGroup || page_size < 1 || num_pages < 1 || n_pages < 1 ||
         B > 65535;
}

}  // namespace

// out [B, Hq, D] from q [B, Hq, D] and the pools of num_pages pages; kv_kind
// 0 = fp32 pools (q fp32), 1 = bf16 pools (q bf16), 2 = int8 pools with fp32
// row-scale pools (q fp32, or bf16 if q_bf16 != 0; out in q's dtype). All
// contiguous, the pools 16-byte aligned; table [B, table_stride] int32, of
// which the first n_pages columns are read; pos [B] int32; ws an fp32
// workspace of B * Hq * n_split * (D + 2) floats, n_split = ceil(n_pages *
// page_size / span); span must be the kernel's kSpan. Two launches, the
// spans then the merge; their number goes to *launches.
extern "C" int paged_attention_split(const void* q, const void* kp, const void* vp,
                                     const void* ks, const void* vs, const void* table,
                                     const void* pos, void* out, void* ws, int64_t B, int64_t hkv,
                                     int64_t group, int64_t D, int64_t page_size,
                                     int64_t num_pages, int64_t table_stride, int64_t n_pages,
                                     int64_t kv_kind, int64_t q_bf16, int64_t span,
                                     void* stream, int64_t* launches) {
  *launches = 0;
  if (B <= 0 || hkv <= 0) return 0;
  const int64_t n_split = (n_pages * page_size + kSpan - 1) / kSpan;
  if (bad_shape(B, group, page_size, num_pages, n_pages) || span != kSpan || n_split > 65535)
    return (int)cudaErrorInvalidValue;
  Args a = make_args(q, kp, vp, ks, vs, table, pos, out, hkv, group, D, page_size, num_pages,
                     table_stride, n_pages);
  a.ws = static_cast<float*>(ws);
  a.n_split = (int)n_split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = (int)B, d = (int)D;
  if (kv_kind == 0) return (int)launch_split<float, float, float, false>(a, b, d, s, launches);
  if (kv_kind == 1)
    return (int)launch_split<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16, false>(a, b, d, s,
                                                                                   launches);
  if (kv_kind == 2)
    return q_bf16 ? (int)launch_split<int8_t, __nv_bfloat16, __nv_bfloat16, true>(a, b, d, s,
                                                                                   launches)
                  : (int)launch_split<int8_t, float, float, true>(a, b, d, s, launches);
  return (int)cudaErrorInvalidValue;
}
