// Fused SGD(momentum, weight decay) update of a whole list of fp32
// parameter tensors, one kernel launch for the list.
//
// Replaces the TPU kernel cs744_pytorch_distributed_tutorial_tpu/ops/fused_sgd.py
// (_kernel, launched per leaf from _update_leaf through pl.pallas_call).
// Exact torch-SGD semantics, in fp32:
//
//     g' = g + wd * p
//     m' = mu * m + g'
//     p' = p - lr * m'
//
// What bounds it: an elementwise pass with 6 flops per element and 20
// bytes of traffic (read p, m, g; write p, m), so device-memory bandwidth:
// 0.0667 ms for ResNet-18's 11.17M parameters at 3.35 TB/s. A model's
// update is many tensors, most of them small (41 of ResNet-18's 62 are
// BatchNorm vectors or a bias of 10-512 elements), so one launch a tensor
// spends its time in launch gaps and host calls, not bytes.
//
// Design: one launch for a list of up to kMaxTensors tensors and
// kMaxBlocks blocks. Each block owns one chunk of kChunk elements (a
// multiple of 4) of one tensor; the ragged tail of a tensor stays in its
// last chunk. The host packs a (tensor, chunk) entry a block and the
// tensors' pointers and sizes into one kernel-parameter struct (under the
// classic 4 KB parameter limit): no table in device memory, no copy, no
// allocation. A list that exceeds one launch's capacity launches again
// with the next batch (a tensor may continue into the next launch: the
// table holds segments, a tensor's pointers advanced to the segment's
// first chunk). Alignment is decided per segment: the float4 path where
// p, m and g are all 16-byte aligned, else the scalar path for that
// block. Each thread keeps four float4 loads of each array in flight.
// p and m are updated IN PLACE, as the JAX kernel aliases its outputs onto
// its inputs (input_output_aliases={0: 0, 1: 1}). The Pallas kernel's
// (rows, 128) padding is a TPU tiling fact and is not carried over.
//
// The arithmetic uses the _rn intrinsics so that nvcc does not contract
// it into FMAs: each step rounds exactly as the plain PyTorch version
// (ops/fused_sgd.py::fused_sgd_plain) rounds it, so the two are bitwise
// equal.
//
// Plain C interface, loaded with ctypes: the launches run on the caller's
// stream, do not synchronise, and the entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;              // float4 loads of each array in flight a thread
constexpr int64_t kChunk = 32768;       // elements a block (a multiple of 4)
constexpr int kMaxTensors = 64;         // segments a launch
constexpr int kMaxBlocks = 640;         // blocks a launch

struct Table {
  float* p[kMaxTensors];
  float* m[kMaxTensors];
  const float* g[kMaxTensors];
  int64_t n[kMaxTensors];               // elements of the segment
  uint16_t chunk[kMaxBlocks];           // the block's chunk within its segment
  uint8_t seg[kMaxBlocks];              // the block's segment
  float lr, mu, wd;
};
static_assert(sizeof(Table) <= 4096, "kernel parameters must fit the classic 4 KB limit");
static_assert(kChunk % (4 * kThreads * kUnroll) == 0, "a chunk is whole float4 sweeps");
static_assert(kMaxTensors <= 256 && kMaxBlocks <= 65536, "entry fields are 8 and 16 bits");

__device__ __forceinline__ void sgd_one(float& p, float& m, float g, float lr,
                                        float mu, float wd) {
  const float ge = __fadd_rn(g, __fmul_rn(wd, p));
  m = __fadd_rn(__fmul_rn(mu, m), ge);
  p = __fsub_rn(p, __fmul_rn(lr, m));
}

__device__ __forceinline__ void sgd4(float4& p, float4& m, const float4& g, float lr,
                                     float mu, float wd) {
  sgd_one(p.x, m.x, g.x, lr, mu, wd);
  sgd_one(p.y, m.y, g.y, lr, mu, wd);
  sgd_one(p.z, m.z, g.z, lr, mu, wd);
  sgd_one(p.w, m.w, g.w, lr, mu, wd);
}

__global__ void __launch_bounds__(kThreads)
    fused_sgd_multi_kernel(const __grid_constant__ Table t) {
  const int s = t.seg[blockIdx.x];
  const int64_t start = (int64_t)t.chunk[blockIdx.x] * kChunk;
  const int64_t rest = t.n[s] - start;
  const int64_t len = rest < kChunk ? rest : kChunk;
  float* p = t.p[s] + start;
  float* m = t.m[s] + start;
  const float* g = t.g[s] + start;
  const float lr = t.lr, mu = t.mu, wd = t.wd;
  const bool aligned = ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(m) |
                         reinterpret_cast<uintptr_t>(g)) & 15u) == 0;
  int64_t done = 0;
  if (aligned) {
    const int64_t n_vec = len / 4;
    float4* p4 = reinterpret_cast<float4*>(p);
    float4* m4 = reinterpret_cast<float4*>(m);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (int64_t base = threadIdx.x; base < n_vec; base += kThreads * kUnroll) {
      float4 pv[kUnroll], mv[kUnroll], gv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = base + u * kThreads;
        if (i < n_vec) {
          pv[u] = p4[i];
          mv[u] = m4[i];
          gv[u] = __ldg(g4 + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = base + u * kThreads;
        if (i < n_vec) {
          sgd4(pv[u], mv[u], gv[u], lr, mu, wd);
          m4[i] = mv[u];
          p4[i] = pv[u];
        }
      }
    }
    done = 4 * n_vec;
  }
  for (int64_t i = done + threadIdx.x; i < len; i += kThreads) {
    float pv = p[i];
    float mv = m[i];
    sgd_one(pv, mv, g[i], lr, mu, wd);
    m[i] = mv;
    p[i] = pv;
  }
}

}  // namespace

// Updates n_tensors tensors: list[4 * i .. 4 * i + 3] = (p, m, g, numel) of
// tensor i, pointers as integers. Writes the number of kernel launches to
// *launches and returns cudaGetLastError() (0 on success).
extern "C" int fused_sgd_multi_f32(const int64_t* list, int64_t n_tensors, float lr, float mu,
                                   float wd, void* stream, int64_t* launches) {
  *launches = 0;
  Table t;
  t.lr = lr;
  t.mu = mu;
  t.wd = wd;
  int segs = 0, blocks = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&]() -> cudaError_t {
    fused_sgd_multi_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(t);
    ++*launches;
    segs = blocks = 0;
    return cudaGetLastError();
  };
  for (int64_t i = 0; i < n_tensors; ++i) {
    const int64_t n = list[4 * i + 3];
    const int64_t n_chunks = (n + kChunk - 1) / kChunk;
    for (int64_t c = 0; c < n_chunks;) {
      if (segs == kMaxTensors || blocks == kMaxBlocks) {
        const cudaError_t err = launch();
        if (err != cudaSuccess) return (int)err;
      }
      const int64_t off = c * kChunk;
      t.p[segs] = reinterpret_cast<float*>(list[4 * i]) + off;
      t.m[segs] = reinterpret_cast<float*>(list[4 * i + 1]) + off;
      t.g[segs] = reinterpret_cast<const float*>(list[4 * i + 2]) + off;
      t.n[segs] = n - off;
      int64_t take = n_chunks - c;
      if (take > kMaxBlocks - blocks) take = kMaxBlocks - blocks;
      for (int64_t k = 0; k < take; ++k) {
        t.seg[blocks] = (uint8_t)segs;
        t.chunk[blocks] = (uint16_t)k;
        ++blocks;
      }
      ++segs;
      c += take;
    }
  }
  return blocks > 0 ? (int)launch() : 0;
}
