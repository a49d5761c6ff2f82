// Weight gradient of a 3x3 SAME convolution (NCHW, no bias), stride 1 or 2.
//
// Replaces the TPU kernels cs744_pytorch_distributed_tutorial_tpu/ops/fused_conv.py
// _wgrad_kernel_s1 and _wgrad_kernel_s2 (launched from conv3x3_wgrad through
// pl.pallas_call). One kernel, templated on the stride, computes
//
//     dW^T[K, 9C] = G^T[K, M] . im2col[M, 9C],   M = B * Ho * Wo,
//     im2col[(b, y, x), c*9 + ky*3 + kx] = X[b, c, s*y + ky - p, s*x + kx - p]
//
// with p = 1 at stride 1 and p = 0 at stride 2 (flax SAME on even H, W pads
// (0, 1)), and zero where the input row or column falls outside the image.
// Column order c*9 + ky*3 + kx is OIHW, so the [K, 9C] result IS dW [K,C,3,3].
//
// What bounds it: at ResNet-18's routed shapes (batch 256: x [256,128,16,16]
// -> 128 and x [256,256,8,8] -> 256) each call does 19.33 GFLOP against about
// 68 MB read (x and g once each), some 285 operations a byte: it is bound by
// operations, not by memory. The design therefore keeps the card's FP32 units
// fed and moves no more bytes than it must:
//
// - Each block owns a 64 x 64 tile of the [K, 9C] output, and each of its 256
//   threads a 4 x 4 register tile, accumulated with FFMA in fp32. One stage of
//   16 rows of M costs every thread two 16-byte shared-memory loads per 16 FMA.
// - The im2col tile is gathered straight from NCHW x into shared memory with
//   the bounds mask, and never written to device memory (the TPU kernel keeps
//   it in VMEM for the same reason). For a fixed (b, c) neighbouring rows of M
//   are neighbouring x, so the gathers of x and of g coalesce.
// - The TPU kernel carries its accumulator over a sequential batch grid; here
//   blocks run in parallel, so M is split over gridDim.z into S slices (enough
//   blocks to fill every SM several times over) that write fp32 partials to a
//   workspace [S, K, 9C]; a second kernel sums them in a fixed order. No
//   atomics: the result is the same bits from run to run.
// - bf16 inputs are widened on load; products of bf16 values are exact in fp32.
//
// Left for later work: tensor cores (TF32 or bf16 mma/wgmma) and TMA loads,
// which lift the bound from 67 TFLOP/s (FP32) to 495 TFLOP/s (TF32).
//
// Plain C interface, loaded with ctypes: the launches run on the caller's
// stream, do not synchronise, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileK = 64;       // output rows (K) per block
constexpr int kTileN = 64;       // output columns (9C) per block
constexpr int kTileM = 16;       // rows of M per shared-memory stage
constexpr int kThreads = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int kLd = kTileN + 4;  // padded row: 16-byte aligned, 2-way store conflicts
constexpr int kMinRowsPerSplit = 256;
constexpr int kBlocksPerSm = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int kStride>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g,
             float* __restrict__ out, int B, int C, int H, int W, int K,
             int Ho, int Wo, int m_per_split) {
  static_assert(kTileK == kTileN, "one padded row length serves both tiles");
  constexpr int kPadLo = kStride == 1 ? 1 : 0;
  __shared__ __align__(16) float gs[kTileM][kLd];
  __shared__ __align__(16) float xs[kTileM][kLd];

  const int tid = threadIdx.x;
  const int n_total = 9 * C;
  const int hw = H * W;
  const int howo = Ho * Wo;
  const int m_total = B * howo;
  const int n0 = blockIdx.x * kTileN;
  const int k0 = blockIdx.y * kTileK;
  const int m_begin = blockIdx.z * m_per_split;
  const int m_end = min(m_total, m_begin + m_per_split);

  // Loader role: thread loads stage row lm, at tile columns (of x) and
  // tile rows (of g) lr + 16 r. What depends only on the column is fixed
  // for the whole block, so it is worked out once here.
  const int lm = tid % kTileM;
  const int lr = tid / kTileM;
  int x_off[4], x_dy[4], x_dx[4], g_off[4];
  bool x_ok[4], g_ok[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = n0 + lr + 16 * r;
    const int c = n / 9;
    const int t = n - 9 * c;
    x_ok[r] = n < n_total;
    x_off[r] = c * hw;
    x_dy[r] = t / 3 - kPadLo;
    x_dx[r] = t % 3 - kPadLo;
    const int k = k0 + lr + 16 * r;
    g_ok[r] = k < K;
    g_off[r] = k * howo;
  }

  // Compute role: output rows k0 + ty*4 + i, columns n0 + tx*4 + j.
  const int ty = tid / 16;
  const int tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int m0 = m_begin; m0 < m_end; m0 += kTileM) {
    const int m = m0 + lm;
    const bool m_ok = m < m_end;
    int b = 0, y = 0, xo = 0;
    if (m_ok) {
      b = m / howo;
      const int pix = m - b * howo;
      y = pix / Wo;
      xo = pix - y * Wo;
    }
    const T* xb = x + (int64_t)b * C * hw;
    const T* gb = g + (int64_t)b * K * howo + (y * Wo + xo);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int yi = kStride * y + x_dy[r];
      const int xi = kStride * xo + x_dx[r];
      float v = 0.f;
      if (m_ok && x_ok[r] && yi >= 0 && yi < H && xi >= 0 && xi < W)
        v = to_f32(xb[x_off[r] + yi * W + xi]);
      xs[lm][lr + 16 * r] = v;
      gs[lm][lr + 16 * r] = (m_ok && g_ok[r]) ? to_f32(gb[g_off[r]]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kTileM; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(&gs[i][ty * 4]);
      const float4 v = *reinterpret_cast<const float4*>(&xs[i][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = fmaf(av[ii], vv[jj], acc[ii][jj]);
    }
    __syncthreads();
  }

  float* o = out + (int64_t)blockIdx.z * K * n_total;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int k = k0 + ty * 4 + ii;
    if (k >= K) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + tx * 4 + jj;
      if (n < n_total) o[(int64_t)k * n_total + n] = acc[ii][jj];
    }
  }
}

// out[i] = sum over z of work[z][i], z in order: the same bits every run.
__global__ void sum_splits_kernel(const float* __restrict__ work,
                                  float* __restrict__ out, int64_t n,
                                  int splits) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += work[(int64_t)z * n + i];
    out[i] = s;
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

template <typename T, int kStride>
void launch(const void* x, const void* g, float* dst, int64_t B, int64_t C,
            int64_t H, int64_t W, int64_t K, int64_t splits,
            cudaStream_t stream) {
  const int64_t ho = H / kStride, wo = W / kStride;
  const int64_t m_total = B * ho * wo;
  const int64_t m_per_split = ceil_div(ceil_div(m_total, splits), kTileM) * kTileM;
  const dim3 grid((unsigned)ceil_div(9 * C, kTileN), (unsigned)ceil_div(K, kTileK),
                  (unsigned)splits);
  wgrad_kernel<T, kStride><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), dst, (int)B, (int)C,
      (int)H, (int)W, (int)K, (int)ho, (int)wo, (int)m_per_split);
}

}  // namespace

// How many slices of M the wgrad splits into for this problem: enough
// blocks for kBlocksPerSm on every SM, each slice at least
// kMinRowsPerSplit rows of M. The caller sizes the workspace from it.
extern "C" int64_t conv3x3_wgrad_splits(int64_t B, int64_t C, int64_t K,
                                        int64_t Ho, int64_t Wo, int64_t num_sms) {
  const int64_t tiles = ceil_div(9 * C, kTileN) * ceil_div(K, kTileK);
  const int64_t m_total = B * Ho * Wo;
  int64_t s = ceil_div(kBlocksPerSm * num_sms, tiles);
  const int64_t most = m_total / kMinRowsPerSplit;
  if (s > most) s = most;
  if (s > 1024) s = 1024;
  return s < 1 ? 1 : s;
}

// dW [K, C, 3, 3] fp32 into `out` from x [B, C, H, W] and g [B, K, H/s, W/s],
// both fp32 (bf16 == 0) or both bf16 (bf16 == 1). With splits > 1, `work`
// holds splits * K * 9C floats of partials; with splits == 1 it is unused.
extern "C" int conv3x3_wgrad(const void* x, const void* g, void* out, void* work,
                             int64_t B, int64_t C, int64_t H, int64_t W,
                             int64_t K, int64_t stride, int64_t bf16,
                             int64_t splits, void* stream) {
  if (B <= 0 || C <= 0 || K <= 0 || H <= 0 || W <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = splits > 1 ? static_cast<float*>(work) : static_cast<float*>(out);
  if (stride == 1) {
    if (bf16) launch<__nv_bfloat16, 1>(x, g, dst, B, C, H, W, K, splits, s);
    else launch<float, 1>(x, g, dst, B, C, H, W, K, splits, s);
  } else {
    if (bf16) launch<__nv_bfloat16, 2>(x, g, dst, B, C, H, W, K, splits, s);
    else launch<float, 2>(x, g, dst, B, C, H, W, K, splits, s);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return (int)err;
  const int64_t n = K * 9 * C;
  int64_t blocks = ceil_div(n, 256);
  if (blocks > 4096) blocks = 4096;
  sum_splits_kernel<<<(unsigned)blocks, 256, 0, s>>>(
      static_cast<const float*>(work), static_cast<float*>(out), n, (int)splits);
  return (int)cudaGetLastError();
}
