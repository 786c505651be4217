// Tiny-window attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel micformer_tpu/ops/pallas/window_attention_v2.py
// (`_kernel` / `_v2_forward`, reached from `window_attention_v2`): per window
// and head, out = softmax(q k^T * scale) v on [N, T, h, d] operands, with no
// bias and no mask. Every attention of the MicFormer serving path has this
// shape (T = 8, d = 16, h = 3..24, N up to 16384 windows at sw_batch 4).
//
// Bound: memory. Each call reads q, k, v once and writes out once, 4 * N*T*h*d
// elements; the arithmetic is 4*T*d multiply-adds per (window, head, query
// row), a few hundred FLOP per 16-byte row, far below the card's
// operations-per-byte balance. At the stage-0 shape in bf16 the call moves
// 50.3 MB, about 15 us at 3.35 TB/s.
//
// Design: one thread per (window, query row, head). The thread keeps its q
// row, the Tk <= 16 logits and its output row in registers (f32), reads the
// key and value rows of its window and head with 16-byte vector loads, and
// writes its output row once. Threads are ordered head-fastest, then query
// row, then window, so the q loads and out stores of a warp are one
// contiguous span and the k/v rows of a window are shared through L1 by the
// Tq threads of that window. The TPU kernel's token-major [T, 512, h*d]
// relayout and per-head lane masks answered the TPU's 128-lane registers and
// are not carried over. Shared-memory staging and tensor-core products are
// left for later work.
//
// Layout: q is [N, Tq, h, d] and k, v are [N, Tk, h, d] with the head and
// feature axes dense and the window and token axes collapsible to one row
// stride (token row r = n*T + t starts at r * row_stride elements), which
// covers contiguous tensors and the q/k/v slices of a fused projection.
// out is contiguous [N, Tq, h, d]. Logits, softmax and accumulation are f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxT = 16;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Load D elements (16-byte aligned) into f32 registers with 16-byte loads.
template <typename T, int D>
__device__ __forceinline__ void load_row(const T* __restrict__ p, float (&r)[D]) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < D; i += kPer) {
    uint4 raw = __ldg(reinterpret_cast<const uint4*>(p + i));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kPer; ++j) r[i + j] = to_float(e[j]);
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_row(T* __restrict__ p, const float (&r)[D]) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < D; i += kPer) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < kPer; ++j) e[j] = from_float<T>(r[i + j]);
    *reinterpret_cast<uint4*>(p + i) = raw;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out,
                        int64_t n_windows, int tq, int tk, int h,
                        int64_t q_row, int64_t k_row, int64_t v_row,
                        float scale) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t total = n_windows * tq * h;
  if (idx >= total) return;
  const int head = static_cast<int>(idx % h);
  const int64_t qrow = idx / h;               // n * tq + t
  const int64_t n = qrow / tq;

  float qv[D];
  load_row<T, D>(q + qrow * q_row + head * D, qv);
#pragma unroll
  for (int i = 0; i < D; ++i) qv[i] *= scale;

  const T* kbase = k + n * tk * k_row + head * D;
  const T* vbase = v + n * tk * v_row + head * D;

  float logit[kMaxT];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kMaxT; ++j) {
    if (j < tk) {
      float kv[D];
      load_row<T, D>(kbase + j * k_row, kv);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) s = fmaf(qv[i], kv[i], s);
      logit[j] = s;
      m = fmaxf(m, s);
    }
  }

  float acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) acc[i] = 0.f;
  float denom = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxT; ++j) {
    if (j < tk) {
      const float p = expf(logit[j] - m);
      denom += p;
      float vv[D];
      load_row<T, D>(vbase + j * v_row, vv);
#pragma unroll
      for (int i = 0; i < D; ++i) acc[i] = fmaf(p, vv[i], acc[i]);
    }
  }
  const float inv = 1.f / denom;
#pragma unroll
  for (int i = 0; i < D; ++i) acc[i] *= inv;
  store_row<T, D>(out + idx * D, acc);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int64_t n, int tq, int tk, int h, int64_t q_row,
                   int64_t k_row, int64_t v_row, float scale,
                   cudaStream_t stream) {
  const int64_t total = n * tq * h;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  window_attention_kernel<T, D><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), n, tq, tk, h, q_row, k_row, v_row, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out,
                       int64_t n, int tq, int tk, int h, int d, int64_t q_row,
                       int64_t k_row, int64_t v_row, float scale,
                       cudaStream_t stream) {
  switch (d) {
    case 8:  return launch<T, 8>(q, k, v, out, n, tq, tk, h, q_row, k_row, v_row, scale, stream);
    case 16: return launch<T, 16>(q, k, v, out, n, tq, tk, h, q_row, k_row, v_row, scale, stream);
    case 32: return launch<T, 32>(q, k, v, out, n, tq, tk, h, q_row, k_row, v_row, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, n, tq, tk, h, q_row, k_row, v_row, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments the kernel does not take.
// Launches on `stream`, allocates nothing and does not synchronise.
extern "C" int window_attention_forward(const void* q, const void* k,
                                        const void* v, void* out,
                                        long long n, int tq, int tk, int h,
                                        int d, long long q_row,
                                        long long k_row, long long v_row,
                                        float scale, int dtype, void* stream) {
  if (n <= 0 || tq < 1 || tq > kMaxT || tk < 1 || tk > kMaxT || h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(q, k, v, out, n, tq, tk, h, d, q_row, k_row, v_row, scale, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(q, k, v, out, n, tq, tk, h, d, q_row, k_row, v_row, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
