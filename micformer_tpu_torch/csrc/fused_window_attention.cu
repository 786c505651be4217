// Fused window attention forward for Hopper (sm_90a): out = softmax(q k^T *
// scale) v per (window, head) on [N, h, T, d] operands, no bias, no mask.
//
// Replaces the TPU kernel micformer_tpu/ops/pallas/window_attention.py
// (`_kernel` / `_pallas_forward`, reached from `fused_window_attention`). The
// TPU kernel packs G = 128 / T (window, head) pairs into one 128-row tile,
// computes one dense 128 x 128 score matrix on the MXU, and masks the
// cross-window products with -1e30, which its f32 exp turns into exact zeros.
// Here the cross-window products are simply not computed: each thread
// evaluates only its own query row's T logits, which gives the same result.
//
// Contract: q, k, v are [N, h, T, d] with any strides of which the feature
// axis is dense (the port hands the kernel transposed views of the [N, T, h,
// d] slices of a fused projection); T <= 32 with 128 % T == 0, d <= 128;
// float32 or bfloat16. out has the strides the wrapper allocates. Logits,
// softmax and PV are f32; the softmax is normalised before the PV product,
// as the TPU kernel does.
//
// Bound: memory. A call reads q, k, v once and writes out once, 4 N h T d
// elements, with 4 T d flops per query row. At the training stage-0 shape
// [4096, 3, 8, 16] in bf16 that is 12.6 MB, 3.8 us at 3.35 TB/s.
//
// Design: one block of 128 threads per 128-row tile of G = 128 / T pairs,
// one thread per query row. The block stages the tile's key and value rows in
// shared memory as f32 (16-byte loads when every row start is 16-byte
// aligned), then each thread streams its q row from device memory in chunks,
// accumulates its T logits in registers, and writes its output row once.
// Tensor-core packing (mma / wgmma on 16- or 64-row tiles) is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;
constexpr int kMaxT = 32;

struct Layout {
  int64_t n, t, h;  // element strides of the window, token and head axes
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int W>
__device__ __forceinline__ void load_chunk(const T* __restrict__ p, float (&r)[W]) {
  if constexpr (W * sizeof(T) == 16) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < W; ++j) r[j] = to_float(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) r[j] = to_float(p[j]);
  }
}

template <typename T, int W>
__device__ __forceinline__ void store_chunk(T* __restrict__ p, const float (&r)[W]) {
  if constexpr (W * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < W; ++j) e[j] = from_float<T>(r[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) p[j] = from_float<T>(r[j]);
  }
}

// W f32 values from shared memory (16-byte reads when W is a multiple of 4;
// rows are padded to a multiple of 4 floats, so such chunks are aligned).
template <int W>
__device__ __forceinline__ void load_shared(const float* p, float (&r)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int j = 0; j < W; j += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + j);
      r[j] = x.x; r[j + 1] = x.y; r[j + 2] = x.z; r[j + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) r[j] = p[j];
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(kRows)
fused_window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, T* __restrict__ out,
                              int64_t pairs, int h, int t, int d, int ld,
                              Layout lq, Layout lk, Layout lv, Layout lo, float scale) {
  extern __shared__ float smem[];  // keys then values: [2][kRows][ld] f32
  float* sK = smem;
  float* sV = smem + kRows * ld;
  const int per_tile = kRows / t;
  const int64_t pair0 = static_cast<int64_t>(blockIdx.x) * per_tile;

  // stage the tile's key and value rows; rows past the last pair are zeros
  const int chunks = d / W;
  for (int idx = threadIdx.x; idx < kRows * chunks; idx += kRows) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * W;
    const int64_t pair = pair0 + r / t;
    float kc[W], vc[W];
    if (pair < pairs) {
      const int64_t n = pair / h;
      const int head = static_cast<int>(pair % h);
      const int tok = r % t;
      load_chunk<T, W>(k + n * lk.n + tok * lk.t + head * lk.h + c, kc);
      load_chunk<T, W>(v + n * lv.n + tok * lv.t + head * lv.h + c, vc);
    } else {
#pragma unroll
      for (int e = 0; e < W; ++e) kc[e] = vc[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < W; ++e) {
      sK[r * ld + c + e] = kc[e];
      sV[r * ld + c + e] = vc[e];
    }
  }
  __syncthreads();

  const int r = threadIdx.x;
  const int64_t pair = pair0 + r / t;
  if (pair >= pairs) return;
  const int64_t n = pair / h;
  const int head = static_cast<int>(pair % h);
  const int tok = r % t;
  const float* kw = sK + (r / t) * t * ld;   // this window's key rows
  const float* vw = sV + (r / t) * t * ld;

  float logit[kMaxT];
#pragma unroll
  for (int j = 0; j < kMaxT; ++j) logit[j] = 0.f;
  const T* qr = q + n * lq.n + tok * lq.t + head * lq.h;
  for (int c = 0; c < d; c += W) {
    float qc[W];
    load_chunk<T, W>(qr + c, qc);
#pragma unroll
    for (int e = 0; e < W; ++e) qc[e] *= scale;
#pragma unroll
    for (int j = 0; j < kMaxT; ++j) {
      if (j < t) {
        float kc[W];
        load_shared<W>(kw + j * ld + c, kc);
#pragma unroll
        for (int e = 0; e < W; ++e) logit[j] = fmaf(qc[e], kc[e], logit[j]);
      }
    }
  }
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kMaxT; ++j) if (j < t) m = fmaxf(m, logit[j]);
  float denom = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxT; ++j) {
    logit[j] = j < t ? expf(logit[j] - m) : 0.f;
    denom += logit[j];
  }
  const float inv = 1.f / denom;
#pragma unroll
  for (int j = 0; j < kMaxT; ++j) logit[j] *= inv;

  T* orow = out + n * lo.n + tok * lo.t + head * lo.h;
  for (int c = 0; c < d; c += W) {
    float acc[W];
#pragma unroll
    for (int e = 0; e < W; ++e) acc[e] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxT; ++j) {
      if (j < t) {
        float vc[W];
        load_shared<W>(vw + j * ld + c, vc);
#pragma unroll
        for (int e = 0; e < W; ++e) acc[e] = fmaf(logit[j], vc[e], acc[e]);
      }
    }
    store_chunk<T, W>(orow + c, acc);
  }
}

template <typename T, int W>
cudaError_t launch(const void* const* ptrs, int64_t n, int h, int t, int d,
                   const Layout* l, float scale, cudaStream_t stream) {
  const int ld = (d + 3) / 4 * 4;
  const size_t shmem = 2 * static_cast<size_t>(kRows) * ld * sizeof(float);
  auto kernel = fused_window_attention_kernel<T, W>;
  if (shmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shmem));
    if (err != cudaSuccess) return err;
  }
  const int64_t pairs = n * h;
  const int per_tile = kRows / t;
  const int64_t blocks = (pairs + per_tile - 1) / per_tile;
  kernel<<<static_cast<unsigned>(blocks), kRows, shmem, stream>>>(
      static_cast<const T*>(ptrs[0]), static_cast<const T*>(ptrs[1]),
      static_cast<const T*>(ptrs[2]), static_cast<T*>(const_cast<void*>(ptrs[3])),
      pairs, h, t, d, ld, l[0], l[1], l[2], l[3], scale);
  return cudaGetLastError();
}

template <typename T>
bool vectorizable(const void* const* ptrs, int d, const Layout* l) {
  constexpr int per = 16 / sizeof(T);
  if (d % per) return false;
  for (int i = 0; i < 4; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
    if ((l[i].n * sizeof(T)) % 16 || (l[i].t * sizeof(T)) % 16 || (l[i].h * sizeof(T)) % 16)
      return false;
  }
  return true;
}

}  // namespace

// q, k, v and out addressed as [N, h, T, d] through `strides`, 12 element
// strides (window, token, head) for q, k, v, out in that order, the feature
// axis dense. dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments the kernel does
// not take. Launches on `stream`, allocates nothing and does not synchronise.
extern "C" int fused_window_attention_forward(const void* q, const void* k, const void* v,
                                              void* out, long long n, int h, int t, int d,
                                              const long long* strides, float scale,
                                              int dtype, void* stream) {
  if (n <= 0 || h < 1 || t < 1 || t > kMaxT || kRows % t || d < 1 || d > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[4] = {q, k, v, out};
  Layout l[4];
  for (int i = 0; i < 4; ++i) l[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = vectorizable<float>(ptrs, d, l) ? launch<float, 4>(ptrs, n, h, t, d, l, scale, s)
                                          : launch<float, 1>(ptrs, n, h, t, d, l, scale, s);
  else if (dtype == 1)
    err = vectorizable<__nv_bfloat16>(ptrs, d, l)
              ? launch<__nv_bfloat16, 8>(ptrs, n, h, t, d, l, scale, s)
              : launch<__nv_bfloat16, 1>(ptrs, n, h, t, d, l, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
