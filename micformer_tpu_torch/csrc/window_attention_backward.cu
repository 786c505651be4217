// Window-attention backward for Hopper (sm_90a): the gradient of
// out = softmax(q k^T * scale) v per (window, head), for both attention kernels.
//
// Replaces the backward halves of the two TPU window-attention kernels, which
// the JAX package writes as f32 einsums around its Pallas forwards:
//   - window_attention_backward: `_v2_bwd` of
//     micformer_tpu/ops/pallas/window_attention_v2.py (K1's gradient) on
//     [N, T, h, d] operands, Tq, Tk <= 16;
//   - fused_window_attention_backward: `_bwd` of
//     micformer_tpu/ops/pallas/window_attention.py (K2's gradient) on
//     [N, h, T, d] operands, T <= 32.
// One kernel serves both: every operand is addressed through its (window,
// token, head) element strides with a dense feature axis, so the two layouts,
// and q/k/v taken as slices of a fused projection, differ only in the strides
// the wrapper passes.
//
// Math, per (window, head), f32 throughout, rounded once to the input dtype:
//   P = softmax(s q k^T), dV = P^T g, dP = g v^T,
//   dS = P o (dP - rowsum(P o dP)), dQ = s dS K, dK = s dS^T Q.
//
// Bound: memory. A call reads q, k, v and g once and writes dq, dk and dv
// once, 7 N T h d elements; the arithmetic is about 10 T^2 d flops per
// (window, head), a few flops per byte, far below the card's balance. At the
// training stage-0 shape [4096, 8, 3, 16] in bf16 that is 22 MB, 6.6 us at
// 3.35 TB/s.
//
// Design: one thread per (window, head, query row), ordered query-row
// fastest, so the Tq threads of one (window, head) are neighbours in one
// block. Each thread walks the feature axis in chunks, recomputing its row of
// logits from its q row and the Tk key rows and its row of dP from its g row
// and the value rows, both held in registers (at most 32 floats each). It
// writes its dQ row and leaves its P and dS rows in shared memory. After one
// barrier, thread t of the group reduces key rows t, t + Tq, ... over the
// group's query rows, dV_j = sum_i P_ij g_i and dK_j = s sum_i dS_ij q_i,
// reading the P and dS columns from shared memory and the q and g rows again
// (L1 and L2 hits: the group's threads read them just before). Each output
// row is written once by one thread, with no atomics. Rows move in 16-byte
// chunks when every row start is 16-byte aligned, else element by element.
// Tensor-core products and keeping q and g rows in shared memory are left
// for later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;

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

// W elements to f32 registers: one 16-byte load when W * sizeof(T) == 16.
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

template <typename T, int W, int MAXT>
__global__ void __launch_bounds__(kBlock)
attention_backward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ g,
                          T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                          int64_t pairs, int tq, int tk, int h, int d,
                          Layout lq, Layout lk, Layout lv, Layout lg,
                          Layout ldq, Layout ldk, Layout ldv, float scale) {
  extern __shared__ float smem[];  // P rows, then dS rows: [2][groups * tq][tk]
  const int groups = blockDim.x / tq;
  const int grp = threadIdx.x / tq;
  const int row = threadIdx.x % tq;
  const int64_t pair = static_cast<int64_t>(blockIdx.x) * groups + grp;  // n * h + head
  const bool valid = pair < pairs;
  const int64_t n = valid ? pair / h : 0;
  const int head = valid ? static_cast<int>(pair % h) : 0;
  float* sP = smem + static_cast<size_t>(grp) * tq * tk;
  float* sdS = sP + static_cast<size_t>(groups) * tq * tk;

  const T* kb = k + n * lk.n + head * lk.h;
  const T* vb = v + n * lv.n + head * lv.h;

  if (valid) {
    const T* qr = q + n * lq.n + row * lq.t + head * lq.h;
    const T* gr = g + n * lg.n + row * lg.t + head * lg.h;
    float p[MAXT], ds[MAXT];
#pragma unroll
    for (int j = 0; j < MAXT; ++j) p[j] = ds[j] = 0.f;
    // logits (in p) and dP = g v^T (in ds), one feature chunk at a time
    for (int c = 0; c < d; c += W) {
      float qc[W], gc[W];
      load_chunk<T, W>(qr + c, qc);
      load_chunk<T, W>(gr + c, gc);
#pragma unroll
      for (int e = 0; e < W; ++e) qc[e] *= scale;
#pragma unroll
      for (int j = 0; j < MAXT; ++j) {
        if (j < tk) {
          float kc[W], vc[W];
          load_chunk<T, W>(kb + j * lk.t + c, kc);
          load_chunk<T, W>(vb + j * lv.t + c, vc);
#pragma unroll
          for (int e = 0; e < W; ++e) {
            p[j] = fmaf(qc[e], kc[e], p[j]);
            ds[j] = fmaf(gc[e], vc[e], ds[j]);
          }
        }
      }
    }
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < MAXT; ++j) if (j < tk) m = fmaxf(m, p[j]);
    float denom = 0.f;
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
      p[j] = j < tk ? expf(p[j] - m) : 0.f;
      denom += p[j];
    }
    const float inv = 1.f / denom;
    float rowsum = 0.f;
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
      p[j] *= inv;
      rowsum = fmaf(p[j], ds[j], rowsum);
    }
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
      ds[j] = p[j] * (ds[j] - rowsum);
      if (j < tk) {
        sP[row * tk + j] = p[j];
        sdS[row * tk + j] = ds[j];
      }
    }
    // dQ = s dS K
    T* dqr = dq + n * ldq.n + row * ldq.t + head * ldq.h;
    for (int c = 0; c < d; c += W) {
      float acc[W];
#pragma unroll
      for (int e = 0; e < W; ++e) acc[e] = 0.f;
#pragma unroll
      for (int j = 0; j < MAXT; ++j) {
        if (j < tk) {
          float kc[W];
          load_chunk<T, W>(kb + j * lk.t + c, kc);
#pragma unroll
          for (int e = 0; e < W; ++e) acc[e] = fmaf(ds[j], kc[e], acc[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < W; ++e) acc[e] *= scale;
      store_chunk<T, W>(dqr + c, acc);
    }
  }
  __syncthreads();
  if (!valid) return;

  // dV_j = sum_i P_ij g_i and dK_j = s sum_i dS_ij q_i for key rows j = row, row + tq, ...
  const T* qb = q + n * lq.n + head * lq.h;
  const T* gb = g + n * lg.n + head * lg.h;
  for (int j = row; j < tk; j += tq) {
    T* dvr = dv + n * ldv.n + j * ldv.t + head * ldv.h;
    T* dkr = dk + n * ldk.n + j * ldk.t + head * ldk.h;
    for (int c = 0; c < d; c += W) {
      float av[W], ak[W];
#pragma unroll
      for (int e = 0; e < W; ++e) av[e] = ak[e] = 0.f;
      for (int i = 0; i < tq; ++i) {
        const float pij = sP[i * tk + j];
        const float sij = sdS[i * tk + j];
        float qc[W], gc[W];
        load_chunk<T, W>(qb + i * lq.t + c, qc);
        load_chunk<T, W>(gb + i * lg.t + c, gc);
#pragma unroll
        for (int e = 0; e < W; ++e) {
          av[e] = fmaf(pij, gc[e], av[e]);
          ak[e] = fmaf(sij, qc[e], ak[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < W; ++e) ak[e] *= scale;
      store_chunk<T, W>(dvr + c, av);
      store_chunk<T, W>(dkr + c, ak);
    }
  }
}

template <typename T, int W, int MAXT>
cudaError_t launch(const void* const* ptrs, int64_t n, int tq, int tk, int h, int d,
                   const Layout* l, float scale, cudaStream_t stream) {
  const int groups = kBlock / tq;
  const int threads = groups * tq;
  const int64_t pairs = n * h;
  const int64_t blocks = (pairs + groups - 1) / groups;
  const size_t shmem = 2 * static_cast<size_t>(threads) * tk * sizeof(float);
  attention_backward_kernel<T, W, MAXT><<<static_cast<unsigned>(blocks), threads, shmem, stream>>>(
      static_cast<const T*>(ptrs[0]), static_cast<const T*>(ptrs[1]),
      static_cast<const T*>(ptrs[2]), static_cast<const T*>(ptrs[3]),
      static_cast<T*>(const_cast<void*>(ptrs[4])), static_cast<T*>(const_cast<void*>(ptrs[5])),
      static_cast<T*>(const_cast<void*>(ptrs[6])), pairs, tq, tk, h, d,
      l[0], l[1], l[2], l[3], l[4], l[5], l[6], scale);
  return cudaGetLastError();
}

// 16-byte chunks when the feature count and every row start allow them.
template <typename T>
bool vectorizable(const void* const* ptrs, int d, const Layout* l) {
  constexpr int per = 16 / sizeof(T);
  if (d % per) return false;
  for (int i = 0; i < 7; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
    if ((l[i].n * sizeof(T)) % 16 || (l[i].t * sizeof(T)) % 16 || (l[i].h * sizeof(T)) % 16)
      return false;
  }
  return true;
}

template <int MAXT>
int backward(const void* q, const void* k, const void* v, const void* g, void* dq,
             void* dk, void* dv, long long n, int tq, int tk, int h, int d,
             const long long* strides, float scale, int dtype, void* stream) {
  if (n <= 0 || tq < 1 || tq > MAXT || tk < 1 || tk > MAXT || h < 1 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[7] = {q, k, v, g, dq, dk, dv};
  Layout l[7];
  for (int i = 0; i < 7; ++i) l[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = vectorizable<float>(ptrs, d, l)
              ? launch<float, 4, MAXT>(ptrs, n, tq, tk, h, d, l, scale, s)
              : launch<float, 1, MAXT>(ptrs, n, tq, tk, h, d, l, scale, s);
  else if (dtype == 1)
    err = vectorizable<__nv_bfloat16>(ptrs, d, l)
              ? launch<__nv_bfloat16, 8, MAXT>(ptrs, n, tq, tk, h, d, l, scale, s)
              : launch<__nv_bfloat16, 1, MAXT>(ptrs, n, tq, tk, h, d, l, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

// Both entry points: q, k, v, g and the outputs dq, dk, dv addressed as
// [N, T, h, d] through `strides`, 21 element strides (window, token, head)
// for q, k, v, g, dq, dk, dv in that order, the feature axis dense.
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments the kernel does not take.
// Launches on `stream`, allocates nothing and does not synchronise.
extern "C" int window_attention_backward(const void* q, const void* k, const void* v,
                                         const void* g, void* dq, void* dk, void* dv,
                                         long long n, int tq, int tk, int h, int d,
                                         const long long* strides, float scale,
                                         int dtype, void* stream) {
  return backward<16>(q, k, v, g, dq, dk, dv, n, tq, tk, h, d, strides, scale, dtype, stream);
}

extern "C" int fused_window_attention_backward(const void* q, const void* k, const void* v,
                                               const void* g, void* dq, void* dk, void* dv,
                                               long long n, int tq, int tk, int h, int d,
                                               const long long* strides, float scale,
                                               int dtype, void* stream) {
  return backward<32>(q, k, v, g, dq, dk, dv, n, tq, tk, h, d, strides, scale, dtype, stream);
}
