// Depthwise k^3 convolution forward for Hopper (sm_90a): stride 1, SAME zero
// padding k/2, optional per-channel bias, k in {3, 5}.
//
// Replaces the TPU kernel micformer_tpu/ops/pallas/dw_stencil.py (`_kernel` /
// `_forward`, reached from `dw_conv3_pallas`): out[b,c,d,h,w] = bias[c] +
// sum over (dz,dy,dx) of w[c,dz,dy,dx] * x[b,c,d+dz-p,h+dy-p,w+dx-p], zeros
// outside the volume. Every stride-1 depthwise conv of MedNeXt's blocks has
// this shape; on the serving path x runs from [4, 32, 128^3] (stage 0) to
// [4, 512, 8^3] (bottleneck) at sw_batch 4.
//
// Layout: x and out are contiguous [B, C, D, H, W]; each (b, c) is an
// independent volume. w is the Conv3d depthwise weight [C, 1, k, k, k]
// (contiguous), bias is [C] or null; all share x's dtype (f32 or bf16).
// Accumulation is f32 in (dz, dy, dx) order, with one rounding on the store.
//
// Bound: close to balanced. Each call must read x once and write out once
// (2 * 2 bytes per output in bf16, 2 * 4 in f32) and does k^3 multiply-adds
// per output on CUDA cores (no tensor-core form: a depthwise conv has no
// reduction over channels). At stage 0 in bf16, [4, 32, 128^3], on an NVIDIA
// H100 80GB HBM3 at its 700 W limit (3.35 TB/s, 67 TFLOP/s f32 FMA): 1.07 GB
// take 320 us, 7.2 G FMA 216 us.
//
// Design. The TPU kernel streams one output plane per grid step from k
// input planes held in VMEM, so each plane is read from HBM about once; its
// W*C lane packing answered the TPU's (8, 128) tiling and is not carried
// over. Here one block owns an output tile of TH x TW (H x W) columns of one
// or more volumes and walks D over a chunk of up to 32 output planes:
//   - each input plane's tile plus its k/2 halo is staged once in shared
//     memory (f32), so x is read from HBM once plus the tile halos; the
//     next plane is loaded into registers while the current one is
//     computed (double-buffered shared memory, one barrier per plane);
//   - zero padding is a predicate on that load, so there is no pre-pad pass;
//   - each thread owns VH x 4 W-adjacent outputs and keeps k planes of
//     accumulators in registers: an input plane is read from shared memory
//     once (two 16-byte loads per row) and added to the k output planes it
//     touches, so shared-memory traffic is ~3 loads per output at k = 3,
//     below the FMA rate; when the oldest plane is complete it is stored
//     (16-byte or 8-byte vector stores where W % 4 == 0, masked elsewhere)
//     and the accumulators shift;
//   - the channel's k^3 weights live in registers;
//   - small planes (deep stages, W <= 16) pack several volumes into one
//     block along threadIdx.z, so a block still has up to 256 threads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kVW = 4;          // W-adjacent outputs per thread
constexpr int kThreads = 256;   // threads per block, at most
constexpr int kMaxBy = 64;      // thread rows per volume, at most
constexpr int kMaxG = 64;       // volumes per block (blockDim.z limit)
constexpr int kDChunk = 32;     // output planes per block along D
constexpr int kMaxSmem = 48 * 1024;

template <int K>
struct Cfg {
  static constexpr int P = K / 2;
  static constexpr int VH = K == 3 ? 2 : 1;       // output rows per thread
  static constexpr int MAXR = VH + 2 * P;         // staged rows per thread, at most
  static constexpr int MAXC = kVW + 2 * P;        // staged cols per thread, at most
  static_assert(kVW + 2 * P <= 8, "a thread reads 8 staged columns per row");
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Store 4 outputs to a 4-element-aligned address with one vector store.
__device__ __forceinline__ void store4(float* dst, const float (&v)[kVW]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, const float (&v)[kVW]) {
  union { __nv_bfloat162 h[2]; uint2 u; } pack;
  pack.h[0] = __floats2bfloat162_rn(v[0], v[1]);
  pack.h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(dst) = pack.u;
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
dw_conv3_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ bias, T* __restrict__ out,
                int64_t n_vol, int C, int D, int H, int W,
                int h_tiles, int w_tiles, int d_chunk) {
  using Cf = Cfg<K>;
  constexpr int P = Cf::P, VH = Cf::VH, K3 = K * K * K;
  const int bx = blockDim.x, by = blockDim.y, G = blockDim.z;
  const int tx = threadIdx.x, ty = threadIdx.y, tz = threadIdx.z;
  const int TH = by * VH, TW = bx * kVW;
  const int rows = TH + 2 * P, cols = TW + 2 * P;   // staged tile with halo
  const int pitch = TW + 8;                         // floats, 16-byte multiple
  const int region = rows * pitch;                  // floats per (buffer, volume)

  int64_t bid = blockIdx.x;
  const int wt = static_cast<int>(bid % w_tiles);
  bid /= w_tiles;
  const int ht = static_cast<int>(bid % h_tiles);
  bid /= h_tiles;
  const int64_t vol = bid * G + tz;                 // (b, c) volume index
  const bool vol_ok = vol < n_vol;
  const int c = vol_ok ? static_cast<int>(vol % C) : 0;
  const int d_begin = blockIdx.y * d_chunk;
  const int d_end = min(D, d_begin + d_chunk);
  const int h0 = ht * TH, w0 = wt * TW;             // first output row / col

  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);

  float wr[K3];
#pragma unroll
  for (int j = 0; j < K3; ++j) wr[j] = vol_ok ? to_float(w[c * K3 + j]) : 0.f;
  const float bv = (vol_ok && bias != nullptr) ? to_float(bias[c]) : 0.f;

  const int64_t plane = static_cast<int64_t>(H) * W;
  const T* const xv = x + (vol_ok ? vol : 0) * D * plane;
  T* const ov = out + (vol_ok ? vol : 0) * D * plane;

  // Staged element (r, cc) of this volume's tile is input (h0-P+r, w0-P+cc);
  // thread (tx, ty) stages r = ty + ri*by, cc = tx + ci*bx (coalesced in W).
  T pre[Cf::MAXR][Cf::MAXC];
  auto fetch = [&](int z) {
    const bool z_ok = vol_ok && z >= 0 && z < D;
    const T* const src = xv + static_cast<int64_t>(z_ok ? z : 0) * plane;
#pragma unroll
    for (int ri = 0; ri < Cf::MAXR; ++ri) {
      const int r = ty + ri * by, hh = h0 - P + r;
#pragma unroll
      for (int ci = 0; ci < Cf::MAXC; ++ci) {
        const int cc = tx + ci * bx, ww = w0 - P + cc;
        pre[ri][ci] = (z_ok && r < rows && cc < cols && hh >= 0 && hh < H &&
                       ww >= 0 && ww < W)
                          ? src[static_cast<int64_t>(hh) * W + ww]
                          : from_float<T>(0.f);
      }
    }
  };
  auto commit = [&](float* dst) {
#pragma unroll
    for (int ri = 0; ri < Cf::MAXR; ++ri) {
      const int r = ty + ri * by;
#pragma unroll
      for (int ci = 0; ci < Cf::MAXC; ++ci) {
        const int cc = tx + ci * bx;
        if (r < rows && cc < cols) dst[r * pitch + cc] = to_float(pre[ri][ci]);
      }
    }
  };

  // acc[i] holds output plane z - P + i while input plane z is consumed;
  // input z reaches it through tap dz = K - 1 - i.
  float acc[K][VH][kVW];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int vh = 0; vh < VH; ++vh)
#pragma unroll
      for (int v = 0; v < kVW; ++v) acc[i][vh][v] = 0.f;

  const int z_first = d_begin - P, z_last = d_end + P - 1;
  const bool vec_store = (W % kVW) == 0;
  const int wbase = w0 + tx * kVW;
  fetch(z_first);
  commit(smem + tz * region);
  __syncthreads();
  int cur = 0;
  for (int z = z_first; z <= z_last; ++z) {
    if (z < z_last) fetch(z + 1);                   // in flight during compute
    const float* const s = smem + (cur * G + tz) * region;
#pragma unroll
    for (int r = 0; r < VH + K - 1; ++r) {
      const float* const row = s + (ty * VH + r) * pitch + tx * kVW;
      const float4 a = *reinterpret_cast<const float4*>(row);
      const float4 b = *reinterpret_cast<const float4*>(row + 4);
      const float win[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int vh = 0; vh < VH; ++vh) {
        const int dy = r - vh;
        if (dy < 0 || dy >= K) continue;
#pragma unroll
        for (int i = 0; i < K; ++i) {
          const int dz = K - 1 - i;
#pragma unroll
          for (int dx = 0; dx < K; ++dx) {
            const float wv = wr[(dz * K + dy) * K + dx];
#pragma unroll
            for (int v = 0; v < kVW; ++v)
              acc[i][vh][v] = fmaf(wv, win[v + dx], acc[i][vh][v]);
          }
        }
      }
    }
    const int o = z - P;                            // complete output plane
    if (vol_ok && o >= d_begin) {
#pragma unroll
      for (int vh = 0; vh < VH; ++vh) {
        const int hh = h0 + ty * VH + vh;
        if (hh >= H || wbase >= W) continue;
        float v4[kVW];
#pragma unroll
        for (int v = 0; v < kVW; ++v) v4[v] = acc[0][vh][v] + bv;
        T* const dst = ov + static_cast<int64_t>(o) * plane +
                       static_cast<int64_t>(hh) * W + wbase;
        if (vec_store && wbase + kVW <= W) {
          store4(dst, v4);
        } else {
#pragma unroll
          for (int v = 0; v < kVW; ++v)
            if (wbase + v < W) dst[v] = from_float<T>(v4[v]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i + 1 < K; ++i)
#pragma unroll
      for (int vh = 0; vh < VH; ++vh)
#pragma unroll
        for (int v = 0; v < kVW; ++v) acc[i][vh][v] = acc[i + 1][vh][v];
#pragma unroll
    for (int vh = 0; vh < VH; ++vh)
#pragma unroll
      for (int v = 0; v < kVW; ++v) acc[K - 1][vh][v] = 0.f;
    if (z < z_last) commit(smem + ((cur ^ 1) * G + tz) * region);
    __syncthreads();
    cur ^= 1;
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

template <typename T, int K>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out,
                   int64_t n_vol, int C, int D, int H, int W, cudaStream_t stream) {
  using Cf = Cfg<K>;
  // block shape: bx threads across W (4 outputs each), by across H (VH
  // rows each), G volumes; tile TH = by*VH, TW = bx*4
  const int bx = static_cast<int>(ceil_div(W, kVW) < 32 ? ceil_div(W, kVW) : 32);
  int by = static_cast<int>(ceil_div(H, Cf::VH));
  by = by < kThreads / bx ? by : kThreads / bx;
  by = by < kMaxBy ? by : kMaxBy;
  int G = kThreads / (bx * by);
  G = G < kMaxG ? G : kMaxG;
  if (G > n_vol) G = static_cast<int>(n_vol);
  auto smem_bytes = [&](int g) {
    return static_cast<size_t>(2) * g * (by * Cf::VH + 2 * Cf::P) * (bx * kVW + 8) *
           sizeof(float);
  };
  while (G > 1 && smem_bytes(G) > kMaxSmem) --G;
  if (smem_bytes(G) > kMaxSmem) return cudaErrorInvalidConfiguration;
  const int h_tiles = static_cast<int>(ceil_div(H, by * Cf::VH));
  const int w_tiles = static_cast<int>(ceil_div(W, bx * kVW));
  const int d_chunk = D < kDChunk ? D : kDChunk;
  const int64_t gx = ceil_div(n_vol, G) * h_tiles * w_tiles;
  const int64_t gy = ceil_div(D, d_chunk);
  if (gx > INT_MAX || gy > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  dim3 block(bx, by, G);
  dw_conv3_kernel<T, K><<<grid, block, smem_bytes(G), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(out), n_vol, C, D, H, W, h_tiles, w_tiles, d_chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_k(const void* x, const void* w, const void* bias, void* out,
                       int64_t n_vol, int C, int D, int H, int W, int k,
                       cudaStream_t stream) {
  switch (k) {
    case 3: return launch<T, 3>(x, w, bias, out, n_vol, C, D, H, W, stream);
    case 5: return launch<T, 5>(x, w, bias, out, n_vol, C, D, H, W, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// n_vol = B * C volumes of D x H x W; dtype: 0 = float32, 1 = bfloat16;
// bias may be null. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue / cudaErrorInvalidConfiguration for arguments the
// kernel does not take. Launches on `stream`, allocates nothing and does not
// synchronise.
extern "C" int dw_conv3_forward(const void* x, const void* w, const void* bias,
                                void* out, long long n_vol, int C, int D, int H,
                                int W, int k, int dtype, void* stream) {
  if (n_vol <= 0 || C <= 0 || n_vol % C != 0 || D <= 0 || H <= 0 || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_k<float>(x, w, bias, out, n_vol, C, D, H, W, k, s);
  else if (dtype == 1)
    err = dispatch_k<__nv_bfloat16>(x, w, bias, out, n_vol, C, D, H, W, k, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
