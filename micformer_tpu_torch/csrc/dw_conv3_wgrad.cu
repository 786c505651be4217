// Weight and bias gradient of the depthwise k^3 convolution (stride 1, SAME
// zero padding k/2) for Hopper (sm_90a), k in {3, 5}.
//
// Replaces the dw half of the TPU kernel's backward,
// micformer_tpu/ops/pallas/dw_stencil.py `_bwd` (dw as a tap-correlation
// reduce, :103-114): for every channel c and tap (dz, dy, dx)
//   dw[c, dz, dy, dx] = sum over (b, d, h, w) of
//                       g[b, c, d, h, w] * x[b, c, d+dz-p, h+dy-p, w+dx-p]
// with zeros outside the volume, and db[c] = sum of g[b, c, ...]. The dx half
// of that backward is the forward kernel (csrc/dw_conv3.cu) on the spatially
// flipped weight.
//
// Layout: x and g are contiguous [B, C, D, H, W] of one dtype (f32 or bf16).
// Out: f32 dw [C, k^3] (the Conv3d weight [C, 1, k, k, k] flattened) and f32
// db [C], accumulated in f32.
//
// Bound: memory. Each call must read x and g once (2 * 2 bytes per voxel in
// bf16); the k^3 multiply-adds per voxel run on CUDA cores (no channel
// reduction for the tensor cores). At MedNeXt-S's stage 0 in a b2 training
// step, [2, 32, 128^3] in bf16, on an NVIDIA H100 80GB HBM3 at its 700 W
// limit (3.35 TB/s, 67 TFLOP/s f32 FMA): 537 MB take 160 us, 3.6 G FMA 108 us.
//
// Why CUDA C++ and not Triton: this is a stencil, not a plain reduction. The
// halo'd x plane is staged once in shared memory and read back as shifted
// windows, and every thread keeps all k^3 + 1 sums in registers across the
// whole D walk; Triton's block model has neither the shared-memory halo tile
// nor an unrolled k^3 register accumulator.
//
// Design, simple and deterministic (no atomics, as the K1 backward):
//   - one block per (G volumes of one or more channels, H x W tile, D chunk);
//     a thread owns 4 W-adjacent voxels of one row and walks the chunk's
//     g planes. While x plane z is consumed it holds the k g planes that
//     plane z meets (z + p - dz for tap dz) in registers, so g is read from
//     HBM once and needs no shared memory;
//   - each x plane's tile plus its k/2 halo is staged once in shared memory
//     (f32), double-buffered with the next plane loaded into registers
//     during the compute, zero padding by predicate, as the forward does;
//   - a row of the tile is read as two 16-byte loads and reused for the k
//     dx taps of the 4 voxels and the k dz taps: k^3 * 4 FMAs per 2k loads;
//   - at the end each block reduces its k^3 + 1 sums over the threads of
//     each volume (warp shuffles, then shared memory across warps) and
//     writes one partial per (volume, tile, chunk) into an f32 scratch;
//     a second small launch sums the partials of each channel in a fixed
//     order (batch, then tile and chunk), so dw is the same in every run;
//   - D is cut into chunks until the grid has about four blocks per SM, so
//     the narrow-C stages (32 channels at 128^3) still fill 132 SMs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kVW = 4;              // W-adjacent voxels per thread
constexpr int kThreads = 256;       // threads per block, at most
constexpr int kMaxBy = 64;          // thread rows per volume, at most
constexpr int kMaxG = 64;           // volumes per block (blockDim.z limit)
constexpr int kMaxDChunk = 32;      // g planes per block along D, at most
constexpr int kMinDChunk = 4;       // ... and at least (where D allows)
constexpr int kTargetBlocks = 4 * 132;
constexpr int kMaxSmem = 48 * 1024;

template <int K>
struct Cfg {
  static constexpr int P = K / 2;
  static constexpr int K3 = K * K * K;
  static constexpr int NACC = K3 + 1;             // k^3 taps and the bias sum
  static constexpr int MAXR = 1 + 2 * P;          // staged rows per thread, at most
  static constexpr int MAXC = kVW + 2 * P;        // staged cols per thread, at most
  static_assert(kVW + 2 * P <= 8, "a thread reads 8 staged columns per row");
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// 4 consecutive values from a 4-element-aligned address, as f32.
__device__ __forceinline__ void load4(const float* src, float (&dst)[kVW]) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* src, float (&dst)[kVW]) {
  union { uint2 u; __nv_bfloat162 h[2]; } pack;
  pack.u = *reinterpret_cast<const uint2*>(src);
  const float2 a = __bfloat1622float2(pack.h[0]), b = __bfloat1622float2(pack.h[1]);
  dst[0] = a.x; dst[1] = a.y; dst[2] = b.x; dst[3] = b.y;
}

struct Plan {
  int bx, by, G, h_tiles, w_tiles, d_chunk, n_chunks;
  int64_t vol_groups;
  size_t smem;
};

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }
int pow2_ceil(int64_t v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// The launch shape for n_vol volumes of D x H x W; the same for the scratch
// query and the launch.
template <int K>
Plan make_plan(int64_t n_vol, int D, int H, int W) {
  using Cf = Cfg<K>;
  Plan pl;
  // bx and by are powers of two, so the threads of one volume form aligned
  // warp segments (or whole warps) for the shuffle reduction
  pl.bx = pow2_ceil(ceil_div(W, kVW));
  if (pl.bx > 32) pl.bx = 32;
  pl.by = pow2_ceil(H);
  if (pl.by > kThreads / pl.bx) pl.by = kThreads / pl.bx;
  if (pl.by > kMaxBy) pl.by = kMaxBy;
  const int S = pl.bx * pl.by;
  pl.G = kThreads / S;
  if (pl.G > kMaxG) pl.G = kMaxG;
  if (pl.G > n_vol) pl.G = static_cast<int>(n_vol);
  const int rows = pl.by + 2 * Cf::P, pitch = pl.bx * kVW + 8;
  auto tile_bytes = [&](int g) {
    return static_cast<size_t>(2) * g * rows * pitch * sizeof(float);
  };
  while (pl.G > 1 && tile_bytes(pl.G) > kMaxSmem) --pl.G;
  // the cross-warp reduction reuses the tile's shared memory
  const int warps = (S > 32 ? S / 32 : 1) * pl.G;
  const size_t red_bytes = static_cast<size_t>(warps) * Cf::NACC * sizeof(float);
  pl.smem = tile_bytes(pl.G) > red_bytes ? tile_bytes(pl.G) : red_bytes;
  pl.h_tiles = static_cast<int>(ceil_div(H, pl.by));
  pl.w_tiles = static_cast<int>(ceil_div(W, pl.bx * kVW));
  pl.vol_groups = ceil_div(n_vol, pl.G);
  const int64_t per_chunk = pl.vol_groups * pl.h_tiles * pl.w_tiles;
  pl.d_chunk = D < kMaxDChunk ? D : kMaxDChunk;
  const int floor_chunk = D < kMinDChunk ? D : kMinDChunk;
  while (pl.d_chunk > floor_chunk && per_chunk * ceil_div(D, pl.d_chunk) < kTargetBlocks)
    pl.d_chunk = static_cast<int>(ceil_div(pl.d_chunk, 2));
  if (pl.d_chunk < floor_chunk) pl.d_chunk = floor_chunk;
  pl.n_chunks = static_cast<int>(ceil_div(D, pl.d_chunk));
  return pl;
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
dw_conv3_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      float* __restrict__ part, int64_t n_vol, int D, int H, int W,
                      int h_tiles, int w_tiles, int d_chunk, int n_chunks) {
  using Cf = Cfg<K>;
  constexpr int P = Cf::P, K3 = Cf::K3, NACC = Cf::NACC;
  const int bx = blockDim.x, by = blockDim.y, G = blockDim.z;
  const int tx = threadIdx.x, ty = threadIdx.y, tz = threadIdx.z;
  const int TW = bx * kVW;
  const int rows = by + 2 * P, cols = TW + 2 * P;   // staged tile with halo
  const int pitch = TW + 8;                         // floats, 16-byte multiple
  const int region = rows * pitch;                  // floats per (buffer, volume)

  int64_t bid = blockIdx.x;
  const int wt = static_cast<int>(bid % w_tiles);
  bid /= w_tiles;
  const int ht = static_cast<int>(bid % h_tiles);
  bid /= h_tiles;
  const int64_t vol = bid * G + tz;                 // (b, c) volume index
  const bool vol_ok = vol < n_vol;
  const int chunk = blockIdx.y;
  const int d_begin = chunk * d_chunk;
  const int d_end = min(D, d_begin + d_chunk);
  const int h0 = ht * by, w0 = wt * TW;             // first row / col of the tile

  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);

  const int64_t plane = static_cast<int64_t>(H) * W;
  const T* const xv = x + (vol_ok ? vol : 0) * D * plane;
  const T* const gv = g + (vol_ok ? vol : 0) * D * plane;
  const int hh = h0 + ty, wbase = w0 + tx * kVW;
  const bool g_vec = (W % kVW) == 0 &&
                     (reinterpret_cast<uintptr_t>(g) % (kVW * sizeof(T))) == 0;

  // this thread's 4 voxels of g plane d, zero outside the chunk and volume
  auto load_g = [&](int d, float (&dst)[kVW]) {
    const bool ok = vol_ok && d >= d_begin && d < d_end && hh < H;
    const T* const src = gv + static_cast<int64_t>(ok ? d : 0) * plane +
                         static_cast<int64_t>(ok ? hh : 0) * W + wbase;
    if (ok && g_vec && wbase + kVW <= W) {
      load4(src, dst);
    } else {
#pragma unroll
      for (int v = 0; v < kVW; ++v)
        dst[v] = (ok && wbase + v < W) ? to_float(src[v]) : 0.f;
    }
  };

  // Staged element (r, cc) of this volume's tile is x (h0-P+r, w0-P+cc);
  // thread (tx, ty) stages r = ty + ri*by, cc = tx + ci*bx (coalesced in W).
  T pre[Cf::MAXR][Cf::MAXC];
  auto fetch = [&](int z) {
    const bool z_ok = vol_ok && z >= 0 && z < D;
    const T* const src = xv + static_cast<int64_t>(z_ok ? z : 0) * plane;
#pragma unroll
    for (int ri = 0; ri < Cf::MAXR; ++ri) {
      const int r = ty + ri * by, xh = h0 - P + r;
#pragma unroll
      for (int ci = 0; ci < Cf::MAXC; ++ci) {
        const int cc = tx + ci * bx, xw = w0 - P + cc;
        pre[ri][ci] = (z_ok && r < rows && cc < cols && xh >= 0 && xh < H &&
                       xw >= 0 && xw < W)
                          ? src[static_cast<int64_t>(xh) * W + xw]
                          : zero<T>();
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

  float acc[NACC];
#pragma unroll
  for (int t = 0; t < NACC; ++t) acc[t] = 0.f;
  // gr[i] holds g plane z + P - i while x plane z is consumed: x plane z
  // meets g plane z + P - dz through tap dz
  float gr[K][kVW];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int v = 0; v < kVW; ++v) gr[i][v] = 0.f;

  const int z_first = d_begin - P, z_last = d_end - 1 + P;
  fetch(z_first);
  commit(smem + tz * region);
  load_g(d_begin, gr[0]);
#pragma unroll
  for (int v = 0; v < kVW; ++v) acc[K3] += gr[0][v];
  __syncthreads();
  int cur = 0;
  for (int z = z_first; z <= z_last; ++z) {
    float gnext[kVW];
    if (z < z_last) {                               // in flight during compute
      fetch(z + 1);
      load_g(z + 1 + P, gnext);
    }
    const float* const s = smem + (cur * G + tz) * region;
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
      const float* const row = s + (ty + dy) * pitch + tx * kVW;
      const float4 a = *reinterpret_cast<const float4*>(row);
      const float4 b = *reinterpret_cast<const float4*>(row + 4);
      const float win[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int dz = 0; dz < K; ++dz) {
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          float sum = acc[(dz * K + dy) * K + dx];
#pragma unroll
          for (int v = 0; v < kVW; ++v) sum = fmaf(gr[dz][v], win[v + dx], sum);
          acc[(dz * K + dy) * K + dx] = sum;
        }
      }
    }
#pragma unroll
    for (int i = K - 1; i > 0; --i)
#pragma unroll
      for (int v = 0; v < kVW; ++v) gr[i][v] = gr[i - 1][v];
    if (z < z_last) {
#pragma unroll
      for (int v = 0; v < kVW; ++v) {
        gr[0][v] = gnext[v];
        acc[K3] += gnext[v];
      }
      commit(smem + ((cur ^ 1) * G + tz) * region);
    }
    __syncthreads();
    cur ^= 1;
  }

  // Reduce the sums over the S = bx*by threads of each volume (a power of
  // two; the threads of volume tz are lanes tid_s = tx + bx*ty of one
  // aligned warp segment, or S/32 whole warps).
  const int S = bx * by;
  const int tid_s = tx + bx * ty;
  const int tid = tid_s + S * tz;
  const int seg = S < 32 ? S : 32;
  const int live = min(32, S * G - (tid & ~31));    // lanes of this warp that exist
  const unsigned mask = live == 32 ? 0xffffffffu : ((1u << live) - 1u);
#pragma unroll
  for (int t = 0; t < NACC; ++t)
    for (int off = seg / 2; off > 0; off >>= 1)
      acc[t] += __shfl_xor_sync(mask, acc[t], off);

  const int64_t n_part = static_cast<int64_t>(h_tiles) * w_tiles * n_chunks;
  const int64_t p_idx = (static_cast<int64_t>(ht) * w_tiles + wt) * n_chunks + chunk;
  float* const dst = part + ((vol_ok ? vol : 0) * n_part + p_idx) * NACC;
  if (S <= 32) {
    if (tid_s == 0 && vol_ok) {
#pragma unroll
      for (int t = 0; t < NACC; ++t) dst[t] = acc[t];
    }
    return;
  }
  const int nw = S / 32;                            // warps of this volume
  if ((tid_s & 31) == 0) {
#pragma unroll
    for (int t = 0; t < NACC; ++t) smem[(tz * nw + tid_s / 32) * NACC + t] = acc[t];
  }
  __syncthreads();
  for (int t = tid_s; t < NACC; t += S) {
    float sum = 0.f;
    for (int w = 0; w < nw; ++w) sum += smem[(tz * nw + w) * NACC + t];
    if (vol_ok) dst[t] = sum;
  }
}

// dw[c, t] (t < k^3) and db[c] (t = k^3): the partials of channel c summed
// over batch, then tile and chunk, in that fixed order.
__global__ void dw_conv3_wgrad_reduce(const float* __restrict__ part,
                                      float* __restrict__ dw, float* __restrict__ db,
                                      int B, int C, int64_t n_part, int nacc) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(C) * nacc) return;
  const int c = static_cast<int>(i / nacc), t = static_cast<int>(i % nacc);
  float sum = 0.f;
  for (int b = 0; b < B; ++b) {
    const float* const src = part + (static_cast<int64_t>(b) * C + c) * n_part * nacc + t;
    for (int64_t p = 0; p < n_part; ++p) sum += src[p * nacc];
  }
  if (t < nacc - 1)
    dw[static_cast<int64_t>(c) * (nacc - 1) + t] = sum;
  else
    db[c] = sum;
}

template <int K>
int64_t scratch_floats(int64_t n_vol, int D, int H, int W) {
  const Plan pl = make_plan<K>(n_vol, D, H, W);
  return n_vol * pl.h_tiles * pl.w_tiles * pl.n_chunks * Cfg<K>::NACC;
}

template <typename T, int K>
cudaError_t launch(const void* x, const void* g, float* dw, float* db, float* part,
                   int64_t n_vol, int C, int D, int H, int W, cudaStream_t stream) {
  const Plan pl = make_plan<K>(n_vol, D, H, W);
  if (pl.smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  const int64_t gx = pl.vol_groups * pl.h_tiles * pl.w_tiles;
  if (gx > INT_MAX || pl.n_chunks > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(pl.n_chunks));
  dim3 block(pl.bx, pl.by, pl.G);
  dw_conv3_wgrad_kernel<T, K><<<grid, block, pl.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), part, n_vol, D, H, W,
      pl.h_tiles, pl.w_tiles, pl.d_chunk, pl.n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n_part = static_cast<int64_t>(pl.h_tiles) * pl.w_tiles * pl.n_chunks;
  const int64_t outs = static_cast<int64_t>(C) * Cfg<K>::NACC;
  dw_conv3_wgrad_reduce<<<static_cast<unsigned>(ceil_div(outs, 256)), 256, 0, stream>>>(
      part, dw, db, static_cast<int>(n_vol / C), C, n_part, Cfg<K>::NACC);
  return cudaGetLastError();
}

bool bad_shape(long long n_vol, int C, int D, int H, int W) {
  return n_vol <= 0 || C <= 0 || n_vol % C != 0 || D <= 0 || H <= 0 || W <= 0;
}

}  // namespace

// Floats of f32 scratch that dw_conv3_wgrad needs for these shapes, or -1
// for arguments it does not take.
extern "C" long long dw_conv3_wgrad_scratch(long long n_vol, int C, int D, int H, int W,
                                            int k) {
  if (bad_shape(n_vol, C, D, H, W)) return -1;
  switch (k) {
    case 3: return scratch_floats<3>(n_vol, D, H, W);
    case 5: return scratch_floats<5>(n_vol, D, H, W);
    default: return -1;
  }
}

// n_vol = B * C volumes of D x H x W in x and g; dtype: 0 = float32,
// 1 = bfloat16. dw (C * k^3 floats), db (C floats) and scratch
// (dw_conv3_wgrad_scratch floats) are f32 device buffers; every element of
// dw, db and the scratch's used part is written, so none needs zeroing.
// Returns cudaGetLastError() after the two launches, or
// cudaErrorInvalidValue / cudaErrorInvalidConfiguration for arguments the
// kernel does not take. Launches on `stream`, allocates nothing and does
// not synchronise.
extern "C" int dw_conv3_wgrad(const void* x, const void* g, void* dw, void* db,
                              void* scratch, long long n_vol, int C, int D, int H, int W,
                              int k, int dtype, void* stream) {
  if (bad_shape(n_vol, C, D, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* const dwf = static_cast<float*>(dw);
  float* const dbf = static_cast<float*>(db);
  float* const part = static_cast<float*>(scratch);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && k == 3)
    err = launch<float, 3>(x, g, dwf, dbf, part, n_vol, C, D, H, W, s);
  else if (dtype == 0 && k == 5)
    err = launch<float, 5>(x, g, dwf, dbf, part, n_vol, C, D, H, W, s);
  else if (dtype == 1 && k == 3)
    err = launch<__nv_bfloat16, 3>(x, g, dwf, dbf, part, n_vol, C, D, H, W, s);
  else if (dtype == 1 && k == 5)
    err = launch<__nv_bfloat16, 5>(x, g, dwf, dbf, part, n_vol, C, D, H, W, s);
  return static_cast<int>(err);
}
