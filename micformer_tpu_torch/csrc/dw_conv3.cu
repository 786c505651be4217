// Depthwise k^3 convolution forward for Hopper (sm_90a): stride 1, SAME zero
// padding k/2, optional per-channel bias, k in {3, 5}. Also the dx of the
// convolution's backward (this kernel on the spatially flipped weight).
//
// Replaces the TPU kernel micformer_tpu/ops/pallas/dw_stencil.py (`_kernel` /
// `_forward`, reached from `dw_conv3_pallas`; its backward `_bwd` takes dx
// from `_forward` on the flipped kernel): out[b,c,d,h,w] = bias[c] + sum over
// (dz,dy,dx) of w[c,dz,dy,dx] * x[b,c,d+dz-p,h+dy-p,w+dx-p], zeros outside
// the volume. On MedNeXt-S's serving path x runs from [4, 32, 128^3] (stage
// 0) to [4, 512, 8^3] (bottleneck) at sw_batch 4.
//
// Layout: x and out are contiguous [B, C, D, H, W]; each (b, c) is an
// independent volume. w is the Conv3d depthwise weight [C, 1, k, k, k]
// (contiguous), bias is [C] or null; all share x's dtype (f32 or bf16).
// Accumulation is f32 in (dz, dy, dx) order, with one rounding on the store.
//
// Bound at stage 0 in bf16, [4, 32, 128^3], on an NVIDIA H100 80GB HBM3 at
// its 700 W limit: x read once and out written once, 1.07 GB at 3.35 TB/s =
// 320 us; 7.2 G FMA on the CUDA cores (a depthwise conv has no channel
// reduction for the tensor cores) at 67 TFLOP/s = 216 us. So the kernel is
// near balance: it is memory-bound only if FMAs are most of what it issues.
// The first design (one scalar load with six predicates per staged element,
// an f32 staging pass, 4 outputs a thread, accumulators shifted by moves)
// issued 811 SASS instructions for 216 FMAs a plane and ran 1310 us in f32
// and bf16 alike.
//
// Design. Three routes, chosen by the wrapper (kernels/dw_conv3.py
// `_dw_route`) and checked here:
//   - "tma" (the rule): one block owns a TH x TW (H x W) tile of one volume
//     and walks a chunk of D. A ring of 4 plane buffers in shared memory, in
//     x's dtype, is filled by TMA (csrc/dw_stage.cuh): one thread asks for
//     each halo'd (TW+2p) x (TH+2p) box three planes ahead, and zero fill out
//     of bounds is the padding, so the loop has no load predicates and no
//     staging pass. Each thread owns VH rows x 8 W-adjacent outputs (VH 2 at
//     k = 3, 1 at k = 5) and keeps k planes of accumulators in registers;
//     a staged row is read as one 16-byte load plus the halo (bf16 converted
//     in pairs) and feeds k^2 * 8 FMAs per output row. The D loop is
//     unrolled by k, so the accumulator ring rotates by renaming registers.
//   - "volume" (D, H, W <= 16: stage 3 and the bottleneck): one TMA box
//     brings G whole halo'd volumes into shared memory and each thread
//     computes its cells (VH rows x 8 columns of one plane) with no D walk;
//     G is cut until the grid has at least 2 blocks per SM.
//   - "cp_async" (x not 16-byte aligned, or W * sizeof(T) not a multiple of
//     16, which TMA cannot describe): the tile kernel with the ring filled by
//     4-byte cp.async copies with src-size zero fill.

#include <limits.h>
#include <string.h>

#include "dw_stage.cuh"

namespace {

using namespace dwk;

template <typename T, int K, bool kTma>
__global__ void __launch_bounds__(kThreads, Cfg<K>::MINB)
dw_conv3_tile_kernel(const __grid_constant__ CUtensorMap xmap, const T* __restrict__ x,
                     const T* __restrict__ w, const T* __restrict__ bias, T* __restrict__ out,
                     int C, int D, int H, int W, int h_tiles, int w_tiles, int d_chunk, int BW,
                     int BH) {
  using Cf = Cfg<K>;
  constexpr int P = Cf::P, VH = Cf::VH, K3 = Cf::K3, NWIN = Cf::NWIN;
  extern __shared__ unsigned char smem[];
  const int tx = threadIdx.x, ty = threadIdx.y;
  PlaneRing<T, K, kTma> ring;
  ring.setup(smem, &xmap, x, D, H, W, h_tiles, w_tiles, d_chunk, BW, BH);
  const int64_t vol = ring.vol;
  const int d_begin = ring.d_begin;

  const int c = static_cast<int>(vol % C);
  float wr[K3];
#pragma unroll
  for (int j = 0; j < K3; ++j) wr[j] = to_float(w[c * K3 + j]);
  const float bv = bias != nullptr ? to_float(bias[c]) : 0.f;

  // acc[(o - d_begin + 2P) % K] holds output plane o: input plane ordinal
  // p (z = z_first + p) reaches output z - P + i through tap dz = K-1-i,
  // in slot (p + i) % K
  float acc[K][VH][kVW];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int vh = 0; vh < VH; ++vh)
#pragma unroll
      for (int v = 0; v < kVW; ++v) acc[i][vh][v] = 0.f;

  const int col0 = tx * kVW;                        // staged column of the window
  const int n_cols = W - (ring.w0 + col0);          // output columns this thread stores
  const bool vec = reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   (static_cast<int64_t>(W) * sizeof(T)) % 16 == 0;
  T* const ov = out + vol * D * static_cast<int64_t>(H) * W + ring.w0 + col0;
  const int n = ring.n_planes;

  __syncthreads();                                  // barriers initialised
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < n) ring.issue(q);
    ring.commit();
  }
  for (int pb = 0; pb < n; pb += K) {
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int p = pb + u;
      if (p >= n) break;
      if (p + kStages - 1 < n) ring.issue(p + kStages - 1);
      ring.commit();
      ring.wait(p);
#pragma unroll
      for (int r = 0; r < VH + K - 1; ++r) {
        float win[NWIN];
        ring.template read<NWIN>(p, ty * VH + r, col0, win);
#pragma unroll
        for (int vh = 0; vh < VH; ++vh) {
          const int dy = r - vh;
          if (dy < 0 || dy >= K) continue;
#pragma unroll
          for (int i = 0; i < K; ++i) {
            const int dz = K - 1 - i, slot = (u + i) % K;
#pragma unroll
            for (int dx = 0; dx < K; ++dx) {
              const float wv = wr[(dz * K + dy) * K + dx];
#pragma unroll
              for (int v = 0; v < kVW; ++v)
                acc[slot][vh][v] = fmaf(wv, win[v + dx], acc[slot][vh][v]);
            }
          }
        }
      }
      __syncthreads();                              // buffer p % kStages is free
      const int o = ring.z_first + p - P;           // complete output plane, in slot u
      if (o >= d_begin && n_cols > 0) {
#pragma unroll
        for (int vh = 0; vh < VH; ++vh) {
          const int hh = ring.h0 + ty * VH + vh;
          if (hh >= H) continue;
          float v8[kVW];
#pragma unroll
          for (int v = 0; v < kVW; ++v) v8[v] = acc[u][vh][v] + bv;
          store_row<T>(ov + (static_cast<int64_t>(o) * H + hh) * W, v8, min(n_cols, kVW), vec);
        }
      }
#pragma unroll
      for (int vh = 0; vh < VH; ++vh)
#pragma unroll
        for (int v = 0; v < kVW; ++v) acc[u][vh][v] = 0.f;
    }
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads, Cfg<K>::MINB)
dw_conv3_volume_kernel(const __grid_constant__ CUtensorMap xmap, const T* __restrict__ w,
                       const T* __restrict__ bias, T* __restrict__ out, int64_t n_vol, int C,
                       int D, int H, int W, int tpv, int G, int nwc, int nhc, int BW, int BH,
                       int BD) {
  using Cf = Cfg<K>;
  constexpr int P = Cf::P, VH = Cf::VH, K3 = Cf::K3, NWIN = Cf::NWIN;
  constexpr int A = 16 / static_cast<int>(sizeof(T));   // staged columns left of 0
  extern __shared__ unsigned char smem[];
  const int box_elems = BW * BH * BD * G;
  const int64_t vol0 = static_cast<int64_t>(blockIdx.x) * G;
  const int gi = threadIdx.x / tpv, lane = threadIdx.x % tpv;
  const int64_t vol = vol0 + gi;
  const bool ok = gi < G && vol < n_vol;
  const int c = ok ? static_cast<int>(vol % C) : 0;
  float wr[K3];
#pragma unroll
  for (int j = 0; j < K3; ++j) wr[j] = to_float(w[c * K3 + j]);
  const float bv = bias != nullptr ? to_float(bias[c]) : 0.f;
  const bool vec = reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   (static_cast<int64_t>(W) * sizeof(T)) % 16 == 0;
  const T* const box = load_volumes<T, P>(smem, &xmap, box_elems, vol0);
  if (!ok) return;

  const T* const xs = box + static_cast<int64_t>(gi) * BD * BH * BW;
  T* const ov = out + vol * D * static_cast<int64_t>(H) * W;
  const int S = nwc * nhc * D;
  for (int cell = lane; cell < S; cell += tpv) {
    const int wc = cell % nwc, t = cell / nwc, hc = t % nhc, d = t / nhc;
    float acc[VH][kVW];
#pragma unroll
    for (int vh = 0; vh < VH; ++vh)
#pragma unroll
      for (int v = 0; v < kVW; ++v) acc[vh][v] = 0.f;
#pragma unroll
    for (int dz = 0; dz < K; ++dz) {
#pragma unroll
      for (int r = 0; r < VH + K - 1; ++r) {
        float win[NWIN];
        read_row_halo<T, P>(xs + ((d + dz) * BH + hc * VH + r) * BW + wc * kVW + A, win);
#pragma unroll
        for (int vh = 0; vh < VH; ++vh) {
          const int dy = r - vh;
          if (dy < 0 || dy >= K) continue;
#pragma unroll
          for (int dx = 0; dx < K; ++dx) {
            const float wv = wr[(dz * K + dy) * K + dx];
#pragma unroll
            for (int v = 0; v < kVW; ++v) acc[vh][v] = fmaf(wv, win[v + dx], acc[vh][v]);
          }
        }
      }
    }
    const int n_cols = min(W - wc * kVW, kVW);
#pragma unroll
    for (int vh = 0; vh < VH; ++vh) {
      const int hh = hc * VH + vh;
      if (hh >= H) continue;
      float v8[kVW];
#pragma unroll
      for (int v = 0; v < kVW; ++v) v8[v] = acc[vh][v] + bv;
      store_row<T>(ov + (static_cast<int64_t>(d) * H + hh) * W + wc * kVW, v8, n_cols, vec);
    }
  }
}

template <typename T, int K>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out, int64_t n_vol,
                   int C, int D, int H, int W, int route, int p0, int p1, int p2,
                   cudaStream_t stream) {
  const int es = static_cast<int>(sizeof(T));
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  cudaError_t err;
  if (route == kRouteVolume) {
    VolumePlan pl;
    if (!tma_ok(x, W, es) || !make_volume_plan<K>(p0, p1, D, H, W, es, &pl))
      return cudaErrorInvalidValue;
    const int64_t gx = ceil_div(n_vol, pl.G);
    if (gx > INT_MAX) return cudaErrorInvalidConfiguration;
    if ((err = encode_x_map<T>(&map, x, n_vol, D, H, W, pl.BW, pl.BH, pl.BD, pl.G)) != cudaSuccess)
      return err;
    auto kern = dw_conv3_volume_kernel<T, K>;
    if ((err = allow_smem(kern, pl.smem)) != cudaSuccess) return err;
    kern<<<static_cast<unsigned>(gx), pl.threads, pl.smem, stream>>>(
        map, static_cast<const T*>(w), static_cast<const T*>(bias), static_cast<T*>(out), n_vol,
        C, D, H, W, pl.tpv, pl.G, pl.nwc, pl.nhc, pl.BW, pl.BH, pl.BD);
    return cudaGetLastError();
  }
  if (route != kRouteTma && route != kRouteCpAsync) return cudaErrorInvalidValue;
  const bool tma = route == kRouteTma;
  TilePlan pl;
  if ((tma && !tma_ok(x, W, es)) || !make_tile_plan<K>(p0, p1, p2, D, H, W, es, tma, &pl))
    return cudaErrorInvalidValue;
  const int64_t gx = n_vol * pl.h_tiles * pl.w_tiles;
  if (gx > INT_MAX) return cudaErrorInvalidConfiguration;
  if (tma && (err = encode_x_map<T>(&map, x, n_vol, D, H, W, pl.BW, pl.BH, 1, 1)) != cudaSuccess)
    return err;
  auto kern = tma ? dw_conv3_tile_kernel<T, K, true> : dw_conv3_tile_kernel<T, K, false>;
  if ((err = allow_smem(kern, pl.smem)) != cudaSuccess) return err;
  kern<<<dim3(static_cast<unsigned>(gx), pl.n_chunks), dim3(pl.bx, pl.by), pl.smem, stream>>>(
      map, static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(out), C, D, H, W, pl.h_tiles, pl.w_tiles, pl.d_chunk, pl.BW, pl.BH);
  return cudaGetLastError();
}

}  // namespace

// n_vol = B * C volumes of D x H x W; dtype: 0 = float32, 1 = bfloat16;
// bias may be null. route: 0 = tma, 1 = volume, 2 = cp_async; (p0, p1, p2)
// the route's plan from the wrapper: (bx, by, D chunk) for tma and
// cp_async, (threads per volume, volumes per block, 0) for volume. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue /
// cudaErrorInvalidConfiguration for arguments, a route or a plan the
// kernel does not take. Launches on `stream`, allocates nothing and does
// not synchronise.
extern "C" int dw_conv3_forward(const void* x, const void* w, const void* bias, void* out,
                                long long n_vol, int C, int D, int H, int W, int k, int dtype,
                                int route, int p0, int p1, int p2, void* stream) {
  if (n_vol <= 0 || C <= 0 || n_vol % C != 0 || D <= 0 || H <= 0 || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && k == 3)
    err = launch<float, 3>(x, w, bias, out, n_vol, C, D, H, W, route, p0, p1, p2, s);
  else if (dtype == 0 && k == 5)
    err = launch<float, 5>(x, w, bias, out, n_vol, C, D, H, W, route, p0, p1, p2, s);
  else if (dtype == 1 && k == 3)
    err = launch<__nv_bfloat16, 3>(x, w, bias, out, n_vol, C, D, H, W, route, p0, p1, p2, s);
  else if (dtype == 1 && k == 5)
    err = launch<__nv_bfloat16, 5>(x, w, bias, out, n_vol, C, D, H, W, route, p0, p1, p2, s);
  return static_cast<int>(err);
}
