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
// Bound at MedNeXt-S's stage 0 in a b2 training step, [2, 32, 128^3] in
// bf16, on an NVIDIA H100 80GB HBM3 at its 700 W limit: x and g read once,
// 537 MB at 3.35 TB/s = 160 us; 3.6 G FMA on the CUDA cores at 67 TFLOP/s
// = 108 us. The first design (4 voxels a thread, 18 predicated scalar
// loads and an f32 staging pass per plane for 108 FMAs) ran 1127 us in f32
// and 1223 us in bf16: bound by instruction issue, not by memory.
//
// Design, deterministic (no atomics):
//   - the "tma" and "cp_async" routes: one block per (volume, H x W tile, D
//     chunk) walks the chunk's g planes. x planes are staged with their
//     halo in a ring of 4 buffers in x's dtype, by TMA or cp.async, exactly
//     as the forward stages them (csrc/dw_stage.cuh). Each thread owns VH
//     rows x 8 W-adjacent voxels (VH 2 at k = 3, 1 at k = 5) and holds, in
//     f32 registers, the k g planes that x plane z meets (z + p - dz for tap
//     dz): g is read from HBM once, 16 bytes a load on the tma route, the
//     next plane's load in flight during the current plane's FMAs. A staged
//     x row is one 16-byte load plus the halo and feeds k^2 * 8 FMAs per g
//     row. At k = 3 the D loop is unrolled by 3, so the g ring rotates by
//     renaming registers.
//   - the "volume" route (D, H, W <= 16): one TMA box brings G whole halo'd
//     x volumes into shared memory; each thread takes cells (VH rows x 8
//     voxels of one g plane) of its volume with no D walk.
//   - every thread keeps all k^3 + 1 sums in f32 registers. At the end each
//     block reduces them over the threads of each volume in f64 (warp
//     shuffles, then shared memory across warps, in a fixed order) and
//     writes one f64 partial per (volume, tile, chunk) into a scratch; a
//     second small launch sums the partials of each channel in f64 in a
//     fixed order (batch, then tile and chunk), so dw is the same in every
//     run.
//   - accuracy: a channel's dw sums up to 8.4 M products (stage 0), and the
//     error of f32 sums grows with the length of each thread's chain of
//     adds and with the levels above it. bf16 inputs round far coarser than
//     that; for f32 the wrapper cuts the D chunk to 8 planes and each thread
//     adds 8 products at a time (a row's 8 voxels) to its running sum, so
//     the thread chains stay short, and the levels above them are f64.

#include <limits.h>
#include <string.h>

#include "dw_stage.cuh"

namespace {

using namespace dwk;

template <int K>
struct WCfg {
  static constexpr int NACC = Cfg<K>::K3 + 1;     // k^3 taps and the bias sum
};

// Raw words of one g row segment of 8 voxels, loaded now and converted
// later, so the load is in flight during the FMAs between.
template <typename T>
struct GRow {
  static constexpr int NW = kVW * sizeof(T) / 4;
  uint32_t wd[NW];
  // vec: src is 16-byte aligned and every 16-byte group is whole or out of
  // range (n is the count of valid voxels, from 0)
  __device__ __forceinline__ void load(const T* src, int n, bool vec) {
#pragma unroll
    for (int i = 0; i < NW; ++i) wd[i] = 0u;
    if (vec) {
      constexpr int per16 = 16 / sizeof(T);
#pragma unroll
      for (int q = 0; q < NW / 4; ++q) {
        if (q * per16 < n) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + q);
          wd[4 * q] = v.x; wd[4 * q + 1] = v.y; wd[4 * q + 2] = v.z; wd[4 * q + 3] = v.w;
        }
      }
    } else {
#pragma unroll
      for (int v = 0; v < kVW; ++v) {
        if (v < n) {
          if constexpr (sizeof(T) == 4) {
            wd[v] = __float_as_uint(__ldg(src + v));
          } else {
            const uint32_t h = __ldg(reinterpret_cast<const unsigned short*>(src) + v);
            wd[v / 2] |= (v & 1) ? (h << 16) : h;
          }
        }
      }
    }
  }
  __device__ __forceinline__ void to_float(float (&out)[kVW]) const {
    words_to_float<T, NW>(wd, out);
  }
};

// Sum acc in f64 over segments of `seg` threads (a power of two below 32,
// or a multiple of 32) and write each segment's sums to dst_of(segment),
// unless that is null; red is shared memory for (blockDim.x / 32) * NACC
// doubles that no thread still reads. Every thread of the block calls it.
template <int NACC, typename Dst>
__device__ __forceinline__ void block_reduce(const float (&acc)[NACC], double* red, int seg,
                                             Dst dst_of) {
  const int tid = threadIdx.x + blockDim.x * threadIdx.y;
  const int lanes = seg < 32 ? seg : 32;
  // one sum at a time, so only one double is live
  double* const dst_lane = seg <= 32 && tid % seg == 0 ? dst_of(tid / seg) : nullptr;
#pragma unroll
  for (int t = 0; t < NACC; ++t) {
    double sum = acc[t];
    for (int off = lanes / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (dst_lane != nullptr) dst_lane[t] = sum;
    if (seg > 32 && (tid & 31) == 0) red[(tid / 32) * NACC + t] = sum;
  }
  if (seg <= 32) return;
  __syncthreads();
  const int nw = seg / 32, s = tid / seg, ts = tid % seg;
  double* const dst = dst_of(s);
  if (dst == nullptr) return;
  for (int t = ts; t < NACC; t += seg) {
    double total = 0.0;
    for (int w = 0; w < nw; ++w) total += red[(s * nw + w) * NACC + t];
    dst[t] = total;
  }
}

template <typename T, int K, bool kTma>
__global__ void __launch_bounds__(kThreads, Cfg<K>::MINB)
dw_conv3_wgrad_tile_kernel(const __grid_constant__ CUtensorMap xmap, const T* __restrict__ x,
                           const T* __restrict__ g, double* __restrict__ part, int D, int H,
                           int W, int h_tiles, int w_tiles, int d_chunk, int n_chunks, int BW,
                           int BH) {
  using Cf = Cfg<K>;
  constexpr int P = Cf::P, VH = Cf::VH, K3 = Cf::K3, NWIN = Cf::NWIN, NACC = WCfg<K>::NACC;
  extern __shared__ unsigned char smem[];
  const int tx = threadIdx.x, ty = threadIdx.y;
  PlaneRing<T, K, kTma> ring;
  ring.setup(smem, &xmap, x, D, H, W, h_tiles, w_tiles, d_chunk, BW, BH);
  const int64_t vol = ring.vol;
  const int d_begin = ring.d_begin, d_end = ring.d_end;

  const int col0 = tx * kVW;
  const int n_cols = min(max(W - (ring.w0 + col0), 0), kVW);
  const bool g_vec = reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                     (static_cast<int64_t>(W) * sizeof(T)) % 16 == 0;
  const T* const gv = g + vol * D * static_cast<int64_t>(H) * W + ring.w0 + col0;
  int n_rows[VH];
#pragma unroll
  for (int vh = 0; vh < VH; ++vh) n_rows[vh] = ring.h0 + ty * VH + vh < H ? n_cols : 0;

  // this thread's g rows of plane j (zero outside the chunk)
  GRow<T> raw[VH];
  auto load_g = [&](int j) {
#pragma unroll
    for (int vh = 0; vh < VH; ++vh) {
      const int hh = ring.h0 + ty * VH + vh;
      const bool ok = j < d_end && n_rows[vh] > 0;
      raw[vh].load(gv + (static_cast<int64_t>(ok ? j : 0) * H + (ok ? hh : 0)) * W,
                   ok ? n_rows[vh] : 0, g_vec);
    }
  };

  float acc[NACC];
#pragma unroll
  for (int t = 0; t < NACC; ++t) acc[t] = 0.f;
  // x plane ordinal p (z = z_first + p) meets g plane d_begin + p - dz
  // through tap dz. At k = 3 the D loop is unrolled by 3 and gs[(j -
  // d_begin) % 3] holds g plane j, so the ring rotates by renaming; at
  // k = 5, whose 5-fold unrolled body is too large to keep the ring in
  // registers, gs[dz] holds plane d_begin + p - dz and the ring shifts by
  // moves (40 a plane against 1000 FMAs).
  constexpr int U = K == 3 ? K : 1;
  float gs[K][VH][kVW];
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int vh = 0; vh < VH; ++vh)
#pragma unroll
      for (int v = 0; v < kVW; ++v) gs[i][vh][v] = 0.f;
  load_g(d_begin);
#pragma unroll
  for (int vh = 0; vh < VH; ++vh) {
    raw[vh].to_float(gs[0][vh]);
#pragma unroll
    for (int v = 0; v < kVW; ++v) acc[K3] += gs[0][vh][v];
  }
  const int n = ring.n_planes;

  __syncthreads();                                  // barriers initialised
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < n) ring.issue(q);
    ring.commit();
  }
  for (int pb = 0; pb < n; pb += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = pb + u;
      if (p >= n) break;
      const bool next_g = d_begin + p + 1 < d_end;
      if (next_g) load_g(d_begin + p + 1);          // in flight during the FMAs
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
          for (int dz = 0; dz < K; ++dz) {
            const int slot = U == K ? (u - dz + K) % K : dz;
#pragma unroll
            for (int dx = 0; dx < K; ++dx) {
              float& sum = acc[(dz * K + dy) * K + dx];
              if constexpr (sizeof(T) == 4) {       // 8 products, then one add
                float row = gs[slot][vh][0] * win[dx];
#pragma unroll
                for (int v = 1; v < kVW; ++v) row = fmaf(gs[slot][vh][v], win[v + dx], row);
                sum += row;
              } else {
#pragma unroll
                for (int v = 0; v < kVW; ++v) sum = fmaf(gs[slot][vh][v], win[v + dx], sum);
              }
            }
          }
        }
      }
      __syncthreads();                              // buffer p % kStages is free
      // g plane d_begin + p + 1 replaces d_begin + p + 1 - K
      if (U != K) {
#pragma unroll
        for (int i = K - 1; i > 0; --i)
#pragma unroll
          for (int vh = 0; vh < VH; ++vh)
#pragma unroll
            for (int v = 0; v < kVW; ++v) gs[i][vh][v] = gs[i - 1][vh][v];
      }
      const int nxt = U == K ? (u + 1) % K : 0;
#pragma unroll
      for (int vh = 0; vh < VH; ++vh) {
        if (next_g) {
          raw[vh].to_float(gs[nxt][vh]);
#pragma unroll
          for (int v = 0; v < kVW; ++v) acc[K3] += gs[nxt][vh][v];
        } else {
#pragma unroll
          for (int v = 0; v < kVW; ++v) gs[nxt][vh][v] = 0.f;
        }
      }
    }
  }

  if constexpr (!kTma) cp_async_wait_all();
  __syncthreads();                                  // the ring is free for the reduction
  const int64_t n_part = static_cast<int64_t>(h_tiles) * w_tiles * n_chunks;
  const int64_t p_idx =
      (static_cast<int64_t>(ring.ht) * w_tiles + ring.wt) * n_chunks + blockIdx.y;
  double* const dst = part + (vol * n_part + p_idx) * NACC;
  block_reduce<NACC>(acc, reinterpret_cast<double*>(ring.buf), ring.nthreads,
                     [&](int) { return dst; });
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads, Cfg<K>::MINB)
dw_conv3_wgrad_volume_kernel(const __grid_constant__ CUtensorMap xmap, const T* __restrict__ g,
                             double* __restrict__ part, int64_t n_vol, int D, int H, int W,
                             int tpv, int G, int nwc, int nhc, int BW, int BH, int BD) {
  using Cf = Cfg<K>;
  constexpr int P = Cf::P, VH = Cf::VH, K3 = Cf::K3, NWIN = Cf::NWIN, NACC = WCfg<K>::NACC;
  constexpr int A = 16 / static_cast<int>(sizeof(T));   // staged columns left of 0
  extern __shared__ unsigned char smem[];
  const int box_elems = BW * BH * BD * G;
  const int64_t vol0 = static_cast<int64_t>(blockIdx.x) * G;
  const int gi = threadIdx.x / tpv, lane = threadIdx.x % tpv;
  const int64_t vol = vol0 + gi;
  const bool ok = gi < G && vol < n_vol;
  float acc[NACC];
#pragma unroll
  for (int t = 0; t < NACC; ++t) acc[t] = 0.f;
  T* const box = load_volumes<T, P>(smem, &xmap, box_elems, vol0);

  if (ok) {
    const T* const xs = box + static_cast<int64_t>(gi) * BD * BH * BW;
    const T* const gv = g + vol * D * static_cast<int64_t>(H) * W;
    const int S = nwc * nhc * D;
    for (int cell = lane; cell < S; cell += tpv) {
      const int wc = cell % nwc, t = cell / nwc, hc = t % nhc, d = t / nhc;
      const int n_cols = min(W - wc * kVW, kVW);
      float gr[VH][kVW];
#pragma unroll
      for (int vh = 0; vh < VH; ++vh) {
        const int hh = hc * VH + vh;
        GRow<T> raw;
        raw.load(gv + (static_cast<int64_t>(d) * H + (hh < H ? hh : 0)) * W + wc * kVW,
                 hh < H ? n_cols : 0, true);
        raw.to_float(gr[vh]);
#pragma unroll
        for (int v = 0; v < kVW; ++v) acc[K3] += gr[vh][v];
      }
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
              float sum = acc[(dz * K + dy) * K + dx];
#pragma unroll
              for (int v = 0; v < kVW; ++v) sum = fmaf(gr[vh][v], win[v + dx], sum);
              acc[(dz * K + dy) * K + dx] = sum;
            }
          }
        }
      }
    }
  }

  __syncthreads();                                  // the box is free for the reduction
  block_reduce<NACC>(acc, reinterpret_cast<double*>(box), tpv, [&](int s) -> double* {
    const int64_t v = vol0 + s;
    return s < G && v < n_vol ? part + v * NACC : nullptr;
  });
}

// dw[c, t] (t < k^3) and db[c] (t = k^3): the partials of channel c summed
// in f64 over batch, then tile and chunk, in that fixed order.
__global__ void dw_conv3_wgrad_reduce(const double* __restrict__ part, float* __restrict__ dw,
                                      float* __restrict__ db, int B, int C, int64_t n_part,
                                      int nacc) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(C) * nacc) return;
  const int c = static_cast<int>(i / nacc), t = static_cast<int>(i % nacc);
  double sum = 0.0;
  for (int b = 0; b < B; ++b) {
    const double* const src = part + (static_cast<int64_t>(b) * C + c) * n_part * nacc + t;
    for (int64_t p = 0; p < n_part; ++p) sum += src[p * nacc];
  }
  if (t < nacc - 1)
    dw[static_cast<int64_t>(c) * (nacc - 1) + t] = static_cast<float>(sum);
  else
    db[c] = static_cast<float>(sum);
}

// The partials per volume of a plan, or -1 for a route or plan the kernels
// do not take (the launch checks the pointers besides).
template <int K>
int64_t parts_per_volume(int D, int H, int W, int es, int route, int p0, int p1, int p2) {
  if (route == kRouteVolume) {
    VolumePlan pl;
    return make_volume_plan<K>(p0, p1, D, H, W, es, &pl) ? 1 : -1;
  }
  if (route != kRouteTma && route != kRouteCpAsync) return -1;
  TilePlan pl;
  if (!make_tile_plan<K>(p0, p1, p2, D, H, W, es, route == kRouteTma, &pl)) return -1;
  return static_cast<int64_t>(pl.h_tiles) * pl.w_tiles * pl.n_chunks;
}

template <typename T, int K>
cudaError_t launch(const void* x, const void* g, float* dw, float* db, double* part,
                   int64_t n_vol, int C, int D, int H, int W, int route, int p0, int p1, int p2,
                   cudaStream_t stream) {
  const int es = static_cast<int>(sizeof(T));
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  cudaError_t err;
  int64_t n_part = 1;
  if (route == kRouteVolume) {
    VolumePlan pl;
    if (!tma_ok(x, W, es) || !tma_ok(g, W, es) || !make_volume_plan<K>(p0, p1, D, H, W, es, &pl))
      return cudaErrorInvalidValue;
    const int64_t gx = ceil_div(n_vol, pl.G);
    if (gx > INT_MAX) return cudaErrorInvalidConfiguration;
    if ((err = encode_x_map<T>(&map, x, n_vol, D, H, W, pl.BW, pl.BH, pl.BD, pl.G)) != cudaSuccess)
      return err;
    // the block reduction reuses the box: it must hold a double per warp and sum
    const size_t red = 256 + static_cast<size_t>(pl.threads / 32) * WCfg<K>::NACC * sizeof(double);
    const size_t smem = pl.smem > red ? pl.smem : red;
    auto kern = dw_conv3_wgrad_volume_kernel<T, K>;
    if ((err = allow_smem(kern, smem)) != cudaSuccess) return err;
    kern<<<static_cast<unsigned>(gx), pl.threads, smem, stream>>>(
        map, static_cast<const T*>(g), part, n_vol, D, H, W, pl.tpv, pl.G, pl.nwc, pl.nhc,
        pl.BW, pl.BH, pl.BD);
  } else {
    if (route != kRouteTma && route != kRouteCpAsync) return cudaErrorInvalidValue;
    const bool tma = route == kRouteTma;
    TilePlan pl;
    if ((tma && (!tma_ok(x, W, es) || !tma_ok(g, W, es))) ||
        !make_tile_plan<K>(p0, p1, p2, D, H, W, es, tma, &pl))
      return cudaErrorInvalidValue;
    const int64_t gx = n_vol * pl.h_tiles * pl.w_tiles;
    if (gx > INT_MAX) return cudaErrorInvalidConfiguration;
    if (tma && (err = encode_x_map<T>(&map, x, n_vol, D, H, W, pl.BW, pl.BH, 1, 1)) != cudaSuccess)
      return err;
    // the block reduction reuses the ring: it must hold a double per warp and sum
    if (static_cast<size_t>(pl.bx * pl.by / 32) * WCfg<K>::NACC * sizeof(double) + 128 > pl.smem)
      return cudaErrorInvalidConfiguration;
    auto kern = tma ? dw_conv3_wgrad_tile_kernel<T, K, true>
                    : dw_conv3_wgrad_tile_kernel<T, K, false>;
    if ((err = allow_smem(kern, pl.smem)) != cudaSuccess) return err;
    kern<<<dim3(static_cast<unsigned>(gx), pl.n_chunks), dim3(pl.bx, pl.by), pl.smem, stream>>>(
        map, static_cast<const T*>(x), static_cast<const T*>(g), part, D, H, W, pl.h_tiles,
        pl.w_tiles, pl.d_chunk, pl.n_chunks, pl.BW, pl.BH);
    n_part = static_cast<int64_t>(pl.h_tiles) * pl.w_tiles * pl.n_chunks;
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t outs = static_cast<int64_t>(C) * WCfg<K>::NACC;
  dw_conv3_wgrad_reduce<<<static_cast<unsigned>(ceil_div(outs, 256)), 256, 0, stream>>>(
      part, dw, db, static_cast<int>(n_vol / C), C, n_part, WCfg<K>::NACC);
  return cudaGetLastError();
}

bool bad_shape(long long n_vol, int C, int D, int H, int W) {
  return n_vol <= 0 || C <= 0 || n_vol % C != 0 || D <= 0 || H <= 0 || W <= 0;
}

}  // namespace

// Doubles of f64 scratch that dw_conv3_wgrad needs for these shapes,
// dtype, route and plan (as dw_conv3_wgrad takes them), or -1 for
// arguments it does not take: k^3 + 1 sums per (volume, tile, chunk), or
// per volume on the volume route.
extern "C" long long dw_conv3_wgrad_scratch(long long n_vol, int C, int D, int H, int W, int k,
                                            int dtype, int route, int p0, int p1, int p2) {
  if (bad_shape(n_vol, C, D, H, W) || (dtype != 0 && dtype != 1)) return -1;
  const int es = dtype == 0 ? 4 : 2;
  int64_t parts;
  switch (k) {
    case 3: parts = parts_per_volume<3>(D, H, W, es, route, p0, p1, p2); break;
    case 5: parts = parts_per_volume<5>(D, H, W, es, route, p0, p1, p2); break;
    default: return -1;
  }
  return parts < 0 ? -1 : n_vol * parts * (k * k * k + 1);
}

// n_vol = B * C volumes of D x H x W in x and g; dtype: 0 = float32,
// 1 = bfloat16; route and (p0, p1, p2) as dw_conv3_forward takes them. dw
// (C * k^3 floats) and db (C floats) are f32 device buffers, scratch
// (dw_conv3_wgrad_scratch doubles) an f64 one; every element of dw, db and
// the scratch's used part is written, so none needs zeroing. Returns cudaGetLastError()
// after the two launches, or cudaErrorInvalidValue /
// cudaErrorInvalidConfiguration for arguments, a route or a plan the
// kernel does not take. Launches on `stream`, allocates nothing and does
// not synchronise.
extern "C" int dw_conv3_wgrad(const void* x, const void* g, void* dw, void* db, void* scratch,
                              long long n_vol, int C, int D, int H, int W, int k, int dtype,
                              int route, int p0, int p1, int p2, void* stream) {
  if (bad_shape(n_vol, C, D, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* const dwf = static_cast<float*>(dw);
  float* const dbf = static_cast<float*>(db);
  double* const part = static_cast<double*>(scratch);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && k == 3)
    err = launch<float, 3>(x, g, dwf, dbf, part, n_vol, C, D, H, W, route, p0, p1, p2, s);
  else if (dtype == 0 && k == 5)
    err = launch<float, 5>(x, g, dwf, dbf, part, n_vol, C, D, H, W, route, p0, p1, p2, s);
  else if (dtype == 1 && k == 3)
    err = launch<__nv_bfloat16, 3>(x, g, dwf, dbf, part, n_vol, C, D, H, W, route, p0, p1, p2, s);
  else if (dtype == 1 && k == 5)
    err = launch<__nv_bfloat16, 5>(x, g, dwf, dbf, part, n_vol, C, D, H, W, route, p0, p1, p2, s);
  return static_cast<int>(err);
}
