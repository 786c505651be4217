// Weight and bias gradient of MedNeXt's stride-2 transposed depthwise conv
// (the default up block, `DepthwiseConv3D(transpose2=True)`) for Hopper
// (sm_90a), k in {3, 5}.
//
// Replaces no TPU kernel: the JAX package computes this conv with a jnp
// stencil (micformer_tpu/models/layers.py `dw_transpose2_stencil`) and leaves
// its gradient to XLA. On the card autograd handed the whole backward of
// `F.conv_transpose3d` to cuDNN, whose `convolveNd_wgrad_engine` took about
// 200 ms of a 249 ms MedNeXt-S b2 training step for dw alone; dx stays on
// cuDNN.
//
// For the module's own weight, with the flip folded into the indexing and
// p = k/2, along each axis of an output exactly 2L long:
//   dw[c, t] = sum over (b, q) of x[b, c, q] * g[b, c, 2q - t + p + 1]
// (a product over the three axes, terms outside [0, 2L) dropped), and
// db[c] = sum of g[b, c, ...]. By parity: g[2i + pi] meets x[i + e] through
// tap t = 2e + p + 1 - pi, for e in {-1, 0} (k = 3) or {-1, 0, 1} (k = 5).
//
// Layout: x contiguous [B, C, L_D, L_H, L_W] and g contiguous
// [B, C, 2L_D, 2L_H, 2L_W] of one dtype (f32 or bf16). Out: f32 dw [C, k^3]
// (the Conv3d weight [C, 1, k, k, k] flattened) and f32 db [C].
//
// Bound on an NVIDIA H100 80GB HBM3 at its 700 W limit, bf16, the up blocks
// of a MedNeXt-S b2 step at roi 128 (x and g read once, 2 k^3 operations per
// x voxel and one per g voxel, dw and db written):
//   [2, 512, 8^3]    9.4 MB   2.8 us     [2, 256, 16^3]  37.7 MB  11.3 us
//   [2, 128, 32^3] 151.0 MB  45.1 us     [2, 64, 64^3]  604.0 MB 180.3 us
// 0.24 ms in all for 802 MB at 3.35 TB/s; the 2.4 G operations take 0.036 ms
// at 67 TFLOP/s on the CUDA cores, so the bound is memory: g is 8/9 of it.
//
// Design, deterministic (no atomics):
//   - a cell is the 2 x 2 x 2 block of g at (2i, 2j, 2l): the 8 values that
//     share the x neighbourhood of (i, j, l). A thread owns 4 W-adjacent
//     cells of one (i, j) row, that is 4 g rows of 8 voxels (16 bytes each
//     in bf16), and walks D. Each g value is read from HBM once, by one
//     thread, with streaming (evict-first) 16-byte loads on the "vector"
//     route; the next cell row's g is in flight during the current one's
//     FMAs. x (1/8 of the bytes) is read through L1 with __ldg: a cell row
//     reads 4 (k = 3) or 9 (k = 5) x row windows of 5 or 6 values, which
//     neighbouring rows and the next D step read again from L1.
//   - one block per (volume, H x W tile of cells, D chunk): 1024 to 4096
//     blocks at the four shapes above, 1 to 8 D steps a thread, so the 132
//     SMs fill and each g load has enough loads beside it in flight.
//   - every thread keeps all k^3 + 1 sums in f32 registers; each tap takes
//     its 4 products of a cell row as one partial sum, so a thread's chain
//     of adds to a sum is one add per D step (at most 8), short in f32 as
//     in bf16. At the end each block reduces the sums over its threads in
//     f64 (warp shuffles, then shared memory across warps, in a fixed
//     order) and writes one f64 partial per block into a scratch; a second
//     small launch sums each channel's partials in f64 in a fixed order
//     (batch, then tile and chunk), so dw is the same in every run.
//   - the "scalar" route takes what the vector route cannot (L_W not a
//     multiple of 4, or a base not 16-byte aligned): element loads with
//     bounds, the same arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kCells = 4;            // W-adjacent cells a thread owns (8 g voxels a row)
constexpr int kSteps = 8;            // most D steps a thread takes (f32 chain length)
constexpr int kMinBlocks = 4 * 132;  // blocks that fill an H100's SMs a few times over
enum Route { kRouteVector = 0, kRouteScalar = 1 };

template <int K>
struct Cfg {
  static constexpr int P = K / 2;
  static constexpr int K3 = K * K * K;
  static constexpr int NACC = K3 + 1;            // k^3 taps and the bias sum
  static constexpr int EHI = K == 5 ? 1 : 0;     // x offsets e run over [-1, EHI]
  static constexpr int NWX = kCells + 1 + EHI;   // an x row window: x[i0 - 1 .. i0 + 3 + EHI]
};

// The tap through which g parity pi meets x offset e, or out of [0, K).
template <int K>
__host__ __device__ constexpr int tap(int e, int pi) {
  return 2 * e + K / 2 + 1 - pi;
}

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// One g row segment of 8 voxels as raw words, loaded now and converted
// later, so the load is in flight during the FMAs between.
template <typename T>
struct GRow {
  static constexpr int NW = 8 * sizeof(T) / 4;
  uint32_t wd[NW];
  // vec: src is 16-byte aligned and all 8 voxels lie in the row; else the
  // first n voxels (n <= 8) are loaded one by one and the rest are zero
  template <bool kVec>
  __device__ __forceinline__ void load(const T* src, int n) {
    if constexpr (kVec) {
#pragma unroll
      for (int q = 0; q < NW / 4; ++q) {
        const uint4 v = __ldcs(reinterpret_cast<const uint4*>(src) + q);
        wd[4 * q] = v.x; wd[4 * q + 1] = v.y; wd[4 * q + 2] = v.z; wd[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < NW; ++i) wd[i] = 0u;
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        if (v < n) {
          if constexpr (sizeof(T) == 4) {
            wd[v] = __float_as_uint(__ldcs(reinterpret_cast<const float*>(src) + v));
          } else {
            const uint32_t h = __ldcs(reinterpret_cast<const unsigned short*>(src) + v);
            wd[v / 2] |= (v & 1) ? (h << 16) : h;
          }
        }
      }
    }
  }
  __device__ __forceinline__ void to_float(float (&out)[8]) const {
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      if constexpr (sizeof(T) == 4) {
        out[i] = __uint_as_float(wd[i]);
      } else {
        out[2 * i] = __uint_as_float(wd[i] << 16);
        out[2 * i + 1] = __uint_as_float(wd[i] & 0xffff0000u);
      }
    }
  }
};

// The window x[i0 - 1 .. i0 + 3 + EHI] of one x row (row == nullptr: a row
// outside the volume, all zero). kVec: i0 and L_W are multiples of 4 and
// the row 16-byte aligned, so the 4 middle values are one 8- (bf16) or
// 16-byte (f32) load and only the ends need bounds.
template <typename T, int K, bool kVec>
__device__ __forceinline__ void load_window(const T* row, int i0, int LW,
                                            float (&xw)[Cfg<K>::NWX]) {
  constexpr int NWX = Cfg<K>::NWX;
#pragma unroll
  for (int i = 0; i < NWX; ++i) xw[i] = 0.f;
  if (row == nullptr) return;
  if constexpr (kVec) {
    if constexpr (sizeof(T) == 4) {
      const float4 m = __ldg(reinterpret_cast<const float4*>(row + i0));
      xw[1] = m.x; xw[2] = m.y; xw[3] = m.z; xw[4] = m.w;
    } else {
      const uint2 m = __ldg(reinterpret_cast<const uint2*>(row + i0));
      xw[1] = __uint_as_float(m.x << 16); xw[2] = __uint_as_float(m.x & 0xffff0000u);
      xw[3] = __uint_as_float(m.y << 16); xw[4] = __uint_as_float(m.y & 0xffff0000u);
    }
    if (i0 > 0) xw[0] = to_float(__ldg(row + i0 - 1));
    if constexpr (Cfg<K>::EHI > 0)
      if (i0 + kCells < LW) xw[NWX - 1] = to_float(__ldg(row + i0 + kCells));
  } else {
#pragma unroll
    for (int i = 0; i < NWX; ++i) {
      const int c = i0 - 1 + i;
      if (c >= 0 && c < LW) xw[i] = to_float(__ldg(row + c));
    }
  }
}

// A block of nt threads (a multiple of 32) owns a tile of by x-cell rows by
// bx * 4 cells of one volume and a chunk of zc cell planes; thread (tx, ty,
// tz) takes cell row (z0 + tz + s * bz, h0 + ty) for s = 0, 1, ... and the
// 4 cells from w0 + 4 tx. Each block writes its NACC sums, in f64, to
// part[(vol * h_tiles * w_tiles * n_chunks + tile * n_chunks + chunk) * NACC].
template <typename T, int K, bool kVec>
__global__ void __launch_bounds__(kMaxThreads, K == 3 ? 2 : 1)
dw_transpose2_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g,
                           double* __restrict__ part, int LD, int LH, int LW, int bx, int by,
                           int bz, int h_tiles, int w_tiles, int zc) {
  using Cf = Cfg<K>;
  constexpr int NACC = Cf::NACC, EHI = Cf::EHI, NWX = Cf::NWX;
  __shared__ double red[(kMaxThreads / 32) * NACC];

  const int tiles = h_tiles * w_tiles;
  const int64_t vol = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles, ht = tile / w_tiles, wt = tile % w_tiles;
  const int tid = threadIdx.x;
  const int tx = tid % bx, ty = (tid / bx) % by, tz = tid / (bx * by);
  const int i0 = (wt * bx + tx) * kCells;          // first x column of the thread's cells
  const int iy = ht * by + ty;
  const int z0 = blockIdx.y * zc;
  const int z1 = min(z0 + zc, LD);
  const bool active = tz < bz && i0 < LW && iy < LH;
  const int n_g = 2 * min(LW - i0, kCells);        // valid g voxels of a row segment
  const int GH = 2 * LH, GW = 2 * LW;
  const T* const xv = x + vol * LD * static_cast<int64_t>(LH) * LW;
  const T* const gv = g + vol * (2 * LD) * static_cast<int64_t>(GH) * GW + 2 * i0;

  float acc[NACC];
#pragma unroll
  for (int t = 0; t < NACC; ++t) acc[t] = 0.f;

  // g rows (2 iz + pz, 2 iy + py) of cell row iz, as gr[pz * 2 + py]
  GRow<T> cur[4], nxt[4];
  auto load_g = [&](GRow<T> (&gr)[4], int iz) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int64_t row = (static_cast<int64_t>(2 * iz + r / 2) * GH + 2 * iy + r % 2) * GW;
      gr[r].template load<kVec>(gv + row, n_g);
    }
  };
  int iz = z0 + tz;
  if (!active) iz = z1;
  if (iz < z1) load_g(cur, iz);
  for (; iz < z1; iz += bz) {
    const bool more = iz + bz < z1;
    if (more) load_g(nxt, iz + bz);                // in flight during this row's FMAs
    float gf[4][8];
    float gsum = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      cur[r].to_float(gf[r]);
#pragma unroll
      for (int v = 0; v < 8; ++v) gsum += gf[r][v];
    }
    acc[NACC - 1] += gsum;
#pragma unroll
    for (int ez = -1; ez <= EHI; ++ez) {
#pragma unroll
      for (int ey = -1; ey <= EHI; ++ey) {
        const int zz = iz + ez, yy = iy + ey;
        const bool in = zz >= 0 && zz < LD && yy >= 0 && yy < LH;
        float xw[NWX];
        load_window<T, K, kVec>(in ? xv + (static_cast<int64_t>(zz) * LH + yy) * LW : nullptr,
                                i0, LW, xw);
#pragma unroll
        for (int pz = 0; pz < 2; ++pz) {
          const int tz_ = tap<K>(ez, pz);
          if (tz_ < 0 || tz_ >= K) continue;
#pragma unroll
          for (int py = 0; py < 2; ++py) {
            const int ty_ = tap<K>(ey, py);
            if (ty_ < 0 || ty_ >= K) continue;
            const float (&gr)[8] = gf[pz * 2 + py];
#pragma unroll
            for (int px = 0; px < 2; ++px) {
#pragma unroll
              for (int ex = -1; ex <= EHI; ++ex) {
                const int tx_ = tap<K>(ex, px);
                if (tx_ < 0 || tx_ >= K) continue;
                // cell c's g voxel 2c + px meets x[i0 + c + ex] = xw[c + ex + 1]
                float row = gr[px] * xw[ex + 1];
#pragma unroll
                for (int c = 1; c < kCells; ++c) row = fmaf(gr[2 * c + px], xw[c + ex + 1], row);
                acc[(tz_ * K + ty_) * K + tx_] += row;
              }
            }
          }
        }
      }
    }
    if (more) {
#pragma unroll
      for (int r = 0; r < 4; ++r) cur[r] = nxt[r];
    }
  }

  // f64 sums over the block's threads: warps by shuffles, then across warps
  // in warp order
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
#pragma unroll
  for (int t = 0; t < NACC; ++t) {
    double s = acc[t];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) red[warp * NACC + t] = s;
  }
  __syncthreads();
  const int64_t n_part = static_cast<int64_t>(tiles) * gridDim.y;
  double* const dst = part + (vol * n_part + static_cast<int64_t>(tile) * gridDim.y +
                              blockIdx.y) * NACC;
  for (int t = tid; t < NACC; t += blockDim.x) {
    double total = 0.0;
    for (int w = 0; w < n_warps; ++w) total += red[w * NACC + t];
    dst[t] = total;
  }
}

// dw[c, t] (t < k^3) and db[c] (t = k^3): the partials of channel c summed
// in f64 over batch, then tile and chunk, in that fixed order.
__global__ void dw_transpose2_wgrad_reduce(const double* __restrict__ part,
                                           float* __restrict__ dw, float* __restrict__ db,
                                           int B, int C, int64_t n_part, int nacc) {
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

// The launch geometry, a function of the shape alone: threads bx along W
// (4 cells each), by along H, bz along D (as many as fill 256 threads), and
// the D chunk zc of bz * s cell planes, s the most steps (8, 4, 2 or 1) that
// still leave kMinBlocks blocks.
struct Plan {
  int bx, by, bz, nt, h_tiles, w_tiles, zc, n_chunks;
};

Plan make_plan(int64_t n_vol, int LD, int LH, int LW) {
  Plan p;
  const int segs = static_cast<int>(ceil_div(LW, kCells));
  p.bx = segs < 32 ? segs : 32;
  p.by = LH < kMaxThreads / p.bx ? LH : kMaxThreads / p.bx;
  p.bz = LD < kMaxThreads / (p.bx * p.by) ? LD : kMaxThreads / (p.bx * p.by);
  p.nt = static_cast<int>(ceil_div(p.bx * p.by * p.bz, 32) * 32);
  p.w_tiles = static_cast<int>(ceil_div(segs, p.bx));
  p.h_tiles = static_cast<int>(ceil_div(LH, p.by));
  for (int s = kSteps; s >= 1; s /= 2) {
    p.zc = p.bz * s < LD ? p.bz * s : LD;
    p.n_chunks = static_cast<int>(ceil_div(LD, p.zc));
    if (n_vol * p.h_tiles * p.w_tiles * p.n_chunks >= kMinBlocks) break;
  }
  return p;
}

bool bad_shape(long long n_vol, int C, int LD, int LH, int LW) {
  return n_vol <= 0 || C <= 0 || n_vol % C != 0 || LD <= 0 || LH <= 0 || LW <= 0 ||
         LD > INT_MAX / 2 || LH > INT_MAX / 2 || LW > INT_MAX / 2;
}

template <typename T, int K>
cudaError_t launch(const void* x, const void* g, float* dw, float* db, double* part,
                   int64_t n_vol, int C, int LD, int LH, int LW, int route,
                   cudaStream_t stream) {
  const bool vec = route == kRouteVector;
  if (!vec && route != kRouteScalar) return cudaErrorInvalidValue;
  if (vec && (LW % kCells != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(g) % 16 != 0))
    return cudaErrorInvalidValue;
  const Plan p = make_plan(n_vol, LD, LH, LW);
  const int64_t gx = n_vol * p.h_tiles * p.w_tiles;
  if (gx > INT_MAX || p.n_chunks > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(p.n_chunks));
  const T* const xt = static_cast<const T*>(x);
  const T* const gt = static_cast<const T*>(g);
  if (vec)
    dw_transpose2_wgrad_kernel<T, K, true><<<grid, p.nt, 0, stream>>>(
        xt, gt, part, LD, LH, LW, p.bx, p.by, p.bz, p.h_tiles, p.w_tiles, p.zc);
  else
    dw_transpose2_wgrad_kernel<T, K, false><<<grid, p.nt, 0, stream>>>(
        xt, gt, part, LD, LH, LW, p.bx, p.by, p.bz, p.h_tiles, p.w_tiles, p.zc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n_part = static_cast<int64_t>(p.h_tiles) * p.w_tiles * p.n_chunks;
  const int64_t outs = static_cast<int64_t>(C) * Cfg<K>::NACC;
  dw_transpose2_wgrad_reduce<<<static_cast<unsigned>(ceil_div(outs, 256)), 256, 0, stream>>>(
      part, dw, db, static_cast<int>(n_vol / C), C, n_part, Cfg<K>::NACC);
  return cudaGetLastError();
}

}  // namespace

// Doubles of f64 scratch that dw_transpose2_wgrad needs for n_vol = B * C
// volumes of x of L_D x L_H x L_W and kernel size k, or -1 for arguments it
// does not take: k^3 + 1 sums per block.
extern "C" long long dw_transpose2_wgrad_scratch(long long n_vol, int C, int LD, int LH, int LW,
                                                 int k) {
  if (bad_shape(n_vol, C, LD, LH, LW) || (k != 3 && k != 5)) return -1;
  const Plan p = make_plan(n_vol, LD, LH, LW);
  return n_vol * p.h_tiles * p.w_tiles * p.n_chunks * (k * k * k + 1);
}

// x: n_vol = B * C volumes of L_D x L_H x L_W; g: the same volumes at twice
// each extent; dtype: 0 = float32, 1 = bfloat16; route: 0 = vector (needs L_W
// a multiple of 4 and x and g 16-byte aligned), 1 = scalar. dw (C * k^3
// floats) and db (C floats) are f32 device buffers, scratch
// (dw_transpose2_wgrad_scratch doubles) an f64 one; every element of dw, db
// and the scratch is written, so none needs zeroing. Returns
// cudaGetLastError() after the two launches, or cudaErrorInvalidValue /
// cudaErrorInvalidConfiguration for arguments or a route the kernel does not
// take. Launches on `stream`, allocates nothing and does not synchronise.
extern "C" int dw_transpose2_wgrad(const void* x, const void* g, void* dw, void* db,
                                   void* scratch, long long n_vol, int C, int LD, int LH, int LW,
                                   int k, int dtype, int route, void* stream) {
  if (bad_shape(n_vol, C, LD, LH, LW)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* const dwf = static_cast<float*>(dw);
  float* const dbf = static_cast<float*>(db);
  double* const part = static_cast<double*>(scratch);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && k == 3)
    err = launch<float, 3>(x, g, dwf, dbf, part, n_vol, C, LD, LH, LW, route, s);
  else if (dtype == 0 && k == 5)
    err = launch<float, 5>(x, g, dwf, dbf, part, n_vol, C, LD, LH, LW, route, s);
  else if (dtype == 1 && k == 3)
    err = launch<__nv_bfloat16, 3>(x, g, dwf, dbf, part, n_vol, C, LD, LH, LW, route, s);
  else if (dtype == 1 && k == 5)
    err = launch<__nv_bfloat16, 5>(x, g, dwf, dbf, part, n_vol, C, LD, LH, LW, route, s);
  return static_cast<int>(err);
}
