// Window tiles in shared memory for the window-attention kernels on Hopper
// (sm_90a): K1 (tiny-window attention, csrc/window_attention.cu) and K2
// (fused window attention, the `fused_window_attention_forward` entry of the
// same file), and both backwards (csrc/window_attention_backward.cu).
//
// A tile is W windows x Hg heads of every operand. Each (window, token) gives
// one staged row of Hg * D elements, the heads h0 .. h0 + Hg - 1 side by side
// whatever their order in device memory; a staged row's pitch is its 16-byte
// chunks made odd, so that eight rows at that pitch fall on eight different
// 16-byte bank groups (ldmatrix and 16-byte reads without bank conflicts).
// Operands are addressed through (window, token, head) element strides with a
// dense feature axis, one (token, head) segment of d features at a time.
//   - aligned (every base address and stride a multiple of 16 bytes, and d
//     whole 16-byte chunks): segments move as 16-byte cp.async copies, all
//     of a tile's in flight together;
//   - otherwise: element by element, synchronously.
// K1 takes d = D, one of its compiled widths. K2 takes any d <= 128 in the
// next compiled width D >= d ("TAIL"): features d .. D - 1 are staged as
// zeros, which add nothing to q k^T or g v^T, and are never stored.
// The tile plan (W, Hg, warps) comes from the wrapper (`_attn_plan` in
// kernels/window_attention.py), which sizes it by the same shared-memory
// formulas (each library exports its own as a query, and a card test holds
// the two equal); the entries check it and refuse what is out of range.
// Block b computes tile b: the grid is the tile count.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace attn {

constexpr int kMaxT = 16;               // K1: Tq, Tk <= 16
constexpr int kFusedMaxT = 32;          // K2: T <= 32 with 128 % T == 0
constexpr int kFusedMaxD = 128;         // K2: d <= 128
constexpr int kMaxWarps = 4;
constexpr int kSmemLimit = 48 * 1024;   // dynamic shared memory without opting in
constexpr int kSmemOptIn = 232448;      // the most a block may opt in to (227 KB)
constexpr int kWarpTileBytes = 1024;    // backward mma route: 8 bf16 8x8 matrices a warp

enum Route { kRouteMma = 0, kRouteFfma = 1 };

struct Layout {
  int64_t n, t, h;  // element strides of the window, token and head axes
};

__host__ __device__ inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Bytes between staged rows of hg * d elements of es bytes.
__host__ __device__ inline int pitch_bytes(int hg, int d, int es) {
  return (((hg * d * es) / 16) | 1) * 16;
}

// K2's compiled feature width for d: the least of 8, 16, 32, 64, 128 that
// holds d (`_fused_width` in kernels/fused_window_attention.py).
__host__ __device__ inline int fused_width(int d) {
  return d <= 8 ? 8 : d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128;
}

// The plan's tile grid: windows per tile W, heads per tile Hg, one block a
// tile.
struct Plan {
  int W, Hg, warps;
  int64_t n;        // windows
  int h, hgroups;   // heads, head groups (h / Hg)
  int64_t tiles;    // the grid
};

inline bool plan_ok(const Plan& p) {
  return p.W >= 1 && p.Hg >= 1 && p.h % p.Hg == 0 && p.warps >= 1 &&
         p.warps <= kMaxWarps && p.tiles <= INT32_MAX;
}

inline Plan make_plan(int64_t n, int h, int W, int Hg, int warps) {
  Plan p{W, Hg, warps, n, h, Hg > 0 ? h / Hg : 0, 0};
  if (W > 0) p.tiles = ceil_div(n, W) * p.hgroups;
  return p;
}

// Where tile `tile` starts: its first window and first head, and how many of
// its W windows lie before N.
struct TilePos {
  int64_t n0;
  int h0, nw;
};

__device__ __forceinline__ TilePos tile_pos(const Plan& p, uint32_t tile) {
  // 32-bit division (plan_ok keeps the tile count below 2^31): a 64-bit one
  // is a long call
  const uint32_t hg = static_cast<uint32_t>(p.hgroups), wt = tile / hg;
  TilePos t;
  t.n0 = static_cast<int64_t>(wt) * p.W;
  t.h0 = static_cast<int>(tile - wt * hg) * p.Hg;
  t.nw = static_cast<int>(p.n - t.n0 < p.W ? p.n - t.n0 : p.W);
  return t;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ---- cp.async, ldmatrix and mma.sync (PTX) ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 b16 matrices; lanes 8m .. 8m + 7 give the row addresses of matrix
// m, and lane l receives row l / 4, elements 2 (l % 4) and 2 (l % 4) + 1 of each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

// The same, transposed: lane l receives elements (2 (l % 4), l / 4) and
// (2 (l % 4) + 1, l / 4) of each matrix.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

// c += a b on m16n8k16, bf16 inputs, f32 sums. Lane l (g = l / 4, c = 2 (l % 4)):
// a[0] = A[g][c, c+1], a[1] = A[g+8][c, c+1], a[2] = A[g][c+8, c+9],
// a[3] = A[g+8][c+8, c+9]; b0 = B[c, c+1][g], b1 = B[c+8, c+9][g];
// c[0..1] = C[g][c, c+1], c[2..3] = C[g+8][c, c+1].
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x = hi + lo in bf16 pairs: hi the rounding of x, lo the rounding of what
// it leaves, so a bf16 product of an f32 operand keeps about 16 bits.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// p / d for a small divisor: (p * div_magic(d)) >> 16 is exact while p * d < 65536.
__host__ __device__ inline uint32_t div_magic(int d) { return (65536u + d - 1) / d; }

__device__ __forceinline__ int div_small(int p, uint32_t magic) {
  return static_cast<int>((static_cast<uint32_t>(p) * magic) >> 16);
}

// 2^x by the special-function unit (about 2 ulp; the mma routes round to bf16).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- staging and stores ----

// A thread's walk over the 16-byte chunks of a tile's staged rows: chunk ch
// of row `row`, kcr chunks a row, the block's threads side by side. Each step
// advances by the block's thread count without dividing.
struct Walk {
  int row, ch, drow, dch;
};

__device__ __forceinline__ Walk walk_start(int kcr) {
  return {static_cast<int>(threadIdx.x) / kcr, static_cast<int>(threadIdx.x) % kcr,
          static_cast<int>(blockDim.x) / kcr, static_cast<int>(blockDim.x) % kcr};
}

__device__ __forceinline__ void walk_next(Walk& it, int kcr) {
  it.ch += it.dch;
  it.row += it.drow;
  if (it.ch >= kcr) {
    it.ch -= kcr;
    ++it.row;
  }
}

// The walk's start for rows of hg heads of D elements of T: taken once a
// kernel, it serves every operand.
template <typename T, int D>
__device__ __forceinline__ Walk walk_for(int hg) {
  return walk_start(hg * (D * static_cast<int>(sizeof(T)) / 16));
}

// Bring rows (window w < nw, token t < rows_per_window, head hh < hg) of
// src, D elements each at (n0 + w) l.n + t l.t + (h0 + hh) l.h, into
// dst + (w * rows_per_window + t) * pitch + hh * D (pitch in elements).
// VEC: 16-byte cp.async copies from `start` (walk_for<T, D>(hg); the caller
// commits and waits); else synchronous element copies. RPW:
// rows_per_window when known at compile time, else 0. TAIL: only the first
// d features lie in src, the rest are staged as zeros (with VEC, d is whole
// 16-byte chunks).
template <typename T, int D, bool VEC, int RPW = 0, bool TAIL = false>
__device__ __forceinline__ void stage_rows(T* dst, int pitch, const T* __restrict__ src,
                                           Layout l, TilePos tp, int rows_per_window, int hg,
                                           Walk start, int d = D) {
  const int rpw = RPW ? RPW : rows_per_window;
  const T* base = src + tp.n0 * l.n + tp.h0 * l.h;
  if constexpr (VEC) {
    constexpr int kE = 16 / sizeof(T);   // elements a chunk
    constexpr int kC = D / kE;           // chunks a (token, head) segment
    const int kcr = hg * kC, rows = tp.nw * rpw;
    for (Walk it = start; it.row < rows; walk_next(it, kcr)) {
      const int w = it.row / rpw, t = it.row - w * rpw;
      const int hh = it.ch / kC, cc = it.ch % kC;
      T* to = dst + it.row * pitch + it.ch * kE;
      if (TAIL && cc * kE >= d)
        *reinterpret_cast<uint4*>(to) = make_uint4(0u, 0u, 0u, 0u);
      else
        cp_async16(to, base + w * l.n + t * l.t + hh * l.h + cc * kE);
    }
  } else {
    const int total = tp.nw * rpw * hg * D;
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int f = e % D, seg = e / D;
      const int hh = seg % hg, row = seg / hg;
      const int t = row % rpw, w = row / rpw;
      dst[row * pitch + hh * D + f] =
          TAIL && f >= d ? from_float<T>(0.f) : base[w * l.n + t * l.t + hh * l.h + f];
    }
  }
}

// The reverse: staged rows of src (shared) to dst through its strides, as
// 16-byte stores (VEC) or element stores; TAIL: the first d features only.
template <typename T, int D, bool VEC, int RPW = 0, bool TAIL = false>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, Layout l, const T* src,
                                           int pitch, TilePos tp, int rows_per_window, int hg,
                                           Walk start, int d = D) {
  const int rpw = RPW ? RPW : rows_per_window;
  T* base = dst + tp.n0 * l.n + tp.h0 * l.h;
  if constexpr (VEC) {
    constexpr int kE = 16 / sizeof(T);
    constexpr int kC = D / kE;
    const int kcr = hg * kC, rows = tp.nw * rpw;
    for (Walk it = start; it.row < rows; walk_next(it, kcr)) {
      const int w = it.row / rpw, t = it.row - w * rpw;
      const int hh = it.ch / kC, cc = it.ch % kC;
      if (TAIL && cc * kE >= d) continue;
      *reinterpret_cast<uint4*>(base + w * l.n + t * l.t + hh * l.h + cc * kE) =
          *reinterpret_cast<const uint4*>(src + it.row * pitch + it.ch * kE);
    }
  } else {
    const int total = tp.nw * rpw * hg * D;
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int f = e % D, seg = e / D;
      if (TAIL && f >= d) continue;
      const int hh = seg % hg, row = seg / hg;
      const int t = row % rpw, w = row / rpw;
      base[w * l.n + t * l.t + hh * l.h + f] = src[row * pitch + hh * D + f];
    }
  }
}

// D elements of a staged row to f32 registers, 16 bytes at a time.
template <typename T, int D>
__device__ __forceinline__ void load_row(const T* p, float (&r)[D]) {
  constexpr int kE = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < D; i += kE) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + i);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kE; ++j) r[i + j] = to_float(e[j]);
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_row(T* p, const float (&r)[D]) {
  constexpr int kE = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < D; i += kE) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < kE; ++j) e[j] = from_float<T>(r[i + j]);
    *reinterpret_cast<uint4*>(p + i) = raw;
  }
}

// Every base address and every stride (in bytes) a multiple of 16.
template <typename T>
inline bool aligned16(const void* const* ptrs, const Layout* l, int count) {
  for (int i = 0; i < count; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
    if ((l[i].n * sizeof(T)) % 16 || (l[i].t * sizeof(T)) % 16 || (l[i].h * sizeof(T)) % 16)
      return false;
  }
  return true;
}

}  // namespace attn
