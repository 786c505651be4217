// Staging of x planes for the depthwise k^3 kernels (csrc/dw_conv3.cu and
// csrc/dw_conv3_wgrad.cu) on Hopper (sm_90a): shared by both sources.
//
// Three routes bring halo'd x tiles into shared memory, in x's dtype:
//   - "tma": a CUtensorMap over x seen as 4-D (W, H, D, B*C); one thread
//     asks for a (BW x BH) box of one plane per stage, starting at
//     (w0 - A, h0 - p) with A = 16 bytes of elements, and an mbarrier per
//     stage counts its bytes. TMA's out-of-bounds zero fill is the SAME
//     padding: no predicates, no per-element loads. Needs x 16-byte aligned
//     and W * sizeof(T) % 16 == 0. The box starts A (not p) columns left of
//     the tile because on the H100 a box that reaches out of bounds from an
//     innermost start coordinate that is not a multiple of 16 bytes traps
//     (illegal instruction, measured); readers take the p halo columns from
//     whole words beside the tile's 16-byte-aligned columns.
//   - "volume": the same tensor map, one box of G whole halo'd volumes
//     (D, H, W <= 16) from (-A, -p, -p, first volume), loaded once.
//   - "cp_async": where TMA cannot describe x, every thread issues 4-byte
//     cp.async copies with src-size zero fill (f32: one element a copy;
//     bf16: aligned element pairs, so a staged row may start half a word
//     early and the reader shifts by that phase).
// A ring of kStages plane buffers keeps kStages - 1 planes in flight ahead
// of the one being computed.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace dwk {

constexpr int kVW = 8;            // W-adjacent outputs (or voxels) per thread
constexpr int kThreads = 256;     // threads per block, at most
constexpr int kStages = 4;        // plane buffers in the ring
constexpr int kMaxSmem = 227 * 1024;

enum Route { kRouteTma = 0, kRouteVolume = 1, kRouteCpAsync = 2 };

template <int K>
struct Cfg {
  static constexpr int P = K / 2;
  static constexpr int K3 = K * K * K;
  static constexpr int VH = K == 3 ? 2 : 1;      // rows per thread
  static constexpr int NWIN = kVW + 2 * P;       // staged values a thread reads per row
  static constexpr int MINB = K == 3 ? 2 : 1;    // blocks per SM the registers allow
};

__host__ __device__ inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }
__host__ __device__ inline int64_t round_up(int64_t a, int64_t b) { return ceil_div(a, b) * b; }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 32-bit words of T values -> f32 (bf16: two per word, low half first).
template <typename T, int NW>
__device__ __forceinline__ void words_to_float(const uint32_t (&wd)[NW],
                                               float (&out)[NW * 4 / sizeof(T)]) {
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

// N values from a 16-byte-aligned address as words, 16 bytes a load where
// they fit, then 8, then 4.
template <typename T, int N>
__device__ __forceinline__ void load_words(const T* p, uint32_t (&wd)[N * sizeof(T) / 4]) {
  constexpr int NB = N * static_cast<int>(sizeof(T));
  static_assert(NB % 4 == 0, "whole words only");
  const char* c = reinterpret_cast<const char*>(p);
  int off = 0;
#pragma unroll
  for (int i = 0; i < NB / 16; ++i, off += 16) {
    const uint4 q = *reinterpret_cast<const uint4*>(c + off);
    wd[off / 4] = q.x; wd[off / 4 + 1] = q.y; wd[off / 4 + 2] = q.z; wd[off / 4 + 3] = q.w;
  }
  if constexpr ((NB % 16) >= 8) {
    const uint2 q = *reinterpret_cast<const uint2*>(c + (NB / 16) * 16);
    wd[(NB / 16) * 4] = q.x; wd[(NB / 16) * 4 + 1] = q.y;
  }
  if constexpr ((NB % 8) == 4) wd[NB / 4 - 1] = *reinterpret_cast<const uint32_t*>(c + NB - 4);
}

// N staged values from a 16-byte-aligned shared address, as f32.
template <typename T, int N>
__device__ __forceinline__ void read_row(const T* p, float (&out)[N]) {
  uint32_t wd[N * sizeof(T) / 4];
  load_words<T, N>(p, wd);
  words_to_float<T>(wd, out);
}

// The 8 + 2P values around 8 staged values that start at a 16-byte-aligned
// address p: P before them, the 8, P after them; each side is read as the
// whole aligned words next to the 8.
template <typename T, int P>
__device__ __forceinline__ void read_row_halo(const T* p, float (&out)[kVW + 2 * P]) {
  constexpr int SN = ((P * static_cast<int>(sizeof(T)) + 3) / 4) * 4 / static_cast<int>(sizeof(T));
  float side[SN], mid[kVW];
  read_row<T, SN>(p - SN, side);
#pragma unroll
  for (int i = 0; i < P; ++i) out[i] = side[SN - P + i];
  read_row<T, kVW>(p, mid);
#pragma unroll
  for (int v = 0; v < kVW; ++v) out[P + v] = mid[v];
  read_row<T, SN>(p + kVW, side);
#pragma unroll
  for (int i = 0; i < P; ++i) out[P + kVW + i] = side[i];
}

// N staged values from an address of any element alignment, as f32.
template <typename T, int N>
__device__ __forceinline__ void read_row_scalar(const T* p, float (&out)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_float(p[i]);
}

// Store 8 f32 values as T to dst[0 .. n) (n <= 8); vec: dst is 16-byte
// aligned, so whole 16-byte groups go as vector stores.
template <typename T>
__device__ __forceinline__ void store_row(T* dst, const float (&v)[kVW], int n, bool vec) {
  if constexpr (sizeof(T) == 2) {
    if (vec && n >= kVW) {
      uint4 q;
      uint32_t* u = reinterpret_cast<uint32_t*>(&q);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        u[i] = *reinterpret_cast<const uint32_t*>(&h);
      }
      *reinterpret_cast<uint4*>(dst) = q;
      return;
    }
  } else {
    if (vec && n >= 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      if (n >= kVW) {
        *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
        return;
      }
#pragma unroll
      for (int i = 4; i < kVW; ++i)
        if (i < n) dst[i] = from_float<T>(v[i]);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < kVW; ++i)
    if (i < n) dst[i] = from_float<T>(v[i]);
}

// ---- mbarrier, TMA and cp.async (PTX) ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Order this thread's earlier generic-proxy accesses of shared memory before
// the async proxy's (TMA) writes that follow.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// 4 bytes global -> shared; the last 4 - src_bytes bytes are zero filled.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---- the plane ring of the D-walking (tile) kernels ----

// Block geometry of a tile kernel: blockDim (bx, by), thread (tx, ty) owns
// VH rows x 8 columns of the TH x TW tile at (h0, w0) of volume `vol`; the
// ring stages input planes z_first .. z_first + n_planes - 1, plane ordinal
// p in buffer p % kStages. Staged element (r, s) of a buffer is x at
// (h0 - P + r, w0 - L + s), at element r * BW + s (+ the row's phase on
// the bf16 cp_async route); L = A on the TMA route, P on the cp_async one.
template <typename T, int K, bool kTma>
struct PlaneRing {
  static constexpr int P = K / 2;
  static constexpr int A = 16 / static_cast<int>(sizeof(T));   // 16 bytes of elements
  const CUtensorMap* map;
  const T* x;
  T* buf;                 // first buffer (128-byte aligned)
  uint32_t buf_s, bar_s;  // shared addresses of the first buffer and barrier
  int stage_elems;        // elements from one buffer to the next
  int BW, BH, NE;         // buffer pitch and rows; staged columns TW + 2P
  int64_t vol;
  int D, H, W, ht, wt, h0, w0, d_begin, d_end, z_first, n_planes;
  int tid, nthreads;

  // This block's tile (blockIdx.x: volume, H tile, W tile with W fastest;
  // blockIdx.y: D chunk), the ring carved out of dynamic shared memory and
  // its barriers initialised (the caller synchronises the block before the
  // first issue).
  __device__ void setup(unsigned char* smem, const CUtensorMap* xmap, const T* x_, int D_,
                        int H_, int W_, int h_tiles, int w_tiles, int d_chunk, int bw, int bh) {
    map = xmap;
    x = x_;
    D = D_;
    H = H_;
    W = W_;
    int64_t bid = blockIdx.x;
    wt = static_cast<int>(bid % w_tiles);
    bid /= w_tiles;
    ht = static_cast<int>(bid % h_tiles);
    vol = bid / h_tiles;
    h0 = ht * blockDim.y * Cfg<K>::VH;
    w0 = wt * blockDim.x * kVW;
    d_begin = blockIdx.y * d_chunk;
    d_end = min(D, d_begin + d_chunk);
    z_first = d_begin - P;
    n_planes = d_end - d_begin + 2 * P;
    tid = threadIdx.y * blockDim.x + threadIdx.x;
    nthreads = blockDim.x * blockDim.y;
    const uintptr_t base = (reinterpret_cast<uintptr_t>(smem) + 127) & ~uintptr_t(127);
    buf = reinterpret_cast<T*>(base);
    BW = bw;
    BH = bh;
    NE = blockDim.x * kVW + 2 * P;
    const int stage_bytes = static_cast<int>(round_up(static_cast<int64_t>(BW) * BH * sizeof(T), 128));
    stage_elems = stage_bytes / static_cast<int>(sizeof(T));
    buf_s = smem_addr(buf);
    bar_s = buf_s + kStages * stage_bytes;
    if (kTma && tid == 0) {
#pragma unroll
      for (int s = 0; s < kStages; ++s) mbar_init(bar_s + 8 * s, 1);
      mbar_fence_init();
    }
  }

  // Start bringing plane ordinal p into buffer p % kStages.
  __device__ void issue(int p) {
    const int s = p % kStages;
    const int z = z_first + p;
    if constexpr (kTma) {
      if (tid == 0) {
        fence_proxy_async();
        mbar_expect_tx(bar_s + 8 * s, static_cast<uint32_t>(BW * BH * sizeof(T)));
        tma_load_4d(buf_s + static_cast<uint32_t>(s * stage_elems * sizeof(T)), map,
                    bar_s + 8 * s, w0 - A, h0 - P, z, static_cast<int>(vol));
      }
    } else {
      const bool z_ok = z >= 0 && z < D;
      const uint32_t dst0 = buf_s + static_cast<uint32_t>(s * stage_elems * sizeof(T));
      if constexpr (sizeof(T) == 4) {
        const T* const xv = x + (vol * D + (z_ok ? z : 0)) * static_cast<int64_t>(H) * W;
        const int total = BH * NE;
        for (int i = tid; i < total; i += nthreads) {
          const int r = i / NE, c = i - r * NE;
          const int h = h0 - P + r, col = w0 - P + c;
          const bool ok = z_ok && h >= 0 && h < H && col >= 0 && col < W;
          cp_async4(dst0 + static_cast<uint32_t>(r * BW + c) * 4,
                    ok ? static_cast<const void*>(xv + static_cast<int64_t>(h) * W + col) : x,
                    ok ? 4 : 0);
        }
      } else {
        // aligned pairs: word j of row r holds columns ca = w0 - P - phi + 2j
        // and ca + 1, phi the parity of the row's first element's address
        // (x's element address xe + e), and the reader shifts by phi
        const int nwr = (NE + 2) / 2;
        const int total = BH * nwr;
        const int64_t xe = static_cast<int64_t>(reinterpret_cast<uintptr_t>(x) >> 1);
        const void* const x_word = reinterpret_cast<const void*>(reinterpret_cast<uintptr_t>(x) &
                                                                 ~uintptr_t(3));
        for (int i = tid; i < total; i += nthreads) {
          const int r = i / nwr, j = i - r * nwr;
          const int h = h0 - P + r;
          const bool row_ok = z_ok && h >= 0 && h < H;
          const int64_t e0 = ((vol * D + z) * H + h) * static_cast<int64_t>(W) + (w0 - P);
          const int phi = static_cast<int>((xe + e0) & 1);
          const int ca = w0 - P - phi + 2 * j;
          const bool va = row_ok && ca >= 0 && ca < W;
          const bool vb = row_ok && ca + 1 >= 0 && ca + 1 < W;
          // a word whose low half is column -1 and high half column 0 is
          // copied whole (its low half lies in x's allocation: the row
          // before, or the 4-byte word that holds x's first element); the
          // reader zeroes column -1 (see read)
          const int bytes = vb ? 4 : (va ? 2 : 0);
          const void* const src =
              bytes ? reinterpret_cast<const void*>(static_cast<uintptr_t>(2 * (xe + e0 - phi + 2 * j)))
                    : x_word;
          cp_async4(dst0 + static_cast<uint32_t>(r * BW + 2 * j) * 2, src, bytes);
        }
      }
    }
  }

  __device__ void commit() {
    if constexpr (!kTma) cp_async_commit();
  }

  // Wait until plane ordinal p has landed and is visible to every thread.
  __device__ void wait(int p) {
    if constexpr (kTma) {
      mbar_wait(bar_s + 8 * (p % kStages), (p / kStages) & 1);
    } else {
      cp_async_wait<kStages - 1>();
      __syncthreads();
    }
  }

  // The first element of staged row r of plane ordinal p, and the element
  // offset of the row's first staged column (the bf16 cp_async phase).
  __device__ const T* row(int p, int r) const {
    const T* const b = buf + (p % kStages) * stage_elems + r * BW;
    if constexpr (kTma || sizeof(T) == 4) {
      return b;
    } else {
      const int64_t xe = static_cast<int64_t>(reinterpret_cast<uintptr_t>(x) >> 1);
      const int64_t e0 = ((vol * D + z_first + p) * H + (h0 - P + r)) * static_cast<int64_t>(W) +
                         (w0 - P);
      return b + static_cast<int>((xe + e0) & 1);
    }
  }

  // The NWIN = 8 + 2P values of staged row r of plane ordinal p that x
  // columns w0 + col0 - P .. w0 + col0 + 7 + P hold, as f32 (col0 a
  // multiple of 8).
  template <int NWIN>
  __device__ __forceinline__ void read(int p, int r, int col0, float (&win)[NWIN]) const {
    if constexpr (kTma) {
      read_row_halo<T, P>(row(p, r) + col0 + A, win);
    } else if constexpr (sizeof(T) == 4) {
      read_row<T, NWIN>(row(p, r) + col0, win);     // 16-byte aligned
    } else {
      read_row_scalar<T, NWIN>(row(p, r) + col0, win);
      // column -1 may hold the word-mate of column 0 (see issue)
      if (w0 == 0 && col0 == 0) win[P - 1] = 0.f;
    }
  }
};

// ---- the whole-volume box ----

// Bring the box of halo'd volumes vol0, vol0 + 1, ... (box_elems elements,
// from (-A, -P, -P, vol0)) into shared memory, behind a barrier in a
// 128-byte slot of its own, and wait for it. Every thread calls it; it
// returns the box.
template <typename T, int P>
__device__ __forceinline__ T* load_volumes(unsigned char* smem, const CUtensorMap* xmap,
                                           int box_elems, int64_t vol0) {
  constexpr int A = 16 / static_cast<int>(sizeof(T));
  unsigned char* const base =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem) + 127) & ~uintptr_t(127));
  T* const buf = reinterpret_cast<T*>(base + 128);
  const uint32_t bar = smem_addr(base);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, static_cast<uint32_t>(box_elems * sizeof(T)));
    tma_load_4d(smem_addr(buf), xmap, bar, -A, -P, -P, static_cast<int>(vol0));
  }
  mbar_wait(bar, 0);
  return buf;
}

// ---- tensor maps ----

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no -lcuda.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tiled map over x [n_vol, D, H, W] seen as 4-D (W, H, D, n_vol), boxes of
// (bw, bh, bd, bv) elements, zero fill out of bounds.
template <typename T>
cudaError_t encode_x_map(CUtensorMap* map, const void* x, int64_t n_vol, int D, int H, int W,
                         int bw, int bh, int bd, int bv) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t es = sizeof(T);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(n_vol)};
  const cuuint64_t strides[3] = {W * es, static_cast<cuuint64_t>(H) * W * es,
                                 static_cast<cuuint64_t>(D) * H * W * es};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(bw), static_cast<cuuint32_t>(bh),
                             static_cast<cuuint32_t>(bd), static_cast<cuuint32_t>(bv)};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        4, const_cast<void*>(x), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Whether TMA can describe a tensor at x with rows of W elements of es bytes.
inline bool tma_ok(const void* x, int W, int es) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && (static_cast<int64_t>(W) * es) % 16 == 0;
}

// Shared memory of a tile kernel's ring (with the alignment slack and the
// barriers after the buffers) and of a volume kernel's box (the barrier
// first, in a 128-byte slot of its own).
inline size_t ring_smem(int bw, int bh, int es) {
  return 128 + kStages * round_up(static_cast<int64_t>(bw) * bh * es, 128) + 8 * kStages;
}
inline size_t volume_smem(int64_t box_elems, int es) {
  return 128 + 128 + round_up(box_elems * es, 128);
}

// The tile geometry a tile kernel is launched with.
struct TilePlan {
  int bx, by, TH, TW, BW, BH, NE, h_tiles, w_tiles, d_chunk, n_chunks;
  size_t smem;
};

// bx x by threads, chunk planes along D; TMA rows start 16 bytes left of
// the tile and are padded to 16 bytes, cp_async rows hold one element more
// for the bf16 phase. Returns false for a plan the kernels cannot take.
template <int K>
bool make_tile_plan(int bx, int by, int chunk, int D, int H, int W, int es, bool tma,
                    TilePlan* pl) {
  using Cf = Cfg<K>;
  if (bx < 1 || by < 1 || chunk < 1 || bx * by > kThreads || (bx * by) % 32 != 0) return false;
  pl->bx = bx;
  pl->by = by;
  pl->TH = by * Cf::VH;
  pl->TW = bx * kVW;
  pl->NE = pl->TW + 2 * Cf::P;
  // TMA: A = 16 / es columns left of the tile, P right of it; cp_async:
  // P left, P right and one for the bf16 phase
  pl->BW = tma ? static_cast<int>(round_up(16 / es + pl->TW + Cf::P, 16 / es))
               : static_cast<int>(round_up(pl->NE + 2, 8));
  pl->BH = pl->TH + 2 * Cf::P;
  if (tma && (pl->BW > 256 || pl->BH > 256)) return false;
  pl->h_tiles = static_cast<int>(ceil_div(H, pl->TH));
  pl->w_tiles = static_cast<int>(ceil_div(W, pl->TW));
  pl->d_chunk = chunk < D ? chunk : D;
  pl->n_chunks = static_cast<int>(ceil_div(D, pl->d_chunk));
  pl->smem = ring_smem(pl->BW, pl->BH, es);
  return pl->smem <= static_cast<size_t>(kMaxSmem) && pl->n_chunks <= 65535;
}

// The whole-volume geometry: G volumes of tpv threads a block; cells of
// VH rows x 8 columns of one plane.
struct VolumePlan {
  int tpv, G, threads, nwc, nhc, S, BW, BH, BD;
  size_t smem;
};

template <int K>
bool make_volume_plan(int tpv, int G, int D, int H, int W, int es, VolumePlan* pl) {
  using Cf = Cfg<K>;
  if (D > 16 || H > 16 || W > 16 || tpv < 1 || G < 1 || (tpv & (tpv - 1)) != 0 ||
      tpv * G > kThreads || G > 256)
    return false;
  pl->tpv = tpv;
  pl->G = G;
  pl->threads = static_cast<int>(round_up(tpv * G, 32));
  pl->nwc = static_cast<int>(ceil_div(W, kVW));
  pl->nhc = static_cast<int>(ceil_div(H, Cf::VH));
  pl->S = pl->nwc * pl->nhc * D;
  pl->BW = static_cast<int>(round_up(16 / es + pl->nwc * kVW + Cf::P, 16 / es));
  pl->BH = pl->nhc * Cf::VH + 2 * Cf::P;
  pl->BD = D + 2 * Cf::P;
  pl->smem = volume_smem(static_cast<int64_t>(pl->BW) * pl->BH * pl->BD * G, es);
  return pl->smem <= static_cast<size_t>(kMaxSmem);
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace dwk
