// Biased window attention for Hopper (sm_90a):
//   out = softmax(q k^T * scale + bias + mask) v
// per window and head, on [N, T, h, d] operands with T <= 512 and d in {16, 32},
// in bf16 or f16. bias is [h, T, T]; mask is [nW, T] region ids (pairs of unequal ids
// get -100, the Swin convention) or [nW, T, T] additive, window n taking mask[n % nW].
//
// It replaces no TPU kernel: the JAX package computes biased and masked window
// attention with XLA (micformer_tpu/ops/attention.py), and the port's mirror of that
// chain (`attention_chain`, ops/attention.py) writes the [N, h, T, T] scores to device
// memory about ten times (logits, + bias, + mask, - max, exp, an f32 copy, the sum, the
// P v read). Here the scores never leave the registers.
//
// Bound: the exponentials. At SwinUNETR's 7^3 windows (T = 343, d = 16) a score costs
// one exponential on the special-function units (about 3.9e12 a second on the H100),
// 4 d = 64 tensor-core operations (q k^T and P v; 989 TFLOP/s) and 4 T d * 2 / T^2 =
// 0.37 bytes of q, k, v and out (3.35 TB/s): the exponential's 0.26 ns beat the bytes'
// 0.11 and the products' 0.065. The per-score softmax work on the FP32 pipe (scale and
// bias in one FMA, the mask's select, the max, the exponent's FMA, the sum, the bf16
// pack) is about as long as the exponential, and the bias is the largest per-score read.
//
// Design:
//   - A block takes one head, a tile of 16 W query rows (W warps, one m16n8k16 row block
//     each) and a strided set of windows n = g, g + G, ... Its tile's bias rows for that
//     head ([16 W, T] in the working type, 124 KB at SwinUNETR's W = 11) are staged in
//     shared memory once and serve every window of the block, so the bias is read from
//     device memory or L2 once a block, not once a window. K and V of the head (T x d
//     each, 16 KB at d = 16) and the tile's Q rows are staged whole by 16-byte cp.async
//     copies (element copies for unaligned operands), double-buffered where shared
//     memory allows, so that the next window's copies overlap this window's math.
//   - A warp walks the keys in chunks of 32: S = Q K^T by mma.sync.m16n8k16 (K by
//     ldmatrix), then on the f32 fragments: x = S scale + bias (+ -100 where the region
//     ids of the pair differ, the ids compared in registers; or + the additive mask),
//     an online softmax (running max and sum per row; exp2 by the special-function unit
//     with log2(e) folded into one FMA, one exponential a score and two a row a chunk
//     for the rescale), then P rounded once to the working type as the A operand of
//     O += P V (V by ldmatrix.trans). Keys past T, up to the chunk, get -inf before the
//     max. Logits, softmax and sums are f32; the row sums add the unrounded P.
//   - The grid is h x ceil(T / 16 W) tiles x G window groups, the plan of the wrapper
//     (`_bwa_plan`, `_bwa_groups` in kernels/biased_window_attention.py): W the most
//     warps (up to 16) whose bias rows and buffers fit the 227 KB a block can opt in
//     to, G the window groups that fill the SMs' block slots in whole waves.
//
// Layout: q, k and v through (window, token, head) element strides with a dense feature
// axis (the [N, T, h, d] slices of a fused qkv projection included); bias contiguous
// [h, T, T] and an additive mask contiguous [nW, T, T], both in the working type; ids
// contiguous int32 [nW, T]; out contiguous [N, T, h, d].

#include <cuda_fp16.h>
#include <math_constants.h>

#include <type_traits>

#include "attn_tile.cuh"

namespace {

using attn::Layout;
using bf16 = __nv_bfloat16;

constexpr int kChunk = 32;            // keys a step of the online softmax
constexpr int kMaxT = 512;
constexpr int kMaxWarps = 16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskValue = -100.f;  // ops/attention.py MASK_VALUE

enum MaskKind { kNoMask = 0, kIds = 1, kAdditive = 2 };

// Keys padded to whole chunks: the staged K and V rows and the bias columns.
__host__ __device__ constexpr int chunked(int t) { return (t + kChunk - 1) / kChunk * kChunk; }

// Elements between staged K, V or Q rows of d 16-bit features: their 16-byte chunks
// made odd (attn::pitch_bytes), so ldmatrix's eight rows fall on eight bank groups.
__host__ __device__ constexpr int row_pitch(int d) { return ((d * 2 / 16) | 1) * 8; }

// Elements between staged bias rows: tc + 8, whose 4-byte words are an odd multiple of
// 4, so the eight rows of a fragment's pair loads fall on eight bank groups.
__host__ __device__ constexpr int bias_pitch(int tc) { return tc + 8; }

// Bytes of one window buffer: K and V rows (tc each), the tile's Q rows, the ids.
__host__ __device__ constexpr int buffer_bytes(int tc, int rows, int d) {
  return (2 * tc + rows) * row_pitch(d) * 2 + tc * 4;
}

// Bytes of shared memory of a block of `warps` warps: the bias rows, then `bufs` window
// buffers (`_bwa_smem` in kernels/biased_window_attention.py is held equal on the card).
__host__ __device__ constexpr int smem_bytes(int t, int d, int warps, int bufs) {
  return warps * 16 * bias_pitch(chunked(t)) * 2 +
         bufs * buffer_bytes(chunked(t), warps * 16, d);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* bias;   // [h, T, T] or null
  const void* mask;   // [nW, T] int32, [nW, T, T] additive, or null
  void* out;          // [N, T, h, d]
  Layout lq, lk, lv;
  long long n, nw;
  int t, h, qtiles, groups, bufs;
  float scale;
  bool vec;
};

// The working type's pairs and elements as f32, and f32 pairs packed to it.
template <typename T>
struct Elem;

template <>
struct Elem<bf16> {
  __device__ static float2 unpack(uint32_t u) {
    return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
  }
  __device__ static float one(uint16_t u) { return __uint_as_float(static_cast<uint32_t>(u) << 16); }
  __device__ static uint32_t pack(float lo, float hi) { return attn::pack_bf16(lo, hi); }
};

template <>
struct Elem<__half> {
  __device__ static float2 unpack(uint32_t u) {
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
  }
  __device__ static float one(uint16_t u) { return __half2float(__ushort_as_half(u)); }
  __device__ static uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// c += a b on m16n8k16 in the working type, f32 sums (the fragments of attn::mma16816).
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  if constexpr (std::is_same_v<T, bf16>) {
    attn::mma16816(c, a, b0, b1);
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One warp's 16 query rows of window n against all its keys. kb, vb, qb: the staged K, V
// and Q rows (Q from the tile's first row); ib: the staged ids; bias_s: the tile's bias
// rows; r0: the tile's first token; wr: the warp's first row in the tile.
template <typename T, int D, int MASK>
__device__ __forceinline__ void window_rows(const Args& a, const uint16_t* bias_s, int bp,
                                            const bf16* kb, const bf16* vb, const bf16* qb,
                                            const int* ib, long long n, int head, int r0,
                                            int wr, int tc) {
  constexpr int kRp = row_pitch(D);
  constexpr int KS = D / 16;   // k16 steps of q k^T; 16-feature blocks of P v
  const int lane = threadIdx.x & 31, g = lane >> 2, c2 = (lane & 3) * 2;
  const int row0 = r0 + wr + g, row1 = row0 + 8;   // the tokens of this lane's two rows
  uint32_t qa[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s)
    attn::ldsm_x4(qa[s], qb + (wr + (lane & 7) + 8 * ((lane >> 3) & 1)) * kRp + 16 * s +
                             8 * (lane >> 4));
  int id0 = 0, id1 = 0;
  if constexpr (MASK == kIds) {
    id0 = ib[min(row0, a.t - 1)];
    id1 = ib[min(row1, a.t - 1)];
  }
  const uint16_t *m0 = nullptr, *m1 = nullptr;
  if constexpr (MASK == kAdditive) {
    const uint16_t* base =
        static_cast<const uint16_t*>(a.mask) + (n % a.nw) * a.t * static_cast<long long>(a.t);
    if (row0 < a.t) m0 = base + static_cast<long long>(row0) * a.t;
    if (row1 < a.t) m1 = base + static_cast<long long>(row1) * a.t;
  }
  const uint16_t* b0 = bias_s + (wr + g) * bp + c2;
  const uint16_t* b1 = b0 + 8 * bp;
  float o[2 * KS][4];
#pragma unroll
  for (int f = 0; f < 2 * KS; ++f) o[f][0] = o[f][1] = o[f][2] = o[f][3] = 0.f;
  float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

  for (int cb = 0; cb < tc; cb += kChunk) {
    float s[4][4];   // n8 blocks of keys cb + 8 j: rows g (0, 1) and g + 8 (2, 3)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int hk = 0; hk < 2; ++hk) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kr[4];
        attn::ldsm_x4(kr, kb + (cb + 16 * hk + (lane & 7) + 8 * (lane >> 4)) * kRp +
                              16 * ks + 8 * ((lane >> 3) & 1));
        mma<T>(s[2 * hk], qa[ks], kr[0], kr[1]);
        mma<T>(s[2 * hk + 1], qa[ks], kr[2], kr[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = cb + 8 * j + c2;
      const float2 x0 = Elem<T>::unpack(*reinterpret_cast<const uint32_t*>(b0 + cb + 8 * j));
      const float2 x1 = Elem<T>::unpack(*reinterpret_cast<const uint32_t*>(b1 + cb + 8 * j));
      s[j][0] = fmaf(s[j][0], a.scale, x0.x);
      s[j][1] = fmaf(s[j][1], a.scale, x0.y);
      s[j][2] = fmaf(s[j][2], a.scale, x1.x);
      s[j][3] = fmaf(s[j][3], a.scale, x1.y);
      if constexpr (MASK == kIds) {
        const int2 ic = *reinterpret_cast<const int2*>(ib + col);
        if (ic.x != id0) s[j][0] += kMaskValue;
        if (ic.y != id0) s[j][1] += kMaskValue;
        if (ic.x != id1) s[j][2] += kMaskValue;
        if (ic.y != id1) s[j][3] += kMaskValue;
      } else if constexpr (MASK == kAdditive) {
        if (col < a.t) {
          if (m0) s[j][0] += Elem<T>::one(m0[col]);
          if (m1) s[j][2] += Elem<T>::one(m1[col]);
        }
        if (col + 1 < a.t) {
          if (m0) s[j][1] += Elem<T>::one(m0[col + 1]);
          if (m1) s[j][3] += Elem<T>::one(m1[col + 1]);
        }
      }
    }
    if (cb + kChunk > a.t) {   // the last chunk: keys past T take no part
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = cb + 8 * j + c2;
        if (col >= a.t) s[j][0] = s[j][2] = -CUDART_INF_F;
        if (col + 1 >= a.t) s[j][1] = s[j][3] = -CUDART_INF_F;
      }
    }
    float n0 = mx0, n1 = mx1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      n0 = fmaxf(n0, fmaxf(s[j][0], s[j][1]));
      n1 = fmaxf(n1, fmaxf(s[j][2], s[j][3]));
    }
    n0 = attn::quad_max(n0);
    n1 = attn::quad_max(n1);
    // every chunk holds a key below T, so without an additive mask n0 and n1 are
    // finite and the first chunk's rescale is exp2(-inf) = 0 of zero sums. An
    // additive mask may put -inf on every key a row has seen so far: that row's
    // exponentials and rescale take 0 as their offset (FlashAttention's guard), so
    // they are exp2(-inf) = 0, not the NaN of -inf - -inf; its running max stays -inf
    float u0 = n0, u1 = n1;
    if constexpr (MASK == kAdditive) {
      if (n0 == -CUDART_INF_F) u0 = 0.f;
      if (n1 == -CUDART_INF_F) u1 = 0.f;
    }
    const float alpha0 = attn::fast_exp2((mx0 - u0) * kLog2e);
    const float alpha1 = attn::fast_exp2((mx1 - u1) * kLog2e);
    mx0 = n0;
    mx1 = n1;
    const float e0 = -u0 * kLog2e, e1 = -u1 * kLog2e;
    float r0s = 0.f, r1s = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j][0] = attn::fast_exp2(fmaf(s[j][0], kLog2e, e0));
      s[j][1] = attn::fast_exp2(fmaf(s[j][1], kLog2e, e0));
      s[j][2] = attn::fast_exp2(fmaf(s[j][2], kLog2e, e1));
      s[j][3] = attn::fast_exp2(fmaf(s[j][3], kLog2e, e1));
      r0s += s[j][0] + s[j][1];
      r1s += s[j][2] + s[j][3];
    }
    l0 = fmaf(l0, alpha0, r0s);
    l1 = fmaf(l1, alpha1, r1s);
#pragma unroll
    for (int f = 0; f < 2 * KS; ++f) {
      o[f][0] *= alpha0;
      o[f][1] *= alpha0;
      o[f][2] *= alpha1;
      o[f][3] *= alpha1;
    }
#pragma unroll
    for (int hk = 0; hk < 2; ++hk) {
      // A: P of keys cb + 16 hk .. + 15, straight from the S fragments
      const uint32_t pa[4] = {Elem<T>::pack(s[2 * hk][0], s[2 * hk][1]),
                              Elem<T>::pack(s[2 * hk][2], s[2 * hk][3]),
                              Elem<T>::pack(s[2 * hk + 1][0], s[2 * hk + 1][1]),
                              Elem<T>::pack(s[2 * hk + 1][2], s[2 * hk + 1][3])};
#pragma unroll
      for (int fb = 0; fb < KS; ++fb) {
        uint32_t vr[4];
        attn::ldsm_x4_t(vr, vb + (cb + 16 * hk + (lane & 7) + 8 * ((lane >> 3) & 1)) * kRp +
                                16 * fb + 8 * (lane >> 4));
        mma<T>(o[2 * fb], pa, vr[0], vr[1]);
        mma<T>(o[2 * fb + 1], pa, vr[2], vr[3]);
      }
    }
  }
  l0 = attn::quad_sum(l0);
  l1 = attn::quad_sum(l1);
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  uint16_t* out = static_cast<uint16_t*>(a.out);
  if (row0 < a.t) {
    uint16_t* p = out + ((n * a.t + row0) * a.h + head) * D + c2;
#pragma unroll
    for (int f = 0; f < 2 * KS; ++f)
      *reinterpret_cast<uint32_t*>(p + 8 * f) = Elem<T>::pack(o[f][0] * i0, o[f][1] * i0);
  }
  if (row1 < a.t) {
    uint16_t* p = out + ((n * a.t + row1) * a.h + head) * D + c2;
#pragma unroll
    for (int f = 0; f < 2 * KS; ++f)
      *reinterpret_cast<uint32_t*>(p + 8 * f) = Elem<T>::pack(o[f][2] * i1, o[f][3] * i1);
  }
}

// Block b: window group b / (h qtiles), head and query tile b % (h qtiles).
template <typename T, int D, int MASK>
__global__ void __launch_bounds__(kMaxWarps * 32) biased_window_attention_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRp = row_pitch(D);
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = warps * 16, tc = chunked(a.t), bp = bias_pitch(tc);
  const int combos = a.h * a.qtiles;
  const int gi = blockIdx.x / combos, combo = blockIdx.x - gi * combos;
  const int head = combo / a.qtiles, r0 = (combo - head * a.qtiles) * rows;
  const int nrows = min(rows, a.t - r0);
  uint16_t* bias_s = reinterpret_cast<uint16_t*>(smem);
  unsigned char* buf0 = smem + rows * bp * 2;
  const int buf_bytes = buffer_bytes(tc, rows, D);

  // zeros where nothing is staged: K and V rows past T, Q rows past the tile's
  // tokens, the ids past T; then the tile's bias rows of this head (zeros past
  // T, and everywhere without a bias)
  for (int i = threadIdx.x; i < a.bufs * buf_bytes / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(buf0)[i] = make_uint4(0u, 0u, 0u, 0u);
  const uint16_t* bias = static_cast<const uint16_t*>(a.bias);
  for (int r = warp; r < rows; r += warps) {
    const uint16_t* src =
        bias != nullptr && r0 + r < a.t ? bias + (static_cast<long long>(head) * a.t + r0 + r) * a.t
                                        : nullptr;
    for (int c = lane; c < tc; c += 32) bias_s[r * bp + c] = src != nullptr && c < a.t ? src[c] : 0;
  }
  __syncthreads();

  auto buffer = [&](int b) { return reinterpret_cast<bf16*>(buf0 + b * buf_bytes); };
  // K, V and the tile's Q rows of window n into buffer b (16-bit elements are
  // moved as bits), and its ids
  auto stage = [&](int b, long long n) {
    bf16* kb = buffer(b);
    bf16* vb = kb + tc * kRp;
    bf16* qb = vb + tc * kRp;
    const attn::TilePos tp{n, head, 1};
    const attn::Walk w = attn::walk_for<bf16, D>(1);
    const bf16* q = static_cast<const bf16*>(a.q) + r0 * a.lq.t;
    if (a.vec) {
      attn::stage_rows<bf16, D, true>(kb, kRp, static_cast<const bf16*>(a.k), a.lk, tp, a.t, 1, w);
      attn::stage_rows<bf16, D, true>(vb, kRp, static_cast<const bf16*>(a.v), a.lv, tp, a.t, 1, w);
      attn::stage_rows<bf16, D, true>(qb, kRp, q, a.lq, tp, nrows, 1, w);
    } else {
      attn::stage_rows<bf16, D, false>(kb, kRp, static_cast<const bf16*>(a.k), a.lk, tp, a.t, 1, w);
      attn::stage_rows<bf16, D, false>(vb, kRp, static_cast<const bf16*>(a.v), a.lv, tp, a.t, 1, w);
      attn::stage_rows<bf16, D, false>(qb, kRp, q, a.lq, tp, nrows, 1, w);
    }
    if constexpr (MASK == kIds) {
      int* ib = reinterpret_cast<int*>(qb + rows * kRp);
      const int* src = static_cast<const int*>(a.mask) + (n % a.nw) * a.t;
      for (int c = threadIdx.x; c < a.t; c += blockDim.x) ib[c] = src[c];
    }
  };

  int b = 0;
  long long n = gi;
  if (n < a.n) {
    stage(0, n);
    attn::cp_async_commit();
  }
  for (; n < a.n; n += a.groups) {
    const long long next = n + a.groups;
    if (a.bufs == 2 && next < a.n) {
      stage(b ^ 1, next);
      attn::cp_async_commit();
      cp_async_wait_one();
    } else {
      attn::cp_async_wait_all();
    }
    __syncthreads();
    if (warp * 16 < nrows) {
      const bf16* kb = buffer(b);
      window_rows<T, D, MASK>(a, bias_s, bp, kb, kb + tc * kRp, kb + 2 * tc * kRp,
                              reinterpret_cast<const int*>(kb + (2 * tc + rows) * kRp), n,
                              head, r0, warp * 16, tc);
    }
    __syncthreads();
    if (a.bufs == 2) {
      b ^= 1;
    } else if (next < a.n) {
      stage(0, next);
      attn::cp_async_commit();
    }
  }
}

template <typename T, int D, int MASK>
cudaError_t launch(const Args& a, int blocks, int warps, int smem, cudaStream_t s) {
  auto kernel = biased_window_attention_kernel<T, D, MASK>;
  if (smem > attn::kSmemLimit) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, warps * 32, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_mask(int kind, const Args& a, int blocks, int warps, int smem,
                          cudaStream_t s) {
  switch (kind) {
    case kIds: return launch<T, D, kIds>(a, blocks, warps, smem, s);
    case kAdditive: return launch<T, D, kAdditive>(a, blocks, warps, smem, s);
    default: return launch<T, D, kNoMask>(a, blocks, warps, smem, s);
  }
}

template <typename T>
cudaError_t dispatch_d(int d, int kind, const Args& a, int blocks, int warps, int smem,
                       cudaStream_t s) {
  return d == 16 ? dispatch_mask<T, 16>(kind, a, blocks, warps, smem, s)
                 : dispatch_mask<T, 32>(kind, a, blocks, warps, smem, s);
}

}  // namespace

// Bytes of shared memory a block of `warps` warps takes at T tokens and d features with
// `bufs` window buffers (`_bwa_smem` in kernels/biased_window_attention.py).
extern "C" int biased_window_attention_smem(int t, int d, int warps, int bufs) {
  return smem_bytes(t, d, warps, bufs);
}

// q, k, v: [N, T, h, d] through `strides`, 9 element strides (window, token, head) for
// q, k, v in that order, the feature axis dense. bias: contiguous [h, T, T] or null.
// mask_kind 0: no mask; 1: int32 ids [nw, T]; 2: additive [nw, T, T], in the working
// type; nw divides n. out: contiguous [N, T, h, d]. dtype: 1 = bfloat16, 2 = float16.
// (warps, qtiles, groups, bufs): the plan of `_bwa_plan` and `_bwa_groups`, qtiles =
// ceil(T / 16 warps); the grid is h * qtiles * groups blocks. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments or a plan the kernel does not
// take. Launches on `stream`, allocates nothing and does not synchronise.
extern "C" int biased_window_attention_forward(const void* q, const void* k, const void* v,
                                               const void* bias, const void* mask, void* out,
                                               long long n, int t, int h, int d,
                                               const long long* strides, long long nw,
                                               int mask_kind, float scale, int dtype, int warps,
                                               int qtiles, int groups, int bufs,
                                               void* stream) {
  const bool mask_ok = mask_kind == kNoMask ||
                       ((mask_kind == kIds || mask_kind == kAdditive) && mask != nullptr &&
                        nw >= 1 && n % nw == 0);
  if (n <= 0 || t < 1 || t > kMaxT || h < 1 || (d != 16 && d != 32) || warps < 1 ||
      warps > kMaxWarps || qtiles != attn::ceil_div(attn::ceil_div(t, 16), warps) ||
      groups < 1 || groups > n || (bufs != 1 && bufs != 2) || (dtype != 1 && dtype != 2) ||
      !mask_ok)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(h) * qtiles * groups;
  const int smem = smem_bytes(t, d, warps, bufs);
  if (blocks > INT32_MAX || smem > attn::kSmemOptIn)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = bias;
  a.mask = mask_kind == kNoMask ? nullptr : mask;
  a.out = out;
  a.lq = {strides[0], strides[1], strides[2]};
  a.lk = {strides[3], strides[4], strides[5]};
  a.lv = {strides[6], strides[7], strides[8]};
  a.n = n;
  a.nw = mask_kind == kNoMask ? 1 : nw;
  a.t = t;
  a.h = h;
  a.qtiles = qtiles;
  a.groups = groups;
  a.bufs = bufs;
  a.scale = scale;
  const void* ptrs[3] = {q, k, v};
  const Layout l[3] = {a.lq, a.lk, a.lv};
  a.vec = attn::aligned16<bf16>(ptrs, l, 3);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = static_cast<int>(blocks);
  const cudaError_t err = dtype == 1 ? dispatch_d<bf16>(d, mask_kind, a, nb, warps, smem, s)
                                     : dispatch_d<__half>(d, mask_kind, a, nb, warps, smem, s);
  return static_cast<int>(err);
}
