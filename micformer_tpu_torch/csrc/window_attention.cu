// Window attention forward for Hopper (sm_90a): out = softmax(q k^T * scale) v
// per window and head, with no bias and no mask. Two entries, one tile kernel:
//   - K1, `window_attention_forward`: replaces the TPU kernel
//     micformer_tpu/ops/pallas/window_attention_v2.py (`_kernel` /
//     `_v2_forward`, reached from `window_attention_v2`), on [N, T, h, d]
//     operands, Tq, Tk <= 16, d in {8, 16, 32, 64}. Every attention of the
//     MicFormer serving path has this shape: T = 8, d = 16, and at sw_batch 4
//     the four stages run [16384, 8, 3, 16], [2048, 8, 6, 16], [256, 8, 12,
//     16] and [32, 8, 24, 16].
//   - K2, `fused_window_attention_forward`: replaces the TPU kernel
//     micformer_tpu/ops/pallas/window_attention.py (`_kernel` /
//     `_pallas_forward`, reached from `fused_window_attention`), on [N, h, T,
//     d] operands, T <= 32 with 128 % T == 0, any d <= 128, any (window,
//     token, head) strides with a dense feature axis. The port hands it the
//     [N, h, T, d] transposed views of the [N, T, h, d] slices of the fused
//     qkv projection, so on the `--fused-attention` path it reads the memory
//     K1 reads. The TPU kernel packs 128 / T (window, head) pairs into one
//     128-row tile, computes a dense 128 x 128 score matrix on the MXU and
//     masks the cross-window products with -1e30: on the TPU the one large
//     product is the cheap way to fill the MXU. Here the cross-window products
//     are not computed at all: the mma route stacks two pairs in the 16 rows
//     of an m16n8k16 and multiplies block-diagonal operands, the ffma route
//     gives each query row its own T logits.
//
// Bound: memory. Each call reads q, k, v once and writes out once, 4 N T h d
// elements; the arithmetic is 4 T d multiply-adds per (window, head, query
// row), far below the card's operations-per-byte balance. In bf16 at 3.35
// TB/s K1's four serving stages are bounded by 15.02, 3.76, 0.94 and 0.23 us,
// K2's at the training stage 0 [4096, 3, 8, 16] by 3.76 us.
//
// Design (csrc/attn_tile.cuh holds the staging):
//   - A block takes a tile of W windows x Hg heads (about twelve (window, head)
//     pairs at T = 8; K2 scales the count by 8 / T) and stages its q, k and v
//     rows in shared memory with 16-byte cp.async copies, so each byte leaves
//     device memory once (K2's unaligned operands: element copies). One tile
//     a block: small tiles keep about 16 blocks on each SM, whose copies are
//     in flight together; where windows are few (the deep stages) the tile
//     shrinks to one window and then to fewer heads, so that the grid still
//     covers the card's SMs. (On the H100, grids of fewer blocks that walked
//     the tiles through a two-stage ring measured slower at every path
//     stage.) A K2 pair that needs more than 48 KB (T = 32, d = 128, f32:
//     about 50 KB) is a tile of its own, and its entry opts in to the larger
//     dynamic shared memory.
//   - "mma" route (bf16, Tq = Tk = 8, d a multiple of 16, aligned; every
//     attention of the MicFormer paths, K1 or K2): a warp takes two (window,
//     head) pairs a step, stacked in the 16 rows of mma.sync.m16n8k16. S = q k^T
//     is two mmas per 16 features (one per pair's keys; each pair keeps its
//     half of the rows); softmax runs on the f32 fragments (row max and sum
//     over the four lanes of a row by shuffles, exp2 with scale * log2(e)
//     folded in); O = P v takes P from registers as a block-diagonal A (pair
//     a's keys in k 0-7, pair b's in 8-15) and v's fragments by
//     ldmatrix.trans. P is split as hi + lo bf16 (two mmas), so P v keeps
//     about 16 bits of P: f32-like sums, rounded once on the store. K1 and K2
//     run the same device code, so at T = 8 they give the same bits.
//   - "ffma" route (f32, d = 8, T != 8, Tq != Tk, K2's unaligned operands and
//     odd widths): one thread per (window, head, query row) computes in f32
//     from the staged rows; k and v rows are read once per pair from shared
//     memory and broadcast to the Tq threads that need them. K1's thread holds
//     its q and output rows in registers, and so does K2's where T <= 16 and
//     the row fits (f32 to d = 64, bf16 to d = 32); else (T = 32, d up to 128)
//     K2's thread runs over the features a 16-byte chunk at a time, with its
//     T logits in registers (at d = 64 in bf16 that measured faster).
//   - Each output row overwrites its own q row in shared memory; the tile is
//     then written out as coalesced 16-byte stores (K2: element stores where
//     the output's rows are not 16-byte aligned).
// The TPU kernels' token-major [T, 512, h*d] relayout and per-head lane masks
// (K1) and 128-row block-diagonal tile (K2) answered the TPU's 128-lane
// registers and 128 x 128 MXU and are not carried over.
//
// Layout, K1: q is [N, Tq, h, d] and k, v are [N, Tk, h, d] with the head and
// feature axes dense and the window and token axes collapsible to one row
// stride (token row r = n*T + t starts at r * row_stride elements), which
// covers contiguous tensors and the q/k/v slices of a fused projection. out
// is contiguous [N, Tq, h, d]. K2: every operand and out through its own
// (window, token, head) strides. Logits, softmax and accumulation are f32.

#include <math.h>

#include "attn_tile.cuh"

namespace {

using attn::Layout;
using attn::Plan;
using attn::TilePos;
using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of a block: its tile's q, k and v rows.
int forward_smem(int W, int Hg, int tq, int tk, int d, int es) {
  return W * (tq + 2 * tk) * attn::pitch_bytes(Hg, d, es);
}

// One warp, pairs pa and pb of the tile (pb == pa when the tile's pair count
// is odd; then only pa is written). Pair p is window p / hg, head p % hg.
template <int D>
__device__ __forceinline__ void mma_step(bf16* qs, const bf16* ks, const bf16* vs, int pitch,
                                         int hg, uint32_t hg_magic, int pa, int pb,
                                         bool b_valid, float sl2) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = (lane & 3) * 2;
  const int m = lane >> 3, r = lane & 7;       // ldmatrix: matrix m, row r
  const int wa = attn::div_small(pa, hg_magic), wb = attn::div_small(pb, hg_magic);
  const int ba = wa * 8 * pitch + (pa - wa * hg) * D;
  const int bb = wb * 8 * pitch + (pb - wb * hg) * D;
  float sa[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t aq[4], bk[4];
    // A: rows 0-7 pair a's q, rows 8-15 pair b's; B: each pair's k rows
    attn::ldsm_x4(aq, qs + ((m & 1) ? bb : ba) + r * pitch + kk + (m >> 1) * 8);
    attn::ldsm_x4(bk, ks + ((m >> 1) ? bb : ba) + r * pitch + kk + (m & 1) * 8);
    attn::mma16816(sa, aq, bk[0], bk[1]);
    attn::mma16816(sb, aq, bk[2], bk[3]);
  }
  // this lane's logits: pair a row g (sa[0..1]) and pair b row g (sb[2..3]),
  // keys c and c + 1
  const float xa0 = sa[0] * sl2, xa1 = sa[1] * sl2, xb0 = sb[2] * sl2, xb1 = sb[3] * sl2;
  const float ma = attn::quad_max(fmaxf(xa0, xa1)), mb = attn::quad_max(fmaxf(xb0, xb1));
  const float pa0 = attn::fast_exp2(xa0 - ma), pa1 = attn::fast_exp2(xa1 - ma);
  const float pb0 = attn::fast_exp2(xb0 - mb), pb1 = attn::fast_exp2(xb1 - mb);
  const float ia = __fdividef(1.f, attn::quad_sum(pa0 + pa1));
  const float ib = __fdividef(1.f, attn::quad_sum(pb0 + pb1));
  // block-diagonal A = [[P_a, 0], [0, P_b]], as hi + lo
  uint32_t ahi[4] = {0u, 0u, 0u, 0u}, alo[4] = {0u, 0u, 0u, 0u};
  attn::split_bf16(pa0, pa1, ahi[0], alo[0]);
  attn::split_bf16(pb0, pb1, ahi[3], alo[3]);
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < D; nt += 16) {
    uint32_t bv[4];   // B: k 0-7 pair a's v rows, k 8-15 pair b's; features nt, nt + 8
    attn::ldsm_x4_t(bv, vs + ((m & 1) ? bb : ba) + r * pitch + nt + (m >> 1) * 8);
    float o0[4] = {0.f, 0.f, 0.f, 0.f}, o1[4] = {0.f, 0.f, 0.f, 0.f};
    attn::mma16816(o0, ahi, bv[0], bv[1]);
    attn::mma16816(o0, alo, bv[0], bv[1]);
    attn::mma16816(o1, ahi, bv[2], bv[3]);
    attn::mma16816(o1, alo, bv[2], bv[3]);
    bf16* oa = qs + ba + g * pitch + nt + c;
    *reinterpret_cast<uint32_t*>(oa) = attn::pack_bf16(o0[0] * ia, o0[1] * ia);
    *reinterpret_cast<uint32_t*>(oa + 8) = attn::pack_bf16(o1[0] * ia, o1[1] * ia);
    if (b_valid) {
      bf16* ob = qs + bb + g * pitch + nt + c;
      *reinterpret_cast<uint32_t*>(ob) = attn::pack_bf16(o0[2] * ib, o0[3] * ib);
      *reinterpret_cast<uint32_t*>(ob + 8) = attn::pack_bf16(o1[2] * ib, o1[3] * ib);
    }
  }
}

// One thread, query row i of pair p.
template <typename T, int D>
__device__ __forceinline__ void ffma_row(T* qs, const T* ks, const T* vs, int pitch, int tq,
                                         int tk, int hg, int p, int i, float scale) {
  const int w = p / hg, col = (p % hg) * D;
  T* qr = qs + (w * tq + i) * pitch + col;
  const T* kb = ks + w * tk * pitch + col;
  const T* vb = vs + w * tk * pitch + col;
  float qv[D];
  attn::load_row<T, D>(qr, qv);
#pragma unroll
  for (int e = 0; e < D; ++e) qv[e] *= scale;
  float logit[attn::kMaxT];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < attn::kMaxT; ++j) {
    logit[j] = -INFINITY;
    if (j < tk) {
      float kv[D];
      attn::load_row<T, D>(kb + j * pitch, kv);
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < D; ++e) s = fmaf(qv[e], kv[e], s);
      logit[j] = s;
      m = fmaxf(m, s);
    }
  }
  float acc[D];
#pragma unroll
  for (int e = 0; e < D; ++e) acc[e] = 0.f;
  float denom = 0.f;
#pragma unroll
  for (int j = 0; j < attn::kMaxT; ++j) {
    if (j < tk) {
      const float pj = expf(logit[j] - m);
      denom += pj;
      float vv[D];
      attn::load_row<T, D>(vb + j * pitch, vv);
#pragma unroll
      for (int e = 0; e < D; ++e) acc[e] = fmaf(pj, vv[e], acc[e]);
    }
  }
  const float inv = 1.f / denom;
#pragma unroll
  for (int e = 0; e < D; ++e) acc[e] *= inv;
  attn::store_row<T, D>(qr, acc);
}

// K2's row: one thread, query row i of pair p, over the features a 16-byte
// chunk at a time (d up to 128 would not fit K1's rows in registers), with
// its tk <= MAXT logits in registers.
template <typename T, int D, int MAXT>
__device__ __forceinline__ void ffma_row_chunked(T* qs, const T* ks, const T* vs, int pitch,
                                                 int tq, int tk, int hg, int p, int i,
                                                 float scale) {
  constexpr int kE = 16 / sizeof(T);
  const int w = p / hg, col = (p % hg) * D;
  T* qr = qs + (w * tq + i) * pitch + col;
  const T* kb = ks + w * tk * pitch + col;
  const T* vb = vs + w * tk * pitch + col;
  float s[MAXT];
#pragma unroll
  for (int j = 0; j < MAXT; ++j) s[j] = 0.f;
#pragma unroll 1
  for (int e0 = 0; e0 < D; e0 += kE) {
    float qc[kE];
    attn::load_row<T, kE>(qr + e0, qc);
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
      if (j < tk) {
        float kc[kE];
        attn::load_row<T, kE>(kb + j * pitch + e0, kc);
#pragma unroll
        for (int e = 0; e < kE; ++e) s[j] = fmaf(qc[e] * scale, kc[e], s[j]);
      }
    }
  }
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < MAXT; ++j) if (j < tk) m = fmaxf(m, s[j]);
  float denom = 0.f;
#pragma unroll
  for (int j = 0; j < MAXT; ++j) {
    s[j] = j < tk ? expf(s[j] - m) : 0.f;
    denom += s[j];
  }
  const float inv = 1.f / denom;
#pragma unroll 1
  for (int e0 = 0; e0 < D; e0 += kE) {   // q's chunks are read no more
    float acc[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] = 0.f;
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
      if (j < tk) {
        float vc[kE];
        attn::load_row<T, kE>(vb + j * pitch + e0, vc);
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[e] = fmaf(s[j], vc[e], acc[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] *= inv;
    attn::store_row<T, kE>(qr + e0, acc);
  }
}

// Block blockIdx.x's tile: stage q, k, v, compute, store. FUSED (K2): T up
// to 32, K1's ffma rows where T <= 16 and the row fits (below), else the
// chunked ones.
// TAIL (K2 only): d < D, the tail staged as zeros and not stored
// (csrc/attn_tile.cuh). Else d = D.
template <typename T, int D, bool MMA, bool VEC, bool FUSED, bool TAIL>
__device__ __forceinline__ void forward_tile(unsigned char* smem, const T* __restrict__ q,
                                             const T* __restrict__ k,
                                             const T* __restrict__ v, T* __restrict__ out,
                                             const Plan& plan, int tq, int tk, Layout lq,
                                             Layout lk, Layout lv, Layout lo, int d,
                                             float scale) {
  const int pitch = attn::pitch_bytes(plan.Hg, D, sizeof(T)) / sizeof(T);
  const int qrows = plan.W * tq, krows = plan.W * tk;
  T* const qs = reinterpret_cast<T*>(smem);
  T* const ks = qs + qrows * pitch;
  T* const vs = ks + krows * pitch;

  constexpr int kRpw = MMA ? 8 : 0;   // token rows a window, when fixed
  const attn::Walk start = attn::walk_for<T, D>(plan.Hg);
  const TilePos tp = attn::tile_pos(plan, blockIdx.x);
  attn::stage_rows<T, D, VEC, kRpw, TAIL>(qs, pitch, q, lq, tp, tq, plan.Hg, start, d);
  attn::stage_rows<T, D, VEC, kRpw, TAIL>(ks, pitch, k, lk, tp, tk, plan.Hg, start, d);
  attn::stage_rows<T, D, VEC, kRpw, TAIL>(vs, pitch, v, lv, tp, tk, plan.Hg, start, d);
  attn::cp_async_commit();
  attn::cp_async_wait_all();
  __syncthreads();
  const int pairs = tp.nw * plan.Hg;
  if constexpr (MMA) {
    const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    const uint32_t hg_magic = attn::div_magic(plan.Hg);
    for (int s = warp; 2 * s < pairs; s += nwarps)
      mma_step<D>(qs, ks, vs, pitch, plan.Hg, hg_magic, 2 * s, min(2 * s + 1, pairs - 1),
                  2 * s + 1 < pairs, scale * kLog2e);
  } else {
    // K1's rows where they fit and measured faster on the H100 (f32 to D 64,
    // bf16 to D 32); the branch is the grid's
    constexpr bool kRowsFit = sizeof(T) == 4 ? D <= 64 : D <= 32;
    const bool rows_fit = !FUSED || (kRowsFit && tk <= attn::kMaxT);
    for (int it = threadIdx.x; it < pairs * tq; it += blockDim.x) {
      if (rows_fit)
        ffma_row<T, D>(qs, ks, vs, pitch, tq, tk, plan.Hg, it / tq, it % tq, scale);
      else
        ffma_row_chunked<T, D, attn::kFusedMaxT>(qs, ks, vs, pitch, tq, tk, plan.Hg, it / tq,
                                                 it % tq, scale);
    }
  }
  __syncthreads();
  attn::store_rows<T, D, VEC, kRpw, TAIL>(out, lo, qs, pitch, tp, tq, plan.Hg, start, d);
}

// K1: aligned rows, out contiguous [N, Tq, h, d].
template <typename T, int D, bool MMA>
__global__ void __launch_bounds__(attn::kMaxWarps * 32)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, Plan plan, int tq,
                        int tk, Layout lq, Layout lk, Layout lv, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lo = {static_cast<int64_t>(tq) * plan.h * D, static_cast<int64_t>(plan.h) * D, D};
  forward_tile<T, D, MMA, true, false, false>(smem, q, k, v, out, plan, tq, tk, lq, lk, lv, lo,
                                              D, scale);
}

// K2: T tokens, any strides, d <= D (d < D: TAIL).
template <typename T, int D, bool MMA, bool VEC, bool TAIL>
__global__ void __launch_bounds__(attn::kMaxWarps * 32)
fused_window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, T* __restrict__ out, Plan plan, int t,
                              Layout lq, Layout lk, Layout lv, Layout lo, int d, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  forward_tile<T, D, MMA, VEC, true, TAIL>(smem, q, k, v, out, plan, t, t, lq, lk, lv, lo, d,
                                           scale);
}

template <typename T, int D, bool MMA>
cudaError_t launch(const void* const* ptrs, const Plan& p, int tq, int tk, const Layout* l,
                   float scale, int smem, cudaStream_t stream) {
  window_attention_kernel<T, D, MMA><<<static_cast<unsigned>(p.tiles), p.warps * 32, smem,
                                       stream>>>(
      static_cast<const T*>(ptrs[0]), static_cast<const T*>(ptrs[1]),
      static_cast<const T*>(ptrs[2]), static_cast<T*>(const_cast<void*>(ptrs[3])), p, tq, tk,
      l[0], l[1], l[2], scale);
  return cudaGetLastError();
}

template <typename T, bool MMA>
cudaError_t dispatch_d(int d, const void* const* ptrs, const Plan& p, int tq, int tk,
                       const Layout* l, float scale, int smem, cudaStream_t s) {
  if constexpr (MMA) {
    switch (d) {
      case 16: return launch<T, 16, true>(ptrs, p, tq, tk, l, scale, smem, s);
      case 32: return launch<T, 32, true>(ptrs, p, tq, tk, l, scale, smem, s);
      case 64: return launch<T, 64, true>(ptrs, p, tq, tk, l, scale, smem, s);
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (d) {
      case 8:  return launch<T, 8, false>(ptrs, p, tq, tk, l, scale, smem, s);
      case 16: return launch<T, 16, false>(ptrs, p, tq, tk, l, scale, smem, s);
      case 32: return launch<T, 32, false>(ptrs, p, tq, tk, l, scale, smem, s);
      case 64: return launch<T, 64, false>(ptrs, p, tq, tk, l, scale, smem, s);
      default: return cudaErrorInvalidValue;
    }
  }
}

template <typename T, int D, bool MMA, bool VEC, bool TAIL>
cudaError_t launch_fused(const void* const* ptrs, const Plan& p, int t, const Layout* l, int d,
                         float scale, int smem, cudaStream_t stream) {
  auto kernel = fused_window_attention_kernel<T, D, MMA, VEC, TAIL>;
  if (smem > attn::kSmemLimit) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(p.tiles), p.warps * 32, smem, stream>>>(
      static_cast<const T*>(ptrs[0]), static_cast<const T*>(ptrs[1]),
      static_cast<const T*>(ptrs[2]), static_cast<T*>(const_cast<void*>(ptrs[3])), p, t, l[0],
      l[1], l[2], l[3], d, scale);
  return cudaGetLastError();
}

// The mma route at a compiled width runs without the tail code (K1's code);
// the ffma route always takes it.
template <typename T, int D, bool MMA, bool VEC>
cudaError_t launch_fused_at(const void* const* ptrs, const Plan& p, int t, const Layout* l,
                            int d, float scale, int smem, cudaStream_t s) {
  if constexpr (MMA) {
    if (d == D) return launch_fused<T, D, MMA, VEC, false>(ptrs, p, t, l, d, scale, smem, s);
  }
  return launch_fused<T, D, MMA, VEC, true>(ptrs, p, t, l, d, scale, smem, s);
}

template <typename T, bool MMA, bool VEC>
cudaError_t dispatch_fused(int d, const void* const* ptrs, const Plan& p, int t,
                           const Layout* l, float scale, int smem, cudaStream_t s) {
  switch (attn::fused_width(d)) {
    case 8:
      if constexpr (!MMA) return launch_fused_at<T, 8, MMA, VEC>(ptrs, p, t, l, d, scale, smem, s);
      return cudaErrorInvalidValue;
    case 16: return launch_fused_at<T, 16, MMA, VEC>(ptrs, p, t, l, d, scale, smem, s);
    case 32: return launch_fused_at<T, 32, MMA, VEC>(ptrs, p, t, l, d, scale, smem, s);
    case 64: return launch_fused_at<T, 64, MMA, VEC>(ptrs, p, t, l, d, scale, smem, s);
    default: return launch_fused_at<T, 128, MMA, VEC>(ptrs, p, t, l, d, scale, smem, s);
  }
}

template <typename T>
cudaError_t dispatch_fused_ffma(bool vec, int d, const void* const* ptrs, const Plan& p, int t,
                                const Layout* l, float scale, int smem, cudaStream_t s) {
  return vec ? dispatch_fused<T, false, true>(d, ptrs, p, t, l, scale, smem, s)
             : dispatch_fused<T, false, false>(d, ptrs, p, t, l, scale, smem, s);
}

}  // namespace

// Bytes of shared memory a block of the plan (W, Hg) takes; dtype 0 =
// float32, 1 = bfloat16 (`_attn_smem` in kernels/window_attention.py is held
// equal to this on the card).
extern "C" int window_attention_forward_smem(int W, int Hg, int tq, int tk, int d, int dtype) {
  return forward_smem(W, Hg, tq, tk, d, dtype == 0 ? 4 : 2);
}

// dtype: 0 = float32, 1 = bfloat16. route: 0 = mma (bf16, Tq = Tk = 8, d a
// multiple of 16), 1 = ffma. (W, Hg, warps): the tile plan of `_attn_plan`;
// the grid is one block a tile. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments, a route or a plan the kernel does not
// take (rows must be 16-byte aligned). Launches on `stream`, allocates
// nothing and does not synchronise.
extern "C" int window_attention_forward(const void* q, const void* k, const void* v,
                                        void* out, long long n, int tq, int tk, int h, int d,
                                        long long q_row, long long k_row, long long v_row,
                                        float scale, int dtype, int route, int W, int Hg,
                                        int warps, void* stream) {
  const Plan p = attn::make_plan(n, h, W, Hg, warps);
  if (n <= 0 || tq < 1 || tq > attn::kMaxT || tk < 1 || tk > attn::kMaxT || h < 1 ||
      !attn::plan_ok(p) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int es = dtype == 0 ? 4 : 2;
  const void* ptrs[4] = {q, k, v, out};
  const Layout l[4] = {{tq * q_row, q_row, d}, {tk * k_row, k_row, d}, {tk * v_row, v_row, d},
                       {static_cast<int64_t>(tq) * h * d, static_cast<int64_t>(h) * d, d}};
  const bool aligned = dtype == 0 ? attn::aligned16<float>(ptrs, l, 4)
                                  : attn::aligned16<bf16>(ptrs, l, 4);
  const int smem = forward_smem(W, Hg, tq, tk, d, es);
  const bool mma_ok = dtype == 1 && tq == 8 && tk == 8 && d % 16 == 0 &&
                      W * Hg * Hg < 65536;   // attn::div_small on pair indices
  if (!aligned || smem > attn::kSmemLimit || (route == attn::kRouteMma && !mma_ok) ||
      (route != attn::kRouteMma && route != attn::kRouteFfma))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (route == attn::kRouteMma)
    err = dispatch_d<bf16, true>(d, ptrs, p, tq, tk, l, scale, smem, s);
  else if (dtype == 0)
    err = dispatch_d<float, false>(d, ptrs, p, tq, tk, l, scale, smem, s);
  else
    err = dispatch_d<bf16, false>(d, ptrs, p, tq, tk, l, scale, smem, s);
  return static_cast<int>(err);
}

// Bytes of shared memory a block of K2's plan (W, Hg) takes at T tokens and
// d features (staged at attn::fused_width(d)); dtype 0 = float32, 1 =
// bfloat16 (`_fused_smem` in kernels/fused_window_attention.py is held equal
// to this on the card).
extern "C" int fused_window_attention_forward_smem(int W, int Hg, int t, int d, int dtype) {
  return forward_smem(W, Hg, t, t, attn::fused_width(d), dtype == 0 ? 4 : 2);
}

// K2. q, k, v and out addressed as [N, h, T, d] through `strides`, 12
// element strides (window, token, head) for q, k, v, out in that order, the
// feature axis dense; T <= 32 with 128 % T == 0, 1 <= d <= 128. dtype: 0 =
// float32, 1 = bfloat16. route: 0 = mma (bf16, T = 8, d a multiple of 16,
// every address and stride 16-byte aligned), 1 = ffma. (W, Hg, warps): the
// tile plan of `_fused_plan`, one block a tile; above 48 KB a block opts in
// to more dynamic shared memory, up to 227 KB. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments, a route or a
// plan the kernel does not take. Launches on `stream`, allocates nothing and
// does not synchronise.
extern "C" int fused_window_attention_forward(const void* q, const void* k, const void* v,
                                              void* out, long long n, int h, int t, int d,
                                              const long long* strides, float scale,
                                              int dtype, int route, int W, int Hg, int warps,
                                              void* stream) {
  const Plan p = attn::make_plan(n, h, W, Hg, warps);
  if (n <= 0 || h < 1 || t < 1 || t > attn::kFusedMaxT || 128 % t || d < 1 ||
      d > attn::kFusedMaxD || !attn::plan_ok(p) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int es = dtype == 0 ? 4 : 2;
  const void* ptrs[4] = {q, k, v, out};
  Layout l[4];
  for (int i = 0; i < 4; ++i) l[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const bool vec = (d * es) % 16 == 0 && (dtype == 0 ? attn::aligned16<float>(ptrs, l, 4)
                                                     : attn::aligned16<bf16>(ptrs, l, 4));
  const int smem = forward_smem(W, Hg, t, t, attn::fused_width(d), es);
  const bool mma_ok = dtype == 1 && t == 8 && d % 16 == 0 && vec &&
                      W * Hg * Hg < 65536;   // attn::div_small on pair indices
  if (smem > attn::kSmemOptIn || (route == attn::kRouteMma && !mma_ok) ||
      (route != attn::kRouteMma && route != attn::kRouteFfma))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (route == attn::kRouteMma)
    err = dispatch_fused<bf16, true, true>(d, ptrs, p, t, l, scale, smem, s);
  else if (dtype == 0)
    err = dispatch_fused_ffma<float>(vec, d, ptrs, p, t, l, scale, smem, s);
  else
    err = dispatch_fused_ffma<bf16>(vec, d, ptrs, p, t, l, scale, smem, s);
  return static_cast<int>(err);
}
