// Tiny-window attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel micformer_tpu/ops/pallas/window_attention_v2.py
// (`_kernel` / `_v2_forward`, reached from `window_attention_v2`): per window
// and head, out = softmax(q k^T * scale) v on [N, T, h, d] operands, with no
// bias and no mask. Every attention of the MicFormer serving path has this
// shape: T = 8, d = 16, and at sw_batch 4 the four stages run
// [16384, 8, 3, 16], [2048, 8, 6, 16], [256, 8, 12, 16] and [32, 8, 24, 16].
//
// Bound: memory. Each call reads q, k, v once and writes out once, 4 N T h d
// elements; the arithmetic is 4 T d multiply-adds per (window, head, query
// row), far below the card's operations-per-byte balance. In bf16 at 3.35
// TB/s the four stages are bounded by 15.02, 3.76, 0.94 and 0.23 us.
//
// Design (csrc/attn_tile.cuh holds the staging):
//   - A block takes a tile of W windows x Hg heads (about twelve (window, head)
//     pairs) and stages its q, k and v rows in shared memory with 16-byte
//     cp.async copies, so each byte leaves device memory once. One tile a
//     block: small tiles keep about 16 blocks on each SM, whose copies are
//     in flight together; where windows are few (the deep stages) the tile
//     shrinks to one window and then to fewer heads, so that the grid still
//     covers the card's SMs. (On the H100, grids of fewer blocks that walked
//     the tiles through a two-stage ring measured slower at every path
//     stage.)
//   - "mma" route (bf16, Tq = Tk = 8, d a multiple of 16; the serving path):
//     a warp takes two (window, head) pairs a step, stacked in the 16 rows of
//     mma.sync.m16n8k16. S = q k^T is two mmas per 16 features (one per
//     pair's keys; each pair keeps its half of the rows); softmax runs on the
//     f32 fragments (row max and sum over the four lanes of a row by
//     shuffles, exp2 with scale * log2(e) folded in); O = P v takes P from
//     registers as a block-diagonal A (pair a's keys in k 0-7, pair b's in
//     8-15) and v's fragments by ldmatrix.trans. P is split as hi + lo bf16
//     (two mmas), so P v keeps about 16 bits of P: f32-like sums, rounded
//     once on the store.
//   - "ffma" route (f32, d = 8, T != 8, Tq != Tk): one thread per (window,
//     head, query row) computes in f32 from the staged rows; k and v rows
//     are read once per pair from shared memory and broadcast to the Tq
//     threads that need them.
//   - Each output row overwrites its own q row in shared memory; the tile is
//     then written out as coalesced 16-byte stores.
// The TPU kernel's token-major [T, 512, h*d] relayout and per-head lane masks
// answered the TPU's 128-lane registers and are not carried over.
//
// Layout: q is [N, Tq, h, d] and k, v are [N, Tk, h, d] with the head and
// feature axes dense and the window and token axes collapsible to one row
// stride (token row r = n*T + t starts at r * row_stride elements), which
// covers contiguous tensors and the q/k/v slices of a fused projection.
// out is contiguous [N, Tq, h, d]. Logits, softmax and accumulation are f32.

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

template <typename T, int D, bool MMA>
__global__ void __launch_bounds__(attn::kMaxWarps * 32)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out, Plan plan, int tq,
                        int tk, Layout lq, Layout lk, Layout lv, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = attn::pitch_bytes(plan.Hg, D, sizeof(T)) / sizeof(T);
  const int qrows = plan.W * tq, krows = plan.W * tk;
  T* const qs = reinterpret_cast<T*>(smem);
  T* const ks = qs + qrows * pitch;
  T* const vs = ks + krows * pitch;
  const Layout lo = {static_cast<int64_t>(tq) * plan.h * D, static_cast<int64_t>(plan.h) * D, D};

  constexpr int kRpw = MMA ? 8 : 0;   // token rows a window, when fixed
  const attn::Walk start = attn::walk_for<T, D>(plan.Hg);
  const TilePos tp = attn::tile_pos(plan, blockIdx.x);
  attn::stage_rows<T, D, true, kRpw>(qs, pitch, q, lq, tp, tq, plan.Hg, start);
  attn::stage_rows<T, D, true, kRpw>(ks, pitch, k, lk, tp, tk, plan.Hg, start);
  attn::stage_rows<T, D, true, kRpw>(vs, pitch, v, lv, tp, tk, plan.Hg, start);
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
    for (int it = threadIdx.x; it < pairs * tq; it += blockDim.x)
      ffma_row<T, D>(qs, ks, vs, pitch, tq, tk, plan.Hg, it / tq, it % tq, scale);
  }
  __syncthreads();
  attn::store_rows<T, D, true, kRpw>(out, lo, qs, pitch, tp, tq, plan.Hg, start);
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
