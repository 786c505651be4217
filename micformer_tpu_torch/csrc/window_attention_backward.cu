// Window-attention backward for Hopper (sm_90a): the gradient of
// out = softmax(q k^T * scale) v per (window, head), for both attention kernels.
//
// Replaces the backward halves of the two TPU window-attention kernels, which
// the JAX package writes as f32 einsums around its Pallas forwards:
//   - window_attention_backward: `_v2_bwd` of
//     micformer_tpu/ops/pallas/window_attention_v2.py (K1's gradient) on
//     [N, T, h, d] operands, Tq, Tk <= 16, d in {8, 16, 32, 64};
//   - fused_window_attention_backward: `_bwd` of
//     micformer_tpu/ops/pallas/window_attention.py (K2's gradient) on
//     [N, h, T, d] operands, T <= 32 with 128 % T == 0, any d <= 128. The TPU
//     forward packs 128 / T pairs into one block-diagonal 128-row tile; its
//     gradient is plain einsums per pair, as here.
// Every operand is addressed through its (window, token, head) element
// strides with a dense feature axis, so the two layouts, and q/k/v taken as
// slices of a fused projection, differ only in the strides the wrapper passes
// (it hands K2's operands over as [N, T, h, d] views).
//
// Math, per (window, head), f32 throughout, rounded once to the input dtype:
//   P = softmax(s q k^T), dV = P^T g, dP = g v^T,
//   dS = P o (dP - rowsum(P o dP)), dQ = s dS K, dK = s dS^T Q.
//
// Bound: memory. A call reads q, k, v and g once and writes dq, dk and dv
// once, 7 N T h d elements; the arithmetic is about 10 T^2 d flops per
// (window, head), a few flops per byte. In bf16 at 3.35 TB/s the four stages
// of a b1 training step, [4096, 8, 3, 16], [512, 8, 6, 16], [64, 8, 12, 16]
// and [8, 8, 24, 16] (K2: the same as [N, h, T, d]), are bounded by 6.57,
// 1.64, 0.41 and 0.10 us.
//
// Design: one tile kernel, two entries (csrc/attn_tile.cuh holds the staging):
//   - A block takes a tile of W windows x Hg heads (about six pairs at T = 8;
//     K2 scales the count by 8 / T) and stages its q, k, v and g rows in
//     shared memory once each (16-byte cp.async copies when every address and
//     stride allows, else element copies). One tile a block, so each block's
//     chain is one load wave, the products and one store wave; where windows
//     are few the tile shrinks to one window and then to fewer heads, so that
//     the grid covers the card's SMs at every stage (stage 3: 192 blocks of
//     one pair). K2 stages d <= D features in the next compiled width D, the
//     tail as zeros, and stores the first d; a K2 pair that needs more than 48
//     KB (T = 32, d = 128, f32: about 74 KB with its P and dS rows) is a tile
//     of its own, and the entry opts in to the larger dynamic shared memory.
//   - "mma" route (bf16, Tq = Tk = 8, d a multiple of 16, aligned; every
//     training step of MicFormer, K1 or K2): one warp owns two (window, head)
//     pairs a step, stacked in the 16 rows of mma.sync.m16n8k16, and computes
//     their five products on the tensor cores: S and dP (one mma per pair and
//     16 features), then dV = P^T g, dK = s dS^T q and dQ = s dS k with
//     block-diagonal A operands (pair a in k 0-7, pair b in k 8-15). P^T and
//     dS^T come back by ldmatrix.trans from a 1 KB per-warp tile; dS for dQ
//     straight from the f32 fragments. P and dS enter the products as hi + lo
//     bf16 (two mmas each), so the sums keep about 16 bits of them. The warp
//     writes its pairs' dQ, dK and dV over their staged q, k and v rows, and
//     the block stores the tile as coalesced 16-byte rows. K1 and K2 run the
//     same device code.
//   - "ffma" route (f32, d = 8, T != 8, Tq != Tk, unaligned operands, K2's odd
//     widths): one thread per (pair, query row) computes its P and dS rows
//     from the staged rows into shared memory; after a barrier one thread per
//     (pair, row) sums its dQ, dK and dV rows from shared memory and writes
//     them. K2 keeps 32 logits a thread where T = 32 (K1's 16 below) and
//     pads its P and dS rows to an odd count of floats, so the threads of a
//     warp reading one key column for dQ fall on different banks.
// Each gradient row is written once by one warp or thread, with no atomics:
// the same inputs give the same bits.

#include <math.h>

#include "attn_tile.cuh"

namespace {

using attn::Layout;
using attn::Plan;
using attn::TilePos;
using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

// Floats between the P (or dS) rows of the ffma route: Tk, and for K2 Tk made
// odd, so a key column's rows fall on different banks.
__host__ __device__ inline int p_pitch(int tk, bool fused) { return fused ? tk | 1 : tk; }

// Shared memory of a block: its tile's q, k, v and g rows, then per-warp 8x8
// tiles (mma) or the tile's P and dS rows in f32 (ffma).
int backward_smem(int W, int Hg, int warps, int tq, int tk, int d, int es, int route,
                  bool fused = false) {
  const int rows = W * (2 * tq + 2 * tk) * attn::pitch_bytes(Hg, d, es);
  const int extra = route == attn::kRouteMma ? warps * attn::kWarpTileBytes
                                             : W * Hg * tq * p_pitch(tk, fused) * 2 * 4;
  return rows + extra;
}

__device__ __forceinline__ void put2(bf16* p, float x0, float x1) {
  *reinterpret_cast<uint32_t*>(p) = attn::pack_bf16(x0, x1);
}

// One warp, pairs pa and pb of the tile (pb == pa when the tile's pair count
// is odd; then only pa is written), Tq = Tk = 8. Leaves dQ in the pairs' q
// rows, dK in their k rows and dV in their v rows. wt: the warp's 1 KB tile.
template <int D>
__device__ __forceinline__ void mma_step(bf16* qs, bf16* ks, bf16* vs, const bf16* gs,
                                         int pitch, int hg, uint32_t hg_magic, int pa, int pb,
                                         bool b_valid, float scale, float sl2, uint32_t* wt) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = (lane & 3) * 2;
  const int m = lane >> 3, r = lane & 7;       // ldmatrix: matrix m, row r
  const int wa = attn::div_small(pa, hg_magic), wb = attn::div_small(pb, hg_magic);
  const int ba = wa * 8 * pitch + (pa - wa * hg) * D;
  const int bb = wb * 8 * pitch + (pb - wb * hg) * D;
  // S = q k^T and dP = g v^T: rows 0-7 pair a, rows 8-15 pair b
  float sa[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
  float da[4] = {0.f, 0.f, 0.f, 0.f}, db[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    const int oa = ((m & 1) ? bb : ba) + r * pitch + kk + (m >> 1) * 8;
    const int ob = ((m >> 1) ? bb : ba) + r * pitch + kk + (m & 1) * 8;
    uint32_t aq[4], ag[4], bk[4], bv[4];
    attn::ldsm_x4(aq, qs + oa);
    attn::ldsm_x4(ag, gs + oa);
    attn::ldsm_x4(bk, ks + ob);
    attn::ldsm_x4(bv, vs + ob);
    attn::mma16816(sa, aq, bk[0], bk[1]);
    attn::mma16816(sb, aq, bk[2], bk[3]);
    attn::mma16816(da, ag, bv[0], bv[1]);
    attn::mma16816(db, ag, bv[2], bv[3]);
  }
  // this lane: pair a row g (sa[0..1], da[0..1]) and pair b row g (sb[2..3],
  // db[2..3]), keys c and c + 1
  const float xa0 = sa[0] * sl2, xa1 = sa[1] * sl2, xb0 = sb[2] * sl2, xb1 = sb[3] * sl2;
  const float ma = attn::quad_max(fmaxf(xa0, xa1)), mb = attn::quad_max(fmaxf(xb0, xb1));
  float pa0 = attn::fast_exp2(xa0 - ma), pa1 = attn::fast_exp2(xa1 - ma);
  float pb0 = attn::fast_exp2(xb0 - mb), pb1 = attn::fast_exp2(xb1 - mb);
  const float ia = __fdividef(1.f, attn::quad_sum(pa0 + pa1));
  const float ib = __fdividef(1.f, attn::quad_sum(pb0 + pb1));
  pa0 *= ia; pa1 *= ia; pb0 *= ib; pb1 *= ib;
  const float rsa = attn::quad_sum(pa0 * da[0] + pa1 * da[1]);
  const float rsb = attn::quad_sum(pb0 * db[2] + pb1 * db[3]);
  const float sa0 = pa0 * (da[0] - rsa), sa1 = pa1 * (da[1] - rsa);
  const float sb0 = pb0 * (db[2] - rsb), sb1 = pb1 * (db[3] - rsb);
  uint32_t ph[2], pl[2], dh[2], dl[2];
  attn::split_bf16(pa0, pa1, ph[0], pl[0]);
  attn::split_bf16(pb0, pb1, ph[1], pl[1]);
  attn::split_bf16(sa0, sa1, dh[0], dl[0]);
  attn::split_bf16(sb0, sb1, dh[1], dl[1]);
  // P and dS of both pairs as 8x8 bf16 matrices [query row][key]:
  // P hi a, P hi b, P lo a, P lo b, dS hi a, dS hi b, dS lo a, dS lo b;
  // ldmatrix.trans gives them back as P^T and dS^T A fragments
  __syncwarp();
  const int wi = g * 4 + (lane & 3);
  wt[wi] = ph[0];
  wt[32 + wi] = ph[1];
  wt[64 + wi] = pl[0];
  wt[96 + wi] = pl[1];
  wt[128 + wi] = dh[0];
  wt[160 + wi] = dh[1];
  wt[192 + wi] = dl[0];
  wt[224 + wi] = dl[1];
  __syncwarp();
  uint32_t tp[4], td[4];
  attn::ldsm_x4_t(tp, wt + m * 32 + r * 4);
  attn::ldsm_x4_t(td, wt + 128 + m * 32 + r * 4);
  // block-diagonal A operands, rows 0-7 pair a and 8-15 pair b: P^T (for
  // dV), dS^T (for dK), and dS straight from the fragments (for dQ)
  const uint32_t pth[4] = {tp[0], 0u, 0u, tp[1]}, ptl[4] = {tp[2], 0u, 0u, tp[3]};
  const uint32_t dth[4] = {td[0], 0u, 0u, td[1]}, dtl[4] = {td[2], 0u, 0u, td[3]};
  const uint32_t dsh[4] = {dh[0], 0u, 0u, dh[1]}, dsl[4] = {dl[0], 0u, 0u, dl[1]};
#pragma unroll
  for (int nt = 0; nt < D; nt += 16) {
    // B: k 0-7 pair a's rows, k 8-15 pair b's; features nt and nt + 8
    const int o = ((m & 1) ? bb : ba) + r * pitch + nt + (m >> 1) * 8;
    uint32_t bg[4], bq[4], bk[4];
    attn::ldsm_x4_t(bg, gs + o);
    attn::ldsm_x4_t(bq, qs + o);
    attn::ldsm_x4_t(bk, ks + o);
    float v0[4] = {0.f, 0.f, 0.f, 0.f}, v1[4] = {0.f, 0.f, 0.f, 0.f};
    float k0[4] = {0.f, 0.f, 0.f, 0.f}, k1[4] = {0.f, 0.f, 0.f, 0.f};
    float q0[4] = {0.f, 0.f, 0.f, 0.f}, q1[4] = {0.f, 0.f, 0.f, 0.f};
    attn::mma16816(v0, pth, bg[0], bg[1]);
    attn::mma16816(v0, ptl, bg[0], bg[1]);
    attn::mma16816(v1, pth, bg[2], bg[3]);
    attn::mma16816(v1, ptl, bg[2], bg[3]);
    attn::mma16816(k0, dth, bq[0], bq[1]);
    attn::mma16816(k0, dtl, bq[0], bq[1]);
    attn::mma16816(k1, dth, bq[2], bq[3]);
    attn::mma16816(k1, dtl, bq[2], bq[3]);
    attn::mma16816(q0, dsh, bk[0], bk[1]);
    attn::mma16816(q0, dsl, bk[0], bk[1]);
    attn::mma16816(q1, dsh, bk[2], bk[3]);
    attn::mma16816(q1, dsl, bk[2], bk[3]);
    __syncwarp();
    // features nt .. nt + 15 of these rows are read no more
    const int wa = ba + g * pitch + nt + c;
    put2(vs + wa, v0[0], v0[1]);
    put2(vs + wa + 8, v1[0], v1[1]);
    put2(ks + wa, k0[0] * scale, k0[1] * scale);
    put2(ks + wa + 8, k1[0] * scale, k1[1] * scale);
    put2(qs + wa, q0[0] * scale, q0[1] * scale);
    put2(qs + wa + 8, q1[0] * scale, q1[1] * scale);
    if (b_valid) {
      const int wb = bb + g * pitch + nt + c;
      put2(vs + wb, v0[2], v0[3]);
      put2(vs + wb + 8, v1[2], v1[3]);
      put2(ks + wb, k0[2] * scale, k0[3] * scale);
      put2(ks + wb + 8, k1[2] * scale, k1[3] * scale);
      put2(qs + wb, q0[2] * scale, q0[3] * scale);
      put2(qs + wb + 8, q1[2] * scale, q1[3] * scale);
    }
  }
}

// ffma, phase 1. One thread, query row i of pair p: its row of P and of dS
// into sp and sds ([pair][query row][key], f32, rows `ldp` floats apart).
template <typename T, int D, int MAXT>
__device__ __forceinline__ void ffma_probs(const T* qs, const T* ks, const T* vs, const T* gs,
                                           int pitch, int tq, int tk, int hg, int p, int i,
                                           float scale, float* sp, float* sds, int ldp) {
  constexpr int kE = 16 / sizeof(T);
  const int w = p / hg, col = (p % hg) * D;
  const T* qr = qs + (w * tq + i) * pitch + col;
  const T* gr = gs + (w * tq + i) * pitch + col;
  const T* kb = ks + w * tk * pitch + col;
  const T* vb = vs + w * tk * pitch + col;
  float s[MAXT], dp[MAXT];
#pragma unroll
  for (int j = 0; j < MAXT; ++j) s[j] = dp[j] = 0.f;
  for (int e0 = 0; e0 < D; e0 += kE) {   // logits and dP = g v^T, a chunk at a time
    float qc[kE], gc[kE];
    attn::load_row<T, kE>(qr + e0, qc);
    attn::load_row<T, kE>(gr + e0, gc);
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
      if (j < tk) {
        float kc[kE], vc[kE];
        attn::load_row<T, kE>(kb + j * pitch + e0, kc);
        attn::load_row<T, kE>(vb + j * pitch + e0, vc);
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          s[j] = fmaf(qc[e] * scale, kc[e], s[j]);
          dp[j] = fmaf(gc[e], vc[e], dp[j]);
        }
      }
    }
  }
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < MAXT; ++j) if (j < tk) mx = fmaxf(mx, s[j]);
  float denom = 0.f;
#pragma unroll
  for (int j = 0; j < MAXT; ++j) {
    s[j] = j < tk ? expf(s[j] - mx) : 0.f;
    denom += s[j];
  }
  const float inv = 1.f / denom;
  float rowsum = 0.f;
#pragma unroll
  for (int j = 0; j < MAXT; ++j) {
    s[j] *= inv;
    rowsum = fmaf(s[j], dp[j], rowsum);
  }
  float* prow = sp + (p * tq + i) * ldp;
  float* drow = sds + (p * tq + i) * ldp;
#pragma unroll
  for (int j = 0; j < MAXT; ++j) {
    if (j < tk) {
      prow[j] = s[j];
      drow[j] = s[j] * (dp[j] - rowsum);
    }
  }
}

// E values to p: one 16-byte store (VEC), else element stores, of the first
// n only with TAIL.
template <typename T, int E, bool VEC, bool TAIL = false>
__device__ __forceinline__ void store_chunk(T* __restrict__ p, const float (&r)[E], int n = E) {
  if constexpr (VEC) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < E; ++j) e[j] = attn::from_float<T>(r[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j)
      if (!TAIL || j < n) p[j] = attn::from_float<T>(r[j]);
  }
}

// ffma, phase 2. One thread, row rr of pair p: dQ of query row rr = s dS K,
// and dV, dK of key row rr = P^T g, s dS^T q, written to device memory (TAIL:
// the first d features; with VEC, d is whole 16-byte chunks).
template <typename T, int D, bool VEC, bool TAIL = false>
__device__ __forceinline__ void ffma_grads(const T* qs, const T* ks, const T* gs, int pitch,
                                           int tq, int tk, int hg, int p, int rr, float scale,
                                           const float* sp, const float* sds, int ldp,
                                           TilePos tp, T* dq, T* dk, T* dv, Layout ldq,
                                           Layout ldk, Layout ldv, int d = D) {
  constexpr int kE = 16 / sizeof(T);
  const int w = p / hg, hh = p % hg, col = hh * D;
  const int64_t n = tp.n0 + w;
  const int head = tp.h0 + hh;
  const int dend = TAIL ? d : D;
  const float* prow = sp + p * tq * ldp;
  const float* drow = sds + p * tq * ldp;
  if (rr < tq) {
    T* out = dq + n * ldq.n + rr * ldq.t + head * ldq.h;
    for (int e0 = 0; e0 < dend; e0 += kE) {
      float acc[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] = 0.f;
      for (int j = 0; j < tk; ++j) {
        float kc[kE];
        attn::load_row<T, kE>(ks + (w * tk + j) * pitch + col + e0, kc);
        const float dsj = drow[rr * ldp + j];
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[e] = fmaf(dsj, kc[e], acc[e]);
      }
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] *= scale;
      store_chunk<T, kE, VEC, TAIL>(out + e0, acc, dend - e0);
    }
  }
  if (rr < tk) {
    T* outk = dk + n * ldk.n + rr * ldk.t + head * ldk.h;
    T* outv = dv + n * ldv.n + rr * ldv.t + head * ldv.h;
    for (int e0 = 0; e0 < dend; e0 += kE) {
      float ak[kE], av[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) ak[e] = av[e] = 0.f;
      for (int i = 0; i < tq; ++i) {
        float qc[kE], gc[kE];
        attn::load_row<T, kE>(qs + (w * tq + i) * pitch + col + e0, qc);
        attn::load_row<T, kE>(gs + (w * tq + i) * pitch + col + e0, gc);
        const float pij = prow[i * ldp + rr], sij = drow[i * ldp + rr];
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          av[e] = fmaf(pij, gc[e], av[e]);
          ak[e] = fmaf(sij, qc[e], ak[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < kE; ++e) ak[e] *= scale;
      store_chunk<T, kE, VEC, TAIL>(outv + e0, av, dend - e0);
      store_chunk<T, kE, VEC, TAIL>(outk + e0, ak, dend - e0);
    }
  }
}

// Block blockIdx.x's tile: stage q, k, v, g, compute, store. FUSED (K2): up
// to 32 tokens, odd P and dS row pitch. TAIL (K2 only): d < D, the tail
// staged as zeros and not stored. Else d = D.
template <typename T, int D, bool VEC, bool MMA, bool FUSED, bool TAIL>
__device__ __forceinline__ void backward_tile(
    unsigned char* smem, const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ g, T* __restrict__ dq, T* __restrict__ dk,
    T* __restrict__ dv, const Plan& plan, int tq, int tk, Layout lq, Layout lk, Layout lv,
    Layout lg, Layout ldq, Layout ldk, Layout ldv, int d, float scale) {
  const int pitch = attn::pitch_bytes(plan.Hg, D, sizeof(T)) / sizeof(T);
  const int qrows = plan.W * tq, krows = plan.W * tk;
  T* const qs = reinterpret_cast<T*>(smem);   // q | k | v | g
  T* const ks = qs + qrows * pitch;
  T* const vs = ks + krows * pitch;
  T* const gs = vs + krows * pitch;
  unsigned char* const extra = reinterpret_cast<unsigned char*>(gs + qrows * pitch);

  constexpr int kRpw = MMA ? 8 : 0;   // token rows a window, when fixed
  const attn::Walk start = attn::walk_for<T, D>(plan.Hg);
  const TilePos tp = attn::tile_pos(plan, blockIdx.x);
  attn::stage_rows<T, D, VEC, kRpw, TAIL>(qs, pitch, q, lq, tp, tq, plan.Hg, start, d);
  attn::stage_rows<T, D, VEC, kRpw, TAIL>(ks, pitch, k, lk, tp, tk, plan.Hg, start, d);
  attn::stage_rows<T, D, VEC, kRpw, TAIL>(vs, pitch, v, lv, tp, tk, plan.Hg, start, d);
  attn::stage_rows<T, D, VEC, kRpw, TAIL>(gs, pitch, g, lg, tp, tq, plan.Hg, start, d);
  attn::cp_async_commit();
  attn::cp_async_wait_all();
  __syncthreads();
  const int pairs = tp.nw * plan.Hg;
  if constexpr (MMA) {
    const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    const uint32_t hg_magic = attn::div_magic(plan.Hg);
    uint32_t* wt = reinterpret_cast<uint32_t*>(extra + warp * attn::kWarpTileBytes);
    for (int s = warp; 2 * s < pairs; s += nwarps)
      mma_step<D>(qs, ks, vs, gs, pitch, plan.Hg, hg_magic, 2 * s, min(2 * s + 1, pairs - 1),
                  2 * s + 1 < pairs, scale, scale * kLog2e, wt);
    __syncthreads();
    attn::store_rows<T, D, true, kRpw, TAIL>(dq, ldq, qs, pitch, tp, tq, plan.Hg, start, d);
    attn::store_rows<T, D, true, kRpw, TAIL>(dk, ldk, ks, pitch, tp, tk, plan.Hg, start, d);
    attn::store_rows<T, D, true, kRpw, TAIL>(dv, ldv, vs, pitch, tp, tk, plan.Hg, start, d);
  } else {
    const int ldp = p_pitch(tk, FUSED);
    float* sp = reinterpret_cast<float*>(extra);
    float* sds = sp + plan.W * plan.Hg * tq * ldp;
    // K1's 16 logits a thread where they fit (the branch is the grid's)
    const bool short_rows = !FUSED || tk <= attn::kMaxT;
    for (int it = threadIdx.x; it < pairs * tq; it += blockDim.x) {
      if (short_rows)
        ffma_probs<T, D, attn::kMaxT>(qs, ks, vs, gs, pitch, tq, tk, plan.Hg, it / tq, it % tq,
                                      scale, sp, sds, ldp);
      else
        ffma_probs<T, D, attn::kFusedMaxT>(qs, ks, vs, gs, pitch, tq, tk, plan.Hg, it / tq,
                                           it % tq, scale, sp, sds, ldp);
    }
    __syncthreads();
    const int rows = tq > tk ? tq : tk;
    for (int it = threadIdx.x; it < pairs * rows; it += blockDim.x)
      ffma_grads<T, D, VEC, TAIL>(qs, ks, gs, pitch, tq, tk, plan.Hg, it / rows, it % rows,
                                  scale, sp, sds, ldp, tp, dq, dk, dv, ldq, ldk, ldv, d);
  }
}

// K1: d = D.
template <typename T, int D, bool VEC, bool MMA>
__global__ void __launch_bounds__(attn::kMaxWarps * 32)
window_attention_backward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                 const T* __restrict__ v, const T* __restrict__ g,
                                 T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                                 Plan plan, int tq, int tk, Layout lq, Layout lk, Layout lv,
                                 Layout lg, Layout ldq, Layout ldk, Layout ldv, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  backward_tile<T, D, VEC, MMA, false, false>(smem, q, k, v, g, dq, dk, dv, plan, tq, tk, lq,
                                              lk, lv, lg, ldq, ldk, ldv, D, scale);
}

// K2: T tokens, d <= D (d < D: TAIL).
template <typename T, int D, bool VEC, bool MMA, bool TAIL>
__global__ void __launch_bounds__(attn::kMaxWarps * 32)
fused_window_attention_backward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                       const T* __restrict__ v, const T* __restrict__ g,
                                       T* __restrict__ dq, T* __restrict__ dk,
                                       T* __restrict__ dv, Plan plan, int t, Layout lq,
                                       Layout lk, Layout lv, Layout lg, Layout ldq,
                                       Layout ldk, Layout ldv, int d, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  backward_tile<T, D, VEC, MMA, true, TAIL>(smem, q, k, v, g, dq, dk, dv, plan, t, t, lq, lk,
                                            lv, lg, ldq, ldk, ldv, d, scale);
}

template <typename T, int D, bool VEC, bool MMA>
cudaError_t launch_k1(const void* const* ptrs, const Plan& p, int tq, int tk, const Layout* l,
                      float scale, int smem, cudaStream_t stream) {
  window_attention_backward_kernel<T, D, VEC, MMA>
      <<<static_cast<unsigned>(p.tiles), p.warps * 32, smem, stream>>>(
      static_cast<const T*>(ptrs[0]), static_cast<const T*>(ptrs[1]),
      static_cast<const T*>(ptrs[2]), static_cast<const T*>(ptrs[3]),
      static_cast<T*>(const_cast<void*>(ptrs[4])), static_cast<T*>(const_cast<void*>(ptrs[5])),
      static_cast<T*>(const_cast<void*>(ptrs[6])), p, tq, tk, l[0], l[1], l[2], l[3], l[4],
      l[5], l[6], scale);
  return cudaGetLastError();
}

template <typename T, bool VEC, bool MMA>
cudaError_t dispatch_k1(int d, const void* const* ptrs, const Plan& p, int tq, int tk,
                        const Layout* l, float scale, int smem, cudaStream_t s) {
  switch (d) {
    case 8:
      if constexpr (!MMA) return launch_k1<T, 8, VEC, MMA>(ptrs, p, tq, tk, l, scale, smem, s);
      return cudaErrorInvalidValue;
    case 16: return launch_k1<T, 16, VEC, MMA>(ptrs, p, tq, tk, l, scale, smem, s);
    case 32: return launch_k1<T, 32, VEC, MMA>(ptrs, p, tq, tk, l, scale, smem, s);
    case 64: return launch_k1<T, 64, VEC, MMA>(ptrs, p, tq, tk, l, scale, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_ffma(bool vec, int d, const void* const* ptrs, const Plan& p, int tq,
                          int tk, const Layout* l, float scale, int smem, cudaStream_t s) {
  return vec ? dispatch_k1<T, true, false>(d, ptrs, p, tq, tk, l, scale, smem, s)
             : dispatch_k1<T, false, false>(d, ptrs, p, tq, tk, l, scale, smem, s);
}

template <typename T, int D, bool VEC, bool MMA, bool TAIL>
cudaError_t launch_k2(const void* const* ptrs, const Plan& p, int t, const Layout* l, int d,
                      float scale, int smem, cudaStream_t stream) {
  auto kernel = fused_window_attention_backward_kernel<T, D, VEC, MMA, TAIL>;
  if (smem > attn::kSmemLimit) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(p.tiles), p.warps * 32, smem, stream>>>(
      static_cast<const T*>(ptrs[0]), static_cast<const T*>(ptrs[1]),
      static_cast<const T*>(ptrs[2]), static_cast<const T*>(ptrs[3]),
      static_cast<T*>(const_cast<void*>(ptrs[4])), static_cast<T*>(const_cast<void*>(ptrs[5])),
      static_cast<T*>(const_cast<void*>(ptrs[6])), p, t, l[0], l[1], l[2], l[3], l[4], l[5],
      l[6], d, scale);
  return cudaGetLastError();
}

// The mma route at a compiled width runs without the tail code (K1's code);
// the ffma route always takes it.
template <typename T, int D, bool VEC, bool MMA>
cudaError_t launch_k2_at(const void* const* ptrs, const Plan& p, int t, const Layout* l, int d,
                         float scale, int smem, cudaStream_t s) {
  if constexpr (MMA) {
    if (d == D) return launch_k2<T, D, VEC, MMA, false>(ptrs, p, t, l, d, scale, smem, s);
  }
  return launch_k2<T, D, VEC, MMA, true>(ptrs, p, t, l, d, scale, smem, s);
}

template <typename T, bool VEC, bool MMA>
cudaError_t dispatch_k2(int d, const void* const* ptrs, const Plan& p, int t, const Layout* l,
                        float scale, int smem, cudaStream_t s) {
  switch (attn::fused_width(d)) {
    case 8:
      if constexpr (!MMA) return launch_k2_at<T, 8, VEC, MMA>(ptrs, p, t, l, d, scale, smem, s);
      return cudaErrorInvalidValue;
    case 16: return launch_k2_at<T, 16, VEC, MMA>(ptrs, p, t, l, d, scale, smem, s);
    case 32: return launch_k2_at<T, 32, VEC, MMA>(ptrs, p, t, l, d, scale, smem, s);
    case 64: return launch_k2_at<T, 64, VEC, MMA>(ptrs, p, t, l, d, scale, smem, s);
    default: return launch_k2_at<T, 128, VEC, MMA>(ptrs, p, t, l, d, scale, smem, s);
  }
}

template <typename T>
cudaError_t dispatch_k2_ffma(bool vec, int d, const void* const* ptrs, const Plan& p, int t,
                             const Layout* l, float scale, int smem, cudaStream_t s) {
  return vec ? dispatch_k2<T, true, false>(d, ptrs, p, t, l, scale, smem, s)
             : dispatch_k2<T, false, false>(d, ptrs, p, t, l, scale, smem, s);
}
}  // namespace

// Both entry points: q, k, v, g and the outputs dq, dk, dv addressed as
// [N, T, h, d] through `strides`, 21 element strides (window, token, head)
// for q, k, v, g, dq, dk, dv in that order, the feature axis dense.
// dtype: 0 = float32, 1 = bfloat16. route: 0 = mma (bf16, Tq = Tk = 8, d a
// multiple of 16, every address and stride 16-byte aligned), 1 = ffma;
// (W, Hg, warps) the tile plan, one block a tile. A route or plan the inputs
// cannot take is refused. Each returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for arguments the kernel does not take. Each
// launches on `stream`, allocates nothing and does not synchronise.
//
// K1: Tq, Tk <= 16, d in {8, 16, 32, 64}, the plan of `_attn_plan`, at most
// 48 KB of shared memory a block.
extern "C" int window_attention_backward(const void* q, const void* k, const void* v,
                                         const void* g, void* dq, void* dk, void* dv,
                                         long long n, int tq, int tk, int h, int d,
                                         const long long* strides, float scale, int dtype,
                                         int route, int W, int Hg, int warps,
                                         void* stream) {
  const Plan p = attn::make_plan(n, h, W, Hg, warps);
  if (n <= 0 || tq < 1 || tq > attn::kMaxT || tk < 1 || tk > attn::kMaxT || h < 1 ||
      !attn::plan_ok(p) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[7] = {q, k, v, g, dq, dk, dv};
  Layout l[7];
  for (int i = 0; i < 7; ++i) l[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const bool vec = dtype == 0 ? attn::aligned16<float>(ptrs, l, 7)
                              : attn::aligned16<bf16>(ptrs, l, 7);
  const int smem = backward_smem(W, Hg, warps, tq, tk, d, dtype == 0 ? 4 : 2, route);
  const bool mma_ok = dtype == 1 && tq == 8 && tk == 8 && d % 16 == 0 && vec &&
                      W * Hg * Hg < 65536;   // attn::div_small on pair indices
  if (smem > attn::kSmemLimit || (route == attn::kRouteMma && !mma_ok) ||
      (route != attn::kRouteMma && route != attn::kRouteFfma))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (route == attn::kRouteMma)
    err = dispatch_k1<bf16, true, true>(d, ptrs, p, tq, tk, l, scale, smem, s);
  else if (dtype == 0)
    err = dispatch_ffma<float>(vec, d, ptrs, p, tq, tk, l, scale, smem, s);
  else
    err = dispatch_ffma<bf16>(vec, d, ptrs, p, tq, tk, l, scale, smem, s);
  return static_cast<int>(err);
}

// Bytes of shared memory a block of K1's backward takes on `route` with
// the plan (W, Hg, warps); dtype 0 = float32, 1 = bfloat16 (`_attn_smem` in
// kernels/window_attention.py is held equal to this on the card).
extern "C" int window_attention_backward_smem(int W, int Hg, int warps, int tq, int tk, int d,
                                              int dtype, int route) {
  return backward_smem(W, Hg, warps, tq, tk, d, dtype == 0 ? 4 : 2, route);
}

// K2: tq = tk = T <= 32 with 128 % T == 0, 1 <= d <= 128 (staged at
// attn::fused_width(d)), the plan of `_fused_plan`; above 48 KB a block opts
// in to more dynamic shared memory, up to 227 KB.
extern "C" int fused_window_attention_backward(const void* q, const void* k, const void* v,
                                               const void* g, void* dq, void* dk, void* dv,
                                               long long n, int tq, int tk, int h, int d,
                                               const long long* strides, float scale,
                                               int dtype, int route, int W, int Hg, int warps,
                                               void* stream) {
  const Plan p = attn::make_plan(n, h, W, Hg, warps);
  if (n <= 0 || tq < 1 || tq > attn::kFusedMaxT || 128 % tq || tk != tq || h < 1 || d < 1 ||
      d > attn::kFusedMaxD || !attn::plan_ok(p) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int es = dtype == 0 ? 4 : 2;
  const void* ptrs[7] = {q, k, v, g, dq, dk, dv};
  Layout l[7];
  for (int i = 0; i < 7; ++i) l[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const bool vec = (d * es) % 16 == 0 && (dtype == 0 ? attn::aligned16<float>(ptrs, l, 7)
                                                     : attn::aligned16<bf16>(ptrs, l, 7));
  const int smem = backward_smem(W, Hg, warps, tq, tq, attn::fused_width(d), es, route, true);
  const bool mma_ok = dtype == 1 && tq == 8 && d % 16 == 0 && vec &&
                      W * Hg * Hg < 65536;   // attn::div_small on pair indices
  if (smem > attn::kSmemOptIn || (route == attn::kRouteMma && !mma_ok) ||
      (route != attn::kRouteMma && route != attn::kRouteFfma))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (route == attn::kRouteMma)
    err = dispatch_k2<bf16, true, true>(d, ptrs, p, tq, l, scale, smem, s);
  else if (dtype == 0)
    err = dispatch_k2_ffma<float>(vec, d, ptrs, p, tq, l, scale, smem, s);
  else
    err = dispatch_k2_ffma<bf16>(vec, d, ptrs, p, tq, l, scale, smem, s);
  return static_cast<int>(err);
}

// Bytes of shared memory a block of K2's backward takes on `route` with the
// plan (W, Hg, warps) at T tokens and d features (`_fused_smem` in
// kernels/fused_window_attention.py is held equal to this on the card).
extern "C" int fused_window_attention_backward_smem(int W, int Hg, int warps, int t, int d,
                                                    int dtype, int route) {
  return backward_smem(W, Hg, warps, t, t, attn::fused_width(d), dtype == 0 ? 4 : 2, route,
                       true);
}
