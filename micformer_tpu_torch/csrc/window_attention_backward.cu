// Window-attention backward for Hopper (sm_90a): the gradient of
// out = softmax(q k^T * scale) v per (window, head), for both attention kernels.
//
// Replaces the backward halves of the two TPU window-attention kernels, which
// the JAX package writes as f32 einsums around its Pallas forwards:
//   - window_attention_backward: `_v2_bwd` of
//     micformer_tpu/ops/pallas/window_attention_v2.py (K1's gradient) on
//     [N, T, h, d] operands, Tq, Tk <= 16;
//   - fused_window_attention_backward: `_bwd` of
//     micformer_tpu/ops/pallas/window_attention.py (K2's gradient) on
//     [N, h, T, d] operands, T <= 32.
// Every operand is addressed through its (window, token, head) element
// strides with a dense feature axis, so the two layouts, and q/k/v taken as
// slices of a fused projection, differ only in the strides the wrapper passes.
//
// Math, per (window, head), f32 throughout, rounded once to the input dtype:
//   P = softmax(s q k^T), dV = P^T g, dP = g v^T,
//   dS = P o (dP - rowsum(P o dP)), dQ = s dS K, dK = s dS^T Q.
//
// Bound: memory. A call reads q, k, v and g once and writes dq, dk and dv
// once, 7 N T h d elements; the arithmetic is about 10 T^2 d flops per
// (window, head), a few flops per byte. In bf16 at 3.35 TB/s the four stages
// of a b1 training step, [4096, 8, 3, 16], [512, 8, 6, 16], [64, 8, 12, 16]
// and [8, 8, 24, 16], are bounded by 6.57, 1.64, 0.41 and 0.10 us.
//
// K1's kernel (`window_attention_backward`; csrc/attn_tile.cuh holds the
// staging):
//   - A block takes a tile of W windows x Hg heads (about six pairs) and
//     stages its q, k, v and g rows in shared memory once each (16-byte
//     cp.async copies when every address and stride allows, else element
//     copies). One tile a block, so each block's chain is one load wave, the
//     products and one store wave; where windows are few the tile shrinks to
//     one window and then to fewer heads, so that the grid covers the card's
//     SMs at every stage (stage 3: 192 blocks of one pair).
//   - "mma" route (bf16, Tq = Tk = 8, d a multiple of 16; the training path):
//     one warp owns two (window, head) pairs a step, stacked in the 16 rows of
//     mma.sync.m16n8k16, and computes their five products on the tensor
//     cores: S and dP (one mma per pair and 16 features), then dV = P^T g,
//     dK = s dS^T q and dQ = s dS k with block-diagonal A operands (pair a in
//     k 0-7, pair b in k 8-15). P^T and dS^T come back by ldmatrix.trans from
//     a 1 KB per-warp tile; dS for dQ straight from the f32 fragments. P and
//     dS enter the products as hi + lo bf16 (two mmas each), so the sums keep
//     about 16 bits of them. The warp writes its pairs' dQ, dK and dV over
//     their staged q, k and v rows, and the block stores the tile as
//     coalesced 16-byte rows.
//   - "ffma" route (f32, d = 8, T != 8, Tq != Tk, unaligned operands): one
//     thread per (pair, query row) computes its P and dS rows from the staged
//     rows into shared memory; after a barrier one thread per (pair, row)
//     sums its dQ, dK and dV rows from shared memory and writes them.
// Each gradient row is written once by one warp or thread, with no atomics:
// the same inputs give the same bits.
//
// K2's kernel (`fused_window_attention_backward`, namespace k2 below) is the
// first design: one thread per (window, head, query row) recomputes its rows
// of P and dP from device memory, writes dQ, and leaves P and dS in shared
// memory; after a barrier thread t reduces key rows t, t + Tq, ... for dK
// and dV.

#include <math.h>

#include "attn_tile.cuh"

namespace {

using attn::Layout;
using attn::Plan;
using attn::TilePos;
using bf16 = __nv_bfloat16;

namespace k2 {

constexpr int kBlock = 128;

using attn::from_float;
using attn::to_float;

// W elements to f32 registers: one 16-byte load when W * sizeof(T) == 16.
template <typename T, int W>
__device__ __forceinline__ void load_chunk(const T* __restrict__ p, float (&r)[W]) {
  if constexpr (W * sizeof(T) == 16) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < W; ++j) r[j] = to_float(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) r[j] = to_float(p[j]);
  }
}

template <typename T, int W>
__device__ __forceinline__ void store_chunk(T* __restrict__ p, const float (&r)[W]) {
  if constexpr (W * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < W; ++j) e[j] = from_float<T>(r[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) p[j] = from_float<T>(r[j]);
  }
}

template <typename T, int W, int MAXT>
__global__ void __launch_bounds__(kBlock)
attention_backward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ g,
                          T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                          int64_t pairs, int tq, int tk, int h, int d,
                          Layout lq, Layout lk, Layout lv, Layout lg,
                          Layout ldq, Layout ldk, Layout ldv, float scale) {
  extern __shared__ float smem[];  // P rows, then dS rows: [2][groups * tq][tk]
  const int groups = blockDim.x / tq;
  const int grp = threadIdx.x / tq;
  const int row = threadIdx.x % tq;
  const int64_t pair = static_cast<int64_t>(blockIdx.x) * groups + grp;  // n * h + head
  const bool valid = pair < pairs;
  const int64_t n = valid ? pair / h : 0;
  const int head = valid ? static_cast<int>(pair % h) : 0;
  float* sP = smem + static_cast<size_t>(grp) * tq * tk;
  float* sdS = sP + static_cast<size_t>(groups) * tq * tk;

  const T* kb = k + n * lk.n + head * lk.h;
  const T* vb = v + n * lv.n + head * lv.h;

  if (valid) {
    const T* qr = q + n * lq.n + row * lq.t + head * lq.h;
    const T* gr = g + n * lg.n + row * lg.t + head * lg.h;
    float p[MAXT], ds[MAXT];
#pragma unroll
    for (int j = 0; j < MAXT; ++j) p[j] = ds[j] = 0.f;
    // logits (in p) and dP = g v^T (in ds), one feature chunk at a time
    for (int c = 0; c < d; c += W) {
      float qc[W], gc[W];
      load_chunk<T, W>(qr + c, qc);
      load_chunk<T, W>(gr + c, gc);
#pragma unroll
      for (int e = 0; e < W; ++e) qc[e] *= scale;
#pragma unroll
      for (int j = 0; j < MAXT; ++j) {
        if (j < tk) {
          float kc[W], vc[W];
          load_chunk<T, W>(kb + j * lk.t + c, kc);
          load_chunk<T, W>(vb + j * lv.t + c, vc);
#pragma unroll
          for (int e = 0; e < W; ++e) {
            p[j] = fmaf(qc[e], kc[e], p[j]);
            ds[j] = fmaf(gc[e], vc[e], ds[j]);
          }
        }
      }
    }
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < MAXT; ++j) if (j < tk) m = fmaxf(m, p[j]);
    float denom = 0.f;
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
      p[j] = j < tk ? expf(p[j] - m) : 0.f;
      denom += p[j];
    }
    const float inv = 1.f / denom;
    float rowsum = 0.f;
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
      p[j] *= inv;
      rowsum = fmaf(p[j], ds[j], rowsum);
    }
#pragma unroll
    for (int j = 0; j < MAXT; ++j) {
      ds[j] = p[j] * (ds[j] - rowsum);
      if (j < tk) {
        sP[row * tk + j] = p[j];
        sdS[row * tk + j] = ds[j];
      }
    }
    // dQ = s dS K
    T* dqr = dq + n * ldq.n + row * ldq.t + head * ldq.h;
    for (int c = 0; c < d; c += W) {
      float acc[W];
#pragma unroll
      for (int e = 0; e < W; ++e) acc[e] = 0.f;
#pragma unroll
      for (int j = 0; j < MAXT; ++j) {
        if (j < tk) {
          float kc[W];
          load_chunk<T, W>(kb + j * lk.t + c, kc);
#pragma unroll
          for (int e = 0; e < W; ++e) acc[e] = fmaf(ds[j], kc[e], acc[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < W; ++e) acc[e] *= scale;
      store_chunk<T, W>(dqr + c, acc);
    }
  }
  __syncthreads();
  if (!valid) return;

  // dV_j = sum_i P_ij g_i and dK_j = s sum_i dS_ij q_i for key rows j = row, row + tq, ...
  const T* qb = q + n * lq.n + head * lq.h;
  const T* gb = g + n * lg.n + head * lg.h;
  for (int j = row; j < tk; j += tq) {
    T* dvr = dv + n * ldv.n + j * ldv.t + head * ldv.h;
    T* dkr = dk + n * ldk.n + j * ldk.t + head * ldk.h;
    for (int c = 0; c < d; c += W) {
      float av[W], ak[W];
#pragma unroll
      for (int e = 0; e < W; ++e) av[e] = ak[e] = 0.f;
      for (int i = 0; i < tq; ++i) {
        const float pij = sP[i * tk + j];
        const float sij = sdS[i * tk + j];
        float qc[W], gc[W];
        load_chunk<T, W>(qb + i * lq.t + c, qc);
        load_chunk<T, W>(gb + i * lg.t + c, gc);
#pragma unroll
        for (int e = 0; e < W; ++e) {
          av[e] = fmaf(pij, gc[e], av[e]);
          ak[e] = fmaf(sij, qc[e], ak[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < W; ++e) ak[e] *= scale;
      store_chunk<T, W>(dvr + c, av);
      store_chunk<T, W>(dkr + c, ak);
    }
  }
}

template <typename T, int W, int MAXT>
cudaError_t launch(const void* const* ptrs, int64_t n, int tq, int tk, int h, int d,
                   const Layout* l, float scale, cudaStream_t stream) {
  const int groups = kBlock / tq;
  const int threads = groups * tq;
  const int64_t pairs = n * h;
  const int64_t blocks = (pairs + groups - 1) / groups;
  const size_t shmem = 2 * static_cast<size_t>(threads) * tk * sizeof(float);
  attention_backward_kernel<T, W, MAXT><<<static_cast<unsigned>(blocks), threads, shmem, stream>>>(
      static_cast<const T*>(ptrs[0]), static_cast<const T*>(ptrs[1]),
      static_cast<const T*>(ptrs[2]), static_cast<const T*>(ptrs[3]),
      static_cast<T*>(const_cast<void*>(ptrs[4])), static_cast<T*>(const_cast<void*>(ptrs[5])),
      static_cast<T*>(const_cast<void*>(ptrs[6])), pairs, tq, tk, h, d,
      l[0], l[1], l[2], l[3], l[4], l[5], l[6], scale);
  return cudaGetLastError();
}

// 16-byte chunks when the feature count and every row start allow them.
template <typename T>
bool vectorizable(const void* const* ptrs, int d, const Layout* l) {
  constexpr int per = 16 / sizeof(T);
  if (d % per) return false;
  for (int i = 0; i < 7; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
    if ((l[i].n * sizeof(T)) % 16 || (l[i].t * sizeof(T)) % 16 || (l[i].h * sizeof(T)) % 16)
      return false;
  }
  return true;
}

template <int MAXT>
int backward(const void* q, const void* k, const void* v, const void* g, void* dq,
             void* dk, void* dv, long long n, int tq, int tk, int h, int d,
             const long long* strides, float scale, int dtype, void* stream) {
  if (n <= 0 || tq < 1 || tq > MAXT || tk < 1 || tk > MAXT || h < 1 || d < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[7] = {q, k, v, g, dq, dk, dv};
  Layout l[7];
  for (int i = 0; i < 7; ++i) l[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = vectorizable<float>(ptrs, d, l)
              ? launch<float, 4, MAXT>(ptrs, n, tq, tk, h, d, l, scale, s)
              : launch<float, 1, MAXT>(ptrs, n, tq, tk, h, d, l, scale, s);
  else if (dtype == 1)
    err = vectorizable<__nv_bfloat16>(ptrs, d, l)
              ? launch<__nv_bfloat16, 8, MAXT>(ptrs, n, tq, tk, h, d, l, scale, s)
              : launch<__nv_bfloat16, 1, MAXT>(ptrs, n, tq, tk, h, d, l, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace k2

// ---- K1's backward: window tiles in shared memory ----

constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of a block: its tile's q, k, v and g rows, then per-warp 8x8
// tiles (mma) or the tile's P and dS rows in f32 (ffma).
int backward_smem(int W, int Hg, int warps, int tq, int tk, int d, int es, int route) {
  const int rows = W * (2 * tq + 2 * tk) * attn::pitch_bytes(Hg, d, es);
  const int extra = route == attn::kRouteMma ? warps * attn::kWarpTileBytes
                                             : W * Hg * tq * tk * 2 * 4;
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
// into sp and sds ([pair][query row][key], f32).
template <typename T, int D>
__device__ __forceinline__ void ffma_probs(const T* qs, const T* ks, const T* vs, const T* gs,
                                           int pitch, int tq, int tk, int hg, int p, int i,
                                           float scale, float* sp, float* sds) {
  constexpr int kE = 16 / sizeof(T);
  const int w = p / hg, col = (p % hg) * D;
  const T* qr = qs + (w * tq + i) * pitch + col;
  const T* gr = gs + (w * tq + i) * pitch + col;
  const T* kb = ks + w * tk * pitch + col;
  const T* vb = vs + w * tk * pitch + col;
  float s[attn::kMaxT], dp[attn::kMaxT];
#pragma unroll
  for (int j = 0; j < attn::kMaxT; ++j) s[j] = dp[j] = 0.f;
  for (int e0 = 0; e0 < D; e0 += kE) {   // logits and dP = g v^T, a chunk at a time
    float qc[kE], gc[kE];
    attn::load_row<T, kE>(qr + e0, qc);
    attn::load_row<T, kE>(gr + e0, gc);
#pragma unroll
    for (int j = 0; j < attn::kMaxT; ++j) {
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
  for (int j = 0; j < attn::kMaxT; ++j) if (j < tk) mx = fmaxf(mx, s[j]);
  float denom = 0.f;
#pragma unroll
  for (int j = 0; j < attn::kMaxT; ++j) {
    s[j] = j < tk ? expf(s[j] - mx) : 0.f;
    denom += s[j];
  }
  const float inv = 1.f / denom;
  float rowsum = 0.f;
#pragma unroll
  for (int j = 0; j < attn::kMaxT; ++j) {
    s[j] *= inv;
    rowsum = fmaf(s[j], dp[j], rowsum);
  }
  float* prow = sp + (p * tq + i) * tk;
  float* drow = sds + (p * tq + i) * tk;
#pragma unroll
  for (int j = 0; j < attn::kMaxT; ++j) {
    if (j < tk) {
      prow[j] = s[j];
      drow[j] = s[j] * (dp[j] - rowsum);
    }
  }
}

template <typename T, int E, bool VEC>
__device__ __forceinline__ void store_chunk(T* __restrict__ p, const float (&r)[E]) {
  if constexpr (VEC) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < E; ++j) e[j] = attn::from_float<T>(r[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) p[j] = attn::from_float<T>(r[j]);
  }
}

// ffma, phase 2. One thread, row rr of pair p: dQ of query row rr = s dS K,
// and dV, dK of key row rr = P^T g, s dS^T q, written to device memory.
template <typename T, int D, bool VEC>
__device__ __forceinline__ void ffma_grads(const T* qs, const T* ks, const T* gs, int pitch,
                                           int tq, int tk, int hg, int p, int rr, float scale,
                                           const float* sp, const float* sds, TilePos tp,
                                           T* dq, T* dk, T* dv, Layout ldq, Layout ldk,
                                           Layout ldv) {
  constexpr int kE = 16 / sizeof(T);
  const int w = p / hg, hh = p % hg, col = hh * D;
  const int64_t n = tp.n0 + w;
  const int head = tp.h0 + hh;
  const float* prow = sp + p * tq * tk;
  const float* drow = sds + p * tq * tk;
  if (rr < tq) {
    T* out = dq + n * ldq.n + rr * ldq.t + head * ldq.h;
    for (int e0 = 0; e0 < D; e0 += kE) {
      float acc[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] = 0.f;
      for (int j = 0; j < tk; ++j) {
        float kc[kE];
        attn::load_row<T, kE>(ks + (w * tk + j) * pitch + col + e0, kc);
        const float dsj = drow[rr * tk + j];
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[e] = fmaf(dsj, kc[e], acc[e]);
      }
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] *= scale;
      store_chunk<T, kE, VEC>(out + e0, acc);
    }
  }
  if (rr < tk) {
    T* outk = dk + n * ldk.n + rr * ldk.t + head * ldk.h;
    T* outv = dv + n * ldv.n + rr * ldv.t + head * ldv.h;
    for (int e0 = 0; e0 < D; e0 += kE) {
      float ak[kE], av[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) ak[e] = av[e] = 0.f;
      for (int i = 0; i < tq; ++i) {
        float qc[kE], gc[kE];
        attn::load_row<T, kE>(qs + (w * tq + i) * pitch + col + e0, qc);
        attn::load_row<T, kE>(gs + (w * tq + i) * pitch + col + e0, gc);
        const float pij = prow[i * tk + rr], sij = drow[i * tk + rr];
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          av[e] = fmaf(pij, gc[e], av[e]);
          ak[e] = fmaf(sij, qc[e], ak[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < kE; ++e) ak[e] *= scale;
      store_chunk<T, kE, VEC>(outv + e0, av);
      store_chunk<T, kE, VEC>(outk + e0, ak);
    }
  }
}

template <typename T, int D, bool VEC, bool MMA>
__global__ void __launch_bounds__(attn::kMaxWarps * 32)
window_attention_backward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                 const T* __restrict__ v, const T* __restrict__ g,
                                 T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                                 Plan plan, int tq, int tk, Layout lq, Layout lk, Layout lv,
                                 Layout lg, Layout ldq, Layout ldk, Layout ldv, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
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
  attn::stage_rows<T, D, VEC, kRpw>(qs, pitch, q, lq, tp, tq, plan.Hg, start);
  attn::stage_rows<T, D, VEC, kRpw>(ks, pitch, k, lk, tp, tk, plan.Hg, start);
  attn::stage_rows<T, D, VEC, kRpw>(vs, pitch, v, lv, tp, tk, plan.Hg, start);
  attn::stage_rows<T, D, VEC, kRpw>(gs, pitch, g, lg, tp, tq, plan.Hg, start);
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
    attn::store_rows<T, D, true, kRpw>(dq, ldq, qs, pitch, tp, tq, plan.Hg, start);
    attn::store_rows<T, D, true, kRpw>(dk, ldk, ks, pitch, tp, tk, plan.Hg, start);
    attn::store_rows<T, D, true, kRpw>(dv, ldv, vs, pitch, tp, tk, plan.Hg, start);
  } else {
    float* sp = reinterpret_cast<float*>(extra);
    float* sds = sp + plan.W * plan.Hg * tq * tk;
    for (int it = threadIdx.x; it < pairs * tq; it += blockDim.x)
      ffma_probs<T, D>(qs, ks, vs, gs, pitch, tq, tk, plan.Hg, it / tq, it % tq, scale, sp,
                       sds);
    __syncthreads();
    const int rows = tq > tk ? tq : tk;
    for (int it = threadIdx.x; it < pairs * rows; it += blockDim.x)
      ffma_grads<T, D, VEC>(qs, ks, gs, pitch, tq, tk, plan.Hg, it / rows, it % rows, scale,
                            sp, sds, tp, dq, dk, dv, ldq, ldk, ldv);
  }
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
}  // namespace

// Both entry points: q, k, v, g and the outputs dq, dk, dv addressed as
// [N, T, h, d] through `strides`, 21 element strides (window, token, head)
// for q, k, v, g, dq, dk, dv in that order, the feature axis dense.
// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments the kernel does not take.
// Each launches on `stream`, allocates nothing and does not synchronise.
//
// K1: route 0 = mma (bf16, Tq = Tk = 8, d a multiple of 16, every address
// and stride 16-byte aligned), 1 = ffma; (W, Hg, warps) the tile plan of
// `_attn_plan`, one block a tile. A route or plan the inputs cannot take is
// refused.
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

extern "C" int fused_window_attention_backward(const void* q, const void* k, const void* v,
                                               const void* g, void* dq, void* dk, void* dv,
                                               long long n, int tq, int tk, int h, int d,
                                               const long long* strides, float scale,
                                               int dtype, void* stream) {
  return k2::backward<32>(q, k, v, g, dq, dk, dv, n, tq, tk, h, d, strides, scale, dtype,
                          stream);
}
