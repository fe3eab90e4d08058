// MX flash attention backward: (dq, dk, dv) from (q, k, v, dout, out, lse).
//
// Replaces: `mx_attn_bwd_pallas` (src/repro/kernels/mx_attention.py:275,
//   pallas_calls at :306 and :326), with its dQ pass `_mx_attn_dq_kernel`
//   (:216) over kv tiles and its dK/dV pass `_mx_attn_dkv_kernel` (:242)
//   over q tiles with per-g partials summed over G in the wrapper (the
//   shared recompute `_p_ds` :200-213); the oracle is
//   `mx_flash_attention_bwd_ref` (src/repro/kernels/ref.py:226).
// Bound: bytes at the training shapes (BH 64, T 512, d 64 causal: the
//   function must move 33.6 MB, q, k, v, dout and out read and three bf16
//   grads written, 10.1 µs at 3.35 TB/s, against 5.4 GFLOP of useful
//   products, 5.4 µs at the bf16 peak; chip_smoke.py reckons both).  The
//   tensor work as built is larger: S and dP are formed in both passes and
//   each gradient product runs three times (below), 13 bf16 product units
//   against the 5 of one plain product each.
// Includes: mx_mma.cuh (the tensor-core and copy helpers and the mask
//   tests, shared with the flash forward in mx_attention.cu) and
//   mx_quant.cuh (the element cast).
// Design: three launches per call.
//   * Pre-pass: delta = sum(dout * out) in fp32, a warp per query row, and
//     in MX mode the scores operands cast once: q and k blocked along d
//     with `mx_warp_quant` (the shared cast) into a bf16 scratch, where the
//     cast values are exact.  The raw q and k stay for the gradient
//     products (straight-through).  bf16 mode reads q and k in place.
//   * Tiles are sized by the padded qk head dim and the padded v head dim
//     apart (BwTile<DQ, DV>): q, k, dq and dk by DQ, v, dout and dv by DV
//     (MLA: 192 against 128; recurrentgemma: 256 and 256).
//   * dQ: one CTA per (bh, g, 64 query rows), 4 warps of 16 rows, looping
//     over the live kv blocks (64 rows; 32 for qk head dims above 64).
//   * dK/dV: one CTA per (bh, 64 kv rows), looping over g and the live q
//     blocks inside itself, so the G sum of dk and dv needs no atomics.
//     At qk 256 / v 256 (recurrentgemma) the dk and dv accumulators would
//     be 128 + 128 registers a thread, over the 255 limit, so dk and dv
//     run as two launches of the same kernel (PART 1 and 2): the dk pass
//     forms S, dP and dS and accumulates dk alone; the dv pass forms S and
//     P alone (no dP) and accumulates dv.  Each takes its terms in the
//     order the joint pass would, so the grads are the same bits; S is
//     formed in both.
//   Both passes recompute S = Q^ K^T and dP = dO V^T with `mma.sync`
//   m16n8k16 (bf16 in, fp32 accumulators in registers): the cast q and k,
//   raw dout and raw v are all exact in bf16.  P = exp(S scale - lse)
//   (masked to 0) and dS = P (dP - delta) scale are formed in registers in
//   fp32, in the accumulators' layout, which is the A operand's layout of
//   the next product.  P and dS are not exact in bf16, so each gradient
//   product (dV += P^T dO, dK += dS^T Q, dQ += dS K, raw operands) takes
//   them as three bf16 pieces, hi = bf16(x), mid = bf16(x - hi),
//   lo = bf16(x - hi - mid), which carry all 24 bits of x (exact for
//   2^-110 <= |x| < 2^127), in three products into one fp32 accumulator:
//   each term to fp32's own rounding.  No TF32, no two-piece split (about
//   11 and 17 bits a term).  Tiles arrive by cp.async (16 bytes a thread,
//   zero filled past the ragged edges; element by element when a head dim
//   is not a multiple of 8), double-buffered, into rows padded by 16 bytes
//   so that `ldmatrix` reads them without bank conflicts.  A block that
//   the AttnSpec mask (causal, full, window, with q_offset) rules out for
//   every row of the CTA is skipped, which equals computing it (p = 0
//   there).  Rows past Tq or Tk are zero filled and neither counted nor
//   stored.  Every sum runs in a fixed order, so a second call gives equal
//   bits.  Grads are written in bf16, or in fp32 when asked; the bf16
//   grads are the fp32 ones rounded once.
#include <math.h>
#include <stdint.h>

#include "mx_mma.cuh"
#include "mx_quant.cuh"

namespace {
constexpr int BW_THREADS = 128;   // 4 warps of 16 own rows
constexpr int BW_BM = 64;         // own rows of a CTA

constexpr int BW_MAXD = 256;      // qk head dim
constexpr int BW_MAXDV = 256;     // v head dim

// Shapes of the tiles for a padded qk head dim DQ and a padded v head dim
// DV (multiples of 32): q, k and their gradients are DQ wide; v, dout and
// dv are DV wide.
template <int DQ, int DV>
struct BwTile {
  static constexpr int LD = DQ + 8;             // q/k smem row stride (bf16)
  static constexpr int LDV = DV + 8;            // v/dout smem row stride
  static constexpr int BN = DQ > 64 ? 32 : 64;  // rows of a visited block
  static constexpr int NT = BN / 8;             // n-tiles of S and dP
  static constexpr int KS = DQ / 16;            // k-steps over the qk dim
  static constexpr int KSV = DV / 16;           // k-steps over the v dim
  static constexpr int DT = DQ / 8;             // n-tiles of dq and dk
  static constexpr int DTV = DV / 8;            // n-tiles of dv
  static constexpr int OWN = BW_BM * (LD + LDV);     // own rows: two tiles
  static constexpr int STAGE = BN * (2 * LD + LDV);  // a stage: 3 tiles
  static constexpr int SMEM = 2 * (OWN + 2 * STAGE) + 4 * 2 * 2 * BN;
};
}  // namespace

// delta for the q rows; in MX mode q and k cast along d into qh and kh.
__global__ void mx_attn_bwd_prep_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ dout, const bf16* __restrict__ out,
    float* __restrict__ delta, bf16* __restrict__ qh, bf16* __restrict__ kh,
    long long qrows, long long krows, int d, int dv, int has_fmt, MxFmt f) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5)
                        + (threadIdx.x >> 5);
  if (row >= qrows + krows) return;   // whole warp exits together
  const bool is_q = row < qrows;
  if (is_q) {
    float s = 0.f;
    for (int c = lane; c < dv; c += 32)
      s += __bfloat162float(dout[row * dv + c])
           * __bfloat162float(out[row * dv + c]);
    s = mx_warp_sum(s);
    if (lane == 0) delta[row] = s;
  }
  if (!has_fmt) return;
  const long long r = is_q ? row : row - qrows;
  const bf16* src = (is_q ? q : k) + r * d;
  bf16* dst = (is_q ? qh : kh) + r * d;
  for (int c0 = 0; c0 < d; c0 += 32) {
    const int c = c0 + lane;
    const float x = mx_warp_quant(c < d ? __bfloat162float(src[c]) : 0.f, f);
    if (c < d) dst[c] = __float2bfloat16_rn(x);
  }
}

template <int DQ, int DV, typename OutT>
__global__ void __launch_bounds__(BW_THREADS)
mx_attn_bwd_dq_kernel(const bf16* __restrict__ qh, const bf16* __restrict__ kh,
                      const bf16* __restrict__ k, const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, OutT* __restrict__ dq,
                      int G, int Tq, int Tk, int d, int dv, int kind,
                      int window, int q_offset, int vec, float scale) {
  using C = BwTile<DQ, DV>;
  constexpr int LD = C::LD, LDV = C::LDV, BN = C::BN;
  extern __shared__ __align__(16) unsigned char bw_sm[];
  bf16* sQ = (bf16*)bw_sm;          // [64][LD] own rows, scores operand
  bf16* sDO = sQ + BW_BM * LD;      // [64][LDV] own rows of dout
  bf16* stage = sDO + BW_BM * LDV;  // 2 x {k^, k [BN][LD], v [BN][LDV]}
  const bool sep = kh != k;         // MX: the cast k has its own tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.z, g = blockIdx.y, r0 = blockIdx.x * BW_BM;
  const long long row0 = ((long long)bh * G + g) * Tq + r0;
  const int nrows = min(BW_BM, Tq - r0);
  const bf16* khb = kh + (long long)bh * Tk * d;
  const bf16* kb = k + (long long)bh * Tk * d;
  const bf16* vb = v + (long long)bh * Tk * dv;
  auto st = [&](int s, int which) {
    return stage + s * C::STAGE + which * BN * LD;
  };

  mma_tile<C::DT, LD, BW_THREADS>(sQ, qh + row0 * d, d, BW_BM, nrows, d, vec);
  mma_tile<C::DTV, LDV, BW_THREADS>(sDO, dout + row0 * dv,
      dv, BW_BM, nrows, dv, vec);
  const int qa = r0 + q_offset, qb = r0 + nrows - 1 + q_offset;
  auto next_live = [&](int bs) {
    while (bs < Tk && !bw_live(kind, window, qa, qb, bs, min(bs + BN, Tk) - 1))
      bs += BN;
    return bs;
  };
  auto load = [&](int s, int bs) {
    const int n = min(BN, Tk - bs);
    if (sep) mma_tile<C::DT, LD, BW_THREADS>(st(s, 0),
        khb + (long long)bs * d, d, BN, n, d, vec);
    mma_tile<C::DT, LD, BW_THREADS>(st(s, 1),
        kb + (long long)bs * d, d, BN, n, d, vec);
    mma_tile<C::DTV, LDV, BW_THREADS>(st(s, 2),
        vb + (long long)bs * dv, dv, BN, n, dv, vec);
  };

  float lse_r[2], dl_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + gq + 8 * h;
    lse_r[h] = r < nrows ? lse[row0 + r] : 0.f;
    dl_r[h] = r < nrows ? delta[row0 + r] : 0.f;
  }
  float acc[C::DT][4];
#pragma unroll
  for (int j = 0; j < C::DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  int bs = next_live(0), s = 0;
  if (bs < Tk) load(0, bs);
  bw_commit();
  while (bs < Tk) {
    const int nx = next_live(bs + BN);
    if (nx < Tk) load(s ^ 1, nx);
    bw_commit();
    bw_wait<1>();
    __syncthreads();
    float sc[C::NT][4], dp[C::NT][4];
    mma_scores<C::NT, C::KS, LD>(sc, sQ, st(s, sep ? 0 : 1), warp, lane);
    mma_scores<C::NT, C::KSV, LDV>(dp, sDO, st(s, 2), warp, lane);
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, r = warp * 16 + gq + 8 * h;
        const int col = bs + 8 * j + 2 * tq + (e & 1);
        const bool ok = r < nrows && col < Tk &&
                        bw_valid(kind, window, r0 + r + q_offset, col);
        const float p = ok ? expf(__fsub_rn(__fmul_rn(sc[j][e], scale),
                                            lse_r[h]))
                           : 0.f;
        sc[j][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[j][e], dl_r[h])),
                             scale);   // ds
      }
#pragma unroll
    for (int kk = 0; kk < C::NT / 2; ++kk) {   // acc += ds (3 pieces) @ K
      uint32_t a[3][4];
      bw_pieces(sc[2 * kk], sc[2 * kk + 1], a[0], a[1], a[2]);
      mma_step<C::DT, LD, 3>(acc, a, st(s, 1), kk, lane);
    }
    __syncthreads();   // this stage's reads are done before it is refilled
    s ^= 1;
    bs = nx;
  }
  bw_wait<0>();
#pragma unroll
  for (int j = 0; j < C::DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = warp * 16 + gq + 8 * (e >> 1);
      const int col = 8 * j + 2 * tq + (e & 1);
      if (r < nrows && col < d)
        mx_store<OutT>(dq + (row0 + r) * d + col, acc[j][e]);
    }
}

// PART 0: dk and dv; PART 1: dk alone; PART 2: dv alone.
template <int DQ, int DV, int PART, typename OutT>
__global__ void __launch_bounds__(BW_THREADS)
mx_attn_bwd_dkv_kernel(const bf16* __restrict__ qh,
                       const bf16* __restrict__ kh,
                       const bf16* __restrict__ q, const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, OutT* __restrict__ dk,
                       OutT* __restrict__ dvo, int G, int Tq, int Tk, int d,
                       int dv, int kind, int window, int q_offset, int vec,
                       float scale) {
  using C = BwTile<DQ, DV>;
  constexpr int LD = C::LD, LDV = C::LDV, BN = C::BN;
  extern __shared__ __align__(16) unsigned char bw_sm[];
  bf16* sK = (bf16*)bw_sm;          // [64][LD] own rows, scores operand
  bf16* sV = sK + BW_BM * LD;       // [64][LDV] own rows of v
  bf16* stage = sV + BW_BM * LDV;   // 2 x {q^, q [BN][LD], dout [BN][LDV]}
  float* lse_s = (float*)(stage + 2 * C::STAGE);      // [2][BN]
  float* dl_s = lse_s + 2 * BN;                       // [2][BN]
  const bool sep = qh != q;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.y, j0 = blockIdx.x * BW_BM;
  const int nrows = min(BW_BM, Tk - j0);
  const long long krow0 = (long long)bh * Tk + j0;
  auto st = [&](int s, int which) {
    return stage + s * C::STAGE + which * BN * LD;
  };

  constexpr bool DK = PART != 2, DVP = PART != 1;
  mma_tile<C::DT, LD, BW_THREADS>(sK, kh + krow0 * d, d, BW_BM, nrows, d, vec);
  if constexpr (DK) {   // dP needs the own v rows; the dv pass forms none
    mma_tile<C::DTV, LDV, BW_THREADS>(sV, v + krow0 * dv,
        dv, BW_BM, nrows, dv, vec);
  }
  const int ka = j0, kb = j0 + nrows - 1;
  const int nqb = (Tq + BN - 1) / BN, total = G * nqb;
  auto next_live = [&](int it) {
    for (; it < total; ++it) {
      const int bs = (it % nqb) * BN;
      if (bw_live(kind, window, bs + q_offset,
                  min(bs + BN, Tq) - 1 + q_offset, ka, kb))
        break;
    }
    return it;
  };
  auto load = [&](int s, int it) {
    const int bs = (it % nqb) * BN, n = min(BN, Tq - bs);
    const long long qrow0 = ((long long)bh * G + it / nqb) * Tq + bs;
    if (sep) mma_tile<C::DT, LD, BW_THREADS>(st(s, 0),
        qh + qrow0 * d, d, BN, n, d, vec);
    mma_tile<C::DT, LD, BW_THREADS>(st(s, 1), q + qrow0 * d, d, BN, n, d, vec);
    mma_tile<C::DTV, LDV, BW_THREADS>(st(s, 2),
        dout + qrow0 * dv, dv, BN, n, dv, vec);
    for (int i = threadIdx.x; i < BN; i += BW_THREADS) {
      lse_s[s * BN + i] = i < n ? lse[qrow0 + i] : 0.f;
      dl_s[s * BN + i] = i < n ? delta[qrow0 + i] : 0.f;
    }
  };

  constexpr int NK = DK ? C::DT : 1, NV = DVP ? C::DTV : 1;
  float dk_acc[NK][4], dv_acc[NV][4];
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv_acc[j][e] = 0.f;

  int it = next_live(0), s = 0;
  if (it < total) load(0, it);
  bw_commit();
  while (it < total) {
    const int nx = next_live(it + 1);
    if (nx < total) load(s ^ 1, nx);
    bw_commit();
    bw_wait<1>();
    __syncthreads();
    const int bs = (it % nqb) * BN;
    float pt[C::NT][4], dst[C::NT][4];   // P^T and dP^T, then dS^T
    mma_scores<C::NT, C::KS, LD>(pt, sK, st(s, sep ? 0 : 1), warp, lane);
    if constexpr (DK) {
      mma_scores<C::NT, C::KSV, LDV>(dst, sV, st(s, 2), warp, lane);
    }
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = warp * 16 + gq + 8 * (e >> 1);
        const int qc = 8 * j + 2 * tq + (e & 1);
        const bool ok = kr < nrows && bs + qc < Tq &&
                        bw_valid(kind, window, bs + qc + q_offset, j0 + kr);
        const float p = ok ? expf(__fsub_rn(__fmul_rn(pt[j][e], scale),
                                            lse_s[s * BN + qc]))
                           : 0.f;
        pt[j][e] = p;
        if constexpr (DK) {
          dst[j][e] = __fmul_rn(
              __fmul_rn(p, __fsub_rn(dst[j][e], dl_s[s * BN + qc])), scale);
        }
      }
#pragma unroll
    for (int kk = 0; kk < C::NT / 2; ++kk) {   // dv += P^T dO, dk += dS^T Q
      uint32_t a[3][4];
      if constexpr (DVP) {
        bw_pieces(pt[2 * kk], pt[2 * kk + 1], a[0], a[1], a[2]);
        mma_step<C::DTV, LDV, 3>(dv_acc, a, st(s, 2), kk, lane);
      }
      if constexpr (DK) {
        bw_pieces(dst[2 * kk], dst[2 * kk + 1], a[0], a[1], a[2]);
        mma_step<C::DT, LD, 3>(dk_acc, a, st(s, 1), kk, lane);
      }
    }
    __syncthreads();   // this stage's reads are done before it is refilled
    s ^= 1;
    it = nx;
  }
  bw_wait<0>();
  if constexpr (DK) {
#pragma unroll
    for (int j = 0; j < C::DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = warp * 16 + gq + 8 * (e >> 1);
        const int col = 8 * j + 2 * tq + (e & 1);
        if (kr < nrows && col < d)
          mx_store<OutT>(dk + (krow0 + kr) * d + col, dk_acc[j][e]);
      }
  }
  if constexpr (DVP) {
#pragma unroll
    for (int j = 0; j < C::DTV; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = warp * 16 + gq + 8 * (e >> 1);
        const int col = 8 * j + 2 * tq + (e & 1);
        if (kr < nrows && col < dv)
          mx_store<OutT>(dvo + (krow0 + kr) * dv + col, dv_acc[j][e]);
      }
  }
}

// SPLIT: dk and dv in two launches (PART 1, then 2), else one (PART 0).
template <int DQ, int DV, bool SPLIT, typename OutT>
static int bw_launch(const bf16* q, const bf16* k, const bf16* v,
                     const bf16* dout, const bf16* qh, const bf16* kh,
                     const float* lse, const float* delta, void* dq,
                     void* dk, void* dv_, int BH, int G, int Tq, int Tk,
                     int d, int dv, int kind, int window, int q_offset,
                     int vec, float scale, cudaStream_t s) {
  constexpr int smem = BwTile<DQ, DV>::SMEM;
  auto dq_k = mx_attn_bwd_dq_kernel<DQ, DV, OutT>;
  auto dkv_k = mx_attn_bwd_dkv_kernel<DQ, DV, SPLIT ? 1 : 0, OutT>;
  cudaFuncSetAttribute(dq_k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  cudaFuncSetAttribute(dkv_k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  dim3 gq((Tq + BW_BM - 1) / BW_BM, G, BH);
  dq_k<<<gq, BW_THREADS, smem, s>>>(qh, kh, k, v, dout, lse, delta,
                                    (OutT*)dq, G, Tq, Tk, d, dv, kind,
                                    window, q_offset, vec, scale);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  dim3 gk((Tk + BW_BM - 1) / BW_BM, BH);
  dkv_k<<<gk, BW_THREADS, smem, s>>>(qh, kh, q, v, dout, lse, delta,
                                     (OutT*)dk, (OutT*)dv_, G, Tq, Tk, d,
                                     dv, kind, window, q_offset, vec, scale);
  rc = (int)cudaGetLastError();
  if constexpr (SPLIT) {
    if (rc) return rc;
    auto dv_k = mx_attn_bwd_dkv_kernel<DQ, DV, 2, OutT>;
    cudaFuncSetAttribute(dv_k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    dv_k<<<gk, BW_THREADS, smem, s>>>(qh, kh, q, v, dout, lse, delta,
                                      (OutT*)dk, (OutT*)dv_, G, Tq, Tk, d,
                                      dv, kind, window, q_offset, vec,
                                      scale);
    rc = (int)cudaGetLastError();
  }
  return rc;
}

// `delta` is a (BH * G * Tq) fp32 scratch; `qk_hat` a bf16 scratch of
// BH * G * Tq * d + BH * Tk * d elements in MX mode (the cast q, then the
// cast k), unused in bf16 mode; grads are bf16, or fp32 with out_fp32.
// q (BH,G,Tq,d), k (BH,Tk,d), v (BH,Tk,dv), dout and out (BH,G,Tq,dv)
// bf16, lse (BH,G,Tq) fp32, all contiguous.
extern "C" int mx_flash_bwd(const void* q, const void* k, const void* v,
                            const void* dout, const void* out,
                            const void* lse, void* delta, void* qk_hat,
                            void* dq, void* dk, void* dv_, int BH, int G,
                            int Tq, int Tk, int d, int dv, int kind,
                            int window, int q_offset, int out_fp32,
                            int has_fmt, int mbits, int min_normal_exp,
                            int e_max, float max_normal, int scale_mode,
                            float scale, void* stream) {
  if (d > BW_MAXD || dv > BW_MAXDV || d <= 0 || dv <= 0 ||
      (has_fmt && !qk_hat))
    return (int)cudaErrorInvalidValue;
  const MxFmt f = mx_fmt(mbits, min_normal_exp, e_max, max_normal,
                         scale_mode);
  cudaStream_t s = (cudaStream_t)stream;
  if (BH <= 0 || G <= 0 || Tq <= 0 || Tk <= 0) return (int)cudaGetLastError();
  const bf16 *qq = (const bf16*)q, *kk = (const bf16*)k;
  const long long qrows = (long long)BH * G * Tq, krows = (long long)BH * Tk;
  bf16* qh = has_fmt ? (bf16*)qk_hat : nullptr;
  bf16* kh = has_fmt ? qh + qrows * d : nullptr;
  const long long prep_rows = qrows + (has_fmt ? krows : 0);
  mx_attn_bwd_prep_kernel<<<(unsigned)((prep_rows + 7) / 8), 256, 0, s>>>(
      qq, kk, (const bf16*)dout, (const bf16*)out, (float*)delta, qh, kh,
      qrows, has_fmt ? krows : 0, d, dv, has_fmt, f);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const bf16* sq = has_fmt ? qh : qq;
  const bf16* sk = has_fmt ? kh : kk;
  const uintptr_t align = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v
                          | (uintptr_t)dout | (uintptr_t)sq | (uintptr_t)sk;
  const int vec = d % 8 == 0 && dv % 8 == 0 && align % 16 == 0;
  const int wide = max(d, dv);
#define BW_CASE(DQ, DV, SPLIT)                                               \
  return out_fp32                                                            \
             ? bw_launch<DQ, DV, SPLIT, float>(                              \
                   qq, kk, (const bf16*)v, (const bf16*)dout, sq, sk,        \
                   (const float*)lse, (const float*)delta, dq, dk, dv_, BH,  \
                   G, Tq, Tk, d, dv, kind, window, q_offset, vec, scale, s)  \
             : bw_launch<DQ, DV, SPLIT, bf16>(                               \
                   qq, kk, (const bf16*)v, (const bf16*)dout, sq, sk,        \
                   (const float*)lse, (const float*)delta, dq, dk, dv_, BH,  \
                   G, Tq, Tk, d, dv, kind, window, q_offset, vec, scale, s)
  // recurrentgemma: qk 256, v 256, dk and dv in separate passes
  if (d > 192 || dv > 128) BW_CASE(256, 256, true);
  if (d > 128) BW_CASE(192, 128, false);   // MLA: qk 192 (nope + rope), v 128
  if (wide <= 32) BW_CASE(32, 32, false);
  if (wide <= 64) BW_CASE(64, 64, false);
  if (wide <= 96) BW_CASE(96, 96, false);
  BW_CASE(128, 128, false);
#undef BW_CASE
}
