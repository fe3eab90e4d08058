// MX flash attention forward (prefill), MX decode attention, and MX decode
// through a page table.
//
// Replaces: `mx_attn_fwd_pallas` (src/repro/kernels/mx_attention.py:156,
//   pallas_call at :172; body `_mx_attn_fwd_kernel` :110-151),
//   `mx_attn_decode_pallas` (:455, pallas_call at :468; body
//   `_mx_attn_decode_body` :364-381) and `mx_attn_decode_paged_pallas`
//   (:407, pallas_call at :445; body `_mx_attn_decode_paged_kernel`
//   :384-404).
// Bound: all three are memory- and latency-bound at the serve path's
//   shapes.  Prefill attention at d = 64 does ~4 d operations per score,
//   far below the H100's ~295 operations per byte.  Decode must move the
//   K rows of the valid slots (a masked slot's score is dropped whatever
//   its K row holds), the V rows of every slot (v is cast along S over
//   all of them), q, out and the validity mask once (3.4 MB at B 4, H 8,
//   S 512 with the serve path's positions: 1.02 µs over 3.35 TB/s); paged
//   decode the same, with V over the mapped pages, and the page table.
//   This kernel still loads and casts the K rows of masked slots: reading
//   the mask first would add a dependent round trip.  Both are held back
//   by latency: a call is a few dependent round trips.
// Design:
//   * Flash forward.  In MX mode the unnormalized p is quantized after the
//     rescale by the running max over the whole JAX kv tile
//     (tile_k = min(kv_chunk, Tk)), so one tile's max must be known before
//     any of its p is quantized.  Each JAX tile is walked twice in 32-row
//     blocks: pass 1 finds each row's max over the tile, pass 2 recomputes
//     the scores, forms p = exp(s - m_new) (exactly 0 where masked), adds
//     the unquantized p to l, quantizes p per 32-block (one warp's lanes,
//     blocks aligned to the tile start) and accumulates Q(p) Q(v).  The
//     tile's l and PV are folded into the carry as acc*corr + pv, as the
//     reference does.  v is quantized along kv over every row of its
//     32-block, masked or not; only rows past the tile end are zeros.  A
//     block that is masked for every row of the CTA is skipped, which is
//     bitwise the same as computing it (p = 0 there).  One CTA holds 16
//     query rows of one (bh, g): 4 warps x 4 rows, lane = kv row in a
//     block.  Out is acc / max(l, 1e-30) in bf16; lse = m + log(max(l,
//     1e-30)) in fp32.  In bf16 mode (no format) p stays fp32 for PV.
//   * Decode, split over a thread-block cluster.  The *normalized* p is
//     quantized along S (32-blocks) and v along S over every slot, valid
//     or not, so the view's max and sum must be known before any p is
//     cast.  The wrapper plans the split from S alone (ops.decode_plan:
//     `splits` <= 8 CTAs of `span` slots, span a multiple of 32, so no
//     32-block of p or v straddles two CTAs, and a row's result does not
//     depend on the batch it shares).  Grid (B*H, splits), one cluster of
//     `splits` CTAs per (row, kv head), launched with cudaLaunchKernelEx.
//     Each CTA reads its span of the cache in its (B, S, Hkv, d) layout
//     through strides (no transposed copy): it starts the copy of its V
//     rows into shared memory (cp.async; a span too long to stage reads
//     them in place later), issues the 16-byte loads of its K rows before
//     using any, casts q once and each K row along d
//     (`mx_quad_quant`: 8 elements a lane, the warp cast's sums in the
//     warp cast's order), and forms the scores of all G query heads at
//     once.  The combine goes through distributed shared memory in rank
//     order: the cluster's max, then p = exp(s - max) and the cluster's
//     sum; then every CTA divides its p by that sum, casts its p blocks
//     and its v blocks along S (four lanes a value column, 8 slots a
//     lane, as K) and forms its partial PV in fp32, and rank 0
//     sums the partials in rank order and stores bf16.  A span with no
//     valid slot gives max -1e30 and sum 0.  No atomics: a second call
//     gives equal bits.
//   * Paged decode is the same kernel (template flag PAGED) with another
//     row address: view position s of row b lives at offset s % ps of
//     physical page pt[b * P + s / ps] of the (N, ps, Hkv, d) pool, read
//     through strides by the CTA that needs the row; an entry outside
//     [0, N) is clamped, so an unmapped -1 reads page 0 exactly as the
//     gather of the plain version does (the mask hides it, and v's
//     32-blocks never straddle a page because ps is a multiple of 32).
//     Every multiply, add and reduction is the slab kernel's, in its
//     order, with the same plan, so the result is bitwise that of the slab
//     kernel on the gathered (B, P*ps, Hkv, d) view.  The TPU kernel's
//     VMEM staging of the gathered view is not carried over: the rows are
//     read in place.
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include "mx_quant.cuh"

namespace cg = cooperative_groups;

namespace {
constexpr int MAXD = 128;
constexpr int FA_WARPS = 4;
constexpr int FA_RPW = 4;                    // query rows per warp
constexpr int FA_ROWS = FA_WARPS * FA_RPW;   // query rows per CTA
constexpr int MAXG = 8;
constexpr int DEC_THREADS = 128;   // a decode CTA
constexpr int DEC_KB = 4;          // K loads a thread keeps in flight
constexpr int DEC_MAX_SMEM = 227 * 1024;   // a CTA's opt-in limit
constexpr float NEG_INF = -1e30f;
enum { KIND_CAUSAL = 0, KIND_FULL = 1, KIND_WINDOW = 2 };
}  // namespace

__device__ __forceinline__ bool attn_valid(int kind, int window, int qpos,
                                           int kpos, int kv_len) {
  bool ok = kpos < kv_len;
  if (kind != KIND_FULL) ok = ok && qpos >= kpos;
  if (kind == KIND_WINDOW) ok = ok && kpos > qpos - window;
  return ok;
}

template <int DVL>
__global__ void __launch_bounds__(FA_WARPS * 32)
mx_flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    int G, int Tq, int Tk, int d, int dv, int kind,
                    int window, int q_offset, int tile_k, int has_fmt,
                    MxFmt f, float scale) {
  __shared__ float qs[FA_ROWS][MAXD];
  __shared__ float ks[32][MAXD + 1];
  __shared__ float vs[32][MAXD + 1];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.z, g = blockIdx.y, r0 = blockIdx.x * FA_ROWS;
  const long long qrow0 = ((long long)bh * G + g) * Tq;
  const __nv_bfloat16* kb = k + (long long)bh * Tk * d;
  const __nv_bfloat16* vb = v + (long long)bh * Tk * dv;

  // Q rows, quantized along d (warp per row, lanes along d).
  for (int r = warp; r < FA_ROWS; r += FA_WARPS) {
    const int i = r0 + r;
    for (int c0 = 0; c0 < d; c0 += 32) {
      const int c = c0 + lane;
      float x = (i < Tq && c < d)
                    ? __bfloat162float(q[(qrow0 + i) * d + c]) : 0.f;
      if (has_fmt) x = mx_warp_quant(x, f);
      if (c < d) qs[r][c] = x;
    }
  }

  float m[FA_RPW], l[FA_RPW], acc[FA_RPW][DVL];
#pragma unroll
  for (int rr = 0; rr < FA_RPW; ++rr) {
    m[rr] = NEG_INF;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < DVL; ++c) acc[rr][c] = 0.f;
  }
  const int qfirst = r0 + q_offset;
  const int qlast = min(r0 + FA_ROWS, Tq) - 1 + q_offset;

  // Loads a 32-row K block [bs, be) quantized along d into ks, and, with
  // with_v, the V block quantized down its rows into vs.  Rows past `be`
  // are zeros (the reference's padding).
  auto load_block = [&](int bs, int be, bool with_v) {
    for (int i = tid; i < 32 * d; i += FA_WARPS * 32) {
      const int rr = i / d, t = i % d;
      ks[rr][t] = (bs + rr < be)
                      ? __bfloat162float(kb[(long long)(bs + rr) * d + t])
                      : 0.f;
    }
    if (with_v)
      for (int i = tid; i < 32 * dv; i += FA_WARPS * 32) {
        const int rr = i / dv, t = i % dv;
        vs[rr][t] = (bs + rr < be)
                        ? __bfloat162float(vb[(long long)(bs + rr) * dv + t])
                        : 0.f;
      }
    __syncthreads();
    if (has_fmt) {
      for (int rr = warp; rr < 32; rr += FA_WARPS)
        for (int c0 = 0; c0 < d; c0 += 32) {
          const int c = c0 + lane;
          const float x = mx_warp_quant(c < d ? ks[rr][c] : 0.f, f);
          if (c < d) ks[rr][c] = x;
        }
      if (with_v)   // a warp per value column, lane = kv row
        for (int c = warp; c < dv; c += FA_WARPS)
          vs[lane][c] = mx_warp_quant(vs[lane][c], f);
    }
    __syncthreads();
  };

  // Masked score of (row r of this CTA, kv row bs + lane).
  auto score = [&](int r, int bs, int be, bool& ok) {
    const int kpos = bs + lane;
    ok = kpos < be &&
         attn_valid(kind, window, r0 + r + q_offset, kpos, Tk);
    float dot = 0.f;
    for (int t = 0; t < d; ++t) dot = fmaf(qs[r][t], ks[lane][t], dot);
    return ok ? dot * scale : NEG_INF;
  };

  auto block_live = [&](int bs, int be) {
    if (kind == KIND_FULL) return true;
    if (bs > qlast) return false;
    if (kind == KIND_WINDOW && be - 1 <= qfirst - window) return false;
    return true;
  };

  for (int ts = 0; ts < Tk; ts += tile_k) {
    const int te = min(ts + tile_k, Tk);
    // Pass 1: each row's max over the whole JAX tile.
    float mt[FA_RPW];
#pragma unroll
    for (int rr = 0; rr < FA_RPW; ++rr) mt[rr] = NEG_INF;
    for (int bs = ts; bs < te; bs += 32) {
      const int be = min(bs + 32, te);
      if (!block_live(bs, be)) continue;
      load_block(bs, be, false);
#pragma unroll
      for (int rr = 0; rr < FA_RPW; ++rr) {
        const int r = warp * FA_RPW + rr;
        if (r0 + r >= Tq) continue;  // warp-uniform
        bool ok;
        mt[rr] = mx_nanmax(mt[rr], mx_warp_max(score(r, bs, be, ok)));
      }
      __syncthreads();
    }
    float mn[FA_RPW], corr[FA_RPW], lt[FA_RPW], pv[FA_RPW][DVL];
#pragma unroll
    for (int rr = 0; rr < FA_RPW; ++rr) {
      mn[rr] = mx_nanmax(m[rr], mt[rr]);
      corr[rr] = expf(m[rr] - mn[rr]);
      lt[rr] = 0.f;
#pragma unroll
      for (int c = 0; c < DVL; ++c) pv[rr][c] = 0.f;
    }
    // Pass 2: p, l and the quantized PV product.
    for (int bs = ts; bs < te; bs += 32) {
      const int be = min(bs + 32, te);
      if (!block_live(bs, be)) continue;
      load_block(bs, be, true);
#pragma unroll
      for (int rr = 0; rr < FA_RPW; ++rr) {
        const int r = warp * FA_RPW + rr;
        if (r0 + r >= Tq) continue;  // warp-uniform
        bool ok;
        const float s = score(r, bs, be, ok);
        const float p = ok ? expf(s - mn[rr]) : 0.f;
        lt[rr] += mx_warp_sum(p);
        const float pq = has_fmt ? mx_warp_quant(p, f) : p;
        for (int j = 0; j < 32; ++j) {
          const float pj = __shfl_sync(0xffffffffu, pq, j);
#pragma unroll
          for (int c = 0; c < DVL; ++c)
            pv[rr][c] = fmaf(pj, vs[j][lane + 32 * c], pv[rr][c]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int rr = 0; rr < FA_RPW; ++rr) {
      l[rr] = l[rr] * corr[rr] + lt[rr];
#pragma unroll
      for (int c = 0; c < DVL; ++c) acc[rr][c] = acc[rr][c] * corr[rr] + pv[rr][c];
      m[rr] = mn[rr];
    }
  }

#pragma unroll
  for (int rr = 0; rr < FA_RPW; ++rr) {
    const int i = r0 + warp * FA_RPW + rr;
    if (i >= Tq) continue;
    const float lc = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int c = 0; c < DVL; ++c) {
      const int col = lane + 32 * c;
      if (col < dv)
        out[(qrow0 + i) * dv + col] = __float2bfloat16_rn(acc[rr][c] / lc);
    }
    if (lane == 0) lse[qrow0 + i] = m[rr] + logf(lc);
  }
}

// Where the decode kernels find the K/V rows.  Slab: k/v are (B, S, Hkv, ·)
// with strides (sb, ss, sh) and pt is unused.  Paged: k/v are
// (N, ps, Hkv, ·) pools, sb is the page stride, ss the in-page one, and
// view position s of row b is read from page pt[b * P + s / ps].
struct DecRows {
  long long ksb, kss, ksh, vsb, vss, vsh;
  const int* pt;
  int P, ps, n_pages;
};

template <bool PAGED>
__device__ __forceinline__ long long dec_row(const DecRows& r, long long sb,
                                             long long ss, long long sh,
                                             int b, int h, int s) {
  if (PAGED) {
    const int phys = min(max(r.pt[(long long)b * r.P + s / r.ps], 0),
                         r.n_pages - 1);
    return phys * sb + (long long)(s % r.ps) * ss + h * sh;
  }
  return b * sb + (long long)s * ss + h * sh;
}

__device__ __forceinline__ void dec_cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// x[i] of every rank's shared memory (ranks below `splits`), all loads
// issued before any is used.
__device__ __forceinline__ void dec_gather(cg::cluster_group& cluster,
                                           float* x, int i, int splits,
                                           float (&vals)[8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
    vals[r] = r < splits ? cluster.map_shared_rank(x, r)[i] : 0.f;
}

// Elements [c, c + 8) of a bf16 row of width d, zeros past d: one 16-byte
// load when vec (d a multiple of 8, 16-byte aligned rows).
__device__ __forceinline__ uint4 dec_chunk(const __nv_bfloat16* row, int c,
                                           int d, int vec) {
  if (c >= d) return make_uint4(0u, 0u, 0u, 0u);
  if (vec) return *reinterpret_cast<const uint4*>(row + c);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (c + e < d)
      w[e >> 1] |= (uint32_t)__bfloat16_as_ushort(row[c + e]) << (16 * (e & 1));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One CTA of a cluster of `splits` (the cluster's size) for each (batch
// row, kv head): rank r holds view slots [r span, (r + 1) span).  A K row
// is LPR lanes of 8 elements (LPR 4, 8, 16 or 32: head dims up to 32, 64,
// 128, and above, where a lane walks the row's 256-wide segments).  With
// `vsm` the span's V rows are staged in shared memory while the scores
// run; without (a long view with wide value heads), PV reads them in
// place.
template <int LPR, bool PAGED>
__global__ void __launch_bounds__(DEC_THREADS)
mx_decode_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const uint8_t* __restrict__ valid,
                 __nv_bfloat16* __restrict__ out, int G, int S, int span,
                 int d, int dv, int H, DecRows rows, long long valid_sb,
                 int vec, int vsm, int has_fmt, MxFmt f, float scale) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int splits = (int)cluster.num_blocks();
  const int dvs = (dv + 7) & ~7;
  const int nseg = (d + 8 * LPR - 1) / (8 * LPR);   // row segments a lane
  const int W = nseg * 8 * LPR;                     // padded head dim
  extern __shared__ __align__(16) unsigned char dec_sm[];
  __nv_bfloat16* vs = (__nv_bfloat16*)dec_sm;   // [span][dvs] v rows (vsm)
  float* qs = (float*)(vs + (vsm ? span * dvs : 0));   // [G][W] cast q
  float* sc = qs + G * W;                       // [G][span] scores, then p
  float* part = sc + G * span;                  // [G][dv] partial PV
  float* red = part + G * dv;                   // [4][MAXG], see below
  uint8_t* oks = (uint8_t*)(red + 4 * MAXG);    // [span] slot valid
  float* loc_max = red;
  float* loc_sum = red + MAXG;
  float* glob_max = red + 2 * MAXG;
  float* glob_sum = red + 3 * MAXG;             // clamped at 1e-30
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int s0 = rank * span, n = max(0, min(span, S - s0));
  const uint8_t* ok = valid + b * valid_sb;
  auto krow = [&](int s) {
    return k + dec_row<PAGED>(rows, rows.ksb, rows.kss, rows.ksh, b, h, s);
  };
  auto vrow = [&](int s) {
    return v + dec_row<PAGED>(rows, rows.vsb, rows.vss, rows.vsh, b, h, s);
  };
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  float vals[8];   // one value from each rank (dec_gather)

  // V rows of the span into shared memory while the scores run; zeros
  // past the view (the reference's padding of the last 32-block).
  const int vch = vsm ? dvs / 8 : 0;
  for (int i = tid; i < span * vch; i += DEC_THREADS) {
    const int r = i / vch, c = (i % vch) * 8;
    __nv_bfloat16* dst = vs + r * dvs + c;
    if (vec && r < n) {
      dec_cp16(dst, vrow(s0 + r) + c);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (r < n && c + e < dv) ? vrow(s0 + r)[c + e] : zero;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // Scores of all G query heads: a K row is LPR lanes of 8 elements, cast
  // along d in place (mx_quad_quant: 4 lanes a 32-block); a thread issues
  // the loads of DEC_KB rows' first segments before it uses any.
  const int steps = span * LPR / DEC_THREADS;   // span is a multiple of 32
  for (int st0 = 0; st0 < steps; st0 += DEC_KB) {
    uint4 raw[DEC_KB];
#pragma unroll
    for (int u = 0; u < DEC_KB; ++u) {
      const int t = (st0 + u) * DEC_THREADS + tid, r = t / LPR;
      raw[u] = (st0 + u < steps && r < n)
                   ? dec_chunk(krow(s0 + r), (t % LPR) * 8, d, vec)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
    if (st0 == 0) {   // q cast along d, and the span's validity
      for (int i = tid; i < span; i += DEC_THREADS)
        oks[i] = i < n && ok[s0 + i] != 0;
      for (int gg = warp; gg < G; gg += DEC_THREADS / 32)
        for (int c0 = 0; c0 < W; c0 += 32) {
          const int c = c0 + lane;
          float x = c < d
                        ? __bfloat162float(q[((long long)bh * G + gg) * d + c])
                        : 0.f;
          if (has_fmt) x = mx_warp_quant(x, f);
          qs[gg * W + c] = x;
        }
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < DEC_KB; ++u) {
      if (st0 + u >= steps) break;   // uniform over the CTA
      const int t = (st0 + u) * DEC_THREADS + tid, r = t / LPR;
      float dots[MAXG];
#pragma unroll
      for (int gg = 0; gg < MAXG; ++gg) dots[gg] = 0.f;
      for (int seg = 0; seg < nseg; ++seg) {   // uniform over the CTA
        const int c = seg * 8 * LPR + (t % LPR) * 8;
        const uint4 chunk = seg == 0 ? raw[u]
                            : r < n ? dec_chunk(krow(s0 + r), c, d, vec)
                                    : make_uint4(0u, 0u, 0u, 0u);
        const __nv_bfloat162* h2 =
            reinterpret_cast<const __nv_bfloat162*>(&chunk);
        float x[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 p2 = __bfloat1622float2(h2[e]);
          x[2 * e] = p2.x;
          x[2 * e + 1] = p2.y;
        }
        if (has_fmt) mx_quad_quant(x, f);
#pragma unroll
        for (int gg = 0; gg < MAXG; ++gg) {
          if (gg >= G) break;   // uniform over the CTA
          const float4* qv = reinterpret_cast<const float4*>(qs + gg * W + c);
          const float4 qa = qv[0], qb = qv[1];
          const float qq[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
          for (int e = 0; e < 8; ++e) dots[gg] = fmaf(qq[e], x[e], dots[gg]);
        }
      }
#pragma unroll
      for (int gg = 0; gg < MAXG; ++gg) {
        if (gg >= G) break;   // uniform over the CTA
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          dots[gg] += __shfl_xor_sync(0xffffffffu, dots[gg], o);
      }
      if (t % LPR == 0)
#pragma unroll
        for (int gg = 0; gg < MAXG; ++gg)
          if (gg < G) sc[gg * span + r] = oks[r] ? dots[gg] * scale : NEG_INF;
    }
  }
  __syncthreads();

  // The cluster's max, then its sum, each read from every rank's shared
  // memory in rank order.  A span with no valid slot gives NEG_INF and 0.
  for (int gg = warp; gg < G; gg += DEC_THREADS / 32) {
    float m = NEG_INF;
    for (int i = lane; i < span; i += 32) m = mx_nanmax(m, sc[gg * span + i]);
    m = mx_warp_max(m);
    if (lane == 0) loc_max[gg] = m;
  }
  cluster.sync();
  if (tid < G) {
    float m = NEG_INF;
    dec_gather(cluster, loc_max, tid, splits, vals);
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (r < splits) m = mx_nanmax(m, vals[r]);
    glob_max[tid] = m;
  }
  __syncthreads();
  for (int gg = warp; gg < G; gg += DEC_THREADS / 32) {
    const float m = glob_max[gg];
    float sum = 0.f;
    for (int i = lane; i < span; i += 32) {
      const float p = oks[i] ? expf(sc[gg * span + i] - m) : 0.f;
      sc[gg * span + i] = p;
      sum += p;
    }
    sum = mx_warp_sum(sum);
    if (lane == 0) loc_sum[gg] = sum;
  }
  cluster.sync();
  if (tid < G) {
    float l = 0.f;
    dec_gather(cluster, loc_sum, tid, splits, vals);
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (r < splits) l += vals[r];
    glob_sum[tid] = fmaxf(l, 1e-30f);
  }
  __syncthreads();

  // The normalized p, quantized along S per 32-block (a warp a block).
  const int nb = (n + 31) / 32;   // blocks holding view slots
  for (int task = warp; task < G * nb; task += DEC_THREADS / 32) {
    const int gg = task / nb, i = (task % nb) * 32 + lane;
    float pr = sc[gg * span + i] / glob_sum[gg];
    if (has_fmt) pr = mx_warp_quant(pr, f);
    sc[gg * span + i] = pr;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // Partial PV: four lanes a value column, eight slots of each 32-block a
  // lane (the K cast's layout, so v's cast along S over every slot, valid
  // or not, is mx_quad_quant); a lane walks the span's blocks in order,
  // then the four lanes' sums are added (xor 2, then xor 1).
  for (int it = 0; it < (4 * dv + DEC_THREADS - 1) / DEC_THREADS; ++it) {
    const int j = it * DEC_THREADS + tid, c = j >> 2, qt = j & 3;
    const bool live = c < dv;   // whole quads; dead ones still shuffle
    float acc[MAXG];
#pragma unroll
    for (int gg = 0; gg < MAXG; ++gg) acc[gg] = 0.f;
    for (int blk = 0; blk < nb; ++blk) {
      const int s = blk * 32 + qt * 8;
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        x[e] = !live ? 0.f
               : vsm ? __bfloat162float(vs[(s + e) * dvs + c])
               : s + e < n ? __bfloat162float(vrow(s0 + s + e)[c]) : 0.f;
      if (has_fmt) mx_quad_quant(x, f);
#pragma unroll
      for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int gg = 0; gg < MAXG; ++gg)
          if (gg < G) acc[gg] = fmaf(sc[gg * span + s + e], x[e], acc[gg]);
    }
#pragma unroll
    for (int gg = 0; gg < MAXG; ++gg) {
      if (gg >= G) break;   // uniform over the CTA
      float a = acc[gg];
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      if (live && qt == 0) part[gg * dv + c] = a;
    }
  }
  cluster.sync();
  if (rank == 0)   // the partials summed in rank order
    for (int i = tid; i < G * dv; i += DEC_THREADS) {
      float o = 0.f;
      dec_gather(cluster, part, i, splits, vals);
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (r < splits) o += vals[r];
      out[(long long)bh * G * dv + i] = __float2bfloat16_rn(o);
    }
  cluster.sync();   // every rank's shared memory lives until rank 0 is done
}

static int dv_lanes(int dv) { return (dv + 31) / 32; }

extern "C" int mx_flash_fwd(const void* q, const void* k, const void* v,
                            void* out, void* lse, int BH, int G, int Tq,
                            int Tk, int d, int dv, int kind, int window,
                            int q_offset, int tile_k, int has_fmt, int mbits,
                            int min_normal_exp, int e_max, float max_normal,
                            int scale_mode, float scale, void* stream) {
  if (d > MAXD || dv > MAXD || d <= 0 || dv <= 0 || tile_k <= 0)
    return (int)cudaErrorInvalidValue;
  const MxFmt f = mx_fmt(mbits, min_normal_exp, e_max, max_normal,
                         scale_mode);
  dim3 grid((Tq + FA_ROWS - 1) / FA_ROWS, G, BH);
  cudaStream_t s = (cudaStream_t)stream;
  const __nv_bfloat16* qq = (const __nv_bfloat16*)q;
  const __nv_bfloat16* kk = (const __nv_bfloat16*)k;
  const __nv_bfloat16* vv = (const __nv_bfloat16*)v;
  __nv_bfloat16* oo = (__nv_bfloat16*)out;
  float* ll = (float*)lse;
#define FA_LAUNCH(N)                                                        \
  mx_flash_fwd_kernel<N><<<grid, FA_WARPS * 32, 0, s>>>(                    \
      qq, kk, vv, oo, ll, G, Tq, Tk, d, dv, kind, window, q_offset, tile_k, \
      has_fmt, f, scale)
  if (BH > 0 && G > 0 && Tq > 0) {
    switch (dv_lanes(dv)) {
      case 1: FA_LAUNCH(1); break;
      case 2: FA_LAUNCH(2); break;
      case 3: FA_LAUNCH(3); break;
      default: FA_LAUNCH(4); break;
    }
  }
#undef FA_LAUNCH
  return (int)cudaGetLastError();
}

// Lanes of one K row (head dims up to 32, 64, 128; above, 32 lanes that
// walk the row's 256-wide segments) and the padded head dim they cover.
static int dec_lanes(int d) { return d <= 32 ? 4 : d <= 64 ? 8 : d <= 128 ? 16 : 32; }
static long long dec_width(int d) {
  const int l = dec_lanes(d);
  return (long long)(d + 8 * l - 1) / (8 * l) * 8 * l;
}

// Shared memory of a decode CTA, without (vsm 0) or with (vsm 1) the
// span's V rows staged.
static long long dec_smem(int G, int span, int d, int dv, int vsm) {
  const long long dvs = (dv + 7) / 8 * 8;
  return (vsm ? 2LL * span * dvs : 0) + 4LL * G * dec_width(d)
         + 4LL * G * span + 4LL * G * dv + 4LL * 4 * MAXG
         + (span + 15) / 16 * 16;
}

// What the kernel takes: V staged when that fits a CTA, else read in place;
// -1 when the shape does not fit the kernel (G, the head dims, a CTA's
// shared memory).  The one place that holds the decode kernels' limits.
extern "C" int mx_decode_smem_bytes(int G, int span, int d, int dv) {
  if (G <= 0 || G > MAXG || d <= 0 || dv <= 0 || dv > MAXD || span <= 0)
    return -1;
  long long b = dec_smem(G, span, d, dv, 1);
  if (b > DEC_MAX_SMEM) b = dec_smem(G, span, d, dv, 0);
  return b > DEC_MAX_SMEM ? -1 : (int)b;
}

template <int LPR, bool PAGED>
static int decode_cluster(const void* q, const void* k, const void* v,
                          const void* valid, void* out, int BH, int G, int S,
                          int splits, int span, int d, int dv, int H,
                          const DecRows& rows, long long valid_sb, int vec,
                          int vsm, int has_fmt, const MxFmt& f, float scale,
                          int smem, cudaStream_t s) {
  auto kern = mx_decode_kernel<LPR, PAGED>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)BH, (unsigned)splits, 1);
  cfg.blockDim = dim3(DEC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = (unsigned)splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const uint8_t*)valid, (__nv_bfloat16*)out, G,
      S, span, d, dv, H, rows, valid_sb, vec, vsm, has_fmt, f, scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The view is split into `splits` spans of `span` slots (ops.decode_plan:
// span a multiple of 32, splits <= 8, splits * span >= S), one CTA each,
// launched as one cluster per (row, kv head).
template <bool PAGED>
static int decode_launch(const void* q, const void* k, const void* v,
                         const void* valid, void* out, int BH, int G, int S,
                         int splits, int span, int d, int dv, int H,
                         const DecRows& rows, long long valid_sb,
                         int has_fmt, int mbits, int min_normal_exp,
                         int e_max, float max_normal, int scale_mode,
                         float scale, void* stream) {
  const int smem = mx_decode_smem_bytes(G, span, d, dv);
  if (smem < 0 || span % 32 || splits < 1 || splits > 8 ||
      (long long)splits * span < S)
    return (int)cudaErrorInvalidValue;
  const int vsm = dec_smem(G, span, d, dv, 1) <= DEC_MAX_SMEM;
  const MxFmt f = mx_fmt(mbits, min_normal_exp, e_max, max_normal,
                         scale_mode);
  cudaStream_t s = (cudaStream_t)stream;
  if (BH <= 0) return (int)cudaGetLastError();
  const long long strides = rows.ksb | rows.kss | rows.ksh | rows.vsb
                            | rows.vss | rows.vsh;
  const int vec = d % 8 == 0 && dv % 8 == 0 && strides % 8 == 0 &&
                  ((uintptr_t)k | (uintptr_t)v) % 16 == 0;
#define DEC_CASE(LPR)                                                       \
  return decode_cluster<LPR, PAGED>(q, k, v, valid, out, BH, G, S, splits, \
                                    span, d, dv, H, rows, valid_sb, vec,    \
                                    vsm, has_fmt, f, scale, smem, s)
  switch (dec_lanes(d)) {
    case 4: DEC_CASE(4);
    case 8: DEC_CASE(8);
    case 16: DEC_CASE(16);
    default: DEC_CASE(32);
  }
#undef DEC_CASE
}

extern "C" int mx_attn_decode(const void* q, const void* k, const void* v,
                              const void* valid, void* out, int BH, int G,
                              int S, int d, int dv, int H, int splits,
                              int span, long long ksb, long long kss,
                              long long ksh, long long vsb, long long vss,
                              long long vsh, long long valid_sb, int has_fmt,
                              int mbits, int min_normal_exp, int e_max,
                              float max_normal, int scale_mode, float scale,
                              void* stream) {
  const DecRows rows{ksb, kss, ksh, vsb, vss, vsh, nullptr, 0, 1, 1};
  return decode_launch<false>(q, k, v, valid, out, BH, G, S, splits, span,
                              d, dv, H, rows, valid_sb, has_fmt, mbits,
                              min_normal_exp, e_max, max_normal, scale_mode,
                              scale, stream);
}

// q (B*H, G, d); k/v pools (N, ps, H, ·) with strides (ksn, kss, ksh) and
// (vsn, vss, vsh); pt (B, P) int32; valid (B, P*ps) contiguous.
extern "C" int mx_attn_decode_paged(const void* q, const void* k,
                                    const void* v, const void* pt,
                                    const void* valid, void* out, int B,
                                    int H, int G, int P, int ps, int n_pages,
                                    int d, int dv, int splits, int span,
                                    long long ksn, long long kss,
                                    long long ksh, long long vsn,
                                    long long vss, long long vsh,
                                    int has_fmt, int mbits,
                                    int min_normal_exp, int e_max,
                                    float max_normal, int scale_mode,
                                    float scale, void* stream) {
  if (ps <= 0 || ps % 32 || n_pages <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  const DecRows rows{ksn, kss, ksh, vsn, vss, vsh, (const int*)pt, P, ps,
                     n_pages};
  return decode_launch<true>(q, k, v, valid, out, B * H, G, P * ps, splits,
                             span, d, dv, H, rows, (long long)P * ps,
                             has_fmt, mbits, min_normal_exp, e_max,
                             max_normal, scale_mode, scale, stream);
}
