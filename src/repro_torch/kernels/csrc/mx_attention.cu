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
//   far below the H100's ~295 operations per byte; decode reads the KV
//   cache once.  Paged decode must move the K/V rows of the mapped pages,
//   q, out, the page table and the validity mask once, over 3.35 TB/s.
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
//   * Decode.  One CTA per (batch, kv head).  The cache is read in its
//     (B, S, Hkv, d) layout through strides, so no per-step transposed copy
//     of the cache is made.  The S scores live in shared memory; the
//     softmax is explicit, the *normalized* p is quantized along S and v
//     along S over every slot, valid or not (the contents of invalid slots
//     therefore matter, as in the reference).  For the PV product a lane
//     owns a value column and walks the 32 rows of a block, so the block
//     max of v needs no shuffle.
//   * Paged decode is the same kernel (template flag PAGED) with another
//     row address: view position s of row b lives at offset s % ps of
//     physical page pt[b * P + s / ps] of the (N, ps, Hkv, d) pool, read
//     through strides; an entry outside [0, N) is clamped, so an unmapped
//     -1 reads page 0 exactly as the gather of the plain version does (the
//     mask hides it, and v's 32-blocks never straddle a page because ps is
//     a multiple of 32).  Every multiply, add and reduction is the slab
//     kernel's, in its order, so the result is bitwise that of the slab
//     kernel on the gathered (B, P*ps, Hkv, d) view.  The TPU kernel's
//     VMEM staging of the gathered view is not carried over: the rows are
//     read in place.
#include <math.h>

#include "mx_quant.cuh"

namespace {
constexpr int MAXD = 128;
constexpr int FA_WARPS = 4;
constexpr int FA_RPW = 4;                    // query rows per warp
constexpr int FA_ROWS = FA_WARPS * FA_RPW;   // query rows per CTA
constexpr int MAXG = 8;
constexpr int DEC_WARPS = 16;
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

template <int DVL, bool PAGED>
__global__ void __launch_bounds__(DEC_WARPS * 32)
mx_decode_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const uint8_t* __restrict__ valid,
                 __nv_bfloat16* __restrict__ out, int G, int S, int d, int dv,
                 int H, DecRows rows, long long valid_sb, int has_fmt,
                 MxFmt f, float scale) {
  extern __shared__ float sm[];
  float* qs = sm;                 // [G][d]
  float* sc = qs + G * d;         // [G][S]
  float* red = sc + G * S;        // [DEC_WARPS][G][dv], or warp scratch
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const uint8_t* ok = valid + b * valid_sb;
  auto krow = [&](int s) {
    return k + dec_row<PAGED>(rows, rows.ksb, rows.kss, rows.ksh, b, h, s);
  };
  auto vrow = [&](int s) {
    return v + dec_row<PAGED>(rows, rows.vsb, rows.vss, rows.vsh, b, h, s);
  };

  for (int gg = warp; gg < G; gg += DEC_WARPS)
    for (int c0 = 0; c0 < d; c0 += 32) {
      const int c = c0 + lane;
      float x = c < d ? __bfloat162float(q[((long long)bh * G + gg) * d + c])
                      : 0.f;
      if (has_fmt) x = mx_warp_quant(x, f);
      if (c < d) qs[gg * d + c] = x;
    }
  __syncthreads();

  // Scores: one warp per cache row, k quantized along d on load.
  for (int s = warp; s < S; s += DEC_WARPS) {
    float dots[MAXG];
#pragma unroll
    for (int gg = 0; gg < MAXG; ++gg) dots[gg] = 0.f;
    for (int c0 = 0; c0 < d; c0 += 32) {
      const int c = c0 + lane;
      float x = c < d ? __bfloat162float(krow(s)[c]) : 0.f;
      if (has_fmt) x = mx_warp_quant(x, f);
#pragma unroll
      for (int gg = 0; gg < MAXG; ++gg)
        if (gg < G && c < d) dots[gg] = fmaf(qs[gg * d + c], x, dots[gg]);
    }
    const bool valid_s = ok[s] != 0;
#pragma unroll
    for (int gg = 0; gg < MAXG; ++gg)
      if (gg < G) {
        const float dot = mx_warp_sum(dots[gg]);
        if (lane == 0) sc[gg * S + s] = valid_s ? dot * scale : NEG_INF;
      }
  }
  __syncthreads();

  // Explicit softmax per query head, then quantize the normalized p along S.
  for (int gg = 0; gg < G; ++gg) {
    float* row = sc + gg * S;
    float mx = NEG_INF;
    for (int s = tid; s < S; s += DEC_WARPS * 32) mx = mx_nanmax(mx, row[s]);
    mx = mx_warp_max(mx);
    if (lane == 0) red[warp] = mx;
    __syncthreads();
    mx = NEG_INF;
    for (int w = 0; w < DEC_WARPS; ++w) mx = mx_nanmax(mx, red[w]);
    __syncthreads();
    float sum = 0.f;
    for (int s = tid; s < S; s += DEC_WARPS * 32) {
      const float p = ok[s] ? expf(row[s] - mx) : 0.f;
      row[s] = p;
      sum += p;
    }
    sum = mx_warp_sum(sum);
    if (lane == 0) red[warp] = sum;
    __syncthreads();
    float tot = 0.f;
    for (int w = 0; w < DEC_WARPS; ++w) tot += red[w];
    const float lc = fmaxf(tot, 1e-30f);
    __syncthreads();
    for (int bs = warp * 32; bs < S; bs += DEC_WARPS * 32) {
      const int s = bs + lane;
      float pr = s < S ? row[s] / lc : 0.f;
      if (has_fmt) pr = mx_warp_quant(pr, f);
      if (s < S) row[s] = pr;
    }
    __syncthreads();
  }

  // PV: lane owns value columns, walks the 32 rows of each block.
  float acc[MAXG][DVL];
#pragma unroll
  for (int gg = 0; gg < MAXG; ++gg)
#pragma unroll
    for (int c = 0; c < DVL; ++c) acc[gg][c] = 0.f;
  for (int bs = warp * 32; bs < S; bs += DEC_WARPS * 32) {
#pragma unroll
    for (int c = 0; c < DVL; ++c) {
      const int col = lane + 32 * c;
      float vals[32];
      float amax = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int s = bs + j;
        vals[j] = (s < S && col < dv)
                      ? __bfloat162float(vrow(s)[col]) : 0.f;
        amax = mx_nanmax(amax, fabsf(vals[j]));
      }
      const int e = has_fmt ? mx_thread_exp(vals, amax, f) : 0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float x = has_fmt ? mx_cast(vals[j], e, f) : vals[j];
        const int s = min(bs + j, S - 1);
        const float keep = (bs + j < S) ? 1.f : 0.f;
#pragma unroll
        for (int gg = 0; gg < MAXG; ++gg)
          if (gg < G) acc[gg][c] = fmaf(sc[gg * S + s] * keep, x, acc[gg][c]);
      }
    }
  }
#pragma unroll
  for (int gg = 0; gg < MAXG; ++gg)
#pragma unroll
    for (int c = 0; c < DVL; ++c) {
      const int col = lane + 32 * c;
      if (gg < G && col < dv) red[(warp * G + gg) * dv + col] = acc[gg][c];
    }
  __syncthreads();
  for (int i = tid; i < G * dv; i += DEC_WARPS * 32) {
    float o = 0.f;
    for (int w = 0; w < DEC_WARPS; ++w) o += red[w * G * dv + i];
    out[(long long)bh * G * dv + i] = __float2bfloat16_rn(o);
  }
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

extern "C" int mx_decode_smem_bytes(int G, int S, int d, int dv) {
  const long long b = 4LL * ((long long)G * d + (long long)G * S
                             + (long long)DEC_WARPS * (G * dv + 1));
  return b > (1 << 30) ? (1 << 30) : (int)b;
}

template <bool PAGED>
static int decode_launch(const void* q, const void* k, const void* v,
                         const void* valid, void* out, int BH, int G, int S,
                         int d, int dv, int H, const DecRows& rows,
                         long long valid_sb, int has_fmt, int mbits,
                         int min_normal_exp, int e_max, float max_normal,
                         int scale_mode, float scale, void* stream) {
  const int smem = mx_decode_smem_bytes(G, S, d, dv);
  if (G > MAXG || dv > MAXD || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const MxFmt f = mx_fmt(mbits, min_normal_exp, e_max, max_normal,
                         scale_mode);
  cudaStream_t s = (cudaStream_t)stream;
#define DEC_LAUNCH(N)                                                        \
  mx_decode_kernel<N, PAGED><<<BH, DEC_WARPS * 32, (size_t)smem, s>>>(       \
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,                      \
      (const __nv_bfloat16*)v, (const uint8_t*)valid, (__nv_bfloat16*)out,   \
      G, S, d, dv, H, rows, valid_sb, has_fmt, f, scale)
  if (BH > 0) {
    switch (dv_lanes(dv)) {
      case 1: DEC_LAUNCH(1); break;
      case 2: DEC_LAUNCH(2); break;
      case 3: DEC_LAUNCH(3); break;
      default: DEC_LAUNCH(4); break;
    }
  }
#undef DEC_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int mx_attn_decode(const void* q, const void* k, const void* v,
                              const void* valid, void* out, int BH, int G,
                              int S, int d, int dv, int H, long long ksb,
                              long long kss, long long ksh, long long vsb,
                              long long vss, long long vsh,
                              long long valid_sb, int has_fmt, int mbits,
                              int min_normal_exp, int e_max,
                              float max_normal, int scale_mode, float scale,
                              void* stream) {
  const DecRows rows{ksb, kss, ksh, vsb, vss, vsh, nullptr, 0, 1, 1};
  return decode_launch<false>(q, k, v, valid, out, BH, G, S, d, dv, H, rows,
                              valid_sb, has_fmt, mbits, min_normal_exp,
                              e_max, max_normal, scale_mode, scale, stream);
}

// q (B*H, G, d); k/v pools (N, ps, H, ·) with strides (ksn, kss, ksh) and
// (vsn, vss, vsh); pt (B, P) int32; valid (B, P*ps) contiguous.
extern "C" int mx_attn_decode_paged(const void* q, const void* k,
                                    const void* v, const void* pt,
                                    const void* valid, void* out, int B,
                                    int H, int G, int P, int ps, int n_pages,
                                    int d, int dv, long long ksn,
                                    long long kss, long long ksh,
                                    long long vsn, long long vss,
                                    long long vsh, int has_fmt, int mbits,
                                    int min_normal_exp, int e_max,
                                    float max_normal, int scale_mode,
                                    float scale, void* stream) {
  if (ps <= 0 || ps % 32 || n_pages <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  const DecRows rows{ksn, kss, ksh, vsn, vss, vsh, (const int*)pt, P, ps,
                     n_pages};
  return decode_launch<true>(q, k, v, valid, out, B * H, G, P * ps, d, dv, H,
                             rows, (long long)P * ps, has_fmt, mbits,
                             min_normal_exp, e_max, max_normal, scale_mode,
                             scale, stream);
}
