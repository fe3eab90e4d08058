// MX flash attention forward (prefill), MX decode attention, and MX decode
// through a page table.
//
// Replaces: `mx_attn_fwd_pallas` (src/repro/kernels/mx_attention.py:156,
//   pallas_call at :172; body `_mx_attn_fwd_kernel` :110-151),
//   `mx_attn_decode_pallas` (:455, pallas_call at :468; body
//   `_mx_attn_decode_body` :364-381) and `mx_attn_decode_paged_pallas`
//   (:407, pallas_call at :445; body `_mx_attn_decode_paged_kernel`
//   :384-404).
// Bound: the flash forward is bytes-bound at the training shape (BH 64,
//   T 512, d 64 causal: q, k, v and out in bf16 and lse in fp32, 16.9 MB,
//   5.0 µs at 3.35 TB/s, against 2.15 GFLOP of useful products, 2.2 µs at
//   the bf16 peak; chip_smoke.py reckons both); the tensor work as built is
//   larger (S formed twice per JAX tile, and in bf16 mode PV three times:
//   3 and 5 product units against the 2 of one QK and one PV).  Decode is
//   memory- and latency-bound at the serve path's shapes: it must move
//   the K rows of the valid slots (a masked slot's score is dropped
//   whatever its K row holds), the V rows of every slot (v is cast along S
//   over all of them), q, out and the validity mask once (3.4 MB at B 4,
//   H 8, S 512 with the serve path's positions: 1.02 µs over 3.35 TB/s);
//   paged decode the same, with V over the mapped pages, and the page
//   table.  The decode kernel still loads and casts the K rows of masked
//   slots: reading the mask first would add a dependent round trip.  It
//   is held back by latency: a call is a few dependent round trips.
// Includes: mx_mma.cuh (the tensor-core and copy helpers, shared with the
//   flash dgrad in mx_attention_bwd.cu) and mx_quant.cuh (the cast).
// Design:
//   * Flash forward, on the tensor cores.  In MX mode a pre-pass casts q
//     and k along d and v along kv into a bf16 scratch (the wrapper's
//     `qkv_hat`), where the cast values are exact; v in 32-row blocks
//     aligned to each JAX kv tile's start (tile_k = min(kv_chunk, Tk)),
//     every row cast, masked or not, rows past the tile's end zeros.  With
//     16-byte rows four lanes hold a 32-block, 8 elements a lane
//     (`mx_quad_quant`: for v, 8 rows of 8 columns a lane, one 16-byte
//     load a row), else a warp a block.  bf16 mode reads q, k, v in place.
//     The main kernel: a CTA per (bh, g, 64 query rows), 4 warps of 16
//     rows, the CTAs of the last rows issued first under a causal or
//     window mask (they hold the most blocks).  The unnormalized p is
//     quantized after the rescale by the running max over the whole JAX
//     tile, so each tile is walked twice in blocks of 64 kv rows (32 for
//     qk head dims above 64).  The tiles are sized by the padded qk head
//     dim and the padded v head dim apart (FwTile<DQ, DV>): q, k and the
//     score's k-steps by DQ; v, PV and the output accumulator by DV, so
//     MLA's qk 192 against v 128 keeps the v side at 128's registers.
//     A v head wider than 128 (recurrentgemma's 256) is cut into chunks of
//     128 value columns, one CTA each (grid z): acc and pv of all 256
//     columns would be 256 registers a thread, over the 255 limit.  Each
//     chunk's CTA forms the same S, p, l and m in the same order (the p
//     cast runs along kv, not along v), so every output column is the one
//     a CTA holding all columns would give; the work of S is repeated in
//     each chunk, and the chunk of v column 0 writes lse.
//     Pass 1 forms S = Q^ K^T on `mma.sync` m16n8k16
//     (bf16 in, fp32 accumulators) and each row's max over the tile, in
//     registers and then across the four lanes of a quad; pass 2 forms S
//     again and p = exp(s scale - m_new) (exactly 0 where masked), adds
//     the unquantized p to the lane's share of l in a fixed order, casts
//     p per 32 columns in the accumulators' layout (`mx_mma_quant`: the
//     warp butterfly's sums, so every scale rule chooses as the other
//     kernels do), and accumulates PV on `mma.sync` with the accumulators
//     as the A operand: Q(p) in one bf16 piece (exact but for MX values
//     below bf16's smallest subnormal, 2^-133, which only a block whose
//     max p lies below 2^-102 can hold, 2^-116 in e4m3; bf16 rounds such
//     a value by at most 2^-134, which moves out by at most 2^-134 max|v|
//     since l >= 1), or in bf16 mode the fp32 p as three bf16 pieces
//     (`bw_pieces`, all 24 bits).  K and V blocks arrive by double-
//     buffered cp.async (K alone in pass 1), read with `ldmatrix`.  At the
//     tile's end l = l corr + lt and acc = acc corr + pv, as the reference
//     folds.  A block that the mask rules out for every row of the CTA is
//     skipped, which is bitwise the same as computing it (p = 0 there).
//     Out is acc / max(l, 1e-30) in bf16 (fp32 when asked: the bf16 out
//     before its one rounding); lse = m + log(max(l, 1e-30)) in fp32.  No
//     atomics: a second call gives equal bits.
//   * Decode, split over a thread-block cluster.  The *normalized* p is
//     quantized along S (32-blocks) and v along S over every slot, valid
//     or not, so the view's max and sum must be known before any p is
//     cast.  The wrapper plans the split from S alone (ops.decode_plan:
//     `splits` <= 8 CTAs of `span` slots, span a multiple of 32, so no
//     32-block of p or v straddles two CTAs, and a row's result does not
//     depend on the batch it shares).  Grid (B*H, splits, head groups),
//     one cluster of `splits` CTAs per (row, kv head, group of query
//     heads), launched with cudaLaunchKernelEx.  Up to MAXG (8) query
//     heads a kv head are one group; more (recurrentgemma's 16) are cut
//     into groups of DEC_GROUP, each reading and casting K and V itself,
//     so a CTA's registers stay those of G <= 8.  A group's CTA runs
//     DEC_WIDE_THREADS threads (the template's NT): at 128, four warps an
//     SM could not hide the latency of eight heads over 256-wide rows.
//     The thread count moves no sum: a K row's dot stays with its LPR
//     lanes, a head's max and sum with one warp, a value column with its
//     four lanes.
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

#include "mx_mma.cuh"
#include "mx_quant.cuh"

namespace cg = cooperative_groups;

namespace {
constexpr int FW_THREADS = 128;   // 4 warps of 16 query rows
constexpr int FW_BM = 64;         // query rows of a CTA
constexpr int FW_PREP = 256;      // threads of a pre-pass CTA
constexpr int MAXG = 8;            // decode: query heads of a CTA
#ifndef DEC_GROUP
#define DEC_GROUP 8                // decode: heads of a CTA when G > MAXG
#endif
static_assert(DEC_GROUP >= 1 && DEC_GROUP <= MAXG, "DEC_GROUP");
constexpr int DEC_MAXDV = 256;     // decode: v head dim
constexpr int DEC_THREADS = 128;   // a decode CTA of up to MAXG heads
#ifndef DEC_WIDE_THREADS
#define DEC_WIDE_THREADS 512       // a decode CTA of a group (G > MAXG)
#endif
static_assert(DEC_WIDE_THREADS != 128 && DEC_WIDE_THREADS % 128 == 0,
              "DEC_WIDE_THREADS");
constexpr int DEC_KB = 4;          // K loads a thread keeps in flight
constexpr int DEC_MAX_SMEM = 227 * 1024;   // a CTA's opt-in limit
constexpr float NEG_INF = -1e30f;
enum { KIND_CAUSAL = 0, KIND_FULL = 1, KIND_WINDOW = 2 };

// The flash kernels' head dims: qk up to FLASH_MAXD, v up to FLASH_MAXDV
// (v above FW_DVC in chunks of FW_DVC columns).
constexpr int FLASH_MAXD = 256;
constexpr int FLASH_MAXDV = 256;
constexpr int FW_DVC = 128;

// Shapes of the forward's tiles for a padded qk head dim DQ and a padded v
// head dim DV (multiples of 32): q and k rows are DQ wide, v rows, PV and
// the output accumulator DV wide.
template <int DQ, int DV>
struct FwTile {
  static constexpr int LD = DQ + 8;             // q/k smem row stride (bf16)
  static constexpr int LDV = DV + 8;            // v smem row stride
  static constexpr int BN = DQ > 64 ? 32 : 64;  // kv rows of a block
  static constexpr int NT = BN / 8;             // n-tiles of S
  static constexpr int KS = DQ / 16;            // k-steps over the qk dim
  static constexpr int DT = DV / 8;             // n-tiles of PV
  static constexpr int STAGE = BN * (LD + LDV);  // one stage: k, then v
  static constexpr int SMEM = 2 * (FW_BM * LD + 2 * STAGE);
};
}  // namespace

// Pre-pass, MX mode: the q rows (qrows of them) and the k rows (krows)
// cast along d into qh and kh.  vec (d a multiple of 8, 16-byte aligned
// rows): four lanes a 32-block, 8 elements a lane (mx_quad_quant);
// otherwise a warp a 32-block (mx_warp_quant).
__global__ void __launch_bounds__(FW_PREP)
mx_flash_fwd_cast_rows(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       bf16* __restrict__ qh, bf16* __restrict__ kh,
                       long long qrows, long long krows, int d, int vec,
                       MxFmt f) {
  const long long nb = (d + 31) / 32, tasks = (qrows + krows) * nb;
  const long long tid = (long long)blockIdx.x * FW_PREP + threadIdx.x;
  const long long t = vec ? tid >> 2 : tid >> 5;   // this lane's block
  const long long row = t / nb;
  const bool is_q = row < qrows;
  const long long r = is_q ? row : row - qrows;
  const bf16* src = (is_q ? q : k) + r * d;
  bf16* dst = (is_q ? qh : kh) + r * d;
  const int c0 = (int)(t - row * nb) * 32;
  if (vec) {
    const int c = c0 + 8 * (int)(tid & 3);
    const bool in = t < tasks && c < d;
    float x[8];
    mx_unpack8(in ? *reinterpret_cast<const uint4*>(src + c)
                  : make_uint4(0u, 0u, 0u, 0u), x);
    mx_quad_quant(x, f);   // every lane takes part in the shuffles
    if (in) *reinterpret_cast<uint4*>(dst + c) = mx_pack8(x);
  } else {
    const int c = c0 + (int)(tid & 31);
    const bool in = t < tasks && c < d;
    const float x = mx_warp_quant(in ? __bfloat162float(src[c]) : 0.f, f);
    if (in) dst[c] = __float2bfloat16_rn(x);
  }
}

// Pre-pass, MX mode: v (BH, Tk, dv) cast along kv into vh, in 32-row
// blocks aligned to each JAX tile's start (tile_k rows a tile); rows past
// the tile's end (or Tk) are zeros in the cast, as the reference pads.
// vec (dv a multiple of 8, 16-byte aligned rows): four lanes hold a block
// of 8 value columns, 8 rows a lane (rows 8 (lane & 3) + i), one 16-byte
// load a row, and cast each column with mx_quad_quant; otherwise a warp a
// (block, column), lane = row.
__global__ void __launch_bounds__(FW_PREP)
mx_flash_fwd_cast_v(const bf16* __restrict__ v, bf16* __restrict__ vh,
                    int BH, int Tk, int dv, int tile_k, int vec, MxFmt f) {
  const int bpt = (tile_k + 31) / 32, nk = (Tk + tile_k - 1) / tile_k;
  const int cols = vec ? (dv + 7) / 8 : dv;   // column tasks of a block
  const long long tasks = (long long)BH * nk * bpt * cols;
  const long long tid = (long long)blockIdx.x * FW_PREP + threadIdx.x;
  const long long t = vec ? tid >> 2 : tid >> 5;
  const int col = (int)(t % cols);
  const long long blk = t / cols;
  const int bh = (int)(blk / ((long long)nk * bpt));
  const int tile = (int)(blk / bpt % nk), ib = (int)(blk % bpt);
  const int rs = tile * tile_k + ib * 32;            // block start
  const int re = min(min((tile + 1) * tile_k, Tk), rs + 32);   // rows in
  const bf16* src = v + (long long)bh * Tk * dv;
  bf16* dst = vh + (long long)bh * Tk * dv;
  if (vec) {
    const int c = col * 8, r0 = rs + 8 * (int)(tid & 3);
    const bool live = t < tasks;
    float x[8][8];   // x[column][row]
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bf16* at = src + (long long)(r0 + i) * dv + c;
      float row[8];
      mx_unpack8(live && r0 + i < re ? *reinterpret_cast<const uint4*>(at)
                                     : make_uint4(0u, 0u, 0u, 0u), row);
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e][i] = row[e];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) mx_quad_quant(x[e], f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float row[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) row[e] = x[e][i];
      if (live && r0 + i < re)
        *reinterpret_cast<uint4*>(dst + (long long)(r0 + i) * dv + c) =
            mx_pack8(row);
    }
  } else {
    const int r = rs + (int)(tid & 31);
    const bool in = t < tasks && r < re;
    const float x = mx_warp_quant(
        in ? __bfloat162float(src[(long long)r * dv + col]) : 0.f, f);
    if (in) dst[(long long)r * dv + col] = __float2bfloat16_rn(x);
  }
}

// One step of the forward's walk: kv block [bs, bs + BN) of the JAX tile
// starting at ts, in pass 1 (K alone) or pass 2 (K and V).
struct FwStep {
  int ts, pass, bs;
};

template <int DQ, int DV, typename OutT>
__global__ void __launch_bounds__(FW_THREADS)
mx_flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, OutT* __restrict__ out,
                    float* __restrict__ lse, int G, int Tq, int Tk, int d,
                    int dv, int kind, int window, int q_offset, int tile_k,
                    int vec, int has_fmt, MxFmt f, float scale) {
  using C = FwTile<DQ, DV>;
  constexpr int LD = C::LD, LDV = C::LDV, BN = C::BN, NT = C::NT,
                DT = C::DT;
  extern __shared__ __align__(16) unsigned char fw_sm[];
  bf16* sQ = (bf16*)fw_sm;          // [64][LD] own rows
  bf16* stage = sQ + FW_BM * LD;    // 2 x {k [BN][LD], v [BN][LDV]}
  auto st = [&](int s, int which) {
    return stage + s * C::STAGE + which * BN * LD;
  };
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int bhg = blockIdx.x, bh = bhg / G;
  // This CTA's chunk of value columns: [dv0, dv0 + dvc) of v's dv.
  const int dv0 = blockIdx.z * DV, dvc = min(DV, dv - dv0);
  // The CTAs of the last query rows hold the most live blocks under a
  // causal or window mask: they are issued first.
  const int qblk = kind == KIND_FULL ? blockIdx.y : gridDim.y - 1 - blockIdx.y;
  const int r0 = qblk * FW_BM;
  const long long row0 = (long long)bhg * Tq + r0;
  const int nrows = min(FW_BM, Tq - r0);
  const bf16* kb = k + (long long)bh * Tk * d;
  const bf16* vb = v + (long long)bh * Tk * dv;
  const int qa = r0 + q_offset, qb = r0 + nrows - 1 + q_offset;

  mma_tile<DQ / 8, LD, FW_THREADS>(sQ, q + row0 * d, d, FW_BM, nrows, d,
                                   vec);

  auto tile_end = [&](int ts) { return min(ts + tile_k, Tk); };
  // The first live block of tile ts at or after bs (the tile's end if none).
  auto live_from = [&](int ts, int bs) {
    const int te = tile_end(ts);
    while (bs < te &&
           !bw_live(kind, window, qa, qb, bs, min(bs + BN, te) - 1))
      bs += BN;
    return bs;
  };
  // The first step of the first tile at or after ts that holds a live
  // block ({Tk, 0, 0} when none is left).
  auto tile_from = [&](int ts) {
    for (; ts < Tk && (kind == KIND_FULL || ts <= qb); ts += tile_k) {
      const int bs = live_from(ts, ts);
      if (bs < tile_end(ts)) return FwStep{ts, 0, bs};
    }
    return FwStep{Tk, 0, 0};
  };
  auto next = [&](FwStep c) {
    const int bs = live_from(c.ts, c.bs + BN);
    if (bs < tile_end(c.ts)) return FwStep{c.ts, c.pass, bs};
    if (c.pass == 0) return FwStep{c.ts, 1, live_from(c.ts, c.ts)};
    return tile_from(c.ts + tile_k);
  };
  auto load = [&](int s, FwStep c) {
    const int n = min(BN, tile_end(c.ts) - c.bs);   // rows past it: zeros
    mma_tile<DQ / 8, LD, FW_THREADS>(st(s, 0), kb + (long long)c.bs * d, d,
                                     BN, n, d, vec);
    if (c.pass)
      mma_tile<DV / 8, LDV, FW_THREADS>(st(s, 1),
                                        vb + (long long)c.bs * dv + dv0, dv,
                                        BN, n, dvc, vec);
  };

  // Two rows a lane: h = 0 is row gq of the warp's 16, h = 1 row gq + 8.
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float mt[2], mn[2], corr[2], lp[2];
  float acc[DT][4], pv[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  FwStep cur = tile_from(0);
  if (cur.ts < Tk) load(0, cur);
  bw_commit();
  int s = 0;
  bool first = true;   // the first step of a tile's pass
  while (cur.ts < Tk) {
    const FwStep nx = next(cur);
    if (nx.ts < Tk) load(s ^ 1, nx);
    bw_commit();
    bw_wait<1>();
    __syncthreads();
    const int be = min(cur.bs + BN, tile_end(cur.ts));
    if (first && cur.pass == 0) {
      mt[0] = mt[1] = NEG_INF;
    } else if (first) {   // pass 2 of this tile begins: the tile's max known
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mn[h] = mx_nanmax(m[h], mt[h]);
        corr[h] = expf(__fsub_rn(m[h], mn[h]));
        lp[h] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < DT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[j][e] = 0.f;
    }
    float x[NT][4];
    mma_scores<NT, C::KS, LD>(x, sQ, st(s, 0), warp, lane);
    if (cur.pass == 0) {   // each row's max over the tile
      float rm[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, r = warp * 16 + gq + 8 * h;
          const int col = cur.bs + 8 * j + 2 * tq + (e & 1);
          const bool ok = col < be &&
                          bw_valid(kind, window, r0 + r + q_offset, col);
          rm[h] = mx_nanmax(rm[h], ok ? __fmul_rn(x[j][e], scale) : NEG_INF);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rm[h] = mx_nanmax(rm[h], __shfl_xor_sync(0xffffffffu, rm[h], 1));
        rm[h] = mx_nanmax(rm[h], __shfl_xor_sync(0xffffffffu, rm[h], 2));
        mt[h] = mx_nanmax(mt[h], rm[h]);
      }
    } else {
      // p = exp(s - m_new), exactly 0 where masked; the unquantized p into
      // this lane's share of l, in a fixed order.
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, r = warp * 16 + gq + 8 * h;
          const int col = cur.bs + 8 * j + 2 * tq + (e & 1);
          const bool ok = col < be &&
                          bw_valid(kind, window, r0 + r + q_offset, col);
          const float p =
              ok ? expf(__fsub_rn(__fmul_rn(x[j][e], scale), mn[h])) : 0.f;
          lp[h] = __fadd_rn(lp[h], p);
          x[j][e] = p;
        }
      if (has_fmt) {   // p cast per 32 columns, blocks aligned to the tile
#pragma unroll
        for (int bb = 0; bb < BN / 32; ++bb)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float pb[8];
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              pb[2 * t] = x[4 * bb + t][2 * h];
              pb[2 * t + 1] = x[4 * bb + t][2 * h + 1];
            }
            mx_mma_quant(pb, f);
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              x[4 * bb + t][2 * h] = pb[2 * t];
              x[4 * bb + t][2 * h + 1] = pb[2 * t + 1];
            }
          }
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {   // Q(p), exact in bf16
          uint32_t a[1][4];
          bw_one_piece(x[2 * kk], x[2 * kk + 1], a[0]);
          mma_step<DT, LDV, 1>(pv, a, st(s, 1), kk, lane);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {   // fp32 p as three pieces
          uint32_t a[3][4];
          bw_pieces(x[2 * kk], x[2 * kk + 1], a[0], a[1], a[2]);
          mma_step<DT, LDV, 3>(pv, a, st(s, 1), kk, lane);
        }
      }
    }
    first = nx.ts != cur.ts || nx.pass != cur.pass;
    if (cur.pass == 1 && first) {   // the tile's end: fold it into the carry
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float lt = lp[h];
        lt = __fadd_rn(lt, __shfl_xor_sync(0xffffffffu, lt, 1));
        lt = __fadd_rn(lt, __shfl_xor_sync(0xffffffffu, lt, 2));
        l[h] = __fadd_rn(__fmul_rn(l[h], corr[h]), lt);
        m[h] = mn[h];
      }
#pragma unroll
      for (int j = 0; j < DT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] = __fadd_rn(__fmul_rn(acc[j][e], corr[e >> 1]), pv[j][e]);
    }
    __syncthreads();   // this stage's reads are done before it is refilled
    s ^= 1;
    cur = nx;
  }
  bw_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + gq + 8 * h;
    if (r >= nrows) continue;
    const float lc = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int col = 8 * j + 2 * tq + b;
        if (col < dvc)
          mx_store<OutT>(out + (row0 + r) * dv + dv0 + col,
                         __fdiv_rn(acc[j][2 * h + b], lc));
      }
    if (tq == 0 && dv0 == 0) lse[row0 + r] = __fadd_rn(m[h], logf(lc));
  }
}

// Query heads of a decode CTA: all G of a kv head up to MAXG; above, groups
// of DEC_GROUP heads, one CTA each (grid z).  A head's scores, max, sum, p
// and PV depend on no other head, so a group gives the bits of one CTA
// holding all G; K and V are read and cast once per group.
static int dec_group(int G) {
  return G <= MAXG ? G : DEC_GROUP;
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
template <int LPR, bool PAGED, int NT>
__global__ void __launch_bounds__(NT)
mx_decode_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const uint8_t* __restrict__ valid,
                 __nv_bfloat16* __restrict__ out, int Gt, int S, int span,
                 int d, int dv, int H, DecRows rows, long long valid_sb,
                 int vec, int vsm, int has_fmt, MxFmt f, float scale) {
  // This CTA's query heads: [g0, g0 + G) of the kv head's Gt.  A CTA of
  // DEC_THREADS holds all Gt <= MAXG; a wide one (Gt > MAXG) a group.
  constexpr bool wide = NT != DEC_THREADS;
  const int g0 = wide ? blockIdx.z * DEC_GROUP : 0;
  const int G = wide ? min(DEC_GROUP, Gt - g0) : Gt;
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
  for (int i = tid; i < span * vch; i += NT) {
    const int r = i / vch, c = (i % vch) * 8;
    __nv_bfloat16* dst = vs + r * dvs + c;
    if (vec && r < n) {
      bw_cp16(dst, vrow(s0 + r) + c, 16);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (r < n && c + e < dv) ? vrow(s0 + r)[c + e] : zero;
    }
  }
  bw_commit();

  // Scores of all G query heads: a K row is LPR lanes of 8 elements, cast
  // along d in place (mx_quad_quant: 4 lanes a 32-block); a thread issues
  // the loads of DEC_KB rows' first segments before it uses any.
  // span is a multiple of 32, so of DEC_THREADS / LPR; a wide CTA's last
  // step may run past it
  const int steps = wide ? (span * LPR + NT - 1) / NT : span * LPR / NT;
  for (int st0 = 0; st0 < steps; st0 += DEC_KB) {
    uint4 raw[DEC_KB];
#pragma unroll
    for (int u = 0; u < DEC_KB; ++u) {
      const int t = (st0 + u) * NT + tid, r = t / LPR;
      raw[u] = (st0 + u < steps && r < n)
                   ? dec_chunk(krow(s0 + r), (t % LPR) * 8, d, vec)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
    if (st0 == 0) {   // q cast along d, and the span's validity
      for (int i = tid; i < span; i += NT)
        oks[i] = i < n && ok[s0 + i] != 0;
      for (int gg = warp; gg < G; gg += NT / 32)
        for (int c0 = 0; c0 < W; c0 += 32) {
          const int c = c0 + lane;
          float x = c < d
                        ? __bfloat162float(
                              q[((long long)bh * Gt + g0 + gg) * d + c])
                        : 0.f;
          if (has_fmt) x = mx_warp_quant(x, f);
          qs[gg * W + c] = x;
        }
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < DEC_KB; ++u) {
      if (st0 + u >= steps) break;   // uniform over the CTA
      const int t = (st0 + u) * NT + tid, r = t / LPR;
      float dots[MAXG];
#pragma unroll
      for (int gg = 0; gg < MAXG; ++gg) dots[gg] = 0.f;
      for (int seg = 0; seg < nseg; ++seg) {   // uniform over the CTA
        const int c = seg * 8 * LPR + (t % LPR) * 8;
        const uint4 chunk = seg == 0 ? raw[u]
                            : r < n ? dec_chunk(krow(s0 + r), c, d, vec)
                                    : make_uint4(0u, 0u, 0u, 0u);
        float x[8];
        mx_unpack8(chunk, x);
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
      if (t % LPR == 0 && (!wide || r < span))
#pragma unroll
        for (int gg = 0; gg < MAXG; ++gg)
          if (gg < G) sc[gg * span + r] = oks[r] ? dots[gg] * scale : NEG_INF;
    }
  }
  __syncthreads();

  // The cluster's max, then its sum, each read from every rank's shared
  // memory in rank order.  A span with no valid slot gives NEG_INF and 0.
  for (int gg = warp; gg < G; gg += NT / 32) {
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
  for (int gg = warp; gg < G; gg += NT / 32) {
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
  for (int task = warp; task < G * nb; task += NT / 32) {
    const int gg = task / nb, i = (task % nb) * 32 + lane;
    float pr = sc[gg * span + i] / glob_sum[gg];
    if (has_fmt) pr = mx_warp_quant(pr, f);
    sc[gg * span + i] = pr;
  }
  bw_wait<0>();
  __syncthreads();

  // Partial PV: four lanes a value column, eight slots of each 32-block a
  // lane (the K cast's layout, so v's cast along S over every slot, valid
  // or not, is mx_quad_quant); a lane walks the span's blocks in order,
  // then the four lanes' sums are added (xor 2, then xor 1).
  for (int it = 0; it < (4 * dv + NT - 1) / NT; ++it) {
    const int j = it * NT + tid, c = j >> 2, qt = j & 3;
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
    for (int i = tid; i < G * dv; i += NT) {
      float o = 0.f;
      dec_gather(cluster, part, i, splits, vals);
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (r < splits) o += vals[r];
      out[((long long)bh * Gt + g0) * dv + i] = __float2bfloat16_rn(o);
    }
  cluster.sync();   // every rank's shared memory lives until rank 0 is done
}

template <int DQ, int DV, typename OutT>
static int fw_launch(const bf16* q, const bf16* k, const bf16* v, void* out,
                     float* lse, int BH, int G, int Tq, int Tk, int d, int dv,
                     int kind, int window, int q_offset, int tile_k, int vec,
                     int has_fmt, const MxFmt& f, float scale,
                     cudaStream_t s) {
  constexpr int smem = FwTile<DQ, DV>::SMEM;
  auto kern = mx_flash_fwd_kernel<DQ, DV, OutT>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  dim3 grid((unsigned)(BH * G), (unsigned)((Tq + FW_BM - 1) / FW_BM),
            (unsigned)((dv + DV - 1) / DV));
  kern<<<grid, FW_THREADS, smem, s>>>(q, k, v, (OutT*)out, lse, G, Tq, Tk, d,
                                      dv, kind, window, q_offset, tile_k, vec,
                                      has_fmt, f, scale);
  return (int)cudaGetLastError();
}

// q (BH,G,Tq,d), k (BH,Tk,d), v (BH,Tk,dv) bf16, contiguous; out
// (BH,G,Tq,dv) bf16, or fp32 with out_fp32; lse (BH,G,Tq) fp32.  In MX
// mode `qkv_hat` is a bf16 scratch of q.numel + k.numel + v.numel
// elements (the cast q, k and v, in that order); unused in bf16 mode.
extern "C" int mx_flash_fwd(const void* q, const void* k, const void* v,
                            void* qkv_hat, void* out, void* lse, int BH,
                            int G, int Tq, int Tk, int d, int dv, int kind,
                            int window, int q_offset, int tile_k,
                            int out_fp32, int has_fmt, int mbits,
                            int min_normal_exp, int e_max, float max_normal,
                            int scale_mode, float scale, void* stream) {
  if (d > FLASH_MAXD || dv > FLASH_MAXDV || d <= 0 || dv <= 0 ||
      tile_k <= 0 || (has_fmt && !qkv_hat))
    return (int)cudaErrorInvalidValue;
  const MxFmt f = mx_fmt(mbits, min_normal_exp, e_max, max_normal,
                         scale_mode);
  cudaStream_t s = (cudaStream_t)stream;
  if (BH <= 0 || G <= 0 || Tq <= 0) return (int)cudaGetLastError();
  const bf16 *qq = (const bf16*)q, *kk = (const bf16*)k, *vv = (const bf16*)v;
  const uintptr_t in_align = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  if (has_fmt && Tk > 0) {
    const long long qrows = (long long)BH * G * Tq, krows = (long long)BH * Tk;
    bf16* qh = (bf16*)qkv_hat;
    bf16* kh = qh + qrows * d;
    bf16* vh = kh + krows * d;
    const int rvec = d % 8 == 0 && in_align % 16 == 0;
    const long long rlanes =
        (qrows + krows) * ((d + 31) / 32) * (rvec ? 4 : 32);
    mx_flash_fwd_cast_rows<<<(unsigned)((rlanes + FW_PREP - 1) / FW_PREP),
                             FW_PREP, 0, s>>>(qq, kk, qh, kh, qrows, krows,
                                              d, rvec, f);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    const int vvec = dv % 8 == 0 && in_align % 16 == 0;
    const long long vlanes = (long long)BH * ((Tk + tile_k - 1) / tile_k)
                             * ((tile_k + 31) / 32)
                             * (vvec ? 4LL * ((dv + 7) / 8) : 32LL * dv);
    mx_flash_fwd_cast_v<<<(unsigned)((vlanes + FW_PREP - 1) / FW_PREP),
                          FW_PREP, 0, s>>>(vv, vh, BH, Tk, dv, tile_k, vvec,
                                           f);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    qq = qh;
    kk = kh;
    vv = vh;
  }
  const uintptr_t align = (uintptr_t)qq | (uintptr_t)kk | (uintptr_t)vv;
  const int vec = d % 8 == 0 && dv % 8 == 0 && align % 16 == 0;
  const int wide = max(d, dv);
  float* ll = (float*)lse;
#define FW_CASE(DQ, DV)                                                     \
  return out_fp32                                                           \
             ? fw_launch<DQ, DV, float>(qq, kk, vv, out, ll, BH, G, Tq, Tk, \
                                        d, dv, kind, window, q_offset,      \
                                        tile_k, vec, has_fmt, f, scale, s)  \
             : fw_launch<DQ, DV, bf16>(qq, kk, vv, out, ll, BH, G, Tq, Tk,  \
                                       d, dv, kind, window, q_offset,       \
                                       tile_k, vec, has_fmt, f, scale, s)
  // recurrentgemma: qk 256, v 256 in chunks of 128 columns
  if (d > 192 || dv > 128) FW_CASE(256, FW_DVC);
  if (d > 128) FW_CASE(192, 128);   // MLA: qk 192 (nope + rope), v 128
  if (wide <= 32) FW_CASE(32, 32);
  if (wide <= 64) FW_CASE(64, 64);
  if (wide <= 96) FW_CASE(96, 96);
  FW_CASE(128, 128);
#undef FW_CASE
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
  G = dec_group(G);
  const long long dvs = (dv + 7) / 8 * 8;
  return (vsm ? 2LL * span * dvs : 0) + 4LL * G * dec_width(d)
         + 4LL * G * span + 4LL * G * dv + 4LL * 4 * MAXG
         + (span + 15) / 16 * 16;
}

// What the kernel takes: V staged when that fits a CTA, else read in place;
// -1 when the shape does not fit the kernel (G, the head dims, a CTA's
// shared memory).  The one place that holds the decode kernels' limits.
extern "C" int mx_decode_smem_bytes(int G, int span, int d, int dv) {
  if (G <= 0 || d <= 0 || dv <= 0 || dv > DEC_MAXDV || span <= 0)
    return -1;
  long long b = dec_smem(G, span, d, dv, 1);
  if (b > DEC_MAX_SMEM) b = dec_smem(G, span, d, dv, 0);
  return b > DEC_MAX_SMEM ? -1 : (int)b;
}

template <int LPR, bool PAGED, int NT>
static int decode_cluster(const void* q, const void* k, const void* v,
                          const void* valid, void* out, int BH, int G, int S,
                          int splits, int span, int d, int dv, int H,
                          const DecRows& rows, long long valid_sb, int vec,
                          int vsm, int has_fmt, const MxFmt& f, float scale,
                          int smem, cudaStream_t s) {
  auto kern = mx_decode_kernel<LPR, PAGED, NT>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)BH, (unsigned)splits,
                     (unsigned)((G + dec_group(G) - 1) / dec_group(G)));
  cfg.blockDim = dim3(NT, 1, 1);
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
#define DEC_CASE(LPR, NT)                                                   \
  return decode_cluster<LPR, PAGED, NT>(q, k, v, valid, out, BH, G, S,      \
                                        splits, span, d, dv, H, rows,       \
                                        valid_sb, vec, vsm, has_fmt, f,     \
                                        scale, smem, s)
  if (G > MAXG) switch (dec_lanes(d)) {
    case 4: DEC_CASE(4, DEC_WIDE_THREADS);
    case 8: DEC_CASE(8, DEC_WIDE_THREADS);
    case 16: DEC_CASE(16, DEC_WIDE_THREADS);
    default: DEC_CASE(32, DEC_WIDE_THREADS);
  }
  switch (dec_lanes(d)) {
    case 4: DEC_CASE(4, DEC_THREADS);
    case 8: DEC_CASE(8, DEC_THREADS);
    case 16: DEC_CASE(16, DEC_THREADS);
    default: DEC_CASE(32, DEC_THREADS);
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
