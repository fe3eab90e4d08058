// MX flash attention backward: (dq, dk, dv) from (q, k, v, dout, out, lse).
//
// Replaces: `mx_attn_bwd_pallas` (src/repro/kernels/mx_attention.py:275,
//   pallas_calls at :306 and :326), with its dQ pass `_mx_attn_dq_kernel`
//   (:216) over kv tiles and its dK/dV pass `_mx_attn_dkv_kernel` (:242)
//   over q tiles with per-g partials summed over G in the wrapper; the
//   oracle is `mx_flash_attention_bwd_ref` (src/repro/kernels/ref.py:226).
// Bound: operations at the training shapes (BH 64, T 512, d 64 causal:
//   ~4 GFLOP of score, dp and gradient products against ~20 MB moved).
//   This first kernel runs them on the fp32 pipes: every gradient product
//   has an fp32 operand (p or ds) that is not exact in bf16, so they cannot
//   go to the bf16 tensor cores as they are.
// Design: three launches per call.
//   * delta = sum(dout * out) in fp32, a warp per query row.
//   * dQ: one CTA per (bh, g, 16 query rows), 4 warps x 4 rows, lane = kv
//     row of a 32-row kv block.  For each live kv block it recomputes
//     p = exp(s - lse) from the *quantized* scores (q and k blocked along d,
//     the forward's cast) and ds = p * (dp - delta) * scale with dp from raw
//     v, and accumulates dq += ds @ k with raw k (straight-through).
//   * dK/dV: one CTA per (bh, 16 kv rows), lane = query row of a 32-row q
//     block.  The CTA loops over g and over the live q blocks inside
//     itself, so the G reduction of dk and dv needs no atomics:
//     dv += p^T dout (raw p), dk += ds^T q (raw q).
//   The backward quantizes nothing along the kv axis, so no tile of the
//   reference shapes its numbers and the kernel picks its own: 32-row
//   blocks, skipped when the AttnSpec mask (causal, full, window, with
//   q_offset) rules out every position of the CTA's rows, which equals
//   computing them (p = 0 there).  Rows past Tq or Tk (a ragged last tile)
//   are neither loaded nor stored.  bf16 mode (no format) uses the raw
//   operands for the scores.  Grads are written in bf16, or in fp32 when
//   asked (the card check compares before the cast).
#include <math.h>

#include "mx_quant.cuh"

namespace {
constexpr int BW_WARPS = 4;
constexpr int BW_RPW = 4;                     // rows per warp
constexpr int BW_ROWS = BW_WARPS * BW_RPW;    // rows per CTA
constexpr float NEG_INF = -1e30f;
enum { KIND_CAUSAL = 0, KIND_FULL = 1, KIND_WINDOW = 2 };
}  // namespace

__device__ __forceinline__ bool bw_valid(int kind, int window, int qpos,
                                         int kpos) {
  bool ok = true;
  if (kind != KIND_FULL) ok = qpos >= kpos;
  if (kind == KIND_WINDOW) ok = ok && kpos > qpos - window;
  return ok;
}

// Whether any (q position in [qa, qb], k position in [ka, kb]) is valid.
__device__ __forceinline__ bool bw_live(int kind, int window, int qa, int qb,
                                        int ka, int kb) {
  if (kind == KIND_FULL) return true;
  if (ka > qb) return false;                              // all above diag
  if (kind == KIND_WINDOW && kb <= qa - window) return false;
  return true;
}

// Load `n` rows of width `w` (row stride `ld` elements) into S (row stride
// `lds`), zero past `valid_rows`, MX-quantizing each row along its width
// when `quant` is set (a warp per row, lanes along the width).
__device__ __forceinline__ void bw_load_rows(
    const __nv_bfloat16* __restrict__ p, long long ld, int n, int valid_rows,
    int w, float* S, int lds, bool quant, const MxFmt& f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < n; r += BW_WARPS)
    for (int c0 = 0; c0 < w; c0 += 32) {
      const int c = c0 + lane;
      float x = (r < valid_rows && c < w)
                    ? __bfloat162float(p[(long long)r * ld + c]) : 0.f;
      if (quant) x = mx_warp_quant(x, f);
      if (c < w) S[r * lds + c] = x;
    }
}

__global__ void mx_attn_bwd_delta_kernel(const __nv_bfloat16* __restrict__ dout,
                                         const __nv_bfloat16* __restrict__ out,
                                         float* __restrict__ delta,
                                         long long rows, int dv) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5)
                        + (threadIdx.x >> 5);
  if (row >= rows) return;   // whole warp exits together
  float s = 0.f;
  for (int c = lane; c < dv; c += 32)
    s += __bfloat162float(dout[row * dv + c])
         * __bfloat162float(out[row * dv + c]);
  s = mx_warp_sum(s);
  if (lane == 0) delta[row] = s;
}

template <int NL, typename OutT>
__global__ void __launch_bounds__(BW_WARPS * 32)
mx_attn_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, OutT* __restrict__ dq,
                      int G, int Tq, int Tk, int d, int dv, int kind,
                      int window, int q_offset, int has_fmt, MxFmt f,
                      float scale) {
  extern __shared__ float sm[];
  float* qs = sm;                     // [16][d]   scores operand
  float* dos = qs + BW_ROWS * d;      // [16][dv]
  float* ks = dos + BW_ROWS * dv;     // [32][d+1] scores operand
  float* kr = ks + 32 * (d + 1);      // [32][d+1] raw k
  float* vs = kr + 32 * (d + 1);      // [32][dv+1] raw v
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.z, g = blockIdx.y, r0 = blockIdx.x * BW_ROWS;
  const long long row0 = ((long long)bh * G + g) * Tq + r0;
  const int nrows = min(BW_ROWS, Tq - r0);
  const __nv_bfloat16* kb = k + (long long)bh * Tk * d;
  const __nv_bfloat16* vb = v + (long long)bh * Tk * dv;

  bw_load_rows(q + row0 * d, d, BW_ROWS, nrows, d, qs, d, has_fmt, f);
  bw_load_rows(dout + row0 * dv, dv, BW_ROWS, nrows, dv, dos, dv, false, f);
  float lse_r[BW_RPW], dl_r[BW_RPW], acc[BW_RPW][NL];
#pragma unroll
  for (int rr = 0; rr < BW_RPW; ++rr) {
    const int r = warp * BW_RPW + rr;
    lse_r[rr] = r < nrows ? lse[row0 + r] : 0.f;
    dl_r[rr] = r < nrows ? delta[row0 + r] : 0.f;
#pragma unroll
    for (int c = 0; c < NL; ++c) acc[rr][c] = 0.f;
  }
  const int qa = r0 + q_offset, qb = r0 + nrows - 1 + q_offset;

  for (int bs = 0; bs < Tk; bs += 32) {
    const int nk = min(32, Tk - bs);
    if (!bw_live(kind, window, qa, qb, bs, bs + nk - 1)) continue;
    __syncthreads();   // the previous block's reads are done
    bw_load_rows(kb + (long long)bs * d, d, 32, nk, d, ks, d + 1, has_fmt,
                 f);
    if (has_fmt)
      bw_load_rows(kb + (long long)bs * d, d, 32, nk, d, kr, d + 1, false,
                   f);
    bw_load_rows(vb + (long long)bs * dv, dv, 32, nk, dv, vs, dv + 1, false,
                 f);
    __syncthreads();
    const float* kraw = has_fmt ? kr : ks;
#pragma unroll
    for (int rr = 0; rr < BW_RPW; ++rr) {
      const int r = warp * BW_RPW + rr;
      if (r >= nrows) continue;   // warp-uniform
      const bool ok = lane < nk &&
                      bw_valid(kind, window, r0 + r + q_offset, bs + lane);
      float dot = 0.f, dp = 0.f;
      for (int t = 0; t < d; ++t) dot = fmaf(qs[r * d + t], ks[lane * (d + 1) + t], dot);
      for (int c = 0; c < dv; ++c) dp = fmaf(dos[r * dv + c], vs[lane * (dv + 1) + c], dp);
      const float p = ok ? expf(dot * scale - lse_r[rr]) : 0.f;
      const float ds = p * (dp - dl_r[rr]) * scale;
      for (int j = 0; j < 32; ++j) {
        const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int c = 0; c < NL; ++c) {
          const int col = lane + 32 * c;
          if (col < d) acc[rr][c] = fmaf(dsj, kraw[j * (d + 1) + col], acc[rr][c]);
        }
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < BW_RPW; ++rr) {
    const int r = warp * BW_RPW + rr;
    if (r >= nrows) continue;
#pragma unroll
    for (int c = 0; c < NL; ++c) {
      const int col = lane + 32 * c;
      if (col < d) mx_store<OutT>(dq + (row0 + r) * d + col, acc[rr][c]);
    }
  }
}

template <int NL, typename OutT>
__global__ void __launch_bounds__(BW_WARPS * 32)
mx_attn_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       OutT* __restrict__ dk, OutT* __restrict__ dvo, int G,
                       int Tq, int Tk, int d, int dv, int kind, int window,
                       int q_offset, int has_fmt, MxFmt f, float scale) {
  extern __shared__ float sm[];
  float* kq = sm;                      // [16][d]   scores operand
  float* vr = kq + BW_ROWS * d;        // [16][dv]  raw v
  float* qq = vr + BW_ROWS * dv;       // [32][d+1] scores operand
  float* qr = qq + 32 * (d + 1);       // [32][d+1] raw q
  float* dos = qr + 32 * (d + 1);      // [32][dv+1]
  float* lse_s = dos + 32 * (dv + 1);  // [32]
  float* dl_s = lse_s + 32;            // [32]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y, j0 = blockIdx.x * BW_ROWS;
  const int nrows = min(BW_ROWS, Tk - j0);
  const long long krow0 = (long long)bh * Tk + j0;

  bw_load_rows(k + krow0 * d, d, BW_ROWS, nrows, d, kq, d, has_fmt, f);
  bw_load_rows(v + krow0 * dv, dv, BW_ROWS, nrows, dv, vr, dv, false, f);
  float dk_acc[BW_RPW][NL], dv_acc[BW_RPW][NL];
#pragma unroll
  for (int rr = 0; rr < BW_RPW; ++rr)
#pragma unroll
    for (int c = 0; c < NL; ++c) dk_acc[rr][c] = dv_acc[rr][c] = 0.f;
  const int ka = j0, kb = j0 + nrows - 1;

  for (int g = 0; g < G; ++g) {
    const long long qrow0 = ((long long)bh * G + g) * Tq;
    for (int bs = 0; bs < Tq; bs += 32) {
      const int nq = min(32, Tq - bs);
      if (!bw_live(kind, window, bs + q_offset, bs + nq - 1 + q_offset, ka,
                   kb))
        continue;
      __syncthreads();   // the previous block's reads are done
      const __nv_bfloat16* qb = q + (qrow0 + bs) * d;
      bw_load_rows(qb, d, 32, nq, d, qq, d + 1, has_fmt, f);
      if (has_fmt) bw_load_rows(qb, d, 32, nq, d, qr, d + 1, false, f);
      bw_load_rows(dout + (qrow0 + bs) * dv, dv, 32, nq, dv, dos, dv + 1,
                   false, f);
      if (threadIdx.x < 32) {
        lse_s[lane] = lane < nq ? lse[qrow0 + bs + lane] : 0.f;
        dl_s[lane] = lane < nq ? delta[qrow0 + bs + lane] : 0.f;
      }
      __syncthreads();
      const float* qraw = has_fmt ? qr : qq;
#pragma unroll
      for (int rr = 0; rr < BW_RPW; ++rr) {
        const int jr = warp * BW_RPW + rr;
        if (jr >= nrows) continue;   // warp-uniform
        const bool ok = lane < nq &&
                        bw_valid(kind, window, bs + lane + q_offset, j0 + jr);
        float dot = 0.f, dp = 0.f;
        for (int t = 0; t < d; ++t) dot = fmaf(qq[lane * (d + 1) + t], kq[jr * d + t], dot);
        for (int c = 0; c < dv; ++c) dp = fmaf(dos[lane * (dv + 1) + c], vr[jr * dv + c], dp);
        const float p = ok ? expf(dot * scale - lse_s[lane]) : 0.f;
        const float ds = p * (dp - dl_s[lane]) * scale;
        for (int i = 0; i < 32; ++i) {
          const float pi = __shfl_sync(0xffffffffu, p, i);
          const float dsi = __shfl_sync(0xffffffffu, ds, i);
#pragma unroll
          for (int c = 0; c < NL; ++c) {
            const int col = lane + 32 * c;
            if (col < dv) dv_acc[rr][c] = fmaf(pi, dos[i * (dv + 1) + col], dv_acc[rr][c]);
            if (col < d) dk_acc[rr][c] = fmaf(dsi, qraw[i * (d + 1) + col], dk_acc[rr][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < BW_RPW; ++rr) {
    const int jr = warp * BW_RPW + rr;
    if (jr >= nrows) continue;
#pragma unroll
    for (int c = 0; c < NL; ++c) {
      const int col = lane + 32 * c;
      if (col < d) mx_store<OutT>(dk + (krow0 + jr) * d + col, dk_acc[rr][c]);
      if (col < dv) mx_store<OutT>(dvo + (krow0 + jr) * dv + col, dv_acc[rr][c]);
    }
  }
}

static int bw_smem_bytes(int d, int dv) {
  return 4 * (BW_ROWS * d + BW_ROWS * dv + 64 * (d + 1) + 32 * (dv + 1)
              + 64);
}

template <int NL, typename OutT>
static int bw_launch(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const float* delta,
                     void* dq, void* dk, void* dv_, int BH, int G, int Tq,
                     int Tk, int d, int dv, int kind, int window,
                     int q_offset, int has_fmt, MxFmt f, float scale,
                     cudaStream_t s) {
  const int smem = bw_smem_bytes(d, dv);
  auto dq_k = mx_attn_bwd_dq_kernel<NL, OutT>;
  auto dkv_k = mx_attn_bwd_dkv_kernel<NL, OutT>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(dq_k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    cudaFuncSetAttribute(dkv_k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  }
  const __nv_bfloat16* qq = (const __nv_bfloat16*)q;
  const __nv_bfloat16* kk = (const __nv_bfloat16*)k;
  const __nv_bfloat16* vv = (const __nv_bfloat16*)v;
  const __nv_bfloat16* dd = (const __nv_bfloat16*)dout;
  dim3 gq((Tq + BW_ROWS - 1) / BW_ROWS, G, BH);
  dq_k<<<gq, BW_WARPS * 32, smem, s>>>(qq, kk, vv, dd, (const float*)lse,
                                       delta, (OutT*)dq, G, Tq, Tk, d, dv,
                                       kind, window, q_offset, has_fmt, f,
                                       scale);
  dim3 gk((Tk + BW_ROWS - 1) / BW_ROWS, BH);
  dkv_k<<<gk, BW_WARPS * 32, smem, s>>>(qq, kk, vv, dd, (const float*)lse,
                                        delta, (OutT*)dk, (OutT*)dv_, G, Tq,
                                        Tk, d, dv, kind, window, q_offset,
                                        has_fmt, f, scale);
  return (int)cudaGetLastError();
}

// `delta` is a (BH * G * Tq) fp32 scratch; grads are bf16, or fp32 with
// out_fp32.  q (BH,G,Tq,d), k (BH,Tk,d), v (BH,Tk,dv), dout and out
// (BH,G,Tq,dv) bf16, lse (BH,G,Tq) fp32, all contiguous.
extern "C" int mx_flash_bwd(const void* q, const void* k, const void* v,
                            const void* dout, const void* out,
                            const void* lse, void* delta, void* dq, void* dk,
                            void* dv_, int BH, int G, int Tq, int Tk, int d,
                            int dv, int kind, int window, int q_offset,
                            int out_fp32, int has_fmt, int mbits,
                            int min_normal_exp, int e_max, float max_normal,
                            int scale_mode, float scale, void* stream) {
  if (d > 128 || dv > 128 || d <= 0 || dv <= 0)
    return (int)cudaErrorInvalidValue;
  const MxFmt f = mx_fmt(mbits, min_normal_exp, e_max, max_normal,
                         scale_mode);
  cudaStream_t s = (cudaStream_t)stream;
  if (BH <= 0 || G <= 0 || Tq <= 0 || Tk <= 0) return (int)cudaGetLastError();
  const long long rows = (long long)BH * G * Tq;
  mx_attn_bwd_delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      (const __nv_bfloat16*)dout, (const __nv_bfloat16*)out, (float*)delta,
      rows, dv);
  const int nl = (max(d, dv) + 31) / 32;
#define BW_CASE(N)                                                          \
  case N:                                                                   \
    return out_fp32                                                         \
               ? bw_launch<N, float>(q, k, v, dout, lse, (float*)delta, dq, \
                                     dk, dv_, BH, G, Tq, Tk, d, dv, kind,   \
                                     window, q_offset, has_fmt, f, scale,   \
                                     s)                                     \
               : bw_launch<N, __nv_bfloat16>(                               \
                     q, k, v, dout, lse, (float*)delta, dq, dk, dv_, BH, G, \
                     Tq, Tk, d, dv, kind, window, q_offset, has_fmt, f,     \
                     scale, s);
  switch (nl) {
    BW_CASE(1)
    BW_CASE(2)
    BW_CASE(3)
    default:
    BW_CASE(4)
  }
#undef BW_CASE
  return (int)cudaErrorInvalidValue;
}
