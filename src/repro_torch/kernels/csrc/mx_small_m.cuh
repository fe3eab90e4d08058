// The forward MX GEMM's small-M kernel: C (M, N) = Q(A) (M, K) @ Q(B)
// (K, N) for M <= 8 rows, blocks along K, in one pass over B.
//
// Replaces: the tile body `_mx_mm_kernel` (src/repro/kernels/
//   mx_matmul.py:40-58) at the decode shapes, where the Pallas kernel
//   runs one (8, 128)-aligned row tile.
// Bound: bytes.  Every element of B is read and cast once for a few rows
//   of A (decode: 4 or 6 rows against each weight); the decode lm_head
//   must read 32.8 MB of W, 9.9 µs at 3.35 TB/s.  As built, the time is
//   the cast's instructions and the loads' latency, not the bytes
//   (PERF.md).
// Design: a CTA owns 32 columns of B and up to 8 32-row slabs of the
//   contraction, one for each of its 8 warps.  A lane holds one column's
//   32-block of its warp's slab in registers (a warp reads 64 or 128
//   contiguous bytes a row): `mx_thread_quant` (mx_quant.cuh) takes the
//   block's max without shuffles and casts it with the same exponent rule
//   and cast as every other kernel.  One column a lane, not two, keeps
//   the registers at 64-80, so three or four CTAs share an SM and one's
//   loads overlap another's casts.  A warp issues its slab's loads first,
//   so they are in flight while A's rows for the CTA's contraction range
//   are quantized along K (a warp per 32-block, all its loads issued
//   before it casts) into shared memory, K-major, so that one 16-byte
//   broadcast read feeds four rows' fp32 FMAs.  The warps' partial sums
//   are added in warp order through shared memory; a contraction of more
//   than 8 slabs is split across CTAs, each writing an fp32 partial that a
//   second kernel adds in split order.  No atomics: a second call gives
//   equal bits.
#pragma once

#include "mx_quant.cuh"

namespace {
constexpr int SM_COLS = 32;     // W columns of a small-M CTA, one a lane
constexpr int SM_WARPS = 8;     // its warps, each on its own 32-row slab
constexpr int SM_SLABS = 8;     // 32-row slabs of a CTA at most
constexpr int SM_MAX_M = 8;     // rows of the small-M path at most
}  // namespace

// Small M: C (or split blockIdx.y's fp32 partial) for columns
// [32 blockIdx.x, +32) over slabs [per blockIdx.y, +per), per <= 8: warp w
// takes slab w.  MT (4 or 8) rows are computed; rows past M are zeros and
// never stored.
template <typename T, int MT>
__global__ void __launch_bounds__(SM_WARPS * 32)
mx_fwd_small_m_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      T* __restrict__ c, float* __restrict__ part, int M,
                      int N, int K, int per, int has_a, MxFmt fa, int has_b,
                      MxFmt fb) {
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s0 = blockIdx.y * per;
  const int ns = min(per, (K + 31) / 32 - s0);
  const int col = blockIdx.x * SM_COLS + lane;
  const int k0 = (s0 + warp) * 32;
  const bool mine = warp < ns;   // warp-uniform

  // The warp's slab of B: its loads are in flight while A is staged.
  float w[32];   // zeros past K: the partial block's padding
#pragma unroll
  for (int j = 0; j < 32; ++j)
    w[j] = mine && k0 + j < K && col < N
               ? mx_load<T>(b + (long long)(k0 + j) * N + col) : 0.f;

  // xs[k][m]: A's rows over the CTA's slabs, quantized along K, a warp per
  // (row, 32-block) pair (lane = k); a warp issues its loads, then casts.
  constexpr int XI = MT * SM_SLABS / SM_WARPS;
  float* xs = sm;
  float xv[XI];
#pragma unroll
  for (int i = 0; i < XI; ++i) {
    const int p = warp + i * SM_WARPS;
    const int m = p / ns, k = (s0 + p % ns) * 32 + lane;
    xv[i] = p < MT * ns && m < M && k < K
                ? mx_load<T>(a + (long long)m * K + k) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < XI; ++i) {
    const int p = warp + i * SM_WARPS;
    if (p >= MT * ns) break;   // warp-uniform
    const int m = p / ns, s = p % ns;
    const float v = has_a && m < M ? mx_warp_quant(xv[i], fa) : xv[i];
    xs[(s * 32 + lane) * MT + m] = v;
  }
  __syncthreads();

  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;
  if (mine) {
    if (has_b) {
      mx_thread_quant(w, fb);
    }
    const float* xk = xs + warp * 32 * MT;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
#pragma unroll
      for (int m = 0; m < MT; m += 4) {
        const float4 x = *reinterpret_cast<const float4*>(xk + j * MT + m);
        acc[m] = fmaf(x.x, w[j], acc[m]);
        acc[m + 1] = fmaf(x.y, w[j], acc[m + 1]);
        acc[m + 2] = fmaf(x.z, w[j], acc[m + 2]);
        acc[m + 3] = fmaf(x.w, w[j], acc[m + 3]);
      }
    }
  }
  __syncthreads();   // xs is done with; its space takes the warps' sums

  float* red = sm;   // [SM_WARPS][MT][SM_COLS]
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    red[(warp * MT + m) * SM_COLS + lane] = acc[m];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MT * SM_COLS; i += SM_WARPS * 32) {
    const int m = i / SM_COLS, cc = i % SM_COLS;
    const int n = blockIdx.x * SM_COLS + cc;
    if (m >= M || n >= N) continue;
    float sum = 0.f;
    for (int w = 0; w < SM_WARPS; ++w) sum += red[(w * MT + m) * SM_COLS + cc];
    if (part)
      part[((long long)blockIdx.y * M + m) * N + n] = sum;
    else
      mx_store<T>(c + (long long)m * N + n, sum);
  }
}

// C = T(sum over splits of part), summed in split order.
template <typename T>
__global__ void mx_fwd_small_m_reduce_kernel(const float* __restrict__ part,
                                             T* __restrict__ C, long long MN,
                                             int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[z * MN + i];
  mx_store<T>(C + i, s);
}

template <typename T, int MT>
static int small_m_launch(const void* a, const void* b, void* c,
                          float* part, int M, int N, int K, int per,
                          int splits, int has_a, MxFmt fa, int has_b,
                          MxFmt fb, cudaStream_t s) {
  const int floats = max(MT * per * 32, SM_WARPS * MT * SM_COLS);
  dim3 grid((N + SM_COLS - 1) / SM_COLS, splits);
  mx_fwd_small_m_kernel<T, MT><<<grid, SM_WARPS * 32, floats * 4, s>>>(
      (const T*)a, (const T*)b, (T*)c, part, M, N, K, per, has_a, fa, has_b,
      fb);
  return (int)cudaGetLastError();
}

template <typename T>
static int small_m(const void* a, const void* b, void* c, void* workspace,
                   int M, int N, int K, int splits, int has_a, MxFmt fa,
                   int has_b, MxFmt fb, cudaStream_t s) {
  const int slabs = (K + 31) / 32;
  const int per = splits > 0 ? (slabs + splits - 1) / splits : 0;
  if (M > SM_MAX_M || splits < 1 || per > SM_SLABS ||
      (splits - 1) * per >= slabs || (splits > 1 && !workspace))
    return (int)cudaErrorInvalidValue;
  float* part = splits > 1 ? (float*)workspace : nullptr;
  const int rc = M <= 4 ? small_m_launch<T, 4>(a, b, c, part, M, N, K, per,
                                               splits, has_a, fa, has_b, fb,
                                               s)
                        : small_m_launch<T, 8>(a, b, c, part, M, N, K, per,
                                               splits, has_a, fa, has_b, fb,
                                               s);
  if (rc || splits == 1) return rc;
  const long long MN = (long long)M * N;
  mx_fwd_small_m_reduce_kernel<T><<<(unsigned)((MN + 255) / 256), 256, 0,
                                    s>>>(part, (T*)c, MN, splits);
  return (int)cudaGetLastError();
}
