// MX GEMM: C (M, N) = Q(A) (M, K) @ Q(B) (K, N), bf16 in and out.
//
// Replaces: `mx_matmul_pallas` (src/repro/kernels/mx_matmul.py:63, the
//   pallas_call at :88), tile body `_mx_mm_kernel` (:40-58).
// Bound: on the serve path, bytes.  Decode multiplies a few rows by every
//   weight matrix (M = max_batch), so the time is reading B once; prefill
//   at M <= 512 rows and K, N <= 2048 is still far below the ~295 bf16
//   operations per byte where the H100's tensor cores would bound it.
// Design: quantize on load.  A K-tile is BK = 32 deep, exactly one MX block:
//   each warp quantizes rows of the A tile with lanes along K (coalesced
//   reads, shuffle max), and the B tile is staged raw in shared memory and
//   quantized one column per warp step with lane = k (b's 32-blocks run
//   down K).  Dequantized MX values are exact in bf16 (mx.py:119-124), so the
//   product runs on the tensor cores through WMMA m16n16k16 bf16 fragments
//   with fp32 accumulation, and C is rounded to bf16 once.  K need not be
//   a multiple of 32: the last K-tile is zero-padded, as `block_reshape`
//   pads.  Rows past M are neither loaded nor quantized, which matters at
//   decode (M = 4 of a 64-row tile).  When the output tiles are too few to
//   fill the card (decode: N = 512 gives 8 tiles), K is split across CTAs:
//   each writes its fp32 partial to a workspace and a second kernel sums
//   the splits in a fixed order and rounds to bf16 once, so the result is
//   deterministic.  Simple by intent: no cp.async, TMA or wgmma pipeline
//   yet, and the weight is re-quantized on every call as in the reference.
#include <mma.h>

#include "mx_quant.cuh"

using namespace nvcuda;

namespace {
constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDA = BK + 8;   // bf16 leading dims: multiples of 8 for WMMA
constexpr int LDB = BK + 8;   // B tile stored column-major (k fastest)
constexpr int LDC = BN + 4;   // fp32 leading dim: multiple of 4
constexpr int THREADS = 128;  // 4 warps, each a 32 x 32 sub-tile
}  // namespace

// One (BM x BN) output tile over k-tiles [kt0, kt1).  With `part` set the
// fp32 sums go to part[(split * M + m) * N + n]; else C gets bf16.
__global__ void __launch_bounds__(THREADS)
mx_matmul_kernel(const __nv_bfloat16* __restrict__ A,
                 const __nv_bfloat16* __restrict__ B,
                 __nv_bfloat16* __restrict__ C, float* __restrict__ part,
                 int M, int N, int K, int kt_per_split, int has_a, MxFmt fa,
                 int has_b, MxFmt fb) {
  __shared__ __align__(32) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(32) __nv_bfloat16 Bs[BN * LDB];
  __shared__ __align__(32) float Bf[BK * (BN + 1)];
  __shared__ __align__(32) float Cs[BM * LDC];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int kt0 = blockIdx.z * kt_per_split;
  const int kt1 = min(kt0 + kt_per_split, (K + BK - 1) / BK);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    // A tile: warp w owns rows 16w..16w+15, lane = k within the MX block.
    const int ka = k0 + lane;
#pragma unroll 4
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      const int gm = m0 + r;
      float v = 0.f;
      if (gm < M) {   // warp-uniform: rows past M stay zero
        v = ka < K ? __bfloat162float(A[(long long)gm * K + ka]) : 0.f;
        if (has_a) v = mx_warp_quant(v, fa);
      }
      As[r * LDA + lane] = __float2bfloat16_rn(v);
    }
    // B tile: coalesced raw staging, then warp w quantizes columns
    // 16w..16w+15 with lane = k (b's MX blocks run down K).
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int kk = i / BN, nn = i % BN;
      const int gk = k0 + kk, gn = n0 + nn;
      Bf[kk * (BN + 1) + nn] =
          (gk < K && gn < N) ? __bfloat162float(B[(long long)gk * N + gn])
                             : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = warp * 16; c < warp * 16 + 16; ++c) {
      float v = Bf[lane * (BN + 1) + c];
      if (has_b) v = mx_warp_quant(v, fb);
      Bs[c * LDB + lane] = __float2bfloat16_rn(v);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa_[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fb_[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa_[i], As + (wm + 16 * i) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb_[j], Bs + (wn + 16 * j) * LDB + kk, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa_[i], fb_[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * LDC + wn + 16 * j,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) {
      if (part)
        part[((long long)blockIdx.z * M + gm) * N + gn] = Cs[r * LDC + c];
      else
        C[(long long)gm * N + gn] = __float2bfloat16_rn(Cs[r * LDC + c]);
    }
  }
}

// C = bf16(sum over splits of part), summed in split order.
__global__ void mx_matmul_reduce_kernel(const float* __restrict__ part,
                                        __nv_bfloat16* __restrict__ C,
                                        long long MN, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[z * MN + i];
  C[i] = __float2bfloat16_rn(s);
}

// Number of K splits for an (M, N, K) product: enough CTAs to cover the
// card twice over, at least one k-tile per split.  `workspace` must hold
// splits * M * N floats when splits > 1.
extern "C" int mx_matmul_splits(int M, int N, int K) {
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int ktiles = (K + BK - 1) / BK;
  if (ktiles == 0) return 1;
  int splits = (264 + tiles - 1) / tiles;
  splits = max(1, min(splits, ktiles));
  const int per = (ktiles + splits - 1) / splits;
  return (ktiles + per - 1) / per;   // no empty split
}

extern "C" int mx_matmul_bf16(const void* a, const void* b, void* c,
                              void* workspace, int M, int N, int K,
                              int has_a, int a_mbits, int a_min_normal_exp,
                              int a_e_max, float a_max_normal, int has_b,
                              int b_mbits, int b_min_normal_exp, int b_e_max,
                              float b_max_normal, void* stream) {
  const MxFmt fa = mx_fmt(a_mbits, a_min_normal_exp, a_e_max, a_max_normal);
  const MxFmt fb = mx_fmt(b_mbits, b_min_normal_exp, b_e_max, b_max_normal);
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  const int splits = mx_matmul_splits(M, N, K);
  const int ktiles = (K + BK - 1) / BK;
  const int per = splits > 0 ? (ktiles + splits - 1) / splits : 0;
  if (splits > 1 && workspace == nullptr) return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  mx_matmul_kernel<<<grid, THREADS, 0, s>>>(
      (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (__nv_bfloat16*)c,
      splits > 1 ? (float*)workspace : nullptr, M, N, K, max(per, 1), has_a,
      fa, has_b, fb);
  if (splits > 1) {
    const long long MN = (long long)M * N;
    mx_matmul_reduce_kernel<<<(unsigned)((MN + 255) / 256), 256, 0, s>>>(
        (const float*)workspace, (__nv_bfloat16*)c, MN, splits);
  }
  return (int)cudaGetLastError();
}
