// MX GEMM core of the forward kernel (mx_matmul.cu) alone; the dgrad and
// wgrad kernels run on mx_gemm_sm90.cuh, which the forward joins next:
//   C (M, N) = Q(A) (M, Kc) @ Q(B) (Kc, N), blocks along the contraction Kc.
//
// Replaces: the tile body `_mx_mm_kernel` (src/repro/kernels/mx_matmul.py:
//   40-58).
// Bound: by the card's bytes at the serve path's small M; by operations at
//   the training step's 4096 tokens (a 4096 x 512 x 2048 product does about
//   370 operations per byte it must move, above the H100's ~295).
// Design: quantize on load.  A contraction tile is BK = 32 deep, exactly one
//   MX block, so quantize-on-load needs no state across tiles and the blocks
//   are aligned to index 0 of the contraction axis, as `block_reshape` pads.
//   Each operand is read in place in one of two layouts, chosen at compile
//   time: contraction-contiguous (p[i * ld + kc]: a warp quantizes a row
//   with lanes along kc, coalesced) or contraction-strided (p[kc * ld + i]:
//   the 32 x 64 tile is staged raw with coalesced reads, then a warp
//   quantizes one column per step with lane = kc).  So the forward reads a
//   (M, K) and b (K, N) as they lie.  Dequantized MX values are
//   exact in bf16 (mx.py:119-124), and so are raw bf16 operands, so the
//   product runs on the tensor cores through WMMA m16n16k16 bf16 fragments
//   with fp32 accumulation; an fp32 operand must be quantized for this to
//   hold (the wrappers check).  C is rounded once to the operand type.
//   When the output tiles are too few to fill the card, Kc is split across
//   CTAs: each writes its fp32 partial to a workspace and a second kernel
//   sums the splits in a fixed order, so a replayed step is bitwise the
//   same (no atomics).  Simple by intent: no cp.async, TMA or wgmma yet.
#pragma once

#include <mma.h>

#include "mx_quant.cuh"

namespace mxg {
constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDS = BK + 8;   // bf16 tile leading dim (multiple of 8, WMMA)
constexpr int LDC = BN + 4;   // fp32 leading dim (multiple of 4)
constexpr int THREADS = 128;  // 4 warps, each a 32 x 32 sub-tile
constexpr int STAGE = BK * (BM + 1);

// Stage one 64-wide operand tile into S[i * LDS + kc] (kc fastest), MX
// quantized along kc.  `rows` is the operand's extent along i.
template <typename T, bool KC_CONTIG>
__device__ __forceinline__ void load_tile(const T* __restrict__ p,
                                          long long ld, int i0, int rows,
                                          int k0, int Kc, int has, MxFmt f,
                                          __nv_bfloat16* S, float* stage) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (KC_CONTIG) {
    const int kc = k0 + lane;
#pragma unroll 4
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      const int gi = i0 + r;
      float v = 0.f;
      if (gi < rows) {   // warp-uniform: rows past the edge stay zero
        v = kc < Kc ? mx_load<T>(p + (long long)gi * ld + kc) : 0.f;
        if (has) v = mx_warp_quant(v, f);
      }
      S[r * LDS + lane] = __float2bfloat16_rn(v);
    }
  } else {
    for (int idx = tid; idx < BK * BM; idx += THREADS) {
      const int kk = idx / BM, ii = idx % BM;
      const int gk = k0 + kk, gi = i0 + ii;
      stage[kk * (BM + 1) + ii] =
          (gk < Kc && gi < rows) ? mx_load<T>(p + (long long)gk * ld + gi)
                                 : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = warp * 16; c < warp * 16 + 16; ++c) {
      float v = stage[lane * (BM + 1) + c];
      if (has) v = mx_warp_quant(v, f);
      S[c * LDS + lane] = __float2bfloat16_rn(v);
    }
  }
}
}  // namespace mxg

// One (BM x BN) output tile over contraction tiles [kt0, kt1).  With `part`
// set the fp32 sums go to part[(split * M + m) * N + n]; else C gets T.
template <typename T, bool A_CONTIG, bool B_CONTIG>
__global__ void __launch_bounds__(mxg::THREADS)
mx_gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
               T* __restrict__ C, float* __restrict__ part, int M, int N,
               int Kc, long long lda, long long ldb, int kt_per_split,
               int has_a, MxFmt fa, int has_b, MxFmt fb) {
  using namespace mxg;
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 As[BM * LDS];
  __shared__ __align__(32) __nv_bfloat16 Bs[BN * LDS];
  // Raw staging for the strided operands, reused for the fp32 epilogue.
  __shared__ __align__(32) float scratch[(2 * STAGE > BM * LDC) ? 2 * STAGE
                                                                : BM * LDC];
  float* stage_a = scratch;
  float* stage_b = scratch + STAGE;
  float* Cs = scratch;

  const int warp = threadIdx.x >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int kt0 = blockIdx.z * kt_per_split;
  const int kt1 = min(kt0 + kt_per_split, (Kc + BK - 1) / BK);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    load_tile<T, A_CONTIG>(A, lda, m0, M, k0, Kc, has_a, fa, As, stage_a);
    load_tile<T, B_CONTIG>(B, ldb, n0, N, k0, Kc, has_b, fb, Bs, stage_b);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa_[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fb_[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa_[i], As + (wm + 16 * i) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb_[j], Bs + (wn + 16 * j) * LDS + kk, LDS);
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
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) {
      if (part)
        part[((long long)blockIdx.z * M + gm) * N + gn] = Cs[r * LDC + c];
      else
        mx_store<T>(C + (long long)gm * N + gn, Cs[r * LDC + c]);
    }
  }
}

// C = T(sum over splits of part), summed in split order.
template <typename T>
__global__ void mx_gemm_reduce_kernel(const float* __restrict__ part,
                                      T* __restrict__ C, long long MN,
                                      int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[z * MN + i];
  mx_store<T>(C + i, s);
}

// Number of contraction splits for an (M, N, Kc) product: enough CTAs to
// cover the card twice over, at least one k-tile per split, none empty.
static inline int mx_gemm_splits(int M, int N, int Kc) {
  using namespace mxg;
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int ktiles = (Kc + BK - 1) / BK;
  if (ktiles == 0) return 1;
  int splits = (264 + tiles - 1) / tiles;
  splits = max(1, min(splits, ktiles));
  const int per = (ktiles + splits - 1) / splits;
  return (ktiles + per - 1) / per;
}

// Launch C = Q(A) @ Q(B) with operands of type T; `workspace` must hold
// splits * M * N floats when mx_gemm_splits(M, N, Kc) > 1.  Returns the CUDA
// error code.
template <typename T, bool A_CONTIG, bool B_CONTIG>
static int mx_gemm_launch_t(const void* a, const void* b, void* c,
                            void* workspace, int M, int N, int Kc,
                            long long lda, long long ldb, int has_a,
                            MxFmt fa, int has_b, MxFmt fb, void* stream) {
  using namespace mxg;
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  const int splits = mx_gemm_splits(M, N, Kc);
  const int ktiles = (Kc + BK - 1) / BK;
  const int per = max((ktiles + splits - 1) / splits, 1);
  if (splits > 1 && workspace == nullptr) return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  mx_gemm_kernel<T, A_CONTIG, B_CONTIG><<<grid, THREADS, 0, s>>>(
      (const T*)a, (const T*)b, (T*)c,
      splits > 1 ? (float*)workspace : nullptr, M, N, Kc, lda, ldb, per,
      has_a, fa, has_b, fb);
  if (splits > 1) {
    const long long MN = (long long)M * N;
    mx_gemm_reduce_kernel<T><<<(unsigned)((MN + 255) / 256), 256, 0, s>>>(
        (const float*)workspace, (T*)c, MN, splits);
  }
  return (int)cudaGetLastError();
}

// The same, with the operand type (bf16 or fp32) as a flag.
template <bool A_CONTIG, bool B_CONTIG>
static int mx_gemm_launch(int is_fp32, const void* a, const void* b, void* c,
                          void* workspace, int M, int N, int Kc,
                          long long lda, long long ldb, int has_a, MxFmt fa,
                          int has_b, MxFmt fb, void* stream) {
  return is_fp32
             ? mx_gemm_launch_t<float, A_CONTIG, B_CONTIG>(
                   a, b, c, workspace, M, N, Kc, lda, ldb, has_a, fa, has_b,
                   fb, stream)
             : mx_gemm_launch_t<__nv_bfloat16, A_CONTIG, B_CONTIG>(
                   a, b, c, workspace, M, N, Kc, lda, ldb, has_a, fa, has_b,
                   fb, stream);
}
