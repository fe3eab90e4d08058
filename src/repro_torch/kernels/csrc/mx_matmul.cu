// MX GEMM forward: C (M, N) = Q(A) (M, K) @ Q(B) (K, N), blocks along K.
//
// Replaces: `mx_matmul_pallas` (src/repro/kernels/mx_matmul.py:63, the
//   pallas_call at :88), tile body `_mx_mm_kernel` (:40-58).
// Bound: bytes at small M, where every weight element is read and cast
//   once for a few rows (decode: M = 4..6 rows against each weight; the
//   decode lm_head must read 32.8 MB of W, 9.9 µs at 3.35 TB/s), and
//   operations at the training step's 4096 tokens (a 4096 x 512 x 32000
//   product does ~450 operations per byte it must move, above the H100's
//   ~295 bf16 line).
// Design: two paths, planned by the wrapper (ops.fwd_gemm_plan).
//   * Small M (at most 8 rows): one pass over W with no scratch, in
//     mx_small_m.cuh (the per-thread cast of mx_quant.cuh on registers,
//     A staged quantized in shared memory, fixed-order split sums).
//   * Large M: quantize each operand once, then the pipelined wgmma/TMA
//     product of mx_gemm_sm90.cuh, as the dgrad and wgrad do.  A (M, K)
//     is contraction-contiguous and goes through the rows pre-pass (or to
//     the product in place when it is a raw bf16 operand that TMA can
//     read); B (K, N) has its blocks down its columns and goes through the
//     cols pre-pass, which writes it transposed to (N, depth), exactly as
//     the wgrad's x.  The product's split-K rule and fixed-order second
//     pass fill the card when the output tiles are few.
//   `mx_matmul_lanes` runs the large-M path over L lanes, each with its own
//   A (M, K) and B (K, N) (the lane-stacked proxy of a sweep; the
//   reference vmaps `mx_matmul_pallas` over its lanes): the rows pre-pass
//   walks the L x M rows as one run, the cols pre-pass takes a lane grid
//   axis, and the product's grid z is lane x split (mx_gemm_sm90.cuh).
//   Its plan is the one-lane plan, so each lane equals the 2-D call on
//   its operands bit for bit.  The small-M kernel has no lane axis.
//   No float atomics on either path, so a second call gives equal bits.
//   bf16 operands, or fp32 operands that are both MX-quantized (the
//   proxy's fp32 path: MX values are exact in bf16); C is rounded once to
//   the operand type.  The weight is quantized on every call, as in the
//   reference.  Every launch is checked with cudaGetLastError and its code
//   returned.
#define MX_SM90_NS fwd
#include "mx_gemm_sm90.cuh"

#include "mx_small_m.cuh"

// Large M, lane by lane: A (L, M, K) through the rows pre-pass (or in place
// when aq is null), B (L, K, N) through the cols pre-pass into bq
// (L, N, depth), then the product into c (L, M, N).
template <typename T>
static int large_m(const void* a, const void* b, void* c, void* workspace,
                   void* aq, void* bq, int L, int M, int N, int K, int depth,
                   int splits, int has_a, MxFmt fa, int has_b, MxFmt fb,
                   cudaStream_t s) {
  if (depth < K || !bq) return (int)cudaErrorInvalidValue;
  sm90::Operand A, B;
  int rc = sm90::operand_rows<T>(a, aq, L, M, K, depth, has_a, fa, s, &A);
  if (rc) return rc;
  rc = sm90::operand_cols<T>(b, bq, L, K, N, depth, has_b, fb, s, &B);
  if (rc) return rc;
  return sm90::tn_gemm<T>(A, B, c, workspace, M, N, depth, splits, L, s);
}

// C (M, N) = Q(a (M, K)) @ Q(b (K, N)), blocks along K.  small_m selects
// the path; depth, aq and bq are the large path's scratch (aq may be null
// for a raw bf16 a used in place); workspace holds splits * M * N floats
// when splits > 1.
extern "C" int mx_matmul(const void* a, const void* b, void* c,
                         void* workspace, void* aq, void* bq, int M, int N,
                         int K, int depth, int splits, int small_m_path,
                         int is_fp32, int has_a, int a_mbits,
                         int a_min_normal_exp, int a_e_max,
                         float a_max_normal, int a_scale_mode, int has_b,
                         int b_mbits, int b_min_normal_exp, int b_e_max,
                         float b_max_normal, int b_scale_mode,
                         void* stream) {
  const MxFmt fa = mx_fmt(a_mbits, a_min_normal_exp, a_e_max, a_max_normal,
                          a_scale_mode);
  const MxFmt fb = mx_fmt(b_mbits, b_min_normal_exp, b_e_max, b_max_normal,
                          b_scale_mode);
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  if (small_m_path)
    return is_fp32 ? small_m<float>(a, b, c, workspace, M, N, K, splits,
                                    has_a, fa, has_b, fb, s)
                   : small_m<__nv_bfloat16>(a, b, c, workspace, M, N, K,
                                            splits, has_a, fa, has_b, fb, s);
  return is_fp32 ? large_m<float>(a, b, c, workspace, aq, bq, 1, M, N, K,
                                  depth, splits, has_a, fa, has_b, fb, s)
                 : large_m<__nv_bfloat16>(a, b, c, workspace, aq, bq, 1, M, N,
                                          K, depth, splits, has_a, fa, has_b,
                                          fb, s);
}

// C[l] (M, N) = Q(a[l] (M, K)) @ Q(b[l] (K, N)) for l < L, blocks along K,
// on the large-M path with the one-lane plan (depth, splits); aq
// (L, M, depth) may be null for a raw bf16 a used in place, bq is
// (L, N, depth); workspace holds L * splits * M * N floats when
// splits > 1.
extern "C" int mx_matmul_lanes(const void* a, const void* b, void* c,
                               void* workspace, void* aq, void* bq, int L,
                               int M, int N, int K, int depth, int splits,
                               int is_fp32, int has_a, int a_mbits,
                               int a_min_normal_exp, int a_e_max,
                               float a_max_normal, int a_scale_mode,
                               int has_b, int b_mbits, int b_min_normal_exp,
                               int b_e_max, float b_max_normal,
                               int b_scale_mode, void* stream) {
  const MxFmt fa = mx_fmt(a_mbits, a_min_normal_exp, a_e_max, a_max_normal,
                          a_scale_mode);
  const MxFmt fb = mx_fmt(b_mbits, b_min_normal_exp, b_e_max, b_max_normal,
                          b_scale_mode);
  cudaStream_t s = (cudaStream_t)stream;
  if (L <= 0 || M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  return is_fp32 ? large_m<float>(a, b, c, workspace, aq, bq, L, M, N, K,
                                  depth, splits, has_a, fa, has_b, fb, s)
                 : large_m<__nv_bfloat16>(a, b, c, workspace, aq, bq, L, M, N,
                                          K, depth, splits, has_a, fa, has_b,
                                          fb, s);
}
