// MX GEMM forward: C (M, N) = Q(A) (M, K) @ Q(B) (K, N), blocks along K.
//
// Replaces: `mx_matmul_pallas` (src/repro/kernels/mx_matmul.py:63, the
//   pallas_call at :88), tile body `_mx_mm_kernel` (:40-58).
// Bound: on the serve path, bytes.  Decode multiplies a few rows by every
//   weight matrix (M = max_batch), so the time is reading B once; prefill
//   at M <= 512 rows and K, N <= 2048 is still far below the ~295 bf16
//   operations per byte where the H100's tensor cores would bound it.  The
//   training step's M = 4096 tokens is above that line (operations).
// Design: the quantize-on-load core of mx_gemm.cuh with A read
//   contraction-contiguous (a warp quantizes a row, lanes along K) and B
//   read contraction-strided (b's 32-blocks run down K: staged raw, then
//   quantized one column per warp step).  Rows past M are neither loaded
//   nor quantized, which matters at decode (M = 4 of a 64-row tile); K
//   need not be a multiple of 32.  Split-K with a fixed-order second-pass
//   sum fills the card at decode (N = 512 gives 8 tiles).  bf16 operands,
//   or fp32 operands that are both MX-quantized (the proxy's fp32 path);
//   the weight is re-quantized on every call as in the reference.
#include "mx_gemm.cuh"

// Number of K splits of a forward product (the wrapper sizes the fp32
// workspace, splits * M * N, from it).
extern "C" int mx_matmul_splits(int M, int N, int K) {
  return mx_gemm_splits(M, N, K);
}

extern "C" int mx_matmul(const void* a, const void* b, void* c,
                         void* workspace, int M, int N, int Kc, int is_fp32,
                         int has_a, int a_mbits, int a_min_normal_exp,
                         int a_e_max, float a_max_normal, int has_b,
                         int b_mbits, int b_min_normal_exp, int b_e_max,
                         float b_max_normal, void* stream) {
  const MxFmt fa = mx_fmt(a_mbits, a_min_normal_exp, a_e_max, a_max_normal);
  const MxFmt fb = mx_fmt(b_mbits, b_min_normal_exp, b_e_max, b_max_normal);
  return mx_gemm_launch<true, false>(is_fp32, a, b, c, workspace, M, N, Kc,
                                     Kc, N, has_a, fa, has_b, fb, stream);
}
