// MX GEMM backward: dgrad and wgrad of the "dense" contraction.
//
// Replaces: `mx_matmul_dgrad_pallas` (src/repro/kernels/mx_matmul_bwd.py:73,
//   pallas_call at :98; body `_mx_dgrad_kernel` :47-70) and
//   `mx_matmul_wgrad_pallas` (:142, pallas_call at :166; body
//   `_mx_wgrad_kernel` :114-139).
// Bound: operations at the training step's shapes (4096 tokens against
//   512..32000-wide weights is above the H100's ~295 bf16 operations per
//   byte); the lm_head dgrad and wgrad (N = 32000) carry most of them.
// Design: both are the shared quantize-on-load core of mx_gemm.cuh, with
//   each operand read in place in its forward layout and quantized along
//   the GEMM's own contraction axis.
//   * dgrad  dx (M, K) = Q_N(dy) (M, N) @ Q_N(W)^T.  dy is read with lanes
//     along N (contraction-contiguous).  W (K, N) is read through its
//     forward layout: for output column k its contraction run W[k, n0:n0+32]
//     is contiguous, so a warp quantizes it along N with coalesced loads
//     and no transposed copy in HBM.  The forward's quantized W tiles are
//     blocked along K and cannot be reused here.
//   * wgrad  dW (K, N) = Q_T(x)^T (K, T) @ Q_T(dy) (T, N).  A 32-row token
//     tile of x and of dy holds one MX block per column, so both operands
//     are staged raw (coalesced along K or N) and quantized a column per
//     warp step with lane = token.  At T = 4096 a 512 x 512 weight has only
//     64 output tiles, so T is split across CTAs and the fp32 partials are
//     summed in a fixed order by a second pass: no float atomics, so a
//     replayed step gives the same bits.
#include "mx_gemm.cuh"

// Workspace splits of a dgrad (M, K out, N contraction) or a wgrad
// (K, N out, T contraction) product.
extern "C" int mx_matmul_bwd_splits(int rows, int cols, int contraction) {
  return mx_gemm_splits(rows, cols, contraction);
}

// dx (M, K) = Q(dy) (M, N) @ Q(W (K, N))^T, blocks along N.
extern "C" int mx_matmul_dgrad(const void* dy, const void* w, void* dx,
                               void* workspace, int M, int N, int K,
                               int is_fp32, int has_g, int g_mbits,
                               int g_min_normal_exp, int g_e_max,
                               float g_max_normal, int has_w, int w_mbits,
                               int w_min_normal_exp, int w_e_max,
                               float w_max_normal, void* stream) {
  const MxFmt fg = mx_fmt(g_mbits, g_min_normal_exp, g_e_max, g_max_normal);
  const MxFmt fw = mx_fmt(w_mbits, w_min_normal_exp, w_e_max, w_max_normal);
  // Output (M, K); the contraction runs over N, contiguous in both.
  return mx_gemm_launch<true, true>(is_fp32, dy, w, dx, workspace, M, K, N,
                                    N, N, has_g, fg, has_w, fw, stream);
}

// dW (K, N) = Q(x (T, K))^T @ Q(dy (T, N)), blocks along T.
extern "C" int mx_matmul_wgrad(const void* x, const void* dy, void* dw,
                               void* workspace, int T, int K, int N,
                               int is_fp32, int has_a, int a_mbits,
                               int a_min_normal_exp, int a_e_max,
                               float a_max_normal, int has_g, int g_mbits,
                               int g_min_normal_exp, int g_e_max,
                               float g_max_normal, void* stream) {
  const MxFmt fa = mx_fmt(a_mbits, a_min_normal_exp, a_e_max, a_max_normal);
  const MxFmt fg = mx_fmt(g_mbits, g_min_normal_exp, g_e_max, g_max_normal);
  // Output (K, N); the contraction runs over T, strided in both.
  return mx_gemm_launch<false, false>(is_fp32, x, dy, dw, workspace, K, N,
                                      T, K, N, has_a, fa, has_g, fg, stream);
}
