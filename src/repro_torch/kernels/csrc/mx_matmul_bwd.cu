// MX GEMM backward: dgrad and wgrad of the "dense" contraction.
//
// Replaces: `mx_matmul_dgrad_pallas` (src/repro/kernels/mx_matmul_bwd.py:73,
//   pallas_call at :98; body `_mx_dgrad_kernel` :47-70) and
//   `mx_matmul_wgrad_pallas` (:142, pallas_call at :166; body
//   `_mx_wgrad_kernel` :114-139).
// Bound: operations at the training step's shapes (4096 tokens against
//   512..32000-wide weights is above the H100's ~295 bf16 operations per
//   byte); the lm_head dgrad and wgrad (N = 32000) carry most of them.
//   As built, the quantize pre-pass takes 70-76% of the lm_head's time,
//   bound by mx_warp_quant's instructions, not by its bytes (PERF.md).
// Design: quantize each operand once, then one pipelined wgmma/TMA bf16
//   product (mx_gemm_sm90.cuh).  Both GEMMs become "TN" products with
//   both operands contraction-major, the layout wgmma and TMA take as
//   they are:
//   * dgrad  dx (M, K) = Q_N(dy) (M, N) @ Q_N(W)^T.  dy (M, N) and W (K, N)
//     are already contraction-contiguous, so the pre-pass quantizes each
//     in its own layout (one warp per 32-block, coalesced) into a scratch
//     padded along N.  A raw dy (the gradient unquantized, as under
//     e4m3_bf16act) goes to the product in place when TMA can read its
//     rows, with no copy.
//   * wgrad  dW (K, N) = Q_T(x)^T @ Q_T(dy).  Both operands block along T,
//     the strided axis: the pre-pass reads 64-token x 64-column tiles of x
//     (T, K) and dy (T, N), quantizes each column's 32-blocks and writes
//     the tiles transposed, xq^T (K, T) and dyq^T (N, T).
//   The wrapper allocates the scratch operands and plans the contraction
//   splits (ops.bwd_gemm_plan); when there are splits, the fp32 partials
//   are summed in a fixed order by a second pass: no float atomics, so a
//   replayed step gives the same bits.  Every launch is checked with
//   cudaGetLastError and its code returned.
#define MX_SM90_NS bwd
#include "mx_gemm_sm90.cuh"

// dx (M, K) = Q(dy) (M, N) @ Q(W (K, N))^T, blocks along N.  dyq (M, depth)
// may be null for a raw bf16 dy used in place; wq (K, depth) may be null
// for a raw bf16 W.
extern "C" int mx_matmul_dgrad(const void* dy, const void* w, void* dx,
                               void* workspace, void* dyq, void* wq, int M,
                               int N, int K, int depth, int splits,
                               int is_fp32, int has_g, int g_mbits,
                               int g_min_normal_exp, int g_e_max,
                               float g_max_normal, int g_scale_mode,
                               int has_w, int w_mbits, int w_min_normal_exp,
                               int w_e_max, float w_max_normal,
                               int w_scale_mode, void* stream) {
  const MxFmt fg = mx_fmt(g_mbits, g_min_normal_exp, g_e_max, g_max_normal,
                          g_scale_mode);
  const MxFmt fw = mx_fmt(w_mbits, w_min_normal_exp, w_e_max, w_max_normal,
                          w_scale_mode);
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 0 || N <= 0 || K <= 0 || depth < N)
    return (int)cudaErrorInvalidValue;
  sm90::Operand a, b;
  int rc = is_fp32
               ? sm90::operand_rows<float>(dy, dyq, M, N, depth, has_g, fg,
                                           s, &a)
               : sm90::operand_rows<__nv_bfloat16>(dy, dyq, M, N, depth,
                                                   has_g, fg, s, &a);
  if (rc) return rc;
  rc = is_fp32 ? sm90::operand_rows<float>(w, wq, K, N, depth, has_w, fw, s,
                                           &b)
               : sm90::operand_rows<__nv_bfloat16>(w, wq, K, N, depth, has_w,
                                                   fw, s, &b);
  if (rc) return rc;
  // Output (M, K); the contraction runs over N.
  return is_fp32 ? sm90::tn_gemm<float>(a, b, dx, workspace, M, K, depth,
                                        splits, s)
                 : sm90::tn_gemm<__nv_bfloat16>(a, b, dx, workspace, M, K,
                                                depth, splits, s);
}

// dW (K, N) = Q(x (T, K))^T @ Q(dy (T, N)), blocks along T.  xq (K, depth)
// and dyq (N, depth) receive the transposed operands.
extern "C" int mx_matmul_wgrad(const void* x, const void* dy, void* dw,
                               void* workspace, void* xq, void* dyq, int T,
                               int K, int N, int depth, int splits,
                               int is_fp32, int has_a, int a_mbits,
                               int a_min_normal_exp, int a_e_max,
                               float a_max_normal, int a_scale_mode,
                               int has_g, int g_mbits, int g_min_normal_exp,
                               int g_e_max, float g_max_normal,
                               int g_scale_mode, void* stream) {
  const MxFmt fa = mx_fmt(a_mbits, a_min_normal_exp, a_e_max, a_max_normal,
                          a_scale_mode);
  const MxFmt fg = mx_fmt(g_mbits, g_min_normal_exp, g_e_max, g_max_normal,
                          g_scale_mode);
  cudaStream_t s = (cudaStream_t)stream;
  if (T <= 0 || K <= 0 || N <= 0 || depth < T)
    return (int)cudaErrorInvalidValue;
  sm90::Operand a, b;
  int rc = is_fp32
               ? sm90::operand_cols<float>(x, xq, T, K, depth, has_a, fa, s,
                                           &a)
               : sm90::operand_cols<__nv_bfloat16>(x, xq, T, K, depth, has_a,
                                                   fa, s, &a);
  if (rc) return rc;
  rc = is_fp32 ? sm90::operand_cols<float>(dy, dyq, T, N, depth, has_g, fg,
                                           s, &b)
               : sm90::operand_cols<__nv_bfloat16>(dy, dyq, T, N, depth,
                                                   has_g, fg, s, &b);
  if (rc) return rc;
  // Output (K, N); the contraction runs over T.
  return is_fp32 ? sm90::tn_gemm<float>(a, b, dw, workspace, K, N, depth,
                                        splits, s)
                 : sm90::tn_gemm<__nv_bfloat16>(a, b, dw, workspace, K, N,
                                                depth, splits, s);
}
