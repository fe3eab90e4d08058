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
//   `mx_matmul_dgrad_lanes` and `mx_matmul_wgrad_lanes` run both over L
//   lanes, each with its own operands (the lane-stacked proxy of a sweep;
//   the reference vmaps the two Pallas kernels over its lanes): the rows
//   pre-pass walks the L lanes' rows as one run, the cols pre-pass takes a
//   lane grid axis, the product's grid z is lane x split, and the plan is
//   the one-lane plan, so each lane equals the 2-D call bit for bit.
//   The wrapper allocates the scratch operands and plans the contraction
//   splits (ops.bwd_gemm_plan); when there are splits, the fp32 partials
//   are summed in a fixed order by a second pass: no float atomics, so a
//   replayed step gives the same bits.  Every launch is checked with
//   cudaGetLastError and its code returned.
#define MX_SM90_NS bwd
#include "mx_gemm_sm90.cuh"

// dx[l] (M, K) = Q(dy[l]) (M, N) @ Q(W[l] (K, N))^T, blocks along N, for
// l < L.  dyq (L, M, depth) may be null for a raw bf16 dy used in place;
// wq (L, K, depth) may be null for a raw bf16 W.
template <typename T>
static int dgrad(const void* dy, const void* w, void* dx, void* workspace,
                 void* dyq, void* wq, int L, int M, int N, int K, int depth,
                 int splits, int has_g, MxFmt fg, int has_w, MxFmt fw,
                 cudaStream_t s) {
  if (L <= 0 || M <= 0 || N <= 0 || K <= 0 || depth < N)
    return (int)cudaErrorInvalidValue;
  sm90::Operand a, b;
  int rc = sm90::operand_rows<T>(dy, dyq, L, M, N, depth, has_g, fg, s, &a);
  if (rc) return rc;
  rc = sm90::operand_rows<T>(w, wq, L, K, N, depth, has_w, fw, s, &b);
  if (rc) return rc;
  // Output (M, K) a lane; the contraction runs over N.
  return sm90::tn_gemm<T>(a, b, dx, workspace, M, K, depth, splits, L, s);
}

// dW[l] (K, N) = Q(x[l] (T, K))^T @ Q(dy[l] (T, N)), blocks along T, for
// l < L.  xq (L, K, depth) and dyq (L, N, depth) receive the transposed
// operands.
template <typename T>
static int wgrad(const void* x, const void* dy, void* dw, void* workspace,
                 void* xq, void* dyq, int L, int T_, int K, int N, int depth,
                 int splits, int has_a, MxFmt fa, int has_g, MxFmt fg,
                 cudaStream_t s) {
  if (L <= 0 || T_ <= 0 || K <= 0 || N <= 0 || depth < T_)
    return (int)cudaErrorInvalidValue;
  sm90::Operand a, b;
  int rc = sm90::operand_cols<T>(x, xq, L, T_, K, depth, has_a, fa, s, &a);
  if (rc) return rc;
  rc = sm90::operand_cols<T>(dy, dyq, L, T_, N, depth, has_g, fg, s, &b);
  if (rc) return rc;
  // Output (K, N) a lane; the contraction runs over T.
  return sm90::tn_gemm<T>(a, b, dw, workspace, K, N, depth, splits, L, s);
}

// dx (M, K) = Q(dy) (M, N) @ Q(W (K, N))^T: the one-lane dgrad.
extern "C" int mx_matmul_dgrad(
    const void* dy, const void* w, void* dx, void* workspace,
    void* dyq, void* wq, int M, int N, int K, int depth, int splits,
    int is_fp32,
    int has_g, int g_mbits,
    int g_min_normal_exp, int g_e_max, float g_max_normal,
    int g_scale_mode,
    int has_w, int w_mbits,
    int w_min_normal_exp, int w_e_max, float w_max_normal,
    int w_scale_mode,
    void* stream) {
  const MxFmt fg = mx_fmt(g_mbits, g_min_normal_exp, g_e_max,
                          g_max_normal, g_scale_mode);
  const MxFmt fw = mx_fmt(w_mbits, w_min_normal_exp, w_e_max,
                          w_max_normal, w_scale_mode);
  cudaStream_t s = (cudaStream_t)stream;
  return is_fp32
             ? dgrad<float>(dy, w, dx, workspace, dyq, wq, 1, M, N, K, depth,
                            splits, has_g, fg, has_w, fw, s)
             : dgrad<__nv_bfloat16>(dy, w, dx, workspace, dyq, wq, 1, M, N,
                                    K, depth, splits, has_g, fg,
                                    has_w, fw, s);
}

// The dgrad over L lanes: dy (L, M, N), W (L, K, N), dx (L, M, K);
// workspace holds L * splits * M * K floats when splits > 1.
extern "C" int mx_matmul_dgrad_lanes(
    const void* dy, const void* w, void* dx, void* workspace,
    void* dyq, void* wq, int L, int M, int N, int K, int depth,
    int splits, int is_fp32,
    int has_g, int g_mbits,
    int g_min_normal_exp, int g_e_max, float g_max_normal,
    int g_scale_mode,
    int has_w, int w_mbits,
    int w_min_normal_exp, int w_e_max, float w_max_normal,
    int w_scale_mode,
    void* stream) {
  const MxFmt fg = mx_fmt(g_mbits, g_min_normal_exp, g_e_max,
                          g_max_normal, g_scale_mode);
  const MxFmt fw = mx_fmt(w_mbits, w_min_normal_exp, w_e_max,
                          w_max_normal, w_scale_mode);
  cudaStream_t s = (cudaStream_t)stream;
  return is_fp32
             ? dgrad<float>(dy, w, dx, workspace, dyq, wq, L, M, N, K, depth,
                            splits, has_g, fg, has_w, fw, s)
             : dgrad<__nv_bfloat16>(dy, w, dx, workspace, dyq, wq, L, M, N,
                                    K, depth, splits, has_g, fg,
                                    has_w, fw, s);
}

// dW (K, N) = Q(x (T, K))^T @ Q(dy (T, N)): the one-lane wgrad.
extern "C" int mx_matmul_wgrad(
    const void* x, const void* dy, void* dw, void* workspace,
    void* xq, void* dyq, int T, int K, int N, int depth, int splits,
    int is_fp32,
    int has_a, int a_mbits,
    int a_min_normal_exp, int a_e_max, float a_max_normal,
    int a_scale_mode,
    int has_g, int g_mbits,
    int g_min_normal_exp, int g_e_max, float g_max_normal,
    int g_scale_mode,
    void* stream) {
  const MxFmt fa = mx_fmt(a_mbits, a_min_normal_exp, a_e_max,
                          a_max_normal, a_scale_mode);
  const MxFmt fg = mx_fmt(g_mbits, g_min_normal_exp, g_e_max,
                          g_max_normal, g_scale_mode);
  cudaStream_t s = (cudaStream_t)stream;
  return is_fp32
             ? wgrad<float>(x, dy, dw, workspace, xq, dyq, 1, T, K, N, depth,
                            splits, has_a, fa, has_g, fg, s)
             : wgrad<__nv_bfloat16>(x, dy, dw, workspace, xq, dyq, 1, T, K,
                                    N, depth, splits, has_a, fa,
                                    has_g, fg, s);
}

// The wgrad over L lanes: x (L, T, K), dy (L, T, N), dW (L, K, N);
// workspace holds L * splits * K * N floats when splits > 1.
extern "C" int mx_matmul_wgrad_lanes(
    const void* x, const void* dy, void* dw, void* workspace,
    void* xq, void* dyq, int L, int T, int K, int N, int depth,
    int splits, int is_fp32,
    int has_a, int a_mbits,
    int a_min_normal_exp, int a_e_max, float a_max_normal,
    int a_scale_mode,
    int has_g, int g_mbits,
    int g_min_normal_exp, int g_e_max, float g_max_normal,
    int g_scale_mode,
    void* stream) {
  const MxFmt fa = mx_fmt(a_mbits, a_min_normal_exp, a_e_max,
                          a_max_normal, a_scale_mode);
  const MxFmt fg = mx_fmt(g_mbits, g_min_normal_exp, g_e_max,
                          g_max_normal, g_scale_mode);
  cudaStream_t s = (cudaStream_t)stream;
  return is_fp32
             ? wgrad<float>(x, dy, dw, workspace, xq, dyq, L, T, K, N, depth,
                            splits, has_a, fa, has_g, fg, s)
             : wgrad<__nv_bfloat16>(x, dy, dw, workspace, xq, dyq, L, T, K,
                                    N, depth, splits, has_a, fa,
                                    has_g, fg, s);
}
