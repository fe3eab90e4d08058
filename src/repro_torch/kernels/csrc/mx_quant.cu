// MX quantize-dequantize of an (M, K) row-major array, 32-blocks along K.
//
// Replaces: `mx_quantize_pallas` (src/repro/kernels/mx_quant.py:66, the
//   pallas_call at :82) and its tile body `_quantize_block_tile` (:31-56).
// Bound: bytes.  Each element is read once and written once, a few dozen
//   ALU operations per element; on the H100 the time is the HBM round trip
//   (or, at the serve path's small shapes, the launch).
// Design: one warp is one MX block.  Lane i holds element i, the block max
//   is a __shfl_xor_sync reduction and the scale comes from the exponent
//   bits (mx_quant.cuh), under the format's scale rule (floor, bump, or
//   adaptive with the two block errors summed by the same shuffles).
//   Consecutive lanes read consecutive elements, so
//   loads and stores coalesce.  A partial last block (K not a multiple of
//   32) is zero-padded in registers, as `block_reshape` pads, and its pad
//   lanes are never stored.
#include "mx_quant.cuh"

template <typename T>
__global__ void mx_quantize_kernel(const T* __restrict__ x, T* __restrict__ y,
                                   long long M, int K, MxFmt f) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * (blockDim.x >> 5)
                         + (threadIdx.x >> 5);
  const int nb = (K + 31) / 32;
  if (warp >= M * nb) return;  // whole warp exits together
  const long long row = warp / nb;
  const int col = (int)(warp % nb) * 32 + lane;
  const bool in = col < K;
  const long long idx = row * K + col;
  const float v = in ? mx_load<T>(x + idx) : 0.f;
  const float q = mx_warp_quant(v, f);
  if (in) mx_store<T>(y + idx, q);
}

extern "C" int mx_quantize_lastdim(const void* x, void* y, long long M, int K,
                                   int is_bf16, int mbits, int min_normal_exp,
                                   int e_max, float max_normal,
                                   int scale_mode, void* stream) {
  const MxFmt f = mx_fmt(mbits, min_normal_exp, e_max, max_normal,
                         scale_mode);
  const long long warps = M * ((K + 31) / 32);
  const int threads = 256;
  const long long blocks = (warps * 32 + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (blocks > 0) {
    if (is_bf16)
      mx_quantize_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
          (const __nv_bfloat16*)x, (__nv_bfloat16*)y, M, K, f);
    else
      mx_quantize_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
          (const float*)x, (float*)y, M, K, f);
  }
  return (int)cudaGetLastError();
}
