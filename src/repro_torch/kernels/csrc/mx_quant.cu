// MX quantize-dequantize of an (M, K) row-major array, 32-blocks along K.
//
// Replaces: `mx_quantize_pallas` (src/repro/kernels/mx_quant.py:66, the
//   pallas_call at :82) and its tile body `_quantize_block_tile` (:31-56).
// Bound: bytes.  Each element is read once and written once, a few dozen
//   ALU operations per element; on the H100 the time is the HBM round trip
//   (16.8 MB at the training step's (4096, 512) fp32 `xn`: 5.0 µs at
//   3.35 TB/s), or, at the serve path's small shapes, the launch.
// Design: a streaming pass where K is a multiple of 8 and both pointers
//   are 16-byte aligned (every activation of the main path).  Four lanes
//   hold a 32-block, 8 consecutive elements a lane, loaded and stored 16
//   bytes at a time (two loads for fp32, one for bf16), and cast it with
//   `mx_quad_quant` (mx_quant.cuh), whose sums are the warp butterfly's,
//   so the result is bitwise that of the one-element-a-lane cast under
//   every format and scale rule.  One block a thread: at the training
//   step's (4096, 512) the grid is one wave of resident CTAs, so every
//   load of the array is in flight at once (two or four blocks a thread,
//   persistent CTAs with a prefetch and streaming cache hints measured no
//   faster on the card).  A partial last block (K not a multiple of 32)
//   is zero-padded in registers, as `block_reshape` pads, and its pad
//   lanes are never stored.  Otherwise (ragged K, misaligned views) one
//   warp is one block, lane i holding element i, with the max and sums by
//   __shfl_xor_sync; consecutive lanes read consecutive elements, so
//   loads and stores coalesce.
#include <stdint.h>

#include "mx_quant.cuh"

namespace {
constexpr int MQ_THREADS = 256;
}  // namespace

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

// Eight consecutive elements, 16 bytes a load.
__device__ __forceinline__ void mq_load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void mq_load8(const __nv_bfloat16* p,
                                         float (&v)[8]) {
  mx_unpack8(*reinterpret_cast<const uint4*>(p), v);
}

__device__ __forceinline__ void mq_store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void mq_store8(__nv_bfloat16* p,
                                          const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = mx_pack8(v);
}

// The streaming pass: quad j casts block j, each lane 8 elements of it.
template <typename T>
__global__ void __launch_bounds__(MQ_THREADS)
mx_quantize_vec_kernel(const T* __restrict__ x, T* __restrict__ y,
                       long long M, int K, MxFmt f) {
  const long long nb = (K + 31) / 32;
  const long long t = (long long)blockIdx.x * (MQ_THREADS / 4)
                      + (threadIdx.x >> 2);
  const long long row = t / nb;
  const int c = (int)(t - row * nb) * 32 + 8 * (threadIdx.x & 3);
  const bool in = t < M * nb && c < K;   // K % 8 == 0: whole chunks
  const long long idx = row * K + c;
  float v[8];
  if (in) {
    mq_load8(x + idx, v);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = 0.f;
  }
  mx_quad_quant(v, f);   // every lane casts (the shuffles)
  if (in) mq_store8(y + idx, v);
}

template <typename T>
static void mq_launch(const void* x, void* y, long long M, int K, int vec,
                      const MxFmt& f, cudaStream_t s) {
  const long long lanes = M * ((K + 31) / 32) * (vec ? 4 : 32);
  const unsigned blocks = (unsigned)((lanes + MQ_THREADS - 1) / MQ_THREADS);
  if (vec)
    mx_quantize_vec_kernel<T><<<blocks, MQ_THREADS, 0, s>>>(
        (const T*)x, (T*)y, M, K, f);
  else
    mx_quantize_kernel<T><<<blocks, MQ_THREADS, 0, s>>>((const T*)x, (T*)y,
                                                        M, K, f);
}

extern "C" int mx_quantize_lastdim(const void* x, void* y, long long M, int K,
                                   int is_bf16, int mbits, int min_normal_exp,
                                   int e_max, float max_normal,
                                   int scale_mode, void* stream) {
  const MxFmt f = mx_fmt(mbits, min_normal_exp, e_max, max_normal,
                         scale_mode);
  cudaStream_t s = (cudaStream_t)stream;
  if (M > 0 && K > 0) {
    const int vec = K % 8 == 0 && ((uintptr_t)x | (uintptr_t)y) % 16 == 0;
    if (is_bf16)
      mq_launch<__nv_bfloat16>(x, y, M, K, vec, f, s);
    else
      mq_launch<float>(x, y, M, K, vec, f, s);
  }
  return (int)cudaGetLastError();
}
