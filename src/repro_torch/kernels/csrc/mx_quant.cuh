// MX element cast and shared scale: the one device code every kernel uses.
//
// Replaces: the body of `_quantize_block_tile` in
//   src/repro/kernels/mx_quant.py, which kernels 2-8 of the Pallas package
//   inline (mx_matmul.py, mx_attention.py).
// Bound: pure ALU on values already in registers; the kernels that include
//   it are bound by their own loads.
// Design: one code path for every kernel, so the cast cannot drift between
//   them.  Powers of two come from the exponent field (`__uint_as_float`),
//   exponents are read with `__float_as_uint`; no exp2f/log2f.  Rounding is
//   `rintf` (half to even, as jnp.round).  The scale exponent is clipped to
//   [-126, 127] and an all-zero block takes -126.  The block max propagates
//   NaN like jnp.max.  The final `x + (y - x)` is the fp32 straight-through
//   assembly of `repro.core.quantize_mx`, so an infinite input comes out NaN
//   exactly as there.  Build without --use_fast_math and with -fmad=false.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

struct MxFmt {
  int mbits;           // explicit mantissa bits
  int min_normal_exp;  // 1 - bias
  int e_max;           // exponent of the largest normal
  float max_normal;
};

__device__ __forceinline__ int mx_floor_log2(float x) {
  return (int)((__float_as_uint(x) >> 23) & 0xFFu) - 127;
}

__device__ __forceinline__ float mx_exp2_int(int e) {
  e = max(-126, min(127, e));
  return __uint_as_float((unsigned)(e + 127) << 23);
}

// max that propagates NaN from either side (fmaxf drops it).
__device__ __forceinline__ float mx_nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Shared exponent of a block from its max magnitude (floor rule).
__device__ __forceinline__ int mx_shared_exp(float amax, const MxFmt& f) {
  int e = mx_floor_log2(amax > 0.f ? amax : 1.f) - f.e_max;
  e = max(-126, min(127, e));
  return amax > 0.f ? e : -126;
}

// 2^e for e in [-149, 127], subnormals included, from the bit pattern.
__device__ __forceinline__ float mx_exp2_any(int e) {
  return e >= -126 ? __uint_as_float((unsigned)(e + 127) << 23)
                   : __uint_as_float(1u << (e + 149));
}

// Quantize-dequantize one fp32 value with its block's shared exponent.
// x / 2^k is computed as x * 2^-k: both are the correctly rounded value of
// the same real number (the reciprocal of a power of two is exact, as a
// subnormal at worst), so the result is bitwise the reference's division.
__device__ __forceinline__ float mx_cast(float x, int e, const MxFmt& f) {
  const float scale = mx_exp2_int(e);
  const float r = __fmul_rn(x, mx_exp2_any(-max(-126, min(127, e))));
  const float mag = fabsf(r);
  int ee = mx_floor_log2(mag > 0.f ? mag : 1.f);
  ee = max(ee, f.min_normal_exp);
  const int qe = max(-126, min(127, ee - f.mbits));
  const float quantum = mx_exp2_int(qe);
  float q = __fmul_rn(rintf(__fmul_rn(r, mx_exp2_any(-qe))), quantum);
  q = fminf(fmaxf(q, -f.max_normal), f.max_normal);
  q = mag > 0.f ? q : 0.f;
  q = isfinite(r) ? q : r;
  const float y = __fmul_rn(q, scale);
  return __fadd_rn(x, __fsub_rn(y, x));
}

// Block max over a warp: lane i holds one element of a 32-block.
__device__ __forceinline__ float mx_warp_absmax(float v) {
  float m = fabsf(v);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = mx_nanmax(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// Quantize a 32-block held one element per lane.
__device__ __forceinline__ float mx_warp_quant(float v, const MxFmt& f) {
  return mx_cast(v, mx_shared_exp(mx_warp_absmax(v), f), f);
}

__device__ __forceinline__ float mx_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float mx_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = mx_nanmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T> __device__ __forceinline__ float mx_load(const T* p);
template <> __device__ __forceinline__ float mx_load<float>(const float* p) {
  return *p;
}
template <> __device__ __forceinline__ float mx_load<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T> __device__ __forceinline__ void mx_store(T* p, float v);
template <> __device__ __forceinline__ void mx_store<float>(float* p, float v) {
  *p = v;
}
template <> __device__ __forceinline__ void mx_store<__nv_bfloat16>(
    __nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

static inline MxFmt mx_fmt(int mbits, int min_normal_exp, int e_max,
                           float max_normal) {
  MxFmt f;
  f.mbits = mbits;
  f.min_normal_exp = min_normal_exp;
  f.e_max = e_max;
  f.max_normal = max_normal;
  return f;
}
