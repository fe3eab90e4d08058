// MX element cast and shared scale: the one device code every kernel uses.
//
// Replaces: the body of `_quantize_block_tile` in
//   src/repro/kernels/mx_quant.py, which kernels 2-8 of the Pallas package
//   inline (mx_matmul.py, mx_attention.py), and the scale rules of
//   `shared_exponent` (src/repro/core/mx.py), which the reference runs
//   through its jnp oracle for the non-floor modes.
// Bound: pure ALU on values already in registers; the kernels that include
//   it are bound by their own loads, or by this cast's instructions where
//   a kernel casts more elements than it can hide behind its bytes.
// Design: one code path for every kernel, so the cast cannot drift between
//   them.  Powers of two come from the exponent field (`__uint_as_float`),
//   exponents are read with `__float_as_uint`; no exp2f/log2f.  Rounding is
//   `rintf` (half to even, as jnp.round).  The scale exponent is clipped to
//   [-126, 127] and an all-zero block takes -126.  The block max propagates
//   NaN like jnp.max.  The final `x + (y - x)` is the fp32 straight-through
//   assembly of `repro.core.quantize_mx`, so an infinite input comes out NaN
//   exactly as there.  Build without --use_fast_math and with -fmad=false.
//   The format carries its scale rule (MxFmt::scale_mode), applied in the
//   reference's order: the floor exponent e; "bump" adds 1 when the block
//   max over 2^e exceeds max_normal (division by a power of two is
//   monotone, so the max decides for the whole block); "adaptive" takes
//   e + 1 only when the block's summed squared error at e + 1 is strictly
//   smaller than at e; then the clip and the zero-block rule.  A block is
//   held one element a lane (`mx_warp_*`), eight a lane over four lanes
//   (`mx_quad_*`: consecutive elements; `mx_mma_*`: the m16n8k16
//   accumulator layout) or whole by one thread (`mx_thread_*`); the
//   adaptive sums run in the same butterfly order in all four, so every
//   kernel takes
//   the same choice for the same block (the
//   plain version's torch.sum may order its sum otherwise, so the two can
//   differ only on near ties).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// Scale rules, as `scale_mode` of repro.core.mx.shared_exponent.
enum { MX_FLOOR = 0, MX_BUMP = 1, MX_ADAPTIVE = 2 };

struct MxFmt {
  int mbits;           // explicit mantissa bits
  int min_normal_exp;  // 1 - bias
  int e_max;           // exponent of the largest normal
  float max_normal;
  int scale_mode;      // MX_FLOOR, MX_BUMP or MX_ADAPTIVE
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

// 2^e for e in [-149, 127], subnormals included, from the bit pattern.
__device__ __forceinline__ float mx_exp2_any(int e) {
  return e >= -126 ? __uint_as_float((unsigned)(e + 127) << 23)
                   : __uint_as_float(1u << (e + 149));
}

// The floor rule's exponent of a block with max magnitude amax, before
// the clip.
__device__ __forceinline__ int mx_floor_exp(float amax, const MxFmt& f) {
  return mx_floor_log2(amax > 0.f ? amax : 1.f) - f.e_max;
}

// The clip to [-126, 127], and -126 for an all-zero (or NaN) block.
__device__ __forceinline__ int mx_final_exp(int e, float amax) {
  e = max(-126, min(127, e));
  return amax > 0.f ? e : -126;
}

// The bump rule's test: whether the block max over 2^e exceeds max_normal.
__device__ __forceinline__ int mx_overflows(float amax, int e,
                                            const MxFmt& f) {
  return __fmul_rn(amax, mx_exp2_any(-max(-126, min(127, e)))) > f.max_normal;
}

// Quantize-dequantize one fp32 value with the shared exponent e (clipped
// here as exp2_int clips), before the straight-through assembly.  x / 2^k
// is computed as x * 2^-k: both are the correctly rounded value of the
// same real number (the reciprocal of a power of two is exact, as a
// subnormal at worst), so the result is bitwise the reference's division.
// The element's exponent is read from r's bits (zero and fp32 subnormals
// read -127) and raised to min_normal_exp, so qe lies in
// [min_normal_exp - mbits, 128 - mbits], inside [-17, 127] for every OCP
// element format, and both 2^qe and 2^-qe are built from the exponent
// field without a clip (2^-qe reads 0 at qe = 127, which only an infinite
// or NaN r reaches).  The reference's zero and non-finite branches are
// left out: a zero r gives a signed zero, which the straight-through
// assembly of mx_cast turns into +0 as the branch's +0 does, and a
// non-finite x comes out NaN there either way; in mx_sq_err such a block
// compares two non-finite errors, which keeps e, as NaN errors do.
__device__ __forceinline__ float mx_cast_value(float x, int e,
                                               const MxFmt& f) {
  const float scale = mx_exp2_int(e);
  const float r = __fmul_rn(x, mx_exp2_any(-max(-126, min(127, e))));
  const int qe = max(mx_floor_log2(r), f.min_normal_exp) - f.mbits;
  const float quantum = __uint_as_float((unsigned)(qe + 127) << 23);
  const float inv_quantum = __uint_as_float((unsigned)(127 - qe) << 23);
  const float q = __fmul_rn(rintf(__fmul_rn(r, inv_quantum)), quantum);
  return __fmul_rn(fminf(fmaxf(q, -f.max_normal), f.max_normal), scale);
}

// The cast as quantize_mx returns it: x + (y - x) in fp32.
__device__ __forceinline__ float mx_cast(float x, int e, const MxFmt& f) {
  return __fadd_rn(x, __fsub_rn(mx_cast_value(x, e, f), x));
}

// One element's term of the adaptive rule's block error at exponent e.
__device__ __forceinline__ float mx_sq_err(float x, int e, const MxFmt& f) {
  const float d = __fsub_rn(mx_cast_value(x, e, f), x);
  return __fmul_rn(d, d);
}

// Block max over a warp: lane i holds one element of a 32-block.
__device__ __forceinline__ float mx_warp_absmax(float v) {
  float m = fabsf(v);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = mx_nanmax(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

__device__ __forceinline__ float mx_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared exponent of a 32-block held one element per lane, under f's scale
// rule.  Every lane gets the same value: after each butterfly step lanes
// i and i ^ o hold a + b and b + a, which fp32 addition makes equal.
__device__ __forceinline__ int mx_warp_exp(float v, const MxFmt& f) {
  const float amax = mx_warp_absmax(v);
  int e = mx_floor_exp(amax, f);
  if (f.scale_mode == MX_BUMP) {
    e += mx_overflows(amax, e, f);
  } else if (f.scale_mode == MX_ADAPTIVE) {
    const float err0 = mx_warp_sum(mx_sq_err(v, e, f));
    const float err1 = mx_warp_sum(mx_sq_err(v, e + 1, f));
    e += err1 < err0;
  }
  return mx_final_exp(e, amax);
}

// Quantize a 32-block held one element per lane.
__device__ __forceinline__ float mx_warp_quant(float v, const MxFmt& f) {
  return mx_cast(v, mx_warp_exp(v, f), f);
}

// Sum of s[0..31] in mx_warp_sum's butterfly order (lane i holding s[i]:
// step o adds s[i + o] into s[i] for i < o); overwrites s.
__device__ __forceinline__ float mx_tree_sum(float (&s)[32]) {
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    const int o = 16 >> l;   // a counted loop, so both unroll fully
#pragma unroll
    for (int i = 0; i < o; ++i) s[i] = __fadd_rn(s[i], s[i + o]);
  }
  return s[0];
}

// Block error of v[0..31] at exponent e, in the butterfly order.
__device__ __forceinline__ float mx_thread_err(const float (&v)[32], int e,
                                               const MxFmt& f) {
  float s[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) s[j] = mx_sq_err(v[j], e, f);
  return mx_tree_sum(s);
}

// Shared exponent of a 32-block v[0..31] held by one thread, given its max
// magnitude (NaN-propagating), under f's scale rule: the value that
// mx_warp_exp gives for the same block.
__device__ __forceinline__ int mx_thread_exp(const float (&v)[32], float amax,
                                             const MxFmt& f) {
  int e = mx_floor_exp(amax, f);
  if (f.scale_mode == MX_BUMP) {
    e += mx_overflows(amax, e, f);
  } else if (f.scale_mode == MX_ADAPTIVE) {
    const float err0 = mx_thread_err(v, e, f);
    const float err1 = mx_thread_err(v, e + 1, f);
    e += err1 < err0;
  }
  return mx_final_exp(e, amax);
}

// Quantize a 32-block held by one thread, in place: the max without
// shuffles, then the exponent and cast of mx_warp_quant, bit for bit.
__device__ __forceinline__ void mx_thread_quant(float (&v)[32],
                                                const MxFmt& f) {
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) amax = mx_nanmax(amax, fabsf(v[j]));
  const int e = mx_thread_exp(v, amax, f);
#pragma unroll
  for (int j = 0; j < 32; ++j) v[j] = mx_cast(v[j], e, f);
}

// A 32-block held 8 elements a lane by four consecutive lanes (element
// 8 (lane & 3) + i in v[i] of that lane): the butterfly's steps 16 and 8
// are the lane exchanges xor 2 and xor 1, its steps 4, 2 and 1 stay in the
// lane, so the sum is mx_warp_sum's tree and every lane of the four ends
// with it.  Every lane of the warp must take part; overwrites s.
__device__ __forceinline__ float mx_quad_sum(float (&s)[8]) {
#pragma unroll
  for (int o = 2; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      s[i] = __fadd_rn(s[i], __shfl_xor_sync(0xffffffffu, s[i], o));
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    const int o = 4 >> l;
#pragma unroll
    for (int i = 0; i < o; ++i) s[i] = __fadd_rn(s[i], s[i + o]);
  }
  return s[0];
}

// A 32-block held 8 elements a lane by four consecutive lanes in the
// m16n8k16 accumulator layout: lane tq = lane & 3 holds, of one row,
// columns 8 t + 2 tq + b (t = 0..3, b = 0..1) in v[2 t + b].  The
// butterfly's steps 16 and 8 (the bits of t) stay in the lane, its steps
// 4 and 2 (the bits of tq) are the lane exchanges xor 2 and xor 1, and its
// step 1 (b) stays in the lane, so the sum is mx_warp_sum's tree and every
// lane of the four ends with it.  Every lane of the warp must take part;
// overwrites s.
__device__ __forceinline__ float mx_mma_sum(float (&s)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = __fadd_rn(s[i], s[i + 4]);   // 16
#pragma unroll
  for (int b = 0; b < 2; ++b) s[b] = __fadd_rn(s[b], s[b + 2]);   // 8
#pragma unroll
  for (int o = 2; o > 0; o >>= 1)                                 // 4, 2
#pragma unroll
    for (int b = 0; b < 2; ++b)
      s[b] = __fadd_rn(s[b], __shfl_xor_sync(0xffffffffu, s[b], o));
  return __fadd_rn(s[0], s[1]);                                   // 1
}

// The two four-lane layouts, by their sum (mx_quad_sum, mx_mma_sum).
struct MxQuadLanes {
  static __device__ __forceinline__ float sum(float (&s)[8]) {
    return mx_quad_sum(s);
  }
};
struct MxMmaLanes {
  static __device__ __forceinline__ float sum(float (&s)[8]) {
    return mx_mma_sum(s);
  }
};

// Shared exponent of a block held by four lanes in layout L:
// mx_warp_exp's value.
template <class L>
__device__ __forceinline__ int mx_lanes4_exp(const float (&v)[8],
                                             const MxFmt& f) {
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) amax = mx_nanmax(amax, fabsf(v[i]));
  amax = mx_nanmax(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
  amax = mx_nanmax(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
  int e = mx_floor_exp(amax, f);
  if (f.scale_mode == MX_BUMP) {
    e += mx_overflows(amax, e, f);
  } else if (f.scale_mode == MX_ADAPTIVE) {
    float s0[8], s1[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s0[i] = mx_sq_err(v[i], e, f);
      s1[i] = mx_sq_err(v[i], e + 1, f);
    }
    const float err0 = L::sum(s0);
    const float err1 = L::sum(s1);
    e += err1 < err0;
  }
  return mx_final_exp(e, amax);
}

// Quantize a block held as in mx_quad_sum, in place.
__device__ __forceinline__ void mx_quad_quant(float (&v)[8], const MxFmt& f) {
  const int e = mx_lanes4_exp<MxQuadLanes>(v, f);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = mx_cast(v[i], e, f);
}

// Quantize a block held as in mx_mma_sum (a row's 32 columns of an
// m16n8k16 accumulator tile), in place.
__device__ __forceinline__ void mx_mma_quant(float (&v)[8], const MxFmt& f) {
  const int e = mx_lanes4_exp<MxMmaLanes>(v, f);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = mx_cast(v[i], e, f);
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

// Eight bf16 values (one 16-byte word) as fp32, and back, rounded to
// nearest (exact for cast values).
__device__ __forceinline__ void mx_unpack8(const uint4& w, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 p2 = __bfloat1622float2(h[e]);
    x[2 * e] = p2.x;
    x[2 * e + 1] = p2.y;
  }
}

__device__ __forceinline__ uint4 mx_pack8(const float (&x)[8]) {
  uint4 w;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(x[2 * e],
                                                           x[2 * e + 1]);
  return w;
}

static inline MxFmt mx_fmt(int mbits, int min_normal_exp, int e_max,
                           float max_normal, int scale_mode) {
  MxFmt f;
  f.mbits = mbits;
  f.min_normal_exp = min_normal_exp;
  f.e_max = e_max;
  f.max_normal = max_normal;
  f.scale_mode = scale_mode;
  return f;
}
