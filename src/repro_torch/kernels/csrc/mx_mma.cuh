// Tensor-core and copy helpers of the attention kernels on mma.sync.
//
// Included by: mx_attention.cu (the flash forward) and mx_attention_bwd.cu
//   (the flash dgrad); the element cast lives in mx_quant.cuh.
// Replaces: the MXU products (`jax.lax.dot_general`) of the flash
//   kernels in src/repro/kernels/mx_attention.py (`_scores` :90, the PV
//   product of `_mx_attn_fwd_kernel` :110-151, the gradient products of
//   the dQ and dK/dV passes :216-272), which become `mma.sync` m16n8k16.
// Bound: none of its own; each helper is a few instructions.
// Design: bf16 tiles arrive in shared memory by cp.async (16 bytes a
//   thread, zero filled past the ragged edges; element by element when a
//   row is not a multiple of 8 or not 16-byte aligned), in rows padded by
//   16 bytes so that `ldmatrix` reads them without bank conflicts.
//   Products run on `mma.sync.m16n8k16` with bf16 operands and fp32
//   accumulators in registers.  An fp32 operand that bf16 does not hold
//   goes in as three bf16 pieces (`bw_pieces`: hi, mid, lo carry all 24
//   bits), three products into one fp32 accumulator; the accumulators'
//   layout of one product is the A operand's layout of the next, so such
//   an operand never leaves registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t bw_smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory; src_bytes 0 writes zeros.
__device__ __forceinline__ void bw_cp16(void* dst, const void* src,
                                        int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   bw_smem(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void bw_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bw_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(bw_smem(p)));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(bw_smem(p)));
}

// c (16x8 fp32) += a (16x16 bf16, row) b (16x8 bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bw_pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float bw_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The A fragment (16 rows x 16 columns) of an fp32 tile held in the
// accumulators' layout as its n-tiles c0 (columns 0-7) and c1 (8-15),
// each value rounded once to bf16 (exact for values bf16 holds).
__device__ __forceinline__ void bw_one_piece(const float (&c0)[4],
                                             const float (&c1)[4],
                                             uint32_t (&a)[4]) {
  a[0] = bw_pack(c0[0], c0[1]);
  a[1] = bw_pack(c0[2], c0[3]);
  a[2] = bw_pack(c1[0], c1[1]);
  a[3] = bw_pack(c1[2], c1[3]);
}

// The A fragments of three bf16 pieces of such a tile: x = hi + mid + lo,
// each piece bf16.
__device__ __forceinline__ void bw_pieces(const float (&c0)[4],
                                          const float (&c1)[4],
                                          uint32_t (&hi)[4],
                                          uint32_t (&mid)[4],
                                          uint32_t (&lo)[4]) {
  const float x[8] = {c0[0], c0[1], c0[2], c0[3], c1[0], c1[1], c1[2], c1[3]};
  float h[8], m[8], l[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    h[e] = bw_round(x[e]);
    const float r = __fsub_rn(x[e], h[e]);
    m[e] = bw_round(r);
    l[e] = __fsub_rn(r, m[e]);   // rounded to bf16 by bw_pack
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = bw_pack(h[2 * i], h[2 * i + 1]);
    mid[i] = bw_pack(m[2 * i], m[2 * i + 1]);
    lo[i] = bw_pack(l[2 * i], l[2 * i + 1]);
  }
}

// acc (16 x 8 DT, n-tiles) += sum over the NP pieces a[i] (16 x 16) @ tile
// rows [16 kk, 16 kk + 16) of a shared (k-major, row stride LD) tile, by
// ldmatrix.trans; each accumulator takes the pieces in order.
template <int DT, int LD, int NP>
__device__ __forceinline__ void mma_step(float (&acc)[DT][4],
                                         const uint32_t (&a)[NP][4],
                                         const bf16* tile, int kk, int lane) {
  const bf16* base = tile + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD
                     + (lane >> 4) * 8;
#pragma unroll
  for (int np = 0; np < DT / 2; ++np) {
    uint32_t b[4];
    ldsm4t(b, base + np * 16);
#pragma unroll
    for (int i = 0; i < NP; ++i) mma_bf16(acc[2 * np], a[i], b[0], b[1]);
#pragma unroll
    for (int i = 0; i < NP; ++i) mma_bf16(acc[2 * np + 1], a[i], b[2], b[3]);
  }
}

// x (16 rows x 8 NT) = A rows [16 warp, +16) of `own` @ B^T, B the rows of
// `blk` (both k-major with row stride LD, KS k-steps of 16).
template <int NT, int KS, int LD>
__device__ __forceinline__ void mma_scores(float (&x)[NT][4], const bf16* own,
                                           const bf16* blk, int warp,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[4];
    ldsm4(a, own + (warp * 16 + (lane & 15)) * LD + kk * 16
                 + (lane >> 4) * 8);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t b[4];
      ldsm4(b, blk + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD
                   + kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(x[2 * jp], a, b[0], b[1]);
      mma_bf16(x[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// Rows [0, n) of a bf16 matrix (row stride ld elements) into a shared tile
// of CH chunks of 8 columns (row stride LD), zeros past `valid` rows and
// `w` columns, by THREADS threads.  vec: w a multiple of 8 and 16-byte
// aligned rows, by cp.async.
template <int CH, int LD, int THREADS>
__device__ __forceinline__ void mma_tile(bf16* s, const bf16* g, long long ld,
                                         int n, int valid, int w, bool vec) {
  for (int i = threadIdx.x; i < n * CH; i += THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    bf16* dst = s + r * LD + c;
    if (vec) {
      const bool in = r < valid && c < w;
      bw_cp16(dst, in ? (const void*)(g + r * ld + c) : (const void*)g,
              in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (r < valid && c + e < w) ? g[r * ld + c + e]
                                          : __float2bfloat16_rn(0.f);
    }
  }
}

// Whether the AttnSpec mask (0 causal, 1 full, 2 window) admits query
// position qpos against kv position kpos.
__device__ __forceinline__ bool bw_valid(int kind, int window, int qpos,
                                         int kpos) {
  bool ok = true;
  if (kind != 1) ok = qpos >= kpos;
  if (kind == 2) ok = ok && kpos > qpos - window;
  return ok;
}

// Whether any (q position in [qa, qb], k position in [ka, kb]) is valid.
__device__ __forceinline__ bool bw_live(int kind, int window, int qa, int qb,
                                        int ka, int kb) {
  if (kind == 1) return true;
  if (ka > qb) return false;                       // all above the diagonal
  if (kind == 2 && kb <= qa - window) return false;
  return true;
}
