// MX GEMM core on Hopper of the forward GEMM at large M and of the dgrad
// and wgrad: quantize each operand once, then a pipelined bf16 "TN"
// product on the tensor cores.
//
//   C (M, N) = A (M, Kp) @ B (N, Kp)^T, both operands contraction-major.
//
// Replaces: the tile bodies `_mx_mm_kernel` (src/repro/kernels/
//   mx_matmul.py:40-58), `_mx_dgrad_kernel` and `_mx_wgrad_kernel`
//   (src/repro/kernels/mx_matmul_bwd.py:47-70, :114-139).
// Bound: operations at the training step's shapes (4096 tokens against
//   512..32000-wide weights: a 4096 x 32000 x 512 product does about 450
//   operations per byte it must move, above the H100's ~295 bf16 line).
//   As built, the pre-pass takes most of the time, bound by the cast's
//   instructions (every lane does its block's whole work), not by bytes.
// Design: two passes.
//   1. `mx_operand_*` (the pre-pass) reads an operand once, in the layout
//      in which it lies, quantizes every 32-block along the GEMM's
//      contraction axis with `mx_warp_quant` (mx_quant.cuh, the one cast
//      every kernel shares) and writes it as bf16, which is exact for MX
//      values, into a scratch operand whose contraction axis is contiguous
//      and zero padded to a multiple of BK.  `rows` keeps the layout of a
//      contraction-contiguous operand (one warp per 32-block, coalesced);
//      `cols` reads a 64-token x 64-column tile of a token-major operand
//      coalesced, quantizes each column's 32-blocks from shared memory
//      (lane = token) and writes the tile transposed.  The zero padding
//      covers a contraction that is not a multiple of 32 (the partial MX
//      block is zero padded, as `block_reshape` pads), TMA's 16-byte
//      stride rule and the ragged last k-tile.  A raw bf16 operand whose
//      rows TMA can read goes to the product in place, with no copy.
//   2. `mx_tn_gemm_kernel`: 128 x 256 output tiles, two consumer
//      warpgroups of 64 rows each running `wgmma.mma_async` m64n256k16
//      (bf16 in, fp32 accumulators in registers) and one producer warp
//      whose single thread keeps a ring of STAGES k-tiles (64 deep) in
//      flight with TMA (`cp.async.bulk.tensor`, 128-byte swizzle, the
//      layout the wgmma descriptors name) and full/empty mbarriers.  Rows
//      and columns past M and N are zero filled by TMA and masked in the
//      epilogue, which rounds once to the output type and stages the tile
//      in the (then idle) ring so that it leaves in 16-byte row chunks:
//      stored from the fragments directly, the 262 MB output of the
//      forward lm_head took half the product's time.
//   When the output tiles are too few to fill the card, the contraction
//   is split across CTAs (the wrapper plans it): each writes its fp32
//   partial to a workspace and `mx_tn_reduce_kernel` sums the splits in a
//   fixed order.  No float atomics, so a replayed step gives the same
//   bits.  Only the summation order differs from the plain version.
// Lanes: every product runs over L lanes, each with its own A and B (the
//   lane GEMMs of a sweep's lane-stacked proxy, `ops.mx_matmul_lanes` and
//   its dgrad/wgrad twins; L = 1 for the 2-D GEMMs).  The operands lie
//   lane after lane; the tensor maps are rank 3 (depth, row, lane) with a
//   box one lane deep, so the shared-memory tile and its swizzle are the
//   2-D ones, a tile never reads another lane's rows and TMA zero fills
//   each lane's ragged edge.  blockIdx.z is lane x split; the epilogue and
//   the split-K workspace are offset by lane.  The plan (tiles, depth,
//   splits) is the one-lane plan of the per-lane shape, so lane l of a
//   lane call gives bitwise the 2-D result on lane l's operands, whatever
//   L is: the plan does not depend on who shares the call.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums (types only; no -lcuda)
#include <dlfcn.h>

#include "mx_quant.cuh"

// Every name of this file lives in the namespace that the including source
// names (MX_SM90_NS), so a profiler tells the forward GEMM's kernels
// (mx_matmul.cu) from the backward's (mx_matmul_bwd.cu) by name; `sm90`
// is its alias in both.
#ifndef MX_SM90_NS
#error "define MX_SM90_NS before including mx_gemm_sm90.cuh"
#endif
namespace MX_SM90_NS {
constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int CONSUMERS = 2;                    // warpgroups of 64 rows
constexpr int THREADS = CONSUMERS * 128 + 32;   // + one producer warp
constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// 1024 bytes of slack align the ring to the 128-byte swizzle's period.
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
constexpr int PRE_T = 64;                       // cols pre-pass tile side
constexpr int ROWS_BPW = 4;                     // rows pre-pass blocks/warp

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait for the phase of parity `parity` to complete.  A barrier that never
// completes (a fault in this file) traps after ~10 s instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  uint64_t t0 = 0, t = 0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t - t0 > 10000000000ull) asm volatile("trap;");
  }
}

// TMA: the (c0 = contraction, c1 = row, c2 = lane) box of `map` into dst;
// completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma descriptor of a contraction-major tile written by TMA with the
// 128-byte swizzle: rows of 128 bytes (64 bf16), 8-row groups 1024 bytes
// apart (SBO), layout type 1 (SWIZZLE_128B).  A k16 step inside the tile
// advances the start address by 32 bytes (+2 in the >>4 encoding).
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256 fp32, the m64nNk16 fragment) += A (64 x 16) @ B (256 x 16)^T,
// both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float a,
                                                  float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p,
                                                          float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Pre-pass, contraction-contiguous operand: src (R, Kc) quantized along Kc
// into dst (R, depth) bf16, zero padded on [Kc, depth).  A warp owns
// ROWS_BPW consecutive 32-blocks of a row (lane = element), loads them all
// before it quantizes, and a CTA of 8 warps walks rows blockIdx.y,
// blockIdx.y + gridDim.y, ...: no 64-bit division per element.
template <typename T>
__global__ void __launch_bounds__(256)
mx_operand_rows_kernel(const T* __restrict__ src,
                       __nv_bfloat16* __restrict__ dst, long long R, int Kc,
                       int depth, int has, MxFmt f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = (blockIdx.x * 8 + warp) * (32 * ROWS_BPW) + lane;
  for (long long row = blockIdx.y; row < R; row += gridDim.y) {
    const T* s = src + row * Kc;
    __nv_bfloat16* d = dst + row * depth;
    float v[ROWS_BPW];
#pragma unroll
    for (int i = 0; i < ROWS_BPW; ++i) {
      const int c = col0 + 32 * i;
      v[i] = c < Kc ? mx_load<T>(s + c) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < ROWS_BPW; ++i) {
      const int c = col0 + 32 * i;   // warp-uniform: depth % 32 == 0
      if (has) v[i] = mx_warp_quant(v[i], f);
      if (c < depth) d[c] = __float2bfloat16_rn(v[i]);
    }
  }
}

// Eight consecutive elements as floats, from a 16-byte aligned address
// (bf16) or two of them (fp32).
template <typename T>
__device__ __forceinline__ void load8(const T* p, float* v);
template <>
__device__ __forceinline__ void load8<float>(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* p,
                                                     float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x = __bfloat1622float2(h[j]);
    v[2 * j] = x.x, v[2 * j + 1] = x.y;
  }
}

// Pre-pass, token-major operand: src (Tn, C) quantized along Tn and written
// transposed into dst (C, depth) bf16, zero padded on [Tn, depth); lane
// blockIdx.z reads src + z Tn C and writes dst + z C depth.  A CTA
// owns a 64-token x 64-column tile: coalesced loads (16 bytes a thread
// when VEC: C % 8 == 0 and src 16-byte aligned), one mx_warp_quant per
// (column, 32-block) from shared memory with lane = token, and 16-byte
// stores of the transposed tile.
template <typename T, bool VEC>
__global__ void __launch_bounds__(256)
mx_operand_cols_kernel(const T* __restrict__ src,
                       __nv_bfloat16* __restrict__ dst, int Tn, int C,
                       int depth, int has, MxFmt f) {
  __shared__ float tile[PRE_T][PRE_T + 1];                    // [token][col]
  __shared__ __align__(16) __nv_bfloat16 out[PRE_T][PRE_T + 8];  // [col][t]
  src += (long long)blockIdx.z * Tn * C;
  dst += (long long)blockIdx.z * C * depth;
  const int t0 = blockIdx.y * PRE_T, c0 = blockIdx.x * PRE_T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (VEC) {
    for (int i = tid; i < PRE_T * PRE_T / 8; i += 256) {
      const int r = i / (PRE_T / 8), c = (i % (PRE_T / 8)) * 8;
      const int gt = t0 + r, gc = c0 + c;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (gt < Tn && gc < C) load8<T>(src + (long long)gt * C + gc, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) tile[r][c + j] = v[j];
    }
  } else {
    for (int i = tid; i < PRE_T * PRE_T; i += 256) {
      const int r = i / PRE_T, c = i % PRE_T;   // lanes along the columns
      const int gt = t0 + r, gc = c0 + c;
      tile[r][c] = (gt < Tn && gc < C)
                       ? mx_load<T>(src + (long long)gt * C + gc)
                       : 0.f;
    }
  }
  __syncthreads();
  // (column, 32-block) pairs; lane = token inside the block.
#pragma unroll 4
  for (int p = warp; p < 2 * PRE_T; p += 8) {
    const int c = p >> 1, b = p & 1;
    float v = tile[b * 32 + lane][c];
    if (has) v = mx_warp_quant(v, f);
    out[c][b * 32 + lane] = __float2bfloat16_rn(v);
  }
  __syncthreads();
  // 8 tokens (16 bytes) a thread: depth % 64 == 0 keeps them aligned.
  for (int i = tid; i < PRE_T * PRE_T / 8; i += 256) {
    const int c = i / (PRE_T / 8), r = (i % (PRE_T / 8)) * 8;
    const int gc = c0 + c;
    if (gc < C)
      *reinterpret_cast<uint4*>(dst + (long long)gc * depth + t0 + r) =
          *reinterpret_cast<const uint4*>(&out[c][r]);
  }
}

// Writes a consumer's accumulators (the m64nNk16 fragment: warp w of
// warpgroup wg owns rows 64 wg + 16 w .. + 15; d[4j + 2h + e] is row
// lane/4 + 8h, column 8j + 2(lane%4) + e) to out[m0.., n0..] rounded to T,
// through a row-major copy of the tile in shared memory (rows padded by 16
// bytes, so the fragment's 8 rows of a store hit distinct banks), then
// with 16-byte stores along the rows (element stores where N leaves the
// rows unaligned or the tile's edge cuts a chunk).  Rows and columns past
// M and N are not written.
template <typename T>
__device__ __forceinline__ void store_tile(const float* d, uint8_t* smem,
                                           T* __restrict__ out, int M,
                                           int N, int m0, int n0, int wg) {
  constexpr int V = 16 / sizeof(T);   // elements of a 16-byte chunk
  constexpr int LD = BN + V;
  T* tile = reinterpret_cast<T*>(smem);
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r0 = wg * 64 + (t / 32) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = j * 8 + (lane % 4) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store_pair<T>(tile + (r0 + 8 * h) * LD + c, d[4 * j + 2 * h],
                    d[4 * j + 2 * h + 1]);
  }
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS * 128) : "memory");
  const bool vec = N % V == 0;
  for (int i = threadIdx.x; i < BM * BN / V; i += CONSUMERS * 128) {
    const int r = i / (BN / V), c = (i % (BN / V)) * V;
    const int gr = m0 + r, gc = n0 + c;
    if (gr >= M || gc >= N) continue;
    const T* src = tile + r * LD + c;
    T* dst = out + (long long)gr * N + gc;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < V && gc + e < N; ++e) dst[e] = src[e];
    }
  }
}

// One BM x BN tile of lane l's C over k-tiles [z * per, min((z + 1) * per,
// ktiles)) of split z, where blockIdx.z = l * splits + z.  With `part` set
// the fp32 sums go to part[((l * splits + z) * M + m) * N + n]; else
// C + l M N gets OutT.  `m_fast`: blockIdx.x walks
// the M tiles (chosen when they are fewer, so the CTAs that share a tile
// of the larger operand run together).
template <typename OutT>
__global__ void __launch_bounds__(THREADS, 1)
mx_tn_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  OutT* __restrict__ C, float* __restrict__ part, int M,
                  int N, int ktiles, int per, int m_fast, int splits) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int tm = m_fast ? blockIdx.x : blockIdx.y;
  const int tn = m_fast ? blockIdx.y : blockIdx.x;
  const int m0 = tm * BM, n0 = tn * BN;
  const int lane_id = blockIdx.z / splits;
  const int kt0 = (blockIdx.z - lane_id * splits) * per;
  const int nk = max(min(kt0 + per, ktiles) - kt0, 0);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {   // the producer warp: one thread starts the TMA
    if (threadIdx.x == CONSUMERS * 128) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % STAGES;
        // A fresh barrier counts its phase before 0 as complete, so the
        // first pass over the ring does not wait.
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        uint8_t* st = smem + s * STAGE_BYTES;
        mbar_expect_tx(&full[s], STAGE_BYTES);
        const int k = (kt0 + i) * BK;
        tma_load_3d(st, &map_a, &full[s], k, m0, lane_id);
        tma_load_3d(st + A_BYTES, &map_b, &full[s], k, n0, lane_id);
      }
    }
    return;
  }

  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const uint8_t* st = smem + s * STAGE_BYTES;
    const uint64_t da = smem_desc(st + wg * (64 * BK * 2));
    const uint64_t db = smem_desc(st + A_BYTES);
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int k = 0; k < BK / 16; ++k)
      wgmma_m64n256k16(d, da + 2 * k, db + 2 * k);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    // Keep this k-tile's products in flight; the previous one is done, so
    // its stage goes back to the producer.
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    fence_acc(d);
    if (i > 0 && threadIdx.x % 128 == 0)
      mbar_arrive(&empty[(i - 1) % STAGES]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(d);

  // The epilogue goes through shared memory: every k-tile this CTA loaded
  // has been consumed, so the ring is free once both warpgroups are done
  // with it (named barrier 1: the producer warp has exited).
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS * 128) : "memory");
  if (part)
    store_tile<float>(d, smem, part + (long long)blockIdx.z * M * N, M, N,
                      m0, n0, wg);
  else
    store_tile<OutT>(d, smem, C + (long long)lane_id * M * N, M, N, m0, n0,
                     wg);
}

// C = OutT(sum over splits of part), each lane's splits summed in split
// order; i runs over lanes * MN.
template <typename OutT>
__global__ void mx_tn_reduce_kernel(const float* __restrict__ part,
                                    OutT* __restrict__ C, long long MN,
                                    int splits, int lanes) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN * lanes) return;
  const long long l = i / MN;
  const float* p = part + l * splits * MN + (i - l * MN);
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += p[z * MN];
  mx_store<OutT>(C + i, s);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, from the libcuda the process already
// has loaded (the runtime needs it), so the library links no -lcuda.
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h) fn = (EncodeTiled)dlsym(h, "cuTensorMapEncodeTiled");
  }
  return fn;
}

// A GEMM operand: `lanes` x `rows` contraction-major rows of bf16.
struct Operand {
  const __nv_bfloat16* p;
  long long ld;       // elements between rows
  int kext;           // valid contraction extent (TMA zero fills past it)
  long long lstride;  // elements between lanes
};

// Rank-3 tensor map (depth, row, lane) of an operand with `rows` rows a
// lane; boxes of BK x box_rows x 1 lane with the 128-byte swizzle (the
// 2-D tile's layout); reads past the extent or past a lane's last row are
// filled with zeros.
static bool make_map(CUtensorMap* map, const Operand& op, int rows,
                     int lanes, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)op.kext, (cuuint64_t)rows,
                              (cuuint64_t)lanes};
  const cuuint64_t strides[2] = {(cuuint64_t)op.ld * 2,
                                 (cuuint64_t)op.lstride * 2};
  const cuuint32_t box[3] = {(cuuint32_t)BK, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<__nv_bfloat16*>(op.p),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Pre-pass of a contraction-contiguous operand src (lanes, R, Kc), whose
// lanes * R rows it walks as one flat run of rows.  With scratch null the
// operand is used in place (a raw bf16 operand: the caller checks that its
// rows are 16-byte aligned).
template <typename T>
static int operand_rows(const void* src, void* scratch, int lanes, int R,
                        int Kc, int depth, int has, MxFmt f, cudaStream_t s,
                        Operand* op) {
  if (!scratch) {
    if (has || sizeof(T) != 2) return (int)cudaErrorInvalidValue;
    *op = {(const __nv_bfloat16*)src, Kc, Kc, (long long)R * Kc};
    return 0;
  }
  const long long rows = (long long)lanes * R;
  const int per_cta = 8 * 32 * ROWS_BPW;
  dim3 grid((depth + per_cta - 1) / per_cta,
            (unsigned)(rows < 65535 ? rows : 65535));
  mx_operand_rows_kernel<T><<<grid, 256, 0, s>>>(
      (const T*)src, (__nv_bfloat16*)scratch, rows, Kc, depth, has, f);
  *op = {(const __nv_bfloat16*)scratch, depth, depth, (long long)R * depth};
  return (int)cudaGetLastError();
}

// Pre-pass of a token-major operand src (lanes, Tn, C): each lane
// quantized along Tn into scratch (lanes, C, depth).
template <typename T>
static int operand_cols(const void* src, void* scratch, int lanes, int Tn,
                        int C, int depth, int has, MxFmt f, cudaStream_t s,
                        Operand* op) {
  if (!scratch || lanes > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((C + PRE_T - 1) / PRE_T, depth / PRE_T, lanes);
  const bool vec = C % 8 == 0 && (uintptr_t)src % 16 == 0;
  if (vec)
    mx_operand_cols_kernel<T, true><<<grid, 256, 0, s>>>(
        (const T*)src, (__nv_bfloat16*)scratch, Tn, C, depth, has, f);
  else
    mx_operand_cols_kernel<T, false><<<grid, 256, 0, s>>>(
        (const T*)src, (__nv_bfloat16*)scratch, Tn, C, depth, has, f);
  *op = {(const __nv_bfloat16*)scratch, depth, depth, (long long)C * depth};
  return (int)cudaGetLastError();
}

// C (lanes, M, N) = A @ B^T lane by lane over `depth` (a multiple of BK)
// in `splits` contraction splits a lane; `workspace` holds
// lanes * splits * M * N floats when splits > 1.
template <typename OutT>
static int tn_gemm(const Operand& a, const Operand& b, void* c,
                   void* workspace, int M, int N, int depth, int splits,
                   int lanes, cudaStream_t s) {
  if (splits < 1 || lanes < 1 || (long long)lanes * splits > 65535 ||
      depth % BK || (splits > 1 && !workspace))
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(mx_tn_gemm_kernel<OutT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SMEM_BYTES);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  CUtensorMap ma, mb;
  if (!make_map(&ma, a, M, lanes, BM) || !make_map(&mb, b, N, lanes, BN))
    return (int)cudaErrorInvalidValue;
  const int ktiles = depth / BK;
  const int per = (ktiles + splits - 1) / splits;
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int m_fast = tiles_m <= tiles_n;
  dim3 grid(m_fast ? tiles_m : tiles_n, m_fast ? tiles_n : tiles_m,
            lanes * splits);
  float* part = splits > 1 ? (float*)workspace : nullptr;
  mx_tn_gemm_kernel<OutT><<<grid, THREADS, SMEM_BYTES, s>>>(
      ma, mb, (OutT*)c, part, M, N, ktiles, per, m_fast, splits);
  rc = (int)cudaGetLastError();
  if (rc || splits == 1) return rc;
  const long long MN = (long long)M * N;
  mx_tn_reduce_kernel<OutT>
      <<<(unsigned)((MN * lanes + 255) / 256), 256, 0, s>>>(
          part, (OutT*)c, MN, splits, lanes);
  return (int)cudaGetLastError();
}
}  // namespace MX_SM90_NS
namespace sm90 = MX_SM90_NS;
