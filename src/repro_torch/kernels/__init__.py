"""Hand-written CUDA kernels for the MX hot spots (H100, sm_90a).

  csrc/mx_quant.cuh  — the element cast and the scale rules (floor, bump,
                       adaptive) every kernel uses
  csrc/mx_quant.cu   — block-scale quantize-dequantize
  csrc/mx_gemm_sm90.cuh — quantize-once pre-pass and wgmma/TMA bf16 product
  csrc/mx_small_m.cuh — one pass over W for a few rows (decode)
  csrc/mx_matmul.cu  — forward MX GEMM: mx_small_m.cuh up to 8 rows, else
                       the pre-pass and product of mx_gemm_sm90.cuh
  csrc/mx_matmul_bwd.cu — dgrad (blocks along N) and wgrad (along tokens)
  csrc/mx_attention.cu — flash forward (out and lse), Tq = 1 decode, and
                       decode through a page table
  csrc/mx_attention_bwd.cu — flash dgrad (dQ pass, dK/dV pass)
  build.py           — nvcc at first use, ctypes binding
  ops.py             — wrappers (checks, launch counts, plain versions on CPU)
  ref.py             — the plain PyTorch versions

Counterpart of ``repro.kernels``.
"""
from .ops import (LAUNCHES, mx_attention_decode, mx_attention_decode_paged,
                  mx_flash_attention, mx_flash_attention_bwd, mx_matmul,
                  mx_matmul_dgrad, mx_matmul_wgrad, mx_quantize,
                  reset_launches)
from .ref import (gather_pages, mx_attention_decode_paged_ref,
                  mx_attention_decode_ref, mx_flash_attention_bwd_ref,
                  mx_flash_attention_ref, mx_matmul_dgrad_ref,
                  mx_matmul_ref, mx_matmul_wgrad_ref, mx_quantize_ref)

__all__ = ["LAUNCHES", "reset_launches", "mx_quantize", "mx_matmul",
           "mx_matmul_dgrad", "mx_matmul_wgrad", "mx_flash_attention",
           "mx_flash_attention_bwd", "mx_attention_decode",
           "mx_attention_decode_paged", "mx_quantize_ref", "mx_matmul_ref",
           "mx_matmul_dgrad_ref", "mx_matmul_wgrad_ref", "mx_flash_attention_ref",
           "mx_flash_attention_bwd_ref", "mx_attention_decode_ref",
           "gather_pages", "mx_attention_decode_paged_ref"]
