"""Hand-written CUDA kernels for the MX hot spots (H100, sm_90a).

  csrc/mx_quant.cuh  — the element cast and shared scale every kernel uses
  csrc/mx_quant.cu   — block-scale quantize-dequantize
  csrc/mx_matmul.cu  — forward MX GEMM, quantize on load, fp32 accumulation
  csrc/mx_attention.cu — flash forward (out and lse) and Tq = 1 decode
  build.py           — nvcc at first use, ctypes binding
  ops.py             — wrappers (checks, launch counts, plain versions on CPU)
  ref.py             — the plain PyTorch versions

Counterpart of ``repro.kernels``; the backward kernels and the paged decode
kernel come with later slices of the port.
"""
from .ops import (LAUNCHES, mx_attention_decode, mx_flash_attention,
                  mx_matmul, mx_quantize, reset_launches)
from .ref import (mx_attention_decode_ref, mx_flash_attention_ref,
                  mx_matmul_ref, mx_quantize_ref)

__all__ = ["LAUNCHES", "reset_launches", "mx_quantize", "mx_matmul",
           "mx_flash_attention", "mx_attention_decode", "mx_quantize_ref",
           "mx_matmul_ref", "mx_flash_attention_ref",
           "mx_attention_decode_ref"]
