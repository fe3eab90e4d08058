"""MX-quantized contractions: the single entry point ``mx_contract``.

Counterpart of ``repro.core.qlinear`` for the serving slice, with the kinds

  "dense"        x (..., K) @ W (K, N), both quantized along K.  Uses the
                 MX GEMM kernel when some operand format is set; with both
                 operands bf16 it is a plain matmul with fp32 accumulation
                 and bf16 output, as the reference's ``_mm``.
  "flash_attn"   the fused QK^T / online softmax / PV forward on the folded
                 layout q (BH,G,Tq,d) x (k (BH,Tk,d), v (BH,Tk,dv)); masks
                 and tiles come from an AttnSpec.  Uses the flash kernel in
                 bf16 mode too (no operand format needed).
  "attn_decode"  the Tq = 1 shape q (BH,G,d) against a cache with a
                 validity mask (see ``kernels.ops.mx_attention_decode``).

Dispatch follows the tensor's device: the kernel wrappers launch the CUDA
kernels for CUDA tensors and run the plain versions for CPU tensors.  The
"dense" and "flash_attn" kinds are ``torch.autograd.Function``s whose
backward belongs to the training slice and raises until it is ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from .attnspec import AttnSpec
from .qconfig import QuantConfig

__all__ = ["mx_contract"]

_TRAINING = ("the backward kernels (dgrad, wgrad and the flash dgrad) belong "
             "to the training slice of the port, which is not ported yet")


def _mm(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    """Matmul with fp32 accumulation rounded once to ``out_dtype``.  cuBLAS
    accumulates bf16 products in fp32 (reduced-precision reductions are off,
    see ``repro_torch/__init__.py``); on the CPU the product runs in fp32."""
    if a.is_cuda:
        return torch.matmul(a, b).to(out_dtype)
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def _attn_fmt(cfg: QuantConfig):
    return cfg.a_fwd if cfg.attn else None


class _Dense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, cfg: QuantConfig):
        if cfg.a_fwd is None and cfg.w_fwd is None:
            return _mm(x, w, x.dtype)
        return ops.mx_matmul(x, w, cfg.a_fwd, cfg.w_fwd, block=cfg.block,
                             scale_mode=cfg.scale_mode).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        raise NotImplementedError(f'mx_contract(kind="dense"): {_TRAINING}')


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, cfg: QuantConfig, spec: AttnSpec):
        out, _ = ops.mx_flash_attention(q, k, v, _attn_fmt(cfg), spec,
                                        block=cfg.block,
                                        scale_mode=cfg.scale_mode)
        return out

    @staticmethod
    def backward(ctx, dout):
        raise NotImplementedError(
            f'mx_contract(kind="flash_attn"): {_TRAINING}')


def mx_contract(lhs, rhs, cfg: QuantConfig, *, kind: str = "dense",
                spec: Optional[AttnSpec] = None,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantized contraction dispatched on ``kind`` (see module docstring).
    ``rhs`` is a tensor for "dense" and a ``(k, v)`` pair for attention."""
    if kind == "dense":
        return _Dense.apply(lhs, rhs, cfg)
    if kind == "flash_attn":
        if spec is None:
            raise ValueError("kind='flash_attn' requires spec=AttnSpec(...)")
        k, v = rhs
        return _Flash.apply(lhs, k, v, cfg, spec)
    if kind == "attn_decode":
        if valid is None:
            raise ValueError("kind='attn_decode' requires a validity mask")
        k, v = rhs
        return ops.mx_attention_decode(lhs, k, v, valid, _attn_fmt(cfg),
                                       block=cfg.block,
                                       scale_mode=cfg.scale_mode)
    raise ValueError(f"unknown mx_contract kind {kind!r}; expected one of "
                     "['attn_decode', 'dense', 'flash_attn'] (the other "
                     "reference kinds come with later slices of the port)")
