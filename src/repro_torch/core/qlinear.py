"""MX-quantized contractions: the single entry point ``mx_contract``.

Counterpart of ``repro.core.qlinear``, with the kinds

  "dense"        x (..., K) @ W (K, N).  Forward, dgrad and wgrad each
                 quantize along their own contraction axis (K, N, tokens)
                 and use the MX GEMM kernels (forward, dgrad, wgrad) when
                 some operand format of that GEMM is set; with both
                 operands raw it is a plain matmul with fp32 accumulation,
                 as the reference's ``_mm``.
  "bmm"          x (..., E, T, K) @ W (E, K, N): "dense" lane by lane (the
                 reference vmaps ``_dense`` over E and the leading axes), a
                 weight per lane; each of its three GEMMs goes to the lane
                 kernels (``ops.mx_matmul_lanes`` and its dgrad/wgrad
                 twins) as "dense" goes to the 2-D ones; an unquantized
                 product is a batched matmul (``_lane_mm``).  Leading
                 axes fold into the lanes with W repeated, and W's
                 gradient sums over them.
  "flash_attn"   the fused QK^T / online softmax / PV forward on the folded
                 layout q (BH,G,Tq,d) x (k (BH,Tk,d), v (BH,Tk,dv)); masks
                 and tiles come from an AttnSpec.  Uses the flash kernels
                 (forward and dgrad) in bf16 mode too.
  "attn_decode"  the Tq = 1 shape q (BH,G,d) against a cache with a
                 validity mask (see ``kernels.ops.mx_attention_decode``).
  "attn_decode_paged"  the same against (N,ps,Hkv,d) page pools through a
                 (B,P) page table ``pages`` with a (B,P*ps) validity mask
                 (see ``kernels.ops.mx_attention_decode_paged``).
  "attn_qk" / "attn_pv"  a batched product lhs (..., M, K) @ rhs (..., K, N)
                 of attention operands (MLA's absorbed decode takes its
                 latent-space context ``pr @ ckv`` this way): with
                 ``cfg.attn`` both are cast in ``a_fwd``, lhs along K (-1)
                 and rhs along K (-2), by the quantize kernel on CUDA, and
                 the product is ``_mm``, as the reference's
                 ``_kind_attn_bmm`` (a ``jnp`` matmul outside any Pallas
                 kernel); without ``cfg.attn`` it is ``_mm`` alone.

Dispatch follows the tensor's device: the kernel wrappers launch the CUDA
kernels for CUDA tensors and run the plain versions for CPU tensors.  The
"dense" and "flash_attn" kinds are ``torch.autograd.Function``s; the
backward is the reference's custom VJP, with straight-through gradients
through every quantizer.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from .attnspec import AttnSpec
from .qconfig import QuantConfig

__all__ = ["mx_contract"]

def _mm(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    """Matmul with fp32 accumulation rounded once to ``out_dtype``.  cuBLAS
    accumulates bf16 products in fp32 (reduced-precision reductions are off,
    see ``repro_torch/__init__.py``); on the CPU the product runs in fp32."""
    if a.is_cuda:
        return torch.matmul(a, b).to(out_dtype)
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def _attn_fmt(cfg: QuantConfig):
    return cfg.a_fwd if cfg.attn else None


def _kernel_gemm(dtype, fmt_a, fmt_b) -> bool:
    """Whether a GEMM goes to an MX GEMM kernel: some operand is quantized,
    and an fp32 product has both quantized (MX values are exact in the
    kernels' bf16 tiles; a raw fp32 operand is not)."""
    if fmt_a is None and fmt_b is None:
        return False
    return dtype == torch.bfloat16 or (fmt_a is not None
                                       and fmt_b is not None)


def _gemm(kernel, product, a, b, fmt_a, fmt_b, axes, cfg: QuantConfig):
    """One GEMM of the dense contraction: the MX kernel when
    ``_kernel_gemm`` says so, else ``product`` of the operands quantized
    along ``axes`` (the quantize kernel on CUDA), as the reference's
    emulation path (``quantize_mx`` then ``_mm``)."""
    if _kernel_gemm(a.dtype, fmt_a, fmt_b):
        return kernel(a, b, fmt_a, fmt_b, block=cfg.block,
                      scale_mode=cfg.scale_mode)
    return product(*(ops.mx_quantize(t, f, axis=ax, block=cfg.block,
                                     scale_mode=cfg.scale_mode)
                     for t, f, ax in zip((a, b), (fmt_a, fmt_b), axes)))


class _Dense(torch.autograd.Function):
    """forward  y  = Q[a_fwd](x) @ Q[w_fwd](W)      blocks along K
       dgrad    dx = Q[g_bwd](dy) @ Q[w_bwd](W)^T   blocks along N
       wgrad    dW = Q[a_bwd](x)^T @ Q[g_bwd](dy)   blocks along tokens
    (``repro.core.qlinear._dense_fwd`` / ``_dense_bwd``)."""

    @staticmethod
    def forward(ctx, x, w, cfg: QuantConfig):
        ctx.save_for_backward(x, w)
        ctx.cfg = cfg
        return _gemm(ops.mx_matmul, lambda a, b: _mm(a, b, x.dtype), x, w,
                     cfg.a_fwd, cfg.w_fwd, (-1, 0), cfg).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        cfg = ctx.cfg
        K, N = w.shape
        dyf = dy.reshape(-1, N)
        xf = x.reshape(-1, K)
        dx = dw = None
        if not cfg.quantize_bwd:
            if ctx.needs_input_grad[0]:
                dx = _mm(dy, w.T, x.dtype)
            if ctx.needs_input_grad[1]:
                dw = _mm(xf.T, dyf, w.dtype)
            return dx, dw, None
        if ctx.needs_input_grad[0]:
            dx = _gemm(ops.mx_matmul_dgrad,
                       lambda g, ww: _mm(g, ww.T, x.dtype), dy, w, cfg.g_bwd,
                       cfg.w_bwd, (-1, 1), cfg).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _gemm(ops.mx_matmul_wgrad, lambda a, g: _mm(a.T, g, w.dtype),
                       xf, dyf, cfg.a_bwd, cfg.g_bwd, (0, 0), cfg).to(w.dtype)
        return dx, dw, None


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


#: Lanes per call of an unquantized lane product (``_lane_mm``).
LANE_CHUNK = 8


def _lane_mm(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    """``_mm`` of lane operands (E, T, K) @ (E, K, N).  On the card the
    operands are made contiguous and the product runs on chunks of
    LANE_CHUNK lanes, the last zero padded: cuBLAS picks its kernel and
    its split of the contraction by the call's shape, batch size
    included, so a lane's bits would otherwise depend on how many lanes
    share the call (a one-lane pack against an eight-lane one)."""
    if not a.is_cuda:
        return _mm(a, b, out_dtype)
    E = a.shape[0]
    pad = -E % LANE_CHUNK
    a, b = a.contiguous(), b.contiguous()
    if pad:
        a = torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
        b = torch.cat([b, b.new_zeros((pad,) + b.shape[1:])])
    out = torch.cat([_mm(a[i:i + LANE_CHUNK], b[i:i + LANE_CHUNK],
                         out_dtype) for i in range(0, E + pad, LANE_CHUNK)])
    return out[:E]


class _Bmm(torch.autograd.Function):
    """"dense" per lane of x (E, T, K) and W (E, K, N): the forward, dgrad
    and wgrad are the lane kernels (one launch each for all E lanes), or
    the quantized operands' batched product where "dense" takes its
    emulation path."""

    @staticmethod
    def forward(ctx, x, w, cfg: QuantConfig):
        ctx.save_for_backward(x, w)
        ctx.cfg = cfg
        return _gemm(ops.mx_matmul_lanes,
                     lambda a, b: _lane_mm(a, b, x.dtype), x, w, cfg.a_fwd,
                     cfg.w_fwd, (-1, 1), cfg).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        cfg = ctx.cfg
        dx = dw = None
        if not cfg.quantize_bwd:
            if ctx.needs_input_grad[0]:
                dx = _lane_mm(dy, _t(w), x.dtype)
            if ctx.needs_input_grad[1]:
                dw = _lane_mm(_t(x), dy, w.dtype)
            return dx, dw, None
        if ctx.needs_input_grad[0]:
            dx = _gemm(ops.mx_matmul_dgrad_lanes,
                       lambda g, ww: _lane_mm(g, _t(ww), x.dtype), dy, w,
                       cfg.g_bwd, cfg.w_bwd, (-1, -1), cfg).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _gemm(ops.mx_matmul_wgrad_lanes,
                       lambda a, g: _lane_mm(_t(a), g, w.dtype), x, dy,
                       cfg.a_bwd, cfg.g_bwd, (1, 1), cfg).to(w.dtype)
        return dx, dw, None


def _bmm(lhs: torch.Tensor, rhs: torch.Tensor, cfg: QuantConfig):
    if rhs.ndim != 3 or lhs.ndim < 3 or lhs.shape[-3] != rhs.shape[0]:
        raise ValueError(f"kind='bmm' takes lhs (..., E, T, K) and rhs "
                         f"(E, K, N), got {tuple(lhs.shape)}, "
                         f"{tuple(rhs.shape)}")
    lead = lhs.shape[:-3]
    if not lead:
        return _Bmm.apply(lhs, rhs, cfg)
    E, T, K = lhs.shape[-3:]
    n = lhs.numel() // (E * T * K)
    w = rhs.unsqueeze(0).expand(n, *rhs.shape).reshape(n * E, *rhs.shape[1:])
    out = _Bmm.apply(lhs.reshape(n * E, T, K), w, cfg)
    return out.reshape(lead + (E,) + out.shape[1:])


def _attn_bmm(lhs: torch.Tensor, rhs: torch.Tensor, cfg: QuantConfig):
    """"attn_qk" / "attn_pv": ``_mm`` of lhs cast along -1 and rhs along
    -2 in ``a_fwd`` when ``cfg.attn`` (the straight-through casts carry the
    gradient), of the raw operands otherwise."""
    if cfg.attn:
        lhs = ops.mx_quantize(lhs, cfg.a_fwd, axis=-1, block=cfg.block,
                              scale_mode=cfg.scale_mode)
        rhs = ops.mx_quantize(rhs, cfg.a_fwd, axis=-2, block=cfg.block,
                              scale_mode=cfg.scale_mode)
    return _mm(lhs, rhs, lhs.dtype)


class _Flash(torch.autograd.Function):
    """Flash forward saving (q, k, v, out, lse); the backward is the flash
    dgrad (``repro.core.qlinear._flash_fwd`` / ``_flash_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, cfg: QuantConfig, spec: AttnSpec):
        out, lse = ops.mx_flash_attention(q, k, v, _attn_fmt(cfg), spec,
                                          block=cfg.block,
                                          scale_mode=cfg.scale_mode)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg, ctx.spec = cfg, spec
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        cfg = ctx.cfg
        dq, dk, dv = ops.mx_flash_attention_bwd(
            q, k, v, dout, out, lse, _attn_fmt(cfg), ctx.spec,
            block=cfg.block, scale_mode=cfg.scale_mode)
        return dq, dk, dv, None, None


def mx_contract(lhs, rhs, cfg: QuantConfig, *, kind: str = "dense",
                spec: Optional[AttnSpec] = None,
                valid: Optional[torch.Tensor] = None,
                pages: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantized contraction dispatched on ``kind`` (see module docstring).
    ``rhs`` is a tensor for "dense" and a ``(k, v)`` pair for attention;
    ``pages`` is the page table of "attn_decode_paged"."""
    if kind == "dense":
        return _Dense.apply(lhs, rhs, cfg)
    if kind == "bmm":
        return _bmm(lhs, rhs, cfg)
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
    if kind == "attn_decode_paged":
        if valid is None or pages is None:
            raise ValueError("kind='attn_decode_paged' requires valid=(B, "
                             "P*ps) mask and pages=(B, P) page table")
        k_pool, v_pool = rhs
        return ops.mx_attention_decode_paged(lhs, k_pool, v_pool, pages,
                                             valid, _attn_fmt(cfg),
                                             block=cfg.block,
                                             scale_mode=cfg.scale_mode)
    if kind in ("attn_qk", "attn_pv"):
        return _attn_bmm(lhs, rhs, cfg)
    raise ValueError(f"unknown mx_contract kind {kind!r}; expected one of "
                     "['attn_decode', 'attn_decode_paged', 'attn_pv', "
                     "'attn_qk', 'bmm', 'dense', 'flash_attn']")
