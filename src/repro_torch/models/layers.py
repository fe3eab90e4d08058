"""Shared layers: MX-quantized dense, norms with MX-quantized affine, RoPE.

Counterpart of ``repro.models.layers``.  Parameters are plain dicts of
tensors with the reference's names and shapes.  The norm's vector ops run
in fp32; with ``qcfg.ln_fmt`` set both the affine scale and the normalized
activations are MX-quantized along the last axis (the paper's §6.1
culprit), through the quantize kernel on CUDA.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import QuantConfig, mx_contract
from repro_torch.kernels import ops

PARAM_DTYPE = torch.float32
COMPUTE_DTYPE = torch.bfloat16

__all__ = ["dense_init", "qdense", "norm_init", "apply_norm", "embed_init",
           "embed_lookup", "rope", "conv_tail", "kaiming_uniform",
           "trunc_normal",
           "PARAM_DTYPE", "COMPUTE_DTYPE"]


def conv_tail(x: torch.Tensor, width: int) -> torch.Tensor:
    """The last ``width`` inputs of a causal conv stream (B, T, d), zero-
    padded on the left below T = width: the decode carry of a depthwise
    conv of width ``width + 1`` after the whole sequence."""
    zeros = x.new_zeros((x.shape[0], width, x.shape[-1]))
    return torch.cat([zeros, x], 1)[:, -width:]


def trunc_normal(shape, std: float, generator: torch.Generator
                 ) -> torch.Tensor:
    """``std`` times a standard normal truncated to [-3, 3], as the
    reference's ``trunc_normal`` (same distribution, not the same bits)."""
    t = torch.empty(shape, dtype=PARAM_DTYPE, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return t * std


def kaiming_uniform(shape, generator: torch.Generator,
                    fan_in: Optional[int] = None, gain: float = 1.0
                    ) -> torch.Tensor:
    """PyTorch-default init, U(-gain/sqrt(fan_in), +gain/sqrt(fan_in))
    (the paper's proxy baseline, App. B); fan_in defaults to shape[-2]."""
    fan_in = (fan_in or shape[-2]) if len(shape) >= 2 else shape[-1]
    bound = gain / math.sqrt(fan_in)
    t = torch.empty(shape, dtype=PARAM_DTYPE, device=generator.device)
    return t.uniform_(-bound, bound, generator=generator)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               std: Optional[float] = None, bias: bool = False,
               init: str = "trunc_normal"):
    """``init``: "trunc_normal" (std, default 1/sqrt(d_in)),
    "kaiming_uniform" or "xavier_lowgain" (normal, gain 0.5; App. B)."""
    if init == "kaiming_uniform":
        w = kaiming_uniform((d_in, d_out), generator, fan_in=d_in)
    elif init == "xavier_lowgain":
        std_x = 0.5 * math.sqrt(2.0 / (d_in + d_out))
        w = torch.randn((d_in, d_out), generator=generator,
                        dtype=PARAM_DTYPE, device=generator.device) * std_x
    else:
        w = trunc_normal((d_in, d_out), std or 1.0 / math.sqrt(d_in),
                         generator)
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=PARAM_DTYPE,
                             device=generator.device)
    return p


def qdense(p, x: torch.Tensor, qcfg: QuantConfig) -> torch.Tensor:
    """MX-quantized dense layer; the weight is used in ``x.dtype`` (a bf16
    weight, as the serve engine holds it, is used as it is).  A weight
    with a lane axis, (L, K, N) against x (L, T, K), takes the "bmm" kind:
    each lane is the dense layer of its own weight."""
    w = p["w"]
    lanes = w.ndim == 3
    y = mx_contract(x, w.to(x.dtype), qcfg, kind="bmm" if lanes else "dense")
    if "b" in p:
        b = p["b"].to(y.dtype)
        y = y + (b.unsqueeze(-2) if lanes else b)
    return y


def norm_init(d: int, kind: str = "rmsnorm", device=None):
    p = {"scale": torch.ones((d,), dtype=PARAM_DTYPE, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=PARAM_DTYPE, device=device)
    return p


def apply_norm(p, x: torch.Tensor, qcfg: QuantConfig, kind: str = "rmsnorm",
               eps: float = 1e-5) -> torch.Tensor:
    """Norm in fp32 with MX-quantized affine parameters (paper §6.1).  An
    affine with a lane axis, (L, d) against x (L, T, d), broadcasts over
    each lane's rows; it is still quantized along its last axis, so each
    lane's blocks are those a one-lane run quantizes."""
    xf = x.to(torch.float32)
    if kind == "layernorm":
        xf = xf - torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    xn = xf * torch.rsqrt(var + eps)
    scale = p["scale"].to(torch.float32)
    if qcfg.ln_fmt is not None:
        scale = ops.mx_quantize(scale, qcfg.ln_fmt, axis=-1, block=qcfg.block,
                                scale_mode=qcfg.scale_mode)
        xn = ops.mx_quantize(xn, qcfg.ln_fmt, axis=-1, block=qcfg.block,
                             scale_mode=qcfg.scale_mode)
    lane = (lambda t: t.unsqueeze(-2)) if scale.ndim > 1 else (lambda t: t)
    y = xn * lane(scale)
    if "bias" in p:
        y = y + lane(p["bias"].to(torch.float32))
    return y.to(x.dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int):
    return {"table": trunc_normal((vocab, d), 1.0 / math.sqrt(d), generator)}


def embed_lookup(p, ids: torch.Tensor) -> torch.Tensor:
    """Rows of the table cast to bf16, cast first as in the reference, so
    the table's gradient is summed over repeated ids in bf16 there too."""
    return p["table"].to(COMPUTE_DTYPE)[ids]


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4
         ) -> torch.Tensor:
    """Rotary embedding over the last axis, first half against second half
    (not interleaved).  x: (B, T, ..., d); positions: (B, T)."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(0, half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    extra = x.ndim - positions.ndim - 1
    ang = ang.reshape(ang.shape[:-1] + (1,) * extra + (half,))
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
