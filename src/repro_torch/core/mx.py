"""MX block-scaled quantization (Algorithm 1 of the paper), in PyTorch.

Counterpart of ``repro.core.mx``: a block of 32 consecutive values along
an axis shares the power-of-two scale ``2^(floor(log2 max|V|) - e_max)``;
values are cast onto the element grid after dividing by it.  Arrays stay
in their container dtype and carry exactly representable MX values.

Scale modes: "floor" (OCP rule), "bump" (+1 on blocks that would clamp,
the paper's Fig. 7 intervention) and "adaptive" (per-block least squared
error between floor and floor+1).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .formats import (SCALE_EMAX, SCALE_EMIN, ElementFormat, exp2_int,
                      floor_log2, quantize_elem)

__all__ = ["quantize_mx", "block_reshape", "block_unreshape",
           "shared_exponent", "mx_stats", "MX_BLOCK"]

MX_BLOCK = 32


def block_reshape(x: torch.Tensor, axis: int, block: int
                  ) -> Tuple[torch.Tensor, int]:
    """Move ``axis`` last and fold it into (..., n_blocks, block), zero-padding
    a partial last block (zeros never raise a block max)."""
    x = torch.movedim(x, axis, -1)
    n = x.shape[-1]
    pad = (-n) % block
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(x.shape[:-1] + ((n + pad) // block, block)), n


def block_unreshape(xb: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """Inverse of :func:`block_reshape`."""
    x = xb.reshape(xb.shape[:-2] + (xb.shape[-2] * xb.shape[-1],))
    return torch.movedim(x[..., :n], -1, axis)


def _block_sq_err(xb: torch.Tensor, e: torch.Tensor,
                  fmt: ElementFormat) -> torch.Tensor:
    scale = exp2_int(e)
    y = quantize_elem(xb / scale, fmt) * scale
    return torch.sum(torch.square(y - xb), dim=-1, keepdim=True)


def shared_exponent(xb: torch.Tensor, fmt: ElementFormat,
                    scale_mode: str = "floor") -> torch.Tensor:
    """Per-block shared exponent (Algorithm 1, line 3), int32 (..., nb, 1)."""
    m = torch.amax(torch.abs(xb), dim=-1, keepdim=True)
    e = floor_log2(torch.where(m > 0, m, torch.ones_like(m))) - fmt.e_max
    if scale_mode == "bump":
        x_over = torch.abs(xb) / exp2_int(e)
        overflow = torch.any(x_over > fmt.max_normal, dim=-1, keepdim=True)
        e = e + overflow.to(torch.int32)
    elif scale_mode == "adaptive":
        err0 = _block_sq_err(xb, e, fmt)
        err1 = _block_sq_err(xb, e + 1, fmt)
        e = torch.where(err1 < err0, e + 1, e)
    elif scale_mode != "floor":
        raise ValueError(f"unknown scale_mode {scale_mode!r}")
    e = torch.clamp(e, SCALE_EMIN + 1, SCALE_EMAX)
    return torch.where(m > 0, e, torch.full_like(e, SCALE_EMIN + 1))


def quantize_mx(x: torch.Tensor, fmt: Optional[ElementFormat], axis: int = -1,
                block: int = MX_BLOCK, scale_mode: str = "floor"
                ) -> torch.Tensor:
    """Quantize-dequantize ``x`` to the MX grid along ``axis``.

    ``fmt=None`` returns ``x``.  The straight-through estimator is
    assembled in fp32 and cast afterwards, as in the reference: every MX
    value is bf16-representable, so the cast is exact, and the forward
    value is the reference's bit for bit (an infinite input comes out NaN
    there, and here too)."""
    if fmt is None:
        return x
    xf = x.to(torch.float32)
    xb, n = block_reshape(xf, axis, block)
    scale = exp2_int(shared_exponent(xb, fmt, scale_mode))
    yb = quantize_elem(xb / scale, fmt) * scale
    y = block_unreshape(yb, axis, n)
    return (xf + (y - xf).detach()).to(x.dtype)


def mx_stats(x: torch.Tensor, fmt: ElementFormat, axis: int = -1,
             block: int = MX_BLOCK, scale_mode: str = "floor") -> dict:
    """Clamping diagnostics of the paper's Fig. 5 / Eq. 10, as 0-d fp32
    tensors (``repro.core.mx.mx_stats``): ``overflow_frac`` (|v/X| above
    max_normal), ``last_bin_frac`` (values that land on +-max_normal),
    ``tight_block_frac`` (blocks whose every value lands there) and
    ``rel_err`` (mean |y - x| / (|x| + 1e-12)); padded lanes excluded."""
    xf = x.detach().to(torch.float32)
    xb, n = block_reshape(xf, axis, block)
    mask = (torch.arange(xb.shape[-1] * xb.shape[-2], device=xb.device)
            .reshape(xb.shape[-2:]) < n).expand(xb.shape)
    scale = exp2_int(shared_exponent(xb, fmt, scale_mode))
    r = xb / scale
    q = quantize_elem(r, fmt)
    total = torch.clamp(mask.sum(), min=1).to(torch.float32)
    overflow = ((r.abs() > fmt.max_normal) & mask).sum() / total
    last_bin = (q.abs() >= fmt.max_normal) & mask
    tight = torch.all(last_bin | ~mask, dim=-1) & torch.any(mask, dim=-1)
    y = q * scale
    rel_err = torch.sum((y - xb).abs() / (xb.abs() + 1e-12) * mask) / total
    return {"overflow_frac": overflow,
            "last_bin_frac": last_bin.sum() / total,
            "tight_block_frac": tight.to(torch.float32).mean(),
            "rel_err": rel_err}
