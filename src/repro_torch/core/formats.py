"""Element formats for Microscaling (MX) block-scaled quantization.

PyTorch counterpart of ``repro.core.formats``: the OCP MX element types
FP8 (E4M3, E5M2), FP6 (E2M3, E3M2) and FP4 (E2M1) plus the E8M0
shared-scale range.  Casts round half to even and clamp overflowing
magnitudes to the largest normal (the paper's Eq. 10 "last bin").
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = [
    "ElementFormat", "E4M3", "E5M2", "E2M3", "E3M2", "E2M1", "BF16",
    "FORMATS", "get_format", "quantize_elem", "floor_log2", "exp2_int",
    "positive_codes", "SCALE_EMIN", "SCALE_EMAX",
]

# E8M0 shared-scale exponent range (code 255 = NaN is excluded).
SCALE_EMIN = -127
SCALE_EMAX = 127


@dataclasses.dataclass(frozen=True)
class ElementFormat:
    """A low-precision floating-point element format (see the reference
    ``ElementFormat`` for the field meanings)."""

    name: str
    ebits: int
    mbits: int
    bias: int
    max_normal: float
    has_inf_nan: bool

    @property
    def min_normal_exp(self) -> int:
        return 1 - self.bias

    @property
    def min_normal(self) -> float:
        return 2.0 ** self.min_normal_exp

    @property
    def min_subnormal(self) -> float:
        return 2.0 ** (self.min_normal_exp - self.mbits)

    @property
    def e_max(self) -> int:
        """Exponent of the largest normal number (Algorithm 1's e_max)."""
        return int(np.floor(np.log2(self.max_normal)))

    @property
    def bits(self) -> int:
        return 1 + self.ebits + self.mbits

    def __repr__(self) -> str:
        return f"ElementFormat({self.name})"


E4M3 = ElementFormat("e4m3", ebits=4, mbits=3, bias=7, max_normal=448.0,
                     has_inf_nan=False)
E5M2 = ElementFormat("e5m2", ebits=5, mbits=2, bias=15, max_normal=57344.0,
                     has_inf_nan=True)
E3M2 = ElementFormat("e3m2", ebits=3, mbits=2, bias=3, max_normal=28.0,
                     has_inf_nan=False)
E2M3 = ElementFormat("e2m3", ebits=2, mbits=3, bias=1, max_normal=7.5,
                     has_inf_nan=False)
E2M1 = ElementFormat("e2m1", ebits=2, mbits=1, bias=1, max_normal=6.0,
                     has_inf_nan=False)

#: Sentinel for "no element quantization" (operand stays bfloat16).
BF16: Optional[ElementFormat] = None

FORMATS = {f.name: f for f in (E4M3, E5M2, E3M2, E2M3, E2M1)}
FORMATS["bf16"] = None


def get_format(name: Optional[str]) -> Optional[ElementFormat]:
    if name is None:
        return None
    key = name.lower()
    if key not in FORMATS:
        raise KeyError(f"unknown element format {name!r}; know {sorted(FORMATS)}")
    return FORMATS[key]


def exp2_int(e: torch.Tensor) -> torch.Tensor:
    """Exact ``2.0**e`` for integer ``e`` by building the exponent field.

    ``exp2`` is not correctly rounded on every backend, which would put
    quantized values off the element grid.  ``e`` is clipped to the fp32
    normal range [-126, 127]."""
    e = torch.clamp(e.to(torch.int32), -126, 127)
    return ((e + 127) << 23).view(torch.float32)


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(|x|)) for positive finite fp32, read from the exponent
    field (fp32 subnormals report -127, infinities and NaN 128)."""
    bits = x.to(torch.float32).view(torch.int32)
    return ((bits >> 23) & 0xFF) - 127


def quantize_elem(x: torch.Tensor, fmt: ElementFormat) -> torch.Tensor:
    """Round ``x`` (already divided by the shared scale) onto ``fmt``'s grid:
    half to even within the exponent bin, clamp to ``±max_normal``, flush
    below the subnormal quantum, pass non-finite values through."""
    xf = x.to(torch.float32)
    mag = torch.abs(xf)
    e = floor_log2(torch.where(mag > 0, mag, torch.ones_like(mag)))
    e = torch.clamp(e, min=fmt.min_normal_exp)
    quantum = exp2_int(e - fmt.mbits)
    q = torch.round(xf / quantum) * quantum
    q = torch.clamp(q, -fmt.max_normal, fmt.max_normal)
    q = torch.where(mag > 0, q, torch.zeros_like(q))
    q = torch.where(torch.isfinite(xf), q, xf)
    return q.to(x.dtype)


def positive_codes(fmt: ElementFormat) -> np.ndarray:
    """All representable positive magnitudes of ``fmt``, ascending."""
    codes = []
    for m in range(1, 2 ** fmt.mbits):
        codes.append(m * fmt.min_subnormal)
    e_min, e_max = fmt.min_normal_exp, fmt.e_max
    for e in range(e_min, e_max + 1):
        for m in range(2 ** fmt.mbits):
            v = (1.0 + m / 2 ** fmt.mbits) * 2.0 ** e
            if v <= fmt.max_normal:
                codes.append(v)
    return np.asarray(sorted(codes), dtype=np.float64)
