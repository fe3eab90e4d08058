"""Quantization configuration: precision schemes, mitigations, interventions.

A :class:`QuantConfig` names the element format of each GEMM operand in each
pass, mirroring the paper's sweep axes (§3.1, App. A):

  forward  : y  = Q[a_fwd](x) @ Q[w_fwd](W)          (blocks along K)
  dgrad    : dx = Q[g_bwd](dy) @ Q[w_bwd](W)^T        (blocks along N)
  wgrad    : dW = Q[a_bwd](x)^T @ Q[g_bwd](dy)        (blocks along tokens)

plus the layernorm affine format (``ln_fmt`` — the paper's §6.1 culprit) and
whether attention BMMs are quantized.  ``None`` anywhere means "bfloat16"
(no element quantization).  A copy of ``repro.core.qconfig``:
``to_dict``/``from_dict`` are the reference's, so a config crosses
between the two packages as a dict.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .formats import E2M1, E2M3, E3M2, E4M3, E5M2, ElementFormat, get_format
from .mx import MX_BLOCK

__all__ = ["QuantConfig", "PRESETS", "preset", "list_presets",
           "apply_intervention", "INTERVENTIONS", "list_interventions"]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    # Forward-pass operand formats.
    w_fwd: Optional[ElementFormat] = None
    a_fwd: Optional[ElementFormat] = None
    # Backward-pass operand formats (None = bf16 in that GEMM).
    w_bwd: Optional[ElementFormat] = None
    g_bwd: Optional[ElementFormat] = None
    a_bwd: Optional[ElementFormat] = None
    # Layer-norm affine parameter format (paper §6.1).  Follows a_fwd in the
    # fully-quantized baseline; None under the "bf16 activations" mitigation.
    ln_fmt: Optional[ElementFormat] = None
    # Quantize attention score/value BMMs (the MX library quantizes MatMul/BMM).
    attn: bool = True
    block: int = MX_BLOCK
    scale_mode: str = "floor"  # "floor" | "bump" | "adaptive"

    # ---- derived ----------------------------------------------------------
    @property
    def quantize_bwd(self) -> bool:
        return any(f is not None for f in (self.w_bwd, self.g_bwd, self.a_bwd))

    @property
    def is_noop(self) -> bool:
        return (not self.quantize_bwd and self.w_fwd is None
                and self.a_fwd is None and self.ln_fmt is None)

    def describe(self) -> str:
        n = lambda f: f.name if f is not None else "bf16"
        return (f"w={n(self.w_fwd)}/a={n(self.a_fwd)} "
                f"bwd[w={n(self.w_bwd)},g={n(self.g_bwd)},a={n(self.a_bwd)}] "
                f"ln={n(self.ln_fmt)} attn={int(self.attn)} "
                f"scale={self.scale_mode}")

    # ---- serialization (checkpoint meta round-trip) ------------------------
    def to_dict(self) -> dict:
        """JSON-able form; ``from_dict`` inverts it exactly.  Used by the
        Trainer to persist the *active* precision scheme in checkpoint meta
        so a resume cannot silently revert a mid-run intervention."""
        n = lambda f: None if f is None else f.name
        return {"w_fwd": n(self.w_fwd), "a_fwd": n(self.a_fwd),
                "w_bwd": n(self.w_bwd), "g_bwd": n(self.g_bwd),
                "a_bwd": n(self.a_bwd), "ln_fmt": n(self.ln_fmt),
                "attn": self.attn, "block": self.block,
                "scale_mode": self.scale_mode}

    @staticmethod
    def from_dict(d: dict) -> "QuantConfig":
        g = lambda k: get_format(d[k]) if d.get(k) else None
        return QuantConfig(w_fwd=g("w_fwd"), a_fwd=g("a_fwd"),
                           w_bwd=g("w_bwd"), g_bwd=g("g_bwd"),
                           a_bwd=g("a_bwd"), ln_fmt=g("ln_fmt"),
                           attn=bool(d.get("attn", True)),
                           block=int(d.get("block", MX_BLOCK)),
                           scale_mode=d.get("scale_mode", "floor"))

    # ---- constructors (paper configurations) ------------------------------
    @staticmethod
    def bf16() -> "QuantConfig":
        """Full-bf16 baseline (paper Fig. 1a)."""
        return QuantConfig()

    @staticmethod
    def full(w_fmt, a_fmt=None, g_fmt=None) -> "QuantConfig":
        """Fully quantized: both passes, both operands (paper baseline)."""
        w = _f(w_fmt)
        a = _f(a_fmt) if a_fmt is not None else w
        g = _f(g_fmt) if g_fmt is not None else a
        return QuantConfig(w_fwd=w, a_fwd=a, w_bwd=w, g_bwd=g, a_bwd=a,
                           ln_fmt=a)

    @staticmethod
    def mx_mix() -> "QuantConfig":
        """E4M3 forward / E5M2 backward (paper §4.2 asymmetric format)."""
        return QuantConfig(w_fwd=E4M3, a_fwd=E4M3, w_bwd=E5M2, g_bwd=E5M2,
                           a_bwd=E5M2, ln_fmt=E4M3)

    @staticmethod
    def forward_only(w_fmt, a_fmt=None) -> "QuantConfig":
        """Mitigation 1: quantize the forward pass only (paper §6.2/§7)."""
        w = _f(w_fmt)
        a = _f(a_fmt) if a_fmt is not None else w
        return QuantConfig(w_fwd=w, a_fwd=a, ln_fmt=a)

    @staticmethod
    def weights_only(w_fmt) -> "QuantConfig":
        """Mitigation 2: MX weights + bf16 activations/LN, both passes.

        The paper's best recipe (E4M3 weights + bf16 activations matches the
        bf16 baseline, Table 1)."""
        w = _f(w_fmt)
        return QuantConfig(w_fwd=w, a_fwd=None, w_bwd=w, g_bwd=None,
                           a_bwd=None, ln_fmt=None, attn=False)

    # ---- modifiers (paper Fig. 7 interventions) ----------------------------
    def without_ln_quant(self) -> "QuantConfig":
        return dataclasses.replace(self, ln_fmt=None)

    def without_bwd_quant(self) -> "QuantConfig":
        return dataclasses.replace(self, w_bwd=None, g_bwd=None, a_bwd=None)

    def with_bf16_activations(self) -> "QuantConfig":
        return dataclasses.replace(self, a_fwd=None, a_bwd=None, g_bwd=None,
                                   ln_fmt=None, attn=False)

    def with_bumped_scale(self) -> "QuantConfig":
        return dataclasses.replace(self, scale_mode="bump")

    def with_adaptive_scale(self) -> "QuantConfig":
        return dataclasses.replace(self, scale_mode="adaptive")

    def to_fp32(self) -> "QuantConfig":
        return QuantConfig(attn=False)


def _f(fmt) -> Optional[ElementFormat]:
    return get_format(fmt) if isinstance(fmt, str) else fmt


# Named presets used across benchmarks / configs / the launcher CLI.
PRESETS = {
    "bf16": QuantConfig.bf16,
    "mxfp8_e4m3": lambda: QuantConfig.full(E4M3),
    "mxfp8_e5m2": lambda: QuantConfig.full(E5M2),
    "mxfp6_e2m3": lambda: QuantConfig.full(E2M3),
    "mxfp6_e3m2": lambda: QuantConfig.full(E3M2),
    "mxfp4_e2m1": lambda: QuantConfig.full(E2M1),
    "mx_mix": QuantConfig.mx_mix,
    # Paper §7 stabilized recipes.
    "e4m3_bf16act": lambda: QuantConfig.weights_only(E4M3),
    "e5m2_bf16act": lambda: QuantConfig.weights_only(E5M2),
    "e4m3_fwd_only": lambda: QuantConfig.forward_only(E4M3),
    "e5m2_fwd_only": lambda: QuantConfig.forward_only(E5M2),
    # FP4 variants of the same mitigations (the Fig. 6 sweep schemes — FP4
    # amplifies the bias so CPU-scale budgets show the ordering).
    "e2m1_fwd_only": lambda: QuantConfig.forward_only(E2M1),
    "e2m1_bf16act": lambda: QuantConfig.weights_only(E2M1),
    # Beyond-paper: adaptive shared scale on the fully-quantized baseline.
    "mxfp8_e4m3_adaptive": lambda: QuantConfig.full(E4M3).with_adaptive_scale(),
    "mxfp4_e2m1_adaptive": lambda: QuantConfig.full(E2M1).with_adaptive_scale(),
}


def list_presets() -> list:
    """Sorted names accepted by :func:`preset` (CLI / policy parsers)."""
    return sorted(PRESETS)


def preset(name: str) -> QuantConfig:
    if name not in PRESETS:
        raise KeyError(
            f"unknown precision preset {name!r}; know {list_presets()}")
    return PRESETS[name]()


# In-situ interventions (paper Fig. 7): name -> QuantConfig transform.
INTERVENTIONS = {
    "fp32": lambda c: c.to_fp32(),
    "no_bwd_quant": lambda c: c.without_bwd_quant(),
    "bf16_activations": lambda c: c.with_bf16_activations(),
    "skip_ln_quant": lambda c: c.without_ln_quant(),
    "bump_exponent": lambda c: c.with_bumped_scale(),
    "adaptive_scale": lambda c: c.with_adaptive_scale(),
    "none": lambda c: c,
}


def list_interventions() -> list:
    """Sorted names accepted by :func:`apply_intervention` (guard policy
    ladders and RunSpec phases validate against this)."""
    return sorted(INTERVENTIONS)


def apply_intervention(cfg: QuantConfig, name: str) -> QuantConfig:
    if name not in INTERVENTIONS:
        raise KeyError(
            f"unknown intervention {name!r}; know {list_interventions()}")
    return INTERVENTIONS[name](cfg)
