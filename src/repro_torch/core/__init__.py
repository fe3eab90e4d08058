"""MX block-scaled quantization core, in PyTorch (see ``repro.core``)."""
from .formats import (BF16, E2M1, E2M3, E3M2, E4M3, E5M2, FORMATS,
                      ElementFormat, get_format, positive_codes,
                      quantize_elem)
from .mx import MX_BLOCK, mx_stats, quantize_mx
from .qconfig import (INTERVENTIONS, PRESETS, QuantConfig, apply_intervention,
                      list_interventions, list_presets, preset)
from .attnspec import AttnSpec
from .qlinear import mx_contract
from .diagnostics import (BatchedSpikeDetector, SpikeDetector,
                          grad_bias_probe, ln_clamp_stats, zeta_bound,
                          zeta_bound_lanes)

__all__ = [
    "BF16", "E2M1", "E2M3", "E3M2", "E4M3", "E5M2", "FORMATS",
    "ElementFormat", "get_format", "positive_codes", "quantize_elem",
    "MX_BLOCK", "mx_stats", "quantize_mx",
    "INTERVENTIONS", "PRESETS", "QuantConfig", "apply_intervention", "preset",
    "list_interventions", "list_presets", "AttnSpec", "mx_contract",
    "SpikeDetector", "BatchedSpikeDetector", "grad_bias_probe",
    "ln_clamp_stats", "zeta_bound", "zeta_bound_lanes",
]
