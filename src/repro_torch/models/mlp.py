"""Feed-forward block: the GeLU MLP of the OLMo family.

Counterpart of ``repro.models.mlp`` for the ungated activations.  The
reference's ``jax.nn.gelu`` is the tanh approximation; XLA:CPU rounds its
bf16 intermediates, so outputs can differ from PyTorch's fp32-then-round
by one bf16 ulp (the tests' tolerances say so).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import QuantConfig
from .layers import dense_init, qdense

__all__ = ["mlp_init", "mlp_apply", "ACTIVATIONS"]

ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
}


def mlp_init(generator: torch.Generator, d_model: int, d_ff: int,
             act: str = "gelu", n_layers: int = 1):
    if act not in ACTIVATIONS:
        raise NotImplementedError(
            f"activation {act!r}: the gated MLPs come with the slice that "
            "ports the other architectures")
    return {"w_up": dense_init(generator, d_model, d_ff),
            "w_down": dense_init(generator, d_ff, d_model,
                                 std=1.0 / math.sqrt(d_ff * 2 * n_layers))}


def mlp_apply(p, x: torch.Tensor, qcfg: QuantConfig, act: str = "gelu"
              ) -> torch.Tensor:
    return qdense(p["w_down"], ACTIVATIONS[act](qdense(p["w_up"], x, qcfg)),
                  qcfg)
