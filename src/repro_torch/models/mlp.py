"""Feed-forward blocks: GeLU/ReLU MLP and the SwiGLU/GeGLU gated variants.

Counterpart of ``repro.models.mlp``.  The gated variants add the
reference's ``w_gate`` leaf: swiglu is ``silu(gate) * up`` and geglu
``gelu(gate) * up``.  The reference's ``jax.nn.gelu`` is the tanh
approximation; XLA:CPU rounds its bf16 intermediates, so outputs can differ
from PyTorch's fp32-then-round by one bf16 ulp (the tests' tolerances say
so).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import QuantConfig
from .layers import dense_init, qdense

__all__ = ["mlp_init", "mlp_apply", "ACTIVATIONS", "GATED"]

ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
}

#: The gated activations: the function applied to the gate projection.
GATED = {"swiglu": ACTIVATIONS["silu"], "geglu": ACTIVATIONS["gelu"]}


def mlp_init(generator: torch.Generator, d_model: int, d_ff: int,
             act: str = "gelu", n_layers: int = 1,
             init: str = "trunc_normal"):
    if act not in ACTIVATIONS and act not in GATED:
        raise ValueError(f"unknown activation {act!r}")
    p = {"w_up": dense_init(generator, d_model, d_ff, init=init),
         "w_down": dense_init(generator, d_ff, d_model, init=init,
                              std=1.0 / math.sqrt(d_ff * 2 * n_layers))}
    if act in GATED:
        p["w_gate"] = dense_init(generator, d_model, d_ff, init=init)
    return p


def mlp_apply(p, x: torch.Tensor, qcfg: QuantConfig, act: str = "gelu"
              ) -> torch.Tensor:
    up = qdense(p["w_up"], x, qcfg)
    if act in GATED:
        h = GATED[act](qdense(p["w_gate"], x, qcfg)) * up
    else:
        h = ACTIVATIONS[act](up)
    return qdense(p["w_down"], h, qcfg)
