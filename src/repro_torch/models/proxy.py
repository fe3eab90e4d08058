"""Student-teacher residual MLP proxy (paper §4, Eq. 1).

Counterpart of ``repro.models.proxy``:

  A_0 = x;  h_k = W1_k LN(A_{k-1});  A_k = A_{k-1} + W2_k phi(h_k)

The teacher has the same architecture without the layernorms; targets get
N(0, 1e-3) label noise.  Inputs are standard normals drawn from a
``torch.Generator`` seeded from (seed, step), so every precision re-run
sees the same batches (the paper's §4.1 protocol); the law is the
reference's, the bits are not.  The activations stay fp32 as in the
reference, so the MX GEMM kernels run on fp32 operands (every proxy GEMM
is quantized under the MX presets).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import QuantConfig
from repro_torch.devices import resolve_device
from .layers import apply_norm, dense_init, norm_init, qdense
from .transformer import tree_map

__all__ = ["ProxyConfig", "proxy_init", "teacher_init", "proxy_apply",
           "proxy_batch", "proxy_loss"]


@dataclasses.dataclass(frozen=True)
class ProxyConfig:
    d_model: int = 512
    n_layers: int = 4
    act: str = "gelu"                # "relu" | "gelu" | "swiglu"
    use_ln: bool = True
    init: str = "kaiming_uniform"    # | "xavier_lowgain" | "trunc_normal"
    label_noise: float = 1e-3
    batch_size: int = 2048

    @property
    def d_hidden(self) -> int:
        if self.act == "swiglu":
            return int(8 * self.d_model / 3 / 32) * 32
        return 4 * self.d_model


def _layer_init(generator, cfg: ProxyConfig, with_ln: bool):
    p = {"w1": dense_init(generator, cfg.d_model, cfg.d_hidden,
                          init=cfg.init),
         "w2": dense_init(generator, cfg.d_hidden, cfg.d_model,
                          init=cfg.init)}
    if cfg.act == "swiglu":
        p["w1g"] = dense_init(generator, cfg.d_model, cfg.d_hidden,
                              init=cfg.init)
    if with_ln:
        p["ln"] = norm_init(cfg.d_model, "layernorm", generator.device)
    return p


def proxy_init(generator: torch.Generator, cfg: ProxyConfig,
               with_ln: Optional[bool] = None, device=None):
    """fp32 weights drawn on ``generator.device``, moved to ``device``
    (default ``cuda``)."""
    device = resolve_device(device)
    with_ln = cfg.use_ln if with_ln is None else with_ln
    params = {"layers": [_layer_init(generator, cfg, with_ln)
                         for _ in range(cfg.n_layers)]}
    return tree_map(lambda t: t.to(device), params)


def teacher_init(generator: torch.Generator, cfg: ProxyConfig, device=None):
    """The teacher: the same architecture without layernorm (§4.1)."""
    return proxy_init(generator, cfg, with_ln=False, device=device)


def proxy_apply(params, x: torch.Tensor, cfg: ProxyConfig,
                qcfg: QuantConfig) -> torch.Tensor:
    a = x
    for p in params["layers"]:
        h_in = apply_norm(p["ln"], a, qcfg, "layernorm") if "ln" in p else a
        h = qdense(p["w1"], h_in, qcfg)
        if cfg.act == "swiglu":
            phi = F.silu(qdense(p["w1g"], h_in, qcfg)) * h
        elif cfg.act == "relu":
            phi = F.relu(h)
        else:
            phi = F.gelu(h, approximate="tanh")
        a = a + qdense(p["w2"], phi, qcfg)
    return a


def proxy_batch(step: int, teacher_params, cfg: ProxyConfig, seed: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step-indexed batch (x, y) on the teacher's device: the same data
    order for every re-run."""
    device = teacher_params["layers"][0]["w1"]["w"].device
    g = torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)
    x = torch.randn((cfg.batch_size, cfg.d_model), generator=g,
                    device=device)
    with torch.no_grad():
        y = proxy_apply(teacher_params, x, cfg, QuantConfig.bf16().to_fp32())
        y = y + cfg.label_noise * torch.randn(y.shape, generator=g,
                                              device=device)
    return x, y


def proxy_loss(params, batch, cfg: ProxyConfig, qcfg: QuantConfig):
    x, y = batch
    pred = proxy_apply(params, x, cfg, qcfg)
    loss = torch.mean(torch.square(pred - y))
    return loss, {"loss": loss}
