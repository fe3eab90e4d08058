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

Lanes (a sweep's pack of runs, the reference's ``vmap``): a tree whose
leaves carry a leading lane axis (``stack_lanes``) goes through
``proxy_apply`` and ``proxy_loss`` unchanged: its weights (L, K, N) take
the "bmm" kind (one lane kernel launch per GEMM, whatever L is), its
layernorm affines (L, d) broadcast over each lane's rows, and the loss is
one value per lane.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core import QuantConfig
from repro_torch.devices import resolve_device
from .layers import apply_norm, dense_init, norm_init, qdense
from .transformer import tree_map

__all__ = ["ProxyConfig", "proxy_init", "teacher_init", "proxy_apply",
           "proxy_batch", "proxy_loss", "stack_lanes", "unstack_lanes"]


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


def proxy_batch(step: int, teacher_params, cfg: ProxyConfig,
                seed: Union[int, Sequence[int]] = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step-indexed batch (x, y) on the teacher's device: the same data
    order for every re-run.  With a lane-stacked teacher, ``seed`` holds
    one seed a lane and each lane's batch is drawn as a one-lane run
    draws it: x and the label noise from the lane's own generator, y from
    the lane's teacher on its own x.  Those are the only launches of a
    pack's step that grow with the lane count; a batched teacher product
    would give other bits at another lane count (cuBLAS picks its split
    of the contraction by the batch's size)."""
    w = teacher_params["layers"][0]["w1"]["w"]
    device = w.device
    seeds = [seed] if w.ndim == 2 else list(seed)
    gens = [torch.Generator(device=device).manual_seed(s * 1_000_003 + step)
            for s in seeds]
    shape = (cfg.batch_size, cfg.d_model)
    xs = [torch.randn(shape, generator=g, device=device) for g in gens]
    fp32 = QuantConfig.bf16().to_fp32()
    with torch.no_grad():
        if w.ndim == 2:
            x = xs[0]
            y = proxy_apply(teacher_params, x, cfg, fp32)
        else:
            x = torch.stack(xs)
            y = torch.stack([proxy_apply(t, xl, cfg, fp32) for t, xl in
                             zip(unstack_lanes(teacher_params), xs)])
        noise = [torch.randn(shape, generator=g, device=device)
                 for g in gens]
        y = y + cfg.label_noise * (noise[0] if w.ndim == 2
                                   else torch.stack(noise))
    return x, y


def proxy_loss(params, batch, cfg: ProxyConfig, qcfg: QuantConfig):
    """Mean squared error: a 0-d loss, or (L,) for lane-stacked params and
    batch (each lane's mean over its own batch)."""
    x, y = batch
    pred = proxy_apply(params, x, cfg, qcfg)
    sq = torch.square(pred - y)
    loss = torch.mean(sq) if x.ndim == 2 else torch.mean(
        sq.reshape(sq.shape[0], -1), dim=1)
    return loss, {"loss": loss}


def stack_lanes(trees: Sequence) -> dict:
    """One tree whose leaves stack the trees' leaves along a new lane axis
    0 (the trees share one structure)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_lanes([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [stack_lanes([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack(list(trees))


def unstack_lanes(tree, n: Optional[int] = None) -> List:
    """The inverse of :func:`stack_lanes`: one tree per lane (views)."""
    if n is None:
        leaf = tree
        while isinstance(leaf, (dict, list, tuple)):
            leaf = (next(iter(leaf.values())) if isinstance(leaf, dict)
                    else leaf[0])
        n = leaf.shape[0]
    return [tree_map(lambda t, i=i: t[i], tree) for i in range(n)]
