"""AdamW (and SGD with momentum for the App. B ablation), from scratch.

Counterpart of ``repro.optim.adamw``: master weights and moments are fp32;
MX quantization touches only GEMM operands, except for two options:

  * ``master=True``: params may be bf16 compute copies while fp32 masters
    ride in the optimizer state.
  * ``moment_fmt``: the Adam moments are MX quantize-dequantized along
    their last axis after each update (the quantize kernel on CUDA).

Trees are nested dicts/lists of tensors.  Unlike the reference, which
returns new trees, the updates run in place under ``torch.no_grad()``
(the parameters and the state are overwritten, and the same objects are
returned), so a step allocates no second copy of the model.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import ElementFormat
from repro_torch.kernels import ops

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "clip_by_global_norm", "sgd_init", "sgd_update"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    master: bool = False
    moment_fmt: Optional[ElementFormat] = None   # MX-compressed moments


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in order) of each leaf's fp32 sum of
    squares, a 0-d tensor on the leaves' device."""
    total = None
    for x in _leaves(tree):
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled by min(1, max_norm / max(norm, 1e-12)), norm)."""
    gn = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return _map(lambda x: (x.to(torch.float32) * scale).to(x.dtype),
                tree), gn


def _mxq_moment(x: torch.Tensor, fmt) -> torch.Tensor:
    if fmt is None or x.ndim == 0 or x.shape[-1] < 2:
        return x
    return ops.mx_quantize(x, fmt, axis=-1)


def adamw_init(params, cfg: AdamWConfig):
    first = next(_leaves(params))
    zeros = lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                  device=t.device)
    state = {"m": _map(zeros, params), "v": _map(zeros, params),
             "count": torch.zeros((), dtype=torch.int32,
                                  device=first.device)}
    if cfg.master:
        state["master"] = _map(
            lambda t: t.detach().to(torch.float32).clone(), params)
    return state


@torch.no_grad()
def adamw_update(grads, state, params, lr, cfg: AdamWConfig):
    """One AdamW step in place.  ``lr`` is a float or a 0-d tensor.
    Returns (params, state, {"grad_norm": 0-d tensor})."""
    grads = _map(lambda g: g.to(torch.float32), grads)
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)
    state["count"].add_(1)
    count = state["count"].to(torch.float32)
    b1c = 1.0 - cfg.b1 ** count
    b2c = 1.0 - cfg.b2 ** count
    lr = torch.as_tensor(lr, dtype=torch.float32).to(count.device)
    ref = state.get("master", params)
    for p, r, m, v, g in zip(_leaves(params), _leaves(ref),
                             _leaves(state["m"]), _leaves(state["v"]),
                             _leaves(grads)):
        m.copy_(_mxq_moment(cfg.b1 * m + (1 - cfg.b1) * g, cfg.moment_fmt))
        v.copy_(_mxq_moment(cfg.b2 * v + (1 - cfg.b2) * g * g,
                            cfg.moment_fmt))
        step = m / b1c / (torch.sqrt(v / b2c) + cfg.eps)
        rf = r.to(torch.float32)
        new = rf - lr * (step + cfg.weight_decay * rf)
        if r is not p:
            r.copy_(new)
        p.copy_(new.to(p.dtype))
    return params, state, {"grad_norm": gnorm}


def sgd_init(params, momentum: float = 0.9):
    first = next(_leaves(params))
    return {"mom": _map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                              device=t.device), params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=first.device)}


@torch.no_grad()
def sgd_update(grads, state, params, lr, momentum: float = 0.9,
               grad_clip: float = 1.0):
    """SGD with momentum, in place; returns (params, state, metrics)."""
    grads = _map(lambda g: g.to(torch.float32), grads)
    if grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
    else:
        gnorm = global_norm(grads)
    for p, m, g in zip(_leaves(params), _leaves(state["mom"]),
                       _leaves(grads)):
        m.copy_(momentum * m + g)
        p.copy_((p.to(torch.float32) - lr * m).to(p.dtype))
    state["count"].add_(1)
    return params, state, {"grad_norm": gnorm}
