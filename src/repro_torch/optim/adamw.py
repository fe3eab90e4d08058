"""AdamW (and SGD with momentum for the App. B ablation), from scratch.

Counterpart of ``repro.optim.adamw``: master weights and moments are fp32;
MX quantization touches only GEMM operands, except for two options:

  * ``master=True``: params may be bf16 compute copies while fp32 masters
    ride in the optimizer state.
  * ``moment_fmt``: the Adam moments are MX quantize-dequantized along
    their last axis after each update (the quantize kernel on CUDA).

Lanes (a sweep's pack of runs, the reference's ``vmap`` of the update):
with ``lanes=True`` every leaf carries a leading lane axis, ``lr`` is a
float or one value a lane, (L,), and the global norm and its clipping are
per lane, so ``grad_norm`` is (L,).  A one-lane call gives the unbatched
update's bits; with more lanes a lane's norm may sum in another order.

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


def global_norm(tree, lanes: bool = False) -> torch.Tensor:
    """sqrt of the sum over leaves (in order) of each leaf's fp32 sum of
    squares, a 0-d tensor on the leaves' device; with ``lanes`` one norm a
    lane, (L,)."""
    total = None
    for x in _leaves(tree):
        sq = torch.square(x.to(torch.float32))
        s = (torch.sum(sq.reshape(sq.shape[0], -1), dim=1) if lanes
             else torch.sum(sq))
        total = s if total is None else total + s
    return torch.sqrt(total)


def _per_lane(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(L,) values shaped to broadcast over a (L, ...) leaf."""
    return v.reshape(v.shape + (1,) * (x.ndim - v.ndim))


def _clip_scale(tree, max_norm: float, lanes: bool = False):
    """(min(1, max_norm / max(norm, 1e-12)), norm) of the global norm."""
    gn = global_norm(tree, lanes)
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0), gn


def _scaled(x: torch.Tensor, scale) -> torch.Tensor:
    return (x.to(torch.float32) * _per_lane(scale, x)).to(x.dtype)


def clip_by_global_norm(tree, max_norm: float, lanes: bool = False):
    """(tree scaled by min(1, max_norm / max(norm, 1e-12)), norm); with
    ``lanes`` each lane by its own norm."""
    scale, gn = _clip_scale(tree, max_norm, lanes)
    return _map(lambda x: _scaled(x, scale), tree), gn


def _lr(lr, device) -> torch.Tensor:
    return torch.as_tensor(lr, dtype=torch.float32).to(device)


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
def adamw_update(grads, state, params, lr, cfg: AdamWConfig,
                 lanes: bool = False):
    """One AdamW step in place.  ``lr`` is a float or a 0-d tensor (with
    ``lanes`` also (L,)).  Returns (params, state, {"grad_norm": 0-d
    tensor, or (L,) with ``lanes``})."""
    grads = _map(lambda g: g.to(torch.float32), grads)
    # the clip's scale is applied leaf by leaf in the loop below, so no
    # second copy of every gradient is held at once
    scale = None
    if cfg.grad_clip > 0:
        scale, gnorm = _clip_scale(grads, cfg.grad_clip, lanes)
    else:
        gnorm = global_norm(grads, lanes)
    state["count"].add_(1)
    count = state["count"].to(torch.float32)
    b1c = 1.0 - cfg.b1 ** count
    b2c = 1.0 - cfg.b2 ** count
    lr = _lr(lr, count.device)
    ref = state.get("master", params)
    for p, r, m, v, g in zip(_leaves(params), _leaves(ref),
                             _leaves(state["m"]), _leaves(state["v"]),
                             _leaves(grads)):
        if scale is not None:
            g = _scaled(g, scale)
        m.copy_(_mxq_moment(cfg.b1 * m + (1 - cfg.b1) * g, cfg.moment_fmt))
        v.copy_(_mxq_moment(cfg.b2 * v + (1 - cfg.b2) * g * g,
                            cfg.moment_fmt))
        step = m / b1c / (torch.sqrt(v / b2c) + cfg.eps)
        rf = r.to(torch.float32)
        lr_p = _per_lane(lr, rf) if lanes else lr
        new = rf - lr_p * (step + cfg.weight_decay * rf)
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
               grad_clip: float = 1.0, lanes: bool = False):
    """SGD with momentum, in place; returns (params, state, metrics).
    ``lanes`` as in :func:`adamw_update`."""
    grads = _map(lambda g: g.to(torch.float32), grads)
    if grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, grad_clip, lanes)
    else:
        gnorm = global_norm(grads, lanes)
    for p, m, g in zip(_leaves(params), _leaves(state["mom"]),
                       _leaves(grads)):
        m.copy_(momentum * m + g)
        lr_p = _per_lane(_lr(lr, p.device), p) if lanes else lr
        p.copy_((p.to(torch.float32) - lr_p * m).to(p.dtype))
    state["count"].add_(1)
    return params, state, {"grad_norm": gnorm}
