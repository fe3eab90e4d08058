"""Instability diagnostics: gradient-bias probe, zeta-norm bound, clamp
statistics and the loss-spike watchdog.

Counterpart of ``repro.core.diagnostics`` (the paper's §5 methodology):

  eps_t = g~_t - g_t            (Eq. 2; g~ low-precision grad, g exact)
  ||zeta_t||_op >= ||eps_t|| / ||g_t||   (lower bound from Eq. 4)

plus the §6.1 clamp-fraction monitors and the App. B spike heuristic.
Gradient trees are nested dicts/lists of tensors; results are 0-d tensors
on the trees' device (no host sync), or (L,) for lane-stacked trees
(``zeta_bound_lanes``), except ``SpikeDetector`` and
``BatchedSpikeDetector``, which consume floats.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from .mx import mx_stats
from .qconfig import QuantConfig

__all__ = ["SpikeDetector", "BatchedSpikeDetector", "grad_bias_probe",
           "ln_clamp_stats", "zeta_bound", "zeta_bound_lanes",
           "tree_leaves_with_path"]


def tree_leaves_with_path(tree, prefix=()):
    """(path, tensor) pairs of a nested dict/list tree in insertion order;
    a path is a tuple of dict keys and list indices."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves_with_path(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, prefix + (i,))
    else:
        yield prefix, tree


def _flat(tree) -> torch.Tensor:
    return torch.cat([t.reshape(-1).to(torch.float32)
                      for _, t in tree_leaves_with_path(tree)])


def zeta_bound(g_exact, g_quant) -> Dict[str, torch.Tensor]:
    """Global (all leaves flattened to one fp32 vector) norm ratio and
    cosine between exact and low-precision gradients:
    ``norm_ratio`` = ||g_quant - g_exact|| / ||g_exact|| (dimensionless,
    a lower bound on ||zeta||_op; divergence follows near 2, Fig. 4),
    ``cosine`` in [-1, 1], ``g_norm`` and ``gq_norm`` in loss-gradient
    units."""
    ge, gq = _flat(g_exact), _flat(g_quant)
    gn = torch.linalg.norm(ge)
    ratio = torch.linalg.norm(gq - ge) / torch.clamp(gn, min=1e-30)
    cos = torch.dot(gq, ge) / torch.clamp(torch.linalg.norm(gq) * gn,
                                          min=1e-30)
    return {"norm_ratio": ratio, "cosine": cos, "g_norm": gn,
            "gq_norm": torch.linalg.norm(gq)}


def zeta_bound_lanes(g_exact, g_quant) -> Dict[str, torch.Tensor]:
    """:func:`zeta_bound` of each lane of lane-stacked gradient trees
    (every leaf (L, ...)): each value is (L,), lane l's from lane l's
    leaves alone."""
    def flat(tree):
        return torch.cat([t.reshape(t.shape[0], -1).to(torch.float32)
                          for _, t in tree_leaves_with_path(tree)], dim=1)
    ge, gq = flat(g_exact), flat(g_quant)
    gn = torch.linalg.norm(ge, dim=1)
    gqn = torch.linalg.norm(gq, dim=1)
    ratio = torch.linalg.norm(gq - ge, dim=1) / torch.clamp(gn, min=1e-30)
    cos = torch.sum(gq * ge, dim=1) / torch.clamp(gqn * gn, min=1e-30)
    return {"norm_ratio": ratio, "cosine": cos, "g_norm": gn,
            "gq_norm": gqn}


def grad_bias_probe(grad_fn: Callable, params, batch,
                    qcfg: QuantConfig) -> Dict[str, torch.Tensor]:
    """Exact (``qcfg.to_fp32()``) against MX gradients at the same
    parameters and batch; ``grad_fn(params, batch, qcfg) -> grads``.
    Returns the :func:`zeta_bound` dict."""
    g_exact = grad_fn(params, batch, qcfg.to_fp32())
    g_quant = grad_fn(params, batch, qcfg)
    return zeta_bound(g_exact, g_quant)


def _keystr(path) -> str:
    return "".join(f"['{p}']" if isinstance(p, str) else f"[{p}]"
                   for p in path)


def ln_clamp_stats(params, qcfg: QuantConfig,
                   match: str = "ln") -> Dict[str, dict]:
    """:func:`mx_stats` of every leaf whose path contains ``match`` (the
    layernorm affine tensors), keyed by its path in the reference's keystr
    form, in the format ``qcfg.ln_fmt or qcfg.a_fwd`` (empty when both are
    None); blocks run along the flattened tensor."""
    fmt = qcfg.ln_fmt or qcfg.a_fwd
    out = {}
    if fmt is None:
        return out
    for path, leaf in tree_leaves_with_path(params):
        name = _keystr(path)
        if match in name.lower() and leaf.ndim >= 1:
            out[name] = mx_stats(leaf.reshape(-1), fmt, axis=-1,
                                 block=qcfg.block,
                                 scale_mode=qcfg.scale_mode)
    return out


class SpikeDetector:
    """Loss-spike watchdog (App. B heuristic plus gradient-norm growth).

    Flags a spike when ``loss > spike_factor * min(recent losses)``, when
    the gradient norm exceeds ``grad_factor`` times its running median, or
    when either is not finite.  Host-side: it consumes floats."""

    def __init__(self, spike_factor: float = 100.0, grad_factor: float = 50.0,
                 window: int = 64):
        self.spike_factor = spike_factor
        self.grad_factor = grad_factor
        self.window = window
        self._losses: list = []
        self._gnorms: list = []
        self.n_spikes = 0

    def update(self, loss: float, grad_norm: Optional[float] = None) -> bool:
        spiked = not math.isfinite(loss)
        if grad_norm is not None and not math.isfinite(grad_norm):
            spiked = True
        if self._losses:
            if loss > self.spike_factor * min(self._losses[-self.window:]):
                spiked = True
        if grad_norm is not None and len(self._gnorms) >= 8:
            recent = self._gnorms[-self.window:]
            med = sorted(recent)[len(recent) // 2]
            if grad_norm > self.grad_factor * max(med, 1e-30):
                spiked = True
        if math.isfinite(loss):
            self._losses.append(loss)
        if grad_norm is not None and math.isfinite(grad_norm):
            self._gnorms.append(grad_norm)
        self.n_spikes += int(spiked)
        return spiked


class BatchedSpikeDetector:
    """Per-lane spike accounting for lane-packed sweeps.

    One independent :class:`SpikeDetector` per lane: lane ``i`` sees only
    lane ``i``'s history, so a pack gives exactly the flags a standalone
    run of each lane would (no leakage through shared windows or running
    medians).  Host-side: it takes the (lanes,) per-step slices after the
    pack's device-to-host transfer.  A copy of the reference's."""

    def __init__(self, n_lanes: int, spike_factor: float = 100.0,
                 grad_factor: float = 50.0, window: int = 64):
        self.lanes = [SpikeDetector(spike_factor, grad_factor, window)
                      for _ in range(n_lanes)]

    def update(self, losses, grad_norms=None):
        """(lanes,) losses [+ grad norms] -> (lanes,) bool spike flags."""
        import numpy as np
        losses = np.asarray(losses, np.float64)
        if grad_norms is None:
            return np.asarray([d.update(float(x))
                               for d, x in zip(self.lanes, losses)])
        grad_norms = np.asarray(grad_norms, np.float64)
        return np.asarray([d.update(float(x), float(g)) for d, x, g
                           in zip(self.lanes, losses, grad_norms)])

    @property
    def n_spikes(self):
        import numpy as np
        return np.asarray([d.n_spikes for d in self.lanes])

    @staticmethod
    def flags(losses, grad_norms=None, spike_factor: float = 100.0,
              grad_factor: float = 50.0, window: int = 64):
        """(lanes, steps) histories -> (lanes, steps) bool spike flags."""
        import numpy as np
        losses = np.atleast_2d(np.asarray(losses, np.float64))
        det = BatchedSpikeDetector(losses.shape[0], spike_factor,
                                   grad_factor, window)
        out = []
        for t in range(losses.shape[1]):
            g = None if grad_norms is None else \
                np.asarray(grad_norms, np.float64)[:, t]
            out.append(det.update(losses[:, t], g))
        return np.stack(out, axis=1) if out else \
            np.zeros(losses.shape, bool)
