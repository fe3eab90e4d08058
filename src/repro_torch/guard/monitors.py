"""Early-warning monitors: cheap per-step risk signals and gated probes.

Counterpart of ``repro.guard.monitors``.  The paper's §5-§6 result is that
an MX divergence announces itself before the loss blows up: the
multiplicative gradient bias (ζ-bound) grows, the layernorm-affine blocks
clamp, and the gradient norm decouples from its running level.  The
Trainer's step computes those warnings on the device, so the autopilot
(``repro_torch.guard.controller``) can act on them without a host sync per
step:

* **cheap channels** (every step, a handful of scalar ops): the fast/slow
  loss EMA pair and their relative gap (the loss trend's "curvature"), the
  loss against its slow trend, and the gradient norm against its own EMA;
* **probe channels** (every ``probe_every`` steps): the ζ-bound against an
  fp32 reference gradient (one more backward), the LN-affine clamp
  fractions, and the overflow rate of the largest gradient leaves.  The
  reference gates them behind a ``lax.cond``; here the step is an int on
  the host, so :func:`probe_due` is a Python test and the probe's work is
  not launched at all on other steps.

Between probes the probe channels hold their last value and ``probe_age``
counts the steps since they were measured.  The state is
:class:`MonitorState`, a NamedTuple of 0-d tensors on the training
device; nothing here moves a value to the host.  :func:`host_signals` is
the host-side replica of the cheap channels over recorded histories that
the sweeps use to run an online policy advisorily over a pack's lanes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import QuantConfig, ln_clamp_stats, mx_stats, \
    zeta_bound
from repro_torch.core.diagnostics import tree_leaves_with_path
from repro_torch.devices import resolve_device

__all__ = ["MonitorConfig", "MonitorState", "RiskSignals", "monitor_init",
           "monitor_update", "monitor_probe", "probe_due",
           "signals_from_metrics", "host_signals", "SIGNAL_NAMES"]


@dataclasses.dataclass(frozen=True)
class MonitorConfig:
    """Monitor knobs (the reference's fields and defaults)."""
    ema_fast: float = 0.2       # fast loss EMA coefficient (per step)
    ema_slow: float = 0.02      # slow loss EMA coefficient
    gnorm_ema: float = 0.05     # grad-norm EMA coefficient
    probe_every: int = 0        # probe stride in steps; 0 disables probes
    zeta_probe: bool = True     # include the fp32 reference grad in probes
    ln_match: str = "ln"        # param-path substring naming LN affines
    max_probe_leaves: int = 8   # cap on grad leaves scanned for overflow


class RiskSignals(NamedTuple):
    """Per-step risk scalars (0-d fp32 tensors), all dimensionless:

    loss_ema_fast / loss_ema_slow — smoothed loss levels (loss units);
    loss_curvature — (fast - slow) / max(|slow|, eps): > 0 when the loss
        rises above its own trend, the pre-spike signature;
    loss_ratio     — loss / slow EMA before this step's update: the
        quantity the App.-B spike heuristic thresholds at 100x, measured
        against the trend at every step;
    gnorm_ratio    — grad norm / its EMA (1 in steady state);
    ln_tight_frac  — mean fraction of LN-affine blocks fully clamped into
        the last quantization bin (paper Fig. 5-center; probe channel);
    ln_last_bin    — mean fraction of LN-affine values in the last bin;
    grad_overflow  — mean pre-clamp overflow fraction of the largest
        gradient leaves under the backward element format;
    zeta           — ||g~ - g|| / ||g||, a lower bound on ||ζ||_op against
        the fp32 reference (probe channel; divergence follows near 2);
    cosine         — cos(g~, g) of the same probe;
    probe_age      — steps since the probe channels were last measured.
    """
    loss_ema_fast: torch.Tensor
    loss_ema_slow: torch.Tensor
    loss_curvature: torch.Tensor
    loss_ratio: torch.Tensor
    gnorm_ratio: torch.Tensor
    ln_tight_frac: torch.Tensor
    ln_last_bin: torch.Tensor
    grad_overflow: torch.Tensor
    zeta: torch.Tensor
    cosine: torch.Tensor
    probe_age: torch.Tensor


SIGNAL_NAMES = tuple(RiskSignals._fields)


class MonitorState(NamedTuple):
    count: torch.Tensor          # steps observed (int32)
    ema_fast: torch.Tensor
    ema_slow: torch.Tensor
    gnorm_ema: torch.Tensor
    ln_tight: torch.Tensor       # held probe values
    ln_last: torch.Tensor
    g_ovf: torch.Tensor
    zeta: torch.Tensor
    cosine: torch.Tensor
    probe_age: torch.Tensor


def monitor_init(mcfg: Optional[MonitorConfig] = None,
                 device=None) -> MonitorState:
    """Zeroed state (cosine 1) on ``device`` (default ``cuda``)."""
    device = resolve_device(device)

    def z():
        return torch.zeros((), dtype=torch.float32, device=device)
    return MonitorState(
        count=torch.zeros((), dtype=torch.int32, device=device),
        ema_fast=z(), ema_slow=z(), gnorm_ema=z(), ln_tight=z(),
        ln_last=z(), g_ovf=z(), zeta=z(),
        cosine=torch.ones((), dtype=torch.float32, device=device),
        probe_age=z())


def _ema(old, new, a: float, first):
    new = torch.where(torch.isfinite(new), new, old)   # never poison it
    return torch.where(first, new, (1.0 - a) * old + a * new)


def _jax_order(tree):
    """The tree with every dict's keys sorted: the order in which
    ``jax.tree.leaves`` visits the reference's trees, so the leaves that
    tie in size and the sums over leaves come in the reference's order."""
    if isinstance(tree, dict):
        return {k: _jax_order(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_jax_order(v) for v in tree]
    return tree


def _leaves(tree):
    return [t for _, t in tree_leaves_with_path(tree)]


def _ln_clamp_means(params, qcfg: QuantConfig, match: str, device):
    """Mean (tight_block_frac, last_bin_frac) over the LN-affine leaves:
    a scalar reduction of the Fig. 5 diagnostic."""
    stats = ln_clamp_stats(_jax_order(params), qcfg, match=match)
    if not stats:
        z = torch.zeros((), dtype=torch.float32, device=device)
        return z, z.clone()

    def mean_of(key):
        return torch.mean(torch.stack([s[key] for s in stats.values()])
                          ).to(torch.float32)
    return mean_of("tight_block_frac"), mean_of("last_bin_frac")


def _grad_overflow(grads, qcfg: QuantConfig, max_leaves: int, device):
    """Mean pre-clamp overflow fraction over the largest gradient leaves,
    under the backward-pass element format (g_bwd, else a_fwd)."""
    fmt = qcfg.g_bwd or qcfg.a_fwd
    leaves = [t for t in _leaves(_jax_order(grads)) if t.ndim >= 1]
    if fmt is None or not leaves:
        return torch.zeros((), dtype=torch.float32, device=device)
    leaves = sorted(leaves, key=lambda t: -t.numel())[:max_leaves]
    fracs = [mx_stats(t.reshape(-1), fmt, axis=-1, block=qcfg.block,
                      scale_mode=qcfg.scale_mode)["overflow_frac"]
             for t in leaves]
    return torch.mean(torch.stack(fracs)).to(torch.float32)


def probe_due(mcfg: MonitorConfig, step: int) -> bool:
    """Whether ``step`` (the host's int step) measures the probe
    channels."""
    return mcfg.probe_every > 0 and int(step) % mcfg.probe_every == 0


@torch.no_grad()
def monitor_probe(mcfg: MonitorConfig, *, grads, params, qcfg: QuantConfig,
                  probe_fn: Optional[Callable] = None) -> tuple:
    """The probe channels -> (ln_tight, ln_last, grad_overflow, zeta,
    cosine), 0-d fp32 tensors.  ``probe_fn() -> grads`` is the fp32
    reference gradient at the same (params, batch); it runs only here.
    The Trainer calls this before its in-place AdamW update, so the clamp
    statistics and the fp32 backward see the weights the step trained
    with, as the reference's monitor does."""
    device = _leaves(grads)[0].device
    lt, lb = _ln_clamp_means(params, qcfg, mcfg.ln_match, device)
    ovf = _grad_overflow(grads, qcfg, mcfg.max_probe_leaves, device)
    if mcfg.zeta_probe and probe_fn is not None and not qcfg.is_noop:
        with torch.enable_grad():
            exact = probe_fn()
        zb = zeta_bound(exact, grads)
        z = zb["norm_ratio"].to(torch.float32)
        cs = zb["cosine"].to(torch.float32)
    else:
        z = torch.zeros((), dtype=torch.float32, device=device)
        cs = torch.ones((), dtype=torch.float32, device=device)
    return lt, lb, ovf, z, cs


@torch.no_grad()
def monitor_update(mcfg: MonitorConfig, state: MonitorState, *, step: int,
                   loss, gnorm, probed: Optional[tuple] = None) -> tuple:
    """One monitor step -> (new_state, RiskSignals).

    On probe steps (:func:`probe_due`) the probe channels are ``probed``,
    the :func:`monitor_probe` result the caller took earlier in the step;
    on other steps they hold and ``probed`` is not read."""
    if probe_due(mcfg, step) and probed is None:
        raise ValueError(f"step {step} is a probe step: pass "
                         f"monitor_probe's result as probed=")
    dev = state.ema_slow.device
    loss = torch.as_tensor(loss).to(device=dev, dtype=torch.float32)
    gnorm = torch.as_tensor(gnorm).to(device=dev, dtype=torch.float32)
    first = state.count == 0
    one = torch.ones((), dtype=torch.float32, device=dev)
    # instantaneous loss against the trend before this step's update
    lratio = torch.where(first, one,
                         loss / torch.clamp(state.ema_slow, min=1e-30))
    fast = _ema(state.ema_fast, loss, mcfg.ema_fast, first)
    slow = _ema(state.ema_slow, loss, mcfg.ema_slow, first)
    curvature = (fast - slow) / torch.clamp(torch.abs(slow), min=1e-30)
    gref = torch.where(first, gnorm, state.gnorm_ema)
    gratio = gnorm / torch.clamp(gref, min=1e-30)
    gema = _ema(state.gnorm_ema, gnorm, mcfg.gnorm_ema, first)

    if probe_due(mcfg, step):
        lt, lb, ovf, z, cs = probed
        age = torch.zeros((), dtype=torch.float32, device=dev)
    else:
        lt, lb, ovf, z, cs = (state.ln_tight, state.ln_last, state.g_ovf,
                              state.zeta, state.cosine)
        age = state.probe_age + 1.0

    new = MonitorState(count=state.count + 1, ema_fast=fast, ema_slow=slow,
                       gnorm_ema=gema, ln_tight=lt, ln_last=lb, g_ovf=ovf,
                       zeta=z, cosine=cs, probe_age=age)
    sig = RiskSignals(loss_ema_fast=fast, loss_ema_slow=slow,
                      loss_curvature=curvature, loss_ratio=lratio,
                      gnorm_ratio=gratio, ln_tight_frac=lt, ln_last_bin=lb,
                      grad_overflow=ovf, zeta=z, cosine=cs, probe_age=age)
    return new, sig


def signals_from_metrics(metrics: dict) -> dict:
    """The ``guard_*`` scalars a monitored step merged into its metrics, as
    a {signal_name: float} dict (host side, after the window's drain)."""
    out = {}
    for name in SIGNAL_NAMES:
        v = metrics.get("guard_" + name)
        if v is not None:
            out[name] = float(v)
    return out


def host_signals(losses, gnorms, mcfg: Optional[MonitorConfig] = None
                 ) -> dict:
    """Host-side replica of the cheap channels over recorded histories.

    ``losses``/``gnorms`` are (lanes, steps) arrays; returns a dict of
    (lanes, steps) float64 arrays for the loss/grad-norm channels (the
    probe channels need the step itself and are absent).  Lane ``i``
    depends only on lane ``i``'s history.  Non-finite inputs hold the EMA
    but pass through to the ratio/curvature outputs, so a NaN step still
    registers as a trigger.  The reference's arithmetic, step for step.
    """
    mcfg = mcfg or MonitorConfig()
    losses = np.atleast_2d(np.asarray(losses, np.float64))
    gnorms = np.atleast_2d(np.asarray(gnorms, np.float64))
    L, T = losses.shape
    fast = np.zeros((L, T))
    slow = np.zeros((L, T))
    curv = np.zeros((L, T))
    gratio = np.zeros((L, T))
    lratio = np.zeros((L, T))
    ef = es = eg = None
    for t in range(T):
        lo, gn = losses[:, t], gnorms[:, t]
        if t == 0:
            ef = np.where(np.isfinite(lo), lo, 0.0)
            es = ef.copy()
            eg = np.where(np.isfinite(gn), gn, 0.0)
            gr = np.where(np.isfinite(gn), 1.0, np.inf)
            lr = np.ones(L)
        else:
            gr = gn / np.maximum(eg, 1e-30)
            lr = lo / np.maximum(es, 1e-30)     # vs the pre-update trend
            ef = np.where(np.isfinite(lo),
                          (1 - mcfg.ema_fast) * ef + mcfg.ema_fast * lo, ef)
            es = np.where(np.isfinite(lo),
                          (1 - mcfg.ema_slow) * es + mcfg.ema_slow * lo, es)
            eg = np.where(np.isfinite(gn),
                          (1 - mcfg.gnorm_ema) * eg + mcfg.gnorm_ema * gn,
                          eg)
        fast[:, t], slow[:, t] = ef, es
        curv[:, t] = (ef - es) / np.maximum(np.abs(es), 1e-30)
        # a non-finite loss must trip the loss channels too
        curv[:, t] = np.where(np.isfinite(lo), curv[:, t], np.inf)
        lratio[:, t] = np.where(np.isfinite(lo), lr, np.inf)
        gratio[:, t] = gr
    return {"loss_ema_fast": fast, "loss_ema_slow": slow,
            "loss_curvature": curv, "loss_ratio": lratio,
            "gnorm_ratio": gratio}
