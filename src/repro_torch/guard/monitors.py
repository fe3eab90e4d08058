"""Host-side risk signals of the guard.

Counterpart of the host half of ``repro.guard.monitors``:
:class:`MonitorConfig` and :func:`host_signals`, the replica of the cheap
loss and grad-norm channels over recorded histories that the sweeps use to
run an online policy advisorily over a pack's lanes.  The in-step monitors
(``monitor_init``/``monitor_update``, the ζ and clamp probes) belong to
the Trainer's online guard, ROADMAP Queue A item 2.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["MonitorConfig", "host_signals"]


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
