"""The autopilot scenario: a deterministic instability and the policy that
averts it.

The port's copy of the helpers of the reference's
``benchmarks/guard_autopilot.py``.  Small models do not diverge
organically inside a short run, so the guard's end-to-end check uses an
*instability injector*: a loss amplification that compounds while
activations are quantized and vanishes under ``bf16_activations`` (the
paper's compounding-bias mechanism, made step-exact).  The trend policy
reacts to the loss-against-trend ratio several steps before the App.-B
watchdog would, and its 25-step stability window holds the mitigation
until the hostile stretch has passed.  The two limits are the
reference's CI gates on the guard's cost.
"""
from __future__ import annotations

import numpy as np

from .policy import GuardPolicy, Rule

__all__ = ["ONSET", "END", "RAMP", "MONITOR_OVERHEAD_MAX",
           "DEESCALATE_RECOVERY_MAX", "trend_policy", "injected_amp",
           "inject_instability"]

ONSET, END = 20, 40            # injector active on steps [ONSET, END)
RAMP = 1.6                     # per-step loss amplification while active
MONITOR_OVERHEAD_MAX = 0.5     # monitored step <= 1.5x unmonitored step
DEESCALATE_RECOVERY_MAX = 2.0  # de-escalated ms/step <= 2x pre-escalation


def trend_policy() -> GuardPolicy:
    """Scheme-independent trend channels tuned to the injector: the
    loss ratio crosses 1.5 on the second amplified step."""
    return GuardPolicy(name="trend",
                       rules=(Rule("loss_ratio", 1.5, calm=1.1),
                              Rule("gnorm_ratio", 3.0, calm=2.0)),
                       cooldown=5, stability_window=25)


def injected_amp(step: int, onset: int = ONSET, end: int = END,
                 ramp: float = RAMP) -> float:
    """The loss factor at ``step``: ``ramp ** (step - onset)`` in fp32 on
    [onset, end), else 1.  A host float, so the step needs no upload."""
    s = int(step)
    if not onset <= s < end:
        return 1.0
    return float(np.float32(ramp) ** np.float32(s - onset))


def inject_instability(loss_fn, onset: int = ONSET, end: int = END,
                       ramp: float = RAMP):
    """``loss_fn(params, batch, qcfg) -> (loss, metrics)`` with the loss
    multiplied by :func:`injected_amp` of ``batch["step"]`` while
    ``qcfg.a_fwd`` is set (activations quantized); ``metrics["loss"]``
    is the amplified loss."""
    def loss(params, batch, qcfg):
        out, metrics = loss_fn(params, batch, qcfg)
        if qcfg.a_fwd is not None:
            amp = injected_amp(batch["step"], onset, end, ramp)
            if amp != 1.0:
                out = out * amp
        return out, {**metrics, "loss": out}
    return loss
