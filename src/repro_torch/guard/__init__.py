"""repro_torch.guard: online instability forecasting and the precision
autopilot.

Counterpart of ``repro.guard``:

  monitors.py    RiskSignals per step on the device, and the ζ / LN-clamp /
                 overflow probes every ``probe_every`` steps;
                 ``host_signals``, the cheap channels over recorded
                 histories
  policy.py      declarative threshold/hysteresis policies (non-flapping)
  controller.py  PrecisionController: qcfg transitions, journal, replay;
                 ``advisory_journals`` over recorded per-lane histories
  scenario.py    the deterministic instability injector and the trend
                 policy the autopilot scenario runs under

Wired through ``repro_torch.train.Trainer`` (``TrainerConfig.guard``, the
first line of defense ahead of the spike-rollback recovery), the sweeps
(scheduled policies split ``plan_segments``; online policies run
advisorily over a pack's lanes and for real on ``kind="lm"`` runs) and
the ``--guard`` flag of ``repro_torch.launch.train``.
"""
from .controller import (PrecisionController, advisory_journals,
                         schedule_from_journal)
from .monitors import (SIGNAL_NAMES, MonitorConfig, MonitorState,
                       RiskSignals, host_signals, monitor_init,
                       monitor_probe, monitor_update, probe_due,
                       signals_from_metrics)
from .policy import (POLICY_PRESETS, Decision, GuardPolicy, PolicyState,
                     Rule, decide, get_policy, list_policies,
                     scheduled_policy)

__all__ = [
    "PrecisionController", "schedule_from_journal", "advisory_journals",
    "MonitorConfig", "MonitorState", "RiskSignals", "SIGNAL_NAMES",
    "monitor_init", "monitor_update", "monitor_probe", "probe_due",
    "signals_from_metrics", "host_signals",
    "GuardPolicy", "PolicyState", "Rule", "Decision", "decide",
    "POLICY_PRESETS", "get_policy", "list_policies", "scheduled_policy",
]
