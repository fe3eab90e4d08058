"""repro_torch.guard: the precision autopilot's host side.

Counterpart of ``repro.guard`` for what runs on the host:

  policy.py      declarative threshold/hysteresis policies (non-flapping)
  controller.py  PrecisionController: qcfg transitions, journal, replay;
                 ``advisory_journals`` over recorded per-lane histories
  monitors.py    ``MonitorConfig`` and ``host_signals``, the cheap loss and
                 grad-norm channels over recorded histories

The sweeps use them (scheduled policies split ``plan_segments``; online
policies run advisorily over a pack's lanes).  The Trainer's online guard
(in-step monitors and probes, ``TrainerConfig.guard``) is ROADMAP Queue A
item 2.
"""
from .controller import (PrecisionController, advisory_journals,
                         schedule_from_journal)
from .monitors import MonitorConfig, host_signals
from .policy import (POLICY_PRESETS, Decision, GuardPolicy, PolicyState,
                     Rule, decide, get_policy, list_policies,
                     scheduled_policy)

__all__ = [
    "PrecisionController", "schedule_from_journal", "advisory_journals",
    "MonitorConfig", "host_signals",
    "GuardPolicy", "PolicyState", "Rule", "Decision", "decide",
    "POLICY_PRESETS", "get_policy", "list_policies", "scheduled_policy",
]
