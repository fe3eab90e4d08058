"""PrecisionController: drives QuantConfig transitions from a guard policy.

A copy of ``repro.guard.controller``.  It drives the Trainer's online
guard (``TrainerConfig.guard``), splits scheduled policies in
``plan_segments`` and the sweeps, and journals online policies
advisorily over a pack's recorded histories.

The controller owns the *current* precision scheme of a run.  Each
evaluation (:meth:`observe`) feeds one step's risk signals to the policy;
a resulting decision swaps the active QuantConfig and appends a
structured ``guard_transition`` record to the journal:

  {"step": <first step executed under the new scheme>,
   "observed_step": <step whose signals triggered the decision>,
   "event": "guard_transition", "kind": escalate|deescalate|scheduled,
   "rule": <signal name or None>, "from_level"/"to_level",
   "from_qcfg"/"to_qcfg": describe() strings, "signals": {...}}

The journal is the run's *replayable* intervention record: levels are
absolute ladder positions, so :meth:`schedule` compiles it into a
step-scheduled policy that re-executes the exact transition sequence —
bitwise, since decisions are pure host-side functions and qcfg swaps land
on recorded step boundaries.  :meth:`state_dict` round-trips through
checkpoint meta so a resumed run adopts the autopilot mid-flight (level,
hysteresis counters, budgets, journal) instead of restarting at level 0.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional

from repro_torch.core import QuantConfig, apply_intervention
from repro_torch.runtime.journal import Journal

from .policy import Decision, GuardPolicy, PolicyState, decide, get_policy

__all__ = ["PrecisionController", "schedule_from_journal"]


class PrecisionController:
    def __init__(self, base_qcfg: QuantConfig, policy,
                 state: Optional[PolicyState] = None):
        self.base = base_qcfg
        self.policy: GuardPolicy = get_policy(policy)
        self.state = state or PolicyState()
        # the unified runtime Journal (a list subclass): replay/JSONL come
        # for free and the records land in the same typed bus as the
        # Trainer's and the engines' events
        self.journal: List[dict] = Journal()
        # cumulative string-scheduled transitions can leave the ladder, so
        # the current qcfg is tracked explicitly (not derived per call)
        self._cur = self.qcfg_at_level(self.state.level)

    # ---- qcfg algebra ------------------------------------------------------
    def qcfg_at_level(self, level: int) -> QuantConfig:
        """Ladder prefix applied cumulatively to the base scheme."""
        q = self.base
        for name in self.policy.ladder[:level]:
            q = apply_intervention(q, name)
        return q

    @property
    def qcfg(self) -> QuantConfig:
        return self._cur

    @property
    def level(self) -> int:
        return self.state.level

    def rebase(self, base_qcfg: QuantConfig) -> None:
        """Adopt a new baseline scheme after an *out-of-band* qcfg change
        (a watchdog recovery applying its own intervention, or a resume
        from a checkpoint without guard meta).  The ladder now stacks on
        the new base and the level resets to 0, so a later de-escalation
        can never drop below the recovered scheme.  Transition budgets and
        rule-firing counts are preserved (they bound whole-run flapping)."""
        self.base = base_qcfg
        self._cur = base_qcfg
        self.state = dataclasses.replace(self.state, level=0,
                                         prev_level=-1, calm=0)

    # ---- online decision ---------------------------------------------------
    def observe(self, step: int, signals: Mapping[str, float],
                effective_step: Optional[int] = None
                ) -> Optional[QuantConfig]:
        """Feed one step's signals; returns the new QuantConfig on a
        transition (None otherwise).  ``effective_step`` is the step index
        at which the caller will actually start executing the new scheme
        (>= ``step`` when metrics drain in windows) — it is what the
        journal records, so a replay switches exactly where the original
        run did.  Scheduled policies are evaluated against the effective
        step for the same reason: entry (s, ...) must fire so that step s
        is the first one executed under the new scheme."""
        eff = int(step if effective_step is None else effective_step)
        dstep = eff if self.policy.is_scheduled else int(step)
        self.state, dec = decide(self.policy, self.state, dstep,
                                 dict(signals))
        if dec is None:
            return None
        return self._apply(dec, int(step), signals, eff)

    def _apply(self, dec: Decision, step: int, signals, eff: int
               ) -> QuantConfig:
        old = self._cur
        if dec.intervention is not None:      # cumulative string schedule
            new = apply_intervention(old, dec.intervention)
        else:
            new = self.qcfg_at_level(dec.to_level)
        self._cur = new
        self.journal.append({
            "step": eff, "observed_step": step, "event": "guard_transition",
            "kind": dec.kind, "rule": dec.rule,
            "intervention": dec.intervention,
            "from_level": dec.from_level, "to_level": dec.to_level,
            "from_qcfg": old.describe(), "to_qcfg": new.describe(),
            "signals": {k: float(v) for k, v in dict(signals).items()}})
        return new

    # ---- replay ------------------------------------------------------------
    def schedule(self) -> tuple:
        """((step, level), ...) from the journal — feed to
        :func:`repro_torch.guard.policy.scheduled_policy` (same ladder!) to
        re-execute this run's transitions deterministically."""
        out = []
        for t in self.journal:
            if t["intervention"] is not None:
                out.append((t["step"], t["intervention"]))
            else:
                out.append((t["step"], int(t["to_level"])))
        return tuple(out)

    # ---- persistence (checkpoint meta) -------------------------------------
    def state_dict(self) -> dict:
        return {"policy": self.policy.name,
                "state": dataclasses.asdict(self.state),
                "qcfg": self._cur.to_dict(),
                "journal": list(self.journal)}

    def load_state_dict(self, d: Dict) -> None:
        """Adopt a persisted autopilot state (resume semantics).  The
        live policy object is kept — only the decision state, current
        qcfg and journal are restored."""
        self.state = PolicyState.from_dict(d["state"])
        self._cur = QuantConfig.from_dict(d["qcfg"])
        self.journal = Journal(d.get("journal", ()))


def advisory_journals(losses, gnorms, policy, base_qcfg,
                      mcfg=None) -> List[list]:
    """Run an online policy *advisorily* over recorded per-lane histories.

    (lanes, steps) loss/grad-norm arrays -> one journal per lane of the
    transitions the policy *would* have performed, driven by the host-side
    replica of the cheap monitor channels (`monitors.host_signals`).  Lane
    i sees only lane i's history.  Used by the sweep engine, where a real
    mid-scan transition would break lane packing: the journals quantify
    time-of-intervention and divergence-averted potential post hoc.
    """
    import numpy as np

    from .monitors import host_signals
    sigs = host_signals(losses, gnorms, mcfg)
    lanes, steps = np.atleast_2d(np.asarray(losses)).shape
    out = []
    for i in range(lanes):
        ctl = PrecisionController(base_qcfg, policy)
        for t in range(steps):
            ctl.observe(t, {k: float(v[i, t]) for k, v in sigs.items()},
                        effective_step=t + 1)
        out.append(ctl.journal)
    return out


def schedule_from_journal(journal) -> tuple:
    """((step, level|name), ...) replay schedule from journaled
    ``guard_transition`` records (e.g. read back from a run log or the
    sweep run-db)."""
    out = []
    for t in journal:
        if t.get("event") != "guard_transition":
            continue
        if t.get("intervention") is not None:
            out.append((int(t["step"]), t["intervention"]))
        else:
            out.append((int(t["step"]), int(t["to_level"])))
    return tuple(out)
