"""Declarative guard policies: threshold + hysteresis rules -> transitions.

A copy of ``repro.guard.policy`` (jax-free there too), so that the port's
sweeps and the reference's decide alike.

A :class:`GuardPolicy` maps the risk signals (``monitors.host_signals`` in the port) to
moves on an escalation *ladder* of precision interventions (applied
cumulatively to the base QuantConfig):

  level 0: the configured MX scheme (full throughput)
  level k: ladder[:k] applied in order — default
           bf16_activations -> skip_ln_quant -> bump_exponent -> fp32

Escalation fires when any rule triggers; de-escalation steps back one
level after ``stability_window`` consecutive calm evaluations, recovering
MX throughput once the instability has passed.  Three mechanisms make a
policy provably non-flapping (property-tested in the reference's tests/test_properties.py):

* **cooldown** — at least ``cooldown`` steps between any two transitions,
  so a T-step run performs at most ceil(T / cooldown) transitions;
* **hysteresis** — a rule arms at ``threshold`` but only re-arms as calm
  below its ``calm`` level, so a signal hovering at the threshold cannot
  toggle;
* **revisit lock** — a transition returning to the *immediately previous*
  level is blocked until ``stability_window`` steps have passed since the
  level was left: no A -> B -> A inside one stability window, ever;
* **budgets** — per-rule and global transition budgets bound the total
  intervention count for the whole run.

A policy with a non-empty ``schedule`` is *purely step-driven* (signals
are ignored): entries ``(step, level:int)`` jump to an absolute ladder
level — the journaled-replay form — and ``(step, name:str)`` apply a named
intervention cumulatively, which is exactly the paper's Fig. 7 protocol in
declarative form.  All decision logic is pure host-side python on floats:
``decide`` is a deterministic function of (policy, state, step, signals),
which is what makes a journaled run bitwise replayable.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple, Union

from repro_torch.core import list_interventions

__all__ = ["Rule", "GuardPolicy", "PolicyState", "Decision", "decide",
           "POLICY_PRESETS", "get_policy", "scheduled_policy",
           "list_policies"]

DEFAULT_LADDER = ("bf16_activations", "skip_ln_quant", "bump_exponent",
                  "fp32")


@dataclasses.dataclass(frozen=True)
class Rule:
    """One escalation trigger with hysteresis.

    Fires when the named signal crosses ``threshold`` (``direction`` =
    "above" or "below"); counts as *calm* only once it has retreated past
    ``calm`` (defaults to threshold/2 for "above" — for "below" rules,
    pass ``calm`` explicitly).  A non-finite signal value always fires
    (NaN/inf is instability by definition).  ``budget`` caps how many
    transitions this rule may cause over the run (None = unbounded).
    """
    signal: str
    threshold: float
    direction: str = "above"
    calm: Optional[float] = None
    budget: Optional[int] = None

    def __post_init__(self):
        if self.direction not in ("above", "below"):
            raise ValueError(f"direction must be above|below, "
                             f"got {self.direction!r}")
        if self.direction == "below" and self.calm is None:
            raise ValueError(
                f"rule on {self.signal!r}: 'below' rules need an explicit "
                "calm level (hysteresis re-arm point)")

    @property
    def calm_level(self) -> float:
        return 0.5 * self.threshold if self.calm is None else self.calm

    def fires(self, value: Optional[float]) -> bool:
        if value is None:
            return False                    # signal not measured: skip
        if not math.isfinite(value):
            return True
        return value > self.threshold if self.direction == "above" \
            else value < self.threshold

    def is_calm(self, value: Optional[float]) -> bool:
        if value is None:
            return True
        if not math.isfinite(value):
            return False
        return value <= self.calm_level if self.direction == "above" \
            else value >= self.calm_level


@dataclasses.dataclass(frozen=True)
class GuardPolicy:
    name: str = "autopilot"
    ladder: Tuple[str, ...] = DEFAULT_LADDER
    rules: Tuple[Rule, ...] = ()
    cooldown: int = 10                 # min steps between transitions
    stability_window: int = 40         # calm steps before de-escalation
    max_transitions: int = 16          # global transition budget
    deescalate: bool = True            # step back down when calm
    # non-empty => purely step-scheduled (signals ignored)
    schedule: Tuple[Tuple[int, Union[int, str]], ...] = ()

    def __post_init__(self):
        known = set(list_interventions())
        for name in self.ladder:
            if name not in known:
                raise KeyError(f"ladder intervention {name!r} unknown; "
                               f"know {list_interventions()}")
        for step, what in self.schedule:
            if isinstance(what, str) and what not in known:
                raise KeyError(f"scheduled intervention {what!r} unknown; "
                               f"know {list_interventions()}")
            if isinstance(what, int) and not 0 <= what <= len(self.ladder):
                raise ValueError(f"scheduled level {what} outside ladder "
                                 f"(0..{len(self.ladder)})")
        if self.cooldown < 1:
            raise ValueError("cooldown must be >= 1 step")

    @property
    def is_scheduled(self) -> bool:
        return bool(self.schedule)

    # ---- JSON round trip (checkpoint meta / run-db) ------------------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["rules"] = [dataclasses.asdict(r) for r in self.rules]
        d["schedule"] = [list(s) for s in self.schedule]
        d["ladder"] = list(self.ladder)
        return d

    @staticmethod
    def from_dict(d: dict) -> "GuardPolicy":
        d = dict(d)
        d["rules"] = tuple(Rule(**r) for r in d.get("rules", ()))
        d["ladder"] = tuple(d.get("ladder", DEFAULT_LADDER))
        d["schedule"] = tuple(
            (int(s), w if isinstance(w, str) else int(w))
            for s, w in d.get("schedule", ()))
        return GuardPolicy(**d)


@dataclasses.dataclass(frozen=True)
class PolicyState:
    """Deterministic decision state (JSON-able via asdict)."""
    level: int = 0
    calm: int = 0                      # consecutive calm evaluations
    last_step: int = -(1 << 30)        # step of the last transition
    prev_level: int = -1               # level before the last transition
    n_transitions: int = 0
    sched_idx: int = 0
    rule_fires: Tuple[int, ...] = ()   # per-rule transition counts

    @staticmethod
    def from_dict(d: dict) -> "PolicyState":
        d = dict(d)
        d["rule_fires"] = tuple(d.get("rule_fires", ()))
        return PolicyState(**d)


@dataclasses.dataclass(frozen=True)
class Decision:
    kind: str                          # "escalate" | "deescalate" | "scheduled"
    from_level: int
    to_level: int                      # -1 for cumulative string schedules
    rule: Optional[str] = None         # triggering signal name
    intervention: Optional[str] = None # set for string-scheduled entries


def _fires(policy: GuardPolicy, state: PolicyState,
           signals: Mapping[str, float]):
    counts = state.rule_fires or (0,) * len(policy.rules)
    for i, rule in enumerate(policy.rules):
        if rule.budget is not None and counts[i] >= rule.budget:
            continue
        if rule.fires(signals.get(rule.signal)):
            return i, rule
    return None, None


def decide(policy: GuardPolicy, state: PolicyState, step: int,
           signals: Mapping[str, float]
           ) -> Tuple[PolicyState, Optional[Decision]]:
    """One evaluation -> (new_state, transition or None).  Pure/deterministic.

    ``step`` must be non-decreasing across calls.  For scheduled policies
    ``signals`` is ignored; entries fire once their step is reached.
    """
    if policy.is_scheduled:
        if state.sched_idx < len(policy.schedule):
            at, what = policy.schedule[state.sched_idx]
            if step >= at:
                new = dataclasses.replace(
                    state, sched_idx=state.sched_idx + 1,
                    prev_level=state.level,
                    level=what if isinstance(what, int) else state.level,
                    last_step=step, calm=0,
                    n_transitions=state.n_transitions + 1)
                if isinstance(what, int):
                    return new, Decision("scheduled", state.level, what)
                return new, Decision("scheduled", state.level, -1,
                                     intervention=what)
        return state, None

    counts = state.rule_fires or (0,) * len(policy.rules)
    idx, rule = _fires(policy, state, signals)
    calm_now = all(r.is_calm(signals.get(r.signal)) for r in policy.rules)
    calm = state.calm + 1 if calm_now else 0
    state = dataclasses.replace(state, calm=calm, rule_fires=counts)

    in_cooldown = step - state.last_step < policy.cooldown
    budget_left = state.n_transitions < policy.max_transitions
    # revisit lock: going back to the level we most recently left is
    # forbidden inside one stability window of leaving it
    def locked(target: int) -> bool:
        return (target == state.prev_level
                and step - state.last_step < policy.stability_window)

    if rule is not None and state.level < len(policy.ladder) \
            and budget_left and not in_cooldown \
            and not locked(state.level + 1):
        counts = tuple(c + (1 if i == idx else 0)
                       for i, c in enumerate(counts))
        new = dataclasses.replace(
            state, level=state.level + 1, prev_level=state.level,
            last_step=step, calm=0, n_transitions=state.n_transitions + 1,
            rule_fires=counts)
        return new, Decision("escalate", state.level, state.level + 1,
                             rule=rule.signal)

    if policy.deescalate and rule is None and state.level > 0 \
            and calm >= policy.stability_window and budget_left \
            and not in_cooldown and not locked(state.level - 1):
        new = dataclasses.replace(
            state, level=state.level - 1, prev_level=state.level,
            last_step=step, calm=0, n_transitions=state.n_transitions + 1)
        return new, Decision("deescalate", state.level, state.level - 1)

    return state, None


# ---------------------------------------------------------------------------
# presets
# ---------------------------------------------------------------------------
def _autopilot(cooldown=10, window=40, lratio=2.0, gnorm=4.0, curv=0.3,
               zeta=1.0, tight=0.05, name="autopilot") -> GuardPolicy:
    return GuardPolicy(
        name=name, cooldown=cooldown, stability_window=window,
        rules=(
            # the earliest channel: instantaneous loss vs slow-EMA trend
            # (the watchdog thresholds the same quantity at ~100x)
            Rule("loss_ratio", lratio, calm=0.5 * (1.0 + lratio)),
            Rule("gnorm_ratio", gnorm, calm=2.0),
            Rule("loss_curvature", curv, calm=0.5 * curv),
            # ζ-bound: the paper sees divergence once the running bound ≈ 2;
            # intervene at half that (probe channel, may lag probe_every)
            Rule("zeta", zeta, calm=0.5 * zeta),
            Rule("ln_tight_frac", tight, calm=0.5 * tight),
        ))


POLICY_PRESETS: Dict[str, object] = {
    # balanced default: act well before the App.-B spike heuristic would
    "autopilot": lambda: _autopilot(),
    # trigger-happy: short cooldown, low thresholds (small proxies / tests)
    "aggressive": lambda: _autopilot(cooldown=5, window=20, lratio=1.5,
                                     gnorm=3.0, curv=0.15, zeta=0.75,
                                     tight=0.02, name="aggressive"),
    # late + sticky: for runs where a scheme change is expensive
    "conservative": lambda: _autopilot(cooldown=50, window=200, lratio=3.0,
                                       gnorm=8.0, curv=0.6, zeta=1.5,
                                       tight=0.15, name="conservative"),
}


def scheduled_policy(schedule, ladder=DEFAULT_LADDER,
                     name: str = "scheduled") -> GuardPolicy:
    """Purely step-driven policy: ``schedule`` is ((step, level|name), ...).

    Integer entries jump to an absolute ladder level (journal-replay form);
    string entries apply a named intervention cumulatively (the paper's
    Fig. 7 switches in declarative form)."""
    sched = tuple(sorted(
        ((int(s), w if isinstance(w, str) else int(w)) for s, w in schedule),
        key=lambda x: x[0]))
    return GuardPolicy(name=name, ladder=tuple(ladder), schedule=sched)


def list_policies() -> list:
    return sorted(POLICY_PRESETS)


def get_policy(name: Union[str, GuardPolicy]) -> GuardPolicy:
    """Resolve a policy preset name or a ``sched:`` spec.

    ``sched:40=bf16_activations,120=0`` schedules the named intervention at
    step 40 and a jump back to ladder level 0 at step 120.
    """
    if isinstance(name, GuardPolicy):
        return name
    if name.startswith("sched:"):
        entries = []
        for part in name[len("sched:"):].split(","):
            if not part.strip():
                continue
            step, _, what = part.partition("=")
            what = what.strip()
            entries.append((int(step),
                            int(what) if what.lstrip("-").isdigit()
                            else what))
        return scheduled_policy(entries, name=name)
    if name not in POLICY_PRESETS:
        raise KeyError(f"unknown guard policy {name!r}; know "
                       f"{list_policies()} or a sched:STEP=LEVEL|NAME,... "
                       "spec")
    return POLICY_PRESETS[name]()
