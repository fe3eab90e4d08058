"""Declarative sweep specification (the paper's thousand-run protocol).

A copy of ``repro.sweep.spec`` (jax-free there too): ``RunSpec.run_id``
hashes the same fields in the same recipe, so one RunDB resumes in either
package.

A :class:`RunSpec` pins *everything* that makes a training run reproducible:
model shape, precision scheme, optimizer knobs, data/init/teacher seeds and
any mid-run precision interventions (the paper's Fig. 7 switches).  It is
frozen/hashable and JSON round-trippable, and its :attr:`run_id` — a stable
content hash — keys the persistent run database so an interrupted sweep can
be re-launched without repeating finished runs.

A :class:`SweepSpec` is a base RunSpec plus a grid of axes; ``expand()``
takes the cartesian product in declaration order.  An axis key may name
several comma-separated fields ("seed,teacher_seed") whose values are
tuples — that expresses *linked* axes (e.g. the paper's per-seed teacher)
without leaving the declarative world.

Packing contract: fields in :data:`LANE_FIELDS` may vary *within* one
lane pack (they are per-lane values: seeds, peak lr); every other field is
shared by the pack's step loop, so runs that differ elsewhere land in
separate packs (see executor.py).
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["RunSpec", "SweepSpec", "LANE_FIELDS", "group_key"]

# Fields allowed to differ between lanes of one pack: they are numeric
# per-lane inputs (seeds become per-lane generators, lr a per-lane peak fed
# to the shared schedule).  Everything else (scheme, shape, optimizer,
# phases) is shared by the pack.  `label` is report-only and never
# constrains packing.
LANE_FIELDS = ("seed", "data_seed", "teacher_seed", "lr")
_PACK_FREE = LANE_FIELDS + ("label",)


@dataclasses.dataclass(frozen=True)
class RunSpec:
    # what kind of run: "proxy" (student-teacher MLP, lane-packed) or
    # "lm" (full LM via the Trainer, sequential)
    kind: str = "proxy"
    # precision scheme: a core.preset name, shared by a pack
    scheme: str = "bf16"
    label: str = ""                   # free-form row label (report only)
    # seeds: `seed` inits the student/model; data/teacher default to the
    # paper's conventions when None (data follows seed, teacher is fixed)
    seed: int = 0
    data_seed: Optional[int] = None   # None -> seed
    teacher_seed: int = 1             # proxy only
    # training
    steps: int = 150
    lr: float = 1e-3
    lr_schedule: str = "constant"     # optim.schedule.get_schedule name
    optimizer: str = "adam"           # "adam" | "sgd" | "momentum"
    grad_clip: float = 0.0
    weight_decay: float = 0.0
    # proxy model shape (paper §4.1)
    d_model: int = 128
    n_layers: int = 4
    act: str = "gelu"
    init: str = "kaiming_uniform"
    # teacher weights always use this init, independent of the student's
    # `init` ablation — the data-generating function must stay fixed when
    # the student init is swept (App. B protocol)
    teacher_init_style: str = "kaiming_uniform"
    batch_size: int = 256
    # lm shape (paper §3 protocol, CPU scale)
    arch: str = "olmo"                # "olmo" -> configs.olmo_paper.olmo
    lm_size: int = 2                  # olmo depth multiplier
    lm_vocab: int = 512
    lm_batch: int = 8
    lm_seq: int = 64
    # mid-run precision interventions: ((switch_step, intervention), ...)
    # applied in step order to the *base* scheme (paper Fig. 7)
    phases: Tuple[Tuple[int, str], ...] = ()
    # guard policy (guard.get_policy name / "sched:..." spec; "" = off).
    # Scheduled policies split the segments exactly like `phases`; online
    # policies run *advisorily* (post-hoc per-lane accounting) on proxy
    # packs, where a mid-pack scheme change would break lane packing;
    # on `kind="lm"` runs they are the Trainer's real autopilot.
    guard: str = ""
    guard_probe_every: int = 0        # lm-only: guard ζ/clamp probe stride
    # diagnostics
    track_bias_every: int = 0         # ζ-bound probe stride (0 = off)
    spike_factor: float = 10.0        # App. B loss-spike threshold
    spike_window: int = 64
    diverge_factor: float = 50.0      # Fig. 7 divergence-step threshold

    # ---- derived ----------------------------------------------------------
    @property
    def effective_data_seed(self) -> int:
        return self.seed if self.data_seed is None else self.data_seed

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["phases"] = [list(p) for p in self.phases]
        return d

    @staticmethod
    def from_dict(d: dict) -> "RunSpec":
        d = dict(d)
        d["phases"] = tuple((int(s), str(iv)) for s, iv in d.get("phases", ()))
        known = {f.name for f in dataclasses.fields(RunSpec)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown RunSpec fields {sorted(unknown)}")
        return RunSpec(**d)

    @property
    def run_id(self) -> str:
        """Stable content hash keying the run DB (the reference's
        recipe): only the fields that *differ from their defaults* plus a
        schema-version tag, so adding an optional field does not shift
        the id of every existing spec."""
        d = self.to_dict()
        sig = {k: v for k, v in d.items() if v != _RUNSPEC_DEFAULTS[k]}
        blob = json.dumps({"schema": RUN_ID_SCHEMA, "spec": sig},
                          sort_keys=True)
        return hashlib.sha1(blob.encode()).hexdigest()[:16]


# Tag baked into every run_id: bump it if the hash *recipe* changes again,
# so ids from different recipes can never collide by accident.
RUN_ID_SCHEMA = 2
_RUNSPEC_DEFAULTS = dataclasses.asdict(RunSpec())
_RUNSPEC_DEFAULTS["phases"] = []


def group_key(r: RunSpec) -> tuple:
    """Signature shared by every lane of one pack."""
    d = r.to_dict()
    return tuple(json.dumps(d[f], sort_keys=True)
                 for f in sorted(d) if f not in _PACK_FREE)


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """Base run + grid axes.  ``axes`` maps a field name (or several,
    comma-joined, with tuple values — linked axes) to the list of values
    swept; expansion is the cartesian product in declaration order."""
    name: str = "sweep"
    base: RunSpec = dataclasses.field(default_factory=RunSpec)
    axes: Tuple[Tuple[str, Tuple], ...] = ()
    # optional row-label template, formatted with the expanded run's fields
    # (e.g. "fig2.lr{lr:g}.{scheme}"); an explicit `label` axis wins
    label_fmt: str = ""

    @staticmethod
    def make(name: str, base: RunSpec, axes: Dict[str, Sequence],
             label_fmt: str = "") -> "SweepSpec":
        return SweepSpec(name=name, base=base, label_fmt=label_fmt,
                         axes=tuple((k, tuple(v)) for k, v in axes.items()))

    def expand(self) -> List[RunSpec]:
        keys = [k for k, _ in self.axes]
        vals = [v for _, v in self.axes]
        runs = []
        for combo in itertools.product(*vals) if keys else [()]:
            upd: dict = {}
            for key, val in zip(keys, combo):
                fields = key.split(",")
                if len(fields) == 1:
                    upd[key] = val
                else:
                    if len(val) != len(fields):
                        raise ValueError(
                            f"linked axis {key!r} wants {len(fields)}-tuples,"
                            f" got {val!r}")
                    upd.update(dict(zip(fields, val)))
            if "phases" in upd:   # JSON round trips turn tuples into lists
                upd["phases"] = tuple(
                    (int(s), str(iv)) for s, iv in upd["phases"])
            r = dataclasses.replace(self.base, **upd)
            if self.label_fmt and "label" not in upd and not self.base.label:
                r = dataclasses.replace(
                    r, label=self.label_fmt.format(**r.to_dict()))
            runs.append(r)
        return runs

    # ---- JSON round trip (CLI --spec files) --------------------------------
    def to_json(self) -> str:
        return json.dumps({"name": self.name, "base": self.base.to_dict(),
                           "label_fmt": self.label_fmt,
                           "axes": [[k, list(v)] for k, v in self.axes]},
                          indent=1)

    @staticmethod
    def from_json(blob: str) -> "SweepSpec":
        d = json.loads(blob)
        axes = tuple(
            (k, tuple(tuple(x) if isinstance(x, list) else x for x in v))
            for k, v in d.get("axes", []))
        return SweepSpec(name=d.get("name", "sweep"),
                         base=RunSpec.from_dict(d["base"]), axes=axes,
                         label_fmt=d.get("label_fmt", ""))
