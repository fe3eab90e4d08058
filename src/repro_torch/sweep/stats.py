"""Aggregate sweep statistics (the paper's divergence/spike-rate tables).

A copy of ``repro.sweep.stats``.

Aggregates are computed from run *summaries* only, so the same numbers come
out whether the input is a live :class:`SweepReport` or the persisted rows
of a run database — this is what makes "resume then aggregate" equal to an
uninterrupted sweep (tested in tests/test_sweep.py and
tests/test_torch_sweep.py).
"""
from __future__ import annotations

from typing import Dict, List, Union

import numpy as np

from .db import RunDB
from .executor import RunResult, SweepReport

__all__ = ["aggregate", "format_table"]


def _as_results(src) -> List[RunResult]:
    if isinstance(src, SweepReport):
        return list(src)
    if isinstance(src, RunDB):
        return [RunResult.from_row(row) for row in src.rows()]
    out = []
    for x in src:
        out.append(RunResult.from_row(x) if isinstance(x, dict) else x)
    return out


def aggregate(src: Union[SweepReport, RunDB, list], by: str = "label"
              ) -> Dict[str, dict]:
    """Group results by an attribute (default the row label) and reduce to
    the figure-level statistics: run/divergence/spike counts, median final
    loss, mean tail loss, worst grad norm, mean us/step."""
    groups: Dict[str, List[RunResult]] = {}
    for r in _as_results(src):
        groups.setdefault(str(getattr(r, by)), []).append(r)
    out: Dict[str, dict] = {}
    for key in groups:
        rs = sorted(groups[key], key=lambda r: (r.scheme, r.seed, r.lr))
        finals = np.asarray([r.final_loss for r in rs], np.float64)
        tails = np.asarray([r.tail_mean for r in rs], np.float64)
        out[key] = {
            "n": len(rs),
            "divergent": int(sum(r.divergent for r in rs)),
            "spikes": int(sum(r.spikes for r in rs)),
            "median_final": float(np.nanmedian(finals))
            if np.isfinite(finals).any() else float("nan"),
            "mean_tail": float(np.nanmean(tails))
            if np.isfinite(tails).any() else float("nan"),
            "max_gnorm": float(np.nanmax(
                [r.max_gnorm for r in rs])),
            "us_per_step": float(np.mean([r.us_per_step for r in rs])),
        }
        guarded = [r for r in rs if r.guard_journal]
        if guarded:
            # guard accounting (from the persisted transition journals):
            # a run is "averted" when the guard intervened and the run
            # still converged — divergence-averted rate + median step of
            # the first intervention (advisory lanes count separately)
            trig = [r.guard_trigger_step for r in guarded
                    if r.guard_trigger_step >= 0]
            out[key].update({
                "guarded": len(guarded),
                "advisory": int(sum(r.guard_advisory for r in guarded)),
                "averted": int(sum((not r.divergent)
                                   and r.guard_trigger_step >= 0
                                   and not r.guard_advisory
                                   for r in guarded)),
                "guard_transitions": int(sum(len(r.guard_journal)
                                             for r in guarded)),
                "median_trigger_step": float(np.median(trig))
                if trig else -1.0,
            })
    return out


def format_table(agg: Dict[str, dict]) -> str:
    lines = [f"{'label':<24} {'n':>3} {'div':>4} {'spikes':>6} "
             f"{'median_final':>13} {'us/step':>10}"]
    for key, s in agg.items():
        lines.append(
            f"{key:<24} {s['n']:>3} {s['divergent']:>4} {s['spikes']:>6} "
            f"{s['median_final']:>13.5g} {s['us_per_step']:>10.1f}")
    return "\n".join(lines)
