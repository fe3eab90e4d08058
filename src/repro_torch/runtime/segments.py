"""Segment planning and numbering, and the deferred metric window.

Counterpart of ``plan_segments``, ``SegmentTracker`` and ``MetricsWindow``
in ``repro.runtime.segments``.  ``SegmentFn`` (jit with per-static-key
trace accounting) is not ported: an eager PyTorch step has no trace to
count, and a segment's qcfg is simply the one its steps are called with.
"""
from __future__ import annotations

import time
from typing import Any, List, NamedTuple, Sequence, Tuple

import torch

__all__ = ["Segment", "plan_segments", "SegmentTracker", "MetricsWindow"]


class Segment(NamedTuple):
    start: int
    end: int
    qcfg: Any


def plan_segments(steps: int, qcfg0, phases: Sequence[Tuple[int, str]] = (),
                  guard: Any = None) -> List[Segment]:
    """Compile an intervention schedule into contiguous step segments.

    ``phases``: ``((switch_step, intervention_name), ...)`` applied
    cumulatively (the paper's Fig. 7 protocol).  ``guard``: a policy
    name/spec/instance; a *scheduled* policy's entries merge into the same
    split (string entries apply cumulatively like phases, integer entries
    jump to an absolute ladder level of the base scheme); online policies
    contribute nothing here.  Switches are clipped to [0, steps];
    coincident switches apply in (step, str(what)) order, so the plan is
    deterministic.  The reference's planner, step for step."""
    from repro_torch.core import apply_intervention
    switches: List[Tuple[int, Any]] = [(int(s), iv) for s, iv in phases]
    ctl = None
    if guard:
        from repro_torch.guard import PrecisionController, get_policy
        pol = get_policy(guard)
        if pol.is_scheduled:
            ctl = PrecisionController(qcfg0, pol)
            switches += [(int(s), w) for s, w in pol.schedule]
    segs: List[Segment] = []
    qcfg, prev = qcfg0, 0
    for step, what in sorted(switches, key=lambda x: (x[0], str(x[1]))):
        step = min(max(int(step), 0), int(steps))
        if step > prev:
            segs.append(Segment(prev, step, qcfg))
            prev = step
        if isinstance(what, str):
            qcfg = apply_intervention(qcfg, what)
        else:
            qcfg = ctl.qcfg_at_level(what)
    if prev < steps:
        segs.append(Segment(prev, int(steps), qcfg))
    return segs or [Segment(0, int(steps), qcfg0)]


class SegmentTracker:
    """Numbers the qcfg segments of a live run: each accepted transition
    bumps ``index`` and lands a ``segment`` record on the journal."""

    def __init__(self, qcfg, journal=None, index: int = 0):
        self.qcfg = qcfg
        self.index = int(index)
        self.journal = journal

    def transition(self, step: int, qcfg, reason: str = "manual") -> bool:
        """Enter a new segment iff the scheme actually changed."""
        if qcfg == self.qcfg:
            return False
        old = self.qcfg
        self.index += 1
        self.qcfg = qcfg
        if self.journal is not None:
            self.journal.append({
                "event": "segment", "index": self.index, "step": int(step),
                "reason": reason, "from_qcfg": old.describe(),
                "to_qcfg": qcfg.describe()})
        return True

    def restore(self, index: int, qcfg) -> None:
        """Adopt a checkpointed (index, qcfg) without journaling."""
        self.index = int(index)
        self.qcfg = qcfg


class MetricsWindow:
    """Buffers each step's metrics as 0-d device tensors; ``drain`` moves
    the whole window to the host in one transfer (one device sync) and
    amortizes the window's wall time over its steps."""

    def __init__(self):
        self._pending: List[tuple] = []
        self._t0 = time.monotonic()

    def push(self, step: int, metrics) -> None:
        self._pending.append((step, metrics))

    def __len__(self) -> int:
        return len(self._pending)

    def __bool__(self) -> bool:
        return bool(self._pending)

    def drain(self) -> List[tuple]:
        """[(step, {name: float}, per_step_seconds)], buffer cleared."""
        if not self._pending:
            return []
        keys = [sorted(m) for _, m in self._pending]
        flat = [torch.as_tensor(m[k]).detach().reshape(())
                for (_, m), ks in zip(self._pending, keys) for k in ks]
        dev = next((t.device for t in flat if t.is_cuda),
                   torch.device("cpu"))
        values = torch.stack([t.to(dev, torch.float64)
                              for t in flat]).tolist()
        per = (time.monotonic() - self._t0) / len(self._pending)
        out, i = [], 0
        for (s, _), ks in zip(self._pending, keys):
            out.append((s, dict(zip(ks, values[i:i + len(ks)])), per))
            i += len(ks)
        self._pending = []
        self._t0 = time.monotonic()
        return out

    def reset_clock(self) -> None:
        self._t0 = time.monotonic()
