"""Persistent JSONL run database for sweeps.

A copy of ``repro.sweep.db``: the rows are the reference's, so a database
written by either package resumes in the other.

One line per *completed* run:

  {"run_id": ..., "spec": {RunSpec dict}, "result": {summary stats}}

Append-only with a flush per row, so a crash loses at most the in-flight
run; on load the newest row per ``run_id`` wins (a re-executed run
overrides, never duplicates, its aggregate contribution).  ``run_id`` is
the RunSpec content hash, which is what makes resume safe: re-launching
the same SweepSpec skips exactly the rows already present and cannot skip
a run whose definition changed.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional

from repro_torch.runtime.journal import JsonlSink, read_jsonl

from .spec import RunSpec

__all__ = ["RunDB"]


class RunDB:
    def __init__(self, path: str):
        self.path = path
        self._rows: Dict[str, dict] = {}
        # the runtime journal's sink: append + flush + fsync per row, the
        # same durability contract as every other journal in the repo
        self._sink = JsonlSink(path)
        if os.path.exists(path):
            for row in read_jsonl(path):
                self._rows[row["run_id"]] = row

    # ---- read -------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._rows)

    def __contains__(self, run_id: str) -> bool:
        return run_id in self._rows

    def completed_ids(self) -> set:
        return set(self._rows)

    def rows(self) -> List[dict]:
        return list(self._rows.values())

    def get(self, run_id: str) -> Optional[dict]:
        return self._rows.get(run_id)

    def specs(self) -> List[RunSpec]:
        return [RunSpec.from_dict(r["spec"]) for r in self._rows.values()]

    # ---- write ------------------------------------------------------------
    def append(self, run_id: str, spec: RunSpec, result: dict):
        row = {"run_id": run_id, "spec": spec.to_dict(), "result": result}
        self._sink.write(row)
        self._rows[run_id] = row

    def extend(self, items: Iterable):
        for run_id, spec, result in items:
            self.append(run_id, spec, result)

    def close(self):
        self._sink.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
