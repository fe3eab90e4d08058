"""Append-only event journal and the one checkpoint-meta serializer.

Counterpart of ``repro.runtime.journal``: a :class:`Journal` is a ``list``
of ``{"event": kind, ...}`` records, validated on append, with a JSONL
round trip; :class:`JsonlSink` is the append + fsync writer of the sweep's
RunDB; :func:`checkpoint_meta` builds the meta the Trainer persists
(qcfg, recoveries, segment index and, with a live guard, the controller's
state) and :func:`parse_checkpoint_meta` inverts it.  The meta is the
reference's JSON, so a checkpoint's meta, guard state included, reads the
same in either package.
"""
from __future__ import annotations

import json
import os
from typing import Any, Iterable, Iterator, NamedTuple, Optional

__all__ = ["Journal", "JsonlSink", "read_jsonl", "checkpoint_meta",
           "parse_checkpoint_meta", "RestoredMeta"]


class JsonlSink:
    """Append-only JSONL writer: one ``json.dumps`` line per record, flushed
    and fsync'd, so a crash loses at most the record in flight (the
    RunDB's durability contract)."""

    def __init__(self, path: str, fsync: bool = True):
        self.path = path
        self._fsync = fsync
        self._fh = None

    def write(self, obj: Any) -> None:
        if self._fh is None:
            os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                        exist_ok=True)
            self._fh = open(self.path, "a")
        self._fh.write(json.dumps(obj) + "\n")
        self._fh.flush()
        if self._fsync:
            os.fsync(self._fh.fileno())

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_jsonl(path: str) -> Iterator[dict]:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


class Journal(list):
    """Append-only event journal: a ``list`` of ``{"event": kind, ...}``
    records, validated on append."""

    def __init__(self, records: Iterable[dict] = ()):
        super().__init__()
        self.extend(records)

    def append(self, rec: dict) -> None:
        if not isinstance(rec, dict):
            raise TypeError(
                f"journal records are dicts, got {type(rec).__name__}")
        kind = rec.get("event")
        if not isinstance(kind, str) or not kind:
            raise ValueError(
                f"journal record needs a string 'event' kind: {rec!r}")
        super().append(rec)

    def extend(self, recs: Iterable[dict]) -> None:
        for rec in recs:
            self.append(rec)

    def emit(self, kind: str, **fields) -> dict:
        rec = {"event": kind, **fields}
        self.append(rec)
        return rec

    def of_kind(self, *kinds: str) -> list:
        return [r for r in self if r.get("event") in kinds]

    def last(self, kind: str) -> Optional[dict]:
        for r in reversed(self):
            if r.get("event") == kind:
                return r
        return None

    def to_jsonl(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            for rec in self:
                f.write(json.dumps(rec) + "\n")
        return path

    @classmethod
    def from_jsonl(cls, path: str) -> "Journal":
        return cls(read_jsonl(path))


class RestoredMeta(NamedTuple):
    """Parsed checkpoint meta: ``qcfg`` a QuantConfig (None when the meta
    predates it), ``guard`` the controller's raw ``state_dict`` (None
    without a guard)."""
    step: Optional[int]
    qcfg: Optional[Any]
    recoveries: Optional[int]
    guard: Optional[dict]
    segment_index: int


def checkpoint_meta(*, step: int, qcfg, recoveries: int = 0,
                    controller=None, segment_index: int = 0) -> dict:
    """The Trainer's checkpoint meta: the active precision scheme (so a
    resume cannot silently revert an intervention), the recovery count,
    the segment index and, when a guard controller is live, its whole
    autopilot state (level, hysteresis counters, journal)."""
    meta = {"step": int(step), "qcfg": qcfg.describe(),
            "qcfg_dict": qcfg.to_dict(), "recoveries": int(recoveries),
            "segment_index": int(segment_index)}
    if controller is not None:
        meta["guard"] = controller.state_dict()
    return meta


def parse_checkpoint_meta(meta: Optional[dict]) -> RestoredMeta:
    """Invert :func:`checkpoint_meta`; absent fields come back None (or
    segment 0), so older metas parse too."""
    meta = meta or {}
    qcfg = None
    if meta.get("qcfg_dict") is not None:
        from repro_torch.core import QuantConfig
        qcfg = QuantConfig.from_dict(meta["qcfg_dict"])
    return RestoredMeta(
        step=None if meta.get("step") is None else int(meta["step"]),
        qcfg=qcfg,
        recoveries=(None if meta.get("recoveries") is None
                    else int(meta["recoveries"])),
        guard=meta.get("guard"),
        segment_index=int(meta.get("segment_index", 0)))
