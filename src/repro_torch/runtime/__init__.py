"""Run-time bookkeeping of the port (see ``repro.runtime``): the event
journal and its JSONL sink, checkpoint meta, segment planning and
numbering, the metric window and the memory ledger.  ``SegmentFn``'s jit
trace accounting has no counterpart: PyTorch runs eagerly and compiles
nothing per qcfg."""
from .journal import (Journal, JsonlSink, RestoredMeta, checkpoint_meta,
                      parse_checkpoint_meta, read_jsonl)
from .memory import MemoryBudgetError, MemoryLedger, tree_bytes
from .segments import MetricsWindow, Segment, SegmentTracker, plan_segments

__all__ = ["Journal", "JsonlSink", "read_jsonl", "Segment", "plan_segments",
           "checkpoint_meta", "parse_checkpoint_meta", "RestoredMeta",
           "MemoryLedger", "MemoryBudgetError", "tree_bytes",
           "MetricsWindow", "SegmentTracker"]
