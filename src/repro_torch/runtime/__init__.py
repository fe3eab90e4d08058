"""Run-time bookkeeping of the port (see ``repro.runtime``): the event
journal and its JSONL sink, checkpoint meta, segment planning and
numbering, the metric window, the memory ledger, and
:func:`snapshot_to_serve` (a mid-training model handed to a serving
engine on the device).  ``SegmentFn``'s jit trace accounting has no
counterpart: PyTorch runs eagerly and compiles nothing per qcfg."""
from .bridge import snapshot_to_serve
from .journal import (Journal, JsonlSink, RestoredMeta, checkpoint_meta,
                      parse_checkpoint_meta, read_jsonl)
from .memory import MemoryBudgetError, MemoryLedger, tree_bytes
from .segments import MetricsWindow, Segment, SegmentTracker, plan_segments

__all__ = ["Journal", "JsonlSink", "read_jsonl", "Segment", "plan_segments",
           "checkpoint_meta", "parse_checkpoint_meta", "RestoredMeta",
           "MemoryLedger", "MemoryBudgetError", "tree_bytes",
           "MetricsWindow", "SegmentTracker", "snapshot_to_serve"]
