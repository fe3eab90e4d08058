"""Run-time bookkeeping of the port (see ``repro.runtime``): the event
journal, checkpoint meta, segment numbering, the metric window and the
memory ledger.  ``SegmentFn``'s jit trace accounting has no counterpart:
PyTorch runs eagerly and compiles nothing per qcfg."""
from .journal import (Journal, RestoredMeta, checkpoint_meta,
                      parse_checkpoint_meta, read_jsonl)
from .memory import MemoryBudgetError, MemoryLedger, tree_bytes
from .segments import MetricsWindow, SegmentTracker

__all__ = ["Journal", "read_jsonl",
           "checkpoint_meta", "parse_checkpoint_meta", "RestoredMeta",
           "MemoryLedger", "MemoryBudgetError", "tree_bytes",
           "MetricsWindow", "SegmentTracker"]
