"""Named device-memory ledgers with an optional budget.

Counterpart of ``repro.runtime.memory``: ``account(name, tree)`` binds an
entry to a tree's byte size (tensor leaves), ``release(name)`` drops it;
past ``budget_bytes`` it raises :class:`MemoryBudgetError` naming the
entries.  With a journal each change lands a ``memory`` record.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

__all__ = ["tree_bytes", "MemoryLedger", "MemoryBudgetError"]


def tree_bytes(tree: Any) -> int:
    """Total bytes of the tensor leaves of a nested dict/list tree."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


class MemoryBudgetError(RuntimeError):
    """An accounted allocation would exceed the ledger's budget."""


class MemoryLedger:
    def __init__(self, budget_bytes: Optional[int] = None, *,
                 journal=None, name: str = "device"):
        self.name = name
        self.budget_bytes = budget_bytes
        self.journal = journal
        self._entries: Dict[str, int] = {}

    def account(self, key: str, tree: Any = None, *,
                nbytes: Optional[int] = None) -> int:
        if nbytes is None:
            nbytes = tree_bytes(tree)
        self._entries[key] = int(nbytes)
        self._emit("account", key, int(nbytes))
        if self.budget_bytes is not None and self.total > self.budget_bytes:
            raise MemoryBudgetError(
                f"ledger {self.name!r}: accounting {key!r} "
                f"({int(nbytes)} B) exceeds budget {self.budget_bytes} B "
                f"(total {self.total} B): {self.report()}")
        return int(nbytes)

    def release(self, key: str) -> int:
        nb = self._entries.pop(key, 0)
        if nb:
            self._emit("release", key, nb)
        return nb

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def __getitem__(self, key: str) -> int:
        return self._entries[key]

    @property
    def total(self) -> int:
        return sum(self._entries.values())

    @property
    def headroom(self) -> Optional[int]:
        if self.budget_bytes is None:
            return None
        return self.budget_bytes - self.total

    def report(self) -> Dict[str, int]:
        out = dict(sorted(self._entries.items()))
        out["total"] = self.total
        return out

    def _emit(self, op: str, key: str, nbytes: int) -> None:
        if self.journal is not None:
            self.journal.append({
                "event": "memory", "ledger": self.name, "op": op,
                "entry": key, "bytes": int(nbytes), "total": self.total})
