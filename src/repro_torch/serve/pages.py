"""Paged MX KV cache: the page allocator and the page helpers.

Counterpart of ``repro.serve.pages``.  The serving cache is a global pool
of fixed-size pages per layer (``models.init_cache_paged``) instead of a
(max_len, ·) stripe per slot.  The page size is a multiple of ``MX_BLOCK``,
so pages align with the 32-wide MX block grid: the at-rest quantization of
sealed pages and the decode kernel's block scales share their boundaries,
and since Q(Q(x)) == Q(x) per aligned block, paging changes no number.

Host side (:class:`PageAllocator`, plain Python and numpy, a copy of the
reference's): a free list and per-page reference counts under the explicit
``n_pages`` budget; a prefix cache keyed on a rolling hash chain of full
prompt pages (shared pages are immutable: decode writes only the pages past
the shared prefix); LRU eviction of unreferenced cached pages, cascading to
their descendants so a chain never dangles.

Device side: in-place helpers over the list of pool tensors (each layer's
"k" and "v"): zeroing freshly allocated pages, gathering the prefix a
prefill chunk attends to, and writing a chunk into its pages with at-rest
MX quantization (through the quantize kernel on CUDA).  The reference's
pools carry a leading ``n_rep`` axis; these do not, so every axis here is
one lower than there.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.mx import MX_BLOCK
from repro_torch.kernels import ops

__all__ = ["PageAllocator", "prefix_chain", "zero_pages", "gather_prior",
           "write_chunk_pages"]


# ---------------------------------------------------------------------------
# prompt-prefix hash chain
# ---------------------------------------------------------------------------
def prefix_chain(prompt: np.ndarray, page_size: int) -> List[bytes]:
    """Rolling hash per *full* prompt page: ``h_i = H(h_{i-1} || tokens_i)``
    — equal chains imply equal token prefixes, so a chain hash is a safe
    content key for the page holding positions [i*ps, (i+1)*ps)."""
    out: List[bytes] = []
    h = b""
    n_full = len(prompt) // page_size
    for i in range(n_full):
        blk = np.ascontiguousarray(prompt[i * page_size:(i + 1) * page_size],
                                   dtype=np.int32)
        h = hashlib.blake2b(h + blk.tobytes(), digest_size=16).digest()
        out.append(h)
    return out


class PageAllocator:
    """Host-side page bookkeeping under a fixed ``n_pages`` budget."""

    def __init__(self, n_pages: int, page_size: int):
        if page_size % MX_BLOCK:
            raise ValueError(f"page_size {page_size} must be a multiple of "
                             f"MX_BLOCK ({MX_BLOCK})")
        self.n_pages = n_pages
        self.page_size = page_size
        self.free: List[int] = list(range(n_pages - 1, -1, -1))
        self.ref = np.zeros(n_pages, np.int32)
        # prefix cache: chain hash -> page, LRU-ordered; reverse map and
        # parent/children links for cascading eviction.
        self.prefix: "OrderedDict[bytes, int]" = OrderedDict()
        self.cached_page: Dict[int, bytes] = {}
        self.parent: Dict[bytes, Optional[bytes]] = {}
        self.children: Dict[bytes, set] = {}
        self.prefix_hits = 0
        self.evictions = 0

    # ---- capacity ----------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self.free)

    @property
    def n_evictable(self) -> int:
        return sum(1 for p in self.cached_page if self.ref[p] == 0)

    def available(self) -> int:
        """Pages obtainable right now: free + evictable cached."""
        return self.n_free + self.n_evictable

    @property
    def pages_in_use(self) -> int:
        return int((self.ref > 0).sum())

    # ---- prefix cache ------------------------------------------------------
    def share(self, chain: Sequence[bytes], limit: int) -> List[int]:
        """Walk the chain from the start, taking a reference on every
        cached page (at most ``limit``); stops at the first miss."""
        out: List[int] = []
        for h in chain[:limit]:
            page = self.prefix.get(h)
            if page is None:
                break
            self.prefix.move_to_end(h)           # LRU touch
            self.ref[page] += 1
            self.prefix_hits += 1
            out.append(page)
        return out

    def register(self, chain: Sequence[bytes], pages: Sequence[int]) -> None:
        """Publish a request's full prompt pages under their chain hashes
        (idempotent for already-cached prefixes)."""
        parent: Optional[bytes] = None
        for h, page in zip(chain, pages):
            if h not in self.prefix:
                self.prefix[h] = page
                self.cached_page[page] = h
                self.parent[h] = parent
                self.children.setdefault(h, set())
                if parent is not None:
                    self.children.setdefault(parent, set()).add(h)
            self.prefix.move_to_end(h)
            parent = h

    def _evict_entry(self, h: bytes) -> int:
        """Drop a cache entry and (recursively) its descendants; frees
        every evicted page whose refcount is zero.  Returns #pages freed.
        A still-referenced page only loses its cache entry and is freed
        when released."""
        freed = 0
        for child in list(self.children.get(h, ())):
            freed += self._evict_entry(child)
        page = self.prefix.pop(h, None)
        if page is None:
            return freed
        self.evictions += 1
        self.cached_page.pop(page, None)
        par = self.parent.pop(h, None)
        if par is not None and par in self.children:
            self.children[par].discard(h)
        self.children.pop(h, None)
        if self.ref[page] == 0:
            self.free.append(page)
            freed += 1
        return freed

    # ---- alloc / release ---------------------------------------------------
    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` fresh pages (refcount 1), evicting LRU cached
        prefixes as needed.  Returns None (and changes nothing visible to
        live requests) when the budget cannot cover the ask."""
        if self.available() < n:
            return None
        while len(self.free) < n:
            # Oldest entry whose page is evictable; cascade handles chains.
            victim = next((h for h, p in self.prefix.items()
                           if self.ref[p] == 0), None)
            if victim is None:
                return None
            self._evict_entry(victim)
        out = [self.free.pop() for _ in range(n)]
        for p in out:
            self.ref[p] = 1
        return out

    def release(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; unreferenced uncached pages return
        to the free list (cached ones stay resident as prefix entries)."""
        for p in pages:
            assert self.ref[p] > 0, f"double free of page {p}"
            self.ref[p] -= 1
            if self.ref[p] == 0 and p not in self.cached_page:
                self.free.append(p)

    # ---- invariants --------------------------------------------------------
    def check(self) -> None:
        free = set(self.free)
        assert len(free) == len(self.free), "free list duplicates"
        for p in free:
            assert self.ref[p] == 0, f"free page {p} has refs"
            assert p not in self.cached_page, f"free page {p} still cached"
        for h, p in self.prefix.items():
            assert self.cached_page.get(p) == h, "prefix/reverse-map drift"
            par = self.parent.get(h)
            if par is not None:
                assert par in self.prefix, f"dangling parent for {h!r}"
        accounted = len(free) + len(
            {p for p in range(self.n_pages)
             if self.ref[p] > 0 or p in self.cached_page})
        assert accounted == self.n_pages, "page leak"


# ---------------------------------------------------------------------------
# device helpers (in place, over the list of pool tensors)
# ---------------------------------------------------------------------------
def _page_index(ids, n_pages: int, device) -> Tuple[np.ndarray, torch.Tensor]:
    """(positions in ``ids`` that name a page in [0, n_pages), those page
    ids as a device index); entries out of range are dropped."""
    ids = np.asarray(ids, np.int64).reshape(-1)
    keep = np.flatnonzero((ids >= 0) & (ids < n_pages))
    return keep, torch.as_tensor(ids[keep], device=device)


def zero_pages(pools: Sequence[torch.Tensor], ids) -> None:
    """Zero physical pages ``ids`` in every pool, in place (ids outside
    [0, N) are dropped): a page (re)allocated to a request must not carry a
    previous tenant's values into its at-rest MX block scales."""
    for p in pools:
        keep, idx = _page_index(ids, p.shape[0], p.device)
        if keep.size:
            p[idx] = 0


def gather_prior(pools: Sequence[torch.Tensor], ids
                 ) -> Tuple[torch.Tensor, ...]:
    """The contiguous (1, n*ps, ...) view of the first ``n`` logical pages
    of a request (``ids``: their n physical ids): what a prefill chunk
    attends to as its prior K/V."""
    out = []
    for p in pools:
        N, ps = p.shape[:2]
        idx = torch.as_tensor(np.clip(np.asarray(ids, np.int64), 0, N - 1),
                              device=p.device)
        out.append(p[idx].reshape((1, idx.numel() * ps) + p.shape[2:]))
    return tuple(out)


def write_chunk_pages(pools: Sequence[torch.Tensor],
                      chunks: Sequence[torch.Tensor], ids, n_sealed: int,
                      rules: Sequence[str], fmt, block: int = MX_BLOCK,
                      scale_mode: str = "floor") -> None:
    """Write one prefill chunk (leaves (1, C, H, d), C = len(ids) * ps)
    into physical pages ``ids`` in place (ids outside [0, N) are dropped),
    MX-quantizing at rest.

    ``rules`` names each leaf's treatment on the first ``n_sealed`` pages,
    the fully written ones: "k" is quantized along the head dim, "v" along
    the in-page position axis (a partial page's block max would move as
    later tokens arrive); partial pages, and "raw" leaves, are stored as
    they are.  The decode kernel quantizes with the same axes and
    page-aligned blocks, so this changes no attention output."""
    n_pg = len(ids)
    for pool, ck, rule in zip(pools, chunks, rules):
        N, ps = pool.shape[:2]
        pages = ck.reshape((n_pg, ps) + ck.shape[2:])
        if fmt is not None and rule in ("k", "v") and n_sealed > 0:
            sealed = ops.mx_quantize(pages[:n_sealed].float(), fmt,
                                     axis=-1 if rule == "k" else 1,
                                     block=block, scale_mode=scale_mode)
            pages = torch.cat([sealed, pages[n_sealed:].float()])
        keep, idx = _page_index(ids, N, pool.device)
        if keep.size:
            pool[idx] = pages[torch.as_tensor(keep, device=pool.device)].to(
                pool.dtype)
