"""AttnSpec: one static description of an attention call's mask + geometry.

A copy of ``repro.core.attnspec``: one frozen, hashable dataclass that
parameterizes the plain flash-attention scan, the CUDA flash kernel and
the serve engine's prefill/decode paths, so mask semantics cannot drift
between them.

Mask kinds
----------
  "causal"   query position ``q_offset + i`` attends kv positions <= it.
  "full"     every (valid) kv position — cross-attention / encoder.
  "window"   causal AND within the last ``window`` positions (inclusive
             of self): ``0 <= qpos - kpos < window``.
  "ring"     decode-time ring-buffer cache of size S == cache capacity:
             slot validity is derived from per-row positions (dynamic, so
             the validity mask is an *argument* of the decode contraction,
             not part of the spec).
  "paged"    decode against a paged KV cache: per-request page tables map
             logical positions onto a global page pool; ``cache_len`` is
             the *gathered view* length (pages-per-request × page_size)
             and ``page_size`` the page granularity (a multiple of
             MX_BLOCK so at-rest MX quantization aligns with page edges).

Only static (python int/str) fields live here; dynamic per-row positions
are passed alongside the operands.  ``q_chunk``/``kv_chunk`` are the tile
sizes of the flash scan; in MX mode the kv tile is part of the numerics
(the probabilities are quantized after the rescale by the running max over
the whole tile), so the CUDA kernel honours it too.
"""
from __future__ import annotations

import dataclasses

__all__ = ["AttnSpec"]

_KINDS = ("causal", "full", "window", "ring", "paged")


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    kind: str = "causal"     # "causal" | "full" | "window" | "ring" | "paged"
    window: int = 0          # window size for kind in ("window", "ring")
    q_offset: int = 0        # static query-position offset (prefill cont.)
    q_chunk: int = 512       # query tile rows (flash scan + kernel tile)
    kv_chunk: int = 1024     # kv tile columns (flash scan + kernel tile)
    cache_len: int = 0       # decode-cache capacity (0 = derive from array)
    page_size: int = 0       # paged decode: page granularity (kind="paged")

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown AttnSpec kind {self.kind!r}; "
                             f"expected one of {_KINDS}")
        if self.kind in ("window", "ring") and self.window <= 0:
            raise ValueError(f"kind={self.kind!r} needs window > 0")
        if self.kind == "paged":
            if self.page_size <= 0:
                raise ValueError("kind='paged' needs page_size > 0")
            if self.cache_len <= 0 or self.cache_len % self.page_size:
                raise ValueError(
                    f"kind='paged' needs cache_len ({self.cache_len}) to be "
                    f"a positive multiple of page_size ({self.page_size})")

    # -- constructors for the three call-site families ---------------------
    @classmethod
    def training(cls, *, causal: bool = True, window: int = 0,
                 q_chunk: int = 512, kv_chunk: int = 1024,
                 q_offset: int = 0) -> "AttnSpec":
        """Full-sequence forward (training / fused prefill / cross-attn)."""
        if window > 0:
            return cls(kind="window", window=window, q_chunk=q_chunk,
                       kv_chunk=kv_chunk, q_offset=q_offset)
        return cls(kind="causal" if causal else "full", q_chunk=q_chunk,
                   kv_chunk=kv_chunk, q_offset=q_offset)

    @classmethod
    def decode(cls, *, window: int = 0, cache_len: int = 0,
               page_size: int = 0) -> "AttnSpec":
        """One-token (Tq=1) decode against a full, ring, or paged cache."""
        if page_size > 0:
            if window > 0:
                raise ValueError("paged decode does not support windowed "
                                 "(ring) caches; use the slab fallback")
            return cls(kind="paged", cache_len=cache_len,
                       page_size=page_size)
        if window > 0:
            return cls(kind="ring", window=window, cache_len=cache_len)
        return cls(kind="causal", cache_len=cache_len)

    @property
    def is_causal(self) -> bool:
        return self.kind in ("causal", "window")

    def with_offset(self, q_offset: int) -> "AttnSpec":
        return dataclasses.replace(self, q_offset=q_offset)
