"""Deterministic, step-indexed synthetic LM stream.

Counterpart of ``repro.data.synthetic``: each sequence follows
``tok_{t+1} = (tok_t + stride) mod V`` with 10% uniform corruption, the
per-sequence stride to be inferred from context.  Batches are pure
functions of (seed, step), which gives exact resume and the same batch
order across precision re-runs (§4.1).  The draws come from a CPU
``torch.Generator`` seeded from (seed, step): the reference's law, not its
bits, and the same batch on every device.  The batch lands on ``cuda``
unless the caller passes another device.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.devices import resolve_device

__all__ = ["lm_batch", "lm_input_arrays"]


def lm_batch(step: int, vocab: int, batch: int, seq: int, seed: int = 0,
             noise: float = 0.1, device=None) -> Dict[str, torch.Tensor]:
    """{"tokens", "labels"}: (batch, seq) int64 on ``device`` (default
    ``cuda``), labels the tokens shifted by one."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed * 1_000_003 + step)
    start = torch.randint(0, vocab, (batch, 1), generator=g)
    stride = torch.randint(1, min(vocab, 97), (batch, 1), generator=g)
    t = torch.arange(seq + 1)[None, :]
    toks = (start + stride * t) % vocab
    corrupt = torch.rand(toks.shape, generator=g) < noise
    rand = torch.randint(0, vocab, toks.shape, generator=g)
    toks = torch.where(corrupt, rand, toks).to(device)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def lm_input_arrays(step: int, cfg, batch: int, seq: int, seed: int = 0,
                    device=None) -> Dict[str, torch.Tensor]:
    """The full input dict of an LMConfig's step.  The port's models have
    no modality frontend (ROADMAP Queue A item 4), so this is
    :func:`lm_batch` at the config's vocabulary; a frontend raises."""
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"lm_input_arrays: frontend {cfg.frontend!r} is ROADMAP Queue A "
            "item 4, not ported yet")
    return lm_batch(step, cfg.vocab, batch, seq, seed, device=device)
