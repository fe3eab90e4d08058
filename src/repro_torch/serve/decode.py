"""Serving wrappers: batch ``generate`` and the token-stepped oracle.

Counterpart of ``repro.serve.decode``.  ``generate`` submits one request
per prompt row to a ``ServeEngine`` and drains it; ``prefill_into_cache``
feeds a prompt token by token through ``lm_decode_step``, the exact
per-token oracle the fused ``lm_prefill`` is held against.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import QuantConfig
from repro_torch.models import LMConfig, init_cache, lm_decode_step
from .engine import ServeEngine
from .scheduler import SamplingParams

__all__ = ["generate", "prefill_into_cache"]


@torch.inference_mode()
def prefill_into_cache(params, tokens: torch.Tensor, cfg: LMConfig,
                       qcfg: QuantConfig, max_len: int):
    """Feed ``tokens`` (B, T) one position at a time through the decode
    path into a fresh (B, max_len) cache on the tokens' device.  Returns
    (logits (B, vocab) after the last token, cache)."""
    B, T = tokens.shape
    cache = init_cache(cfg, B, max_len, tokens.device)
    logits = None
    for t in range(T):
        logits, cache = lm_decode_step(params, cache, tokens[:, t:t + 1],
                                       torch.tensor(t, device=tokens.device),
                                       cfg, qcfg)
    return logits, cache


def generate(params, prompt, cfg: LMConfig, qcfg: QuantConfig,
             max_new_tokens: int = 32, temperature: float = 0.0,
             seed: int = 0, max_len: Optional[int] = None,
             device=None) -> torch.Tensor:
    """Greedy (or sampled) continuation of ``prompt`` (B, T): one request
    per row through a ``ServeEngine`` on ``device`` (default ``cuda``).
    Row ``i`` samples with seed ``seed + i``.  Returns (B, max_new_tokens)
    int32 tokens on the CPU."""
    prompt = np.asarray(prompt)
    B, T = prompt.shape
    max_len = max_len or (T + max_new_tokens)
    engine = ServeEngine(params, cfg, qcfg, max_batch=B, max_len=max_len,
                         device=device)
    rids = [engine.submit(prompt[i],
                          SamplingParams(temperature=temperature,
                                         max_new_tokens=max_new_tokens,
                                         seed=seed + i))
            for i in range(B)]
    done = {r.rid: r for r in engine.drain()}
    return torch.as_tensor(np.stack(
        [np.asarray(done[r].tokens, np.int32)[:max_new_tokens]
         for r in rids]))
