"""ServeEngine: fused prefill + continuous batching over a slab KV cache.

Counterpart of ``repro.serve.engine.ServeEngine``: ``submit``/``step``/
``drain``/``stats`` drive the scheduler; ``events`` is a plain list of the
reference's record dicts (submit / prefill / request_done).

  * Prefill is one fused ``lm_prefill`` pass per request.  Prompts are
    right-padded to power-of-two buckets (>= 16): padded cache slots sit
    beyond the causal mask until a decode step overwrites them.  Their K/V
    are written as the reference writes them, since decode quantizes V
    along the whole cache axis.
  * Admission is two-phase: every admission's prefill, first-token sample
    and row insert is issued before any result is read back, so the host
    does not wait on one admission's device work before queuing the next.
  * The (max_batch, max_len) cache is updated in place; the reference
    returns a new cache and donates the old buffers instead.

Runs on ``cuda`` unless ``device="cpu"`` is passed; raises without CUDA.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import QuantConfig
from repro_torch.devices import resolve_device
from repro_torch.models import (LMConfig, check_supported, init_cache,
                                lm_decode_step, lm_prefill)
from .scheduler import Request, SamplingParams, Scheduler, sample_tokens

__all__ = ["ServeEngine", "serving_params"]


def _bucket(n: int) -> int:
    b = 16
    while b < n:
        b *= 2
    return b


def serving_params(params, device) -> dict:
    """``params`` on ``device`` with every weight matrix and the embedding
    table held in bf16, once.  ``qdense`` and ``embed_lookup`` use them in
    bf16 anyway, so the numbers are the same; norm scales stay fp32."""
    def leaf(path, t):
        t = t.to(device)
        return t.to(torch.bfloat16) if path in ("w", "table") else t

    def walk(tree, key=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, key) for v in tree]
        return leaf(key, tree)
    return walk(params)


class ServeEngine:
    """Continuous-batching serving engine for one (params, cfg, qcfg)."""

    def __init__(self, params, cfg: LMConfig, qcfg: QuantConfig, *,
                 max_batch: int = 4, max_len: int = 256,
                 eos_id: Optional[int] = None, device=None):
        check_supported(cfg)
        self.device = resolve_device(device)
        self.params = serving_params(params, self.device)
        self.cfg = cfg
        self.qcfg = qcfg
        self.max_len = max_len
        self.sched = Scheduler(max_batch, max_len, eos_id)
        self.cache = init_cache(cfg, max_batch, max_len, self.device)
        self.events: List[dict] = []
        self.finished: Dict[int, Request] = {}
        self._next_rid = 0
        self._decode_steps = 0
        self._decode_time = 0.0
        self._decode_tokens = 0
        self._prefill_tokens = 0
        self._prefill_time = 0.0

    # ---- request lifecycle -------------------------------------------------
    def submit(self, prompt, sampling: Optional[SamplingParams] = None) -> int:
        """Queue a prompt (1-D int sequence). Returns the request id."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        sp = sampling or SamplingParams()
        if prompt.size == 0:
            raise ValueError("empty prompt")
        # A prompt that fills the cache exactly leaves no slot for a second
        # token; only a 1-token budget fits.
        if prompt.size > self.max_len or (prompt.size == self.max_len
                                          and sp.max_new_tokens > 1):
            raise ValueError(
                f"prompt length {prompt.size} with max_new_tokens "
                f"{sp.max_new_tokens} cannot fit max_len {self.max_len}: "
                "decode needs a cache position per generated token after "
                "the first")
        rid = self._next_rid
        self._next_rid += 1
        self.sched.submit(Request(rid=rid, prompt=prompt, sampling=sp,
                                  submit_t=time.perf_counter()))
        self.events.append({"event": "submit", "rid": rid,
                            "prompt_len": int(prompt.size)})
        return rid

    def _prefill_one(self, req: Request):
        """(logits (1, V), one-row cache, padded length) for a request."""
        T = req.prompt.size
        Tp = min(_bucket(T), self.max_len)
        toks = np.zeros(Tp, np.int64)
        toks[:T] = req.prompt
        logits, cache = lm_prefill(
            self.params, torch.as_tensor(toks, device=self.device)[None],
            self.cfg, self.qcfg, self.max_len,
            torch.tensor([T - 1], device=self.device))
        return logits, cache, Tp

    def _first_token(self, logits, sp: SamplingParams):
        return sample_tokens(logits, [sp.temperature], [sp.top_k],
                             [sp.seed], [0], sp.temperature > 0.0,
                             sp.top_k > 0)

    def _insert_row(self, one_cache, slot: int) -> None:
        """Copy a one-request cache into batch row ``slot`` (whole row, so
        a finished request's stale entries are overwritten)."""
        for full, one in zip(self.cache, one_cache):
            full["k"][slot].copy_(one["k"][0])
            full["v"][slot].copy_(one["v"][0])

    @torch.inference_mode()
    def _admit(self) -> List[Request]:
        finished = []
        staged = []
        for slot, req in self.sched.admissions():
            t0 = time.perf_counter()
            logits, one_cache, padded = self._prefill_one(req)
            first = self._first_token(logits, req.sampling)
            self._insert_row(one_cache, slot)
            staged.append((slot, req, first, padded, t0))
        for slot, req, first, padded, t0 in staged:
            tok0 = int(first[0])               # realizes this admission
            dt = time.perf_counter() - t0
            self._prefill_tokens += int(req.prompt.size)
            self._prefill_time += dt
            self.events.append({"event": "prefill", "rid": req.rid,
                                "slot": slot,
                                "prompt_len": int(req.prompt.size),
                                "padded_len": padded, "fused": True,
                                "time_s": dt})
            if self.sched.place(slot, req, tok0, req.prompt.size):
                finished.append(req)
        return finished

    @torch.inference_mode()
    def _decode_batch(self) -> np.ndarray:
        tok, pos, temp, top_k, seeds, n_gen = self.sched.batch_arrays()
        logits, _ = lm_decode_step(
            self.params, self.cache,
            torch.as_tensor(tok, dtype=torch.long, device=self.device),
            torch.as_tensor(pos, dtype=torch.long, device=self.device),
            self.cfg, self.qcfg)
        nxt = sample_tokens(logits, temp, top_k, seeds, n_gen,
                            bool((temp > 0).any()), bool((top_k > 0).any()))
        return nxt.cpu().numpy()

    @property
    def has_work(self) -> bool:
        return self.sched.has_work

    def step(self) -> List[Request]:
        """Admit what fits, then advance every live slot one token.
        Returns the requests that finished during this call."""
        finished = self._admit()
        if self.sched.n_active:
            t0 = time.perf_counter()
            nxt = self._decode_batch()
            dt = time.perf_counter() - t0
            self._decode_steps += 1
            self._decode_time += dt
            self._decode_tokens += self.sched.n_active
            finished.extend(self.sched.record_step(nxt))
        for req in finished:
            self.finished[req.rid] = req
            self.events.append({"event": "request_done", "rid": req.rid,
                                "reason": req.finish_reason,
                                "n_tokens": len(req.tokens),
                                "latency_s": req.latency_s})
        return finished

    def drain(self) -> List[Request]:
        """Run until queue and slots are empty; returns every finished
        request (rid order)."""
        while self.has_work:
            self.step()
        return [self.finished[rid] for rid in sorted(self.finished)]

    def stats(self) -> Dict[str, float]:
        lat = [r.latency_s for r in self.finished.values()
               if r.latency_s is not None]
        return {
            "n_finished": float(len(self.finished)),
            "prefill_tokens": float(self._prefill_tokens),
            "prefill_time_s": self._prefill_time,
            "prefill_tok_s": self._prefill_tokens / max(self._prefill_time,
                                                        1e-9),
            "decode_steps": float(self._decode_steps),
            "decode_tokens": float(self._decode_tokens),
            "decode_time_s": self._decode_time,
            "decode_tok_s": self._decode_tokens / max(self._decode_time,
                                                      1e-9),
            "mean_latency_s": float(np.mean(lat)) if lat else 0.0,
        }
