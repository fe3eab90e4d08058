"""Continuous-batching scheduler: slot lifecycle + per-request sampling.

Counterpart of ``repro.serve.scheduler``.  The scheduler owns bookkeeping
only: a FIFO of pending requests, ``max_batch`` slots and the per-slot
numpy arrays (position, temperature, top-k, seed, tokens generated) that
the engine feeds to its decode step.

Determinism: a sampled token is drawn with noise from a CPU
``torch.Generator`` seeded from ``(seed, n_generated)`` alone — never from
the slot or the other requests in the batch — so results do not depend on
admission order or packing.  The port cannot reproduce ``jax.random``'s
bits; it keeps that property.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["SamplingParams", "Request", "Scheduler", "sample_tokens"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode controls. ``temperature<=0`` = greedy;
    ``top_k=0`` = full vocab."""
    temperature: float = 0.0
    top_k: int = 0
    max_new_tokens: int = 32
    seed: int = 0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                       # (T,) int32
    sampling: SamplingParams
    submit_t: float = 0.0
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None      # "eos" | "length" | "cache_full"

    @property
    def done(self) -> bool:
        return self.finish_reason is not None

    @property
    def latency_s(self) -> Optional[float]:
        if self.finish_t is None:
            return None
        return self.finish_t - self.submit_t


def _request_generator(seed: int, n: int) -> torch.Generator:
    digest = hashlib.blake2b(f"{seed}:{n}".encode(), digest_size=8).digest()
    g = torch.Generator(device="cpu")
    g.manual_seed(int.from_bytes(digest, "little") >> 1)
    return g


def sample_tokens(logits: torch.Tensor, temperature, top_k, seeds, n_gen,
                  any_sampled: bool = True, any_top_k: bool = True
                  ) -> torch.Tensor:
    """Per-slot sampling.  logits (B, V); the other arguments (B,) numpy
    arrays.  Greedy rows take the first maximal index (as jnp.argmax);
    sampled rows take the Gumbel-max draw from the temperature-scaled,
    optionally top-k-masked logits.  ``any_sampled``/``any_top_k`` skip the
    sampling and the full-vocab sort when no slot needs them."""
    B, V = logits.shape
    lf = logits.to(torch.float32)
    greedy = torch.argmax(lf, dim=-1)
    if not any_sampled:
        return greedy
    dev = logits.device
    temperature = torch.as_tensor(np.asarray(temperature, np.float32),
                                  device=dev)
    masked = lf
    if any_top_k:
        tk = torch.as_tensor(np.asarray(top_k, np.int64), device=dev)
        k = torch.where(tk > 0, torch.clamp(tk, max=V), V)
        # Rank every entry (stable: ties go to the lower index) and keep
        # exactly the k best; a >= threshold test would admit every tie.
        order = torch.argsort(-lf, dim=-1, stable=True)
        ranks = torch.argsort(order, dim=-1, stable=True)
        masked = torch.where(ranks < k[:, None], lf, -torch.inf)
    scaled = masked / torch.clamp(temperature, min=1e-6)[:, None]
    noise = torch.stack([
        torch.rand(V, generator=_request_generator(int(s), int(n)))
        for s, n in zip(np.asarray(seeds), np.asarray(n_gen))]).to(dev)
    gumbel = -torch.log(-torch.log(torch.clamp(noise, min=1e-20)))
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(temperature > 0.0, sampled, greedy)


class Scheduler:
    """Fixed-slot continuous batching (admit / decode / evict)."""

    def __init__(self, max_batch: int, max_len: int,
                 eos_id: Optional[int] = None):
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.pos = np.zeros(max_batch, np.int32)
        self.cur_tok = np.zeros(max_batch, np.int32)
        self.temp = np.zeros(max_batch, np.float32)
        self.top_k = np.zeros(max_batch, np.int32)
        self.seeds = np.zeros(max_batch, np.int32)
        self.n_gen = np.zeros(max_batch, np.int32)

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.slots)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or self.n_active > 0

    def admissions(self) -> List[Tuple[int, Request]]:
        """Pop queued requests into free slots (FIFO)."""
        out = []
        for i in range(self.max_batch):
            if self.slots[i] is None and self.queue:
                out.append((i, self.queue.popleft()))
        return out

    def place(self, slot: int, req: Request, first_token: int,
              pos: int) -> bool:
        """Install a prefilled request at ``pos`` (= prompt length) with its
        first token.  Returns True when it already finished."""
        req.tokens.append(first_token)
        req.first_token_t = time.perf_counter()
        self.slots[slot] = req
        self.pos[slot] = pos
        self.cur_tok[slot] = first_token
        self.temp[slot] = req.sampling.temperature
        self.top_k[slot] = req.sampling.top_k
        self.seeds[slot] = req.sampling.seed
        self.n_gen[slot] = 1
        return self._maybe_finish(slot, first_token)

    def batch_arrays(self):
        """(tok (B,1), pos (B,), temp, top_k, seeds, n_gen) numpy arrays.
        Positions are clamped to max_len-1: inactive slots write there, in
        rows no live request reads."""
        pos = np.minimum(self.pos, self.max_len - 1)
        return (self.cur_tok[:, None].copy(), pos, self.temp.copy(),
                self.top_k.copy(), self.seeds.copy(), self.n_gen.copy())

    def record_step(self, next_tok: np.ndarray) -> List[Request]:
        """Account one decode step; returns the requests that finished."""
        finished = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(next_tok[i])
            self.pos[i] += 1
            req.tokens.append(tok)
            self.cur_tok[i] = tok
            self.n_gen[i] += 1
            if self._maybe_finish(i, tok):
                finished.append(req)
        return finished

    def _maybe_finish(self, slot: int, tok: int) -> bool:
        req = self.slots[slot]
        if self.eos_id is not None and tok == self.eos_id:
            req.finish_reason = "eos"
        elif len(req.tokens) >= req.sampling.max_new_tokens:
            req.finish_reason = "length"
        elif self.pos[slot] >= self.max_len:
            req.finish_reason = "cache_full"
        else:
            return False
        req.finish_t = time.perf_counter()
        self.slots[slot] = None
        # Zero all per-slot state: a freed slot keeps decoding (masked) at
        # position 0 until it is re-admitted.
        self.pos[slot] = 0
        self.cur_tok[slot] = 0
        self.temp[slot] = 0.0
        self.top_k[slot] = 0
        self.seeds[slot] = 0
        self.n_gen[slot] = 0
        return True
