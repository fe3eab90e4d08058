"""Serving engines: fused prefill + continuous batching over a slab KV
cache, and chunked prefill over a paged MX KV cache.

Counterpart of ``repro.serve.engine``.  ``submit``/``step``/``drain``/
``stats`` drive the scheduler; ``events`` is a ``runtime.Journal`` of the
reference's records (submit / prefill / request_done, and preempt in the
paged engine); ``ledger`` is a ``runtime.MemoryLedger`` of the weights and
the KV state.

:class:`ServeEngine` (slab cache):
  * Prefill is one fused ``lm_prefill`` pass per request.  Prompts are
    right-padded to power-of-two buckets (>= 16) unless
    ``bucket_prompts=False``, or unless padding would not be inert
    (``pad_safe``: MoE, windowed and recurrent configs prefill at the exact
    length): padded cache slots sit beyond the causal mask until a decode
    step overwrites them.  Their K/V are written as the reference writes
    them, since decode quantizes V along the whole cache axis.
  * Admission is two-phase: every admission's prefill, first-token sample
    and row insert is issued before any result is read back, so the host
    does not wait on one admission's device work before queuing the next.
  * The (max_batch, max_len) cache is updated in place; the reference
    returns a new cache and donates the old buffers instead.

:class:`PagedServeEngine` swaps the per-slot slabs for per-layer page pools
(``models.init_cache_paged``) managed by ``pages.PageAllocator``: a request
maps only the pages its length needs, prompts prefill one chunk per
``step()`` interleaved with live decodes (``lm_prefill_chunk``), full
prompt pages are shared across requests by content, and page pressure is
resolved by LRU eviction of unreferenced cached pages or LIFO preemption of
the newest request.  Configs that cannot prefill in chunks (MoE, MLA,
windowed, recurrent) prefill each prompt whole and page the resulting
cache ("pagify"); the leaves of layers that do not page (ring buffers,
recurrent state) are copied into the request's slab row instead.  Decode
goes through the page table (the paged decode kernel on CUDA; MLA's
absorbed decode gathers its latent pages), and on the slab rows for the
other layers.

Runs on ``cuda`` unless ``device="cpu"`` is passed; raises without CUDA.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core import QuantConfig
from repro_torch.devices import resolve_device
from repro_torch.models import (LMConfig, block_plan, check_supported,
                                chunk_supported, init_cache,
                                init_cache_paged, lm_decode_step, lm_prefill,
                                lm_prefill_chunk, paged_leaf_mask)
from repro_torch.runtime import Journal, MemoryLedger
from .pages import PageAllocator, gather_prior, prefix_chain, \
    write_chunk_pages, zero_pages
from .scheduler import Request, SamplingParams, Scheduler, sample_tokens

__all__ = ["ServeEngine", "PagedServeEngine", "serving_params"]


def _bucket(n: int) -> int:
    b = 16
    while b < n:
        b *= 2
    return b


#: Leaves held in bf16 for serving: weight matrices, the embedding table
#: and the stacked expert weights (the MoE router stays fp32).
_BF16_LEAVES = ("w", "table", "w_up", "w_gate", "w_down")


def serving_params(params, device) -> dict:
    """``params`` on ``device`` with every weight matrix, the stacked
    expert weights and the embedding table held in bf16, once.  ``qdense``,
    ``moe_apply`` and ``embed_lookup`` use them in bf16 anyway, so the
    numbers are the same; norm scales and the router stay fp32."""
    def leaf(path, t):
        t = t.to(device)
        return t.to(torch.bfloat16) if path in _BF16_LEAVES else t

    def walk(tree, key=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, key) for v in tree]
        return leaf(key, tree)
    return walk(params)


class ServeEngine:
    """Continuous-batching serving engine for one (params, cfg, qcfg).
    ``bucket_prompts=False`` prefills every prompt at its exact length."""

    def __init__(self, params, cfg: LMConfig, qcfg: QuantConfig, *,
                 max_batch: int = 4, max_len: int = 256,
                 eos_id: Optional[int] = None, bucket_prompts: bool = True,
                 device=None):
        check_supported(cfg)
        self.device = resolve_device(device)
        self.params = serving_params(params, self.device)
        self.cfg = cfg
        self.qcfg = qcfg
        self.max_len = max_len
        # Bucketing is causally inert only for purely positional caches:
        # not with a ring buffer or recurrent state, which the padding
        # would run through, and not under MoE, where padded tokens would
        # take expert capacity from real ones.
        kinds = {k for pat, _ in block_plan(cfg) for k in pat}
        self.pad_safe = (bucket_prompts and cfg.window == 0
                         and cfg.n_experts == 0
                         and kinds <= {"attn", "dense_attn"})
        self.sched = Scheduler(max_batch, max_len, eos_id)
        self.cache = self._init_cache()
        self.events = Journal()
        self.ledger = MemoryLedger(name="serve")
        self.ledger.account("params", self.params)
        self.ledger.account("cache", self.cache)
        self.finished: Dict[int, Request] = {}
        self._next_rid = 0
        self._decode_steps = 0
        self._decode_time = 0.0
        self._decode_tokens = 0
        self._prefill_tokens = 0
        self._prefill_time = 0.0

    def _init_cache(self):
        return init_cache(self.cfg, self.sched.max_batch, self.max_len,
                          self.device)

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
        Tp = min(_bucket(T), self.max_len) if self.pad_safe else T
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
            for name, leaf in full.items():
                leaf[slot].copy_(one[name][0])

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

    # ---- stepping ----------------------------------------------------------
    def _pre_decode(self) -> List[Request]:
        """Hook before the batched decode (paged: page growth and
        preemption).  Returns the requests finished here."""
        return []

    def _decode_logits(self, tok: torch.Tensor, pos: torch.Tensor):
        logits, _ = lm_decode_step(self.params, self.cache, tok, pos,
                                   self.cfg, self.qcfg)
        return logits

    @torch.inference_mode()
    def _decode_batch(self) -> np.ndarray:
        tok, pos, temp, top_k, seeds, n_gen = self.sched.batch_arrays()
        logits = self._decode_logits(
            torch.as_tensor(tok, dtype=torch.long, device=self.device),
            torch.as_tensor(pos, dtype=torch.long, device=self.device))
        nxt = sample_tokens(logits, temp, top_k, seeds, n_gen,
                            bool((temp > 0).any()), bool((top_k > 0).any()))
        return nxt.cpu().numpy()

    def _post_finish(self, finished: List[Request]) -> None:
        """Hook after requests finish (paged: release their pages)."""

    @property
    def has_work(self) -> bool:
        return self.sched.has_work

    def step(self) -> List[Request]:
        """Admit what fits, then advance every live slot one token.
        Returns the requests that finished during this call."""
        finished = self._admit()
        finished.extend(self._pre_decode())
        if self.sched.n_active:
            t0 = time.perf_counter()
            nxt = self._decode_batch()
            dt = time.perf_counter() - t0
            self._decode_steps += 1
            self._decode_time += dt
            self._decode_tokens += self.sched.n_active
            finished.extend(self.sched.record_step(nxt))
        self._post_finish(finished)
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


# ===========================================================================
# paged engine
# ===========================================================================
class _PrefillJob:
    """A prompt mid-prefill: owns its slot and pages until placement."""

    __slots__ = ("req", "slot", "pages", "n_shared", "chain", "next_start",
                 "n_chunks", "t0")

    def __init__(self, req: Request, slot: int, pages: List[int],
                 n_shared: int, chain: List[bytes], next_start: int):
        self.req = req
        self.slot = slot
        self.pages = pages
        self.n_shared = n_shared
        self.chain = chain
        self.next_start = next_start
        self.n_chunks = 0
        self.t0 = time.perf_counter()


class PagedServeEngine(ServeEngine):
    """Continuous batching over a paged MX KV cache.

    ``n_pages`` x ``page_size`` is the explicit budget of KV state; a
    request maps ``T//ps + 1`` pages (its prompt plus decode headroom)
    instead of a whole ``max_len`` row; full prompt pages are shared
    between requests by content (``prefix_chain``).  Prompts prefill one
    chunk of ``min(2 * page_size, max_len)`` tokens per ``step()`` (one per
    idle row when rows are idle), interleaved with live decodes.  Prompts
    are not bucketed: chunking takes its place.  Configs that cannot chunk
    (``chunk_supported``: MoE, MLA) prefill the whole prompt in one
    ``step()`` and write the one-row cache into the request's pages
    ("pagify", the reference's path), every page of the request, shared
    prefix pages included, as the reference writes them.  The leaves of
    the layers that page (``paged_leaf_mask``: global attention and MLA)
    are page pools, a pool's at-rest rule "k" or "v" by its name, and
    "raw" (stored as it is) for MLA's latents; the other layers' leaves
    (ring buffers, recurrent state) are slab rows of ``max_batch`` x
    ``max_len``, which pagify fills with the request's row.  Such rows
    hide behind no page-table sentinel, so a job is placed in the
    ``step()`` whose prefill finished it, before the decode step writes
    every row.
    """

    def __init__(self, params, cfg: LMConfig, qcfg: QuantConfig, *,
                 max_batch: int = 4, max_len: int = 256, n_pages: int = 16,
                 page_size: int = 32, eos_id: Optional[int] = None,
                 device=None):
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} must be a multiple of "
                             f"page_size {page_size} (the page table views "
                             "a whole number of pages per row)")
        check_supported(cfg)
        self.chunk = chunk_supported(cfg)
        self.n_pages = n_pages
        self.page_size = page_size
        self.P = max_len // page_size
        super().__init__(params, cfg, qcfg, max_batch=max_batch,
                         max_len=max_len, eos_id=eos_id,
                         bucket_prompts=False, device=device)
        self.chunk_size = min(2 * page_size, max_len)
        self.alloc = PageAllocator(n_pages, page_size)
        self.page_table = np.full((max_batch, self.P), -1, np.int32)
        self.slot_pages: List[List[int]] = [[] for _ in range(max_batch)]
        self._slot_rid: List[Optional[int]] = [None] * max_batch
        self._admit_seq = np.zeros(max_batch, np.int64)
        self._seq = 0
        self._jobs: Deque[_PrefillJob] = deque()
        self._reserved: Set[int] = set()
        self._ready: List[Tuple[_PrefillJob, torch.Tensor]] = []
        self._preemptions = 0
        # The leaves, (layer, name), updated in place: page pools with
        # their at-rest rules, and the slab rows of the layers that do not
        # page.
        mask = paged_leaf_mask(cfg)
        keys = [(i, n) for i, lc in enumerate(self.cache) for n in lc]
        self._pool_keys = [(i, n) for i, n in keys if mask[i][n]]
        self._slab_keys = [(i, n) for i, n in keys if not mask[i][n]]
        self._pools = [self.cache[i][n] for i, n in self._pool_keys]
        self._rules = tuple(n if n in ("k", "v") else "raw"
                            for _, n in self._pool_keys)
        self._rest_fmt = qcfg.a_fwd if qcfg.attn else None
        self.ledger.release("cache")
        self.ledger.account("page_pool", self._pools)
        self.ledger.account("slab_fallback",
                            [self.cache[i][n] for i, n in self._slab_keys])

    def _init_cache(self):
        return init_cache_paged(self.cfg, self.n_pages, self.page_size,
                                self.device, B=self.sched.max_batch,
                                S=self.max_len)

    def _zero(self, page_ids: List[int]) -> None:
        if page_ids and self._pools:
            zero_pages(self._pools, page_ids)

    def _row_ids(self, pages: List[int], start_page: int,
                 n: int) -> np.ndarray:
        """Physical ids for logical pages [start_page, start_page+n), with
        the out-of-range sentinel (= n_pages) where unmapped."""
        ids = np.full(n, self.n_pages, np.int32)
        for j in range(n):
            lp = start_page + j
            if lp < len(pages):
                ids[j] = pages[lp]
        return ids

    # ---- admission: jobs, chunks, placement --------------------------------
    def _pages_needed(self, T: int) -> int:
        # Prompt pages plus one decode-headroom page (the first generated
        # token is fed at position T); capped at the per-row view P.
        return min(T // self.page_size + 1, self.P)

    def _start_jobs(self) -> List[Request]:
        finished = []
        while self.sched.queue:
            slot = next((i for i in range(self.sched.max_batch)
                         if self.sched.slots[i] is None
                         and i not in self._reserved), None)
            if slot is None:
                break
            req = self.sched.queue[0]
            T = int(req.prompt.size)
            ps = self.page_size
            need_total = self._pages_needed(T)
            if need_total > self.n_pages:
                # Can never fit, even with the pool to itself.
                self.sched.queue.popleft()
                req.finish_reason = "cache_full"
                req.finish_t = time.perf_counter()
                finished.append(req)
                continue
            chain = prefix_chain(req.prompt, ps)
            # Share at most (T-1)//ps pages: at least one prompt token is
            # always recomputed so the final chunk yields the logits.
            shared = self.alloc.share(chain, (T - 1) // ps)
            fresh = self.alloc.alloc(need_total - len(shared))
            if fresh is None:
                self.alloc.release(shared)
                break                      # wait for live work to free pages
            self.sched.queue.popleft()
            self._zero(fresh)
            pages = shared + fresh
            self.slot_pages[slot] = pages
            self.page_table[slot, :] = -1
            self.page_table[slot, :len(pages)] = pages
            self._reserved.add(slot)
            self._jobs.append(_PrefillJob(req, slot, pages, len(shared),
                                          chain,
                                          next_start=len(shared) * ps))
        return finished

    def _pagify(self, job: _PrefillJob) -> None:
        """Whole-prompt prefill of a job: its one-row cache into the row's
        P pages, with the prompt's ``T // ps`` full pages sealed, and into
        the job's slab row for the layers that do not page."""
        req, T = job.req, int(job.req.prompt.size)
        logits, one_cache, _ = self._prefill_one(req)
        if self._pools:
            write_chunk_pages(self._pools,
                              [one_cache[i][n] for i, n in self._pool_keys],
                              self._row_ids(job.pages, 0, self.P),
                              T // self.page_size, self._rules,
                              self._rest_fmt, self.qcfg.block,
                              self.qcfg.scale_mode)
        for i, n in self._slab_keys:
            self.cache[i][n][job.slot].copy_(one_cache[i][n][0])
        job.n_chunks = 1
        self._ready.append((job, self._first_token(logits, req.sampling)))
        self._jobs.popleft()

    def _advance_job(self) -> None:
        """Run one prefill chunk of the oldest in-flight job (the whole
        prompt for configs outside ``chunk_supported``)."""
        job = self._jobs[0]
        if not self.chunk:
            self._pagify(job)
            return
        req, T, ps = job.req, int(job.req.prompt.size), self.page_size
        start = job.next_start
        C = self.chunk_size
        real = min(T - start, C)
        toks = np.zeros(C, np.int64)
        toks[:real] = req.prompt[start:start + real]
        dev = self.device
        kv_mask = torch.as_tensor(np.arange(C) < real, device=dev)[None]
        prior = [dict() for _ in self.cache]
        for (i, n), t in zip(self._pool_keys, gather_prior(
                self._pools, self._row_ids(job.pages, 0, start // ps))):
            prior[i][n] = t
        logits, chunk_kv = lm_prefill_chunk(
            self.params, torch.as_tensor(toks, device=dev)[None], prior,
            start, self.cfg, self.qcfg,
            torch.tensor([real - 1], device=dev), kv_mask)
        n_sealed = max(0, min(T // ps - start // ps, C // ps))
        write_chunk_pages(self._pools,
                          [chunk_kv[i][n] for i, n in self._pool_keys],
                          self._row_ids(job.pages, start // ps, C // ps),
                          n_sealed, self._rules, self._rest_fmt,
                          self.qcfg.block, self.qcfg.scale_mode)
        job.n_chunks += 1
        job.next_start = start + C
        if job.next_start >= T:
            self._ready.append((job, self._first_token(logits,
                                                       req.sampling)))
            self._jobs.popleft()

    @torch.inference_mode()
    def _admit(self) -> List[Request]:
        finished = self._start_jobs()
        # With idle rows the decode step pays its fixed cost anyway, so run
        # one prefill chunk per idle row (at least one); a full batch runs
        # one chunk per step to protect decode latency.
        budget = max(1, self.sched.max_batch - self.sched.n_active)
        for _ in range(budget):
            if not self._jobs:
                break
            self._advance_job()
        finished.extend(self._place_ready())
        return finished

    def _place_ready(self) -> List[Request]:
        """Install the jobs whose last chunk just ran, in the same
        ``step()``: a finished job's row is still dead, and the next
        decode step writes every row, so it would clobber the job's ring
        and recurrent state (slab leaves hide behind no page-table
        sentinel, as pool leaves do)."""
        finished = []
        while self._ready:
            job, first = self._ready.pop(0)
            req = job.req
            T = int(req.prompt.size)
            tok0 = int(first[0])
            dt = time.perf_counter() - job.t0
            self._prefill_tokens += T
            self._prefill_time += dt
            self.events.append({"event": "prefill", "rid": req.rid,
                                "slot": job.slot, "prompt_len": T,
                                "padded_len": T, "fused": True,
                                "chunks": job.n_chunks,
                                "shared_pages": job.n_shared,
                                "time_s": dt})
            self._reserved.discard(job.slot)
            self._slot_rid[job.slot] = req.rid
            self._admit_seq[job.slot] = self._seq
            self._seq += 1
            full = T // self.page_size
            self.alloc.register(job.chain[:full], job.pages[:full])
            if self.sched.place(job.slot, req, tok0, T):
                finished.append(req)
        return finished

    # ---- page lifecycle ----------------------------------------------------
    def _release_slot(self, slot: int) -> None:
        if self.slot_pages[slot]:
            self.alloc.release(self.slot_pages[slot])
        self.slot_pages[slot] = []
        self.page_table[slot, :] = -1
        self._slot_rid[slot] = None

    def _post_finish(self, finished: List[Request]) -> None:
        rids = {req.rid for req in finished}
        for slot in range(self.sched.max_batch):
            if self._slot_rid[slot] in rids:
                self._release_slot(slot)

    def _preempt(self, exclude: int) -> bool:
        """Evict the most recently admitted live request (LIFO: it has the
        least sunk decode work) and requeue it at the queue front for a
        deterministic replay (same seed/n_gen stream, same tokens)."""
        cands = [s for s in range(self.sched.max_batch)
                 if self.sched.slots[s] is not None and s != exclude]
        if not cands:
            return False
        victim = max(cands, key=lambda s: self._admit_seq[s])
        req = self.sched.slots[victim]
        self.sched.slots[victim] = None
        self._scrub_slot(victim)
        self._release_slot(victim)
        req.tokens.clear()
        req.first_token_t = None
        self.sched.queue.appendleft(req)
        self._preemptions += 1
        self.events.append({"event": "preempt", "rid": req.rid,
                            "slot": victim})
        return True

    def _scrub_slot(self, slot: int) -> None:
        s = self.sched
        s.pos[slot] = 0
        s.cur_tok[slot] = 0
        s.temp[slot] = 0.0
        s.top_k[slot] = 0
        s.seeds[slot] = 0
        s.n_gen[slot] = 0

    def _force_finish(self, slot: int, reason: str) -> Request:
        req = self.sched.slots[slot]
        req.finish_reason = reason
        req.finish_t = time.perf_counter()
        self.sched.slots[slot] = None
        self._scrub_slot(slot)
        self._release_slot(slot)
        return req

    def _pre_decode(self) -> List[Request]:
        """Grow each live row's page map to cover the position it writes
        this step; resolve pressure by preemption, or finish the row
        "cache_full" when it is alone in the pool."""
        finished = []
        fresh_ids: List[int] = []
        for slot in range(self.sched.max_batch):
            req = self.sched.slots[slot]
            if req is None:
                continue
            need = int(self.sched.pos[slot]) // self.page_size + 1
            while len(self.slot_pages[slot]) < need:
                got = self.alloc.alloc(1)
                if got is None:
                    if not self._preempt(exclude=slot):
                        finished.append(self._force_finish(slot,
                                                           "cache_full"))
                        break
                    continue
                idx = len(self.slot_pages[slot])
                self.slot_pages[slot].append(got[0])
                self.page_table[slot, idx] = got[0]
                fresh_ids.append(got[0])
        self._zero(fresh_ids)
        return finished

    # ---- decode ------------------------------------------------------------
    def _decode_logits(self, tok: torch.Tensor, pos: torch.Tensor):
        # Every row decodes, live or not.  A reserved row's table already
        # maps the pages of its in-flight prompt, so the decode view blanks
        # every non-live row: its write is dropped instead of landing in
        # page 0 of that prompt.
        live = np.fromiter((r is not None for r in self.sched.slots),
                           bool, self.sched.max_batch)
        pt = np.where(live[:, None], self.page_table, -1).astype(np.int32)
        logits, _ = lm_decode_step(
            self.params, self.cache, tok, pos, self.cfg, self.qcfg,
            page_table=torch.as_tensor(pt, device=self.device),
            live=torch.as_tensor(np.flatnonzero(live), device=self.device))
        return logits

    @property
    def has_work(self) -> bool:
        return (self.sched.has_work or bool(self._jobs)
                or bool(self._ready))

    # ---- reporting ---------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        out = super().stats()
        out.update({
            "n_pages": float(self.n_pages),
            "page_size": float(self.page_size),
            "pages_in_use": float(self.alloc.pages_in_use),
            "pages_free": float(self.alloc.n_free),
            "prefix_hits": float(self.alloc.prefix_hits),
            "evictions": float(self.alloc.evictions),
            "preemptions": float(self._preemptions),
        })
        return out
