#!/usr/bin/env python3
"""Quickest proof that the PyTorch port serves (slab and paged KV caches)
and trains on an NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository checkout around this file
(``src/repro_torch``); imports nothing of JAX or of the JAX package.
Phases, each of which raises on failure:

  1. build    — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
                into ``build/repro_torch/<source hash>/`` (parallel nvcc).
  2. kernels  — each kernel against its plain PyTorch version on the card at
                the serve path's shapes (MX E4M3 and bf16 modes; flash at
                buckets 64 and 512, and at the training shape BH 64, T 512
                with SDPA beside bf16 mode; the quantize kernel at the
                training step's xn (4096, 512) fp32, its bf16 twin, the
                serve shapes, K 48 and 70 and a misaligned view, each
                bitwise under every scale rule), timed by the profiler's
                device time
                against the plain version and, where one exists, a PyTorch
                call.  Attention outputs are held per element; planted
                faults in the plain attention must fail that check.  The
                forward GEMM on both of its paths (small-M kernel, and the
                quantize-once wgmma product) at every M of the main path,
                each called twice for equal bits, and both paths timed
                around the plan's switch.  MXFP6 and MXFP4 (E3M2, E2M3,
                E2M1) under each scale rule: quantize bitwise, the
                forward GEMM on both paths, the dgrad and wgrad on the
                proxy's fp32 operands, and the cast without the
                min_normal_exp clamp planted, which the checks reject.
                The flash forward at its edges (FLASH_FWD_EDGES: ragged
                T 300, G 2, window with q_offset, full Tq 300 / Tk 200,
                d 128, a chunked prefill, two JAX tiles causal and full,
                head dims 100) in both modes, each called twice for equal
                bits, its fp32 out the bf16 out before its rounding; an
                output whose p holds a near tie of its cast may differ by
                what the tie moves when each p moves by its reach, taken
                from its score's term bound (flash_tie_slack, p_reach;
                the plain p's measured gap to fp64 printed beside it, and
                planted faults run through it).  In bf16 mode its
                fp32 out against fp64 attention within max(1, 2x) the
                plain version's reading, with "p as one bf16 piece"
                planted.
     scale-modes — all eight kernels under "bump" and "adaptive" against
                their plain versions, on inputs whose blocks make the rules
                matter; adaptive choices that differ must be near ties
                (counted); the floor rule under "bump" and "always e + 1"
                under "adaptive" planted, which the checks reject.
     lanes    — the lane GEMMs (kernels 2-4 with a lane axis) at 8 lanes,
                at the fig6 preset's shapes and ProxyConfig()'s, fp32, in
                E4M3, E5M2, E3M2, E2M3 and E2M1 under every rule: each
                lane bitwise to the 2-D kernel on its operands, within
                gemm_check of the plain version, equal bits on a second
                call; a lane reading its neighbour's weight and a plan
                folding the lane count into the splits planted and
                rejected; timed against 8 2-D calls and torch.bmm.
  3. serve    — ``ServeEngine`` on olmo-paper (full width, n = 8) with seeded
                random weights: 8 requests under ``mxfp8_e4m3`` and under
                ``e4m3_bf16act``; every request must finish and every
                kernel of the path must have been launched.
  4. parity   — one 64-token request through ``lm_prefill`` + 8 greedy
                decode steps on the card (kernels) and on the CPU (plain
                versions) with the same weights; logits must agree.
  5. train    — olmo-paper full trains 20 steps at batch 8 x 512 under
                ``mxfp8_e4m3`` and ``e4m3_bf16act`` through the Trainer:
                losses, step time, tokens/s, idle share, peak memory and
                launches per step; the loss must fall, every kernel of the
                path launch, and two 3-step replays give the same bits.
  6. grad-parity — one step's gradients on the card and on the CPU (B 2,
                T 512, full width): every layernorm gradient non-zero and
                within its limit.
  7. recovery — a batch poisoned at step 12 makes the Trainer roll back to
                the step-10 checkpoint, twice: with ``bf16_activations`` the
                quantize kernel must then launch no more; with
                ``bump_exponent`` (the paper's Fig. 7 scale bump) the run
                continues under the "bump" rule, its kernels still
                launching.
     guard    — the precision autopilot at olmo-paper's full width (8 x
                512, ``mxfp8_e4m3``) under the reference's instability
                injector: the fixed scheme exhausts its 2 recoveries; the
                trend policy (a probe every 5 steps) escalates before the
                watchdog, de-escalates and finishes 80 steps; the
                journaled schedule replays it bitwise; launches per step
                match each rung ([train]'s counts; a probe step adds one
                flash forward and one flash dgrad a layer); a checkpoint
                mid-escalation resumes the controller and trains on
                bitwise; the journal survives JSONL.  Times a ζ-probe
                step, the monitors' overhead with the probe off (<= 0.5)
                and the de-escalated step against the pre-escalation one
                (<= 2.0), the reference's gates.
     snapshot — ``snapshot_to_serve`` from the guard's trainer into a
                ServeEngine and a PagedServeEngine: greedy tokens bitwise
                those of engines built from a checkpoint round trip, and
                unchanged after 3 more training steps; snapshot ms and
                peak memory printed.
  8. proxy    — the paper's student-teacher proxy at full width trains 20
                steps under ``mxfp8_e4m3``.
  9. sweep    — the fig6 preset at its full budget (5 schemes x 8 seeds,
                500 steps, d_model 128, 4 layers, batch 256) packed into
                a RunDB; a resume after stop_after=7 that must reproduce
                the uninterrupted aggregates; a fig7 pair bitwise equal
                before its fp32 switch; an advisory autopilot pack; one
                kind="lm" run of table1 through the Trainer.
 10. sweep-parity — packed against sequential (rtol 2e-4 / atol 1e-7,
                equal spike flags), launches of a pack step at 8 lanes
                against 1, and the reference's gate: 8 seeds packed at
                least 3x faster than sequential.
 11. paged-parity — page pools filled by chunked prefill for 4 prompts:
                one decode step through the page table and one slab step
                on the gathered cache give bitwise equal logits, and the
                new K/V rows land in the mapped pages; chunked against
                whole prefill logits within CHUNK_ATOL.
 12. paged    — the JAX package's bursty 32-request trace through the slab
                engine (2 rows x 256) and the paged engine (6 rows, 16
                pages of 32) under both presets: every request finishes,
                the allocator ends empty, the prefix cache hits, the paged
                decode kernel runs every paged decode step, and the token
                streams agree under the margin rule.
 13. moe      — olmo-paper's state freed, moonshot-v1-16b-a3b at full
                width with its depth cut to 4 layers (1 dense, 3 MoE;
                weights from a CUDA generator): the lane GEMMs at the
                experts' training shapes (64 lanes of 480 rows, d_model
                2048, moe_dff 1408, bf16, E4M3) bitwise to the 2-D kernel
                lane by lane and within gemm_check; ServeEngine with 8
                greedy 64-token prompts x 32 tokens (all finish; 3 lane
                GEMMs per MoE layer per prefill and decode step); teacher-
                forced logits of the lead dense layer and one MoE layer on
                the card against the CPU; PagedServeEngine on the same
                prompts through its whole-prompt path (tokens equal the
                slab engine's, the paged decode kernel launched); 10
                Trainer steps at 8 x 512
                under mxfp8_e4m3 and bf16 (finite, falling losses; 3
                forward, 3 dgrad and 3 wgrad lane GEMMs a step per MoE
                layer) and two 3-step replays with equal bits.
 14. mla      — moonshot's state freed, deepseek-v2-236b at full width
                (MLA: qk head dim 192, v 128, kv_lora 512; weights from a
                CUDA generator) with its depth cut to 2 layers (1 dense,
                1 MoE of 160 experts): ServeEngine and PagedServeEngine
                (whole-prompt prefill, latent pages) with 8 greedy
                64-token prompts x 32 tokens, all finishing, paged tokens
                bitwise the slab engine's; the absorbed decode's
                teacher-forced logits against the expanded form's at the
                same 8 positions; then the lead dense layer alone: logits
                on the card against the CPU at 64 positions, and 10
                Trainer steps at 4 x 512 under mxfp8_e4m3 and bf16 (one
                flash forward and one flash dgrad a layer a step; finite,
                falling losses) with two 3-step replays of equal bits.
 15. rgemma   — deepseek's state freed: kernels 5 and 6 at recurrentgemma's
                attention (BH 2, G 16, T 4096, window 2048, d 256 / dv
                256; and 300 queries at q_offset 2048) in both modes with
                the flash checks and the window one position wider
                planted, kernel 7 at its ring decode (B 4, G 16, S 2048,
                rows before and after the wrap) with the ring's age rule
                planted one slot ahead, each timed against SDPA with the
                mask; then recurrentgemma-9b at full width, one pattern
                period (rec, rec, attn; weights from a CUDA generator):
                the slab ServeEngine (4 rows, max_len 4096) on prompts of
                64, 2000, 2100 and 3000 tokens x 32 greedy tokens, every
                step's logits against a teacher-forced forward under the
                reference's bounds, in mxfp8_e4m3 and bf16; the paged
                engine's tokens equal with 0 paged leaves; card against
                CPU logits at 64 positions; 10 Trainer steps at 2 x 4096
                per preset (one flash forward and one flash dgrad a
                step, the RG-LRU scans' share printed) with two 3-step
                replays of equal bits.
The kernel phase also holds the dgrad, wgrad and flash dgrad kernels at
the training shapes (4096 tokens; BH 64, T 512) against their plain
versions, with planted faults that their checks reject (dgrad with W
quantized along K, wgrad with x unquantized; four in the flash dgrad,
among them P and dS as one bf16 piece), dgrad and wgrad also at ragged
sizes (contractions 48, 70 and 1000, raw gradients) and on the proxy's
fp32 path, the flash dgrad also at its edges (FLASH_BWD_EDGES: ragged
T 300, G 2, the window mask with q_offset, the full mask, d 128), each
called twice for equal bits, with the pre-pass's share of the GEMMs'
time; decode at its edges (DECODE_EDGES: a view that is not a multiple
of the split's span, a span with no valid slot, G 4, S 2048, and the
kernel's other paths: V read in place, d 256, unaligned rows), called
twice for equal bits, with the split's planted faults (a split's partial
left out of the combine, p over its own CTA's sum); and the paged decode
kernel at the paged engine's shapes (6 rows, views of 256 and 512)
against the slab decode kernel on the gathered view and its plain
version, with planted page-table faults.  [scale-modes] runs the flash
dgrad's and decode's edges under "bump" and "adaptive" too, and holds the
flash dgrad at d 128 with q and k at std 1 (logits of a few hundred)
against the fp64 grads beside its plain version, and runs the flash
forward at BH 64, T 512 and at the bucket of 512 under both rules (the
operands' adaptive near ties counted), each with the rule's planted
faults (FLASH_MODE_FAULTS) through its near-tie check.  The flash forward
and dgrad also run at MLA's head dims (MLA_FLASH_SHAPES: d 192 / dv 128
at BH 512, T 512, and d 24 / dv 16), both modes, with the softmax scale
taken from dv and v read with the qk dim's stride planted and rejected.
SDPA times are PyTorch's FlashAttention kernel (sdpa_flash), forward and
backward; at dv != d the first fused SDPA backend that takes the shapes
(sdpa_any, its name in the row).

Prints one JSON line of kernel numbers, the card's name and power limit,
and as the last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import cProfile
import dataclasses
import io
import json
import math
import pstats
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12      # dense bf16 tensor-core peak
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(2)


def ulp_bf16(x):
    """bf16 unit in the last place of |x| (elementwise, x a float tensor)."""
    import torch
    e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


# A profiler window loses records at its start: late in this script's
# long run a window of flush + fn pairs has missed its first flush, and a
# window of one pack step its first 20-28 kernels.  So every counting or
# timing window opens with PROFILE_WARM spin kernels (torch.cuda._sleep's
# ``spin_kernel``, never counted) and PROFILE_MARGIN_S idle seconds before
# what it measures (``_open_window``).
PROFILE_WARM = 32
PROFILE_MARGIN_S = 0.02
SPIN = "spin_kernel"


def _open_window():
    import torch
    for _ in range(PROFILE_WARM):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    time.sleep(PROFILE_MARGIN_S)


def _device_rows(prof):
    """The kernels a profiler window saw (key_averages rows), but for the
    spin kernels that opened it."""
    import torch
    return [row for row in prof.key_averages()
            if row.device_type == torch.autograd.DeviceType.CUDA
            and SPIN not in row.key]


def _kernel_us(prof, skip=frozenset()) -> float:
    """Summed device time (µs) of the kernels a profiler window saw, but
    for those named in ``skip`` and the spin kernels."""
    return sum(getattr(row, "device_time_total",
                       getattr(row, "cuda_time_total", 0.0))
               for row in _device_rows(prof) if row.key not in skip)


def time_ms(fn, iters: int, flush) -> float:
    """Device time (ms) of one ``fn`` call, L2 flushed before each (see
    ``time_parts_ms``)."""
    return time_parts_ms(fn, iters, flush)[0]


_FLUSH_KEYS: frozenset = frozenset()   # the flush's kernels, seen once
EVENT_TIMED = [0]   # calls timed with CUDA events (time_parts_ms)


def _window_counts_ok(prof, iters: int) -> bool:
    """Whether a profiler window of ``iters`` flush + fn pairs saw every
    launch: each of the flush's kernels exactly ``iters`` times, and each
    kernel of fn a whole multiple of ``iters`` times (at least once)."""
    counts = {row.key: row.count for row in _device_rows(prof)}
    own = [n for key, n in counts.items() if key not in _FLUSH_KEYS]
    return (bool(_FLUSH_KEYS) and bool(own)
            and all(counts.get(key, 0) == iters for key in _FLUSH_KEYS)
            and all(n % iters == 0 for n in own))


def time_parts_ms(fn, iters: int, flush):
    """Device time (ms) of one ``fn`` call, L2 flushed before each, and
    that time by kernel name.

    The profiler sums the device time of the kernels ``fn`` launches in a
    window of flush + ``fn`` pairs, leaving out the kernels a window of
    the flush alone showed (the flush is a uint8 ``bitwise_not_`` over
    64 MiB, which no timed function launches; its kernels are read once
    a run), so neither the flush nor host launch overhead is counted.  The
    flush is taken out by name, not by subtracting a second window's time:
    the flush's time varies by more than a call of a few µs takes.  A
    window that lost records (the flush's kernels not seen exactly
    ``iters`` times, or one of fn's kernels not a whole multiple of
    ``iters`` times) is taken again, up to three times; then the call is
    timed with CUDA events around each ``fn`` (after its flush), the parts
    are empty, and EVENT_TIMED counts it (record() marks the row)."""
    global _FLUSH_KEYS
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn(), fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a window that lost records is taken again
        if not _FLUSH_KEYS:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _open_window()
                flush()
                torch.cuda.synchronize()
            _FLUSH_KEYS = frozenset(row.key for row in _device_rows(prof))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _open_window()
            for _ in range(iters):
                flush()
                fn()
            torch.cuda.synchronize()
        if _window_counts_ok(prof, iters):
            break
    else:
        seen = {row.key[:60]: row.count for row in _device_rows(prof)}
        print(f"[timing] the profiler lost records in three windows (flush "
              f"kernels {sorted(_FLUSH_KEYS)}; the last window of {iters} "
              f"calls saw {seen}): CUDA events", flush=True)
        EVENT_TIMED[0] += 1
        return _event_ms(fn, iters, flush), {}
    parts = {row.key: getattr(row, "device_time_total",
                              getattr(row, "cuda_time_total", 0.0))
             / iters / 1e3
             for row in _device_rows(prof) if row.key not in _FLUSH_KEYS}
    return _kernel_us(prof, _FLUSH_KEYS) / iters / 1e3, parts


def _event_ms(fn, iters: int, flush) -> float:
    """Device time (ms) of one ``fn`` call between CUDA events recorded
    around it, L2 flushed before each (host gaps inside ``fn`` count)."""
    import torch
    pairs = []
    for _ in range(iters):
        flush()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for e0, e1 in pairs) / iters


def sdpa_flash(q, k, v):
    """PyTorch's FlashAttention kernel, causal, on (BH, T, d) q, k, v taken
    as (BH, 1, T, d): held to the flash backend, so that a fallback to
    another backend (the math path takes any 3-D input and forms the whole
    (BH, T, T) score matrix) raises instead of being timed."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        return F.scaled_dot_product_attention(
            q[:, None], k[:, None], v[:, None], is_causal=True)[:, 0]


def bound(bytes_moved: float, flops: float):
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_f = flops / BF16_FLOP_PER_S * 1e3
    return (max(t_b, t_f), "bytes" if t_b >= t_f else "operations")


def decode_bound(valid, H: int, G: int, d: int, dv: int):
    """bound() of a decode over a (B, S) ``valid`` mask with H kv heads:
    the bytes of the K rows of the valid slots only (a masked slot's score
    is dropped whatever its K row holds), the V rows of every slot (v is
    cast along S over every slot), q, out and the mask; the operations of
    the QK and PV products over the valid slots."""
    B, S = valid.shape
    n_valid = int(valid.sum())
    return bound(2 * H * (n_valid * d + B * S * dv + B * G * (d + dv))
                 + B * S, 2 * H * G * n_valid * (d + dv))


def attn_floor(v, n_terms: int) -> float:
    """Absolute floor of the attention check: the fp32 accumulation-order
    bound of a convex combination of ``n_terms`` values of v."""
    return n_terms * 2.0 ** -24 * v.float().abs().max().item()


def attn_check(out, want, floor: float):
    """(ok, worst): every output element within 2 bf16 ulps of its own
    plain value, plus ``floor``; ``worst`` is the largest error over what
    its element allows."""
    err = (out.float() - want.float()).abs()
    worst = (err / (2 * ulp_bf16(want.float()) + floor)).max().item()
    return worst <= 1.0, worst


# Faults a kernel could plant in the MX attention arithmetic.  The plain
# version with each fault must fail attn_check against the true plain
# version, so the check is known to be able to see them.
FLASH_FAULTS = ("p unquantized", "p against a 32-column sub-tile max",
                "v quantized along d")
# The faults held to each scale rule.  Under "bump" and "adaptive" no
# block max clamps, and the cast's grid is the same at every scale but for
# the subnormals, so "v quantized along d" casts v as the plain version
# does (the planted output equals it) and "e + 1 for every block of p"
# moves only elements 2^-14 below their block's max; p cast under the
# floor rule, which clamps such maxima, is held in their place.
FLASH_MODE_FAULTS = {"floor": FLASH_FAULTS,
                     "bump": FLASH_FAULTS[:2] + ("p cast under the floor "
                                                 "rule",)}
FLASH_MODE_FAULTS["adaptive"] = FLASH_MODE_FAULTS["bump"]
DECODE_FAULTS = ("p unquantized", "p quantized before normalizing",
                 "v quantized along d", "v quantized over valid slots only")


# Faults of a flash kernel whose qk head dim differs from its v head dim
# (MLA: 192 against 128), planted in the forward and the dgrad: the
# softmax scale 1/sqrt(dv) in place of 1/sqrt(d), and v's rows read with
# the qk dim's stride.
MLA_FLASH_FAULTS = ("softmax scale from dv", "v read with the qk dim's "
                    "stride")


def v_qk_stride(v, d: int):
    """What a kernel reads as v (BH, Tk, dv) when it steps v's rows by d:
    row t of head b at element t d of the head's block (zeros past the
    end)."""
    import torch
    BH, Tk, dv = v.shape
    flat = torch.nn.functional.pad(v.reshape(BH, Tk * dv),
                                   (0, Tk * max(d - dv, 0)))
    return flat.as_strided((BH, Tk, dv), (flat.shape[1], d, 1)).contiguous()


def planted_flash(q, k, v, fmt, fault, scale_mode="floor", spec=None):
    """The plain flash forward under ``spec`` (default causal, Tq = Tk)
    over its kv tiles (every serve bucket fits in one: kv_chunk 1024),
    folded as the reference folds them, under ``scale_mode`` with one
    planted ``fault`` (None: none; FLASH_FAULTS or MLA_FLASH_FAULTS)."""
    import torch
    from repro_torch.core import AttnSpec, quantize_mx
    from repro_torch.kernels import ref

    def Q(x, axis):
        return quantize_mx(x, fmt, axis=axis, scale_mode=scale_mode)
    spec = spec or AttnSpec()
    Tq, Tk = q.shape[2], k.shape[1]
    tile_k = ref.attn_tiles(spec, Tq, Tk)[1]
    scale = 1.0 / math.sqrt(v.shape[-1] if fault == MLA_FLASH_FAULTS[0]
                            else q.shape[-1])
    if fault == MLA_FLASH_FAULTS[1]:
        v = v_qk_stride(v, q.shape[-1])
    qq, kq = Q(q.float(), -1), Q(k.float(), -1)
    valid_all = attn_valid(spec, Tq, Tk, q.device)
    m = torch.full(q.shape[:3], ref.NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape[:3] + (v.shape[-1],), device=q.device)
    for ts in range(0, Tk, tile_k):
        te = min(ts + tile_k, Tk)
        valid = valid_all[:, ts:te]
        s = torch.where(valid, torch.einsum("bgqd,bkd->bgqk", qq,
                                            kq[:, ts:te]) * scale,
                        ref.NEG_INF)
        mn = torch.maximum(m, s.amax(-1))
        p = torch.where(valid, torch.exp(s - mn[..., None]), 0.0)
        pq = Q(p, -1)
        if fault == "p unquantized":
            pq = p
        elif fault == "p cast under the floor rule":
            pq = quantize_mx(p, fmt, axis=-1)
        elif fault == "p against a 32-column sub-tile max":
            ms = s.unflatten(-1, (-1, 32)).amax(-1, keepdim=True)
            ms = ms.expand(*ms.shape[:-1], 32).flatten(-2)
            pq = Q(torch.where(valid, torch.exp(s - ms), 0.0),
                   -1) * torch.exp(ms - mn[..., None])
        vq = Q(v[:, ts:te].float(), -1 if fault == "v quantized along d"
               else -2)
        corr = torch.exp(m - mn)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bgqk,bkd->bgqd", pq, vq)
        m = mn
    return (acc / l.clamp(min=1e-30)[..., None]).to(q.dtype)


def planted_decode(q, kc, vc, valid, fmt, fault):
    """The plain decode against a (B, S, H, d) cache with one planted
    ``fault`` (None: none)."""
    import torch
    from repro_torch.core import quantize_mx
    from repro_torch.kernels.ref import NEG_INF, fold_cache

    def Q(x, axis):
        return quantize_mx(x, fmt, axis=axis)
    kf, vf = fold_cache(kc).float(), fold_cache(vc).float()
    ok = torch.repeat_interleave(valid, kc.shape[2], dim=0)[:, None, :]
    if fault == "v quantized over valid slots only":
        vf = torch.where(ok[:, 0, :, None], vf, 0.0)
    s = torch.einsum("bgd,bsd->bgs", Q(q.float(), -1), Q(kf, -1))
    s = torch.where(ok, s * (1.0 / math.sqrt(q.shape[-1])), NEG_INF)
    p = torch.where(ok, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True).clamp(min=1e-30)
    pq = Q(p / l, -1)
    if fault == "p unquantized":
        pq = p / l
    elif fault == "p quantized before normalizing":
        pq = Q(p, -1) / l
    vq = Q(vf, -1 if fault == "v quantized along d" else -2)
    return torch.einsum("bgs,bsd->bgd", pq, vq).to(q.dtype)


# Faults of the decode kernels' split over a cluster (ops.decode_plan),
# planted in split_decode.
SPLIT_FAULTS = ("one split's partial left out of the combine",
                "p divided by the CTA's own sum")


def split_decode(q, kc, vc, valid, fmt, fault=None, scale_mode="floor"):
    """The decode kernels' split in plain PyTorch, against a (B, S, H, d)
    cache, with one planted ``fault`` (None: none): the view cut into the
    plan's spans (the last padded with invalid zero slots), each split's
    max and sum, the cluster's max and its sum in rank order, p over that
    sum cast along S per 32-block inside each span, v cast along S over
    every slot, each split's partial PV, and the partials summed in rank
    order."""
    import torch
    from repro_torch.core import quantize_mx
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import NEG_INF, fold_cache

    def Q(x, axis):
        return quantize_mx(x, fmt, axis=axis, scale_mode=scale_mode)
    S = kc.shape[1]
    splits, span = ops.decode_plan(S)
    pad = splits * span - S
    kf, vf = fold_cache(kc).float(), fold_cache(vc).float()
    ok = torch.repeat_interleave(valid, kc.shape[2], dim=0)
    s = torch.einsum("bgd,bsd->bgs", Q(q.float(), -1), Q(kf, -1))
    s = torch.where(ok[:, None], s * (1.0 / math.sqrt(q.shape[-1])), NEG_INF)
    s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
    ok = torch.nn.functional.pad(ok, (0, pad))[:, None].unflatten(
        -1, (splits, span))
    s = s.unflatten(-1, (splits, span))                    # (BH, G, r, span)
    m = s.amax(-1).amax(-1, keepdim=True)[..., None]
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l_r = p.sum(-1)
    total = torch.zeros_like(l_r[..., 0])
    for r in range(splits):
        total = total + l_r[..., r]
    if fault == "p divided by the CTA's own sum":
        pr = p / l_r.clamp(min=1e-30)[..., None]
    else:
        pr = p / total.clamp(min=1e-30)[..., None, None]
    prq = Q(pr, -1)
    vq = Q(torch.nn.functional.pad(vf, (0, 0, 0, pad)), -2)
    part = torch.einsum("bgrs,brsd->bgrd", prq, vq.unflatten(1, (splits,
                                                                  span)))
    o = torch.zeros_like(part[:, :, 0])
    for r in range(splits):
        if fault == "one split's partial left out of the combine" and r == 1:
            continue
        o = o + part[:, :, r]
    return o.to(q.dtype)


# Edges of the decode kernels beside the serve shape: (label, B, H, G, S,
# a hole, d, dv): S 300 ends inside the plan's last span; the hole makes
# the span [64, 128) invalid in every row; the last three take the
# kernel's other paths: V rows read in place (their span does not fit a
# CTA's shared memory), a head dim above 128 (a lane walks 256-wide
# segments), rows that are not 16-byte aligned (element loads).
DECODE_EDGES = (("view not a multiple of the span", 4, 8, 1, 300, False,
                 64, 64),
                ("a span with no valid slot", 4, 8, 1, 512, True, 64, 64),
                ("G 4", 4, 2, 4, 512, False, 64, 64),
                ("long view", 4, 8, 1, 2048, False, 64, 64),
                ("long view, V in place", 1, 2, 1, 9000, False, 64, 128),
                ("head dim 256", 2, 2, 2, 300, False, 256, 64),
                ("head dims 100", 2, 2, 1, 300, False, 100, 100))


def decode_valid(B, S, hole, device):
    """(B, S) validity of rows valid up to positions spread over the view
    (the first at a fifth of it); ``hole`` makes slots [64, 128) invalid
    in every row."""
    import torch
    pos = torch.tensor([S // 5, S // 2, 3 * S // 4, S - 1][:B],
                       device=device)
    valid = torch.arange(S, device=device)[None] <= pos[:, None]
    if hole:
        valid[:, 64:128] = False
    return valid


def decode_case(q, kc, vc, valid, fmt, mode="floor"):
    """The decode kernel against its plain version (attn_check) and against
    itself on a second call.  Returns (ok, worst, max_abs_err, replay,
    the plain output)."""
    import torch
    from repro_torch.kernels import ops, ref
    o = ops.mx_attention_decode(q, kc, vc, valid, fmt, scale_mode=mode)
    replay = torch.equal(o, ops.mx_attention_decode(q, kc, vc, valid, fmt,
                                                    scale_mode=mode))
    orf = ref.mx_attention_decode_ref(q, kc, vc, valid, fmt,
                                      scale_mode=mode)
    ok, worst = attn_check(o, orf, attn_floor(vc, kc.shape[1]))
    return (ok and replay, worst, (o.float() - orf.float()).abs().max().item(),
            replay, orf)


def check_controls(what, check, planted, faults):
    """The fault-free planted version must pass ``check`` (got -> (ok,
    worst err/tol, ...)) and every planted fault must fail it."""
    ok, worst = check(planted(None))[:2]
    if not ok:
        raise AssertionError(f"{what}: fault-free control fails the check "
                             f"(worst err/tol {worst})")
    for fault in faults:
        accepted, worst = check(planted(fault))[:2]
        print(f"[controls] {what}: {fault!r} worst err/tol {worst:.2f} "
              f"({'ACCEPTED' if accepted else 'rejected'})", flush=True)
        if accepted:
            raise AssertionError(f"{what}: the check accepts the planted "
                                 f"fault {fault!r}")


def phase_build():
    from repro_torch.kernels import build
    out = build.build()
    print(f"[build] {out} in {build.last_build_seconds():.2f} s", flush=True)
    for name in build.SOURCES:   # ptxas -v: registers and spills a kernel
        fn, spill = "?", ""
        for line in (out / f"{name}.log").read_text().splitlines():
            if "Function properties for" in line:
                fn = line.split("for", 1)[1].strip()
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line:
                print(f"[build] {name}: {fn}: {line.split(':', 1)[1].strip()}"
                      f"; {spill}")


def phase_kernels():
    """Each kernel against its plain version at the serve path's shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import E4M3, AttnSpec
    from repro_torch.kernels import ops, ref

    dev = "cuda"
    g = torch.Generator().manual_seed(SEED)
    flush_buf = torch.zeros(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    flush = flush_buf.bitwise_not_

    def rnd(*shape, dtype=torch.bfloat16, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(dtype).to(dev)

    rows = {}
    events_seen = [EVENT_TIMED[0]]

    def record(name, case, primary, err, ok, ms, plain_ms, library_ms,
               bnd, **extra):
        # "events": one of the row's times came from CUDA events, since the
        # last row (time_parts_ms)
        timing = "events" if EVENT_TIMED[0] > events_seen[0] else "profiler"
        events_seen[0] = EVENT_TIMED[0]
        entry = {"case": case, "max_abs_err": err, "ms": ms,
                 "plain_ms": plain_ms, "library_ms": library_ms,
                 "bound_ms": bnd[0], "bound_by": bnd[1], "timing": timing,
                 **extra}
        print(f"[kernels] {'ok  ' if ok else 'FAIL'} {name} {json.dumps(entry)}",
              flush=True)
        if not ok:
            raise AssertionError(f"{name} {case} disagrees with its plain "
                                 f"version (max_abs_err {err})")
        rows.setdefault(name, {"cases": []})["cases"].append(entry)
        if primary:
            rows[name].update(entry)

    # 1. quantize: apply_norm's fp32 activations and the affine scale.
    quantize_rows(rnd, record, flush)

    # 2. forward GEMM on both paths (ops.fwd_gemm_plan): the small-M kernel
    # at decode (M = max_batch 4; the paged engine's 6 rows), the
    # quantize-once wgmma path at the chunked prefill's 64 rows and the
    # prefill bucket's 512 (the training shapes are in training_kernels),
    # and both paths timed at the rows where the plan switches.
    gemm_cases = (("decode lm_head 4x512x32000 e4m3/e4m3", 4, 512, 32000, E4M3, E4M3, True),
                  ("decode w_down 4x2048x512 e4m3/e4m3", 4, 2048, 512, E4M3, E4M3, False),
                  ("decode wq 4x512x512 e4m3/e4m3", 4, 512, 512, E4M3, E4M3, False),
                  ("decode w_up 4x512x2048 e4m3/e4m3", 4, 512, 2048, E4M3, E4M3, False),
                  ("paged decode lm_head 6x512x32000 e4m3/e4m3", 6, 512, 32000, E4M3, E4M3, False),
                  ("chunk lm_head 64x512x32000 e4m3/e4m3", 64, 512, 32000, E4M3, E4M3, False),
                  ("prefill w_up 512x512x2048 e4m3/e4m3", 512, 512, 2048, E4M3, E4M3, False),
                  ("decode lm_head 4x512x32000 bf16/e4m3", 4, 512, 32000, None, E4M3, False),
                  ("prefill w_up 512x512x2048 bf16/e4m3", 512, 512, 2048, None, E4M3, False))
    for case, M, K, N, fa, fb, primary in gemm_cases:
        fwd_gemm_case(record, flush, case, rnd(M, K),
                      rnd(K, N, std=1.0 / math.sqrt(K)), fa, fb, primary)
    fwd_paths(rnd, flush)

    # 3. flash forward: olmo-paper prefill, BH = 8 heads, G = 1, d = 64.
    for T, fmt, primary in ((512, E4M3, True), (64, E4M3, False),
                            (512, None, False), (64, None, False)):
        q, k, v = rnd(8, 1, T, 64), rnd(8, T, 64), rnd(8, T, 64)
        spec = AttnSpec()
        o, lse = ops.mx_flash_attention(q, k, v, fmt, spec)
        orf, lser = ref.mx_flash_attention_ref(q, k, v, fmt, spec)
        floor = attn_floor(v, T)
        ok, worst = attn_check(o, orf, floor)
        lse_err = (lse - lser).abs().max().item()
        ok = ok and lse_err <= 1e-4
        if fmt is not None:
            check_controls(f"flash bucket {T}",
                           lambda got: attn_check(got, orf, floor),
                           lambda fault: planted_flash(q, k, v, fmt, fault),
                           FLASH_FAULTS)
        lib = None
        if fmt is None:   # bf16 mode: the same function exists in PyTorch
            lib = time_ms(lambda: sdpa_flash(q[:, 0], k, v), 50, flush)
        n_scores = 8 * T * (T + 1) // 2
        record("mx_flash_attention",
               f"prefill bucket {T} BH8 G1 d64 {'e4m3' if fmt else 'bf16'} "
               f"(worst err/tol {worst:.3f}, lse err {lse_err:.2e})",
               primary, (o.float() - orf.float()).abs().max().item(), ok,
               time_ms(lambda: ops.mx_flash_attention(q, k, v, fmt, spec), 20, flush),
               time_ms(lambda: ref.mx_flash_attention_ref(q, k, v, fmt, spec), 5, flush),
               lib, bound(2 * 4 * 8 * T * 64 + 4 * 8 * T, 4 * 64 * n_scores))

    flash_fwd_kernels(rnd, record, flush)

    # 4. decode: max_batch 4 x 8 kv heads against a 512-slot cache; the
    # invalid slots hold random K/V, as stale rows and prefill pads do.
    # Row 0 (pos 100) leaves six of the plan's eight spans without a valid
    # slot.
    B, H, S = 4, 8, 512
    for fmt, primary in ((E4M3, True), (None, False)):
        q = rnd(B * H, 1, 64)
        kc, vc = rnd(B, S, H, 64), rnd(B, S, H, 64)
        pos = torch.tensor([100, 257, 400, 511], device=dev)
        valid = torch.arange(S, device=dev)[None] <= pos[:, None]
        ok, worst, err, replay, orf = decode_case(q, kc, vc, valid, fmt)
        floor = attn_floor(vc, S)
        if fmt is not None:
            check_controls("decode", lambda got: attn_check(got, orf, floor),
                           lambda fault: planted_decode(q, kc, vc, valid,
                                                        fmt, fault),
                           DECODE_FAULTS)
            check_controls("decode split", lambda got: attn_check(got, orf,
                                                                  floor),
                           lambda fault: split_decode(q, kc, vc, valid, fmt,
                                                      fault),
                           SPLIT_FAULTS)
        lib = None
        if fmt is None:
            qs = q.view(B, H, 1, 64)
            ks, vs = kc.transpose(1, 2), vc.transpose(1, 2)
            mask = valid[:, None, None, :]
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask), 50, flush)
        record("mx_attention_decode",
               f"decode B4 H8 S512 d64 {'e4m3' if fmt else 'bf16'} "
               f"(plan {ops.decode_plan(S)}; worst err/tol {worst:.3f}, "
               f"replay equal {replay})", primary, err, ok,
               time_ms(lambda: ops.mx_attention_decode(q, kc, vc, valid, fmt), 50, flush),
               time_ms(lambda: ref.mx_attention_decode_ref(q, kc, vc, valid, fmt), 10, flush),
               lib, decode_bound(valid, H, 1, 64, 64))
    # The decode kernel's edges: a view that is not a multiple of the span,
    # a span invalid in every row, G 4, and a long view (S 2048); each
    # checked and replayed, the split's planted faults at S 300.
    for label, B, H, G, S, hole, d, dv in DECODE_EDGES:
        q, kc, vc = rnd(B * H, G, d), rnd(B, S, H, d), rnd(B, S, H, dv)
        valid = decode_valid(B, S, hole, dev)
        ok, worst, err, replay, orf = decode_case(q, kc, vc, valid, E4M3)
        if S % ops.decode_plan(S)[1]:
            floor = attn_floor(vc, S)
            check_controls(f"decode split {label}",
                           lambda got: attn_check(got, orf, floor),
                           lambda fault: split_decode(q, kc, vc, valid, E4M3,
                                                      fault),
                           SPLIT_FAULTS)
        record("mx_attention_decode",
               f"decode edge {label}: B{B} H{H} G{G} S{S} d{d} dv{dv} e4m3 "
               f"(plan {ops.decode_plan(S)}; worst err/tol {worst:.3f}, "
               f"replay equal {replay})", False, err, ok,
               time_ms(lambda: ops.mx_attention_decode(q, kc, vc, valid, E4M3), 20, flush),
               None, None, decode_bound(valid, H, G, d, dv))
    paged_kernels(record, flush)
    training_kernels(rnd, record, flush)
    mla_flash_kernels(rnd, record, flush)
    return rows


# Rows of the quantize kernel: (case, shape, dtype, a view at a 4-byte
# offset, primary).  The training step's xn (8 x 512 tokens, fp32) first;
# its bf16 twin; the serve path's shapes; K 48 (a partial last block on the
# streaming path) and K 70 (not a multiple of 8) and the misaligned view,
# which take the one-element-a-lane path.
QUANTIZE_ROWS = (("train xn (4096,512) fp32", (4096, 512), "float32", False,
                  True),
                 ("train xn (4096,512) bf16", (4096, 512), "bfloat16", False,
                  False),
                 ("prefill xn (1,512,512) fp32", (1, 512, 512), "float32",
                  False, False),
                 ("decode xn (4,1,512) fp32", (4, 1, 512), "float32", False,
                  False),
                 ("ln scale (512,) fp32", (512,), "float32", False, False),
                 ("ragged K 48 (100,48) fp32", (100, 48), "float32", False,
                  False),
                 ("ragged K 70 (100,70) fp32", (100, 70), "float32", False,
                  False),
                 ("misaligned view (4096,512) fp32", (4096, 512), "float32",
                  True, False))


def quantize_rows(rnd, record, flush):
    """The quantize kernel at QUANTIZE_ROWS: bitwise to its plain version
    on normal values, and under each scale rule on blocks that make the
    rules matter (mode_input; adaptive: near ties only, counted); timed
    against its bytes bound on the normal values."""
    import torch
    from repro_torch.core import E4M3
    from repro_torch.kernels import ops, ref

    g = torch.Generator().manual_seed(SEED + 18)
    for case, shape, dtype, offset, primary in QUANTIZE_ROWS:
        dt = getattr(torch, dtype)

        def place(x):
            if not offset:
                return x.cuda()
            buf = torch.empty(x.numel() + 1, dtype=dt, device="cuda")
            view = buf[1:].view(x.shape)   # data_ptr 4 or 2 bytes off
            view.copy_(x)
            return view
        x = place(rnd(*shape, dtype=dt).cpu())
        y = ops.mx_quantize(x, E4M3)
        yr = ref.mx_quantize_ref(x, E4M3)
        ok = torch.equal(y, yr)
        ties = {}
        for mode in ("floor", "bump", "adaptive"):
            xm = place(mode_input(shape, -1, E4M3, g, dtype=dt))
            ok_m, n_off, _ = scale_choice_check(
                xm, ops.mx_quantize(xm, E4M3, scale_mode=mode), E4M3, -1,
                mode)
            ok, ties[mode] = ok and ok_m, n_off
        extra = {}
        if primary:   # what a plain copy of the same bytes takes on the card
            yc = torch.empty_like(x)
            extra["copy_ms"] = time_ms(lambda: yc.copy_(x), 50, flush)
        record("mx_quantize", f"{case} (under floor/bump/adaptive: "
               f"{ties['adaptive']} adaptive near ties)", primary,
               (y.float() - yr.float()).abs().max().item(), ok,
               time_ms(lambda: ops.mx_quantize(x, E4M3), 50, flush),
               time_ms(lambda: ref.mx_quantize_ref(x, E4M3), 10, flush)
               if primary else None,
               None, bound(2 * x.element_size() * x.numel(), 0),
               streaming=offset is False and shape[-1] % 8 == 0, **extra)



# ---------------------------------------------------------------------------
# The flash forward on the tensor cores (csrc/mx_attention.cu).
# ---------------------------------------------------------------------------
# Edges of the flash forward beside its main shapes: (label, BH, G, Tq, Tk,
# d, AttnSpec arguments).  T 300 is ragged against the kernel's 64-row
# CTAs and blocks; d 128 takes its 32-row blocks; the chunked prefill is
# the paged engine's last chunk of a 512-token prompt; Tk 1300 runs two
# JAX tiles (kv_chunk 1024), so the carry folds a second tile; head dims
# of 100 take the element loads and the warp cast (not multiples of 8).
FLASH_FWD_EDGES = (
    ("ragged T 300", 16, 1, 300, 300, 64, {}),
    ("G 2", 16, 2, 512, 512, 64, {}),
    ("window 128 with q_offset 64", 16, 2, 256, 320, 64,
     dict(kind="window", window=128, q_offset=64)),
    ("full mask Tq 300 Tk 200", 16, 1, 300, 200, 64, dict(kind="full")),
    ("d 128", 16, 1, 256, 256, 128, {}),
    ("chunked prefill Tq 64 q_offset 448", 8, 1, 64, 512, 64,
     dict(q_offset=448)),
    ("two JAX tiles causal Tk 1300", 4, 1, 1300, 1300, 64, {}),
    ("two JAX tiles full Tk 1300", 4, 1, 1300, 1300, 64, dict(kind="full")),
    ("head dims 100", 4, 1, 200, 200, 100, {}))
# The bf16-mode forward's fp32 out against fp64 dense attention, per
# element: FLASH_FWD_EPS times that element's bound, sum_k p_k |v_k| / l
# (exact p).  A bf16 out hides a one-piece p inside its 2 ulps; the fp32
# out does not: p as one bf16 piece is off by up to 2^-9 a term.
FLASH_FWD_EPS = 256 * 2.0 ** -24
FLASH_FWD_FAULT = "p as one bf16 piece"


def butterfly_sum(s):
    """Sums over the last axis (32) in mx_warp_sum's butterfly order, the
    order of every holder of an MX block in the kernels."""
    o = s.shape[-1] // 2
    while o:
        s = s[..., :o] + s[..., o:2 * o]
        o //= 2
    return s[..., 0]


def butterfly_quantize(x, fmt, axis=-1, scale_mode="floor"):
    """quantize_mx along ``axis`` with the adaptive rule's block errors
    summed in the butterfly order (the kernels' cast, mx_quant.cuh);
    "floor" and "bump" sum nothing and are quantize_mx itself."""
    import torch
    from repro_torch.core import quantize_mx
    from repro_torch.core.formats import exp2_int, floor_log2, quantize_elem
    from repro_torch.core.mx import block_reshape, block_unreshape
    if fmt is None or scale_mode != "adaptive":
        return quantize_mx(x, fmt, axis=axis, scale_mode=scale_mode)
    xf = x.float()
    xb, n = block_reshape(xf, axis, 32)
    m = xb.abs().amax(-1)
    e = floor_log2(torch.where(m > 0, m, torch.ones_like(m))) - fmt.e_max
    err = [butterfly_sum(torch.square(
        quantize_elem(xb / exp2_int(c)[..., None], fmt)
        * exp2_int(c)[..., None] - xb)) for c in (e, e + 1)]
    e = torch.clamp(torch.where(err[1] < err[0], e + 1, e), -126, 127)
    e = torch.where(m > 0, e, torch.full_like(e, -126))[..., None]
    y = block_unreshape(quantize_elem(xb / exp2_int(e), fmt) * exp2_int(e),
                        axis, n)
    return (xf + (y - xf)).to(x.dtype)


def flash_fwd_split(q, k, v, fmt, spec, scale_mode="floor", pieces=3):
    """The tensor-core flash forward's arithmetic in plain PyTorch ->
    (out fp32, lse): the pre-pass casts q and k along d and v along kv in
    32-row blocks aligned to each JAX tile's start (rows past the tile's
    end zeros); per JAX tile, S from those exact bf16 operands (each score
    rounded once to fp32, for the tensor cores' fp32 accumulators), pass
    1's row max over the tile, then p = exp(s scale - m_new) (0 where
    masked), l from the unquantized p, p cast per 32 columns in the
    butterfly order (mx_mma_quant) in MX mode, or in bf16 mode taken as
    ``pieces`` bf16 pieces (3: the kernel's split; 1: one bf16 rounding),
    PV, and the fold acc corr + pv, l corr + lt."""
    import torch
    from repro_torch.kernels import ref
    f64 = torch.float64

    def Q(x, axis):
        return butterfly_quantize(x.float(), fmt, axis, scale_mode)
    BH, G, Tq, d = q.shape
    Tk = k.shape[1]
    tile_k = ref.attn_tiles(spec, Tq, Tk)[1]
    scale = 1.0 / math.sqrt(d)
    qh, kh = Q(q, -1), Q(k, -1)
    valid_all = attn_valid(spec, Tq, Tk, q.device)
    m = torch.full((BH, G, Tq), ref.NEG_INF, device=q.device)
    l = torch.zeros((BH, G, Tq), device=q.device)
    acc = torch.zeros((BH, G, Tq, v.shape[-1]), device=q.device)
    for ts in range(0, Tk, tile_k):
        te = min(ts + tile_k, Tk)
        pad = (-(te - ts)) % 32
        vt = torch.nn.functional.pad(v[:, ts:te].float(), (0, 0, 0, pad))
        vh = Q(vt, -2)[:, :te - ts]
        s = torch.einsum("bgqd,bkd->bgqk", qh.to(f64),
                         kh[:, ts:te].to(f64)).float() * scale
        valid = valid_all[:, ts:te]
        s = torch.where(valid, s, ref.NEG_INF)
        mn = torch.maximum(m, s.amax(-1))
        p = torch.where(valid, torch.exp(s - mn[..., None]), 0.0)
        corr = torch.exp(m - mn)
        lt = p.sum(-1)
        if fmt is not None:
            pp = torch.nn.functional.pad(p, (0, pad))
            pq = Q(pp, -1)[..., :te - ts]
        else:
            pq, r = torch.zeros_like(p, dtype=f64), p
            for _ in range(pieces):
                piece = r.to(torch.bfloat16).float()
                pq, r = pq + piece.to(f64), r - piece
        pv = torch.einsum("bgqk,bkd->bgqd", pq.to(f64), vh.to(f64)).float()
        l = l * corr + lt
        acc = acc * corr[..., None] + pv
        m = mn
    lc = torch.clamp(l, min=1e-30)
    return acc / lc[..., None], m + torch.log(lc)


def flash_fwd_dense(q, k, v, spec):
    """bf16-mode attention in fp64 -> (out, bound): out = p v / l with
    the exact softmax, bound = p |v| / l, the sum of its terms'
    magnitudes (FLASH_FWD_EPS)."""
    import torch
    f64 = torch.float64
    s = torch.einsum("bgqd,bkd->bgqk", q.to(f64), k.to(f64)) / math.sqrt(
        q.shape[-1])
    valid = attn_valid(spec, q.shape[2], k.shape[1], q.device)
    s = torch.where(valid, s, -1e300)
    p = torch.where(valid, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True).clamp(min=1e-300)
    return (torch.einsum("bgqk,bkd->bgqd", p, v.to(f64)) / l,
            torch.einsum("bgqk,bkd->bgqd", p, v.to(f64).abs()) / l)


def flash_fwd_worst(got, exact, bnd):
    """The largest error of an fp32 out against the fp64 one over what its
    element allows (FLASH_FWD_EPS of its bound)."""
    return ((got.double() - exact).abs()
            / (FLASH_FWD_EPS * bnd + 1e-300)).max().item()


def flash_fwd_fp64_case(q, k, v, spec):
    """The bf16-mode flash forward's fp32 out and its plain version's, each
    held against fp64 dense attention (flash_fwd_worst): the kernel must
    stay within max(1, twice the plain version's reading), call twice for
    equal bits, and "p as one bf16 piece" (flash_fwd_split with one piece)
    must exceed that limit.  Returns (ok, kernel worst, plain worst,
    planted worst, replay)."""
    import torch
    from repro_torch.kernels import ops, ref

    def fn():
        return ops.mx_flash_attention(q, k, v, None, spec,
                                      out_dtype=torch.float32)[0]
    got = fn()
    replay = torch.equal(got, fn())
    plain = ref.mx_flash_attention_ref(q, k, v, None, spec,
                                       out_dtype=torch.float32)[0]
    planted = flash_fwd_split(q, k, v, None, spec, pieces=1)[0]
    exact, bnd = flash_fwd_dense(q, k, v, spec)
    kw, pw, fw = (flash_fwd_worst(x, exact, bnd) for x in (got, plain,
                                                           planted))
    limit = max(1.0, 2.0 * pw)
    return kw <= limit < fw and replay, kw, pw, fw, replay


# Near ties of the flash forward's p cast.  The kernel forms each score on
# the tensor cores (bf16 products exact, fp32 sums that may truncate), the
# plain version in its own fp32 GEMM: each score is within sqrt(d) 2^-24 of
# the magnitudes of its terms, sum_i |q_i k_i| (gemm_check's measure), the
# kernel's within twice that for its truncating sums.  Both then round
# s scale and s scale - m once and take exp within 2 ulps, and m is a
# score of the row, within the error of the row's largest term sum.  So
# each p moves, relative, by at most its reach (p_reach).  Where an
# element of p sits that close to a rounding midpoint of its cast, or a
# 32-block that close to another shared exponent or adaptive choice, the
# kernel can cast it one quantum away, and the output moves by that
# quantum of p times |v|.  The plain version's own p is measured against
# p from fp64 scores of the same operands and must lie within its share.
SCORE_EPS = 2.0 ** -24


def p_reach(qq, kq, s, m, valid, scale, tmax):
    """Relative reach of each p = exp(s - m) of one JAX tile (s: the plain
    version's scaled scores, m: the running max, tmax: each row's largest
    scaled term sum so far) -> (reach of the kernel's p against the plain
    version's, the plain version's share of it, tmax updated)."""
    import torch
    t = torch.where(valid, torch.einsum("bgqd,bkd->bgqk", qq.abs(),
                                        kq.abs()) * scale, 0.0)
    tmax = torch.maximum(tmax, t.amax(-1))
    sv = torch.where(valid, s, 0.0)
    rounds = sv.abs() + m.abs()[..., None] + (sv - m[..., None]).abs() + 2
    terms = math.sqrt(qq.shape[-1]) * (t + tmax[..., None])
    return (SCORE_EPS * (3 * terms + 2 * rounds),
            SCORE_EPS * (terms + rounds), tmax)


def flash_tie_slack(q, k, v, fmt, spec, mode="floor"):
    """(slack, info).  slack (BH, G, Tq, dv) fp32: how far each output of
    the plain flash forward can move when each p (per JAX tile, before the
    cast) moves by its reach r (p_reach): sum_k |Q(p_k (1 +- r_k)) -
    Q(p_k)| |Q(v)_k| / l, folded over the tiles as the plain version folds
    acc; the row max's p = 1 holds still unless another p of its row lies
    within reach of 1.  Under "adaptive" a block whose error difference
    err1 - err0 such moves can change sign (by at most 2 sum_k r_k |Q1(p_k)
    - Q0(p_k)| p_k, Q0 and Q1 the casts at e and e + 1), or the two sums'
    orders can (TIE_EPS), counts the move to its other exponent.  Zero for
    an output whose p holds no near tie.  info: the largest reach, the
    largest measured gap of the plain p to fp64 (where p > 2^-100) and that
    gap over its share of the reach, which must be at most 1 (else this
    raises)."""
    import torch
    from repro_torch.core import quantize_mx
    from repro_torch.core.formats import exp2_int, floor_log2, quantize_elem
    from repro_torch.core.mx import block_reshape, block_unreshape
    from repro_torch.kernels import ref
    BH, G, Tq, d = q.shape
    Tk = k.shape[1]
    tile_k = ref.attn_tiles(spec, Tq, Tk)[1]
    scale = 1.0 / math.sqrt(d)

    def Q(x, axis):
        return quantize_mx(x, fmt, axis=axis, scale_mode=mode)
    qq, kq = Q(q.float(), -1), Q(k.float(), -1)
    valid_all = attn_valid(spec, Tq, Tk, q.device)
    m = torch.full((BH, G, Tq), ref.NEG_INF, device=q.device)
    m64 = m.double()
    tmax = torch.zeros_like(m)
    l = torch.zeros_like(m)
    slack = torch.zeros((BH, G, Tq, v.shape[-1]), device=q.device)
    info = {"reach": 0.0, "gap": 0.0, "gap_over_share": 0.0}
    for ts in range(0, Tk, tile_k):
        te = min(ts + tile_k, Tk)
        valid = valid_all[:, ts:te]
        s = torch.where(valid, torch.einsum("bgqd,bkd->bgqk", qq,
                                            kq[:, ts:te]) * scale,
                        ref.NEG_INF)
        mn = torch.maximum(m, s.amax(-1))
        p = torch.where(valid, torch.exp(s - mn[..., None]), 0.0)
        corr = torch.exp(m - mn)
        r, share, tmax = p_reach(qq, kq[:, ts:te], s, mn, valid, scale, tmax)
        s64 = torch.where(valid, torch.einsum(
            "bgqd,bkd->bgqk", qq.double(), kq[:, ts:te].double()) * scale,
            -1e300)
        m64 = torch.maximum(m64, s64.amax(-1))
        p64 = torch.exp(s64 - m64[..., None])
        gap = torch.where(valid & (p64 > 2.0 ** -100),
                          (p.double() / p64 - 1).abs(), 0.0)
        info["reach"] = max(info["reach"], float(r.amax()))
        info["gap"] = max(info["gap"], float(gap.amax()))
        info["gap_over_share"] = max(info["gap_over_share"],
                                     float((gap / share).amax()))
        del s64, p64, gap, share
        top = p.topk(min(2, p.shape[-1]), dim=-1).values[..., -1]
        still = (p >= 1.0) & ((top < 1 - 2 * r.amax(-1)) | (p.shape[-1] < 2)
                              )[..., None]
        pq = Q(p, -1)
        dev = torch.zeros_like(p)
        for sign in (-1.0, 1.0):
            moved = torch.where(still, p, p * (1 + sign * r))
            dev = torch.maximum(dev, (Q(moved, -1) - pq).abs())
        if mode == "adaptive":
            pb, n = block_reshape(p, -1, 32)
            rb = block_reshape(r, -1, 32)[0]
            mx = pb.amax(-1, keepdim=True)
            e0 = floor_log2(torch.where(mx > 0, mx, torch.ones_like(mx))
                            ) - fmt.e_max
            cast = [quantize_elem(pb / exp2_int(c), fmt) * exp2_int(c)
                    for c in (e0, e0 + 1)]
            err = [torch.square(c - pb).double().sum(-1, keepdim=True)
                   for c in cast]
            other = (cast[1] - cast[0]).abs()
            reach = (2 * (rb * other * pb).double().sum(-1, keepdim=True)
                     + TIE_EPS * (err[0] + err[1]))
            tie = (err[1] - err[0]).abs() <= reach
            dev = torch.maximum(dev, block_unreshape(
                torch.where(tie, other, 0.0), -1, n))
        vt = torch.nn.functional.pad(v[:, ts:te].float(),
                                     (0, 0, 0, (-(te - ts)) % 32))
        vq = Q(vt, -2)[:, :te - ts].abs()
        l = l * corr + p.sum(-1)
        slack = slack * corr[..., None] + torch.einsum("bgqk,bkd->bgqd",
                                                       dev, vq)
        m = mn
    if info["gap_over_share"] > 1.0:
        raise AssertionError(f"the plain flash forward's p lies outside its "
                             f"share of the reach: {info}")
    return slack / torch.clamp(l, min=1e-30)[..., None], info


def attn_check_ties(out, want, floor: float, slack):
    """attn_check with each element's tolerance widened by its near-tie
    slack (flash_tie_slack)."""
    err = (out.float() - want.float()).abs()
    worst = (err / (2 * ulp_bf16(want.float()) + floor + slack)).max().item()
    return worst <= 1.0, worst


def flash_fwd_case(q, k, v, fmt, spec, mode="floor"):
    """The flash forward kernel on one case against its plain version
    (attn_check, in MX mode with the near-tie slack; lse within 1e-4), its
    bf16 out against its fp32 out rounded once, and a second call for
    equal bits.  Returns a dict: ok, worst, err, lse_err, replay, ties
    (rows with a near tie), want, and the check's ``check`` (got -> (ok,
    worst)) and ``reach`` (flash_tie_slack's info; None in bf16 mode)."""
    import torch
    from repro_torch.kernels import ops, ref
    o, lse = ops.mx_flash_attention(q, k, v, fmt, spec, scale_mode=mode)
    o2, lse2 = ops.mx_flash_attention(q, k, v, fmt, spec, scale_mode=mode)
    of = ops.mx_flash_attention(q, k, v, fmt, spec, scale_mode=mode,
                                out_dtype=torch.float32)[0]
    replay = torch.equal(o, o2) and torch.equal(lse, lse2)
    orf, lser = ref.mx_flash_attention_ref(q, k, v, fmt, spec,
                                           scale_mode=mode)
    floor = attn_floor(v, k.shape[1])
    if fmt is None:
        def check(got):
            return attn_check(got, orf, floor)
        n_ties, info = 0, None
    else:
        slack, info = flash_tie_slack(q, k, v, fmt, spec, mode)

        def check(got):
            return attn_check_ties(got, orf, floor, slack)
        n_ties = int((slack > 0).any(-1).sum())
        # how far the slack widens attn_check: the share of outputs it
        # widens, and its largest over the element's own tolerance
        info["widened"] = float((slack > 0).float().mean())
        info["widen_max"] = float((slack / (2 * ulp_bf16(orf.float())
                                            + floor)).max())
    ok, worst = check(o)
    lse_err = (lse - lser).abs().max().item()
    rounded = torch.equal(of.to(o.dtype), o)
    return {"ok": ok and lse_err <= 1e-4 and replay and rounded,
            "worst": worst, "lse_err": lse_err, "replay": replay,
            "err": (o.float() - orf.float()).abs().max().item(),
            "ties": n_ties, "want": orf, "check": check, "reach": info}


def reach_note(info) -> str:
    """flash_tie_slack's info (and flash_fwd_case's), for a log line."""
    return (f"p reach up to {info['reach']:.3g} (plain p against fp64: gap "
            f"{info['gap']:.3g}, at most {info['gap_over_share']:.3f} of "
            f"its share); the slack widens {info['widened']:.4f} of the "
            f"outputs, up to {info['widen_max']:.1f}x their tolerance")


def flash_bound(BH, G, Tq, Tk, d, dv, spec, device):
    """bound() of a flash forward: q, k, v and out in bf16 and lse in fp32
    moved once; 2 (d + dv) operations per valid score."""
    n_valid = int(attn_valid(spec, Tq, Tk, device).sum()) * BH * G
    return bound(2 * (BH * G * Tq * (d + dv) + BH * Tk * (d + dv))
                 + 4 * BH * G * Tq, 2 * (d + dv) * n_valid)


def flash_fwd_kernels(rnd, record, flush):
    """The flash forward at the training shape (BH 64, G 1, T 512, d 64,
    causal) in e4m3 (with the pre-pass's share) and bf16 mode (SDPA
    beside it, and the fp32 out against fp64 attention with one-piece p
    planted), then at FLASH_FWD_EDGES in both modes, each called twice for
    equal bits."""
    import torch
    from repro_torch.core import E4M3, AttnSpec
    from repro_torch.kernels import ops, ref

    BH, T, d = 64, 512, 64
    spec = AttnSpec()
    q, k, v = rnd(BH, 1, T, d), rnd(BH, T, d), rnd(BH, T, d)
    bnd = flash_bound(BH, 1, T, T, d, d, spec, q.device)
    for fmt in (E4M3, None):
        c = flash_fwd_case(q, k, v, fmt, spec)
        if fmt is not None:   # the near-tie slack hides no planted fault
            print(f"[kernels] flash train e4m3: {c['ties']} rows with a "
                  f"near tie, {reach_note(c['reach'])}", flush=True)
            check_controls("flash train", c["check"],
                           lambda fault: planted_flash(q, k, v, fmt, fault),
                           FLASH_FAULTS)
        del c["check"]
        ms, parts = time_parts_ms(
            lambda: ops.mx_flash_attention(q, k, v, fmt, spec), 20, flush)
        pre = sum(t for n, t in parts.items() if "cast" in n)
        lib, extra = None, {"prepass_ms": pre, "prepass_share": pre / ms}
        if fmt is None:
            lib = time_ms(lambda: sdpa_flash(q[:, 0], k, v), 20, flush)
            ok64, kw, pw, fw, rep = flash_fwd_fp64_case(q, k, v, spec)
            print(f"[kernels] {'ok  ' if ok64 else 'FAIL'} flash forward "
                  f"train bf16 fp32 out against fp64: kernel worst err/tol "
                  f"{kw:.3f}, plain version {pw:.3f} (limit max(1, 2x "
                  f"plain)), {FLASH_FWD_FAULT!r} {fw:.2f} "
                  f"({'rejected' if fw > max(1.0, 2 * pw) else 'ACCEPTED'}"
                  f"), replay equal {rep}", flush=True)
            if not ok64:
                raise AssertionError("flash forward bf16 against fp64 "
                                     "disagrees")
            extra.update(fp64_worst=kw, fp64_plain_worst=pw,
                         fp64_planted_worst=fw, sdpa_ratio=ms / lib)
        record("mx_flash_attention",
               f"train BH{BH} G1 T{T} d{d} causal "
               f"{'e4m3' if fmt else 'bf16'} (worst err/tol "
               f"{c['worst']:.3f}, lse err {c['lse_err']:.2e}, replay "
               f"equal {c['replay']})", False, c["err"], c["ok"], ms,
               time_ms(lambda: ref.mx_flash_attention_ref(q, k, v, fmt,
                                                          spec), 3, flush),
               lib, bnd, near_tie_rows=c["ties"], **extra)
    for label, BH, G, Tq, Tk, d, kw in FLASH_FWD_EDGES:
        spec = AttnSpec(**kw)
        q, k, v = rnd(BH, G, Tq, d), rnd(BH, Tk, d), rnd(BH, Tk, d)
        for fmt in (E4M3, None):
            c = flash_fwd_case(q, k, v, fmt, spec)
            record("mx_flash_attention",
                   f"edge {label}: BH{BH} G{G} Tq{Tq} Tk{Tk} d{d} "
                   f"{'e4m3' if fmt else 'bf16'} (worst err/tol "
                   f"{c['worst']:.3f}, lse err {c['lse_err']:.2e}, replay "
                   f"equal {c['replay']})", False, c["err"], c["ok"],
                   time_ms(lambda: ops.mx_flash_attention(q, k, v, fmt,
                                                          spec), 10, flush),
                   None, None, flash_bound(BH, G, Tq, Tk, d, d, spec,
                                           q.device))
        if d > 64:   # bf16 mode's fp32 out against fp64 at d 128 too
            ok64, kw_, pw, fw, rep = flash_fwd_fp64_case(q, k, v, spec)
            print(f"[kernels] {'ok  ' if ok64 else 'FAIL'} flash forward "
                  f"{label} bf16 fp32 out against fp64: kernel worst "
                  f"err/tol {kw_:.3f}, plain version {pw:.3f}, "
                  f"{FLASH_FWD_FAULT!r} {fw:.2f}, replay equal {rep}",
                  flush=True)
            if not ok64:
                raise AssertionError(f"flash forward {label} bf16 against "
                                     "fp64 disagrees")



# ---------------------------------------------------------------------------
# The paged-serving slice: decode through a page table.
# ---------------------------------------------------------------------------
# Faults a paged decode kernel could plant in its page-table lookup.  Each
# is run through the kernel itself, with the faulty table standing for the
# faulty lookup, and must fail the checks below.
PAGED_FAULTS = ("two logical pages swapped", "table read one page off")


def paged_case(P: int, device, ps: int = 32, n_pages: int = 64, H: int = 8,
               d: int = 64, seed: int = SEED):
    """Inputs of the paged decode kernel at the paged engine's row count
    (6 rows x 8 kv heads, d 64, pages of 32): rows at several positions
    map ceil((pos+1)/ps) pages drawn from a permutation of the pool, the
    rest of each row is unmapped (-1), rows 0 and 1 share their first page
    and row 5 is dead (all -1).  Returns (q, k_pool, v_pool, page_table,
    valid, pos)."""
    import numpy as np
    import torch
    B, S = 6, P * ps
    rng = np.random.default_rng(seed + P)
    pos = np.array([40, 130, S - 12, S // 2 + 3, 75, 0])
    perm = iter(rng.permutation(n_pages).tolist())
    pt = np.full((B, P), -1, np.int32)
    for b in range(B - 1):
        for j in range(pos[b] // ps + 1):
            pt[b, j] = next(perm)
    pt[1, 0] = pt[0, 0]
    g = torch.Generator().manual_seed(seed + P)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(torch.bfloat16).to(device)
    q = rnd(B * H, 1, d)
    kp, vp = rnd(n_pages, ps, H, d), rnd(n_pages, ps, H, d)
    ptt = torch.as_tensor(pt, device=device)
    posd = torch.as_tensor(pos, device=device)
    valid = (torch.arange(S, device=device)[None] <= posd[:, None]) & (
        torch.repeat_interleave(ptt >= 0, ps, dim=1))
    return q, kp, vp, ptt, valid, posd


def planted_table(pt, fault):
    """The page table as a kernel with ``fault`` in its lookup would read
    it: the first logical page swapped with each live row's tail page
    (which holds pos, partly written), or every entry read one place
    later along the flattened table."""
    import torch
    if fault == "two logical pages swapped":
        out = pt.clone()
        for b in range(pt.shape[0]):
            tail = int((pt[b] >= 0).sum()) - 1
            if tail > 0:
                out[b, 0], out[b, tail] = pt[b, tail], pt[b, 0]
        return out
    flat = pt.flatten()
    return torch.cat([flat[1:], flat.new_full((1,), -1)]).reshape(pt.shape)


def fwd_gemm_case(record, flush, case, a, b, fa, fb, primary=False):
    """The forward GEMM kernel against its plain version (gemm_check) and
    against itself on a second call, timed beside the plain version and
    the unquantized torch.matmul, with its path and pre-pass share."""
    import torch
    from repro_torch.kernels import ops, ref

    def fn():
        return ops.mx_matmul(a, b, fa, fb)
    got, want = fn(), ref.mx_matmul_ref(a, b, fa, fb)
    M, K = a.shape
    N = b.shape[1]
    ok, worst, err = gemm_check(got, want,
                                ref.mx_quantize_ref(a, fa).float().abs(),
                                ref.mx_quantize_ref(b, fb, axis=0).float()
                                .abs(), K)
    replay = torch.equal(got, fn())
    small, _, splits = ops.fwd_gemm_plan(M, N, K)
    ms, parts = time_parts_ms(fn, 20, flush)
    pre = sum(v for k_, v in parts.items() if "mx_operand" in k_)
    size = a.element_size()
    record("mx_matmul", f"{case} ({'small-M' if small else 'wgmma'} path, "
           f"{splits} splits; worst err/tol {worst:.3f}, replay equal "
           f"{replay})", primary, err, ok and replay, ms,
           time_ms(lambda: ref.mx_matmul_ref(a, b, fa, fb), 3, flush),
           time_ms(lambda: torch.matmul(a, b), 20, flush),
           bound(size * (M * K + K * N + M * N), 2 * M * N * K),
           prepass_ms=pre, prepass_share=pre / ms)


def fwd_paths(rnd, flush):
    """Both forward paths timed at 4, 6 and 8 rows (the small-M kernel's
    limit, ops.FWD_SMALL_M), on the serve path's weights: the numbers
    behind the threshold."""
    from repro_torch.core import E4M3
    from repro_torch.kernels import ops
    keep = ops.FWD_SMALL_M
    for M in (4, 6, 8):
        for K, N in ((512, 32000), (2048, 512), (512, 2048)):
            a, b = rnd(M, K), rnd(K, N, std=1.0 / math.sqrt(K))
            ms = {}
            try:
                for path, limit in (("small-M", keep), ("wgmma", 0)):
                    ops.FWD_SMALL_M = limit
                    ms[path] = time_ms(lambda: ops.mx_matmul(a, b, E4M3,
                                                             E4M3), 20, flush)
            finally:
                ops.FWD_SMALL_M = keep
            print(f"[kernels] forward paths at {M}x{K}x{N} e4m3: "
                  + json.dumps(ms), flush=True)


def paged_kernels(record, flush, dev: str = "cuda"):
    """The paged decode kernel at P 16 (view 512) and P 8 (view 256), in
    E4M3 and bf16 modes: bitwise equal to the slab decode kernel on the
    gathered view and to its plain version, and each planted table fault
    both unequal to the slab kernel and outside the decode tolerance
    (attn_check) of the plain version."""
    import torch
    from repro_torch.core import E4M3
    from repro_torch.kernels import ops, ref

    for P, fmt, primary in ((16, E4M3, True), (8, E4M3, False),
                            (16, None, False), (8, None, False)):
        q, kp, vp, pt, valid, _ = paged_case(P, dev)
        ps, H = kp.shape[1], kp.shape[2]
        S = P * ps
        validr = torch.repeat_interleave(valid, H, dim=0)

        def slab(table):
            return ops.mx_attention_decode(q, ref.gather_pages(kp, table),
                                           ref.gather_pages(vp, table),
                                           validr, fmt)
        o = ops.mx_attention_decode_paged(q, kp, vp, pt, valid, fmt)
        o7 = slab(pt)
        orf = ref.mx_attention_decode_paged_ref(q, kp, vp, pt, valid, fmt)
        floor = attn_floor(vp, S)
        _, worst = attn_check(o, orf, floor)
        same7 = torch.equal(o, o7)
        n_off_plain = int((o != orf).sum())
        for fault in PAGED_FAULTS:
            of = ops.mx_attention_decode_paged(q, kp, vp,
                                               planted_table(pt, fault),
                                               valid, fmt)
            accepted, w_ = attn_check(of, orf, floor)
            accepted = accepted or torch.equal(of, o7)
            print(f"[controls] paged decode P{P}: {fault!r} worst err/tol "
                  f"{w_:.2f} ({'ACCEPTED' if accepted else 'rejected'})",
                  flush=True)
            if accepted:
                raise AssertionError(f"paged decode: the checks accept the "
                                     f"planted fault {fault!r}")
        # Bytes the function must move: the K rows of the distinct pool
        # slots that some row holds valid (a masked slot's score is dropped
        # whatever its K row holds), the V rows of the distinct mapped
        # pages (v is cast along S over every slot), q, out, the table and
        # the mask; operations: the QK and PV products over the valid
        # positions.
        mapped = torch.unique(pt[pt >= 0]).numel()
        n_valid = int(valid.sum())
        slot = (pt.long().repeat_interleave(ps, dim=1) * ps
                + torch.arange(S, device=pt.device) % ps)
        k_slots = torch.unique(slot[valid]).numel()
        d = q.shape[-1]
        record("mx_attention_decode_paged",
               f"paged decode B6 H8 P{P} ps{ps} (view {S}) d64 "
               f"{'e4m3' if fmt else 'bf16'} (worst err/tol {worst:.3f}, "
               f"bitwise to the slab kernel {same7}, {n_off_plain} of "
               f"{o.numel()} elements off the plain version)", primary,
               (o.float() - orf.float()).abs().max().item(),
               same7 and n_off_plain == 0,
               time_ms(lambda: ops.mx_attention_decode_paged(
                   q, kp, vp, pt, valid, fmt), 50, flush),
               time_ms(lambda: ref.mx_attention_decode_paged_ref(
                   q, kp, vp, pt, valid, fmt), 10, flush),
               None, bound(2 * (k_slots + mapped * ps) * H * d
                           + 2 * 2 * q.numel() + 4 * pt.numel()
                           + valid.numel(), 4 * n_valid * H * d))


# ---------------------------------------------------------------------------
# The training slice: dgrad, wgrad and the flash dgrad at the training
# shapes of olmo-paper full, B = 8 x T = 512 (4096 tokens).
# ---------------------------------------------------------------------------
TOKENS = 8 * 512
# (name, K in, N out) of the weights whose dgrad and wgrad are checked.
TRAIN_GEMMS = (("wq", 512, 512), ("w_up", 512, 2048), ("w_down", 2048, 512),
               ("lm_head", 512, 32000))
# Flash dgrad tolerance, per element of the fp32 gradients: FLASH_BWD_EPS
# times that element's bound, the sum of the magnitudes of the terms it
# adds up (|ds| @ |k| for dq, |ds|^T @ |q| for dk, p^T @ |dout| for dv,
# with |ds| bounded by p (|dout| @ |v|^T + |delta|) scale).  Both sides
# sum up to T terms of each product in another order, over p and ds that
# carry their own rounding (the scores' d-term dot, dp, delta and expf,
# 2 ulps); 2^8 ulps of the bound covers that.  On the CPU the tiled plain
# version sits within 9 * 2^-24 of an fp64 dense computation, and each
# planted fault below exceeds the tolerance by 11x or more.
FLASH_BWD_EPS = 256 * 2.0 ** -24
# Faults a flash dgrad could plant.  `out` is bf16 on the path (the forward
# returns q.dtype, as the reference), so rounding it again is the
# identity: the third fault rounds delta itself to bf16, the place where
# taking delta at bf16 precision would show.  The fourth is the tensor-core
# kernel's own: P and dS taken as one bf16 piece in the gradient products
# (the kernel splits each into three, hi + mid + lo).
FLASH_BWD_FAULTS = ("p from unquantized scores",
                    "quantized operands in the gradient products",
                    "delta rounded to bf16",
                    "P and dS as one bf16 piece")


def attn_valid(spec, Tq: int, Tk: int, device):
    """(Tq, Tk) validity of an AttnSpec mask (causal, full, window, with
    q_offset), as ref.attn_tile_mask over one tile."""
    from repro_torch.kernels import ref
    return ref.attn_tile_mask(spec, 0, 0, Tq, Tk, Tk, device)


def flash_bwd_dense(q, k, v, dout, out, lse, fmt, fault=None,
                    scale_mode="floor", spec=None):
    """Untiled flash dgrad in fp64 under ``spec`` (default causal) with one
    planted ``fault`` (None: none; FLASH_BWD_FAULTS or MLA_FLASH_FAULTS),
    any G, Tq and Tk.  Returns ((dq, dk,
    dv), (bound_q, bound_k, bound_v)) in fp64; the bounds are those of
    FLASH_BWD_EPS."""
    import torch
    from repro_torch.core import AttnSpec, quantize_mx
    f64 = torch.float64

    def Q(x, axis):
        return quantize_mx(x.float(), fmt, axis=axis,
                           scale_mode=scale_mode).to(f64)
    Tq, Tk, d = q.shape[2], k.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(v.shape[-1] if fault == MLA_FLASH_FAULTS[0]
                            else d)
    if fault == MLA_FLASH_FAULTS[1]:
        v = v_qk_stride(v, d)
    qq, kk = Q(q, -1), Q(k, -1)
    if fault == "p from unquantized scores":
        qq, kk = q.to(f64), k.to(f64)
    s = torch.einsum("bgqd,bkd->bgqk", qq, kk) * scale
    valid = attn_valid(spec or AttnSpec(), Tq, Tk, q.device)
    p = torch.where(valid, torch.exp(torch.where(valid, s, -1e30)
                                     - lse.to(f64)[..., None]), 0.0)
    do, vv, kr, qr = dout.to(f64), v.to(f64), k.to(f64), q.to(f64)
    delta = torch.sum(do * out.to(f64), dim=-1)
    if fault == "delta rounded to bf16":
        delta = delta.to(torch.bfloat16).to(f64)
    pd = p
    if fault == "quantized operands in the gradient products":
        vv, kr, qr = Q(v, -1), Q(k, -2), Q(q, -2)
        pd = Q(p, -2)
    dp = torch.einsum("bgqd,bkd->bgqk", do, vv)
    ds = p * (dp - delta[..., None]) * scale
    dsd = ds
    if fault == "P and dS as one bf16 piece":
        pd, dsd = (x.to(torch.bfloat16).to(f64) for x in (p, ds))
    grads = (torch.einsum("bgqk,bkd->bgqd", dsd, kr),
             torch.einsum("bgqk,bgqd->bkd", dsd, qr),
             torch.einsum("bgqk,bgqd->bkd", pd, do))
    D = p * (torch.einsum("bgqd,bkd->bgqk", do.abs(), v.to(f64).abs())
             + delta.abs()[..., None]) * scale
    bounds = (torch.einsum("bgqk,bkd->bgqd", D, k.to(f64).abs()),
              torch.einsum("bgqk,bgqd->bkd", D, q.to(f64).abs()),
              torch.einsum("bgqk,bgqd->bkd", p, do.abs()))
    return grads, bounds


def flash_bwd_check(got, want, bounds):
    """(ok, worst): every element of dq, dk, dv within FLASH_BWD_EPS of its
    bound; ``worst`` is the largest error over what its element allows."""
    worst = max(((g.double() - w.double()).abs()
                 / (FLASH_BWD_EPS * b + 1e-30)).max().item()
                for g, w, b in zip(got, want, bounds))
    return worst <= 1.0, worst


# GEMM tolerance, per element: one bf16 ulp of the plain result (for fp32
# results |want| * 2^-23) for the final rounding, plus sqrt(n) * 2^-24 *
# sum_k |Q(a)_k Q(b)_k| for the n-term fp32 sums, which the kernel and the
# plain version take in different orders.  Rounding errors of such a sum
# add up like a random walk, ~sqrt(n) * 2^-24 * |partial sums|, and every
# partial sum is below the sum of the magnitudes.  The worst-case bound
# n * 2^-24 * sum |terms| is sqrt(n) times looser: at the lm_head's n =
# 32000 it admits errors of about a quarter of a typical output, and W
# quantized along K instead of N passes it (tests/test_torch_gemm_sm90.py).
GEMM_FAULTS = {"dgrad": ("w quantized along K instead of N",),
               "wgrad": ("x left unquantized",)}


def gemm_check(got, want, qa, qb, n_terms: int):
    """(ok, worst, max_abs_err) of a GEMM result against its plain version
    ``want``; ``qa @ qb`` sums the magnitudes of each element's terms and
    ``worst`` is the largest error over what its element allows."""
    import torch
    w = want.float()
    last = (w.abs() * 2.0 ** -23 if want.dtype == torch.float32
            else ulp_bf16(w))
    tol = last + math.sqrt(n_terms) * 2.0 ** -24 * (qa @ qb)
    diff = (got.float() - w).abs()
    worst = (diff / tol.clamp(min=2.0 ** -149)).max().item()
    return bool((diff <= tol).all()), worst, diff.max().item()


def planted_gemm(kind, a, b, fa, fb, fault=None):
    """The plain dgrad (a = dy (M, N), b = w (K, N)) or wgrad (a = x (T, K),
    b = dy (T, N)) with one planted ``fault`` (None: none)."""
    import torch
    from repro_torch.core import quantize_mx
    if kind == "dgrad":
        axis = 0 if fault == "w quantized along K instead of N" else 1
        aq, bq = quantize_mx(a, fa, axis=-1), quantize_mx(b, fb, axis=axis)
        return torch.matmul(aq.float(), bq.float().T).to(a.dtype)
    aq = a if fault == "x left unquantized" else quantize_mx(a, fa, axis=0)
    bq = quantize_mx(b, fb, axis=0)
    return torch.matmul(aq.float().T, bq.float()).to(a.dtype)


# ---------------------------------------------------------------------------
# The scale rules ("floor", "bump", "adaptive") and the low-bit formats.
# ---------------------------------------------------------------------------
# Under "floor" and "bump" a kernel's quantization equals its plain
# version's bit for bit.  Under "adaptive" both pick the exponent e or
# e + 1 of each 32-block by comparing two fp32 sums of 32 squared errors;
# the kernels add them in a butterfly order and torch.sum in its own, so
# the two choices can differ where the sums are within their rounding of
# each other.  Such a block must hold the plain version's other candidate
# bit for bit, and be a near tie: |err1 - err0| <= TIE_EPS (err0 + err1)
# with the errors summed exactly (fp64); each fp32 sum of 32 non-negative
# terms is within ~32 ulps of its exact value.
TIE_EPS = 32 * 2.0 ** -24
# Faults a kernel could plant in its scale rule or its cast, each held to
# the mode it breaks: the floor rule run under "bump" or "adaptive", e + 1
# taken for every block under "adaptive", and the cast without the
# min_normal_exp clamp (the element's own exponent below the smallest
# normal, so the subnormal grid is lost; E2M1's min_normal_exp is 0).  The
# quantize check sees each bit for bit.  A GEMM check sees the floor rule,
# which clamps the blocks whose max lies above max_normal * 2^e, but not
# "always e + 1" in E4M3: e and e + 1 cast a block alike but for its
# elements more than 2^14 below the max, whose products lie far below a
# bf16 ulp of the outputs.
SCALE_FAULTS = {"bump": ("the floor rule",),
                "adaptive": ("always e + 1", "the floor rule")}
CAST_FAULT = "no min_normal_exp clamp"


def planted_quantize(x, fmt, axis, scale_mode, fault=None):
    """quantize_mx along ``axis`` with one planted ``fault`` (None: none)."""
    import torch
    from repro_torch.core import quantize_mx
    from repro_torch.core.formats import exp2_int, floor_log2
    from repro_torch.core.mx import (block_reshape, block_unreshape,
                                     shared_exponent)
    if fault is None or fmt is None:
        return quantize_mx(x, fmt, axis=axis, scale_mode=scale_mode)
    if fault == "the floor rule":
        return quantize_mx(x, fmt, axis=axis, scale_mode="floor")
    xf = x.float()
    xb, n = block_reshape(xf, axis, 32)
    if fault == "always e + 1":
        m = xb.abs().amax(-1, keepdim=True)
        e = torch.where(m > 0, torch.clamp(
            shared_exponent(xb, fmt, "floor") + 1, -126, 127), -126)
    else:
        e = shared_exponent(xb, fmt, scale_mode)
    scale = exp2_int(e)
    r = xb / scale
    mag = r.abs()
    ee = floor_log2(torch.where(mag > 0, mag, torch.ones_like(mag)))
    if fault != CAST_FAULT:
        ee = torch.clamp(ee, min=fmt.min_normal_exp)
    quantum = exp2_int(ee - fmt.mbits)
    q = torch.clamp(torch.round(r / quantum) * quantum, -fmt.max_normal,
                    fmt.max_normal)
    q = torch.where(mag > 0, q, torch.zeros_like(q))
    q = torch.where(torch.isfinite(r), q, r)
    y = block_unreshape(q * scale, axis, n)
    return (xf + (y - xf)).to(x.dtype)


def scale_choice_check(x, got, fmt, axis, scale_mode):
    """(ok, n_off, n_blocks): ``got`` (a kernel's quantization of x along
    ``axis``) against the plain version, block by block; ``n_off`` counts
    the blocks that differ, which for a correct kernel are adaptive near
    ties (see TIE_EPS)."""
    import torch
    from repro_torch.core import quantize_mx
    from repro_torch.core.formats import exp2_int, floor_log2, quantize_elem
    from repro_torch.core.mx import block_reshape

    def same(a, b):
        return ((a == b) | (a.isnan() & b.isnan())).all(-1)
    want = quantize_mx(x, fmt, axis=axis, scale_mode=scale_mode)
    gb = block_reshape(got.float(), axis, 32)[0]
    wb = block_reshape(want.float(), axis, 32)[0]
    eq = same(gb, wb)
    if scale_mode != "adaptive" or bool(eq.all()):
        return bool(eq.all()), int((~eq).sum()), eq.numel()
    xb = block_reshape(x.float(), axis, 32)[0]
    m = xb.abs().amax(-1, keepdim=True)
    e = floor_log2(torch.where(m > 0, m, torch.ones_like(m))) - fmt.e_max
    cands, errs = [], []
    for c in (e, e + 1):
        sc = exp2_int(c)
        y = quantize_elem(xb / sc, fmt) * sc
        errs.append(((y.double() - xb.double()) ** 2).sum(-1))
        cands.append((xb + (y - xb)).to(x.dtype).float())
    other = torch.where(same(wb, cands[0])[..., None], cands[1], cands[0])
    tie = (errs[1] - errs[0]).abs() <= TIE_EPS * (errs[0] + errs[1])
    ok = bool((eq | (same(gb, other) & tie)).all())
    return ok, int((~eq).sum()), eq.numel()


def mode_input(shape, axis, fmt, g, std=1.0, dtype=None, edges=False):
    """Normal values whose 32-blocks along ``axis`` make the scale rules
    matter.  Of every four blocks, the second has its max above
    max_normal * 2^e, from just above to just below 2^(e + e_max + 1)
    (where "bump" takes e + 1, and the max then rounds to another value
    than the floor rule's clamp once it lies past the midpoint of the
    last bin); the third is tight, all
    its values near 1.96 * 2^k, where the floor scale clamps them all and
    "adaptive" takes e + 1; the fourth spans the format's normal and
    subnormal range below its max, so that e + 1 puts more of it on the
    coarser subnormal grid and "adaptive" keeps e.  With ``edges``, the first rows hold an all-zero block, a NaN, an
    infinity, and blocks whose floor exponent sits at the lower and upper
    clip.  Drawn on the generator's device."""
    import torch
    dtype = dtype or torch.bfloat16
    dev = g.device
    x = torch.movedim(torch.randn(*shape, generator=g, device=dev) * std,
                      axis, -1)
    n = x.shape[-1] // 32 * 32
    xb = x[..., :n].unflatten(-1, (-1, 32))
    k = torch.ceil(torch.log2(xb.abs().amax(-1) + 1e-30))
    sign = torch.where(xb[..., 0] < 0, -1.0, 1.0)
    top = fmt.max_normal / 2.0 ** fmt.e_max      # max_normal's mantissa
    frac = 2.0 ** -7 + (2 - top - 2.0 ** -6) * torch.rand(
        k.shape, generator=g, device=dev)
    xb[..., 1::4, 0] = ((top + frac) * 2.0 ** k * sign)[..., 1::4]
    tight = (1.96 + 0.02 * torch.rand(xb[..., 2::4, :].shape, generator=g,
                                      device=dev)
             ) * 2.0 ** k[..., 2::4, None]
    xb[..., 2::4, :] = tight * torch.where(xb[..., 2::4, :] < 0, -1.0, 1.0)
    span = fmt.e_max - fmt.min_normal_exp + fmt.mbits + 2
    wide = 2.0 ** (k[..., 3::4, None] - span * torch.rand(
        xb[..., 3::4, :].shape, generator=g, device=dev))
    xb[..., 3::4, :] = wide * torch.where(xb[..., 3::4, :] < 0, -1.0, 1.0)
    if edges:
        flat = xb.reshape(-1, xb.shape[-2], 32)
        flat[0, 0] = 0.0
        flat[0, 3, 5] = float("nan")
        flat[0, 4, 7] = float("inf")
        flat[0, 5] = flat[0, 5] * 2.0 ** -122     # exponent clipped at -126
        flat[0, 6] = 1.9 * 2.0 ** 126             # near the top of fp32
        xb = flat.reshape(xb.shape)
    x[..., :n] = xb.flatten(-2).clone()   # xb may be a view of x
    return torch.movedim(x, -1, axis).to(dtype)


def quantize_mode_case(tag, x, fmt, mode, fault=None):
    """The quantize kernel on x under ``mode`` against its plain version
    (scale_choice_check), and ``fault`` (or the mode's own fault) planted
    in the plain version, which the check must reject."""
    from repro_torch.kernels import ops
    got = ops.mx_quantize(x, fmt, scale_mode=mode)
    ok, ties, n = scale_choice_check(x, got, fmt, -1, mode)
    faults = list(SCALE_FAULTS.get(mode, ())) + ([fault] if fault else [])
    for f in faults:
        accepted, off, _ = scale_choice_check(
            x, planted_quantize(x, fmt, -1, mode, f), fmt, -1, mode)
        print(f"[controls] quantize {fmt.name} {mode}: {f!r} {off} blocks "
              f"off ({'ACCEPTED' if accepted else 'rejected'})", flush=True)
        if accepted:
            raise AssertionError(f"quantize {fmt.name} {mode}: the check "
                                 f"accepts the planted fault {f!r}")
    print(f"[{tag}] {'ok  ' if ok else 'FAIL'} quantize {tuple(x.shape)} "
          f"{x.dtype} {fmt.name} {mode}: {n} blocks, {ties} adaptive near "
          f"ties", flush=True)
    if not ok:
        raise AssertionError(f"quantize {fmt.name} {mode} disagrees with its "
                             f"plain version")
    return ties


def kernel_operands(ops_pairs, mode):
    """Each (x, fmt, axis) quantized by the quantize kernel, whose choices
    every kernel shares (the same cast and butterfly sums), checked against
    the plain version; returns the operands and their near-tie count."""
    from repro_torch.kernels import ops
    out, ties = [], 0
    for x, fmt, axis in ops_pairs:
        q = ops.mx_quantize(x, fmt, axis=axis, scale_mode=mode)
        if fmt is not None:
            ok, n, _ = scale_choice_check(x, q, fmt, axis, mode)
            if not ok:
                raise AssertionError(f"quantize {fmt.name} {mode} along "
                                     f"{axis} disagrees with its plain "
                                     "version")
            ties += n
        out.append(q)
    return out, ties


def gemm_mode_case(tag, kind, a, b, fa, fb, mode, faults=()):
    """The forward GEMM (a (M, K), b (K, N)), dgrad (a = dy, b = w) or
    wgrad (a = x, b = dy) kernel under ``mode`` against its plain version
    with gemm_check, a second call for equal bits, and ``faults`` planted in
    the plain version's quantizers, which gemm_check must reject.  Where
    the operands hold adaptive near ties, the plain product takes the
    kernels' (checked) choices."""
    import torch
    from repro_torch.kernels import ops
    axes = {"fwd": (-1, 0), "dgrad": (-1, 1), "wgrad": (0, 0)}[kind]
    fn = {"fwd": ops.mx_matmul, "dgrad": ops.mx_matmul_dgrad,
          "wgrad": ops.mx_matmul_wgrad}[kind]

    def product(qa, qb):
        qa, qb = qa.float(), qb.float()
        out = {"fwd": lambda: qa @ qb, "dgrad": lambda: qa @ qb.T,
               "wgrad": lambda: qa.T @ qb}[kind]()
        return out.to(a.dtype)

    def planted(fault):
        return product(planted_quantize(a, fa, axes[0], mode, fault),
                       planted_quantize(b, fb, axes[1], mode, fault))
    got = fn(a, b, fa, fb, scale_mode=mode)
    (qa, qb), ties = kernel_operands(((a, fa, axes[0]), (b, fb, axes[1])),
                                     mode)
    want = planted(None) if ties == 0 else product(qa, qb)
    ma, mb = qa.float().abs(), qb.float().abs()
    ma, mb = {"fwd": (ma, mb), "dgrad": (ma, mb.T), "wgrad": (ma.T, mb)}[kind]
    n = a.shape[0] if kind == "wgrad" else a.shape[-1]
    ok, worst, err = gemm_check(got, want, ma, mb, n)
    replay = torch.equal(got, fn(a, b, fa, fb, scale_mode=mode))
    if faults:
        check_controls(f"{kind} {tuple(a.shape)}x{tuple(b.shape)} {mode}",
                       lambda y: gemm_check(y, want, ma, mb, n), planted,
                       faults)
    names = "/".join(f.name if f else "bf16" for f in (fa, fb))
    print(f"[{tag}] {'ok  ' if ok and replay else 'FAIL'} {kind} "
          f"{tuple(a.shape)}x{tuple(b.shape)} {names} {mode}: worst err/tol "
          f"{worst:.3f}, replay equal {replay}, {ties} adaptive near ties",
          flush=True)
    if not (ok and replay):
        raise AssertionError(f"{kind} {names} {mode} disagrees with its "
                             f"plain version (worst err/tol {worst})")
    return ties


def phase_scale_modes():
    """All eight kernels under "bump" and "adaptive" against their plain
    versions at the shapes of [kernels], on inputs whose blocks make the
    rules matter (mode_input): quantize bitwise (adaptive: near ties
    only), the GEMMs within gemm_check, attention within attn_check, the
    flash dgrad within its term bound, paged decode bitwise to the slab
    decode kernel.  The mode's planted faults (SCALE_FAULTS) must fail the
    quantize check, the floor rule also the forward GEMM's."""
    import torch
    from repro_torch.core import E4M3, AttnSpec
    from repro_torch.kernels import ops, ref

    dev, fmt, spec = "cuda", E4M3, AttnSpec()
    g = torch.Generator().manual_seed(SEED + 16)

    def mi(shape, axis, std=1.0, dtype=torch.bfloat16, edges=False):
        return mode_input(shape, axis, fmt, g, std, dtype, edges).to(dev)
    ties = {}
    for mode in ("bump", "adaptive"):
        fault = ("the floor rule",)
        t = quantize_mode_case("scale-modes", mi((1, 512, 512), -1,
                                                 dtype=torch.float32,
                                                 edges=True), fmt, mode)
        x, w = mi((TOKENS, 512), -1), mi((512, 32000), 0, 1 / math.sqrt(512))
        t += gemm_mode_case("scale-modes", "fwd", x[:4], w, fmt, fmt, mode,
                            fault)
        t += gemm_mode_case("scale-modes", "fwd", x, w, fmt, fmt, mode, fault)
        dy = mi((TOKENS, 32000), -1, 1e-2)
        t += gemm_mode_case("scale-modes", "dgrad", dy,
                            mi((512, 32000), 1, 1 / math.sqrt(512)), fmt,
                            fmt, mode)
        t += gemm_mode_case("scale-modes", "wgrad", mi((TOKENS, 512), 0),
                            mi((TOKENS, 32000), 0, 1e-2), fmt, fmt, mode)
        del dy
        q, k, v = mi((8, 1, 512, 64), -1), mi((8, 512, 64), -1), mi(
            (8, 512, 64), -2)
        # attn_check with the near-tie slack of the p cast (flash_fwd_case),
        # which must reject the mode's planted faults
        c = flash_fwd_case(q, k, v, fmt, spec, mode)
        print(f"[scale-modes] {'ok  ' if c['ok'] else 'FAIL'} flash bucket "
              f"512 {mode}: worst err/tol {c['worst']:.3f}, lse err "
              f"{c['lse_err']:.2e}, replay equal {c['replay']}, "
              f"{c['ties']} rows with a near tie, {reach_note(c['reach'])}",
              flush=True)
        if not c["ok"]:
            raise AssertionError(f"flash forward {mode} disagrees")
        check_controls(f"flash bucket 512 {mode}", c["check"],
                       lambda fault: planted_flash(q, k, v, fmt, fault, mode),
                       FLASH_MODE_FAULTS[mode])
        BH, T = 64, 512
        q, k, v = mi((BH, 1, T, 64), -1), mi((BH, T, 64), -1), mi(
            (BH, T, 64), -2)
        # the operands' adaptive near ties, counted by the quantize kernel
        # (the pre-pass casts q and k along d, v along kv, as it does)
        ft = kernel_operands(((q, fmt, -1), (k, fmt, -1), (v, fmt, -2)),
                             mode)[1]
        c = flash_fwd_case(q, k, v, fmt, spec, mode)
        print(f"[scale-modes] {'ok  ' if c['ok'] else 'FAIL'} flash forward "
              f"BH{BH} T{T} {mode}: worst err/tol {c['worst']:.3f}, lse err "
              f"{c['lse_err']:.2e}, replay equal {c['replay']}, {ft} "
              f"adaptive near ties in q, k, v, {c['ties']} rows with a near "
              f"tie of the p cast, {reach_note(c['reach'])}", flush=True)
        if not c["ok"]:
            raise AssertionError(f"flash forward BH{BH} {mode} disagrees")
        check_controls(f"flash BH{BH} T{T} {mode}", c["check"],
                       lambda fault: planted_flash(q, k, v, fmt, fault, mode),
                       FLASH_MODE_FAULTS[mode])
        del c
        t += ft
        dout = mi((BH, 1, T, 64), -1, 1e-2)
        c = flash_bwd_case(q, k, v, dout, fmt, spec, mode)
        print(f"[scale-modes] {'ok  ' if c['ok'] else 'FAIL'} flash dgrad "
              f"BH{BH} T{T} {mode}: worst err/tol {c['worst']:.3f}, replay "
              f"equal {c['replay']}", flush=True)
        if not c["ok"]:
            raise AssertionError(f"flash dgrad {mode} disagrees")
        for label, BH, G, Tq, Tk, d, kw in FLASH_BWD_EDGES:
            # From d 128 on, a row of q and k holds a tight block (32
            # values near 1.96 * 2^k): at std 1 the logits reach a few
            # hundred, and their fp32 rounding alone puts the plain
            # version itself outside FLASH_BWD_EPS of the fp64 product
            # (tests/test_torch_attn_sm90.py).  At std 2^-2 q and k draw
            # the same kinds of blocks scaled by 2^-2 (the cast commutes
            # with a power of two), with logits below ~20.  The std 1
            # inputs are then held against the fp64 grads beside the plain
            # version (flash_bwd_fp64_case).
            std = 0.25 if d > 64 else 1.0
            q, k, v = (mi((BH, G, Tq, d), -1, std), mi((BH, Tk, d), -1, std),
                       mi((BH, Tk, d), -2))
            dout = mi((BH, G, Tq, d), -1, 1e-2)
            c = flash_bwd_case(q, k, v, dout, fmt, AttnSpec(**kw), mode)
            print(f"[scale-modes] {'ok  ' if c['ok'] else 'FAIL'} flash "
                  f"dgrad {label} {mode}: worst err/tol {c['worst']:.3f}, "
                  f"replay equal {c['replay']}", flush=True)
            if not c["ok"]:
                raise AssertionError(f"flash dgrad {label} {mode} disagrees")
            if d > 64:   # and at std 1, against the fp64 grads
                q, k = mi((BH, G, Tq, d), -1), mi((BH, Tk, d), -1)
                ok, worst, pw, fw, rep = flash_bwd_fp64_case(
                    q, k, v, dout, fmt, AttnSpec(**kw), mode)
                print(f"[scale-modes] {'ok  ' if ok else 'FAIL'} flash "
                      f"dgrad {label} std 1 {mode} against fp64: kernel "
                      f"worst err/tol {worst:.3f}, plain version {pw:.3f} "
                      f"(limit max(1, 2x plain)), "
                      f"{FLASH_BWD_FAULTS[-1]!r} {fw:.2f} "
                      f"({'rejected' if fw > max(1.0, 2 * pw) else 'ACCEPTED'}"
                      f"), replay equal {rep}", flush=True)
                if not ok:
                    raise AssertionError(f"flash dgrad {label} std 1 {mode} "
                                         "against fp64 disagrees")
        B, H, S = 4, 8, 512
        qd = mi((B * H, 1, 64), -1)
        kc, vc = mi((B, S, H, 64), -1), mi((B, S, H, 64), 1)
        pos = torch.tensor([100, 257, 400, 511], device=dev)
        valid = torch.arange(S, device=dev)[None] <= pos[:, None]
        ok, worst = decode_case(qd, kc, vc, valid, fmt, mode)[:2]
        for label, B, H, G, S, hole, d, dv in DECODE_EDGES:
            qe, ke, ve = (mi((B * H, G, d), -1), mi((B, S, H, d), -1),
                          mi((B, S, H, dv), 1))
            vale = decode_valid(B, S, hole, dev)
            ok_e, worst_e = decode_case(qe, ke, ve, vale, fmt, mode)[:2]
            print(f"[scale-modes] {'ok  ' if ok_e else 'FAIL'} decode "
                  f"{label} (B{B} H{H} G{G} S{S}) {mode}: worst err/tol "
                  f"{worst_e:.3f}", flush=True)
            if not ok_e:
                raise AssertionError(f"decode {label} {mode} disagrees")
        qp, kp, vp, pt, validp, _ = paged_case(16, dev)
        op = ops.mx_attention_decode_paged(qp, kp, vp, pt, validp, fmt,
                                           scale_mode=mode)
        o7 = ops.mx_attention_decode(
            qp, ref.gather_pages(kp, pt), ref.gather_pages(vp, pt),
            torch.repeat_interleave(validp, kp.shape[2], dim=0), fmt,
            scale_mode=mode)
        same7 = torch.equal(op, o7)
        print(f"[scale-modes] {'ok  ' if ok and same7 else 'FAIL'} decode "
              f"B4 H8 S512 {mode}: worst err/tol {worst:.3f}; paged decode "
              f"P16 bitwise to the slab kernel {same7}", flush=True)
        if not (ok and same7):
            raise AssertionError(f"decode {mode} disagrees")
        ties[mode] = t
    return ties


def lowbit_kernels():
    """[kernels] in MXFP6 (E3M2, E2M3) and MXFP4 (E2M1) under each scale
    rule: quantize bitwise to its plain version (adaptive: near ties
    only), the forward GEMM on both paths (decode and training lm_head)
    and the dgrad and wgrad on the proxy's fp32 operands (batch 2048,
    512 -> 2048: the path every sweep preset trains through) within
    gemm_check; the cast without the min_normal_exp clamp planted in the
    plain versions must fail every check."""
    import torch
    from repro_torch.core import E2M1, E2M3, E3M2

    g = torch.Generator().manual_seed(SEED + 6)
    out = {}
    for fmt in (E3M2, E2M3, E2M1):
        for mode in ("floor", "bump", "adaptive"):
            fault = CAST_FAULT if mode == "floor" else None
            t = quantize_mode_case("kernels", mode_input(
                (1, 512, 512), -1, fmt, g, dtype=torch.float32,
                edges=True).cuda(), fmt, mode, fault)
            x = mode_input((TOKENS, 512), -1, fmt, g).cuda()
            w = mode_input((512, 32000), 0, fmt, g,
                           1 / math.sqrt(512)).cuda()
            faults = (CAST_FAULT,) if fault else ()
            t += gemm_mode_case("kernels", "fwd", x[:4], w, fmt, fmt, mode,
                                faults)
            t += gemm_mode_case("kernels", "fwd", x, w, fmt, fmt, mode,
                                faults)
            t += proxy_bwd_cases("kernels", fmt, mode, g, faults)
            out[f"{fmt.name} {mode}"] = t
    return out


def proxy_bwd_cases(tag, fmt, mode, g, faults=(), dev="cuda"):
    """The dgrad and wgrad kernels on the proxy's fp32 operands (batch
    2048, d 512 -> hidden 2048) in ``fmt`` under ``mode`` (gemm_mode_case,
    ``faults`` planted); returns the adaptive near ties."""
    import torch
    f32 = torch.float32
    M, K, N = 2048, 512, 2048
    dy = mode_input((M, N), -1, fmt, g, 1e-2, f32).to(dev)
    w = mode_input((K, N), 1, fmt, g, 1 / math.sqrt(K), f32).to(dev)
    t = gemm_mode_case(tag, "dgrad", dy, w, fmt, fmt, mode, faults)
    x = mode_input((M, K), 0, fmt, g, dtype=f32).to(dev)
    dy = mode_input((M, N), 0, fmt, g, 1e-2, f32).to(dev)
    return t + gemm_mode_case(tag, "wgrad", x, dy, fmt, fmt, mode, faults)


# ---------------------------------------------------------------------------
# [lanes]: the lane GEMMs, kernels 2-4 with a lane axis (ops.mx_matmul_lanes,
# mx_matmul_dgrad_lanes, mx_matmul_wgrad_lanes), which the sweeps' packs run.
# ---------------------------------------------------------------------------
LANES = 8
# (label, batch, d_model, hidden): the fig6 preset's proxy (the shapes the
# [sweep] path gives the lane kernels) and ProxyConfig().
LANE_SIZES = (("fig6", 256, 128, 512), ("ProxyConfig", 2048, 512, 2048))
LANE_FORMATS = ("e4m3", "e5m2", "e3m2", "e2m3", "e2m1")
LANE_KERNELS = ("mx_matmul_lanes", "mx_matmul_dgrad_lanes",
                "mx_matmul_wgrad_lanes")
# Faults a lane GEMM could plant: lane l computing with lane l + 1's
# weight, and a plan taken with the lane count folded into the output
# tiles (fewer contraction splits where the one-lane plan splits).  The
# first breaks the product, so gemm_check rejects it too; the second only
# changes the order of fp32 sums, which gemm_check allows by design and
# only the bitwise check against the 2-D kernel sees.
LANE_FAULTS = ("a lane reads lane l+1's weight",
               "a plan that folds L into the split count")


def lane_fns(kind):
    """(lane wrapper, 2-D wrapper, plain lane version, quantize axes of the
    two operands) of the forward GEMM, dgrad or wgrad."""
    from repro_torch.kernels import ops, ref
    return {"fwd": (ops.mx_matmul_lanes, ops.mx_matmul,
                    ref.mx_matmul_lanes_ref, (-1, 1)),
            "dgrad": (ops.mx_matmul_dgrad_lanes, ops.mx_matmul_dgrad,
                      ref.mx_matmul_dgrad_lanes_ref, (-1, -1)),
            "wgrad": (ops.mx_matmul_wgrad_lanes, ops.mx_matmul_wgrad,
                      ref.mx_matmul_wgrad_lanes_ref, (1, 1))}[kind]


def lane_operands(kind, B, d, h, fmt, g, lanes=LANES):
    """The proxy's first-layer GEMM of ``kind`` over ``lanes`` lanes, fp32:
    forward x (L, B, d) @ W (L, d, h), dgrad dy (L, B, h) against W, wgrad
    x against dy; blocks along each contraction make the scale rules
    matter (mode_input)."""
    import torch
    f32, L = torch.float32, lanes
    if kind == "fwd":
        return (mode_input((L, B, d), -1, fmt, g, dtype=f32),
                mode_input((L, d, h), 1, fmt, g, 1 / math.sqrt(d), f32))
    if kind == "dgrad":
        return (mode_input((L, B, h), -1, fmt, g, 1e-2, f32),
                mode_input((L, d, h), -1, fmt, g, 1 / math.sqrt(d), f32))
    return (mode_input((L, B, d), 1, fmt, g, dtype=f32),
            mode_input((L, B, h), 1, fmt, g, 1e-2, f32))


def _t(x):
    return x.transpose(-1, -2)


def lane_product(kind, a, b):
    """The GEMM of ``kind`` on (quantized) lane operands in product form,
    (L, M, Kc) @ (L, Kc, N), as fp32."""
    a, b = a.float(), b.float()
    return {"fwd": (a, b), "dgrad": (a, _t(b)), "wgrad": (_t(a), b)}[kind]


def split_product(kind, a, b, fmt, mode="floor", plan=None):
    """A plain emulation of the lane kernels' split-K order: each lane's
    quantized operands in product form, the contraction cut into the
    plan's splits of whole BWD_DEPTH k-tiles, each split's fp32 product,
    the splits summed in order, lane by lane.  ``plan(rows, cols,
    contraction) -> (depth, splits)`` is ops.bwd_gemm_plan unless given
    (a planted plan)."""
    import torch
    from repro_torch.kernels import ops, ref
    _, _, _, axes = lane_fns(kind)
    plan = plan or ops.bwd_gemm_plan
    qa = ref.mx_quantize_ref(a, fmt, axis=axes[0], scale_mode=mode)
    qb = ref.mx_quantize_ref(b, fmt, axis=axes[1], scale_mode=mode)
    A, Bm = lane_product(kind, qa, qb)
    M, Kc, N = A.shape[1], A.shape[2], Bm.shape[2]
    depth, splits = plan(M, N, Kc)
    ktiles = depth // ops.BWD_DEPTH
    per = -(-ktiles // splits) * ops.BWD_DEPTH
    out = []
    for lane in range(A.shape[0]):
        acc = None
        for k0 in range(0, Kc, per):
            part = A[lane, :, k0:k0 + per] @ Bm[lane, k0:k0 + per, :]
            acc = part if acc is None else acc + part
        out.append(acc.to(a.dtype))
    return torch.stack(out)


def folded_plan(lanes):
    """ops.bwd_gemm_plan with the lane count folded into the output tiles
    (the planted plan fault)."""
    from repro_torch.kernels import ops
    plan = ops.bwd_gemm_plan
    return lambda rows, cols, contraction: plan(rows * lanes, cols,
                                                contraction)


def planted_lanes(kind, a, b, fmt, mode, fault=None):
    """The lane call of ``kind`` with one planted ``fault`` (None: none).
    On CUDA tensors the lane kernel (the folded plan patched into
    ops.bwd_gemm_plan for the call) or the 2-D kernel per lane; on CPU
    tensors the plain versions and the split emulation."""
    from repro_torch.kernels import ops
    fn, fn2, _, _ = lane_fns(kind)
    L = a.shape[0]
    if fault == LANE_FAULTS[0]:
        import torch
        return torch.stack([fn2(a[i], b[(i + 1) % L], fmt, fmt,
                                scale_mode=mode) for i in range(L)])
    if not a.is_cuda:
        return split_product(kind, a, b, fmt, mode,
                             folded_plan(L) if fault else None)
    if fault == LANE_FAULTS[1]:
        plan = ops.bwd_gemm_plan
        ops.bwd_gemm_plan = folded_plan(L)
        try:
            return fn(a, b, fmt, fmt, scale_mode=mode)
        finally:
            ops.bwd_gemm_plan = plan
    return fn(a, b, fmt, fmt, scale_mode=mode)


def lane_splits(kind, a, b, plan=None):
    """The contraction splits the plan gives one lane of ``kind``."""
    from repro_torch.kernels import ops
    plan = plan or ops.bwd_gemm_plan
    A, Bm = lane_product(kind, a[:1], b[:1])
    return plan(A.shape[1], Bm.shape[2], A.shape[2])[1]


def lane_case(kind, a, b, fmt, mode, faults=False):
    """The lane kernel of ``kind`` on (L, ., .) operands under ``mode``:
    every lane bitwise equal to the 2-D kernel's call on that lane's
    operands, the whole within gemm_check of the plain version (where the
    operands hold adaptive near ties, of the product of the kernels'
    checked choices, as gemm_mode_case), equal bits on a second call; with
    ``faults`` the LANE_FAULTS planted (each must fail the bitwise check,
    the first also gemm_check).  Returns a dict of the readings."""
    import torch
    fn, fn2, plain, axes = lane_fns(kind)
    L = a.shape[0]
    got = fn(a, b, fmt, fmt, scale_mode=mode)
    two = torch.stack([fn2(a[i], b[i], fmt, fmt, scale_mode=mode)
                       for i in range(L)])
    bitwise = torch.equal(got, two)
    replay = torch.equal(got, fn(a, b, fmt, fmt, scale_mode=mode))
    (qa, qb), ties = kernel_operands(((a, fmt, axes[0]), (b, fmt, axes[1])),
                                     mode)
    want = (plain(a, b, fmt, fmt, scale_mode=mode) if ties == 0 else
            torch.matmul(*lane_product(kind, qa, qb)).to(a.dtype))
    ma, mb = lane_product(kind, qa.abs(), qb.abs())
    n = ma.shape[-1]
    ok, worst, err = gemm_check(got, want, ma, mb, n)
    out = {"kind": kind, "fmt": fmt.name, "mode": mode,
           "shape": [list(a.shape), list(b.shape)], "bitwise_2d": bitwise,
           "replay": replay, "worst": worst, "max_abs_err": err,
           "ties": ties, "splits": lane_splits(kind, a, b)}
    if faults:
        for fault in LANE_FAULTS:
            if fault == LANE_FAULTS[1] and lane_splits(
                    kind, a, b, folded_plan(L)) == out["splits"]:
                print(f"[controls] lanes {kind} {fmt.name}: {fault!r} not "
                      f"plantable ({out['splits']} splits either way)",
                      flush=True)
                continue
            bad = planted_lanes(kind, a, b, fmt, mode, fault)
            same = torch.equal(bad, two)
            accepted, w_ = gemm_check(bad, want, ma, mb, n)[:2]
            print(f"[controls] lanes {kind} {fmt.name} {mode}: {fault!r} "
                  f"bitwise to the 2-D kernel {same}, gemm_check worst "
                  f"err/tol {w_:.2f} "
                  f"({'ACCEPTED' if same else 'rejected'})", flush=True)
            if same or (fault == LANE_FAULTS[0] and accepted):
                raise AssertionError(f"lanes {kind}: the checks accept the "
                                     f"planted fault {fault!r}")
    return out


def lane_bound(kind, a, b):
    """(bound ms, bound_by) of a lane GEMM: each operand read once, the
    output (in a's dtype) written once; bf16 tensor-core operations."""
    A, Bm = lane_product(kind, a[:1], b[:1])
    L, (M, Kc), N = a.shape[0], A.shape[1:], Bm.shape[2]
    ea, eb = a.element_size(), b.element_size()
    return bound(L * (ea * (M * Kc + M * N) + eb * Kc * N),
                 2 * L * M * N * Kc)


def lane_library(kind, a, b):
    """torch.bmm of the unquantized operands: the same product, one call."""
    import torch
    return {"fwd": lambda: torch.bmm(a, b),
            "dgrad": lambda: torch.bmm(a, _t(b)),
            "wgrad": lambda: torch.bmm(_t(a), b)}[kind]


def phase_lanes():
    """[lanes]: the three lane kernels at LANES lanes, at the fig6 preset's
    shapes and ProxyConfig()'s, fp32, in five formats under every rule:
    each lane bitwise to the 2-D kernel, within gemm_check of the plain
    version, equal bits on a second call; LANE_FAULTS planted at
    ProxyConfig() in E4M3; in E4M3 under floor, the lane call timed
    against LANES 2-D calls, the plain version and torch.bmm.  Returns
    the kernel rows (fig6's shapes are the primary case)."""
    import torch
    from repro_torch.core import get_format
    from repro_torch.kernels import ops

    g = torch.Generator(device="cuda").manual_seed(SEED + 19)
    flush = torch.zeros(64 * 2 ** 20, dtype=torch.uint8,
                        device="cuda").bitwise_not_
    card = torch.cuda.get_device_name(0)
    rows = {}
    ties = 0
    for label, B, d, h in LANE_SIZES:
        for fname in LANE_FORMATS:
            fmt = get_format(fname)
            for kind, name in zip(("fwd", "dgrad", "wgrad"), LANE_KERNELS):
                a, b = lane_operands(kind, B, d, h, fmt, g)
                for mode in ops.SCALE_MODES:
                    primary = fname == "e4m3" and mode == "floor"
                    c = lane_case(kind, a, b, fmt, mode, faults=(
                        primary and label == "ProxyConfig"))
                    ties += c["ties"]
                    ok = (c["bitwise_2d"] and c["replay"]
                          and c["worst"] <= 1.0)
                    print(f"[lanes] {'ok  ' if ok else 'FAIL'} {label} "
                          f"{name} {json.dumps(c)}", flush=True)
                    if not ok:
                        raise AssertionError(
                            f"lanes {label} {name} {fname} {mode}: bitwise "
                            f"{c['bitwise_2d']}, replay {c['replay']}, "
                            f"worst err/tol {c['worst']}")
                    if not primary:
                        continue
                    fn, fn2, plain, _ = lane_fns(kind)

                    def lane_call():
                        return fn(a, b, fmt, fmt)

                    def two_d():
                        return [fn2(a[i], b[i], fmt, fmt)
                                for i in range(LANES)]
                    events0 = EVENT_TIMED[0]
                    ms = time_ms(lane_call, 10, flush)
                    entry = {
                        "case": f"{label} L{LANES} {tuple(a.shape)}x"
                                f"{tuple(b.shape)} fp32 e4m3 floor",
                        "max_abs_err": c["max_abs_err"], "ms": ms,
                        "two_d_x_lanes_ms": time_ms(two_d, 10, flush),
                        "plain_ms": time_ms(
                            lambda: plain(a, b, fmt, fmt), 3, flush),
                        "library_ms": time_ms(lane_library(kind, a, b), 10,
                                              flush),
                        "splits": c["splits"], "card": card}
                    entry["bound_ms"], entry["bound_by"] = lane_bound(
                        kind, a, b)
                    entry["timing"] = ("events" if EVENT_TIMED[0] > events0
                                       else "profiler")
                    print(f"[lanes] {name} {json.dumps(entry)}", flush=True)
                    rows.setdefault(name, {"cases": []})["cases"].append(
                        entry)
                    if label == "fig6":
                        rows[name].update(entry)
    print(f"[lanes] {ties} adaptive near ties over every case", flush=True)
    return rows


def training_kernels(rnd, record, flush):
    """dgrad and wgrad of wq, w_up, w_down and the lm_head over 4096 tokens
    under E4M3, E5M2 and mixed formats (planted faults and times in E4M3),
    at ragged sizes, the fp32 GEMMs of the proxy, the forward GEMM at the
    lm_head's training shape, and the flash dgrad at BH 64, T 512, d 64,
    causal, in e4m3 and bf16."""
    import torch
    from repro_torch.core import E4M3, E5M2, AttnSpec
    from repro_torch.kernels import ops, ref

    def absq(x, fmt, axis):
        return ref.mx_quantize_ref(x, fmt, axis=axis).float().abs()

    def gemm_case(kind, a, b, fa, fb, case, primary=False, timed=False,
                  faults=False):
        """dgrad (a = dy, b = w) or wgrad (a = x, b = dy): the kernel against
        its plain version and against itself on a second call, the planted
        faults when asked, and, when timed, the kernel (with its pre-pass's
        share), the plain version and the unquantized torch.matmul."""
        if kind == "dgrad":
            def fn():
                return ops.mx_matmul_dgrad(a, b, fa, fb)

            def plain():
                return ref.mx_matmul_dgrad_ref(a, b, fa, fb)

            def lib():
                return torch.matmul(a, b.T)
            qa, qb, n = absq(a, fa, -1), absq(b, fb, 1).T, a.shape[-1]
            M, K = a.shape[0], b.shape[0]
        else:
            def fn():
                return ops.mx_matmul_wgrad(a, b, fa, fb)

            def plain():
                return ref.mx_matmul_wgrad_ref(a, b, fa, fb)

            def lib():
                return torch.matmul(a.T, b)
            qa, qb, n = absq(a, fa, 0).T, absq(b, fb, 0), a.shape[0]
            M, K = a.shape[1], b.shape[1]
        got, want = fn(), plain()
        ok, worst, err = gemm_check(got, want, qa, qb, n)
        replay = torch.equal(got, fn())
        if faults:
            check_controls(f"{kind} {case}",
                           lambda g: gemm_check(g, want, qa, qb, n),
                           lambda f: planted_gemm(kind, a, b, fa, fb, f),
                           GEMM_FAULTS[kind])
        ms = plain_ms = lib_ms = None
        extra = {}
        if timed:
            ms, parts = time_parts_ms(fn, 10, flush)
            pre = sum(v for k_, v in parts.items() if "mx_operand" in k_)
            extra = {"prepass_ms": pre, "prepass_share": pre / ms}
            plain_ms = time_ms(plain, 3, flush)
            lib_ms = time_ms(lib, 10, flush)
        size = a.element_size()
        record(f"mx_matmul_{kind}",
               f"{case} (worst err/tol {worst:.3f}, replay equal {replay})",
               primary, err, ok and replay, ms, plain_ms, lib_ms,
               bound(size * (M * n + n * K + M * K), 2 * M * n * K),
               **extra)

    fmts = (("e4m3", E4M3, E4M3), ("e5m2", E5M2, E5M2),
            ("mixed", E5M2, E4M3))
    for wname, K, N in TRAIN_GEMMS:
        x = rnd(TOKENS, K)
        w = rnd(K, N, std=1.0 / math.sqrt(K))
        dy = rnd(TOKENS, N, std=1e-2)
        for label, f1, f2 in fmts:
            timed = label == "e4m3"
            primary = timed and wname == "lm_head"
            # dgrad: (g, w) formats; mixed is E5M2 gradients, E4M3 weights
            gemm_case("dgrad", dy, w, f1, f2,
                      f"{wname} dx {TOKENS}x{N}->{K} {label}", primary,
                      timed, timed)
            # wgrad: (a, g) formats; mixed is E4M3 activations, E5M2 grads
            fa, fg = (f2, f1) if label == "mixed" else (f1, f2)
            gemm_case("wgrad", x, dy, fa, fg,
                      f"{wname} dW T{TOKENS} {K}x{N} {label}", primary,
                      timed, timed)
        fwd_gemm_case(record, flush,
                      f"train {wname} {TOKENS}x{K}x{N} e4m3/e4m3", x, w,
                      E4M3, E4M3)
        if wname == "lm_head":
            fwd_gemm_case(record, flush,
                          f"train {wname} {TOKENS}x{K}x{N} bf16/e4m3", x, w,
                          None, E4M3)

    # Ragged sizes: 100 rows, 200 output columns, contractions 48 and 1000
    # (not multiples of 32: the partial MX block is zero padded), and a raw
    # gradient (e4m3_bf16act's dgrad reads dy in place; 70 columns are not
    # 16-byte rows, so that dy goes through the pre-pass; 199 output
    # columns take the epilogue's unpaired stores).
    for Kc in (48, 1000):
        for label, f1, f2 in (("e4m3", E4M3, E4M3), ("mixed", E5M2, E4M3),
                              ("raw dy", None, E4M3)):
            fa, fg = (f2, f1) if label != "e4m3" else (f1, f2)
            gemm_case("dgrad", rnd(100, Kc, std=1e-2),
                      rnd(200, Kc, std=1.0 / math.sqrt(Kc)), f1, f2,
                      f"ragged dx 100x{Kc}->200 {label}",
                      faults=label == "e4m3")
            gemm_case("wgrad", rnd(Kc, 100), rnd(Kc, 200, std=1e-2), fa, fg,
                      f"ragged dW T{Kc} 100x200 {label}",
                      faults=label == "e4m3")
    gemm_case("dgrad", rnd(100, 70, std=1e-2), rnd(199, 70), None, E4M3,
              "ragged dx 100x70->199 raw dy")

    # The proxy's fp32 GEMMs (batch 2048, 512 -> 2048), all quantized.
    M, K, N = 2048, 512, 2048
    x = rnd(M, K, dtype=torch.float32)
    w = rnd(K, N, dtype=torch.float32, std=1.0 / math.sqrt(K))
    dy = rnd(M, N, dtype=torch.float32, std=1e-2)
    fwd_gemm_case(record, flush, f"proxy fp32 {M}x{K}x{N} e4m3/e4m3", x, w,
                  E4M3, E4M3)
    gemm_case("dgrad", dy, w, E4M3, E4M3, f"proxy fp32 {M}x{N}->{K} e4m3")
    gemm_case("wgrad", x, dy, E4M3, E4M3, f"proxy fp32 T{M} {K}x{N} e4m3")

    # Flash dgrad: olmo-paper training, B 8 x 8 heads, G 1, T 512, d 64.
    BH, T, d = 64, 512, 64
    spec = AttnSpec()
    n_scores = BH * T * (T + 1) // 2
    for fmt, primary in ((E4M3, True), (None, False)):
        q, k, v = rnd(BH, 1, T, d), rnd(BH, T, d), rnd(BH, T, d)
        dout = rnd(BH, 1, T, d, std=1e-2)
        c = flash_bwd_case(q, k, v, dout, fmt, spec)
        args, want, bounds = c["args"], c["want"], c["bounds"]
        mode = "e4m3" if fmt else "bf16"
        control_ok, control = flash_bwd_check(
            flash_bwd_dense(*args[:7])[0], want, bounds)
        if not control_ok:
            raise AssertionError(f"flash dgrad {mode}: fault-free control "
                                 f"fails the check (worst {control})")
        if fmt is not None:
            for fault in FLASH_BWD_FAULTS:
                accepted, w_ = flash_bwd_check(
                    flash_bwd_dense(*args[:7], fault)[0], want, bounds)
                print(f"[controls] flash dgrad: {fault!r} worst err/tol "
                      f"{w_:.2f} ({'ACCEPTED' if accepted else 'rejected'})",
                      flush=True)
                if accepted:
                    raise AssertionError(f"flash dgrad: the check accepts "
                                         f"the planted fault {fault!r}")
        lib = None
        if fmt is None:   # bf16 mode: PyTorch's FlashAttention backward
            qs, ks, vs = (t.detach().requires_grad_(True)
                          for t in (q[:, 0], k, v))
            o = sdpa_flash(qs, ks, vs)
            lib = time_ms(lambda: torch.autograd.grad(
                o, (qs, ks, vs), dout[:, 0], retain_graph=True), 20, flush)
        record("mx_flash_attention_bwd",
               f"train BH{BH} G1 T{T} d{d} causal {mode} (worst err/tol "
               f"{c['worst']:.3f}, control {control:.3f}, replay equal "
               f"{c['replay']})", primary, c["err"], c["ok"],
               time_ms(lambda: ops.mx_flash_attention_bwd(*args), 10, flush),
               time_ms(lambda: ref.mx_flash_attention_bwd_ref(*args), 3,
                       flush),
               lib, bound(2 * 8 * BH * T * d + 4 * BH * T,
                          10 * d * n_scores))
    # Its edges, each with the new planted fault rejected.
    for label, BH, G, Tq, Tk, d, kw in FLASH_BWD_EDGES:
        spec = AttnSpec(**kw)
        q, k, v = rnd(BH, G, Tq, d), rnd(BH, Tk, d), rnd(BH, Tk, d)
        dout = rnd(BH, G, Tq, d, std=1e-2)
        c = flash_bwd_case(q, k, v, dout, E4M3, spec)
        accepted, w_ = flash_bwd_check(flash_bwd_dense(
            *c["args"][:7], FLASH_BWD_FAULTS[-1], spec=spec)[0], c["want"],
            c["bounds"])
        print(f"[controls] flash dgrad {label}: {FLASH_BWD_FAULTS[-1]!r} "
              f"worst err/tol {w_:.2f} "
              f"({'ACCEPTED' if accepted else 'rejected'})", flush=True)
        if accepted:
            raise AssertionError(f"flash dgrad {label}: the check accepts "
                                 f"the planted fault {FLASH_BWD_FAULTS[-1]!r}")
        n_valid = int(attn_valid(spec, Tq, Tk, q.device).sum()) * BH * G
        record("mx_flash_attention_bwd",
               f"edge {label}: BH{BH} G{G} Tq{Tq} Tk{Tk} d{d} e4m3 (worst "
               f"err/tol {c['worst']:.3f}, replay equal {c['replay']})",
               False, c["err"], c["ok"],
               time_ms(lambda: ops.mx_flash_attention_bwd(*c["args"]), 10,
                       flush), None, None,
               bound(2 * 4 * d * (BH * G * Tq + BH * Tk) + 4 * BH * G * Tq,
                     10 * d * n_valid))


def sdpa_any(q, k, v):
    """PyTorch's SDPA, causal, on (BH, T, ·) q, k, v taken as (BH, 1, T,
    ·), held to the first fused backend (FlashAttention, memory-efficient,
    cuDNN) that takes these shapes, v's head dim unlike q's included.
    Returns (a function of no argument making the call, the backend's
    name), or (None, "none") when no fused backend takes them."""
    import warnings
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION):
        def call(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(
                    q[:, None], k[:, None], v[:, None], is_causal=True)
        try:
            with warnings.catch_warnings():   # each refusal warns its why
                warnings.simplefilter("ignore")
                call()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return call, backend.name
    return None, "none"


# MLA's flash shapes: (label, BH, T, d, dv, primary).  BH 512 is deepseek-
# v2-236b's 128 heads at [mla]'s training batch of 4 x 512 tokens (q is
# [q_nope, q_rope], 128 + 64; v 128); d 24 / dv 16 is its smoke config's.
MLA_FLASH_SHAPES = (("deepseek-v2-236b train", 512, 512, 192, 128),
                    ("deepseek-v2-236b smoke", 16, 300, 24, 16))


def mla_flash_kernels(rnd, record, flush):
    """Kernels 5 and 6 at MLA's head dims (MLA_FLASH_SHAPES), causal, in
    e4m3 and bf16 mode: each against its plain version (the forward with
    the near-tie slack, the dgrad within its term bound), each called
    twice for equal bits, MLA_FLASH_FAULTS (and in the forward at T a
    multiple of 32 FLASH_FAULTS) planted and rejected in e4m3, and SDPA's
    time beside the bf16 rows where a fused backend takes dv != d."""
    import torch
    from repro_torch.core import E4M3, AttnSpec
    from repro_torch.kernels import ops, ref

    spec = AttnSpec()
    for label, BH, T, d, dv in MLA_FLASH_SHAPES:
        q, k, v = rnd(BH, 1, T, d), rnd(BH, T, d), rnd(BH, T, dv)
        dout = rnd(BH, 1, T, dv, std=1e-2)
        n_scores = int(attn_valid(spec, T, T, q.device).sum()) * BH
        for fmt in (E4M3, None):
            mode = "e4m3" if fmt else "bf16"
            c = flash_fwd_case(q, k, v, fmt, spec)
            if fmt is not None:   # the sub-tile fault needs T % 32 == 0
                check_controls(f"flash {label}", c["check"],
                               lambda fault: planted_flash(q, k, v, fmt,
                                                           fault),
                               MLA_FLASH_FAULTS + (FLASH_FAULTS if T % 32 == 0
                                                   else ()))
            lib, backend = None, None
            if fmt is None:
                call, backend = sdpa_any(q[:, 0], k, v)
                lib = call and time_ms(call, 10, flush)
            record("mx_flash_attention",
                   f"mla {label} BH{BH} G1 T{T} d{d} dv{dv} causal {mode} "
                   f"(worst err/tol {c['worst']:.3f}, lse err "
                   f"{c['lse_err']:.2e}, replay equal {c['replay']})",
                   False, c["err"], c["ok"],
                   time_ms(lambda: ops.mx_flash_attention(q, k, v, fmt,
                                                          spec), 10, flush),
                   time_ms(lambda: ref.mx_flash_attention_ref(q, k, v, fmt,
                                                              spec), 3,
                           flush),
                   lib, flash_bound(BH, 1, T, T, d, dv, spec, q.device),
                   near_tie_rows=c["ties"], sdpa_backend=backend)
            del c
            c = flash_bwd_case(q, k, v, dout, fmt, spec)
            args, want, bounds = c["args"], c["want"], c["bounds"]
            control_ok, control = flash_bwd_check(
                flash_bwd_dense(*args[:7])[0], want, bounds)
            if not control_ok:
                raise AssertionError(f"flash dgrad {label} {mode}: "
                                     "fault-free control fails the check "
                                     f"(worst {control})")
            if fmt is not None:
                for fault in MLA_FLASH_FAULTS:
                    accepted, w_ = flash_bwd_check(
                        flash_bwd_dense(*args[:7], fault)[0], want, bounds)
                    print(f"[controls] flash dgrad {label}: {fault!r} worst "
                          f"err/tol {w_:.2f} ("
                          f"{'ACCEPTED' if accepted else 'rejected'})",
                          flush=True)
                    if accepted:
                        raise AssertionError(
                            f"flash dgrad {label}: the check accepts the "
                            f"planted fault {fault!r}")
            lib = None
            if fmt is None:
                qs, ks, vs = (t.detach().requires_grad_(True)
                              for t in (q[:, 0], k, v))
                call, backend = sdpa_any(qs, ks, vs)
                if call is not None:
                    o = call()
                    lib = time_ms(lambda: torch.autograd.grad(
                        o, (qs, ks, vs), dout, retain_graph=True), 10, flush)
                    del o
            record("mx_flash_attention_bwd",
                   f"mla {label} BH{BH} G1 T{T} d{d} dv{dv} causal {mode} "
                   f"(worst err/tol {c['worst']:.3f}, control "
                   f"{control:.3f}, replay equal {c['replay']})", False,
                   c["err"], c["ok"],
                   time_ms(lambda: ops.mx_flash_attention_bwd(*args), 10,
                           flush),
                   time_ms(lambda: ref.mx_flash_attention_bwd_ref(*args), 3,
                           flush),
                   lib, bound(2 * 4 * BH * T * (d + dv) + 4 * BH * T,
                              (6 * d + 4 * dv) * n_scores),
                   sdpa_backend=backend)
            del c, args, want, bounds
        del q, k, v, dout
        torch.cuda.empty_cache()


# Edges of the flash dgrad kernel beside the training shape: (label, BH, G,
# Tq, Tk, d, AttnSpec arguments).  T 300 is ragged against the kernel's
# 64-row tiles; d 128 takes its 32-row blocks.
FLASH_BWD_EDGES = (
    ("ragged T 300", 16, 1, 300, 300, 64, {}),
    ("G 2", 16, 2, 512, 512, 64, {}),
    ("window 128 with q_offset 64", 16, 2, 256, 320, 64,
     dict(kind="window", window=128, q_offset=64)),
    ("full mask", 16, 1, 300, 200, 64, dict(kind="full")),
    ("d 128", 16, 1, 256, 256, 128, {}))


def flash_bwd_case(q, k, v, dout, fmt, spec, mode="floor"):
    """The flash dgrad kernel on one case: its fp32 grads against the plain
    version (flash_bwd_check, the dense fp64 bounds), its bf16 grads
    against the fp32 ones rounded once, and a second call for equal bits.
    Returns a dict: ok, worst, err, replay, args, want, bounds."""
    import torch
    from repro_torch.kernels import ops, ref
    out, lse = ops.mx_flash_attention(q, k, v, fmt, spec, scale_mode=mode)
    args = (q, k, v, dout, out, lse, fmt, spec)

    def fn(dtype=torch.float32):
        return ops.mx_flash_attention_bwd(*args, scale_mode=mode,
                                          out_dtype=dtype)
    got, gotb = fn(), fn(torch.bfloat16)
    replay = all(torch.equal(a, b) for a, b in zip(got, fn()))
    want = ref.mx_flash_attention_bwd_ref(*args, scale_mode=mode,
                                          out_dtype=torch.float32)
    _, bounds = flash_bwd_dense(q, k, v, dout, out, lse, fmt,
                                scale_mode=mode, spec=spec)
    ok, worst = flash_bwd_check(got, want, bounds)
    # the bf16 grads are the fp32 ones rounded once
    rounded = all(torch.equal(b, g.to(torch.bfloat16))
                  for b, g in zip(gotb, got))
    return {"ok": ok and rounded and replay, "worst": worst,
            "err": max((a - b).abs().max().item() for a, b in zip(got, want)),
            "replay": replay, "args": args, "want": want, "bounds": bounds,
            "got": got}


def flash_bwd_fp64_case(q, k, v, dout, fmt, spec, mode):
    """The flash dgrad kernel and its plain version, each held against the
    fp64 dense grads (flash_bwd_check's measure), for inputs whose logits
    reach a few hundred: there the scores' fp32 rounding alone can put the
    plain version itself outside FLASH_BWD_EPS of fp64, so the kernel must
    stay within twice the plain version's reading (or within
    FLASH_BWD_EPS), call twice for equal bits, and "P and dS as one bf16
    piece" must exceed that limit.  Returns (ok, kernel worst, plain
    worst, planted worst, replay)."""
    import torch
    from repro_torch.kernels import ops, ref
    out, lse = ops.mx_flash_attention(q, k, v, fmt, spec, scale_mode=mode)
    args = (q, k, v, dout, out, lse, fmt, spec)

    def fn():
        return ops.mx_flash_attention_bwd(*args, scale_mode=mode,
                                          out_dtype=torch.float32)
    got = fn()
    replay = all(torch.equal(a, b) for a, b in zip(got, fn()))
    plain = ref.mx_flash_attention_bwd_ref(*args, scale_mode=mode,
                                           out_dtype=torch.float32)
    exact, bounds = flash_bwd_dense(*args[:7], scale_mode=mode, spec=spec)
    planted = flash_bwd_dense(*args[:7], FLASH_BWD_FAULTS[-1],
                              scale_mode=mode, spec=spec)[0]
    kw, pw, fw = (flash_bwd_check(x, exact, bounds)[1]
                  for x in (got, plain, planted))
    limit = max(1.0, 2.0 * pw)
    return kw <= limit < fw and replay, kw, pw, fw, replay


def _fresh(params, device):
    """A detached copy of a parameter tree on ``device`` (new leaves)."""
    from repro_torch.models import tree_map
    return tree_map(lambda t: t.detach().to(device).clone(), params)


def _train_kernels(qcfg_name: str):
    """The kernels a training step launches under a preset."""
    if qcfg_name == "mxfp8_e4m3":
        return {"mx_quantize", "mx_matmul", "mx_matmul_dgrad",
                "mx_matmul_wgrad", "mx_flash_attention",
                "mx_flash_attention_bwd"}
    return {"mx_matmul", "mx_matmul_dgrad", "mx_flash_attention",
            "mx_flash_attention_bwd"}


# A training step's kernel time by family, from the kernels' names: the
# forward GEMM's kernels live in the namespace fwd::, the dgrad's and
# wgrad's in bwd:: (csrc/mx_gemm_sm90.cuh); the pre-pass "rows" serves x
# (forward) and dy and W (dgrad), "cols" W (forward) and x and dy (wgrad).
TRAIN_FAMILIES = (("forward GEMM small-M", "mx_fwd_small_m"),
                  ("forward GEMM pre-pass", "fwd::mx_operand"),
                  ("forward GEMM product", "fwd::mx_tn_"),
                  ("dgrad/wgrad pre-pass rows", "bwd::mx_operand_rows"),
                  ("dgrad/wgrad pre-pass cols", "bwd::mx_operand_cols"),
                  ("dgrad/wgrad product", "bwd::mx_tn_"),
                  ("flash dgrad", "mx_attn_bwd"),
                  ("flash forward", "mx_flash_fwd"),
                  ("quantize", "mx_quantize"))


def phase_train(params, cfg):
    """olmo-paper full trains 20 steps at batch 8 x 512 under mxfp8_e4m3
    and e4m3_bf16act: losses finite and falling, every kernel of the path
    launched, a profiled step's device idle share, and two 3-step replays
    from one state with bitwise equal losses.  Returns the launch counts
    of the mxfp8_e4m3 run and the per-step numbers of both."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import preset
    from repro_torch.data import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.models import lm_loss
    from repro_torch.train import Trainer, TrainerConfig

    B, T, steps = 8, 512, 20

    def trainer(name, p, total):
        return Trainer(lambda pp, b, q: lm_loss(pp, b, cfg, q),
                       _fresh(p, "cuda"), preset(name),
                       lambda s: lm_batch(s, cfg.vocab, B, T, SEED,
                                          device="cuda"),
                       tcfg=TrainerConfig(total_steps=total, peak_lr=1e-3,
                                          log_every=1))

    out = {}
    for name in ("mxfp8_e4m3", "e4m3_bf16act"):
        tr = trainer(name, params, steps)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        hist = tr.run(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        losses = [h["loss"] for h in hist]
        times = [h["time_s"] for h in hist]
        # steady-state step: median of the steps after the first
        step_s = sorted(times[1:])[len(times[1:]) // 2]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _open_window()
            t1 = time.perf_counter()
            tr.run(2)
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t1) / 2
        busy = _kernel_us(prof) / 2 / 1e6
        rows_ = [(r.key, getattr(r, "device_time_total",
                                 getattr(r, "cuda_time_total", 0.0))
                  / 2 / 1e3, r.count // 2) for r in _device_rows(prof)]
        top = [(k[:60], ms, n) for k, ms, n in
               sorted(rows_, key=lambda t: -t[1])[:10]]
        families = {}
        for key, ms, _ in rows_:
            fam = next((f for f, part in TRAIN_FAMILIES if part in key),
                       "other")
            families[fam] = families.get(fam, 0.0) + ms
        rec = {"steps": steps, "batch": B, "seq": T, "losses": losses,
               "step_ms": step_s * 1e3, "first_step_ms": times[0] * 1e3,
               "tokens_per_s": B * T / step_s, "wall_s": wall,
               "profiled_step_ms": prof_wall * 1e3,
               "kernel_ms_per_step": busy * 1e3,
               # against the unprofiled step: the profiler slows the host
               "idle_share": max(0.0, 1 - busy / step_s),
               "kernel_ms_by_family": families,
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "launches_per_step": {k: v / steps for k, v in
                                     counts.items()},
               "top_kernels_ms_per_step": top}
        print(f"[train] {name}: " + json.dumps(rec), flush=True)
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{name}: non-finite loss {losses}")
        first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
        if not last < first:
            raise AssertionError(f"{name}: loss did not fall (first 5 "
                                 f"{first}, last 5 {last})")
        idle = sorted(k for k in _train_kernels(name) if counts[k] == 0)
        if idle:
            raise AssertionError(f"{name}: kernels never launched while "
                                 f"training: {idle}")
        # Replay: two 3-step runs from the same state.
        runs = []
        for _ in range(2):
            rt = trainer(name, params, 3)
            runs.append([h["loss"] for h in rt.run(3)])
        print(f"[train] {name} replay: {runs[0]} / {runs[1]}", flush=True)
        if runs[0] != runs[1]:
            raise AssertionError(f"{name}: replayed losses differ: {runs}")
        out[name] = {"counts": counts, **rec}
    return out


# Card-against-CPU gradient limits (relative Frobenius norm per leaf) under
# mxfp8_e4m3.  The kernels sum in another order and use the card's expf,
# so an MX rounding can land on the other side of a boundary and move a
# value by a quantum; through 8 layers that reaches every gradient.  Both
# sides are deterministic.  First reading on an H100 80GB HBM3 at 700 W:
# worst layernorm leaf 0.0847 (ln1 scale), worst leaf 0.1016 (wk); the
# limits leave 2x.
GRAD_REL_LN = 0.17
GRAD_REL_ANY = 0.2


def phase_grad_parity(params, cfg):
    """One step's loss and gradients, card (kernels) against CPU (plain
    versions), same weights and batch (B 2, T 512, full width), under
    mxfp8_e4m3.  Every layernorm scale and bias gradient must be non-zero
    on the card and within GRAD_REL_LN of the CPU's."""
    import torch
    from repro_torch.core import preset
    from repro_torch.core.diagnostics import tree_leaves_with_path
    from repro_torch.data import lm_batch
    from repro_torch.models import lm_loss

    batch = lm_batch(SEED + 2, cfg.vocab, 2, 512, SEED)
    qcfg = preset("mxfp8_e4m3")
    res = {}
    for dev in ("cuda", "cpu"):
        p = _fresh(params, dev)
        leaves = list(tree_leaves_with_path(p))
        for _, t in leaves:
            t.requires_grad_(True)
        loss, _ = lm_loss(p, {k: v.to(dev) for k, v in batch.items()}, cfg,
                          qcfg)
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
        res[dev] = (loss.item(), {path: g.detach().cpu().float()
                                  for (path, _), g in zip(leaves, grads)})
    (lc, gc), (lp, gp) = res["cuda"], res["cpu"]
    rel, worst = {}, {}
    for path, g in gp.items():
        r = (torch.linalg.norm(gc[path] - g)
             / torch.clamp(torch.linalg.norm(g), min=1e-30)).item()
        rel[path] = r
        key = "/".join(str(x) for x in path if not isinstance(x, int))
        worst[key] = max(worst.get(key, 0.0), r)
    ln = {path: r for path, r in rel.items()
          if path[-2] in ("ln1", "ln2", "final_ln")}
    zero = [path for path in ln if not bool(gc[path].abs().max() > 0)]
    bad = [p for p, r in ln.items() if r > GRAD_REL_LN]
    bad_any = [p for p, r in rel.items() if r > GRAD_REL_ANY]
    out = {"loss_cuda": lc, "loss_cpu": lp, "ln_leaves": len(ln),
           "ln_rel_max": max(ln.values()), "rel_max": max(rel.values()),
           "worst_by_leaf": worst}
    ok = not zero and not bad and not bad_any
    print(f"[grad-parity] {'ok  ' if ok else 'FAIL'} mxfp8_e4m3 "
          + json.dumps(out), flush=True)
    if zero:
        raise AssertionError(f"zero layernorm gradients on the card: {zero}")
    if bad or bad_any:
        raise AssertionError(f"card and CPU gradients disagree: "
                             f"{bad + bad_any}")
    return out


def phase_recovery(params, cfg):
    """The Trainer on the card with ckpt_every=5 and a batch poisoned at
    step 12, once per intervention: it must roll back to step 10, apply
    the intervention, and finish the 20 steps with finite losses.  After
    ``bf16_activations`` no quantize kernel launches; after
    ``bump_exponent`` (the paper's Fig. 7 scale bump: scale_mode "bump")
    the quantize, GEMM and attention kernels still launch, now under the
    bump rule."""
    import shutil
    import torch
    from repro_torch.convert import lm_checkpoint_layout
    from repro_torch.core import apply_intervention, preset
    from repro_torch.data import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.models import lm_loss
    from repro_torch.train import Trainer, TrainerConfig

    ckdir = ROOT / "build" / "chip_smoke_ckpt"
    start = preset("mxfp8_e4m3")
    outs = {}
    for intervention in ("bf16_activations", "bump_exponent"):
        shutil.rmtree(ckdir, ignore_errors=True)
        armed = {"spike": True}

        def batch_fn(step):
            b = lm_batch(step, cfg.vocab, 2, 512, SEED, device="cuda")
            hit = step == 12 and armed.pop("spike", False)
            b["poison"] = torch.tensor(1e6 if hit else 1.0, device="cuda")
            return b

        def loss_fn(p, b, q):
            loss, m = lm_loss(p, {"tokens": b["tokens"],
                                  "labels": b["labels"]}, cfg, q)
            return loss * b["poison"], m

        tr = Trainer(loss_fn, _fresh(params, "cuda"), start, batch_fn,
                     tcfg=TrainerConfig(total_steps=20, ckpt_dir=str(ckdir),
                                        ckpt_every=5, peak_lr=1e-3,
                                        spike_factor=5.0,
                                        auto_intervention=intervention),
                     ckpt_layout=lm_checkpoint_layout(cfg, "cuda"))
        ops.reset_launches()
        tr.run(1)
        before = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        tr.run(19)
        wall = time.perf_counter() - t0
        ops.reset_launches()
        tr.run(1)
        after = dict(ops.LAUNCHES)
        shutil.rmtree(ckdir, ignore_errors=True)
        recs = tr.events.of_kind("recovery")
        losses = [h["loss"] for h in tr.history]
        out = {"intervention": intervention, "recoveries": recs,
               "final_step": tr.step, "qcfg": tr.qcfg.describe(),
               "scale_mode": tr.qcfg.scale_mode,
               "launches_per_step_before": before,
               "launches_per_step_after": after, "wall_s": wall,
               "losses": losses}
        print("[recovery] " + json.dumps(out), flush=True)
        want = apply_intervention(start, intervention)
        if not (len(recs) == 1 and recs[0]["rolled_back"]
                and recs[0]["step"] == 10
                and "spike@step12" in recs[0]["reason"]
                and tr.qcfg == want and tr.step == 21
                and all(math.isfinite(x) for x in losses)):
            raise AssertionError(f"recovery did not roll back to step 10 "
                                 f"and apply {intervention}: {out}")
        if intervention == "bf16_activations":
            if before["mx_quantize"] == 0 or after["mx_quantize"] != 0:
                raise AssertionError(
                    f"quantize launches per step {before['mx_quantize']} "
                    f"before and {after['mx_quantize']} after the "
                    "intervention")
        else:
            idle = sorted(k for k in _train_kernels("mxfp8_e4m3")
                          if after[k] == 0)
            if tr.qcfg.scale_mode != "bump" or idle:
                raise AssertionError(f"after bump_exponent: scale_mode "
                                     f"{tr.qcfg.scale_mode!r}, kernels not "
                                     f"launched {idle}")
        outs[intervention] = out
    return outs


# [guard]: the Trainer's online guard at full width.
GUARD_PRESET = "mxfp8_e4m3"
GUARD_STEPS = 80
PROBE_REL = 1e-4    # ζ: the Trainer's probe against this phase's
PROBE_ABS = 1e-4    # cosine: same gradients, other fp32 sum order


def _guard_trainer(params, cfg, guard, *, probe=5, inject=True,
                   ckpt_dir=None, ckpt_every=200, spike_factor=8.0,
                   snaps=None, dev="cuda"):
    """olmo-paper full at [train]'s batch (8 x 512) under GUARD_PRESET,
    with the port's copy of the reference's instability injector (the
    loss amplified 1.6x a step on steps 20-39 while activations are
    quantized), no auto intervention and 2 recoveries at most, as the
    reference's autopilot scenario.  ``snaps`` collects (step, launch
    counts) as each step starts."""
    from repro_torch.convert import lm_checkpoint_layout
    from repro_torch.core import preset
    from repro_torch.data import lm_batch
    from repro_torch.guard.scenario import inject_instability
    from repro_torch.kernels import ops
    from repro_torch.models import lm_loss
    from repro_torch.train import Trainer, TrainerConfig

    def base(p, b, q):
        return lm_loss(p, {"tokens": b["tokens"], "labels": b["labels"]},
                       cfg, q)

    def batch_fn(s):
        if snaps is not None:
            snaps.append((s, dict(ops.LAUNCHES)))
        b = lm_batch(s, cfg.vocab, 8, 512, SEED, device=dev)
        b["step"] = s
        return b
    tcfg = TrainerConfig(total_steps=GUARD_STEPS, peak_lr=1e-3, log_every=1,
                         spike_factor=spike_factor, auto_intervention=None,
                         max_recoveries=2, guard=guard,
                         guard_probe_every=probe, ckpt_dir=ckpt_dir,
                         ckpt_every=ckpt_every)
    return Trainer(inject_instability(base) if inject else base,
                   _fresh(params, dev), preset(GUARD_PRESET), batch_fn,
                   tcfg=tcfg, ckpt_layout=lm_checkpoint_layout(cfg, dev))


def _step_launches(snaps, final):
    """{step: {kernel: launches in that step}} from the counts at each
    step's start and after the last one."""
    seq = list(snaps) + [(None, final)]
    return {s: {k: b[k] - a[k] for k in b}
            for (s, a), (_, b) in zip(seq, seq[1:])}


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _paired_ms(tr_a, tr_b, dev, rounds: int = 6, block: int = 6):
    """Median ms/step of two trainers in alternating blocks, so drift hits
    both alike (benchmarks/guard_autopilot.py's _paired_us)."""
    tr_a.run(3)
    tr_b.run(3)
    ta, tb = [], []
    for _ in range(rounds):
        for tr, out in ((tr_a, ta), (tr_b, tb)):
            _sync(dev)
            t0 = time.perf_counter()
            tr.run(block)
            _sync(dev)
            out.append((time.perf_counter() - t0) / block * 1e3)
    return _median(ta), _median(tb)


def _guard_probe_check(params, cfg, dev):
    """The Trainer's ζ and cosine on probe step 0 against :func:`zeta_bound`
    of MX and fp32 gradients taken here, on the same weights and batch
    (and against the same pair in fp64).  The Trainer's probe reads both
    gradients in the reference's stacked layout and this check reads
    them per layer, so only the fp32 sums' order differs: held to
    PROBE_REL relative (ζ) and PROBE_ABS absolute (cosine)."""
    import torch
    from repro_torch.core import zeta_bound
    from repro_torch.core.diagnostics import tree_leaves_with_path
    from repro_torch.data import lm_batch
    from repro_torch.guard.scenario import trend_policy
    from repro_torch.models import lm_loss

    tr = _guard_trainer(params, cfg, trend_policy(), inject=False,
                        spike_factor=float("inf"), dev=dev)
    batch = lm_batch(0, cfg.vocab, 8, 512, SEED, device=dev)
    leaves = [t for _, t in tree_leaves_with_path(tr.params)]

    def grads(q):
        loss, _ = lm_loss(tr.params, batch, cfg, q)
        return list(torch.autograd.grad(loss, leaves))
    mx, exact = grads(tr.qcfg), grads(tr.qcfg.to_fp32())
    zb = zeta_bound(exact, mx)
    ge = torch.cat([g.reshape(-1).double() for g in exact])
    gq = torch.cat([g.reshape(-1).double() for g in mx])
    want = {"zeta": float(zb["norm_ratio"]), "cosine": float(zb["cosine"]),
            "zeta_fp64": float(torch.linalg.norm(gq - ge)
                               / torch.linalg.norm(ge)),
            "cosine_fp64": float(gq @ ge / (torch.linalg.norm(gq)
                                            * torch.linalg.norm(ge)))}
    del mx, exact, ge, gq
    tr.run(1)
    got = {"zeta": float(tr._mstate.zeta),
           "cosine": float(tr._mstate.cosine),
           "history_zeta": tr.history[0]["guard_zeta"],
           "probe_age": float(tr._mstate.probe_age)}
    ok = (got["probe_age"] == 0 and got["history_zeta"] == got["zeta"]
          and all(abs(got["zeta"] - want[k]) <= PROBE_REL * want[k]
                  for k in ("zeta", "zeta_fp64"))
          and all(abs(got["cosine"] - want[k]) <= PROBE_ABS
                  for k in ("cosine", "cosine_fp64")))
    return {"trainer": got, "here": want, "rel_tol": PROBE_REL,
            "abs_tol": PROBE_ABS, "ok": ok}


def phase_guard(params, cfg, train, dev: str = "cuda"):
    """The precision autopilot on the card, as the reference's acceptance
    scenario (tests/test_guard.py, benchmarks/guard_autopilot.py) at
    olmo-paper's full width: the fixed scheme exhausts its recoveries; the
    trend policy with a probe every 5 steps escalates before the watchdog,
    de-escalates and completes; its ζ and cosine on a probe step equal
    zeta_bound of MX and fp32 gradients taken in the phase on the same
    weights and batch; the journaled schedule replays it bitwise;
    launches per step match each rung ([train]'s per-step counts, plus one
    flash forward and dgrad a layer on probe steps); a mid-escalation
    checkpoint resumes the controller and trains on bitwise; the journal
    survives JSONL.  Times a ζ-probe step against a plain one, the
    monitors' overhead with the probe off (<= MONITOR_OVERHEAD_MAX) and
    the de-escalated against the pre-escalation step (<=
    DEESCALATE_RECOVERY_MAX).  Returns the numbers, the autopilot's
    launch counts and its trainer."""
    import shutil
    import warnings
    import torch
    from repro_torch.core import preset
    from repro_torch.guard import scheduled_policy
    from repro_torch.guard.scenario import (DEESCALATE_RECOVERY_MAX,
                                            MONITOR_OVERHEAD_MAX,
                                            trend_policy)
    from repro_torch.kernels import ops
    from repro_torch.runtime import Journal

    base = preset(GUARD_PRESET)
    L = cfg.n_layers
    ckdir = ROOT / "build" / "chip_smoke_guard_ckpt"
    out = {"preset": GUARD_PRESET, "steps": GUARD_STEPS}

    # 1. the fixed scheme: spike, rollback, the same spike, exhausted
    shutil.rmtree(ckdir, ignore_errors=True)
    fixed = _guard_trainer(params, cfg, None, ckpt_dir=str(ckdir),
                           ckpt_every=10, dev=dev)
    t0 = time.perf_counter()
    fixed.run(GUARD_STEPS)
    recs = fixed.events.of_kind("recovery")
    out["fixed"] = {"last_event": fixed.events[-1]["event"],
                    "final_step": fixed.step, "wall_s":
                    time.perf_counter() - t0,
                    "recoveries": [(r["step"], r["reason"]) for r in recs]}
    print("[guard] fixed " + json.dumps(out["fixed"]), flush=True)
    if not (fixed.events[-1]["event"] == "recovery_exhausted"
            and len(recs) == 2 and fixed.step < GUARD_STEPS):
        raise AssertionError(f"the fixed scheme did not exhaust its "
                             f"recoveries: {out['fixed']}")
    first_spike = int(recs[0]["reason"].split("@step")[1].split(":")[0])
    del fixed
    shutil.rmtree(ckdir, ignore_errors=True)

    # 1b. the ζ probe: the Trainer's channels against gradients taken here
    out["probe"] = _guard_probe_check(params, cfg, dev)
    print("[guard] probe " + json.dumps(out["probe"]), flush=True)
    if not out["probe"]["ok"]:
        raise AssertionError(f"the Trainer's ζ probe disagrees with "
                             f"zeta_bound of the same gradients: "
                             f"{out['probe']}")

    # 2. the autopilot, launches counted per step
    snaps = []
    auto = _guard_trainer(params, cfg, trend_policy(), snaps=snaps, dev=dev)
    _sync(dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    hist = auto.run(GUARD_STEPS)
    _sync(dev)
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    per_step = _step_launches(snaps, counts)
    journal = auto._controller.journal
    events = [e["event"] for e in auto.events]
    trans = [(t["step"], t["kind"], t["to_level"]) for t in journal]
    out["autopilot"] = {
        "transitions": trans, "wall_s": wall, "final_level":
        auto._controller.level, "first_spike_without_guard": first_spike,
        "max_memory_allocated": torch.cuda.max_memory_allocated()
        if dev == "cuda" else None,
        "losses": [h["loss"] for h in hist],
        "zeta": {h["step"]: h["guard_zeta"] for h in hist
                 if h["step"] % 5 == 0},
        "launches": counts}
    print("[guard] autopilot " + json.dumps(out["autopilot"]), flush=True)
    kinds = [k for _, k, _ in trans]
    if not ("recovery" not in events and "recovery_exhausted" not in events
            and len(hist) == GUARD_STEPS and "escalate" in kinds
            and "deescalate" in kinds and trans[0][1] == "escalate"
            and trans[0][0] <= first_spike
            and auto.qcfg == base and auto._controller.level == 0):
        raise AssertionError(f"the autopilot did not escalate before the "
                             f"watchdog (step {first_spike}), de-escalate "
                             f"and finish: {trans}, events {events}")
    if not all(math.isfinite(x) for x in out["autopilot"]["losses"]):
        raise AssertionError("the autopilot's losses are not finite")
    idle = sorted(k for k in _train_kernels(GUARD_PRESET) if counts[k] == 0)
    if idle:
        raise AssertionError(f"kernels never launched by the guarded "
                             f"run: {idle}")

    # launches per step against each rung
    sched = auto._controller.schedule()

    def level_at(s):
        lv = 0
        for step, to in sched:
            if step <= s:
                lv = to
        return lv
    rungs = {}
    for s, c in per_step.items():
        if s % 5 and s > 0:
            rungs.setdefault(level_at(s), []).append(c)
    want = {0: train["mxfp8_e4m3"]["launches_per_step"],
            1: train["e4m3_bf16act"]["launches_per_step"]}
    rung_counts = {}
    for lv, cs in rungs.items():
        if any(c != cs[0] for c in cs):
            raise AssertionError(f"level {lv}: launches differ between "
                                 f"plain steps: {cs}")
        rung_counts[lv] = cs[0]
        if lv in want and any(cs[0][k] != want[lv][k] for k in cs[0]):
            raise AssertionError(f"level {lv}: launches per step "
                                 f"{cs[0]}, [train] {want[lv]}")
    if rung_counts[1]["mx_quantize"] or rung_counts[1]["mx_matmul_wgrad"] \
            or not rung_counts[0]["mx_quantize"]:
        raise AssertionError(f"bf16_activations did not stop the "
                             f"activation quantizes: {rung_counts}")
    extra = {}
    for s, c in per_step.items():
        if s % 5 == 0:
            d = {k: c[k] - rung_counts[level_at(s)][k] for k in c}
            extra[s] = {k: v for k, v in d.items() if v}
            if d["mx_flash_attention"] != L or \
                    d["mx_flash_attention_bwd"] != L or \
                    any(v for k, v in d.items() if k not in (
                        "mx_flash_attention", "mx_flash_attention_bwd")):
                raise AssertionError(f"probe step {s} launched {d} more "
                                     f"than a plain step")
    out["launches_per_step_by_level"] = rung_counts
    out["probe_step_extra_launches"] = extra[0]
    print("[guard] launches per step by level " + json.dumps(rung_counts)
          + " probe step extra " + json.dumps(extra[0]), flush=True)

    # timings: probe step, pre-escalation and de-escalated plain steps
    t_ms = {h["step"]: h["time_s"] * 1e3 for h in hist}
    esc = trans[0][0]
    de = next(s for s, k, _ in trans if k == "deescalate")
    pre = [t_ms[s] for s in range(1, esc) if s % 5]
    probe = [t_ms[s] for s in range(5, esc, 5)]
    post = [t_ms[s] for s in range(de + 1, GUARD_STEPS) if s % 5]
    timing = {"plain_step_ms": _median(pre),
              "probe_step_ms": _median(probe),
              "probe_steps_ms": probe,
              "deescalated_step_ms": _median(post)}
    timing["probe_over_plain"] = timing["probe_step_ms"] / \
        timing["plain_step_ms"]
    timing["deescalated_over_pre"] = timing["deescalated_step_ms"] / \
        timing["plain_step_ms"]
    plain_tr = _guard_trainer(params, cfg, None, inject=False,
                              spike_factor=float("inf"), dev=dev)
    mon_tr = _guard_trainer(params, cfg, "conservative", probe=0,
                            inject=False, spike_factor=float("inf"),
                            dev=dev)
    ms_plain, ms_mon = _paired_ms(plain_tr, mon_tr, dev)
    del plain_tr, mon_tr
    timing.update(paired_plain_ms=ms_plain, paired_monitored_ms=ms_mon,
                  monitor_overhead=ms_mon / ms_plain - 1.0)
    out["timing"] = timing
    print("[guard] timing " + json.dumps(timing), flush=True)
    if timing["monitor_overhead"] > MONITOR_OVERHEAD_MAX:
        raise AssertionError(f"monitor overhead {timing['monitor_overhead']}"
                             f" above {MONITOR_OVERHEAD_MAX}")
    if timing["deescalated_over_pre"] > DEESCALATE_RECOVERY_MAX:
        raise AssertionError(f"de-escalated step "
                             f"{timing['deescalated_over_pre']}x the "
                             f"pre-escalation step, above "
                             f"{DEESCALATE_RECOVERY_MAX}")

    # 3. bitwise replay of the journaled schedule
    replay = _guard_trainer(params, cfg, scheduled_policy(
        sched, ladder=auto._controller.policy.ladder), dev=dev)
    h2 = replay.run(GUARD_STEPS)
    same = [r["loss"] for r in h2] == [r["loss"] for r in hist]
    rj = [(t["step"], t["to_level"]) for t in replay._controller.journal]
    out["replay"] = {"bitwise": same, "journal": rj}
    print("[guard] replay " + json.dumps(out["replay"]), flush=True)
    if not same or rj != [(t["step"], t["to_level"]) for t in journal] \
            or replay.qcfg != auto.qcfg:
        raise AssertionError(f"the journaled schedule did not replay the "
                             f"run bitwise: {out['replay']}")
    del replay

    # 4. the journal through JSONL
    path = str(ROOT / "build" / "chip_smoke_guard_journal.jsonl")
    ok_j = Journal.from_jsonl(journal.to_jsonl(path)) == journal
    ok_e = Journal.from_jsonl(auto.events.to_jsonl(path)) == auto.events
    if not (ok_j and ok_e):
        raise AssertionError("the guard journal did not survive JSONL")

    # 5. a checkpoint mid-escalation resumes the controller
    shutil.rmtree(ckdir, ignore_errors=True)
    r1 = _guard_trainer(params, cfg, trend_policy(), ckpt_dir=str(ckdir),
                        ckpt_every=30, dev=dev)
    r1.run(30)
    r1._ckptr.wait()
    r2 = _guard_trainer(params, cfg, trend_policy(), ckpt_dir=str(ckdir),
                        ckpt_every=10 ** 6, dev=dev)
    with warnings.catch_warnings():
        # the restore warns that it adopts the checkpoint's qcfg
        warnings.simplefilter("ignore", UserWarning)
        restored = r2.restore()
    h3 = r2.run(3)
    resume = {"restored": restored, "step": r2.step - 3,
              "level": r2._controller.level,
              "journal_equal": r2._controller.journal == r1._controller.journal,
              "guard_restored": len(r2.events.of_kind("guard_restored")),
              "losses_bitwise": [h["loss"] for h in h3]
              == [h["loss"] for h in hist[30:33]]}
    out["resume"] = resume
    print("[guard] resume " + json.dumps(resume), flush=True)
    shutil.rmtree(ckdir, ignore_errors=True)
    if not (restored and resume["step"] == 30 and resume["level"] ==
            r1._controller.level > 0 and resume["journal_equal"]
            and resume["guard_restored"] == 1 and r2.qcfg == r1.qcfg
            and resume["losses_bitwise"]):
        raise AssertionError(f"the mid-escalation resume failed: {resume}")
    del r1, r2
    return out, counts, auto


def _greedy(engine, prompts, n_new: int = 16):
    """Tokens of each prompt: greedy, and for the last two also sampled
    (temperature 0.8, top-k 50, a seed each), so a logit that moves can
    show even where the greedy argmax does not."""
    from repro_torch.serve import SamplingParams
    sps = [SamplingParams(max_new_tokens=n_new) for _ in prompts] + [
        SamplingParams(temperature=0.8, top_k=50, max_new_tokens=n_new,
                       seed=i) for i in range(2)]
    rids = [engine.submit(p, sp)
            for p, sp in zip(list(prompts) + list(prompts[-2:]), sps)]
    done = {r.rid: r for r in engine.drain()}
    return [list(done[r].tokens) for r in rids]


def phase_snapshot(trainer, cfg, dev: str = "cuda"):
    """snapshot_to_serve from the [guard] autopilot's trainer (olmo-paper
    full after 80 steps) into a ServeEngine (4 rows x 512) and a
    PagedServeEngine (6 rows, 64 pages of 32): greedy tokens of 4 prompts
    bitwise those of engines built from a checkpoint round trip of the
    same step in the reference's files (benchmarks/runtime_unify.py's
    gate; two sampled requests too), the engines' weights bitwise equal,
    unchanged after 3 more training steps; no engine tensor shares
    storage with a trainer tensor.  Prints each snapshot's ms and peak
    memory.  Returns the numbers and the launch counts of the phase."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.convert import lm_checkpoint_layout
    from repro_torch.core.diagnostics import tree_leaves_with_path
    from repro_torch.kernels import ops
    from repro_torch.runtime import snapshot_to_serve
    from repro_torch.serve import PagedServeEngine, ServeEngine
    from repro_torch.train import restore, save

    rng = np.random.default_rng(SEED + 5)
    prompts = [rng.integers(1, cfg.vocab, size=n).astype(np.int32)
               for n in (40, 100, 300, 64)]
    kinds = {"slab": dict(max_batch=4, max_len=512),
             "paged": dict(max_batch=6, max_len=512, n_pages=64,
                           page_size=32)}
    ckdir = ROOT / "build" / "chip_smoke_snapshot_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    to_ref, from_ref = lm_checkpoint_layout(cfg, dev)
    template = to_ref({"params": trainer.params, "opt": trainer.opt_state})
    t0 = time.perf_counter()
    save(str(ckdir), trainer.step, template, {})
    tree, _, _ = restore(str(ckdir), template, trainer.step)
    ck_params = from_ref(tree)["params"]
    ckpt_s = time.perf_counter() - t0
    shutil.rmtree(ckdir, ignore_errors=True)
    trainer_ptrs = {t.untyped_storage().data_ptr()
                    for _, t in tree_leaves_with_path(trainer.params)}
    out, engines = {"step": trainer.step, "ckpt_round_trip_s": ckpt_s}, {}
    ops.reset_launches()
    for kind, kw in kinds.items():
        _sync(dev)
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        eng = snapshot_to_serve(trainer, cfg, paged=kind == "paged", **kw)
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - before \
            if dev == "cuda" else None
        shared = trainer_ptrs & {t.untyped_storage().data_ptr()
                                 for _, t in tree_leaves_with_path(
                                     eng.params)}
        live = _greedy(eng, prompts)
        cls = PagedServeEngine if kind == "paged" else ServeEngine
        ck_eng = cls(ck_params, cfg, trainer.qcfg, device=dev, **kw)
        ck = _greedy(ck_eng, prompts)
        ck_w = dict(tree_leaves_with_path(ck_eng.params))
        same_w = all(torch.equal(t, ck_w[p])
                     for p, t in tree_leaves_with_path(eng.params))
        engines[kind] = (eng, live)
        out[kind] = {"snapshot_ms": ms, "peak_bytes_over_trainer": peak,
                     "shared_storages": len(shared),
                     "weights_bitwise_ckpt": same_w,
                     "tokens_bitwise_ckpt": live == ck, "tokens": live}
        if shared or live != ck or not same_w:
            raise AssertionError(f"{kind} snapshot: {len(shared)} shared "
                                 f"storages, weights equal {same_w}, "
                                 f"tokens {live} against the checkpoint's "
                                 f"{ck}")
    counts = dict(ops.LAUNCHES)
    trainer.run(3)
    for kind, (eng, live) in engines.items():
        after = _greedy(eng, prompts)
        out[kind]["tokens_unchanged_after_3_steps"] = after == live
        if after != live:
            raise AssertionError(f"{kind} snapshot's tokens moved after "
                                 f"trainer.run(3): {after} / {live}")
    recs = trainer.events.of_kind("snapshot_to_serve")
    out["journal"] = recs[-2:]
    out["launches"] = counts
    print("[snapshot] " + json.dumps(out), flush=True)
    idle = sorted(k for k in ("mx_quantize", "mx_matmul",
                              "mx_flash_attention", "mx_attention_decode",
                              "mx_attention_decode_paged")
                  if counts[k] == 0)
    if idle:
        raise AssertionError(f"kernels never launched by the snapshot "
                             f"engines: {idle}")
    return out, counts


def phase_proxy():
    """The paper's student-teacher proxy at ProxyConfig() (d_model 512, 4
    layers, hidden 2048, batch 2048) under mxfp8_e4m3 for 20 steps: the
    loss falls, the layernorm scale gradients are non-zero, and every GEMM
    of the step runs through the kernels (fp32 operands, all quantized)."""
    import torch
    from repro_torch.core import preset
    from repro_torch.kernels import ops
    from repro_torch.models import (ProxyConfig, proxy_batch, proxy_init,
                                    proxy_loss, teacher_init)
    from repro_torch.train import Trainer, TrainerConfig

    pc = ProxyConfig()
    qcfg = preset("mxfp8_e4m3")
    params = proxy_init(torch.Generator().manual_seed(SEED), pc, device="cuda")
    teacher = teacher_init(torch.Generator().manual_seed(SEED + 1), pc,
                           device="cuda")
    scales = [lp["ln"]["scale"].requires_grad_(True)
              for lp in params["layers"]]
    loss, _ = proxy_loss(params, proxy_batch(0, teacher, pc, SEED), pc, qcfg)
    ln_grads = [g.abs().max().item()
                for g in torch.autograd.grad(loss, scales)]
    tr = Trainer(lambda p, b, q: proxy_loss(p, b, pc, q), params, qcfg,
                 lambda s: proxy_batch(s, teacher, pc, SEED),
                 tcfg=TrainerConfig(total_steps=20, peak_lr=1e-3,
                                    log_every=1))
    ops.reset_launches()
    hist = tr.run(20)
    counts = dict(ops.LAUNCHES)
    losses = [h["loss"] for h in hist]
    step_s = sorted(h["time_s"] for h in hist[1:])[9]
    out = {"losses": losses, "ln_scale_grad_absmax": ln_grads,
           "step_ms": step_s * 1e3, "launches": counts}
    print("[proxy] " + json.dumps(out), flush=True)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"proxy: non-finite loss {losses}")
    if not sum(losses[-5:]) < sum(losses[:5]):
        raise AssertionError("proxy: the loss did not fall")
    if not all(g > 0 for g in ln_grads):
        raise AssertionError(f"proxy: zero layernorm gradients {ln_grads}")
    idle = [k for k in ("mx_quantize", "mx_matmul", "mx_matmul_dgrad",
                        "mx_matmul_wgrad") if counts[k] == 0]
    if idle:
        raise AssertionError(f"proxy: kernels never launched: {idle}")
    return out


# ---------------------------------------------------------------------------
# [sweep] and [sweep-parity]: the paper's sweeps, lane-packed.
# ---------------------------------------------------------------------------
SWEEP_RTOL, SWEEP_ATOL = 2e-4, 1e-7   # the reference's (tests/test_sweep.py)
SWEEP_GATE = 3.0      # benchmarks/sweep_throughput.py SMOKE_SPEEDUP
SWEEP_DRIFT = 5e-2    # and its final-loss drift limit


def _sync(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _agg_no_time(agg):
    return {k: {f: v for f, v in s.items() if f != "us_per_step"}
            for k, s in agg.items()}


def phase_sweep(dev: str = "cuda", budget: str = "full"):
    """[sweep]: the fig6 preset at ``budget`` (full: 5 schemes x 8 seeds,
    500 steps, d_model 128, 4 layers, batch 256) packed into a RunDB in a
    temporary directory (its table, wall time per pack, launches per pack
    step, peak memory); a resume check on fig6 "quick" (stop_after=7, then
    a relaunch that must skip exactly 7 and reproduce the uninterrupted
    aggregates bit for bit); a fig7 pair (mxfp4_e2m1 with and without an
    fp32 switch at step 100: equal bits before it, not after); one
    advisory autopilot pack (journals non-empty where a lane spikes); one
    kind="lm" run of table1 "quick" through the Trainer (finite).  Returns
    the launch counts of the fig6 run and its readings."""
    import dataclasses
    import tempfile
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.sweep import (RunDB, aggregate, format_table,
                                   get_sweep_spec, run_sweep)
    from repro_torch.sweep.presets import fig7_base_spec, table1_spec

    cuda = torch.device(dev).type == "cuda"
    out = {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        # 1. fig6, the paper's Fig. 6 protocol, packed into a RunDB.
        spec = get_sweep_spec("fig6", budget)
        runs = spec.expand()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        _sync(dev)
        ops.reset_launches()
        t0 = time.perf_counter()
        rep = run_sweep(spec, db=str(Path(tmp) / "fig6.jsonl"), device=dev)
        _sync(dev)
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        res = list(rep)
        packs = {}
        for r in res:
            packs.setdefault(r.label, r.us_per_step * r.steps / 1e6)
        pack_steps = len(packs) * runs[0].steps
        per_step = {k: v / pack_steps for k, v in counts.items() if v}
        print(format_table(aggregate(rep)), flush=True)
        fig6 = {"budget": budget, "runs": len(res), "packs": len(packs),
                "lanes": len(res) // max(len(packs), 1),
                "steps": runs[0].steps, "wall_s": wall,
                "pack_wall_s": packs, "launches": counts,
                "launches_per_pack_step": per_step,
                "peak_memory": (torch.cuda.max_memory_allocated() if cuda
                                else None)}
        print("[sweep] fig6 " + json.dumps(fig6), flush=True)
        if rep.n_executed != len(runs) or len(res) != len(runs):
            raise AssertionError(f"fig6: {rep.n_executed} of {len(runs)} "
                                 "runs executed")
        if any(r.steps != runs[0].steps for r in res):
            raise AssertionError("fig6: a run stopped short")
        fp32 = [r for r in res if r.label == "fig6.fp32"]
        if not fp32 or any(r.divergent or not math.isfinite(r.final_loss)
                           for r in fp32):
            raise AssertionError("fig6: an fp32 run diverged")
        if cuda:
            idle = [k for k in LANE_KERNELS if counts[k] == 0]
            if idle:
                raise AssertionError(f"fig6: lane kernels never launched: "
                                     f"{idle}")
        out["fig6"] = fig6

        # 2. Resume: stop after 7 runs, relaunch, compare with a whole run.
        quick = get_sweep_spec("fig6", "quick")
        n = len(quick.expand())
        whole = run_sweep(quick, device=dev)
        db = str(Path(tmp) / "resume.jsonl")
        first = run_sweep(quick, db=db, stop_after=7, device=dev)
        second = run_sweep(quick, db=db, device=dev)
        agg_whole = _agg_no_time(aggregate(whole))
        agg_resumed = _agg_no_time(aggregate(RunDB(db)))
        same_final = sum(whole[r.run_id].final_loss == r.final_loss
                         for r in second)
        resume = {"runs": n, "first_executed": first.n_executed,
                  "first_interrupted": first.interrupted,
                  "second_skipped": second.n_skipped,
                  "second_executed": second.n_executed,
                  "aggregates_equal": agg_resumed == agg_whole,
                  "final_losses_bitwise": same_final}
        print("[sweep] resume " + json.dumps(resume), flush=True)
        if not (first.interrupted and first.n_executed == 7
                and second.n_skipped == 7 and second.n_executed == n - 7
                and agg_resumed == agg_whole):
            raise AssertionError(f"resume: {resume}")
        out["resume"] = resume

        # 3. fig7: mxfp4_e2m1 with and without an fp32 switch at step 100.
        base = fig7_base_spec("quick").expand()[0]
        switched = dataclasses.replace(base, phases=((100, "fp32"),))
        pair = run_sweep([base, switched], keep_history=True, device=dev)
        la = pair[base.run_id].history["loss"]
        lb = pair[switched.run_id].history["loss"]
        fig7 = {"scheme": base.scheme, "steps": base.steps,
                "equal_before": la[:100] == lb[:100],
                "differ_after": la[100:] != lb[100:],
                "final": [la[-1], lb[-1]],
                "diverge_step": [pair[base.run_id].diverge_step,
                                 pair[switched.run_id].diverge_step]}
        print("[sweep] fig7 " + json.dumps(fig7), flush=True)
        if not (fig7["equal_before"] and fig7["differ_after"]):
            raise AssertionError(f"fig7: {fig7}")

        # 4. One advisory autopilot pack: fig7's setting at lr 5e-3, where
        # some lanes spike, 8 seeds.
        guarded = [dataclasses.replace(base, seed=s, lr=5e-3,
                                       guard="autopilot",
                                       label="autopilot.e2m1")
                   for s in range(LANES)]
        adv = list(run_sweep(guarded, device=dev))
        auto = {"lanes": len(adv), "spiking": sum(r.spikes > 0 for r in adv),
                "journals": [len(r.guard_journal) for r in adv],
                "trigger_steps": [r.guard_trigger_step for r in adv],
                "advisory": all(r.guard_advisory for r in adv)}
        print("[sweep] autopilot " + json.dumps(auto), flush=True)
        if not auto["advisory"] or any(
                r.spikes > 0 and not r.guard_journal for r in adv):
            raise AssertionError(f"autopilot: {auto}")

        # 5. One kind="lm" run of table1 "quick" through the Trainer.
        lm = next(r for r in table1_spec("quick").expand()
                  if r.scheme == "e4m3_bf16act")
        ops.reset_launches()
        t0 = time.perf_counter()
        r_lm = run_sweep([lm], keep_history=True, device=dev)[lm.run_id]
        lm_out = {"label": r_lm.label, "steps": r_lm.steps,
                  "final_loss": r_lm.final_loss, "min_loss": r_lm.min_loss,
                  "wall_s": time.perf_counter() - t0,
                  "launches": {k: v for k, v in ops.LAUNCHES.items() if v}}
        print("[sweep] lm " + json.dumps(lm_out), flush=True)
        if r_lm.steps != lm.steps or not np.isfinite(
                r_lm.history["loss"]).all():
            raise AssertionError(f"lm run: {lm_out}")
    return out


COUNT_READINGS = 3       # readings of each launch count (its largest kept)


def _profile_kernels(fn):
    """(device kernels of one ``fn()`` call by name, their device ms, the
    call's wall ms) from a profiler window opened on an idle card
    (``_open_window``), with PROFILE_MARGIN_S idle seconds after the
    call too."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _open_window()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_MARGIN_S)
    return ({r.key: r.count for r in _device_rows(prof)},
            _kernel_us(prof) / 1e3, wall)


def sweep_launch_counts() -> dict:
    """Launches of one step of fig6's mxfp4_e2m1 pack at LANES lanes and
    at 1, and of its batch draw alone, each from COUNT_READINGS profiler
    windows (``_profile_kernels``), on consecutive steps: by lane count,
    [kernels of the step, our launches in it (ops.LAUNCHES), kernels of
    the draw, the step's kernel ms, its wall ms, every reading of the
    step's and the draw's kernels].  A profiler window can lose records
    and never adds one, so each count is its largest reading; every
    reading is printed.  For [sweep-parity], which runs it in a fresh
    process (``run_fresh``): late in this script's long run the profiler
    loses more (a one-lane draw of 27 kernels has read 0-21)."""
    import dataclasses
    from repro_torch.kernels import ops
    from repro_torch.models import proxy_batch
    from repro_torch.sweep import ProxyPack, get_sweep_spec
    mx = [r for r in get_sweep_spec("fig6", "full").expand()
          if r.scheme == "mxfp4_e2m1"]
    counts = {}
    for lanes in (LANES, 1):
        pack = ProxyPack([dataclasses.replace(r, steps=50)
                          for r in mx[:lanes]], "cuda")
        for s in range(2):
            pack.step(s, pack.qcfg0)
        steps, draws, ours, busy, wall = [], [], [], [], []
        for s in range(2, 2 + COUNT_READINGS):
            ops.reset_launches()
            step_k, b, w = _profile_kernels(lambda: pack.step(s, pack.qcfg0))
            ours.append({k: v for k, v in ops.LAUNCHES.items() if v})
            draw_k = _profile_kernels(lambda: proxy_batch(
                s, pack.teachers, pack.cfg, pack.seeds))[0]
            steps.append(sum(step_k.values()))
            draws.append(sum(draw_k.values()))
            busy.append(b)
            wall.append(w)
        if any(o != ours[0] for o in ours):
            raise AssertionError(f"our launches differ between steps at "
                                 f"{lanes} lanes: {ours}")
        i = steps.index(max(steps))
        counts[lanes] = (steps[i], ours[0], max(draws), busy[i], wall[i],
                         {"step": steps, "draw": draws})
    return counts


def run_fresh(name: str):
    """``name()`` of this script run in a fresh Python process on the same
    card (the kernels already built are loaded), its result through JSON
    (int keys come back as strings)."""
    code = ("import json, sys; sys.path[:0] = [%r, %r]; import chip_smoke; "
            "print(json.dumps(chip_smoke.%s()))" % (str(ROOT / "src"),
                                                   str(ROOT), name))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    if out.returncode:
        raise AssertionError(f"{name} in a fresh process failed:\n"
                             f"{out.stdout[-2000:]}{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def _timed_sweep(runs, dev, mode, keep_params=False):
    """run_sweep(runs) with histories, and its wall time."""
    from repro_torch.sweep import run_sweep
    _sync(dev)
    t0 = time.perf_counter()
    rep = run_sweep(runs, keep_history=True, keep_params=keep_params,
                    mode=mode, device=dev)
    _sync(dev)
    return rep, time.perf_counter() - t0


def phase_sweep_parity(dev: str = "cuda", steps: int = 50,
                       proxy_steps: int = 20):
    """[sweep-parity]: the five fig6 schemes x 8 seeds, ``steps`` steps,
    packed against mode="sequential" (one-lane packs): loss and grad-norm
    histories within the reference's rtol/atol, spike flags equal, the
    lanes bitwise equal counted; kernel launches of one pack step at 8
    lanes against one lane (only the per-lane batch draws may differ, and
    are counted); the reference's own gate (8 seeds, d 64, 2 layers, batch
    128, mxfp8_e4m3, 40 steps): packed at least SWEEP_GATE times faster
    than sequential in wall time with final-loss drift under SWEEP_DRIFT;
    the same ratio at ProxyConfig() width, printed."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.diagnostics import tree_leaves_with_path as \
        tree_leaves
    from repro_torch.sweep import RunSpec, get_sweep_spec

    cuda = torch.device(dev).type == "cuda"
    runs = [dataclasses.replace(r, steps=steps)
            for r in get_sweep_spec("fig6", "full").expand()]
    packed, t_packed = _timed_sweep(runs, dev, "auto", keep_params=True)
    seq, t_seq = _timed_sweep(runs, dev, "sequential", keep_params=True)
    worst, bitwise, flags_equal = 0.0, 0, True
    same_params = sum(all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_leaves(packed[r.run_id].final_params),
        tree_leaves(seq[r.run_id].final_params))) for r in runs)
    for r in runs:
        a, b = packed[r.run_id].history, seq[r.run_id].history
        for key in ("loss", "grad_norm"):
            x, y = np.asarray(a[key]), np.asarray(b[key])
            fin = np.isfinite(y)
            if not (np.isfinite(x) == fin).all():
                worst = float("inf")
                continue
            err = np.abs(x[fin] - y[fin]) / (SWEEP_ATOL
                                             + SWEEP_RTOL * np.abs(y[fin]))
            worst = max(worst, float(err.max()) if err.size else 0.0)
        bitwise += a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
        flags_equal &= a["spike_flags"] == b["spike_flags"]
    parity = {"runs": len(runs), "steps": steps, "worst_err_over_tol": worst,
              "lanes_bitwise": bitwise, "params_bitwise": same_params,
              "spike_flags_equal": flags_equal,
              "packed_s": t_packed, "sequential_s": t_seq}
    print("[sweep-parity] " + json.dumps(parity), flush=True)
    if worst > 1.0 or not flags_equal:
        raise AssertionError(f"sweep parity: {parity}")

    # Launches of one pack step, 8 lanes against 1 (an MX scheme's pack),
    # and of its batch draw alone (each lane's x, teacher forward and
    # label noise, drawn as a one-lane run draws them), counted in a fresh
    # process (sweep_launch_counts).
    launches = None
    if cuda:
        counts = run_fresh("sweep_launch_counts")
        (k8, o8, d8, busy8, wall8, read8), (k1, o1, d1, busy1, wall1,
                                            read1) = (counts[str(LANES)],
                                                      counts["1"])
        launches = {"lanes": LANES, "kernels_per_step": k8,
                    "kernels_per_step_one_lane": k1,
                    "kernel_ms_per_step": busy8,
                    "profiled_step_ms": wall8,
                    "idle_share": 1 - busy8 / wall8,
                    "kernel_ms_per_step_one_lane": busy1,
                    "profiled_step_ms_one_lane": wall1,
                    "batch_draw_kernels": d8,
                    "batch_draw_kernels_one_lane": d1,
                    "batch_draw_kernels_per_lane": (d8 - d1) / (LANES - 1),
                    "ours_per_step": o8, "ours_equal": o8 == o1,
                    "readings": read8, "readings_one_lane": read1}
        print("[sweep-parity] launches " + json.dumps(launches), flush=True)
        # the lanes add their batch draws and nothing else
        if not o8 == o1 or k8 - k1 != d8 - d1:
            raise AssertionError(f"launches per pack step grow with the "
                                 f"lane count: {launches}")

    # The reference's gate, then the same ratio at ProxyConfig() width.
    gates = {}
    for label, kw, n_steps in (
            ("gate", dict(d_model=64, n_layers=2, batch_size=128), 40),
            ("ProxyConfig", dict(d_model=512, n_layers=4, batch_size=2048),
             proxy_steps)):
        base = RunSpec(kind="proxy", steps=n_steps, lr=1e-3,
                       scheme="mxfp8_e4m3", teacher_seed=1, **kw)
        seeds = [dataclasses.replace(base, seed=s) for s in range(LANES)]
        _timed_sweep([dataclasses.replace(base, seed=100, steps=2)], dev,
                     "auto")   # warm-up: first calls off the clock
        vec, t_vec = _timed_sweep(seeds, dev, "auto")
        sq, t_sq = _timed_sweep(seeds, dev, "sequential")
        fv = np.asarray([vec[r.run_id].final_loss for r in seeds])
        fs = np.asarray([sq[r.run_id].final_loss for r in seeds])
        drift = float(np.max(np.abs(fv - fs) / np.maximum(np.abs(fs),
                                                          1e-9)))
        gates[label] = {"lanes": LANES, "steps": n_steps, **kw,
                        "packed_s": t_vec, "sequential_s": t_sq,
                        "speedup": t_sq / t_vec, "final_loss_drift": drift}
        print(f"[sweep-parity] {label} " + json.dumps(gates[label]),
              flush=True)
    g = gates["gate"]
    if cuda and not (g["speedup"] >= SWEEP_GATE
                     and g["final_loss_drift"] < SWEEP_DRIFT):
        raise AssertionError(f"sweep gate: {g}")
    return {"parity": parity, "launches": launches, "gates": gates}


def _requests(vocab: int):
    import numpy as np
    from repro_torch.serve import SamplingParams
    rng = np.random.default_rng(SEED)
    lens = rng.integers(33, 451, size=8)
    out = []
    for i, n in enumerate(lens):
        sp = (SamplingParams(temperature=0.8, top_k=50, max_new_tokens=32,
                             seed=i) if i in (2, 5)
              else SamplingParams(max_new_tokens=32))
        out.append((rng.integers(1, vocab, size=int(n)).astype(np.int32), sp))
    return out


def phase_serve(params, cfg):
    """Serve 8 requests per preset; returns the launch counts per preset."""
    import torch
    from repro_torch.core import preset
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeEngine

    counts = {}
    for name in ("mxfp8_e4m3", "e4m3_bf16act"):
        eng = ServeEngine(params, cfg, preset(name), max_batch=4, max_len=512)
        for prompt, sp in _requests(cfg.vocab):
            eng.submit(prompt, sp)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        done = eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[name] = dict(ops.LAUNCHES)
        st = eng.stats()
        if len(done) != 8 or not all(r.done for r in done):
            raise AssertionError(f"{name}: {len(done)} of 8 requests finished")
        bad = [r.rid for r in done if len(r.tokens) != 32]
        if bad:
            raise AssertionError(f"{name}: requests {bad} stopped early")
        want = {"mx_matmul", "mx_flash_attention", "mx_attention_decode"}
        if name == "mxfp8_e4m3":
            want.add("mx_quantize")
        idle = sorted(k for k in want if counts[name][k] == 0)
        if idle:
            raise AssertionError(f"{name}: kernels never launched: {idle}")
        if name != "mxfp8_e4m3" and counts[name]["mx_quantize"]:
            raise AssertionError(f"{name}: quantize kernel launched")
        print(f"[serve] {name}: " + json.dumps({
            "requests": len(done), "wall_s": wall,
            "prefill_tok_s": st["prefill_tok_s"],
            "decode_tok_s": st["decode_tok_s"],
            "decode_steps": st["decode_steps"],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches": counts[name]}), flush=True)
    return counts


def profile_decode_step(sp, cfg, qcfg, cache, steps: int = 10,
                        pos=(100, 200, 300, 400), **paged):
    """Wall time of one batched decode step (4 rows) against the kernel
    time the profiler sees in it: the device's busy and idle share, and
    the kernels that take the most time.  ``paged`` (page_table, live)
    decodes through a page table, as the paged engine calls it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import lm_decode_step

    tok = torch.ones((4, 1), dtype=torch.long, device="cuda")
    pos = torch.tensor(pos, device="cuda")

    def run():
        for _ in range(steps):
            lm_decode_step(sp, cache, tok, pos, cfg, qcfg, **paged)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _open_window()
        run()
    busy_ms = _kernel_us(prof) / steps / 1e3
    host = cProfile.Profile()
    host.runcall(run)
    report = io.StringIO()
    pstats.Stats(host, stream=report).sort_stats("tottime").print_stats(6)
    print("[decode-step] host functions by own time over "
          f"{steps} steps:\n" + "\n".join(
              line for line in report.getvalue().splitlines()
              if line.strip() and "ncalls" not in line
              and ("{" in line or ".py" in line))[:1500], flush=True)
    top = sorted(((r.key[:60], getattr(r, "device_time_total",
                                        getattr(r, "cuda_time_total", 0.0))
                   / steps / 1e3, r.count // steps)
                  for r in _device_rows(prof)),
                 key=lambda t: -t[1])[:8]
    out = {"wall_ms": wall_ms, "kernel_ms": busy_ms,
           "idle_share": max(0.0, 1 - busy_ms / wall_ms),
           "top_kernels_ms_per_step": top}
    print(f"[decode-step] {'paged ' if paged else ''}{qcfg.describe()}: "
          f"{json.dumps(out)}", flush=True)
    return out


def launches_per_call(params, cfg):
    """Kernel launches of one prefill (bucket 64) and one decode step."""
    import torch
    from repro_torch.core import preset
    from repro_torch.kernels import ops
    from repro_torch.models import init_cache, lm_decode_step, lm_prefill
    from repro_torch.serve import serving_params

    sp = serving_params(params, "cuda")
    qcfg = preset("mxfp8_e4m3")
    with torch.inference_mode():
        toks = torch.ones((1, 64), dtype=torch.long, device="cuda")
        ops.reset_launches()
        lm_prefill(sp, toks, cfg, qcfg, 512)
        per_prefill = dict(ops.LAUNCHES)
        cache = init_cache(cfg, 4, 512, "cuda")
        ops.reset_launches()
        lm_decode_step(sp, cache, torch.ones((4, 1), dtype=torch.long,
                                             device="cuda"),
                       torch.tensor([3, 4, 5, 6], device="cuda"), cfg, qcfg)
        per_decode = dict(ops.LAUNCHES)
        step = {"mxfp8_e4m3": profile_decode_step(sp, cfg, qcfg, cache)}
        step["e4m3_bf16act"] = profile_decode_step(
            sp, cfg, preset("e4m3_bf16act"), cache)
    L = cfg.n_layers
    want = {"mx_matmul": 6 * L + 1, "mx_attention_decode": L,
            "mx_quantize": 4 * L + 2}
    for key, n in want.items():
        if per_decode[key] != n:
            raise AssertionError(f"decode step launched {key} "
                                 f"{per_decode[key]} times, expected {n}")
    print(f"[launches] per prefill {per_prefill}; per decode step "
          f"{per_decode}", flush=True)
    return per_prefill, per_decode


def phase_parity(params, cfg):
    """Card (kernels) against CPU (plain versions), same weights."""
    import numpy as np
    import torch
    from repro_torch.core import preset
    from repro_torch.models import lm_decode_step, lm_prefill, tree_map
    from repro_torch.serve import serving_params

    prompt = np.random.default_rng(SEED + 1).integers(1, cfg.vocab, 64)
    runs = {"cuda": serving_params(params, "cuda"),
            "cpu": serving_params(tree_map(lambda t: t.cpu(), params), "cpu")}
    results = {}
    for name in ("mxfp8_e4m3", "e4m3_bf16act"):
        qcfg = preset(name)
        logits = {dev: [] for dev in runs}
        caches = {}
        with torch.inference_mode():
            for dev, p in runs.items():
                lg, caches[dev] = lm_prefill(
                    p, torch.as_tensor(prompt, device=dev)[None], cfg, qcfg,
                    128)
                logits[dev].append(lg.float().cpu())
            # Teacher-forced greedy decode: both devices take the CPU's
            # greedy token, so one disagreement cannot snowball.
            for step in range(8):
                tok = int(torch.argmax(logits["cpu"][-1][0]))
                for dev, p in runs.items():
                    lg, _ = lm_decode_step(
                        p, caches[dev], torch.tensor([[tok]], device=dev),
                        torch.tensor([64 + step], device=dev), cfg, qcfg)
                    logits[dev].append(lg.float().cpu())
        a = torch.cat(logits["cuda"])
        b = torch.cat(logits["cpu"])
        rel = (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()
        err = (a - b).abs().max().item()
        agree = torch.argmax(a, -1) == torch.argmax(b, -1)
        ok = rel <= LOGIT_REL[name] and err <= LOGIT_ATOL[name]
        results[name] = {"rel_fro": rel, "max_abs_err": err,
                         "argmax_agree": int(agree.sum()),
                         "positions": int(agree.numel())}
        print(f"[parity] {'ok  ' if ok else 'FAIL'} {name} "
              f"{json.dumps(results[name])}", flush=True)
        if not ok:
            raise AssertionError(f"{name}: card and CPU logits disagree")
    return results


# Card-against-CPU logit tolerances, per preset: relative Frobenius norm
# and largest absolute difference over the 9 positions.  The kernels sum in
# another order and use the card's expf; under mxfp8_e4m3 an MX rounding
# that lands on the other side of a rounding boundary moves a value by a
# whole quantum, and that spreads through the layers.  Both sides are
# deterministic, so a reading repeats while the code stands.  Readings on
# an H100 80GB HBM3 at 700 W: rel 0.0564 / 0.0081 and max abs 0.258 /
# 0.039 (mxfp8_e4m3 / e4m3_bf16act); the limits leave about 1.5x.  Where
# every logit is within LOGIT_ATOL, greedy tokens agree wherever the top-1
# / top-2 margin exceeds 2 * LOGIT_ATOL, so no separate margin rule.
LOGIT_REL = {"mxfp8_e4m3": 0.08, "e4m3_bf16act": 0.012}
LOGIT_ATOL = {"mxfp8_e4m3": 0.375, "e4m3_bf16act": 0.0625}


# The paged engine's geometry on the bursty trace (the JAX package's
# benchmarks/serve_throughput.py): pages of 32, rows of 256 positions.
PAGE_SIZE = 32
PAGED_MAX_LEN = 256
# Chunked against whole lm_prefill logits, largest absolute difference over
# the 4 parity prompts, per preset.  The GEMM kernels split K by a count
# that depends on M, and a 64-row chunk is another M than a whole prompt,
# so the two sum in another order; under mxfp8_e4m3 a rounding flip of an
# MX value then moves a logit by a quantum.  Both are deterministic.  The
# limits are 2x the first reading on an H100 80GB HBM3 at 700 W (0.171875
# and 0.03515625).
CHUNK_ATOL = {"mxfp8_e4m3": 0.34375, "e4m3_bf16act": 0.0703125}


def fill_pages(sp, cfg, qcfg, prompts, n_pages: int, dev):
    """Chunked prefill of ``prompts`` into fresh page pools, as the paged
    engine runs it (chunks of 2 pages, ``lm_prefill_chunk`` then
    ``write_chunk_pages`` with at-rest quantization), each row on pages
    drawn from a permutation of the pool.  Returns (pools, page table
    (B, P) int32, the last chunk's logits (B, vocab))."""
    import numpy as np
    import torch
    from repro_torch.models import init_cache_paged, lm_prefill_chunk
    from repro_torch.serve.pages import gather_prior, write_chunk_pages

    ps, C = PAGE_SIZE, 2 * PAGE_SIZE
    P = PAGED_MAX_LEN // ps
    cache = init_cache_paged(cfg, n_pages, ps, dev)
    pools = [lc[n] for lc in cache for n in ("k", "v")]
    fmt = qcfg.a_fwd if qcfg.attn else None
    perm = iter(np.random.default_rng(SEED).permutation(n_pages).tolist())
    pt = np.full((len(prompts), P), -1, np.int32)
    logits = []
    for b, prompt in enumerate(prompts):
        T = prompt.size
        pages = [next(perm) for _ in range(T // ps + 1)]
        pt[b, :len(pages)] = pages
        row = np.full(P + C // ps, n_pages, np.int32)
        row[:len(pages)] = pages
        for start in range(0, T, C):
            real = min(T - start, C)
            toks = np.zeros(C, np.int64)
            toks[:real] = prompt[start:start + real]
            prior = gather_prior(pools, row[:start // ps])
            lg, chunk = lm_prefill_chunk(
                sp, torch.as_tensor(toks, device=dev)[None],
                [{"k": k, "v": v} for k, v in zip(prior[::2], prior[1::2])],
                start, cfg, qcfg, torch.tensor([real - 1], device=dev),
                torch.as_tensor(np.arange(C) < real, device=dev)[None])
            write_chunk_pages(pools, [c[n] for c in chunk
                                      for n in ("k", "v")],
                              row[start // ps:(start + C) // ps],
                              max(0, min(T // ps - start // ps, C // ps)),
                              ("k", "v") * len(cache), fmt, qcfg.block,
                              qcfg.scale_mode)
        logits.append(lg)
    return cache, torch.as_tensor(pt, device=dev), torch.cat(logits)


def slab_view(cache, pt):
    """The slab cache (B, P*ps, H, d) per layer that the page table maps
    (unmapped entries read page 0, as the gather does)."""
    out = []
    for lc in cache:
        view = {}
        for n in ("k", "v"):
            pool = lc[n]
            g = pool[pt.long().clamp(0, pool.shape[0] - 1)]
            view[n] = g.reshape((pt.shape[0], -1) + pool.shape[2:]).clone()
        out.append(view)
    return out


def phase_paged_parity(params, cfg, dev: str = "cuda",
                       presets=("mxfp8_e4m3", "e4m3_bf16act")):
    """At full width: fill page pools for 4 prompts by chunked prefill, run
    one paged lm_decode_step through the page table and one slab step on
    the gathered cache (same tokens, positions and M): the logits must be
    bitwise equal and the new K/V rows must land in the mapped pages.  Also
    reads chunked against whole lm_prefill logits (CHUNK_ATOL).  Returns
    the readings per preset and the launches of one paged decode step."""
    import numpy as np
    import torch
    from repro_torch.core import preset
    from repro_torch.kernels import ops
    from repro_torch.models import lm_decode_step, lm_prefill
    from repro_torch.serve import serving_params

    sp = serving_params(params, dev)
    rng = np.random.default_rng(SEED + 3)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32)
               for n in (40, 100, 150, 230)]
    out = {}
    with torch.inference_mode():
        for name in presets:
            qcfg = preset(name)
            cache, pt, chunked = fill_pages(sp, cfg, qcfg, prompts, 48, dev)
            whole = torch.cat([lm_prefill(
                sp, torch.as_tensor(p, dtype=torch.long, device=dev)[None],
                cfg, qcfg, PAGED_MAX_LEN)[0] for p in prompts])
            chunk_err = (chunked.float() - whole.float()).abs().max().item()
            tok = torch.argmax(chunked.float(), -1)[:, None]
            pos = torch.as_tensor([p.size for p in prompts], device=dev)
            slab = slab_view(cache, pt)
            ops.reset_launches()
            # Without ``live`` the step finds the live rows from the table.
            lp, _ = lm_decode_step(sp, cache, tok, pos, cfg, qcfg,
                                   page_table=pt)
            per_step = dict(ops.LAUNCHES)
            ls, _ = lm_decode_step(sp, slab, tok, pos, cfg, qcfg)
            same = torch.equal(lp, ls)
            landed = all(torch.equal(a[n], b[n]) for a, b in
                         zip(slab_view(cache, pt), slab) for n in ("k", "v"))
            limit = CHUNK_ATOL[name]
            ok = same and landed and chunk_err <= limit
            step = None
            if dev == "cuda":
                step = profile_decode_step(
                    sp, cfg, qcfg, cache, pos=[p.size for p in prompts],
                    page_table=pt,
                    live=torch.arange(len(prompts), device=dev))
            out[name] = {"logits_bitwise": same, "rows_landed": landed,
                         "chunked_vs_whole_max_abs": chunk_err,
                         "limit": limit,
                         "argmax_agree": int((torch.argmax(chunked, -1)
                                              == torch.argmax(whole, -1))
                                             .sum()),
                         "launches_per_paged_decode_step": per_step,
                         "decode_step": step}
            print(f"[paged-parity] {'ok  ' if ok else 'FAIL'} {name} "
                  + json.dumps(out[name]), flush=True)
            if not ok:
                raise AssertionError(f"{name}: paged and slab decode "
                                     f"disagree: {out[name]}")
    return out


def bursty_trace(vocab: int, n_req: int = 32):
    """The JAX package's bursty trace (benchmarks/serve_throughput.py):
    bimodal prompt lengths (6-16 and 120-200 tokens) submitted in one
    burst, every third opening with one shared 32-token page; 24 or 8 new
    tokens, greedy, seeds by index."""
    import numpy as np
    from repro_torch.serve import SamplingParams
    rng = np.random.RandomState(17)
    prefix = rng.randint(1, vocab, size=PAGE_SIZE)
    trace = []
    for i in range(n_req):
        if i % 3 == 0:
            body = rng.randint(1, vocab, size=int(rng.randint(8, 24)))
            prompt = np.concatenate([prefix, body])
        elif i % 3 == 1:
            prompt = rng.randint(1, vocab, size=int(rng.randint(6, 16)))
        else:
            prompt = rng.randint(1, vocab, size=int(rng.randint(120, 200)))
        trace.append((prompt, SamplingParams(
            max_new_tokens=24 if i % 2 == 0 else 8, seed=i)))
    return trace


def teacher_forced(sp, cfg, qcfg, trace, results, dev: str):
    """One whole forward per request over its prompt and emitted tokens
    (teacher forced).  Returns per request (margins, gaps): at token i, the
    top-1/top-2 logit margin and how far the emitted token's logit lies
    below the maximum, both of the logits that chose token i."""
    import numpy as np
    import torch
    from repro_torch.models import lm_apply
    from repro_torch.models.layers import qdense

    out = []
    with torch.inference_mode():
        for (prompt, _), r in zip(trace, results):
            ctx = np.concatenate([prompt, np.asarray(r.tokens[:-1])])
            h, _ = lm_apply(sp, {"tokens": torch.as_tensor(
                ctx, dtype=torch.long, device=dev)[None]}, cfg, qcfg)
            lg = qdense(sp["lm_head"], h[0, prompt.size - 1:], qcfg).float()
            top2 = torch.topk(lg, 2, dim=-1).values
            tok = torch.as_tensor(r.tokens, device=dev)
            gap = top2[:, 0] - lg[torch.arange(tok.numel(), device=dev), tok]
            out.append(((top2[:, 0] - top2[:, 1]).cpu().numpy(),
                        gap.cpu().numpy()))
    return out


def stream_rule(slab, paged, margins, limit: float):
    """The margin rule of tests/test_torch_serve.py: each paged stream
    equals the slab stream up to its first differing token, and there the
    slab engine's own top-1/top-2 margin is within ``limit``.  Returns
    (tokens held before the first difference, the first differences, the
    ones the rule rejects)."""
    held, diverged, bad = 0, [], []
    for rs, rp, m in zip(slab, paged, margins):
        diff = [i for i, (a, b) in enumerate(zip(rs.tokens, rp.tokens))
                if a != b]
        if len(rs.tokens) != len(rp.tokens):
            diff.append(min(len(rs.tokens), len(rp.tokens)))
        if not diff:
            held += len(rs.tokens)
            continue
        i = diff[0]
        held += i
        rec = {"rid": rs.rid, "step": i,
               "margin": float(m[i]) if i < len(m) else float("inf")}
        diverged.append(rec)
        if rec["margin"] > limit:
            bad.append(rec)
    return held, diverged, bad


def tail_write_off_by_one():
    """Planted engine fault: every paged decode step writes the new K/V
    one position past its slot in the tail page."""
    from unittest import mock
    from repro_torch.models import transformer

    real = transformer.paged_write_slots

    def faulty(page_table, pos, page_size, live=None):
        rows, page, off = real(page_table, pos, page_size, live)
        return rows, page, (off + 1) % page_size

    return mock.patch.object(transformer, "paged_write_slots", faulty)


def phase_paged(params, cfg, dev: str = "cuda",
                presets=("mxfp8_e4m3", "e4m3_bf16act"), n_req: int = 32):
    """The bursty trace through the slab engine (max_batch 2, max_len 256,
    no bucketing) and the paged engine (max_batch 6, 16 pages of 32): the
    same token budget.  Every request finishes by length, the allocator is
    consistent and empty at the end, the prefix cache hits, the paged
    decode kernel launches once per layer per paged decode step and the
    slab decode kernel never in the paged engine, and the token streams
    agree until the slab engine's own top-1/top-2 margin is within
    2 x CHUNK_ATOL.  Every paged token also lies within CHUNK_ATOL of the
    maximum of a teacher-forced whole forward over its own stream, and a
    paged engine with a planted fault (the tail page written one position
    off) must fail that check.  Returns each preset's launch counts and
    numbers."""
    import numpy as np
    import torch
    from repro_torch.core import preset
    from repro_torch.kernels import ops
    from repro_torch.serve import (PagedServeEngine, ServeEngine,
                                   serving_params)

    trace = bursty_trace(cfg.vocab, n_req)
    out = {}
    for name in presets:
        qcfg = preset(name)
        engines = {
            "slab": ServeEngine(params, cfg, qcfg, max_batch=2,
                                max_len=PAGED_MAX_LEN, bucket_prompts=False,
                                device=dev),
            "paged": PagedServeEngine(params, cfg, qcfg, max_batch=6,
                                      max_len=PAGED_MAX_LEN, n_pages=16,
                                      page_size=PAGE_SIZE, device=dev)}
        res, counts = {}, {}
        for kind, eng in engines.items():
            for prompt, spr in trace:
                eng.submit(prompt, spr)
            if dev == "cuda":
                torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            res[kind] = eng.drain()
            if dev == "cuda":
                torch.cuda.synchronize()
            counts[kind] = dict(ops.LAUNCHES)
            counts[kind]["wall_s"] = time.perf_counter() - t0
        slab, paged = engines["slab"], engines["paged"]
        st = {k: e.stats() for k, e in engines.items()}
        bad = [(r.rid, r.finish_reason, len(r.tokens)) for k in res
               for r in res[k] if r.finish_reason != "length"
               or len(r.tokens) != r.sampling.max_new_tokens]
        if len(res["paged"]) != n_req or len(res["slab"]) != n_req or bad:
            raise AssertionError(f"{name}: requests did not all finish by "
                                 f"length: {bad}")
        paged.alloc.check()
        if paged.alloc.pages_in_use or not paged.alloc.prefix_hits:
            raise AssertionError(f"{name}: {paged.alloc.pages_in_use} pages "
                                 f"in use at the end, "
                                 f"{paged.alloc.prefix_hits} prefix hits")
        n8 = counts["paged"]["mx_attention_decode_paged"]
        steps = int(st["paged"]["decode_steps"])
        if n8 != cfg.n_layers * steps or counts["paged"][
                "mx_attention_decode"] or counts["slab"][
                "mx_attention_decode_paged"]:
            raise AssertionError(
                f"{name}: paged decode launched {n8} times over {steps} "
                f"paged decode steps; slab decode launched "
                f"{counts['paged']['mx_attention_decode']} times in the "
                f"paged engine")
        # Token streams under the margin rule, and every paged token held
        # to a teacher-forced whole forward of its own stream.
        limit = 2 * CHUNK_ATOL[name]
        sp = serving_params(params, dev)
        slab_tf = teacher_forced(sp, cfg, qcfg, trace, res["slab"], dev)
        margins = [m for m, _ in slab_tf]
        held, diverged, bad = stream_rule(res["slab"], res["paged"],
                                          margins, limit)
        if bad:
            raise AssertionError(
                f"{name}: streams diverge where the slab margin exceeds "
                f"{limit}: {bad}")
        every = np.concatenate(margins)
        paged_gap = max(float(g.max()) for _, g in teacher_forced(
            sp, cfg, qcfg, trace, res["paged"], dev))
        rule = {"limit": limit, "tokens": int(every.size),
                "tokens_held": held,
                "margin_median": float(np.median(every)),
                "margin_p5": float(np.percentile(every, 5)),
                "share_within_limit": float((every <= limit).mean()),
                "forced_gap_limit": CHUNK_ATOL[name],
                "forced_gap_max": {
                    "slab": max(float(g.max()) for _, g in slab_tf),
                    "paged": paged_gap}}
        if paged_gap > CHUNK_ATOL[name]:
            raise AssertionError(
                f"{name}: a paged token lies {paged_gap} below the maximum "
                f"of the teacher-forced logits (limit {CHUNK_ATOL[name]})")
        planted = PagedServeEngine(params, cfg, qcfg, max_batch=6,
                                   max_len=PAGED_MAX_LEN, n_pages=16,
                                   page_size=PAGE_SIZE, device=dev)
        for prompt, spr in trace:
            planted.submit(prompt, spr)
        with tail_write_off_by_one():
            wrong = planted.drain()
        p_held, _, p_bad = stream_rule(res["slab"], wrong, margins, limit)
        p_gap = max(float(g.max()) for _, g in teacher_forced(
            sp, cfg, qcfg, trace, wrong, dev))
        rule["planted_tail_off_by_one"] = {
            "tokens_held": p_held, "margin_rule_rejects": len(p_bad),
            "forced_gap_max": p_gap}
        if p_gap <= CHUNK_ATOL[name]:
            raise AssertionError(
                f"{name}: the teacher-forced check accepts a paged engine "
                f"that writes the tail page one position off: {rule}")
        rec = {
            "slab": {k: st["slab"][k] for k in (
                "decode_tok_s", "prefill_tok_s", "decode_steps")},
            "paged": {k: st["paged"][k] for k in (
                "decode_tok_s", "prefill_tok_s", "decode_steps",
                "preemptions", "prefix_hits", "evictions")},
            "paged_over_slab_decode_tok_s": st["paged"]["decode_tok_s"]
            / max(st["slab"]["decode_tok_s"], 1e-9),
            "wall_s": {k: counts[k]["wall_s"] for k in counts},
            "streams_diverged": diverged,
            "margin_rule": rule,
            "ledger": paged.ledger.report(),
            "launches": {k: {n: v for n, v in counts[k].items()
                             if n != "wall_s"} for k in counts}}
        print(f"[paged] {name}: " + json.dumps(rec), flush=True)
        out[name] = rec
    return out


# ---------------------------------------------------------------------------
# [moe]: moonshot-v1-16b-a3b at full width, depth cut to MOE_LAYERS
# ---------------------------------------------------------------------------
MOE_ARCH = "moonshot-v1-16b-a3b"
# The lead dense layer (first_dense 1) and 3 MoE layers: 2.52 G fp32
# parameters, whose weights, gradients and two AdamW moments (~40 GB) fit
# one card beside the activations at 8 x 512 tokens; the config's 48
# layers (~28 G) would not.
MOE_LAYERS = 4
# The card-against-CPU parity runs the lead dense layer and one MoE layer:
# the CPU's plain versions quantize the 163840-row head and the experts'
# 553 M weights on every call.
MOE_PARITY_LAYERS = 2
MOE_B, MOE_T, MOE_STEPS = 8, 512, 10
# Card-against-CPU logit limits of [moe]'s parity under mxfp8_e4m3 (a
# 64-token prompt, teacher-forced, 2 layers): 1.5x the first reading, rel
# 0.05027201 and max abs 0.60009766 on an H100 80GB HBM3 at 700 W (PERF.md
# §6).  Both sides are deterministic.  A token whose 6th and 7th router
# probabilities lie within the two devices' difference routes to another
# expert on one of them (58 of 64 greedy tokens agreed there).
MOE_LOGIT_REL = 1.5 * 0.05027201
MOE_LOGIT_ATOL = 1.5 * 0.60009766


def moe_config(n_layers: int):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MOE_ARCH, "full"),
                               n_layers=n_layers)


def expert_lane_kernels(rows, tag, cfg, C, seed):
    """Kernels 2-4 with their lane axis at ``cfg``'s routed experts' shapes:
    n_experts lanes of C rows, d_model and moe_dff, bf16 operands in E4M3
    under the floor rule; the forward at the up and the down product's
    shapes, dgrad and wgrad at the up product's.  Each through lane_case
    (bitwise the 2-D kernel lane by lane, gemm_check against the plain
    version, equal bits on a second call), timed against the plain
    version and torch.bmm; the rows gain the cases."""
    import torch
    from repro_torch.core import get_format
    E, D, F = cfg.n_experts, cfg.d_model, cfg.moe_dff
    g = torch.Generator(device="cuda").manual_seed(seed)
    flush = torch.zeros(64 * 2 ** 20, dtype=torch.uint8,
                        device="cuda").bitwise_not_
    fmt = get_format("e4m3")

    def rnd(shape, std):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(
            torch.bfloat16)
    cases = (("fwd up", "fwd", rnd((E, C, D), 1.0),
              rnd((E, D, F), D ** -0.5)),
             ("fwd down", "fwd", rnd((E, C, F), 1.0),
              rnd((E, F, D), F ** -0.5)),
             ("dgrad up", "dgrad", rnd((E, C, F), 1e-3),
              rnd((E, D, F), D ** -0.5)),
             ("wgrad up", "wgrad", rnd((E, C, D), 1.0), rnd((E, C, F), 1e-3)))
    card = torch.cuda.get_device_name(0)
    for label, kind, a, b in cases:
        name = dict(zip(("fwd", "dgrad", "wgrad"), LANE_KERNELS))[kind]
        c = lane_case(kind, a, b, fmt, "floor")
        ok = c["bitwise_2d"] and c["replay"] and c["worst"] <= 1.0
        print(f"[{tag}] {'ok  ' if ok else 'FAIL'} {label} {name} "
              f"{json.dumps(c)}", flush=True)
        if not ok:
            raise AssertionError(f"{tag} {label} {name}: bitwise "
                                 f"{c['bitwise_2d']}, replay {c['replay']}, "
                                 f"worst err/tol {c['worst']}")
        fn, _, plain, _ = lane_fns(kind)
        events0 = EVENT_TIMED[0]
        entry = {"case": f"{tag} {label} L{E} {tuple(a.shape)}x"
                         f"{tuple(b.shape)} bf16 e4m3 floor",
                 "max_abs_err": c["max_abs_err"],
                 "ms": time_ms(lambda: fn(a, b, fmt, fmt), 10, flush),
                 "plain_ms": time_ms(lambda: plain(a, b, fmt, fmt), 3,
                                     flush),
                 "library_ms": time_ms(lane_library(kind, a, b), 10, flush),
                 "splits": c["splits"], "card": card}
        entry["bound_ms"], entry["bound_by"] = lane_bound(kind, a, b)
        entry["timing"] = ("events" if EVENT_TIMED[0] > events0
                           else "profiler")
        print(f"[{tag}] {name} {json.dumps(entry)}", flush=True)
        rows[name]["cases"].append(entry)
        del a, b
    torch.cuda.empty_cache()


def _lane_launches(counts):
    return {k: counts.get(k, 0) for k in LANE_KERNELS}


def _peak_reset(dev):
    import torch
    _sync(dev)
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak(dev) -> int:
    import torch
    if torch.device(dev).type == "cuda":
        return torch.cuda.max_memory_allocated()
    return 0


def _laps(tag):
    """A function that prints the wall seconds since its last call (or
    since this one) under ``label``: where a phase's time goes."""
    last = [time.perf_counter()]

    def lap(label):
        now = time.perf_counter()
        print(f"[{tag}] {label} {now - last[0]:.1f} s", flush=True)
        last[0] = now
    return lap


def _free(dev):
    """Collect what the caller dropped (cycles too) and return the
    allocator's free blocks to the card."""
    import gc
    import torch
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def moe_serve(params, cfg, dev: str = "cuda"):
    """ServeEngine (max_batch 4) on 8 greedy 64-token prompts, 32 new
    tokens each, under mxfp8_e4m3: every request finishes, the lane GEMM
    runs 3 times per MoE layer in a prefill and in a decode step (up,
    gate, down), and the routed experts' dropped share is printed.  Then
    PagedServeEngine (32 pages of 32) on the same prompts through its
    whole-prompt path: every request finishes with the slab engine's
    tokens, the paged decode kernel runs.  Returns the launch counts of
    both engines' runs."""
    import numpy as np
    import torch
    from repro_torch.core import preset
    from repro_torch.kernels import ops
    from repro_torch.models import (init_cache, lm_decode_step, lm_prefill,
                                    moe)
    from repro_torch.serve import (PagedServeEngine, SamplingParams,
                                   ServeEngine)

    qcfg = preset("mxfp8_e4m3")
    n_moe = sum("moe" in lp for lp in params["layers"])
    eng = ServeEngine(params, cfg, qcfg, max_batch=4, max_len=128,
                      device=dev)
    rng = np.random.default_rng(SEED + 3)
    prompts = [rng.integers(1, cfg.vocab, 64).astype(np.int32)
               for _ in range(8)]
    for pr in prompts:
        eng.submit(pr, SamplingParams(max_new_tokens=32))
    _peak_reset(dev)
    moe.reset_routing()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.drain()
    _sync(dev)
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    dropped = float(moe.ROUTING["dropped"]) / moe.ROUTING["assignments"]
    st = eng.stats()
    if len(done) != 8 or any(len(r.tokens) != 32 for r in done):
        raise AssertionError(f"moe serve: {len(done)} of 8 requests, "
                             f"{[len(r.tokens) for r in done]} tokens")
    per = {}
    with torch.inference_mode():
        ops.reset_launches()
        lm_prefill(eng.params, torch.ones((1, 64), dtype=torch.long,
                                          device=dev), cfg, qcfg, 128)
        per["prefill"] = dict(ops.LAUNCHES)
        cache = init_cache(cfg, 4, 128, dev)
        ops.reset_launches()
        lm_decode_step(eng.params, cache, torch.ones((4, 1), dtype=torch.long,
                                                     device=dev),
                       torch.tensor([3, 4, 5, 6], device=dev), cfg, qcfg)
        per["decode_step"] = dict(ops.LAUNCHES)
    rec = {"requests": len(done), "wall_s": wall,
           "prefill_tok_s": st["prefill_tok_s"],
           "decode_tok_s": st["decode_tok_s"],
           "decode_steps": st["decode_steps"], "dropped_frac": dropped,
           "max_memory_allocated": _peak(dev),
           "lane_launches_per_prefill": _lane_launches(per["prefill"]),
           "lane_launches_per_decode_step":
               _lane_launches(per["decode_step"]),
           "launches": counts}
    print(f"[moe] serve mxfp8_e4m3: {json.dumps(rec)}", flush=True)
    for call, c in per.items():
        if dev == "cuda" and c["mx_matmul_lanes"] != 3 * n_moe:
            raise AssertionError(f"moe {call}: {c['mx_matmul_lanes']} lane "
                                 f"GEMMs, expected {3 * n_moe}")
    idle = sorted(k for k in ("mx_quantize", "mx_matmul", "mx_matmul_lanes",
                              "mx_flash_attention", "mx_attention_decode")
                  if counts[k] == 0)
    if idle and dev == "cuda":
        raise AssertionError(f"moe serve: kernels never launched: {idle}")
    tokens = [list(map(int, r.tokens)) for r in done]
    del eng
    _free(dev)
    eng = PagedServeEngine(params, cfg, qcfg, max_batch=4, max_len=128,
                           n_pages=32, page_size=32, device=dev)
    for pr in prompts:
        eng.submit(pr, SamplingParams(max_new_tokens=32))
    ops.reset_launches()
    t0 = time.perf_counter()
    done = eng.drain()
    _sync(dev)
    paged = dict(ops.LAUNCHES)
    eng.alloc.check()
    st = eng.stats()
    same = [list(map(int, r.tokens)) for r in done] == tokens
    rec = {"requests": len(done), "chunked": eng.chunk,
           "wall_s": time.perf_counter() - t0,
           "prefill_tok_s": st["prefill_tok_s"],
           "decode_tok_s": st["decode_tok_s"], "tokens_equal_slab": same,
           "launches": paged}
    print(f"[moe] {'ok  ' if same else 'FAIL'} serve paged mxfp8_e4m3 "
          f"(whole-prompt path): {json.dumps(rec)}", flush=True)
    if not same:
        raise AssertionError("moe: the paged engine's greedy tokens differ "
                             "from the slab engine's")
    if dev == "cuda" and paged["mx_attention_decode_paged"] == 0:
        raise AssertionError("moe paged serve: the paged decode kernel was "
                             "never launched")
    del eng
    _free(dev)
    return counts, paged


def moe_parity(params, cfg, devs=("cuda", "cpu")):
    """Teacher-forced logits of one 64-token prompt through the lead dense
    layer and the first MoE layer, on the card (kernels) and on the CPU
    (plain versions), same bf16 serving weights, under mxfp8_e4m3."""
    import numpy as np
    import torch
    from repro_torch.core import preset
    from repro_torch.models import lm_apply, tree_map
    from repro_torch.models.layers import qdense
    from repro_torch.serve import serving_params

    cfg = dataclasses.replace(cfg, n_layers=MOE_PARITY_LAYERS)
    cut = {k: v for k, v in params.items() if k != "layers"}
    cut["layers"] = params["layers"][:MOE_PARITY_LAYERS]
    qcfg = preset("mxfp8_e4m3")
    prompt = torch.as_tensor(np.random.default_rng(SEED + 4).integers(
        1, cfg.vocab, (1, 64)))
    logits, secs = {}, {}
    with torch.inference_mode():
        for dev in devs:
            p = serving_params(tree_map(lambda t: t.to(dev), cut), dev)
            t0 = time.perf_counter()
            h, _ = lm_apply(p, {"tokens": prompt.to(dev)}, cfg, qcfg)
            logits[dev] = qdense(p["lm_head"], h, qcfg)[0].float().cpu()
            secs[dev] = time.perf_counter() - t0
            del p, h
    a, b = logits[devs[0]], logits[devs[1]]
    rel = (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()
    err_rows = (a - b).abs().amax(-1)
    rec = {"layers": MOE_PARITY_LAYERS, "positions": a.shape[0],
           "rel_fro": rel, "max_abs_err": err_rows.max().item(),
           "median_row_max_abs_err": err_rows.median().item(),
           "argmax_agree": int((a.argmax(-1) == b.argmax(-1)).sum()),
           "seconds": secs,
           "limits": {"rel_fro": MOE_LOGIT_REL,
                      "max_abs_err": MOE_LOGIT_ATOL}}
    ok = rel <= MOE_LOGIT_REL and rec["max_abs_err"] <= MOE_LOGIT_ATOL
    print(f"[moe] {'ok  ' if ok else 'FAIL'} parity mxfp8_e4m3: "
          f"{json.dumps(rec)}", flush=True)
    if not ok:
        raise AssertionError("moe: card and CPU logits disagree")
    _free(devs[0])
    return rec


def _bits(tree):
    """A digest of every leaf's bits (the sum of its int32 words)."""
    import torch
    from repro_torch.core.diagnostics import tree_leaves_with_path
    return [int(t.detach().view(torch.int32).to(torch.int64).sum())
            for _, t in tree_leaves_with_path(tree)]


def moe_train(params, cfg, dev: str = "cuda", B: int = MOE_B,
              T: int = MOE_T, steps: int = MOE_STEPS):
    """The Trainer at 8 x 512 for MOE_STEPS AdamW steps under mxfp8_e4m3
    and bf16 from one host copy of the weights: loss finite and falling by
    [train]'s rule, aux_loss in the history, under mxfp8_e4m3 3 forward,
    3 dgrad and 3 wgrad lane GEMMs a step per MoE layer; two 3-step runs
    from the same state give equal losses and equal bits in every
    parameter and moment (a float atomic in the dispatch's backward would
    not).  Returns the mxfp8_e4m3 run's launch counts."""
    from repro_torch.core import preset
    from repro_torch.data import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.models import lm_loss
    from repro_torch.train import Trainer, TrainerConfig

    n_moe = sum("moe" in lp for lp in params["layers"])

    def trainer(name, total):
        return Trainer(lambda pp, b, q: lm_loss(pp, b, cfg, q),
                       _fresh(params, dev), preset(name),
                       lambda s: lm_batch(s, cfg.vocab, B, T, SEED,
                                          device=dev),
                       tcfg=TrainerConfig(total_steps=total, peak_lr=1e-3,
                                          log_every=1))

    out = {}
    for name in ("mxfp8_e4m3", "bf16"):
        tr = trainer(name, steps)
        _peak_reset(dev)
        ops.reset_launches()
        t0 = time.perf_counter()
        hist = tr.run(steps)
        _sync(dev)
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        losses = [h["loss"] for h in hist]
        times = [h["time_s"] for h in hist]
        step_s = sorted(times[1:])[len(times[1:]) // 2]
        per_step = {k: v / steps for k, v in counts.items()}
        rec = {"steps": steps, "batch": B, "seq": T,
               "losses": losses, "aux_loss": [h["aux_loss"] for h in hist],
               "step_ms": step_s * 1e3, "first_step_ms": times[0] * 1e3,
               "tokens_per_s": B * T / step_s, "wall_s": wall,
               "max_memory_allocated": _peak(dev),
               "launches_per_step": per_step}
        print(f"[moe] train {name}: {json.dumps(rec)}", flush=True)
        del tr
        _free(dev)
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"moe {name}: non-finite loss {losses}")
        first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
        if not last < first:
            raise AssertionError(f"moe {name}: loss did not fall (first 5 "
                                 f"{first}, last 5 {last})")
        if name == "mxfp8_e4m3" and dev == "cuda":
            want = {k: 3 * n_moe for k in LANE_KERNELS}
            got = {k: per_step.get(k, 0) for k in LANE_KERNELS}
            if got != want:
                raise AssertionError(f"moe {name}: lane GEMMs per step "
                                     f"{got}, expected {want}")
        if name == "mxfp8_e4m3":
            out["counts"] = counts
        runs = []
        for _ in range(2):
            rt = trainer(name, 3)
            runs.append(([h["loss"] for h in rt.run(3)],
                         _bits({"params": rt.params, "opt": rt.opt_state})))
            del rt
            _free(dev)
        same = runs[0] == runs[1]
        print(f"[moe] train {name} replay: losses {runs[0][0]} / "
              f"{runs[1][0]}, bits equal {same}", flush=True)
        if not same:
            raise AssertionError(f"moe {name}: replays differ")
        out[name] = rec
    return out


def phase_moe(rows):
    """[moe]: the lane kernels at the experts' shapes, then
    moonshot-v1-16b-a3b at full width and MOE_LAYERS layers, weights drawn
    on a CUDA generator: serving (slab and paged), card-against-CPU
    parity, training.  Returns the launch counts of the serve and train
    runs."""
    import torch
    from repro_torch.core.diagnostics import tree_leaves_with_path
    from repro_torch.models import lm_init, tree_map

    lap = _laps("moe")
    cfg = moe_config(MOE_LAYERS)
    # training's capacity: 8 x 512 tokens, top-6, capacity factor 1.25
    expert_lane_kernels(rows, "moe", cfg, 480, SEED + 23)
    lap("lane kernels")
    t0 = time.perf_counter()
    params = lm_init(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                     "cuda")
    n = sum(t.numel() for _, t in tree_leaves_with_path(params))
    print(f"[moe] {cfg.name} {cfg.n_layers} layers: {n} parameters, "
          f"drawn in {time.perf_counter() - t0:.1f} s", flush=True)
    serve, paged = moe_serve(params, cfg)
    lap("serve")
    moe_parity(params, cfg)
    lap("parity")
    # The trainers draw fresh copies from the host: the card holds one
    # model's weights, gradients and moments at a time.
    params = tree_map(lambda t: t.cpu(), params)
    torch.cuda.empty_cache()
    train = moe_train(params, cfg)
    lap("train")
    return {"serve": serve, "paged": paged, "train": train["counts"]}


MLA_ARCH = "deepseek-v2-236b"
# Serving runs the lead dense layer and one MoE layer (160 experts, top-6
# plus 2 shared) at full width: 5.36 G fp32 parameters (21.4 GB) beside
# the engine's bf16 copy.  Training runs the lead dense layer alone (1.39
# G parameters: weights, gradients and two AdamW moments 22.2 GB); one
# MoE layer of deepseek alone needs 63.5 GB of such state, so two layers
# do not fit the card.  MoE training at full width is [moe]'s.
MLA_SERVE_LAYERS, MLA_TRAIN_LAYERS = 2, 1
MLA_B, MLA_T, MLA_STEPS = 4, 512, 10
# Limits at 1.5x the first reading (PERF.md §6; an H100 80GB HBM3 at 700
# W), each (rel_fro, max_abs_err): the absorbed decode against the
# expanded form at the same 8 positions, the lead layer's attention output
# alone (mxfp8_e4m3 rel 0.08200774 / max 0.03198242, bf16 0.004379366 /
# 0.001953125) and the 2-layer model's teacher-forced logits (0.1823494 /
# 1.0625, 0.01151662 / 0.0625); the 1-layer model's card logits against
# the CPU's at 64 positions (mxfp8_e4m3 rel 0.008461246 / max 0.21875);
# the 1-layer model's card gradients against the CPU's, the largest
# relative Frobenius error of any leaf (0.05427870, w_dkv).  The two forms
# quantize at different points under MX (expanded: q and k along the
# 192-wide head, p and v along kv; absorbed: q_nope along its 128, pr and
# the latents along the cache), so they agree to MX noise there; in bf16
# they round different intermediates (k_nope and v against q_eff and the
# context).
MLA_ABSORB = {"mxfp8_e4m3": {"layer": (1.5 * 0.08200774, 1.5 * 0.03198242),
                             "logits": (1.5 * 0.1823494, 1.5 * 1.0625)},
              "bf16": {"layer": (1.5 * 0.004379366, 1.5 * 0.001953125),
                       "logits": (1.5 * 0.01151662, 1.5 * 0.0625)}}
# Planted decode faults a check cannot see: under mxfp8_e4m3 the late
# rope moves the 2-layer logits by rel 0.2653 / max 1.389, inside their MX
# limits (the layer check rejects it at rel 0.1606 / max 0.06269).
MLA_ABSORB_BLIND = {("logits", "mxfp8_e4m3"): ("query rope one position "
                                               "late",)}
MLA_LOGIT_REL, MLA_LOGIT_ATOL = 1.5 * 0.008461246, 1.5 * 0.21875
MLA_GRAD_REL = 1.5 * 0.05427870


def mla_config(n_layers: int):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MLA_ARCH, "full"),
                               n_layers=n_layers)


def _limit_check(tag, rec, rel_limit, atol_limit, phase="mla"):
    """rec's rel_fro and max_abs_err within the limits."""
    rec["limits"] = {"rel_fro": rel_limit, "max_abs_err": atol_limit}
    ok = rec["rel_fro"] <= rel_limit and rec["max_abs_err"] <= atol_limit
    print(f"[{phase}] {'ok  ' if ok else 'FAIL'} {tag}: {json.dumps(rec)}",
          flush=True)
    if not ok:
        raise AssertionError(f"{phase} {tag}: logits disagree")


def _logit_diff(a, b):
    import torch
    rows = (a - b).abs().amax(-1)
    return {"positions": a.shape[0],
            "rel_fro": (torch.linalg.norm(a - b)
                        / torch.linalg.norm(b)).item(),
            "max_abs_err": rows.max().item(),
            "median_row_max_abs_err": rows.median().item(),
            "argmax_agree": int((a.argmax(-1) == b.argmax(-1)).sum())}


def mla_serve(params, cfg, dev: str = "cuda"):
    """ServeEngine and PagedServeEngine (max_batch 4, max_len 128, page
    size 32; the paged engine prefills whole and pages the latents) on 8
    greedy 64-token prompts, 32 new tokens each, under mxfp8_e4m3: every
    request finishes, the paged engine's tokens equal the slab engine's,
    the flash forward runs once per layer a prefill, and each engine's
    prefill and decode tokens/s and peak memory are printed.  Returns
    the launch counts of both engines' runs."""
    import numpy as np
    from repro_torch.core import preset
    from repro_torch.kernels import ops
    from repro_torch.serve import (PagedServeEngine, SamplingParams,
                                   ServeEngine)

    qcfg = preset("mxfp8_e4m3")
    rng = np.random.default_rng(SEED + 5)
    prompts = [rng.integers(1, cfg.vocab, 64).astype(np.int32)
               for _ in range(8)]
    tokens, counts = {}, {}
    for kind in ("slab", "paged"):
        if kind == "slab":
            eng = ServeEngine(params, cfg, qcfg, max_batch=4, max_len=128,
                              device=dev)
        else:
            eng = PagedServeEngine(params, cfg, qcfg, max_batch=4,
                                   max_len=128, n_pages=32, page_size=32,
                                   device=dev)
        for pr in prompts:
            eng.submit(pr, SamplingParams(max_new_tokens=32))
        _peak_reset(dev)
        ops.reset_launches()
        t0 = time.perf_counter()
        done = eng.drain()
        _sync(dev)
        wall = time.perf_counter() - t0
        counts[kind] = dict(ops.LAUNCHES)
        st = eng.stats()
        if len(done) != 8 or any(len(r.tokens) != 32 for r in done):
            raise AssertionError(f"mla {kind} serve: {len(done)} of 8 "
                                 f"requests, {[len(r.tokens) for r in done]}"
                                 " tokens")
        tokens[kind] = [list(map(int, r.tokens)) for r in done]
        rec = {"requests": len(done), "wall_s": wall,
               "prefill_tok_s": st["prefill_tok_s"],
               "decode_tok_s": st["decode_tok_s"],
               "decode_steps": st["decode_steps"],
               "max_memory_allocated": _peak(dev),
               "launches": counts[kind]}
        if kind == "paged":
            eng.alloc.check()
            rec["chunked"] = eng.chunk
        print(f"[mla] serve {kind} mxfp8_e4m3: {json.dumps(rec)}",
              flush=True)
        if dev == "cuda" and counts[kind]["mx_flash_attention"] != \
                8 * cfg.n_layers:
            raise AssertionError(
                f"mla {kind} serve: {counts[kind]['mx_flash_attention']} "
                f"flash forwards, expected {8 * cfg.n_layers}")
        idle = sorted(k for k in ("mx_quantize", "mx_matmul",
                                  "mx_matmul_lanes", "mx_flash_attention")
                      if counts[kind][k] == 0)
        if idle and dev == "cuda":
            raise AssertionError(f"mla {kind} serve: kernels never "
                                 f"launched: {idle}")
        del eng
        _free(dev)
    same = tokens["paged"] == tokens["slab"]
    print(f"[mla] {'ok  ' if same else 'FAIL'} paged tokens equal slab "
          f"tokens: {same}", flush=True)
    if not same:
        raise AssertionError("mla: the paged engine's greedy tokens differ "
                             "from the slab engine's")
    return counts


def mla_decode_gemms(rows, cfg, M: int = 4):
    """Kernel 2, 2-D, at the decode's row count (M = max_batch 4) on the
    shapes a deepseek decode step gives it: the absorbed decode's
    projections (w_dq, w_dkv, w_kr, w_uq, wo), the lead dense layer's
    SwiGLU, the shared experts' and the lm_head; bf16 operands in E4M3
    under the floor rule.  Each within gemm_check of the plain version
    and bitwise on a second call, timed beside the plain version and
    torch.matmul; the mx_matmul row gains the cases."""
    import torch
    from repro_torch.core import E4M3
    from repro_torch.kernels import ops, ref
    H, D = cfg.n_heads, cfg.d_model
    sh = cfg.n_shared * cfg.moe_dff
    shapes = (("w_dq", D, cfg.q_lora), ("w_dkv", D, cfg.kv_lora),
              ("w_kr", D, cfg.rope_dim), ("w_uq", cfg.q_lora, H * cfg.qk_dim),
              ("wo", H * cfg.v_head, D), ("dense w_up", D, cfg.d_ff),
              ("dense w_down", cfg.d_ff, D), ("shared w_up", D, sh),
              ("shared w_down", sh, D), ("lm_head", D, cfg.vocab))
    g = torch.Generator(device="cuda").manual_seed(SEED + 24)
    flush = torch.zeros(64 * 2 ** 20, dtype=torch.uint8,
                        device="cuda").bitwise_not_
    card = torch.cuda.get_device_name(0)
    for label, K, N in shapes:
        a = torch.randn((M, K), generator=g, device="cuda").bfloat16()
        b = (torch.randn((K, N), generator=g, device="cuda")
             * K ** -0.5).bfloat16()

        def fn():
            return ops.mx_matmul(a, b, E4M3, E4M3)
        got, want = fn(), ref.mx_matmul_ref(a, b, E4M3, E4M3)
        ok, worst, err = gemm_check(
            got, want, ref.mx_quantize_ref(a, E4M3).float().abs(),
            ref.mx_quantize_ref(b, E4M3, axis=0).float().abs(), K)
        replay = torch.equal(got, fn())
        small, _, splits = ops.fwd_gemm_plan(M, N, K)
        events0 = EVENT_TIMED[0]
        entry = {"case": f"mla decode {label} {M}x{K}x{N} e4m3/e4m3 "
                         f"({'small-M' if small else 'wgmma'} path, "
                         f"{splits} splits)",
                 "max_abs_err": err, "worst": worst, "replay": replay,
                 "ms": time_ms(fn, 20, flush),
                 "plain_ms": time_ms(
                     lambda: ref.mx_matmul_ref(a, b, E4M3, E4M3), 3, flush),
                 "library_ms": time_ms(lambda: torch.matmul(a, b), 20,
                                       flush), "card": card}
        entry["bound_ms"], entry["bound_by"] = bound(
            2 * (M * K + K * N + M * N), 2 * M * N * K)
        entry["timing"] = ("events" if EVENT_TIMED[0] > events0
                           else "profiler")
        good = ok and replay
        print(f"[mla] {'ok  ' if good else 'FAIL'} mx_matmul "
              f"{json.dumps(entry)}", flush=True)
        if not good:
            raise AssertionError(f"mla decode {label}: worst err/tol "
                                 f"{worst}, replay {replay}")
        rows["mx_matmul"]["cases"].append(entry)
        del a, b
    torch.cuda.empty_cache()


def _absorb_faults():
    """Decode faults the absorbed-form checks must reject, each a wrapper
    of ``mla._absorbed_attend``: the query's rope taken one position
    late, and W_uv read one head over (each head's context mapped by the
    next head's value projection)."""
    import torch

    def late_rope(orig):
        def f(*a):
            a = list(a)
            a[10] = a[10] + 1          # positions
            return orig(*a)
        return f

    def next_head_uv(orig):
        def f(p, *a):
            kv_lora, H = p["w_uv"]["w"].shape[0], a[5]
            w = p["w_uv"]["w"].reshape(kv_lora, H, -1)
            p = dict(p, w_uv={"w": torch.roll(w, 1, dims=1).reshape(
                kv_lora, -1)})
            return orig(p, *a)
        return f
    return {"query rope one position late": late_rope,
            "W_uv of the next head": next_head_uv}


def _planted_absorb(fault, fn):
    """``fn()`` with ``mla._absorbed_attend`` wrapped by ``fault`` (None:
    as it is)."""
    from repro_torch.models import mla
    orig = mla._absorbed_attend
    if fault is not None:
        mla._absorbed_attend = _absorb_faults()[fault](orig)
    try:
        return fn()
    finally:
        mla._absorbed_attend = orig


def _hold_absorbed(tag, rec, limits, planted, blind=()):
    """rec within ``limits`` (rel_fro, max_abs_err), and each planted
    fault's reading outside them, but for the ``blind`` ones (printed
    only)."""
    _limit_check(tag, rec, *limits)
    for fault, bad in planted.items():
        rejected = bad["rel_fro"] > limits[0] or bad["max_abs_err"] > limits[1]
        verdict = ("rejected" if rejected else
                   "accepted: not seen here" if fault in blind else
                   "ACCEPTED")
        print(f"[controls] mla {tag}: {fault!r} rel_fro "
              f"{bad['rel_fro']:.4g}, max_abs_err {bad['max_abs_err']:.4g} "
              f"({verdict})", flush=True)
        if not rejected and fault not in blind:
            raise AssertionError(f"mla {tag}: the limits accept the planted "
                                 f"fault {fault!r}")


def mla_absorbed(params, cfg, dev: str = "cuda"):
    """The absorbed decode against the expanded form at the same positions,
    same bf16 serving weights, under mxfp8_e4m3 and bf16, each with the
    _absorb_faults planted and rejected (but for MLA_ABSORB_BLIND's):
    (1) the lead layer's attention alone on one 72-row input of unit
    scale: 8 mla_decode steps after a 64-row mla_prefill, against a
    72-row mla_prefill's rows 64-71;
    (2) the 2-layer model's teacher-forced logits: a 64-token lm_prefill
    plus 8 lm_decode_step calls fed tokens 64-71, against lm_prefill of
    the first 65, ..., 72 tokens."""
    import numpy as np
    import torch
    from repro_torch.core import preset
    from repro_torch.models import lm_decode_step, lm_prefill, mla
    from repro_torch.models.transformer import _mla_kw
    from repro_torch.serve import serving_params

    p = serving_params(params, dev)
    toks = torch.as_tensor(np.random.default_rng(SEED + 6).integers(
        1, cfg.vocab, (1, 72)), device=dev)
    x = torch.randn((1, 72, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(
                        SEED + 9)).bfloat16()
    attn, kw = p["layers"][0]["attn"], _mla_kw(cfg)
    spec = cfg.attn_spec(cache_len=128)
    pos = torch.arange(72, device=dev)[None]
    out = {}
    for name in MLA_ABSORB:
        qcfg = preset(name)
        with torch.inference_mode():
            want_l = mla.mla_prefill(attn, x, qcfg=qcfg, positions=pos,
                                     spec=spec, **kw)[0][0, 64:].float()
            want = torch.stack([lm_prefill(p, toks[:, :i + 1], cfg, qcfg,
                                           128)[0][0].float()
                                for i in range(64, 72)])

            def layer():
                _, c = mla.mla_prefill(attn, x[:, :64], qcfg=qcfg,
                                       positions=pos[:, :64], spec=spec,
                                       **kw)
                rows = []
                for i in range(64, 72):
                    o, c = mla.mla_decode(attn, x[:, i:i + 1], c, qcfg=qcfg,
                                          pos=pos[0, i:i + 1], **kw)
                    rows.append(o[0, 0].float())
                return _logit_diff(torch.stack(rows).cpu(), want_l.cpu())

            def logits():
                _, cache = lm_prefill(p, toks[:, :64], cfg, qcfg, 128)
                got = []
                for i in range(64, 72):
                    lg, cache = lm_decode_step(
                        p, cache, toks[:, i:i + 1],
                        torch.tensor([i], device=dev), cfg, qcfg)
                    got.append(lg[0].float())
                return _logit_diff(torch.stack(got).cpu(), want.cpu())
            for what, fn in (("layer", layer), ("logits", logits)):
                rec = fn()
                planted = {f: _planted_absorb(f, fn)
                           for f in _absorb_faults()}
                rec["layers"] = 1 if what == "layer" else cfg.n_layers
                _hold_absorbed(f"absorbed decode against the expanded form "
                               f"({what}) {name}", rec,
                               MLA_ABSORB[name][what], planted,
                               MLA_ABSORB_BLIND.get((what, name), ()))
                out[f"{what} {name}"] = rec
    del p
    _free(dev)
    return out


def mla_logits(params, cfg, dev: str):
    """Teacher-forced logits (64, vocab) fp32 on the host of one 64-token
    prompt through ``cfg``'s layers (the lead dense MLA layer) on ``dev``,
    with bf16 serving weights made there from ``params``, under
    mxfp8_e4m3, and the seconds they took."""
    import numpy as np
    import torch
    from repro_torch.core import preset
    from repro_torch.models import lm_apply, tree_map
    from repro_torch.models.layers import qdense
    from repro_torch.serve import serving_params

    qcfg = preset("mxfp8_e4m3")
    prompt = torch.as_tensor(np.random.default_rng(SEED + 7).integers(
        1, cfg.vocab, (1, 64)))
    with torch.inference_mode():
        p = serving_params(tree_map(lambda t: t.to(dev), params), dev)
        t0 = time.perf_counter()
        h, _ = lm_apply(p, {"tokens": prompt.to(dev)}, cfg, qcfg)
        logits = qdense(p["lm_head"], h, qcfg)[0].float().cpu()
        secs = time.perf_counter() - t0
        del p, h
    _free(dev)
    return logits, secs


def mla_parity(card, cpu, cfg):
    """mla_logits' results from the card (kernels) and the CPU (plain
    versions): within MLA_LOGIT_REL / MLA_LOGIT_ATOL."""
    rec = _logit_diff(card[0], cpu[0])
    rec.update(layers=cfg.n_layers, seconds={"cuda": card[1],
                                             "cpu": cpu[1]})
    _limit_check("parity mxfp8_e4m3", rec, MLA_LOGIT_REL, MLA_LOGIT_ATOL)
    return rec


def mla_grads(params, cfg, dev: str, B: int = 2, T: int = 128):
    """One step's loss and gradients (fp32 on the host, by leaf path) of
    ``cfg`` (the lead dense MLA layer) on ``dev`` (on the card: the flash
    dgrad at qk 192 / v 128, the dgrad and wgrad GEMMs), from fresh fp32
    copies of ``params`` and one B x T batch, under mxfp8_e4m3; and the
    seconds they took."""
    import torch
    from repro_torch.core import preset
    from repro_torch.core.diagnostics import tree_leaves_with_path
    from repro_torch.data import lm_batch
    from repro_torch.models import lm_loss

    batch = lm_batch(SEED + 8, cfg.vocab, B, T, SEED, device="cpu")
    p = _fresh(params, dev)
    leaves = list(tree_leaves_with_path(p))
    for _, t in leaves:
        t.requires_grad_(True)
    t0 = time.perf_counter()
    loss, _ = lm_loss(p, {k: v.to(dev) for k, v in batch.items()}, cfg,
                      preset("mxfp8_e4m3"))
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    out = (loss.item(), {path: g.detach().cpu().float()
                         for (path, _), g in zip(leaves, grads)})
    secs = time.perf_counter() - t0
    del p, leaves, grads, loss
    _free(dev)
    return out + (secs,)


def mla_grad_parity(card, cpu, B: int = 2, T: int = 128):
    """mla_grads' results from the card and the CPU (plain versions),
    same fp32 weights and batch: every leaf's gradient non-zero on the
    card and within MLA_GRAD_REL (relative Frobenius) of the CPU's."""
    import torch
    (lc, gc, sc), (lp, gp, sp) = card, cpu
    rel = {"/".join(map(str, path)): (
        torch.linalg.norm(gc[path] - g)
        / torch.clamp(torch.linalg.norm(g), min=1e-30)).item()
        for path, g in gp.items()}
    zero = ["/".join(map(str, path)) for path in gc
            if not bool(gc[path].abs().max() > 0)]
    worst = max(rel, key=rel.get)
    out = {"batch": B, "seq": T, "loss_cuda": lc, "loss_cpu": lp,
           "leaves": len(rel), "rel_max": rel[worst], "worst_leaf": worst,
           "rel": rel, "seconds": {"cuda": sc, "cpu": sp},
           "limit": MLA_GRAD_REL}
    ok = not zero and rel[worst] <= MLA_GRAD_REL
    print(f"[mla] {'ok  ' if ok else 'FAIL'} grad parity mxfp8_e4m3 "
          + json.dumps(out), flush=True)
    if zero:
        raise AssertionError(f"mla: zero gradients on the card: {zero}")
    if not ok:
        raise AssertionError(f"mla: card and CPU gradients disagree at "
                             f"{worst} ({rel[worst]})")
    return out


def mla_train(params, cfg, dev: str = "cuda", B: int = MLA_B,
              T: int = MLA_T, steps: int = MLA_STEPS):
    """The Trainer at B x T for ``steps`` AdamW steps under mxfp8_e4m3 and
    bf16 from one host copy of the weights, on one batch repeated: loss
    finite and falling by [train]'s rule, one flash forward and one flash
    dgrad a step per layer (at qk dim 192, v dim 128), and two 3-step runs
    from the same state give equal losses and equal bits in every
    parameter and moment.  Returns the mxfp8_e4m3 run's launch counts.
    The batch is repeated because at 4 x 512 tokens the spread of the
    loss between fresh batches (about 0.02) hides what one layer learns in
    10 steps at lr 1e-3 (about 0.01; first chip reading, PERF.md §6)."""
    from repro_torch.core import preset
    from repro_torch.data import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.models import lm_loss
    from repro_torch.train import Trainer, TrainerConfig

    batch = lm_batch(0, cfg.vocab, B, T, SEED, device=dev)

    def trainer(name, total):
        return Trainer(lambda pp, b, q: lm_loss(pp, b, cfg, q),
                       _fresh(params, dev), preset(name), lambda s: batch,
                       tcfg=TrainerConfig(total_steps=total, peak_lr=1e-3,
                                          log_every=1))

    out = {}
    for name in ("mxfp8_e4m3", "bf16"):
        tr = trainer(name, steps)
        _peak_reset(dev)
        ops.reset_launches()
        t0 = time.perf_counter()
        hist = tr.run(steps)
        _sync(dev)
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        losses = [h["loss"] for h in hist]
        times = [h["time_s"] for h in hist]
        step_s = sorted(times[1:])[len(times[1:]) // 2]
        per_step = {k: v / steps for k, v in counts.items()}
        rec = {"steps": steps, "batch": B, "seq": T, "losses": losses,
               "step_ms": step_s * 1e3, "first_step_ms": times[0] * 1e3,
               "tokens_per_s": B * T / step_s, "wall_s": wall,
               "max_memory_allocated": _peak(dev),
               "launches_per_step": per_step}
        print(f"[mla] train {name}: {json.dumps(rec)}", flush=True)
        del tr
        _free(dev)
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"mla {name}: non-finite loss {losses}")
        first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
        if not last < first:
            raise AssertionError(f"mla {name}: loss did not fall (first 5 "
                                 f"{first}, last 5 {last})")
        want = {k: cfg.n_layers for k in ("mx_flash_attention",
                                          "mx_flash_attention_bwd")}
        got = {k: per_step.get(k, 0) for k in want}
        if dev == "cuda" and got != want:
            raise AssertionError(f"mla {name}: flash launches per step "
                                 f"{got}, expected {want}")
        if name == "mxfp8_e4m3":
            out["counts"] = counts
        runs = []
        for _ in range(2):
            rt = trainer(name, 3)
            runs.append(([h["loss"] for h in rt.run(3)],
                         _bits({"params": rt.params, "opt": rt.opt_state})))
            del rt
            _free(dev)
        same = runs[0] == runs[1]
        print(f"[mla] train {name} replay: losses {runs[0][0]} / "
              f"{runs[1][0]}, bits equal {same}", flush=True)
        if not same:
            raise AssertionError(f"mla {name}: replays differ")
        out[name] = rec
    return out


def phase_mla(rows):
    """[mla]: the lane GEMMs at deepseek-v2-236b's expert shapes and the
    2-D GEMM at its decode shapes, then the model at full width, weights
    drawn on a CUDA generator: serving on MLA_SERVE_LAYERS layers (slab
    and paged engines), the absorbed decode against the expanded form,
    then on the lead dense layer alone card-against-CPU logits and
    gradients, and training.  Returns the launch counts of the serve and
    train runs."""
    import torch
    from repro_torch.core.diagnostics import tree_leaves_with_path
    from repro_torch.models import lm_init, tree_map

    t_phase = time.perf_counter()
    cfg = mla_config(MLA_SERVE_LAYERS)
    t0 = time.perf_counter()
    params = lm_init(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                     "cuda")
    n = sum(t.numel() for _, t in tree_leaves_with_path(params))
    # The lead dense layer alone, on the host: the parity's CPU side and
    # the trainers' fresh copies.
    cfg1 = mla_config(MLA_TRAIN_LAYERS)
    one = {k: v for k, v in params.items() if k != "layers"}
    one["layers"] = params["layers"][:MLA_TRAIN_LAYERS]
    one = tree_map(lambda t: t.cpu(), one)
    print(f"[mla] {cfg.name} {cfg.n_layers} layers: {n} parameters, drawn "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    # The CPU side of the card-against-CPU logits and gradients (the plain
    # versions at full width, about 100 s) runs in a thread while the card
    # works, as in [rgemma]; 2 of the host's cores stay free for the
    # card's launches.
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads - 2))
    with ThreadPoolExecutor(1) as pool:
        cpu = pool.submit(lambda: (mla_logits(one, cfg1, "cpu"),
                                   mla_grads(one, cfg1, "cpu")))
        # serving's capacity: 64-token prompts or 4 decode rows, top-6 of
        # 160 at SERVE_CAPACITY 4 give the 32-row floor of moe._capacity
        lap = _laps("mla")
        expert_lane_kernels(rows, "mla", cfg, 32, SEED + 25)
        mla_decode_gemms(rows, cfg)
        lap("lane and decode kernels")
        serve = mla_serve(params, cfg)
        lap("serve")
        mla_absorbed(params, cfg)
        lap("absorbed")
        del params
        _free("cuda")
        card = (mla_logits(one, cfg1, "cuda"), mla_grads(one, cfg1, "cuda"))
        lap("card logits and gradients")
        train = mla_train(one, cfg1)
        lap("train")
        t0 = time.perf_counter()
        cpu = cpu.result()
    torch.set_num_threads(threads)
    print(f"[mla] waited {time.perf_counter() - t0:.1f} s for the CPU "
          "logits and gradients", flush=True)
    mla_parity(card[0], cpu[0], cfg1)
    mla_grad_parity(card[1], cpu[1])
    print(f"[mla] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"serve": serve["slab"], "paged": serve["paged"],
            "train": train["counts"]}


RG_ARCH = "recurrentgemma-9b"
# One pattern period at full width: (rec, rec, attn), 2.754 G parameters
# (embedding and lm_head 2.097 G, a rec layer 234.9 M, the attn layer
# 186.7 M): 11.0 GB of fp32 weights, 44.1 GB of weights, gradients and
# AdamW moments when training.
RG_LAYERS = 3
RG_B, RG_T, RG_STEPS = 2, 4096, 10
# Serving: 4 rows of max_len 4096 (the attn layer's ring holds the window
# of 2048); prompts below, at and past the window, so the ring wraps in
# prefill and decode writes over wrapped slots.
RG_PROMPTS = (64, 2000, 2100, 3000)
RG_MAX_LEN, RG_NEW = 4096, 32
# Decode against a teacher-forced whole-sequence forward, the reference's
# bounds (tests/test_serve.py:373-383): bf16 within atol and rtol 1e-1
# (the rec block's scan runs in another order when stepping); MX relative
# Frobenius error below 0.2 and cosine above 0.98 (decode casts p and v
# along the whole ring, the whole forward along each kv tile).
RG_BF16_TOL = 1e-1
RG_MX_REL, RG_MX_COS = 0.2, 0.98
# Card against CPU logits of the 3 layers at 64 positions, (rel_fro,
# max_abs_err): 1.5x the first reading (mxfp8_e4m3 0.06748654 / 0.3828125,
# e4m3_bf16act 0.01112247 / 0.0625; PERF.md §6, an H100 80GB HBM3 at 700
# W).
RG_LOGIT = {"mxfp8_e4m3": (1.5 * 0.06748654, 1.5 * 0.3828125),
            "e4m3_bf16act": (1.5 * 0.01112247, 1.5 * 0.0625)}
# Kernels 5 and 6 at recurrentgemma's attention shapes: (label, BH, G,
# Tq, Tk, AttnSpec arguments); BH 2 is the training batch of 2 with one
# kv head, G its 16 query heads, d = dv = 256.  The ragged case is a
# chunk of 300 queries at q_offset 2048 against 2348 keys.
RG_FLASH = (("recurrentgemma-9b train", 2, 16, 4096, 4096,
             dict(kind="window", window=2048)),
            ("ragged Tq 300 at q_offset 2048", 2, 16, 300, 2348,
             dict(kind="window", window=2048, q_offset=2048)))
RG_WINDOW_FAULT = "window one position wider"
# Kernel 7 at recurrentgemma's decode: B 4 rows, one kv head of 16
# queries, a ring of 2048 slots; rows before the wrap (pos 100, 1500) and
# after it (2500, 5000).
RG_DECODE_POS = (100, 1500, 2500, 5000)
RING, RING_WINDOW = 2048, 2048
# Faults of the ring's age rule (age <= min(pos, window - 1)).  The rule
# with one slot too many as ``age <= min(pos, window)`` gives the same mask
# as the rule wherever the ring holds min(max_len, window) <= window
# slots (every age is below S <= window), so no output can tell it apart:
# it is printed, not held.  A slot too many that can show is the slot
# after the row's last write before the wrap.
RING_SAME = "age <= min(pos, window)"
RING_FAULTS = ("age <= min(pos + 1, window - 1)",)


def rg_config(n_layers: int):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(RG_ARCH, "full"),
                               n_layers=n_layers)


def ring_mask(pos, S: int, window: int, fault=None):
    """(B, S) validity of a ring of S slots at per-row positions ``pos``
    under the age rule, or with one planted ``fault`` (RING_SAME or
    RING_FAULTS)."""
    import torch
    from repro_torch.models.attention import decode_valid_mask
    if fault is None:
        return decode_valid_mask(pos, S, window)
    age = ((pos % S)[:, None] - torch.arange(S, device=pos.device)[None]) % S
    reach = (torch.clamp(pos, max=window) if fault == RING_SAME
             else torch.clamp(pos + 1, max=window - 1))
    return age <= reach[:, None]


def sdpa_masked(q, k, v, mask):
    """PyTorch's SDPA on q (B, H, Tq, d), k and v (B, H, Tk, ·) with a
    boolean ``mask``, held to the first backend that takes it
    (memory-efficient, cuDNN, FlashAttention, then the math path).
    Returns (a function of no argument making the call, the backend's
    name)."""
    import warnings
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    for backend in (SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.FLASH_ATTENTION, SDPBackend.MATH):
        def call(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(q, k, v,
                                                      attn_mask=mask)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                call()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return call, backend.name
    return None, "none"


def rg_flash_bound(BH, G, Tq, Tk, d, dv, spec, device):
    """bound() of the flash dgrad: q, k, v, dout, out read and dq, dk, dv
    written in bf16, lse read in fp32; (6 d + 4 dv) operations a valid
    score."""
    n_valid = int(attn_valid(spec, Tq, Tk, device).sum()) * BH * G
    return bound(2 * (BH * G * Tq * 2 * (d + dv) + BH * Tk * 2 * (d + dv))
                 + 4 * BH * G * Tq, (6 * d + 4 * dv) * n_valid)


def rg_flash_kernels(rows, flush):
    """Kernels 5 and 6 at RG_FLASH (d 256 / dv 256, G 16, window 2048), in
    e4m3 and bf16 mode: each against its plain version with [kernels]'
    checks (the forward with its near-tie slack and lse, the dgrad within
    its term bound, bf16 outputs the fp32 ones rounded once, equal bits
    on a second call); the window one position wider planted in each and
    rejected, FLASH_FAULTS in the e4m3 forward at the training shape; in
    bf16 mode the forward's fp32 out against fp64 at the ragged shape.
    The dgrad's dense fp64 checks run one bh at a time (each bh is its
    own problem in the kernel); the call at the full BH, which the
    Trainer's shape gives the split dK/dV pass, must then give the per-bh
    calls' fp32 grads (and the forward their out and lse) bitwise,
    stacked.  Timed against the bound and SDPA with the window as a
    boolean mask."""
    import torch
    from repro_torch.core import E4M3, AttnSpec
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 30)
    card = torch.cuda.get_device_name(0)

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device="cuda")
                * std).bfloat16()

    def record(name, case, err, ok, ms, plain_ms, lib, bnd, **extra):
        entry = {"case": case, "max_abs_err": err, "ms": ms,
                 "plain_ms": plain_ms, "library_ms": lib,
                 "bound_ms": bnd[0], "bound_by": bnd[1], "card": card,
                 **extra}
        print(f"[rgemma] {'ok  ' if ok else 'FAIL'} {name} "
              f"{json.dumps(entry)}", flush=True)
        if not ok:
            raise AssertionError(f"rgemma {name} {case} disagrees with its "
                                 "plain version")
        rows[name]["cases"].append(entry)

    for label, BH, G, Tq, Tk, kw in RG_FLASH:
        spec = AttnSpec(**kw)
        wide = dataclasses.replace(spec, window=spec.window + 1)
        d = dv = 256
        q, k, v = rnd(BH, G, Tq, d), rnd(BH, Tk, d), rnd(BH, Tk, dv)
        dout = rnd(BH, G, Tq, dv, std=1e-2)
        valid = attn_valid(spec, Tq, Tk, q.device)
        mask = valid[None, None]
        qs, ks, vs = (q, k[:, None].expand(BH, G, Tk, d).contiguous(),
                      v[:, None].expand(BH, G, Tk, dv).contiguous())
        for fmt in (E4M3, None):
            mode = "e4m3" if fmt else "bf16"
            c = flash_fwd_case(q, k, v, fmt, spec)
            faults = {RG_WINDOW_FAULT: wide}
            check_controls(
                f"rgemma flash {label} {mode}", c["check"],
                lambda fault: ref.mx_flash_attention_ref(
                    q, k, v, fmt, faults.get(fault, spec))[0],
                (RG_WINDOW_FAULT,))
            if fmt is not None and Tq == Tk:
                check_controls(f"rgemma flash {label}", c["check"],
                               lambda fault: planted_flash(
                                   q, k, v, fmt, fault, spec=spec),
                               FLASH_FAULTS)
            extra = {}
            if fmt is None and Tq < 1024:
                ok64, kw_, pw, fw, rep = flash_fwd_fp64_case(q, k, v, spec)
                print(f"[rgemma] {'ok  ' if ok64 else 'FAIL'} flash forward "
                      f"{label} bf16 fp32 out against fp64: kernel worst "
                      f"err/tol {kw_:.3f}, plain version {pw:.3f}, "
                      f"{FLASH_FWD_FAULT!r} {fw:.2f}, replay equal {rep}",
                      flush=True)
                if not ok64:
                    raise AssertionError(f"rgemma flash forward {label} bf16 "
                                         "against fp64 disagrees")
                extra.update(fp64_worst=kw_, fp64_plain_worst=pw)
            lib, backend = None, None
            if fmt is None:
                call, backend = sdpa_masked(qs, ks, vs, mask)
                lib = call and time_ms(call, 5, flush)
            record("mx_flash_attention",
                   f"rgemma {label} BH{BH} G{G} Tq{Tq} Tk{Tk} d{d} dv{dv} "
                   f"window {spec.window} {mode} (worst err/tol "
                   f"{c['worst']:.3f}, lse err {c['lse_err']:.2e}, replay "
                   f"equal {c['replay']})", c["err"], c["ok"],
                   time_ms(lambda: ops.mx_flash_attention(q, k, v, fmt,
                                                          spec), 5, flush),
                   time_ms(lambda: ref.mx_flash_attention_ref(q, k, v, fmt,
                                                              spec), 2,
                           flush),
                   lib, flash_bound(BH, G, Tq, Tk, d, dv, spec, q.device),
                   near_tie_rows=c["ties"], sdpa_backend=backend, **extra)
            del c
            torch.cuda.empty_cache()
            # the dgrad, checked one bh at a time
            worst, errs, replays, per_bh = 0.0, [], True, []
            for b in range(BH):
                sl = (q[b:b + 1], k[b:b + 1], v[b:b + 1], dout[b:b + 1])
                c = flash_bwd_case(*sl, fmt, spec)
                args, want, bounds = c["args"], c["want"], c["bounds"]
                planted = flash_bwd_dense(*args[:7], spec=wide)[0]
                accepted, w_ = flash_bwd_check(planted, want, bounds)
                print(f"[controls] rgemma flash dgrad {label} {mode} bh {b}: "
                      f"{RG_WINDOW_FAULT!r} worst err/tol {w_:.2f} "
                      f"({'ACCEPTED' if accepted else 'rejected'})",
                      flush=True)
                if accepted:
                    raise AssertionError(f"rgemma flash dgrad {label}: the "
                                         "check accepts the planted window")
                if not c["ok"]:
                    raise AssertionError(f"rgemma flash dgrad {label} {mode} "
                                         f"bh {b}: worst {c['worst']}")
                worst = max(worst, c["worst"])
                errs.append(c["err"])
                replays = replays and c["replay"]
                per_bh.append((*args[4:6], *c["got"]))
                del c, args, want, bounds, planted
                torch.cuda.empty_cache()
            out, lse = ops.mx_flash_attention(q, k, v, fmt, spec)
            args = (q, k, v, dout, out, lse, fmt, spec)
            full = (out, lse, *ops.mx_flash_attention_bwd(
                *args, out_dtype=torch.float32))
            stacked = [torch.equal(torch.cat(parts), x)
                       for parts, x in zip(zip(*per_bh), full)]
            print(f"[rgemma] {'ok  ' if all(stacked) else 'FAIL'} flash "
                  f"{label} {mode} at BH {BH} against the per-bh calls "
                  "stacked, bitwise (out, lse, dq, dk, dv): "
                  f"{stacked}", flush=True)
            if not all(stacked):
                raise AssertionError(f"rgemma flash {label} {mode}: the BH "
                                     f"{BH} call differs from its per-bh "
                                     f"calls: {stacked}")
            del per_bh, full
            lib = None
            if fmt is None:
                qg, kg, vg = (t.detach().requires_grad_(True)
                              for t in (qs, ks, vs))
                call, backend = sdpa_masked(qg, kg, vg, mask)
                if call is not None:
                    o = call()
                    lib = time_ms(lambda: torch.autograd.grad(
                        o, (qg, kg, vg), dout, retain_graph=True), 5, flush)
                    del o
                del qg, kg, vg
            record("mx_flash_attention_bwd",
                   f"rgemma {label} BH{BH} G{G} Tq{Tq} Tk{Tk} d{d} dv{dv} "
                   f"window {spec.window} {mode} (worst err/tol "
                   f"{worst:.3f}, replay equal {replays})", max(errs), True,
                   time_ms(lambda: ops.mx_flash_attention_bwd(*args), 5,
                           flush),
                   time_ms(lambda: ref.mx_flash_attention_bwd_ref(*args), 2,
                           flush),
                   lib, rg_flash_bound(BH, G, Tq, Tk, d, dv, spec, q.device),
                   sdpa_backend=backend)
            del out, lse, args
            torch.cuda.empty_cache()
        del q, k, v, dout, qs, ks, vs, mask, valid
        torch.cuda.empty_cache()


def rg_decode_kernel(rows, flush):
    """Kernel 7 at recurrentgemma's decode: B 4, one kv head of G 16, a
    ring of 2048 slots, d = dv = 256, rows at RG_DECODE_POS: against its
    plain version (attn_check), equal bits on a second call, DECODE_FAULTS
    and RING_FAULTS planted and rejected (RING_SAME shown to give the
    rule's own mask), timed against the bound and SDPA with the ring's
    mask."""
    import torch
    from repro_torch.core import E4M3
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 31)
    B, H, G, S, d = len(RG_DECODE_POS), 1, 16, RING, 256
    q = torch.randn((B * H, G, d), generator=g, device="cuda").bfloat16()
    kc, vc = (torch.randn((B, S, H, d), generator=g,
                          device="cuda").bfloat16() for _ in range(2))
    pos = torch.tensor(RG_DECODE_POS, device="cuda")
    valid = ring_mask(pos, S, RING_WINDOW)
    same = torch.equal(ring_mask(pos, S, RING_WINDOW, RING_SAME), valid)
    print(f"[controls] rgemma decode ring: {RING_SAME!r} gives the rule's "
          f"own mask at S {S}, window {RING_WINDOW}: {same} (every age is "
          "below S <= window, so no output can tell them apart)",
          flush=True)
    card = torch.cuda.get_device_name(0)
    for fmt in (E4M3, None):
        mode = "e4m3" if fmt else "bf16"
        ok, worst, err, replay, orf = decode_case(q, kc, vc, valid, fmt)
        floor = attn_floor(vc, S)
        check_controls(f"rgemma decode ring {mode}",
                       lambda got: attn_check(got, orf, floor),
                       lambda fault: planted_decode(
                           q, kc, vc, ring_mask(pos, S, RING_WINDOW, fault),
                           fmt, None), RING_FAULTS)
        if fmt is not None:
            check_controls("rgemma decode", lambda got: attn_check(got, orf,
                                                                   floor),
                           lambda fault: planted_decode(q, kc, vc, valid,
                                                        fmt, fault),
                           DECODE_FAULTS)
        lib, backend = None, None
        if fmt is None:
            qs = q.view(B, H * G, 1, d)
            ks, vs = (t.transpose(1, 2).expand(B, G, S, d).contiguous()
                      for t in (kc, vc))
            call, backend = sdpa_masked(qs, ks, vs, valid[:, None, None, :])
            lib = call and time_ms(call, 50, flush)
        entry = {"case": f"rgemma decode B{B} H{H} G{G} ring S{S} d{d} "
                         f"dv{d} pos {list(RG_DECODE_POS)} {mode} (plan "
                         f"{ops.decode_plan(S)}; worst err/tol "
                         f"{worst:.3f}, replay equal {replay})",
                 "max_abs_err": err,
                 "ms": time_ms(lambda: ops.mx_attention_decode(
                     q, kc, vc, valid, fmt), 50, flush),
                 "plain_ms": time_ms(lambda: ref.mx_attention_decode_ref(
                     q, kc, vc, valid, fmt), 5, flush),
                 "library_ms": lib, "sdpa_backend": backend, "card": card}
        entry["bound_ms"], entry["bound_by"] = decode_bound(valid, H, G, d,
                                                            d)
        print(f"[rgemma] {'ok  ' if ok else 'FAIL'} mx_attention_decode "
              f"{json.dumps(entry)}", flush=True)
        if not ok:
            raise AssertionError(f"rgemma decode {mode}: worst err/tol "
                                 f"{worst}, replay {replay}")
        rows["mx_attention_decode"]["cases"].append(entry)
    del q, kc, vc
    torch.cuda.empty_cache()


class _Recorder:
    """Mixin of a serving engine that keeps each request's logits: the
    prefill's (its first token) and every decode step's, by rid."""

    def _prefill_one(self, req):
        logits, cache, padded = super()._prefill_one(req)
        self.logits.setdefault(req.rid, []).append(logits[0].float().cpu())
        return logits, cache, padded

    def _decode_logits(self, tok, pos):
        logits = super()._decode_logits(tok, pos)
        for i, req in enumerate(self.sched.slots):
            if req is not None:
                self.logits.setdefault(req.rid, []).append(
                    logits[i].float().cpu())
        return logits


def _decode_agrees(name, got, want):
    """Per step (row) of one request: the reference's bound for the preset.
    Returns (ok, worst readings)."""
    import torch
    diff = (got - want).abs()
    if name == "bf16":
        over = (diff / (RG_BF16_TOL + RG_BF16_TOL * want.abs())).amax(-1)
        return bool((over <= 1).all()), {"worst_over_tol": over.max().item()}
    rel = torch.linalg.norm(got - want, dim=-1) / torch.linalg.norm(
        want, dim=-1)
    cos = (got * want).sum(-1) / (torch.linalg.norm(got, dim=-1)
                                  * torch.linalg.norm(want, dim=-1))
    return (bool((rel < RG_MX_REL).all() and (cos > RG_MX_COS).all()),
            {"rel_fro_max": rel.max().item(), "cos_min": cos.min().item()})


def rg_serve(params, cfg, dev: str = "cuda"):
    """The slab ServeEngine (4 rows, max_len 4096, ring 2048) on
    RG_PROMPTS, RG_NEW greedy tokens each, under mxfp8_e4m3 and bf16:
    every request finishes; each step's logits (the prefill's and every
    decode step's) against a teacher-forced whole-sequence forward of the
    prompt and the tokens before it, under the reference's bounds; then
    PagedServeEngine on the same prompts: the slab engine's tokens, 0
    paged leaves.  Returns the launch counts of the mxfp8_e4m3 runs."""
    import numpy as np
    import torch
    from repro_torch.core import preset
    from repro_torch.kernels import ops
    from repro_torch.models import lm_apply
    from repro_torch.models.layers import qdense
    from repro_torch.serve import (PagedServeEngine, SamplingParams,
                                   ServeEngine, serving_params)

    class Slab(_Recorder, ServeEngine):
        pass

    class Paged(_Recorder, PagedServeEngine):
        pass

    rng = np.random.default_rng(SEED + 32)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32)
               for n in RG_PROMPTS]
    counts = {}
    for name in ("mxfp8_e4m3", "bf16"):
        qcfg = preset(name)
        tokens = {}
        for kind in ("slab", "paged"):
            if kind == "slab":
                eng = Slab(params, cfg, qcfg, max_batch=4,
                           max_len=RG_MAX_LEN, device=dev)
            else:
                eng = Paged(params, cfg, qcfg, max_batch=4,
                            max_len=RG_MAX_LEN, n_pages=512, page_size=32,
                            device=dev)
            eng.logits = {}
            for pr in prompts:
                eng.submit(pr, SamplingParams(max_new_tokens=RG_NEW))
            _peak_reset(dev)
            ops.reset_launches()
            t0 = time.perf_counter()
            done = eng.drain()
            _sync(dev)
            wall = time.perf_counter() - t0
            launches = dict(ops.LAUNCHES)
            st = eng.stats()
            if len(done) != len(prompts) or any(len(r.tokens) != RG_NEW
                                                for r in done):
                raise AssertionError(f"rgemma {kind} serve {name}: "
                                     f"{[len(r.tokens) for r in done]}")
            tokens[kind] = [list(map(int, r.tokens)) for r in done]
            rec = {"requests": len(done), "prompts": list(RG_PROMPTS),
                   "wall_s": wall, "prefill_tok_s": st["prefill_tok_s"],
                   "decode_tok_s": st["decode_tok_s"],
                   "decode_steps": st["decode_steps"],
                   "max_memory_allocated": _peak(dev), "launches": launches}
            if kind == "paged":
                eng.alloc.check()
                rec.update(chunked=eng.chunk,
                           paged_leaves=len(eng._pool_keys),
                           slab_leaves=len(eng._slab_keys))
                if eng._pool_keys or eng.chunk:
                    raise AssertionError("rgemma: the paged engine pages "
                                         f"{eng._pool_keys} or chunks")
            if name == "mxfp8_e4m3":
                counts[kind] = launches
            if dev == "cuda":   # bf16 mode's GEMMs are not MX GEMMs
                path = ("mx_flash_attention", "mx_attention_decode") + (
                    ("mx_quantize", "mx_matmul") if qcfg.w_fwd else ())
                idle = sorted(k for k in path if launches[k] == 0)
                if idle:
                    raise AssertionError(f"rgemma {kind} serve {name}: "
                                         f"kernels never launched: {idle}")
            if kind == "slab":   # every step against the teacher-forced one
                p = eng.params
                worst, ok = {}, True
                with torch.inference_mode():
                    for r in done:
                        seq = np.concatenate([r.prompt, np.asarray(
                            r.tokens[:-1], np.int32)])
                        h, _ = lm_apply(p, {"tokens": torch.as_tensor(
                            seq, device=dev)[None].long()}, cfg, qcfg)
                        T = r.prompt.size
                        want = qdense(p["lm_head"], h[0, T - 1:], qcfg)
                        got = torch.stack(eng.logits[r.rid])
                        good, w = _decode_agrees(name, got,
                                                 want.float().cpu())
                        ok = ok and good
                        for key, val in w.items():
                            pick = min if key == "cos_min" else max
                            worst[key] = pick(worst.get(key, val), val)
                        del h, want
                rec["against_teacher_forced"] = worst
            print(f"[rgemma] serve {kind} {name}: {json.dumps(rec)}",
                  flush=True)
            del eng
            _free(dev)
            if kind == "slab" and not ok:
                raise AssertionError(f"rgemma serve {name}: decode logits "
                                     f"outside the bounds ({worst})")
        same = tokens["paged"] == tokens["slab"]
        print(f"[rgemma] {'ok  ' if same else 'FAIL'} paged tokens equal "
              f"slab tokens {name}: {same}", flush=True)
        if not same:
            raise AssertionError(f"rgemma {name}: the paged engine's tokens "
                                 "differ from the slab engine's")
    return counts


def rg_logits(params, cfg, dev: str):
    """{preset: logits (64, vocab) fp32 on the host} of one 64-token
    prompt through ``cfg``'s layers on ``dev``, with bf16 serving weights
    made there from ``params``, under each preset of RG_LOGIT, and the
    seconds each took."""
    import numpy as np
    import torch
    from repro_torch.core import preset
    from repro_torch.models import lm_apply, tree_map
    from repro_torch.models.layers import qdense
    from repro_torch.serve import serving_params

    prompt = torch.as_tensor(np.random.default_rng(SEED + 33).integers(
        1, cfg.vocab, (1, 64)), device=dev)
    out, secs = {}, {}
    with torch.inference_mode():
        p = serving_params(tree_map(lambda t: t.to(dev), params), dev)
        for name in RG_LOGIT:
            qcfg = preset(name)
            t0 = time.perf_counter()
            h, _ = lm_apply(p, {"tokens": prompt}, cfg, qcfg)
            out[name] = qdense(p["lm_head"], h, qcfg)[0].float().cpu()
            secs[name] = time.perf_counter() - t0
            del h
        del p
    _free(dev)
    return out, secs


def rg_parity(card, cpu, cfg):
    """rg_logits' results from the card (kernels) and the CPU (plain
    versions), same bf16 serving weights: each preset within RG_LOGIT
    (1.5x the first reading; None prints the first reading)."""
    out = {}
    for name in RG_LOGIT:
        rec = _logit_diff(card[0][name], cpu[0][name])
        rec.update(layers=cfg.n_layers, seconds={"cuda": card[1][name],
                                                 "cpu": cpu[1][name]})
        if RG_LOGIT[name] is None:
            print(f"[rgemma] first reading, parity {name}: "
                  f"{json.dumps(rec)}", flush=True)
        else:
            _limit_check(f"parity {name}", rec, *RG_LOGIT[name],
                         phase="rgemma")
        out[name] = rec
    return out


def rg_scan_ms(B: int, T: int, d: int, iters: int = 5) -> float:
    """Device ms of one RG-LRU scan forward and backward at (B, T, d) fp32
    (``rglru._associative_scan`` and its autograd), CUDA events."""
    import torch
    from repro_torch.models import rglru
    g = torch.Generator(device="cuda").manual_seed(SEED + 34)
    a = torch.rand((B, T, d), generator=g, device="cuda").requires_grad_()
    b = torch.randn((B, T, d), generator=g, device="cuda").requires_grad_()
    gh = torch.randn((B, T, d), generator=g, device="cuda")

    def fn():
        A, Bc = rglru._associative_scan([a, b])
        return torch.autograd.grad(Bc, (a, b), gh)
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def rg_train(params, cfg, dev: str = "cuda", B: int = RG_B, T: int = RG_T,
             steps: int = RG_STEPS):
    """The Trainer at B x T for ``steps`` AdamW steps under mxfp8_e4m3 and
    bf16, on one repeated batch: loss finite and falling by [train]'s
    rule, one flash forward and one flash dgrad a step (the attn layer's),
    two 3-step runs giving equal bits; step ms, the RG-LRU scans' share of
    it (rg_scan_ms at the step's shape, one scan a rec layer) and peak
    memory printed.  Returns the mxfp8_e4m3 run's launch counts."""
    from repro_torch.core import preset
    from repro_torch.data import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.models import layer_kinds, lm_loss
    from repro_torch.train import Trainer, TrainerConfig

    batch = lm_batch(0, cfg.vocab, B, T, SEED, device=dev)
    n_rec = layer_kinds(cfg).count("rec")
    n_attn = layer_kinds(cfg).count("attn")

    def trainer(name, total):
        return Trainer(lambda pp, b, q: lm_loss(pp, b, cfg, q),
                       _fresh(params, dev), preset(name), lambda s: batch,
                       tcfg=TrainerConfig(total_steps=total, peak_lr=1e-3,
                                          log_every=1))

    scan = rg_scan_ms(B, T, cfg.d_rnn) if dev == "cuda" else 0.0
    out = {}
    for name in ("mxfp8_e4m3", "bf16"):
        tr = trainer(name, steps)
        _peak_reset(dev)
        ops.reset_launches()
        t0 = time.perf_counter()
        hist = tr.run(steps)
        _sync(dev)
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        losses = [h["loss"] for h in hist]
        times = [h["time_s"] for h in hist]
        step_s = sorted(times[1:])[len(times[1:]) // 2]
        per_step = {k: v / steps for k, v in counts.items()}
        rec = {"steps": steps, "batch": B, "seq": T, "losses": losses,
               "step_ms": step_s * 1e3, "first_step_ms": times[0] * 1e3,
               "tokens_per_s": B * T / step_s, "wall_s": wall,
               "scan_ms_per_layer": scan,
               "scan_share": n_rec * scan / (step_s * 1e3),
               "max_memory_allocated": _peak(dev),
               "launches_per_step": per_step}
        print(f"[rgemma] train {name}: {json.dumps(rec)}", flush=True)
        del tr
        _free(dev)
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"rgemma {name}: non-finite loss {losses}")
        first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
        if not last < first:
            raise AssertionError(f"rgemma {name}: loss did not fall (first "
                                 f"5 {first}, last 5 {last})")
        want = {k: n_attn for k in ("mx_flash_attention",
                                    "mx_flash_attention_bwd")}
        got = {k: per_step.get(k, 0) for k in want}
        if dev == "cuda" and got != want:
            raise AssertionError(f"rgemma {name}: flash launches per step "
                                 f"{got}, expected {want}")
        if name == "mxfp8_e4m3":
            out["counts"] = counts
        runs = []
        for _ in range(2):
            rt = trainer(name, 3)
            runs.append(([h["loss"] for h in rt.run(3)],
                         _bits({"params": rt.params, "opt": rt.opt_state})))
            del rt
            _free(dev)
        same = runs[0] == runs[1]
        print(f"[rgemma] train {name} replay: losses {runs[0][0]} / "
              f"{runs[1][0]}, bits equal {same}", flush=True)
        if not same:
            raise AssertionError(f"rgemma {name}: replays differ")
        out[name] = rec
    return out


def phase_rgemma(rows):
    """[rgemma]: kernels 5 and 6 at recurrentgemma's attention shapes and
    kernel 7 at its ring decode, then recurrentgemma-9b at full width,
    one pattern period (rec, rec, attn), weights drawn on a CUDA
    generator: slab and paged serving with each decode step against a
    teacher-forced forward, card against CPU logits, and training.
    Returns the launch counts of the serve, paged and train runs."""
    import torch
    from repro_torch.core.diagnostics import tree_leaves_with_path
    from repro_torch.models import lm_init, tree_map

    t_phase = time.perf_counter()
    cfg = rg_config(RG_LAYERS)
    t0 = time.perf_counter()
    params = lm_init(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                     "cuda")
    n = sum(t.numel() for _, t in tree_leaves_with_path(params))
    host = tree_map(lambda t: t.cpu(), params)
    print(f"[rgemma] {cfg.name} {cfg.n_layers} layers: {n} parameters, "
          f"drawn in {time.perf_counter() - t0:.1f} s", flush=True)
    # The CPU side of the card-against-CPU logits (the plain versions at
    # full width, about two minutes) runs in a thread while the card
    # works; it keeps 2 of the host's cores free for the card's launches.
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads - 2))
    with ThreadPoolExecutor(1) as pool:
        cpu = pool.submit(rg_logits, host, cfg, "cpu")
        flush = torch.zeros(64 * 2 ** 20, dtype=torch.uint8,
                            device="cuda").bitwise_not_
        rg_flash_kernels(rows, flush)
        rg_decode_kernel(rows, flush)
        del flush
        serve = rg_serve(params, cfg)
        del params
        _free("cuda")
        card = rg_logits(host, cfg, "cuda")
        train = rg_train(host, cfg)
        t0 = time.perf_counter()
        cpu = cpu.result()
    torch.set_num_threads(threads)
    print(f"[rgemma] waited {time.perf_counter() - t0:.1f} s for the CPU "
          "logits", flush=True)
    rg_parity(card, cpu, cfg)
    print(f"[rgemma] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"serve": serve["slab"], "paged": serve["paged"],
            "train": train["counts"]}


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("run from a checkout: src/repro_torch is missing beside this "
             "script")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import lm_init

    t_start = time.perf_counter()
    laps = [t_start]

    def lap(tag):   # wall seconds of each phase, for the 1200 s limit
        laps.append(time.perf_counter())
        print(f"[time] {tag} {laps[-1] - laps[-2]:.1f} s", flush=True)

    phase_build()
    lap("build")
    rows = phase_kernels()
    lap("kernels")
    lowbit_kernels()
    phase_scale_modes()
    lap("lowbit, scale-modes")
    rows.update(phase_lanes())
    lap("lanes")
    cfg = get_config("olmo-paper", "full")
    params = lm_init(cfg, torch.Generator().manual_seed(SEED), "cuda")
    per_prefill, per_decode = launches_per_call(params, cfg)
    counts = phase_serve(params, cfg)
    phase_parity(params, cfg)
    lap("serve, parity")
    train = phase_train(params, cfg)
    phase_grad_parity(params, cfg)
    phase_recovery(params, cfg)
    lap("train, grad-parity, recovery")
    _, guard_counts, guarded = phase_guard(params, cfg, train)
    _, snapshot_counts = phase_snapshot(guarded, cfg)
    del guarded
    lap("guard, snapshot")
    phase_proxy()
    sweep = phase_sweep()
    lap("proxy, sweep")
    phase_sweep_parity()
    lap("sweep-parity")
    paged_parity = phase_paged_parity(params, cfg)
    paged = phase_paged(params, cfg)
    lap("paged-parity, paged")
    del params
    torch.cuda.empty_cache()
    moe = phase_moe(rows)
    lap("moe")
    _free("cuda")   # moonshot's state is gone before deepseek's is drawn
    mla = phase_mla(rows)
    lap("mla")
    _free("cuda")   # deepseek's state is gone before recurrentgemma's
    rg = phase_rgemma(rows)
    lap("rgemma")

    # "launches": each kernel's count over the run of its own path under
    # mxfp8_e4m3, counts set to 0 just before it (serving for the slice-1
    # kernels, 20 training steps for the backward kernels, the paged
    # engine's bursty trace for the paged decode kernel, the fig6 sweep at
    # full budget for the lane kernels); "launches_guard" and
    # "launches_snapshot" over the [guard] autopilot's 80 steps and the
    # [snapshot] engines' serving; "launches_moe_serve" and
    # "launches_moe_train" over [moe]'s serving and its 10 mxfp8_e4m3
    # training steps, "launches_moe_paged" over its paged engine's run; "launches_mla_serve", "launches_mla_paged" and
    # "launches_mla_train" over [mla]'s slab and paged serving and its 10
    # mxfp8_e4m3 training steps; "launches_rgemma_serve",
    # "launches_rgemma_paged" and "launches_rgemma_train" over [rgemma]'s
    # slab and paged serving and its 10 mxfp8_e4m3 training steps.
    serve_path = ("mx_quantize", "mx_matmul", "mx_flash_attention",
                  "mx_attention_decode")
    train_counts = train["mxfp8_e4m3"]["counts"]
    paged_counts = paged["mxfp8_e4m3"]["launches"]["paged"]
    per_paged = paged_parity["mxfp8_e4m3"]["launches_per_paged_decode_step"]
    sweep_counts = sweep["fig6"]["launches"]
    kernels = []
    for name, (sources, replaces) in ops.KERNELS.items():
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[0],
            "sources": list(sources), "replaces": replaces,
            "launches": (counts["mxfp8_e4m3"][name] if name in serve_path
                         else paged_counts[name]
                         if name == "mx_attention_decode_paged"
                         else sweep_counts[name] if name in LANE_KERNELS
                         else train_counts[name]),
            "launches_sweep": sweep_counts[name],
            "launches_per_pack_step":
                sweep["fig6"]["launches_per_pack_step"].get(name, 0),
            "launches_serve": counts["mxfp8_e4m3"][name],
            "launches_train": train_counts[name],
            "launches_paged": paged_counts[name],
            "launches_guard": guard_counts[name],
            "launches_snapshot": snapshot_counts[name],
            "launches_moe_serve": moe["serve"][name],
            "launches_moe_paged": moe["paged"][name],
            "launches_moe_train": moe["train"][name],
            "launches_mla_serve": mla["serve"][name],
            "launches_mla_paged": mla["paged"][name],
            "launches_mla_train": mla["train"][name],
            "launches_rgemma_serve": rg["serve"][name],
            "launches_rgemma_paged": rg["paged"][name],
            "launches_rgemma_train": rg["train"][name],
            "launches_per_prefill": per_prefill[name],
            "launches_per_decode_step": per_decode[name],
            "launches_per_paged_decode_step": per_paged[name],
            "launches_per_train_step": {
                k: v["launches_per_step"][name] for k, v in train.items()},
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "timing": row["timing"], "case": row["case"],
            "cases": row["cases"]})
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
