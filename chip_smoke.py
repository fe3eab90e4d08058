#!/usr/bin/env python3
"""Quickest proof that the PyTorch port serves on an NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository checkout around this file
(``src/repro_torch``); imports nothing of JAX or of the JAX package.
Phases, each of which raises on failure:

  1. build    — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
                into ``build/repro_torch/<source hash>/`` (parallel nvcc).
  2. kernels  — each kernel against its plain PyTorch version on the card at
                the serve path's shapes (MX E4M3 and bf16 modes; flash at
                buckets 64 and 512), timed by the profiler's device time
                against the plain version and, where one exists, a PyTorch
                call.  Attention outputs are held per element; planted
                faults in the plain attention must fail that check.
  3. serve    — ``ServeEngine`` on olmo-paper (full width, n = 8) with seeded
                random weights: 8 requests under ``mxfp8_e4m3`` and under
                ``e4m3_bf16act``; every request must finish and every
                kernel of the path must have been launched.
  4. parity   — one 64-token request through ``lm_prefill`` + 8 greedy
                decode steps on the card (kernels) and on the CPU (plain
                versions) with the same weights; logits must agree.

Prints one JSON line of kernel numbers, the card's name and power limit,
and as the last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import cProfile
import io
import json
import math
import pstats
import subprocess
import sys
import time
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


def _kernel_us(prof) -> float:
    """Summed device time (µs) of the kernels a profiler window saw."""
    import torch
    total = 0.0
    for row in prof.key_averages():
        if row.device_type == torch.autograd.DeviceType.CUDA:
            total += getattr(row, "device_time_total",
                             getattr(row, "cuda_time_total", 0.0))
    return total


def time_ms(fn, iters: int, flush) -> float:
    """Device time (ms) of one ``fn`` call, L2 flushed before each.

    The profiler sums the device time of the kernels ``fn`` launches (the
    flush kernel's time, measured alone, is taken off), so host launch
    overhead is excluded.  Raises if the profiler sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn(), fn()
    torch.cuda.synchronize()
    spans = []
    for with_fn in (True, False):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush()
                if with_fn:
                    fn()
            torch.cuda.synchronize()
        spans.append(_kernel_us(prof))
    if spans[0] - spans[1] <= 0:
        raise RuntimeError(f"the profiler saw no device time for the call "
                           f"(with {spans[0]} us, flush alone {spans[1]} us)")
    return (spans[0] - spans[1]) / iters / 1e3


def bound(bytes_moved: float, flops: float):
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_f = flops / BF16_FLOP_PER_S * 1e3
    return (max(t_b, t_f), "bytes" if t_b >= t_f else "operations")


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
DECODE_FAULTS = ("p unquantized", "p quantized before normalizing",
                 "v quantized along d", "v quantized over valid slots only")


def planted_flash(q, k, v, fmt, fault):
    """The plain causal flash forward for one kv tile (every serve bucket
    fits in one: kv_chunk 1024) with one planted ``fault`` (None: none)."""
    import torch
    from repro_torch.core import quantize_mx
    from repro_torch.kernels.ref import NEG_INF

    def Q(x, axis):
        return quantize_mx(x, fmt, axis=axis)
    T = k.shape[1]
    s = torch.einsum("bgqd,bkd->bgqk", Q(q.float(), -1), Q(k.float(), -1))
    s = s * (1.0 / math.sqrt(q.shape[-1]))
    valid = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    pq = Q(p, -1)
    if fault == "p unquantized":
        pq = p
    elif fault == "p against a 32-column sub-tile max":
        ms = s.unflatten(-1, (T // 32, 32)).amax(-1, keepdim=True)
        ms = ms.expand(*ms.shape[:-1], 32).flatten(-2)
        pq = Q(torch.where(valid, torch.exp(s - ms), 0.0), -1) * torch.exp(
            ms - m)
    vq = Q(v.float(), -1 if fault == "v quantized along d" else -2)
    acc = torch.einsum("bgqk,bkd->bgqd", pq, vq)
    return (acc / l.clamp(min=1e-30)).to(q.dtype)


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


def check_controls(what, want, floor, planted, faults):
    """The fault-free planted version must pass ``attn_check`` against the
    plain version ``want`` and every planted fault must fail it."""
    ok, worst = attn_check(planted(None), want, floor)
    if not ok:
        raise AssertionError(f"{what}: fault-free control fails the check "
                             f"(worst err/tol {worst})")
    for fault in faults:
        accepted, worst = attn_check(planted(fault), want, floor)
        print(f"[controls] {what}: {fault!r} worst err/tol {worst:.2f} "
              f"({'ACCEPTED' if accepted else 'rejected'})", flush=True)
        if accepted:
            raise AssertionError(f"{what}: the check accepts the planted "
                                 f"fault {fault!r}")


def phase_build():
    from repro_torch.kernels import build
    out = build.build()
    print(f"[build] {out} in {build.last_build_seconds():.2f} s", flush=True)
    for name in build.SOURCES:
        for line in (out / f"{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def phase_kernels():
    """Each kernel against its plain version at the serve path's shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import E4M3, AttnSpec
    from repro_torch.kernels import ops, ref

    dev = "cuda"
    g = torch.Generator().manual_seed(SEED)
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_

    def rnd(*shape, dtype=torch.bfloat16, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(dtype).to(dev)

    rows = {}

    def record(name, case, primary, err, ok, ms, plain_ms, library_ms,
               bnd):
        entry = {"case": case, "max_abs_err": err, "ms": ms,
                 "plain_ms": plain_ms, "library_ms": library_ms,
                 "bound_ms": bnd[0], "bound_by": bnd[1]}
        print(f"[kernels] {'ok  ' if ok else 'FAIL'} {name} {json.dumps(entry)}",
              flush=True)
        if not ok:
            raise AssertionError(f"{name} {case} disagrees with its plain "
                                 f"version (max_abs_err {err})")
        rows.setdefault(name, {"cases": []})["cases"].append(entry)
        if primary:
            rows[name].update(entry)

    # 1. quantize: apply_norm's fp32 activations and the affine scale.
    for case, shape, primary in (("prefill xn (1,512,512) fp32", (1, 512, 512), True),
                                 ("decode xn (4,1,512) fp32", (4, 1, 512), False),
                                 ("ln scale (512,) fp32", (512,), False)):
        x = rnd(*shape, dtype=torch.float32)
        y = ops.mx_quantize(x, E4M3)
        yr = ref.mx_quantize_ref(x, E4M3)
        err = (y - yr).abs().max().item()
        n = x.numel()
        record("mx_quantize", case, primary, err, torch.equal(y, yr),
               time_ms(lambda: ops.mx_quantize(x, E4M3), 50, flush),
               time_ms(lambda: ref.mx_quantize_ref(x, E4M3), 10, flush),
               None, bound(8 * n, 0))

    # 2. GEMM: decode (M = max_batch = 4) and prefill (M = bucket 512).
    gemm_cases = (("decode lm_head 4x512x32000 e4m3/e4m3", 4, 512, 32000, E4M3, E4M3, True),
                  ("decode w_down 4x2048x512 e4m3/e4m3", 4, 2048, 512, E4M3, E4M3, False),
                  ("decode wq 4x512x512 e4m3/e4m3", 4, 512, 512, E4M3, E4M3, False),
                  ("prefill w_up 512x512x2048 e4m3/e4m3", 512, 512, 2048, E4M3, E4M3, False),
                  ("decode lm_head 4x512x32000 bf16/e4m3", 4, 512, 32000, None, E4M3, False),
                  ("prefill w_up 512x512x2048 bf16/e4m3", 512, 512, 2048, None, E4M3, False))
    for case, M, K, N, fa, fb, primary in gemm_cases:
        a = rnd(M, K)
        b = rnd(K, N, std=1.0 / math.sqrt(K))
        c = ops.mx_matmul(a, b, fa, fb)
        cr = ref.mx_matmul_ref(a, b, fa, fb)
        # Tolerance: one bf16 ulp of the result plus the fp32 accumulation
        # bound K * 2^-24 * sum_k |Q(a)||Q(b)| (the summation orders differ).
        qa = ref.mx_quantize_ref(a, fa).float().abs()
        qb = ref.mx_quantize_ref(b, fb, axis=0).float().abs()
        tol = ulp_bf16(cr.float()) + K * 2.0 ** -24 * (qa @ qb)
        diff = (c.float() - cr.float()).abs()
        record("mx_matmul", case, primary, diff.max().item(),
               bool((diff <= tol).all()),
               time_ms(lambda: ops.mx_matmul(a, b, fa, fb), 50, flush),
               time_ms(lambda: ref.mx_matmul_ref(a, b, fa, fb), 10, flush),
               time_ms(lambda: torch.matmul(a, b), 50, flush),
               bound(2 * (M * K + K * N + M * N), 2 * M * N * K))

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
            check_controls(f"flash bucket {T}", orf, floor,
                           lambda fault: planted_flash(q, k, v, fmt, fault),
                           FLASH_FAULTS)
        lib = None
        if fmt is None:   # bf16 mode: the same function exists in PyTorch
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                q[:, 0], k, v, is_causal=True), 50, flush)
        n_scores = 8 * T * (T + 1) // 2
        record("mx_flash_attention",
               f"prefill bucket {T} BH8 G1 d64 {'e4m3' if fmt else 'bf16'} "
               f"(worst err/tol {worst:.3f}, lse err {lse_err:.2e})",
               primary, (o.float() - orf.float()).abs().max().item(), ok,
               time_ms(lambda: ops.mx_flash_attention(q, k, v, fmt, spec), 20, flush),
               time_ms(lambda: ref.mx_flash_attention_ref(q, k, v, fmt, spec), 5, flush),
               lib, bound(2 * 4 * 8 * T * 64 + 4 * 8 * T, 4 * 64 * n_scores))

    # 4. decode: max_batch 4 x 8 kv heads against a 512-slot cache; the
    # invalid slots hold random K/V, as stale rows and prefill pads do.
    B, H, S = 4, 8, 512
    for fmt, primary in ((E4M3, True), (None, False)):
        q = rnd(B * H, 1, 64)
        kc, vc = rnd(B, S, H, 64), rnd(B, S, H, 64)
        pos = torch.tensor([100, 257, 400, 511], device=dev)
        valid = torch.arange(S, device=dev)[None] <= pos[:, None]
        o = ops.mx_attention_decode(q, kc, vc, valid, fmt)
        orf = ref.mx_attention_decode_ref(q, kc, vc, valid, fmt)
        floor = attn_floor(vc, S)
        ok, worst = attn_check(o, orf, floor)
        if fmt is not None:
            check_controls("decode", orf, floor,
                           lambda fault: planted_decode(q, kc, vc, valid,
                                                        fmt, fault),
                           DECODE_FAULTS)
        lib = None
        if fmt is None:
            qs = q.view(B, H, 1, 64)
            ks, vs = kc.transpose(1, 2), vc.transpose(1, 2)
            mask = valid[:, None, None, :]
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask), 50, flush)
        record("mx_attention_decode",
               f"decode B4 H8 S512 d64 {'e4m3' if fmt else 'bf16'} "
               f"(worst err/tol {worst:.3f})", primary,
               (o.float() - orf.float()).abs().max().item(), ok,
               time_ms(lambda: ops.mx_attention_decode(q, kc, vc, valid, fmt), 50, flush),
               time_ms(lambda: ref.mx_attention_decode_ref(q, kc, vc, valid, fmt), 10, flush),
               lib, bound(2 * (2 * B * S * H * 64 + 2 * B * H * 64) + B * S,
                          4 * B * H * S * 64))
    return rows


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


def profile_decode_step(sp, cfg, qcfg, cache, steps: int = 10):
    """Wall time of one batched decode step (max_batch 4) against the
    kernel time the profiler sees in it: the device's busy and idle share,
    and the kernels that take the most time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import lm_decode_step

    tok = torch.ones((4, 1), dtype=torch.long, device="cuda")
    pos = torch.tensor([100, 200, 300, 400], device="cuda")

    def run():
        for _ in range(steps):
            lm_decode_step(sp, cache, tok, pos, cfg, qcfg)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
                  for r in prof.key_averages()
                  if r.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda t: -t[1])[:8]
    out = {"wall_ms": wall_ms, "kernel_ms": busy_ms,
           "idle_share": max(0.0, 1 - busy_ms / wall_ms),
           "top_kernels_ms_per_step": top}
    print(f"[decode-step] {qcfg.describe()}: {json.dumps(out)}", flush=True)
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
    phase_build()
    rows = phase_kernels()
    cfg = get_config("olmo-paper", "full")
    params = lm_init(cfg, torch.Generator().manual_seed(SEED), "cuda")
    per_prefill, per_decode = launches_per_call(params, cfg)
    counts = phase_serve(params, cfg)
    phase_parity(params, cfg)

    kernels = []
    for name, (source, replaces) in ops.KERNELS.items():
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": counts["mxfp8_e4m3"][name],
            "launches_per_prefill": per_prefill[name],
            "launches_per_decode_step": per_decode[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "case": row["case"], "cases": row["cases"]})
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
