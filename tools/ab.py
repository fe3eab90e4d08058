"""Step times A/B between two checkouts on one card.

    python3 tools/ab.py ROOT_A ROOT_B [paged] [step] [kernels]

Runs each checkout's ``chip_smoke.py`` phases in a process of its own, in
the order A, B, B, A, and prints one ``[ab]`` JSON line per run, with the
card's name and power limit:

  * ``paged`` — ``[paged-parity]`` (with its profile of one paged decode
    step, 4 rows, under both presets), a slab decode step at the same rows
    and positions, and ``[paged]`` (the bursty trace) under
    ``mxfp8_e4m3``: the decode steps' wall and kernel ms and idle share
    and the engines' decode tok/s;
  * ``step`` — the training phase (olmo-paper full, 20 steps at batch
    8 x 512 under ``mxfp8_e4m3`` and ``e4m3_bf16act``) and a profiled slab
    decode step (4 rows of a 512-slot cache, both presets): each preset's
    step ms, tokens/s, kernel ms per step, idle share and kernel ms by
    family, and the decode steps' wall and kernel ms and idle share;
  * ``kernels`` — the device time of the flash forward (BH 64, T 512,
    d 64 causal, the training shape, and the serve bucket of 512, BH 8;
    e4m3 and bf16 mode, PyTorch's FlashAttention (SDPA held to its flash
    backend) beside bf16 mode), the MX quantize (the
    training step's ``xn`` (4096, 512) fp32 and (1, 512, 512) fp32) and
    the flash dgrad (BH 64, T 512, e4m3), each with its bound, timed for
    both trees by this tree's ``chip_smoke.time_ms``.

With no phase named, ``paged`` and ``step`` run.  Needs a CUDA card; the
checkouts must be complete (their kernels are built into each one's
``build/``).
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

PHASES = ("paged", "step", "kernels")
KEYS = ("wall_ms", "kernel_ms", "idle_share")
HERE = Path(__file__).resolve().parents[1]


def _load_chip_smoke(root: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def paged(cs, params, cfg, sp) -> dict:
    from repro_torch.core import preset
    from repro_torch.models import init_cache

    parity = cs.phase_paged_parity(params, cfg)
    steps = {}
    for name, rec in parity.items():
        slab = cs.profile_decode_step(
            sp, cfg, preset(name), init_cache(cfg, 4, cs.PAGED_MAX_LEN,
                                              "cuda"),
            pos=[40, 100, 150, 230])
        steps[name] = {"paged": {k: rec["decode_step"][k] for k in KEYS},
                       "slab": {k: slab[k] for k in KEYS}}
    trace = cs.phase_paged(params, cfg, presets=("mxfp8_e4m3",))
    return {"decode_step": steps,
            "trace_mxfp8_e4m3": {k: trace["mxfp8_e4m3"][k] for k in (
                "slab", "paged", "paged_over_slab_decode_tok_s")}}


def step(cs, params, cfg, sp) -> dict:
    import torch
    from repro_torch.core import preset
    from repro_torch.models import init_cache

    train = cs.phase_train(params, cfg)
    decode = {}
    with torch.inference_mode():
        cache = init_cache(cfg, 4, 512, "cuda")
        for name in train:
            rec = cs.profile_decode_step(sp, cfg, preset(name), cache)
            decode[name] = {k: rec[k] for k in KEYS}
    return {"train": {name: {k: rec[k] for k in (
        "step_ms", "tokens_per_s", "kernel_ms_per_step", "idle_share",
        "kernel_ms_by_family")} for name, rec in train.items()},
        "decode_step": decode}


def kernels(cs, params, cfg, sp) -> dict:
    import torch
    from repro_torch.core import E4M3, AttnSpec
    from repro_torch.kernels import ops

    # Both trees' kernels are timed by this tree's timer and SDPA call.
    cs = _load_chip_smoke(HERE, "chip_smoke_timer")
    g = torch.Generator().manual_seed(cs.SEED)
    buf = torch.zeros(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = buf.bitwise_not_

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g).to(dtype).to("cuda")
    out = {}
    for BH, T in ((64, 512), (8, 512)):
        q, k, v = rnd(BH, 1, T, 64), rnd(BH, T, 64), rnd(BH, T, 64)
        spec = AttnSpec()
        bnd = cs.bound(2 * 4 * BH * T * 64 + 4 * BH * T,
                       4 * 64 * BH * T * (T + 1) // 2)
        for fmt in (E4M3, None):
            out[f"flash fwd BH{BH} T{T} {'e4m3' if fmt else 'bf16'}"] = {
                "ms": cs.time_ms(lambda: ops.mx_flash_attention(
                    q, k, v, fmt, spec), 20, flush), "bound_ms": bnd[0]}
        out[f"flash fwd BH{BH} T{T} SDPA"] = {
            "ms": cs.time_ms(lambda: cs.sdpa_flash(q[:, 0], k, v), 20,
                             flush)}
        if BH == 64:
            dout = rnd(BH, 1, T, 64) * 1e-2
            o, lse = ops.mx_flash_attention(q, k, v, E4M3, spec)
            out[f"flash dgrad BH{BH} T{T} e4m3"] = {
                "ms": cs.time_ms(lambda: ops.mx_flash_attention_bwd(
                    q, k, v, dout, o, lse, E4M3, spec), 20, flush)}
    for shape in ((4096, 512), (1, 512, 512)):
        x = rnd(*shape, dtype=torch.float32)
        out[f"quantize {shape} fp32"] = {
            "ms": cs.time_ms(lambda: ops.mx_quantize(x, E4M3), 50, flush),
            "bound_ms": cs.bound(8 * x.numel(), 0)[0]}
    return out


def one(root: Path, label: str, phases) -> None:
    sys.path.insert(0, str(root / "src"))
    cs = _load_chip_smoke(root, "chip_smoke")
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm_init
    from repro_torch.serve import serving_params

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    cs.phase_build()
    cfg = get_config("olmo-paper", "full")
    params = lm_init(cfg, torch.Generator().manual_seed(cs.SEED), "cuda")
    sp = serving_params(params, "cuda")
    runs = {"paged": paged, "step": step, "kernels": kernels}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    rec = {"tree": label, "card": card}
    for name in phases:
        rec[name] = runs[name](cs, params, cfg, sp)
    print("[ab] " + json.dumps(rec), flush=True)


def main() -> int:
    if sys.argv[1] == "--one":
        one(Path(sys.argv[2]).resolve(), sys.argv[3], sys.argv[4:])
        return 0
    a, b, *phases = sys.argv[1:]
    if not set(phases) <= set(PHASES):
        sys.exit(f"phases are {PHASES}")
    for root, label in ((a, "A"), (b, "B"), (b, "B"), (a, "A")):
        subprocess.run([sys.executable, __file__, "--one", root, label,
                        *(phases or PHASES[:2])], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
