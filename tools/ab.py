"""Step times A/B between two checkouts on one card.

    python3 tools/ab.py ROOT_A ROOT_B [paged] [step]

Runs each checkout's ``chip_smoke.py`` phases in a process of its own, in
the order A, B, B, A, and prints one ``[ab]`` JSON line per run:

  * ``paged`` — ``[paged-parity]`` (with its profile of one paged decode
    step, 4 rows, under both presets), a slab decode step at the same rows
    and positions, and ``[paged]`` (the bursty trace) under
    ``mxfp8_e4m3``: the decode steps' wall and kernel ms and idle share
    and the engines' decode tok/s;
  * ``step`` — the training phase (olmo-paper full, 20 steps at batch
    8 x 512 under ``mxfp8_e4m3`` and ``e4m3_bf16act``) and a profiled slab
    decode step (4 rows of a 512-slot cache, both presets): each preset's
    step ms, tokens/s, kernel ms per step, idle share and kernel ms by
    family, and the decode steps' wall and kernel ms and idle share.

With no phase named, both run.  Needs a CUDA card; the checkouts must be
complete (their kernels are built into each one's ``build/``).
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

PHASES = ("paged", "step")
KEYS = ("wall_ms", "kernel_ms", "idle_share")


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


def one(root: Path, label: str, phases) -> None:
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
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
    runs = {"paged": paged, "step": step}
    rec = {"tree": label}
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
                        *(phases or PHASES)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
