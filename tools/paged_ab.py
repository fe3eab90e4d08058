"""The paged decode step and the paged engine, A/B between two checkouts
on one card.

    python3 tools/paged_ab.py ROOT_A ROOT_B

Runs each checkout's ``chip_smoke.py`` paged phases in a process of its
own, in the order A, B, B, A: ``[paged-parity]`` (with its profile of one
paged decode step, 4 rows, under both presets), a slab decode step at the
same rows and positions, and ``[paged]`` (the bursty trace) under
``mxfp8_e4m3``.  Prints one ``[ab]`` JSON line per run with the decode
steps' wall and kernel ms and idle share and the engines' decode tok/s.
Needs a CUDA card; the checkouts must be complete (their kernels are built
into each one's ``build/``).
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path


def one(root: Path, label: str) -> None:
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import preset
    from repro_torch.models import init_cache, lm_init
    from repro_torch.serve import serving_params

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    cs.phase_build()
    cfg = get_config("olmo-paper", "full")
    params = lm_init(cfg, torch.Generator().manual_seed(cs.SEED), "cuda")
    parity = cs.phase_paged_parity(params, cfg)
    sp = serving_params(params, "cuda")
    keys = ("wall_ms", "kernel_ms", "idle_share")
    steps = {}
    for name, rec in parity.items():
        slab = cs.profile_decode_step(
            sp, cfg, preset(name), init_cache(cfg, 4, cs.PAGED_MAX_LEN,
                                              "cuda"),
            pos=[40, 100, 150, 230])
        steps[name] = {"paged": {k: rec["decode_step"][k] for k in keys},
                       "slab": {k: slab[k] for k in keys}}
    paged = cs.phase_paged(params, cfg, presets=("mxfp8_e4m3",))
    print("[ab] " + json.dumps({
        "tree": label, "decode_step": steps,
        "trace_mxfp8_e4m3": {k: paged["mxfp8_e4m3"][k] for k in (
            "slab", "paged", "paged_over_slab_decode_tok_s")}}),
        flush=True)


def main() -> int:
    if sys.argv[1] == "--one":
        one(Path(sys.argv[2]).resolve(), sys.argv[3])
        return 0
    a, b = sys.argv[1:3]
    for root, label in ((a, "A"), (b, "B"), (b, "B"), (a, "A")):
        subprocess.run([sys.executable, __file__, "--one", root, label],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
