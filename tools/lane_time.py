"""The lane GEMMs' device time by kernel, beside 8 calls of the 2-D kernel
and torch.bmm, at the sweeps' shapes, on one card.

    python3 tools/lane_time.py

Times ``ops.mx_matmul_lanes``, ``mx_matmul_dgrad_lanes`` and
``mx_matmul_wgrad_lanes`` (8 lanes, fp32 operands, E4M3 under "floor") with
``chip_smoke.time_parts_ms`` (L2 flushed before each call, profiler device
time) split by kernel name, the same work as 8 calls of the 2-D kernel,
the plain lane version and ``torch.bmm`` of the unquantized operands,
at the fig6 preset's
shapes (batch 256, d 128, hidden 512) and ProxyConfig()'s (2048, 512,
2048).  Prints one ``[lane-time]`` JSON line per case, then the card's
name and power limit.  Needs a CUDA card.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    from repro_torch.core import E4M3

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    cs.phase_build()
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    flush = torch.zeros(64 * 2 ** 20, dtype=torch.uint8,
                        device="cuda").bitwise_not_
    for label, B, d, h in cs.LANE_SIZES:
        for kind, name in zip(("fwd", "dgrad", "wgrad"), cs.LANE_KERNELS):
            a, b = cs.lane_operands(kind, B, d, h, E4M3, g)
            fn, fn2, plain, _ = cs.lane_fns(kind)
            ms, parts = cs.time_parts_ms(lambda: fn(a, b, E4M3, E4M3), 20,
                                         flush)
            two = cs.time_ms(lambda: [fn2(a[i], b[i], E4M3, E4M3)
                                      for i in range(cs.LANES)], 20, flush)
            plain_ms = cs.time_ms(lambda: plain(a, b, E4M3, E4M3), 3, flush)
            lib = cs.time_ms(cs.lane_library(kind, a, b), 20, flush)
            bnd, by = cs.lane_bound(kind, a, b)
            print("[lane-time] " + json.dumps({
                "kernel": name, "size": label, "lanes": cs.LANES,
                "shape": [list(a.shape), list(b.shape)], "ms": ms,
                "two_d_x_lanes_ms": two, "plain_ms": plain_ms,
                "bmm_ms": lib, "bound_ms": bnd,
                "bound_by": by, "events_timed": cs.EVENT_TIMED[0],
                "parts_ms": parts}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
