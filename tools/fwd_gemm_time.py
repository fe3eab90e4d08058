"""The forward MX GEMM's device time by kernel, beside torch.matmul, at the
main path's shapes, in one or more checkouts on one card.

    python3 tools/fwd_gemm_time.py ROOT [ROOT ...]

For each checkout, in a process of its own and in the order given, times
``ops.mx_matmul`` (E4M3 operands) with ``chip_smoke.time_parts_ms`` (L2
flushed before each call, profiler device time) split by kernel name, and
the unquantized ``torch.matmul`` on the same inputs, at the decode rows
(4 and 6), the chunked prefill's 64, the prefill bucket's 512 and the
training step's 4096 against olmo-paper's lm_head and w_up, and the
lm_head under "adaptive".  Prints one ``[fwd]`` JSON line per case.
Needs a CUDA card; each checkout builds its kernels into its own
``build/``.
"""
from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

CASES = ((4, 512, 32000, "floor"), (4, 512, 32000, "adaptive"),
         (6, 512, 32000, "floor"), (4, 2048, 512, "floor"),
         (64, 512, 32000, "floor"), (512, 512, 2048, "floor"),
         (4096, 512, 32000, "floor"), (4096, 512, 32000, "adaptive"),
         (4096, 512, 2048, "floor"))


def one(root: Path) -> None:
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    from repro_torch.core import E4M3
    from repro_torch.kernels import ops

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    cs.phase_build()
    g = torch.Generator().manual_seed(cs.SEED)
    flush = torch.zeros(64 * 2 ** 20, dtype=torch.uint8,
                        device="cuda").bitwise_not_
    for M, K, N, mode in CASES:
        a = (torch.randn(M, K, generator=g)).bfloat16().cuda()
        b = (torch.randn(K, N, generator=g) / math.sqrt(K)).bfloat16().cuda()
        ms, parts = cs.time_parts_ms(
            lambda: ops.mx_matmul(a, b, E4M3, E4M3, scale_mode=mode), 20,
            flush)
        lib = cs.time_ms(lambda: torch.matmul(a, b), 20, flush)
        print("[fwd] " + json.dumps({
            "root": str(root), "M": M, "K": K, "N": N, "scale_mode": mode,
            "plan": ops.fwd_gemm_plan(M, N, K), "ms": ms, "torch_ms": lib,
            "parts_ms": parts}), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        one(Path(sys.argv[2]).resolve())
        return 0
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
