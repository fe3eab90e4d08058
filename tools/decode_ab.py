"""The MX decode kernel (kernel 7) built at several head-group plans and
beside another checkout's, timed on one card in one process.

    python3 tools/decode_ab.py [OTHER_CHECKOUT]

Builds this checkout's ``csrc/mx_attention.cu`` once for each
``(DEC_GROUP, DEC_WIDE_THREADS)`` of VARIANTS (the first is the source's own
default) and, when given, OTHER_CHECKOUT's as "other", each into
``build/decode_ab/<name>/``.  Every case runs through ``ops``'s wrapper on
each library: held against the plain version (``chip_smoke.attn_check``),
called twice for equal bits, and compared bitwise with the first library
that ran it.  The cases at G <= 8 (the serve shape and chip_smoke's
DECODE_EDGES, and the paged kernel's rows) run on "other" and the default
only; the cases at G > 8 (recurrentgemma's ring decode at G 16, and G 12
and two small wide shapes) on every variant.  Each library is timed twice,
in the order A..Z then Z..A, with ``chip_smoke.time_ms``; the last line is
one JSON object of the times with the card's name and power limit.
Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

# (DEC_GROUP, DEC_WIDE_THREADS): heads of a wide CTA and its threads
VARIANTS = ((8, 512), (8, 256), (4, 512))


def _build(libs) -> None:
    from repro_torch.kernels import build
    procs = []
    for name, src, flags in libs:
        out = ROOT / "build" / "decode_ab" / name
        out.mkdir(parents=True, exist_ok=True)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(src.parent),
               *flags, "-o", str(out / "libmx_attention.so"), str(src),
               *build.LINK_FLAGS]
        procs.append((name, subprocess.Popen(
            cmd, stdout=open(out / "log", "w"), stderr=subprocess.STDOUT)))
    for name, proc in procs:
        if proc.wait():
            sys.exit((ROOT / "build" / "decode_ab" / name / "log")
                     .read_text())
    for name, _, _ in libs:   # ptxas: the decode kernels at LPR 32
        fn = ""
        for line in (ROOT / "build" / "decode_ab" / name / "log"
                     ).read_text().splitlines():
            if "Function properties" in line:
                fn = line.split("for", 1)[1].strip()
            elif "registers" in line and "decode" in fn and "Li32E" in fn:
                print(f"[decode-ab] {name} {fn}: {line.split(':', 1)[1]}",
                      flush=True)


def _cases():
    import torch
    import chip_smoke as cs
    from repro_torch.core import E4M3
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 32)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()
    out = []
    pos = torch.tensor([100, 257, 400, 511], device="cuda")
    for fmt in (E4M3, None):
        out.append((f"B4 H8 G1 S512 d64 {'e4m3' if fmt else 'bf16'}",
                    rnd(32, 1, 64), rnd(4, 512, 8, 64), rnd(4, 512, 8, 64),
                    torch.arange(512, device="cuda")[None] <= pos[:, None],
                    fmt))
    for label, B, H, G, S, hole, d, dv in cs.DECODE_EDGES:
        out.append((f"edge {label}: B{B} H{H} G{G} S{S} d{d} dv{dv} e4m3",
                    rnd(B * H, G, d), rnd(B, S, H, d), rnd(B, S, H, dv),
                    cs.decode_valid(B, S, hole, "cuda"), E4M3))
    out.append(("wide B2 H2 G16 S300 d64 e4m3", rnd(4, 16, 64),
                rnd(2, 300, 2, 64), rnd(2, 300, 2, 64),
                cs.decode_valid(2, 300, False, "cuda"), E4M3))
    out.append(("wide B2 H1 G16 S300 d100, a span with no valid slot, bf16",
                rnd(2, 16, 100), rnd(2, 300, 1, 100), rnd(2, 300, 1, 100),
                cs.decode_valid(2, 300, True, "cuda"), None))
    rpos = torch.tensor(cs.RG_DECODE_POS, device="cuda")
    for G in (16, 12):
        for fmt in (E4M3, None):
            out.append((f"ring B4 H1 G{G} S2048 d256 "
                        f"{'e4m3' if fmt else 'bf16'}", rnd(4, G, 256),
                        rnd(4, 2048, 1, 256), rnd(4, 2048, 1, 256),
                        cs.ring_mask(rpos, 2048, cs.RING_WINDOW), fmt))
    return out


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build, ops, ref
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    src = build.CSRC / "mx_attention.cu"
    libs = [(f"g{gr}t{nt}", src, [f"-DDEC_GROUP={gr}",
                                  f"-DDEC_WIDE_THREADS={nt}"])
            for gr, nt in VARIANTS]
    if len(sys.argv) > 1:
        other = Path(sys.argv[1]).resolve() / "src/repro_torch/kernels/csrc"
        libs.insert(0, ("other", other / "mx_attention.cu", []))
    t0 = time.perf_counter()
    _build(libs)
    print(f"[decode-ab] built {len(libs)} libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    narrow = {"other", libs[-len(VARIANTS)][0]}
    flush = torch.zeros(64 * 2 ** 20, dtype=torch.uint8,
                        device="cuda").bitwise_not_
    cases = _cases()
    first, times, ok_all = {}, {}, True
    names = [n for n, _, _ in libs]
    for rnd_i, order in enumerate((names, names[::-1])):
        for name in order:
            build._LIBS.clear()
            build._LIBS["mx_attention"] = ctypes.CDLL(
                str(ROOT / "build" / "decode_ab" / name /
                    "libmx_attention.so"))
            ops._FNS.clear()
            for label, q, kc, vc, valid, fmt in cases:
                wide = q.shape[1] > 8
                if (wide and name == "other") or (not wide and
                                                  name not in narrow):
                    continue

                def call():
                    return ops.mx_attention_decode(q, kc, vc, valid, fmt)
                if rnd_i == 0:
                    o = call()
                    orf = ref.mx_attention_decode_ref(q, kc, vc, valid, fmt)
                    ok, worst = cs.attn_check(
                        o, orf, cs.attn_floor(vc, kc.shape[1]))[:2]
                    same = torch.equal(first.setdefault(label, o), o)
                    replay = torch.equal(o, call())
                    good = ok and same and replay
                    print(f"[decode-ab] {'ok  ' if good else 'FAIL'} {name} "
                          f"{label}: worst err/tol {worst:.3f}, replay "
                          f"equal {replay}, equal to the first library's "
                          f"{same}", flush=True)
                    ok_all = ok_all and good
                times.setdefault(label, {}).setdefault(name, []).append(
                    cs.time_ms(call, 50, flush))
            if rnd_i == 0 and name in narrow:
                rows = []
                cs.paged_kernels(lambda n, case, primary, err, ok, ms, *a,
                                 **k: rows.append((case, ok, ms)), flush)
                for case, ok, ms in rows:
                    times.setdefault(case, {}).setdefault(name, []).append(ms)
    for label, q, kc, vc, valid, fmt in cases[-4:]:
        times[label]["plain"] = [cs.time_ms(
            lambda: ref.mx_attention_decode_ref(q, kc, vc, valid, fmt), 5,
            flush)]
    print(json.dumps({"card": card, "ok": ok_all, "times_ms": times}),
          flush=True)
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
