"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` compiles to its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds).  All sources are
compiled in parallel, one ``nvcc`` each.  The libraries go to
``<repo>/build/repro_torch/<hash>/``, where the hash covers every source and
the compiler flags, so a changed source rebuilds and an unchanged one is
loaded as it is.  Nothing is compiled or loaded when this module is
imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

__all__ = ["CSRC", "BUILD_ROOT", "NVCC_FLAGS", "source_hash", "build",
           "load", "last_build_seconds"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# -fmad=false keeps every fp32 multiply and add separately rounded, as in
# the reference; there is no --use_fast_math (expf must stay expf).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
# After the source: the backward GEMMs find libcuda's tensor-map encoder
# with dlopen (mx_gemm_sm90.cuh).
LINK_FLAGS = ["-ldl"]
SOURCES = ("mx_quant", "mx_matmul", "mx_matmul_bwd", "mx_attention",
           "mx_attention_bwd")

_LIBS: Dict[str, ctypes.CDLL] = {}
_BUILD_SECONDS: Optional[float] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine that has the card")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build(out_dir: Optional[Path] = None) -> Path:
    """Compile every source that is not built yet; returns the directory.
    The compiler's resource report (``-Xptxas -v``) is kept beside each
    library as ``<name>.log``."""
    global _BUILD_SECONDS
    out_dir = Path(out_dir or BUILD_ROOT / source_hash())
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not (out_dir / f"lib{n}.so").exists()]
    t0 = time.perf_counter()
    procs = []
    nvcc = _nvcc()
    for name in todo:
        tmp = out_dir / f".lib{name}.{os.getpid()}.so"
        log = open(out_dir / f"{name}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"),
               *LINK_FLAGS]
        procs.append((name, tmp, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for name, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc:
            failed.append(name)
        else:
            os.replace(tmp, out_dir / f"lib{name}.so")
    if failed:
        logs = "\n".join((out_dir / f"{n}.log").read_text() for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    _BUILD_SECONDS = time.perf_counter() - t0
    return out_dir


def last_build_seconds() -> Optional[float]:
    """Seconds the last :func:`build` in this process spent compiling."""
    return _BUILD_SECONDS


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, building it first if needed."""
    if name not in _LIBS:
        out_dir = build()
        for n in SOURCES:
            _LIBS[n] = ctypes.CDLL(str(out_dir / f"lib{n}.so"))
    return _LIBS[name]
