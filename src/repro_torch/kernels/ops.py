"""Wrappers of the CUDA kernels.

Each wrapper checks device, dtype, shape and contiguity, launches its kernel
on PyTorch's current stream and adds one to its launch count.  For tensors
on the CPU it calls the kernel's plain version in ``ref.py`` instead; for
CUDA tensors it launches the kernel or raises (there is no fallback).  The
kernels implement the "floor" scale rule only, as the Pallas kernels do;
other scale modes raise ``NotImplementedError`` on CUDA.

Counterpart of ``repro.kernels.ops``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from repro_torch.core.attnspec import AttnSpec
from repro_torch.core.formats import ElementFormat
from repro_torch.core.mx import MX_BLOCK
from . import build, ref

__all__ = ["mx_quantize", "mx_matmul", "mx_flash_attention",
           "mx_attention_decode", "LAUNCHES", "reset_launches", "KERNELS"]

#: Launch count of each kernel: one per launch, counted only where the
#: kernel is launched (never for the plain versions).
LAUNCHES: Dict[str, int] = {"mx_quantize": 0, "mx_matmul": 0,
                            "mx_flash_attention": 0,
                            "mx_attention_decode": 0}

#: name -> (source file, the Pallas function it replaces)
KERNELS = {
    "mx_quantize": ("src/repro_torch/kernels/csrc/mx_quant.cu",
                    "src/repro/kernels/mx_quant.py:66"),
    "mx_matmul": ("src/repro_torch/kernels/csrc/mx_matmul.cu",
                  "src/repro/kernels/mx_matmul.py:63"),
    "mx_flash_attention": ("src/repro_torch/kernels/csrc/mx_attention.cu",
                           "src/repro/kernels/mx_attention.py:156"),
    "mx_attention_decode": ("src/repro_torch/kernels/csrc/mx_attention.cu",
                            "src/repro/kernels/mx_attention.py:455"),
}

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_FMT = [_I, _I, _I, _F]
_SIGNATURES = {
    "mx_quantize_lastdim": ("mx_quant", [_P, _P, _LL, _I, _I, *_FMT, _P]),
    "mx_matmul_bf16": ("mx_matmul", [_P, _P, _P, _P, _I, _I, _I, _I, *_FMT,
                                     _I, *_FMT, _P]),
    "mx_matmul_splits": ("mx_matmul", [_I, _I, _I]),
    "mx_decode_smem_bytes": ("mx_attention", [_I, _I, _I, _I]),
    "mx_flash_fwd": ("mx_attention", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                      _I, _I, _I, _I, _I, _I, *_FMT, _F,
                                      _P]),
    "mx_attn_decode": ("mx_attention", [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                        _I, _I, _LL, _LL, _LL, _LL, _LL, _LL,
                                        _LL, _I, *_FMT, _F, _P]),
}
_FNS: Dict[str, ctypes._CFuncPtr] = {}
_KIND = {"causal": 0, "full": 1, "window": 2}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _fn(name: str):
    if name not in _FNS:
        lib_name, argtypes = _SIGNATURES[name]
        fn = getattr(build.load(lib_name), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def _launch(counter: str, name: str, *args) -> None:
    rc = _fn(name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed to launch: CUDA error {rc}")
    LAUNCHES[counter] += 1


def _fmt_args(fmt: Optional[ElementFormat]):
    if fmt is None:
        return [0, 0, 0, 0.0]
    return [fmt.mbits, fmt.min_normal_exp, fmt.e_max, fmt.max_normal]


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: all operands must be on the same CUDA "
                             f"device, got {t.device}")


def _check_mx(name: str, fmt, block: int, scale_mode: str) -> None:
    if fmt is not None and scale_mode != "floor":
        raise NotImplementedError(
            f"{name}: the CUDA kernels implement the 'floor' scale rule only, "
            f"not {scale_mode!r} (queued in ROADMAP.md)")
    if fmt is not None and block != MX_BLOCK:
        raise NotImplementedError(
            f"{name}: the CUDA kernels use {MX_BLOCK}-wide MX blocks, "
            f"not {block}")


def mx_quantize(x: torch.Tensor, fmt: Optional[ElementFormat],
                axis: int = -1, block: int = MX_BLOCK,
                scale_mode: str = "floor") -> torch.Tensor:
    """Quantize-dequantize along ``axis`` for any rank (fp32 or bf16)."""
    if fmt is None:
        return x
    if not x.is_cuda:
        return ref.mx_quantize_ref(x, fmt, axis, block, scale_mode)
    _check_mx("mx_quantize", fmt, block, scale_mode)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mx_quantize: float32 or bfloat16, got {x.dtype}")
    xm = torch.movedim(x, axis, -1).contiguous()
    y = torch.empty_like(xm)
    K = xm.shape[-1]
    M = xm.numel() // max(K, 1)
    _launch("mx_quantize", "mx_quantize_lastdim", xm.data_ptr(), y.data_ptr(),
            M, K, int(x.dtype == torch.bfloat16), *_fmt_args(fmt))
    return torch.movedim(y, -1, axis)


def mx_matmul(a: torch.Tensor, b: torch.Tensor,
              fmt_a: Optional[ElementFormat],
              fmt_b: Optional[ElementFormat], block: int = MX_BLOCK,
              scale_mode: str = "floor") -> torch.Tensor:
    """``Q(a) (..., K) @ Q(b) (K, N)`` with fp32 accumulation, in a.dtype."""
    if not a.is_cuda:
        return ref.mx_matmul_ref(a, b, fmt_a, fmt_b, block, scale_mode)
    _check_cuda("mx_matmul", a, b)
    _check_mx("mx_matmul", fmt_a, block, scale_mode)
    _check_mx("mx_matmul", fmt_b, block, scale_mode)
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"mx_matmul: bfloat16 operands, got {a.dtype}, "
                        f"{b.dtype}")
    if b.ndim != 2 or a.shape[-1] != b.shape[0]:
        raise ValueError(f"mx_matmul: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    K, N = b.shape
    a2 = a.reshape(-1, K).contiguous()
    b = b.contiguous()
    M = a2.shape[0]
    c = torch.empty((M, N), dtype=torch.bfloat16, device=a.device)
    # Split-K scratch: the kernel sums the fp32 partials in a second pass
    # (one launch of the wrapper, counted once).
    splits = _fn("mx_matmul_splits")(M, N, K)
    work = (torch.empty((splits, M, N), dtype=torch.float32, device=a.device)
            if splits > 1 else None)
    _launch("mx_matmul", "mx_matmul_bf16", a2.data_ptr(), b.data_ptr(),
            c.data_ptr(), None if work is None else work.data_ptr(), M, N, K,
            int(fmt_a is not None),
            *_fmt_args(fmt_a), int(fmt_b is not None), *_fmt_args(fmt_b))
    return c.reshape(a.shape[:-1] + (N,))


def mx_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       fmt: Optional[ElementFormat], spec: AttnSpec,
                       block: int = MX_BLOCK, scale_mode: str = "floor"):
    """Flash forward on the folded layout q (BH,G,Tq,d), k (BH,Tk,d),
    v (BH,Tk,dv) -> (out (BH,G,Tq,dv) bf16, lse (BH,G,Tq) fp32)."""
    if not q.is_cuda:
        return ref.mx_flash_attention_ref(q, k, v, fmt, spec, block,
                                          scale_mode)
    _check_cuda("mx_flash_attention", q, k, v)
    _check_mx("mx_flash_attention", fmt, block, scale_mode)
    if spec.kind not in _KIND:
        raise NotImplementedError(
            f"mx_flash_attention: mask kind {spec.kind!r} (decode kinds go "
            "through mx_attention_decode)")
    if {q.dtype, k.dtype, v.dtype} != {torch.bfloat16}:
        raise TypeError("mx_flash_attention: bfloat16 q, k and v")
    BH, G, Tq, d = q.shape
    Tk, dv = k.shape[1], v.shape[-1]
    if k.shape != (BH, Tk, d) or v.shape[:2] != (BH, Tk):
        raise ValueError(f"mx_flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if d > 128 or dv > 128:
        raise NotImplementedError("mx_flash_attention: head dims up to 128")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((BH, G, Tq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((BH, G, Tq), dtype=torch.float32, device=q.device)
    tile_k = ref.attn_tiles(spec, Tq, Tk)[1]
    _launch("mx_flash_attention", "mx_flash_fwd", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), lse.data_ptr(), BH, G, Tq, Tk, d,
            dv, _KIND[spec.kind], spec.window, spec.q_offset, tile_k,
            int(fmt is not None), *_fmt_args(fmt), 1.0 / math.sqrt(d))
    return out, lse


def mx_attention_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        valid: torch.Tensor, fmt: Optional[ElementFormat],
                        block: int = MX_BLOCK,
                        scale_mode: str = "floor") -> torch.Tensor:
    """Decode attention, q (BH, G, d) against k/v in the folded layout
    (BH, S, ·) with valid (BH, S), or in the cache layout (B, S, Hkv, ·)
    with valid (B, S); the kernel reads either through strides."""
    if not q.is_cuda:
        return ref.mx_attention_decode_ref(q, k, v, valid, fmt, block,
                                           scale_mode)
    _check_cuda("mx_attention_decode", q, k, v, valid)
    _check_mx("mx_attention_decode", fmt, block, scale_mode)
    if {q.dtype, k.dtype, v.dtype} != {torch.bfloat16}:
        raise TypeError("mx_attention_decode: bfloat16 q, k and v")
    if valid.dtype != torch.bool:
        raise TypeError("mx_attention_decode: bool validity mask")
    k4 = k if k.ndim == 4 else k.unsqueeze(2)
    v4 = v if v.ndim == 4 else v.unsqueeze(2)
    B, S, H, d = k4.shape
    dv = v4.shape[-1]
    BH, G = q.shape[0], q.shape[1]
    if (BH != B * H or q.shape[2] != d or v4.shape[:3] != (B, S, H)
            or valid.shape != (B, S)):
        raise ValueError(f"mx_attention_decode: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(valid.shape)}")
    if k4.stride(-1) != 1 or v4.stride(-1) != 1:
        raise ValueError("mx_attention_decode: head dim must be contiguous")
    if (G > 8 or dv > 128
            or _fn("mx_decode_smem_bytes")(G, S, d, dv) > 48 * 1024):
        raise ValueError(f"mx_attention_decode: G={G}, S={S}, d={d}, dv={dv} "
                         "does not fit the kernel's shared memory")
    q = q.contiguous()
    valid = valid.contiguous()
    out = torch.empty((BH, G, dv), dtype=q.dtype, device=q.device)
    _launch("mx_attention_decode", "mx_attn_decode", q.data_ptr(),
            k4.data_ptr(), v4.data_ptr(), valid.data_ptr(), out.data_ptr(),
            BH, G, S, d, dv, H, k4.stride(0), k4.stride(1), k4.stride(2),
            v4.stride(0), v4.stride(1), v4.stride(2), valid.stride(0),
            int(fmt is not None), *_fmt_args(fmt), 1.0 / math.sqrt(d))
    return out
