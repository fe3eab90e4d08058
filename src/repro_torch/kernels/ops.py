"""Wrappers of the CUDA kernels.

Each wrapper checks device, dtype, shape and contiguity, launches its kernel
on PyTorch's current stream and adds one to its launch count.  For tensors
on the CPU it calls the kernel's plain version in ``ref.py`` instead; for
CUDA tensors it launches the kernel or raises (there is no fallback).  The
kernels run every scale rule of ``repro_torch.core.mx`` ("floor", "bump",
"adaptive"): the rule travels in the format arguments of each C entry
point, and an unknown rule raises here, before any launch.

``mx_quantize`` is a ``torch.autograd.Function`` whose backward is the
identity (the reference's straight-through estimator); the GEMM and
attention wrappers are called inside the ``mx_contract`` autograd
Functions and carry no graph of their own.

Counterpart of ``repro.kernels.ops``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.attnspec import AttnSpec
from repro_torch.core.formats import ElementFormat
from repro_torch.core.mx import MX_BLOCK
from . import build, ref

__all__ = ["mx_quantize", "mx_matmul", "mx_matmul_dgrad", "mx_matmul_wgrad",
           "mx_flash_attention", "mx_flash_attention_bwd",
           "mx_attention_decode", "mx_attention_decode_paged",
           "mx_matmul_lanes", "mx_matmul_dgrad_lanes",
           "mx_matmul_wgrad_lanes", "LAUNCHES",
           "reset_launches", "KERNELS", "bwd_gemm_plan", "fwd_gemm_plan",
           "decode_plan", "SCALE_MODES"]

#: Launch count of each kernel: one per launch, counted only where the
#: kernel is launched (never for the plain versions).
LAUNCHES: Dict[str, int] = {"mx_quantize": 0, "mx_matmul": 0,
                            "mx_matmul_dgrad": 0, "mx_matmul_wgrad": 0,
                            "mx_flash_attention": 0,
                            "mx_flash_attention_bwd": 0,
                            "mx_attention_decode": 0,
                            "mx_attention_decode_paged": 0,
                            "mx_matmul_lanes": 0, "mx_matmul_dgrad_lanes": 0,
                            "mx_matmul_wgrad_lanes": 0}

_CSRC = "src/repro_torch/kernels/csrc/"

#: name -> (its sources: the entry point's file, then the headers it
#: builds on beside mx_quant.cuh, which all share; the Pallas function it
#: replaces)
KERNELS = {
    "mx_quantize": ((_CSRC + "mx_quant.cu",),
                    "src/repro/kernels/mx_quant.py:66"),
    "mx_matmul": ((_CSRC + "mx_matmul.cu", _CSRC + "mx_small_m.cuh",
                   _CSRC + "mx_gemm_sm90.cuh"),
                  "src/repro/kernels/mx_matmul.py:63"),
    "mx_matmul_dgrad": ((_CSRC + "mx_matmul_bwd.cu",
                         _CSRC + "mx_gemm_sm90.cuh"),
                        "src/repro/kernels/mx_matmul_bwd.py:73"),
    "mx_matmul_wgrad": ((_CSRC + "mx_matmul_bwd.cu",
                         _CSRC + "mx_gemm_sm90.cuh"),
                        "src/repro/kernels/mx_matmul_bwd.py:142"),
    "mx_flash_attention": ((_CSRC + "mx_attention.cu", _CSRC + "mx_mma.cuh"),
                           "src/repro/kernels/mx_attention.py:156"),
    "mx_flash_attention_bwd": ((_CSRC + "mx_attention_bwd.cu",
                                _CSRC + "mx_mma.cuh"),
                               "src/repro/kernels/mx_attention.py:275"),
    "mx_attention_decode": ((_CSRC + "mx_attention.cu",),
                            "src/repro/kernels/mx_attention.py:455"),
    "mx_attention_decode_paged": ((_CSRC + "mx_attention.cu",),
                                  "src/repro/kernels/mx_attention.py:407"),
    # The lane GEMMs: kernels 2-4 with a lane axis, where the reference
    # vmaps the Pallas function over a sweep's lanes.
    "mx_matmul_lanes": ((_CSRC + "mx_matmul.cu", _CSRC + "mx_gemm_sm90.cuh"),
                        "src/repro/kernels/mx_matmul.py:63"),
    "mx_matmul_dgrad_lanes": ((_CSRC + "mx_matmul_bwd.cu",
                               _CSRC + "mx_gemm_sm90.cuh"),
                              "src/repro/kernels/mx_matmul_bwd.py:73"),
    "mx_matmul_wgrad_lanes": ((_CSRC + "mx_matmul_bwd.cu",
                               _CSRC + "mx_gemm_sm90.cuh"),
                              "src/repro/kernels/mx_matmul_bwd.py:142"),
}

#: The scale rules and their codes in the kernels' format arguments
#: (``MX_FLOOR``, ``MX_BUMP``, ``MX_ADAPTIVE`` in csrc/mx_quant.cuh).
SCALE_MODES = {"floor": 0, "bump": 1, "adaptive": 2}

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# mbits, min_normal_exp, e_max, max_normal, scale rule
_FMT = [_I, _I, _I, _F, _I]
_SIGNATURES = {
    "mx_quantize_lastdim": ("mx_quant", [_P, _P, _LL, _I, _I, *_FMT, _P]),
    "mx_matmul": ("mx_matmul", [_P] * 6 + [_I] * 7
                  + [_I, *_FMT, _I, *_FMT, _P]),
    "mx_matmul_dgrad": ("mx_matmul_bwd", [_P] * 6 + [_I] * 6
                        + [_I, *_FMT, _I, *_FMT, _P]),
    "mx_matmul_wgrad": ("mx_matmul_bwd", [_P] * 6 + [_I] * 6
                        + [_I, *_FMT, _I, *_FMT, _P]),
    "mx_matmul_lanes": ("mx_matmul", [_P] * 6 + [_I] * 7
                        + [_I, *_FMT, _I, *_FMT, _P]),
    "mx_matmul_dgrad_lanes": ("mx_matmul_bwd", [_P] * 6 + [_I] * 7
                              + [_I, *_FMT, _I, *_FMT, _P]),
    "mx_matmul_wgrad_lanes": ("mx_matmul_bwd", [_P] * 6 + [_I] * 7
                              + [_I, *_FMT, _I, *_FMT, _P]),
    "mx_decode_smem_bytes": ("mx_attention", [_I, _I, _I, _I]),
    "mx_flash_fwd": ("mx_attention", [_P] * 6 + [_I] * 12 + [*_FMT, _F, _P]),
    "mx_flash_bwd": ("mx_attention_bwd", [_P] * 11 + [_I] * 11 + [*_FMT, _F,
                                                                 _P]),
    "mx_attn_decode": ("mx_attention", [_P] * 5 + [_I] * 8 + [_LL] * 7
                       + [_I, *_FMT, _F, _P]),
    "mx_attn_decode_paged": ("mx_attention", [_P] * 6 + [_I] * 10
                             + [_LL] * 6 + [_I, *_FMT, _F, _P]),
}
_FNS: Dict[str, ctypes._CFuncPtr] = {}
_KIND = {"causal": 0, "full": 1, "window": 2}

#: Output tile (rows, columns) and k-tile depth of the wgmma GEMMs
#: (``csrc/mx_gemm_sm90.cuh``), and the H100's SM count.
BWD_TILE, BWD_DEPTH, _SMS = (128, 256), 64, 132
#: The forward GEMM's small-M kernel (``csrc/mx_small_m.cuh``): rows it
#: takes at most, and 32-row slabs a CTA covers at most (one for each of
#: its 8 warps).  Above FWD_SMALL_M rows the forward runs the quantize-once
#: pre-pass and the wgmma product, as the backward GEMMs do.  Both cast W
#: once; the small-M kernel also skips the pre-pass's scratch round trip,
#: but its FMAs grow with M (``chip_smoke.py`` times both paths at 4, 6
#: and 8 rows; PERF.md).
FWD_SMALL_M, FWD_SLABS = 8, 8
#: The decode kernels' cluster: at most DECODE_CLUSTER CTAs (the portable
#: cluster size) per (row, kv head).
DECODE_CLUSTER = 8


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


def _fmt_args(fmt: Optional[ElementFormat], scale_mode: str):
    """A format's arguments of the C entry points, its scale rule last."""
    if fmt is None:
        return [0, 0, 0, 0.0, 0]
    return [fmt.mbits, fmt.min_normal_exp, fmt.e_max, fmt.max_normal,
            SCALE_MODES[scale_mode]]


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: all operands must be on the same CUDA "
                             f"device, got {t.device}")


def _check_mx(name: str, fmt, block: int, scale_mode: str) -> None:
    if scale_mode not in SCALE_MODES:
        raise ValueError(f"{name}: unknown scale_mode {scale_mode!r}; the "
                         f"kernels run {sorted(SCALE_MODES)}")
    if fmt is not None and block != MX_BLOCK:
        raise NotImplementedError(
            f"{name}: the CUDA kernels use {MX_BLOCK}-wide MX blocks, "
            f"not {block}")


class _Quantize(torch.autograd.Function):
    """Quantize-dequantize with the straight-through gradient: the backward
    is the identity in x's dtype, as the reference's
    ``xf + stop_gradient(y - xf)``."""

    @staticmethod
    def forward(ctx, x, fmt, axis, block, scale_mode):
        if not x.is_cuda:
            return ref.mx_quantize_ref(x, fmt, axis, block, scale_mode)
        _check_mx("mx_quantize", fmt, block, scale_mode)
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"mx_quantize: float32 or bfloat16, got "
                            f"{x.dtype}")
        xm = torch.movedim(x, axis, -1).contiguous()
        y = torch.empty_like(xm)
        K = xm.shape[-1]
        M = xm.numel() // max(K, 1)
        _launch("mx_quantize", "mx_quantize_lastdim", xm.data_ptr(),
                y.data_ptr(), M, K, int(x.dtype == torch.bfloat16),
                *_fmt_args(fmt, scale_mode))
        return torch.movedim(y, -1, axis)

    @staticmethod
    def backward(ctx, dy):
        return dy, None, None, None, None


def mx_quantize(x: torch.Tensor, fmt: Optional[ElementFormat],
                axis: int = -1, block: int = MX_BLOCK,
                scale_mode: str = "floor") -> torch.Tensor:
    """Quantize-dequantize along ``axis`` for any rank (fp32 or bf16), with
    the straight-through gradient."""
    if fmt is None:
        return x
    return _Quantize.apply(x, fmt, axis, block, scale_mode)


def _check_gemm(name: str, a: torch.Tensor, b: torch.Tensor, fmt_a,
                fmt_b, block: int, scale_mode: str) -> int:
    """Common checks of the GEMM wrappers; returns the is_fp32 flag."""
    _check_cuda(name, a, b)
    _check_mx(name, fmt_a, block, scale_mode)
    _check_mx(name, fmt_b, block, scale_mode)
    if a.dtype != b.dtype or a.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: bfloat16 or float32 operands of one dtype, "
                        f"got {a.dtype}, {b.dtype}")
    if a.dtype == torch.float32 and (fmt_a is None or fmt_b is None):
        raise TypeError(f"{name}: float32 operands must both be MX-quantized "
                        "(the tensor-core path holds operands in bf16, which "
                        "is exact only for MX values)")
    return int(a.dtype == torch.float32)


def _workspace(splits: int, rows: int, cols: int, device, lanes: int = 1):
    """fp32 split-K partials of each lane, summed by the kernel's second
    pass (one launch of the wrapper, counted once)."""
    if splits <= 1:
        return None
    return torch.empty((lanes * splits, rows, cols), dtype=torch.float32,
                       device=device)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def mx_matmul(a: torch.Tensor, b: torch.Tensor,
              fmt_a: Optional[ElementFormat],
              fmt_b: Optional[ElementFormat], block: int = MX_BLOCK,
              scale_mode: str = "floor") -> torch.Tensor:
    """``Q(a) (..., K) @ Q(b) (K, N)`` with fp32 accumulation, in a.dtype."""
    if not a.is_cuda:
        return ref.mx_matmul_ref(a, b, fmt_a, fmt_b, block, scale_mode)
    is_fp32 = _check_gemm("mx_matmul", a, b, fmt_a, fmt_b, block,
                          scale_mode)
    if b.ndim != 2 or a.shape[-1] != b.shape[0]:
        raise ValueError(f"mx_matmul: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    K, N = b.shape
    a2 = a.reshape(-1, K).contiguous()
    b = b.contiguous()
    M = a2.shape[0]
    c = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if c.numel() == 0 or K == 0:
        return c.zero_().reshape(a.shape[:-1] + (N,))
    small, depth, splits = fwd_gemm_plan(M, N, K)
    aq = bq = None
    if not small:
        aq = None if _in_place(a2, fmt_a) else _bwd_scratch(M, depth,
                                                            a.device)
        bq = _bwd_scratch(N, depth, a.device)
    work = _workspace(splits, M, N, a.device)
    _launch("mx_matmul", "mx_matmul", a2.data_ptr(), b.data_ptr(),
            c.data_ptr(), _ptr(work), _ptr(aq), _ptr(bq), M, N, K, depth,
            splits, int(small), is_fp32, int(fmt_a is not None),
            *_fmt_args(fmt_a, scale_mode), int(fmt_b is not None),
            *_fmt_args(fmt_b, scale_mode))
    return c.reshape(a.shape[:-1] + (N,))


def fwd_gemm_plan(M: int, N: int, K: int) -> Tuple[bool, int, int]:
    """``(small, depth, splits)`` of a forward GEMM (M, K) @ (K, N).

    Up to FWD_SMALL_M rows the small-M kernel reads W once, with no
    scratch (``depth`` 0), in 64-column CTAs of one 32-row slab a warp:
    the contraction is split into as few CTAs as hold FWD_SLABS slabs
    each, none empty.  Above it, the quantize-once pre-pass and the wgmma
    product, planned as the backward GEMMs (``bwd_gemm_plan``)."""
    if M > FWD_SMALL_M:
        return (False, *bwd_gemm_plan(M, N, K))
    return True, 0, -(-K // (MX_BLOCK * FWD_SLABS))


def bwd_gemm_plan(rows: int, cols: int, contraction: int) -> Tuple[int, int]:
    """``(depth, splits)`` of a backward GEMM with a (rows, cols) output:
    the scratch operands' contraction extent, zero padded to a multiple of
    the k-tile depth, and the number of contraction splits.  Splits are
    taken only when the output tiles are fewer than the card's SMs: the
    nearest whole number of waves, at least 4 k-tiles each, none empty."""
    depth = -(-contraction // BWD_DEPTH) * BWD_DEPTH
    ktiles = depth // BWD_DEPTH
    tiles = -(-rows // BWD_TILE[0]) * -(-cols // BWD_TILE[1])
    splits = max(1, min((_SMS + tiles // 2) // tiles, ktiles // 4))
    per = -(-ktiles // splits)
    return depth, -(-ktiles // per)


def decode_plan(S: int) -> Tuple[int, int]:
    """``(splits, span)`` of a decode over a view of S slots: ``splits``
    CTAs of one cluster (at most DECODE_CLUSTER) hold ``span`` slots each,
    a multiple of the MX block, so no 32-block of p or v straddles two
    CTAs; the last span may run past S.  It depends on S alone (not on the
    batch or on which slots are valid), so a row's result does not depend
    on the rows it shares a call with, and the paged kernel runs the slab
    kernel's plan on the same view."""
    span = max(1, -(-S // (DECODE_CLUSTER * MX_BLOCK))) * MX_BLOCK
    return max(1, -(-S // span)), span


def _decode_fits(name: str, G: int, S: int, d: int, dv: int):
    """The plan of a decode over S slots, or ValueError when its shapes do
    not fit the kernel (``mx_decode_smem_bytes`` holds the limits)."""
    splits, span = decode_plan(S)
    if _fn("mx_decode_smem_bytes")(G, span, d, dv) < 0:
        raise ValueError(f"{name}: G={G}, view {S}, d={d}, dv={dv} does not "
                         "fit the kernel's shared memory")
    return splits, span


def _bwd_scratch(rows: int, depth: int, device) -> torch.Tensor:
    """A quantized operand of a wgmma GEMM, contraction-major bf16."""
    return torch.empty((rows, depth), dtype=torch.bfloat16, device=device)


def _in_place(t: torch.Tensor, fmt) -> bool:
    """A raw bf16 operand already contraction-major goes to the wgmma
    product as it lies when TMA can read its rows (16-byte aligned)."""
    return (fmt is None and t.dtype == torch.bfloat16
            and t.shape[-1] % 8 == 0 and t.data_ptr() % 16 == 0)


def mx_matmul_dgrad(dy: torch.Tensor, w: torch.Tensor,
                    fmt_g: Optional[ElementFormat],
                    fmt_w: Optional[ElementFormat], block: int = MX_BLOCK,
                    scale_mode: str = "floor") -> torch.Tensor:
    """dgrad ``Q(dy) (..., N) @ Q(w)^T`` with w in its forward (K, N)
    layout, both blocked along N; fp32 accumulation, in dy.dtype."""
    if not dy.is_cuda:
        return ref.mx_matmul_dgrad_ref(dy, w, fmt_g, fmt_w, block,
                                       scale_mode)
    is_fp32 = _check_gemm("mx_matmul_dgrad", dy, w, fmt_g, fmt_w, block,
                          scale_mode)
    if w.ndim != 2 or dy.shape[-1] != w.shape[1]:
        raise ValueError(f"mx_matmul_dgrad: shapes {tuple(dy.shape)}, "
                         f"{tuple(w.shape)}")
    K, N = w.shape
    dy2 = dy.reshape(-1, N).contiguous()
    w = w.contiguous()
    M = dy2.shape[0]
    dx = torch.empty((M, K), dtype=dy.dtype, device=dy.device)
    if dx.numel() == 0 or N == 0:
        return dx.zero_().reshape(dy.shape[:-1] + (K,))
    depth, splits = bwd_gemm_plan(M, K, N)
    dyq = None if _in_place(dy2, fmt_g) else _bwd_scratch(M, depth,
                                                          dy.device)
    wq = None if _in_place(w, fmt_w) else _bwd_scratch(K, depth, dy.device)
    work = _workspace(splits, M, K, dy.device)
    _launch("mx_matmul_dgrad", "mx_matmul_dgrad", dy2.data_ptr(),
            w.data_ptr(), dx.data_ptr(), _ptr(work), _ptr(dyq), _ptr(wq), M,
            N, K, depth, splits, is_fp32, int(fmt_g is not None),
            *_fmt_args(fmt_g, scale_mode), int(fmt_w is not None),
            *_fmt_args(fmt_w, scale_mode))
    return dx.reshape(dy.shape[:-1] + (K,))


def mx_matmul_wgrad(x: torch.Tensor, dy: torch.Tensor,
                    fmt_a: Optional[ElementFormat],
                    fmt_g: Optional[ElementFormat], block: int = MX_BLOCK,
                    scale_mode: str = "floor") -> torch.Tensor:
    """wgrad ``Q(x)^T @ Q(dy)`` for x (T, K) and dy (T, N), both blocked
    along the token axis T; fp32 accumulation, (K, N) in x.dtype."""
    if not x.is_cuda:
        return ref.mx_matmul_wgrad_ref(x, dy, fmt_a, fmt_g, block,
                                       scale_mode)
    is_fp32 = _check_gemm("mx_matmul_wgrad", x, dy, fmt_a, fmt_g, block,
                          scale_mode)
    if x.ndim != 2 or dy.ndim != 2 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"mx_matmul_wgrad: shapes {tuple(x.shape)}, "
                         f"{tuple(dy.shape)}")
    T, K = x.shape
    N = dy.shape[1]
    x, dy = x.contiguous(), dy.contiguous()
    dw = torch.empty((K, N), dtype=x.dtype, device=x.device)
    if dw.numel() == 0 or T == 0:
        return dw.zero_()
    depth, splits = bwd_gemm_plan(K, N, T)
    xq = _bwd_scratch(K, depth, x.device)
    dyq = _bwd_scratch(N, depth, x.device)
    work = _workspace(splits, K, N, x.device)
    _launch("mx_matmul_wgrad", "mx_matmul_wgrad", x.data_ptr(),
            dy.data_ptr(), dw.data_ptr(), _ptr(work), xq.data_ptr(),
            dyq.data_ptr(), T, K, N, depth, splits, is_fp32,
            int(fmt_a is not None), *_fmt_args(fmt_a, scale_mode),
            int(fmt_g is not None), *_fmt_args(fmt_g, scale_mode))
    return dw


# ---------------------------------------------------------------------------
# The lane GEMMs: kernels 2-4 over L lanes, each with its own operands.
# ---------------------------------------------------------------------------
def _check_lanes(name: str, a: torch.Tensor, b: torch.Tensor, ia: int,
                 ib: int) -> None:
    """a and b are (L, ., .) with one lane count and a.shape[ia] ==
    b.shape[ib] (the shared extent)."""
    if (a.ndim != 3 or b.ndim != 3 or a.shape[0] != b.shape[0]
            or a.shape[ia] != b.shape[ib]):
        raise ValueError(f"{name}: shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")


def mx_matmul_lanes(a: torch.Tensor, b: torch.Tensor,
                    fmt_a: Optional[ElementFormat],
                    fmt_b: Optional[ElementFormat], block: int = MX_BLOCK,
                    scale_mode: str = "floor") -> torch.Tensor:
    """``C[l] = Q(a[l]) (M, K) @ Q(b[l]) (K, N)`` for a (L, M, K) and
    b (L, K, N), blocks along K; fp32 accumulation, (L, M, N) in a.dtype.
    One launch for all lanes, planned as one lane (``fwd_gemm_plan(M, N,
    K)``), so lane l is bitwise ``mx_matmul(a[l], b[l])``.  M <= 8 raises
    (the small-M kernel has no lane axis)."""
    _check_lanes("mx_matmul_lanes", a, b, 2, 1)
    L, M, K = a.shape
    N = b.shape[2]
    if M <= FWD_SMALL_M:
        raise NotImplementedError(
            f"mx_matmul_lanes: M = {M}: the small-M forward kernel has no "
            "lane axis; lane GEMMs at so few rows are ROADMAP Queue A item 4 "
            "(no caller needs them: MoE expert lanes hold >= 32 rows)")
    if not a.is_cuda:
        return ref.mx_matmul_lanes_ref(a, b, fmt_a, fmt_b, block, scale_mode)
    is_fp32 = _check_gemm("mx_matmul_lanes", a, b, fmt_a, fmt_b, block,
                          scale_mode)
    a, b = a.contiguous(), b.contiguous()
    c = torch.empty((L, M, N), dtype=a.dtype, device=a.device)
    if c.numel() == 0 or K == 0:
        return c.zero_()
    _, depth, splits = fwd_gemm_plan(M, N, K)
    aq = None if _in_place(a, fmt_a) else _bwd_scratch(L * M, depth,
                                                       a.device)
    bq = _bwd_scratch(L * N, depth, a.device)
    work = _workspace(splits, M, N, a.device, L)
    _launch("mx_matmul_lanes", "mx_matmul_lanes", a.data_ptr(),
            b.data_ptr(), c.data_ptr(), _ptr(work), _ptr(aq), _ptr(bq), L, M,
            N, K, depth, splits, is_fp32, int(fmt_a is not None),
            *_fmt_args(fmt_a, scale_mode), int(fmt_b is not None),
            *_fmt_args(fmt_b, scale_mode))
    return c


def mx_matmul_dgrad_lanes(dy: torch.Tensor, w: torch.Tensor,
                          fmt_g: Optional[ElementFormat],
                          fmt_w: Optional[ElementFormat],
                          block: int = MX_BLOCK,
                          scale_mode: str = "floor") -> torch.Tensor:
    """``dx[l] = Q(dy[l]) (M, N) @ Q(w[l])^T`` for dy (L, M, N) and w
    (L, K, N), blocks along N; (L, M, K) in dy.dtype, planned as one lane
    (``bwd_gemm_plan(M, K, N)``), so lane l is bitwise
    ``mx_matmul_dgrad(dy[l], w[l])``."""
    _check_lanes("mx_matmul_dgrad_lanes", dy, w, 2, 2)
    if not dy.is_cuda:
        return ref.mx_matmul_dgrad_lanes_ref(dy, w, fmt_g, fmt_w, block,
                                             scale_mode)
    is_fp32 = _check_gemm("mx_matmul_dgrad_lanes", dy, w, fmt_g, fmt_w,
                          block, scale_mode)
    L, M, N = dy.shape
    K = w.shape[1]
    dy, w = dy.contiguous(), w.contiguous()
    dx = torch.empty((L, M, K), dtype=dy.dtype, device=dy.device)
    if dx.numel() == 0 or N == 0:
        return dx.zero_()
    depth, splits = bwd_gemm_plan(M, K, N)
    dyq = None if _in_place(dy, fmt_g) else _bwd_scratch(L * M, depth,
                                                         dy.device)
    wq = None if _in_place(w, fmt_w) else _bwd_scratch(L * K, depth,
                                                       dy.device)
    work = _workspace(splits, M, K, dy.device, L)
    _launch("mx_matmul_dgrad_lanes", "mx_matmul_dgrad_lanes", dy.data_ptr(),
            w.data_ptr(), dx.data_ptr(), _ptr(work), _ptr(dyq), _ptr(wq), L,
            M, N, K, depth, splits, is_fp32, int(fmt_g is not None),
            *_fmt_args(fmt_g, scale_mode), int(fmt_w is not None),
            *_fmt_args(fmt_w, scale_mode))
    return dx


def mx_matmul_wgrad_lanes(x: torch.Tensor, dy: torch.Tensor,
                          fmt_a: Optional[ElementFormat],
                          fmt_g: Optional[ElementFormat],
                          block: int = MX_BLOCK,
                          scale_mode: str = "floor") -> torch.Tensor:
    """``dW[l] = Q(x[l])^T @ Q(dy[l])`` for x (L, T, K) and dy (L, T, N),
    blocks along each lane's T; (L, K, N) in x.dtype, planned as one lane
    (``bwd_gemm_plan(K, N, T)``), so lane l is bitwise
    ``mx_matmul_wgrad(x[l], dy[l])``."""
    _check_lanes("mx_matmul_wgrad_lanes", x, dy, 1, 1)
    if not x.is_cuda:
        return ref.mx_matmul_wgrad_lanes_ref(x, dy, fmt_a, fmt_g, block,
                                             scale_mode)
    is_fp32 = _check_gemm("mx_matmul_wgrad_lanes", x, dy, fmt_a, fmt_g,
                          block, scale_mode)
    L, T, K = x.shape
    N = dy.shape[2]
    x, dy = x.contiguous(), dy.contiguous()
    dw = torch.empty((L, K, N), dtype=x.dtype, device=x.device)
    if dw.numel() == 0 or T == 0:
        return dw.zero_()
    depth, splits = bwd_gemm_plan(K, N, T)
    xq = _bwd_scratch(L * K, depth, x.device)
    dyq = _bwd_scratch(L * N, depth, x.device)
    work = _workspace(splits, K, N, x.device, L)
    _launch("mx_matmul_wgrad_lanes", "mx_matmul_wgrad_lanes", x.data_ptr(),
            dy.data_ptr(), dw.data_ptr(), _ptr(work), xq.data_ptr(),
            dyq.data_ptr(), L, T, K, N, depth, splits, is_fp32,
            int(fmt_a is not None), *_fmt_args(fmt_a, scale_mode),
            int(fmt_g is not None), *_fmt_args(fmt_g, scale_mode))
    return dw


#: The flash kernels' head dims: qk up to FLASH_MAX_D and v up to
#: FLASH_MAX_DV (recurrentgemma's 256; MLA's nope + rope at DeepSeek-V2's
#: widths, 128 + 64, against v 128, lies inside).
FLASH_MAX_D, FLASH_MAX_DV = 256, 256


def _check_flash_dims(name: str, d: int, dv: int) -> None:
    if d > FLASH_MAX_D or dv > FLASH_MAX_DV:
        raise NotImplementedError(
            f"{name}: qk head dim {d}, v head dim {dv}: the flash kernels "
            f"take qk up to {FLASH_MAX_D} and v up to {FLASH_MAX_DV}; wider "
            "heads are ROADMAP Queue A item 4")


def mx_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       fmt: Optional[ElementFormat], spec: AttnSpec,
                       block: int = MX_BLOCK, scale_mode: str = "floor",
                       out_dtype: Optional[torch.dtype] = None):
    """Flash forward on the folded layout q (BH,G,Tq,d), k (BH,Tk,d),
    v (BH,Tk,dv) -> (out (BH,G,Tq,dv) bf16, lse (BH,G,Tq) fp32).  With
    ``out_dtype=torch.float32`` out is fp32: the bf16 out before its one
    rounding (for checks; the model passes nothing)."""
    if not q.is_cuda:
        return ref.mx_flash_attention_ref(q, k, v, fmt, spec, block,
                                          scale_mode, out_dtype)
    _check_cuda("mx_flash_attention", q, k, v)
    _check_mx("mx_flash_attention", fmt, block, scale_mode)
    if spec.kind not in _KIND:
        raise NotImplementedError(
            f"mx_flash_attention: mask kind {spec.kind!r} (decode kinds go "
            "through mx_attention_decode)")
    if {q.dtype, k.dtype, v.dtype} != {torch.bfloat16}:
        raise TypeError("mx_flash_attention: bfloat16 q, k and v")
    odt = out_dtype or q.dtype
    if odt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"mx_flash_attention: out_dtype {odt}")
    BH, G, Tq, d = q.shape
    Tk, dv = k.shape[1], v.shape[-1]
    if k.shape != (BH, Tk, d) or v.shape[:2] != (BH, Tk):
        raise ValueError(f"mx_flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    _check_flash_dims("mx_flash_attention", d, dv)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((BH, G, Tq, dv), dtype=odt, device=q.device)
    lse = torch.empty((BH, G, Tq), dtype=torch.float32, device=q.device)
    # MX mode: q and k cast along d, v along kv, once, by the pre-pass
    qkv_hat = (None if fmt is None else torch.empty(
        q.numel() + k.numel() + v.numel(), dtype=torch.bfloat16,
        device=q.device))
    tile_k = ref.attn_tiles(spec, Tq, Tk)[1]
    _launch("mx_flash_attention", "mx_flash_fwd", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), _ptr(qkv_hat), out.data_ptr(), lse.data_ptr(), BH,
            G, Tq, Tk, d, dv, _KIND[spec.kind], spec.window, spec.q_offset,
            tile_k, int(odt == torch.float32), int(fmt is not None),
            *_fmt_args(fmt, scale_mode), 1.0 / math.sqrt(d))
    return out, lse


def mx_flash_attention_bwd(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, dout: torch.Tensor,
                           out: torch.Tensor, lse: torch.Tensor,
                           fmt: Optional[ElementFormat], spec: AttnSpec,
                           block: int = MX_BLOCK, scale_mode: str = "floor",
                           out_dtype: Optional[torch.dtype] = None):
    """Flash dgrad on the folded layout -> (dq, dk, dv), in the operands'
    dtype, or all in ``out_dtype`` (bf16 or fp32) when given."""
    if not q.is_cuda:
        return ref.mx_flash_attention_bwd_ref(q, k, v, dout, out, lse, fmt,
                                              spec, block, scale_mode,
                                              out_dtype)
    _check_cuda("mx_flash_attention_bwd", q, k, v, dout, out, lse)
    _check_mx("mx_flash_attention_bwd", fmt, block, scale_mode)
    if spec.kind not in _KIND:
        raise NotImplementedError(
            f"mx_flash_attention_bwd: mask kind {spec.kind!r}")
    if {q.dtype, k.dtype, v.dtype, dout.dtype, out.dtype} != {
            torch.bfloat16} or lse.dtype != torch.float32:
        raise TypeError("mx_flash_attention_bwd: bfloat16 q, k, v, dout and "
                        "out, float32 lse")
    BH, G, Tq, d = q.shape
    Tk, dv = k.shape[1], v.shape[-1]
    if (k.shape != (BH, Tk, d) or v.shape[:2] != (BH, Tk)
            or dout.shape != (BH, G, Tq, dv) or out.shape != dout.shape
            or lse.shape != (BH, G, Tq)):
        raise ValueError(f"mx_flash_attention_bwd: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(dout.shape)}, {tuple(lse.shape)}")
    _check_flash_dims("mx_flash_attention_bwd", d, dv)
    odt = out_dtype or torch.bfloat16
    if odt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"mx_flash_attention_bwd: out_dtype {odt}")
    q, k, v, dout, out, lse = (t.contiguous()
                               for t in (q, k, v, dout, out, lse))
    delta = torch.empty((BH, G, Tq), dtype=torch.float32, device=q.device)
    # MX mode: the scores operands (q, then k) cast once along d
    qk_hat = (None if fmt is None else torch.empty(
        q.numel() + k.numel(), dtype=torch.bfloat16, device=q.device))
    dq = torch.empty(q.shape, dtype=odt, device=q.device)
    dk = torch.empty(k.shape, dtype=odt, device=q.device)
    dvv = torch.empty(v.shape, dtype=odt, device=q.device)
    _launch("mx_flash_attention_bwd", "mx_flash_bwd", q.data_ptr(),
            k.data_ptr(), v.data_ptr(), dout.data_ptr(), out.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(qk_hat), dq.data_ptr(),
            dk.data_ptr(),
            dvv.data_ptr(), BH, G, Tq, Tk, d, dv, _KIND[spec.kind],
            spec.window, spec.q_offset, int(odt == torch.float32),
            int(fmt is not None), *_fmt_args(fmt, scale_mode),
            1.0 / math.sqrt(d))
    return dq, dk, dvv


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
    splits, span = _decode_fits("mx_attention_decode", G, S, d, dv)
    q = q.contiguous()
    valid = valid.contiguous()
    out = torch.empty((BH, G, dv), dtype=q.dtype, device=q.device)
    _launch("mx_attention_decode", "mx_attn_decode", q.data_ptr(),
            k4.data_ptr(), v4.data_ptr(), valid.data_ptr(), out.data_ptr(),
            BH, G, S, d, dv, H, splits, span, k4.stride(0), k4.stride(1),
            k4.stride(2),
            v4.stride(0), v4.stride(1), v4.stride(2), valid.stride(0),
            int(fmt is not None), *_fmt_args(fmt, scale_mode),
            1.0 / math.sqrt(d))
    return out


def mx_attention_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, page_table: torch.Tensor,
                              valid: torch.Tensor,
                              fmt: Optional[ElementFormat],
                              block: int = MX_BLOCK,
                              scale_mode: str = "floor") -> torch.Tensor:
    """Paged decode: q (BH, G, d) with BH = B * H against (N, ps, H, ·)
    page pools through the (B, P) int32 page table, with valid (B, P*ps)
    per view position.  Unmapped (negative) entries read page 0, as the
    gather of the plain version does; ``valid`` masks them."""
    if not q.is_cuda:
        return ref.mx_attention_decode_paged_ref(q, k_pool, v_pool,
                                                 page_table, valid, fmt,
                                                 block, scale_mode)
    name = "mx_attention_decode_paged"
    _check_cuda(name, q, k_pool, v_pool, page_table, valid)
    _check_mx(name, fmt, block, scale_mode)
    if {q.dtype, k_pool.dtype, v_pool.dtype} != {torch.bfloat16}:
        raise TypeError(f"{name}: bfloat16 q and pools")
    if page_table.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError(f"{name}: int32 page table and bool validity mask")
    N, ps, H, d = k_pool.shape
    dv = v_pool.shape[-1]
    B, P = page_table.shape
    BH, G = q.shape[0], q.shape[1]
    if (BH != B * H or q.shape[2] != d or v_pool.shape[:3] != (N, ps, H)
            or valid.shape != (B, P * ps)):
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}, "
                         f"{tuple(page_table.shape)}, {tuple(valid.shape)}")
    if ps % block or ps % MX_BLOCK:
        raise ValueError(f"{name}: page size {ps} must be a multiple of the "
                         f"MX block ({block}), so no block straddles a page")
    if k_pool.stride(-1) != 1 or v_pool.stride(-1) != 1:
        raise ValueError(f"{name}: head dim must be contiguous")
    splits, span = _decode_fits(name, G, P * ps, d, dv)
    q = q.contiguous()
    page_table = page_table.contiguous()
    valid = valid.contiguous()
    out = torch.empty((BH, G, dv), dtype=q.dtype, device=q.device)
    _launch(name, "mx_attn_decode_paged", q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), page_table.data_ptr(), valid.data_ptr(),
            out.data_ptr(), B, H, G, P, ps, N, d, dv, splits, span,
            *k_pool.stride()[:3],
            *v_pool.stride()[:3], int(fmt is not None),
            *_fmt_args(fmt, scale_mode),
            1.0 / math.sqrt(d))
    return out
