"""Plain PyTorch versions of the CUDA kernels.

Counterparts of ``repro.kernels.ref``.  The kernel wrappers in ``ops.py``
call these for tensors on the CPU; ``chip_smoke.py`` holds each CUDA kernel
against them on the card.  They repeat the reference's arithmetic op for
op (same tiling, same masks), so on the CPU they agree with the JAX oracles
bitwise for the quantizer and to fp32 accumulation order elsewhere.

Layouts are the reference's folded ones:
    q (BH, G, Tq, d), k (BH, Tk, d), v (BH, Tk, dv)   flash forward/backward
    q (BH, G, d),     k (BH, S, d),  v (BH, S, dv)    decode
The decode version also takes the KV cache in its model layout
(B, S, Hkv, d) with a (B, S) mask, which it folds first.  The paged decode
version gathers (N, ps, Hkv, d) page pools through a (B, P) page table
into that folded layout and runs the decode version on the view.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.attnspec import AttnSpec
from repro_torch.core.formats import ElementFormat
from repro_torch.core.mx import MX_BLOCK, quantize_mx

__all__ = ["mx_quantize_ref", "mx_matmul_ref", "mx_matmul_dgrad_ref",
           "mx_matmul_wgrad_ref", "mx_matmul_lanes_ref",
           "mx_matmul_dgrad_lanes_ref", "mx_matmul_wgrad_lanes_ref",
           "mx_flash_attention_ref",
           "mx_flash_attention_bwd_ref", "mx_attention_decode_ref",
           "gather_pages", "mx_attention_decode_paged_ref", "attn_tile_mask", "attn_tile_needed", "attn_tiles", "fold_cache",
           "NEG_INF"]

NEG_INF = -1e30


def mx_quantize_ref(x: torch.Tensor, fmt: Optional[ElementFormat],
                    axis: int = -1, block: int = MX_BLOCK,
                    scale_mode: str = "floor") -> torch.Tensor:
    """Block-scaled quantize-dequantize along ``axis`` (Algorithm 1)."""
    return quantize_mx(x, fmt, axis=axis, block=block, scale_mode=scale_mode)


def mx_matmul_ref(a: torch.Tensor, b: torch.Tensor,
                  fmt_a: Optional[ElementFormat],
                  fmt_b: Optional[ElementFormat],
                  block: int = MX_BLOCK,
                  scale_mode: str = "floor") -> torch.Tensor:
    """``Q(a) (..., K) @ Q(b) (K, N)``, both quantized along K, fp32
    accumulation, output in ``a.dtype``."""
    aq = quantize_mx(a, fmt_a, axis=-1, block=block, scale_mode=scale_mode)
    bq = quantize_mx(b, fmt_b, axis=0, block=block, scale_mode=scale_mode)
    return torch.matmul(aq.float(), bq.float()).to(a.dtype)


def mx_matmul_dgrad_ref(dy: torch.Tensor, w: torch.Tensor,
                        fmt_g: Optional[ElementFormat],
                        fmt_w: Optional[ElementFormat],
                        block: int = MX_BLOCK,
                        scale_mode: str = "floor") -> torch.Tensor:
    """dgrad ``Q(dy) (..., N) @ Q(w)^T`` with w in its forward (K, N)
    layout, both quantized along N; fp32 accumulation, out in dy.dtype."""
    dyq = quantize_mx(dy, fmt_g, axis=-1, block=block, scale_mode=scale_mode)
    wq = quantize_mx(w, fmt_w, axis=1, block=block, scale_mode=scale_mode)
    return torch.matmul(dyq.float(), wq.float().T).to(dy.dtype)


def mx_matmul_wgrad_ref(x: torch.Tensor, dy: torch.Tensor,
                        fmt_a: Optional[ElementFormat],
                        fmt_g: Optional[ElementFormat],
                        block: int = MX_BLOCK,
                        scale_mode: str = "floor") -> torch.Tensor:
    """wgrad ``Q(x)^T (K, T) @ Q(dy) (T, N)``, both quantized along the
    token axis T; fp32 accumulation, out in x.dtype."""
    xq = quantize_mx(x, fmt_a, axis=0, block=block, scale_mode=scale_mode)
    dyq = quantize_mx(dy, fmt_g, axis=0, block=block, scale_mode=scale_mode)
    return torch.matmul(xq.float().T, dyq.float()).to(x.dtype)


def _lanes(fn, a: torch.Tensor, b: torch.Tensor, out_shape, *args):
    """fn over the lanes of a (L, ., .) and b (L, ., .), stacked."""
    if a.shape[0] == 0:
        return torch.empty((0,) + out_shape, dtype=a.dtype, device=a.device)
    return torch.stack([fn(a[i], b[i], *args) for i in range(a.shape[0])])


def mx_matmul_lanes_ref(a: torch.Tensor, b: torch.Tensor,
                        fmt_a: Optional[ElementFormat],
                        fmt_b: Optional[ElementFormat],
                        block: int = MX_BLOCK,
                        scale_mode: str = "floor") -> torch.Tensor:
    """``mx_matmul_ref`` lane by lane: a (L, M, K), b (L, K, N)."""
    return _lanes(mx_matmul_ref, a, b, (a.shape[1], b.shape[2]), fmt_a,
                  fmt_b, block, scale_mode)


def mx_matmul_dgrad_lanes_ref(dy: torch.Tensor, w: torch.Tensor,
                              fmt_g: Optional[ElementFormat],
                              fmt_w: Optional[ElementFormat],
                              block: int = MX_BLOCK,
                              scale_mode: str = "floor") -> torch.Tensor:
    """``mx_matmul_dgrad_ref`` lane by lane: dy (L, M, N), w (L, K, N)."""
    return _lanes(mx_matmul_dgrad_ref, dy, w, (dy.shape[1], w.shape[1]),
                  fmt_g, fmt_w, block, scale_mode)


def mx_matmul_wgrad_lanes_ref(x: torch.Tensor, dy: torch.Tensor,
                              fmt_a: Optional[ElementFormat],
                              fmt_g: Optional[ElementFormat],
                              block: int = MX_BLOCK,
                              scale_mode: str = "floor") -> torch.Tensor:
    """``mx_matmul_wgrad_ref`` lane by lane: x (L, T, K), dy (L, T, N)."""
    return _lanes(mx_matmul_wgrad_ref, x, dy, (x.shape[2], dy.shape[2]),
                  fmt_a, fmt_g, block, scale_mode)


def attn_tile_mask(spec: AttnSpec, qi: int, kj: int, tile_q: int,
                   tile_k: int, kv_len: int, device=None) -> torch.Tensor:
    """(tile_q, tile_k) validity of tile (qi, kj)."""
    qpos = (qi * tile_q + spec.q_offset
            + torch.arange(tile_q, device=device)[:, None])
    kpos = kj * tile_k + torch.arange(tile_k, device=device)[None, :]
    valid = (kpos < kv_len).expand(tile_q, tile_k)
    if spec.kind in ("causal", "window"):
        valid = valid & (qpos >= kpos)
    if spec.kind == "window":
        valid = valid & (kpos > qpos - spec.window)
    return valid


def attn_tile_needed(spec: AttnSpec, qi: int, kj: int, tile_q: int,
                     tile_k: int, kv_len: int) -> bool:
    """True iff tile (qi, kj) holds any valid position (the skip rule)."""
    needed = kj * tile_k < kv_len
    if spec.kind in ("causal", "window"):
        needed &= kj * tile_k <= qi * tile_q + (tile_q - 1) + spec.q_offset
    if spec.kind == "window":
        needed &= ((kj + 1) * tile_k - 1
                   >= qi * tile_q + spec.q_offset - (spec.window - 1))
    return bool(needed)


def attn_tiles(spec: AttnSpec, Tq: int, Tk: int):
    """(tile_q, tile_k, nq, nk) for a spec and the true sequence lengths."""
    tile_q = min(spec.q_chunk, Tq)
    tile_k = min(spec.kv_chunk, Tk)
    return tile_q, tile_k, -(-Tq // tile_q), -(-Tk // tile_k)


def _pad_axis(x: torch.Tensor, axis: int, to: int) -> torch.Tensor:
    pad = to - x.shape[axis]
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - axis % x.ndim - 1) + [0, pad]
    return F.pad(x, widths)


def mx_flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           fmt: Optional[ElementFormat], spec: AttnSpec,
                           block: int = MX_BLOCK, scale_mode: str = "floor",
                           out_dtype=None):
    """Online-softmax flash forward with MX-quantized QK^T / PV and tile
    skipping.  Returns (out (BH, G, Tq, dv) in q.dtype, or ``out_dtype``
    when given, lse (BH, G, Tq) fp32).  The probabilities are quantized
    after the rescale by the running max over the whole kv tile, as the
    reference does."""
    BH, G, Tq, d = q.shape
    Tk = k.shape[1]
    dv = v.shape[-1]
    tile_q, tile_k, nq, nk = attn_tiles(spec, Tq, Tk)
    scale = 1.0 / math.sqrt(d)
    qp = _pad_axis(q.float(), 2, nq * tile_q)
    kp = _pad_axis(k.float(), 1, nk * tile_k)
    vp = _pad_axis(v.float(), 1, nk * tile_k)
    outs, lses = [], []
    for qi in range(nq):
        qt = qp[:, :, qi * tile_q:(qi + 1) * tile_q]
        qq = quantize_mx(qt, fmt, axis=-1, block=block, scale_mode=scale_mode)
        m = torch.full((BH, G, tile_q), NEG_INF, device=q.device)
        l = torch.zeros((BH, G, tile_q), device=q.device)
        acc = torch.zeros((BH, G, tile_q, dv), device=q.device)
        for kj in range(nk):
            if not attn_tile_needed(spec, qi, kj, tile_q, tile_k, Tk):
                continue
            kt = kp[:, kj * tile_k:(kj + 1) * tile_k]
            vt = vp[:, kj * tile_k:(kj + 1) * tile_k]
            kk = quantize_mx(kt, fmt, axis=-1, block=block,
                             scale_mode=scale_mode)
            s = torch.einsum("bgqd,bkd->bgqk", qq, kk) * scale
            valid = attn_tile_mask(spec, qi, kj, tile_q, tile_k, Tk,
                                   q.device)
            s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            # Fully masked rows keep p == 0 (not exp(0) == 1), so computing
            # a masked tile equals skipping it.
            p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            pq = quantize_mx(p, fmt, axis=-1, block=block,
                             scale_mode=scale_mode)
            vv = quantize_mx(vt, fmt, axis=-2, block=block,
                             scale_mode=scale_mode)
            acc = acc * corr[..., None] + torch.einsum("bgqk,bkd->bgqd",
                                                       pq, vv)
            m = m_new
        lc = torch.clamp(l, min=1e-30)
        outs.append((acc / lc[..., None]).to(out_dtype or q.dtype))
        lses.append(m + torch.log(lc))
    out = torch.cat(outs, dim=2)[:, :, :Tq]
    lse = torch.cat(lses, dim=2)[:, :, :Tq]
    return out, lse


def mx_flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, dout: torch.Tensor,
                               out: torch.Tensor, lse: torch.Tensor,
                               fmt: Optional[ElementFormat], spec: AttnSpec,
                               block: int = MX_BLOCK,
                               scale_mode: str = "floor", out_dtype=None):
    """Flash dgrad -> (dq, dk, dv).  p is recomputed from the *quantized*
    scores (q and k blocked along d) and the stashed lse; the gradient
    products are straight-through (raw v in dp, raw p in dV, raw k in dQ,
    raw q in dK).  Tiles and the skip rule are the reference's; dQ sums
    over kv tiles, dK/dV over q tiles per g, then over G.  Grads come back
    in the operands' dtypes, or all in ``out_dtype`` when given."""
    BH, G, Tq, d = q.shape
    Tk = k.shape[1]
    tile_q, tile_k, nq, nk = attn_tiles(spec, Tq, Tk)
    scale = 1.0 / math.sqrt(d)
    dof = dout.float()
    delta = torch.sum(dof * out.float(), dim=-1)
    qp = _pad_axis(q.float(), 2, nq * tile_q)
    dop = _pad_axis(dof, 2, nq * tile_q)
    lsep = _pad_axis(lse.float(), 2, nq * tile_q)
    dlp = _pad_axis(delta, 2, nq * tile_q)
    kp = _pad_axis(k.float(), 1, nk * tile_k)
    vp = _pad_axis(v.float(), 1, nk * tile_k)
    dq = torch.zeros_like(qp)
    dk_g = q.new_zeros((BH, G) + kp.shape[1:], dtype=torch.float32)
    dv_g = q.new_zeros((BH, G) + vp.shape[1:], dtype=torch.float32)

    def Q(x):
        return quantize_mx(x, fmt, axis=-1, block=block,
                           scale_mode=scale_mode)

    for qi in range(nq):
        rows = slice(qi * tile_q, (qi + 1) * tile_q)
        qt, dot = qp[:, :, rows], dop[:, :, rows]
        lset, dlt = lsep[:, :, rows], dlp[:, :, rows]
        qq = Q(qt)
        for kj in range(nk):
            if not attn_tile_needed(spec, qi, kj, tile_q, tile_k, Tk):
                continue
            cols = slice(kj * tile_k, (kj + 1) * tile_k)
            kt, vt = kp[:, cols], vp[:, cols]
            s = torch.einsum("bgqd,bkd->bgqk", qq, Q(kt)) * scale
            valid = attn_tile_mask(spec, qi, kj, tile_q, tile_k, Tk,
                                   q.device)
            s = torch.where(valid, s, NEG_INF)
            p = torch.where(valid, torch.exp(s - lset[..., None]), 0.0)
            dp = torch.einsum("bgqd,bkd->bgqk", dot, vt)
            ds = p * (dp - dlt[..., None]) * scale
            dq[:, :, rows] += torch.einsum("bgqk,bkd->bgqd", ds, kt)
            dv_g[:, :, cols] += torch.einsum("bgqk,bgqd->bgkd", p, dot)
            dk_g[:, :, cols] += torch.einsum("bgqk,bgqd->bgkd", ds, qt)
    dts = [out_dtype or t.dtype for t in (q, k, v)]
    return (dq[:, :, :Tq].to(dts[0]), dk_g[:, :, :Tk].sum(1).to(dts[1]),
            dv_g[:, :, :Tk].sum(1).to(dts[2]))


def fold_cache(x: torch.Tensor) -> torch.Tensor:
    """(B, S, Hkv, d) cache layout -> the folded (B*Hkv, S, d) layout."""
    B, S, H, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * H, S, d)


def mx_attention_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            valid: torch.Tensor,
                            fmt: Optional[ElementFormat],
                            block: int = MX_BLOCK,
                            scale_mode: str = "floor") -> torch.Tensor:
    """Decode (Tq = 1).  q (BH, G, d); k/v folded (BH, S, ·) with ``valid``
    (BH, S), or in the cache layout (B, S, Hkv, ·) with ``valid`` (B, S).
    The normalized probabilities are quantized along the whole cache axis,
    and v along S over every slot, valid or not."""
    if k.ndim == 4:
        valid = torch.repeat_interleave(valid, k.shape[2], dim=0)
        k, v = fold_cache(k), fold_cache(v)
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    qq = quantize_mx(q.float(), fmt, axis=-1, block=block,
                     scale_mode=scale_mode)
    kk = quantize_mx(k.float(), fmt, axis=-1, block=block,
                     scale_mode=scale_mode)
    s = torch.einsum("bgd,bsd->bgs", qq, kk) * scale
    ok = valid[:, None, :].to(torch.bool)
    s = torch.where(ok, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = torch.sum(p, dim=-1, keepdim=True)
    pr = p / torch.clamp(l, min=1e-30)
    prq = quantize_mx(pr, fmt, axis=-1, block=block, scale_mode=scale_mode)
    vv = quantize_mx(v.float(), fmt, axis=-2, block=block,
                     scale_mode=scale_mode)
    return torch.einsum("bgs,bsd->bgd", prq, vv).to(q.dtype)


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """The folded (B*H, P*ps, d) view of a (N, ps, H, d) page pool through
    a (B, P) page table: view position ``t`` of row ``b`` is offset
    ``t % ps`` of page ``page_table[b, t // ps]``.  Entries outside
    [0, N) are clamped (an unmapped -1 reads page 0); callers mask those
    view positions out."""
    B, P = page_table.shape
    N, ps, H, d = pool.shape
    g = pool[page_table.long().clamp(0, N - 1)]          # (B, P, ps, H, d)
    return g.permute(0, 3, 1, 2, 4).reshape(B * H, P * ps, d)


def mx_attention_decode_paged_ref(q: torch.Tensor, k_pool: torch.Tensor,
                                  v_pool: torch.Tensor,
                                  page_table: torch.Tensor,
                                  valid: torch.Tensor,
                                  fmt: Optional[ElementFormat],
                                  block: int = MX_BLOCK,
                                  scale_mode: str = "floor") -> torch.Tensor:
    """Paged decode: the decode version on the gathered view.  q (BH, G, d)
    with BH = B * H; pools (N, ps, H, ·); page_table (B, P); valid
    (B, P*ps) per view position."""
    H = k_pool.shape[2]
    return mx_attention_decode_ref(
        q, gather_pages(k_pool, page_table), gather_pages(v_pool, page_table),
        torch.repeat_interleave(valid, H, dim=0), fmt, block, scale_mode)
