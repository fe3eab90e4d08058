"""Attention: MHA/GQA with QK-norm and RoPE, via ``mx_contract``.

Counterpart of ``repro.models.attention`` for dense attention.  Projections
go through ``qdense`` (the MX GEMM kernels); mixing goes through
``mx_contract(kind="flash_attn")`` on the folded (BH, G, T, d) layout for
training, prefill and prefill chunks (``kind="window"`` specs on windowed
layers), ``kind="attn_decode"`` for one-token decode against a slab cache
(global, or a ring buffer on windowed layers) and
``kind="attn_decode_paged"`` for one-token decode against page pools
through a page table.  QK-norm is an RMSNorm without bias whatever
``cfg.norm`` says, and runs without the layer-norm quantization, as in the
reference.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import AttnSpec, QuantConfig, mx_contract
from .layers import apply_norm, dense_init, norm_init, qdense, rope

__all__ = ["attn_init", "attention", "attention_decode",
           "attention_decode_paged", "attention_prefill",
           "attention_prefill_chunk", "decode_valid_mask", "flash_attention",
           "paged_valid_mask", "paged_write_slots"]


def attn_init(generator: torch.Generator, d_model: int, n_heads: int,
              n_kv: int, d_head: int, qk_norm: bool = False,
              qkv_bias: bool = False, n_layers: int = 1):
    p = {
        "wq": dense_init(generator, d_model, n_heads * d_head, bias=qkv_bias),
        "wk": dense_init(generator, d_model, n_kv * d_head, bias=qkv_bias),
        "wv": dense_init(generator, d_model, n_kv * d_head, bias=qkv_bias),
        "wo": dense_init(generator, n_heads * d_head, d_model,
                         std=1.0 / math.sqrt(n_heads * d_head * 2 * n_layers)),
    }
    if qk_norm:
        p["q_norm"] = norm_init(d_head, device=generator.device)
        p["k_norm"] = norm_init(d_head, device=generator.device)
    return p


def _project_qkv(p, x, qcfg: QuantConfig, n_heads: int, n_kv: int,
                 d_head: int, positions, rope_theta: float = 1e4):
    """q (B, T, Hkv, G, d), k and v (B, T, Hkv, d)."""
    B, T = x.shape[:2]
    G = n_heads // n_kv
    q = qdense(p["wq"], x, qcfg).reshape(B, T, n_kv, G, d_head)
    k = qdense(p["wk"], x, qcfg).reshape(B, T, n_kv, 1, d_head)
    v = qdense(p["wv"], x, qcfg).reshape(B, T, n_kv, 1, d_head)
    if "q_norm" in p:
        q = apply_norm(p["q_norm"], q, qcfg.without_ln_quant())
        k = apply_norm(p["k_norm"], k, qcfg.without_ln_quant())
    q = rope(q, positions, rope_theta)
    k = rope(k, positions, rope_theta)
    return q, k[:, :, :, 0], v[:, :, :, 0]


def _fold(q, k, v):
    """(B, T, Hkv, G/·, d) model layout -> q (B*Hkv, G, Tq, d),
    k (B*Hkv, Tk, d), v (B*Hkv, Tk, dv)."""
    B, Tq, Hkv, G, d = q.shape
    qf = q.permute(0, 2, 3, 1, 4).reshape(B * Hkv, G, Tq, d)
    kf = k.permute(0, 2, 1, 3).reshape(B * Hkv, k.shape[1], k.shape[-1])
    vf = v.permute(0, 2, 1, 3).reshape(B * Hkv, v.shape[1], v.shape[-1])
    return qf, kf, vf


def _unfold(out, B: int, Hkv: int):
    """(B*Hkv, G, Tq, dv) -> (B, Tq, Hkv, G, dv)."""
    BH, G, Tq, dv = out.shape
    return out.reshape(B, Hkv, G, Tq, dv).permute(0, 3, 1, 2, 4)


def flash_attention(q, k, v, qcfg: QuantConfig, spec: AttnSpec):
    """q (B, Tq, Hkv, G, d), k (B, Tk, Hkv, d), v (B, Tk, Hkv, dv) ->
    (B, Tq, Hkv, G, dv)."""
    B, Hkv = q.shape[0], q.shape[2]
    qf, kf, vf = _fold(q, k, v)
    out = mx_contract(qf, (kf, vf), qcfg, kind="flash_attn", spec=spec)
    return _unfold(out, B, Hkv)


def attention(p, x, *, qcfg: QuantConfig, n_heads: int, n_kv: int,
              d_head: int, positions, spec: AttnSpec,
              rope_theta: float = 1e4):
    """The training attention layer: projections, flash attention (whose
    backward is the flash dgrad) and the output projection, no cache."""
    B, T = x.shape[:2]
    q, k, v = _project_qkv(p, x, qcfg, n_heads, n_kv, d_head, positions,
                           rope_theta)
    o = flash_attention(q, k, v, qcfg, spec)
    return qdense(p["wo"], o.reshape(B, T, n_heads * d_head), qcfg)


def attention_prefill(p, x, *, qcfg: QuantConfig, n_heads: int, n_kv: int,
                      d_head: int, positions, spec: AttnSpec,
                      rope_theta: float = 1e4):
    """Full-sequence attention plus the decode cache.  A global layer's
    cache is the zero-padded (B, cache_len, Hkv, d) buffer with every
    prompt position written, the engine's bucket padding included: decode
    quantizes v along the whole cache axis, so those pad rows are part of
    the numbers, as in the reference.  A windowed layer (``spec.kind ==
    "window"``) returns the ring of ``min(cache_len, window)`` slots with
    the last ``min(T, ring)`` tokens at slots ``position % ring`` (older
    tokens would have been overwritten by token stepping)."""
    B, T = x.shape[:2]
    window = spec.window if spec.kind == "window" else 0
    cache_len = spec.cache_len
    if not window and T > cache_len:
        raise ValueError(f"prompt length {T} exceeds cache_len {cache_len}")
    q, k, v = _project_qkv(p, x, qcfg, n_heads, n_kv, d_head, positions,
                           rope_theta)
    o = flash_attention(q, k, v, qcfg, spec)
    out = qdense(p["wo"], o.reshape(B, T, n_heads * d_head), qcfg)
    ring = min(cache_len, window) if window else cache_len
    m = min(T, ring)
    slots = torch.arange(T - m, T, device=x.device) % ring
    ck = k.new_zeros((B, ring) + k.shape[2:])
    cv = v.new_zeros((B, ring) + v.shape[2:])
    ck[:, slots] = k[:, T - m:]
    cv[:, slots] = v[:, T - m:]
    return out, {"k": ck, "v": cv}


def decode_valid_mask(pos: torch.Tensor, S: int,
                      window: int = 0) -> torch.Tensor:
    """(B, S) cache-slot validity at per-row positions ``pos``.  A ring of
    S slots (``window > 0``): slot s is valid if it was written within the
    last ``min(pos + 1, window)`` steps.  A global cache: slots up to
    ``pos``."""
    kv_pos = torch.arange(S, device=pos.device)
    if window > 0:
        age = ((pos % S)[:, None] - kv_pos[None, :]) % S
        return age <= torch.clamp(pos, max=window - 1)[:, None]
    return kv_pos[None, :] <= pos[:, None]


def attention_decode(p, x, cache, *, qcfg: QuantConfig, n_heads: int,
                     n_kv: int, d_head: int, pos: torch.Tensor,
                     spec: Optional[AttnSpec] = None,
                     rope_theta: float = 1e4):
    """One-token decode.  x (B, 1, D); cache {"k", "v"}: (B, S, Hkv, d);
    pos (B,) int.  ``spec`` from ``LMConfig.decode_spec``: ``kind="ring"``
    makes the cache a ring buffer (slot ``pos % S``), otherwise it is
    global (slot ``pos``).  The new K/V row is written into the cache in
    place before it is attended (the reference returns a new cache and
    donates the old buffers), and the decode kernel reads the cache in
    this layout through strides."""
    B = x.shape[0]
    S = cache["k"].shape[1]
    window = spec.window if spec is not None and spec.kind == "ring" else 0
    q, k_new, v_new = _project_qkv(p, x, qcfg, n_heads, n_kv, d_head,
                                   pos[:, None], rope_theta)
    rows = torch.arange(B, device=x.device)
    slot = pos % S if window else pos
    cache["k"][rows, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v_new[:, 0].to(cache["v"].dtype)
    G = n_heads // n_kv
    qf = q[:, 0].reshape(B * n_kv, G, d_head)
    o = mx_contract(qf, (cache["k"], cache["v"]), qcfg, kind="attn_decode",
                    valid=decode_valid_mask(pos, S, window))
    o = o.reshape(B, 1, n_heads * d_head).to(x.dtype)
    return qdense(p["wo"], o, qcfg), cache


def paged_valid_mask(page_table: torch.Tensor, pos: torch.Tensor,
                     page_size: int) -> torch.Tensor:
    """(B, P*ps) validity of each view position for paged decode: its page
    is mapped (>= 0) and its logical position (= view position) is <= the
    row's ``pos``.  A dead row (all -1) has no valid position."""
    B, P = page_table.shape
    vp = torch.arange(P * page_size, device=page_table.device)
    allocated = (page_table >= 0)[:, vp // page_size]
    return allocated & (vp[None, :] <= pos[:, None])


def paged_write_slots(page_table: torch.Tensor, pos: torch.Tensor,
                      page_size: int, live: Optional[torch.Tensor] = None):
    """(rows, page, off): where a paged decode step writes each live row's
    new K/V, its tail page ``page_table[row, pos // ps]`` at ``pos % ps``.
    ``live`` (n,) long holds the rows whose tail page is mapped, where the
    caller knows them (the engine does); None finds them from the table at
    the cost of one host sync.  A dead row writes nothing: its -1 entry
    would wrap to page N-1."""
    if live is None:
        rows = torch.arange(page_table.shape[0], device=page_table.device)
        live = torch.nonzero(
            page_table[rows, pos // page_size] >= 0).squeeze(1)
    lpos = pos[live]
    return live, page_table[live, lpos // page_size].long(), lpos % page_size


def attention_decode_paged(p, x, cache, *, qcfg: QuantConfig, n_heads: int,
                           n_kv: int, d_head: int, pos: torch.Tensor,
                           page_table: torch.Tensor, slots, valid,
                           rope_theta: float = 1e4):
    """One-token decode against page pools.  x (B, 1, D); cache {"k", "v"}:
    (N, ps, Hkv, d) pools shared by every row through the (B, P) int32
    ``page_table`` (physical page of logical page ``t // ps``; -1 =
    unmapped); pos (B,).  The new K/V rows go into the ``slots`` of
    ``paged_write_slots`` in place, and attention reads the positions that
    ``valid`` (``paged_valid_mask``) admits.  Both depend only on the table
    and ``pos``, so the caller computes them once for every layer."""
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(p, x, qcfg, n_heads, n_kv, d_head,
                                   pos[:, None], rope_theta)
    rows, page, off = slots
    cache["k"][page, off] = k_new[rows, 0].to(cache["k"].dtype)
    cache["v"][page, off] = v_new[rows, 0].to(cache["v"].dtype)
    G = n_heads // n_kv
    qf = q[:, 0].reshape(B * n_kv, G, d_head)
    o = mx_contract(qf, (cache["k"], cache["v"]), qcfg,
                    kind="attn_decode_paged", valid=valid, pages=page_table)
    o = o.reshape(B, 1, n_heads * d_head).to(x.dtype)
    return qdense(p["wo"], o, qcfg), cache


def attention_prefill_chunk(p, x, prior_k, prior_v, *, qcfg: QuantConfig,
                            n_heads: int, n_kv: int, d_head: int, positions,
                            spec: AttnSpec, kv_mask=None,
                            rope_theta: float = 1e4):
    """One chunk of a chunked prefill.  x (B, C, D) at absolute positions
    ``spec.q_offset ..``; prior_k/prior_v (B, q_offset, Hkv, d) are the
    prefix K/V gathered from the page pools.  The chunk's queries attend
    prefix + chunk through the rectangular causal flash forward
    (``q_offset``).  ``kv_mask`` (B, C) zeroes the K/V of padded tail
    positions before attention, so pads are neither attended nor part of
    the at-rest MX block scales.  Returns (out (B, C, D), k, v) with the
    chunk's (B, C, Hkv, d) K/V for the caller to write into pages."""
    B, C = x.shape[:2]
    q, k, v = _project_qkv(p, x, qcfg, n_heads, n_kv, d_head, positions,
                           rope_theta)
    if kv_mask is not None:
        m = kv_mask[:, :, None, None]
        k = torch.where(m, k, 0.0)
        v = torch.where(m, v, 0.0)
    k_full = torch.cat([prior_k.to(k.dtype), k], dim=1)
    v_full = torch.cat([prior_v.to(v.dtype), v], dim=1)
    o = flash_attention(q, k_full, v_full, qcfg, spec)
    out = qdense(p["wo"], o.reshape(B, C, n_heads * d_head), qcfg)
    return out, k, v
