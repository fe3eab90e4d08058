"""Multi-head Latent Attention (DeepSeek-V2) with MX-quantized projections.

Counterpart of ``repro.models.mla``.  Training and prefill use the
expanded form: per-head K/V decompressed from the latent, the query
``[q_nope, q_rope]`` of width ``nope + rope_dim`` against a value of width
``v_head``, through ``attention.flash_attention`` with every head its own
kv head (G = 1), so the flash kernels run a qk head dim unlike the v
head dim (192 against 128 at DeepSeek-V2's widths).  Decoding uses the
absorbed form on the compressed latent cache, ``kv_lora + rope_dim``
values a position: ``W_uk`` is folded into the query and ``W_uv`` applied
once to the latent-space context.  The slab decode (``mla_decode``) and
the paged one (``mla_decode_paged``) share ``_absorbed_attend``, so
gathering pages cannot drift from the slab numbers.  The latents stay
bf16 at rest (the paper quantizes GEMM operands, not state).

The absorbed products with a weight (``W_uk``, ``W_uv``) are the
reference's bf16 ``einsum``s: fp32 products of the bf16 operands rounded
once to bf16.  The caches are updated in place, as in
``attention.attention_decode``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.core import AttnSpec, QuantConfig, mx_contract
from repro_torch.kernels import ops
from .attention import decode_valid_mask, flash_attention
from .layers import apply_norm, dense_init, norm_init, qdense, rope

__all__ = ["mla_init", "mla_apply", "mla_prefill", "mla_decode",
           "mla_decode_paged"]

NEG_INF = -1e30


def mla_init(generator: torch.Generator, d_model: int, n_heads: int,
             q_lora: int, kv_lora: int, nope: int, rope_dim: int,
             v_head: int, n_layers: int = 1):
    """The reference's leaves, truncated normals of its stds (not its
    bits); the norm scales are ones on the generator's device."""
    gd = generator.device
    return {
        "w_dq": dense_init(generator, d_model, q_lora),
        "q_ln": norm_init(q_lora, device=gd),
        "w_uq": dense_init(generator, q_lora, n_heads * (nope + rope_dim)),
        "w_dkv": dense_init(generator, d_model, kv_lora),
        "kv_ln": norm_init(kv_lora, device=gd),
        "w_uk": dense_init(generator, kv_lora, n_heads * nope),
        "w_uv": dense_init(generator, kv_lora, n_heads * v_head),
        "w_kr": dense_init(generator, d_model, rope_dim),
        "wo": dense_init(generator, n_heads * v_head, d_model,
                         std=1.0 / math.sqrt(n_heads * v_head * 2
                                             * n_layers)),
    }


def _latents(p, x, qcfg: QuantConfig, positions, rope_theta: float):
    """Compressed queries cq and the (ckv, k_rope) latent pair."""
    B, T = x.shape[:2]
    cq = apply_norm(p["q_ln"], qdense(p["w_dq"], x, qcfg), qcfg)
    ckv = apply_norm(p["kv_ln"], qdense(p["w_dkv"], x, qcfg), qcfg)
    kr = qdense(p["w_kr"], x, qcfg).reshape(B, T, 1, -1)
    kr = rope(kr, positions, rope_theta).reshape(B, T, -1)
    return cq, ckv, kr


def _forward(p, x, qcfg: QuantConfig, n_heads: int, nope: int,
             rope_dim: int, v_head: int, positions, rope_theta: float,
             spec: AttnSpec):
    """Expanded-form attention over the whole sequence; also returns the
    latents."""
    B, T = x.shape[:2]
    cq, ckv, kr = _latents(p, x, qcfg, positions, rope_theta)
    q = qdense(p["w_uq"], cq, qcfg).reshape(B, T, n_heads, nope + rope_dim)
    q_rope = rope(q[..., nope:], positions, rope_theta)
    k_nope = qdense(p["w_uk"], ckv, qcfg).reshape(B, T, n_heads, nope)
    v = qdense(p["w_uv"], ckv, qcfg).reshape(B, T, n_heads, v_head)
    k_rope = kr[:, :, None, :].expand(B, T, n_heads, rope_dim)
    # every head is its own kv head (G = 1)
    qf = torch.cat([q[..., :nope], q_rope], -1)[:, :, :, None, :]
    kf = torch.cat([k_nope, k_rope], -1)
    o = flash_attention(qf, kf, v, qcfg, spec)
    o = o.reshape(B, T, n_heads * v_head)
    return qdense(p["wo"], o, qcfg), ckv, kr


def mla_apply(p, x, *, qcfg: QuantConfig, n_heads: int, nope: int,
              rope_dim: int, v_head: int, positions, spec: AttnSpec,
              rope_theta: float = 1e4) -> torch.Tensor:
    """The training layer: (B, T, D) -> (B, T, D)."""
    return _forward(p, x, qcfg, n_heads, nope, rope_dim, v_head, positions,
                    rope_theta, spec)[0]


def mla_prefill(p, x, *, qcfg: QuantConfig, n_heads: int, nope: int,
                rope_dim: int, v_head: int, positions, spec: AttnSpec,
                rope_theta: float = 1e4) -> Tuple[torch.Tensor, dict]:
    """Expanded-form attention plus the zero-padded latent cache
    {"ckv": (B, cache_len, kv_lora), "kr": (B, cache_len, rope_dim)} that
    the decodes read.  The decodes score in the absorbed form: the same
    math up to fp association, so prefill against decode is held to a
    tolerance, not bitwise."""
    B, T = x.shape[:2]
    cache_len = spec.cache_len
    if T > cache_len:
        raise ValueError(f"prompt length {T} exceeds cache_len {cache_len}")
    out, ckv, kr = _forward(p, x, qcfg, n_heads, nope, rope_dim, v_head,
                            positions, rope_theta, spec)
    cache = {"ckv": ckv.new_zeros((B, cache_len, ckv.shape[-1])),
             "kr": kr.new_zeros((B, cache_len, kr.shape[-1]))}
    cache["ckv"][:, :T] = ckv
    cache["kr"][:, :T] = kr
    return out, cache


def _einsum_bf16(eq: str, a: torch.Tensor, b: torch.Tensor, dtype):
    """``einsum`` of two operands in fp32, rounded once to ``dtype``: the
    reference's bf16 ``einsum`` (fp32 accumulation)."""
    return torch.einsum(eq, a.float(), b.float()).to(dtype)


def _maybe_quant(x: torch.Tensor, qcfg: QuantConfig, axis: int):
    if not qcfg.attn or qcfg.a_fwd is None:
        return x
    return ops.mx_quantize(x, qcfg.a_fwd, axis=axis, block=qcfg.block,
                           scale_mode=qcfg.scale_mode)


def _absorbed_attend(p, x, cq, ckv, kr, qcfg: QuantConfig, n_heads: int,
                     nope: int, rope_dim: int, v_head: int, positions,
                     rope_theta: float, valid):
    """Absorbed-form scores and context over a contiguous (B, S, ·) latent
    view with a (B, S) validity mask, shared by the slab and paged
    decodes: q_nope^T W_uk ckv + q_rope^T k_rope in fp32, the softmax, the
    latent-space context ``pr @ ckv`` through ``mx_contract(kind=
    "attn_pv")`` (pr and ckv cast along the cache axis when
    ``qcfg.attn``), then W_uv once and ``wo``."""
    B = x.shape[0]
    kv_lora = ckv.shape[-1]
    q = qdense(p["w_uq"], cq, qcfg).reshape(B, n_heads, nope + rope_dim)
    q_nope = q[..., :nope]
    q_rope = rope(q[:, None, :, nope:], positions, rope_theta)[:, 0]
    w_uk = p["w_uk"]["w"].to(x.dtype).reshape(kv_lora, n_heads, nope)
    q_eff = _einsum_bf16("bhd,chd->bhc", _maybe_quant(q_nope, qcfg, -1),
                         w_uk, x.dtype)                    # (B, H, kv_lora)
    scale = 1.0 / math.sqrt(nope + rope_dim)
    s = (torch.einsum("bhc,bsc->bhs", q_eff.float(), ckv.float())
         + torch.einsum("bhr,bsr->bhs", q_rope.float(), kr.float())) * scale
    s = torch.where(valid[:, None, :], s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    ctx = mx_contract(pr, ckv.float(), qcfg, kind="attn_pv")
    w_uv = p["w_uv"]["w"].to(x.dtype).reshape(kv_lora, n_heads, v_head)
    o = _einsum_bf16("bhc,chv->bhv", ctx.to(x.dtype), w_uv, x.dtype)
    return qdense(p["wo"], o.reshape(B, 1, n_heads * v_head), qcfg)


def mla_decode(p, x, cache, *, qcfg: QuantConfig, n_heads: int, nope: int,
               rope_dim: int, v_head: int, pos: torch.Tensor,
               rope_theta: float = 1e4) -> Tuple[torch.Tensor, dict]:
    """Absorbed-form decode on the slab latent cache {"ckv": (B, S,
    kv_lora), "kr": (B, S, rope_dim)}; x (B, 1, D); pos (B,).  The new
    latents are written into the cache in place."""
    B = x.shape[0]
    S = cache["ckv"].shape[1]
    positions = pos[:, None]
    cq, ckv_new, kr_new = _latents(p, x, qcfg, positions, rope_theta)
    rows = torch.arange(B, device=x.device)
    cache["ckv"][rows, pos] = ckv_new[:, 0].to(cache["ckv"].dtype)
    cache["kr"][rows, pos] = kr_new[:, 0].to(cache["kr"].dtype)
    out = _absorbed_attend(p, x, cq, cache["ckv"], cache["kr"], qcfg,
                           n_heads, nope, rope_dim, v_head, positions,
                           rope_theta, decode_valid_mask(pos, S))
    return out, cache


def mla_decode_paged(p, x, cache, *, qcfg: QuantConfig, n_heads: int,
                     nope: int, rope_dim: int, v_head: int,
                     pos: torch.Tensor, page_table: torch.Tensor, slots,
                     valid, rope_theta: float = 1e4
                     ) -> Tuple[torch.Tensor, dict]:
    """Absorbed-form decode on paged latent pools {"ckv": (N, ps,
    kv_lora), "kr": (N, ps, rope_dim)} through the (B, P) ``page_table``.
    The new latents go into the ``slots`` of ``attention.
    paged_write_slots`` in place; the row's (B, P*ps, ·) view is gathered
    (an unmapped -1 entry reads page 0, which ``valid`` hides) and scored
    by the slab path's ``_absorbed_attend``, so decode is bitwise the slab
    decode on the same logical contents."""
    B = x.shape[0]
    N = cache["ckv"].shape[0]
    P = page_table.shape[1]
    positions = pos[:, None]
    cq, ckv_new, kr_new = _latents(p, x, qcfg, positions, rope_theta)
    rows, page, off = slots
    cache["ckv"][page, off] = ckv_new[rows, 0].to(cache["ckv"].dtype)
    cache["kr"][page, off] = kr_new[rows, 0].to(cache["kr"].dtype)
    ptc = page_table.long().clamp(0, N - 1)
    ckv = cache["ckv"][ptc].reshape(B, P * cache["ckv"].shape[1], -1)
    kr = cache["kr"][ptc].reshape(B, P * cache["kr"].shape[1], -1)
    out = _absorbed_attend(p, x, cq, ckv, kr, qcfg, n_heads, nope, rope_dim,
                           v_head, positions, rope_theta, valid)
    return out, cache
