"""Decoder LM assembly: training forward and loss, prefill and decode.

Counterpart of ``repro.models.transformer`` for ``"attn"`` blocks, dense
or MoE, with multi-head attention or MLA (``models.mla``), global or
windowed, Griffin's ``"rec"`` blocks (``models.rglru``) and xLSTM's
``"mlstm"`` and ``"slstm"`` blocks (``models.xlstm``).  Parameters
are a plain dict with per-layer entries:

    {"embed": {"table"}, "layers": [block, ...], "final_ln": {...},
     "lm_head": {"w"}}

where each ``block`` has the reference's per-block names (``ln1``, ``attn``,
``ln2``, and ``mlp``, or on an MoE layer ``moe`` and ``shared``); on an MLA
config ``attn`` holds ``mla_init``'s leaves, a ``"rec"`` block holds
``rec`` (``rec_block_init``'s leaves) in place of ``attn``, and an xLSTM
block is the reference's ``{"ln", "cell"}`` (a pre-norm and the cell's
leaves, its FFN inside the cell).  An MoE config's first
``first_dense`` layers are dense (the reference's leading ``"dense_attn"``
group).  Layer ``i`` is the reference's stacked group entry
``blocks[g]["b{j}"][r]`` in plan order (see ``convert.params_from_jax``).
The decode cache is a list with one ``{"k", "v"}`` dict of (B, S, Hkv, d)
bf16 tensors per layer (on MLA, ``{"ckv", "kr"}`` latents of (B, S,
kv_lora) and (B, S, rope_dim); on a windowed layer a ring of min(S,
window) slots; on a ``"rec"`` layer ``{"conv"}`` (B, 3, d_rnn) bf16 and
``{"h"}`` (B, d_rnn) fp32; on an ``"mlstm"`` layer ``{"conv"}`` (B, 3,
d_in) bf16 and ``{"C", "n", "m"}`` fp32, on an ``"slstm"`` layer ``{"c",
"n", "m", "h"}`` fp32, both ``m`` starting at -1e30), updated in place;
the paged cache
(``init_cache_paged``) is the same list with (N, ps, ...) page pools in
place of the (B, S, ...) rows of every layer that pages (``kind_paged``:
global attention and MLA), addressed through one (B, P) page table; ring,
recurrent and xLSTM layers keep their slab rows there.
Layers run as a Python loop over that list; the reference's activation
checkpointing (``remat``) is not ported yet: at olmo-paper's size the
activations fit.

Encoder-decoder, frontend and tied-embedding configs raise
``NotImplementedError``: they come with a later slice of the port
(ROADMAP Queue A item 4).  MoE, MLA, windowed, recurrent and xLSTM
configs prefill whole: ``lm_prefill_chunk`` raises for them
(``chunk_supported``), and the paged engine pages their cache (or
inserts its slab rows) after a whole-prompt prefill.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import AttnSpec, QuantConfig
from repro_torch.devices import resolve_device
from .attention import (attention, attention_decode, attention_decode_paged,
                        attention_prefill, attention_prefill_chunk,
                        attn_init, paged_valid_mask, paged_write_slots)
from .layers import (apply_norm, dense_init, embed_init, embed_lookup,
                     norm_init, qdense)
from .mla import (mla_apply, mla_decode, mla_decode_paged, mla_init,
                  mla_prefill)
from .mlp import mlp_apply, mlp_init
from .moe import moe_apply, moe_init
from .rglru import (rec_block_apply, rec_block_decode, rec_block_init,
                    rec_block_prefill)
from .xlstm import (M_INIT, mlstm_apply, mlstm_decode, mlstm_dims,
                    mlstm_init, mlstm_prefill, slstm_apply, slstm_decode,
                    slstm_init, slstm_prefill)

__all__ = ["LMConfig", "block_plan", "lm_init", "lm_apply", "lm_loss",
           "init_cache", "lm_prefill", "lm_decode_step", "prefill_supported",
           "chunk_supported", "check_supported", "init_cache_paged",
           "lm_prefill_chunk", "kind_paged", "paged_leaf_mask",
           "layer_kinds"]

#: The capacity factor of MoE routing in prefill and decode (the
#: reference's serving value: the training capacity would drop prompt
#: tokens that per-step decode never drops).
SERVE_CAPACITY = 4.0


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The reference's ``LMConfig`` field for field, so a config converts
    between the packages with ``dataclasses.asdict``."""
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 64
    d_ff: int = 1024
    vocab: int = 512
    norm: str = "rmsnorm"
    act: str = "gelu"
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    moe_dff: int = 0
    capacity_factor: float = 1.25
    first_dense: int = 0
    mla: bool = False
    q_lora: int = 1536
    kv_lora: int = 512
    nope_dim: int = 128
    rope_dim: int = 64
    v_head: int = 128
    block_pattern: Tuple[str, ...] = ("attn",)
    window: int = 0
    d_rnn: int = 0
    enc_layers: int = 0
    frontend: str = "none"
    n_frontend_tokens: int = 0
    scan_layers: bool = True
    remat: str = "full"
    q_chunk: int = 512
    kv_chunk: int = 1024
    loss_chunk: int = 2048

    @property
    def qk_dim(self) -> int:
        """The width of a query and key head (MLA's ``nope + rope_dim``)."""
        return (self.nope_dim + self.rope_dim) if self.mla else self.d_head

    def attn_spec(self, kind: str = "attn", cache_len: int = 0) -> AttnSpec:
        """Training/prefill AttnSpec of a block kind with the config's
        tiles.  Only "attn" blocks take the local window ("dense_attn"
        lead layers and MLA attend globally); ``cache_len`` is set for
        prefill specs."""
        window = self.window if (kind == "attn" and not self.mla) else 0
        return dataclasses.replace(
            AttnSpec.training(window=window,
                              q_chunk=self.q_chunk, kv_chunk=self.kv_chunk),
            cache_len=cache_len)

    def decode_spec(self, kind: str = "attn", cache_len: int = 0) -> AttnSpec:
        """One-token slab decode AttnSpec: a ring buffer on windowed layers
        (paged layers decode through ``attention_decode_paged``)."""
        window = self.window if (kind == "attn" and not self.mla) else 0
        return AttnSpec.decode(window=window, cache_len=cache_len)


def check_supported(cfg: LMConfig) -> None:
    """Raise for configs outside this slice of the port."""
    later = []
    if not set(cfg.block_pattern) <= {"attn", "rec", "mlstm", "slstm"}:
        later.append(f"block kinds {sorted(set(cfg.block_pattern))}")
    if cfg.enc_layers or cfg.frontend != "none":
        later.append("encoder-decoder / modality frontends")
    if cfg.tie_embeddings:
        later.append("tied embeddings")
    if later:
        raise NotImplementedError(
            f"config {cfg.name!r} needs {', '.join(later)}: the port serves "
            "'attn' stacks, dense or MoE, with MHA/GQA or MLA, global or "
            "windowed, Griffin's 'rec' blocks and xLSTM's 'mlstm' and "
            "'slstm' blocks; the other architectures (encoder-decoder and "
            "frontends after the four dense configs) come with a later "
            "slice of the port (ROADMAP Queue A item 4)")


def block_plan(cfg: LMConfig) -> List[Tuple[Tuple[str, ...], int]]:
    """The reference's scan groups: (pattern, n_rep) in layer order; an
    MoE config's leading dense layers are a ``("dense_attn",)`` group."""
    pat = tuple(cfg.block_pattern)
    n_layers = cfg.n_layers
    groups = []
    lead = cfg.first_dense if cfg.n_experts else 0
    if lead:
        groups.append((("dense_attn",), lead))
        n_layers -= lead
    n_rep, tail = divmod(n_layers, len(pat))
    if n_rep:
        groups.append((pat, n_rep))
    if tail:
        groups.append((pat[:tail], 1))
    return groups


def layer_kinds(cfg: LMConfig) -> List[str]:
    """Each layer's block kind, in the order of ``params["layers"]``."""
    return [kind for pattern, n_rep in block_plan(cfg)
            for _ in range(n_rep) for kind in pattern]


def prefill_supported(cfg: LMConfig) -> bool:
    """Whether ``lm_prefill`` covers this config (decoder-only stacks)."""
    return cfg.enc_layers == 0 and cfg.frontend == "none"


def chunk_supported(cfg: LMConfig) -> bool:
    """Whether ``lm_prefill_chunk`` covers this config: a pure global-
    attention decoder stack.  Windowed, recurrent, xLSTM, MLA and MoE
    configs prefill whole: their prefix state is not an append-only K/V
    sequence (ring slots, recurrent state, latents, batch-level
    routing)."""
    return (prefill_supported(cfg) and not cfg.mla and cfg.window == 0
            and cfg.n_experts == 0 and cfg.d_rnn == 0
            and set(cfg.block_pattern) <= {"attn"})


def _block_init(generator: torch.Generator, kind: str, cfg: LMConfig):
    L = cfg.n_layers
    gd = generator.device
    if kind in _XLSTM:
        return {"ln": norm_init(cfg.d_model, cfg.norm, gd),
                "cell": _XLSTM[kind][0](generator, cfg.d_model, cfg.n_heads,
                                        L)}
    p = {"ln1": norm_init(cfg.d_model, cfg.norm, gd),
         "ln2": norm_init(cfg.d_model, cfg.norm, gd)}
    if kind == "rec":
        p["rec"] = rec_block_init(generator, cfg.d_model, cfg.d_rnn, L)
        p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.act, L)
        return p
    if cfg.mla:
        p["attn"] = mla_init(generator, cfg.d_model, cfg.n_heads, cfg.q_lora,
                             cfg.kv_lora, cfg.nope_dim, cfg.rope_dim,
                             cfg.v_head, L)
    else:
        p["attn"] = attn_init(generator, cfg.d_model, cfg.n_heads,
                              cfg.n_kv_heads, cfg.d_head, cfg.qk_norm,
                              cfg.qkv_bias, L)
    if cfg.n_experts and kind == "attn":
        p["moe"] = moe_init(generator, cfg.d_model, cfg.moe_dff,
                            cfg.n_experts, cfg.act, L)
        if cfg.n_shared:
            p["shared"] = mlp_init(generator, cfg.d_model,
                                   cfg.n_shared * cfg.moe_dff, cfg.act, L)
    else:
        p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.act, L)
    return p


#: xLSTM block kinds: (init, apply, prefill, decode) of the cell, each
#: taking the config's n_heads after the quantization config.
_XLSTM = {"mlstm": (mlstm_init, mlstm_apply, mlstm_prefill, mlstm_decode),
          "slstm": (slstm_init, slstm_apply, slstm_prefill, slstm_decode)}


def lm_init(cfg: LMConfig, generator: torch.Generator, device=None
            ) -> Dict[str, Any]:
    """Fresh fp32 weights with the reference's shapes and distributions
    (truncated normals, unit norm scales, zero biases); not its bits.  Drawn
    on ``generator.device`` and moved to ``device`` (default ``cuda``)."""
    check_supported(cfg)
    device = resolve_device(device)
    gd = generator.device
    params = {"embed": embed_init(generator, cfg.vocab, cfg.d_model),
              "layers": [_block_init(generator, kind, cfg)
                         for kind in layer_kinds(cfg)]}
    params["final_ln"] = norm_init(cfg.d_model, cfg.norm, gd)
    params["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab,
                                   std=1.0 / math.sqrt(cfg.d_model))
    return tree_map(lambda t: t.to(device), params)


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def kind_paged(kind: str, cfg: LMConfig) -> bool:
    """Whether a block kind's decode state lives in page pools: global
    attention and MLA latents page; ring-buffer (windowed) layers and
    recurrent and xLSTM state keep their slab rows (O(window) and O(1) a
    row: nothing to page)."""
    if kind not in ("attn", "dense_attn"):
        return False
    return cfg.mla or not (cfg.window and kind == "attn")


def _cache_shapes(cfg: LMConfig, kind: str, lead: Tuple[int, int]) -> dict:
    """One layer's decode-cache leaves, (shape, dtype), with ``lead`` =
    (B, S) rows or (N, ps) pages in front: K/V heads (a ring of min(S,
    window) slots on a windowed layer), MLA's latents, a ``"rec"`` layer's
    conv window and fp32 state, or an xLSTM layer's (its head size is
    d_in / H for the mLSTM and D / H for the sLSTM, not d_head)."""
    bf, f32 = torch.bfloat16, torch.float32
    if kind == "mlstm":
        B, H = lead[0], cfg.n_heads
        d_in, dh = mlstm_dims(cfg.d_model, H)
        return {"conv": ((B, 3, d_in), bf), "C": ((B, H, dh, dh), f32),
                "n": ((B, H, dh), f32), "m": ((B, H), f32)}
    if kind == "slstm":
        shp = (lead[0], cfg.n_heads, cfg.d_model // cfg.n_heads)
        return {n: (shp, f32) for n in "cnmh"}
    if kind == "rec":
        B = lead[0]
        return {"conv": ((B, 3, cfg.d_rnn), bf),
                "h": ((B, cfg.d_rnn), torch.float32)}
    if cfg.mla:
        return {"ckv": (lead + (cfg.kv_lora,), bf),
                "kr": (lead + (cfg.rope_dim,), bf)}
    if cfg.window and kind == "attn":
        lead = (lead[0], min(lead[1], cfg.window))
    shp = lead + (cfg.n_kv_heads, cfg.d_head)
    return {"k": (shp, bf), "v": (shp, bf)}


def _zeros(cfg: LMConfig, kind: str, lead, device) -> dict:
    """A layer's initial decode state: zeros, but an xLSTM stabilizer
    ``m`` at the reference's -1e30."""
    return {n: torch.full(shp, M_INIT if n == "m" else 0.0, dtype=dt,
                          device=device)
            for n, (shp, dt) in _cache_shapes(cfg, kind, lead).items()}


def init_cache(cfg: LMConfig, B: int, S: int, device=None) -> List[dict]:
    """Initial decode cache per layer: zeroed bf16 (B, S, Hkv, d) K/V (a
    ring of min(S, window) slots on windowed layers), MLA's (B, S,
    kv_lora) / (B, S, rope_dim) latents, a ``"rec"`` layer's (B, 3, d_rnn)
    bf16 conv window and (B, d_rnn) fp32 state, or an xLSTM layer's conv
    window and fp32 cell state (``m`` at -1e30)."""
    check_supported(cfg)
    device = resolve_device(device)
    return [_zeros(cfg, kind, (B, S), device) for kind in layer_kinds(cfg)]


def init_cache_paged(cfg: LMConfig, n_pages: int, page_size: int,
                     device=None, *, B: int = 0, S: int = 0) -> List[dict]:
    """Paged decode cache: per layer that pages (``kind_paged``), zeroed
    bf16 (N, ps, ...) pools of its leaves (K/V heads, or MLA's latents),
    shared by every row through the engine's page table; every other layer
    keeps ``init_cache``'s slab rows, B rows of capacity S (which must be
    given when the config has such layers)."""
    check_supported(cfg)
    device = resolve_device(device)
    kinds = layer_kinds(cfg)
    if not all(kind_paged(k, cfg) for k in kinds) and not (B and S):
        raise ValueError(f"config {cfg.name!r} keeps slab leaves in its "
                         "paged cache: give their rows B and capacity S")
    return [_zeros(cfg, kind, (n_pages, page_size) if kind_paged(kind, cfg)
                   else (B, S), device) for kind in kinds]


def paged_leaf_mask(cfg: LMConfig) -> List[dict]:
    """``init_cache_paged``'s structure with a bool per leaf: True for a
    page pool, False for a slab leaf."""
    return [{n: kind_paged(kind, cfg) for n in _cache_shapes(cfg, kind,
                                                             (1, 1))}
            for kind in layer_kinds(cfg)]


def _block_rest(h, lp, cfg: LMConfig, qcfg: QuantConfig, a,
                capacity_factor: float):
    """The residual, norm and feed-forward after attention output ``a``.
    Returns (h, the MoE auxiliary loss or None on a dense layer)."""
    h = h + a
    hn2 = apply_norm(lp["ln2"], h, qcfg, cfg.norm)
    if "moe" not in lp:
        return h + mlp_apply(lp["mlp"], hn2, qcfg, cfg.act), None
    y, metrics = moe_apply(lp["moe"], hn2.reshape(-1, hn2.shape[-1]), qcfg,
                           top_k=cfg.top_k, act=cfg.act,
                           capacity_factor=capacity_factor)
    y = y.reshape(hn2.shape)
    if "shared" in lp:
        y = y + mlp_apply(lp["shared"], hn2, qcfg, cfg.act)
    return h + y, metrics["aux_loss"]


def _mla_kw(cfg: LMConfig) -> dict:
    return dict(n_heads=cfg.n_heads, nope=cfg.nope_dim,
                rope_dim=cfg.rope_dim, v_head=cfg.v_head,
                rope_theta=cfg.rope_theta)


def _attn_kw(cfg: LMConfig) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.d_head,
                rope_theta=cfg.rope_theta)


def lm_apply(params, batch, cfg: LMConfig, qcfg: QuantConfig):
    """Forward to the final hidden states (B, T, D) in bf16.  Returns
    (hidden, aux_loss): the MoE layers' load-balance losses summed (0 for
    a dense stack)."""
    check_supported(cfg)
    tok = batch["tokens"]
    B, T = tok.shape
    h = embed_lookup(params["embed"], tok)
    positions = torch.arange(T, device=tok.device)[None].expand(B, T)
    aux = torch.zeros((), dtype=torch.float32, device=tok.device)
    for kind, lp in zip(layer_kinds(cfg), params["layers"]):
        if kind in _XLSTM:
            h = h + _XLSTM[kind][1](lp["cell"], apply_norm(
                lp["ln"], h, qcfg, cfg.norm), qcfg, cfg.n_heads)
            continue
        hn = apply_norm(lp["ln1"], h, qcfg, cfg.norm)
        if kind == "rec":
            a = rec_block_apply(lp["rec"], hn, qcfg)
        else:
            apply = mla_apply if cfg.mla else attention
            kw = _mla_kw(cfg) if cfg.mla else _attn_kw(cfg)
            a = apply(lp["attn"], hn, qcfg=qcfg, positions=positions,
                      spec=cfg.attn_spec(kind), **kw)
        h, la = _block_rest(h, lp, cfg, qcfg, a, cfg.capacity_factor)
        if la is not None:
            aux = aux + la
    h = apply_norm(params["final_ln"], h, qcfg, cfg.norm)
    return h, aux


def lm_loss(params, batch, cfg: LMConfig, qcfg: QuantConfig):
    """Mean next-token cross-entropy, streamed over sequence chunks of
    ``cfg.loss_chunk`` (the LM-head GEMM inside the chunk loop, so fp32
    logits peak at (B, loss_chunk, vocab)).  The last chunk is zero-padded
    to full length as in the reference: wgrad blocks run along the chunk's
    B * loss_chunk tokens, so the padding is part of the numbers.  Labels
    < 0 are masked.  Returns (loss + 0.01 * aux, {"loss", "aux_loss"})."""
    h, aux = lm_apply(params, batch, cfg, qcfg)
    labels = batch["labels"]
    B, T, D = h.shape
    mask = (labels >= 0).to(torch.float32)
    lc = min(cfg.loss_chunk, T)
    pad = -T % lc
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, T + pad, lc):
        logits = qdense(params["lm_head"], h[:, c0:c0 + lc],
                        qcfg).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        lx = torch.clamp(labels[:, c0:c0 + lc], min=0)
        ll = torch.gather(logits, -1, lx[..., None])[..., 0]
        total = total + torch.sum((lse - ll) * mask[:, c0:c0 + lc])
    loss = total / torch.clamp(torch.sum(mask), min=1.0)
    return loss + 0.01 * aux, {"loss": loss, "aux_loss": aux}


def lm_prefill(params, tokens: torch.Tensor, cfg: LMConfig,
               qcfg: QuantConfig, max_len: int,
               logit_positions: Optional[torch.Tensor] = None):
    """One full forward over (B, T) prompts that also builds the decode
    cache.  Returns (logits (B, vocab) at ``logit_positions`` — the true
    prompt ends, default T-1 — and the per-layer cache)."""
    check_supported(cfg)
    B, T = tokens.shape
    h = embed_lookup(params["embed"], tokens)
    positions = torch.arange(T, device=tokens.device)[None].expand(B, T)
    caches = []
    for kind, lp in zip(layer_kinds(cfg), params["layers"]):
        if kind in _XLSTM:
            a, c = _XLSTM[kind][2](lp["cell"], apply_norm(
                lp["ln"], h, qcfg, cfg.norm), qcfg, cfg.n_heads)
            h = h + a
            caches.append(c)
            continue
        hn = apply_norm(lp["ln1"], h, qcfg, cfg.norm)
        if kind == "rec":
            a, c = rec_block_prefill(lp["rec"], hn, qcfg)
        else:
            prefill = mla_prefill if cfg.mla else attention_prefill
            kw = _mla_kw(cfg) if cfg.mla else _attn_kw(cfg)
            a, c = prefill(lp["attn"], hn, qcfg=qcfg, positions=positions,
                           spec=cfg.attn_spec(kind, cache_len=max_len), **kw)
        h, _ = _block_rest(h, lp, cfg, qcfg, a, SERVE_CAPACITY)
        caches.append(c)
    h = apply_norm(params["final_ln"], h, qcfg, cfg.norm)
    if logit_positions is None:
        logit_positions = torch.full((B,), T - 1, dtype=torch.long,
                                     device=tokens.device)
    h_last = h[torch.arange(B, device=tokens.device), logit_positions]
    return qdense(params["lm_head"], h_last, qcfg), caches


def lm_prefill_chunk(params, tokens: torch.Tensor, prior: List[dict],
                     start: int, cfg: LMConfig, qcfg: QuantConfig,
                     logit_positions: Optional[torch.Tensor] = None,
                     kv_mask: Optional[torch.Tensor] = None):
    """One chunk of a chunked prefill: ``tokens`` (B, C) at absolute
    positions ``start .. start+C-1`` attend the prefix written before them
    through ``prior``, a per-layer list of ``{"k", "v"}`` (B, start, Hkv, d)
    gathered from the page pools.  Returns (logits (B, vocab) at
    ``logit_positions``, default C-1, and the per-layer list of the chunk's
    (B, C, Hkv, d) K/V for the caller to write into pages).  ``kv_mask``
    (B, C) zeroes padded tail K/V, so a fixed chunk shape can carry a
    shorter last chunk.  Raises for configs outside ``chunk_supported``."""
    check_supported(cfg)
    if not chunk_supported(cfg):
        raise NotImplementedError(
            f"config {cfg.name!r}: chunked prefill covers pure global-"
            "attention decoder stacks; MoE and MLA configs prefill whole "
            "(the paged engine pages their cache afterwards)")
    B, C = tokens.shape
    h = embed_lookup(params["embed"], tokens)
    positions = torch.arange(start, start + C,
                             device=tokens.device)[None].expand(B, C)
    spec = cfg.attn_spec().with_offset(start)
    chunk = []
    for lp, lc in zip(params["layers"], prior):
        hn = apply_norm(lp["ln1"], h, qcfg, cfg.norm)
        a, ck, cv = attention_prefill_chunk(
            lp["attn"], hn, lc["k"], lc["v"], qcfg=qcfg, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, d_head=cfg.d_head, positions=positions,
            spec=spec, kv_mask=kv_mask, rope_theta=cfg.rope_theta)
        h, _ = _block_rest(h, lp, cfg, qcfg, a, SERVE_CAPACITY)
        chunk.append({"k": ck, "v": cv})
    h = apply_norm(params["final_ln"], h, qcfg, cfg.norm)
    if logit_positions is None:
        logit_positions = torch.full((B,), C - 1, dtype=torch.long,
                                     device=tokens.device)
    h_last = h[torch.arange(B, device=tokens.device), logit_positions]
    return qdense(params["lm_head"], h_last, qcfg), chunk


def lm_decode_step(params, cache: List[dict], tok: torch.Tensor,
                   pos: torch.Tensor, cfg: LMConfig, qcfg: QuantConfig,
                   page_table: Optional[torch.Tensor] = None,
                   live: Optional[torch.Tensor] = None):
    """One decode step.  tok (B, 1) int; pos (B,) per-row positions (a
    scalar broadcasts).  Writes the new K/V into ``cache`` in place and
    returns (logits (B, vocab), cache).  With ``page_table`` ((B, P)
    int32), ``cache`` is ``init_cache_paged``'s and every layer that pages
    decodes through the table; ``live`` (n,) long names the rows whose
    tail page is mapped (see ``paged_write_slots``).  Ring (windowed),
    ``"rec"`` and xLSTM layers decode on their slab rows either way, every
    row live or not.  An MLA config decodes in the absorbed form on its
    latent cache (``mla_decode`` / ``mla_decode_paged``)."""
    check_supported(cfg)
    B = tok.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.long, device=tok.device)
    pos = pos.expand(B) if pos.ndim == 0 else pos
    kw = dict(qcfg=qcfg, pos=pos,
              **(_mla_kw(cfg) if cfg.mla else _attn_kw(cfg)))
    kinds = layer_kinds(cfg)
    paged = [page_table is not None and kind_paged(k, cfg) for k in kinds]
    pkw = {}
    if any(paged):
        # The write slots and the mask are the same in every paged layer.
        ps = next(iter(cache[paged.index(True)].values())).shape[1]
        pkw = dict(kw, page_table=page_table,
                   slots=paged_write_slots(page_table, pos, ps, live),
                   valid=paged_valid_mask(page_table, pos, ps))
    h = embed_lookup(params["embed"], tok)
    for kind, pg, lp, lc in zip(kinds, paged, params["layers"], cache):
        if kind in _XLSTM:
            a, _ = _XLSTM[kind][3](lp["cell"], apply_norm(
                lp["ln"], h, qcfg, cfg.norm), lc, qcfg, cfg.n_heads)
            h = h + a
            continue
        hn = apply_norm(lp["ln1"], h, qcfg, cfg.norm)
        if kind == "rec":
            a, _ = rec_block_decode(lp["rec"], hn, lc, qcfg)
        elif pg:
            decode = mla_decode_paged if cfg.mla else attention_decode_paged
            a, _ = decode(lp["attn"], hn, lc, **pkw)
        elif cfg.mla:
            a, _ = mla_decode(lp["attn"], hn, lc, **kw)
        else:
            a, _ = attention_decode(lp["attn"], hn, lc,
                                    spec=cfg.decode_spec(kind), **kw)
        h, _ = _block_rest(h, lp, cfg, qcfg, a, SERVE_CAPACITY)
    h = apply_norm(params["final_ln"], h, qcfg, cfg.norm)
    return qdense(params["lm_head"], h[:, 0], qcfg), cache
