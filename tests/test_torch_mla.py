"""The port's MLA, deepseek-v2-236b and the paged engine's whole-prompt
path against the JAX reference, on the CPU at smoke size.

Inputs come from numpy seeds, weights from the port's init (one MLA
layer's as they are, the LM's moved to the reference with
``params_to_jax``; the layouts are held to the reference's inits); every JAX result is computed once per
module fixture or jitted once per shape.  deepseek-v2-236b smoke has a qk
head dim of nope + rope = 24 and a v head dim of 16.  Tolerances, with
their reasons:

  * "attn_qk" / "attn_pv": the casts bitwise the reference's
    ``quantize_mx``; the products within the GEMM rule (ROADMAP, "held
    against the reference"): 1 ulp of the result's dtype at the larger
    magnitude, the fp32 sums running in another order.
  * ``mla_apply`` (``OUT_ULPS``): within bf16 ulps of the output's largest
    magnitude.  The projections and the flash forward could differ by
    bf16 roundings (their fp32 sums run in other orders), and under MX a
    value that crosses a rounding boundary would move its block's cast;
    at this size the outputs are equal (readings in ``OUT_ULPS``'
    comment).  Gradients (``GRAD_REL``): relative Frobenius norm per leaf,
    the backward GEMMs' sums running in other orders.
  * Prefill plus 8 absorbed decode steps (``DEC_ULPS``): the same rule;
    the absorbed products with W_uk and W_uv are bf16 ``einsum``s, fp32
    sums rounded once.  Slab against paged decode is bitwise in the port
    (one ``_absorbed_attend`` over the same logical contents; unmapped
    pages are masked and their p is exactly 0).
  * The deepseek smoke LM (routing pinned, see ``pinned_routing``):
    prefill plus decode logits within ``LOGIT_ATOL`` / ``LOGIT_REL``,
    about 2x the readings, which are moonshot's in
    ``tests/test_torch_moe.py`` (the gated activations' bf16 rounding in
    the experts and the dense MLP, through three layers).
  * Weight round trips, the engines' tokens, the guard's LN-clamp means:
    equal.
  * The CPU paths of the flash forward and dgrad at d 24 / dv 16 and
    d 192 / dv 128 against the reference's jnp flash oracle: within
    ``ATTN_ULPS`` fp32 ulps of each result's largest magnitude (exp and
    the sums differ by fp32 ulps), as ``tests/test_torch_backward.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_config as jget_config
from repro.guard.monitors import _ln_clamp_means
from repro.kernels import ref as jref
from repro.models import lm_decode_step as jdecode
from repro.models import lm_init as jlm_init
from repro.models import lm_prefill as jprefill
from repro.models import mla as jmla
from repro.models.attention import paged_valid_mask as jpaged_valid_mask
from repro.train import checkpoint as jcheckpoint
from repro_torch import core
from repro_torch.configs import get_config
from repro_torch.convert import (lm_checkpoint_layout, param_shapes,
                                 params_from_jax, params_to_jax)
from repro_torch.core.diagnostics import ln_clamp_stats, tree_leaves_with_path
from repro_torch.kernels import ops
from repro_torch.models import (chunk_supported, init_cache,
                                init_cache_paged, lm_decode_step, lm_init,
                                lm_loss, lm_prefill, mla)
from repro_torch.models.attention import paged_valid_mask, paged_write_slots
from repro_torch.serve import PagedServeEngine, SamplingParams, ServeEngine
from repro_torch.train import Trainer, TrainerConfig

ARCH = "deepseek-v2-236b"
PRESETS = ("bf16", "mxfp8_e4m3")
# readings on this suite's CPU: the layer's forward, prefill and decode
# outputs 0 ulps (equal) in both presets; gradients 0.0134 (bf16, the
# input's) and 0.0098 (MX, w_kr's); logits 0.0586 / 0.0134 (bf16) and
# 0.414 / 0.1007 (MX), as moonshot's; the limits leave about 2x (1 ulp
# where the reading is 0)
OUT_ULPS = {"bf16": 1, "mxfp8_e4m3": 1}
DEC_ULPS = {"bf16": 1, "mxfp8_e4m3": 1}
GRAD_REL = {"bf16": 0.03, "mxfp8_e4m3": 0.02}
LOGIT_ATOL = {"bf16": 0.125, "mxfp8_e4m3": 0.875}
LOGIT_REL = {"bf16": 0.03, "mxfp8_e4m3": 0.2}
ATTN_ULPS = 16   # readings up to 7.25


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size ops: one intra-op thread keeps them from spin-waiting on
    cores busy with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _ulps(got, want, bits: int) -> float:
    """max |got - want| in ulps (``bits`` mantissa bits) of want's largest
    magnitude."""
    g, w = _np(got), _np(want)
    scale = np.exp2(np.floor(np.log2(np.max(np.abs(w)))) - bits)
    return float(np.max(np.abs(g - w)) / scale)


def _leaves(tree):
    return dict(tree_leaves_with_path(tree))


@pytest.fixture(scope="module")
def smoke():
    """(reference config, port config, the reference's parameter tree as
    jax arrays, the same as numpy).  The weights are the port's init moved
    with ``params_to_jax`` (the reference's jitted init costs seconds of
    compile); the round-trip test holds the tree's layout to the
    reference's init."""
    jcfg = jget_config(ARCH, "smoke")
    cfg = get_config(ARCH, "smoke")
    tree = jax.tree.map(lambda t: t.numpy(), params_to_jax(
        lm_init(cfg, torch.Generator().manual_seed(0), device="cpu"), cfg))
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), tree


# ---------------------------------------------------------------------------
# "attn_qk" / "attn_pv"
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["attn_qk", "attn_pv"])
@pytest.mark.parametrize("name", ["bf16", "mxfp8_e4m3", "e4m3_bf16act"])
def test_attn_bmm_kinds_match_reference(kind, name):
    """lhs (B, H, S) fp32 @ rhs (B, S, C) fp32, as the absorbed decode's
    context product (e4m3_bf16act has ``attn`` off): the casts bitwise,
    the product within 1 fp32 ulp of its largest magnitude."""
    rng = np.random.default_rng(7)
    a = rng.standard_normal((2, 4, 64)).astype(np.float32)
    b = rng.standard_normal((2, 64, 32)).astype(np.float32)
    jq, tq = jcore.preset(name), core.preset(name)
    want = jcore.mx_contract(jnp.asarray(a), jnp.asarray(b), jq, kind=kind)
    got = core.mx_contract(torch.from_numpy(a), torch.from_numpy(b), tq,
                           kind=kind)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _ulps(got, want, 23) <= 1.0
    if tq.attn and tq.a_fwd is not None:
        for x, axis in ((a, -1), (b, -2)):
            jc = jcore.quantize_mx(jnp.asarray(x), jq.a_fwd, axis=axis)
            tc = ops.mx_quantize(torch.from_numpy(x), tq.a_fwd, axis=axis)
            np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    else:   # attn off: the raw product
        np.testing.assert_allclose(_np(got), a @ b, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the MLA layer
# ---------------------------------------------------------------------------
def _layer(cfg, seed=0):
    """(reference params, port params) of one MLA layer: the port's
    ``mla_init`` (the reference's leaves; its own init runs op by op for
    seconds), the same numbers in both."""
    tp = mla.mla_init(torch.Generator().manual_seed(seed), cfg.d_model,
                      cfg.n_heads, cfg.q_lora, cfg.kv_lora, cfg.nope_dim,
                      cfg.rope_dim, cfg.v_head, cfg.n_layers)
    jp = {k: {kk: jnp.asarray(vv.numpy()) for kk, vv in v.items()}
          for k, v in tp.items()}
    assert jax.tree.structure(jp) == jax.tree.structure(jax.eval_shape(
        lambda key: jmla.mla_init(key, cfg.d_model, cfg.n_heads, cfg.q_lora,
                                  cfg.kv_lora, cfg.nope_dim, cfg.rope_dim,
                                  cfg.v_head, cfg.n_layers),
        jax.random.PRNGKey(0)))
    return jp, tp


def _kw(cfg):
    return dict(n_heads=cfg.n_heads, nope=cfg.nope_dim,
                rope_dim=cfg.rope_dim, v_head=cfg.v_head,
                rope_theta=cfg.rope_theta)


@pytest.mark.parametrize("prec", PRESETS)
def test_mla_apply_and_grads_match_reference(smoke, prec):
    jcfg, cfg, _, _ = smoke
    jp, tp = _layer(cfg)
    B, T = 2, 40
    x = np.random.default_rng(1).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)
    g = np.random.default_rng(2).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)
    jq, tq = jcore.preset(prec), core.preset(prec)
    pos = jnp.broadcast_to(jnp.arange(T), (B, T))
    @jax.jit
    def jfwd_bwd(p, xx, gg):
        out, vjp = jax.vjp(lambda pp, xxx: jmla.mla_apply(
            pp, xxx, qcfg=jq, positions=pos, spec=jcfg.attn_spec("attn"),
            **_kw(cfg)), p, xx)
        return out, vjp(gg)
    jout, (jgp, jgx) = jfwd_bwd(jp, jnp.asarray(x).astype(jnp.bfloat16),
                                jnp.asarray(g).astype(jnp.bfloat16))
    tx = torch.from_numpy(x).bfloat16().requires_grad_(True)
    leaves = list(tree_leaves_with_path(tp))
    for _, t in leaves:
        t.requires_grad_(True)
    out = mla.mla_apply(tp, tx, qcfg=tq, positions=torch.arange(T)[None]
                        .expand(B, T), spec=cfg.attn_spec(), **_kw(cfg))
    assert out.dtype == torch.bfloat16
    assert _ulps(out, jout, 7) <= OUT_ULPS[prec]
    out.backward(torch.from_numpy(g).bfloat16())
    assert _rel(_np(tx.grad), _np(jgx)) <= GRAD_REL[prec]
    want = _leaves({k: {kk: torch.from_numpy(np.array(vv, np.float32))
                        for kk, vv in v.items()}
                    for k, v in jax.tree.map(np.asarray, jgp).items()})
    for path, t in leaves:
        assert _rel(_np(t.grad), _np(want[path])) <= GRAD_REL[prec], path


def _shuffled_table(B, P, n_pages, seed):
    """A (B, P) table of distinct physical pages in shuffled order, page 0
    left unmapped for the dead slots' clamp to land on."""
    ids = np.random.default_rng(seed).permutation(np.arange(1, n_pages))
    return ids[:B * P].reshape(B, P).astype(np.int32)


@pytest.mark.parametrize("prec", PRESETS)
def test_mla_prefill_and_decodes_match_reference(smoke, prec):
    """A 24-token prefill into a 64-slot cache, then 8 absorbed decode
    steps on the slab cache and through a shuffled page table (ps 32),
    teacher-forced on the same inputs; the reference's slab and paged
    decode beside them.  The reference's prefill runs op by op: jitted,
    XLA:CPU keeps some bf16 intermediates in fp32 inside its fusions
    (excess precision), which moves MX block casts (10 bf16 ulps under
    mxfp8_e4m3 at this size)."""
    jcfg, cfg, _, _ = smoke
    jp, tp = _layer(cfg, 3)
    B, T, S, ps, N = 2, 24, 64, 32, 8
    rng = np.random.default_rng(4)
    xs = rng.standard_normal((B, T + 8, cfg.d_model)).astype(np.float32)
    jq, tq = jcore.preset(prec), core.preset(prec)
    jx = jnp.asarray(xs).astype(jnp.bfloat16)
    tx = torch.from_numpy(xs).bfloat16()
    jpos = jnp.broadcast_to(jnp.arange(T), (B, T))
    jo, jc = jmla.mla_prefill(jp, jx[:, :T], qcfg=jq, positions=jpos,
                              spec=jcfg.attn_spec("attn", cache_len=S),
                              **_kw(cfg))
    with torch.no_grad():
        to, tc = mla.mla_prefill(tp, tx[:, :T], qcfg=tq,
                                 positions=torch.arange(T)[None].expand(B, T),
                                 spec=cfg.attn_spec(cache_len=S), **_kw(cfg))
    assert _ulps(to, jo, 7) <= OUT_ULPS[prec]
    table = _shuffled_table(B, S // ps, N, 5)
    pt = torch.from_numpy(table)
    pools = {n: torch.zeros((N, ps) + tuple(tc[n].shape[2:]),
                            dtype=torch.bfloat16) for n in ("ckv", "kr")}
    for n in ("ckv", "kr"):
        pages = tc[n].reshape((B * (S // ps), ps) + tuple(tc[n].shape[2:]))
        pools[n][torch.from_numpy(table.reshape(-1)).long()] = pages
    jdec = jax.jit(lambda p, x, c, pos: jmla.mla_decode(
        p, x, c, qcfg=jq, pos=pos, **_kw(cfg)))
    worst = 0.0
    for i in range(8):
        pos = np.full(B, T + i, np.int64)
        x1 = tx[:, T + i:T + i + 1]
        jo, jc = jdec(jp, jx[:, T + i:T + i + 1], jc, jnp.asarray(pos))
        tpos = torch.from_numpy(pos)
        with torch.no_grad():
            to, tc = mla.mla_decode(tp, x1, tc, qcfg=tq, pos=tpos,
                                    **_kw(cfg))
            top, pools = mla.mla_decode_paged(
                tp, x1, pools, qcfg=tq, pos=tpos, page_table=pt,
                slots=paged_write_slots(pt, tpos, ps),
                valid=paged_valid_mask(pt, tpos, ps), **_kw(cfg))
        assert torch.equal(to, top), i
        worst = max(worst, _ulps(to, jo, 7))
    assert worst <= DEC_ULPS[prec]
    assert torch.equal(paged_valid_mask(pt, torch.from_numpy(pos), ps),
                       torch.from_numpy(np.array(jpaged_valid_mask(
                           jnp.asarray(table), jnp.asarray(pos), ps))))
    # the pools hold the slab cache's rows, page by page
    for n in ("ckv", "kr"):
        view = pools[n][pt.long()].reshape(tc[n].shape)
        assert torch.equal(view, tc[n])


# ---------------------------------------------------------------------------
# deepseek-v2-236b smoke
# ---------------------------------------------------------------------------
def test_config_matches_reference_and_pages_whole():
    for variant in ("full", "smoke"):
        assert (dataclasses.asdict(jget_config(ARCH, variant))
                == dataclasses.asdict(get_config(ARCH, variant)))
    cfg, jcfg = get_config(ARCH, "full"), jget_config(ARCH, "full")
    assert cfg.qk_dim == jcfg.qk_dim == 192
    smoke_cfg = get_config(ARCH, "smoke")
    assert not chunk_supported(smoke_cfg)
    cache = init_cache(smoke_cfg, 2, 64, device="cpu")
    assert {n: tuple(t.shape) for n, t in cache[0].items()} == {
        "ckv": (2, 64, 32), "kr": (2, 64, 8)}
    pools = init_cache_paged(smoke_cfg, 5, 32, device="cpu")
    assert {n: tuple(t.shape) for n, t in pools[2].items()} == {
        "ckv": (5, 32, 32), "kr": (5, 32, 8)}
    assert all(t.dtype == torch.bfloat16 for c in pools for t in c.values())


def test_params_round_trip_through_tree_and_checkpoint(smoke, tmp_path):
    jcfg, cfg, jparams, tree = smoke
    params = params_from_jax(tree, cfg, "cpu")
    assert set(params["layers"][0]["attn"]) == {
        "w_dq", "q_ln", "w_uq", "w_dkv", "kv_ln", "w_uk", "w_uv", "w_kr",
        "wo"}
    assert set(param_shapes(cfg)) == {"embed", "layer", "dense_layer",
                                      "final_ln", "lm_head"}
    back, want = _leaves(params_to_jax(params, cfg)), _leaves(tree)
    assert set(back) == set(want)
    for path in want:
        np.testing.assert_array_equal(back[path].numpy(), want[path])
    np.testing.assert_array_equal(
        params["layers"][2]["attn"]["w_uk"]["w"].numpy(),
        tree["blocks"][1]["b0"]["attn"]["w_uk"]["w"][1])
    bf = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                      if a.ndim >= 2 else a, jparams)
    npz = dict(np.load(jcheckpoint.save(str(tmp_path), 0, bf)))
    from_npz = params_from_jax(npz, cfg, device="cpu")
    np.testing.assert_array_equal(
        _np(from_npz["layers"][0]["attn"]["kv_ln"]["scale"]),
        np.asarray(bf["blocks"][0]["b0"]["attn"]["kv_ln"]["scale"][0]))
    np.testing.assert_array_equal(
        _np(from_npz["layers"][1]["attn"]["w_uq"]["w"]),
        _np(bf["blocks"][1]["b0"]["attn"]["w_uq"]["w"][0]))
    # the tree has the reference's init's layout, shapes and dtypes
    def layout(t):
        return {jax.tree_util.keystr(p): (tuple(a.shape), np.dtype(a.dtype))
                for p, a in jax.tree_util.tree_leaves_with_path(t)}
    assert layout(tree) == layout(jax.eval_shape(
        lambda key: jlm_init(key, jcfg), jax.random.PRNGKey(0)))


def _pinned_scores(T_: int, E_: int) -> np.ndarray:
    return np.random.default_rng(1000 * T_ + E_).random((T_, E_)).astype(
        np.float32)


@pytest.fixture
def pinned_routing(monkeypatch):
    """Both packages route each token to the top-k of a fixed score table,
    as ``tests/test_torch_moe.py``'s fixture of that name (bf16-ulp hidden
    state differences flip near-tie routings)."""
    jtopk, ttopk = jax.lax.top_k, torch.topk

    def jpinned(probs, k):
        _, idx = jtopk(jnp.asarray(_pinned_scores(*probs.shape)), k)
        return jnp.take_along_axis(probs, idx, -1), idx

    def tpinned(probs, k, dim=-1, sorted=True):
        _, idx = ttopk(torch.from_numpy(_pinned_scores(*probs.shape)), k,
                       dim=-1, sorted=True)
        return torch.gather(probs, -1, idx.to(probs.device)), idx.to(
            probs.device)
    monkeypatch.setattr(jax.lax, "top_k", jpinned)
    monkeypatch.setattr(torch, "topk", tpinned)


@pytest.mark.parametrize("prec", PRESETS)
def test_lm_prefill_and_decode_match_reference(smoke, pinned_routing, prec):
    jcfg, cfg, jparams, tree = smoke
    params = params_from_jax(tree, cfg, "cpu")
    jq, tq = jcore.preset(prec), core.preset(prec)
    _jprefill = jax.jit(lambda *a: jprefill(*a), static_argnums=(2, 3, 4))
    _jdecode = jax.jit(lambda *a: jdecode(*a), static_argnums=(4, 5))
    rng = np.random.default_rng(5)
    B, T_, S = 2, 24, 40
    toks = rng.integers(1, cfg.vocab, (B, T_)).astype(np.int32)
    lpos = np.array([T_ - 1, T_ - 6], np.int32)
    jl, jc = _jprefill(jparams, jnp.asarray(toks), jcfg, jq, S,
                       jnp.asarray(lpos))
    with torch.no_grad():
        tl, tc = lm_prefill(params, torch.from_numpy(toks).long(), cfg, tq,
                            S, torch.from_numpy(lpos).long())
    ref_logits, port_logits = [_np(jl)], [_np(tl)]
    pos = lpos + 1
    for _ in range(8):
        tok = np.argmax(ref_logits[-1], -1).astype(np.int32)[:, None]
        jl, jc = _jdecode(jparams, jc, jnp.asarray(tok), jnp.asarray(pos),
                          jcfg, jq)
        with torch.no_grad():
            tl, tc = lm_decode_step(params, tc, torch.from_numpy(tok).long(),
                                    torch.from_numpy(pos).long(), cfg, tq)
        ref_logits.append(_np(jl))
        port_logits.append(_np(tl))
        pos = pos + 1
    a, b = np.concatenate(port_logits), np.concatenate(ref_logits)
    assert np.max(np.abs(a - b)) <= LOGIT_ATOL[prec]
    assert _rel(a, b) <= LOGIT_REL[prec]


# ---------------------------------------------------------------------------
# the paged engine's whole-prompt path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("prec", PRESETS)
@pytest.mark.parametrize("arch", [ARCH, "moonshot-v1-16b-a3b"])
def test_paged_engine_pages_whole_prompts_like_the_slab_engine(arch, prec):
    """The port's form of the reference's "deepseek MLA pagify" check
    (``tests/test_paged.py``): greedy and sampled rows, two prompts
    sharing a full page, a prompt longer than two pages; the paged engine
    prefills each whole and pages its cache, and every request's tokens
    equal the slab engine's (built with ``bucket_prompts=False``, as the
    reference's test builds it); the allocator holds its invariants."""
    cfg = get_config(arch, "smoke")
    params = lm_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    q = core.preset(prec)
    rng = np.random.default_rng(0)
    base = rng.integers(1, cfg.vocab, 40)
    prompts = [base[:37],
               np.concatenate([base[:33], rng.integers(1, cfg.vocab, 5)]),
               rng.integers(1, cfg.vocab, 12),
               rng.integers(1, cfg.vocab, 70)]
    sps = [SamplingParams(max_new_tokens=6),
           SamplingParams(max_new_tokens=6, temperature=0.8, top_k=20,
                          seed=3),
           SamplingParams(max_new_tokens=6),
           SamplingParams(max_new_tokens=6, temperature=1.0, seed=5)]
    out = {}
    for kind in ("slab", "paged"):
        if kind == "slab":
            eng = ServeEngine(params, cfg, q, max_batch=3, max_len=128,
                              bucket_prompts=False, device="cpu")
        else:
            eng = PagedServeEngine(params, cfg, q, max_batch=3, max_len=128,
                                   n_pages=16, page_size=32, device="cpu")
            assert not eng.chunk
            assert set(eng._rules) == ({"raw"} if cfg.mla else {"k", "v"})
        for pr, sp in zip(prompts, sps):
            eng.submit(pr, sp)
        done = eng.drain()
        assert [len(r.tokens) for r in done] == [6] * 4
        out[kind] = [list(map(int, r.tokens)) for r in done]
        if kind == "paged":
            eng.alloc.check()
            assert all(e.get("chunks", 1) == 1 for e in eng.events
                       if e["event"] == "prefill")
    assert out["paged"] == out["slab"]


# ---------------------------------------------------------------------------
# training with the guard
# ---------------------------------------------------------------------------
def test_guarded_trainer_step_covers_the_mla_norms(smoke):
    """A guarded mxfp8_e4m3 Trainer step (probe on step 0) through the
    reference's checkpoint layout: the LN-clamp probe's leaves include
    every layer's q_ln and kv_ln, and its means equal the reference's
    ``_ln_clamp_means`` on the weights the step trained with."""
    jcfg, cfg, _, tree = smoke
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: a * (1 + rng.standard_normal(a.shape)
                             .astype(np.float32))
        if "ln" in jax.tree_util.keystr(path) else a, tree)
    q, jq = core.preset("mxfp8_e4m3"), jcore.preset("mxfp8_e4m3")
    layout = lm_checkpoint_layout(cfg, "cpu")
    params = params_from_jax(tree, cfg, "cpu")
    view = layout[0]({"params": params, "opt": {}})["params"]
    names = list(ln_clamp_stats(view, q))
    for leaf in ("q_ln", "kv_ln"):
        assert sum(leaf in n for n in names) == 2   # two scan groups
    rng_b = np.random.default_rng(1)

    def batch(step):
        toks = rng_b.integers(1, cfg.vocab, (2, 33))
        return {"tokens": torch.from_numpy(toks[:, :-1]).long(),
                "labels": torch.from_numpy(toks[:, 1:]).long()}
    tr = Trainer(lambda p, b, qq: lm_loss(p, b, cfg, qq), params, q, batch,
                 tcfg=TrainerConfig(total_steps=1, peak_lr=1e-3,
                                    log_every=1, guard="autopilot",
                                    guard_probe_every=1),
                 ckpt_layout=layout)
    rec = tr.run(1)[-1]
    assert np.isfinite(rec["loss"]) and rec["guard_zeta"] > 0
    jlt, jlb = _ln_clamp_means(jax.tree.map(jnp.asarray, tree), jq, "ln")
    assert float(jlb) > 0
    assert float(tr._mstate.ln_tight) == float(jlt)
    assert float(tr._mstate.ln_last) == pytest.approx(float(jlb), rel=1e-6)


# ---------------------------------------------------------------------------
# the flash kernels' plain versions at MLA's head dims
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", [None, "e4m3"])
@pytest.mark.parametrize("d,dv", [(24, 16), (192, 128)])
def test_flash_plain_versions_at_mla_head_dims(d, dv, fmt):
    """The CPU paths of ``ops.mx_flash_attention`` and ``_bwd`` (the
    kernels' plain versions) with a qk head dim unlike the v head dim,
    against the reference's jnp flash oracle, causal, two kv tiles."""
    rng = np.random.default_rng(d + dv)
    BH, T = 2, 72
    q = rng.standard_normal((BH, 1, T, d)).astype(np.float32)
    k = rng.standard_normal((BH, T, d)).astype(np.float32)
    v = rng.standard_normal((BH, T, dv)).astype(np.float32)
    do = rng.standard_normal((BH, 1, T, dv)).astype(np.float32)
    kw = dict(kind="causal", q_chunk=32, kv_chunk=48)
    jf = None if fmt is None else jcore.get_format(fmt)
    tf = None if fmt is None else core.get_format(fmt)
    jspec, tspec = jcore.AttnSpec(**kw), core.AttnSpec(**kw)

    @jax.jit
    def oracle(q, k, v, do):
        o, lse = jref.mx_flash_attention_ref(q, k, v, jf, jspec)
        return o, lse, jref.mx_flash_attention_bwd_ref(q, k, v, do, o, lse,
                                                       jf, jspec)
    jo, jl, want = oracle(*map(jnp.asarray, (q, k, v, do)))
    t = lambda a: torch.from_numpy(np.array(a))
    to, tl = ops.mx_flash_attention(t(q), t(k), t(v), tf, tspec)
    assert to.shape == (BH, 1, T, dv)
    assert _ulps(to, jo, 23) <= ATTN_ULPS
    assert _ulps(tl, jl, 23) <= ATTN_ULPS
    got = ops.mx_flash_attention_bwd(t(q), t(k), t(v), t(do), t(jo), t(jl),
                                     tf, tspec)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert _ulps(a, b, 23) <= ATTN_ULPS


class _OnCard:
    """A CPU tensor's shape that tells a wrapper it lies on the card, so
    its CUDA branch's checks run (nothing is launched)."""

    def __init__(self, shape):
        self.shape, self.dtype, self.is_cuda = shape, torch.bfloat16, True
        self.device = torch.device("cpu")


@pytest.mark.parametrize("d,dv", [(288, 256), (192, 288)])
def test_flash_wrappers_raise_beyond_mla_head_dims(d, dv):
    """The flash kernels take qk and v head dims up to 256 (MLA's 192 /
    128 and recurrentgemma's 256 / 256); a wider qk or v head raises on a
    CUDA tensor."""
    BH, T = 2, 64
    q, k, v = (_OnCard((BH, 1, T, d)), _OnCard((BH, T, d)),
               _OnCard((BH, T, dv)))
    with pytest.raises(NotImplementedError, match="Queue A item 4"):
        ops.mx_flash_attention(q, k, v, None, core.AttnSpec())
    o, lse = _OnCard((BH, 1, T, dv)), _OnCard((BH, 1, T))
    lse.dtype = torch.float32
    with pytest.raises(NotImplementedError, match="Queue A item 4"):
        ops.mx_flash_attention_bwd(q, k, v, o, o, lse, None,
                                   core.AttnSpec())
