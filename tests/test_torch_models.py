"""The port's layers and LM against the JAX reference on olmo-paper smoke.

Inputs and weights come from numpy / the reference's own init and are fed
to both packages (weights through ``params_from_jax``).  End-to-end bitwise
parity is out of reach: ``jax.nn.gelu`` (tanh form) rounds its bf16
intermediates on XLA:CPU, so about 40% of GeLU outputs differ from
PyTorch's fp32-then-round by one bf16 ulp, and under MX quantization such
a difference can move a value across a rounding boundary.  So the LM is
held to logit tolerances per preset (``LOGIT_ATOL``, ``LOGIT_REL``), and
greedy tokens must agree wherever the reference's top-1/top-2 margin
exceeds twice the tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_config as jget_config
from repro.models import attention as jattention
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro.models import lm_decode_step as jdecode
from repro.models import lm_init as jlm_init
from repro.models import lm_prefill as jprefill
from repro.train import checkpoint as jcheckpoint
from repro_torch import core
from repro_torch.configs import get_config
from repro_torch.convert import param_shapes, params_from_jax
from repro_torch.models import (LMConfig, attention, layers, lm_apply,
                                lm_decode_step, lm_init, lm_prefill, mlp)
from repro_torch.models.transformer import tree_map

_jprefill = jax.jit(jprefill, static_argnums=(2, 3, 4))
_jdecode = jax.jit(jdecode, static_argnums=(4, 5))

PRESETS = ("bf16", "e4m3_bf16act", "mxfp8_e4m3")
LOGIT_ATOL = {"bf16": 0.0625, "e4m3_bf16act": 0.0625, "mxfp8_e4m3": 0.5}
LOGIT_REL = {"bf16": 0.02, "e4m3_bf16act": 0.02, "mxfp8_e4m3": 0.15}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _t(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.bfloat16):
    return jnp.asarray(np.array(a, np.float32)).astype(dtype)


def _ulp_bf16(x) -> np.ndarray:
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return np.exp2(e - 7)


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-9))


@pytest.fixture(scope="module")
def smoke():
    jcfg = jget_config("olmo-paper", "smoke")
    cfg = get_config("olmo-paper", "smoke")
    jparams = jlm_init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, params_from_jax(tree, cfg, device="cpu"), tree


@pytest.mark.parametrize("ln_fmt", [None, "e4m3", "e2m1"])
@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_apply_norm_matches_reference(kind, ln_fmt):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 128)) * 3 + 0.5
    scale = np.exp(rng.standard_normal(128) * 0.3)
    bias = rng.standard_normal(128) * 0.1
    jp = {"scale": jnp.asarray(scale, jnp.float32)}
    tp = {"scale": torch.tensor(scale, dtype=torch.float32)}
    if kind == "layernorm":
        jp["bias"] = jnp.asarray(bias, jnp.float32)
        tp["bias"] = torch.tensor(bias, dtype=torch.float32)
    fmt = None if ln_fmt is None else core.get_format(ln_fmt)
    jfmt = None if ln_fmt is None else jcore.get_format(ln_fmt)
    jcfg = jcore.QuantConfig(ln_fmt=jfmt)
    tcfg = core.QuantConfig(ln_fmt=fmt)
    want = _np(jlayers.apply_norm(jp, _j(x), jcfg, kind))
    got = _np(layers.apply_norm(tp, _t(x), tcfg, kind))
    assert np.all(np.abs(got - want) <= _ulp_bf16(np.abs(want)))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_rope_matches_reference(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 11, 3, 2, 64))
    pos = rng.integers(0, 500, (2, 11))
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    want = _np(jlayers.rope(_j(x, jdt), jnp.asarray(pos)))
    got = _np(layers.rope(_t(x, tdt), torch.from_numpy(pos)))
    if dtype == "bf16":
        assert np.all(np.abs(got - want) <= _ulp_bf16(np.abs(want)))
    else:   # cos/sin of angles up to ~500 rad: a few fp32 ulps of the angle
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_embed_lookup_matches_reference(smoke):
    jcfg, cfg, jparams, params, _ = smoke
    ids = np.array([[0, 5, 511], [7, 7, 1]])
    want = _np(jlayers.embed_lookup(jparams["embed"], jnp.asarray(ids)))
    got = layers.embed_lookup(params["embed"], torch.from_numpy(ids))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("prec", PRESETS)
def test_mlp_apply_matches_reference(smoke, prec):
    jcfg, cfg, jparams, params, _ = smoke
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["b0"]["mlp"])
    x = np.random.default_rng(3).standard_normal((2, 7, 128))
    want = _np(jmlp.mlp_apply(jp, _j(x), jcore.preset(prec)))
    got = _np(mlp.mlp_apply(params["layers"][0]["mlp"], _t(x),
                            core.preset(prec)))
    assert _rel(got, want) < 0.02


@pytest.mark.parametrize("prec", PRESETS)
def test_attention_prefill_and_decode_match_reference(smoke, prec):
    jcfg, cfg, jparams, params, _ = smoke
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["b0"]["attn"])
    tp = params["layers"][0]["attn"]
    rng = np.random.default_rng(4)
    B, T, S = 2, 20, 32
    x = rng.standard_normal((B, T, 128))
    kw = dict(n_heads=2, n_kv=2, d_head=64)
    jspec = jcfg.attn_spec("attn", cache_len=S)
    pos = np.repeat(np.arange(T)[None], B, axis=0)
    jo, jc = jattention.attention_prefill(
        jp, _j(x), qcfg=jcore.preset(prec), positions=jnp.asarray(pos),
        spec=jspec, **kw)
    to, tc = attention.attention_prefill(
        tp, _t(x), qcfg=core.preset(prec), positions=torch.from_numpy(pos),
        spec=cfg.attn_spec(cache_len=S), **kw)
    assert _rel(to, jo) < 0.02
    for key in ("k", "v"):
        assert _rel(tc[key], jc[key]) < 0.01
    # One decode step at per-row positions on the reference's own cache.
    xd = rng.standard_normal((B, 1, 128))
    p = np.array([T, T - 3])
    jod, _ = jattention.attention_decode(
        jp, _j(xd), jc, qcfg=jcore.preset(prec), pos=jnp.asarray(p),
        spec=jcfg.decode_spec("attn"), **kw)
    cache = {k: torch.from_numpy(np.asarray(v).view(np.int16).copy()).view(
        torch.bfloat16) for k, v in jc.items()}
    tod, cache = attention.attention_decode(
        tp, _t(xd), cache, qcfg=core.preset(prec), pos=torch.from_numpy(p),
        **kw)
    assert _rel(tod, jod) < 0.02
    assert torch.equal(cache["k"][0, :T], _t(np.asarray(jc["k"])[0, :T]))


def test_params_from_jax_uses_every_leaf_from_tree_and_npz(smoke, tmp_path):
    jcfg, cfg, jparams, params, tree = smoke
    n_leaves = len(jax.tree.leaves(jparams))
    got = jax.tree.leaves(tree_map(lambda t: t, params))
    # 2 layers per stacked leaf, minus the unstacked ones, equals the count.
    n_stacked = len(jax.tree.leaves(jparams["blocks"]))
    assert len(got) == n_leaves - n_stacked + n_stacked * cfg.n_layers
    # Layer r of group 0 is the reference's stacked entry r.
    np.testing.assert_array_equal(
        _np(params["layers"][1]["attn"]["wq"]["w"]),
        np.asarray(jparams["blocks"][0]["b0"]["attn"]["wq"]["w"][1]))
    # The checkpoint form: keystr keys, bf16 stored as BF16:: uint16.
    bf = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                      if a.ndim == 2 else a, jparams)
    path = jcheckpoint.save(str(tmp_path), 0, bf)
    npz = dict(np.load(path))
    assert any(k.startswith("BF16::") for k in npz)
    from_npz = params_from_jax(npz, cfg, device="cpu")
    assert from_npz["lm_head"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _np(from_npz["layers"][1]["mlp"]["w_up"]["w"]),
        np.asarray(bf["blocks"][0]["b0"]["mlp"]["w_up"]["w"][1]
                   ).astype(np.float32))
    extra = dict(tree)
    extra["stray"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="not used"):
        params_from_jax(extra, cfg, device="cpu")
    missing = dict(tree)
    del missing["final_ln"]
    with pytest.raises(KeyError):
        params_from_jax(missing, cfg, device="cpu")


def test_lm_init_shapes_and_distributions_match_reference(smoke):
    jcfg, cfg, jparams, params, _ = smoke
    fresh = lm_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    for ref_leaf, leaf in zip(jax.tree.leaves(tree_map(lambda t: t, params)),
                              jax.tree.leaves(fresh)):
        assert tuple(ref_leaf.shape) == tuple(leaf.shape)
        assert leaf.dtype == torch.float32
        if leaf.ndim == 2:   # same truncated normal: std within 5%
            want = float(np.std(_np(ref_leaf)))
            assert abs(float(leaf.std()) - want) < 0.05 * want
    assert set(param_shapes(cfg)) == {"embed", "layer", "final_ln", "lm_head"}


@pytest.mark.parametrize("prec", PRESETS)
def test_lm_prefill_and_decode_match_reference(smoke, prec):
    jcfg, cfg, jparams, params, _ = smoke
    jq, tq = jcore.preset(prec), core.preset(prec)
    rng = np.random.default_rng(5)
    B, T, S = 2, 24, 40
    toks = rng.integers(1, cfg.vocab, (B, T)).astype(np.int32)
    lpos = np.array([T - 1, T - 6], np.int32)
    jl, jc = _jprefill(jparams, jnp.asarray(toks), jcfg, jq, S,
                       jnp.asarray(lpos))
    tl, tc = lm_prefill(params, torch.from_numpy(toks).long(), cfg, tq, S,
                        torch.from_numpy(lpos).long())
    for layer, tcl in enumerate(tc):
        for key in ("k", "v"):
            assert _rel(tcl[key], np.asarray(jc[0]["b0"][key][layer])) \
                < LOGIT_REL[prec]
    ref_logits, port_logits = [_np(jl)], [_np(tl)]
    pos = lpos + 1
    for step in range(8):
        # Teacher-forced on the reference's greedy tokens.
        tok = np.argmax(ref_logits[-1], -1).astype(np.int32)[:, None]
        jl, jc = _jdecode(jparams, jc, jnp.asarray(tok), jnp.asarray(pos),
                          jcfg, jq)
        tl, tc = lm_decode_step(params, tc, torch.from_numpy(tok).long(),
                                torch.from_numpy(pos).long(), cfg, tq)
        ref_logits.append(_np(jl))
        port_logits.append(_np(tl))
        pos = pos + 1
    a, b = np.concatenate(port_logits), np.concatenate(ref_logits)
    assert np.max(np.abs(a - b)) <= LOGIT_ATOL[prec]
    assert _rel(a, b) <= LOGIT_REL[prec]
    top2 = np.sort(b, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * LOGIT_ATOL[prec]
    np.testing.assert_array_equal(a.argmax(-1)[clear], b.argmax(-1)[clear])


@pytest.mark.parametrize("overrides", [
    dict(tie_embeddings=True), dict(frontend="patch", n_frontend_tokens=4),
    dict(block_pattern=("rec", "attn"), d_rnn=64), dict(window=16),
    dict(enc_layers=2), dict(block_pattern=("mlstm",))])
def test_other_architectures_raise_not_implemented(overrides):
    """Tied embeddings, frontends, encoder-decoder and xLSTM raise; Griffin's
    "rec" blocks and windowed attention are ported (recurrentgemma-9b,
    tests/test_torch_rglru.py) and give finite logits of the right
    shape."""
    cfg = LMConfig(**overrides)
    if "d_rnn" in overrides or "window" in overrides:
        params = lm_init(cfg, torch.Generator().manual_seed(0), device="cpu")
        tok = torch.randint(0, cfg.vocab, (2, 24),
                            generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            h, _ = lm_apply(params, {"tokens": tok}, cfg, core.preset("bf16"))
            logits = layers.qdense(params["lm_head"], h, core.preset("bf16"))
        assert logits.shape == (2, 24, cfg.vocab)
        assert bool(torch.isfinite(logits.float()).all())
        return
    with pytest.raises(NotImplementedError, match="later slice"):
        lm_init(cfg, torch.Generator().manual_seed(0), device="cpu")


def test_lm_config_fields_match_reference():
    import dataclasses
    from repro.models import LMConfig as JLMConfig
    assert ([f.name for f in dataclasses.fields(JLMConfig)]
            == [f.name for f in dataclasses.fields(LMConfig)])
    assert (dataclasses.asdict(jget_config("olmo-paper", "full"))
            == dataclasses.asdict(get_config("olmo-paper", "full")))
