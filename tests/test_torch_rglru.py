"""recurrentgemma-9b on the port against the JAX reference, on the CPU at
smoke size: Griffin's RG-LRU blocks, the windowed MQA layer's ring cache,
the engines and the weights.

The smoke config has 5 layers (one (rec, rec, attn) group and a (rec, rec)
tail), d_model 64, d_rnn 96, 4 query heads on one kv head of 16, and a
window of 32; T 48 lies past the window, so the window masks and the ring
wraps.  Weights are the port's init moved with ``params_to_jax`` (the
round-trip test holds the tree's layout to the reference's init); inputs
come from numpy seeds; every reference run happens once, in a module
fixture.  Tolerances, each beside the reading it rests on (this suite's
CPU; the limits leave about 2x, 1 ulp where the reading is 0):

  * One rec block, same inputs (``REC_ULPS``): the scan is bitwise the
    reference's combine tree, but the gates' sigmoid, exp and softplus
    come from other libraries (fp32 ulps apart) and the projections' GEMMs
    sum in other orders.  Readings: ``rglru_scan``'s h 0.004 bf16 ulps of
    its largest magnitude (bf16; MX 0.0002), h_last 3.75 fp32 ulps (MX
    4.0); ``rec_block_prefill``'s output 1.0 bf16 ulp (MX 2.75), its conv
    carry 0, its state 3.0 fp32 ulps (MX 2.0); 8 ``rec_block_decode``
    steps 1.0 (MX 1.5) and 5.0 (MX 2.75).  Its gradients
    (``BLOCK_GRAD_REL``, relative Frobenius per leaf, ``lam`` included):
    worst 0.0096 (bf16, conv_w), 0.022 (MX, w_gate).
  * The windowed attention layer, same inputs (``RING_ULPS``): the ring
    prefill cache slot for slot, the outputs and 28 ring decodes across
    the wrap read 0 ulps (equal).
  * The LM (``LOGIT_*``, ``CACHE_REL``, ``LOSS_REL``, ``GRAD_REL``): the
    GeGLU's tanh GeLU rounds its bf16 intermediates on XLA:CPU (about 40%
    of outputs one bf16 ulp off PyTorch's), and under MX such an ulp can
    move a value across a cast boundary; the differences grow through the
    five layers.  Readings: logits of the whole prefill 0.064 / rel 0.020
    (bf16) and 0.43 / 0.15 (MX), of 28 decode steps across the wrap 0.082
    / 0.018 and 0.82 / 0.13; each layer's cache after both, relative
    Frobenius, worst 0.0165 (bf16) and 0.121 (MX; layer 0 within 2e-7);
    the loss (bf16) 3.4e-5 relative (the reference jitted; 1.6e-6 op by
    op); its gradients per leaf worst 0.042 (a lam; MX: 0.25, the attn
    layer's ln2, as moonshot's in ``tests/test_torch_moe.py``, so MX
    gradients are held at the block).
  * Decode against prefill and the engines: the reference's own bounds
    (``tests/test_serve.py``, ``tests/test_paged.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_config as jget_config
from repro.models import lm_decode_step as jdecode
from repro.models import lm_init as jlm_init
from repro.models import lm_loss as jlm_loss
from repro.models import lm_prefill as jprefill
from repro.models import rglru as jrglru
from repro.train import checkpoint as jcheckpoint
from repro_torch import core
from repro_torch.configs import get_config
from repro_torch.convert import (lm_checkpoint_layout, param_shapes,
                                 params_from_jax, params_to_jax)
from repro_torch.core.diagnostics import tree_leaves_with_path
from repro_torch.models import (LMConfig, chunk_supported, init_cache,
                                init_cache_paged, kind_paged, lm_decode_step,
                                lm_init, lm_loss, lm_prefill,
                                paged_leaf_mask, rglru, tree_map)
from repro_torch.models.attention import decode_valid_mask
from repro_torch.serve import PagedServeEngine, SamplingParams, ServeEngine

ARCH = "recurrentgemma-9b"
PRESETS = ("bf16", "mxfp8_e4m3")
T, WINDOW, S = 48, 32, 64
# readings in the module docstring
REC_ULPS = {"h": 1, "h_last": 8, "out": 6, "state": 10}
BLOCK_GRAD_REL = {"bf16": 0.02, "mxfp8_e4m3": 0.045}
RING_ULPS = 1
LOGIT_ATOL = {"bf16": 0.16, "mxfp8_e4m3": 1.75}
LOGIT_REL = {"bf16": 0.04, "mxfp8_e4m3": 0.3}
CACHE_REL = {"bf16": 0.035, "mxfp8_e4m3": 0.25}
LOSS_REL = {"bf16": 1e-4}
GRAD_REL = {"bf16": 0.08}
# the reference's bounds for one decode step against a whole prefill
# (tests/test_serve.py: bf16 within 1e-1; MX rel_fro < 0.2, cosine > 0.98)
DEC_TOL, DEC_REL, DEC_COS = 1e-1, 0.2, 0.98


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


def _t(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.bfloat16):
    return jnp.asarray(np.array(a, np.float32)).astype(dtype)


@pytest.fixture(scope="module")
def smoke():
    """(reference config, port config, the reference's tree as jax arrays,
    the same as numpy, the port's parameters, tokens (2, T))."""
    jcfg, cfg = jget_config(ARCH, "smoke"), get_config(ARCH, "smoke")
    tree = jax.tree.map(lambda t: t.numpy(), params_to_jax(
        lm_init(cfg, torch.Generator().manual_seed(0), device="cpu"), cfg))
    toks = np.random.default_rng(3).integers(1, cfg.vocab, (2, T)).astype(
        np.int32)
    return (jcfg, cfg, jax.tree.map(jnp.asarray, tree), tree,
            params_from_jax(tree, cfg, "cpu"), toks)


# ---------------------------------------------------------------------------
# config and weights
# ---------------------------------------------------------------------------
def test_config_matches_reference_and_keeps_slab_state():
    for variant in ("full", "smoke"):
        assert (dataclasses.asdict(jget_config(ARCH, variant))
                == dataclasses.asdict(get_config(ARCH, variant)))
    cfg = get_config(ARCH, "smoke")
    assert not chunk_supported(cfg)
    assert [kind_paged(k, cfg) for k in ("attn", "rec")] == [False, False]
    jcfg = jget_config(ARCH, "smoke")
    for kind in ("attn", "rec"):
        assert (dataclasses.asdict(cfg.attn_spec(kind, cache_len=S))
                == dataclasses.asdict(jcfg.attn_spec(kind, cache_len=S)))
        assert (dataclasses.asdict(cfg.decode_spec(kind, S))
                == dataclasses.asdict(jcfg.decode_spec(kind, S, 32)))
    assert cfg.attn_spec("attn").window == WINDOW
    assert cfg.decode_spec("attn").kind == "ring"
    cache = init_cache(cfg, 2, S, device="cpu")
    assert [{n: (tuple(t.shape), t.dtype) for n, t in c.items()}
            for c in cache[1:3]] == [
        {"conv": ((2, 3, 96), torch.bfloat16),
         "h": ((2, 96), torch.float32)},
        {"k": ((2, WINDOW, 1, 16), torch.bfloat16),
         "v": ((2, WINDOW, 1, 16), torch.bfloat16)}]
    paged = init_cache_paged(cfg, 8, 32, device="cpu", B=2, S=S)
    assert all(not any(m.values()) for m in paged_leaf_mask(cfg))
    assert [t.shape for t in paged[2].values()] == [t.shape for t in
                                                    cache[2].values()]
    with pytest.raises(ValueError, match="slab leaves"):
        init_cache_paged(cfg, 8, 32, device="cpu")


def test_params_round_trip_through_tree_and_checkpoint(smoke, tmp_path):
    jcfg, cfg, jparams, tree, params, _ = smoke
    assert set(params["layers"][0]) == {"ln1", "rec", "ln2", "mlp"}
    assert set(params["layers"][0]["rec"]) == {
        "w_main", "w_gate", "conv_w", "conv_b", "lam", "w_i", "w_r", "w_out"}
    assert set(param_shapes(cfg)) == {"embed", "layer", "rec_layer",
                                      "final_ln", "lm_head"}
    back = dict(tree_leaves_with_path(params_to_jax(params, cfg)))
    want = dict(tree_leaves_with_path(tree))
    assert set(back) == set(want)
    for path in want:
        np.testing.assert_array_equal(back[path].numpy(), want[path])
    # layer i is entry r of group g, block j, in plan order: the tail
    # group (rec, rec) holds layers 3 and 4
    np.testing.assert_array_equal(params["layers"][4]["rec"]["lam"].numpy(),
                                  tree["blocks"][1]["b1"]["rec"]["lam"][0])
    np.testing.assert_array_equal(
        params["layers"][2]["attn"]["wk"]["w"].numpy(),
        tree["blocks"][0]["b2"]["attn"]["wk"]["w"][0])
    bf = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                      if a.ndim >= 3 else a, jparams)
    npz = dict(np.load(jcheckpoint.save(str(tmp_path), 0, bf)))
    from_npz = params_from_jax(npz, cfg, device="cpu")
    np.testing.assert_array_equal(
        _np(from_npz["layers"][3]["rec"]["conv_w"]),
        _np(bf["blocks"][1]["b0"]["rec"]["conv_w"][0]))
    np.testing.assert_array_equal(
        _np(from_npz["layers"][1]["rec"]["w_i"]["w"]),
        _np(bf["blocks"][0]["b1"]["rec"]["w_i"]["w"][0]))
    # a Trainer's {"params", "opt"} tree through the reference's layout
    to_ref, from_ref = lm_checkpoint_layout(cfg, "cpu")
    opt = {"m": params, "v": params, "count": torch.zeros(())}
    again = from_ref(to_ref({"params": params, "opt": opt}))
    assert torch.equal(again["opt"]["m"]["layers"][4]["rec"]["w_r"]["w"],
                       params["layers"][4]["rec"]["w_r"]["w"])

    def layout(t):
        return {jax.tree_util.keystr(p): (tuple(a.shape), np.dtype(a.dtype))
                for p, a in jax.tree_util.tree_leaves_with_path(t)}
    assert layout(tree) == layout(jax.eval_shape(
        lambda key: jlm_init(key, jcfg), jax.random.PRNGKey(0)))


# ---------------------------------------------------------------------------
# the RG-LRU block
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def block_runs(smoke):
    """Layer 0's rec block in both packages, per preset: the scan over a
    (2, T, d_rnn) input, the block's prefill over (2, T, D), and a prefill
    of the first 40 positions plus 8 decode steps."""
    jcfg, cfg, _, tree, params, _ = smoke
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    xs = rng.standard_normal((2, T, cfg.d_rnn)).astype(np.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      tree["blocks"][0]["b0"]["rec"])
    tp = params["layers"][0]["rec"]
    out = {}
    ct = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    for prec in PRESETS:
        jq, tq = jcore.preset(prec), core.preset(prec)

        prefill = jax.jit(lambda pp, x_: jrglru.rec_block_prefill(pp, x_,
                                                                  jq))
        step = jax.jit(lambda pp, x_, c: jrglru.rec_block_decode(pp, x_, c,
                                                                 jq))

        @jax.jit
        def scan_and_grads(pp, xs_, x_, ct_):
            _, vjp = jax.vjp(lambda a, b: jrglru.rec_block_apply(a, b, jq),
                             pp, x_)
            return jrglru.rglru_scan(pp, xs_, jq), vjp(ct_)
        ref = dict(zip(("scan", "grads"),
                       scan_and_grads(jp, _j(xs), _j(x), _j(ct))))
        ref["prefill"] = prefill(jp, _j(x))
        o, c = prefill(jp, _j(x[:, :40]))
        steps = []
        for i in range(40, T):
            o, c = step(jp, _j(x[:, i:i + 1]), c)
            steps.append(o)
        ref["decode"] = (jnp.concatenate(steps, 1), c)
        with torch.no_grad():
            port = {"scan": rglru.rglru_scan(tp, _t(xs), tq),
                    "prefill": rglru.rec_block_prefill(tp, _t(x), tq)}
            o, c = rglru.rec_block_prefill(tp, _t(x[:, :40]), tq)
            steps = []
            for i in range(40, T):
                o, c = rglru.rec_block_decode(tp, _t(x[:, i:i + 1]), c, tq)
                steps.append(o)
            port["decode"] = (torch.cat(steps, 1), c)
        tpg = tree_map(lambda t: t.clone().requires_grad_(True), tp)
        tx = _t(x).requires_grad_(True)
        leaves = list(tree_leaves_with_path(tpg))
        grads = torch.autograd.grad(rglru.rec_block_apply(tpg, tx, tq),
                                    [t for _, t in leaves] + [tx], _t(ct))
        port["grads"] = (dict(zip([q for q, _ in leaves], grads[:-1])),
                         grads[-1])
        out[prec] = (ref, port)
    return out


@pytest.mark.parametrize("prec", PRESETS)
def test_rglru_scan_matches_reference(block_runs, prec):
    ref, port = block_runs[prec]
    (jh, jl), (th, tl) = ref["scan"], port["scan"]
    assert th.dtype == torch.bfloat16 and tl.dtype == torch.float32
    assert _ulps(th, jh, 7) <= REC_ULPS["h"]
    assert _ulps(tl, jl, 23) <= REC_ULPS["h_last"]


def test_associative_scan_is_the_reference_combine_tree():
    """Bitwise jax.lax.associative_scan's odd/even recursion at lengths
    odd, even and one, op by op (under jit XLA:CPU may contract a2 b1 + b2
    into one fma, an fp32 ulp away)."""
    rng = np.random.default_rng(9)
    for n in (1, 2, 7, 48):
        a = rng.uniform(0.5, 1.0, (2, n, 4)).astype(np.float32)
        b = rng.standard_normal((2, n, 4)).astype(np.float32)
        want = jax.lax.associative_scan(
            lambda u, v: (v[0] * u[0], v[0] * u[1] + v[1]),
            (jnp.asarray(a), jnp.asarray(b)), axis=1)
        got = rglru._associative_scan([torch.from_numpy(a),
                                       torch.from_numpy(b)])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("prec", PRESETS)
def test_rec_block_prefill_and_decode_match_reference(block_runs, prec):
    ref, port = block_runs[prec]
    (jo, jc), (to, tc) = ref["prefill"], port["prefill"]
    assert _ulps(to, jo, 7) <= REC_ULPS["out"]
    assert tc["conv"].dtype == torch.bfloat16 and tc["h"].dtype == \
        torch.float32
    # the conv carry is the last three inputs of the conv: w_main's output
    assert _ulps(tc["conv"], jc["conv"], 7) <= REC_ULPS["out"]
    assert _ulps(tc["h"], jc["h"], 23) <= REC_ULPS["state"]
    (jo, jc), (to, tc) = ref["decode"], port["decode"]
    assert _ulps(to, jo, 7) <= REC_ULPS["out"]
    assert _ulps(tc["conv"], jc["conv"], 7) <= REC_ULPS["out"]
    assert _ulps(tc["h"], jc["h"], 23) <= REC_ULPS["state"]


@pytest.mark.parametrize("prec", PRESETS)
def test_rec_block_grads_match_reference(block_runs, prec):
    """jax.vjp of rec_block_apply against autograd: every leaf, lam
    included, and the input's gradient."""
    ref, port = block_runs[prec]
    (jgp, jgx), (tgp, tgx) = ref["grads"], port["grads"]
    want = {tuple(k.key for k in path): g
            for path, g in jax.tree_util.tree_leaves_with_path(jgp)}
    assert set(want) == set(tgp) and ("lam",) in want
    for path, g in want.items():
        assert np.any(_np(tgp[path]) != 0), path
        assert _rel(_np(tgp[path]), np.asarray(g, np.float32)) <= \
            BLOCK_GRAD_REL[prec], path
    assert _rel(_np(tgx), _np(jgx)) <= BLOCK_GRAD_REL[prec]


def test_softplus_is_the_reference_formula():
    """log1p(exp(-|x|)) + max(x, 0) also above 20, where PyTorch's softplus
    returns x itself; its derivative exp(x - softplus(x))."""
    x = np.array([-30.0, -3.0, 0.0, 0.5, 19.0, 20.5, 40.0], np.float32)
    got = rglru._Softplus.apply(torch.from_numpy(x).requires_grad_())
    want = jax.nn.softplus(jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2 ** -22, atol=0)
    t = torch.from_numpy(x).requires_grad_()
    rglru._Softplus.apply(t).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jax.grad(
        lambda z: jnp.sum(jax.nn.softplus(z)))(jnp.asarray(x))),
        rtol=2 ** -20, atol=0)


# ---------------------------------------------------------------------------
# the windowed attention layer's ring
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def attn_runs(smoke):
    """Layer 2's attention in both packages, per preset, on one (2, T, D)
    input: attention_prefill of all T positions (window spec, cache_len
    S: the ring of 32), and attention_prefill of the first 20 plus 28
    ring decodes (positions 20-47, across the wrap at 32)."""
    from repro.models import attention as jattention
    from repro_torch.models import attention
    jcfg, cfg, _, tree, params, _ = smoke
    x = np.random.default_rng(8).standard_normal(
        (2, T, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      tree["blocks"][0]["b2"]["attn"])
    tp = params["layers"][2]["attn"]
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.d_head,
              rope_theta=cfg.rope_theta)
    pos = np.array(np.broadcast_to(np.arange(T), (2, T)))
    out = {}
    for prec in PRESETS:
        jq, tq = jcore.preset(prec), core.preset(prec)

        prefill = jax.jit(lambda pp, x_, p_: jattention.attention_prefill(
            pp, x_, qcfg=jq, positions=p_,
            spec=jcfg.attn_spec("attn", cache_len=S), **kw))
        step = jax.jit(lambda pp, x_, c, i: jattention.attention_decode(
            pp, x_, c, qcfg=jq, pos=i, spec=jcfg.decode_spec("attn"), **kw))
        whole = prefill(jp, _j(x), jnp.asarray(pos))
        o, c = prefill(jp, _j(x[:, :20]), jnp.asarray(pos[:, :20]))
        steps = []
        for i in range(20, T):
            o, c = step(jp, _j(x[:, i:i + 1]), c, jnp.int32(i))
            steps.append(o)
        ref = (whole, jnp.concatenate(steps, 1), c)
        with torch.no_grad():
            whole = attention.attention_prefill(
                tp, _t(x), qcfg=tq, positions=torch.from_numpy(pos),
                spec=cfg.attn_spec("attn", cache_len=S), **kw)
            o, c = attention.attention_prefill(
                tp, _t(x[:, :20]), qcfg=tq,
                positions=torch.from_numpy(pos[:, :20]),
                spec=cfg.attn_spec("attn", cache_len=S), **kw)
            steps = []
            for i in range(20, T):
                o, c = attention.attention_decode(
                    tp, _t(x[:, i:i + 1]), c, qcfg=tq,
                    pos=torch.full((2,), i), spec=cfg.decode_spec("attn"),
                    **kw)
                steps.append(o)
        out[prec] = (ref, (whole, torch.cat(steps, 1), c))
    return out


@pytest.mark.parametrize("prec", PRESETS)
def test_prefill_ring_cache_matches_reference_slot_for_slot(attn_runs,
                                                            prec):
    ((jo, jc), _, _), ((to, tc), _, _) = attn_runs[prec]
    assert _ulps(to, jo, 7) <= RING_ULPS
    assert tc["k"].shape == (2, WINDOW, 1, 16) == jc["k"].shape
    # slot s holds the last position t < T with t % 32 == s: positions
    # 16..47, so every slot is written (16..31 by 16..31, 0..15 by 32..47)
    for s in range(WINDOW):
        for name in ("k", "v"):
            assert _ulps(tc[name][:, s], jc[name][:, s], 7) <= RING_ULPS, (
                name, s)
            assert bool(tc[name][:, s].abs().amax() > 0)


@pytest.mark.parametrize("prec", PRESETS)
def test_ring_decode_across_the_wrap_matches_reference(attn_runs, prec):
    (_, jo, jc), (_, to, tc) = attn_runs[prec]
    assert _ulps(to, jo, 7) <= RING_ULPS
    for name in ("k", "v"):
        assert _ulps(tc[name], jc[name], 7) <= RING_ULPS


# ---------------------------------------------------------------------------
# the LM: prefill and decode across the wrap, loss and gradients
# ---------------------------------------------------------------------------
_jprefill = jax.jit(jprefill, static_argnums=(2, 3, 4))
_jdecode = jax.jit(jdecode, static_argnums=(4, 5))


@pytest.fixture(scope="module")
def lm_runs(smoke):
    """Per preset, both packages: lm_prefill of the first 20 tokens
    (cache_len S) plus 28 teacher-forced decode steps (positions 20-47,
    across the ring's wrap at 32)."""
    jcfg, cfg, jparams, _, params, toks = smoke
    out = {}
    for prec in PRESETS:
        jq, tq = jcore.preset(prec), core.preset(prec)
        res = {}
        for side in ("ref", "port"):
            logits = []
            if side == "ref":
                lg, cache = _jprefill(jparams, jnp.asarray(toks[:, :20]),
                                      jcfg, jq, S)
            else:
                with torch.no_grad():
                    lg, cache = lm_prefill(
                        params, torch.from_numpy(toks[:, :20]).long(), cfg,
                        tq, S)
            # the port's decode writes its cache in place: keep a copy
            pre = (_np(lg), cache if side == "ref"
                   else tree_map(torch.clone, cache))
            logits.append(_np(lg))
            for i in range(20, T):
                pos = np.full(2, i, np.int32)
                if side == "ref":
                    lg, cache = _jdecode(jparams, cache,
                                         jnp.asarray(toks[:, i:i + 1]),
                                         jnp.asarray(pos), jcfg, jq)
                else:
                    with torch.no_grad():
                        lg, cache = lm_decode_step(
                            params, cache,
                            torch.from_numpy(toks[:, i:i + 1]).long(),
                            torch.from_numpy(pos).long(), cfg, tq)
                logits.append(_np(lg))
            res[side] = (pre, np.stack(logits), cache)
        out[prec] = res
    return out


def _ref_layer_cache(cache, layer):
    """The reference's cache entry of port layer ``layer`` (plan order:
    group 0 holds layers 0-2, the tail group 3-4)."""
    g, j = (0, layer) if layer < 3 else (1, layer - 3)
    return jax.tree.map(lambda a: a[0], cache[g][f"b{j}"])


@pytest.mark.parametrize("prec", PRESETS)
def test_lm_prefill_and_decode_across_the_wrap_match_reference(lm_runs,
                                                              prec):
    """Logits of the prefill and of the 28 decode steps, and every layer's
    cache after each (ring K/V, conv window, fp32 state)."""
    (_, jc), jlog, jc2 = lm_runs[prec]["ref"]
    (_, tc), tlog, tc2 = lm_runs[prec]["port"]
    assert np.max(np.abs(tlog - jlog)) <= LOGIT_ATOL[prec]
    assert _rel(tlog, jlog) <= LOGIT_REL[prec]
    for port, ref in ((tc, jc), (tc2, jc2)):
        for layer, names in ((0, ("conv", "h")), (1, ("conv", "h")),
                             (2, ("k", "v")), (3, ("conv", "h")),
                             (4, ("conv", "h"))):
            want = _ref_layer_cache(ref, layer)
            for name in names:
                assert port[layer][name].shape == want[name].shape
                assert _rel(_np(port[layer][name]), _np(want[name])) <= \
                    CACHE_REL[prec], (layer, name)
    # after position 47 the ring's age rule admits every slot
    assert bool(decode_valid_mask(torch.tensor([47, 47]), WINDOW,
                                  WINDOW).all())
    assert decode_valid_mask(torch.tensor([20]), WINDOW, WINDOW).sum() == 21


def test_ring_age_rule_matches_reference():
    from repro.models.attention import decode_valid_mask as jmask
    for Sr, window in ((32, 32), (24, 32), (64, 0)):
        pos = np.array([0, 5, 23, 31, 32, 33, 63, 100, 1000], np.int32)
        want = np.asarray(jmask(jnp.asarray(pos), Sr, window))
        got = decode_valid_mask(torch.from_numpy(pos).long(), Sr, window)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def loss_grads(smoke):
    """lm_loss and its gradients in both packages on (2, T) tokens, under
    bf16 (MX gradients are held at the block, where the inputs are the
    same: through five layers MX noise sets the reading, and the
    reference's compile of the LM's gradients takes 20 s a preset)."""
    jcfg, cfg, jparams, _, params, toks = smoke
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -1
    out = {}
    for prec in ("bf16",):
        jq, tq = jcore.preset(prec), core.preset(prec)
        jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
        (jl, _), jg = jax.jit(jax.value_and_grad(
            lambda p: jlm_loss(p, jb, jcfg, jq), has_aux=True))(jparams)
        p = tree_map(lambda t: t.clone().requires_grad_(True), params)
        leaves = list(tree_leaves_with_path(p))
        tl, _ = lm_loss(p, {"tokens": torch.from_numpy(toks).long(),
                            "labels": torch.from_numpy(labels).long()},
                        cfg, tq)
        tg = torch.autograd.grad(tl, [t for _, t in leaves])
        grads = params_to_jax(
            _unflat(params, dict(zip([q for q, _ in leaves], tg))), cfg)
        out[prec] = (float(jl), float(tl.detach()), jg, grads)
    return out


def _unflat(tree, flat, prefix=()):
    if isinstance(tree, dict):
        return {k: _unflat(v, flat, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unflat(v, flat, prefix + (i,)) for i, v in enumerate(tree)]
    return flat[prefix]


@pytest.mark.parametrize("prec", ["bf16"])
def test_lm_loss_and_grads_match_reference(loss_grads, prec):
    jl, tl, jg, tg = loss_grads[prec]
    assert abs(tl - jl) <= LOSS_REL[prec] * abs(jl)
    want = dict(jax.tree_util.tree_leaves_with_path(jg))
    got = {jax.tree_util.keystr(p): t
           for p, t in jax.tree_util.tree_leaves_with_path(tg)}
    assert len(got) == len(want)
    lam = 0
    for path, w in want.items():
        key = jax.tree_util.keystr(path)
        g = _np(got[key])
        assert np.any(g != 0), key
        assert _rel(g, np.asarray(w, np.float32)) <= GRAD_REL[prec], key
        lam += key.endswith("['lam']")
    assert lam == 4      # the stacked lam of each rec block of each group


# ---------------------------------------------------------------------------
# the reference's serving tests on the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("prec", PRESETS)
def test_decode_step_matches_prefill_last_token(smoke, prec):
    """The reference's test_decode_step_matches_prefill_last_token_fused
    [recurrentgemma]: prefilling T-1 tokens and taking one decode step
    matches the logits of prefilling all T, under its bounds."""
    _, cfg, _, _, params, _ = smoke
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab, (2, 24)).astype(np.int64))
    qcfg = core.preset(prec)
    with torch.no_grad():
        _, cache = lm_prefill(params, toks[:, :23], cfg, qcfg, 32)
        ld, _ = lm_decode_step(params, cache, toks[:, 23:], 23, cfg, qcfg)
        lp, _ = lm_prefill(params, toks, cfg, qcfg, 32)
    ld, lp = _np(ld), _np(lp)
    if prec == "bf16":
        np.testing.assert_allclose(ld, lp, atol=DEC_TOL, rtol=DEC_TOL)
    else:
        assert _rel(ld, lp) < DEC_REL
        a, b = ld.ravel(), lp.ravel()
        assert float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))) > \
            DEC_COS


def _submit_all(eng, prompts, max_new=8, sample_every=0):
    for i, p in enumerate(prompts):
        sampled = sample_every and (i % sample_every == sample_every - 1)
        eng.submit(p, SamplingParams(temperature=0.8 if sampled else 0.0,
                                     top_k=20 if sampled else 0,
                                     max_new_tokens=max_new, seed=300 + i))


def _results(eng):
    return {r.rid: (tuple(r.tokens), r.finish_reason) for r in eng.drain()}


@pytest.mark.parametrize("prec", PRESETS)
def test_paged_vs_slab_greedy_parity(smoke, prec):
    """The reference's test_paged_vs_slab_greedy_parity[recurrentgemma]:
    ring and recurrent state are slab leaves of the paged engine (0 paged
    leaves), which must give the slab engine's tokens, greedy and sampled
    rows alike."""
    _, cfg, _, _, params, _ = smoke
    qcfg = core.preset(prec)
    rng = np.random.RandomState(11)
    prompts = [rng.randint(1, cfg.vocab, size=n) for n in (5, 40, 70, 33)]
    slab = ServeEngine(params, cfg, qcfg, max_batch=3, max_len=128,
                       bucket_prompts=False, device="cpu")
    paged = PagedServeEngine(params, cfg, qcfg, max_batch=3, max_len=128,
                             n_pages=16, page_size=32, device="cpu")
    assert not paged.chunk and not paged._pool_keys
    assert len(paged._slab_keys) == 10
    _submit_all(slab, prompts, sample_every=4)
    _submit_all(paged, prompts, sample_every=4)
    assert _results(paged) == _results(slab)
    paged.alloc.check()
    assert paged.alloc.pages_in_use == 0


def test_slab_engine_does_not_bucket_recurrent_or_windowed_prompts(smoke):
    _, cfg, _, _, params, _ = smoke
    qcfg = core.preset("bf16")
    eng = ServeEngine(params, cfg, qcfg, max_batch=2, max_len=128,
                      device="cpu")
    assert not eng.pad_safe
    eng.submit(np.arange(1, 21))
    eng.drain()
    pre = [e for e in eng.events if e["event"] == "prefill"]
    assert [(e["prompt_len"], e["padded_len"]) for e in pre] == [(20, 20)]
    small = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_head=16,
                 d_ff=64, vocab=64)
    for kw, safe in ((dict(window=16), False),
                     (dict(block_pattern=("rec", "attn"), d_rnn=32), False),
                     ({}, True)):
        c = LMConfig(**small, **kw)
        p = lm_init(c, torch.Generator().manual_seed(0), device="cpu")
        assert ServeEngine(p, c, qcfg, device="cpu").pad_safe is safe
