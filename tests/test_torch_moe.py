"""The port's MoE layer, gated MLPs and moonshot-v1-16b-a3b against the JAX
reference, on the CPU at smoke size.

Inputs come from numpy seeds and weights from the reference's own init
(moved with ``params_from_jax``); every JAX result is computed once per
module fixture.  Tolerances, with their reasons:

  * Routing (top-k expert ids, capacity, dropped assignments): equal.
    The fp32 router products sum in another order, so a near tie could
    swap two experts; random data holds none.  The dropped fraction is
    held by its count: jitted XLA divides by the count as a multiply by
    its fp32 reciprocal (1 - 384/384 reads -3e-8 there, 0 in the port).
  * ``moe_apply`` output (``Y_ULPS``): within bf16 ulps of the output's
    scale (its largest magnitude).  The reference's gated activations
    round their bf16 intermediates on XLA:CPU and the port rounds once, so
    about a third of the expert activations differ by one bf16 ulp; under
    bf16 the output stays within 1 ulp (reading 1.0 in every case), under
    MX an activation may cross a rounding boundary of its block (readings
    9.0, 4.1 and 8.1 ulps; the limit leaves about 2x).  In fp32, where
    nothing rounds to bf16, the output is the reference's within 1e-5.
    ``aux_loss``: 1e-6 relative (1.2e-7 seen).
  * Router, expert and input gradients (``GRAD_REL``): relative Frobenius
    norm per leaf; the forward's ulp differences above pass through the
    backward GEMMs (worst readings 0.0124 in bf16, 0.018 under MX; the
    limits leave about 2x).
  * Dispatch and combine backwards: the fp64 sum of the same terms within
    one fp32 ulp of the terms' magnitude per term.
  * The moonshot smoke LM, routed through a pinned table on both sides
    (``pinned_routing`` says why): loss (``LOSS_ATOL``; readings 1.4e-3
    in bf16, 3.1e-3 under MX), load-balance loss (``AUX_REL``; 1.3e-4,
    5e-4), gradients per leaf (``LM_GRAD_REL``; worst 0.027, 0.195) and
    prefill plus decode logits (``LOGIT_ATOL``, ``LOGIT_REL``; 0.055 /
    0.0125 in bf16, 0.435 / 0.098 under MX) within about 2x their
    readings, for the same reasons as olmo-paper's in
    ``tests/test_torch_train.py`` and ``tests/test_torch_models.py``
    (the gated activations' rounding, now also in the experts, through
    three layers).  With free routing the loss is held to its near-tie
    flips.
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
from repro.models import mlp as jmlp
from repro.models import moe as jmoe
from repro.train import checkpoint as jcheckpoint
from repro_torch import core
from repro_torch.configs import get_config
from repro_torch.convert import (lm_checkpoint_layout, param_shapes,
                                 params_from_jax, params_to_jax)
from repro_torch.core.diagnostics import tree_leaves_with_path
from repro_torch.models import (chunk_supported, lm_decode_step,
                                lm_init, lm_loss, lm_prefill,
                                lm_prefill_chunk, mlp, moe)
from repro_torch.serve import PagedServeEngine, SamplingParams, ServeEngine
from repro_torch.train import Trainer, TrainerConfig

ARCH = "moonshot-v1-16b-a3b"
MOE_CASES = [(2, "swiglu"), (1, "gelu"), (3, "swiglu")]
MOE_PRESETS = ("bf16", "mxfp8_e4m3")
T, D, F, E = 128, 64, 96, 8
Y_ULPS = {"bf16": 1, "mxfp8_e4m3": 16}
GRAD_REL = {"bf16": 0.025, "mxfp8_e4m3": 0.04}
LM_PRESETS = ("bf16", "mxfp8_e4m3")
LOSS_ATOL = {"bf16": 3e-3, "mxfp8_e4m3": 6e-3}
AUX_REL = {"bf16": 3e-4, "mxfp8_e4m3": 1e-3}
LM_GRAD_REL = {"bf16": 0.06, "mxfp8_e4m3": 0.4}
LOGIT_ATOL = {"bf16": 0.09375, "mxfp8_e4m3": 0.75}
LOGIT_REL = {"bf16": 0.025, "mxfp8_e4m3": 0.2}


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


def _ulp(x, mant: int) -> np.ndarray:
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return np.exp2(e - mant)


def _leaves(tree):
    return dict(tree_leaves_with_path(tree))


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


def _moe_params(act, seed=0, d=D, f=F, e=E):
    p = jmoe.moe_init(jax.random.PRNGKey(seed), d, f, e, act=act)
    return jax.tree.map(np.asarray, p)


def _moe_input(seed=1, t=T, d=D):
    return np.random.default_rng(seed).standard_normal((t, d)).astype(
        np.float32)


def _jax_moe(p, x, k, act, prec, cf, g):
    """The reference's (y, metrics, top-k ids, grads of <y, g> + 0.01 aux
    to the parameters and x)."""
    jq = jcore.preset(prec)

    def f(pp, xx):
        y, m = jmoe.moe_apply(pp, xx, jq, top_k=k, act=act,
                              capacity_factor=cf)
        return jnp.sum(y.astype(jnp.float32) * g) + 0.01 * m["aux_loss"], \
            (y, m)
    (_, (y, m)), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x).astype(jnp.bfloat16))
    probs = jax.nn.softmax(jnp.asarray(x).astype(jnp.bfloat16).astype(
        jnp.float32) @ p["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    return (_np(y), {n: float(v) for n, v in m.items()}, np.asarray(idx),
            jax.tree.map(np.asarray, grads))


@pytest.fixture(scope="module")
def moe_ref():
    g = np.random.default_rng(2).standard_normal((T, D)).astype(np.float32)
    out = {}
    for k, act in MOE_CASES:
        p = _moe_params(act)
        x = _moe_input()
        for prec in MOE_PRESETS:
            out[k, act, prec] = (p, x, g) + _jax_moe(p, x, k, act, prec,
                                                     1.25, g)
    return out


def _port_moe(p, x, k, act, prec, cf, g):
    tp = {n: torch.from_numpy(v).requires_grad_(True) for n, v in p.items()}
    tx = _bf16(x).requires_grad_(True)
    y, m = moe.moe_apply(tp, tx, core.preset(prec), top_k=k, act=act,
                         capacity_factor=cf)
    loss = (y.float() * torch.from_numpy(g)).sum() + 0.01 * m["aux_loss"]
    loss.backward()
    return y, m, {n: t.grad for n, t in tp.items()}, tx.grad


@pytest.mark.parametrize("prec", MOE_PRESETS)
@pytest.mark.parametrize("k,act", MOE_CASES)
def test_moe_apply_matches_reference(moe_ref, k, act, prec):
    p, x, g, jy, jm, jidx, (jgp, jgx) = moe_ref[k, act, prec]
    probs = torch.softmax(_bf16(x).float() @ torch.from_numpy(p["router"]),
                          -1)
    _, idx = torch.topk(probs, k, dim=-1, sorted=True)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    for t in (1, 4, T, 4096):
        assert (moe._capacity(t, k, E, 1.25)
                == jmoe._capacity(t, k, E, 1.25))
    y, m, grads, gx = _port_moe(p, x, k, act, prec, 1.25, g)
    n = T * k
    assert round(float(m["dropped_frac"]) * n) == round(jm["dropped_frac"]
                                                        * n)
    assert abs(float(m["aux_loss"]) - jm["aux_loss"]) \
        <= 1e-6 * abs(jm["aux_loss"])
    scale = _ulp(np.abs(jy).max(), 7)
    assert np.abs(_np(y) - jy).max() <= Y_ULPS[prec] * scale
    for name, gr in grads.items():
        assert _rel(gr.numpy(), jgp[name]) <= GRAD_REL[prec], name
        assert float(gr.abs().max()) > 0, name
    assert _rel(_np(gx), _np(jgx)) <= GRAD_REL[prec]


@pytest.mark.parametrize("k,act,cf,shape", [
    (2, "swiglu", 0.5, (64, 32, 24, 4))] + [
    (k, act, 1.25, (T, D, F, E)) for k, act in MOE_CASES])
def test_moe_apply_in_fp32_matches_reference(k, act, cf, shape):
    """Unquantized fp32 tokens, as ``tests/test_moe.py`` runs them; the
    first case is its capacity-drop case (T 64, D 16, here 32: a whole MX
    block, F 24, E 4, top-2 at capacity factor 0.5)."""
    t, d, f, e = shape
    p = _moe_params(act, d=d, f=f, e=e)
    x = _moe_input(t=t, d=d)
    jy, jm = jmoe.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                            jcore.QuantConfig.bf16(), top_k=k, act=act,
                            capacity_factor=cf)
    y, m = moe.moe_apply({n: torch.from_numpy(v) for n, v in p.items()},
                         torch.from_numpy(x), core.QuantConfig.bf16(),
                         top_k=k, act=act, capacity_factor=cf)
    n = t * k
    assert round(float(m["dropped_frac"]) * n) == round(
        float(jm["dropped_frac"]) * n)
    assert (float(m["dropped_frac"]) > 0) == (cf < 1)
    assert bool(torch.isfinite(y).all())
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)


def _routing(seed=3, t=40, k=3, e=4, c=32):
    idx = np.stack([np.random.default_rng(seed + i).permutation(e)[:k]
                    for i in range(t)])
    return moe.route(torch.from_numpy(idx), e, c)


@pytest.mark.parametrize("k", [1, 3])
def test_dispatch_and_combine_backwards_are_the_fp64_sums(k):
    """Each backward against the fp64 sum of its terms; a capacity of 32
    below the 40 assignments of expert 0 drops some."""
    t, e, c, d = 48, 4, 32, 40
    r = _routing(t=t, k=k, e=e, c=c)
    assert bool((~r.kept).any()) == (k == 3)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32))
    w = torch.from_numpy(rng.random((t, k)).astype(np.float32))
    buf = torch.from_numpy(rng.standard_normal((e, c, d)).astype(
        np.float32))
    dh = torch.from_numpy(rng.standard_normal((e, c, d)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32))
    slot, kept = r.flat_slot.numpy(), r.kept.numpy()
    tok, valid = r.tok_of_slot.numpy(), r.valid.numpy()
    aos = r.assign_of_slot.numpy()

    xr = x.clone().requires_grad_(True)
    moe.dispatch(xr, r).backward(dh)
    terms = (dh.double().numpy().reshape(-1, d)[slot]
             * kept[:, None]).reshape(t, k, d)
    exact, mag = terms.sum(1), np.abs(terms).sum(1)
    assert np.all(np.abs(xr.grad.double().numpy() - exact)
                  <= k * _ulp(mag, 23))

    br = buf.clone().requires_grad_(True)
    wr = w.clone().requires_grad_(True)
    y = moe.combine(br, wr, r)
    rows = (buf.double().numpy().reshape(-1, d)[slot]
            * kept[:, None]).reshape(t, k, d)
    terms = rows * w.double().numpy()[..., None]
    assert np.all(np.abs(y.double().detach().numpy() - terms.sum(1))
                  <= k * _ulp(np.abs(terms).sum(1), 23))
    y.backward(dy)
    want = (dy.double().numpy()[tok] * w.double().numpy().reshape(-1)[aos][
        ..., None] * valid[..., None])
    assert np.all(np.abs(br.grad.double().numpy() - want)
                  <= _ulp(np.abs(want), 23))
    dterms = rows * dy.double().numpy()[:, None]
    assert np.all(np.abs(wr.grad.double().numpy() - dterms.sum(-1))
                  <= d * _ulp(np.abs(dterms).sum(-1), 23))
    # every slot's gradient is its own token's: empty slots get none
    assert float(br.grad[torch.from_numpy(~valid)].abs().max()) == 0.0


@pytest.mark.parametrize("prec", ["bf16", "mxfp8_e4m3"])
@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_gated_mlp_matches_reference(act, prec):
    jp = jmlp.mlp_init(jax.random.PRNGKey(0), 64, 96, act=act)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), jp)
    assert set(tp) == {"w_up", "w_gate", "w_down"}
    x = np.random.default_rng(3).standard_normal((2, 7, 64))
    want = _np(jmlp.mlp_apply(jp, jnp.asarray(x).astype(jnp.bfloat16),
                              jcore.preset(prec), act))
    got = _np(mlp.mlp_apply(tp, _bf16(x), core.preset(prec), act))
    assert _rel(got, want) < 0.02
    fresh = mlp.mlp_init(torch.Generator().manual_seed(0), 64, 96, act,
                         init="kaiming_uniform")
    assert fresh["w_gate"]["w"].abs().max() <= 64 ** -0.5


# ---- moonshot-v1-16b-a3b smoke -------------------------------------------
def _np_batch(step, vocab, B=2, T_=64):
    toks = np.random.default_rng(100 + step).integers(0, vocab, (B, T_ + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def _torch_batch(b):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()}


@pytest.fixture(scope="module")
def smoke():
    jcfg = jget_config(ARCH, "smoke")
    cfg = get_config(ARCH, "smoke")
    jparams = jlm_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, jax.tree.map(np.asarray, jparams)


def test_config_matches_reference_and_is_served_whole():
    for variant in ("full", "smoke"):
        assert (dataclasses.asdict(jget_config(ARCH, variant))
                == dataclasses.asdict(get_config(ARCH, variant)))
    cfg = get_config(ARCH, "smoke")
    assert not chunk_supported(cfg)
    assert chunk_supported(get_config("olmo-paper", "smoke"))
    params = lm_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    # the paged engine takes the whole-prompt path, chunked prefill raises
    eng = PagedServeEngine(params, cfg, core.preset("bf16"), device="cpu")
    assert not eng.chunk
    with pytest.raises(NotImplementedError, match="prefill whole"):
        lm_prefill_chunk(params, torch.zeros((1, 32), dtype=torch.long), [],
                         0, cfg, core.preset("bf16"))
    with pytest.raises(NotImplementedError, match="later slice"):
        lm_init(dataclasses.replace(cfg, tie_embeddings=True),
                torch.Generator().manual_seed(0), device="cpu")


def test_params_round_trip_through_tree_and_checkpoint(smoke, tmp_path):
    jcfg, cfg, jparams, tree = smoke
    params = params_from_jax(tree, cfg, "cpu")
    assert [("moe" in lp, "mlp" in lp) for lp in params["layers"]] == [
        (False, True), (True, False), (True, False)]
    assert set(param_shapes(cfg)) == {"embed", "layer", "dense_layer",
                                      "final_ln", "lm_head"}
    back, want = _leaves(params_to_jax(params, cfg)), _leaves(tree)
    assert set(back) == set(want)
    for path in want:
        np.testing.assert_array_equal(back[path].numpy(), want[path])
    np.testing.assert_array_equal(
        params["layers"][2]["moe"]["w_gate"].numpy(),
        tree["blocks"][1]["b0"]["moe"]["w_gate"][1])
    bf = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                      if a.ndim >= 2 else a, jparams)
    npz = dict(np.load(jcheckpoint.save(str(tmp_path), 0, bf)))
    from_npz = params_from_jax(npz, cfg, device="cpu")
    assert from_npz["layers"][1]["moe"]["w_down"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _np(from_npz["layers"][1]["shared"]["w_gate"]["w"]),
        _np(bf["blocks"][1]["b0"]["shared"]["w_gate"]["w"][0]))
    extra = dict(npz)
    extra["['stray']"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="not used"):
        params_from_jax(extra, cfg, device="cpu")


def test_lm_init_shapes_and_distributions_match_reference(smoke):
    """Same shapes; each weight's std within 5 standard errors of the
    reference's (se(std) = std / sqrt(2n)), plus 2% for the truncation."""
    _, cfg, _, tree = smoke
    want = _leaves(params_from_jax(tree, cfg, "cpu"))
    fresh = _leaves(lm_init(cfg, torch.Generator().manual_seed(0),
                            device="cpu"))
    assert set(fresh) == set(want)
    for path, leaf in fresh.items():
        assert tuple(leaf.shape) == tuple(want[path].shape), path
        assert leaf.dtype == torch.float32
        if leaf.ndim >= 2:
            ref = float(want[path].std())
            tol = 5 / np.sqrt(2 * leaf.numel()) + 0.02
            assert abs(float(leaf.std()) - ref) <= tol * ref, path


def _pinned_scores(T_: int, E_: int) -> np.ndarray:
    return np.random.default_rng(1000 * T_ + E_).random((T_, E_)).astype(
        np.float32)


@pytest.fixture
def pinned_routing(monkeypatch):
    """Both packages route each token to the top-k of a fixed score table
    (one per token count), the gates still the router's probabilities at
    those experts.  Through an LM the hidden states differ by bf16 ulps
    (the gated activations' rounding), which moves router probabilities by
    ~1e-3, and tokens whose k-th and (k+1)-th probabilities lie that close
    route to other experts in the two packages (3 of 16 decode rows in
    bf16 here): pinned, the LM's numbers are held tight; top-k itself is
    held equal in ``test_moe_apply_matches_reference``."""
    jtopk, ttopk = jax.lax.top_k, torch.topk

    def jpinned(probs, k):
        _, idx = jtopk(jnp.asarray(_pinned_scores(*probs.shape)), k)
        return jnp.take_along_axis(probs, idx, -1), idx

    def tpinned(probs, k, dim=-1, sorted=True):
        _, idx = ttopk(torch.from_numpy(_pinned_scores(*probs.shape)), k,
                       dim=-1, sorted=True)
        idx = idx.to(probs.device)
        return torch.gather(probs, -1, idx), idx
    monkeypatch.setattr(jax.lax, "top_k", jpinned)
    monkeypatch.setattr(torch, "topk", tpinned)


def _port_loss_grads(params, batch, cfg, prec):
    leaves = list(tree_leaves_with_path(params))
    for _, t in leaves:
        t.requires_grad_(True)
    loss, metrics = lm_loss(params, _torch_batch(batch), cfg,
                            core.preset(prec))
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    return loss, metrics, {p: g for (p, _), g in zip(leaves, grads)}


@pytest.mark.parametrize("prec", LM_PRESETS)
def test_lm_loss_and_grads_match_reference(smoke, pinned_routing, prec):
    jcfg, cfg, jparams, tree = smoke
    batch = _np_batch(0, cfg.vocab)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm_loss(p, b, jcfg, jcore.preset(prec)),
        has_aux=True))(jparams, jax.tree.map(jnp.asarray, batch))
    loss, metrics, grads = _port_loss_grads(params_from_jax(tree, cfg, "cpu"),
                                            batch, cfg, prec)
    assert abs(loss.item() - float(jl)) <= LOSS_ATOL[prec]
    assert float(metrics["aux_loss"]) > 1.0   # E * sum(frac * pbar) ~ 2
    assert abs(float(metrics["aux_loss"]) - float(jm["aux_loss"])) \
        <= AUX_REL[prec] * float(jm["aux_loss"])
    want = _leaves(params_from_jax(jax.tree.map(np.asarray, jg), cfg,
                                   "cpu"))
    assert set(want) == set(grads)
    for path, g in grads.items():
        assert _rel(g.numpy(), want[path].numpy()) <= LM_GRAD_REL[prec], \
            path
        assert float(g.abs().max()) > 0, path


def test_lm_loss_with_free_routing_stays_near_reference(smoke):
    """Unpinned, a few near-tie tokens route to other experts (see
    ``pinned_routing``): the loss moves by their share (readings 5e-4 in
    bf16, 1.25e-2 under MX, limits 2x), the load-balance loss by a few
    assignments' 1/(T k) of its frac (readings 0.24% and 0.16%)."""
    jcfg, cfg, jparams, tree = smoke
    batch = _np_batch(0, cfg.vocab)
    for prec, atol in (("bf16", 1e-3), ("mxfp8_e4m3", 2.5e-2)):
        jl, jm = jax.jit(lambda p, b: jlm_loss(p, b, jcfg,
                                               jcore.preset(prec)))(
            jparams, jax.tree.map(jnp.asarray, batch))
        with torch.no_grad():
            loss, metrics = lm_loss(params_from_jax(tree, cfg, "cpu"),
                                    _torch_batch(batch), cfg,
                                    core.preset(prec))
        assert abs(loss.item() - float(jl)) <= atol
        assert abs(float(metrics["aux_loss"]) - float(jm["aux_loss"])) \
            <= 5e-3 * float(jm["aux_loss"])


@pytest.mark.parametrize("prec", LM_PRESETS)
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
    tl, tc = lm_prefill(params, torch.from_numpy(toks).long(), cfg, tq, S,
                        torch.from_numpy(lpos).long())
    ref_logits, port_logits = [_np(jl)], [_np(tl)]
    pos = lpos + 1
    for _ in range(8):
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


def _trainer(cfg, params, prec, ckpt_dir=None, **kw):
    return Trainer(lambda p, b, q: lm_loss(p, b, cfg, q), params,
                   core.preset(prec),
                   lambda s: _torch_batch(_np_batch(s, cfg.vocab)),
                   tcfg=TrainerConfig(total_steps=3, peak_lr=1e-3,
                                      log_every=1, ckpt_dir=ckpt_dir,
                                      ckpt_every=2, **kw),
                   ckpt_layout=lm_checkpoint_layout(cfg, "cpu"))


def test_trainer_steps_resume_bitwise_and_serve(smoke, tmp_path):
    """Three Trainer steps with a checkpoint at step 2 (the reference's
    npz); a second Trainer resumes from it and trains step 2 to the same
    bits.  A guarded MX step (ζ probe on) reads the same layout, and a
    ServeEngine serves the trained weights: greedy tokens equal to the
    port's own prefill and decode, one request at a time."""
    _, cfg, _, tree = smoke
    tr = _trainer(cfg, params_from_jax(tree, cfg, "cpu"), "bf16",
                  str(tmp_path))
    hist = tr.run(3)
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(h["aux_loss"] > 1.0 and np.isfinite(h["loss"]) for h in hist)
    again = _trainer(cfg, lm_init(cfg, torch.Generator().manual_seed(3),
                                  device="cpu"), "bf16", str(tmp_path))
    assert again.restore(step=2) and again.step == 2
    assert again.run(1)[-1]["loss"] == hist[-1]["loss"]
    resumed = _leaves(again._tree())
    for path, t in tree_leaves_with_path(tr._tree()):
        assert torch.equal(t, resumed[path]), path
    z = np.load(tmp_path / "step_00000002.npz")
    assert "['params']['blocks'][1]['b0']['moe']['router']" in z.files

    guarded = _trainer(cfg, params_from_jax(tree, cfg, "cpu"), "mxfp8_e4m3",
                       guard="autopilot", guard_probe_every=1)
    rec = guarded.run(1)[-1]
    assert np.isfinite(rec["guard_zeta"]) and rec["guard_zeta"] > 0

    q = core.preset("bf16")
    eng = ServeEngine(tr.params, cfg, q, max_batch=2, max_len=48,
                      device="cpu")
    prompts = [np.arange(1, 12), np.arange(5, 25), np.arange(40, 47)]
    for pr in prompts:
        eng.submit(pr, SamplingParams(max_new_tokens=8))
    done = eng.drain()
    assert [e["padded_len"] for e in eng.events
            if e["event"] == "prefill"] == [11, 20, 7]
    with torch.no_grad():
        want = []
        for pr in prompts:
            lg, cache = lm_prefill(eng.params, torch.from_numpy(pr)[None],
                                   cfg, q, 48)
            toks = [int(lg.argmax(-1))]
            for i in range(7):
                lg, cache = lm_decode_step(
                    eng.params, cache, torch.tensor([[toks[-1]]]),
                    torch.tensor(len(pr) + i), cfg, q)
                toks.append(int(lg.argmax(-1)))
            want.append(toks)
    assert [list(map(int, r.tokens)) for r in done] == want


def test_trainer_step_leaves_no_cycle_holding_tensors():
    """A step's gradients die with the step: none sits in a reference
    cycle until the collector runs (at moonshot's full width that was
    10 GB a step)."""
    import gc
    cfg = get_config(ARCH, "smoke")
    tr = _trainer(cfg, lm_init(cfg, torch.Generator().manual_seed(0),
                               device="cpu"), "bf16")
    tr.run(1)
    gc.collect()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        tr.run(1)
        gc.collect()
        held = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
    assert held == []


def test_checkpoint_save_copies_leaves_the_trainer_updates(tmp_path):
    """The writer thread reads a copy: an in-place update right after
    ``save`` returns does not reach the file."""
    from repro_torch.train.checkpoint import Checkpointer, restore
    tree = {"w": torch.zeros(1 << 16)}
    ck = Checkpointer(str(tmp_path))
    ck.save(0, tree)
    tree["w"].add_(1.0)
    ck.wait()
    out, _, _ = restore(str(tmp_path), {"w": torch.empty(1 << 16)}, 0)
    assert float(out["w"].abs().max()) == 0.0
