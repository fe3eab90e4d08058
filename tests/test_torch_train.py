"""The port's training path against the JAX reference, on the CPU.

Numpy inputs and the reference's own init (moved with ``params_from_jax``)
go to both packages: the attention layer's and the LM's loss and
gradients, the proxy, one AdamW update, the LR schedule, the spike
detector, three Trainer steps and checkpoints written by one package and
read by the other.  The Trainer's recovery scenarios of
``tests/test_train.py`` run on the port alone (smoke size).

Tolerances, with their reasons:
  * Attention layer (projections, flash, wo) gradients: relative Frobenius
    norm <= 1e-3 per leaf (the forward differs by one bf16 ulp in ~1% of
    outputs through exp and sum order; 1.7e-4 seen in bf16, 0 in MX).
  * LM loss and gradients (``LOSS_ATOL``, ``GRAD_REL``): ``jax.nn.gelu``
    rounds its bf16 intermediates on XLA:CPU and the port rounds once
    (ROADMAP Queue C), so ~40% of GeLU outputs differ by a bf16 ulp, and
    under MX a value may cross a rounding boundary; gradients of two
    layers amplify that.  Readings: loss 6e-4 / 2e-4 / 4.8e-3 and worst
    leaf 0.016 / 0.015 / 0.107 (bf16 / e4m3_bf16act / mxfp8_e4m3); the
    limits leave about 2x.
  * Proxy (fp32 activations): relative Frobenius <= 1e-5 (1e-7 seen).
  * AdamW: bitwise unclipped; clipped within 1e-6 relative (the global
    norm's sum order).  The schedule and the spike detector: bitwise.
  * Three Trainer steps: losses within ``LOSS_ATOL``, gradient norms within
    1% (the LM gradients' noise above).
  * Checkpoints: bitwise both ways.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis import given, settings, strategies as st

from repro import core as jcore
from repro.configs import get_config as jget_config
from repro.models import attention as jattention
from repro.models import lm_init as jlm_init
from repro.models import lm_loss as jlm_loss
from repro.models import proxy as jproxy
from repro.models.transformer import LMConfig as JLMConfig
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro_torch import core
from repro_torch.configs import get_config
from repro_torch.convert import (lm_checkpoint_layout, params_from_jax,
                                 params_to_jax)
from repro_torch.core.diagnostics import tree_leaves_with_path
from repro_torch.data import lm_batch
from repro_torch.models import (LMConfig, attention, lm_init, lm_loss,
                                proxy)
from repro_torch.optim import adamw, schedule
from repro_torch.train import (Trainer, TrainerConfig, latest_step, restore,
                               save)

PRESETS = ("bf16", "e4m3_bf16act", "mxfp8_e4m3")
LOSS_ATOL = {"bf16": 2e-3, "e4m3_bf16act": 2e-3, "mxfp8_e4m3": 1e-2}
GRAD_REL = {"bf16": 0.03, "e4m3_bf16act": 0.03, "mxfp8_e4m3": 0.2}


def _leaves(tree):
    return dict(tree_leaves_with_path(tree))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np_batch(step, vocab, B=2, T=64):
    toks = np.random.default_rng(100 + step).integers(0, vocab, (B, T + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def _torch_batch(b):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in b.items()}


@pytest.fixture(scope="module")
def smoke():
    jcfg = jget_config("olmo-paper", "smoke")
    cfg = get_config("olmo-paper", "smoke")
    jparams = jlm_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, jax.tree.map(np.asarray, jparams)


def _port_grads(params, batch, cfg, qcfg):
    leaves = list(tree_leaves_with_path(params))
    for _, t in leaves:
        t.requires_grad_(True)
    loss, metrics = lm_loss(params, batch, cfg, qcfg)
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    return loss, metrics, {p: g for (p, _), g in zip(leaves, grads)}


@pytest.mark.parametrize("name", ["bf16", "mxfp8_e4m3"])
def test_attention_layer_vjp_matches_reference(name):
    rng = np.random.default_rng(1)
    D, H, dh, B, T = 128, 2, 64, 2, 64
    w = lambda i, o, s: (rng.standard_normal((i, o)) * s).astype(np.float32)
    P = {"wq": {"w": w(D, H * dh, D ** -0.5)},
         "wk": {"w": w(D, H * dh, D ** -0.5)},
         "wv": {"w": w(D, H * dh, D ** -0.5)},
         "wo": {"w": w(H * dh, D, (4 * D) ** -0.5)},
         "q_norm": {"scale": (1 + 0.1 * rng.standard_normal(dh)
                              ).astype(np.float32)},
         "k_norm": {"scale": (1 + 0.1 * rng.standard_normal(dh)
                              ).astype(np.float32)}}
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    g = rng.standard_normal((B, T, D)).astype(np.float32)
    kw = dict(n_heads=H, n_kv=H, d_head=dh)

    def jf(p, xx):
        y = jattention.attention(
            p, xx, qcfg=jcore.preset(name), spec=JLMConfig().attn_spec(),
            positions=jnp.broadcast_to(jnp.arange(T)[None], (B, T)), **kw)
        return jnp.sum(y.astype(jnp.float32) * g)
    jgp, jgx = jax.grad(jf, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, P), jnp.asarray(x).astype(jnp.bfloat16))
    tp = jax.tree.map(lambda a: torch.from_numpy(a).requires_grad_(True), P)
    tx = torch.from_numpy(x).bfloat16().requires_grad_(True)
    y = attention.attention(tp, tx, qcfg=core.preset(name),
                            spec=LMConfig().attn_spec(),
                            positions=torch.arange(T)[None].expand(B, T),
                            **kw)
    (y.float() * torch.from_numpy(g)).sum().backward()
    want = _leaves(jax.tree.map(np.asarray, jgp))
    for path, t in tree_leaves_with_path(tp):
        assert _rel(t.grad.numpy(), want[path]) <= 1e-3, path
    assert _rel(tx.grad.float().numpy(),
                np.asarray(jgx.astype(jnp.float32))) <= 1e-3


def test_embedding_gradient_sums_in_bf16_as_the_reference():
    """Gathering fp32 rows and then casting would sum the gradients of
    repeated ids in fp32; the reference casts the table first and sums in
    bf16 (1% apart here).  The port casts first: bitwise."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((4, 16)).astype(np.float32)
    ids = rng.integers(0, 4, (2, 64))
    g = rng.standard_normal((2, 64, 16)).astype(np.float32)
    from repro.models import layers as jlayers
    from repro_torch.models import layers
    want = jax.grad(lambda t: jnp.sum(jlayers.embed_lookup(
        {"table": t}, jnp.asarray(ids)).astype(jnp.float32) * g))(
        jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_(True)
    (layers.embed_lookup({"table": t}, torch.from_numpy(ids)).float()
     * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", PRESETS)
def test_lm_loss_and_grads_match_reference(smoke, name):
    jcfg, cfg, jparams, tree = smoke
    batch = _np_batch(0, cfg.vocab)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm_loss(p, b, jcfg, jcore.preset(name)),
        has_aux=True))(jparams, jax.tree.map(jnp.asarray, batch))
    loss, metrics, grads = _port_grads(params_from_jax(tree, cfg, "cpu"),
                                       _torch_batch(batch), cfg,
                                       core.preset(name))
    assert abs(loss.item() - float(jl)) <= LOSS_ATOL[name]
    assert float(metrics["aux_loss"]) == float(jm["aux_loss"]) == 0.0
    want = _leaves(params_from_jax(jax.tree.map(np.asarray, jg), cfg,
                                   "cpu"))
    assert set(want) == set(grads)
    for path, g in grads.items():
        assert _rel(g.numpy(), want[path].numpy()) <= GRAD_REL[name], path
    ln = [p for p in grads if p[-2] in ("ln1", "ln2", "final_ln")]
    assert ln and all(grads[p].abs().max() > 0 for p in ln)


def test_lm_loss_pads_the_last_chunk_as_the_reference():
    """T not a multiple of loss_chunk: the padded tokens are masked and
    the wgrad blocks run over the padded chunk, as in the reference."""
    jcfg = dataclasses.replace(jget_config("olmo-paper", "smoke"),
                               loss_chunk=48)
    cfg = dataclasses.replace(get_config("olmo-paper", "smoke"),
                              loss_chunk=48)
    jparams = jlm_init(jax.random.PRNGKey(1), jcfg)
    batch = _np_batch(1, cfg.vocab)
    batch["labels"][0, :5] = -1
    qcfg = "mxfp8_e4m3"
    jl, jg = jax.value_and_grad(lambda p: jlm_loss(
        p, jax.tree.map(jnp.asarray, batch), jcfg, jcore.preset(qcfg))[0])(
        jparams)
    loss, _, grads = _port_grads(
        params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu"),
        _torch_batch(batch), cfg, core.preset(qcfg))
    assert abs(loss.item() - float(jl)) <= LOSS_ATOL[qcfg]
    want = params_from_jax(jax.tree.map(np.asarray, jg), cfg, "cpu")
    assert _rel(grads[("lm_head", "w")].numpy(),
                want["lm_head"]["w"].numpy()) <= GRAD_REL[qcfg]


@pytest.mark.parametrize("name", PRESETS)
def test_proxy_loss_and_grads_match_reference(name):
    jcfg = jproxy.ProxyConfig(d_model=64, n_layers=2, batch_size=64)
    cfg = proxy.ProxyConfig(d_model=64, n_layers=2, batch_size=64)
    jparams = jproxy.proxy_init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 64)).astype(np.float32)
    y = (0.1 * rng.standard_normal((64, 64))).astype(np.float32)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jproxy.proxy_loss(p, (jnp.asarray(x), jnp.asarray(y)),
                                    jcfg, jcore.preset(name)),
        has_aux=True)(jparams)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a))
                      .requires_grad_(True), jparams)
    tl, _ = proxy.proxy_loss(tp, (torch.from_numpy(x), torch.from_numpy(y)),
                             cfg, core.preset(name))
    tl.backward()
    assert abs(tl.item() - float(jl)) <= 1e-5 * float(jl)
    want = _leaves(jax.tree.map(np.asarray, jg))
    for path, t in tree_leaves_with_path(tp):
        assert _rel(t.grad.numpy(), want[path]) <= 1e-5, path


def test_proxy_shapes_and_teacher_have_no_layernorm():
    cfg = proxy.ProxyConfig(d_model=64, n_layers=3, batch_size=16,
                            act="swiglu", init="xavier_lowgain")
    g = torch.Generator().manual_seed(0)
    p = proxy.proxy_init(g, cfg, device="cpu")
    t = proxy.teacher_init(g, cfg, device="cpu")
    assert len(p["layers"]) == 3 and "ln" in p["layers"][0]
    assert "ln" not in t["layers"][0] and "w1g" in t["layers"][0]
    assert p["layers"][0]["w1"]["w"].shape == (64, cfg.d_hidden)
    x, y = proxy.proxy_batch(5, t, cfg, seed=2)
    x2, y2 = proxy.proxy_batch(5, t, cfg, seed=2)
    assert x.shape == y.shape == (16, 64)
    assert torch.equal(x, x2) and torch.equal(y, y2)
    assert not torch.equal(x, proxy.proxy_batch(6, t, cfg, seed=2)[0])


@pytest.mark.parametrize("master,moment_fmt,clip", [(False, None, 1.0),
                                                    (True, "e4m3", 0.0),
                                                    (True, None, 0.0)])
def test_adamw_update_matches_reference(master, moment_fmt, clip):
    """Bitwise without clipping.  The global norm's sums run in another
    order (1 fp32 ulp seen, 2 allowed), so with clipping the scaled
    gradients differ by an ulp and the update is held to 1e-6 relative
    (1e-9 absolute for moments near 0); MX moments are checked unclipped,
    where no gradient moves a moment across a grid point."""
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 64), "b": [(64,), (3, 32)]}
    mk = lambda: jax.tree.map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    p0, grads = mk(), [mk() for _ in range(3)]
    jcfg = jadamw.AdamWConfig(master=master, grad_clip=clip,
                              moment_fmt=moment_fmt and
                              jcore.get_format(moment_fmt))
    tcfg = adamw.AdamWConfig(master=master, grad_clip=clip,
                             moment_fmt=moment_fmt and
                             core.get_format(moment_fmt))
    jp = jax.tree.map(jnp.asarray, p0)
    js = jadamw.adamw_init(jp, jcfg)
    # copies: the port updates in place, and jnp.asarray may share p0's
    # memory on the CPU
    tp = jax.tree.map(torch.tensor, p0)
    ts = adamw.adamw_init(tp, tcfg)
    rtol, atol = (1e-6, 1e-9) if clip else (0.0, 0.0)
    for i, g in enumerate(grads):
        jlr, tlr = jschedule.warmup_cosine(i, 10), schedule.warmup_cosine(i,
                                                                          10)
        assert float(jlr) == float(tlr)
        jp, js, jm = jadamw.adamw_update(jax.tree.map(jnp.asarray, g), js,
                                         jp, jlr, jcfg)
        tp, ts, tm = adamw.adamw_update(jax.tree.map(torch.from_numpy, g),
                                        ts, tp, tlr, tcfg)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=2.0 ** -22, abs=0)
    for key in ("m", "v") + (("master",) if master else ()):
        want = _leaves(jax.tree.map(np.asarray, js[key]))
        for path, t in tree_leaves_with_path(ts[key]):
            np.testing.assert_allclose(t.numpy(), want[path], rtol=rtol,
                                       atol=atol)
    want = _leaves(jax.tree.map(np.asarray, jp))
    for path, t in tree_leaves_with_path(tp):
        np.testing.assert_allclose(t.numpy(), want[path], rtol=rtol,
                                   atol=atol)
    assert int(ts["count"]) == int(js["count"]) == 3


def test_sgd_and_schedules_match_reference():
    rng = np.random.default_rng(1)
    p = {"w": rng.standard_normal((8, 32)).astype(np.float32)}
    g = {"w": rng.standard_normal((8, 32)).astype(np.float32)}
    # unclipped, so bitwise (clipping is held in the AdamW test)
    jp, js, _ = jadamw.sgd_update(jax.tree.map(jnp.asarray, g),
                                  jadamw.sgd_init(p), jax.tree.map(
                                      jnp.asarray, p), 0.01, grad_clip=0.0)
    tp = jax.tree.map(torch.tensor, p)   # a copy: updated in place
    tp, ts, _ = adamw.sgd_update(jax.tree.map(torch.from_numpy, g),
                                 adamw.sgd_init(tp), tp, 0.01, grad_clip=0.0)
    np.testing.assert_array_equal(tp["w"].numpy(), np.asarray(jp["w"]))
    for step in (0, 1, 4, 5, 6, 50, 99, 150):
        assert float(schedule.warmup_cosine(step, 100)) == float(
            jschedule.warmup_cosine(step, 100))
        for name in ("constant", "cosine"):
            assert float(schedule.get_schedule(name)(step, 100, 3e-4)) == \
                float(jschedule.get_schedule(name)(step, 100, 3e-4))


# float32-exact bounds (ROADMAP Queue C): 2**-10 and 2**10.
_LOSSES = st.lists(st.floats(min_value=2.0 ** -10, max_value=2.0 ** 10,
                             width=32), min_size=1, max_size=40)


@settings(max_examples=50, deadline=None, derandomize=True)
@given(losses=_LOSSES, gnorms=_LOSSES)
def test_spike_detector_flags_match_reference(losses, gnorms):
    from repro.core import SpikeDetector as JSpike
    jd, td = JSpike(spike_factor=3.0, grad_factor=5.0), core.SpikeDetector(
        spike_factor=3.0, grad_factor=5.0)
    for loss, gn in zip(losses, gnorms):
        assert td.update(loss, gn) == jd.update(loss, gn)
    for value in (float("nan"), float("inf"), 1e9):
        assert td.update(value) == jd.update(value)
    assert td.n_spikes == jd.n_spikes


def test_diagnostics_match_reference():
    from repro.core import diagnostics as jdiag
    from repro.core.mx import mx_stats as jmx_stats
    rng = np.random.default_rng(2)
    a = {"x": rng.standard_normal((4, 40)).astype(np.float32),
         "ln": {"scale": (1 + 0.01 * rng.standard_normal(70)
                          ).astype(np.float32)}}
    b = jax.tree.map(lambda v: v + 0.1 * rng.standard_normal(v.shape)
                     .astype(np.float32), a)
    jz = jdiag.zeta_bound(jax.tree.map(jnp.asarray, a),
                          jax.tree.map(jnp.asarray, b))
    tz = core.zeta_bound(jax.tree.map(torch.from_numpy, a),
                         jax.tree.map(torch.from_numpy, b))
    for k in jz:
        assert abs(float(tz[k]) - float(jz[k])) <= 1e-6 * abs(float(jz[k]))
    qcfg, jq = core.preset("mxfp8_e4m3"), jcore.preset("mxfp8_e4m3")
    tstats = core.ln_clamp_stats(jax.tree.map(torch.from_numpy, a), qcfg)
    jstats = jdiag.ln_clamp_stats(jax.tree.map(jnp.asarray, a), jq)
    assert list(tstats) == list(jstats) == ["['ln']['scale']"]
    for k, v in jstats["['ln']['scale']"].items():
        assert float(tstats["['ln']['scale']"][k]) == pytest.approx(
            float(v), rel=1e-6, abs=1e-9)
    x = (rng.standard_normal((3, 50)) * 40).astype(np.float32)
    for fmt in ("e4m3", "e2m1"):
        js = jmx_stats(jnp.asarray(x), jcore.get_format(fmt))
        ts = core.mx_stats(torch.from_numpy(x), core.get_format(fmt))
        for k in js:
            assert float(ts[k]) == pytest.approx(float(js[k]), rel=1e-6,
                                                 abs=1e-9)
    probe = core.grad_bias_probe(
        lambda p, bb, q: {"g": p["w"] * (2.0 if q.a_fwd else 1.0)},
        {"w": torch.ones(4)}, None, qcfg)
    assert float(probe["norm_ratio"]) == pytest.approx(1.0)


# ---- Trainer: parity with the reference and checkpoint interop ----------
@pytest.fixture(scope="module")
def jax_runs(smoke, tmp_path_factory):
    """Three reference Trainer steps per preset, checkpointed."""
    jcfg, cfg, jparams, _ = smoke
    out = {}
    for name in ("bf16", "mxfp8_e4m3"):
        d = tmp_path_factory.mktemp(f"jax_{name}")
        jt = JTrainer(lambda p, b, q: jlm_loss(p, b, jcfg, q), jparams,
                      jcore.preset(name),
                      lambda s: jax.tree.map(jnp.asarray,
                                             _np_batch(s, cfg.vocab)),
                      tcfg=JTrainerConfig(total_steps=3, peak_lr=1e-3,
                                          log_every=1, ckpt_dir=str(d),
                                          ckpt_every=100))
        out[name] = (jt, jt.run(3), d)
    return out


def _port_trainer(cfg, params, qcfg, ckpt_dir=None, **kw):
    return Trainer(lambda p, b, q: lm_loss(p, b, cfg, q), params, qcfg,
                   lambda s: _torch_batch(_np_batch(s, cfg.vocab)),
                   tcfg=TrainerConfig(total_steps=3, peak_lr=1e-3,
                                      log_every=1, ckpt_dir=ckpt_dir,
                                      ckpt_every=100, **kw),
                   ckpt_layout=lm_checkpoint_layout(cfg, "cpu"))


@pytest.mark.parametrize("name", ["bf16", "mxfp8_e4m3"])
def test_trainer_three_steps_match_reference(smoke, jax_runs, name):
    _, cfg, _, tree = smoke
    _, jhist, _ = jax_runs[name]
    hist = _port_trainer(cfg, params_from_jax(tree, cfg, "cpu"),
                         core.preset(name)).run(3)
    assert [r["step"] for r in hist] == [0, 1, 2]
    for a, b in zip(hist, jhist):
        assert abs(a["loss"] - b["loss"]) <= LOSS_ATOL[name]
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-2)
        assert a["lr"] == b["lr"]


def test_checkpoint_written_by_reference_restores_in_port(smoke, jax_runs):
    _, cfg, _, _ = smoke
    jt, _, d = jax_runs["mxfp8_e4m3"]
    jt._ckptr.wait()
    fresh = lm_init(cfg, torch.Generator().manual_seed(5), device="cpu")
    tr = _port_trainer(cfg, fresh, core.preset("bf16"), ckpt_dir=str(d))
    with pytest.warns(UserWarning, match="qcfg"):
        assert tr.restore()
    assert tr.step == 3 and tr.qcfg == core.preset("mxfp8_e4m3")
    want = _leaves(params_from_jax(jax.tree.map(np.asarray, jt.params), cfg,
                                   "cpu"))
    for path, t in tree_leaves_with_path(tr.params):
        np.testing.assert_array_equal(t.detach().numpy(), want[path].numpy())
    for key in ("m", "v"):
        want = _leaves(params_from_jax(
            jax.tree.map(np.asarray, jt.opt_state[key]), cfg, "cpu"))
        for path, t in tree_leaves_with_path(tr.opt_state[key]):
            np.testing.assert_array_equal(t.numpy(), want[path].numpy())
    assert int(tr.opt_state["count"]) == int(jt.opt_state["count"])


def test_checkpoint_written_by_port_restores_in_reference(smoke, tmp_path):
    jcfg, cfg, jparams, tree = smoke
    tr = _port_trainer(cfg, params_from_jax(tree, cfg, "cpu"),
                       core.preset("mxfp8_e4m3"), ckpt_dir=str(tmp_path))
    tr.run(2)
    tr.checkpoint()
    tr._ckptr.wait()
    jt = JTrainer(lambda p, b, q: jlm_loss(p, b, jcfg, q),
                  jlm_init(jax.random.PRNGKey(9), jcfg), jcore.preset("bf16"),
                  lambda s: None,
                  tcfg=JTrainerConfig(ckpt_dir=str(tmp_path)))
    with pytest.warns(UserWarning, match="qcfg"):
        assert jt.restore()
    assert jt.step == 2 and jt.qcfg == jcore.preset("mxfp8_e4m3")
    got = _leaves(params_from_jax(jax.tree.map(np.asarray, jt.params), cfg,
                                  "cpu"))
    for path, t in tree_leaves_with_path(tr.params):
        np.testing.assert_array_equal(got[path].numpy(), t.detach().numpy())
    want = params_to_jax(tr.opt_state["v"], cfg)
    np.testing.assert_array_equal(
        np.asarray(jt.opt_state["v"]["blocks"][0]["b0"]["mlp"]["w_up"]["w"]),
        want["blocks"][0]["b0"]["mlp"]["w_up"]["w"].numpy())


def test_checkpoint_format_is_the_references(tmp_path):
    from repro.train import checkpoint as jckpt
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": [{"c": torch.ones(3, 4, dtype=torch.bfloat16) * 1.5}]}
    save(str(tmp_path), 7, tree, {"note": "x"})
    z = np.load(tmp_path / "step_00000007.npz")
    assert sorted(z.files) == ["BF16::['b'][0]['c']", "['a']"]
    assert latest_step(str(tmp_path)) == 7
    out, meta, step = restore(str(tmp_path), tree)
    assert step == 7 and meta == {"note": "x"}
    assert out["b"][0]["c"].dtype == torch.bfloat16
    assert torch.equal(out["b"][0]["c"], tree["b"][0]["c"])
    jtree = {"a": jnp.zeros(10), "b": [{"c": jnp.zeros((3, 4),
                                                        jnp.bfloat16)}]}
    jout, jmeta, _ = jckpt.restore(str(tmp_path), jtree)
    assert float(jout["b"][0]["c"][0, 0]) == 1.5 and jmeta["note"] == "x"


def test_params_to_jax_inverts_params_from_jax(smoke):
    _, cfg, _, tree = smoke
    back = params_to_jax(params_from_jax(tree, cfg, "cpu"), cfg)
    want = _leaves(tree)
    got = _leaves(back)
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_array_equal(got[path].numpy(), want[path])


# ---- Trainer scenarios (tests/test_train.py), on the port -------------------
def _poisoned(cfg, poison_step, once=True, **tkw):
    params = lm_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    armed = {"spike": True}

    def batch_fn(step):
        b = lm_batch(step, cfg.vocab, 4, 32, device="cpu")
        hit = step == poison_step and (armed.pop("spike", False) or not once)
        b["poison"] = torch.tensor(1e6 if hit else 1.0)
        return b

    def loss_fn(p, b, q):
        loss, m = lm_loss(p, {"tokens": b["tokens"], "labels": b["labels"]},
                          cfg, q)
        return loss * b["poison"], m

    tcfg = TrainerConfig(peak_lr=1e-3, spike_factor=5.0,
                         auto_intervention="bf16_activations", **tkw)
    return Trainer(loss_fn, params, core.preset("mxfp8_e4m3"), batch_fn,
                   tcfg=tcfg)


def test_recovery_end_to_end_through_run_loop(tmp_path):
    cfg = get_config("olmo-paper", "smoke")
    tr = _poisoned(cfg, 12, total_steps=20, ckpt_dir=str(tmp_path),
                   ckpt_every=5)
    start = tr.qcfg.describe()
    tr.run(20)
    recs = tr.events.of_kind("recovery")
    assert len(recs) == 1
    rec = recs[0]
    assert rec["rolled_back"] is True and rec["step"] == 10
    assert "spike@step12" in rec["reason"]
    assert rec["from_qcfg"] == start
    assert rec["to_qcfg"] == tr.qcfg.describe() != start
    assert tr.qcfg.a_fwd is None and tr.qcfg.ln_fmt is None
    assert not tr.qcfg.attn
    assert tr.step == 20
    losses = [h["loss"] for h in tr.history]
    assert all(np.isfinite(losses))
    assert sum(x > 1e4 for x in losses) == 1
    seg = tr.events.of_kind("segment")
    assert len(seg) == 1 and seg[0]["reason"] == "recovery"


def test_bump_exponent_recovery_matches_reference(smoke, tmp_path):
    """The paper's Fig. 7 scale bump through the run loop: a batch poisoned
    at step 12 makes both Trainers roll back to the step-10 checkpoint and
    switch to scale_mode "bump"; the port then trains on under it with
    finite losses (on the card the kernels run the bump rule)."""
    jcfg, cfg, jparams, tree = smoke

    def batches(wrap):
        armed = {"spike": True}

        def batch_fn(step):
            b = dict(_np_batch(step, cfg.vocab))
            hit = step == 12 and armed.pop("spike", False)
            b["poison"] = np.float32(1e6 if hit else 1.0)
            return wrap(b)
        return batch_fn

    def jloss(p, b, q):
        loss, m = jlm_loss(p, {"tokens": b["tokens"], "labels": b["labels"]},
                           jcfg, q)
        return loss * b["poison"], m

    def loss(p, b, q):
        out, m = lm_loss(p, {"tokens": b["tokens"], "labels": b["labels"]},
                         cfg, q)
        return out * b["poison"], m

    kw = dict(total_steps=14, ckpt_every=5, peak_lr=1e-3, spike_factor=5.0,
              auto_intervention="bump_exponent")
    jt = JTrainer(jloss, jparams, jcore.preset("mxfp8_e4m3"),
                  batches(lambda b: jax.tree.map(jnp.asarray, b)),
                  tcfg=JTrainerConfig(ckpt_dir=str(tmp_path / "jax"), **kw))
    jt.run(14)
    tr = Trainer(loss, params_from_jax(tree, cfg, "cpu"),
                 core.preset("mxfp8_e4m3"),
                 batches(lambda b: {k: torch.from_numpy(np.asarray(v))
                                    .long() if k != "poison" else
                                    torch.tensor(v) for k, v in b.items()}),
                 tcfg=TrainerConfig(ckpt_dir=str(tmp_path / "port"), **kw),
                 ckpt_layout=lm_checkpoint_layout(cfg, "cpu"))
    tr.run(14)
    jrecs = [e for e in jt.events if e["event"] == "recovery"]
    recs = tr.events.of_kind("recovery")
    assert len(recs) == len(jrecs) == 1
    assert recs[0]["rolled_back"] is jrecs[0]["rolled_back"] is True
    assert recs[0]["step"] == jrecs[0]["step"] == 10
    assert "spike@step12" in recs[0]["reason"]
    assert tr.qcfg.describe() == jt.qcfg.describe()
    assert tr.qcfg.scale_mode == jt.qcfg.scale_mode == "bump"
    assert tr.qcfg == core.apply_intervention(core.preset("mxfp8_e4m3"),
                                              "bump_exponent")
    assert tr.step == jt.step == 14
    assert all(np.isfinite([h["loss"] for h in tr.history]))


def test_recovery_livelock_aborts_after_max_recoveries(tmp_path):
    cfg = get_config("olmo-paper", "smoke")
    tr = _poisoned(cfg, 12, once=False, total_steps=25,
                   ckpt_dir=str(tmp_path), ckpt_every=5, log_every=1,
                   max_recoveries=2)
    tr.run(25)
    assert len(tr.events.of_kind("recovery")) == 2
    assert tr.events[-1]["event"] == "recovery_exhausted"
    assert tr.events[-1]["recoveries"] == 2
    assert "spike@step12" in tr.events[-1]["reason"]
    assert tr.step < 25


def test_intervention_applies_without_checkpointer():
    cfg = get_config("olmo-paper", "smoke")
    tr = _poisoned(cfg, 5, total_steps=10, log_every=1)
    tr.run(10)
    recs = tr.events.of_kind("recovery")
    assert len(recs) == 1 and recs[0]["rolled_back"] is False
    assert tr.qcfg.a_fwd is None
    assert tr.step == 10


def _tiny(cfg, tmp_path):
    params = lm_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    return Trainer(lambda p, b, q: lm_loss(p, b, cfg, q), params,
                   core.preset("mxfp8_e4m3"),
                   lambda s: lm_batch(s, cfg.vocab, 4, 32, device="cpu"),
                   tcfg=TrainerConfig(total_steps=30, ckpt_dir=str(tmp_path),
                                      ckpt_every=5, peak_lr=1e-3,
                                      spike_factor=3.0),
                   ckpt_layout=lm_checkpoint_layout(cfg, "cpu"))


def test_qcfg_and_recoveries_survive_resume(tmp_path):
    cfg = get_config("olmo-paper", "smoke")
    t1 = _tiny(cfg, tmp_path)
    t1.run(6)
    assert t1.detector.update(1e9, None)
    t1._recover("test-injected")
    assert t1.qcfg.a_fwd is None
    t1.checkpoint()
    t1._ckptr.wait()
    t2 = _tiny(cfg, tmp_path)
    assert t2.qcfg.a_fwd is not None
    with pytest.warns(UserWarning, match="qcfg"):
        assert t2.restore()
    assert t2.qcfg == t1.qcfg
    assert t2._recoveries == 1
    assert t2.events.of_kind("qcfg_restored")
    t2.qcfg = core.preset("mxfp8_e4m3")
    assert t2.restore(adopt_meta=False)
    assert t2.qcfg == core.preset("mxfp8_e4m3")


def test_trainer_restore_resumes_exactly(tmp_path):
    cfg = get_config("olmo-paper", "smoke")
    t1 = _tiny(cfg, tmp_path)
    t1.run(10)
    t1.checkpoint()
    t1._ckptr.wait()
    cont = [r["loss"] for r in t1.run(3)][-3:]
    t2 = _tiny(cfg, tmp_path)
    assert t2.restore(step=10) and t2.step == 10
    assert [r["loss"] for r in t2.run(3)][-3:] == cont


def test_grad_accum_matches_full_batch():
    cfg = get_config("olmo-paper", "smoke")

    def make(accum):
        params = lm_init(cfg, torch.Generator().manual_seed(0), device="cpu")
        return Trainer(lambda p, b, q: lm_loss(p, b, cfg, q), params,
                       core.preset("bf16"),
                       lambda s: lm_batch(s, cfg.vocab, 8, 32, device="cpu"),
                       tcfg=TrainerConfig(total_steps=3, peak_lr=1e-3,
                                          log_every=1, grad_accum=accum))
    t1, t4 = make(1), make(4)
    h1, h4 = t1.run(3), t4.run(3)
    np.testing.assert_allclose([r["loss"] for r in h1],
                               [r["loss"] for r in h4], rtol=2e-4)
    for (_, a), (_, b) in zip(tree_leaves_with_path(t1.params),
                              tree_leaves_with_path(t4.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-2)


def test_run_zero_steps_is_noop():
    cfg = get_config("olmo-paper", "smoke")
    params = lm_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    tr = Trainer(lambda p, b, q: lm_loss(p, b, cfg, q), params,
                 core.preset("bf16"),
                 lambda s: lm_batch(s, cfg.vocab, 2, 16, device="cpu"),
                 tcfg=TrainerConfig(total_steps=2, log_every=1))
    before = {p: t.detach().clone()
              for p, t in tree_leaves_with_path(tr.params)}
    assert tr.run(0) == [] and tr.step == 0
    for p, t in tree_leaves_with_path(tr.params):
        assert torch.equal(t.detach(), before[p])
    tr.run(2)
    assert tr.step == 2 and len(tr.history) == 2


def test_unported_trainer_options_raise():
    cfg = get_config("olmo-paper", "smoke")
    params = lm_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    args = (lambda p, b, q: lm_loss(p, b, cfg, q), params,
            core.preset("bf16"), lambda s: None)
    # the online guard is ported: it builds a controller and monitors
    tr = Trainer(*args, tcfg=TrainerConfig(guard="autopilot"))
    assert tr._controller is not None
    assert tr._controller.policy.name == "autopilot"
    assert tr._controller.qcfg == core.preset("bf16")
    assert tr._mcfg is not None and tr._mcfg.probe_every == 25
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        Trainer(*args, tcfg=TrainerConfig(pod_compression="e4m3"))
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        Trainer(*args, mesh=object())


def test_lm_batch_is_learnable_and_step_indexed():
    b1 = lm_batch(5, 512, 4, 16, seed=3, device="cpu")
    b2 = lm_batch(5, 512, 4, 16, seed=3, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"],
                           lm_batch(6, 512, 4, 16, seed=3,
                                    device="cpu")["tokens"])
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    t = lm_batch(0, 512, 64, 64, noise=0.0, device="cpu")["tokens"]
    d = (t[:, 1:] - t[:, :-1]) % 512
    assert (d == d[:, :1]).float().mean() > 0.99


def test_train_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.launch import train as launch_train
    cfg = get_config("olmo-paper", "smoke")
    pcfg = proxy.ProxyConfig(d_model=64, n_layers=1, batch_size=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = torch.Generator().manual_seed(0)
    for call in (lambda: proxy.proxy_init(g, pcfg),
                 lambda: proxy.teacher_init(g, pcfg),
                 lambda: lm_batch(0, cfg.vocab, 2, 8),
                 lambda: launch_train.main(["--steps", "1"]),
                 lambda: lm_checkpoint_layout(cfg)[1](
                     {"params": {}, "opt": {}})):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    tr = launch_train.main(["--steps", "2", "--batch", "2", "--seq", "16",
                            "--device", "cpu", "--log-every", "1"])
    assert tr.step == 2 and str(tr.events[0]["device"]) == "cpu"


def test_runtime_bookkeeping_reads_the_references_meta(tmp_path):
    from repro.runtime import journal as jjournal
    from repro_torch.runtime import (Journal, MemoryBudgetError,
                                     MemoryLedger, MetricsWindow,
                                     SegmentTracker, checkpoint_meta,
                                     parse_checkpoint_meta)
    q0, q1 = core.preset("mxfp8_e4m3"), core.preset("e4m3_bf16act")
    ev = Journal()
    seg = SegmentTracker(q0, journal=ev)
    assert not seg.transition(3, q0) and seg.transition(5, q1, "recovery")
    assert seg.index == 1 and ev.last("segment")["to_qcfg"] == q1.describe()
    with pytest.raises(ValueError):
        ev.append({"step": 1})
    ev.emit("straggler", step=2)
    back = Journal.from_jsonl(ev.to_jsonl(str(tmp_path / "j.jsonl")))
    assert back == ev and len(back.of_kind("segment", "straggler")) == 2
    meta = checkpoint_meta(step=7, qcfg=q1, recoveries=2, segment_index=1)
    jmeta = jjournal.checkpoint_meta(step=7, qcfg=jcore.preset(
        "e4m3_bf16act"), recoveries=2, segment_index=1)
    assert meta == jmeta
    for m in (meta, jmeta):
        rm = parse_checkpoint_meta(m)
        assert (rm.step, rm.qcfg, rm.recoveries, rm.segment_index) == (
            7, q1, 2, 1)
    assert parse_checkpoint_meta(None).qcfg is None
    led = MemoryLedger(budget_bytes=1000, journal=ev, name="t")
    assert led.account("a", {"x": torch.zeros(100)}) == 400
    with pytest.raises(MemoryBudgetError, match="'b'"):
        led.account("b", nbytes=700)
    assert led.release("b") == 700 and led.total == 400
    assert ev.last("memory")["op"] == "release"
    win = MetricsWindow()
    win.push(0, {"loss": torch.tensor(2.5), "lr": torch.tensor(0.5)})
    win.push(1, {"loss": torch.tensor(1.5), "lr": 0.25})
    out = win.drain()
    assert [(s, m) for s, m, _ in out] == [(0, {"loss": 2.5, "lr": 0.5}),
                                          (1, {"loss": 1.5, "lr": 0.25})]
    assert not win and win.drain() == []
