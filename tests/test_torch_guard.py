"""The port's online guard and snapshot_to_serve against the JAX reference,
on the CPU.

Numpy inputs go to both packages: the in-step monitors step for step, the
autopilot scenario of ``tests/test_guard.py`` (the reference's proxy
init and batches, the deterministic instability injector), guard state in
checkpoint meta across packages, the recovery rebase, lm sweep runs under
a guard, and ``snapshot_to_serve``.

Tolerances, with their reasons:
  * Cheap monitor channels (loss EMAs, curvature, loss and grad-norm
    ratios): 1e-6 relative; both sides compute them in fp32 from the same
    floats, and XLA may fuse a multiply-add.  The probe channels are
    fractions of counted blocks (bitwise).  The ζ-bound and cosine are
    fp32 norms and dots over the ~25k flattened gradient values: within
    1e-5 relative of their fp64 values (3e-6 seen), and within 1e-4 of
    the reference's, whose XLA:CPU fp32 dot reads 2.8e-5 off the fp64
    cosine on these inputs.
  * A guarded LM Trainer step's ζ and cosine (smoke olmo-paper, 525,824
    gradient values, mxfp8_e4m3): within 1e-4 relative of their fp64
    values on the same gradients (2.7e-5 and 1.1e-5 seen); ζ within 1e-4
    relative of the reference monitor's on those gradients, cosine within
    2e-3 absolute (the reference's XLA:CPU fp32 dot reads 7.5e-4 off the
    fp64 cosine here).  Against the reference's own gradients, whose
    leaves differ from the port's by up to ``GRAD_REL`` of
    ``tests/test_torch_train.py``: ζ within 5% relative, cosine within
    5e-3 absolute (1.1% and 9.5e-4 seen).
  * Autopilot scenario losses before the first transition: within 1e-2
    absolute, the tolerance ``tests/test_torch_train.py`` holds three
    Trainer steps to under an MX preset (``LOSS_ATOL``); the first three
    steps within its proxy tolerance, 1e-5 relative.  Under MXFP4 an
    element whose cast lands on the other side of a rounding boundary
    moves the trajectory a little from then on: the two sides agree to
    1e-5 up to step 14, then drift to 8.3e-4 absolute (4.2e-3 relative)
    by step 23, where the injector has amplified the loss 1.6^3 times.
    The transition journal (step, kind, level) must be equal, and the
    port's replay of its own journal bitwise.
  * Checkpoint meta and journals: equal as JSON.
  * snapshot_to_serve: greedy tokens bitwise equal to an engine built from
    a checkpoint round trip of the same step.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import guard as jguard
from repro.core import preset as jpreset
from repro.models import proxy as jproxy
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro_torch import core, guard, sweep
from repro_torch.configs import get_config
from repro_torch.core.diagnostics import tree_leaves_with_path
from repro_torch.data import lm_batch
from repro_torch.guard import scenario
from repro_torch.models import lm_init, lm_loss, proxy
from repro_torch.runtime import Journal, snapshot_to_serve
from repro_torch.serve import SamplingParams
from repro_torch.train import Trainer, TrainerConfig

from benchmarks import guard_autopilot as jscenario

STEPS = 80
PROXY = dict(d_model=64, n_layers=2, batch_size=64)
GRAD_ZETA_REL = 0.05
GRAD_COS_ABS = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many small ops a step: one intra-op thread keeps them from
    spin-waiting on cores that the other test workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the monitors, step for step ------------------------------------------
def _monitor_inputs(n=12):
    """Per-step (loss, gnorm, grads, params, fp32 grads) from numpy: a
    NaN loss at step 6 and an inf grad norm at step 9."""
    rng = np.random.default_rng(3)
    shapes = {"layers": [{"ln": {"scale": (64,), "bias": (64,)},
                          "w1": {"w": (64, 96)}, "w2": {"w": (96, 64)}}
                         for _ in range(2)]}

    def tree(scale):
        return jax.tree.map(lambda s: (scale * rng.standard_normal(s))
                            .astype(np.float32), shapes,
                            is_leaf=lambda x: isinstance(x, tuple))
    out = []
    for s in range(n):
        loss = np.float32(2.0 - 0.05 * s + 0.1 * rng.standard_normal())
        gnorm = np.float32(1.0 + 0.2 * rng.standard_normal())
        if s == 6:
            loss = np.float32("nan")
        if s == 9:
            gnorm = np.float32("inf")
        params = tree(1.0)
        params["layers"][0]["ln"]["scale"] *= np.float32(40.0)
        grads = tree(1e-2)
        grads["layers"][1]["w1"]["w"][:, :4] *= np.float32(300.0)
        exact = jax.tree.map(
            lambda g: g + np.float32(3e-3) * rng.standard_normal(g.shape)
            .astype(np.float32), grads)
        out.append((loss, gnorm, grads, params, exact))
    return out


def _zeta64(exact, grads):
    ge, gq = (np.concatenate([x.reshape(-1).astype(np.float64)
                              for x in jax.tree.leaves(t)])
              for t in (exact, grads))
    gn = np.linalg.norm(ge)
    return {"zeta": np.linalg.norm(gq - ge) / gn,
            "cosine": gq @ ge / (np.linalg.norm(gq) * gn)}


def _tt(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_monitor_update_matches_reference_step_for_step():
    """Twelve steps of the in-step monitor under mxfp4_e2m1 with a probe
    every 4 steps: every signal against the reference's; the EMAs stay
    finite through the NaN loss and the inf grad norm; probe channels
    hold between probes while probe_age counts."""
    mcfg = guard.MonitorConfig(probe_every=4)
    jmcfg = jguard.MonitorConfig(probe_every=4)
    qcfg, jq = core.preset("mxfp4_e2m1"), jpreset("mxfp4_e2m1")
    st, jst = guard.monitor_init(mcfg, "cpu"), jguard.monitor_init(jmcfg)
    cheap = ("loss_ema_fast", "loss_ema_slow", "loss_curvature",
             "loss_ratio", "gnorm_ratio")
    @jax.jit
    def jupdate(st, step, loss, gnorm, g, p, exact):
        return jguard.monitor_update(jmcfg, st, step=step, loss=loss,
                                     gnorm=gnorm, grads=g, params=p,
                                     qcfg=jq, probe_fn=lambda: exact)
    ages, zetas = [], []
    for s, (loss, gnorm, g, p, exact) in enumerate(_monitor_inputs()):
        jst, jsig = jupdate(jst, s, loss, gnorm, g, p, exact)
        probed = None
        if guard.probe_due(mcfg, s):
            probed = guard.monitor_probe(mcfg, grads=_tt(g), params=_tt(p),
                                         qcfg=qcfg,
                                         probe_fn=lambda e=exact: _tt(e))
        st, sig = guard.monitor_update(
            mcfg, st, step=s, loss=torch.tensor(loss),
            gnorm=torch.tensor(gnorm), probed=probed)
        for name in guard.SIGNAL_NAMES:
            got = float(getattr(sig, name))
            want = float(getattr(jsig, name))
            if name in cheap and not np.isfinite(want):
                assert not np.isfinite(got), (s, name)
                continue
            if name in cheap:
                assert got == pytest.approx(want, rel=1e-6, abs=1e-30), (
                    s, name, got, want)
            elif name in ("zeta", "cosine"):
                assert got == pytest.approx(want, rel=1e-4), (s, name)
                if s % 4 == 0:
                    exact64 = _zeta64(exact, g)[name]
                    assert got == pytest.approx(exact64, rel=1e-5), (s, name)
            else:
                assert got == want, (s, name, got, want)
        assert torch.isfinite(st.ema_fast) and torch.isfinite(st.ema_slow)
        assert torch.isfinite(st.gnorm_ema)
        ages.append(float(sig.probe_age))
        zetas.append(float(sig.zeta))
    assert ages == [0, 1, 2, 3] * 3
    assert zetas[0] > 0 and zetas[0] == zetas[1] == zetas[2] == zetas[3]
    assert zetas[4] != zetas[0] and zetas[4] == zetas[7]
    assert float(sig.ln_last_bin) > 0 and float(sig.grad_overflow) > 0


def test_ema_never_poisoned_by_nonfinite():
    mcfg = guard.MonitorConfig(probe_every=0)
    st = guard.monitor_init(mcfg, "cpu")
    for loss in (1.0, 1.0, float("nan"), 1.0):
        st, _ = guard.monitor_update(mcfg, st, step=0,
                                     loss=torch.tensor(loss),
                                     gnorm=torch.tensor(1.0))
    assert float(st.ema_fast) == pytest.approx(1.0)


# ---- the autopilot scenario ------------------------------------------------
@pytest.fixture(scope="module")
def reference_scenario(tmp_path_factory):
    """The reference's scenario (tests/test_guard.py:191): its proxy init
    and batches as numpy, and its autopilot run (``_trainer``'s settings,
    checkpointed every 10 steps) with its losses and journal."""
    jcfg, jparams, loss_fn, batch_fn = jscenario._scenario(STEPS)
    teacher = jproxy.teacher_init(jax.random.PRNGKey(1), jcfg)
    batches = [tuple(np.array(a) for a in jproxy.proxy_batch(
        s, teacher, jcfg)) for s in range(STEPS)]
    init = jax.tree.map(np.array, jparams)   # the step donates jparams
    ckpt_dir = str(tmp_path_factory.mktemp("jax_guard"))
    tcfg = JTrainerConfig(total_steps=STEPS, peak_lr=1e-3, log_every=1,
                          spike_factor=8.0, auto_intervention=None,
                          max_recoveries=2, guard=jscenario._trend_policy(),
                          guard_probe_every=5, ckpt_dir=ckpt_dir,
                          ckpt_every=10, keep_ckpts=STEPS // 10)
    auto = JTrainer(loss_fn=loss_fn, params=jparams,
                    qcfg=jpreset("mxfp4_e2m1"), batch_fn=batch_fn, tcfg=tcfg)
    hist = auto.run(STEPS)
    auto._ckptr.wait()
    return {"params": init,
            "batches": batches, "losses": [h["loss"] for h in hist],
            "journal": [dict(t) for t in auto._controller.journal],
            "ckpt_dir": ckpt_dir}


def _proxy_loss(cfg):
    return scenario.inject_instability(
        lambda p, b, q: proxy.proxy_loss(p, (b["x"], b["y"]), cfg, q))


def _port_trainer(ref, guard_policy=None, probe=5, loss_fn=None, **kw):
    cfg = proxy.ProxyConfig(**PROXY)

    def batch_fn(s):
        x, y = ref["batches"][s]
        return {"x": torch.from_numpy(x), "y": torch.from_numpy(y),
                "step": s}
    tcfg = dict(total_steps=STEPS, peak_lr=1e-3, log_every=1,
                spike_factor=8.0, auto_intervention=None, max_recoveries=2,
                guard=guard_policy, guard_probe_every=probe)
    tcfg.update(kw)
    return Trainer(loss_fn or _proxy_loss(cfg), _tt(ref["params"]),
                   core.preset("mxfp4_e2m1"), batch_fn,
                   tcfg=TrainerConfig(**tcfg))


@pytest.fixture(scope="module")
def port_autopilot(reference_scenario):
    tr = _port_trainer(reference_scenario, scenario.trend_policy())
    return tr, tr.run(STEPS)


def test_scenario_matches_the_references():
    """The port's copy of the injector and the trend policy are the
    reference's."""
    assert scenario.trend_policy().to_dict() == \
        jscenario._trend_policy().to_dict()
    assert (scenario.ONSET, scenario.END, scenario.RAMP) == (
        jscenario.ONSET, jscenario.END, jscenario.RAMP)
    assert (scenario.MONITOR_OVERHEAD_MAX,
            scenario.DEESCALATE_RECOVERY_MAX) == (
        jscenario.MONITOR_OVERHEAD_MAX, jscenario.DEESCALATE_RECOVERY_MAX)
    for s in range(STEPS):
        want = jnp.where((s >= 20) & (s < 40), jscenario.RAMP ** jnp.clip(
            jnp.float32(s) - 20, 0, 20), 1.0)
        assert scenario.injected_amp(s) == pytest.approx(float(want),
                                                         rel=1e-6)


def test_autopilot_journal_matches_reference_and_replays_bitwise(
        reference_scenario, port_autopilot, tmp_path):
    """Acceptance (tests/test_guard.py:191) on the port: the autopilot
    escalates before the watchdog and de-escalates, with the reference's
    (step, kind, level) journal; replaying the journaled schedule gives
    bitwise equal losses."""
    ref = reference_scenario
    auto, h1 = port_autopilot
    events = [e["event"] for e in auto.events]
    assert "recovery" not in events and "recovery_exhausted" not in events
    assert len(h1) == STEPS
    journal = auto._controller.journal
    key = [(t["step"], t["kind"], t["to_level"]) for t in journal]
    assert key == [(t["step"], t["kind"], t["to_level"])
                   for t in ref["journal"]]
    assert {"escalate", "deescalate"} <= {k for _, k, _ in key}
    assert [dict(t) for t in journal] == auto.events.of_kind(
        "guard_transition")
    first = journal[0]["step"]
    losses = [h["loss"] for h in h1]
    np.testing.assert_allclose(losses[:3], ref["losses"][:3], rtol=1e-5)
    np.testing.assert_allclose(losses[:first], ref["losses"][:first],
                               rtol=0, atol=1e-2)
    pol = guard.scheduled_policy(auto._controller.schedule(),
                                 ladder=auto._controller.policy.ladder)
    replay = _port_trainer(ref, pol)
    assert replay._mcfg is None          # a schedule needs no monitors
    h2 = replay.run(STEPS)
    assert [r["loss"] for r in h2] == [r["loss"] for r in h1]   # bitwise
    assert [(t["step"], t["to_level"]) for t in replay._controller.journal
            ] == [(t["step"], t["to_level"]) for t in journal]
    assert replay.qcfg == auto.qcfg
    start = auto.events.of_kind("run_start")[0]
    assert start["guard"] == "trend"
    back = Journal.from_jsonl(journal.to_jsonl(str(tmp_path / "g.jsonl")))
    assert back == journal


def test_fixed_scheme_exhausts_its_recoveries(reference_scenario,
                                             tmp_path):
    """Without the guard the injected spike rolls back, recurs and
    exhausts max_recoveries, as in the reference."""
    fixed = _port_trainer(reference_scenario, None,
                          ckpt_dir=str(tmp_path), ckpt_every=10)
    fixed.run(STEPS)
    assert fixed.events[-1]["event"] == "recovery_exhausted"
    assert fixed.step < STEPS
    assert len(fixed.events.of_kind("recovery")) == 2


def test_probe_runs_before_the_update_on_probe_steps_only(
        reference_scenario):
    """With a probe stride of 5 the fp32 backward runs on steps 0, 5 and
    10 of 12, and reads the weights the step trained with (before the
    in-place AdamW update); the same run with probes off runs none."""
    cfg = proxy.ProxyConfig(**PROXY)
    base = _proxy_loss(cfg)
    for probe, want in ((5, [0, 5, 10]), (0, [])):
        seen = []

        def loss_fn(p, b, q):
            if q == q.to_fp32():
                seen.append((b["step"],
                             p["layers"][0]["w1"]["w"].detach().clone()))
            return base(p, b, q)
        tr = _port_trainer(reference_scenario, scenario.trend_policy(),
                           probe=probe, loss_fn=loss_fn)
        before = {}
        orig = tr.batch_fn

        def batch_fn(s):
            before[s] = tr.params["layers"][0]["w1"]["w"].detach().clone()
            return orig(s)
        tr.batch_fn = batch_fn
        tr.run(12)
        assert [s for s, _ in seen] == want
        for s, w in seen:
            assert torch.equal(w, before[s])
            assert not torch.equal(w, tr.params["layers"][0]["w1"]["w"])
        assert all("guard_zeta" in h for h in tr.history)


def test_guard_state_survives_resume(reference_scenario, tmp_path):
    """The port's own checkpoint mid-escalation: a fresh trainer restores
    the controller's level, journal and qcfg (guard_restored)."""
    def make():
        return _port_trainer(reference_scenario, scenario.trend_policy(),
                             total_steps=40, ckpt_dir=str(tmp_path),
                             ckpt_every=10, spike_factor=10.0)
    t1 = make()
    t1.run(30)
    t1._ckptr.wait()
    assert t1._controller.journal
    t2 = make()
    assert t2._controller.level == 0
    with pytest.warns(UserWarning, match="qcfg"):
        assert t2.restore()
    assert t2.events.of_kind("guard_restored")
    assert t2._controller.level == t1._controller.level > 0
    assert t2._controller.journal == t1._controller.journal
    assert t2.qcfg == t1.qcfg == t2._controller.qcfg


def test_reference_guard_checkpoint_restores_in_port(reference_scenario):
    """The reference's step-30 checkpoint, written mid-escalation, restores
    the controller's whole state (level, counters, journal) and qcfg."""
    d = reference_scenario["ckpt_dir"]
    with open(f"{d}/step_00000030.json") as f:
        meta = json.load(f)
    assert meta["guard"]["state"]["level"] > 0
    tr = _port_trainer(reference_scenario, scenario.trend_policy(),
                       ckpt_dir=d)
    with pytest.warns(UserWarning, match="qcfg"):
        assert tr.restore(30)
    assert tr.step == 30
    assert tr.events.of_kind("guard_restored")[0]["level"] == \
        meta["guard"]["state"]["level"]
    assert json.loads(json.dumps(tr._controller.state_dict())) == \
        meta["guard"]
    assert tr.qcfg.describe() == meta["qcfg"]


def test_port_guard_checkpoint_restores_in_reference(
        reference_scenario, tmp_path):
    tr = _port_trainer(reference_scenario, scenario.trend_policy(),
                       total_steps=40, ckpt_dir=str(tmp_path), ckpt_every=10,
                       spike_factor=10.0)
    tr.run(30)
    tr._ckptr.wait()
    assert tr._controller.level > 0
    _, params, loss_fn, batch_fn = jscenario._scenario(40)
    jt = JTrainer(loss_fn=loss_fn, params=params,
                  qcfg=jpreset("mxfp4_e2m1"), batch_fn=batch_fn,
                  tcfg=JTrainerConfig(total_steps=40, ckpt_dir=str(tmp_path),
                                      guard=jscenario._trend_policy()))
    with pytest.warns(UserWarning, match="qcfg"):
        assert jt.restore()
    assert jt._controller.level == tr._controller.level
    assert [dict(t) for t in jt._controller.journal] == \
        [dict(t) for t in tr._controller.journal]
    assert jt.qcfg.describe() == tr.qcfg.describe()


def test_pre_guard_checkpoint_rebases_the_controller(reference_scenario,
                                                     tmp_path):
    """A checkpoint without guard state written under another scheme
    becomes the controller's baseline on restore."""
    t0 = _port_trainer(reference_scenario, None, ckpt_dir=str(tmp_path),
                       ckpt_every=100)
    t0.qcfg = core.preset("mxfp4_e2m1").with_bf16_activations()
    t0.run(2)
    t0._ckptr.wait()
    tr = _port_trainer(reference_scenario, scenario.trend_policy(),
                       ckpt_dir=str(tmp_path))
    with pytest.warns(UserWarning, match="qcfg"):
        assert tr.restore()
    assert not tr.events.of_kind("guard_restored")
    assert tr._controller.base == tr.qcfg and tr._controller.level == 0


def test_recovery_rebases_controller(reference_scenario):
    """tests/test_guard.py:397 on the port: after a recovery the
    controller's level 0 is the recovered scheme, and a calm stretch never
    de-escalates below it."""
    deaf = guard.GuardPolicy(name="deaf",
                             rules=(guard.Rule("gnorm_ratio", 1e9,
                                               calm=1.0),),
                             cooldown=2, stability_window=3)
    tr = _port_trainer(reference_scenario, deaf, probe=0, spike_factor=5.0,
                       max_recoveries=3,
                       auto_intervention="bf16_activations")
    tr.run(5)
    assert tr.detector.update(1e9, None)
    tr._recover("test-injected")
    assert tr.qcfg.a_fwd is None
    assert tr._controller.base == tr.qcfg and tr._controller.level == 0
    assert int(tr._mstate.count) == 0        # the monitors restarted
    tr.run(10)
    assert tr.qcfg.a_fwd is None and not tr._controller.journal


# ---- lm sweep runs under a guard -------------------------------------------
def test_sweep_lm_run_uses_real_autopilot():
    """tests/test_guard.py:373 on the port: a scheduled guard on an lm
    run makes real transitions with the reference's journal; an online
    policy runs through the Trainer's autopilot with probes; an online
    guard with phases is refused."""
    from repro import sweep as jsweep
    r = sweep.RunSpec(kind="lm", arch="olmo", lm_size=1, lm_vocab=64,
                      lm_batch=2, lm_seq=16, steps=8, lr=1e-3,
                      scheme="mxfp4_e2m1", guard="sched:4=bf16_activations")
    res = sweep.run_sweep([r], device="cpu")[r.run_id]
    assert res.steps == 8 and not res.guard_advisory
    assert [t["kind"] for t in res.guard_journal] == ["scheduled"]
    assert res.guard_trigger_step == 4
    jr = jsweep.RunSpec(**dataclasses.asdict(r))
    assert jr.run_id == r.run_id
    from repro.sweep.executor import _scheduled_journal
    assert res.guard_journal == _scheduled_journal(jr)

    online = dataclasses.replace(r, guard="aggressive",
                                 guard_probe_every=3)
    res = sweep.run_sweep([online], device="cpu",
                          keep_history=True)[online.run_id]
    assert res.steps == 8 and not res.guard_advisory
    assert all(np.isfinite(res.history["loss"]))
    for t in res.guard_journal:
        assert t["event"] == "guard_transition"
    bad = dataclasses.replace(r, guard="aggressive", phases=((2, "fp32"),))
    with pytest.raises(ValueError, match="online guard"):
        sweep.run_sweep([bad], device="cpu")


def test_lm_probes_read_the_references_layout():
    """The LM's probes read the reference's stacked layout (the Trainer's
    ``ckpt_layout``): the clamp and overflow channels of the port's tree
    through it equal the reference's on the same weights."""
    from repro.guard.monitors import _grad_overflow, _ln_clamp_means
    from repro_torch.convert import lm_checkpoint_layout, params_from_jax
    cfg = get_config("olmo-paper", "smoke")
    rng = np.random.default_rng(0)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, a: a * (1 + rng.standard_normal(a.shape)
                             .astype(np.float32))
        if "ln" in jax.tree_util.keystr(path) else a, _reference_lm(cfg))
    grads = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 1e-3)
                         .astype(np.float32), jparams)
    q, jq = core.preset("mxfp8_e4m3"), jpreset("mxfp8_e4m3")
    to_ref, _ = lm_checkpoint_layout(cfg, "cpu")

    def view(tree):
        return to_ref({"params": params_from_jax(tree, cfg, "cpu"),
                       "opt": {}})["params"]
    lt, lb, ovf, _, _ = guard.monitor_probe(
        guard.MonitorConfig(probe_every=1), grads=view(grads),
        params=view(jparams), qcfg=q)
    jlt, jlb = _ln_clamp_means(jax.tree.map(jnp.asarray, jparams), jq, "ln")
    jovf = _grad_overflow(jax.tree.map(jnp.asarray, grads), jq, 8)
    assert float(lb) > 0 and float(ovf) > 0
    assert float(lt) == float(jlt)
    assert float(lb) == pytest.approx(float(jlb), rel=1e-6)
    assert float(ovf) == pytest.approx(float(jovf), rel=1e-6)


def test_lm_trainer_probe_matches_reference_monitor():
    """A guarded LM Trainer step with the reference's checkpoint layout,
    a probe on step 0: its ζ, cosine, clamp and overflow channels equal
    the reference's ``monitor_update`` on the same weights and batch, fed
    (a) the port's own MX and fp32 gradients in the reference's layout
    and (b) the reference's own gradients (tolerances in the module
    docstring).  A probe that paired the fp32 and MX elements in two
    layouts would read ζ near √2 and cosine near 0."""
    from repro.configs import get_config as jget_config
    from repro.models import lm_loss as jlm_loss
    from repro_torch.convert import (lm_checkpoint_layout, params_from_jax,
                                     params_to_jax)
    cfg, jcfg = (get_config("olmo-paper", "smoke"),
                 jget_config("olmo-paper", "smoke"))
    tree = _reference_lm(cfg)
    q, jq = core.preset("mxfp8_e4m3"), jpreset("mxfp8_e4m3")
    batch = lm_batch(0, cfg.vocab, 2, 32, device="cpu")

    def port_grads(qq):
        p = params_from_jax(tree, cfg, "cpu")
        for _, t in tree_leaves_with_path(p):
            t.requires_grad_(True)
        lm_loss(p, batch, cfg, qq)[0].backward()
        g = jax.tree.map(lambda t: t.grad, p)
        return jax.tree.map(lambda t: t.float().numpy(),
                            params_to_jax(g, cfg))

    tr = Trainer(lambda p, b, qq: lm_loss(p, b, cfg, qq),
                 params_from_jax(tree, cfg, "cpu"), q, lambda s: batch,
                 tcfg=TrainerConfig(total_steps=4, log_every=1,
                                    guard="autopilot", guard_probe_every=1),
                 ckpt_layout=lm_checkpoint_layout(cfg, "cpu"))
    tr.run(1)
    st = tr._mstate
    got = {"zeta": float(st.zeta), "cosine": float(st.cosine),
           "ln_tight_frac": float(st.ln_tight),
           "ln_last_bin": float(st.ln_last),
           "grad_overflow": float(st.g_ovf)}
    assert tr.history[0]["guard_zeta"] == got["zeta"]

    mx, exact = port_grads(q), port_grads(q.to_fp32())
    jbatch = {k: jnp.asarray(v.numpy().astype(np.int32))
              for k, v in batch.items()}

    def reference(grads, fp32):
        jmcfg = jguard.MonitorConfig(probe_every=1)
        _, sig = jguard.monitor_update(
            jmcfg, jguard.monitor_init(jmcfg), step=0, loss=1.0, gnorm=1.0,
            grads=grads, params=jax.tree.map(jnp.asarray, tree), qcfg=jq,
            probe_fn=lambda: fp32)
        return {k: float(getattr(sig, k)) for k in got}
    want = reference(mx, exact)
    z64 = _zeta64(exact, mx)
    assert 0 < got["zeta"] < 0.5 and got["cosine"] > 0.9, got
    for k in ("zeta", "cosine"):
        assert got[k] == pytest.approx(z64[k], rel=1e-4), (k, got, z64)
    assert got["zeta"] == pytest.approx(want["zeta"], rel=1e-4)
    assert got["cosine"] == pytest.approx(want["cosine"], abs=2e-3)
    assert got["ln_tight_frac"] == want["ln_tight_frac"]
    for k in ("ln_last_bin", "grad_overflow"):
        assert got[k] == pytest.approx(want[k], rel=1e-6), (k, got, want)

    def jgrads(qq):
        return jax.jit(jax.grad(lambda p: jlm_loss(p, jbatch, jcfg, qq)[0])
                       )(jax.tree.map(jnp.asarray, tree))
    own = reference(jgrads(jq), jgrads(jq.to_fp32()))
    assert got["zeta"] == pytest.approx(own["zeta"], rel=GRAD_ZETA_REL)
    assert got["cosine"] == pytest.approx(own["cosine"], abs=GRAD_COS_ABS)


def _reference_lm(cfg):
    """A smoke LM in the reference's layout, as numpy (the port's init,
    through ``params_to_jax``; no JAX init to compile)."""
    from repro_torch.convert import params_to_jax
    tree = params_to_jax(lm_init(cfg, torch.Generator().manual_seed(0),
                                 device="cpu"), cfg)
    return jax.tree.map(lambda t: t.float().numpy(), tree)


# ---- snapshot_to_serve -----------------------------------------------------
def _greedy(engine, prompts, n_new=6):
    rids = [engine.submit(p, SamplingParams(temperature=0.0,
                                            max_new_tokens=n_new))
            for p in prompts]
    done = {r.rid: r for r in engine.drain()}
    return [list(done[rid].tokens) for rid in rids]


@pytest.mark.parametrize("paged", [False, True])
def test_snapshot_to_serve_matches_checkpoint_round_trip(tmp_path, paged):
    """The snapshot engine's greedy tokens are bitwise those of an engine
    built from a checkpoint round trip of the same step, and stay so after
    three more training steps; no engine tensor shares storage with a
    trainer tensor; the journal record has the reference's keys."""
    from repro_torch.convert import lm_checkpoint_layout
    from repro_torch.serve import PagedServeEngine, ServeEngine
    cfg = get_config("olmo-paper", "smoke")
    q = core.preset("mxfp8_e4m3")

    def make(seed, ckpt_dir):
        return Trainer(lambda p, b, qq: lm_loss(p, b, cfg, qq),
                       lm_init(cfg, torch.Generator().manual_seed(seed),
                               device="cpu"), q,
                       lambda s: lm_batch(s, cfg.vocab, 2, 32,
                                          device="cpu"),
                       tcfg=TrainerConfig(total_steps=10, peak_lr=1e-3,
                                          log_every=1, ckpt_dir=ckpt_dir,
                                          ckpt_every=100),
                       ckpt_layout=lm_checkpoint_layout(cfg, "cpu"))
    tr = make(0, str(tmp_path))
    tr.run(2)
    kw = dict(max_batch=2, max_len=64)
    if paged:
        kw.update(n_pages=8, page_size=32)
    eng = snapshot_to_serve(tr, cfg, paged=paged, **kw)
    assert isinstance(eng, PagedServeEngine if paged else ServeEngine)
    prompts = [np.arange(1, 9) % cfg.vocab, np.arange(5, 25) % cfg.vocab]
    live = _greedy(eng, prompts)
    tr.checkpoint()
    tr._ckptr.wait()
    t2 = make(7, str(tmp_path))
    assert t2.restore() and t2.step == 2
    kind = PagedServeEngine if paged else ServeEngine
    ck_eng = kind(t2.params, cfg, t2.qcfg, device="cpu", **kw)
    assert _greedy(ck_eng, prompts) == live
    ck_w = dict(tree_leaves_with_path(ck_eng.params))
    for path, t in tree_leaves_with_path(eng.params):
        assert torch.equal(t, ck_w[path]), path
    storages = {t.untyped_storage().data_ptr()
                for _, t in tree_leaves_with_path(tr.params)}
    assert not storages & {t.untyped_storage().data_ptr()
                           for _, t in tree_leaves_with_path(eng.params)}
    tr.run(3)
    assert _greedy(eng, prompts) == live
    rec = tr.events.of_kind("snapshot_to_serve")[0]
    assert set(rec) == set(_reference_snapshot_record(paged))
    assert (rec["step"], rec["paged"], rec["qcfg"]) == (2, paged,
                                                       q.describe())


def _reference_snapshot_record(paged):
    from repro.configs import get_config as jget_config
    from repro.runtime import snapshot_to_serve as jsnapshot
    jcfg = jget_config("olmo-paper", "smoke")
    jt = JTrainer(lambda p, b, q: (jnp.float32(0), {}),
                  jax.tree.map(jnp.asarray, _reference_lm(
                      get_config("olmo-paper", "smoke"))),
                  jpreset("mxfp8_e4m3"), lambda s: None)
    kw = dict(n_pages=8, page_size=32) if paged else {}
    jsnapshot(jt, jcfg, paged=paged, max_batch=2, max_len=64, **kw)
    return jt.events[-1]
