"""The port's sweeps against the JAX reference, on the CPU.

Numpy inputs go to both packages.  What must be equal is held equal: the
run ids, labels and pack signatures of every preset (so one RunDB resumes
in either package), SweepSpec JSON and RunDB rows read across packages,
``plan_segments``, the per-lane spike flags, the advisory guard journals
and host signals, and the aggregate tables.  The "bmm" contraction and
three lane-packed proxy steps are held to the tolerance of
``tests/test_torch_train.py``'s proxy test (1e-5 relative): the two sides
sum fp32 products in other orders.  Port-packed against port-sequential
runs are held to the reference's own bound for its packed against
standalone runs (rtol 2e-4, atol 1e-7, ``tests/test_sweep.py``), since a
one-lane pack's reductions may sum in another order than an 8-lane pack's.
"""
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis import given, settings, strategies as st

from repro import core as jcore
from repro import guard as jguard
from repro import sweep as jsweep
from repro.models import proxy as jproxy
from repro.optim import adamw as jadamw
from repro.runtime import plan_segments as jplan_segments
from repro_torch import core, guard
from repro_torch import sweep
from repro_torch.core.diagnostics import tree_leaves_with_path
from repro_torch.models import proxy
from repro_torch.optim import adamw
from repro_torch.runtime import plan_segments

ROOT = Path(__file__).resolve().parents[1]
BUDGETS = ("quick", "full")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The sweep tests run many small ops (a pack step is hundreds): one
    intra-op thread keeps them from spin-waiting on cores that the other
    test workers hold, and costs little alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _preset_specs(budget):
    """Every preset's specs at ``budget``, the fig7 pair included."""
    out = []
    for name in sorted(sweep.SWEEP_PRESETS):
        specs = sweep.get_sweep_spec(name, budget)
        jspecs = jsweep.get_sweep_spec(name, budget)
        out += list(zip(specs if isinstance(specs, list) else [specs],
                        jspecs if isinstance(jspecs, list) else [jspecs]))
    from repro.sweep import presets as jp
    from repro_torch.sweep import presets as tp
    out.append((tp.fig7_base_spec(budget), jp.fig7_base_spec(budget)))
    out.append((tp.fig7_intervention_spec(budget, 37, 90),
                jp.fig7_intervention_spec(budget, 37, 90)))
    return out


def _ids(runs, mod):
    return [(r.run_id, mod.group_key(r), r.label, r.to_dict())
            for r in runs]


@pytest.mark.parametrize("budget", BUDGETS)
def test_every_preset_run_has_the_references_id(budget):
    n = 0
    for spec, jspec in _preset_specs(budget):
        got = _ids(spec.expand(), sweep)
        want = _ids(jspec.expand(), jsweep)
        assert got == want, spec.name
        n += len(got)
    assert n > 50


@pytest.mark.parametrize("budget", BUDGETS)
def test_sweep_spec_json_reads_across_packages(budget):
    for spec, jspec in _preset_specs(budget):
        there = jsweep.SweepSpec.from_json(spec.to_json()).expand()
        here = sweep.SweepSpec.from_json(jspec.to_json()).expand()
        assert [r.run_id for r in here] == [r.run_id for r in there] \
            == [r.run_id for r in spec.expand()]


def test_run_db_reads_across_packages_newest_row_winning(tmp_path):
    r = sweep.RunSpec(scheme="mxfp4_e2m1", seed=3, steps=7)
    jr = jsweep.RunSpec.from_dict(r.to_dict())
    assert r.run_id == jr.run_id
    for writer, reader, spec in ((sweep.RunDB, jsweep.RunDB, r),
                                 (jsweep.RunDB, sweep.RunDB, jr)):
        path = str(tmp_path / f"{writer.__module__}.jsonl")
        with writer(path) as db:
            db.append(spec.run_id, spec, {"final_loss": 1.0})
            db.append(spec.run_id, spec, {"final_loss": 2.0})
        other = reader(path)
        assert len(other) == 1 and spec.run_id in other
        assert other.get(spec.run_id)["result"]["final_loss"] == 2.0
        assert other.specs()[0].run_id == spec.run_id
        other.close()


PLANS = [
    ((), ""),
    (((100, "fp32"),), ""),
    (((50, "bf16_activations"), (120, "skip_ln_quant")), ""),
    (((0, "bump_exponent"), (300, "fp32")), ""),   # clipped to [0, steps]
    ((), "sched:40=bf16_activations,120=0"),
    ((), "sched:30=2,90=1,150=bump_exponent"),
    (((60, "adaptive_scale"),), "sched:60=1"),      # coincident switches
    (((80, "no_bwd_quant"),), "autopilot"),         # online: no split
]


@pytest.mark.parametrize("scheme", ["mxfp4_e2m1", "mxfp8_e4m3"])
@pytest.mark.parametrize("phases,guard_spec", PLANS)
def test_plan_segments_match_reference(phases, guard_spec, scheme):
    got = plan_segments(200, core.preset(scheme), phases, guard_spec)
    want = jplan_segments(200, jcore.preset(scheme), phases, guard_spec)
    assert [(s.start, s.end, s.qcfg.describe()) for s in got] == \
        [(s.start, s.end, s.qcfg.describe()) for s in want]


_value = st.one_of(st.floats(2.0 ** -7, 8.0, width=32),
                   st.sampled_from([float("nan"), float("inf"), 1e4, 500.0]))


@settings(max_examples=40, deadline=None, derandomize=True)
@given(st.integers(1, 4).flatmap(lambda lanes: st.tuples(
    st.just(lanes), st.lists(st.lists(_value, min_size=lanes,
                                      max_size=lanes),
                             min_size=1, max_size=40))),
       st.booleans())
def test_batched_spike_detector_matches_reference(data, with_gnorm):
    lanes, rows = data
    losses = np.asarray(rows, np.float64).T           # (lanes, steps)
    gnorms = losses[::-1] * 3.0 if with_gnorm else None
    kw = dict(spike_factor=10.0, grad_factor=5.0, window=8)
    got = core.BatchedSpikeDetector.flags(losses, gnorms, **kw)
    want = jcore.BatchedSpikeDetector.flags(losses, gnorms, **kw)
    assert got.shape == losses.shape
    assert np.array_equal(got, want)


def _histories(lanes=4, steps=120, seed=0):
    rng = np.random.default_rng(seed)
    losses = np.exp(-np.linspace(0, 2, steps))[None] * (
        1 + 0.05 * rng.standard_normal((lanes, steps)))
    gnorms = 1 + 0.1 * rng.standard_normal((lanes, steps))
    losses[1, 60:64] *= 8.0          # a spike
    gnorms[2, 30] = 40.0             # a grad-norm excursion
    losses[3, 100] = np.nan          # a non-finite step
    return losses, gnorms


@pytest.mark.parametrize("policy", ["autopilot", "aggressive",
                                    "conservative"])
def test_advisory_journals_and_host_signals_match_reference(policy):
    losses, gnorms = _histories()
    got = guard.host_signals(losses, gnorms)
    want = jguard.host_signals(losses, gnorms)
    assert sorted(got) == sorted(want)
    for k in got:
        assert np.array_equal(got[k], want[k], equal_nan=True), k
    j_got = guard.advisory_journals(losses, gnorms, guard.get_policy(policy),
                                    core.preset("mxfp4_e2m1"))
    j_want = jguard.advisory_journals(losses, gnorms,
                                      jguard.get_policy(policy),
                                      jcore.preset("mxfp4_e2m1"))
    assert [list(j) for j in j_got] == [list(j) for j in j_want]
    assert any(j_got)


def test_aggregate_and_format_table_match_reference():
    rng = np.random.default_rng(1)
    rows = []
    for i in range(12):
        r = sweep.RunSpec(scheme=("bf16", "mxfp4_e2m1")[i % 2], seed=i,
                          label=f"cell{i % 3}")
        journal = ([{"event": "guard_transition", "kind": "escalate",
                     "step": int(rng.integers(10, 90))}] if i % 4 == 0
                   else [])
        res = {"label": r.label, "scheme": r.scheme, "seed": r.seed,
               "lr": r.lr, "steps": 20,
               "final_loss": float("nan") if i == 5 else float(rng.random()),
               "tail_mean": float(rng.random()),
               "min_loss": float(rng.random()),
               "max_gnorm": float(rng.random() * 10),
               "spikes": int(rng.integers(0, 3)), "divergent": i == 5,
               "diverge_step": 12 if i == 5 else -1,
               "us_per_step": float(rng.random() * 1e3),
               "guard_journal": journal,
               "guard_trigger_step": journal[0]["step"] if journal else -1,
               "guard_advisory": i % 8 == 0}
        rows.append({"run_id": r.run_id, "spec": r.to_dict(),
                     "result": res})
    for by in ("label", "scheme", "seed"):
        got = sweep.aggregate(rows, by=by)
        want = jsweep.aggregate(rows, by=by)
        assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                             sort_keys=True)
        assert sweep.format_table(got) == jsweep.format_table(want)


# ---------------------------------------------------------------------------
# The "bmm" contraction and lane-stacked proxy math.
# ---------------------------------------------------------------------------
def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("lead", [(), (2,)])
@pytest.mark.parametrize("name", ["bf16", "mxfp8_e4m3", "mxfp4_e2m1",
                                  "mx_mix", "e2m1_bf16act"])
def test_bmm_kind_matches_reference(name, lead):
    """lhs (..., E, T, K) @ rhs (E, K, N) in fp32: the forward and both
    gradients against the reference's "bmm" (jax.vjp)."""
    rng = np.random.default_rng(len(name) + len(lead))
    E, T, K, N = 3, 64, 96, 40
    x = rng.standard_normal(lead + (E, T, K)).astype(np.float32)
    w = (rng.standard_normal((E, K, N)) / 10).astype(np.float32)
    dy = (rng.standard_normal(lead + (E, T, N)) * 1e-2).astype(np.float32)
    y, vjp = jax.vjp(lambda a, b: jcore.mx_contract(
        a, b, jcore.preset(name), kind="bmm"), jnp.asarray(x),
        jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    got = core.mx_contract(tx, tw, core.preset(name), kind="bmm")
    got.backward(torch.from_numpy(dy))
    assert got.shape == y.shape
    for g, want in ((got, y), (tx.grad, jdx), (tw.grad, jdw)):
        assert _rel(g.detach().numpy(), np.asarray(want)) <= 1e-5


def test_bmm_kind_refuses_mismatched_shapes():
    with pytest.raises(ValueError, match="bmm"):
        core.mx_contract(torch.zeros(2, 8, 4), torch.zeros(3, 4, 5),
                         core.preset("bf16"), kind="bmm")


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("name,clip", [
    ("mxfp8_e4m3", 1.0), ("bf16", 0.0), ("mxfp4_e2m1", 1.0),
    ("mxfp4_e2m1_adaptive", 0.0)])
def test_lane_packed_proxy_steps_match_reference_vmap(name, clip):
    """Three steps of a 2-lane pack (d 64, 2 layers, batch 64): the port's
    lane-stacked proxy_loss, its gradients and the per-lane AdamW update
    against jax.vmap of the reference's, from the reference's init and the
    same numpy batches; each lane its own peak lr."""
    L, steps = 2, 3
    jcfg = jproxy.ProxyConfig(d_model=64, n_layers=2, batch_size=64)
    cfg = proxy.ProxyConfig(d_model=64, n_layers=2, batch_size=64)
    jparams = jax.vmap(lambda k: jproxy.proxy_init(k, jcfg))(
        jnp.stack([jax.random.PRNGKey(s) for s in range(L)]))
    opt_cfg = adamw.AdamWConfig(weight_decay=0.1, grad_clip=clip)
    jopt_cfg = jadamw.AdamWConfig(weight_decay=0.1, grad_clip=clip)
    jopt = jax.vmap(lambda p: jadamw.adamw_init(p, jopt_cfg))(jparams)
    lrs = np.asarray([1e-3, 2e-3], np.float32)
    tparams = _to_torch(jparams)
    leaves = [t.requires_grad_(True) for _, t in
              tree_leaves_with_path(tparams)]
    topt = adamw.adamw_init(tparams, opt_cfg)
    qj, qt = jcore.preset(name), core.preset(name)

    def jstep(p, o, x, y, lr):
        loss, g = jax.value_and_grad(
            lambda pp: jproxy.proxy_loss(pp, (x, y), jcfg, qj)[0])(p)
        p, o, m = jadamw.adamw_update(g, o, p, lr, jopt_cfg)
        return p, o, loss, m["grad_norm"]
    jstep = jax.jit(jax.vmap(jstep))
    rng = np.random.default_rng(0)
    for _ in range(steps):
        x = rng.standard_normal((L, 64, 64)).astype(np.float32)
        y = (0.1 * rng.standard_normal((L, 64, 64))).astype(np.float32)
        jparams, jopt, jl, jg = jstep(jparams, jopt, jnp.asarray(x),
                                      jnp.asarray(y), jnp.asarray(lrs))
        loss, _ = proxy.proxy_loss(tparams, (torch.from_numpy(x),
                                             torch.from_numpy(y)), cfg, qt)
        grads = torch.autograd.grad(loss.sum(), leaves)
        it = iter(grads)
        gtree = jax.tree.map(lambda _: next(it), jax.tree.map(
            lambda a: 0, jparams))
        _, _, m = adamw.adamw_update(gtree, topt, tparams,
                                     torch.from_numpy(lrs), opt_cfg,
                                     lanes=True)
        assert loss.shape == (L,) and m["grad_norm"].shape == (L,)
        np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jl),
                                   rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].numpy(), np.asarray(jg),
                                   rtol=1e-5)
    want = dict(tree_leaves_with_path(jax.tree.map(np.asarray, jparams)))
    for path, t in tree_leaves_with_path(tparams):
        assert _rel(t.detach().numpy(), want[path]) <= 1e-5, path


def test_one_lane_update_is_the_unbatched_update():
    cfg = proxy.ProxyConfig(d_model=64, n_layers=2, batch_size=16)
    g = torch.Generator().manual_seed(0)
    p1 = proxy.proxy_init(g, cfg, device="cpu")
    p2 = proxy.stack_lanes([proxy.tree_map(lambda t: t.clone(), p1)])
    grads = proxy.tree_map(lambda t: torch.randn(t.shape, generator=g), p1)
    for clip in (0.0, 1.0):
        oc = adamw.AdamWConfig(grad_clip=clip)
        s1, s2 = adamw.adamw_init(p1, oc), adamw.adamw_init(p2, oc)
        _, _, m1 = adamw.adamw_update(grads, s1, p1, 1e-3, oc)
        _, _, m2 = adamw.adamw_update(proxy.stack_lanes([grads]), s2, p2,
                                      torch.tensor([1e-3]), oc, lanes=True)
        assert torch.equal(m1["grad_norm"][None], m2["grad_norm"])
        for (_, a), (_, b) in zip(tree_leaves_with_path(p1),
                                  tree_leaves_with_path(p2)):
            assert torch.equal(a, b[0])
    back = proxy.unstack_lanes(p2)
    assert len(back) == 1 and torch.equal(back[0]["layers"][0]["w1"]["w"],
                                          p1["layers"][0]["w1"]["w"])


# ---------------------------------------------------------------------------
# The executor on the CPU: packed against sequential, resume, phases.
# ---------------------------------------------------------------------------
TINY = sweep.RunSpec(kind="proxy", d_model=64, n_layers=2, batch_size=64,
                     steps=12, lr=2e-3, teacher_seed=7)


def test_packed_matches_sequential_on_the_port():
    runs = [dataclasses.replace(TINY, scheme=s, seed=i, lr=lr, steps=8)
            for s in ("bf16", "mxfp4_e2m1")
            for i, lr in ((0, 1e-3), (1, 2e-3), (2, 5e-4))]
    packed = sweep.run_sweep(runs, keep_history=True, device="cpu")
    seq = sweep.run_sweep(runs, keep_history=True, mode="sequential",
                          device="cpu")
    for r in runs:
        a, b = packed[r.run_id].history, seq[r.run_id].history
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[key], b[key], rtol=2e-4, atol=1e-7)
        assert a["spike_flags"] == b["spike_flags"]
        assert packed[r.run_id].steps == r.steps


def test_resume_reproduces_the_uninterrupted_aggregates(tmp_path):
    """stop_after cuts a pack; the relaunch skips exactly the completed
    runs, and since packs run at their group's width the aggregates equal
    an uninterrupted sweep's bit for bit."""
    runs = [dataclasses.replace(TINY, scheme=s, seed=i, steps=6)
            for s in ("bf16", "mxfp8_e4m3") for i in range(3)]
    whole = sweep.run_sweep(runs, device="cpu")
    db = str(tmp_path / "runs.jsonl")
    first = sweep.run_sweep(runs, db=db, stop_after=4, device="cpu")
    assert first.interrupted and first.n_executed == 4
    second = sweep.run_sweep(runs, db=db, device="cpu")
    assert second.n_skipped == 4 and second.n_executed == 2
    assert not second.interrupted
    with open(db) as f:
        ids = [json.loads(x)["run_id"] for x in f if x.strip()]
    assert len(ids) == len(set(ids)) == len(runs)
    strip = lambda agg: {k: {f: v for f, v in s.items()
                             if f != "us_per_step"} for k, s in agg.items()}
    assert strip(sweep.aggregate(sweep.RunDB(db), by="scheme")) == \
        strip(sweep.aggregate(whole, by="scheme"))
    for r in runs:
        assert second[r.run_id].final_loss == whole[r.run_id].final_loss


def test_phases_are_identical_before_the_switch():
    base = dataclasses.replace(TINY, scheme="mxfp4_e2m1", steps=16)
    switched = dataclasses.replace(base, phases=((8, "fp32"),))
    rep = sweep.run_sweep([base, switched], keep_history=True, device="cpu")
    a = rep[base.run_id].history["loss"]
    b = rep[switched.run_id].history["loss"]
    assert a[:8] == b[:8]
    assert a[8:] != b[8:]


def test_scheduled_and_advisory_guards_journal_as_the_reference():
    sched = dataclasses.replace(TINY, guard="sched:4=bf16_activations",
                                scheme="mxfp4_e2m1")
    online = dataclasses.replace(TINY, guard="aggressive", seed=1,
                                 scheme="mxfp4_e2m1", lr=0.05)
    rep = sweep.run_sweep([sched, online], keep_history=True, device="cpu")
    s = rep[sched.run_id]
    assert s.guard_trigger_step == 4 and not s.guard_advisory
    assert [t["to_qcfg"] for t in s.guard_journal] == [
        jcore.apply_intervention(jcore.preset("mxfp4_e2m1"),
                                 "bf16_activations").describe()]
    o = rep[online.run_id]
    assert o.guard_advisory
    want = jguard.advisory_journals(
        np.asarray([o.history["loss"]]), np.asarray([o.history["grad_norm"]]),
        jguard.get_policy("aggressive"), jcore.preset("mxfp4_e2m1"))[0]
    assert o.guard_journal == list(want)


def test_lm_run_trains_through_the_trainer():
    r = sweep.RunSpec(kind="lm", scheme="e4m3_bf16act", steps=3, lr=1e-3,
                      lm_size=1, lm_vocab=256, lm_batch=2, lm_seq=32)
    res = sweep.run_sweep([r], keep_history=True, device="cpu")[r.run_id]
    assert res.steps == 3 and all(map(math.isfinite, res.history["loss"]))
    cfg = sweep.lm_config(r)
    assert (cfg.n_layers, cfg.vocab, cfg.loss_chunk) == (1, 256, 32)


def test_online_guard_lm_run_and_mesh_raise():
    # an online guard on an lm run is accepted (the Trainer's autopilot;
    # tests/test_torch_guard.py holds a full run against the reference)
    r = sweep.RunSpec(kind="lm", guard="autopilot", steps=2, lm_size=1,
                      lm_vocab=256, lm_batch=2, lm_seq=32)
    res = sweep.run_sweep([r], device="cpu")[r.run_id]
    assert res.steps == 2 and not res.guard_advisory
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        sweep.run_sweep([TINY], mesh=object(), device="cpu")
    from repro_torch.launch import sweep as cli
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        cli.main(["--preset", "demo", "--mesh", "4,1", "--device", "cpu"])


def test_cli_relaunch_skips_every_completed_run(tmp_path):
    db = str(tmp_path / "runs.jsonl")
    cmd = [sys.executable, "-m", "repro_torch.launch.sweep", "--preset",
           "demo", "--device", "cpu", "--db", db]
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "2"}
    first = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           check=True, timeout=300)
    assert "executed 4, skipped (already in db) 0" in first.stdout
    second = subprocess.run(cmd, capture_output=True, text=True, env=env,
                            check=True, timeout=300)
    assert "executed 0, skipped (already in db) 4" in second.stdout
    assert first.stdout.splitlines()[-5:] == second.stdout.splitlines()[-5:]
