"""Sweep execution: lane-packed proxy runs on the card, LM runs through the
Trainer.

Counterpart of ``repro.sweep.executor``.  Two engines behind one entry
point (:func:`run_sweep`):

* **Packed** (``kind="proxy"``): runs that share every field but
  ``spec.LANE_FIELDS`` (seeds, peak lr) go into one pack along a leading
  *lane* axis.  Params, optimizer state and teachers are lane-stacked
  trees (``models.stack_lanes``); each lane draws its batches from its own
  generators and takes its own peak lr.  Each segment of
  ``runtime.plan_segments`` runs as an eager step loop over all lanes at
  once: every GEMM of the forward, dgrad and wgrad is one launch of a lane
  kernel (``ops.mx_matmul_lanes`` and its twins) whatever the lane count,
  and so is every other op of the step but the per-lane batch draws.  The
  reference gets the same packing from ``vmap`` inside a ``lax.scan``; the
  port's kernels take the lane axis themselves.  Loss and grad norm stay
  on the device; one device-to-host transfer per segment brings the
  (lanes, steps) histories back (as ``MetricsWindow`` does), then the
  host-side accounting runs.

* **Sequential** (``kind="lm"``): LM-scale runs go one at a time through
  the port's :class:`repro_torch.train.Trainer` with recovery disabled (a
  sweep must *observe* divergence, not intervene on it).

``mode="sequential"`` runs proxy runs as one-lane packs through the same
loop: the parity and throughput reference of the packed engine.

A pack always runs at its group's full width: the number of the sweep's
runs that share its ``group_key``, completed ones included.  A pack cut
by ``stop_after``, or left short by runs a database already holds, is
padded with copies of its last run, whose results are dropped (the
reference pads its lanes to a mesh the same way).  The step's shapes are
then the same in every launch, so a run's bits do not depend on which of
its group's runs a launch still had to execute, and a resumed sweep
reproduces an uninterrupted one bit for bit.  (The lane kernels give each
lane the same bits whatever the lane count; PyTorch's own reductions and
batched products may sum in another order at another lane count, which
is why one-lane packs are held to a tolerance and not bitwise.)

Mid-run precision interventions (``RunSpec.phases``) and *scheduled* guard
policies split the step loop at their switch steps; *online* policies run
advisorily over a pack's recorded histories (``guard.advisory_journals``).
On an ``lm`` run an online policy is the Trainer's real autopilot: its
transitions happen, and its journal is the run's.  A device mesh is
ROADMAP Queue A item 6 and raises.

Per-lane accounting is host-side: :class:`core.BatchedSpikeDetector` flags
(one detector per lane), the Fig. 6 divergence rule, the Fig. 7
divergence step and the optional ζ-bound probes (``track_bias_every``)
against the fp32 gradient, all as the reference computes them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.train.loop import _leaves, _unflatten
from .db import RunDB
from .spec import RunSpec, SweepSpec, group_key

__all__ = ["RunResult", "SweepReport", "ProxyPack", "run_sweep",
           "lm_config"]

# Fig. 6 rule: a run diverged if its last loss is non-finite or exceeds
# 100x the best loss it ever reached.
DIVERGENT_FACTOR = 100.0

_MESH = ("sharded sweeps (mesh) are ROADMAP Queue A item 6 (distribution), "
         "not ported yet")


@dataclasses.dataclass
class RunResult:
    run_id: str
    label: str
    scheme: str
    seed: int
    lr: float
    steps: int
    final_loss: float
    tail_mean: float
    min_loss: float
    max_gnorm: float
    spikes: int
    divergent: bool
    diverge_step: int
    us_per_step: float
    zeta_steps: list = dataclasses.field(default_factory=list)
    zeta: list = dataclasses.field(default_factory=list)
    cosine: list = dataclasses.field(default_factory=list)
    # guard accounting, persisted to the run DB: *actual* transitions of
    # scheduled policies, *advisory* ones of online policies over lanes
    guard_journal: list = dataclasses.field(default_factory=list)
    guard_trigger_step: int = -1      # first escalation (advisory or real)
    guard_advisory: bool = False
    # in-memory only (never persisted to the run DB)
    history: Optional[Dict[str, list]] = None
    final_params: Any = None

    def summary(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if f.name not in ("history", "final_params", "run_id")}

    @staticmethod
    def from_row(row: dict) -> "RunResult":
        return RunResult(run_id=row["run_id"], **row["result"])


@dataclasses.dataclass
class SweepReport:
    results: Dict[str, RunResult]     # run_id -> result (full sweep view)
    order: List[str]                  # run_ids in expansion order
    n_executed: int
    n_skipped: int
    interrupted: bool                 # stop_after exhausted before the end

    def __iter__(self):
        return (self.results[rid] for rid in self.order
                if rid in self.results)

    def __getitem__(self, run_id: str) -> RunResult:
        return self.results[run_id]


# ---------------------------------------------------------------------------
# host-side accounting shared by both engines (the reference's)
# ---------------------------------------------------------------------------
def _diverge_step(losses: np.ndarray, factor: float) -> int:
    best = losses[0]
    for i, x in enumerate(losses):
        if not np.isfinite(x) or x > factor * best:
            return i
        best = min(best, x)
    return -1


def _guard_trigger(journal) -> int:
    for t in journal or ():
        if t.get("kind") in ("escalate", "scheduled"):
            return int(t["step"])
    return -1


def _account(r: RunSpec, losses: np.ndarray, gnorms: np.ndarray,
             spike_flags: np.ndarray, us_per_step: float,
             zeta_steps=(), zeta=(), cosine=(),
             history: Optional[dict] = None,
             final_params=None, guard_journal=None,
             guard_advisory: bool = False) -> RunResult:
    finite = losses[np.isfinite(losses)]
    last = float(losses[-1]) if len(losses) else float("nan")
    min_loss = float(finite.min()) if len(finite) else float("nan")
    tail = float(np.mean(losses[-10:])) if len(losses) else float("nan")
    divergent = (not np.isfinite(last)) or (
        len(finite) > 0 and last > DIVERGENT_FACTOR * min_loss)
    fin_g = gnorms[np.isfinite(gnorms)]
    return RunResult(
        run_id=r.run_id, label=r.label or r.scheme, scheme=r.scheme,
        seed=r.seed, lr=r.lr, steps=int(len(losses)), final_loss=last,
        tail_mean=tail, min_loss=min_loss,
        max_gnorm=float(fin_g.max()) if len(fin_g) else float("nan"),
        spikes=int(spike_flags.sum()), divergent=bool(divergent),
        diverge_step=_diverge_step(losses, r.diverge_factor)
        if len(losses) else -1,
        us_per_step=float(us_per_step),
        zeta_steps=list(zeta_steps), zeta=list(zeta), cosine=list(cosine),
        guard_journal=list(guard_journal or ()),
        guard_trigger_step=_guard_trigger(guard_journal),
        guard_advisory=bool(guard_advisory),
        history=history, final_params=final_params)


def _spike_flags(losses_2d: np.ndarray, r: RunSpec) -> np.ndarray:
    """(lanes, steps) loss histories -> per-lane App. B spike flags
    (loss only, as the figure benchmarks count spikes)."""
    from repro_torch.core import BatchedSpikeDetector
    return BatchedSpikeDetector.flags(
        losses_2d, spike_factor=r.spike_factor, window=r.spike_window)


def _phase_segments(r: RunSpec, qcfg0):
    """[(start, end, qcfg)] from ``r.phases`` merged with a *scheduled*
    guard policy (``runtime.plan_segments``)."""
    from repro_torch.runtime import plan_segments
    return plan_segments(r.steps, qcfg0, phases=r.phases, guard=r.guard)


def _scheduled_journal(r: RunSpec) -> Optional[list]:
    """The transition journal of a *scheduled* guard policy: the schedule
    walked through a controller (the same for every lane).  None when
    r.guard is empty or online."""
    if not r.guard:
        return None
    from repro_torch.core import preset
    from repro_torch.guard import PrecisionController, get_policy
    pol = get_policy(r.guard)
    if not pol.is_scheduled:
        return None
    ctl = PrecisionController(preset(r.scheme), pol)
    for s, _ in pol.schedule:
        if s < r.steps:
            ctl.observe(s, {}, effective_step=s)
    return ctl.journal


def _advisory_guard(r: RunSpec, losses_2d: np.ndarray,
                    gnorms_2d: np.ndarray) -> Optional[list]:
    """One would-have-intervened journal per lane for an *online* policy
    over a pack's (lanes, steps) histories; None when r.guard is empty or
    scheduled."""
    if not r.guard:
        return None
    from repro_torch.core import preset
    from repro_torch.guard import advisory_journals, get_policy
    pol = get_policy(r.guard)
    if pol.is_scheduled:
        return None
    return advisory_journals(losses_2d, gnorms_2d, pol, preset(r.scheme))


# ---------------------------------------------------------------------------
# packed proxy engine
# ---------------------------------------------------------------------------
class ProxyPack:
    """The lane-stacked state of one pack of proxy runs and its step.

    ``runs`` share their ``group_key``; lane i is ``runs[i]``: its student
    from ``Generator().manual_seed(seed)``, its teacher from
    ``teacher_seed``, its batches from ``effective_data_seed`` and its peak
    lr.  :meth:`step` runs one training step of every lane (lane kernels
    for the GEMMs) and returns the (L,) loss, grad norm and, on probe
    steps, ζ-bound and cosine, all on the device."""

    def __init__(self, runs: Sequence[RunSpec], device=None):
        from repro_torch.core import preset
        from repro_torch.devices import resolve_device
        from repro_torch.models import (ProxyConfig, proxy_init,
                                        stack_lanes, teacher_init)
        from repro_torch.optim import (AdamWConfig, adamw_init,
                                       get_schedule, sgd_init)

        self.runs = list(runs)
        r0 = self.runs[0]
        self.device = resolve_device(device)
        self.cfg = ProxyConfig(d_model=r0.d_model, n_layers=r0.n_layers,
                               act=r0.act, init=r0.init,
                               batch_size=r0.batch_size)
        # the teacher keeps its own init, so a student-init ablation does
        # not also change the regression target
        tcfg = dataclasses.replace(self.cfg, init=r0.teacher_init_style)
        self.qcfg0 = preset(r0.scheme)
        self.opt_cfg = AdamWConfig(weight_decay=r0.weight_decay,
                                   grad_clip=r0.grad_clip)
        self.adam = r0.optimizer == "adam"
        self.momentum = 0.9 if r0.optimizer == "momentum" else 0.0
        self.seeds = [r.effective_data_seed for r in self.runs]
        dev = self.device
        self.teachers = stack_lanes([
            teacher_init(torch.Generator().manual_seed(r.teacher_seed), tcfg,
                         device=dev) for r in self.runs])
        self.params = stack_lanes([
            proxy_init(torch.Generator().manual_seed(r.seed), self.cfg,
                       device=dev) for r in self.runs])
        self.leaves = _leaves(self.params)
        for t in self.leaves:
            t.requires_grad_(True)
        self.opt = (adamw_init(self.params, self.opt_cfg) if self.adam
                    else sgd_init(self.params))
        # the shared schedule at each lane's peak, (steps, L) on the device
        sched = get_schedule(r0.lr_schedule)
        self.lrs = torch.stack([
            torch.stack([sched(s, r0.steps, r.lr) for r in self.runs])
            for s in range(max(r0.steps, 1))]).to(dev)

    def _grads(self, batch, qcfg):
        from repro_torch.models import proxy_loss
        loss, _ = proxy_loss(self.params, batch, self.cfg, qcfg)
        grads = torch.autograd.grad(loss.sum(), self.leaves)
        return loss.detach(), _unflatten(self.params, grads)

    def step(self, step: int, qcfg, probe: bool = False):
        """One step of every lane under ``qcfg`` -> (loss, grad_norm,
        zeta, cosine), each (L,) on the device; zeta and cosine are None
        unless ``probe`` (the fp32 gradient's ζ-bound, taken before the
        update as the reference takes it)."""
        from repro_torch.core import zeta_bound_lanes
        from repro_torch.models import proxy_batch
        from repro_torch.optim import adamw_update, sgd_update
        batch = proxy_batch(step, self.teachers, self.cfg, self.seeds)
        loss, grads = self._grads(batch, qcfg)
        z = cs = None
        if probe:
            _, exact = self._grads(batch, qcfg.to_fp32())
            zb = zeta_bound_lanes(exact, grads)
            z, cs = zb["norm_ratio"], zb["cosine"]
        lr = self.lrs[step]
        if self.adam:
            _, _, om = adamw_update(grads, self.opt, self.params, lr,
                                    self.opt_cfg, lanes=True)
        else:
            _, _, om = sgd_update(grads, self.opt, self.params, lr,
                                  momentum=self.momentum,
                                  grad_clip=self.runs[0].grad_clip,
                                  lanes=True)
        return loss, om["grad_norm"], z, cs

    def lane_params(self, i: int):
        """Lane i's parameters, detached copies in the one-run layout."""
        from repro_torch.models import tree_map
        return tree_map(lambda t: t[i].detach().clone(), self.params)


def _run_proxy_pack(runs: List[RunSpec], device=None,
                    keep_history: bool = False, keep_params: bool = False
                    ) -> List[RunResult]:
    r0 = runs[0]
    track = r0.track_bias_every
    t0 = time.perf_counter()
    pack = ProxyPack(runs, device)
    losses, gnorms, zetas, coss = [], [], [], []
    nan = torch.full((len(runs),), float("nan"), device=pack.device)
    for a, b, qcfg in _phase_segments(r0, pack.qcfg0):
        seg_l, seg_g, seg_z, seg_c = [], [], [], []
        for step in range(a, b):
            probe = bool(track) and step % track == 0
            loss, gn, z, cs = pack.step(step, qcfg, probe)
            seg_l.append(loss)
            seg_g.append(gn)
            if track:
                seg_z.append(z if probe else nan)
                seg_c.append(cs if probe else nan)
        # one device-to-host transfer of the segment's histories
        host = torch.stack([torch.stack(x) for x in (
            (seg_l, seg_g) + ((seg_z, seg_c) if track else ()))]
        ).to("cpu", torch.float64).numpy()
        losses.append(host[0])
        gnorms.append(host[1])
        if track:
            zetas.append(host[2])
            coss.append(host[3])
    wall = time.perf_counter() - t0
    us = wall / max(r0.steps, 1) * 1e6   # pack-level: lanes ran together
    cat = lambda xs: np.concatenate(xs, axis=0).T   # (lanes, steps)
    losses, gnorms = cat(losses), cat(gnorms)
    if track:
        zetas, coss = cat(zetas), cat(coss)

    flags = _spike_flags(losses, r0)
    adv = _advisory_guard(r0, losses, gnorms)
    sched_journal = _scheduled_journal(r0)
    out = []
    for i, r in enumerate(runs):
        zsteps = list(range(0, r.steps, track)) if track else []
        hist = None
        if keep_history:
            hist = {"loss": losses[i].tolist(),
                    "grad_norm": gnorms[i].tolist(),
                    "spike_flags": flags[i].tolist()}
        out.append(_account(
            r, losses[i], gnorms[i], flags[i], us,
            zsteps, [float(zetas[i][s]) for s in zsteps] if track else [],
            [float(coss[i][s]) for s in zsteps] if track else [],
            history=hist,
            final_params=pack.lane_params(i) if keep_params else None,
            guard_journal=adv[i] if adv is not None else sched_journal,
            guard_advisory=adv is not None))
    return out


# ---------------------------------------------------------------------------
# sequential Trainer engine (LM-scale specs)
# ---------------------------------------------------------------------------
def lm_config(r: RunSpec):
    """The LMConfig a ``kind="lm"`` RunSpec trains."""
    if r.arch == "olmo":
        from repro_torch.configs.olmo_paper import olmo
        return dataclasses.replace(
            olmo(max(r.lm_size, 1), vocab=r.lm_vocab, context=r.lm_seq),
            loss_chunk=r.lm_seq)
    from repro_torch.configs import get_config
    return get_config(r.arch, "smoke")


def _run_lm_run(r: RunSpec, device=None, keep_history: bool = False,
                keep_params: bool = False) -> RunResult:
    from repro_torch.convert import lm_checkpoint_layout
    from repro_torch.core import preset
    from repro_torch.data import lm_input_arrays
    from repro_torch.devices import resolve_device
    from repro_torch.guard import get_policy
    from repro_torch.models import lm_init, lm_loss
    from repro_torch.optim import AdamWConfig, get_schedule
    from repro_torch.train import Trainer, TrainerConfig

    if r.optimizer != "adam":
        raise ValueError(
            f"lm sweeps run through the Trainer, which is AdamW-only "
            f"(got optimizer={r.optimizer!r})")
    if r.track_bias_every:
        raise ValueError("track_bias_every is proxy-only (the Trainer "
                         "does not recompute fp32 gradients per step; use "
                         "guard_probe_every for in-Trainer ζ probes)")
    pol = get_policy(r.guard) if r.guard else None
    online = pol is not None and not pol.is_scheduled
    if online and r.phases:
        raise ValueError(
            "an online guard policy owns the trainer's qcfg, which would "
            "fight the phases' segment switches: express the schedule as "
            "part of a sched: guard policy instead of mixing an online "
            "guard with phases")
    device = resolve_device(device)
    cfg = lm_config(r)
    get_schedule(r.lr_schedule)   # reject unknown names up front
    if r.lr_schedule == "constant":
        peak = init = end = r.lr
    elif r.lr_schedule == "cosine":
        peak, init, end = r.lr, 0.1 * r.lr, 0.1 * r.lr
    else:
        raise ValueError(
            f"lm runs map lr schedules onto the Trainer's warmup-cosine "
            f"and support only constant/cosine, got {r.lr_schedule!r}")
    # Recovery off: a non-finite loss aborts the run (max_recoveries=0),
    # which is exactly "this run diverged".  Only an online guard needs a
    # drain every step (its transitions land at drains); scheduled
    # policies split the run into segments below.
    tcfg = TrainerConfig(
        total_steps=r.steps, peak_lr=peak, init_lr=init, end_lr=end,
        auto_intervention=None, max_recoveries=0,
        spike_factor=float("inf"), grad_factor=float("inf"),
        log_every=1 if online else min(50, max(r.steps, 1)),
        guard=r.guard if online else None,
        guard_probe_every=r.guard_probe_every)
    segs = _phase_segments(r, preset(r.scheme))
    trainer = Trainer(
        loss_fn=lambda p, b, q: lm_loss(p, b, cfg, q),
        params=lm_init(cfg, torch.Generator().manual_seed(r.seed), device),
        qcfg=segs[0][2],
        batch_fn=lambda s: lm_input_arrays(s, cfg, r.lm_batch, r.lm_seq,
                                           r.effective_data_seed,
                                           device=device),
        opt_cfg=AdamWConfig(weight_decay=r.weight_decay,
                            grad_clip=r.grad_clip),
        tcfg=tcfg, ckpt_layout=lm_checkpoint_layout(cfg, device))
    t0 = time.perf_counter()
    for _, end_step, qcfg_seg in segs:
        if not online:
            trainer.qcfg = qcfg_seg
        if trainer.step < end_step:
            trainer.run(end_step - trainer.step)
        if len(trainer.history) < min(end_step, r.steps):   # aborted
            break
    wall = time.perf_counter() - t0

    losses = np.asarray([h["loss"] for h in trainer.history], np.float64)
    gnorms = np.asarray([h["grad_norm"] for h in trainer.history],
                        np.float64)
    flags = _spike_flags(losses[None, :], r)[0] if len(losses) else \
        np.zeros((0,), bool)
    hist = None
    if keep_history:
        hist = {"loss": losses.tolist(), "grad_norm": gnorms.tolist(),
                "spike_flags": flags.tolist()}
    return _account(r, losses, gnorms, flags,
                    wall / max(len(losses), 1) * 1e6, history=hist,
                    final_params=trainer.params if keep_params else None,
                    guard_journal=(list(trainer._controller.journal)
                                   if online else _scheduled_journal(r)))


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------
def run_sweep(spec: Union[SweepSpec, Sequence[RunSpec]], *,
              db: Union[None, str, RunDB] = None, mesh=None,
              mode: str = "auto", stop_after: Optional[int] = None,
              keep_history: bool = False, keep_params: bool = False,
              verbose: bool = False, device=None) -> SweepReport:
    """Execute a sweep, resumably, on ``device`` (default ``cuda``).

    ``db``           path (or open RunDB): completed run_ids are *skipped*
                     and their persisted summaries folded into the report;
                     each newly finished run is appended and flushed, so a
                     crash loses at most the pack in flight.
    ``mesh``         not ported (ROADMAP Queue A item 6): raises.
    ``mode``         "auto" / "vectorized" (pack proxy runs) |
                     "sequential" (one-lane packs: the parity and
                     throughput reference).
    ``stop_after``   execute at most this many runs, then return with
                     ``interrupted=True``.
    """
    if mode not in ("auto", "vectorized", "sequential"):
        raise ValueError(f"unknown mode {mode!r}")
    if mesh is not None:
        raise NotImplementedError(_MESH)
    runs = spec.expand() if isinstance(spec, SweepSpec) else list(spec)
    own_db = isinstance(db, str)
    rdb = RunDB(db) if own_db else db
    try:
        return _run_sweep(runs, rdb, device, mode, stop_after, keep_history,
                          keep_params, verbose)
    finally:
        if own_db:
            rdb.close()


def _run_sweep(runs, rdb, device, mode, stop_after, keep_history,
               keep_params, verbose) -> SweepReport:
    results: Dict[str, RunResult] = {}
    todo: List[RunSpec] = []
    seen = set()
    n_skipped = 0
    for r in runs:
        rid = r.run_id
        if rid in seen:
            continue
        seen.add(rid)
        if rdb is not None and rid in rdb:
            results[rid] = RunResult.from_row(rdb.get(rid))
            n_skipped += 1
        else:
            todo.append(r)

    # pack proxy runs by signature (first-seen order); lm runs stay
    # sequential in expansion order after the packs.  A pack's width is
    # its group's size over the whole sweep (see the module docstring).
    packs: List[List[RunSpec]] = []
    by_key: Dict[tuple, List[RunSpec]] = {}
    width: Dict[tuple, int] = {}
    for r in {r.run_id: r for r in runs}.values():
        if r.kind != "lm" and mode != "sequential":
            k = group_key(r)
            width[k] = width.get(k, 0) + 1
    lm_runs: List[RunSpec] = []
    for r in todo:
        if r.kind == "lm":
            lm_runs.append(r)
        elif mode == "sequential":
            packs.append([r])
        else:
            k = group_key(r)
            if k not in by_key:
                by_key[k] = []
                packs.append(by_key[k])
            by_key[k].append(r)

    budget = stop_after
    n_executed = 0
    interrupted = False

    def spend(k: int) -> int:
        nonlocal budget
        if budget is None:
            return k
        take = min(k, budget)
        budget -= take
        return take

    for pack in packs:
        take = spend(len(pack))
        if take < len(pack):
            interrupted = True
        if take == 0:
            break
        pack = pack[:take]
        pad = width.get(group_key(pack[0]), 1) - len(pack)
        if verbose:
            print(f"[sweep] pack x{len(pack)}"
                  + (f" (+{pad} padding)" if pad > 0 else "")
                  + f": {pack[0].label or pack[0].scheme} "
                  f"steps={pack[0].steps}", flush=True)
        for r, res in zip(pack, _run_proxy_pack(
                pack + [pack[-1]] * max(pad, 0), device, keep_history,
                keep_params)):
            results[r.run_id] = res
            n_executed += 1
            if rdb is not None:
                rdb.append(r.run_id, r, res.summary())
    if not interrupted:
        for r in lm_runs:
            if spend(1) == 0:
                interrupted = True
                break
            if verbose:
                print(f"[sweep] lm run: {r.label or r.scheme} "
                      f"steps={r.steps}", flush=True)
            res = _run_lm_run(r, device, keep_history, keep_params)
            results[r.run_id] = res
            n_executed += 1
            if rdb is not None:
                rdb.append(r.run_id, r, res.summary())

    order, odone = [], set()
    for r in runs:
        if r.run_id not in odone:
            odone.add(r.run_id)
            order.append(r.run_id)
    return SweepReport(results=results, order=order, n_executed=n_executed,
                       n_skipped=n_skipped, interrupted=interrupted)
