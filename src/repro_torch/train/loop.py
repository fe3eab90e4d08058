"""Fault-tolerant training loop with the paper's in-situ interventions.

Counterpart of ``repro.train.loop`` on a single device:

  0. autopilot (first line): with ``TrainerConfig.guard`` set, a
     :class:`repro_torch.guard.PrecisionController` reads the step's risk
     signals (loss trend, grad-norm ratio, and every
     ``guard_probe_every`` steps the ζ-bound and LN-clamp probes, see
     ``guard/monitors.py``) and escalates the precision scheme before the
     watchdog would fire; after a stability window it de-escalates back
     toward MX.  Each transition is a ``guard_transition`` record (qcfg
     before and after), rides checkpoint meta, and takes effect at a
     metric-drain boundary (every step with ``log_every=1``), so the
     journaled schedule replays the run bitwise;
  1. watchdog (last line): :class:`SpikeDetector` on loss and gradient
     norm (App. B);
  2. on a spike: roll back to the last clean checkpoint;
  3. apply the configured intervention (default "bf16_activations", the
     paper's strongest immediate stabilizer, Fig. 7) and resume from the
     rollback step on the same step-indexed data; without a checkpointer
     the intervention still applies (forward fix, no rollback);
  4. after ``max_recoveries`` the run aborts with a terminal
     ``recovery_exhausted`` event instead of replaying the same spike;
  5. every decision is a record on ``Trainer.events`` (a Journal).

``restore()`` adopts the checkpoint's recorded qcfg and recovery count,
so a resume never silently reverts an intervention.  Step metrics stay on
the device as 0-d tensors and are moved to the host once per
``log_every`` / checkpoint window; checkpoints are written only after
their window drained clean.  A step-time monitor flags stragglers.

The step runs eagerly: the forward, ``torch.autograd.grad`` through the
``mx_contract`` Functions (the MX GEMM, flash and quantize kernels on
CUDA) and an in-place AdamW update.  A guarded step runs its probes
before that update, so they read the weights the step trained with.
With a ``ckpt_layout`` (see ``repro_torch.convert.lm_checkpoint_layout``)
checkpoints are the reference's files.  Meshes and the cross-pod
gradient compression are ROADMAP Queue A item 6 and raise.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.core import QuantConfig, SpikeDetector, apply_intervention
from repro_torch.core.diagnostics import tree_leaves_with_path
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               warmup_cosine)
from repro_torch.runtime import (Journal, MemoryLedger, MetricsWindow,
                                 SegmentTracker, checkpoint_meta,
                                 parse_checkpoint_meta)

__all__ = ["TrainerConfig", "Trainer", "make_train_step"]

_MESH_LATER = "is ROADMAP Queue A item 6 (distribution), not ported yet"


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 1000
    peak_lr: float = 2e-4
    init_lr: float = 2e-5
    end_lr: float = 2e-5
    warmup_frac: float = 0.05
    ckpt_every: int = 200
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    # instability watchdog / recovery
    spike_factor: float = 100.0
    grad_factor: float = 50.0
    auto_intervention: Optional[str] = "bf16_activations"
    max_recoveries: int = 3
    # precision autopilot (first line of defense; repro_torch.guard): a
    # policy preset name ("autopilot", "aggressive", ..., or
    # "sched:STEP=..."), or a GuardPolicy.  None disables the controller.
    guard: Optional[Any] = None
    guard_probe_every: int = 25       # ζ/clamp probe stride (0 = off)
    # straggler monitor
    straggler_factor: float = 3.0
    log_every: int = 50
    grad_accum: int = 1                      # microbatches per step
    pod_compression: Optional[str] = None    # not ported (raises when set)


def _leaves(tree) -> List[torch.Tensor]:
    return [t for _, t in tree_leaves_with_path(tree)]


def _unflatten(tree, leaves):
    return _build(tree, iter(leaves))


def _build(node, it):
    # A module-level recursion: a recursive closure is a reference cycle
    # that would hold ``leaves`` (a step's gradients) until the cyclic
    # collector runs.
    if isinstance(node, dict):
        return {k: _build(v, it) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_build(v, it) for v in node]
    return next(it)


def _microbatched(batch, n: int):
    """(B, ...) tensor leaves -> n microbatches of B // n rows; 0-d leaves
    are shared by every microbatch."""
    def split(x, i):
        if torch.as_tensor(x).ndim == 0:
            return x
        if x.shape[0] % n:
            raise ValueError(f"grad_accum={n} does not divide batch dim "
                             f"{x.shape[0]}")
        m = x.shape[0] // n
        return x[i * m:(i + 1) * m]

    def part(node, i):
        if isinstance(node, dict):
            return {k: part(v, i) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(part(v, i) for v in node)
        return split(node, i)
    return [part(batch, i) for i in range(n)]


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig,
                    tcfg: TrainerConfig, mesh=None, monitors=None,
                    probe_view: Optional[Callable] = None):
    """``loss_fn(params, batch, qcfg) -> (loss, metrics)``.  Returns
    ``step_fn(params, opt_state, batch, step, qcfg) -> (params, opt_state,
    metrics)``, which updates params and opt_state in place; metrics are
    0-d tensors.  ``grad_accum > 1`` sums the microbatches' losses,
    metrics and gradients in fp32, each divided by the count, in the
    reference's order.

    With ``monitors`` (a ``repro_torch.guard.MonitorConfig``) the step is
    ``step_fn(params, opt_state, mon_state, batch, step, qcfg) ->
    (params, opt_state, mon_state, metrics)``: the risk signals join the
    metrics under ``guard_*`` keys.  On probe steps the probes (the fp32
    backward of the ζ probe among them) run before the in-place update;
    on other steps they do not run.  ``probe_view`` maps a params-shaped
    tree to the tree every probe reads: the params, the step's gradients
    and the fp32 reference gradients alike, so the ζ-bound pairs each
    element with its own (the Trainer gives its ``ckpt_layout``'s
    reference layout); identity by default."""
    if mesh is not None or tcfg.pod_compression:
        raise NotImplementedError(f"sharded training (mesh, "
                                  f"pod_compression) {_MESH_LATER}")
    accum = max(1, tcfg.grad_accum)

    def value_and_grad(params, batch, qcfg):
        leaves = _leaves(params)
        loss, metrics = loss_fn(params, batch, qcfg)
        grads = torch.autograd.grad(loss, leaves)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                list(grads))

    def grads_of(params, batch, qcfg):
        if accum == 1:
            return value_and_grad(params, batch, qcfg)
        total = None
        for mb in _microbatched(batch, accum):
            loss, metrics, grads = value_and_grad(params, mb, qcfg)
            part = [loss.float() / accum,
                    {k: v.float() / accum for k, v in metrics.items()},
                    [g.float() / accum for g in grads]]
            if total is None:
                total = part
            else:
                total = [total[0] + part[0],
                         {k: total[1][k] + part[1][k] for k in total[1]},
                         [a + b for a, b in zip(total[2], part[2])]]
        return total[0], total[1], total[2]

    def update(params, opt_state, grads, metrics, loss, step: int):
        lr = warmup_cosine(step, tcfg.total_steps, tcfg.peak_lr,
                           tcfg.init_lr, tcfg.end_lr, tcfg.warmup_frac)
        params, opt_state, om = adamw_update(grads, opt_state, params, lr,
                                             opt_cfg)
        metrics.update(om)
        metrics["lr"] = lr
        metrics["loss"] = loss
        return params, opt_state, metrics

    if monitors is None:
        def step_fn(params, opt_state, batch, step: int, qcfg: QuantConfig):
            loss, metrics, grads = grads_of(params, batch, qcfg)
            return update(params, opt_state, _unflatten(params, grads),
                          metrics, loss, step)
        return step_fn

    from repro_torch.guard import monitor_probe, monitor_update, probe_due
    view = probe_view or _identity

    def monitored_step_fn(params, opt_state, mstate, batch, step: int,
                          qcfg: QuantConfig):
        loss, metrics, grads = grads_of(params, batch, qcfg)
        gtree = _unflatten(params, grads)
        probed = None
        if probe_due(monitors, step):
            # before adamw_update rewrites the params in place: the clamp
            # statistics and the fp32 reference backward must see the
            # weights this step's gradients were taken at
            probed = monitor_probe(
                monitors, grads=view(gtree), params=view(params), qcfg=qcfg,
                probe_fn=lambda: view(_unflatten(
                    params, grads_of(params, batch, qcfg.to_fp32())[2])))
        params, opt_state, metrics = update(params, opt_state, gtree,
                                            metrics, loss, step)
        mstate, sig = monitor_update(
            monitors, mstate, step=step, loss=metrics["loss"],
            gnorm=metrics["grad_norm"], probed=probed)
        for name, v in sig._asdict().items():
            metrics["guard_" + name] = v
        return params, opt_state, mstate, metrics
    return monitored_step_fn


def _identity(tree):
    return tree


class Trainer:
    """Single-device fault-tolerant trainer (see the module docstring).

    ``params`` is a nested dict/list of tensors on the training device;
    its leaves become autograd leaves and are updated in place.
    ``ckpt_layout`` is a (to_ref, from_ref) pair mapping the
    {"params", "opt"} tree to the checkpoint's layout and back (identity
    by default)."""

    def __init__(self, loss_fn, params, qcfg: QuantConfig,
                 batch_fn: Callable[[int], Any],
                 opt_cfg: Optional[AdamWConfig] = None,
                 tcfg: Optional[TrainerConfig] = None, mesh=None,
                 ckpt_layout=None):
        self.tcfg = tcfg or TrainerConfig()
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.loss_fn = loss_fn
        self.batch_fn = batch_fn
        self.qcfg = qcfg
        self.mesh = mesh
        for t in _leaves(params):
            if not t.is_leaf:
                raise ValueError("Trainer params must be leaf tensors")
            t.requires_grad_(True)
        self.params = params
        self.opt_state = adamw_init(params, self.opt_cfg)
        self.step = 0
        self.detector = SpikeDetector(self.tcfg.spike_factor,
                                      self.tcfg.grad_factor)
        self._controller = self._mcfg = self._mstate = None
        if self.tcfg.guard is not None:
            from repro_torch.guard import (MonitorConfig,
                                           PrecisionController, get_policy,
                                           monitor_init)
            policy = get_policy(self.tcfg.guard)
            self._controller = PrecisionController(qcfg, policy)
            if not policy.is_scheduled:
                # a scheduled policy ignores the signals: no monitors, and
                # no fp32 probe backward that decide() would discard
                self._mcfg = MonitorConfig(
                    probe_every=max(0, self.tcfg.guard_probe_every))
                self._mstate = monitor_init(
                    self._mcfg, _leaves(params)[0].device)
        self._to_ref, self._from_ref = ckpt_layout or (_identity, _identity)
        self._step_fn = make_train_step(
            loss_fn, self.opt_cfg, self.tcfg, mesh, monitors=self._mcfg,
            probe_view=lambda tree: self._to_ref(
                {"params": tree, "opt": {}})["params"])
        self.history: List[Dict[str, float]] = []
        self.events: Journal = Journal()
        self._segments = SegmentTracker(qcfg, journal=self.events)
        self.ledger = MemoryLedger(name="trainer")
        self.ledger.account("params", self.params)
        self.ledger.account("opt", self.opt_state)
        self._ckptr = None
        if self.tcfg.ckpt_dir:
            from .checkpoint import Checkpointer
            self._ckptr = Checkpointer(self.tcfg.ckpt_dir,
                                       self.tcfg.keep_ckpts)
        self._recoveries = 0
        self._step_times: List[float] = []

    # ---- checkpoint / restore --------------------------------------------
    def _tree(self):
        return {"params": self.params, "opt": self.opt_state}

    def checkpoint(self):
        if self._ckptr:
            # the autopilot's state rides along, so a resume picks up
            # mid-flight (level, hysteresis counters, journal)
            meta = checkpoint_meta(step=self.step, qcfg=self.qcfg,
                                   recoveries=self._recoveries,
                                   controller=self._controller,
                                   segment_index=self._segments.index)
            self._ckptr.save(self.step, self._to_ref(self._tree()), meta)

    def restore(self, step: Optional[int] = None,
                adopt_meta: bool = True) -> bool:
        """Load the newest (or given) checkpoint into the live tensors.

        ``adopt_meta=True`` (resume) also adopts the recorded qcfg and
        recovery count, warning when the qcfg differs; the in-run rollback
        of ``_recover`` passes False, since there the in-memory qcfg is the
        intervention."""
        if not self._ckptr:
            return False
        from .checkpoint import latest_step, restore
        self._ckptr.wait()
        s = latest_step(self.tcfg.ckpt_dir) if step is None else step
        if s is None:
            return False
        tree, meta, s = restore(self.tcfg.ckpt_dir,
                                self._to_ref(self._tree()), s)
        src = dict(tree_leaves_with_path(self._from_ref(tree)))
        with torch.no_grad():
            for path, dst in tree_leaves_with_path(self._tree()):
                dst.copy_(src[path])
        self.step = s
        if adopt_meta and meta:
            rm = parse_checkpoint_meta(meta)
            if rm.recoveries is not None:
                self._recoveries = rm.recoveries
            if rm.qcfg is not None and rm.qcfg != self.qcfg:
                warnings.warn(
                    f"checkpoint step {s} was written with qcfg "
                    f"[{rm.qcfg.describe()}] but the trainer was "
                    f"constructed with [{self.qcfg.describe()}]; "
                    "adopting the checkpoint's qcfg (mid-run "
                    "intervention preserved)")
                self.events.append({
                    "step": s, "event": "qcfg_restored",
                    "from_qcfg": self.qcfg.describe(),
                    "to_qcfg": rm.qcfg.describe()})
                self.qcfg = rm.qcfg
            if self._controller is not None:
                if rm.guard:
                    self._controller.load_state_dict(rm.guard)
                    self.events.append({
                        "step": s, "event": "guard_restored",
                        "level": self._controller.level,
                        "transitions": len(self._controller.journal),
                        "qcfg": self._controller.qcfg.describe()})
                elif self._controller.qcfg != self.qcfg:
                    # a checkpoint from before the guard: its scheme
                    # becomes the controller's baseline
                    self._controller.rebase(self.qcfg)
            self._segments.restore(rm.segment_index, self.qcfg)
        return True

    # ---- recovery policy --------------------------------------------------
    def _recover(self, reason: str) -> bool:
        """Roll back (if possible) and intervene.  Returns whether a
        rollback happened."""
        rolled = self.restore(adopt_meta=False)
        old = self.qcfg.describe()
        if self.tcfg.auto_intervention:
            self.qcfg = apply_intervention(self.qcfg,
                                           self.tcfg.auto_intervention)
            if self._controller is not None:
                # the recovery's scheme is the new floor: without a rebase
                # the controller's next transition would revert it
                self._controller.rebase(self.qcfg)
        self._recoveries += 1
        self.detector = SpikeDetector(self.tcfg.spike_factor,
                                      self.tcfg.grad_factor)
        if self._mcfg is not None:
            # the EMAs describe the poisoned trajectory: restart them
            from repro_torch.guard import monitor_init
            self._mstate = monitor_init(self._mcfg,
                                        self._mstate.count.device)
        self._segments.transition(self.step, self.qcfg, reason="recovery")
        self.events.append({
            "step": self.step, "event": "recovery", "reason": reason,
            "rolled_back": rolled, "from_qcfg": old,
            "to_qcfg": self.qcfg.describe()})
        return rolled

    # ---- metric window ----------------------------------------------------
    def _guard_pass(self, pending) -> bool:
        """Feed the window's risk signals to the autopilot, before the
        watchdog sees the window.  At most one transition per window; the
        new scheme takes effect at ``self.step`` (the next step to run),
        the step the journal records, so a scheduled replay switches at
        the same boundary.  Transitions survive a later rollback."""
        if self._controller is None:
            return False
        from repro_torch.guard import signals_from_metrics
        for s, metrics, _ in pending:
            new = self._controller.observe(s, signals_from_metrics(metrics),
                                           effective_step=self.step)
            if new is not None:
                self.events.append(dict(self._controller.journal[-1]))
                self.qcfg = new
                self._segments.transition(self.step, new, reason="guard")
                return True
        return False

    def _drain(self, pending) -> tuple:
        """Record a window of (step, metrics, time_s) entries and feed the
        watchdog in order; stops at the first spike and returns (spike
        reason or None, entries consumed)."""
        for i, (s, metrics, dt) in enumerate(pending):
            loss, gnorm = metrics["loss"], metrics["grad_norm"]
            self._step_times.append(dt)
            win = self._step_times[-64:]
            med = sorted(win)[len(win) // 2]
            rec = {"step": s, "loss": loss, "grad_norm": gnorm,
                   "lr": metrics["lr"], "time_s": dt}
            for k in ("aux_loss", "guard_zeta", "guard_gnorm_ratio",
                      "guard_loss_ratio", "guard_loss_curvature"):
                if k in metrics:
                    rec[k] = metrics[k]
            if dt > self.tcfg.straggler_factor * med and len(
                    self._step_times) > 8:
                self.events.append({"step": s, "event": "straggler",
                                    "time_s": dt, "median_s": med})
            self.history.append(rec)
            if self.detector.update(loss, gnorm):
                return f"spike@step{s}: loss={loss:.4g}", i + 1
        return None, len(pending)

    # ---- main loop ---------------------------------------------------------
    def run(self, n_steps: Optional[int] = None):
        first = _leaves(self.params)[0]
        if not self.events or self.events[-1].get("event") != "run_start":
            self.events.append({"step": self.step, "event": "run_start",
                                "device": str(first.device),
                                "guard": self._controller.policy.name
                                if self._controller is not None else None,
                                "qcfg": self.qcfg.describe()})
        # n_steps=0 means nothing to do (a resume of a finished run)
        end = self.step + (self.tcfg.total_steps if n_steps is None
                           else n_steps)
        log_every = max(self.tcfg.log_every, 1)
        window = MetricsWindow()
        aborted = False
        window.reset_clock()
        while self.step < end:
            batch = self.batch_fn(self.step)
            if self._mcfg is None:
                self.params, self.opt_state, metrics = self._step_fn(
                    self.params, self.opt_state, batch, self.step,
                    self.qcfg)
            else:
                (self.params, self.opt_state, self._mstate,
                 metrics) = self._step_fn(self.params, self.opt_state,
                                          self._mstate, batch, self.step,
                                          self.qcfg)
            window.push(self.step, metrics)
            self.step += 1
            at_ckpt = bool(self._ckptr) \
                and self.step % self.tcfg.ckpt_every == 0
            if not (at_ckpt or self.step >= end
                    or self.step % log_every == 0):
                continue
            pending = window.drain()
            self._guard_pass(pending)
            recovered = False
            while pending:
                spike, consumed = self._drain(pending)
                pending = pending[consumed:]
                if spike is None:
                    break
                if self._recoveries >= self.tcfg.max_recoveries:
                    self.events.append({
                        "step": self.step, "event": "recovery_exhausted",
                        "reason": spike, "recoveries": self._recoveries})
                    aborted = True
                    break
                recovered = True
                if self._recover(spike):
                    pending = []   # the tail ran on a state now gone
            window.reset_clock()
            if aborted:
                break
            if at_ckpt and not recovered:
                self.checkpoint()
        if self._ckptr:
            if not aborted:
                self.checkpoint()
            self._ckptr.wait()
        return self.history
