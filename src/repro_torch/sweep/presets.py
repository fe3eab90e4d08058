"""Declarative sweep specs for the paper's figure/table experiments.

A copy of ``repro.sweep.presets``: every run of every preset has the
reference's run_id.  Budgets: "quick" is CI-sized, "full" the paper's
protocol at its published widths.

Two experiments need post-processing beyond a flat grid and are therefore
*function pairs* rather than CLI presets: fig7's intervention steps depend
on the baseline's measured divergence step, and table2 fits a scaling law
on held-out losses of the final parameters.
"""
from __future__ import annotations

from typing import Dict, List

import dataclasses

from .spec import RunSpec, SweepSpec

__all__ = ["SWEEP_PRESETS", "get_sweep_spec", "fig2_spec", "fig6_spec",
           "fig7_base_spec", "fig7_intervention_spec", "fig9_spec",
           "fig10_specs", "table1_spec", "table2_spec", "demo_spec"]

_PROXY = RunSpec(kind="proxy", d_model=128, n_layers=4, batch_size=256,
                 spike_factor=10.0)


def _proxy(**kw) -> RunSpec:
    return dataclasses.replace(_PROXY, **kw)

FIG2_PRECISIONS = ("bf16", "mxfp8_e4m3", "mxfp6_e2m3", "mxfp4_e2m1")

# label -> preset name (Fig. 6 mitigation schemes at FP4)
FIG6_SCHEMES = (("fig6.fp32", "bf16"),
                ("fig6.full_e2m1", "mxfp4_e2m1"),
                ("fig6.fwd_only_e2m1", "e2m1_fwd_only"),
                ("fig6.bf16_acts_e2m1", "e2m1_bf16act"),
                ("fig6.adaptive_e2m1", "mxfp4_e2m1_adaptive"))

FIG7_INTERVENTIONS = ("fp32", "no_bwd_quant", "bf16_activations",
                      "skip_ln_quant", "bump_exponent", "adaptive_scale")

TABLE1_SCHEMES = ("bf16", "e4m3_bf16act", "e5m2_bf16act",
                  "e4m3_fwd_only", "e5m2_fwd_only")


def fig2_spec(budget: str = "quick") -> SweepSpec:
    """LR x precision grid (paper Fig. 2): lanes pack over the LR axis."""
    steps = 150 if budget == "quick" else 600
    lrs = (1e-4, 5e-4, 2e-3) if budget == "quick" else \
        (1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 2e-3)
    base = SweepSpec.make(
        "fig2", _proxy(steps=steps, seed=0, data_seed=0, teacher_seed=1),
        {"lr": lrs, "scheme": FIG2_PRECISIONS},
        label_fmt="fig2.lr{lr:g}.{scheme}")
    return base


def fig6_spec(budget: str = "quick") -> SweepSpec:
    """Mitigation x seed grid (paper Fig. 6): lanes pack over seeds."""
    steps = 150 if budget == "quick" else 500
    n_seeds = 3 if budget == "quick" else 8
    return SweepSpec.make(
        "fig6", _proxy(steps=steps, lr=1e-3),
        {"label,scheme": FIG6_SCHEMES,
         # per-seed teacher (seed s trains against teacher 100+s), the
         # old module's convention; data follows the student seed
         "seed,teacher_seed": tuple((s, 100 + s) for s in range(n_seeds))})


def fig7_base_spec(budget: str = "quick") -> SweepSpec:
    """Unintervened baselines (MX + fp32) whose measured divergence step
    positions the "early"/"late" intervention points."""
    steps = 200 if budget == "quick" else 800
    return SweepSpec.make(
        "fig7.base",
        _proxy(steps=steps, lr=2e-3, seed=0, data_seed=0, teacher_seed=1,
               diverge_factor=50.0),
        {"label,scheme": (("fig7.baseline_mx", "mxfp4_e2m1"),
                          ("fig7.baseline_fp32", "bf16"))})


def fig7_intervention_spec(budget: str, early: int, late: int) -> SweepSpec:
    """In-situ interventions at the measured early/late switch steps."""
    steps = 200 if budget == "quick" else 800
    cells = []
    for when, sw in (("early", early), ("late", late)):
        for iv in FIG7_INTERVENTIONS:
            cells.append((((int(sw), iv),), f"fig7.{when}@{sw}.{iv}"))
    return SweepSpec.make(
        "fig7.interventions",
        _proxy(steps=steps, lr=2e-3, seed=0, data_seed=0, teacher_seed=1,
               scheme="mxfp4_e2m1", diverge_factor=50.0),
        {"phases,label": tuple(cells)})


def fig9_spec(budget: str = "quick") -> SweepSpec:
    """Depth x width x precision spike counts (paper Fig. 9)."""
    steps = 120 if budget == "quick" else 500
    grid = ((2, 96), (4, 128)) if budget == "quick" else \
        ((2, 96), (3, 128), (4, 192), (6, 256))
    return SweepSpec.make(
        "fig9", _proxy(steps=steps, lr=1e-3, seed=0, data_seed=0,
                       teacher_seed=1),
        {"n_layers,d_model": grid,
         "scheme": ("bf16", "mxfp8_e4m3", "mx_mix", "mxfp4_e2m1")},
        label_fmt="fig9.L{n_layers}.D{d_model}.{scheme}")


def fig10_specs(budget: str = "quick") -> List[SweepSpec]:
    """Optimizer + init ablations (paper App. B Figs. 10-11)."""
    steps = 120 if budget == "quick" else 500
    base = _proxy(steps=steps, scheme="mxfp4_e2m1", seed=0, data_seed=0,
                  teacher_seed=1)
    opt = SweepSpec.make(
        "fig10.opt", base,
        {"optimizer,lr": (("adam", 2e-3), ("sgd", 1e-2),
                          ("momentum", 1e-2))},
        label_fmt="fig10.opt.{optimizer}")
    init = SweepSpec.make(
        "fig10.init", dataclasses.replace(base, lr=2e-3),
        {"init": ("kaiming_uniform", "xavier_lowgain")},
        label_fmt="fig10.init.{init}")
    return [opt, init]


def table1_spec(budget: str = "quick") -> SweepSpec:
    """Mitigated-loss deltas vs bf16 (paper Table 1) — LM runs through the
    sequential Trainer engine."""
    steps = 120 if budget == "quick" else 400
    sizes = (2,) if budget == "quick" else (2, 3, 4)
    return SweepSpec.make(
        "table1",
        RunSpec(kind="lm", steps=steps, lr=1e-3, grad_clip=1.0,
                weight_decay=0.1, seed=0, data_seed=0,
                lm_vocab=512, lm_batch=8, lm_seq=64),
        {"lm_size": sizes, "scheme": TABLE1_SCHEMES},
        label_fmt="table1.n{lm_size}.{scheme}")


def table2_spec(budget: str = "quick") -> SweepSpec:
    """Scaling-law grid (paper Table 2 / Fig. 8): sizes x token budgets x
    stabilized recipes; the benchmark fits Chinchilla on the results."""
    sizes = (1, 2, 3) if budget == "quick" else (1, 2, 3, 4)
    step_budgets = (60, 150) if budget == "quick" else (60, 150, 400)
    schemes = ("e4m3_bf16act",) if budget == "quick" else \
        ("bf16", "e4m3_bf16act", "e5m2_fwd_only")
    return SweepSpec.make(
        "table2",
        RunSpec(kind="lm", lr=1e-3, grad_clip=1.0, weight_decay=0.1,
                seed=0, data_seed=0, lm_vocab=512, lm_batch=8, lm_seq=64),
        {"scheme": schemes, "lm_size": sizes, "steps": step_budgets},
        label_fmt="table2.{scheme}.n{lm_size}.s{steps}")


def demo_spec(budget: str = "quick") -> SweepSpec:
    """CI smoke: 2 schemes x 2 seeds, vectorized, seconds on a laptop."""
    steps = 40 if budget == "quick" else 200
    return SweepSpec.make(
        "demo",
        RunSpec(kind="proxy", d_model=64, n_layers=2, batch_size=128,
                steps=steps, lr=1e-3, spike_factor=10.0, teacher_seed=1),
        {"scheme": ("bf16", "mxfp4_e2m1"), "seed": (0, 1)},
        label_fmt="demo.{scheme}.s{seed}")


SWEEP_PRESETS: Dict[str, object] = {
    "fig2": fig2_spec,
    "fig6": fig6_spec,
    "fig9": fig9_spec,
    "fig10": fig10_specs,
    "table1": table1_spec,
    "table2": table2_spec,
    "demo": demo_spec,
}


def get_sweep_spec(name: str, budget: str = "quick"):
    if name not in SWEEP_PRESETS:
        raise KeyError(f"unknown sweep preset {name!r}; know "
                       f"{sorted(SWEEP_PRESETS)}")
    return SWEEP_PRESETS[name](budget)
