"""Lane-packed sweep orchestration for thousand-run instability studies.

Counterpart of ``repro.sweep``.  The paper's evidence is statistical (~1000
runs over seeds x precision schemes x scales):

  spec      declarative SweepSpec/RunSpec grids with the reference's run_ids
  executor  lane-packed proxy engine on the card (+ the Trainer for LM runs)
  db        persistent JSONL run database; crash -> re-launch skips
            completed runs (in either package)
  stats     spike/divergence-rate aggregation from run summaries
  presets   the paper's fig/table experiments as declarative specs

CLI: ``python -m repro_torch.launch.sweep --preset fig6 --db runs.jsonl``.
"""
from .db import RunDB
from .executor import (ProxyPack, RunResult, SweepReport, lm_config,
                       run_sweep)
from .presets import SWEEP_PRESETS, get_sweep_spec
from .spec import LANE_FIELDS, RunSpec, SweepSpec, group_key
from .stats import aggregate, format_table

__all__ = ["RunDB", "RunResult", "SweepReport", "ProxyPack", "run_sweep",
           "lm_config", "SWEEP_PRESETS", "get_sweep_spec", "LANE_FIELDS",
           "RunSpec", "SweepSpec", "group_key", "aggregate", "format_table"]
