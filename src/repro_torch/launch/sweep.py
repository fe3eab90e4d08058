"""Sweep launcher of the port (CLI).

  python -m repro_torch.launch.sweep --preset fig6 --budget quick \
      --db runs.jsonl [--mode auto|sequential] [--stop-after N] \
      [--device cuda]

Runs a declarative sweep (a named preset of ``repro_torch.sweep.presets``,
or a SweepSpec JSON file via --spec) through the lane-packed executor on
the card (``--device cpu`` runs the plain versions), appending every
completed run to the JSONL run database.  Re-launching with the same spec
and database *skips* completed runs: kill it mid-grid and run it again.
The database is the reference's, so ``python -m repro.launch.sweep`` can
resume a sweep started here, and the other way round.

Counterpart of ``repro.launch.sweep``.  ``--mesh`` (lanes sharded over a
device mesh) is ROADMAP Queue A item 6 and raises; ``--fake-devices`` is
XLA's host-device emulation, which has no counterpart here.
"""
from __future__ import annotations

import argparse
import sys


def _parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default=None,
                    help="named sweep from repro_torch.sweep.presets")
    ap.add_argument("--spec", default=None,
                    help="path to a SweepSpec JSON file")
    ap.add_argument("--budget", default="quick", choices=["quick", "full"])
    ap.add_argument("--db", default=None,
                    help="JSONL run database (enables resume)")
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "vectorized", "sequential"])
    ap.add_argument("--stop-after", type=int, default=None,
                    help="execute at most N runs this launch")
    ap.add_argument("--by", default="label",
                    help="aggregate report key (label/scheme/lr/seed)")
    ap.add_argument("--journal", default=None,
                    help="write a runtime journal (one sweep_run record per "
                         "run, guard journal inlined) to this JSONL path")
    ap.add_argument("--mesh", default=None,
                    help="not ported (ROADMAP Queue A item 6): raises")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without one)")
    args = ap.parse_args(argv)
    if bool(args.preset) == bool(args.spec):
        ap.error("exactly one of --preset / --spec is required")
    return args


def main(argv=None) -> int:
    args = _parse_args(argv)
    from repro_torch.devices import resolve_device
    from repro_torch.sweep import (RunDB, SweepSpec, aggregate, format_table,
                                   get_sweep_spec, run_sweep)

    if args.mesh:
        from repro_torch.sweep.executor import _MESH
        raise NotImplementedError(_MESH)
    device = resolve_device(args.device)
    if args.preset:
        spec = get_sweep_spec(args.preset, args.budget)
    else:
        with open(args.spec) as f:
            spec = SweepSpec.from_json(f.read())
    specs = spec if isinstance(spec, list) else [spec]
    runs = [r for s in specs for r in s.expand()]
    name = args.preset or specs[0].name
    print(f"[sweep] {name}: {len(runs)} runs on {device}"
          + (f", db {args.db}" if args.db else ""), flush=True)

    db = RunDB(args.db) if args.db else None
    rep = run_sweep(runs, db=db, mode=args.mode, stop_after=args.stop_after,
                    verbose=True, device=device)
    print(f"[sweep] executed {rep.n_executed}, skipped (already in db) "
          f"{rep.n_skipped}" + (", INTERRUPTED by --stop-after"
                                if rep.interrupted else ""))
    done = [rep.results[rid] for rid in rep.order if rid in rep.results]
    print(format_table(aggregate(done, by=args.by)))
    if args.journal:
        from repro_torch.runtime import Journal
        journal = Journal()
        for res in done:
            journal.emit("sweep_run", run_id=res.run_id, label=res.label,
                         scheme=res.scheme, steps=res.steps,
                         divergent=res.divergent,
                         diverge_step=res.diverge_step,
                         guard_journal=list(res.guard_journal))
        journal.to_jsonl(args.journal)
    if db is not None:
        db.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
