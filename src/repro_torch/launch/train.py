"""Training command line of the port.

  python -m repro_torch.launch.train --variant full --precision mxfp8_e4m3 \
      --steps 200 --batch 8 --seq 512 [--ckpt-dir DIR] [--resume] \
      [--auto-intervention bf16_activations] [--guard autopilot] \
      [--guard-probe-every 25] [--guard-journal FILE] [--device cuda]

Runs the fault-tolerant Trainer (precision autopilot, spike watchdog,
rollback, precision intervention) on olmo-paper with the deterministic
synthetic LM stream, on ``cuda`` unless ``--device cpu`` is given.
Checkpoints are the JAX reference's npz files, guard state included, so
``python -m repro.launch.train --resume`` can continue a run written
here, and the other way round.  Counterpart of ``repro.launch.train``;
``--mesh`` and the cross-pod compression are ROADMAP Queue A item 6.
"""
from __future__ import annotations

import argparse
import json


def _parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-paper")
    ap.add_argument("--variant", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--precision", default="bf16")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--peak-lr", type=float, default=2e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--auto-intervention", default="bf16_activations")
    ap.add_argument("--guard", default=None,
                    help="precision-autopilot policy: a guard preset "
                         "(autopilot|aggressive|conservative) or a "
                         "declarative schedule sched:STEP=LEVEL|NAME,... "
                         "(first line of defense ahead of the recovery "
                         "watchdog)")
    ap.add_argument("--guard-probe-every", type=int, default=25,
                    help="guard ζ-bound/LN-clamp probe stride in steps "
                         "(0 disables the probes; cheap channels stay on)")
    ap.add_argument("--guard-journal", default=None,
                    help="write the guard transition journal to this JSONL "
                         "path at exit")
    ap.add_argument("--journal", default=None,
                    help="write the run journal (run_start / segment / "
                         "guard / recovery records) to this JSONL path at "
                         "exit")
    ap.add_argument("--log-jsonl", default=None)
    ap.add_argument("--log-every", type=int, default=50,
                    help="host-sync/log window (steps); metrics stay on "
                         "the device between windows")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="sequential microbatches per optimizer step")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without one)")
    return ap.parse_args(argv)


def main(argv=None):
    args = _parse_args(argv)
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import lm_checkpoint_layout
    from repro_torch.core import preset
    from repro_torch.core.diagnostics import tree_leaves_with_path
    from repro_torch.data import lm_batch
    from repro_torch.devices import resolve_device
    from repro_torch.models import lm_init, lm_loss
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig

    device = resolve_device(args.device)
    cfg = get_config(args.arch, args.variant)
    qcfg = preset(args.precision)
    params = lm_init(cfg, torch.Generator().manual_seed(args.seed), device)
    n = sum(t.numel() for _, t in tree_leaves_with_path(params))
    print(f"[train] {cfg.name}: {n / 1e6:.2f}M params on {device}, "
          f"precision {qcfg.describe()}")
    tcfg = TrainerConfig(total_steps=args.steps, peak_lr=args.peak_lr,
                         ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         auto_intervention=args.auto_intervention,
                         log_every=args.log_every,
                         grad_accum=args.grad_accum, guard=args.guard,
                         guard_probe_every=args.guard_probe_every)
    trainer = Trainer(
        loss_fn=lambda p, b, q: lm_loss(p, b, cfg, q), params=params,
        qcfg=qcfg,
        batch_fn=lambda step: lm_batch(step, cfg.vocab, args.batch,
                                       args.seq, args.seed, device=device),
        opt_cfg=AdamWConfig(), tcfg=tcfg,
        ckpt_layout=lm_checkpoint_layout(cfg, device))
    if args.resume and trainer.restore():
        print(f"[train] resumed at step {trainer.step}, precision "
              f"{trainer.qcfg.describe()}")
    hist = trainer.run(args.steps - trainer.step)
    for rec in hist[:: max(len(hist) // 20, 1)]:
        print(f"  step {rec['step']:>6} loss {rec['loss']:.4f} "
              f"gnorm {rec['grad_norm']:.3f} {rec['time_s'] * 1e3:.0f}ms")
    if trainer.events:
        print("[train] events:", json.dumps(trainer.events, indent=1))
    if trainer._controller is not None:
        print(f"[train] guard: level {trainer._controller.level}, "
              f"{len(trainer._controller.journal)} transition(s), final "
              f"precision {trainer.qcfg.describe()}")
        if args.guard_journal:
            trainer._controller.journal.to_jsonl(args.guard_journal)
    if args.journal:
        trainer.events.to_jsonl(args.journal)
    if args.log_jsonl:
        with open(args.log_jsonl, "w") as f:
            for rec in hist:
                f.write(json.dumps(rec) + "\n")
    if hist:
        print(f"[train] final loss {hist[-1]['loss']:.4f}")
    return trainer


if __name__ == "__main__":
    main()
