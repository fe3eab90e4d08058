"""snapshot_to_serve: hand a mid-training model to the serving engine.

Counterpart of ``repro.runtime.bridge``.  The Trainer's live parameters
become a ``ServeEngine`` (or ``PagedServeEngine``) on the training
device: no checkpoint write, no host round trip, so online evaluation
samples the exact model state the run is at.

Aliasing: the Trainer's AdamW updates its parameter tensors in place, and
the engine's ``serving_params`` keeps a tensor as it is when it is
already on the device (and in bf16, for weights).  An engine built on the
trainer's own leaves would see the next ``trainer.run()`` rewrite its
weights.  The snapshot therefore clones every leaf first (the port's
form of the reference's rule against aliasing donated buffers); the
clone is also what makes the engine's tokens bitwise those of an engine
built from a checkpoint of the same step.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

__all__ = ["snapshot_to_serve"]


def snapshot_to_serve(trainer, cfg, *, paged: bool = False,
                      max_batch: int = 4, max_len: int = 256,
                      eos_id: Optional[int] = None, **engine_kwargs) -> Any:
    """Build a ServeEngine (``PagedServeEngine`` with ``paged=True``)
    around a copy of ``trainer.params`` under the trainer's *current*
    qcfg, on the parameters' device unless ``device`` is given.

    ``cfg`` is the LMConfig the trainer's loss closes over (the Trainer
    does not hold it).  Other keyword arguments go to the engine
    (``n_pages``, ``page_size``, ``bucket_prompts``, ...).  Appends a
    ``snapshot_to_serve`` record to the trainer's journal."""
    from repro_torch.core.diagnostics import tree_leaves_with_path
    from repro_torch.models import tree_map
    from repro_torch.serve import PagedServeEngine, ServeEngine

    with torch.no_grad():
        params = tree_map(lambda t: t.detach().clone(), trainer.params)
    _, first = next(tree_leaves_with_path(params))
    engine_kwargs.setdefault("device", first.device)
    kind = PagedServeEngine if paged else ServeEngine
    engine = kind(params, cfg, trainer.qcfg, max_batch=max_batch,
                  max_len=max_len, eos_id=eos_id, **engine_kwargs)
    trainer.events.append({
        "event": "snapshot_to_serve", "step": int(trainer.step),
        "qcfg": trainer.qcfg.describe(), "paged": bool(paged),
        "segment_index": getattr(getattr(trainer, "_segments", None),
                                 "index", 0)})
    return engine

