"""Versioned, async checkpoints in the reference's npz format.

Counterpart of ``repro.train.checkpoint``: one ``step_{NNNNNNNN}.npz`` per
checkpoint, keyed by the leaf's ``jax.tree_util.keystr`` path (``['a'][0]``)
with bf16 stored as its uint16 bit pattern under a ``BF16::`` prefix, plus
a ``step_{NNNNNNNN}.json`` meta.  The npz is written to a temporary name
and renamed into place, so ``latest_step`` only sees whole checkpoints; a
:class:`Checkpointer` copies the tree to the host, writes in a background
thread and keeps the newest ``keep`` checkpoints.  Trees are nested
dicts/lists of tensors; a tree in the reference's layout (see
``repro_torch.convert.lm_checkpoint_layout``) reads the same in both
packages.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "Checkpointer"]

_BF16 = "BF16::"


def _items(tree, prefix=""):
    """(keystr, leaf) pairs; dict keys in sorted order, as jax flattens."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _flatten(tree) -> Dict[str, np.ndarray]:
    out = {}
    for key, leaf in _items(tree):
        # a copy even of a CPU tensor: the trainer updates its leaves in
        # place while the writer thread still reads them
        t = torch.as_tensor(leaf).detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            out[_BF16 + key] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            out[key] = t.numpy()
    return out


def _unflatten_like(template, data: Dict[str, np.ndarray]):
    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}['{k}']") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [build(v, f"{prefix}[{i}]") for i, v in enumerate(node)]
        if _BF16 + prefix in data:
            arr = torch.from_numpy(data[_BF16 + prefix].view(np.int16)
                                   .copy()).view(torch.bfloat16)
        elif prefix in data:
            arr = torch.from_numpy(np.array(data[prefix]))
        else:
            raise KeyError(f"checkpoint missing {prefix}")
        like = torch.as_tensor(node)
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{prefix}: shape {tuple(arr.shape)} != "
                             f"{tuple(like.shape)}")
        return arr.to(like.dtype)
    return build(template, "")


def _write(ckpt_dir: str, step: int, flat: Dict[str, np.ndarray],
           meta: Optional[dict]) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step:08d}.npz")
    final = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    np.savez(tmp, **flat)
    if meta is not None:
        with open(os.path.join(ckpt_dir, f"step_{step:08d}.json"), "w") as f:
            json.dump(meta, f)
    os.replace(tmp, final)
    return final


def save(ckpt_dir: str, step: int, tree, meta: Optional[dict] = None) -> str:
    return _write(ckpt_dir, step, _flatten(tree), meta)


def _steps(ckpt_dir: str) -> List[int]:
    return sorted(int(f[5:-4]) for f in os.listdir(ckpt_dir)
                  if f.startswith("step_") and f.endswith(".npz"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, template, step: Optional[int] = None
            ) -> Tuple[Any, dict, int]:
    """Load a checkpoint into the structure of ``template`` (CPU tensors
    in the template's dtypes).  Returns (tree, meta, step)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    with np.load(os.path.join(ckpt_dir, f"step_{step:08d}.npz")) as z:
        data = {k: z[k] for k in z.files}
    meta_path = os.path.join(ckpt_dir, f"step_{step:08d}.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return _unflatten_like(template, data), meta, step


class Checkpointer:
    """Async writer with retention.  ``save()`` copies the tree to the
    host (the device sync) and returns; the write runs in a thread, and
    the previous write is joined first (at most one in flight)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree, meta: Optional[dict] = None):
        self.wait()
        host = _flatten(tree)

        def _write_and_gc():
            _write(self.dir, step, host, meta)
            self._gc()

        self._thread = threading.Thread(target=_write_and_gc, daemon=True)
        self._thread.start()

    def _gc(self):
        for s in _steps(self.dir)[:-self.keep]:
            for ext in (".npz", ".json"):
                p = os.path.join(self.dir, f"step_{s:08d}{ext}")
                if os.path.exists(p):
                    os.remove(p)

    def steps(self) -> List[int]:
        self.wait()
        return _steps(self.dir)
