"""Move parameters between the JAX reference's layout and the port's.

``params_from_jax(tree, cfg)`` takes either the reference's parameter tree
as numpy arrays (``jax.tree.map(np.asarray, params)``) or the flat dict of
a reference checkpoint npz, keyed by ``jax.tree_util.keystr`` with bf16
stored as ``BF16::`` uint16 (``repro/train/checkpoint.py:26-58``).  The
reference stacks layers by scan group, ``blocks[g]["b{j}"][n_rep, ...]``;
layer ``i`` of the port is entry ``r`` of group ``g``, block ``j``, in plan
order.  Every reference leaf must be used exactly once: a missing leaf,
a shape that differs, or a leaf left over raises.

``params_to_jax(params, cfg)`` is the inverse: the reference's stacked
tree with the port's tensors, stacked on their own device, as leaves
(``.numpy()`` of an fp32 CPU leaf is what ``jax.numpy.asarray`` takes).  ``lm_checkpoint_layout(cfg)`` applies the
pair to a Trainer's whole {"params", "opt"} tree (the AdamW moments and
masters have the parameters' structure), so the port writes and reads
the reference's checkpoints.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.devices import resolve_device
from repro_torch.models import LMConfig, block_plan, check_supported
from repro_torch.models.mlp import GATED

__all__ = ["params_from_jax", "params_to_jax", "param_shapes",
           "lm_checkpoint_layout"]

_BF16 = "BF16::"
_KEY = re.compile(r"\[(?:'([^']*)'|(\d+))\]")


def _dense(i, o):
    return {"w": (i, o)}


def _norm(d, kind):
    return {"scale": (d,), **({"bias": (d,)} if kind == "layernorm"
                              else {})}


def _mlp(cfg: LMConfig, width: int):
    p = {"w_up": _dense(cfg.d_model, width),
         "w_down": _dense(width, cfg.d_model)}
    if cfg.act in GATED:
        p["w_gate"] = _dense(cfg.d_model, width)
    return p


def _mla(cfg: LMConfig):
    """``mla_init``'s leaves (the q_ln/kv_ln norms are RMSNorms whatever
    ``cfg.norm`` says, as in the reference)."""
    D, H = cfg.d_model, cfg.n_heads
    return {"w_dq": _dense(D, cfg.q_lora), "q_ln": _norm(cfg.q_lora,
                                                         "rmsnorm"),
            "w_uq": _dense(cfg.q_lora, H * cfg.qk_dim),
            "w_dkv": _dense(D, cfg.kv_lora),
            "kv_ln": _norm(cfg.kv_lora, "rmsnorm"),
            "w_uk": _dense(cfg.kv_lora, H * cfg.nope_dim),
            "w_uv": _dense(cfg.kv_lora, H * cfg.v_head),
            "w_kr": _dense(D, cfg.rope_dim), "wo": _dense(H * cfg.v_head, D)}


def _rec(cfg: LMConfig):
    """``rec_block_init``'s leaves."""
    D, R = cfg.d_model, cfg.d_rnn
    return {"w_main": _dense(D, R), "w_gate": _dense(D, R),
            "conv_w": (4, R), "conv_b": (R,), "lam": (R,),
            "w_i": _dense(R, R), "w_r": _dense(R, R), "w_out": _dense(R, D)}


def _block_shapes(cfg: LMConfig, kind: str = "attn") -> Dict[str, Any]:
    """One block's parameter tree with shapes as leaves: a dense block, or
    on an MoE config's ``"attn"`` layers the routed experts (``moe``) and
    the shared ones (``shared``); on an MLA config ``attn`` holds the MLA
    projections and norms; a ``"rec"`` block holds ``rec`` in place of
    ``attn``."""
    D, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if kind == "rec":
        return {"ln1": _norm(D, cfg.norm), "rec": _rec(cfg),
                "ln2": _norm(D, cfg.norm), "mlp": _mlp(cfg, cfg.d_ff)}

    if cfg.mla:
        attn = _mla(cfg)
    else:
        attn = {"wq": _dense(D, H * dh), "wk": _dense(D, Hkv * dh),
                "wv": _dense(D, Hkv * dh), "wo": _dense(H * dh, D)}
    if cfg.qkv_bias and not cfg.mla:
        for name, width in (("wq", H * dh), ("wk", Hkv * dh),
                            ("wv", Hkv * dh)):
            attn[name]["b"] = (width,)
    if cfg.qk_norm and not cfg.mla:
        attn["q_norm"] = _norm(dh, "rmsnorm")
        attn["k_norm"] = _norm(dh, "rmsnorm")
    block = {"ln1": _norm(D, cfg.norm), "ln2": _norm(D, cfg.norm),
             "attn": attn}
    if cfg.n_experts and kind == "attn":
        E, F = cfg.n_experts, cfg.moe_dff
        block["moe"] = {"router": (D, E), "w_up": (E, D, F),
                        "w_down": (E, F, D)}
        if cfg.act in GATED:
            block["moe"]["w_gate"] = (E, D, F)
        if cfg.n_shared:
            block["shared"] = _mlp(cfg, cfg.n_shared * F)
    else:
        block["mlp"] = _mlp(cfg, cfg.d_ff)
    return block


def param_shapes(cfg: LMConfig) -> Dict[str, Any]:
    """The port's parameter tree with shapes as leaves, one block of each
    kind: "layer" is the stack's repeated block, an MoE config with
    leading dense layers adds "dense_layer" and a config with ``"rec"``
    blocks "rec_layer"."""
    out = {"embed": {"table": (cfg.vocab, cfg.d_model)},
           "layer": _block_shapes(cfg),
           "final_ln": _norm(cfg.d_model, cfg.norm),
           "lm_head": {"w": (cfg.d_model, cfg.vocab)}}
    kinds = {k for pattern, _ in block_plan(cfg) for k in pattern}
    if "dense_attn" in kinds:
        out["dense_layer"] = _block_shapes(cfg, "dense_attn")
    if "rec" in kinds:
        out["rec_layer"] = _block_shapes(cfg, "rec")
    return out


def _leaves(tree, prefix=()):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _parse_keystr(key: str) -> Tuple:
    parts = tuple(s if s else int(i) for s, i in _KEY.findall(key))
    if "".join(f"['{p}']" if isinstance(p, str) else f"[{p}]"
               for p in parts) != key:
        raise ValueError(f"not a jax keystr path: {key!r}")
    return parts


def _to_tensor(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _flat(tree_or_npz) -> Dict[Tuple, torch.Tensor]:
    flat = {}
    if all(isinstance(k, str) and k.removeprefix(_BF16).startswith("[")
           for k in tree_or_npz):
        for key, arr in tree_or_npz.items():
            if key.startswith(_BF16):
                t = torch.from_numpy(np.asarray(arr).view(np.int16).copy())
                flat[_parse_keystr(key[len(_BF16):])] = t.view(torch.bfloat16)
            else:
                flat[_parse_keystr(key)] = _to_tensor(arr)
        return flat
    for path, leaf in _leaves(tree_or_npz):
        flat[path] = _to_tensor(leaf)
    return flat


def params_from_jax(tree_or_npz, cfg: LMConfig, device=None) -> dict:
    """The port's parameters from the reference's tree or checkpoint dict,
    on ``device`` (default ``cuda``), in the reference's dtypes."""
    check_supported(cfg)
    device = resolve_device(device)
    flat = _flat(tree_or_npz)
    shapes = param_shapes(cfg)

    def take(path, shape):
        if path not in flat:
            raise KeyError(f"reference parameters lack {path}")
        t = flat.pop(path)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{path}: shape {tuple(t.shape)} != {shape}")
        return t

    def build(shape_tree, prefix):
        return {k: (build(v, prefix + (k,)) if isinstance(v, dict)
                    else take(prefix + (k,), v).to(device))
                for k, v in shape_tree.items()}

    params = {k: build(shapes[k], (k,))
              for k in ("embed", "final_ln", "lm_head")}
    layers = []
    for g, (pattern, n_rep) in enumerate(block_plan(cfg)):
        group = [dict() for _ in range(n_rep * len(pattern))]
        for j, kind in enumerate(pattern):
            for sub, shape in _leaves(_block_shapes(cfg, kind)):
                stacked = take(("blocks", g, f"b{j}") + sub,
                               (n_rep,) + tuple(shape))
                for r in range(n_rep):
                    node = group[r * len(pattern) + j]
                    for key in sub[:-1]:
                        node = node.setdefault(key, {})
                    node[sub[-1]] = stacked[r].to(device)
        layers.extend(group)
    params["layers"] = layers
    if flat:
        raise ValueError(f"reference leaves not used by the port: "
                         f"{sorted(map(str, flat))}")
    return params


def params_to_jax(params, cfg: LMConfig) -> dict:
    """The reference's parameter tree (layers stacked by scan group,
    ``blocks[g]["b{j}"][n_rep, ...]``) with the port's tensors, detached,
    in their own dtypes and on their own device."""
    check_supported(cfg)
    out = {k: {kk: vv.detach() for kk, vv in params[k].items()}
           for k in ("embed", "final_ln", "lm_head")}
    layers = params["layers"]
    blocks, i = [], 0
    for pattern, n_rep in block_plan(cfg):
        group = {}
        for j in range(len(pattern)):
            reps = [layers[i + r * len(pattern) + j] for r in range(n_rep)]
            group[f"b{j}"] = _stack(reps)
        blocks.append(group)
        i += n_rep * len(pattern)
    out["blocks"] = blocks
    return out


def _stack(trees):
    if isinstance(trees[0], Mapping):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack([t.detach() for t in trees])


def lm_checkpoint_layout(cfg: LMConfig, device=None):
    """(to_ref, from_ref) for a Trainer's {"params", "opt"} tree: the
    parameters and the AdamW ``m``, ``v`` and ``master`` trees go to and
    from the reference's stacked layout; ``count`` stays as it is.
    ``to_ref`` stacks on the tensors' own device (the checkpoint writer
    moves them to the host; the guard's probes read the stacked leaves
    as the reference's do); ``from_ref`` places the tensors on
    ``device`` (default ``cuda``)."""
    def to_ref(tree):
        opt = {k: (params_to_jax(v, cfg) if k in ("m", "v", "master")
                   else v) for k, v in tree["opt"].items()}
        return {"params": params_to_jax(tree["params"], cfg), "opt": opt}

    def from_ref(tree):
        opt = {k: (params_from_jax(v, cfg, device)
                   if k in ("m", "v", "master") else v)
               for k, v in tree["opt"].items()}
        return {"params": params_from_jax(tree["params"], cfg, device),
                "opt": opt}
    return to_ref, from_ref
