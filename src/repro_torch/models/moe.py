"""Mixture-of-Experts: top-k routing with capacity-based sort dispatch.

Counterpart of ``repro.models.moe`` (DeepSeek/Moonlight style): an fp32
softmax router, top-k gates renormalized, a stable argsort dispatch into
per-expert buffers of ``_capacity`` rows (assignments over capacity are
dropped and counted), and the expert GEMMs through ``mx_contract(...,
kind="bmm")``: one launch of each lane GEMM kernel for all experts, whose
rows are the capacity, a multiple of 32 and at least 32.

Dispatch and combine are the reference's gathers (no scatters).  As
autograd Functions their backwards are each other's gathers, so no
gradient is summed with float atomics: the dispatch's gradient gathers
each token's k slots and adds them in slot order j = 0..k-1 in fp32, and
the combine's gradient to the expert buffer gathers each slot's token.
Routing ties: ``torch.topk(sorted=True)`` promises no order between equal
probabilities where ``jax.lax.top_k`` puts the lower index first.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.core import QuantConfig, mx_contract
from .layers import trunc_normal
from .mlp import ACTIVATIONS, GATED

__all__ = ["moe_init", "moe_apply", "route", "dispatch", "combine",
           "ROUTING", "reset_routing"]

#: Routed assignments and dropped ones, summed over every ``moe_apply``
#: since ``reset_routing()``; 0-d tensors on the tokens' device, so the
#: count costs no host sync.
ROUTING: Dict[str, Any] = {}


def reset_routing() -> None:
    ROUTING.clear()


def moe_init(generator: torch.Generator, d_model: int, d_ff: int,
             n_experts: int, act: str = "swiglu", n_layers: int = 1):
    std_in = 1.0 / math.sqrt(d_model)
    std_out = 1.0 / math.sqrt(d_ff * 2 * n_layers)
    p = {"router": trunc_normal((d_model, n_experts), std_in, generator),
         "w_up": trunc_normal((n_experts, d_model, d_ff), std_in, generator),
         "w_down": trunc_normal((n_experts, d_ff, d_model), std_out,
                                generator)}
    if act in GATED:
        p["w_gate"] = trunc_normal((n_experts, d_model, d_ff), std_in,
                                   generator)
    return p


def _capacity(T: int, top_k: int, n_experts: int, factor: float) -> int:
    c = int(factor * T * top_k / n_experts)
    return max(32, (c + 31) // 32 * 32)     # MX-block / lane aligned


class Routing(NamedTuple):
    """Where each assignment (token t's j-th expert, flat index t*k + j)
    sits in the (E, C) expert buffer, and the inverse."""
    tok_of_slot: torch.Tensor      # (E, C) token read by each slot
    assign_of_slot: torch.Tensor   # (E, C) flat assignment of each slot
    valid: torch.Tensor            # (E, C) the slot holds an assignment
    flat_slot: torch.Tensor        # (T*k,) slot of each assignment
    kept: torch.Tensor             # (T*k,) the assignment fit the capacity
    counts: torch.Tensor           # (E,) assignments per expert
    top_k: int


def route(idx: torch.Tensor, n_experts: int, capacity: int) -> Routing:
    """The reference's sort dispatch for top-k expert ids ``idx`` (T, k)."""
    T, k = idx.shape
    E, C = n_experts, capacity
    dev = idx.device
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=E)
    offsets = torch.cumsum(counts, 0) - counts                # exclusive
    c = torch.arange(C, device=dev)
    a_of_slot = torch.clamp(offsets[:, None] + c[None], 0, T * k - 1)
    valid = c[None] < counts[:, None]
    assign_of_slot = order[a_of_slot]
    pos = torch.arange(T * k, device=dev) - offsets[flat_e[order]]
    inv_order = torch.argsort(order, stable=True)             # a -> rank
    pos_a = pos[inv_order]
    kept = pos_a < C
    flat_slot = torch.clamp(flat_e * C + pos_a, 0, E * C - 1)
    return Routing(assign_of_slot // k, assign_of_slot, valid, flat_slot,
                   kept, counts, k)


def _to_slots(x: torch.Tensor, r: Routing, w=None) -> torch.Tensor:
    """(T, D) -> (E, C, D): each slot's token row (times its gate when
    ``w`` (T, k) is given), zero in the empty slots."""
    h = x[r.tok_of_slot]
    if w is not None:
        h = h * w.reshape(-1)[r.assign_of_slot][..., None]
    return h * r.valid[..., None].to(h.dtype)


def _to_tokens(buf: torch.Tensor, r: Routing, w=None) -> torch.Tensor:
    """(E, C, D) -> (T, D): each token's kept slots (times their gates when
    ``w`` is given), added in fp32 in slot order j = 0..k-1 and rounded
    once to ``buf.dtype``."""
    D = buf.shape[-1]
    rows = buf.reshape(-1, D)[r.flat_slot] * r.kept[:, None].to(buf.dtype)
    if w is not None:
        rows = rows * w.reshape(-1, 1)
    rows = rows.reshape(-1, r.top_k, D).to(torch.float32)
    y = rows[:, 0]
    for j in range(1, r.top_k):
        y = y + rows[:, j]
    return y.to(buf.dtype)


class _Dispatch(torch.autograd.Function):
    """h_in = x[tok_of_slot] * valid; dx gathers each token's slots."""

    @staticmethod
    def forward(ctx, x, r: Routing):
        ctx.r = r
        return _to_slots(x, r)

    @staticmethod
    def backward(ctx, dh):
        return _to_tokens(dh, ctx.r), None


class _Combine(torch.autograd.Function):
    """y[t] = sum_j kept * out[flat_slot[t, j]] * w[t, j]; the gradient to
    ``out`` gathers each slot's token times its gate, the gradient to the
    gate ``w`` (T, k) is the row's dot product with its slot, in fp32."""

    @staticmethod
    def forward(ctx, out, w, r: Routing):
        ctx.save_for_backward(out, w)
        ctx.r = r
        return _to_tokens(out, r, w)

    @staticmethod
    def backward(ctx, dy):
        out, w = ctx.saved_tensors
        r = ctx.r
        dout = dw = None
        if ctx.needs_input_grad[0]:
            dout = _to_slots(dy, r, w)
        if ctx.needs_input_grad[1]:
            D = out.shape[-1]
            rows = (out.reshape(-1, D)[r.flat_slot]
                    * r.kept[:, None].to(out.dtype)).to(torch.float32)
            dw = (rows.reshape(-1, r.top_k, D)
                  * dy.to(torch.float32)[:, None]).sum(-1).to(w.dtype)
        return dout, dw, None


def dispatch(x: torch.Tensor, r: Routing) -> torch.Tensor:
    return _Dispatch.apply(x, r)


def combine(out: torch.Tensor, w: torch.Tensor, r: Routing) -> torch.Tensor:
    return _Combine.apply(out, w, r)


def moe_apply(p, x: torch.Tensor, qcfg: QuantConfig, *, top_k: int,
              act: str = "swiglu", capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, dict]:
    """x: (T, D) flat tokens -> (y, metrics): the load-balance
    ``aux_loss`` and the ``dropped_frac`` of assignments over capacity."""
    T, D = x.shape
    E = p["router"].shape[-1]
    C = _capacity(T, top_k, E, capacity_factor)

    logits = x.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1, sorted=True)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    r = route(idx, E, C)

    h_in = dispatch(x, r)                                       # (E, C, D)
    up = mx_contract(h_in, p["w_up"].to(x.dtype), qcfg, kind="bmm")
    if "w_gate" in p:
        g = mx_contract(h_in, p["w_gate"].to(x.dtype), qcfg, kind="bmm")
        h = GATED[act](g) * up
    else:
        h = ACTIVATIONS[act](up)
    out = mx_contract(h, p["w_down"].to(x.dtype), qcfg, kind="bmm")
    y = combine(out, gates.to(out.dtype), r)

    n = max(T * top_k, 1)
    frac = r.counts.to(torch.float32) / n                 # token fraction
    dropped = (~r.kept).sum()
    ROUTING["assignments"] = ROUTING.get("assignments", 0) + T * top_k
    ROUTING["dropped"] = ROUTING.get("dropped", 0) + dropped.detach()
    metrics = {"aux_loss": E * torch.sum(frac * probs.mean(0)),
               "dropped_frac": dropped.to(torch.float32) / n}
    return y, metrics
