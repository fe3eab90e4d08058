"""Griffin / RecurrentGemma recurrent block: conv1d + RG-LRU.

Counterpart of ``repro.models.rglru``.  The RG-LRU recurrence

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(-c softplus(lam) sigmoid(r_t)),

is a chain of vector ops that runs in fp32 and is not MX-quantized (the
paper's App. A); every projection around it (gates, branches, output) is
an MX GEMM through ``qdense``.  The reference computes the recurrence
outside any Pallas kernel, so the port keeps it in plain PyTorch, in the
reference's order of operations:

  * the causal width-4 conv sums its terms in bf16 in a different order in
    prefill (``w[3] x`` first, then the shifted terms) and in decode
    (``sum_j w[j] full[j:]``), as the reference does;
  * softplus is ``max(x, 0) + log1p(exp(-|x|))`` with the derivative
    ``exp(x - softplus(x))`` (``jax.nn.softplus``); PyTorch's switches to
    ``x`` above 20;
  * training and prefill scan with ``jax.lax.associative_scan``'s log-depth
    odd/even combine tree (``_associative_scan``), so the fp32 products and
    sums come in the reference's order and autograd gives the backward:
    about 2 log2(T) levels of whole-tensor ops a layer, not T launches;
  * ``h`` leaves the scan in the input's dtype, ``h_last`` in fp32, and
    decode carries fp32 ``h``.

The decode step updates its ``{"conv", "h"}`` cache in place, as the
attention layers update theirs.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import QuantConfig
from .layers import conv_tail, dense_init, qdense, trunc_normal

__all__ = ["rec_block_init", "rec_block_apply", "rec_block_decode",
           "rec_block_prefill", "rglru_scan", "rglru_step"]

_C = 8.0           # Griffin's fixed gate sharpness
_CONV_W = 4        # temporal conv width


def rec_block_init(generator: torch.Generator, d_model: int, d_rnn: int,
                   n_layers: int = 1):
    gd = generator.device
    # lam so that a lies in (0.9, 0.999) at sigmoid(r) = 0.5 (Griffin's
    # appendix): the inverse softplus of -2 log(u) / c.
    u = torch.empty((d_rnn,), dtype=torch.float32, device=gd).uniform_(
        0.9, 0.999, generator=generator)
    lam = torch.log(torch.expm1(-torch.log(u) * 2.0 / _C))
    return {
        "w_main": dense_init(generator, d_model, d_rnn),
        "w_gate": dense_init(generator, d_model, d_rnn),
        "conv_w": trunc_normal((_CONV_W, d_rnn), 1.0 / math.sqrt(_CONV_W),
                               generator),
        "conv_b": torch.zeros((d_rnn,), dtype=torch.float32, device=gd),
        "lam": lam,
        "w_i": dense_init(generator, d_rnn, d_rnn),
        "w_r": dense_init(generator, d_rnn, d_rnn),
        "w_out": dense_init(generator, d_rnn, d_model,
                            std=1.0 / math.sqrt(d_rnn * 2 * n_layers)),
    }


class _Softplus(torch.autograd.Function):
    """``jax.nn.softplus``: logaddexp(x, 0), with its derivative
    exp(x - softplus(x))."""

    @staticmethod
    def forward(ctx, x):
        y = torch.maximum(x, torch.zeros_like(x)) + torch.log1p(
            torch.exp(-torch.abs(x)))
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * torch.exp(x - y)


def _conv1d(p, x: torch.Tensor, state: Optional[torch.Tensor] = None):
    """Causal depthwise conv, width 4, in x's dtype.  x (B, T, d); state
    (B, 3, d), the last three inputs before x.  Returns (y, new state or
    None)."""
    w = p["conv_w"].to(x.dtype)
    if state is None:
        pads = torch.zeros_like(x[:, :1])
        y = w[-1] * x
        shifted = x
        for j in range(1, _CONV_W):
            shifted = torch.cat([pads, shifted[:, :-1]], 1)
            y = y + w[_CONV_W - 1 - j] * shifted
        new_state = None
    else:
        full = torch.cat([state.to(x.dtype), x], 1)         # (B, 3+T, d)
        T = x.shape[1]
        y = sum(w[j] * full[:, j:j + T] for j in range(_CONV_W))
        new_state = full[:, -(_CONV_W - 1):]
    return y + p["conv_b"].to(x.dtype), new_state


def _combine(u, v):
    (a1, b1), (a2, b2) = u, v
    return a2 * a1, a2 * b1 + b2


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a at the even positions of axis 1, b at the odd (a one longer or of
    b's length)."""
    n = b.shape[1]
    out = torch.stack([a[:, :n], b], 2).flatten(1, 2)
    return torch.cat([out, a[:, n:]], 1) if a.shape[1] > n else out


def _associative_scan(elems):
    """``jax.lax.associative_scan(_combine, elems, axis=1)`` with the same
    recursion: pairs (0, 1), (2, 3), ... reduced, scanned, then the even
    positions combined from the odd results."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine([e[:, 0:n - 1:2] for e in elems],
                       [e[:, 1::2] for e in elems])
    odd = _associative_scan(reduced)
    if n % 2 == 0:
        even = _combine([e[:, :-1] for e in odd],
                        [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], 1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def _gates(p, x: torch.Tensor, qcfg: QuantConfig):
    """(a, b) of the recurrence for inputs x (..., d), in fp32."""
    i = torch.sigmoid(qdense(p["w_i"], x, qcfg).to(torch.float32))
    r = torch.sigmoid(qdense(p["w_r"], x, qcfg).to(torch.float32))
    log_a = -_C * _Softplus.apply(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * x.to(torch.float32))
    return a, b


def rglru_scan(p, x: torch.Tensor, qcfg: QuantConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU over x (B, T, d) from a zero state.  Returns (h (B, T, d) in
    x.dtype, h_last (B, d) fp32)."""
    a, b = _gates(p, x, qcfg)
    h = _associative_scan([a, b])[1]
    return h.to(x.dtype), h[:, -1]


def rglru_step(p, x_t: torch.Tensor, h: torch.Tensor, qcfg: QuantConfig):
    """One step of the recurrence.  x_t (B, d); h (B, d) fp32.  Returns
    (h_new in x_t.dtype, h_new fp32)."""
    a, b = _gates(p, x_t, qcfg)
    h_new = a * h + b
    return h_new.to(x_t.dtype), h_new


def rec_block_apply(p, x: torch.Tensor, qcfg: QuantConfig) -> torch.Tensor:
    """The temporal-mixing block for training.  x (B, T, D)."""
    return rec_block_prefill(p, x, qcfg)[0]


def rec_block_prefill(p, x: torch.Tensor, qcfg: QuantConfig):
    """The block over a whole sequence plus its decode cache: the last
    three conv inputs (zero-padded on the left below T 3) and the scan's
    fp32 tail, what stepping ``rec_block_decode`` over x would carry."""
    gate = F.gelu(qdense(p["w_gate"], x, qcfg), approximate="tanh")
    main = qdense(p["w_main"], x, qcfg)
    c, _ = _conv1d(p, main)
    h, h_last = rglru_scan(p, c, qcfg)
    out = qdense(p["w_out"], h * gate, qcfg)
    return out, {"conv": conv_tail(main, _CONV_W - 1), "h": h_last}


def rec_block_decode(p, x: torch.Tensor, cache: dict, qcfg: QuantConfig):
    """One-token step.  x (B, 1, D); cache {"conv": (B, 3, d) bf16, "h":
    (B, d) fp32}, updated in place.  Returns (out (B, 1, D), cache)."""
    gate = F.gelu(qdense(p["w_gate"], x, qcfg), approximate="tanh")
    main = qdense(p["w_main"], x, qcfg)
    c, conv_state = _conv1d(p, main, cache["conv"])
    y_t, h_new = rglru_step(p, c[:, 0], cache["h"], qcfg)
    out = qdense(p["w_out"], y_t[:, None] * gate, qcfg)
    cache["conv"].copy_(conv_state)
    cache["h"].copy_(h_new)
    return out, cache
