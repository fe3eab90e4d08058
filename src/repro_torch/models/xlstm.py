"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

Counterpart of ``repro.models.xlstm``, function for function.  xlstm-1.3b
has no separate FFN: the mLSTM block carries a projection-factor-2 up and
down path, and the sLSTM block is followed by a GeGLU FFN of factor 4/3.

The cells are exponentially gated with the max-stabilizer state ``m``
(xLSTM Eq. 15-19).  Their recurrences are vector ops in fp32 and are not
MX-quantized (the paper's App. A); every projection around them (up, q,
k, v, the gates, down, the sLSTM's input gates, output and FFN) is an MX
GEMM through ``qdense``.  The reference computes the cells in plain
``jnp`` outside any Pallas kernel, so the port keeps them in plain
PyTorch, in the reference's order of operations:

  * ``jax.nn.silu`` is x / (1 + exp(-x)) as x * (1 / (1 + exp(-x))), each
    op rounded in x's dtype (bf16 here: ``F.silu`` rounds once and differs
    in 40% of outputs), and ``jax.nn.log_sigmoid`` is -softplus(-x) with
    softplus's derivative (``_silu``, ``_log_sigmoid``).  The sLSTM's
    step, which launches once a position, takes PyTorch's one-kernel
    ``logsigmoid`` and ``sigmoid`` instead (fp32 ulps from the
    reference's forms);
  * the causal width-4 conv sums its bf16 terms in prefill order
    (``w[3] x`` first, then the shifted terms) or decode order
    (``sum_j w[j] full[j:]``), as the reference does;
  * a prompt of ``2 * MLSTM_CHUNK`` tokens or more runs the chunkwise
    form, a shorter one the step scan (``_mlstm_forward``).  The chunkwise
    form carries its state under the chunk-end stabilizer, the recurrent
    ``m`` summed in another order, so prefill logits and caches depend on
    the form in their last bits, as in the reference; decode continues
    from whichever state prefill left;
  * the chunkwise form pads a ragged last chunk with f = 1e30 and i =
    -1e30, exact no-ops, and masks the causal exponents before ``exp``;
  * the sLSTM runs a Python loop over time (the reference's
    ``lax.scan``): about twenty launches a position forward, more in the
    backward, so it is bound by the host.  Its input preactivations are
    permuted to the step's (B, H, 4 dh) layout for all positions at
    once.

Decode updates its cache in place, as the attention layers update theirs:
the mLSTM's ``{"conv", "C", "n", "m"}`` and the sLSTM's ``{"c", "n", "m",
"h"}``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import QuantConfig
from .layers import (apply_norm, conv_tail, dense_init, norm_init, qdense,
                     trunc_normal)
from .mlp import mlp_apply, mlp_init
from .rglru import _Softplus

__all__ = ["mlstm_init", "mlstm_apply", "mlstm_decode", "mlstm_prefill",
           "slstm_init", "slstm_apply", "slstm_decode", "slstm_prefill",
           "MLSTM_CHUNK", "mlstm_dims", "slstm_ff"]

_PF = 2            # mLSTM projection factor
_CONV_W = 4
#: The chunk of the chunkwise mLSTM form, and half the prompt length from
#: which ``_mlstm_forward`` takes it.
MLSTM_CHUNK = 64
#: The stabilizer's start: the reference's initial ``m`` (-1e30, not -inf,
#: so ``m - m_new`` stays finite).
M_INIT = -1e30


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * (1 / (1 + torch.exp(-x)))


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return -_Softplus.apply(-x)


def _conv1d(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
            state: Optional[torch.Tensor] = None):
    """Causal depthwise conv of width 4 in x's dtype.  x (B, T, d); state
    (B, 3, d), the three inputs before x.  Returns (y, new state or
    None)."""
    if state is None:
        pads = torch.zeros_like(x[:, :1])
        y = w[-1] * x
        shifted = x
        for j in range(1, _CONV_W):
            shifted = torch.cat([pads, shifted[:, :-1]], 1)
            y = y + w[_CONV_W - 1 - j] * shifted
        new_state = None
    else:
        full = torch.cat([state.to(x.dtype), x], 1)
        T = x.shape[1]
        y = sum(w[j] * full[:, j:j + T] for j in range(_CONV_W))
        new_state = full[:, -(_CONV_W - 1):]
    return y + b, new_state


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------
def mlstm_init(generator: torch.Generator, d_model: int, n_heads: int,
               n_layers: int = 1):
    d_in = _PF * d_model
    gd = generator.device
    return {
        "w_up": dense_init(generator, d_model, 2 * d_in),
        "conv_w": trunc_normal((_CONV_W, d_in), 0.5, generator),
        "conv_b": torch.zeros((d_in,), dtype=torch.float32, device=gd),
        "w_q": dense_init(generator, d_in, d_in),
        "w_k": dense_init(generator, d_in, d_in),
        "w_v": dense_init(generator, d_in, d_in),
        "w_i": dense_init(generator, d_in, n_heads),
        "w_f": dense_init(generator, d_in, n_heads),
        "skip_scale": torch.ones((d_in,), dtype=torch.float32, device=gd),
        "out_ln": norm_init(d_in, device=gd),
        "w_down": dense_init(generator, d_in, d_model,
                             std=1.0 / math.sqrt(d_in * 2 * n_layers)),
    }


def _mlstm_state(B: int, H: int, dh: int, device):
    return (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=device),
            torch.zeros((B, H, dh), dtype=torch.float32, device=device),
            torch.full((B, H), M_INIT, dtype=torch.float32, device=device))


def _mlstm_cell_step(carry, inp):
    """One step of the stabilized mLSTM recurrence, per head.
    carry: C (B, H, dk, dv), n (B, H, dk), m (B, H); inp: q, k, v (B, H,
    d), i and f preactivations (B, H).  Returns (carry, h (B, H, dv))."""
    C, n, m = carry
    q, k, v, it, ft = inp
    logf = _log_sigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    i_g = torch.exp(it - m_new)
    f_g = torch.exp(logf + m - m_new)
    C = f_g[..., None, None] * C + i_g[..., None, None] \
        * (k[..., :, None] * v[..., None, :])
    n = f_g[..., None] * n + i_g[..., None] * k
    denom = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", n, q)),
                          torch.exp(-m_new))
    h = torch.einsum("bhkv,bhk->bhv", C, q) / denom[..., None]
    return (C, n, m_new), h


def _mlstm_scan(q, k, v, it, ft, state=None):
    """q, k, v (B, T, H, dh) fp32; it, ft (B, T, H).  Steps the cell over
    T.  Returns (h (B, T, H, dh), state (C, n, m))."""
    B, T, H, dh = q.shape
    if state is None:
        state = _mlstm_state(B, H, dh, q.device)
    hs = []
    for t in range(T):
        state, h = _mlstm_cell_step(state, (q[:, t], k[:, t], v[:, t],
                                            it[:, t], ft[:, t]))
        hs.append(h)
    return torch.stack(hs, 1), state


def _chunk_carry(C, n, m_prev, a, g, m_row, kt, vt):
    """The state after a chunk, under the chunk-end stabilizer m_W (the
    recurrent m at the chunk's end): (C', n', m' = G + m_W)."""
    m_c = m_row[..., -1]
    w = torch.exp(a - m_c[..., None])
    ic = torch.exp(m_prev - m_c)
    C = (ic[..., None, None] * C
         + torch.einsum("bhj,bhjd,bhjv->bhdv", w, kt, vt))
    n = ic[..., None] * n + torch.einsum("bhj,bhjd->bhd", w, kt)
    return C, n, g[..., -1] + m_c


def _mlstm_chunkwise(q, k, v, it, ft, state=None, chunk: int = MLSTM_CHUNK):
    """The chunkwise-parallel stabilized mLSTM (TFLA-style): within a chunk
    of W steps an attention-like (W, W) product with gate-derived decay
    weights, across chunks the carried state.

      g_i   = cumsum(log f)                (within the chunk)
      m_i   = max(m_prev, max_{j<=i}(i_j - g_j));  M_i = g_i + m_i
      num_i = e^{m_prev-m_i} q_i C + sum_{j<=i} (q_i.k_j) e^{i_j-g_j-m_i} v_j
      den_i = e^{m_prev-m_i} q_i n + sum_{j<=i} (q_i.k_j) e^{i_j-g_j-m_i}
      h_i   = num_i / max(|den_i|, e^{-M_i})
      C'    = e^{m_prev-m_W} C + sum_j e^{i_j-g_j-m_W} k_j v_j^T;
      m'    = G + m_W  (the chunk-end stabilizer, ``_chunk_carry``)

    Returns (h (B, T, H, dh), state (C, n, m))."""
    B, T, H, dh = q.shape
    W = min(chunk, T)
    if T % W:
        pad = (-T) % W
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
        # padded steps are exact no-ops: f = 1 (no decay of the carried
        # state) and i = -inf (no write), so the state is step T's
        ft = torch.cat([ft, ft.new_full((B, pad, H), 1e30)], 1)
        it = torch.cat([it, it.new_full((B, pad, H), -1e30)], 1)
    Tp = q.shape[1]
    nc = Tp // W
    if state is None:
        state = _mlstm_state(B, H, dh, q.device)

    def cs(x):      # (B, Tp, H, d) -> (nc, B, H, W, d)
        return x.reshape(B, nc, W, H, -1).permute(1, 0, 3, 2, 4)
    qc, kc, vc = cs(q), cs(k), cs(v)
    itc = it.reshape(B, nc, W, H).permute(1, 0, 3, 2)
    ftc = ft.reshape(B, nc, W, H).permute(1, 0, 3, 2)
    causal = torch.ones((W, W), dtype=torch.bool, device=q.device).tril()

    C, n, m_prev = state
    hs = []
    for c in range(nc):
        qt, kt, vt, itx, ftx = qc[c], kc[c], vc[c], itc[c], ftc[c]
        logf = _log_sigmoid(ftx)
        g = torch.cumsum(logf, dim=-1)                       # (B, H, W)
        a = itx - g                                          # i_j - g_j
        # the row's running stabilizer equals the recurrent m_i
        m_row = torch.maximum(m_prev[..., None],
                              torch.cummax(a, dim=-1).values)
        # mask BEFORE exp: a future (j > i) exponent can overflow, and
        # inf * 0 = NaN if masked after
        expo = torch.where(causal, a[..., None, :] - m_row[..., :, None],
                           -math.inf)
        w2 = torch.exp(expo)
        inter = torch.exp(m_prev[..., None] - m_row)         # (B, H, W)
        s = torch.einsum("bhid,bhjd->bhij", qt, kt)
        sw = s * w2
        num = (inter[..., None] * torch.einsum("bhid,bhdv->bhiv", qt, C)
               + torch.einsum("bhij,bhjv->bhiv", sw, vt))
        den = (inter * torch.einsum("bhid,bhd->bhi", qt, n)
               + torch.sum(sw, dim=-1))
        M = g + m_row
        hs.append(num / torch.maximum(torch.abs(den),
                                      torch.exp(-M))[..., None])
        C, n, m_prev = _chunk_carry(C, n, m_prev, a, g, m_row, kt, vt)
    # (nc, B, H, W, dv) -> (B, T, H, dv)
    h = torch.stack(hs).permute(1, 0, 3, 2, 4).reshape(B, Tp, H, dh)
    return h[:, :T], (C, n, m_prev)


def _mlstm_qkvif(p, u, qcfg: QuantConfig, n_heads: int):
    B, T, d_in = u.shape
    dh = d_in // n_heads
    q = qdense(p["w_q"], u, qcfg).reshape(B, T, n_heads, dh).float()
    k = qdense(p["w_k"], u, qcfg).reshape(B, T, n_heads, dh).float()
    k = k / math.sqrt(dh)
    v = qdense(p["w_v"], u, qcfg).reshape(B, T, n_heads, dh).float()
    it = qdense(p["w_i"], u, qcfg).float()
    ft = qdense(p["w_f"], u, qcfg).float() + 3.0            # forget bias
    return q, k, v, it, ft


def _mlstm_in(p, x, qcfg: QuantConfig, n_heads: int,
              conv_state: Optional[torch.Tensor] = None):
    """The block's front: the up projection split into the cell's branch u
    and the gate z, the causal conv (over the whole of x, or stepped from
    ``conv_state``) and silu, then q, k, v and the gates' preactivations.
    Returns (u, z, u_c, the new conv state or None, (q, k, v, it, ft))."""
    up = qdense(p["w_up"], x, qcfg)
    u, z = torch.chunk(up, 2, dim=-1)
    u_c, conv = _conv1d(p["conv_w"].to(u.dtype), p["conv_b"].to(u.dtype), u,
                        conv_state)
    u_c = _silu(u_c)
    return u, z, u_c, conv, _mlstm_qkvif(p, u_c, qcfg, n_heads)


def _mlstm_out(p, x, h, u_c, z, qcfg: QuantConfig):
    """The block's tail: out_ln of the cell output, the skip, the z gate
    and the down projection."""
    h = h.reshape(x.shape[0], x.shape[1], -1).to(x.dtype)
    h = apply_norm(p["out_ln"], h, qcfg) + p["skip_scale"].to(x.dtype) * u_c
    return qdense(p["w_down"], h * _silu(z), qcfg)


def _mlstm_forward(p, x, qcfg: QuantConfig, n_heads: int):
    """The block over a whole sequence.  Returns (out, conv carry, cell
    state (C, n, m))."""
    u, z, u_c, _, gates = _mlstm_in(p, x, qcfg, n_heads)
    if x.shape[1] >= 2 * MLSTM_CHUNK:
        h, state = _mlstm_chunkwise(*gates)
    else:
        h, state = _mlstm_scan(*gates)
    return (_mlstm_out(p, x, h, u_c, z, qcfg), conv_tail(u, _CONV_W - 1),
            state)


def mlstm_apply(p, x: torch.Tensor, qcfg: QuantConfig, n_heads: int
                ) -> torch.Tensor:
    return _mlstm_forward(p, x, qcfg, n_heads)[0]


def mlstm_prefill(p, x: torch.Tensor, qcfg: QuantConfig, n_heads: int):
    """The block over a prompt plus its decode cache: the last three
    inputs of the conv (the pre-conv up projection) and the cell state
    at step T (the chunkwise form's or the scan's, as ``_mlstm_forward``
    chose)."""
    out, conv, (C, n, m) = _mlstm_forward(p, x, qcfg, n_heads)
    return out, {"conv": conv, "C": C, "n": n, "m": m}


def mlstm_decode(p, x: torch.Tensor, cache: dict, qcfg: QuantConfig,
                 n_heads: int):
    """One-token step.  x (B, 1, D); cache {"conv": (B, 3, d_in) bf16, "C":
    (B, H, dh, dh), "n": (B, H, dh), "m": (B, H) fp32}, updated in place.
    Returns (out (B, 1, D), cache)."""
    _, z, u_c, conv, (q, k, v, it, ft) = _mlstm_in(p, x, qcfg, n_heads,
                                                   cache["conv"])
    (C, n, m), h = _mlstm_cell_step((cache["C"], cache["n"], cache["m"]),
                                    (q[:, 0], k[:, 0], v[:, 0], it[:, 0],
                                     ft[:, 0]))
    out = _mlstm_out(p, x, h, u_c, z, qcfg)
    for name, t in (("conv", conv), ("C", C), ("n", n), ("m", m)):
        cache[name].copy_(t)
    return out, cache


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------
def slstm_ff(d_model: int) -> int:
    """The sLSTM block's GeGLU width: 4/3 d_model in multiples of 32."""
    return int(4 * d_model / 3 / 32) * 32


def slstm_init(generator: torch.Generator, d_model: int, n_heads: int,
               n_layers: int = 1):
    dh = d_model // n_heads
    gd = generator.device
    return {
        "w_gates": dense_init(generator, d_model, 4 * d_model),  # i,f,z,o
        "r_gates": trunc_normal((n_heads, dh, 4 * dh), 1.0 / math.sqrt(dh),
                                generator),
        "ffn_ln": norm_init(d_model, device=gd),
        "ffn": mlp_init(generator, d_model, slstm_ff(d_model), act="geglu",
                        n_layers=n_layers),
        "out_ln": norm_init(d_model, device=gd),
        "w_out": dense_init(generator, d_model, d_model,
                            std=1.0 / math.sqrt(d_model * 2 * n_layers)),
    }


def _slstm_gates(wx: torch.Tensor, n_heads: int) -> torch.Tensor:
    """The input preactivations (..., 4 D), gate-major as w_gates gives
    them, in the step's head-major (..., H, 4 dh) layout."""
    lead = wx.shape[:-1]
    dh = wx.shape[-1] // (4 * n_heads)
    x = wx.reshape(lead + (4, n_heads, dh)).transpose(-3, -2)
    return x.reshape(lead + (n_heads, 4 * dh))


def _slstm_cell(p_r, carry, z_in):
    """One step on head-major preactivations z_in (B, H, 4 dh).  carry: c,
    n, m, h, all (B, H, dh).  Returns (carry, h)."""
    c, n, m, h = carry
    z_all = z_in + torch.einsum("bhd,hde->bhe", h, p_r)
    it, ft, zt, ot = torch.chunk(z_all, 4, dim=-1)
    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    i_g = torch.exp(it - m_new)
    f_g = torch.exp(logf + m - m_new)
    c = f_g * c + i_g * torch.tanh(zt)
    n = f_g * n + i_g
    h_new = torch.sigmoid(ot) * c / torch.clamp(n, min=1e-6)
    return (c, n, m_new, h_new), h_new


def _slstm_step(p_r, carry, wx_t, n_heads: int):
    """carry: c, n, m, h, all (B, H, dh); wx_t (B, 4 D), the input
    preactivation.  Returns (carry, h)."""
    return _slstm_cell(p_r, carry, _slstm_gates(wx_t, n_heads))


def _slstm_state(B: int, H: int, dh: int, device):
    z = lambda: torch.zeros((B, H, dh), dtype=torch.float32,  # noqa: E731
                            device=device)
    return (z(), z(), torch.full((B, H, dh), M_INIT, dtype=torch.float32,
                                 device=device), z())


def _slstm_ffn(p, y, qcfg: QuantConfig):
    """The post-GeGLU FFN (factor 4/3) with its pre-norm residual."""
    return y + mlp_apply(p["ffn"], apply_norm(p["ffn_ln"], y, qcfg), qcfg,
                         act="geglu")


def _slstm_forward(p, x, qcfg: QuantConfig, n_heads: int):
    """The block over a whole sequence.  Returns (out, final carry)."""
    B, T, D = x.shape
    z_in = _slstm_gates(qdense(p["w_gates"], x, qcfg).float(), n_heads)
    p_r = p["r_gates"].float()
    carry = _slstm_state(B, n_heads, D // n_heads, x.device)
    hs = []
    for t in range(T):
        carry, h = _slstm_cell(p_r, carry, z_in[:, t])
        hs.append(h)
    h = torch.stack(hs, 1).reshape(B, T, D).to(x.dtype)
    y = qdense(p["w_out"], apply_norm(p["out_ln"], h, qcfg), qcfg)
    return _slstm_ffn(p, y, qcfg), carry


def slstm_apply(p, x: torch.Tensor, qcfg: QuantConfig, n_heads: int
                ) -> torch.Tensor:
    return _slstm_forward(p, x, qcfg, n_heads)[0]


def slstm_prefill(p, x: torch.Tensor, qcfg: QuantConfig, n_heads: int):
    """The block over a prompt plus the (c, n, m, h) state after it."""
    out, (c, n, m, h) = _slstm_forward(p, x, qcfg, n_heads)
    return out, {"c": c, "n": n, "m": m, "h": h}


def slstm_decode(p, x: torch.Tensor, cache: dict, qcfg: QuantConfig,
                 n_heads: int):
    """One-token step.  x (B, 1, D); cache {"c", "n", "m", "h"}, each (B,
    H, dh) fp32, updated in place.  Returns (out (B, 1, D), cache)."""
    B, _, D = x.shape
    wx = qdense(p["w_gates"], x, qcfg).float()[:, 0]
    carry, h = _slstm_step(p["r_gates"].float(),
                           tuple(cache[n] for n in "cnmh"), wx, n_heads)
    y = qdense(p["w_out"], apply_norm(p["out_ln"], h.reshape(B, 1, D)
                                      .to(x.dtype), qcfg), qcfg)
    for name, t in zip("cnmh", carry):
        cache[name].copy_(t)
    return _slstm_ffn(p, y, qcfg), cache


def mlstm_dims(d_model: int, n_heads: int) -> Tuple[int, int]:
    """(d_in, head size) of an mLSTM block: the head size is d_in / H,
    not the config's d_head."""
    d_in = _PF * d_model
    return d_in, d_in // n_heads
