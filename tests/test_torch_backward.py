"""The port's backward against the JAX reference, on the CPU.

The CUDA kernels have no CPU mode; on the CPU each wrapper runs its plain
version, which is held here against the reference: the "dense" and
"flash_attn" contractions through ``torch.autograd`` against ``jax.vjp``
of ``repro.core.mx_contract``, the plain dgrad / wgrad / flash-dgrad
versions against ``repro.kernels.ref``, and the straight-through gradient
of the quantized layernorm.  The card-side checks are the ``gpu``-marked
test and ``chip_smoke.py``.

Tolerances:
  * GEMMs (dense value, dx, dW): within 1 bf16 ulp of the larger of the
    two results (fp32 accumulation order differs); fp32 operands (the
    proxy's) within 8 fp32 ulps of the result's largest magnitude.
  * Flash dgrad on fp32 inputs: within ``ATTN_ULPS`` fp32 ulps of each
    gradient's largest magnitude (exp and the sums differ by fp32 ulps
    between XLA:CPU and PyTorch; up to ~5 seen); bf16 gradients through
    ``mx_contract`` within 2 bf16 ulps of the largest.
  * The layernorm's straight-through gradients: within 4 fp32 ulps of
    each gradient's largest magnitude (the backward of the mean and
    variance sums in another order; ~2 seen); the quantizer's own
    backward is the identity, bitwise.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch import core
from repro_torch.kernels import ops, ref
from repro_torch.models import layers

ATTN_ULPS = 16
PRESETS = ("bf16", "mxfp8_e4m3", "mx_mix", "e4m3_bf16act", "e4m3_fwd_only")


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ulp_bf16(x: np.ndarray) -> np.ndarray:
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return np.exp2(e - 7)


def _close_bf16(got, want):
    g, w = _np(got), _np(want)
    assert np.all(np.abs(g - w) <= _ulp_bf16(np.maximum(np.abs(g),
                                                        np.abs(w)))), (
        np.max(np.abs(g - w)))


def _close_ulps(got, want, ulps, bits=23):
    g, w = _np(got), _np(want)
    scale = np.exp2(np.floor(np.log2(np.max(np.abs(w)))) - bits)
    assert np.max(np.abs(g - w)) <= ulps * scale, np.max(np.abs(g - w)) / scale


def _fmt(name):
    return (None, None) if name is None else (jcore.get_format(name),
                                              core.get_format(name))


def _dense_pair(x, w, g, name, dtype, jdtype):
    """(port (y, dx, dw), reference (y, dx, dw)) for one preset."""
    jx, jw, jg = (jnp.asarray(a).astype(jdtype) for a in (x, w, g))
    jy, vjp = jax.vjp(lambda a, b: jcore.mx_contract(a, b,
                                                     jcore.preset(name)),
                      jx, jw)
    jdx, jdw = vjp(jg)
    tx = torch.from_numpy(x).to(dtype).requires_grad_(True)
    tw = torch.from_numpy(w).to(dtype).requires_grad_(True)
    ty = core.mx_contract(tx, tw, core.preset(name))
    ty.backward(torch.from_numpy(g).to(dtype))
    return (ty, tx.grad, tw.grad), (jy, jdx, jdw)


@pytest.mark.parametrize("name", PRESETS)
def test_dense_vjp_matches_reference(name):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 72)) / 10).astype(np.float32)
    g = rng.standard_normal((2, 40, 72)).astype(np.float32)
    got, want = _dense_pair(x, w, g, name, torch.bfloat16, jnp.bfloat16)
    for a, b in zip(got, want):
        _close_bf16(a, b)
    assert got[1].dtype == torch.bfloat16 and got[2].dtype == torch.bfloat16


def test_dense_vjp_fp32_operands_match_reference():
    """The proxy's fp32 activations: every GEMM quantized, fp32 results."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 96)) / 8).astype(np.float32)
    g = rng.standard_normal((64, 96)).astype(np.float32)
    for name in ("mxfp8_e4m3", "e4m3_bf16act"):
        got, want = _dense_pair(x, w, g, name, torch.float32, jnp.float32)
        for a, b in zip(got, want):
            _close_ulps(a, b, 8)
        assert got[1].dtype == torch.float32


@pytest.mark.parametrize("name", ["mxfp8_e4m3", "mx_mix"])
def test_dense_vjp_matches_interpret_mode_pallas_kernels(name):
    """The reference's fused path (interpret-mode Pallas forward, dgrad and
    wgrad) at one small shape."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((64, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 128)) / 8).astype(np.float32)
    g = rng.standard_normal((64, 128)).astype(np.float32)
    cfg = jcore.preset(name)
    jx, jw, jg = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w, g))
    with jcore.use_fused_gemms(True):
        f = jax.jit(lambda a, b: jax.vjp(
            lambda a_, b_: jcore.mx_contract(a_, b_, cfg), a, b)[1](jg))
        jdx, jdw = f(jx, jw)
    got, _ = _dense_pair(x, w, g, name, torch.bfloat16, jnp.bfloat16)
    _close_bf16(got[1], jdx)
    _close_bf16(got[2], jdw)


@pytest.mark.parametrize("fg,fw", [("e4m3", "e4m3"), ("e5m2", "e4m3"),
                                   (None, "e4m3"), ("e2m1", None)])
def test_dgrad_wgrad_plain_match_reference_oracles(fg, fw):
    rng = np.random.default_rng(6)
    dy = rng.standard_normal((3, 33, 70)).astype(np.float32)
    w = (rng.standard_normal((50, 70)) / 8).astype(np.float32)
    x = rng.standard_normal((99, 50)).astype(np.float32)
    dy2 = dy.reshape(99, 70)
    (jg, tg), (jw, tw) = _fmt(fg), _fmt(fw)
    bf = lambda a: torch.from_numpy(a).bfloat16()
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    _close_bf16(ops.mx_matmul_dgrad(bf(dy), bf(w), tg, tw),
                jref.mx_matmul_dgrad_ref(jb(dy), jb(w), jg, jw))
    _close_bf16(ops.mx_matmul_wgrad(bf(x), bf(dy2), tw, tg),
                jref.mx_matmul_wgrad_ref(jb(x), jb(dy2), jw, jg))


def _flash_inputs(G, Tq, Tk, seed):
    rng = np.random.default_rng(seed)
    BH, d = 3, 64
    return (rng.standard_normal((BH, G, Tq, d)).astype(np.float32),
            rng.standard_normal((BH, Tk, d)).astype(np.float32),
            rng.standard_normal((BH, Tk, d)).astype(np.float32),
            rng.standard_normal((BH, G, Tq, d)).astype(np.float32))


@pytest.mark.parametrize("fmt", [None, "e4m3"])
@pytest.mark.parametrize("kind", ["causal", "full", "window"])
@pytest.mark.parametrize("G,Tq,Tk,kv_chunk", [(1, 45, 45, 1024),
                                              (2, 40, 77, 32),
                                              (2, 70, 70, 48)])
def test_flash_bwd_plain_matches_oracle(fmt, kind, G, Tq, Tk, kv_chunk):
    q, k, v, do = _flash_inputs(G, Tq, Tk, Tq + 3 * Tk + G)
    jf, tf = _fmt(fmt)
    kw = dict(kind=kind, window=24 if kind == "window" else 0,
              q_offset=Tk - Tq if kind != "full" else 0, q_chunk=32,
              kv_chunk=kv_chunk)
    jspec = jcore.AttnSpec(**kw)
    jo, jl = jref.mx_flash_attention_ref(*map(jnp.asarray, (q, k, v)), jf,
                                         jspec)
    want = jref.mx_flash_attention_bwd_ref(
        *map(jnp.asarray, (q, k, v, do)), jo, jl, jf, jspec)
    t = lambda a: torch.from_numpy(np.array(a))
    got = ref.mx_flash_attention_bwd_ref(t(q), t(k), t(v), t(do), t(jo),
                                         t(jl), tf, core.AttnSpec(**kw))
    for a, b in zip(got, want):
        _close_ulps(a, b, ATTN_ULPS)


@pytest.mark.parametrize("name", ["bf16", "mxfp8_e4m3"])
def test_flash_vjp_matches_reference(name):
    """bf16 operands through mx_contract(kind="flash_attn"): the forward
    saves (q, k, v, out, lse) and the backward is the flash dgrad."""
    q, k, v, do = _flash_inputs(2, 40, 77, 11)
    kw = dict(kind="causal", q_offset=37, q_chunk=32, kv_chunk=32)
    jcfg, tcfg = jcore.preset(name), core.preset(name)
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, b, c: jcore.mx_contract(
        a, (b, c), jcfg, kind="flash_attn", spec=jcore.AttnSpec(**kw)),
        jb(q), jb(k), jb(v))
    want = vjp(jb(do))
    tq, tk, tv = (torch.from_numpy(a).bfloat16().requires_grad_(True)
                  for a in (q, k, v))
    out = core.mx_contract(tq, (tk, tv), tcfg, kind="flash_attn",
                           spec=core.AttnSpec(**kw))
    out.backward(torch.from_numpy(do).bfloat16())
    for a, b in zip((tq.grad, tk.grad, tv.grad), want):
        assert a.dtype == torch.bfloat16
        g, w = _np(a), _np(b)
        assert np.all(np.abs(g - w) <= 2 * _ulp_bf16(np.max(np.abs(w))))


@pytest.mark.parametrize("ln_fmt", ["e4m3", "e2m1"])
def test_apply_norm_straight_through_grad_matches_reference(ln_fmt):
    """Quantized layernorm affine: the gradient reaches x, scale and bias
    through the straight-through quantizer (the path the paper blames for
    the instability, §6.1)."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 9, 128)) * 3 + 0.5).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(128)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(128)).astype(np.float32)}
    g = rng.standard_normal((2, 9, 128)).astype(np.float32)
    jq = dataclasses.replace(jcore.preset("bf16"),
                             ln_fmt=jcore.get_format(ln_fmt))
    tq = dataclasses.replace(core.preset("bf16"),
                             ln_fmt=core.get_format(ln_fmt))
    jgrads = jax.grad(lambda xx, pp: jnp.sum(
        jlayers.apply_norm(pp, xx, jq, "layernorm") * g), argnums=(0, 1))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p))
    tx = torch.from_numpy(x).requires_grad_(True)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    torch.sum(layers.apply_norm(tp, tx, tq, "layernorm")
              * torch.from_numpy(g)).backward()
    assert np.abs(_np(tp["scale"].grad)).max() > 0
    _close_ulps(tx.grad, jgrads[0], 4)
    for key in ("scale", "bias"):
        _close_ulps(tp[key].grad, jgrads[1][key], 4)


def test_quantize_backward_is_identity_in_the_input_dtype():
    fmt = core.get_format("e4m3")
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(4, 64).to(dtype).requires_grad_(True)
        g = torch.randn(4, 64).to(dtype)
        ops.mx_quantize(x, fmt).backward(g)
        assert x.grad.dtype == dtype and torch.equal(x.grad, g)


@pytest.mark.parametrize("fault", [None, "p from unquantized scores",
                                   "quantized operands in the gradient "
                                   "products", "delta rounded to bf16"])
def test_card_flash_bwd_check_rejects_planted_faults(fault):
    """chip_smoke.py holds the flash dgrad kernel to its plain version per
    element (FLASH_BWD_EPS of the element's term bound); the dense version
    with a planted fault must fail that check, the fault-free one pass."""
    cs = _chip_smoke()
    g = torch.Generator().manual_seed(3)
    BH, T, d = 2, 128, 64
    q = torch.randn(BH, 1, T, d, generator=g).bfloat16()
    k = torch.randn(BH, T, d, generator=g).bfloat16()
    v = torch.randn(BH, T, d, generator=g).bfloat16()
    dout = (torch.randn(BH, 1, T, d, generator=g) * 1e-2).bfloat16()
    fmt, spec = core.get_format("e4m3"), core.AttnSpec()
    out, lse = ref.mx_flash_attention_ref(q, k, v, fmt, spec)
    want = ref.mx_flash_attention_bwd_ref(q, k, v, dout, out, lse, fmt, spec,
                                          out_dtype=torch.float32)
    _, bounds = cs.flash_bwd_dense(q, k, v, dout, out, lse, fmt)
    planted, _ = cs.flash_bwd_dense(q, k, v, dout, out, lse, fmt, fault)
    ok, _ = cs.flash_bwd_check(planted, want, bounds)
    assert ok == (fault is None)


@pytest.mark.gpu
def test_backward_kernels_match_plain_versions_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode "
                    "(run chip_smoke.py on the card)")
    g = torch.Generator().manual_seed(0)
    fmt = core.get_format("e4m3")
    dy = torch.randn(96, 70, generator=g).bfloat16().cuda()
    w = torch.randn(50, 70, generator=g).bfloat16().cuda()
    x = torch.randn(96, 50, generator=g).bfloat16().cuda()
    for got, want in ((ops.mx_matmul_dgrad(dy, w, fmt, fmt),
                       ref.mx_matmul_dgrad_ref(dy, w, fmt, fmt)),
                      (ops.mx_matmul_wgrad(x, dy, fmt, fmt),
                       ref.mx_matmul_wgrad_ref(x, dy, fmt, fmt))):
        _close_bf16(got.cpu(), want.cpu())
    q = torch.randn(2, 2, 64, 64, generator=g).bfloat16().cuda()
    k = torch.randn(2, 64, 64, generator=g).bfloat16().cuda()
    v = torch.randn(2, 64, 64, generator=g).bfloat16().cuda()
    dout = (torch.randn(2, 2, 64, 64, generator=g) * 1e-2).bfloat16().cuda()
    for f in (None, fmt):
        spec = core.AttnSpec()
        out, lse = ops.mx_flash_attention(q, k, v, f, spec)
        got = ops.mx_flash_attention_bwd(q, k, v, dout, out, lse, f, spec,
                                         out_dtype=torch.float32)
        want = ref.mx_flash_attention_bwd_ref(q, k, v, dout, out, lse, f,
                                              spec, out_dtype=torch.float32)
        for a, b in zip(got, want):
            assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()
