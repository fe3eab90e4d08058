"""The kernels' plain PyTorch versions against the JAX oracles, on the CPU.

The CUDA kernels have no interpret mode; on the CPU each wrapper runs its
plain version, which is held here against ``repro.kernels.ref`` (the
oracles the Pallas kernels are held to).  The card-side check of each
kernel against its plain version is the ``gpu``-marked test at the end and
``chip_smoke.py``.

Tolerances:
  * GEMM: within 1 bf16 ulp (fp32 accumulation order differs).
  * Attention: the exp and the sums differ between XLA:CPU and PyTorch by
    fp32 ulps; on fp32 inputs out and lse agree within ``ATTN_ULPS`` fp32
    ulps of their largest magnitude (7.5 seen).  bf16 outputs agree within
    2 bf16 ulps.  MX-quantized probabilities could, very rarely, round the
    other way on such a difference; the seeded inputs here do not.
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
from repro_torch import core
from repro_torch.kernels import ops, ref

ATTN_ULPS = 16


def _chip_smoke():
    """The card script's module (its attention check and planted faults)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.array(a, np.float32)).astype(dtype)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _ulp_bf16(x: np.ndarray) -> np.ndarray:
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return np.exp2(e - 7)


def _fmt(name):
    return (None, None) if name is None else (jcore.get_format(name),
                                              core.get_format(name))


@pytest.mark.parametrize("fa,fb", [("e4m3", "e4m3"), (None, "e4m3"),
                                   ("e2m1", "e5m2"), ("e4m3", None)])
@pytest.mark.parametrize("shape", [(3, 7, 96, 40), (1, 5, 70, 33)])
def test_matmul_plain_matches_oracle_and_dense_path(fa, fb, shape):
    B, M, K, N = shape
    rng = np.random.default_rng(K + N)
    a = rng.standard_normal((B, M, K))
    b = rng.standard_normal((K, N)) / np.sqrt(K)
    (jfa, tfa), (jfb, tfb) = _fmt(fa), _fmt(fb)
    got = _np(ref.mx_matmul_ref(_t(a, torch.bfloat16), _t(b, torch.bfloat16),
                                tfa, tfb))
    want = _np(jref.mx_matmul_ref(_j(a, jnp.bfloat16), _j(b, jnp.bfloat16),
                                  jfa, jfb))
    assert np.all(np.abs(got - want) <= _ulp_bf16(np.maximum(np.abs(got),
                                                             np.abs(want))))
    # The same numbers through mx_contract(kind="dense") in both packages.
    jcfg = dataclasses.replace(jcore.preset("bf16"), a_fwd=jfa, w_fwd=jfb)
    tcfg = dataclasses.replace(core.preset("bf16"), a_fwd=tfa, w_fwd=tfb)
    got_d = _np(core.mx_contract(_t(a, torch.bfloat16),
                                 _t(b, torch.bfloat16), tcfg, kind="dense"))
    want_d = _np(jcore.mx_contract(_j(a, jnp.bfloat16), _j(b, jnp.bfloat16),
                                   jcfg, kind="dense"))
    assert np.all(np.abs(got_d - want_d)
                  <= _ulp_bf16(np.maximum(np.abs(got_d), np.abs(want_d))))


def test_matmul_plain_matches_interpret_mode_pallas_kernel():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((16, 64))
    b = rng.standard_normal((64, 128)) / 8
    jf, tf = _fmt("e4m3")
    cfg = jcore.preset("mxfp8_e4m3")
    with jcore.use_fused_gemms(True):
        want = _np(jax.jit(lambda x, w: jcore.mx_contract(x, w, cfg))(
            _j(a, jnp.bfloat16), _j(b, jnp.bfloat16)))
    got = _np(ops.mx_matmul(_t(a, torch.bfloat16), _t(b, torch.bfloat16),
                            tf, tf))
    assert np.all(np.abs(got - want) <= _ulp_bf16(np.maximum(np.abs(got),
                                                             np.abs(want))))


def _assert_attn_close(got, want):
    g, w = _np(got), _np(want)
    scale = np.exp2(np.floor(np.log2(np.max(np.abs(w)))) - 23)
    assert np.max(np.abs(g - w)) <= ATTN_ULPS * scale, (
        np.max(np.abs(g - w)) / scale)


@pytest.mark.parametrize("fmt", [None, "e4m3"])
@pytest.mark.parametrize("kind", ["causal", "full", "window"])
@pytest.mark.parametrize("G,Tq,Tk,kv_chunk", [(1, 45, 45, 1024),
                                              (2, 40, 77, 32),
                                              (2, 70, 70, 48)])
def test_flash_plain_matches_oracle(fmt, kind, G, Tq, Tk, kv_chunk):
    rng = np.random.default_rng(Tq * 3 + Tk + G)
    BH, d = 3, 64
    q = rng.standard_normal((BH, G, Tq, d))
    k = rng.standard_normal((BH, Tk, d))
    v = rng.standard_normal((BH, Tk, d))
    jf, tf = _fmt(fmt)
    q_offset = Tk - Tq if kind != "full" else 0
    kw = dict(kind=kind, window=24 if kind == "window" else 0,
              q_offset=q_offset, q_chunk=32, kv_chunk=kv_chunk)
    out, lse = ref.mx_flash_attention_ref(_t(q), _t(k), _t(v), tf,
                                          core.AttnSpec(**kw))
    jout, jlse = jref.mx_flash_attention_ref(_j(q), _j(k), _j(v), jf,
                                             jcore.AttnSpec(**kw))
    _assert_attn_close(out, jout)
    _assert_attn_close(lse, jlse)


@pytest.mark.parametrize("fmt", [None, "e4m3"])
def test_flash_wrapper_bf16_operands_match_oracle(fmt):
    """bf16 operands through the wrapper (the serve path's dtype): the
    output is bf16 and within 2 bf16 ulps of the largest output."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 2, 40, 64))
    k = rng.standard_normal((2, 77, 64))
    v = rng.standard_normal((2, 77, 64))
    jf, tf = _fmt(fmt)
    kw = dict(kind="causal", q_offset=37, q_chunk=32, kv_chunk=32)
    outb, _ = ops.mx_flash_attention(_t(q, torch.bfloat16),
                                     _t(k, torch.bfloat16),
                                     _t(v, torch.bfloat16), tf,
                                     core.AttnSpec(**kw))
    joutb, _ = jref.mx_flash_attention_ref(
        _j(q, jnp.bfloat16), _j(k, jnp.bfloat16), _j(v, jnp.bfloat16), jf,
        jcore.AttnSpec(**kw))
    assert outb.dtype == torch.bfloat16
    g, w = _np(outb), _np(joutb)
    assert np.all(np.abs(g - w) <= 2 * _ulp_bf16(np.max(np.abs(w))))


@pytest.mark.parametrize("fmt", [None, "e4m3", "e2m1"])
@pytest.mark.parametrize("G,S", [(1, 64), (2, 77)])
def test_decode_plain_matches_oracle(fmt, G, S):
    rng = np.random.default_rng(S + G)
    B, H, d = 3, 2, 64
    q = rng.standard_normal((B * H, G, d))
    k = rng.standard_normal((B * H, S, d))
    v = rng.standard_normal((B * H, S, d))
    valid = rng.random((B * H, S)) < 0.6
    valid[:, 0] = True
    jf, tf = _fmt(fmt)
    got = ref.mx_attention_decode_ref(_t(q), _t(k), _t(v),
                                      torch.from_numpy(valid), tf)
    want = jref.mx_attention_decode_ref(_j(q), _j(k), _j(v),
                                        jnp.asarray(valid), jf)
    _assert_attn_close(got, want)


def test_decode_cache_layout_equals_folded_layout():
    rng = np.random.default_rng(0)
    B, S, H, G, d = 2, 70, 3, 2, 64
    kc = _t(rng.standard_normal((B, S, H, d)), torch.bfloat16)
    vc = _t(rng.standard_normal((B, S, H, d)), torch.bfloat16)
    q = _t(rng.standard_normal((B * H, G, d)), torch.bfloat16)
    valid = torch.from_numpy(rng.random((B, S)) < 0.7)
    fmt = core.get_format("e4m3")
    folded = ops.mx_attention_decode(
        q, ref.fold_cache(kc), ref.fold_cache(vc),
        torch.repeat_interleave(valid, H, dim=0), fmt)
    assert torch.equal(ops.mx_attention_decode(q, kc, vc, valid, fmt), folded)


@pytest.mark.parametrize("kind", ["causal", "full", "window"])
def test_tile_predicates_match_reference(kind):
    spec_kw = dict(kind=kind, window=20 if kind == "window" else 0,
                   q_offset=7)
    spec, jspec = core.AttnSpec(**spec_kw), jcore.AttnSpec(**spec_kw)
    for qi in range(4):
        for kj in range(5):
            assert ref.attn_tile_needed(spec, qi, kj, 16, 24, 100) == bool(
                jref.attn_tile_needed(jspec, qi, kj, 16, 24, 100))
            qpos = np.broadcast_to(np.arange(16)[:, None], (16, 24))
            kpos = np.broadcast_to(np.arange(24)[None, :], (16, 24))
            np.testing.assert_array_equal(
                ref.attn_tile_mask(spec, qi, kj, 16, 24, 100).numpy(),
                np.asarray(jref.attn_tile_mask(jspec, qi, kj, 16, 24, 100,
                                               qpos, kpos)))


def test_cpu_wrappers_use_plain_versions_and_count_no_launch():
    ops.reset_launches()
    x = torch.randn(4, 64)
    fmt = core.get_format("e4m3")
    assert torch.equal(ops.mx_quantize(x, fmt), ref.mx_quantize_ref(x, fmt))
    ops.mx_matmul(x.bfloat16(), x.bfloat16().T.contiguous(), fmt, fmt)
    assert all(n == 0 for n in ops.LAUNCHES.values())


def test_mx_contract_rejects_unknown_kind_and_backward_raises():
    cfg = core.preset("mxfp8_e4m3")
    with pytest.raises(ValueError, match="unknown mx_contract kind"):
        core.mx_contract(torch.zeros(2, 32), torch.zeros(32, 4), cfg,
                         kind="attn_qkv")
    # "bmm" is a kind now; 2-D operands are not its shapes
    with pytest.raises(ValueError, match="kind='bmm' takes"):
        core.mx_contract(torch.zeros(2, 32), torch.zeros(32, 4), cfg,
                         kind="bmm")
    # The backward runs on the CPU through the plain versions: dx and dW
    # equal the quantize_mx-based products.
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 32, generator=g).bfloat16().requires_grad_(True)
    w = torch.randn(32, 4, generator=g).bfloat16().requires_grad_(True)
    dy = torch.randn(2, 4, generator=g).bfloat16()
    core.mx_contract(x, w, cfg, kind="dense").backward(dy)
    Q = core.quantize_mx
    dx = (Q(dy, cfg.g_bwd, axis=-1).float()
          @ Q(w.detach(), cfg.w_bwd, axis=1).float().T).bfloat16()
    dw = (Q(x.detach(), cfg.a_bwd, axis=0).float().T
          @ Q(dy, cfg.g_bwd, axis=0).float()).bfloat16()
    assert torch.equal(x.grad, dx) and torch.equal(w.grad, dw)


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode "
                    "(run chip_smoke.py on the card)")
    g = torch.Generator().manual_seed(0)
    fmt = core.get_format("e4m3")
    x = torch.randn(64, 100, generator=g).cuda()
    assert torch.equal(ops.mx_quantize(x, fmt), ref.mx_quantize_ref(x, fmt))
    a = torch.randn(8, 96, generator=g).bfloat16().cuda()
    b = torch.randn(96, 40, generator=g).bfloat16().cuda()
    c, cr = ops.mx_matmul(a, b, fmt, fmt), ref.mx_matmul_ref(a, b, fmt, fmt)
    assert np.all(np.abs(_np(c.cpu()) - _np(cr.cpu()))
                  <= _ulp_bf16(np.abs(_np(cr.cpu()))))
    cs = _chip_smoke()
    q = torch.randn(2, 1, 64, 64, generator=g).bfloat16().cuda()
    k = torch.randn(2, 64, 64, generator=g).bfloat16().cuda()
    v = torch.randn(2, 64, 64, generator=g).bfloat16().cuda()
    for f in (None, fmt):
        o, lse = ops.mx_flash_attention(q, k, v, f, core.AttnSpec())
        orf, lser = ref.mx_flash_attention_ref(q, k, v, f, core.AttnSpec())
        assert cs.attn_check(o, orf, cs.attn_floor(v, 64))[0]
        assert (lse - lser).abs().max().item() <= 1e-4
    kc = torch.randn(2, 96, 2, 64, generator=g).bfloat16().cuda()
    vc = torch.randn(2, 96, 2, 64, generator=g).bfloat16().cuda()
    qd = torch.randn(4, 1, 64, generator=g).bfloat16().cuda()
    valid = torch.arange(96).cuda()[None] <= torch.tensor([40, 95]).cuda()[:, None]
    for f in (None, fmt):
        o = ops.mx_attention_decode(qd, kc, vc, valid, f)
        orf = ref.mx_attention_decode_ref(qd, kc, vc, valid, f)
        assert cs.attn_check(o, orf, cs.attn_floor(vc, 96))[0]


@pytest.mark.parametrize("fault", [None, "p unquantized",
                                   "p against a 32-column sub-tile max",
                                   "v quantized along d"])
def test_card_attention_check_rejects_planted_flash_faults(fault):
    """chip_smoke.py holds the flash kernel to its plain version within 2
    bf16 ulps of each element; the plain version with a planted fault must
    fail that check, the fault-free one pass it."""
    cs = _chip_smoke()
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 1, 64, 64, generator=g).bfloat16()
    k = torch.randn(2, 64, 64, generator=g).bfloat16()
    v = torch.randn(2, 64, 64, generator=g).bfloat16()
    fmt = core.get_format("e4m3")
    want, _ = ref.mx_flash_attention_ref(q, k, v, fmt, core.AttnSpec())
    ok, _ = cs.attn_check(cs.planted_flash(q, k, v, fmt, fault), want,
                          cs.attn_floor(v, 64))
    assert ok == (fault is None)


@pytest.mark.parametrize("fault", [None, "p unquantized",
                                   "p quantized before normalizing",
                                   "v quantized along d",
                                   "v quantized over valid slots only"])
def test_card_attention_check_rejects_planted_decode_faults(fault):
    cs = _chip_smoke()
    g = torch.Generator().manual_seed(2)
    B, S, H = 2, 96, 2
    kc = torch.randn(B, S, H, 64, generator=g).bfloat16()
    vc = torch.randn(B, S, H, 64, generator=g).bfloat16()
    q = torch.randn(B * H, 1, 64, generator=g).bfloat16()
    valid = torch.arange(S)[None] <= torch.tensor([40, 70])[:, None]
    fmt = core.get_format("e4m3")
    want = ref.mx_attention_decode_ref(q, kc, vc, valid, fmt)
    ok, _ = cs.attn_check(cs.planted_decode(q, kc, vc, valid, fmt, fault),
                          want, cs.attn_floor(vc, S))
    assert ok == (fault is None)
