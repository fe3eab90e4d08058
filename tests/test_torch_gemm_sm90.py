"""The backward MX GEMMs (dgrad, wgrad) against the JAX reference, on the CPU.

On the card, ``mx_matmul_dgrad`` and ``mx_matmul_wgrad`` quantize each
operand once into a contraction-major bf16 scratch, zero padded to the
GEMM's k-tile depth, and then run one bf16 tensor-core product with fp32
accumulation (``csrc/mx_gemm_sm90.cuh``).  On the CPU the wrappers run the
plain versions, which are held here against ``repro.kernels.ref`` and the
interpret-mode Pallas kernels, together with what the redesign rests on:
MX values are exact in bf16, a padded contraction adds only zero terms,
the wrapper's split and scratch plan, and the card check's planted faults.
The ``gpu``-marked test runs the kernels against their plain versions.

Tolerance: one bf16 ulp of the reference (|want| * 2^-23 for fp32
results) plus the fp32 accumulation bound n * 2^-24 * sum |terms|, since
the two sides sum the n terms of each element in different orders.
"""
import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.kernels import mx_matmul_bwd as jbwd
from repro.kernels import ref as jref
from repro_torch import core
from repro_torch.kernels import ops, ref

FMTS = {"e4m3": ("e4m3", "e4m3"), "e5m2": ("e5m2", "e5m2"),
        "mixed": ("e5m2", "e4m3")}
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16),
          "fp32": (torch.float32, jnp.float32)}


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


def _absq(x: np.ndarray, name, axis) -> np.ndarray:
    t = torch.from_numpy(x)
    return np.abs(_np(core.quantize_mx(t, core.get_format(name), axis=axis)))


def _assert_close(got, want, terms: np.ndarray, n: int, fp32: bool):
    g, w = _np(got), _np(want)
    last = np.abs(w) * 2.0 ** -23 if fp32 else _ulp_bf16(w)
    tol = last + n * 2.0 ** -24 * terms
    assert g.shape == w.shape
    assert np.all(np.abs(g - w) <= tol), np.max(np.abs(g - w) / tol)


def _operands(kind: str, n: int, seed: int):
    """dgrad: dy (3, n), w (40, n) -> dx (3, 40); wgrad: x (n, 3),
    dy (n, 40) -> dW (3, 40); the contraction n is the ragged axis."""
    rng = np.random.default_rng(seed)
    if kind == "dgrad":
        return ((rng.standard_normal((3, n)) * 1e-2).astype(np.float32),
                (rng.standard_normal((40, n)) / math.sqrt(n)).astype(
                    np.float32))
    return (rng.standard_normal((n, 3)).astype(np.float32),
            (rng.standard_normal((n, 40)) * 1e-2).astype(np.float32))


def _pair(kind, a, b, fa, fb, dtype):
    """(port, reference) for numpy operands in one dtype."""
    tdt, jdt = DTYPES[dtype]
    ta, tb = (torch.from_numpy(v).to(tdt) for v in (a, b))
    ja, jb = (jnp.asarray(v).astype(jdt) for v in (a, b))
    tfa, tfb = core.get_format(fa), core.get_format(fb)
    jfa, jfb = jcore.get_format(fa), jcore.get_format(fb)
    if kind == "dgrad":
        return (ops.mx_matmul_dgrad(ta, tb, tfa, tfb),
                jref.mx_matmul_dgrad_ref(ja, jb, jfa, jfb))
    return (ops.mx_matmul_wgrad(ta, tb, tfa, tfb),
            jref.mx_matmul_wgrad_ref(ja, jb, jfa, jfb))


def _terms(kind, a, b, fa, fb):
    """sum over the contraction of |Q(a)| |Q(b)| per output element."""
    if kind == "dgrad":
        return _absq(a, fa, -1) @ _absq(b, fb, 1).T
    return _absq(a, fa, 0).T @ _absq(b, fb, 0)


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("fmts", ["e4m3", "e5m2", "mixed"])
@pytest.mark.parametrize("n", [48, 100])
@pytest.mark.parametrize("kind", ["dgrad", "wgrad"])
def test_plain_matches_reference_at_ragged_contractions(kind, n, fmts,
                                                        dtype):
    fa, fb = FMTS[fmts]
    a, b = _operands(kind, n, seed=n)
    if dtype == "bf16":   # the terms of the bf16 operands the port sees
        a, b = (_np(torch.from_numpy(v).bfloat16()) for v in (a, b))
    got, want = _pair(kind, a, b, fa, fb, dtype)
    assert got.dtype == DTYPES[dtype][0]
    _assert_close(got, want, _terms(kind, a, b, fa, fb), n,
                  dtype == "fp32")


@pytest.mark.parametrize("fmts", ["e4m3", "mixed"])
@pytest.mark.parametrize("kind", ["dgrad", "wgrad"])
def test_plain_matches_interpret_mode_pallas_kernels(kind, fmts):
    """The reference's Pallas dgrad / wgrad in interpret mode (they take a
    contraction that is a multiple of 32: 96 here)."""
    fa, fb = FMTS[fmts]
    a, b = _operands(kind, 96, seed=7)
    a, b = (_np(torch.from_numpy(v).bfloat16()) for v in (a, b))
    ja, jb = (jnp.asarray(v).astype(jnp.bfloat16) for v in (a, b))
    jfa, jfb = jcore.get_format(fa), jcore.get_format(fb)
    if kind == "dgrad":
        want = jbwd.mx_matmul_dgrad_pallas(ja, jb, jfa, jfb, interpret=True)
    else:
        want = jbwd.mx_matmul_wgrad_pallas(ja, jb, jfa, jfb, interpret=True)
    got, _ = _pair(kind, a, b, fa, fb, "bf16")
    _assert_close(got, want, _terms(kind, a, b, fa, fb), 96, False)


@pytest.mark.parametrize("name", ["e4m3", "e5m2", "e3m2", "e2m3", "e2m1"])
def test_mx_values_are_exact_in_bf16(name):
    """The pre-pass writes quantized fp32 operands as bf16: exact for every
    MX element format, over scales from 2^-100 to 2^100."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((64, 96)) * np.exp2(
        rng.integers(-100, 100, size=(64, 1)))
    q = core.quantize_mx(torch.from_numpy(x.astype(np.float32)),
                         core.get_format(name), axis=-1)
    assert torch.equal(q.bfloat16().float(), q)


def _prepass(t: torch.Tensor, fmt, axis: int, depth: int) -> torch.Tensor:
    """What the pre-pass writes: t quantized along ``axis``, that axis
    moved last and zero padded to ``depth``, in bf16."""
    q = torch.movedim(core.quantize_mx(t, fmt, axis=axis), axis, -1)
    q = torch.nn.functional.pad(q.float(), (0, depth - q.shape[-1]))
    return q.bfloat16()


@pytest.mark.parametrize("n", [48, 100, 1000])
@pytest.mark.parametrize("kind", ["dgrad", "wgrad"])
def test_quantize_once_then_padded_product_equals_plain(kind, n):
    """The redesign's arithmetic: both operands quantized once into
    contraction-major scratch padded to the plan's depth, then one product
    with fp32 accumulation, gives the plain version's result."""
    fa, fb = core.get_format("e5m2"), core.get_format("e4m3")
    a, b = (torch.from_numpy(v).bfloat16() for v in _operands(kind, n, 3))
    if kind == "dgrad":
        depth, _ = ops.bwd_gemm_plan(a.shape[0], b.shape[0], n)
        aq, bq = _prepass(a, fa, 1, depth), _prepass(b, fb, 1, depth)
        want = ref.mx_matmul_dgrad_ref(a, b, fa, fb)
    else:
        depth, _ = ops.bwd_gemm_plan(a.shape[1], b.shape[1], n)
        aq, bq = _prepass(a, fa, 0, depth), _prepass(b, fb, 0, depth)
        want = ref.mx_matmul_wgrad_ref(a, b, fa, fb)
    assert depth % ops.BWD_DEPTH == 0 and n <= depth < n + ops.BWD_DEPTH
    assert torch.all(aq[:, n:] == 0) and torch.all(bq[:, n:] == 0)
    got = (aq.float() @ bq.float().T).bfloat16()
    terms = np.abs(_np(aq)) @ np.abs(_np(bq)).T
    _assert_close(got, want, terms, n, False)


@pytest.mark.parametrize("rows,cols,n", [
    (4096, 512, 512), (512, 512, 4096),        # wq dgrad, wgrad
    (4096, 512, 2048), (512, 2048, 4096),      # w_up
    (4096, 2048, 512), (2048, 512, 4096),      # w_down
    (4096, 512, 32000), (512, 32000, 4096),    # lm_head
    (2048, 512, 2048), (512, 2048, 2048),      # the proxy's fp32 GEMMs
    (100, 200, 48), (100, 200, 1000), (3, 40, 1)])
def test_bwd_gemm_plan_pads_and_splits(rows, cols, n):
    depth, splits = ops.bwd_gemm_plan(rows, cols, n)
    assert depth % ops.BWD_DEPTH == 0 and n <= depth < n + ops.BWD_DEPTH
    ktiles = depth // ops.BWD_DEPTH
    per = -(-ktiles // splits)   # as the kernel divides them
    assert 1 <= splits <= ktiles and (splits - 1) * per < ktiles
    tiles = (-(-rows // ops.BWD_TILE[0])) * (-(-cols // ops.BWD_TILE[1]))
    if tiles >= 132:
        assert splits == 1
    if splits > 1:
        assert per >= 4 and tiles * splits <= 2 * 132


def test_bwd_gemm_plan_of_the_lm_head_and_wq():
    assert ops.bwd_gemm_plan(4096, 512, 32000) == (32000, 2)
    assert ops.bwd_gemm_plan(512, 32000, 4096) == (4096, 1)
    assert ops.bwd_gemm_plan(512, 512, 4096) == (4096, 16)


@pytest.mark.parametrize("kind", ["dgrad", "wgrad"])
def test_cpu_wrappers_run_the_plain_versions_and_count_no_launch(kind):
    a, b = (torch.from_numpy(v).bfloat16() for v in _operands(kind, 100, 5))
    f = core.get_format("e4m3")
    ops.reset_launches()
    if kind == "dgrad":
        assert torch.equal(ops.mx_matmul_dgrad(a, b, f, f),
                           ref.mx_matmul_dgrad_ref(a, b, f, f))
    else:
        assert torch.equal(ops.mx_matmul_wgrad(a, b, f, f),
                           ref.mx_matmul_wgrad_ref(a, b, f, f))
    assert all(v == 0 for v in ops.LAUNCHES.values())


@pytest.mark.parametrize("kind,fault", [
    ("dgrad", None), ("dgrad", "w quantized along K instead of N"),
    ("wgrad", None), ("wgrad", "x left unquantized")])
def test_card_gemm_check_rejects_planted_faults(kind, fault):
    """chip_smoke.py holds dgrad and wgrad to their plain versions with
    ``gemm_check``; the plain version with a planted fault must fail it,
    the fault-free one pass it."""
    cs = _chip_smoke()
    fa = fb = core.get_format("e4m3")
    g = torch.Generator().manual_seed(4)
    if kind == "dgrad":
        a = (torch.randn(64, 320, generator=g) * 1e-2).bfloat16()
        b = (torch.randn(96, 320, generator=g) / 18).bfloat16()
        qa = ref.mx_quantize_ref(a, fa).float().abs()
        qb = ref.mx_quantize_ref(b, fb, axis=1).float().abs().T
        want, n = ref.mx_matmul_dgrad_ref(a, b, fa, fb), 320
    else:
        a = torch.randn(256, 64, generator=g).bfloat16()
        b = (torch.randn(256, 96, generator=g) * 1e-2).bfloat16()
        qa = ref.mx_quantize_ref(a, fa, axis=0).float().abs().T
        qb = ref.mx_quantize_ref(b, fb, axis=0).float().abs()
        want, n = ref.mx_matmul_wgrad_ref(a, b, fa, fb), 256
    ok = cs.gemm_check(cs.planted_gemm(kind, a, b, fa, fb, fault), want, qa,
                       qb, n)[0]
    assert ok == (fault is None)


def test_card_gemm_check_sees_a_misquantized_w_at_the_lm_heads_contraction():
    """At n = 32000 the worst-case bound n * 2^-24 * sum |terms| admits a W
    quantized along K instead of N; the card check's sqrt(n) bound rejects
    it, and passes the fault-free plain version."""
    cs = _chip_smoke()
    f = core.get_format("e4m3")
    g = torch.Generator().manual_seed(9)
    dy = (torch.randn(16, 32000, generator=g) * 1e-2).bfloat16()
    w = (torch.randn(64, 32000, generator=g) / math.sqrt(512)).bfloat16()
    qa = ref.mx_quantize_ref(dy, f).float().abs()
    qb = ref.mx_quantize_ref(w, f, axis=1).float().abs().T
    want = ref.mx_matmul_dgrad_ref(dy, w, f, f)
    bad = cs.planted_gemm("dgrad", dy, w, f, f,
                          "w quantized along K instead of N")
    worst_case = (cs.ulp_bf16(want.float())
                  + 32000 * 2.0 ** -24 * (qa @ qb))
    assert bool(((bad.float() - want.float()).abs() <= worst_case).all())
    assert not cs.gemm_check(bad, want, qa, qb, 32000)[0]
    assert cs.gemm_check(cs.planted_gemm("dgrad", dy, w, f, f), want, qa,
                         qb, 32000)[0]


@pytest.mark.gpu
def test_bwd_gemm_kernels_match_plain_versions_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode "
                    "(run chip_smoke.py on the card)")
    cs = _chip_smoke()
    e4, e5 = core.get_format("e4m3"), core.get_format("e5m2")
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype=torch.bfloat16, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(dtype).cuda()
    cases = []
    for n in (48, 70, 1000):
        for fa, fb in ((e4, e4), (e5, e4), (None, e4)):
            cases.append(("dgrad", rnd(100, n, std=1e-2), rnd(199, n), fa,
                          fb))
            cases.append(("wgrad", rnd(n, 100), rnd(n, 199, std=1e-2), fb,
                          fa))
    cases.append(("dgrad", rnd(96, 256, dtype=torch.float32),
                  rnd(130, 256, dtype=torch.float32), e4, e4))
    cases.append(("wgrad", rnd(300, 96, dtype=torch.float32),
                  rnd(300, 130, dtype=torch.float32), e4, e4))
    for kind, a, b, fa, fb in cases:
        fn = ops.mx_matmul_dgrad if kind == "dgrad" else ops.mx_matmul_wgrad
        plain = (ref.mx_matmul_dgrad_ref if kind == "dgrad"
                 else ref.mx_matmul_wgrad_ref)
        ops.reset_launches()
        got = fn(a, b, fa, fb)
        assert ops.LAUNCHES[f"mx_matmul_{kind}"] == 1
        assert torch.equal(got, fn(a, b, fa, fb))
        if kind == "dgrad":
            qa = ref.mx_quantize_ref(a, fa).float().abs()
            qb = ref.mx_quantize_ref(b, fb, axis=1).float().abs().T
            n = a.shape[1]
        else:
            qa = ref.mx_quantize_ref(a, fa, axis=0).float().abs().T
            qb = ref.mx_quantize_ref(b, fb, axis=0).float().abs()
            n = a.shape[0]
        assert cs.gemm_check(got, plain(a, b, fa, fb), qa, qb, n)[0], kind
