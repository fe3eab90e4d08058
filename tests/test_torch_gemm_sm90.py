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


# ---------------------------------------------------------------------------
# The lane GEMMs: kernels 2-4 with a lane axis (one launch for L lanes).
# ---------------------------------------------------------------------------
LANE_WRAPPERS = {"fwd": ("mx_matmul_lanes", "mx_matmul"),
                 "dgrad": ("mx_matmul_dgrad_lanes", "mx_matmul_dgrad"),
                 "wgrad": ("mx_matmul_wgrad_lanes", "mx_matmul_wgrad")}


class _OnCard:
    """A CPU tensor that tells a wrapper it lies on the card, so that the
    wrapper's CUDA branch (checks, plan, scratch, the launch's arguments)
    runs with ``ops._launch`` recorded instead of launched."""

    def __init__(self, t: torch.Tensor):
        self.t = t
        self.is_cuda = True
        self.shape, self.ndim, self.dtype = t.shape, t.ndim, t.dtype
        self.device = t.device

    def contiguous(self):
        return self

    def data_ptr(self):
        return self.t.data_ptr()

    def __getitem__(self, i):
        return _OnCard(self.t[i])

    def reshape(self, *shape):
        return _OnCard(self.t.reshape(*shape))


def _recorded_launch(monkeypatch):
    calls = []
    monkeypatch.setattr(ops, "_launch",
                        lambda counter, name, *args: calls.append(
                            (counter, name, args)))
    return calls


def _lane_shapes(kind, L, M=256, K=256, N=1024):
    """(L, ., .) operand shapes of ``kind``: forward x (M, K) @ W (K, N),
    dgrad dy (M, N) against W (K, N), wgrad x (M, K) against dy (M, N)."""
    return {"fwd": ((L, M, K), (L, K, N)), "dgrad": ((L, M, N), (L, K, N)),
            "wgrad": ((L, M, K), (L, M, N))}[kind]


@pytest.mark.parametrize("kind", sorted(LANE_WRAPPERS))
def test_lane_wrappers_pass_their_c_signature(kind, monkeypatch):
    """Each lane wrapper passes its C entry point as many arguments as the
    ctypes signature holds (the stream is appended by ``_launch``); the
    signature itself is held against the C source in
    test_torch_scale_modes.py."""
    calls = _recorded_launch(monkeypatch)
    name = LANE_WRAPPERS[kind][0]
    sa, sb = _lane_shapes(kind, 3)
    f = core.get_format("e4m3")
    getattr(ops, name)(_OnCard(torch.empty(sa)), _OnCard(torch.empty(sb)),
                       f, f, scale_mode="adaptive")
    (counter, entry, args), = calls
    assert counter == entry == name
    assert len(args) + 1 == len(ops._SIGNATURES[name][1])
    assert args[6] == 3    # the lane count follows the six pointers
    assert args[-1] == ops.SCALE_MODES["adaptive"]


@pytest.mark.parametrize("L", [1, 3, 8])
@pytest.mark.parametrize("M", [256, 2048])
@pytest.mark.parametrize("kind", sorted(LANE_WRAPPERS))
def test_lane_plans_are_the_one_lane_plans(kind, M, L, monkeypatch):
    """A lane launch's depth and splits are those the 2-D wrapper launches
    on one lane's operands, whatever the lane count: the plan does not
    depend on who shares the call (the shapes split where a plan folding
    L into the tiles would not)."""
    calls = _recorded_launch(monkeypatch)
    lane, flat = (getattr(ops, n) for n in LANE_WRAPPERS[kind])
    sa, sb = _lane_shapes(kind, L, M=M)
    a, b = _OnCard(torch.empty(sa)), _OnCard(torch.empty(sb))
    f = core.get_format("e4m3")
    lane(a, b, f, f)
    flat(a[0], b[0], f, f)
    (_, _, la), (_, _, fa) = calls
    # lane: pointers, L, M, N, K, depth, splits; 2-D: pointers, M, N, K,
    # depth, splits (the forward then takes its small-M flag)
    assert la[7:12] == fa[6:11]
    assert la[12:] == (fa[12:] if kind == "fwd" else fa[11:])


def test_lane_plans_split_where_a_folded_plan_would_not():
    """At the proxy's width (batch 2048, 512 -> 2048) the one-lane plan of
    the dgrad and wgrad splits the contraction 4 ways; with 8 lanes folded
    into the tiles it would not split: the planted plan fault of the card
    check changes the order of the sums there."""
    assert ops.bwd_gemm_plan(2048, 512, 2048) == (2048, 4)    # dgrad
    assert ops.bwd_gemm_plan(512, 2048, 2048) == (2048, 4)    # wgrad
    assert ops.bwd_gemm_plan(8 * 2048, 512, 2048) == (2048, 1)
    assert ops.bwd_gemm_plan(8 * 512, 2048, 2048) == (2048, 1)


@pytest.mark.parametrize("name", ["e4m3", "e2m1"])
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("kind", sorted(LANE_WRAPPERS))
def test_plain_lane_versions_are_their_per_lane_plain_versions(kind, dtype,
                                                               name):
    g = torch.Generator().manual_seed(3)
    sa, sb = _lane_shapes(kind, 3, M=40, K=70, N=48)
    a = torch.randn(sa, generator=g).to(DTYPES[dtype][0])
    b = (torch.randn(sb, generator=g) / 8).to(DTYPES[dtype][0])
    f = core.get_format(name)
    lane, flat = (getattr(ops, n) for n in LANE_WRAPPERS[kind])
    ops.reset_launches()
    got = lane(a, b, f, f, scale_mode="bump")
    want = torch.stack([flat(a[i], b[i], f, f, scale_mode="bump")
                        for i in range(3)])
    assert got.dtype == a.dtype and torch.equal(got, want)
    assert all(n == 0 for n in ops.LAUNCHES.values())


@pytest.mark.parametrize("M", [1, 8])
def test_forward_lane_call_at_small_m_raises(M):
    f = core.get_format("e4m3")
    with pytest.raises(NotImplementedError, match="Queue A item 4"):
        ops.mx_matmul_lanes(torch.randn(2, M, 64), torch.randn(2, 64, 32),
                            f, f)
    # the backward lane GEMMs run the wgmma path at any row count
    assert ops.mx_matmul_dgrad_lanes(torch.randn(2, M, 32),
                                     torch.randn(2, 64, 32), f, f).shape \
        == (2, M, 64)


@pytest.mark.parametrize("kind", ["dgrad", "wgrad"])
def test_card_lane_checks_reject_the_planted_lane_faults(kind):
    """chip_smoke's LANE_FAULTS on CPU tensors: a lane reading its
    neighbour's weight fails gemm_check and the bitwise check; the folded
    plan, in the split emulation, gives other bits than the one-lane plan,
    whose lanes are each the 2-D emulation's bits."""
    cs = _chip_smoke()
    f = core.get_format("e4m3")
    g = torch.Generator().manual_seed(5)
    L, (B, d, h) = 2, (1024, 512, 2048)
    a, b = cs.lane_operands(kind, B, d, h, f, g, lanes=L)
    fn, fn2, plain, axes = cs.lane_fns(kind)
    two = torch.stack([fn2(a[i], b[i], f, f) for i in range(L)])
    qa = core.quantize_mx(a, f, axis=axes[0])
    qb = core.quantize_mx(b, f, axis=axes[1])
    ma, mb = cs.lane_product(kind, qa.abs(), qb.abs())
    want = plain(a, b, f, f)
    assert cs.gemm_check(two, want, ma, mb, ma.shape[-1])[0]
    bad = cs.planted_lanes(kind, a, b, f, "floor", cs.LANE_FAULTS[0])
    assert not torch.equal(bad, two)
    assert not cs.gemm_check(bad, want, ma, mb, ma.shape[-1])[0]
    assert cs.lane_splits(kind, a, b) > cs.lane_splits(
        kind, a, b, cs.folded_plan(L)) >= 1
    lanes = cs.planted_lanes(kind, a, b, f, "floor")
    per_lane = torch.cat([cs.split_product(kind, a[i:i + 1], b[i:i + 1], f)
                          for i in range(L)])
    assert torch.equal(lanes, per_lane)
    folded = cs.planted_lanes(kind, a, b, f, "floor", cs.LANE_FAULTS[1])
    assert not torch.equal(folded, lanes)
    assert cs.gemm_check(folded, want, ma, mb, ma.shape[-1])[0]


@pytest.mark.gpu
def test_lane_kernels_match_the_2d_kernels_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode "
                    "(run chip_smoke.py on the card)")
    cs = _chip_smoke()
    g = torch.Generator(device="cuda").manual_seed(0)
    for name in ("e4m3", "e2m1"):
        f = core.get_format(name)
        for kind in sorted(LANE_WRAPPERS):
            a, b = cs.lane_operands(kind, 300, 100, 200, f, g, lanes=3)
            for mode in ("floor", "adaptive"):
                c = cs.lane_case(kind, a, b, f, mode)
                assert c["bitwise_2d"] and c["replay"] and c["worst"] <= 1
