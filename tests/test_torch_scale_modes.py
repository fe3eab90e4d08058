"""The scale rules ("floor", "bump", "adaptive") in the CUDA kernels' Python
side, and the forward GEMM's plan, on the CPU.

On the card every kernel takes the rule in its format arguments
(``csrc/mx_quant.cuh``: ``MxFmt::scale_mode``) and ``chip_smoke.py``
holds each kernel against its plain version under "bump" and "adaptive".
Here: the wrappers' format arguments and the C entry points agree on
where the rule goes, ``_check_mx`` takes every rule and refuses others,
the forward GEMM's path plan at every M of the main path, the plain
forward GEMM against ``repro``'s ``quantize_mx`` and a matmul under each
rule and format, the card check's adaptive near-tie rule and its planted
faults, and the argument that a block held by one thread sums its
adaptive errors in the warp's butterfly order.

Tolerance: the plain GEMM against the reference, one bf16 ulp of the
reference plus n * 2^-24 * sum |terms| (the two sum in different orders).
"""
import importlib.util
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.kernels import ref as jref
from repro_torch import core
from repro_torch.kernels import ops, ref

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
FORMATS = ["e4m3", "e5m2", "e3m2", "e2m3", "e2m1"]
MODES = ["floor", "bump", "adaptive"]
# (K in, N out) of olmo-paper's weights: wq (wk, wv, wo), w_up, w_down,
# lm_head.
WEIGHTS = [(512, 512), (512, 2048), (2048, 512), (512, 32000)]


def _chip_smoke():
    path = ROOT / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mode", MODES)
def test_fmt_args_carry_the_scale_rule_last(mode):
    f = core.get_format("e4m3")
    args = ops._fmt_args(f, mode)
    assert args == [f.mbits, f.min_normal_exp, f.e_max, f.max_normal,
                    ops.SCALE_MODES[mode]]
    assert len(args) == len(ops._FMT) == 5
    assert ops._fmt_args(None, mode) == [0, 0, 0, 0.0, 0]
    assert ops.SCALE_MODES == {"floor": 0, "bump": 1, "adaptive": 2}


def _c_params(name: str, lib: str):
    text = (CSRC / f"{lib}.cu").read_text()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    assert m, name
    return [p.strip() for p in m.group(1).split(",")]


@pytest.mark.parametrize("name", sorted(ops._SIGNATURES))
def test_c_entry_points_match_their_ctypes_signatures(name):
    """Each C entry point takes as many arguments as its ctypes signature,
    and every format quintuple ends with its scale rule."""
    lib, argtypes = ops._SIGNATURES[name]
    params = _c_params(name, lib)
    assert len(params) == len(argtypes), (name, params)
    for i, p in enumerate(params):
        if p.endswith("max_normal"):
            assert params[i + 1].endswith("scale_mode"), (name, params)
            assert argtypes[i] is ops._F and argtypes[i + 1] is ops._I
    n_fmt = sum(p.endswith("max_normal") for p in params)
    assert n_fmt == sum(p.endswith("scale_mode") for p in params)


def test_c_rule_codes_match_the_wrappers():
    text = (CSRC / "mx_quant.cuh").read_text()
    assert "enum { MX_FLOOR = 0, MX_BUMP = 1, MX_ADAPTIVE = 2 };" in text


@pytest.mark.parametrize("mode", MODES)
def test_check_mx_takes_every_scale_rule(mode):
    f = core.get_format("e4m3")
    ops._check_mx("t", f, core.MX_BLOCK, mode)
    ops._check_mx("t", None, core.MX_BLOCK, mode)
    with pytest.raises(NotImplementedError, match="32-wide"):
        ops._check_mx("t", f, 16, mode)


def test_check_mx_refuses_an_unknown_rule_before_any_launch():
    with pytest.raises(ValueError, match="unknown scale_mode"):
        ops._check_mx("t", core.get_format("e4m3"), core.MX_BLOCK, "ceil")
    with pytest.raises(ValueError, match="unknown scale_mode"):
        ops._check_mx("t", None, core.MX_BLOCK, "ceil")


# The main path's M: decode (max_batch 4), paged decode (6 rows), chunked
# prefill (64), whole prefill buckets (64..512), the proxy (2048), training
# (8 x 512 tokens).
@pytest.mark.parametrize("M", [4, 6, 16, 17, 64, 256, 512, 2048, 4096])
@pytest.mark.parametrize("K,N", WEIGHTS)
def test_fwd_gemm_plan_at_every_m_of_the_main_path(M, K, N):
    small, depth, splits = ops.fwd_gemm_plan(M, N, K)
    assert small == (M <= ops.FWD_SMALL_M)
    if not small:
        assert (depth, splits) == ops.bwd_gemm_plan(M, N, K)
        return
    assert depth == 0
    slabs = -(-K // 32)
    per = -(-slabs // splits)   # as the kernel divides them
    assert 1 <= per <= ops.FWD_SLABS         # a slab for each warp at most
    assert (splits - 1) * per < slabs        # no split is empty
    assert splits == -(-slabs // ops.FWD_SLABS)


def test_fwd_gemm_plan_of_the_decode_weights():
    assert ops.fwd_gemm_plan(4, 32000, 512) == (True, 0, 2)
    assert ops.fwd_gemm_plan(4, 512, 2048) == (True, 0, 8)
    assert ops.fwd_gemm_plan(6, 2048, 512) == (True, 0, 2)
    assert ops.fwd_gemm_plan(4096, 32000, 512) == (False, 512, 1)
    assert ops.fwd_gemm_plan(5, 200, 48) == (True, 0, 1)
    assert ops.fwd_gemm_plan(5, 200, 1000) == (True, 0, 4)


@pytest.mark.parametrize("mode", ["bump", "adaptive"])
@pytest.mark.parametrize("name", FORMATS)
def test_plain_matmul_matches_reference_under_each_rule(name, mode):
    rng = np.random.default_rng(FORMATS.index(name))
    a = rng.standard_normal((6, 200)).astype(np.float32)
    b = (rng.standard_normal((200, 40)) / 14).astype(np.float32)
    a[:, 32:64] *= 1.9 / np.abs(a[:, 32:64]).max(1, keepdims=True)
    f, jf = core.get_format(name), jcore.get_format(name)
    ta, tb = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    got = ref.mx_matmul_ref(ta, tb, f, f, scale_mode=mode)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    qa = jcore.quantize_mx(ja, jf, axis=-1, scale_mode=mode)
    qb = jcore.quantize_mx(jb, jf, axis=0, scale_mode=mode)
    want = np.asarray(jnp.matmul(qa.astype(jnp.float32),
                                 qb.astype(jnp.float32)))
    terms = np.abs(np.asarray(qa.astype(jnp.float32))) @ np.abs(
        np.asarray(qb.astype(jnp.float32)))
    e = np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
    tol = np.exp2(e - 7) + 200 * 2.0 ** -24 * terms
    assert np.all(np.abs(got.float().numpy() - want) <= tol)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["e3m2", "e2m3", "e2m1"])
@pytest.mark.parametrize("kind", ["dgrad", "wgrad"])
def test_plain_dgrad_wgrad_match_reference_in_low_bit_formats(kind, name,
                                                              mode):
    """The proxy's fp32 dgrad and wgrad (the path every sweep preset trains
    through) in MXFP6 and MXFP4 at a ragged contraction (100: a partial
    last block), against the reference's oracle (floor) or its quantize_mx
    under the rule and a matmul; one bf16 ulp plus the fp32 sum bound."""
    rng = np.random.default_rng(7 + FORMATS.index(name))
    n = 100
    if kind == "dgrad":   # dy (6, n) @ w (40, n)^T, blocks along n
        a = (rng.standard_normal((6, n)) * 1e-2).astype(np.float32)
        b = (rng.standard_normal((40, n)) / 10).astype(np.float32)
        a[:, 32:64] *= 0.019 / np.abs(a[:, 32:64]).max(1, keepdims=True)
        axes = (-1, 1)
    else:                 # x (n, 6)^T @ dy (n, 40), blocks along n
        a = rng.standard_normal((n, 6)).astype(np.float32)
        b = (rng.standard_normal((n, 40)) * 1e-2).astype(np.float32)
        a[32:64] *= 1.9 / np.abs(a[32:64]).max(0, keepdims=True)
        axes = (0, 0)
    f, jf = core.get_format(name), jcore.get_format(name)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    fn = ops.mx_matmul_dgrad if kind == "dgrad" else ops.mx_matmul_wgrad
    got = fn(ta, tb, f, f, scale_mode=mode)
    qa = jcore.quantize_mx(ja, jf, axis=axes[0], scale_mode=mode)
    qb = jcore.quantize_mx(jb, jf, axis=axes[1], scale_mode=mode)
    pair = (qa, qb.T) if kind == "dgrad" else (qa.T, qb)
    if mode == "floor":
        oracle = (jref.mx_matmul_dgrad_ref if kind == "dgrad"
                  else jref.mx_matmul_wgrad_ref)
        want = np.asarray(oracle(ja, jb, jf, jf))
    else:
        want = np.asarray(jnp.matmul(*pair))
    terms = np.abs(np.asarray(pair[0])) @ np.abs(np.asarray(pair[1]))
    tol = np.abs(want) * 2.0 ** -23 + n * 2.0 ** -24 * terms
    assert got.dtype == torch.float32
    assert np.all(np.abs(got.numpy() - want) <= tol)


@pytest.mark.parametrize("mode", MODES)
def test_cpu_wrappers_run_every_rule_and_count_no_launch(mode):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 96, generator=g).bfloat16()
    w = torch.randn(96, 40, generator=g).bfloat16()
    f = core.get_format("e4m3")
    ops.reset_launches()
    assert torch.equal(ops.mx_quantize(x, f, scale_mode=mode),
                       ref.mx_quantize_ref(x, f, scale_mode=mode))
    assert torch.equal(ops.mx_matmul(x, w, f, f, scale_mode=mode),
                       ref.mx_matmul_ref(x, w, f, f, scale_mode=mode))
    assert all(n == 0 for n in ops.LAUNCHES.values())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", FORMATS)
def test_card_scale_check_passes_the_plain_version_and_rejects_faults(
        name, mode):
    """chip_smoke.py's block check passes the plain quantizer and rejects
    every planted fault that changes this rule's output: the floor rule
    (under bump and adaptive), e + 1 everywhere (under adaptive) and the
    cast without the min_normal_exp clamp."""
    cs = _chip_smoke()
    f = core.get_format(name)
    g = torch.Generator().manual_seed(3)
    x = cs.mode_input((4, 512), -1, f, g, dtype=torch.float32, edges=True)
    ok, off, n = cs.scale_choice_check(
        x, cs.planted_quantize(x, f, -1, mode), f, -1, mode)
    assert ok and off == 0 and n == 64
    faults = list(cs.SCALE_FAULTS.get(mode, ())) + [cs.CAST_FAULT]
    for fault in faults:
        y = cs.planted_quantize(x, f, -1, mode, fault)
        assert not cs.scale_choice_check(x, y, f, -1, mode)[0], fault


def test_mode_input_makes_the_rules_matter():
    cs = _chip_smoke()
    f = core.get_format("e4m3")
    x = cs.mode_input((64, 512), -1, f, torch.Generator().manual_seed(0))
    floor = core.quantize_mx(x, f)
    for mode in ("bump", "adaptive"):
        changed = (core.quantize_mx(x, f, scale_mode=mode) != floor).view(
            64, 16, 32).any(-1)
        assert changed[:, 1::4].float().mean() > 0.3   # the planted blocks
        assert changed.float().mean() > 0.2


def test_card_scale_check_takes_the_other_candidate_only_on_a_tie(
        monkeypatch):
    """A block that differs passes only as the plain version's other
    candidate and only within TIE_EPS: with every block a tie, e + 1
    everywhere passes, a perturbed block does not; with no tie allowed,
    e + 1 everywhere fails."""
    cs = _chip_smoke()
    f = core.get_format("e4m3")
    x = cs.mode_input((8, 256), -1, f, torch.Generator().manual_seed(2))
    other = cs.planted_quantize(x, f, -1, "adaptive", "always e + 1")
    monkeypatch.setattr(cs, "TIE_EPS", 1.0)
    ok, off, _ = cs.scale_choice_check(x, other, f, -1, "adaptive")
    assert ok and off > 0
    bad = other.clone()
    bad[0, 3] = bad[0, 3] * 2 + 1
    assert not cs.scale_choice_check(x, bad, f, -1, "adaptive")[0]
    monkeypatch.setattr(cs, "TIE_EPS", 0.0)
    assert not cs.scale_choice_check(x, other, f, -1, "adaptive")[0]


@pytest.mark.parametrize("mode", ["bump", "adaptive"])
def test_card_gemm_check_rejects_the_floor_rule(mode):
    """The forward GEMM under a rule passes gemm_check against its plain
    version; the floor rule planted in the plain quantizers fails it."""
    cs = _chip_smoke()
    f = core.get_format("e4m3")
    g = torch.Generator().manual_seed(5)
    x = cs.mode_input((16, 512), -1, f, g)
    w = cs.mode_input((512, 64), 0, f, g, 1 / math.sqrt(512))
    ties = cs.gemm_mode_case("t", "fwd", x, w, f, f, mode,
                             ("the floor rule",))
    assert ties == 0


def test_thread_tree_sum_is_the_warp_butterfly():
    """mx_tree_sum (one thread, s[i] += s[i + o] for o = 16..1) gives the
    value every lane of mx_warp_sum's xor butterfly ends with, in fp32."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        v = (rng.standard_normal(32) * 10.0 ** rng.integers(-6, 6, 32)
             ).astype(np.float32)
        lanes = v.copy()
        o = 16
        while o:
            lanes = (lanes + lanes[np.arange(32) ^ o]).astype(np.float32)
            o //= 2
        s = v.copy()
        o = 16
        while o:
            s[:o] = (s[:o] + s[o:2 * o]).astype(np.float32)
            o //= 2
        assert np.all(lanes == lanes[0]) and lanes[0] == s[0]


@pytest.mark.gpu
def test_kernels_run_every_scale_rule_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode "
                    "(run chip_smoke.py on the card)")
    cs = _chip_smoke()
    f = core.get_format("e4m3")
    g = torch.Generator().manual_seed(7)
    for mode in ("bump", "adaptive"):
        x = cs.mode_input((64, 512), -1, f, g, dtype=torch.float32,
                          edges=True).cuda()
        y = ops.mx_quantize(x, f, scale_mode=mode)
        assert cs.scale_choice_check(x, y, f, -1, mode)[0]
        for M in (4, 64):
            a = cs.mode_input((M, 512), -1, f, g).cuda()
            w = cs.mode_input((512, 96), 0, f, g, 1 / math.sqrt(512)).cuda()
            cs.gemm_mode_case("gpu", "fwd", a, w, f, f, mode)
