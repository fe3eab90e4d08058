"""The arithmetic of the tensor-core flash forward and of the streaming MX
quantize, on the CPU.

The CUDA kernels have no CPU mode, so their new arithmetic is held here
through plain emulations and ``chip_smoke.py``'s card checks:

  * the flash forward (``csrc/mx_attention.cu``) casts q, k and v once in
    a pre-pass, forms S on the tensor cores from those exact bf16
    operands twice per JAX tile (the tile's row max, then p), casts p per
    32 columns in the m16n8k16 accumulator layout (``mx_mma_*`` in
    ``csrc/mx_quant.cuh``) and, in bf16 mode, takes p into PV as three
    bf16 pieces.  Its emulation (``chip_smoke.flash_fwd_split``) passes
    ``attn_check`` against the plain version and the JAX oracle under
    every mask, with one and two JAX tiles, G 1 and 2, d 64 and 128 and
    every scale rule; the accumulator layout's lane sum is the warp
    butterfly's (hypothesis over fp32 bit patterns); the card's fp64
    check of the bf16-mode fp32 out rejects one-piece p;
  * the quantize kernel (``csrc/mx_quant.cu``) casts a 32-block held
    eight consecutive elements a lane over four lanes; an emulation of
    that layout's sums equals the plain version in all five formats under
    every rule.

Tolerances are the card checks' own (``attn_check``, and in MX mode
``attn_check_ties``: an output whose p holds a near tie of its cast may
differ by what the tie moves when each p moves by its derived reach,
``flash_tie_slack``; lse within 1e-4;
``flash_fwd_worst``);
adaptive choices that differ from the plain version's must be near ties
(``scale_choice_check``).
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import core as jcore
from repro.kernels import ref as jref
from repro_torch import core
from repro_torch.kernels import ops, ref

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    path = ROOT / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
MODES = ["floor", "bump", "adaptive"]


def _bf16_values(rng, shape, std=1.0):
    """bf16 values (the kernels' inputs) drawn with numpy."""
    x = (rng.standard_normal(shape) * std).astype(np.float32)
    return torch.from_numpy(x).bfloat16()


def _jax_bf16(x):
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


def _torch(a):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))


# --- the split flash forward against both oracles --------------------------

SPECS = {
    "causal": dict(kind="causal", q_offset=8),
    "full": dict(kind="full"),
    "window": dict(kind="window", window=40, q_offset=16),
}
# (G, d): one query head of 64 wide, two of 128 (the kernel's 32-row blocks)
HEADS = [(1, 64), (2, 128)]


def _fwd_case(kind, tiles, G, d, mode, seed=7, BH=2, Tq=45, Tk=77):
    """Inputs at smoke size (ragged Tq and Tk), with kv tiles of 1024 (one
    JAX tile) or 64 (two, the second ragged), whose MX blocks make the
    scale rules matter (``chip_smoke.mode_input``; q and k at std 2^-1 so
    the logits stay moderate)."""
    fmt = core.get_format("e4m3")
    g = torch.Generator().manual_seed(seed + d + G)
    q = CS.mode_input((BH, G, Tq, d), -1, fmt, g, 0.5)
    k = CS.mode_input((BH, Tk, d), -1, fmt, g, 0.5)
    v = CS.mode_input((BH, Tk, d), 1, fmt, g)
    kw = dict(SPECS[kind], q_chunk=32, kv_chunk=1024 if tiles == 1 else 64)
    return q, k, v, kw


@pytest.mark.parametrize("G,d", HEADS)
@pytest.mark.parametrize("tiles", [1, 2])
@pytest.mark.parametrize("kind", sorted(SPECS))
@pytest.mark.parametrize("mode", MODES)
def test_split_forward_passes_attn_check_against_both_oracles(mode, kind,
                                                              tiles, G, d):
    q, k, v, kw = _fwd_case(kind, tiles, G, d, mode)
    tf, jf = core.get_format("e4m3"), jcore.get_format("e4m3")
    spec = core.AttnSpec(**kw)
    got, lse = CS.flash_fwd_split(q, k, v, tf, spec, mode)
    want_t, lse_t = ref.mx_flash_attention_ref(q, k, v, tf, spec,
                                               scale_mode=mode)
    jo, jl = jref.mx_flash_attention_ref(_jax_bf16(q), _jax_bf16(k),
                                         _jax_bf16(v), jf,
                                         jcore.AttnSpec(**kw),
                                         scale_mode=mode)
    floor = CS.attn_floor(v, k.shape[1])
    slack, info = CS.flash_tie_slack(q, k, v, tf, spec, mode)
    assert info["gap_over_share"] <= 1.0
    for want, lse_w in ((want_t, lse_t), (_torch(jo), _torch(jl))):
        ok, worst = CS.attn_check_ties(got.to(torch.bfloat16), want, floor,
                                       slack)
        assert ok, worst
        assert (lse - lse_w).abs().max().item() <= 1e-4
    assert got.abs().max() > 0


@pytest.mark.parametrize("G,d", HEADS)
@pytest.mark.parametrize("tiles", [1, 2])
@pytest.mark.parametrize("kind", sorted(SPECS))
def test_split_forward_bf16_mode_against_both_oracles(kind, tiles, G, d):
    """bf16 mode: p into PV as three bf16 pieces."""
    rng = np.random.default_rng(d + tiles)
    q = _bf16_values(rng, (2, G, 45, d))
    k, v = _bf16_values(rng, (2, 77, d)), _bf16_values(rng, (2, 77, d))
    kw = dict(SPECS[kind], q_chunk=32, kv_chunk=1024 if tiles == 1 else 64)
    spec = core.AttnSpec(**kw)
    got, lse = CS.flash_fwd_split(q, k, v, None, spec)
    want_t, lse_t = ref.mx_flash_attention_ref(q, k, v, None, spec)
    jo, jl = jref.mx_flash_attention_ref(_jax_bf16(q), _jax_bf16(k),
                                         _jax_bf16(v), None,
                                         jcore.AttnSpec(**kw))
    for want, lse_w in ((want_t, lse_t), (_torch(jo), _torch(jl))):
        ok, worst = CS.attn_check(got.to(torch.bfloat16), want,
                                  CS.attn_floor(v, 77))
        assert ok, worst
        assert (lse - lse_w).abs().max().item() <= 1e-4


def test_split_forward_tells_the_tile_max_apart():
    """The split takes p after the rescale by the whole JAX tile's max: a
    second tile holding a larger score changes the first tile's casts, so
    the split with one tile of 64 differs from the one with a tile of 1024
    (both within attn_check of their own plain version)."""
    q, k, v, kw = _fwd_case("full", 1, 1, 64, "floor")
    fmt = core.get_format("e4m3")
    outs = []
    for kv in (1024, 64):
        spec = core.AttnSpec(kind="full", q_chunk=32, kv_chunk=kv)
        got = CS.flash_fwd_split(q, k, v, fmt, spec)[0]
        want = ref.mx_flash_attention_ref(q, k, v, fmt, spec)[0]
        assert CS.attn_check(got.to(torch.bfloat16), want,
                             CS.attn_floor(v, 77))[0]
        outs.append(got)
    assert not torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("mode", MODES)
def test_tie_slack_hides_no_planted_fault(mode):
    """The per-element near-tie slack of the card's check leaves every
    planted flash fault of the mode rejected (one causal tile, T 128), the
    fault-free planted version passes, and the slack is small against the
    outputs: one near tie moves its output by at most a quantum of p (2^-3
    of p in e4m3) times |v| / l, so its largest is under 2^-3 of the
    median output and its mean under 2^-9 of it."""
    rng = np.random.default_rng(4)
    q = _bf16_values(rng, (2, 1, 128, 64))
    k, v = _bf16_values(rng, (2, 128, 64)), _bf16_values(rng, (2, 128, 64))
    fmt, spec = core.get_format("e4m3"), core.AttnSpec()
    want = ref.mx_flash_attention_ref(q, k, v, fmt, spec, scale_mode=mode)[0]
    slack, info = CS.flash_tie_slack(q, k, v, fmt, spec, mode)
    floor = CS.attn_floor(v, 128)
    typical = float(want.float().abs().median())
    assert float(slack.max()) < 2.0 ** -3 * typical
    assert float(slack.mean()) < 2.0 ** -9 * typical
    assert 0 < info["gap"] <= info["gap_over_share"] * info["reach"]
    CS.check_controls("flash", lambda got: CS.attn_check_ties(
        got, want, floor, slack), lambda f: CS.planted_flash(q, k, v, fmt,
                                                             f, mode),
        CS.FLASH_MODE_FAULTS[mode])
    assert CS.attn_check_ties(CS.flash_fwd_split(q, k, v, fmt, spec, mode)[0]
                              .to(torch.bfloat16), want, floor, slack)[0]


def test_tie_reach_holds_the_plain_scores():
    """The reach of p (p_reach) covers the plain version's own p against p
    from fp64 scores, and flash_tie_slack raises where it would not (a
    plain version whose scores are off by more than their share)."""
    rng = np.random.default_rng(5)
    q = _bf16_values(rng, (2, 1, 96, 64), std=2.0)
    k, v = _bf16_values(rng, (2, 96, 64)), _bf16_values(rng, (2, 96, 64))
    fmt, spec = core.get_format("e4m3"), core.AttnSpec()
    info = CS.flash_tie_slack(q, k, v, fmt, spec)[1]
    assert 0 < info["gap_over_share"] <= 1.0
    eps = CS.SCORE_EPS
    try:
        CS.SCORE_EPS = eps * info["gap_over_share"] / 4
        with pytest.raises(AssertionError, match="outside its share"):
            CS.flash_tie_slack(q, k, v, fmt, spec)
    finally:
        CS.SCORE_EPS = eps


def test_tie_slack_is_zero_off_the_ties():
    """Most outputs have no near tie: the slack widens few rows."""
    rng = np.random.default_rng(6)
    q = _bf16_values(rng, (2, 1, 128, 64))
    k, v = _bf16_values(rng, (2, 128, 64)), _bf16_values(rng, (2, 128, 64))
    slack = CS.flash_tie_slack(q, k, v, core.get_format("e4m3"),
                               core.AttnSpec())[0]
    rows = (slack > 0).any(-1)
    assert rows.float().mean() < 0.1


# --- the accumulator layout's lane sum -------------------------------------

def _warp_butterfly(v):
    """mx_warp_sum: lane i holds v[i]; lane 0's value at the end."""
    lanes = v.copy()
    o = 16
    while o:
        lanes = (lanes + lanes[np.arange(32) ^ o]).astype(np.float32)
        o //= 2
    return lanes[0]


def _mma_lane_sum(v):
    """mx_mma_sum: lane tq of a quad holds columns 8t + 2tq + b in
    s[2t + b]; steps 16 and 8 in the lane, lane exchanges xor 2 and xor 1,
    then step 1 in the lane.  Returns each lane's value."""
    s = np.empty((4, 8), np.float32)
    for tq in range(4):
        for t in range(4):
            for b in range(2):
                s[tq, 2 * t + b] = v[8 * t + 2 * tq + b]
    s[:, :4] = (s[:, :4] + s[:, 4:]).astype(np.float32)
    s[:, :2] = (s[:, :2] + s[:, 2:4]).astype(np.float32)
    for o in (2, 1):
        s[:, :2] = (s[:, :2] + s[np.arange(4) ^ o, :2]).astype(np.float32)
    return (s[:, 0] + s[:, 1]).astype(np.float32)


def _same(a, b):
    return (np.isnan(a) and np.isnan(b)) or a.tobytes() == b.tobytes()


EDGE_BITS = [0x00000001, 0x007FFFFF, 0x00800000, 0x3F800001, 0x7F7FFFFF,
             0xFF7FFFFF, 0x7F800000, 0x7FC00000, 0x80000000, 0x4B800000,
             0x33800000]


@settings(max_examples=300, deadline=None, derandomize=True)
@given(st.lists(st.integers(0, 2 ** 32 - 1), min_size=32, max_size=32),
       st.lists(st.sampled_from(EDGE_BITS), max_size=4))
def test_mma_lane_sum_is_the_warp_butterfly(words, edges):
    """Every lane of the quad ends with the butterfly's value, bit for bit
    (NaN where it is NaN), for any fp32 bit patterns."""
    words = (edges + words)[:32]
    v = np.array(words, dtype=np.uint32).view(np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        want = _warp_butterfly(v)
        got = _mma_lane_sum(v)
    for lane in got:
        assert _same(lane, want)


def test_butterfly_sum_of_the_card_checks_is_the_warp_butterfly():
    rng = np.random.default_rng(3)
    for _ in range(200):
        v = (rng.standard_normal(32) * 10.0 ** rng.integers(-6, 6, 32)
             ).astype(np.float32)
        got = CS.butterfly_sum(torch.from_numpy(v)).numpy()
        assert got.tobytes() == _warp_butterfly(v).tobytes()


# --- the bf16-mode fp64 check -----------------------------------------------

@pytest.mark.parametrize("kind,d", [("causal", 64), ("full", 64),
                                    ("window", 64), ("causal", 128)])
def test_fp64_check_rejects_one_piece_p(kind, d):
    """On CPU tensors the kernel is the plain version: it reads as the
    plain version against fp64 attention, inside max(1, 2x) that reading,
    and p as one bf16 piece exceeds it several times over."""
    rng = np.random.default_rng(11)
    q = _bf16_values(rng, (2, 2, 96, d))
    k, v = _bf16_values(rng, (2, 130, d)), _bf16_values(rng, (2, 130, d))
    spec = core.AttnSpec(**SPECS[kind])
    ok, kernel, plain, planted, replay = CS.flash_fwd_fp64_case(q, k, v,
                                                                spec)
    assert ok and replay and kernel == plain
    assert plain < 1.0
    assert planted > 4 * max(1.0, 2 * plain), (plain, planted)


def test_three_pieces_of_the_split_stay_within_the_fp64_check():
    rng = np.random.default_rng(12)
    q = _bf16_values(rng, (2, 1, 96, 64))
    k, v = _bf16_values(rng, (2, 96, 64)), _bf16_values(rng, (2, 96, 64))
    spec = core.AttnSpec()
    exact, bnd = CS.flash_fwd_dense(q, k, v, spec)
    three = CS.flash_fwd_worst(CS.flash_fwd_split(q, k, v, None, spec)[0],
                               exact, bnd)
    one = CS.flash_fwd_worst(
        CS.flash_fwd_split(q, k, v, None, spec, pieces=1)[0], exact, bnd)
    assert three < 1.0 < one


# --- the card's per-case check on CPU tensors --------------------------------

@pytest.mark.parametrize("edge", CS.FLASH_FWD_EDGES, ids=lambda e: e[0])
def test_flash_fwd_case_on_cpu_tensors(edge):
    """flash_fwd_case's plumbing (out_dtype fp32 is the bf16 out before its
    rounding, replay, lse) at each edge, one (bh) row, through the plain
    version."""
    label, BH, G, Tq, Tk, d, kw = edge
    rng = np.random.default_rng(len(label))
    q = _bf16_values(rng, (1, G, Tq, d))
    k, v = _bf16_values(rng, (1, Tk, d)), _bf16_values(rng, (1, Tk, d))
    for fmt in (core.get_format("e4m3"), None):
        c = CS.flash_fwd_case(q, k, v, fmt, core.AttnSpec(**kw))
        assert c["ok"] and c["replay"] and c["worst"] == 0.0


def test_flash_fwd_edges_cover_the_kernel_paths():
    edges = {e[0]: e for e in CS.FLASH_FWD_EDGES}
    assert any(e[3] % 64 and e[4] % 64 for e in edges.values())   # ragged
    assert any(e[2] == 2 for e in edges.values())                  # G 2
    assert any(e[5] == 128 for e in edges.values())                # d 128
    assert any(e[5] % 8 for e in edges.values())          # element loads
    kinds = {e[6].get("kind", "causal") for e in edges.values()}
    assert kinds == {"causal", "full", "window"}
    assert any(e[6].get("q_offset", 0) and e[3] < e[4]
               for e in edges.values())                            # chunk
    two = [e for e in edges.values() if e[4] > core.AttnSpec().kv_chunk]
    assert {e[6].get("kind", "causal") for e in two} == {"causal", "full"}


def test_wrapper_out_dtype_on_cpu():
    rng = np.random.default_rng(2)
    q = _bf16_values(rng, (1, 1, 40, 64))
    k, v = _bf16_values(rng, (1, 40, 64)), _bf16_values(rng, (1, 40, 64))
    fmt, spec = core.get_format("e4m3"), core.AttnSpec()
    o, lse = ops.mx_flash_attention(q, k, v, fmt, spec)
    of, lsef = ops.mx_flash_attention(q, k, v, fmt, spec,
                                      out_dtype=torch.float32)
    assert o.dtype == torch.bfloat16 and of.dtype == torch.float32
    assert torch.equal(of.to(torch.bfloat16), o) and torch.equal(lse, lsef)


# --- the quantize's four-lane layout ----------------------------------------

def _quad_quantize(x, fmt, mode):
    """The streaming quantize's cast along the last axis: a 32-block held
    eight consecutive elements a lane by four lanes; the adaptive rule's
    errors summed as mx_quad_sum (lane exchanges xor 2 and xor 1, then
    steps 4, 2 and 1 in the lane)."""
    from repro_torch.core.formats import exp2_int, floor_log2, quantize_elem
    from repro_torch.core.mx import block_reshape, block_unreshape
    xf = x.float()
    xb, n = block_reshape(xf, -1, 32)
    m = xb.abs().amax(-1)
    e = floor_log2(torch.where(m > 0, m, torch.ones_like(m))) - fmt.e_max

    def cast(c):
        sc = exp2_int(c)[..., None]
        return quantize_elem(xb / sc, fmt) * sc

    def quad_sum(s):
        s = s.unflatten(-1, (4, 8))
        for o in (2, 1):
            s = s + s[..., torch.arange(4) ^ o, :]
        for o in (4, 2, 1):
            s = torch.cat([s[..., :o] + s[..., o:2 * o], s[..., o:]], -1)
        return s[..., 0, 0]
    if mode == "bump":
        e = e + ((xb.abs() / exp2_int(e)[..., None]) > fmt.max_normal
                 ).any(-1).to(e.dtype)
    elif mode == "adaptive":
        err0 = quad_sum(torch.square(cast(e) - xb))
        err1 = quad_sum(torch.square(cast(e + 1) - xb))
        e = torch.where(err1 < err0, e + 1, e)
    e = torch.where(m > 0, torch.clamp(e, -126, 127), torch.full_like(e,
                                                                      -126))
    y = block_unreshape(cast(e), -1, n)
    return (xf + (y - xf)).to(x.dtype)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fmt_name", ["e4m3", "e5m2", "e3m2", "e2m3",
                                      "e2m1"])
def test_quad_layout_quantize_equals_the_plain_version(fmt_name, mode):
    """In all five formats under every rule, fp32 and bf16, on blocks that
    make the rules matter, with a partial last block (K 48, zero padded in
    registers): bitwise, or for "adaptive" a near tie where it differs."""
    fmt = core.get_format(fmt_name)
    g = torch.Generator().manual_seed(5)
    for shape in ((64, 512), (100, 48)):
        for dtype in (torch.float32, torch.bfloat16):
            x = CS.mode_input(shape, -1, fmt, g, dtype=dtype,
                              edges=shape[-1] > 256)
            got = _quad_quantize(x, fmt, mode)
            ok, n_off, _ = CS.scale_choice_check(x, got, fmt, -1, mode)
            assert ok, (shape, dtype, n_off)
            if mode != "adaptive":
                assert n_off == 0


def test_quantize_rows_cover_both_paths():
    """QUANTIZE_ROWS times the training step's xn first and reaches the
    one-element-a-lane path by a ragged K and by a misaligned view."""
    rows = CS.QUANTIZE_ROWS
    assert rows[0][1] == (4096, 512) and rows[0][4]
    assert sum(r[4] for r in rows) == 1
    assert any(r[1][-1] % 8 for r in rows)             # K 70
    assert any(r[1][-1] % 32 and not r[1][-1] % 8 for r in rows)   # K 48
    assert any(r[3] for r in rows)                     # misaligned view
    assert {r[2] for r in rows} == {"float32", "bfloat16"}


# --- the shared header -------------------------------------------------------

def test_mma_header_carries_its_note_and_both_attention_sources_use_it():
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    text = (csrc / "mx_mma.cuh").read_text()
    head = text[:text.index("#include")]
    for key in ("Included by:", "Replaces:", "Bound:", "Design:"):
        assert key in head
    assert "src/repro/kernels/" in head
    for name in ("mx_attention.cu", "mx_attention_bwd.cu"):
        src = (csrc / name).read_text()
        assert '#include "mx_mma.cuh"' in src
        for helper in ("void bw_cp16(", "void mma_bf16(", "void bw_pieces(",
                       "void ldsm4("):
            assert helper not in src, (name, helper)   # one copy, shared
    for name in ("mx_flash_attention", "mx_flash_attention_bwd"):
        assert ops.KERNELS[name][0][-1].endswith("mx_mma.cuh")


# --- on the card ------------------------------------------------------------

@pytest.mark.gpu
def test_flash_forward_and_quantize_match_plain_versions_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode "
                    "(run chip_smoke.py on the card)")
    fmt = core.get_format("e4m3")
    for mode in MODES:
        for kind in sorted(SPECS):
            for tiles in (1, 2):
                q, k, v, kw = _fwd_case(kind, tiles, 2, 128, mode)
                c = CS.flash_fwd_case(q.cuda(), k.cuda(), v.cuda(), fmt,
                                      core.AttnSpec(**kw), mode)
                assert c["ok"], (mode, kind, tiles, c["worst"])
        g = torch.Generator().manual_seed(1)
        for shape in ((4096, 512), (100, 48), (100, 70)):
            x = CS.mode_input(shape, -1, fmt, g, dtype=torch.float32).cuda()
            got = ops.mx_quantize(x, fmt, scale_mode=mode)
            assert CS.scale_choice_check(x, got, fmt, -1, mode)[0]


# --- the card timer's window check ------------------------------------------

class _Window:
    """A profiler window's key_averages(): (kernel name, count) pairs."""

    def __init__(self, counts):
        cuda = torch.autograd.DeviceType.CUDA
        self.rows = [type("Row", (), dict(key=k, count=n, device_type=cuda))
                     for k, n in counts.items()]

    def key_averages(self):
        return self.rows


@pytest.mark.parametrize("counts,ok", [
    ({"flush": 20, "fwd": 20, "cast": 40}, True),
    ({"flush": 19, "fwd": 20, "cast": 40}, False),   # a flush record lost
    ({"flush": 20, "fwd": 19, "cast": 40}, False),   # a call's record lost
    ({"flush": 20, "fwd": 20, "cast": 39}, False),
    ({"flush": 20}, False),                          # no kernel of fn seen
    ({"fwd": 20}, False),                            # no flush seen
    # the spin kernels that open a window are not counted
    ({"flush": 20, "fwd": 20, "spin_kernel(long)": 32}, True),
    ({"flush": 20, "spin_kernel(long)": 32}, False),
])
def test_timer_retakes_a_window_that_lost_records(counts, ok, monkeypatch):
    """time_parts_ms keeps a profiler window only when it saw the flush's
    kernel once per iteration and each of fn's kernels a whole multiple of
    the iterations."""
    monkeypatch.setattr(CS, "_FLUSH_KEYS", frozenset({"flush"}))
    assert CS._window_counts_ok(_Window(counts), 20) is ok
