"""The arithmetic of the tensor-core flash dgrad and of the decode split
over a thread-block cluster, on the CPU.

The CUDA kernels have no CPU mode, so their new arithmetic is held here
through plain emulations and ``chip_smoke.py``'s card checks:

  * the flash dgrad (``csrc/mx_attention_bwd.cu``) takes P and dS into its
    bf16 tensor-core products as three bf16 pieces; the split is exact
    (hypothesis over fp32 bit patterns), its emulation
    (``flash_bwd_split`` here) stays within ``FLASH_BWD_EPS`` of the
    term bound against the plain version and the JAX oracle under each
    mask, and a two-piece or TF32 split is told apart from it;
  * the decode kernels (``csrc/mx_attention.cu``) split the view into the
    spans of ``ops.decode_plan`` and combine the cluster's max, sum and
    partial PV in rank order; the emulation (``chip_smoke.split_decode``)
    passes ``attn_check`` against the plain version and the JAX oracle,
    and its planted faults fail it;
  * the decode kernels cast a K row's 32-blocks eight elements a lane over
    four lanes (``mx_quad_*`` in ``csrc/mx_quant.cuh``); that sum order is
    the warp butterfly's.

Tolerances are the card checks' own (``flash_bwd_check``, ``attn_check``).
"""
import importlib.util
import inspect
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

U = 2.0 ** -24   # fp32 unit roundoff


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def _bf16_values(rng, shape, std=1.0):
    """fp32 numpy values that bf16 holds exactly (the kernels' inputs)."""
    x = (rng.standard_normal(shape) * std).astype(np.float32)
    return torch.from_numpy(x).bfloat16().float().numpy()


def _fmt(name):
    return (None, None) if name is None else (jcore.get_format(name),
                                              core.get_format(name))


# --- plain emulation of the flash dgrad kernel's arithmetic ---------------

def bf16_pieces(x, n: int = 3):
    """x (fp32) as ``n`` bf16 pieces, hi = bf16(x), mid = bf16(x - hi),
    lo = bf16(x - hi - mid), each returned in fp32: the kernel's split of
    P and dS (three pieces carry all 24 bits)."""
    out, r = [], x.float()
    for _ in range(n):
        piece = r.to(torch.bfloat16).float()
        out.append(piece)
        r = r - piece
    return out


def tf32(x):
    """x (fp32) rounded to TF32 (10 explicit mantissa bits, to nearest
    even): what a TF32 tensor-core product keeps of an fp32 operand."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def flash_bwd_split(q, k, v, dout, out, lse, fmt, spec, pieces=3):
    """The kernel's arithmetic: p and ds in fp32 from the quantized scores,
    then each gradient product (dq = ds k, dk = ds^T q, dv = p^T dout, raw
    operands) with p or ds as ``pieces`` bf16 pieces (3, the kernel's
    split; 2; or "tf32", one TF32-rounded operand), each piece's product
    in fp64 and the pieces summed in fp32, hi first.  Returns ((dq, dk,
    dv) fp32, the products of the fp32 p and ds in fp64, and the sums of
    their terms' magnitudes)."""
    f64 = torch.float64

    def Q(x):
        return core.quantize_mx(x.float(), fmt, axis=-1)
    d = q.shape[-1]
    valid = CS.attn_valid(spec, q.shape[2], k.shape[1], q.device)
    s = torch.einsum("bgqd,bkd->bgqk", Q(q), Q(k)) * (1.0 / np.sqrt(d))
    p = torch.where(valid, torch.exp(torch.where(valid, s, ref.NEG_INF)
                                     - lse.float()[..., None]), 0.0)
    delta = torch.sum(dout.float() * out.float(), dim=-1)
    dp = torch.einsum("bgqd,bkd->bgqk", dout.float(), v.float())
    ds = p * (dp - delta[..., None]) * (1.0 / np.sqrt(d))
    got, exact, mags = [], [], []
    for eq, x, b in (("bgqk,bkd->bgqd", ds, k), ("bgqk,bgqd->bkd", ds, q),
                     ("bgqk,bgqd->bkd", p, dout)):
        acc = None
        for part in ([tf32(x)] if pieces == "tf32"
                     else bf16_pieces(x, pieces)):
            term = torch.einsum(eq, part.to(f64), b.to(f64)).float()
            acc = term if acc is None else acc + term
        got.append(acc)
        exact.append(torch.einsum(eq, x.to(f64), b.to(f64)))
        mags.append(torch.einsum(eq, x.abs().to(f64), b.abs().to(f64)))
    return tuple(got), tuple(exact), tuple(mags)


# --- the three-piece split ----------------------------------------------

def _split_error(bits: np.ndarray):
    x = torch.from_numpy(bits.astype(np.uint32).view(np.float32).copy())
    hi, mid, lo = bf16_pieces(x, 3)
    back = hi.double() + mid.double() + lo.double()
    return x.double(), back


EDGE_BITS = [0x00000001, 0x00000003, 0x007FFFFF, 0x00800000, 0x0C7FFFFF,
             0x08800001, 0x08FFFFFF, 0x3F800001, 0x3FFFFFFF, 0x7EFFFFFF,
             0x7E800001, 0xBF7FFFFF, 0x80000001, 0xFEFFFFFF]


@settings(max_examples=200, deadline=None, derandomize=True)
@given(st.lists(st.integers(0, 2 ** 32 - 1), min_size=1, max_size=256))
def test_three_piece_split_carries_every_bit(words):
    """hi + mid + lo == x for 2^-110 <= |x| < 2^127 (all 24 bits), and
    within 2^-134 (half of bf16's subnormal step) below, subnormals
    included.  Above 2^127 bf16(x) can round to infinity; P <= 1 and dS
    never get there."""
    bits = np.array(words + EDGE_BITS, dtype=np.uint64)
    x, back = _split_error(bits)
    keep = torch.isfinite(x) & (x.abs() < 2.0 ** 127)
    x, back = x[keep], back[keep]
    big = x.abs() >= 2.0 ** -110
    assert torch.equal(back[big], x[big])
    assert ((back[~big] - x[~big]).abs() <= 2.0 ** -134).all()


# --- the split flash dgrad ------------------------------------------------

SPECS = {
    "causal": dict(kind="causal", q_offset=32),
    "full": dict(kind="full"),
    "window": dict(kind="window", window=24, q_offset=32),
}


def _dgrad_case(kind, fmt, seed=5, BH=2, G=2, Tq=45, Tk=77, d=64):
    """Inputs at smoke size (G 2, ragged Tq and Tk), the JAX forward's out
    and lse, and the JAX oracle's grads, as torch tensors."""
    rng = np.random.default_rng(seed)
    q = _bf16_values(rng, (BH, G, Tq, d))
    k = _bf16_values(rng, (BH, Tk, d))
    v = _bf16_values(rng, (BH, Tk, d))
    do = _bf16_values(rng, (BH, G, Tq, d), 1e-2)
    jf, tf = _fmt(fmt)
    kw = dict(SPECS[kind], q_chunk=32, kv_chunk=32)
    jspec = jcore.AttnSpec(**kw)
    jo, jl = jref.mx_flash_attention_ref(*map(jnp.asarray, (q, k, v)), jf,
                                         jspec)
    want_j = jref.mx_flash_attention_bwd_ref(
        *map(jnp.asarray, (q, k, v, do)), jo, jl, jf, jspec)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    args = (t(q), t(k), t(v), t(do), t(jo), t(jl))
    return args, tf, core.AttnSpec(**kw), tuple(t(w) for w in want_j)


@pytest.mark.parametrize("fmt", [None, "e4m3"])
@pytest.mark.parametrize("kind", sorted(SPECS))
def test_split_dgrad_within_the_card_bound_of_both_oracles(kind, fmt):
    args, tf, spec, want_j = _dgrad_case(kind, fmt)
    got = flash_bwd_split(*args, tf, spec)[0]
    _, bounds = CS.flash_bwd_dense(*args, tf, spec=spec)
    want_t = ref.mx_flash_attention_bwd_ref(*args, tf, spec,
                                            out_dtype=torch.float32)
    for want in (want_t, want_j):
        ok, worst = CS.flash_bwd_check(got, want, bounds)
        assert ok, worst
    # every gradient is non-trivial, so the check compares something
    assert all(g.abs().max() > 0 for g in got)


@pytest.mark.parametrize("kind", sorted(SPECS))
def test_split_is_told_apart_from_two_pieces_and_tf32(kind):
    """Against the fp64 products of the same fp32 P and dS, per element
    over the sum of its terms' magnitudes: the three-piece split stays
    within fp32 rounding (3 piece products and 2 adds, 5 u), a two-piece
    or TF32-rounded split does not."""
    args, tf, spec, _ = _dgrad_case(kind, "e4m3", seed=9)

    def worst(pieces):
        got, exact, mags = flash_bwd_split(*args, tf, spec, pieces=pieces)
        return max(((g.double() - e).abs() / (m + 1e-300)).max().item()
                   for g, e, m in zip(got, exact, mags))
    assert worst(3) <= 5 * U
    assert worst(2) > 16 * U
    assert worst("tf32") > 16 * U


def test_card_flash_bwd_check_rejects_one_piece_under_a_window():
    """The new planted fault, P and dS as one bf16 piece, fails the card's
    flash dgrad check at G 2 under a window mask with q_offset; the
    fault-free dense version passes it."""
    args, tf, spec, _ = _dgrad_case("window", "e4m3", seed=3)
    want = ref.mx_flash_attention_bwd_ref(*args, tf, spec,
                                          out_dtype=torch.float32)
    clean, bounds = CS.flash_bwd_dense(*args, tf, spec=spec)
    assert CS.flash_bwd_check(clean, want, bounds)[0]
    planted, _ = CS.flash_bwd_dense(*args, tf, "P and dS as one bf16 piece",
                                    spec=spec)
    assert not CS.flash_bwd_check(planted, want, bounds)[0]


@pytest.mark.parametrize("mode", ["floor", "bump", "adaptive"])
def test_d128_scale_mode_inputs_at_logits_the_check_can_hold(mode):
    """chip_smoke's [scale-modes] takes q and k at std 2^-2 from d 128 on:
    at std 1 every row holds a tight block (32 values near 1.96 * 2^k) and
    the logits' fp32 rounding alone puts the plain version itself outside
    FLASH_BWD_EPS of the fp64 product; at std 2^-2 it sits well inside."""
    fmt, spec = core.get_format("e4m3"), core.AttnSpec()
    for std, inside in ((1.0, False), (0.25, True)):
        g = torch.Generator().manual_seed(0)

        def mi(shape, axis, s=1.0):
            return CS.mode_input(shape, axis, fmt, g, s)
        q, k = mi((2, 1, 128, 128), -1, std), mi((2, 128, 128), -1, std)
        v, dout = mi((2, 128, 128), -2), mi((2, 1, 128, 128), -1, 1e-2)
        out, lse = ref.mx_flash_attention_ref(q, k, v, fmt, spec,
                                              scale_mode=mode)
        args = (q, k, v, dout, out, lse, fmt, spec)
        plain = ref.mx_flash_attention_bwd_ref(*args, scale_mode=mode,
                                               out_dtype=torch.float32)
        exact, bounds = CS.flash_bwd_dense(*args[:7], scale_mode=mode,
                                           spec=spec)
        ok, worst = CS.flash_bwd_check(plain, exact, bounds)
        assert ok == inside, (std, worst)
        assert inside or worst < 5.0


@pytest.mark.parametrize("mode", ["floor", "bump", "adaptive"])
def test_d128_std1_case_against_fp64(mode):
    """chip_smoke's std 1 d 128 case: the kernel (here, on CPU tensors, the
    plain version) passes its limit of twice the plain version's reading
    against the fp64 grads, and P and dS as one bf16 piece exceed it."""
    fmt, spec = core.get_format("e4m3"), core.AttnSpec()
    g = torch.Generator().manual_seed(0)

    def mi(shape, axis, s=1.0):
        return CS.mode_input(shape, axis, fmt, g, s)
    q, k = mi((2, 1, 128, 128), -1), mi((2, 128, 128), -1)
    v, dout = mi((2, 128, 128), -2), mi((2, 1, 128, 128), -1, 1e-2)
    ok, kernel, plain, planted, replay = CS.flash_bwd_fp64_case(
        q, k, v, dout, fmt, spec, mode)
    assert ok and replay and kernel == plain
    assert planted > max(1.0, 2.0 * plain) * 4, (plain, planted)


@pytest.mark.parametrize("hole", [False, True])
def test_decode_bound_counts_k_rows_of_valid_slots_only(hole):
    """The decode bound moves the K rows of the valid slots, the V rows of
    every slot, q, out and the mask."""
    B, H, G, S, d, dv = 4, 8, 2, 512, 64, 32
    valid = CS.decode_valid(B, S, hole, "cpu")
    n_valid = int(valid.sum())
    every = CS.bound(2 * H * (B * S * (d + dv) + B * G * (d + dv)) + B * S,
                     0.0)[0]
    ms, kind = CS.decode_bound(valid, H, G, d, dv)
    skipped = 2 * H * d * (B * S - n_valid) / CS.HBM_BYTES_PER_S * 1e3
    assert kind == "bytes" and n_valid < B * S
    assert ms == pytest.approx(every - skipped, rel=1e-12)


# --- the decode plan and the cluster combine -------------------------------

@pytest.mark.parametrize("S", [0, 1, 31, 32, 33, 100, 255, 256, 257, 300,
                               511, 512, 513, 1000, 2047, 2048, 4096, 6000])
def test_decode_plan_spans_and_splits(S):
    splits, span = ops.decode_plan(S)
    assert span % 32 == 0 and span >= 32
    assert 1 <= splits <= ops.DECODE_CLUSTER
    assert splits * span >= S
    assert S == 0 or (splits - 1) * span < S   # no CTA without a view slot


def test_decode_plan_depends_on_the_view_alone():
    assert list(inspect.signature(ops.decode_plan).parameters) == ["S"]
    assert ops.decode_plan(512) == (8, 64)   # a cluster of 8 at S 512
    assert ops.decode_plan(2048) == (8, 256)
    assert ops.decode_plan(300) == (5, 64)   # S not a multiple of the span


def _decode_case(B, H, G, S, seed, holes=False):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(_bf16_values(rng, (B * H, G, 64))).bfloat16()
    kc = torch.from_numpy(_bf16_values(rng, (B, S, H, 64))).bfloat16()
    vc = torch.from_numpy(_bf16_values(rng, (B, S, H, 64))).bfloat16()
    pos = torch.from_numpy(rng.integers(S // 3, S, B))
    pos[0] = min(20, S - 1)   # later spans of row 0 hold no valid slot
    valid = torch.arange(S)[None] <= pos[:, None]
    if holes:   # a whole span in the middle of every row invalid
        valid[:, 64:128] = False
    return q, kc, vc, valid


DECODE_CASES = [(2, 2, 4, 300, True), (2, 2, 1, 512, False),
                (1, 2, 2, 96, True)]


@pytest.mark.parametrize("mode", ["floor", "bump", "adaptive"])
@pytest.mark.parametrize("B,H,G,S,holes", DECODE_CASES)
def test_cluster_combine_passes_attn_check_against_both_oracles(
        B, H, G, S, holes, mode):
    q, kc, vc, valid = _decode_case(B, H, G, S, S + G, holes)
    fmt = core.get_format("e4m3")
    got = CS.split_decode(q, kc, vc, valid, fmt, scale_mode=mode)
    floor = CS.attn_floor(vc, S)
    want_t = ref.mx_attention_decode_ref(q, kc, vc, valid, fmt,
                                         scale_mode=mode)
    f = lambda x: jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    want_j = jref.mx_attention_decode_ref(
        f(q), f(ref.fold_cache(kc)), f(ref.fold_cache(vc)),
        jnp.asarray(torch.repeat_interleave(valid, H, dim=0).numpy()),
        jcore.get_format("e4m3"), scale_mode=mode)
    want_j = torch.from_numpy(np.array(want_j.astype(jnp.float32)))
    for want in (want_t, want_j):
        ok, worst = CS.attn_check(got, want, floor)
        assert ok, worst


def test_cluster_combine_bf16_mode_and_batch_independence():
    """bf16 mode passes too; a row's result is bitwise the same computed
    alone or beside other rows (the plan depends on S alone)."""
    q, kc, vc, valid = _decode_case(3, 2, 2, 300, 1, True)
    got = CS.split_decode(q, kc, vc, valid, None)
    ok, worst = CS.attn_check(
        got, ref.mx_attention_decode_ref(q, kc, vc, valid, None),
        CS.attn_floor(vc, 300))
    assert ok, worst
    fmt = core.get_format("e4m3")
    full = CS.split_decode(q, kc, vc, valid, fmt)
    one = CS.split_decode(q[2:4], kc[1:2], vc[1:2], valid[1:2], fmt)
    assert torch.equal(full[2:4], one)


@pytest.mark.parametrize("fault", CS.SPLIT_FAULTS)
def test_card_decode_check_rejects_split_faults(fault):
    q, kc, vc, valid = _decode_case(2, 2, 4, 512, 4, False)
    fmt = core.get_format("e4m3")
    want = ref.mx_attention_decode_ref(q, kc, vc, valid, fmt)
    ok, _ = CS.attn_check(CS.split_decode(q, kc, vc, valid, fmt, fault),
                          want, CS.attn_floor(vc, 512))
    assert not ok


# --- the cast of a 32-block held eight elements a lane ---------------------

def test_quad_lane_sum_is_the_warp_butterfly():
    """mx_quad_sum (lane j of four holds elements 8j..8j+7: lane exchanges
    xor 2 and xor 1, then s[i] += s[i + o] for o = 4, 2, 1 in the lane)
    ends with the value of mx_warp_sum's xor butterfly, in fp32."""
    rng = np.random.default_rng(1)
    for _ in range(300):
        v = (rng.standard_normal(32) * 10.0 ** rng.integers(-6, 6, 32)
             ).astype(np.float32)
        lanes = v.copy()
        o = 16
        while o:
            lanes = (lanes + lanes[np.arange(32) ^ o]).astype(np.float32)
            o //= 2
        quad = v.reshape(4, 8).copy()
        for o in (2, 1):
            quad = (quad + quad[np.arange(4) ^ o]).astype(np.float32)
        for o in (4, 2, 1):
            quad[:, :o] = (quad[:, :o] + quad[:, o:2 * o]).astype(np.float32)
        assert np.all(quad[:, 0] == lanes[0])


# --- on the card -----------------------------------------------------------

@pytest.mark.gpu
def test_new_kernels_match_plain_versions_at_their_edges_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode "
                    "(run chip_smoke.py on the card)")
    fmt = core.get_format("e4m3")
    for kind in sorted(SPECS):
        args, tf, spec, _ = _dgrad_case(kind, "e4m3")
        cargs = tuple(a.cuda().bfloat16() if i < 5 else a.cuda()
                      for i, a in enumerate(args))
        got = ops.mx_flash_attention_bwd(*cargs, tf, spec,
                                         out_dtype=torch.float32)
        want = ref.mx_flash_attention_bwd_ref(*cargs, tf, spec,
                                              out_dtype=torch.float32)
        _, bounds = CS.flash_bwd_dense(*cargs, tf, spec=spec)
        assert CS.flash_bwd_check(got, want, bounds)[0]
    for B, H, G, S, holes in DECODE_CASES:
        q, kc, vc, valid = (t.cuda() for t in _decode_case(B, H, G, S, 2,
                                                            holes))
        got = ops.mx_attention_decode(q, kc, vc, valid, fmt)
        want = ref.mx_attention_decode_ref(q, kc, vc, valid, fmt)
        assert CS.attn_check(got, want, CS.attn_floor(vc, S))[0]
        assert torch.equal(got, ops.mx_attention_decode(q, kc, vc, valid,
                                                        fmt))
