"""The port's paged serving path against the JAX package, on the CPU.

Inputs come from seeded numpy and are copied before they reach either
package.  Tolerances:
  * Gather, masks, page writes (at-rest quantization of sealed pages),
    page zeroing and prefix gathers: bitwise.
  * The paged plain decode against the JAX oracle: ``ATTN_ULPS`` fp32 ulps
    of the largest output (the bound tests/test_torch_kernels.py holds the
    slab decode to); against the port's slab plain decode on the gathered
    view: bitwise (the paging is only a gather).
  * Attention layers: relative Frobenius 0.02 on the outputs and 0.01 on
    the new K/V rows, as tests/test_torch_models.py (XLA:CPU and PyTorch
    sum the bf16 projections in other orders).  The whole LM: the logit
    tolerances of tests/test_torch_models.py, for the GeLU rounding
    difference described there.
  * Engines: the port's paged engine equals the port's slab engine token
    for token (same kernels on the same rows); against the JAX paged
    engine the scheduling (finish reasons, chunks, shared pages,
    preemptions) is equal and tokens follow the margin rule of
    tests/test_torch_serve.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_config as jget_config
from repro.kernels import ref as jref
from repro.models import attention as jattention
from repro.models import lm_init as jlm_init
from repro.models import lm_prefill as jprefill
from repro.models import lm_prefill_chunk as jprefill_chunk
from repro.serve import PageAllocator as JPageAllocator
from repro.serve import PagedServeEngine as JPagedServeEngine
from repro.serve import SamplingParams as JSamplingParams
from repro.serve import generate as jgenerate
from repro.serve import pages as jpages
from repro.serve import prefill_into_cache as jprefill_into_cache
from repro_torch import core
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.models import (attention, init_cache_paged, lm_prefill,
                                lm_prefill_chunk)
from repro_torch.runtime import Journal, tree_bytes
from repro_torch.serve import (PageAllocator, PagedServeEngine,
                               SamplingParams, ServeEngine, generate,
                               prefill_into_cache, prefix_chain,
                               serving_params)
from repro_torch.serve import pages

ATTN_ULPS = 16
LOGIT_ATOL = {"bf16": 0.0625, "mxfp8_e4m3": 0.5}
LOGIT_REL = {"bf16": 0.02, "mxfp8_e4m3": 0.15}
PAGE_TABLE = [[5, 2, -1, -1], [0, 7, 3, -1]]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.array(a, np.float32)).astype(dtype)


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-9))


def _fmt(name):
    return (None, None) if name is None else (jcore.get_format(name),
                                              core.get_format(name))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The engine tests run thousands of small ops at smoke size: one
    intra-op thread keeps them from spin-waiting on busy cores beside the
    other test workers (by 100x), and costs nothing alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smoke():
    jcfg = jget_config("olmo-paper", "smoke")
    cfg = get_config("olmo-paper", "smoke")
    jparams = jlm_init(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    return jcfg, cfg, jparams, params


# ---------------------------------------------------------------------------
# the plain paged decode against the JAX oracle
# ---------------------------------------------------------------------------
def _decode_case(seed=9):
    """The shapes of tests/test_paged.py's kernel test: B 2, H 2, G 2,
    d 32, ps 32, P 4, N 8, positions 40 and 70."""
    rng = np.random.default_rng(seed)
    B, H, G, d, ps, P, N = 2, 2, 2, 32, 32, 4, 8
    q = rng.standard_normal((B * H, G, d))
    kp = rng.standard_normal((N, ps, H, d))
    vp = rng.standard_normal((N, ps, H, d))
    pt = np.asarray(PAGE_TABLE, np.int32)
    pos = np.array([[40], [70]])
    valid = (np.arange(P * ps)[None] <= pos) & np.repeat(pt >= 0, ps, axis=1)
    return q, kp, vp, pt, valid


def test_gather_pages_is_bitwise_the_reference():
    _, kp, _, pt, _ = _decode_case()
    got = ref.gather_pages(_t(kp), torch.from_numpy(pt.copy()))
    want = jref.gather_pages(_j(kp), jnp.asarray(pt), kp.shape[2])
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("fmt", [None, "e4m3"], ids=["bf16", "e4m3"])
def test_paged_plain_matches_oracle_and_slab_plain(fmt):
    """Within ATTN_ULPS of the JAX oracle; bitwise the port's slab plain
    decode on the gathered view; the CPU wrapper is the plain version and
    counts no launch."""
    q, kp, vp, pt, valid = _decode_case()
    jf, tf = _fmt(fmt)
    args = (_t(q), _t(kp), _t(vp), torch.from_numpy(pt.copy()),
            torch.from_numpy(valid.copy()))
    got = ref.mx_attention_decode_paged_ref(*args, tf)
    want = jref.mx_attention_decode_paged_ref(
        _j(q), _j(kp), _j(vp), jnp.asarray(pt), jnp.asarray(valid), jf)
    g, w = _np(got), _np(want)
    scale = np.exp2(np.floor(np.log2(np.max(np.abs(w)))) - 23)
    assert np.max(np.abs(g - w)) <= ATTN_ULPS * scale
    H = kp.shape[2]
    slab = ref.mx_attention_decode_ref(
        args[0], ref.gather_pages(args[1], args[3]),
        ref.gather_pages(args[2], args[3]),
        torch.repeat_interleave(args[4], H, dim=0), tf)
    assert torch.equal(got, slab)
    ops.reset_launches()
    assert torch.equal(ops.mx_attention_decode_paged(*args, tf), got)
    assert ops.LAUNCHES["mx_attention_decode_paged"] == 0


def test_mx_contract_paged_kind_needs_mask_and_table():
    q, kp, vp, pt, valid = _decode_case()
    cfg = core.preset("mxfp8_e4m3")
    with pytest.raises(ValueError, match="page table"):
        core.mx_contract(_t(q), (_t(kp), _t(vp)), cfg,
                         kind="attn_decode_paged",
                         valid=torch.from_numpy(valid.copy()))
    got = core.mx_contract(_t(q), (_t(kp), _t(vp)), cfg,
                           kind="attn_decode_paged",
                           valid=torch.from_numpy(valid.copy()),
                           pages=torch.from_numpy(pt.copy()))
    want = ref.mx_attention_decode_paged_ref(
        _t(q), _t(kp), _t(vp), torch.from_numpy(pt.copy()),
        torch.from_numpy(valid.copy()), cfg.a_fwd)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_paged_decode_kernel_matches_plain_and_slab_kernel_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode "
                    "(run chip_smoke.py on the card)")
    q, kp, vp, pt, valid = _decode_case()
    H = kp.shape[2]
    args = (_t(q, torch.bfloat16).cuda(), _t(kp, torch.bfloat16).cuda(),
            _t(vp, torch.bfloat16).cuda(), torch.from_numpy(pt).cuda(),
            torch.from_numpy(valid).cuda())
    S = pt.shape[1] * kp.shape[1]
    floor = S * 2.0 ** -24 * args[2].float().abs().max()
    for f in (None, core.get_format("e4m3")):
        got = ops.mx_attention_decode_paged(*args, f)
        slab = ops.mx_attention_decode(
            args[0], ref.gather_pages(args[1], args[3]),
            ref.gather_pages(args[2], args[3]),
            torch.repeat_interleave(args[4], H, dim=0), f)
        assert torch.equal(got, slab)
        # the slab kernel's tolerance against its plain version: 2 bf16
        # ulps of each element plus the fp32 accumulation floor
        want = ref.mx_attention_decode_paged_ref(*args, f).float()
        ulp = torch.exp2(torch.floor(torch.log2(
            want.abs().clamp(min=2.0 ** -126))) - 7)
        assert bool(((got.float() - want).abs() <= 2 * ulp + floor).all())


# ---------------------------------------------------------------------------
# masks and page helpers against the reference (bitwise)
# ---------------------------------------------------------------------------
def test_paged_valid_mask_is_bitwise_the_reference():
    pt = np.asarray([[5, 2, -1, -1], [0, 7, 3, -1], [-1] * 4], np.int32)
    pos = np.array([40, 70, 0])
    got = attention.paged_valid_mask(torch.from_numpy(pt.copy()),
                                     torch.from_numpy(pos.copy()), 32)
    want = jattention.paged_valid_mask(jnp.asarray(pt), jnp.asarray(pos), 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _pools(rng, n_leaves=2, N=6, ps=32, H=2, d=64):
    return [rng.standard_normal((N, ps, H, d)) for _ in range(n_leaves)]


def _jpools(arrays):
    """The reference's pools carry a leading n_rep axis (here 1)."""
    return tuple(_j(a, jnp.bfloat16)[None] for a in arrays)


def _tpools(arrays):
    return [_t(a, torch.bfloat16) for a in arrays]


@pytest.mark.parametrize("fmt", [None, "e4m3"])
@pytest.mark.parametrize("n_sealed", [0, 1, 2])
def test_write_chunk_pages_is_bitwise_the_reference(fmt, n_sealed):
    """k quantized along the head dim on every page, v along the in-page
    axis only on the sealed pages, the sentinel page id dropped."""
    rng = np.random.default_rng(7 + n_sealed)
    base = _pools(rng)
    chunks = [rng.standard_normal((1, 96, 2, 64)) * 3 for _ in range(2)]
    ids = np.array([4, 1, 6], np.int32)      # 6 == N: dropped
    jf, tf = _fmt(fmt)
    want = jpages.write_chunk_pages(
        _jpools(base), tuple(_j(c, jnp.bfloat16)[None] for c in chunks),
        jnp.asarray(ids), np.int32(n_sealed), ("k", "v"), jf)
    got = _tpools(base)
    pages.write_chunk_pages(got, [_t(c, torch.bfloat16) for c in chunks],
                            ids.copy(), n_sealed, ("k", "v"), tf)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w[0]))


def test_zero_pages_and_gather_prior_are_bitwise_the_reference():
    rng = np.random.default_rng(8)
    base = _pools(rng)
    ids = np.array([3, 0, 6, 6], np.int32)   # 6 == N: dropped
    want = jpages.zero_pages(_jpools(base), jnp.asarray(ids))
    got = _tpools(base)
    pages.zero_pages(got, ids.copy())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w[0]))
    prior = np.array([5, 2, 4], np.int32)
    want = jpages.gather_prior(_jpools(base), jnp.asarray(prior))
    got = pages.gather_prior(_tpools(base), prior.copy())
    for g, w in zip(got, want):
        assert tuple(g.shape) == (1, 96, 2, 64)
        np.testing.assert_array_equal(_np(g), _np(w[0]))


# ---------------------------------------------------------------------------
# attention layers and the LM chunk against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("prec", ["bf16", "mxfp8_e4m3"])
def test_attention_decode_paged_matches_reference(smoke, prec):
    """Two live rows and a dead all -1 row: the outputs match the
    reference; the live rows' K/V land at (their tail page, pos % ps); the
    dead row writes nothing (page N-1 keeps its bits, where a negative
    index would have wrapped)."""
    jcfg, cfg, jparams, params = smoke
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["b0"]["attn"])
    rng = np.random.default_rng(10)
    N, ps, H, d = 8, 32, 2, 64
    base = _pools(rng, N=N)
    pt = np.asarray([[5, 2, -1, -1], [0, 7, 3, -1], [-1] * 4], np.int32)
    pos = np.array([40, 70, 0])
    x = rng.standard_normal((3, 1, 128))
    kw = dict(n_heads=2, n_kv=2, d_head=64)
    jo, jc = jattention.attention_decode_paged(
        jp, _j(x, jnp.bfloat16),
        {"k": _j(base[0], jnp.bfloat16), "v": _j(base[1], jnp.bfloat16)},
        qcfg=jcore.preset(prec), pos=jnp.asarray(pos),
        page_table=jnp.asarray(pt),
        spec=jcfg.decode_spec("attn", cache_len=4 * ps, page_size=ps), **kw)
    cache = {"k": _t(base[0], torch.bfloat16),
             "v": _t(base[1], torch.bfloat16)}
    tpos, tpt = torch.from_numpy(pos.copy()), torch.from_numpy(pt.copy())
    slots = attention.paged_write_slots(tpt, tpos, ps)
    # The rows the engine would name live give the same slots.
    for got, want in zip(attention.paged_write_slots(
            tpt, tpos, ps, live=torch.tensor([0, 1])), slots):
        assert torch.equal(got, want)
    to, cache = attention.attention_decode_paged(
        params["layers"][0]["attn"], _t(x, torch.bfloat16), cache,
        qcfg=core.preset(prec), pos=tpos, page_table=tpt, slots=slots,
        valid=attention.paged_valid_mask(tpt, tpos, ps), **kw)
    assert _rel(to, jo) < 0.02
    for key, arr in zip(("k", "v"), base):
        before = _np(_t(arr, torch.bfloat16))
        got, want = _np(cache[key]), _np(jc[key])
        written = np.zeros(got.shape[:2], bool)
        written[[2, 3], [40 % ps, 70 % ps]] = True
        np.testing.assert_array_equal(got[~written], before[~written])
        np.testing.assert_array_equal(want[~written], before[~written])
        assert _rel(got[written], want[written]) < 0.01
        np.testing.assert_array_equal(got[N - 1], before[N - 1])


@pytest.mark.parametrize("prec", ["bf16", "mxfp8_e4m3"])
def test_attention_prefill_chunk_matches_reference(smoke, prec):
    """A 64-position chunk at offset 32 with 20 real positions: the padded
    tail K/V are zeros on both sides; outputs and K/V within the layer
    tolerances."""
    jcfg, cfg, jparams, params = smoke
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["b0"]["attn"])
    rng = np.random.default_rng(11)
    start, C, real = 32, 64, 20
    x = rng.standard_normal((1, C, 128))
    prior = [rng.standard_normal((1, start, 2, 64)) for _ in range(2)]
    mask = (np.arange(C) < real)[None]
    positions = np.arange(start, start + C)[None]
    kw = dict(n_heads=2, n_kv=2, d_head=64)
    jo, jk, jv = jattention.attention_prefill_chunk(
        jp, _j(x, jnp.bfloat16), _j(prior[0], jnp.bfloat16),
        _j(prior[1], jnp.bfloat16), qcfg=jcore.preset(prec),
        positions=jnp.asarray(positions),
        spec=jcfg.attn_spec("attn").with_offset(start),
        kv_mask=jnp.asarray(mask), **kw)
    to, tk, tv = attention.attention_prefill_chunk(
        params["layers"][0]["attn"], _t(x, torch.bfloat16),
        _t(prior[0], torch.bfloat16), _t(prior[1], torch.bfloat16),
        qcfg=core.preset(prec), positions=torch.from_numpy(positions.copy()),
        spec=cfg.attn_spec().with_offset(start),
        kv_mask=torch.from_numpy(mask.copy()), **kw)
    assert _rel(to[:, :real], jo[:, :real]) < 0.02
    for got, want in ((tk, jk), (tv, jv)):
        assert not _np(got)[:, real:].any() and not _np(want)[:, real:].any()
        assert _rel(got, want) < 0.01


@pytest.mark.parametrize("prec", ["bf16", "mxfp8_e4m3"])
def test_lm_prefill_chunk_matches_reference_and_whole_prefill(smoke, prec):
    """Chunks of 32 over a 45-token prompt (the last one padded): the
    final chunk's logits match the reference's chunked prefill within the
    LM logit tolerance and the port's whole prefill bitwise (same rows at
    smoke size on the CPU)."""
    jcfg, cfg, jparams, params = smoke
    jq, tq = jcore.preset(prec), core.preset(prec)
    prompt = np.random.default_rng(12).integers(1, cfg.vocab, 45)
    C, T = 32, 45
    jprior = [{"b0": {"k": jnp.zeros((2, 1, 0, 2, 64), jnp.bfloat16),
                      "v": jnp.zeros((2, 1, 0, 2, 64), jnp.bfloat16)}}]
    tprior = [{"k": torch.zeros((1, 0, 2, 64), dtype=torch.bfloat16),
               "v": torch.zeros((1, 0, 2, 64), dtype=torch.bfloat16)}
              for _ in range(2)]
    for start in (0, C):
        real = min(T - start, C)
        toks = np.zeros((1, C), np.int32)
        toks[0, :real] = prompt[start:start + real]
        mask = (np.arange(C) < real)[None]
        jl, jchunk = jprefill_chunk(jparams, jnp.asarray(toks), jprior, start,
                                    jcfg, jq, jnp.asarray([real - 1]),
                                    jnp.asarray(mask))
        tl, tchunk = lm_prefill_chunk(
            params, torch.from_numpy(toks.copy()).long(), tprior, start, cfg,
            tq, torch.tensor([real - 1]), torch.from_numpy(mask.copy()))
        jprior = [{"b0": {n: jnp.concatenate([jprior[0]["b0"][n],
                                              jchunk[0]["b0"][n]], axis=2)
                          for n in ("k", "v")}}]
        tprior = [{n: torch.cat([p[n], c[n]], dim=1) for n in ("k", "v")}
                  for p, c in zip(tprior, tchunk)]
    assert np.max(np.abs(_np(tl) - _np(jl))) <= LOGIT_ATOL[prec]
    assert _rel(tl, jl) <= LOGIT_REL[prec]
    whole, cache = lm_prefill(params, torch.from_numpy(prompt[None]).long(),
                              cfg, tq, 64)
    assert torch.equal(tl, whole)
    for lc, tp in zip(cache, tprior):
        assert torch.equal(lc["k"][:, :T], tp["k"][:, :T])


def test_paged_cache_layout(smoke):
    _, cfg, _, _ = smoke
    cache = init_cache_paged(cfg, 10, 32, device="cpu")
    assert len(cache) == cfg.n_layers
    assert tuple(cache[0]["k"].shape) == (10, 32, 2, 64)
    assert cache[0]["v"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# PageAllocator and prefix_chain (copies of tests/test_paged.py's)
# ---------------------------------------------------------------------------
def test_prefix_chain_is_positional_and_content_keyed():
    ps = 32
    rng = np.random.RandomState(0)
    a = rng.randint(1, 1000, size=70).astype(np.int32)
    assert len(prefix_chain(a, ps)) == 2
    b = a.copy()
    b[40] += 1
    ca, cb = prefix_chain(a, ps), prefix_chain(b, ps)
    assert ca[0] == cb[0] and ca[1] != cb[1]
    c = np.concatenate([[7], a[:63]]).astype(np.int32)
    assert prefix_chain(c, ps)[0] != ca[0]
    assert ca == jpages.prefix_chain(a.copy(), ps)


def test_allocator_eviction_never_touches_live_pages():
    al = PageAllocator(n_pages=4, page_size=32)
    chain = prefix_chain(np.arange(128, dtype=np.int32), 32)
    pages_ = al.alloc(4)
    al.register(chain, pages_)
    shared = al.share(chain, 2)
    assert shared == pages_[:2] and al.prefix_hits == 2
    al.release(pages_)
    assert al.n_free == 0
    assert al.available() == 2
    got = al.alloc(2)
    assert got is not None and set(got).isdisjoint(shared)
    assert al.evictions >= 2
    assert all(al.ref[p] == 1 for p in shared)
    assert al.alloc(1) is None
    al.release(shared)
    al.release(got)
    al.check()


def test_allocator_cascade_eviction_keeps_chains_rooted():
    al = PageAllocator(n_pages=3, page_size=32)
    chain = prefix_chain(np.arange(96, dtype=np.int32), 32)
    pages_ = al.alloc(3)
    al.register(chain, pages_)
    al.release(pages_)
    assert al.alloc(1) is not None
    for h, p in al.prefix.items():
        par = al.parent.get(h)
        assert par is None or par in al.prefix
    al.check()


def test_allocator_rejects_misaligned_page_size():
    with pytest.raises(ValueError):
        PageAllocator(n_pages=4, page_size=48)
    with pytest.raises(ValueError):
        PagedServeEngine(None, None, None, max_len=100, page_size=32)


def test_allocator_double_free_asserts():
    al = PageAllocator(n_pages=2, page_size=32)
    (p,) = al.alloc(1)
    al.release([p])
    with pytest.raises(AssertionError):
        al.release([p])


def test_allocator_script_gives_the_reference_page_ids():
    """alloc / register / share / release / evict through both
    allocators: the same page ids, counters and free lists at each step."""
    ps = 32
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 500, size=n).astype(np.int32)
               for n in (100, 70, 40)]
    prompts.append(np.concatenate([prompts[0][:64], prompts[2][:20]]))
    got = []
    for al in (PageAllocator(8, ps), JPageAllocator(8, ps)):
        log = []
        held = []
        for p in prompts:
            chain = prefix_chain(p, ps)
            shared = al.share(chain, (p.size - 1) // ps)
            fresh = al.alloc(p.size // ps + 1 - len(shared))
            if fresh is None:
                al.release(shared)
                al.release(held.pop(0))
                shared = al.share(chain, (p.size - 1) // ps)
                fresh = al.alloc(p.size // ps + 1 - len(shared))
            pages_ = shared + fresh
            al.register(chain, pages_[:p.size // ps])
            held.append(pages_)
            log.append((pages_, al.prefix_hits, al.evictions,
                        sorted(al.free)))
        for h in held:
            al.release(h)
        log.append((al.alloc(8), al.evictions))
        al.check()
        got.append(log)
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------
def _submit_all(eng, prompts, max_new=8, sample_every=0, jax_side=False):
    SP = JSamplingParams if jax_side else SamplingParams
    for i, p in enumerate(prompts):
        sampled = sample_every and (i % sample_every == sample_every - 1)
        eng.submit(p.copy(), SP(temperature=0.8 if sampled else 0.0,
                                top_k=20 if sampled else 0,
                                max_new_tokens=max_new, seed=300 + i))


def _results(eng):
    return {r.rid: (tuple(r.tokens), r.finish_reason) for r in eng.drain()}


def _paged(smoke, prec, **kw):
    _, cfg, _, params = smoke
    kw.setdefault("max_batch", 3)
    kw.setdefault("max_len", 128)
    kw.setdefault("n_pages", 16)
    return PagedServeEngine(params, cfg, core.preset(prec), page_size=32,
                            device="cpu", **kw)


def _slab(smoke, prec, max_batch=3):
    _, cfg, _, params = smoke
    return ServeEngine(params, cfg, core.preset(prec), max_batch=max_batch,
                       max_len=128, bucket_prompts=False, device="cpu")


@pytest.mark.parametrize("prec", ["bf16", "mxfp8_e4m3"])
def test_paged_engine_equals_slab_engine(smoke, prec):
    """Prompts of tests/test_paged.py (5, 40, 70, 33; every fourth row
    sampled), max_batch 3, 16 pages: the same tokens and finish reasons as
    the slab engine without bucketing, and an empty, consistent pool."""
    rng = np.random.RandomState(11)
    prompts = [rng.randint(1, smoke[1].vocab, size=n) for n in (5, 40, 70, 33)]
    slab, paged = _slab(smoke, prec), _paged(smoke, prec)
    _submit_all(slab, prompts, sample_every=4)
    _submit_all(paged, prompts, sample_every=4)
    assert _results(paged) == _results(slab)
    paged.alloc.check()
    assert paged.alloc.pages_in_use == 0


def test_paged_engine_across_batch_widths_and_page_boundaries(smoke):
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, smoke[1].vocab, size=n)
               for n in (31, 32, 33, 64, 96, 7)]
    slab = _slab(smoke, "mxfp8_e4m3", max_batch=2)
    _submit_all(slab, prompts, max_new=6)
    want = _results(slab)
    for max_batch in (2, 4):
        eng = _paged(smoke, "mxfp8_e4m3", max_batch=max_batch, n_pages=24)
        _submit_all(eng, prompts, max_new=6)
        assert _results(eng) == want
        eng.alloc.check()


def test_prefix_sharing_shares_pages_without_changing_outputs(smoke):
    rng = np.random.RandomState(21)
    vocab = smoke[1].vocab
    prefix = rng.randint(1, vocab, size=64)
    prompts = [np.concatenate([prefix, rng.randint(1, vocab, size=n)])
               for n in (9, 17, 5, 26)]
    slab = _slab(smoke, "mxfp8_e4m3", max_batch=2)
    paged = _paged(smoke, "mxfp8_e4m3", max_batch=2, n_pages=20)
    ref_, out = {}, {}
    for wave in (prompts[:2], prompts[2:]):
        _submit_all(slab, wave, max_new=6)
        ref_.update(_results(slab))
        _submit_all(paged, wave, max_new=6)
        out.update(_results(paged))
    assert out == ref_
    assert paged.alloc.prefix_hits >= 2
    assert max(e["shared_pages"] for e in paged.events.of_kind("prefill")) \
        >= 2
    paged.alloc.check()


def test_preemption_replays_deterministically(smoke):
    rng = np.random.RandomState(31)
    prompts = [rng.randint(1, smoke[1].vocab, size=40) for _ in range(3)]
    slab = _slab(smoke, "mxfp8_e4m3")
    paged = _paged(smoke, "mxfp8_e4m3", n_pages=6)
    _submit_all(slab, prompts, max_new=40)
    _submit_all(paged, prompts, max_new=40)
    assert _results(paged) == _results(slab)
    assert paged.stats()["preemptions"] >= 1
    assert paged.events.of_kind("preempt")
    assert all(r.finish_reason == "length" for r in paged.finished.values())
    assert paged.alloc.n_free + paged.alloc.n_evictable == 6
    paged.alloc.check()


def test_oversize_request_fails_fast(smoke):
    eng = _paged(smoke, "bf16", max_batch=2, n_pages=2)
    eng.submit(np.arange(1, 101, dtype=np.int32),
               SamplingParams(max_new_tokens=8))
    (r,) = eng.drain()
    assert r.finish_reason == "cache_full" and r.tokens == []
    assert not eng.events.of_kind("prefill")
    eng.alloc.check()


def test_lone_request_exhausts_pool_at_page_capacity(smoke):
    """T = 40 into 2 pages = 64 positions: 64 - 40 + 1 tokens, then
    cache_full."""
    eng = _paged(smoke, "bf16", max_batch=2, n_pages=2)
    eng.submit(np.arange(1, 41, dtype=np.int32),
               SamplingParams(max_new_tokens=40))
    (r,) = eng.drain()
    assert r.finish_reason == "cache_full"
    assert len(r.tokens) == 64 - 40 + 1
    assert eng.alloc.n_free + eng.alloc.n_evictable == 2
    eng.alloc.check()


def test_paged_engine_schedules_as_the_reference_engine(smoke):
    """One trace with a shared 32-token prefix and a pool small enough to
    preempt, through the port's and the JAX paged engines under
    mxfp8_e4m3: the same finish reasons, prefill chunks, shared pages and
    preemptions, tokens under the margin rule, and the same ledger split
    of the page pool."""
    jcfg, cfg, jparams, params = smoke
    prec = "mxfp8_e4m3"
    rng = np.random.RandomState(41)
    prefix = rng.randint(1, cfg.vocab, size=32)
    prompts = [np.concatenate([prefix, rng.randint(1, cfg.vocab, size=n)])
               for n in (9, 40)] + [rng.randint(1, cfg.vocab, size=n)
                                    for n in (70, 5)]
    kw = dict(max_batch=3, max_len=128, n_pages=5, page_size=32)
    jeng = JPagedServeEngine(jparams, jcfg, jcore.preset(prec), **kw)
    teng = PagedServeEngine(params, cfg, core.preset(prec), device="cpu",
                            **kw)
    _submit_all(jeng, prompts, max_new=32, jax_side=True)
    _submit_all(teng, prompts, max_new=32)
    jdone, tdone = jeng.drain(), teng.drain()

    def sched(eng):
        return ([(e["rid"], e["chunks"], e["shared_pages"])
                 for e in eng.events if e["event"] == "prefill"],
                [(e["rid"], e["slot"]) for e in eng.events
                 if e["event"] == "preempt"])
    assert [r.finish_reason for r in tdone] == [r.finish_reason
                                                 for r in jdone]
    assert sched(teng) == sched(jeng)
    assert teng.stats()["preemptions"] >= 1
    assert teng.alloc.prefix_hits == jeng.alloc.prefix_hits >= 1
    for p, jr, tr in zip(prompts, jdone, tdone):
        diff = [i for i, (a, b) in enumerate(zip(jr.tokens, tr.tokens))
                if a != b]
        if diff:
            ctx = np.concatenate([p, np.asarray(jr.tokens[:diff[0]])])
            logits, _ = jprefill(jparams, jnp.asarray(ctx, jnp.int32)[None],
                                 jcfg, jcore.preset(prec), max_len=128)
            top2 = np.sort(np.asarray(logits, np.float32)[0])[-2:]
            assert top2[1] - top2[0] <= 2 * LOGIT_ATOL[prec]
    tl, jl = teng.ledger.report(), jeng.ledger.report()
    assert set(tl) == set(jl) == {"params", "page_pool", "slab_fallback",
                                  "total"}
    assert tl["page_pool"] == jl["page_pool"]
    assert tl["slab_fallback"] == jl["slab_fallback"] == 0


def test_generate_and_prefill_into_cache(smoke):
    """The token-stepped oracle's logits match the port's fused prefill
    (bf16, bitwise at smoke size on the CPU) and the reference's oracle
    within the bf16 logit tolerance; generate returns the engine's greedy
    tokens, row i seeded seed + i, as the reference's wrapper does."""
    jcfg, cfg, jparams, params = smoke
    rng = np.random.default_rng(13)
    prompt = rng.integers(1, cfg.vocab, (2, 12)).astype(np.int32)
    sp = serving_params(params, "cpu")
    q = core.preset("bf16")
    tl, tcache = prefill_into_cache(sp, torch.from_numpy(prompt.copy()).long(),
                                    cfg, q, 32)
    fl, fcache = lm_prefill(sp, torch.from_numpy(prompt.copy()).long(), cfg,
                            q, 32)
    assert torch.equal(tl, fl)
    assert torch.equal(tcache[0]["k"][:, :12], fcache[0]["k"][:, :12])
    jl, _ = jprefill_into_cache(jparams, jnp.asarray(prompt), jcfg,
                                jcore.preset("bf16"), 32)
    assert np.max(np.abs(_np(tl) - _np(jl))) <= LOGIT_ATOL["bf16"]
    toks = generate(params, prompt.copy(), cfg, q, max_new_tokens=5,
                    device="cpu")
    assert toks.shape == (2, 5) and toks.dtype == torch.int32
    eng = ServeEngine(params, cfg, q, max_batch=2, max_len=17, device="cpu")
    for row in prompt:
        eng.submit(row.copy(), SamplingParams(max_new_tokens=5))
    assert toks.tolist() == [r.tokens for r in eng.drain()]
    jtoks = np.asarray(jgenerate(jparams, jnp.asarray(prompt), jcfg,
                                 jcore.preset("bf16"), max_new_tokens=5))
    assert jtoks.shape == tuple(toks.shape)


# ---------------------------------------------------------------------------
# the slab engine's repairs: hooks, bucketing switch, journal, ledger
# ---------------------------------------------------------------------------
def test_step_calls_pre_decode_and_post_finish_hooks(smoke):
    _, cfg, _, params = smoke
    calls = []

    class Hooked(ServeEngine):
        def _pre_decode(self):
            calls.append(("pre", self.sched.n_active))
            return []

        def _post_finish(self, finished):
            calls.append(("post", [r.rid for r in finished]))

    eng = Hooked(params, cfg, core.preset("bf16"), max_batch=2, max_len=32,
                 device="cpu")
    eng.submit(np.arange(1, 6, dtype=np.int32),
               SamplingParams(max_new_tokens=3))
    eng.drain()
    assert calls == [("pre", 1), ("post", []), ("pre", 1), ("post", [0])]


def test_bucket_prompts_false_prefills_exact_lengths(smoke):
    """Without bucketing every prompt prefills at its own length, and the
    greedy tokens equal the bucketed engine's."""
    prompts = [np.random.default_rng(14).integers(1, 512, n).astype(np.int32)
               for n in (5, 17)]
    runs = {}
    for bucket in (True, False):
        _, cfg, _, params = smoke
        eng = ServeEngine(params, cfg, core.preset("bf16"), max_batch=2,
                          max_len=64, bucket_prompts=bucket, device="cpu")
        for p in prompts:
            eng.submit(p, SamplingParams(max_new_tokens=4))
        runs[bucket] = [r.tokens for r in eng.drain()]
        pads = [e["padded_len"] for e in eng.events.of_kind("prefill")]
        assert pads == ([16, 32] if bucket else [5, 17])
    assert runs[True] == runs[False]


def test_events_are_a_journal_and_the_ledger_splits_the_cache(smoke):
    _, cfg, _, params = smoke
    slab = ServeEngine(params, cfg, core.preset("bf16"), max_batch=2,
                       max_len=64, device="cpu")
    assert isinstance(slab.events, Journal)
    with pytest.raises(ValueError):
        slab.events.append({"rid": 0})
    rep = slab.ledger.report()
    assert set(rep) == {"params", "cache", "total"}
    assert rep["params"] == tree_bytes(slab.params)
    assert rep["cache"] == tree_bytes(slab.cache) == 2 * 2 * 64 * 2 * 64 * 2 \
        * cfg.n_layers
    paged = _paged(smoke, "bf16", n_pages=10)
    rep = paged.ledger.report()
    assert set(rep) == {"params", "page_pool", "slab_fallback", "total"}
    assert rep["page_pool"] == 2 * 10 * 32 * 2 * 64 * 2 * cfg.n_layers
    assert rep["slab_fallback"] == 0
