"""The port's ServeEngine and scheduler, against the JAX engine on the CPU.

Greedy tokens of the two engines must agree until the first step where
the reference's own top-1/top-2 margin is within twice the logit
tolerance of tests/test_torch_models.py (there the two are allowed to
differ, and their continuations then legitimately diverge).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_config as jget_config
from repro.models import lm_init as jlm_init
from repro.models import lm_prefill as jprefill
from repro.serve import SamplingParams as JSamplingParams
from repro.serve import ServeEngine as JServeEngine
from repro_torch import core
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import lm_decode_step, lm_prefill
from repro_torch.serve import (SamplingParams, ServeEngine, sample_tokens,
                               serving_params)

LOGIT_ATOL = {"mxfp8_e4m3": 0.5}
PROMPT_LENS = (5, 17, 30)


@pytest.fixture(scope="module")
def smoke():
    jcfg = jget_config("olmo-paper", "smoke")
    cfg = get_config("olmo-paper", "smoke")
    jparams = jlm_init(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32)
               for n in PROMPT_LENS]
    return jcfg, cfg, jparams, params, prompts


def _port_engine(smoke, prec="mxfp8_e4m3", **kw):
    _, cfg, _, params, _ = smoke
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", 64)
    return ServeEngine(params, cfg, core.preset(prec), device="cpu", **kw)


def test_engine_matches_jax_engine_under_margin_rule(smoke):
    jcfg, cfg, jparams, params, prompts = smoke
    prec = "mxfp8_e4m3"
    jeng = JServeEngine(jparams, jcfg, jcore.preset(prec), max_batch=2,
                        max_len=64)
    teng = _port_engine(smoke, prec)
    for p in prompts:
        jeng.submit(p, JSamplingParams(max_new_tokens=6))
        teng.submit(p, SamplingParams(max_new_tokens=6))
    jdone, tdone = jeng.drain(), teng.drain()
    assert [r.finish_reason for r in tdone] == ["length"] * 3
    for p, jr, tr in zip(prompts, jdone, tdone):
        assert len(tr.tokens) == len(jr.tokens) == 6
        diff = [i for i, (a, b) in enumerate(zip(jr.tokens, tr.tokens))
                if a != b]
        if not diff:
            continue
        i = diff[0]
        ctx = np.concatenate([p, np.asarray(jr.tokens[:i], np.int32)])
        logits, _ = jprefill(jparams, jnp.asarray(ctx)[None], jcfg,
                             jcore.preset(prec), max_len=64)
        top2 = np.sort(np.asarray(logits, np.float32)[0])[-2:]
        assert top2[1] - top2[0] <= 2 * LOGIT_ATOL[prec], (p.size, i)


def test_results_do_not_depend_on_admission_order(smoke):
    prompts = smoke[-1]
    sps = [SamplingParams(max_new_tokens=5),
           SamplingParams(temperature=0.9, top_k=8, max_new_tokens=5, seed=3),
           SamplingParams(temperature=1.3, max_new_tokens=4, seed=9)]
    runs = []
    for order, max_batch in (((0, 1, 2), 2), ((2, 0, 1), 3), ((1, 2, 0), 1)):
        eng = _port_engine(smoke, "e4m3_bf16act", max_batch=max_batch)
        rid = {eng.submit(prompts[i], sps[i]): i for i in order}
        runs.append({rid[r.rid]: r.tokens for r in eng.drain()})
    assert runs[0] == runs[1] == runs[2]


def test_prefill_bucketing_does_not_change_greedy_tokens(smoke):
    """The engine prefills bucketed prompts; the same requests prefilled at
    their exact lengths and decoded greedily give the same tokens, and the
    bucketed prefill's logits and real cache rows equal the exact ones."""
    _, cfg, _, params, prompts = smoke
    qcfg = core.preset("bf16")
    eng = _port_engine(smoke, "bf16")
    for p in prompts:
        eng.submit(p, SamplingParams(max_new_tokens=4))
    got = [r.tokens for r in eng.drain()]
    pads = [e["padded_len"] for e in eng.events if e["event"] == "prefill"]
    assert pads == [16, 32, 32]
    sp = serving_params(params, "cpu")
    with torch.inference_mode():
        for p, tokens, Tp in zip(prompts, got, pads):
            T = p.size
            padded = np.zeros(Tp, np.int64)
            padded[:T] = p
            lg_pad, c_pad = lm_prefill(sp, torch.as_tensor(padded)[None], cfg,
                                       qcfg, 64, torch.tensor([T - 1]))
            lg, cache = lm_prefill(sp, torch.as_tensor(p, dtype=torch.long)[None],
                                   cfg, qcfg, 64)
            assert torch.equal(lg_pad, lg)
            for a, b in zip(c_pad, cache):
                assert torch.equal(a["k"][:, :T], b["k"][:, :T])
                assert torch.equal(a["v"][:, :T], b["v"][:, :T])
            want = [int(torch.argmax(lg[0]))]
            for i in range(len(tokens) - 1):
                lg, _ = lm_decode_step(sp, cache, torch.tensor([[want[-1]]]),
                                       torch.tensor([T + i]), cfg, qcfg)
                want.append(int(torch.argmax(lg[0])))
            assert tokens == want


def test_sample_tokens_top_k_keeps_exactly_k_under_ties():
    V, k = 12, 3
    logits = torch.zeros((1, V))
    logits[0, 7] = -1.0
    drawn = set()
    for n in range(200):
        tok = sample_tokens(logits, [5.0], [k], [1], [n])
        drawn.add(int(tok[0]))
    assert drawn == {0, 1, 2}    # ties rank toward the lower index


def test_greedy_takes_first_maximal_index():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [3.0, 3.0, 3.0, 3.0]])
    got = sample_tokens(logits, np.zeros(2), np.zeros(2, np.int32),
                        np.zeros(2, np.int32), np.zeros(2, np.int32),
                        any_sampled=False)
    assert got.tolist() == [1, 0]


def test_submit_rejects_prompts_that_cannot_decode(smoke):
    eng = _port_engine(smoke, "bf16", max_len=16)
    with pytest.raises(ValueError, match="cannot fit"):
        eng.submit(np.ones(17, np.int32))
    with pytest.raises(ValueError, match="cannot fit"):
        eng.submit(np.ones(16, np.int32), SamplingParams(max_new_tokens=2))
    with pytest.raises(ValueError, match="empty"):
        eng.submit(np.zeros(0, np.int32))
    eng.submit(np.ones(16, np.int32), SamplingParams(max_new_tokens=1))
    (req,) = eng.drain()
    assert req.finish_reason == "length" and len(req.tokens) == 1


def test_eos_cache_full_events_and_stats(smoke):
    prompts = smoke[-1]
    eng = _port_engine(smoke, "bf16", max_len=33)
    eng.submit(prompts[2], SamplingParams(max_new_tokens=10))   # 30 tokens
    (req,) = eng.drain()
    assert req.finish_reason == "cache_full" and len(req.tokens) == 4
    eos = req.tokens[1]
    eng = _port_engine(smoke, "bf16", max_len=64, eos_id=eos)
    eng.submit(prompts[2], SamplingParams(max_new_tokens=10))
    (req,) = eng.drain()
    assert req.finish_reason == "eos" and req.tokens[-1] == eos
    kinds = [e["event"] for e in eng.events]
    assert kinds == ["submit", "prefill", "request_done"]
    st = eng.stats()
    assert st["n_finished"] == 1 and st["prefill_tokens"] == 30
    assert st["decode_tokens"] == len(req.tokens) - 1
    # A finished slot keeps no per-request state.
    s = eng.sched
    assert not (s.pos.any() or s.temp.any() or s.seeds.any() or s.n_gen.any())
