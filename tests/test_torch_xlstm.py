"""xlstm-1.3b on the port against the JAX reference, on the CPU at smoke
size: the mLSTM cell (step scan and chunkwise forms), the sLSTM cell, both
blocks, the LM, its decode state, the engines, the Trainer and the
weights.

The smoke config has 4 layers (mLSTM x 3 + sLSTM), d_model 64 and 2
heads: the mLSTM's head size is d_in / H = 64, the sLSTM's 32, its GeGLU
64 wide.  ``TC`` = 150 positions run the chunkwise form (two chunks of 64
and a ragged one of 22, padded), ``TS`` = 40 the step scan.  Weights are
the port's init moved with ``params_to_jax`` (the round-trip test holds
the tree's layout to the reference's init, at full size too); inputs
come from numpy seeds; the reference runs once, in module fixtures.
Tolerances, each beside the reading it rests on (this suite's CPU; the
limits leave about 2x).  The reference's functions are compiled without
XLA:CPU's excess precision (``_exact_jit``), so they give their op-by-op
numbers; with it, its jitted MX prefill logits move 0.86 from those.

  * The cells in fp32, same inputs (``CELL_ULPS``, in fp32 ulps of the
    output's largest magnitude): XLA's and PyTorch's exp, log1p, tanh
    and dot products are ulps apart.  Readings: one ``_mlstm_cell_step``
    h 3.0, its state 0; ``_mlstm_scan`` h 8.0; ``_mlstm_chunkwise`` h
    16.5, extreme gates (i x 40) 30.0; ``_slstm_step`` 1.0, 40 steps 2.5
    (the port's one-kernel logsigmoid and sigmoid).  The port's chunkwise
    against its own scan is held to the reference test's bounds
    (``tests/test_xlstm_chunkwise.py``: 2e-4, 5e-4 with extreme gates;
    the states compared as C e^(m_c - m_r)); its gradients against the
    scan's within ``FORM_GRAD_REL`` (reading 2.3e-6 relative Frobenius).
  * The conv is bitwise in both modes (bf16 ops, one rounding each).
  * One block, same inputs (``BLOCK_ULPS`` in bf16 ulps of the output's
    largest magnitude; ``STATE_REL`` relative Frobenius of the fp32
    state, absolute on ``m``).  Readings: the mLSTM's outputs 0.25 (bf16)
    and 0 (MX) after either prefill form and 8 decodes, its state 1.0e-7;
    the sLSTM's outputs 2.0 (bf16) and 3.5 (MX: its GeGLU's tanh GeLU
    rounds bf16 intermediates on XLA:CPU, ROADMAP Queue C), its state
    1.3e-7 (m 3.6e-7).  MX gradients (``BLOCK_GRAD_REL``, relative
    Frobenius per leaf and the input's): worst 0.014 (mLSTM w_up), 0.034
    (sLSTM w_gates).
  * The LM (``LOGIT_*``, ``LM_STATE_REL``, ``LOSS_REL``, ``GRAD_REL``).
    Under MX every layer's state after the chunkwise prefill and 8
    decodes is within 1e-7 (m 2.4e-7) and the logits 0.123 / rel 0.012
    (the GeGLU).  In bf16 the plain bf16 GEMMs sum in other orders, an
    ulp of the residual stream moves the gates' max-stabilizer, and the
    differences grow through the layers: logits 0.055 / rel 0.012, the
    last layer's state 0.011 (m 0.023).  Loss 2.8e-7 (bf16) and 4.1e-5
    (MX) relative; bf16 gradients per leaf worst 0.133 (layer 2's
    conv_b, a sum over positions; w_k 0.115).  MX gradients are held at
    the block.
  * Decode against prefill and the engines: the reference's own bounds
    (``tests/test_serve.py``); 3 Trainer steps: ``tests/test_torch_train
    .py``'s ``LOSS_ATOL`` and 1e-2 on the gradient norm.
  * Decode's drift from a teacher-forced whole forward over the chunkwise
    prefill's 150 tokens and 8 decode steps (``DRIFT_*``; bf16 the largest
    error over the reference's tolerance, MX the relative Frobenius
    error, worst of the 2 rows).  Step by step the reference reads bf16
    0, 0.69, 0.52, 0.47, 0.91, 0.45, 0.90, 0.74, 0.63 and the port 0,
    0.75, 0.81, 0.67, 0.91, 0.42, 0.87, 0.72, 0.69 (0.29 apart at most);
    MX 0, 0.094, 0.095, 0.093, 0.145, 0.122, 0.252, 0.264, 0.190 and the
    port within 0.0022 of each.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_config as jget_config
from repro.models import init_cache as jinit_cache
from repro.models import lm_decode_step as jdecode
from repro.models import lm_apply as jlm_apply
from repro.models import lm_init as jlm_init
from repro.models import lm_loss as jlm_loss
from repro.models import lm_prefill as jprefill
from repro.models import xlstm as jxlstm
from repro.models.layers import qdense as jqdense
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import checkpoint as jcheckpoint
from repro_torch import core
from repro_torch.configs import get_config
from repro_torch.convert import (_block_shapes, lm_checkpoint_layout,
                                 param_shapes, params_from_jax,
                                 params_to_jax)
from repro_torch.core.diagnostics import tree_leaves_with_path
from repro_torch.models import (block_plan, chunk_supported, init_cache,
                                init_cache_paged, kind_paged, lm_apply,
                                lm_decode_step, lm_init, lm_loss, lm_prefill,
                                paged_leaf_mask, tree_map, xlstm)
from repro_torch.models.layers import qdense
from repro_torch.serve import PagedServeEngine, SamplingParams, ServeEngine
from repro_torch.serve.decode import prefill_into_cache
from repro_torch.train import Trainer, TrainerConfig, save

ARCH = "xlstm-1.3b"
PRESETS = ("bf16", "mxfp8_e4m3")
TC, TS, S, N_DEC = 150, 40, 256, 8
# readings in the module docstring
CELL_ULPS = {"step": 6, "scan": 16, "chunkwise": 64, "slstm": 6}
FORM_GRAD_REL = 1e-5
BLOCK_ULPS = {"bf16": 4, "mxfp8_e4m3": 8}
STATE_REL = 1e-6
BLOCK_GRAD_REL = {"mxfp8_e4m3": 0.07}
LOGIT_ATOL = {"bf16": 0.11, "mxfp8_e4m3": 0.25}
LOGIT_REL = {"bf16": 0.025, "mxfp8_e4m3": 0.025}
LM_STATE_REL = {"bf16": 0.05, "mxfp8_e4m3": 1e-6}
LOSS_REL = {"bf16": 1e-6, "mxfp8_e4m3": 1e-4}
GRAD_REL = {"bf16": 0.25}
LOSS_ATOL = {"bf16": 2e-3, "mxfp8_e4m3": 1e-2}
# the reference's bounds (tests/test_serve.py): fused against stepped
# prefill (e4m3_bf16act) logits within 1e-1 and caches within 5e-2
# relative Frobenius; one decode step against a whole prefill: bf16
# within 1e-1, MX rel_fro < 0.2 and cosine > 0.98
STEP_TOL, STEP_CACHE_REL = 1e-1, 5e-2
DEC_TOL, DEC_REL, DEC_COS = 1e-1, 0.2, 0.98
# decode's drift from the whole forward (module docstring)
DRIFT_PREFILL = {"bf16": 0.05, "mxfp8_e4m3": 0.01}
DRIFT_ATOL = {"bf16": 0.6, "mxfp8_e4m3": 0.005}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Smoke-size ops: one intra-op thread keeps them from spin-waiting on
    cores busy with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _ulps(got, want, bits: int) -> float:
    """max |got - want| in ulps (``bits`` mantissa bits) of want's largest
    magnitude."""
    g, w = _np(got), _np(want)
    scale = np.exp2(np.floor(np.log2(np.max(np.abs(w)))) - bits)
    return float(np.max(np.abs(g - w)) / scale)


def _t(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.bfloat16):
    return jnp.asarray(np.array(a, np.float32)).astype(dtype)


def _exact_jit(fn):
    """``jax.jit(fn)`` compiled without XLA:CPU's excess precision: its
    results are then bitwise the op-by-op run's (with it, the smoke LM's
    jitted MX prefill logits are 0.86 from its op-by-op ones; the port's
    0.12).  One compile per argument shape."""
    compiled = {}

    def call(*args):
        key = str(jax.tree.map(lambda a: (a.shape, str(a.dtype)), args))
        if key not in compiled:
            compiled[key] = jax.jit(fn).lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False})
        return compiled[key](*args)
    return call


@pytest.fixture(scope="module")
def smoke():
    """(reference config, port config, the reference's tree as jax arrays,
    the same as numpy, the port's parameters, tokens (2, TC + N_DEC))."""
    jcfg, cfg = jget_config(ARCH, "smoke"), get_config(ARCH, "smoke")
    tree = jax.tree.map(lambda t: t.numpy(), params_to_jax(
        lm_init(cfg, torch.Generator().manual_seed(0), device="cpu"), cfg))
    toks = np.random.default_rng(3).integers(
        1, cfg.vocab, (2, TC + N_DEC)).astype(np.int32)
    return (jcfg, cfg, jax.tree.map(jnp.asarray, tree), tree,
            params_from_jax(tree, cfg, "cpu"), toks)


# ---------------------------------------------------------------------------
# config, cache and weights
# ---------------------------------------------------------------------------
def test_config_matches_reference_and_keeps_slab_state():
    for variant in ("full", "smoke"):
        assert (dataclasses.asdict(jget_config(ARCH, variant))
                == dataclasses.asdict(get_config(ARCH, variant)))
    full = get_config(ARCH, "full")
    assert block_plan(full) == [(("mlstm",) * 7 + ("slstm",), 6)]
    assert xlstm.mlstm_dims(full.d_model, full.n_heads) == (4096, 1024)
    assert xlstm.slstm_ff(full.d_model) == 2720
    cfg = get_config(ARCH, "smoke")
    assert not chunk_supported(cfg)
    assert [kind_paged(k, cfg) for k in ("mlstm", "slstm")] == [False, False]
    paged = init_cache_paged(cfg, 8, 32, device="cpu", B=2, S=S)
    assert all(not any(m.values()) for m in paged_leaf_mask(cfg))
    assert [{n: t.shape for n, t in c.items()} for c in paged] == [
        {n: t.shape for n, t in c.items()}
        for c in init_cache(cfg, 2, S, device="cpu")]
    with pytest.raises(ValueError, match="slab leaves"):
        init_cache_paged(cfg, 8, 32, device="cpu")


def test_init_cache_is_the_references_initial_state():
    """Leaf for leaf the reference's init_cache: shapes, dtypes and values,
    both stabilizers ``m`` at -1e30 (not zero)."""
    cfg, jcfg = get_config(ARCH, "smoke"), jget_config(ARCH, "smoke")
    cache = init_cache(cfg, 2, S, device="cpu")
    ref = jinit_cache(jcfg, 2, S)
    assert len(ref) == 1 and set(ref[0]) == {"b0", "b1", "b2", "b3"}
    for layer, c in enumerate(cache):
        want = jax.tree.map(lambda a: a[0], ref[0][f"b{layer}"])
        assert set(c) == set(want)
        for name, t in c.items():
            assert tuple(t.shape) == want[name].shape, (layer, name)
            assert str(t.dtype).split(".")[-1] == str(want[name].dtype)
            np.testing.assert_array_equal(_np(t), _np(want[name]))
    for layer in (0, 3):
        assert bool((cache[layer]["m"] == np.float32(-1e30)).all())
    assert cache[0]["C"].shape == (2, 2, 64, 64)
    assert cache[3]["h"].shape == (2, 2, 32)


def _stacked_layout(cfg):
    """{keystr: shape} of the reference's tree from the port's shapes: each
    block of a scan group stacked n_rep deep."""
    out = {}

    def walk(tree, prefix, lead):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + f"['{k}']", lead)
            else:
                out[prefix + f"['{k}']"] = lead + tuple(v)
    shapes = param_shapes(cfg)
    for k in ("embed", "final_ln", "lm_head"):
        walk(shapes[k], f"['{k}']", ())
    for g, (pattern, n_rep) in enumerate(block_plan(cfg)):
        for j, kind in enumerate(pattern):
            walk(_block_shapes(cfg, kind), f"['blocks'][{g}]['b{j}']",
                 (n_rep,))
    return out


@pytest.mark.parametrize("variant", ["smoke", "full"])
def test_param_layout_is_the_references(variant):
    """The port's shape tree, stacked by scan group, is the reference's
    init leaf for leaf (at full size: 8-block pattern x 6 groups)."""
    cfg, jcfg = get_config(ARCH, variant), jget_config(ARCH, variant)
    want = {jax.tree_util.keystr(p): tuple(a.shape)
            for p, a in jax.tree_util.tree_leaves_with_path(jax.eval_shape(
                lambda key: jlm_init(key, jcfg), jax.random.PRNGKey(0)))}
    assert _stacked_layout(cfg) == want
    assert set(param_shapes(cfg)) == {"embed", "layer", "mlstm_layer",
                                      "slstm_layer", "final_ln", "lm_head"}


def test_params_round_trip_through_tree_and_checkpoints(smoke, tmp_path):
    """params_from_jax leaf for leaf; a checkpoint npz written by the
    reference read by the port and one written by the port read by the
    reference, bitwise; a Trainer's {"params", "opt"} tree through the
    reference's layout."""
    jcfg, cfg, jparams, tree, params, _ = smoke
    assert set(params["layers"][0]) == {"ln", "cell"}
    assert set(params["layers"][3]["cell"]) == {
        "w_gates", "r_gates", "ffn_ln", "ffn", "out_ln", "w_out"}
    back = dict(tree_leaves_with_path(params_to_jax(params, cfg)))
    want = dict(tree_leaves_with_path(tree))
    assert set(back) == set(want)
    for path in want:
        np.testing.assert_array_equal(back[path].numpy(), want[path])
    np.testing.assert_array_equal(
        params["layers"][2]["cell"]["w_f"]["w"].numpy(),
        tree["blocks"][0]["b2"]["cell"]["w_f"]["w"][0])
    bf = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                      if a.ndim >= 3 else a, jparams)
    npz = dict(np.load(jcheckpoint.save(str(tmp_path / "ref"), 0, bf)))
    from_npz = params_from_jax(npz, cfg, device="cpu")
    np.testing.assert_array_equal(
        _np(from_npz["layers"][1]["cell"]["conv_w"]),
        _np(bf["blocks"][0]["b1"]["cell"]["conv_w"][0]))
    np.testing.assert_array_equal(
        _np(from_npz["layers"][3]["cell"]["r_gates"]),
        _np(bf["blocks"][0]["b3"]["cell"]["r_gates"][0]))
    # the port's writer, the reference's reader
    save(str(tmp_path / "port"), 4, params_to_jax(params, cfg), {"k": 1})
    jout, meta, step = jcheckpoint.restore(str(tmp_path / "port"), jparams)
    assert step == 4 and meta == {"k": 1}
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(jout),
                                 jax.tree_util.tree_leaves_with_path(
                                     jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(path))
    to_ref, from_ref = lm_checkpoint_layout(cfg, "cpu")
    opt = {"m": params, "v": params, "count": torch.zeros(())}
    again = from_ref(to_ref({"params": params, "opt": opt}))
    ffn = params["layers"][3]["cell"]["ffn"]
    assert torch.equal(
        again["opt"]["v"]["layers"][3]["cell"]["ffn"]["w_gate"]["w"],
        ffn["w_gate"]["w"])


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------
def _cell_inputs(T, seed, B=2, H=2, dh=16, scale=1.0):
    """tests/test_xlstm_chunkwise.py's inputs, drawn with numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, dh)).astype(np.float32)
    k = (rng.standard_normal((B, T, H, dh)) / np.sqrt(dh)).astype(np.float32)
    v = rng.standard_normal((B, T, H, dh)).astype(np.float32)
    it = (scale * rng.standard_normal((B, T, H))).astype(np.float32)
    ft = (3.0 + rng.standard_normal((B, T, H))).astype(np.float32)
    return q, k, v, it, ft


def _both(fn_ref, fn_port, arrays, **kw):
    ref = fn_ref(*map(jnp.asarray, arrays), **kw)
    with torch.no_grad():
        port = fn_port(*map(torch.from_numpy, arrays), **kw)
    return ref, port


def _state_close(got, want, rtol, atol):
    """States under one stabilizer convention: C, n and m."""
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=rtol, atol=atol)


def test_mlstm_cell_step_matches_reference():
    q, k, v, it, ft = (a[:, 0] for a in _cell_inputs(1, 5))
    rng = np.random.default_rng(6)
    C = rng.standard_normal((2, 2, 16, 16)).astype(np.float32)
    n = rng.standard_normal((2, 2, 16)).astype(np.float32)
    m = rng.standard_normal((2, 2)).astype(np.float32)
    for carry in ((C, n, m), (np.zeros_like(C), np.zeros_like(n),
                              np.full_like(m, -1e30))):
        (jc, jh) = jxlstm._mlstm_cell_step(
            tuple(map(jnp.asarray, carry)),
            tuple(map(jnp.asarray, (q, k, v, it, ft))))
        with torch.no_grad():
            tc, th = xlstm._mlstm_cell_step(
                tuple(map(torch.from_numpy, carry)),
                tuple(map(torch.from_numpy, (q, k, v, it, ft))))
        assert _ulps(th, jh, 23) <= CELL_ULPS["step"]
        for g, w in zip(tc, jc):
            assert _ulps(g, w, 23) <= CELL_ULPS["step"]


@pytest.mark.parametrize("T,chunk", [(128, 32), (96, 32), (100, 32),
                                     (64, 64)])
def test_mlstm_scan_and_chunkwise_match_reference(T, chunk):
    """Each form against the reference's own, and the port's chunkwise
    against its scan under the reference test's bounds."""
    arrays = _cell_inputs(T, T)
    (jh, js), (th, ts) = _both(jxlstm._mlstm_scan, xlstm._mlstm_scan, arrays)
    assert _ulps(th, jh, 23) <= CELL_ULPS["scan"]
    _state_close(ts, js, 1e-5, 1e-6)
    (jh2, js2), (th2, ts2) = _both(jxlstm._mlstm_chunkwise,
                                   xlstm._mlstm_chunkwise, arrays,
                                   chunk=chunk)
    assert _ulps(th2, jh2, 23) <= CELL_ULPS["chunkwise"]
    _state_close(ts2, js2, 1e-5, 1e-6)
    # the chunk-end stabilizer: the state is step T's, padded steps no-ops
    np.testing.assert_allclose(_np(th2), _np(th), rtol=2e-4, atol=2e-4)
    C_c, n_c, m_c = ts2
    C_r, n_r, m_r = ts
    np.testing.assert_allclose(_np(C_c * torch.exp(m_c - m_r)[..., None,
                                                              None]),
                               _np(C_r), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(_np(n_c * torch.exp(m_c - m_r)[..., None]),
                               _np(n_r), rtol=2e-4, atol=2e-4)


def test_mlstm_chunkwise_extreme_gates_match_reference():
    """Input-gate preactivations x 40 must not overflow (the stabilizer,
    the mask before exp)."""
    arrays = _cell_inputs(128, 1, scale=40.0)
    (jh, _), (th, _) = _both(jxlstm._mlstm_chunkwise,
                             xlstm._mlstm_chunkwise, arrays, chunk=32)
    assert bool(torch.isfinite(th).all())
    assert _ulps(th, jh, 23) <= CELL_ULPS["chunkwise"]
    with torch.no_grad():
        hs, _ = xlstm._mlstm_scan(*map(torch.from_numpy, arrays))
    np.testing.assert_allclose(_np(th), _np(hs), rtol=5e-4, atol=5e-4)


def test_mlstm_chunkwise_gradients_equal_the_scans():
    """Autograd through the chunkwise form (the mask's -inf branch
    included) against autograd through the step scan: every input's
    gradient of sum(h^2) and of the state."""
    grads = {}
    for form in ("scan", "chunkwise"):
        ins = [torch.from_numpy(a).requires_grad_(True)
               for a in _cell_inputs(100, 2)]
        kw = {"chunk": 32} if form == "chunkwise" else {}
        h, (C, n, m) = getattr(xlstm, f"_mlstm_{form}")(*ins, **kw)
        scale = torch.exp(m)[..., None]     # the state, stabilizer undone
        loss = (h ** 2).sum() + (C * scale[..., None] * 1e-3).sum() \
            + (n * scale).sum()
        grads[form] = torch.autograd.grad(loss, ins)
    for g, w in zip(grads["chunkwise"], grads["scan"]):
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
        assert _rel(_np(g), _np(w)) <= FORM_GRAD_REL


def test_slstm_step_and_scan_match_reference():
    H, dh, B, T = 2, 32, 2, TS
    rng = np.random.default_rng(11)
    p_r = (rng.standard_normal((H, dh, 4 * dh)) / np.sqrt(dh)).astype(
        np.float32)
    wx = rng.standard_normal((B, T, 4 * H * dh)).astype(np.float32)
    carry = tuple(rng.standard_normal((B, H, dh)).astype(np.float32)
                  for _ in range(4))
    jc, jh = jxlstm._slstm_step(jnp.asarray(p_r),
                                tuple(map(jnp.asarray, carry)),
                                jnp.asarray(wx[:, 0]), H)
    with torch.no_grad():
        tc, th = xlstm._slstm_step(torch.from_numpy(p_r),
                                   tuple(map(torch.from_numpy, carry)),
                                   torch.from_numpy(wx[:, 0]), H)
    assert _ulps(th, jh, 23) <= CELL_ULPS["slstm"]
    for g, w in zip(tc, jc):
        assert _ulps(g, w, 23) <= CELL_ULPS["slstm"]
    # T steps from the initial state, as _slstm_forward runs them
    c0 = tuple(map(torch.from_numpy, (
        np.zeros((B, H, dh), np.float32),) * 2 + (
        np.full((B, H, dh), -1e30, np.float32),
        np.zeros((B, H, dh), np.float32))))
    jcar, tcar = tuple(map(lambda t: jnp.asarray(t.numpy()), c0)), c0
    for t in range(T):
        jcar, jh = jxlstm._slstm_step(jnp.asarray(p_r), jcar,
                                      jnp.asarray(wx[:, t]), H)
        with torch.no_grad():
            tcar, th = xlstm._slstm_step(torch.from_numpy(p_r), tcar,
                                         torch.from_numpy(wx[:, t]), H)
    assert _ulps(th, jh, 23) <= CELL_ULPS["slstm"]


def test_conv1d_is_bitwise_the_references_in_both_modes():
    rng = np.random.default_rng(12)
    w = rng.standard_normal((4, 48)).astype(np.float32) * 0.5
    b = rng.standard_normal(48).astype(np.float32) * 0.1
    x = rng.standard_normal((2, 9, 48)).astype(np.float32)
    st = rng.standard_normal((2, 3, 48)).astype(np.float32)
    jy, _ = jxlstm._conv1d(_j(w), _j(b), _j(x))
    ty, _ = xlstm._conv1d(_t(w), _t(b), _t(x))
    np.testing.assert_array_equal(_np(ty), _np(jy))
    jy, js = jxlstm._conv1d(_j(w), _j(b), _j(x[:, :1]), _j(st))
    ty, ts = xlstm._conv1d(_t(w), _t(b), _t(x[:, :1]), _t(st))
    np.testing.assert_array_equal(_np(ty), _np(jy))
    np.testing.assert_array_equal(_np(ts), _np(js))


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------
# layer, and the prefill lengths: the mLSTM's chunkwise and step-scan
# forms; the sLSTM has one form
_BLOCKS = {"mlstm": (0, (TC, TS)), "slstm": (3, (TC,))}


@pytest.fixture(scope="module")
def block_runs(smoke):
    """Per block kind and preset, layer 0's mLSTM and layer 3's sLSTM
    cell in both packages on a (2, TC + N_DEC, D) input: prefill over TC
    (the mLSTM's chunkwise form) and, for the mLSTM, over TS (its step
    scan), each followed by N_DEC decode steps; and under MX jax.vjp /
    autograd of the block's apply over TC."""
    jcfg, cfg, _, tree, params, _ = smoke
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, TC + N_DEC, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((2, TC, cfg.d_model)).astype(np.float32)
    H = cfg.n_heads
    out = {}
    for kind, (layer, lengths) in _BLOCKS.items():
        jp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                          tree["blocks"][0][f"b{layer}"]["cell"])
        tp = params["layers"][layer]["cell"]
        jmod = {n: getattr(jxlstm, f"{kind}_{n}")
                for n in ("apply", "prefill", "decode")}
        tmod = {n: getattr(xlstm, f"{kind}_{n}")
                for n in ("apply", "prefill", "decode")}
        for prec in PRESETS:
            jq, tq = jcore.preset(prec), core.preset(prec)
            prefill = _exact_jit(lambda pp, x_: jmod["prefill"](pp, x_, jq, H))
            step = _exact_jit(lambda pp, x_, c: jmod["decode"](pp, x_, c, jq,
                                                               H))

            @_exact_jit
            def grads(pp, x_, ct_):
                _, vjp = jax.vjp(lambda a, b: jmod["apply"](a, b, jq, H),
                                 pp, x_)
                return vjp(ct_)
            ref, port = {}, {}
            for T0 in lengths:
                o, c = prefill(jp, _j(x[:, :T0]))
                outs = [o]
                for i in range(T0, T0 + N_DEC):
                    o, c = step(jp, _j(x[:, i:i + 1]), c)
                    outs.append(o)
                ref[T0] = (jnp.concatenate(outs, 1), c)
                with torch.no_grad():
                    o, c = tmod["prefill"](tp, _t(x[:, :T0]), tq, H)
                    pre = tree_map(torch.clone, c)
                    outs = [o]
                    for i in range(T0, T0 + N_DEC):
                        o, c = tmod["decode"](tp, _t(x[:, i:i + 1]), c, tq,
                                              H)
                        outs.append(o)
                port[T0] = (torch.cat(outs, 1), c, pre)
            if prec == "bf16":      # bf16 gradients are held at the LM
                out[kind, prec] = (ref, port)
                continue
            ref["grads"] = grads(jp, _j(x[:, :TC]), _j(ct))
            tpg = tree_map(lambda t: t.clone().requires_grad_(True), tp)
            tx = _t(x[:, :TC]).requires_grad_(True)
            leaves = list(tree_leaves_with_path(tpg))
            g = torch.autograd.grad(tmod["apply"](tpg, tx, tq, H),
                                    [t for _, t in leaves] + [tx], _t(ct))
            port["grads"] = (dict(zip([q for q, _ in leaves], g[:-1])), g[-1])
            out[kind, prec] = (ref, port)
    return out


@pytest.mark.parametrize("kind", list(_BLOCKS))
@pytest.mark.parametrize("prec", PRESETS)
def test_block_prefill_and_decode_match_reference(block_runs, kind, prec):
    """The block's outputs over the prompt and N_DEC decode steps after
    it, and the state it leaves, after a chunkwise (TC) and a step-scan
    (TS) prefill: each decode continues from the stabilizer its prefill
    form left."""
    ref, port = block_runs[kind, prec]
    for T0 in _BLOCKS[kind][1]:
        (jo, jc), (to, tc, _) = ref[T0], port[T0]
        assert to.shape == jo.shape
        assert _ulps(to, jo, 7) <= BLOCK_ULPS[prec], T0
        assert set(tc) == set(jc)
        for name, t in tc.items():
            if name == "conv":      # the pre-conv up projection, bf16
                assert _ulps(t, jc[name], 7) <= BLOCK_ULPS[prec]
            elif name == "m":       # the stabilizer: log-domain, absolute
                np.testing.assert_allclose(_np(t), _np(jc[name]), rtol=0,
                                           atol=STATE_REL)
            else:
                assert _rel(_np(t), _np(jc[name])) <= STATE_REL, (T0, name)


@pytest.mark.parametrize("kind", list(_BLOCKS))
@pytest.mark.parametrize("prec", ["mxfp8_e4m3"])
def test_block_grads_match_reference(block_runs, kind, prec):
    """jax.vjp of the block's apply (the mLSTM's chunkwise form at TC 150)
    against autograd under MX: every leaf and the input's gradient (bf16
    gradients are held at the LM)."""
    ref, port = block_runs[kind, prec]
    jgp, jgx = ref["grads"]
    tgp, tgx = port["grads"]
    want = {tuple(k.key for k in path): g
            for path, g in jax.tree_util.tree_leaves_with_path(jgp)}
    assert set(want) == set(tgp)
    for path, g in want.items():
        assert np.any(_np(tgp[path]) != 0), path
        assert _rel(_np(tgp[path]), np.asarray(g, np.float32)) <= \
            BLOCK_GRAD_REL[prec], path
    assert _rel(_np(tgx), _np(jgx)) <= BLOCK_GRAD_REL[prec]


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lm_runs(smoke):
    """Per preset, both packages: lm_prefill of TC tokens (the chunkwise
    form) plus N_DEC teacher-forced decode steps, and one decode step from
    a fresh cache."""
    jcfg, cfg, jparams, _, params, toks = smoke
    out = {}
    for prec in PRESETS:
        jq, tq = jcore.preset(prec), core.preset(prec)
        prefill = _exact_jit(lambda p, t: jprefill(p, t, jcfg, jq, S))
        decode = _exact_jit(lambda p, c, t, i: jdecode(p, c, t, i, jcfg, jq))
        res = {}
        for side in ("ref", "port"):
            if side == "ref":
                lg, cache = prefill(jparams, jnp.asarray(toks[:, :TC]))
                first, _ = decode(jparams, jinit_cache(jcfg, 2, S),
                                  jnp.asarray(toks[:, :1]),
                                  jnp.zeros(2, jnp.int32))
            else:
                with torch.no_grad():
                    lg, cache = lm_prefill(
                        params, torch.from_numpy(toks[:, :TC]).long(), cfg,
                        tq, S)
                    first, _ = lm_decode_step(
                        params, init_cache(cfg, 2, S, device="cpu"),
                        torch.from_numpy(toks[:, :1]).long(), 0, cfg, tq)
            logits = [_np(lg)]
            for i in range(TC, TC + N_DEC):
                pos = np.full(2, i, np.int32)
                if side == "ref":
                    lg, cache = decode(jparams, cache,
                                       jnp.asarray(toks[:, i:i + 1]),
                                       jnp.asarray(pos))
                else:
                    with torch.no_grad():
                        lg, cache = lm_decode_step(
                            params, cache,
                            torch.from_numpy(toks[:, i:i + 1]).long(),
                            torch.from_numpy(pos).long(), cfg, tq)
                logits.append(_np(lg))
            res[side] = (np.stack(logits), cache, _np(first))
        out[prec] = res
    return out


@pytest.mark.parametrize("prec", PRESETS)
def test_lm_prefill_and_decode_match_reference(lm_runs, prec):
    """Logits of the chunkwise prefill and of N_DEC decode steps, and
    every layer's state after them; the first decode step from a fresh
    cache."""
    jlog, jc, jfirst = lm_runs[prec]["ref"]
    tlog, tc, tfirst = lm_runs[prec]["port"]
    for got, want in ((tlog, jlog), (tfirst, jfirst)):
        assert np.max(np.abs(got - want)) <= LOGIT_ATOL[prec]
        assert _rel(got, want) <= LOGIT_REL[prec]
    for layer in range(4):
        want = jax.tree.map(lambda a: a[0], jc[0][f"b{layer}"])
        for name, t in tc[layer].items():
            assert t.shape == want[name].shape
            tol = LM_STATE_REL[prec]
            if name == "m":     # the stabilizer: log-domain, absolute
                np.testing.assert_allclose(_np(t), _np(want[name]), rtol=0,
                                           atol=tol)
            else:
                assert _rel(_np(t), _np(want[name])) <= tol, (layer, name)


@pytest.fixture(scope="module")
def loss_grads(smoke):
    """lm_loss in both packages on (2, 128) tokens (the chunkwise form, one
    loss chunk) per preset, and its gradients under bf16 (MX gradients are
    held at the block)."""
    jcfg, cfg, jparams, _, params, toks = smoke
    tk = toks[:, :128]
    labels = np.roll(tk, -1, 1)
    labels[:, -1] = -1
    jb = {"tokens": jnp.asarray(tk), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tk).long(),
          "labels": torch.from_numpy(labels).long()}
    out = {}
    for prec in PRESETS:
        jq, tq = jcore.preset(prec), core.preset(prec)
        if prec == "bf16":
            (jl, _), jg = _exact_jit(jax.value_and_grad(
                lambda p: jlm_loss(p, jb, jcfg, jq), has_aux=True))(jparams)
            p = tree_map(lambda t: t.clone().requires_grad_(True), params)
            leaves = list(tree_leaves_with_path(p))
            tl, _ = lm_loss(p, tb, cfg, tq)
            tg = torch.autograd.grad(tl, [t for _, t in leaves])
            grads = params_to_jax(
                _unflat(params, dict(zip([q for q, _ in leaves], tg))), cfg)
            out[prec] = (float(jl), float(tl.detach()), jg, grads)
        else:
            jl, _ = _exact_jit(lambda p: jlm_loss(p, jb, jcfg, jq))(jparams)
            with torch.no_grad():
                tl, _ = lm_loss(params, tb, cfg, tq)
            out[prec] = (float(jl), float(tl), None, None)
    return out


def _unflat(tree, flat, prefix=()):
    if isinstance(tree, dict):
        return {k: _unflat(v, flat, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unflat(v, flat, prefix + (i,)) for i, v in enumerate(tree)]
    return flat[prefix]


@pytest.mark.parametrize("prec", PRESETS)
def test_lm_loss_and_grads_match_reference(loss_grads, prec):
    jl, tl, jg, tg = loss_grads[prec]
    assert abs(tl - jl) <= LOSS_REL[prec] * abs(jl)
    if jg is None:
        return
    want = dict(jax.tree_util.tree_leaves_with_path(jg))
    got = {jax.tree_util.keystr(p): t
           for p, t in jax.tree_util.tree_leaves_with_path(tg)}
    assert len(got) == len(want)
    for path, w in want.items():
        key = jax.tree_util.keystr(path)
        g = _np(got[key])
        assert np.any(g != 0), key
        assert _rel(g, np.asarray(w, np.float32)) <= GRAD_REL[prec], key


@pytest.mark.parametrize("prec", PRESETS)
def test_decode_drift_from_the_whole_forward_is_the_references(
        smoke, lm_runs, prec):
    """Each of lm_runs' N_DEC decode steps after the chunkwise prefill
    against a teacher-forced whole forward over the same tokens, in each
    package: the port's drift is the reference's step by step.  Under MX
    both readings pass the reference's one-step bound (DEC_REL) in later
    steps, so chip_smoke.py holds every decode step against a stepped
    run and only the first against the whole forward."""
    jcfg, cfg, jparams, _, params, toks = smoke
    jq, tq = jcore.preset(prec), core.preset(prec)
    seq = toks[:, :TC + N_DEC]
    want = {"ref": _np(_exact_jit(lambda p, t: jqdense(
        p["lm_head"], jlm_apply(p, {"tokens": t}, jcfg, jq)[0], jq))(
            jparams, jnp.asarray(seq)))}
    with torch.no_grad():
        h, _ = lm_apply(params, {"tokens": torch.from_numpy(seq).long()},
                        cfg, tq)
        want["port"] = _np(qdense(params["lm_head"], h, tq))
    drift = {}
    for side in ("ref", "port"):
        got = lm_runs[prec][side][0]                 # (1 + N_DEC, B, V)
        w = want[side][:, TC - 1:].transpose(1, 0, 2)
        if prec == "bf16":
            drift[side] = (np.abs(got - w) / (DEC_TOL + DEC_TOL * np.abs(w))
                           ).max((1, 2))
        else:
            drift[side] = (np.linalg.norm(got - w, axis=-1)
                           / np.linalg.norm(w, axis=-1)).max(1)
    assert drift["port"][0] <= DRIFT_PREFILL[prec]
    assert np.all(np.abs(drift["port"] - drift["ref"]) <= DRIFT_ATOL[prec])
    if prec != "bf16":
        assert drift["ref"].max() > DEC_REL and drift["port"].max() > DEC_REL


def test_fused_prefill_matches_token_stepped_decode(smoke):
    """The reference's test_fused_prefill_windowed_and_recurrent_parity
    [xlstm-1.3b] on the port: one fused lm_prefill of (2, 24) tokens (the
    step scan) against feeding them one at a time through lm_decode_step,
    logits and every cache leaf, under the reference's bounds."""
    _, cfg, _, _, params, toks = smoke
    qcfg = core.preset("e4m3_bf16act")
    tk = torch.from_numpy(toks[:, :24]).long()
    with torch.no_grad():
        lf, cf = lm_prefill(params, tk, cfg, qcfg, 32)
    ls, cs = prefill_into_cache(params, tk, cfg, qcfg, 32)
    np.testing.assert_allclose(_np(lf), _np(ls), atol=STEP_TOL,
                               rtol=STEP_TOL)
    for a, b in zip(cf, cs):
        assert set(a) == set(b)
        for name in a:
            assert a[name].shape == b[name].shape
            assert a[name].dtype == b[name].dtype
            assert _rel(_np(a[name]), _np(b[name])) < STEP_CACHE_REL


@pytest.mark.parametrize("prec", PRESETS)
@pytest.mark.parametrize("T", [24, TC])
def test_decode_step_matches_prefill_last_token(smoke, prec, T):
    """The reference's test_decode_step_matches_prefill_last_token_fused
    on the port: prefilling T-1 tokens and one decode step against
    prefilling all T, under its bounds; at T 150 the shorter prefill runs
    the chunkwise form and decode continues from its chunk-end
    stabilizer."""
    _, cfg, _, _, params, toks = smoke
    tk = torch.from_numpy(toks[:, :T]).long()
    qcfg = core.preset(prec)
    with torch.no_grad():
        _, cache = lm_prefill(params, tk[:, :T - 1], cfg, qcfg, S)
        ld, _ = lm_decode_step(params, cache, tk[:, T - 1:], T - 1, cfg,
                               qcfg)
        lp, _ = lm_prefill(params, tk, cfg, qcfg, S)
    ld, lp = _np(ld), _np(lp)
    if prec == "bf16":
        np.testing.assert_allclose(ld, lp, atol=DEC_TOL, rtol=DEC_TOL)
    else:
        assert _rel(ld, lp) < DEC_REL
        a, b = ld.ravel(), lp.ravel()
        assert float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))) > \
            DEC_COS


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------
def _submit_all(eng, prompts, max_new=8, sample_every=0):
    for i, p in enumerate(prompts):
        sampled = sample_every and (i % sample_every == sample_every - 1)
        eng.submit(p, SamplingParams(temperature=0.8 if sampled else 0.0,
                                     top_k=20 if sampled else 0,
                                     max_new_tokens=max_new, seed=300 + i))


def _results(eng):
    return {r.rid: (tuple(r.tokens), r.finish_reason) for r in eng.drain()}


@pytest.mark.parametrize("prec", PRESETS)
def test_paged_vs_slab_greedy_parity(smoke, prec):
    """xLSTM state is slab leaves of the paged engine (0 paged leaves),
    which must give the slab engine's tokens, greedy and sampled rows
    alike; the step scan (5, 40, 33) and the chunkwise form (150)."""
    _, cfg, _, _, params, _ = smoke
    qcfg = core.preset(prec)
    rng = np.random.RandomState(11)
    prompts = [rng.randint(1, cfg.vocab, size=n) for n in (5, 40, 150, 33)]
    slab = ServeEngine(params, cfg, qcfg, max_batch=3, max_len=S,
                       device="cpu")
    paged = PagedServeEngine(params, cfg, qcfg, max_batch=3, max_len=S,
                             n_pages=32, page_size=32, device="cpu")
    assert not slab.pad_safe
    assert not paged.chunk and not paged._pool_keys
    assert len(paged._slab_keys) == 3 * 4 + 4
    _submit_all(slab, prompts, sample_every=4)
    _submit_all(paged, prompts, sample_every=4)
    assert _results(paged) == _results(slab)
    assert [(e["prompt_len"], e["padded_len"]) for e in slab.events
            if e["event"] == "prefill"] == [(n, n) for n in (5, 40, 150, 33)]
    paged.alloc.check()
    assert paged.alloc.pages_in_use == 0


@pytest.mark.parametrize("engine", ["slab", "paged"])
def test_finished_rows_do_not_leak_into_the_next_request(smoke, engine):
    """One slot serves three requests in turn: each one's tokens equal
    those of a fresh engine serving it alone, and after the last one its
    state rows hold what that request's prefill and decodes left, not a
    mix with the earlier requests'."""
    _, cfg, _, _, params, _ = smoke
    qcfg = core.preset("bf16")
    rng = np.random.RandomState(13)
    prompts = [rng.randint(1, cfg.vocab, size=n) for n in (150, 20, 9)]

    def make():
        if engine == "slab":
            return ServeEngine(params, cfg, qcfg, max_batch=1, max_len=S,
                               device="cpu")
        return PagedServeEngine(params, cfg, qcfg, max_batch=1, max_len=S,
                                n_pages=16, page_size=32, device="cpu")
    used = make()
    _submit_all(used, prompts, max_new=6)
    got = [t for t, _ in _results(used).values()]
    for p, tokens in zip(prompts, got):
        fresh = make()
        _submit_all(fresh, [p], max_new=6)
        assert [t for t, _ in _results(fresh).values()] == [tokens]
    # the last request's state: its prompt and 5 fed tokens stepped
    seq = np.concatenate([prompts[-1], np.asarray(got[-1][:-1])])
    with torch.no_grad():
        _, want = lm_prefill(used.params, torch.from_numpy(
            prompts[-1][None]).long(), cfg, qcfg, S)
        for i, tok in enumerate(seq[len(prompts[-1]):]):
            _, want = lm_decode_step(
                used.params, want, torch.tensor([[int(tok)]]),
                len(prompts[-1]) + i, cfg, qcfg)
    for lc, wc in zip(used.cache, want):
        for name, t in wc.items():
            assert torch.equal(lc[name][:1], t), name


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def _np_batch(step, vocab, B=2, T=128):
    toks = np.random.default_rng(100 + step).integers(0, vocab, (B, T + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


@pytest.mark.parametrize("prec", ["bf16"])
def test_trainer_three_steps_match_reference(smoke, prec):
    """Three AdamW steps at (2, 128) (the chunkwise form) in both
    packages from the same weights and batches: losses, gradient norms
    and learning rates.  In bf16: the reference's Trainer jits its step
    with XLA:CPU's excess precision, which under MX moves its losses by
    about 1e-2 from its own op-by-op numbers (the MX LM is held above,
    against exact compiles)."""
    jcfg, cfg, jparams, tree, _, _ = smoke
    # the reference's step donates its parameters: give it its own copy
    jt = JTrainer(lambda p, b, q: jlm_loss(p, b, jcfg, q),
                  jax.tree.map(jnp.array, tree),
                  jcore.preset(prec),
                  lambda s: jax.tree.map(jnp.asarray,
                                         _np_batch(s, cfg.vocab)),
                  tcfg=JTrainerConfig(total_steps=3, peak_lr=1e-3,
                                      log_every=1))
    jhist = jt.run(3)
    tr = Trainer(lambda p, b, q: lm_loss(p, b, cfg, q),
                 params_from_jax(tree, cfg, "cpu"), core.preset(prec),
                 lambda s: {k: torch.from_numpy(v.astype(np.int64))
                            for k, v in _np_batch(s, cfg.vocab).items()},
                 tcfg=TrainerConfig(total_steps=3, peak_lr=1e-3,
                                    log_every=1),
                 ckpt_layout=lm_checkpoint_layout(cfg, "cpu"))
    hist = tr.run(3)
    assert [r["step"] for r in hist] == [0, 1, 2]
    for a, b in zip(hist, jhist):
        assert abs(a["loss"] - b["loss"]) <= LOSS_ATOL[prec]
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-2)
        assert a["lr"] == b["lr"]


def test_card_fault_checks_reject_their_planted_faults(smoke):
    """chip_smoke.py's [xlstm] fault checks on the CPU at smoke size: the
    block's decode against its whole prefill within XL_DECODE_REL and the
    chunkwise form against the step scan within XL_FORM_REL, with the
    decode conv window one position off and the chunkwise carry under the
    chunk-start stabilizer each planted and rejected (the function raises
    otherwise); the planted functions are restored after."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    _, cfg, _, _, params, _ = smoke
    conv, carry = xlstm._conv1d, xlstm._chunk_carry
    out = cs.xl_fault_checks(params, cfg, "cpu")
    assert xlstm._conv1d is conv and xlstm._chunk_carry is carry
    assert out["decode_rel"]["reading"] <= cs.XL_DECODE_REL
    assert out["form_rel"]["reading"] <= cs.XL_FORM_REL
    assert out["decode_rel"]["planted"] > 10 * cs.XL_DECODE_REL
    assert out["form_rel"]["planted"] > 10 * cs.XL_FORM_REL
