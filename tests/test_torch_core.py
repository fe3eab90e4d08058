"""The port's MX numerics core against the JAX reference.

Inputs are made with numpy from a seed and fed to both packages.  The
quantizers must agree bitwise: 5 formats x 3 scale modes x {fp32, bf16} x
axis in {0, 1, -1}, lengths that are not block multiples, and non-finite
values.  Configs cross the packages as dicts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.kernels import ref as jref
from repro_torch import core
from repro_torch.kernels import ref

FORMATS = ["e4m3", "e5m2", "e3m2", "e2m3", "e2m1"]
MODES = ["floor", "bump", "adaptive"]


def _to_torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, np.float32))
    return t.to(torch.bfloat16) if dtype == "bf16" else t


def _to_jax(a: np.ndarray, dtype: str):
    x = jnp.asarray(np.array(a, np.float32))
    return x.astype(jnp.bfloat16) if dtype == "bf16" else x


def _bits(x) -> np.ndarray:
    """Raw bits of a torch or JAX array, for bitwise comparison."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.view(torch.int32).numpy()
    a = np.asarray(x)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _assert_same(got, want) -> None:
    """Bitwise equal, except that any NaN matches any NaN (the sign and
    payload of a NaN differ between the frameworks' casts)."""
    g = got.float().numpy()
    w = np.asarray(want).astype(np.float32)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    keep = ~np.isnan(w)
    np.testing.assert_array_equal(_bits(got)[keep], _bits(want)[keep])


def _sample(seed: int) -> np.ndarray:
    """(5, 70, 45) values spanning ~2^-10..2^10 with zeros, non-multiple
    block lengths on every axis, and one inf, -inf and NaN."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((5, 70, 45)) * np.exp2(rng.integers(-10, 10,
                                                                (5, 70, 45)))
    x[rng.random(x.shape) < 0.05] = 0.0
    x[0, 3, 7] = np.inf
    x[1, 40, 2] = -np.inf
    x[2, 65, 44] = np.nan
    return x.astype(np.float32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_quantize_mx_bitwise(fmt, mode, dtype):
    x = _sample(FORMATS.index(fmt) * 7 + MODES.index(mode))
    jf, tf = jcore.get_format(fmt), core.get_format(fmt)
    with jax.disable_jit():
        for axis in (0, 1, -1):
            want = jcore.quantize_mx(_to_jax(x, dtype), jf, axis=axis,
                                     scale_mode=mode)
            got = core.quantize_mx(_to_torch(x, dtype), tf, axis=axis,
                                   scale_mode=mode)
            _assert_same(got, want)
            got_ref = ref.mx_quantize_ref(_to_torch(x, dtype), tf, axis=axis,
                                          scale_mode=mode)
            want_ref = jref.mx_quantize_ref(_to_jax(x, dtype), jf, axis=axis,
                                            scale_mode=mode)
            _assert_same(got_ref, want_ref)


def test_quantize_none_is_identity():
    x = torch.randn(3, 40)
    assert core.quantize_mx(x, None) is x


@pytest.mark.parametrize("fmt", FORMATS)
def test_formats_and_code_tables_match(fmt):
    jf, tf = jcore.get_format(fmt), core.get_format(fmt)
    assert dataclasses.asdict(jf) == dataclasses.asdict(tf)
    assert (jf.e_max, jf.min_normal_exp, jf.bits) == (tf.e_max,
                                                      tf.min_normal_exp,
                                                      tf.bits)
    np.testing.assert_array_equal(jcore.positive_codes(jf),
                                  core.positive_codes(tf))
    # Every code is a fixed point of the element cast, in both packages.
    codes = core.positive_codes(tf).astype(np.float32)
    got = core.quantize_elem(torch.from_numpy(codes), tf).numpy()
    np.testing.assert_array_equal(got, codes)


def test_floor_log2_and_exp2_int_bitwise():
    from repro.core import formats as jformats
    from repro_torch.core import formats
    x = np.abs(_sample(3)).ravel()
    x = x[np.isfinite(x) & (x > 0)]
    np.testing.assert_array_equal(
        formats.floor_log2(torch.from_numpy(x)).numpy(),
        np.asarray(jformats.floor_log2(jnp.asarray(x))))
    e = np.arange(-140, 140, dtype=np.int32)
    np.testing.assert_array_equal(
        formats.exp2_int(torch.from_numpy(e)).numpy(),
        np.asarray(jformats.exp2_int(jnp.asarray(e))))


@pytest.mark.parametrize("name", sorted(jcore.PRESETS))
def test_qconfig_round_trips_across_packages(name):
    jc, tc = jcore.preset(name), core.preset(name)
    assert jc.to_dict() == tc.to_dict()
    assert jcore.QuantConfig.from_dict(tc.to_dict()) == jc
    assert core.QuantConfig.from_dict(jc.to_dict()) == tc
    assert jc.describe() == tc.describe()
    for iv in sorted(jcore.INTERVENTIONS):
        assert (jcore.apply_intervention(jc, iv).to_dict()
                == core.apply_intervention(tc, iv).to_dict())


def test_preset_and_intervention_names_match():
    assert core.list_presets() == jcore.list_presets()
    assert core.list_interventions() == jcore.list_interventions()


def test_attnspec_matches_reference():
    for kw in ({}, {"causal": False}, {"window": 16, "kv_chunk": 64}):
        assert (dataclasses.asdict(core.AttnSpec.training(**kw))
                == dataclasses.asdict(jcore.AttnSpec.training(**kw)))
    assert (dataclasses.asdict(core.AttnSpec.decode(cache_len=64))
            == dataclasses.asdict(jcore.AttnSpec.decode(cache_len=64)))
    with pytest.raises(ValueError):
        core.AttnSpec(kind="window")
