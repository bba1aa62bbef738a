"""Stochastic rounding (`libxsmm_torch.kernels.eltwise.stochastic_round`,
its plain version on CPU tensors) onto bf16, f16, bf8 (e5m2) and hf8
(e4m3fn): statistics and edges.

For every target, on inputs in its normal range, in its subnormal range,
below its least subnormal and past its largest finite value:
  * each output is one of the input's two neighbours in the target;
  * the rounding is unbiased: the summed error is within 4 sigma of 0,
    sigma^2 = sum (upper - x)(x - lower);
  * an f8 value past the largest finite rounds to nearest even as the JAX
    package's cast does (e5m2: Inf from 61440; e4m3fn: NaN above 464);
  * NaN stays NaN, Inf stays Inf (NaN for e4m3fn);
  * bf16 is the reference's add-16-random-bits-and-truncate, bit for bit,
    on the port's counter-hash bits.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import libxsmm_torch as xp
from libxsmm_torch.dtypes import Datatype
from libxsmm_torch.kernels import eltwise as ke

torch.set_num_threads(1)

RNG = np.random.default_rng(1234)
TARGETS = {"bf16": (torch.bfloat16, Datatype.BF16),
           "f16": (torch.float16, Datatype.F16),
           "bf8": (torch.float8_e5m2, Datatype.BF8),
           "hf8": (torch.float8_e4m3fn, Datatype.HF8)}
# (least subnormal, least normal, largest finite) per target
LIMITS = {"bf16": (2.0 ** -133, 2.0 ** -126, None),
          "f16": (2.0 ** -24, 2.0 ** -14, 65504.0),
          "bf8": (2.0 ** -16, 2.0 ** -14, 57344.0),
          "hf8": (2.0 ** -9, 2.0 ** -6, 448.0)}


def finite_values(tdt):
    """Every finite value of the target, sorted, in float64."""
    nbits = 8 * tdt.itemsize
    codes = torch.arange(2 ** nbits, dtype=torch.int64)
    codes = torch.where(codes >= 2 ** (nbits - 1), codes - 2 ** nbits, codes)
    vals = codes.to({8: torch.int8, 16: torch.int16}[nbits]).view(tdt)
    v = vals.double().numpy()
    return np.unique(v[np.isfinite(v)])


def neighbours(x, tdt):
    grid = finite_values(tdt)
    i = np.searchsorted(grid, x, side="right")
    lo = grid[np.clip(i - 1, 0, len(grid) - 1)]
    hi = grid[np.clip(i, 0, len(grid) - 1)]
    exact = lo == x
    return np.where(exact, x, lo), np.where(exact, x, hi)


def inputs(name, region, n=20000):
    tiny, least_normal, maxf = LIMITS[name]
    sign = np.where(RNG.random(n) < 0.5, -1.0, 1.0)
    if region == "normal":
        mag = RNG.uniform(1.0, 2.0, n) * np.exp2(RNG.integers(-3, 4, n))
    elif region == "subnormal":
        mag = RNG.uniform(tiny, least_normal, n)
    else:                                  # below the least subnormal
        mag = RNG.uniform(0.0, tiny, n)
    return (sign * mag).astype(np.float32)


@pytest.mark.parametrize("name", list(TARGETS))
@pytest.mark.parametrize("region", ["normal", "subnormal", "tiny"])
def test_sr_neighbours_and_unbiased(name, region):
    tdt, dt = TARGETS[name]
    x = inputs(name, region)
    if name == "bf16" and region != "normal":
        # f32 subnormals: the f32 grid is 2^-149, below bf16's 2^-133
        x = (x * 2.0 ** 16).astype(np.float32) * np.float32(2.0 ** -16)
    y = ke.stochastic_round(torch.from_numpy(x), 21, dt)
    assert y.dtype == tdt
    out = y.double().numpy()
    x64 = x.astype(np.float64)
    lo, hi = neighbours(x64, tdt)
    assert ((out == lo) | (out == hi)).all()
    var = (hi - x64) * (x64 - lo)
    sigma = np.sqrt(var.sum())
    assert abs((out - x64).sum()) <= 4 * sigma + 1e-300
    # both neighbours occur where the input lies between them
    between = lo != hi
    if between.sum() > 100:
        assert 0.05 < (out[between] == hi[between]).mean() < 0.95 or \
            region == "tiny"


@pytest.mark.parametrize("name", ["bf8", "hf8"])
def test_sr_f8_overflow_rounds_to_nearest_like_jax(name):
    tdt, dt = TARGETS[name]
    maxf = LIMITS[name][2]
    x = np.concatenate([np.linspace(maxf, 2.2 * maxf, 401),
                        [61439.0, 61440.0, 61441.0, 464.0, 465.0, 1e30,
                         np.inf]]).astype(np.float32)
    x = np.concatenate([x, -x])
    got = ke.stochastic_round(torch.from_numpy(x), 5, dt)
    jdt = jnp.float8_e5m2 if name == "bf8" else jnp.float8_e4m3fn
    want = np.asarray(jnp.asarray(x).astype(jdt)).view(np.uint8)
    past = np.abs(x) > maxf
    np.testing.assert_array_equal(got.view(torch.uint8).numpy()[past],
                                  want[past])


@pytest.mark.parametrize("name", list(TARGETS))
def test_sr_nan_inf_and_wide_overflow(name):
    tdt, dt = TARGETS[name]
    bits = np.asarray([0x7F800001, 0xFF800001, 0x7FC00000, 0xFFFFFFFF,
                       0x7F800000, 0xFF800000], np.uint32)
    y = ke.stochastic_round(torch.from_numpy(bits.view(np.float32)), 3, dt)
    v = y.double().numpy()
    assert np.isnan(v[:4]).all()
    raw = y.view(torch.uint8 if tdt.itemsize == 1 else torch.int16).numpy()
    sign_bit = 0x80 if tdt.itemsize == 1 else -0x8000
    assert (raw[[1, 3]] & sign_bit).all() and not (raw[[0, 2]] & sign_bit).any()
    if name == "hf8":
        assert np.isnan(v[4:]).all()            # e4m3fn has no Inf
    else:
        assert list(v[4:]) == [np.inf, -np.inf]
    if name in ("bf16", "f16"):
        # past the largest finite the add-and-truncate runs to Inf: the
        # upper neighbour is Inf
        maxf = finite_values(tdt)[-1]
        top = np.float32(maxf) * np.float32(1.0 + 2 ** -9)
        z = ke.stochastic_round(torch.full((4096,), float(top)), 1, dt)
        assert set(np.unique(z.double().numpy())) <= {maxf, np.inf}


def test_sr_bf16_is_add_and_truncate():
    x = torch.from_numpy((RNG.standard_normal((64, 96)) * 3).astype(
        np.float32))
    r = ke._flat_bits(99, (64, 96), x.device)
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    want = ((bits + (r & 0xFFFF)) & 0xFFFF0000) >> 16
    got = ke.stochastic_round(x, 99, Datatype.BF16).view(torch.int16)
    np.testing.assert_array_equal(got.to(torch.int64).numpy() & 0xFFFF,
                                  want.numpy())


@pytest.mark.parametrize("in_dtype", [torch.bfloat16, torch.float16])
def test_sr_narrow_inputs_widen(in_dtype):
    x = torch.randn(33, 17, generator=torch.Generator().manual_seed(0)).to(
        in_dtype)
    for dt in (Datatype.BF16, Datatype.F16, Datatype.BF8, Datatype.HF8):
        assert torch.equal(ke.stochastic_round(x, 4, dt),
                           ke.stochastic_round(x.float(), 4, dt))


def test_sr_seed_forms_and_refusals():
    x = torch.randn(40, 40)
    a = ke.stochastic_round(x, 7, Datatype.BF16)
    assert torch.equal(a, ke.stochastic_round(x, torch.tensor(7),
                                              Datatype.BF16))
    assert torch.equal(a, ke.stochastic_round(x, 7 + 2 ** 32, Datatype.BF16))
    assert torch.equal(ke.stochastic_round(x, -1, Datatype.BF16),
                       ke.stochastic_round(x, 2 ** 32 - 1, Datatype.BF16))
    assert not torch.equal(a, ke.stochastic_round(x, 8, Datatype.BF16))
    assert torch.equal(a, ke.stochastic_round.plain(x, 7, Datatype.BF16))
    with pytest.raises(ValueError, match="stochastic rounding targets"):
        ke.stochastic_round(x, 0, Datatype.F32)
    with pytest.raises(ValueError, match="stochastic rounding targets"):
        ke.stochastic_round(x, 0, Datatype.I8)


def test_sr_entry_points():
    """meltw STOCHASTIC_ROUND and the quant converters reach the rounding
    (plain on the CPU)."""
    x = torch.randn(16, 64)
    for dt in (Datatype.BF16, Datatype.F16, Datatype.BF8, Datatype.HF8):
        kern = xp.dispatch_meltw_unary(xp.UnaryType.STOCHASTIC_ROUND, 16, 64,
                                       out_type=dt)
        assert torch.equal(kern(x, 5), ke.stochastic_round(x, 5, dt))
        assert torch.equal(kern(x, seed=5), kern(x, 5))
    assert torch.equal(xp.stochastic_convert_fp32_bf16(x, 3),
                       ke.stochastic_round(x, 3, Datatype.BF16))
    assert torch.equal(xp.convert_f32_to_bf8_stochastic(x, 3),
                       ke.stochastic_round(x, 3, Datatype.BF8))
