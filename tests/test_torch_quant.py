"""libxsmm_torch.quant and libxsmm_torch.rng against the JAX package's
quant and rng, on the CPU, bit for bit.

The same numpy inputs (random f32 bit patterns, which cover every class of
value, and hand-picked edges: denormals, NaN payloads, Inf, rounding ties,
the f8 overflow boundaries, all-zero and Inf/NaN blocks) go through both
packages; converter outputs, block payloads and scale bytes are compared as
raw bits. Dequantized values are compared bit for bit where the JAX
package's exp2 is exact (scale exponents within +-12 of 0: XLA's exp2 on
the CPU is inexact beyond; the port computes every power of two exactly,
and `test_mx_decode_powers_of_two_are_exact` pins that). NaN outputs of a
widening conversion are compared as NaN, not by payload.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import libxsmm_torch as xp
import libxsmm_tpu as xt
from libxsmm_torch import quant as pq
from libxsmm_torch import rng as prng
from libxsmm_tpu import quant as rq
from libxsmm_tpu import rng as rrng
from libxsmm_tpu.dtypes import Datatype

torch.set_num_threads(1)

RNG = np.random.default_rng(505)

SPECIAL_BITS = [
    0x00000000, 0x80000000, 0x00000001, 0x80000001, 0x007FFFFF, 0x00800000,
    0x7F7FFFFF, 0xFF7FFFFF, 0x7F800000, 0xFF800000, 0x7F800001, 0xFF800001,
    0xFFC00001, 0x7FC12345, 0x3F808000, 0x3F818000, 0x3F807FFF, 0x3F808001,
    0xBF808000, 0x477FE000, 0x47700000, 0x476FFFFF, 0x47700001, 0x47800000,
    0x47600000, 0x43E80000, 0x43E80001, 0x43E7FFFF, 0x43F00000, 0x43E00000,
    0x38800000, 0x33800000, 0x33000000, 0x3B800000, 0x387FC000, 0x3A000000,
    0x7F7F8000, 0x7F7F7FFF, 0x00008000, 0x3E2AAAAB, 0x40C00000, 0x41000000,
]


def f32_inputs(n=4096):
    """Random f32 bit patterns (every class: normal, denormal, NaN, Inf),
    random values of moderate range, and the edges above."""
    bits = RNG.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    vals = (RNG.standard_normal(n) * np.exp2(RNG.integers(-30, 30, n))
            ).astype(np.float32).view(np.uint32)
    allb = np.concatenate([np.asarray(SPECIAL_BITS, np.uint32), bits, vals])
    return allb.view(np.float32)


def raw(x):
    """The bits of a result of either package as an unsigned numpy array."""
    if isinstance(x, torch.Tensor):
        if x.is_floating_point():
            x = x.view({1: torch.uint8, 2: torch.int16,
                        4: torch.int32}[x.element_size()])
        x = x.numpy()
    else:
        x = np.asarray(x)
    return x.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[x.dtype.itemsize])


def same_bits(ref, got):
    r, g = raw(ref), raw(got)
    assert r.shape == g.shape, (r.shape, g.shape)
    bad = np.flatnonzero(r.ravel() != g.ravel())
    assert bad.size == 0, (f"{bad.size} of {r.size} differ, first at "
                           f"{bad[:5]}: ref {r.ravel()[bad[:5]]}, "
                           f"port {g.ravel()[bad[:5]]}")


def same_values(ref, got):
    """f32 results equal bit for bit, NaN compared as NaN."""
    r = np.asarray(ref, np.float32)
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert r.shape == g.shape
    assert (np.isnan(r) == np.isnan(g)).all()
    keep = ~np.isnan(r)
    np.testing.assert_array_equal(g[keep].view(np.uint32),
                                  r[keep].view(np.uint32))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# scalar converters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "rne_convert_fp32_bf16", "truncate_convert_fp32_bf16",
    "rnaz_convert_fp32_bf16", "rne_convert_fp32_bf8",
    "rne_convert_fp32_hf8", "convert_fp32_f16"])
def test_f32_converters_bit_exact(name):
    x = f32_inputs()
    same_bits(getattr(rq, name)(jnp.asarray(x)), getattr(pq, name)(t(x)))


@pytest.mark.parametrize("src", ["bf8", "hf8", "f16", "bf16"])
def test_widening_converters(src):
    if src in ("bf8", "hf8"):
        codes = np.arange(256, dtype=np.uint8)
        jdt = jnp.float8_e5m2 if src == "bf8" else jnp.float8_e4m3fn
        tdt = torch.float8_e5m2 if src == "bf8" else torch.float8_e4m3fn
        xj = jnp.asarray(codes).view(jdt)
        xt_ = t(codes).view(tdt)
    else:
        codes = np.arange(65536, dtype=np.uint32).astype(np.uint16)
        jdt = jnp.float16 if src == "f16" else jnp.bfloat16
        tdt = torch.float16 if src == "f16" else torch.bfloat16
        xj = jnp.asarray(codes).view(jdt)
        xt_ = t(codes.view(np.int16)).view(tdt)
    fn = {"bf8": "convert_bf8_fp32", "hf8": "convert_hf8_fp32",
          "f16": "convert_f16_fp32", "bf16": "convert_bf16_fp32"}[src]
    same_values(getattr(rq, fn)(xj), getattr(pq, fn)(xt_))


def test_f16_to_hf8_bit_exact():
    codes = np.arange(65536, dtype=np.uint32).astype(np.uint16)
    xj = jnp.asarray(codes).view(jnp.float16)
    xt_ = t(codes.view(np.int16)).view(torch.float16)
    same_bits(rq.rne_convert_f16_hf8(xj), pq.rne_convert_f16_hf8(xt_))


def test_bf16_converter_edges():
    # DAZ, NaN quieting, Inf untouched, ties even / away
    x = np.asarray(SPECIAL_BITS, np.uint32).view(np.float32)
    rne = raw(pq.rne_convert_fp32_bf16(t(x)))
    assert rne[2] == 0 and rne[3] == 0x8000                   # DAZ
    assert rne[10] == 0x7FC0 and rne[12] == 0xFFC0            # quieted
    assert rne[8] == 0x7F80 and rne[9] == 0xFF80
    assert rne[14] == 0x3F80 and rne[15] == 0x3F82            # ties to even
    rnaz = raw(pq.rnaz_convert_fp32_bf16(t(x)))
    assert rnaz[14] == 0x3F81 and rnaz[18] == 0xBF81          # away


def test_fp8_overflow_boundaries():
    x = np.asarray([57344, 61439, 61440, 65504, 65536, 448, 464, 465, 480,
                    -61440, -465], np.float32)
    assert list(raw(pq.rne_convert_fp32_bf8(t(x)))) == list(
        raw(rq.rne_convert_fp32_bf8(jnp.asarray(x))))
    assert list(raw(pq.rne_convert_fp32_hf8(t(x)))) == list(
        raw(rq.rne_convert_fp32_hf8(jnp.asarray(x))))


def test_converter_aliases_match():
    names = [n for n in dir(rq) if n.startswith(("convert_", "rne_",
                                                 "rnaz_", "truncate_",
                                                 "stochastic_"))]
    for n in names:
        assert hasattr(pq, n), n
        assert getattr(xp, n, None) is getattr(pq, n) or not hasattr(xt, n)
        # an alias names the same function in both packages
        ref_target = getattr(rq, n).__name__
        assert getattr(pq, n).__name__ == ref_target, n


def test_numpy_input_needs_a_device():
    x = np.ones(4, np.float32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pq.rne_convert_fp32_bf16(x)
    assert pq.rne_convert_fp32_bf16(x, device="cpu").device.type == "cpu"


# ---------------------------------------------------------------------------
# integer quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["i16", "i8"])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_quantize_int_parity(which, scale):
    x = (RNG.standard_normal((16, 24)) * scale).astype(np.float32)
    x[0, :3] = [0.5, 1.5, -2.5]
    fr, fp = getattr(rq, f"quantize_{which}"), getattr(pq, f"quantize_{which}")
    (qr, sr), (qp, sp) = fr(jnp.asarray(x)), fp(t(x))
    assert sr == sp
    same_bits(qr, qp)
    if which == "i16":
        same_values(rq.dequantize_i16(qr, sr), pq.dequantize_i16(qp, sp))


def test_quantize_int_zero_and_refusals():
    q, s = pq.quantize_i8(torch.zeros(3, 4))
    assert s == 0 and q.dtype == torch.int8 and not q.any()
    for bad in (np.nan, np.inf):
        with pytest.raises(ValueError, match="NaN/Inf"):
            pq.quantize_i16(torch.tensor([1.0, bad]))


# ---------------------------------------------------------------------------
# MX block formats
# ---------------------------------------------------------------------------

# the block magnitude (log2) at which each format's scales stay where XLA's
# exp2 is exact
MAGNITUDE = {"mxbf8": 12, "mxfp8_e5m2": 12, "mxfp8_e4m3": 6}


def block_inputs(rows=6, n=64, wild=True, magnitude=0):
    """Blocks of several magnitudes around 2^magnitude, an all-zero block, a
    subnormal block, Inf and NaN blocks, -0 and ties."""
    x = RNG.standard_normal((rows, n)).astype(np.float32)
    x *= np.exp2(RNG.integers(-5, 6, (rows, 1)) + magnitude).astype(
        np.float32)
    if wild:
        x[0, :32] = 0.0
        x[0, 32:] = np.asarray(SPECIAL_BITS[:32], np.uint32).view(np.float32)
        x[1, :32] = np.float32(1e-40)
        x[1, 5] = -0.0
        x[2, 3] = np.inf
        x[3, 40] = np.nan
        x[4, :8] = [0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0, -0.25]
        x[5, :16] = 1e30
    return x


@pytest.mark.parametrize("fmt", ["mxfp4", "nvfp4", "mxbf8", "mxfp6_e3m2",
                                 "mxfp6_e2m3"])
@pytest.mark.parametrize("wild", [False, True])
def test_block_quantizers_bit_exact(fmt, wild):
    x = block_inputs(wild=wild)
    if fmt.startswith("mxfp6"):
        f = fmt.split("_")[1]
        (pr, sr), (pp, sp) = (rq.mxfp6_quantize_blocks(jnp.asarray(x), f),
                              pq.mxfp6_quantize_blocks(t(x), f))
    else:
        name = f"{fmt}_quantize_blocks"
        (pr, sr), (pp, sp) = (getattr(rq, name)(jnp.asarray(x)),
                              getattr(pq, name)(t(x)))
    same_bits(pr, pp)
    same_bits(sr, sp)


@pytest.mark.parametrize("fmt", ["mxfp4", "nvfp4", "mxbf8", "mxfp6_e3m2",
                                 "mxfp6_e2m3"])
def test_block_dequantizers_bit_exact(fmt):
    x = block_inputs(wild=False, magnitude=MAGNITUDE.get(fmt, 0))
    if fmt.startswith("mxfp6"):
        f = fmt.split("_")[1]
        p, s = rq.mxfp6_quantize_blocks(jnp.asarray(x), f)
        ref = rq.mxfp6_dequantize_blocks(p, s, f)
        got = pq.mxfp6_dequantize_blocks(t(np.asarray(p)), t(np.asarray(s)),
                                         f)
    else:
        p, s = getattr(rq, f"{fmt}_quantize_blocks")(jnp.asarray(x))
        ref = getattr(rq, f"{fmt}_dequantize_blocks")(p, s)
        praw = np.asarray(p).view(np.uint8)
        pt = t(praw).view(torch.float8_e5m2) if fmt == "mxbf8" else t(praw)
        got = getattr(pq, f"{fmt}_dequantize_blocks")(pt, t(np.asarray(s)))
    same_values(ref, got)


def test_nvfp4_scale_clamp_to_0x78():
    # amax 6 * 300: the hf8 scale needs exponent 15, clamped to code 0x78
    x = np.full((2, 16), 1800.0, np.float32)
    x[1] = 1e6
    pp, sp = pq.nvfp4_quantize_blocks(t(x))
    pr, sr = rq.nvfp4_quantize_blocks(jnp.asarray(x))
    same_bits(sr, sp)
    same_bits(pr, pp)
    assert list(raw(sp)[:, 0]) == [0x78, 0x78]


def test_zero_block_follows_the_flushed_arithmetic():
    # the E8M0 code 0 (2^-127) flushes to 0 in the JAX package's
    # arithmetic: an all-zero block divides 0 by 0 and stores the NaN code
    x = np.zeros((1, 32), np.float32)
    pp, sp = pq.mxfp4_quantize_blocks(t(x))
    assert set(raw(pp).ravel()) == {0x77} and raw(sp).ravel()[0] == 0
    same_bits(rq.mxfp4_quantize_blocks(jnp.asarray(x))[0], pp)
    assert float(pq._e8m0_decode(torch.tensor([0]))[0]) == 0.0


def test_mx_decode_powers_of_two_are_exact():
    codes = torch.arange(1, 255, dtype=torch.uint8)
    got = pq._e8m0_decode(codes).double()
    want = torch.ldexp(torch.ones(254, dtype=torch.float64),
                       codes.to(torch.int64) - 127)
    want = torch.where(want < 2.0 ** -126, 0.0, want)       # flushed
    assert torch.equal(got, want)
    # where XLA's exp2 is exact the two packages agree bit for bit
    mid = np.arange(116, 140, dtype=np.uint8)
    same_values(rq._e8m0_decode(jnp.asarray(mid)),
                pq._e8m0_decode(t(mid)))


@pytest.mark.parametrize("fmt", ["mxfp4", "mxfp6_e2m3", "mxfp6_e3m2",
                                 "mxfp8_e4m3", "mxfp8_e5m2"])
def test_mx_quantize_roundtrip_parity(fmt):
    x = block_inputs(wild=False, magnitude=MAGNITUDE.get(fmt, 0))
    (qr, er), (qp, ep) = (rq.mx_quantize(jnp.asarray(x), fmt),
                          pq.mx_quantize(t(x), fmt))
    same_values(qr, qp)
    same_bits(er, ep)
    same_values(rq.mx_dequantize(qr, er), pq.mx_dequantize(qp, ep))
    if fmt == "mxfp4":
        same_bits(rq.pack_fp4(qr), pq.pack_fp4(qp))
        same_values(rq.unpack_fp4(rq.pack_fp4(qr)),
                    pq.unpack_fp4(pq.pack_fp4(qp)))


def test_mx_quantize_zero_block_and_refusals():
    x = np.zeros((2, 32), np.float32)
    qr, er = rq.mx_quantize(jnp.asarray(x))
    qp, ep = pq.mx_quantize(t(x))
    same_values(qr, qp)
    same_bits(er, ep)
    with pytest.raises(ValueError, match="unknown MX format"):
        pq.mx_quantize(t(x), "mxfp3")
    with pytest.raises(ValueError, match="not divisible"):
        pq.mx_quantize(torch.zeros(2, 30))
    with pytest.raises(ValueError, match="not divisible"):
        pq.mxfp4_quantize_blocks(torch.zeros(2, 48))


@pytest.mark.parametrize("fmt", ["e3m2", "e2m3"])
def test_fp6_encode_ties_and_decode(fmt):
    grid = rq._format_grid("mxfp6_" + fmt).astype(np.float32)
    mids = ((grid[1:] + grid[:-1]) / 2).astype(np.float32)
    x = np.concatenate([grid, -grid, mids, -mids, [np.nan, np.inf, 100.0],
                        RNG.standard_normal(200).astype(np.float32) * 4])
    x = x.astype(np.float32)
    cr, cp = rq.fp6_encode(jnp.asarray(x), fmt), pq.fp6_encode(t(x), fmt)
    same_bits(cr, cp)
    codes = np.arange(64, dtype=np.uint8)
    same_values(rq.fp6_decode(jnp.asarray(codes), fmt),
                pq.fp6_decode(t(codes), fmt))


def test_encode_e2m1_ties():
    a = np.asarray([0, 0.25, 0.26, 0.75, 0.74, 1.25, 1.26, 1.75, 2.5, 2.6,
                    3.5, 5.0, 5.1, 7.0, np.nan, np.inf], np.float32)
    same_bits(rq.encode_e2m1(jnp.asarray(a)), pq.encode_e2m1(t(a)))


# ---------------------------------------------------------------------------
# sub-byte integer payloads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["I4X2", "U4X2", "I2X4", "I1X8"])
def test_subbyte_pack_unpack_parity(dt):
    lo, hi = {"I4X2": (-8, 8), "U4X2": (0, 16), "I2X4": (-1, 2),
              "I1X8": (-1, 2)}[dt]
    v = RNG.integers(lo, hi, (3, 5, 32))
    if dt == "I1X8":
        v = np.where(v >= 0, 1, -1)
    rdt, pdt = Datatype[dt], xp.Datatype[dt]
    pr = rq.pack_subbyte_gemm(rdt, jnp.asarray(v, jnp.int32))
    pp = pq.pack_subbyte_gemm(pdt, t(v))
    same_bits(pr, pp)
    allbytes = np.arange(256, dtype=np.uint8).reshape(8, 32)
    same_bits(rq.unpack_subbyte_gemm(rdt, jnp.asarray(allbytes)),
              pq.unpack_subbyte_gemm(pdt, t(allbytes)))
    np.testing.assert_array_equal(
        pq.unpack_subbyte_gemm(pdt, pp).numpy(), v.astype(np.int8))


def test_subbyte_refusals_and_i4x2():
    with pytest.raises(ValueError, match="sub-byte"):
        pq.unpack_subbyte_gemm(xp.Datatype.I8, torch.zeros(2, 2))
    with pytest.raises(ValueError, match="sub-byte"):
        pq.pack_subbyte_gemm(xp.Datatype.F32, torch.zeros(2, 8))
    lo = RNG.integers(-8, 8, (4, 6))
    hi = RNG.integers(-8, 8, (4, 6))
    packed = pq.pack_i4x2(t(lo), t(hi))
    same_bits(rq.pack_i4x2(jnp.asarray(lo), jnp.asarray(hi)), packed)
    ul, uh = pq.unpack_i4x2(packed)
    np.testing.assert_array_equal(ul.numpy(), lo)
    np.testing.assert_array_equal(uh.numpy(), hi)
    with pytest.raises(ValueError, match="even"):
        pq.pack_fp4(torch.zeros(2, 3))


# ---------------------------------------------------------------------------
# rng
# ---------------------------------------------------------------------------

def test_lsfr_i32_draws_bit_exact():
    state = RNG.integers(0, 2 ** 32, 64, dtype=np.uint64).astype(np.uint32)
    s_ref, s_port = state.copy(), state.copy()
    for step in range(200):
        idx = step % 16
        assert xp.lsfr_i32(s_port, idx) == rrng.lsfr_i32(s_ref, idx)
    np.testing.assert_array_equal(s_port, s_ref)


def test_rng_api_on_cpu():
    st = xp.rng_create_extstate(7, device="cpu")
    a = xp.rng_f32_seq((64,), st)
    assert a.dtype == torch.float32 and bool(((a >= 0) & (a < 1)).all())
    again = xp.rng_f32_seq((64,), xp.rng_create_extstate(7, device="cpu"))
    assert torch.equal(a, again)
    u = xp.rng_u32(st)
    assert 0 <= u < 2 ** 32 and 0 <= xp.rng_u64(st) < 2 ** 64
    assert 0.0 <= xp.rng_f64(st) < 1.0
    assert len(xp.rng_seq(13, st)) == 13 and xp.rng_seq(0, st) == b""
    seq = prng.u32_seq((1000,), st)
    assert int(seq.min()) >= 0 and int(seq.max()) < 2 ** 32
    assert abs(float(seq.double().mean()) / 2 ** 32 - 0.5) < 0.05
    sub = st.split()
    assert not torch.equal(xp.rng_f32_seq((8,), sub),
                           xp.rng_f32_seq((8,), st))
    assert xp.rng_get_extstate_size("cpu") == \
        torch.Generator().get_state().numel()
    xp.rng_set_seed(3, device="cpu")
    first = xp.rng_f32_seq((4,))
    xp.rng_set_seed(3, device="cpu")
    assert torch.equal(first, xp.rng_f32_seq((4,)))
    xp.rng_destroy_extstate(st)
    assert st.generator is None
    # the JAX package keeps the same names
    for n in ("rng_create_extstate", "rng_f32_seq", "rng_get_extstate_size",
              "rng_u32", "rng_u64", "rng_f64", "rng_seq", "rng_set_seed",
              "RngState", "lsfr_i32"):
        assert hasattr(xt, n) and hasattr(xp, n)
