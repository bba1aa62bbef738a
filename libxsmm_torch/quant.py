"""Low-precision float conversion and quantization.

The port of `libxsmm_tpu/quant.py` (itself the semantics port of the
reference's src/libxsmm_lpflt_quant.c): f32 <-> bf16/f16/bf8/hf8 under RNE,
truncation, round-nearest-away and stochastic rounding; i16/i8 quantization
with the scale-factor search; the MX (microscaling, OCP MX v1.0) block
formats as (packed uint8 payload, scales) pairs; the sub-byte integer GEMM
payloads. Every function is torch ops, as the JAX package's are jnp, and
gives the JAX package's payload and scale bytes bit for bit.

Arithmetic notes, so that the bytes agree:
  * bf16 results are built from f32 bits in integer arithmetic (RNE, or the
    reference converters' DAZ + NaN quieting). torch's own f32 -> bf16 cast
    turns every NaN into 0xFFFF, the JAX package's into 0x7FC0 | sign.
  * The JAX package's arithmetic runs with f32 subnormals flushed to zero
    (XLA on the CPU, and the TPU): the E8M0 scale code 0 (2^-127) decodes to
    0, so a block whose amax has a zero biased exponent divides by 0 (its
    payload becomes the NaN/Inf codes), and subnormal inputs and products
    are zero. `_ftz` reproduces this where a subnormal can arise.
  * Powers of two (MX scales) are computed exactly. XLA's exp2 on the CPU
    is exact only for small exponents (about |e| <= 12), so an MX
    dequantization with a scale outside that range can differ from the JAX
    package's in the last bits of the f32 result (ROADMAP.md queue 3).

Stochastic rounding (`stochastic_convert_fp32_bf16/bf8`) goes through
kernels/eltwise.stochastic_round: the hand-written CUDA kernel on CUDA
tensors, its plain torch version on CPU tensors.

Device: tensors stay on their device; anything else is loaded from numpy
onto `device` (default: the GPU, raising without one).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .device import resolve_device
from .dtypes import Datatype
from .kernels.eltwise import _bits32 as _bits, _from_bits, stochastic_round

_FLT_MIN = float(np.finfo(np.float32).tiny)     # 2^-126


def _tensor(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))


def _f32(x, device=None) -> torch.Tensor:
    return _tensor(x, device).to(torch.float32)


def _from_u16(b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A 16-bit float tensor from its bits held in int64."""
    b = torch.where(b >= 2 ** 15, b - 2 ** 16, b)
    return b.to(torch.int16).view(dtype)


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """x with f32 subnormals flushed to signed zero (the JAX package's
    arithmetic; see the module docstring)."""
    return torch.where(torch.abs(x) < _FLT_MIN, x * 0.0, x)


def _bf16_rne_f32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (RNE) and kept in f32, as XLA's f32 -> bf16 cast
    rounds: NaN becomes the quiet 0x7FC0 | sign, subnormals round too."""
    b = _bits(x)
    nan = (b & 0x7FFFFFFF) > 0x7F800000
    r = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    r = torch.where(nan, (b & 0x80000000) | 0x7FC00000, r)
    return _from_bits(r)


# ---------------------------------------------------------------------------
# scalar-format conversions (libxsmm_rne_convert_* / truncate_*)
# ---------------------------------------------------------------------------

def _bf16_round_bits_prep(x, device=None):
    """Shared edge handling of the reference bf16 converters
    (libxsmm_convert_f32_to_bf16_{truncate,rnaz}, src/libxsmm_math.c:
    646-682): DAZ (denormals flush to signed zero) and a non-finite mask so
    Inf/NaN are never rounded (NaN payloads get the quiet bit 0x00400000).
    Returns (bits held in int64, nonfinite_mask)."""
    bits = _bits(_f32(x, device))
    denorm = (bits & 0x7F800000) == 0
    bits = torch.where(denorm, bits & 0x80000000, bits)
    nonfinite = (bits & 0x7F800000) == 0x7F800000
    is_nan = nonfinite & ((bits & 0x007FFFFF) != 0)
    bits = torch.where(is_nan, bits | 0x00400000, bits)
    return bits, nonfinite


def rne_convert_fp32_bf16(x, *, device=None):
    """Round-to-nearest-even f32 -> bf16 (libxsmm_rne_convert_fp32_bf16),
    with the reference's DAZ prologue (libxsmm_math.c:684-703)."""
    bits, nonfinite = _bf16_round_bits_prep(x, device)
    rounded = bits + 0x7FFF + ((bits >> 16) & 1)
    bits = torch.where(nonfinite, bits, rounded)
    return _from_u16((bits >> 16) & 0xFFFF, torch.bfloat16)


def truncate_convert_fp32_bf16(x, *, device=None):
    """Truncation mode: drop the low 16 bits (DAZ; Inf/NaN pass through
    unrounded with NaN quieted, libxsmm_convert_f32_to_bf16_truncate)."""
    bits, _ = _bf16_round_bits_prep(x, device)
    # the JAX package casts the truncated f32 to bf16, which canonicalizes
    # a NaN to 0x7FC0 | sign
    return _from_u16(_bits(_bf16_rne_f32(_from_bits(bits & 0xFFFF0000)))
                     >> 16, torch.bfloat16)


def rnaz_convert_fp32_bf16(x, *, device=None):
    """Round-nearest-away-from-zero f32 -> bf16
    (libxsmm_rnaz_convert_fp32_bf16, src/libxsmm_lpflt_quant.c:236): DAZ,
    then add 0x8000 to the magnitude bits and truncate — except Inf/NaN,
    which are never rounded (NaN quieted)."""
    bits, nonfinite = _bf16_round_bits_prep(x, device)
    bits = torch.where(nonfinite, bits, bits + 0x8000) & 0xFFFF0000
    return _from_u16(_bits(_bf16_rne_f32(_from_bits(bits))) >> 16,
                     torch.bfloat16)


def stochastic_convert_fp32_bf16(x, seed=0, *, device=None):
    """libxsmm_stochastic_convert_fp32_bf16: exact stochastic rounding onto
    bf16 (kernels/eltwise.stochastic_round)."""
    return stochastic_round(_f32(x, device), seed, Datatype.BF16)


def rne_convert_fp32_bf8(x, *, device=None):
    """f32 -> e5m2 via double rounding through f16, the reference's convert
    path (f32 -> f16 -> bf8). NaN carries the reference's payload: the f16
    quiet pattern 0x7E00 >> 8 = 0x7E | sign."""
    xf = _f32(x, device)
    u = xf.to(torch.float16).to(torch.float8_e5m2).view(torch.uint8)
    sign = ((_bits(xf) >> 31) << 7).to(torch.uint8)
    u = torch.where(torch.isnan(xf), sign | 0x7E, u)
    return u.view(torch.float8_e5m2)


def _to_e4m3fn(x: torch.Tensor) -> torch.Tensor:
    """x (f32) -> e4m3fn, round to nearest even, past 464 NaN (0x7F | sign,
    e4m3fn has no Inf), as the JAX package's cast. torch's own cast
    saturates to 448 in some versions, so the overflow is set here."""
    u = x.to(torch.float8_e4m3fn).view(torch.uint8)
    sign = ((_bits(x) >> 31) << 7).to(torch.uint8)
    u = torch.where(torch.abs(x) > 464.0, sign | 0x7F, u)
    return torch.where(torch.isnan(x), sign | 0x7F, u).view(
        torch.float8_e4m3fn)


def rne_convert_fp32_hf8(x, *, device=None):
    """f32 -> e4m3fn via the reference's f16 intermediate (double rounding,
    libxsmm_convert_f32_to_hf8_rne = f32 -> f16 -> hf8)."""
    return _to_e4m3fn(_f32(x, device).to(torch.float16).to(torch.float32))


def convert_bf8_fp32(x, *, device=None):
    return _tensor(x, device).to(torch.float32)


def convert_hf8_fp32(x, *, device=None):
    return _tensor(x, device).to(torch.float32)


def stochastic_convert_fp32_bf8(x, seed=0, *, device=None):
    """libxsmm_stochastic_convert_fp32_bf8: stochastic rounding onto e5m2
    (kernels/eltwise.stochastic_round)."""
    return stochastic_round(_f32(x, device), seed, Datatype.BF8)


def convert_fp32_f16(x, *, device=None):
    """libxsmm_convert_f32_to_f16 (RNE, the only f16 mode)."""
    return _f32(x, device).to(torch.float16)


def convert_f16_fp32(x, *, device=None):
    """libxsmm_convert_f16_to_f32."""
    return _tensor(x, device).to(torch.float32)


def convert_bf16_fp32(x, *, device=None):
    """libxsmm_convert_bf16_to_f32 (exact widening)."""
    return _tensor(x, device).to(torch.float32)


def rne_convert_f16_hf8(x, *, device=None):
    """libxsmm_convert_f16_to_hf8_rne: f16 -> e4m3fn through f32 (widening
    is exact, so the only rounding is the final RNE onto e4m3)."""
    return _to_e4m3fn(_tensor(x, device).to(torch.float16).to(
        torch.float32))


# ---------------------------------------------------------------------------
# integer quantization with scale search (libxsmm_quantize_i16 semantics:
# find the exponent that maps the absmax into range, round via rint)
# ---------------------------------------------------------------------------

def _quantize_int(x, limit: float, lo: int, hi: int, dtype, name: str,
                  device):
    x = _f32(x, device)
    absmax = float(torch.max(torch.abs(x))) if x.numel() else 0.0
    if absmax == 0.0:
        return torch.zeros(x.shape, dtype=dtype, device=x.device), 0
    if not np.isfinite(absmax):
        raise ValueError(f"{name}: input contains NaN/Inf")
    # largest scf with absmax * 2^scf <= limit
    scf = int(np.floor(np.log2(limit / absmax)))
    q = torch.round(x * (2.0 ** scf))
    return torch.clamp(q, lo, hi).to(dtype), scf


def quantize_i16(x, *, device=None) -> Tuple[torch.Tensor, int]:
    """Returns (q_i16, scf) with x ~= q * 2^-scf."""
    return _quantize_int(x, 32767.0, -32768, 32767, torch.int16,
                         "quantize_i16", device)


def dequantize_i16(q, scf: int, *, device=None):
    return _tensor(q, device).to(torch.float32) * (2.0 ** -scf)


def quantize_i8(x, *, device=None) -> Tuple[torch.Tensor, int]:
    return _quantize_int(x, 127.0, -128, 127, torch.int8, "quantize_i8",
                         device)


# ---------------------------------------------------------------------------
# MX microscaling block formats (OCP MX v1.0): block=32, E8M0 shared scale
# ---------------------------------------------------------------------------

MX_BLOCK = 32

# (exp_bits, mant_bits) per OCP MX element format
_MX_FORMATS = {
    "mxfp4": (2, 1),    # E2M1
    "mxfp6_e2m3": (2, 3),
    "mxfp6_e3m2": (3, 2),
    "mxfp8_e4m3": (4, 3),
    "mxfp8_e5m2": (5, 2),
}


@functools.lru_cache(maxsize=None)
def _format_grid(fmt: str) -> np.ndarray:
    """All non-negative representable values of the element format."""
    e_bits, m_bits = _MX_FORMATS[fmt]
    bias = 2 ** (e_bits - 1) - 1
    vals = [0.0]
    for e in range(2 ** e_bits):
        for m in range(2 ** m_bits):
            if e == 0:   # subnormals
                v = (m / 2 ** m_bits) * 2.0 ** (1 - bias)
            else:
                v = (1 + m / 2 ** m_bits) * 2.0 ** (e - bias)
            vals.append(v)
    return np.unique(np.asarray(vals, np.float64))


def _grid(fmt: str, device) -> torch.Tensor:
    return torch.as_tensor(_format_grid(fmt), dtype=torch.float32,
                           device=device)


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e for integer-valued e, exact (subnormal results flushed)."""
    return _ftz(torch.ldexp(torch.ones_like(e, dtype=torch.float32),
                            e.to(torch.int32)))


def _round_to_grid(x, grid: np.ndarray):
    """Round |x| to the nearest grid point (ties toward the smaller index),
    keep the sign."""
    g = torch.as_tensor(grid, dtype=torch.float32, device=x.device)
    ax = torch.abs(x)
    idx = torch.searchsorted(g, ax.contiguous())
    idx = torch.clamp(idx, 1, len(grid) - 1)
    lo, hi = g[idx - 1], g[idx]
    mag = torch.where((ax - lo) > (hi - ax), hi, lo)
    # jnp.sign(NaN) is NaN, torch.sign(NaN) is 0
    return torch.where(torch.isnan(x), x, torch.sign(x) * mag)


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    n = x.shape[-1]
    if n % block:
        raise ValueError(f"last dim {n} not divisible by {block}")
    return x.reshape(*x.shape[:-1], n // block, block)


def mx_quantize(x, fmt: str = "mxfp8_e4m3", block: int = MX_BLOCK, *,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize along the LAST axis in blocks: returns (elements_f32,
    scales_e8m0_exponents_i32). Elements are grid values pre-division by
    the block scale; storage packing is a separate concern (pack_fp4)."""
    if fmt not in _MX_FORMATS:
        raise ValueError(f"unknown MX format {fmt}; "
                         f"one of {sorted(_MX_FORMATS)}")
    x = _f32(x, device)
    if x.shape[-1] % block:
        raise ValueError(f"last dim {x.shape[-1]} not divisible by "
                         f"block {block}")
    xb = _ftz(_blocks(x, block))
    absmax = torch.amax(torch.abs(xb), dim=-1, keepdim=True)
    grid = _format_grid(fmt)
    gmax = float(grid[-1])
    # shared exponent: smallest power of two with absmax/scale <= grid max
    e = torch.ceil(torch.log2(_ftz(torch.clamp_min(absmax, 1e-38)) / gmax))
    e = torch.clamp(e, -127, 127)
    q = _round_to_grid(xb / _pow2(e), grid)
    return q.reshape(x.shape), e.squeeze(-1).to(torch.int32)


def mx_dequantize(q, scales_e, block: int = MX_BLOCK, *, device=None):
    q = _f32(q, device)
    qb = _blocks(q, block)
    s = _tensor(scales_e, q.device)
    return _ftz(qb * _pow2(s)[..., None]).reshape(q.shape)


# ---------------------------------------------------------------------------
# reference-exact MX block quantizers (UNARY_QUANT MX output dtypes): ports
# of libxsmm_ref_fp32_to_{mxfp4,nvfp4,mxfp8}_block
# (generator_mateltwise_reference_impl.c:1896-2076), blocked along the LAST
# axis. MXFP4X2/NVFP4X2: two 4-bit codes per byte; E8M0 or HF8 scale byte
# per block.
# ---------------------------------------------------------------------------

# E2M1 magnitude grid (code 0..7)
_E2M1_GRID = np.asarray([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0], np.float32)


def encode_e2m1(absval, *, device=None):
    """libxsmm_ref_encode_e2m1_abs: RNE onto the E2M1 grid with the
    reference's exact tie directions (impl.c:1870-1882); NaN -> 0x7."""
    a = _f32(absval, device)
    code = sum(c.to(torch.int32) for c in (
        a > 0.25, a >= 0.75, a > 1.25, a >= 1.75, a > 2.5, a >= 3.5,
        a > 5.0))
    return torch.where(torch.isnan(a), 7, code).to(torch.int32)


def _pack_codes_pairwise(code: torch.Tensor) -> torch.Tensor:
    """4-bit codes -> bytes, even element in the LOW nibble (:1941)."""
    lo, hi = code[..., 0::2], code[..., 1::2]
    return ((hi << 4) | lo).to(torch.uint8)


def _unpack_nibble_codes(packed: torch.Tensor) -> torch.Tensor:
    """bytes -> 4-bit codes along the last axis, LOW nibble first."""
    p = packed.to(torch.int32)
    return torch.stack([p & 0xF, (p >> 4) & 0xF], dim=-1).reshape(
        *p.shape[:-1], p.shape[-1] * 2)


def _e8m0_decode(scales) -> torch.Tensor:
    """E8M0 shared-scale decode: code 0 -> 2^-127, else 2^(e-127); one
    definition for every MX dequantizer. 2^-127 is subnormal and flushes
    to 0, as in the JAX package's arithmetic."""
    e = scales.to(torch.int32)
    return _pow2(torch.where(e == 0, -127, e - 127))


def _e8m0_shared_scale(x_blocks: torch.Tensor, elem_emax: int):
    """Shared E8M0 exponent per block: biased exponent of amax minus the
    element format's emax, clamped to [0, 254] (:1906-1925). Returns
    (scale_f32, scale_code_u8, nonfinite_mask); the scale is the divisor as
    the JAX package's arithmetic sees it (code 0's 2^-127 flushed to 0). On
    Inf/NaN amax the reference emits scale code 0xFF and fills the block
    payload with max-normal element codes; the mask lets callers apply the
    payload half of that contract."""
    amax = torch.amax(torch.abs(x_blocks), dim=-1, keepdim=True)
    bexp = (_bits(amax) >> 23) & 0xFF
    nonfinite = bexp == 0xFF
    shared = torch.clamp(bexp - elem_emax, 0, 254)
    mant = torch.where(shared == 0, 1 << 22, 0)
    scale = _ftz(_from_bits((shared << 23) | mant))
    scode = torch.where(nonfinite, 255, shared).to(torch.uint8)
    return scale, scode, nonfinite


def _sign_bit(x: torch.Tensor) -> torch.Tensor:
    return (_bits(x) >> 31).to(torch.int32)


def mxfp4_quantize_blocks(x, *, device=None):
    """f32 -> MXFP4X2: (payload u8 (..., n/2), scales_e8m0 u8 (..., n/32)).

    Port of libxsmm_ref_fp32_to_mxfp4_block (impl.c:1898-1946): E2M1
    elements, blocksize 32, E8M0 scale offset by elem_emax=2; the sign
    nibble bit comes from the INPUT's sign bit (preserves -0)."""
    x = _f32(x, device)
    n = x.shape[-1]
    xb = _blocks(x, MX_BLOCK)
    scale, scode, nonfinite = _e8m0_shared_scale(xb, elem_emax=2)
    code = (_sign_bit(xb) << 3) | encode_e2m1(torch.abs(_ftz(xb) / scale))
    # Inf/NaN amax: scale code 0xFF + payload all max-normal (0x77 bytes)
    code = torch.where(nonfinite, 7, code)
    packed = _pack_codes_pairwise(code).reshape(*x.shape[:-1], n // 2)
    return packed, scode.squeeze(-1).reshape(*x.shape[:-1], n // MX_BLOCK)


def _e2m1_values(packed: torch.Tensor) -> torch.Tensor:
    code = _unpack_nibble_codes(packed)
    mag = torch.as_tensor(_E2M1_GRID, device=packed.device)[code & 0x7]
    return torch.where((code >> 3) & 1 == 1, -mag, mag)


def mxfp4_dequantize_blocks(packed, scales, *, device=None):
    """Inverse storage transform of mxfp4_quantize_blocks -> f32."""
    packed = _tensor(packed, device)
    val = _e2m1_values(packed)
    scale = _e8m0_decode(_tensor(scales, packed.device))
    return _ftz(_blocks(val, MX_BLOCK) * scale[..., None]).reshape(val.shape)


NVFP4_BLOCK = 16


def nvfp4_quantize_blocks(x, *, device=None):
    """f32 -> NVFP4X2: (payload u8 (..., n/2), scales_hf8 u8 (..., n/16)).

    Port of libxsmm_ref_fp32_to_nvfp4_block (impl.c:1951-2012): E2M1
    elements, blocksize 16, E4M3 (HF8) scale = hf8(bf16(bf16(amax)/6));
    elements scaled by the BF16 reciprocal of the decoded scale."""
    x = _f32(x, device)
    n = x.shape[-1]
    xb = _blocks(x, NVFP4_BLOCK)
    xd = _ftz(xb)
    amax = torch.amax(torch.abs(xd), dim=-1, keepdim=True)
    rcp6 = _from_bits(torch.tensor(0x3E2A0000, device=x.device))  # bf16(1/6)
    raw = _bf16_rne_f32(_bf16_rne_f32(amax) * rcp6)
    # The reference's SCALE encoder (libxsmm_ref_float_to_hf8, impl.c:
    # 1813-1894) clamps any value needing e4m3 exponent 15 to the code 0x78
    # (which its own hf8 decode reads as 256); it never produces 0x79-0x7E.
    # Clamp the cast input (so > 464 cannot hit the e4m3fn NaN), then fold
    # every exponent-15 encoding to 0x78. NaN propagates to 0x7F.
    raw = torch.minimum(raw, torch.tensor(448.0, device=x.device))
    code_u = _to_e4m3fn(raw).view(torch.uint8)
    code_u = torch.where(torch.isnan(raw), 0x7F, code_u).to(torch.uint8)
    low = code_u & 0x7F
    exp15 = (low >= 0x78) & (low < 0x7F)
    code_u = torch.where(exp15, (code_u & 0x80) | 0x78, code_u)
    scale_f = code_u.view(torch.float8_e4m3fn).to(torch.float32)
    scale_code = torch.where(amax == 0.0, 0, code_u).to(torch.uint8)
    one = torch.ones((), device=x.device)
    rcp = _bf16_rne_f32(one / torch.where(scale_f == 0.0, one,
                                          _bf16_rne_f32(scale_f)))
    v = _bf16_rne_f32(xd * rcp)
    code = (_sign_bit(xb) << 3) | encode_e2m1(torch.abs(v))
    code = torch.where(scale_f == 0.0, 0, code)
    packed = _pack_codes_pairwise(code).reshape(*x.shape[:-1], n // 2)
    return packed, scale_code.squeeze(-1).reshape(*x.shape[:-1],
                                                  n // NVFP4_BLOCK)


def nvfp4_dequantize_blocks(packed, scales, *, device=None):
    packed = _tensor(packed, device)
    val = _e2m1_values(packed)
    scale = _tensor(scales, packed.device).to(torch.uint8).view(
        torch.float8_e4m3fn).to(torch.float32)
    return (_blocks(val, NVFP4_BLOCK) * scale[..., None]).reshape(val.shape)


def mxbf8_quantize_blocks(x, *, device=None):
    """f32 -> MXBF8: (payload bf8 (..., n), scales_e8m0 u8 (..., n/32)).

    Port of libxsmm_ref_fp32_to_mxfp8_block (impl.c:2017-2076): E5M2 (BF8)
    elements via the reference's RNE f32->bf8, blocksize 32, E8M0 scale
    offset by elem_emax=15."""
    x = _f32(x, device)
    n = x.shape[-1]
    xb = _blocks(x, MX_BLOCK)
    scale, scode, nonfinite = _e8m0_shared_scale(xb, elem_emax=15)
    q = rne_convert_fp32_bf8(_ftz(xb) / scale).view(torch.uint8)
    # Inf/NaN amax: scale code 0xFF + payload all max-normal BF8 (0x7B);
    # the JAX package's select on f8 values stores every NaN as 0x7F
    q = torch.where((q & 0x7F) > 0x7C, 0x7F, q)
    q = torch.where(nonfinite, 0x7B, q).to(torch.uint8)
    return (q.view(torch.float8_e5m2).reshape(x.shape),
            scode.squeeze(-1).reshape(*x.shape[:-1], n // MX_BLOCK))


_FP6_PARAMS = {
    # (exp_bits, mant_bits); bias = 2^(e-1)-1. BF6 = E3M2, HF6 = E2M3
    # (the reference's LUT converters, generator_gemm_reference_impl.c:
    # 73-97)
    "e2m3": (2, 3),
    "e3m2": (3, 2),
}


def fp6_decode(codes, fmt: str = "e3m2", *, device=None):
    """6-bit code (sign<<5 | exp<<m | mant, one code per byte) -> f32."""
    e_bits, m_bits = _FP6_PARAMS[fmt]
    bias = 2 ** (e_bits - 1) - 1
    c = _tensor(codes, device).to(torch.int32)
    e = (c >> m_bits) & (2 ** e_bits - 1)
    frac = (c & (2 ** m_bits - 1)).to(torch.float32) / (2 ** m_bits)
    mag = torch.where(e == 0, frac * 2.0 ** (1 - bias),
                      (1.0 + frac) * _pow2(e - bias))
    return torch.where((c >> (e_bits + m_bits)) & 1 == 1, -mag, mag)


def fp6_encode(x, fmt: str = "e3m2", *, device=None):
    """f32 -> nearest 6-bit code (RNE onto the format grid, one per byte):
    at an exact grid midpoint the EVEN code of the two neighbours wins."""
    e_bits, m_bits = _FP6_PARAMS[fmt]
    grid = _format_grid("mxfp6_" + fmt)
    x = _f32(x, device)
    g = _grid("mxfp6_" + fmt, x.device)
    mag = torch.clamp(torch.abs(x), 0.0, float(grid[-1]))
    idx = torch.argmin(torch.abs(mag[..., None] - g), dim=-1)
    # argmin ties to the lower grid point; at an exact midpoint take the
    # higher neighbour iff the lower code is odd
    idx_hi = torch.clamp_max(idx + 1, len(grid) - 1)
    tie = (mag - g[idx] == g[idx_hi] - mag) & (mag > g[idx])
    idx = torch.where(tie & (idx % 2 == 1), idx_hi, idx)
    sign = _sign_bit(x) << (e_bits + m_bits)
    return (sign | idx.to(torch.int32)).to(torch.uint8)


_FP6_EMAX = {"e2m3": 2, "e3m2": 4}   # floor(log2(grid max)): 7.5 / 28


def mxfp6_quantize_blocks(x, fmt: str = "e3m2", *, device=None):
    """f32 -> MXBF6/MXHF6: (codes u8 (..., n), scales_e8m0 u8 (..., n/32)).

    E8M0 shared scale per 32-block in the mxfp4/mxfp8 pattern with the
    format's elem_emax; one 6-bit code per byte (the reference's
    3-bytes-per-4-values packing is an ISA storage detail, docs/PARITY.md)."""
    x = _f32(x, device)
    n = x.shape[-1]
    xb = _blocks(x, MX_BLOCK)
    scale, scode, nonfinite = _e8m0_shared_scale(xb,
                                                 elem_emax=_FP6_EMAX[fmt])
    codes = fp6_encode(_ftz(xb) / scale, fmt)
    # Inf/NaN amax: scale code 0xFF + payload all max-normal (5-bit 0x1F)
    codes = torch.where(nonfinite, 0x1F, codes).to(torch.uint8)
    return (codes.reshape(x.shape),
            scode.squeeze(-1).reshape(*x.shape[:-1], n // MX_BLOCK))


def mxfp6_dequantize_blocks(codes, scales, fmt: str = "e3m2", *,
                            device=None):
    v = fp6_decode(codes, fmt, device=device)
    scale = _e8m0_decode(_tensor(scales, v.device))
    return _ftz(_blocks(v, MX_BLOCK) * scale[..., None]).reshape(v.shape)


def mxbf8_dequantize_blocks(payload, scales, *, device=None):
    v = _tensor(payload, device).to(torch.float32)
    scale = _e8m0_decode(_tensor(scales, v.device))
    return _ftz(_blocks(v, MX_BLOCK) * scale[..., None]).reshape(v.shape)


# ---------------------------------------------------------------------------
# sub-byte integer GEMM payloads
# ---------------------------------------------------------------------------

def unpack_subbyte_gemm(dt, packed, *, device=None):
    """Decode a packed sub-byte integer GEMM operand along the LAST axis.

    Value semantics follow the reference GEMM impl:
      * I4X2: two sign-extended nibbles per byte, low nibble first;
      * U4X2: unsigned nibbles;
      * I2X4: four 2-bit TERNARY codes {0:0, 1:+1, 2:-1, 3:-1}
        (unpack2bit, impl.c:19-56);
      * I1X8: eight 1-bit BINARY codes {0:+1, 1:-1} (impl.c:1199-1223).
    Returns int8 with the last dim expanded by the pack factor."""
    p = _tensor(packed, device).to(torch.int32) & 0xFF
    if dt in (Datatype.I4X2, Datatype.U4X2):
        lo, hi = p & 0xF, (p >> 4) & 0xF
        if dt == Datatype.I4X2:
            lo = torch.where(lo >= 8, lo - 16, lo)
            hi = torch.where(hi >= 8, hi - 16, hi)
        out = torch.stack([lo, hi], dim=-1)
    elif dt == Datatype.I2X4:
        codes = torch.stack([(p >> (2 * i)) & 0x3 for i in range(4)], dim=-1)
        lut = torch.tensor([0, 1, -1, -1], dtype=torch.int32,
                           device=p.device)
        out = lut[codes]
    elif dt == Datatype.I1X8:
        bits = torch.stack([(p >> i) & 1 for i in range(8)], dim=-1)
        out = torch.where(bits == 0, 1, -1)
    else:
        raise ValueError(f"not a packed sub-byte integer type: {dt}")
    return out.reshape(*p.shape[:-1], -1).to(torch.int8)


def pack_subbyte_gemm(dt, values, *, device=None):
    """Inverse of unpack_subbyte_gemm for building operands (I4X2/U4X2
    exact; I2X4/I1X8 encode by value match: 0/±1 for I2X4, ±1 for I1X8)."""
    v = _tensor(values, device).to(torch.int32)
    if dt in (Datatype.I4X2, Datatype.U4X2):
        pairs = v.reshape(*v.shape[:-1], v.shape[-1] // 2, 2) & 0xF
        return ((pairs[..., 1] << 4) | pairs[..., 0]).to(torch.uint8)
    if dt == Datatype.I2X4:
        code = torch.where(v == 0, 0, torch.where(v > 0, 1, 2))
        quads = code.reshape(*v.shape[:-1], v.shape[-1] // 4, 4)
        out = (quads[..., 0] | (quads[..., 1] << 2) | (quads[..., 2] << 4)
               | (quads[..., 3] << 6))
        return out.to(torch.uint8)
    if dt == Datatype.I1X8:
        bit = torch.where(v > 0, 0, 1)
        octs = bit.reshape(*v.shape[:-1], v.shape[-1] // 8, 8)
        return sum(octs[..., i] << i for i in range(8)).to(torch.uint8)
    raise ValueError(f"not a packed sub-byte integer type: {dt}")


# ---------------------------------------------------------------------------
# sub-byte packing (I4X2 / MXFP4X2 storage, typedefs.h:236-241)
# ---------------------------------------------------------------------------

def pack_i4x2(lo, hi, *, device=None):
    """Pack two int4 arrays (values in [-8,7]) into one uint8 array."""
    lo = _tensor(lo, device).to(torch.int32) & 0xF
    hi = _tensor(hi, lo.device).to(torch.int32) & 0xF
    return ((hi << 4) | lo).to(torch.uint8)


def unpack_i4x2(packed, *, device=None):
    p = _tensor(packed, device).to(torch.int32)
    lo, hi = p & 0xF, (p >> 4) & 0xF
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    return lo.to(torch.int8), hi.to(torch.int8)


def pack_fp4(q, fmt: str = "mxfp4", *, device=None):
    """Encode grid values (from mx_quantize) to 4-bit codes, two per byte
    along the last axis (MXFP4X2 storage layout)."""
    q = _f32(q, device)
    g = _grid(fmt, q.device)
    mag_code = torch.argmin(torch.abs(torch.abs(q)[..., None] - g), dim=-1)
    code = ((q < 0).to(torch.int32) << 3) | mag_code.to(torch.int32)
    if q.shape[-1] % 2:
        raise ValueError("need even last dim to pack pairs")
    return _pack_codes_pairwise(code)


def unpack_fp4(packed, fmt: str = "mxfp4", *, device=None):
    packed = _tensor(packed, device)
    g = _grid(fmt, packed.device)
    code = _unpack_nibble_codes(packed)
    sign = torch.where((code >> 3) & 1 == 1, -1.0, 1.0)
    return sign * g[code & 0x7]


# ---------------------------------------------------------------------------
# Reference-spelling aliases: the reference exposes the convert family under
# two public names each (libxsmm.h `*_to_*` style and the short
# include/utils/libxsmm_lpflt_quant.h style).
# ---------------------------------------------------------------------------
convert_bf16_f32 = convert_bf16_to_f32 = convert_bf16_fp32
convert_bf8_f32 = convert_bf8_to_f32 = convert_bf8_fp32
convert_f16_f32 = convert_f16_to_f32 = convert_f16_fp32
convert_hf8_f32 = convert_hf8_to_f32 = convert_hf8_fp32
convert_f32_to_f16 = rne_convert_fp32_f16 = convert_fp32_f16
convert_f32_to_bf16_rne = rne_convert_fp32_bf16
convert_f32_to_bf16_rnaz = rnaz_convert_fp32_bf16
convert_f32_to_bf16_truncate = truncate_convert_f32_bf16 = (
    truncate_convert_fp32_bf16)
convert_f32_to_bf8_rne = rne_convert_fp32_bf8
convert_f32_to_bf8_stochastic = stochastic_convert_fp32_bf8
convert_f32_to_hf8_rne = rne_convert_fp32_hf8
convert_f16_to_hf8_rne = rne_convert_f16_hf8
