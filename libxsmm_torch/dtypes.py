"""Datatype model.

Mirrors the reference's `libxsmm_datatype` enumeration
(include/libxsmm_typedefs.h:218-246) onto torch dtypes; the counterpart of
`libxsmm_tpu/dtypes.py` with `to_torch`/`from_torch` in place of
`to_jnp`/`from_jnp`.

Mapping policy:
  * F64/F32/BF16/F16/I64/U64/I32/U32/I16/U16/I8/U8 are native torch dtypes.
  * BF8 == float8_e5m2, HF8 == float8_e4m3fn (the reference's BF8/HF8 bit
    layouts).
  * BF32 (the tf32-like 19-bit mode) is a *compute* precision: float32
    storage.
  * MX* microscaling and sub-byte packed types have no native storage; they
    travel as (packed-uint8 payload, scale) pairs and `to_torch` raises.
"""

from __future__ import annotations

import enum

import torch


class Datatype(enum.Enum):
    """Element types; order and names follow the reference enum."""

    F64 = "f64"
    F32 = "f32"
    BF16 = "bf16"
    F16 = "f16"
    BF8 = "bf8"
    HF8 = "hf8"
    I64 = "i64"
    U64 = "u64"
    I32 = "i32"
    U32 = "u32"
    I16 = "i16"
    U16 = "u16"
    I8 = "i8"
    U8 = "u8"
    MXBF8 = "mxbf8"
    MXHF8 = "mxhf8"
    MXBF6 = "mxbf6"
    MXHF6 = "mxhf6"
    I4X2 = "i4x2"
    U4X2 = "u4x2"
    MXFP4X2 = "mxfp4x2"
    NVFP4X2 = "nvfp4x2"
    I2X4 = "i2x4"
    I1X8 = "i1x8"
    BF32 = "bf32"
    IMPLICIT = "implicit"

    def __repr__(self) -> str:  # terse keys in kernel names
        return self.value


_TORCH = {
    Datatype.F64: torch.float64,
    Datatype.F32: torch.float32,
    Datatype.BF16: torch.bfloat16,
    Datatype.F16: torch.float16,
    Datatype.BF8: torch.float8_e5m2,
    Datatype.HF8: torch.float8_e4m3fn,
    Datatype.I64: torch.int64,
    Datatype.U64: torch.uint64,
    Datatype.I32: torch.int32,
    Datatype.U32: torch.uint32,
    Datatype.I16: torch.int16,
    Datatype.U16: torch.uint16,
    Datatype.I8: torch.int8,
    Datatype.U8: torch.uint8,
    Datatype.BF32: torch.float32,  # storage f32; BF32 names the compute mode
}

# Bits per element (sub-byte packed types report their true element width).
_BITS = {
    Datatype.F64: 64, Datatype.I64: 64, Datatype.U64: 64,
    Datatype.F32: 32, Datatype.I32: 32, Datatype.U32: 32, Datatype.BF32: 32,
    Datatype.BF16: 16, Datatype.F16: 16, Datatype.I16: 16, Datatype.U16: 16,
    Datatype.BF8: 8, Datatype.HF8: 8, Datatype.I8: 8, Datatype.U8: 8,
    Datatype.MXBF8: 8, Datatype.MXHF8: 8,
    Datatype.MXBF6: 6, Datatype.MXHF6: 6,
    Datatype.I4X2: 4, Datatype.U4X2: 4, Datatype.MXFP4X2: 4,
    Datatype.NVFP4X2: 4, Datatype.I2X4: 2, Datatype.I1X8: 1,
}

_FROM_TORCH = {v: k for k, v in _TORCH.items() if k is not Datatype.BF32}


def to_torch(dt: "Datatype") -> torch.dtype:
    """torch dtype for a natively-representable Datatype; raises otherwise."""
    try:
        return _TORCH[dt]
    except KeyError:
        raise ValueError(
            f"Datatype {dt} has no native torch storage; microscaling and "
            f"sub-byte types travel as (packed payload, scales) pairs."
        ) from None


def from_torch(dtype: torch.dtype) -> "Datatype":
    return _FROM_TORCH[dtype]


def is_native(dt: "Datatype") -> bool:
    return dt in _TORCH


def bits(dt: "Datatype") -> int:
    return _BITS[dt]


def itemsize(dt: "Datatype") -> int:
    return max(1, _BITS[dt] // 8)


def typesize(dt: "Datatype") -> int:
    """Alias mirroring LIBXSMM_TYPESIZE."""
    return itemsize(dt)


def get_typename(dt: "Datatype") -> str:
    """libxsmm_get_typename analogue (include/libxsmm.h:77)."""
    return Datatype(dt).value
