"""Stateful element-wise kernels: dropout, stochastic rounding, quant.

The port of `libxsmm_tpu/kernels/eltwise_pallas.py`: the meltw ops whose
semantics need a random stream (dropout, stochastic rounding) or a
saturating integer conversion (quant).

* `dropout(x, seed, p)` -> (out, keep mask uint8) is the hand-written CUDA
  kernel of csrc/eltwise_kernels.cu on CUDA tensors (it replaces
  `_dropout_tpu`) and `dropout.plain`, the plain torch version of the same
  function, on CPU tensors. Its random bits are a stateless counter hash of
  (seed, flat index), the flash kernel's `_rand_bits` avalanche, so kernel
  and plain agree bit for bit; they are not the TPU's bits, nor jax.random's
  (the reference does not promise the same bits across backends either,
  eltwise_pallas.py:12-14).
* `stochastic_round` runs its plain version on CPU tensors; on CUDA tensors
  it raises until its kernel lands (ROADMAP.md queue 2, item 5).
* `dropout_inv`, `quant`, `dequant` and `run_stateful_unary` are torch ops,
  as the reference's are jnp.

`launches` counts kernel launches, and only those.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..descriptor import MeltwDescriptor, UnaryFlags, UnaryType
from ..dtypes import Datatype, to_torch
from .attention import _M32, _rand_bits
from .gemm import _on_cuda, _ptr, _raise_on_error, _stream

launches = {"dropout": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


_TYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_lib = None


def _kernels() -> ctypes.CDLL:
    """The CUDA library, built and loaded on first use."""
    global _lib
    if _lib is None:
        from . import _build
        lib = _build.load("eltwise_kernels")
        P, I, LL, F, U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float, ctypes.c_uint)
        lib.xsmm_dropout.argtypes = [P, P, P, LL, I, F, F, U, I, I, P]
        lib.xsmm_dropout.restype = I
        lib.xsmm_error_string.argtypes = [I]
        lib.xsmm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _flat_bits(seed, shape, device) -> torch.Tensor:
    """u32 bits (in int64) per element of `shape`: the counter hash of
    (seed, flat row-major index), with the index's low and high 32 bits as
    the hash's row and column (csrc/eltwise_kernels.cu drop_one)."""
    n = int(np.prod(shape, dtype=np.int64))
    i = torch.arange(n, dtype=torch.int64, device=device)
    return _rand_bits(int(seed), 0, i & _M32, i >> 32).reshape(shape)


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    """u in [0, 1) from u32 bits by the mantissa fill (eltwise_pallas.py:
    121-122): exponent 127 over the top 23 bits, minus 1."""
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fbits.view(torch.float32) - 1.0


def _check_p(p) -> float:
    p = float(p)
    if not 0.0 <= p < 1.0:
        # the 1/(1-p) rescale is undefined at p=1
        raise ValueError(f"dropout probability must be in [0, 1), got {p}")
    return p


# ---------------------------------------------------------------------------
# stochastic rounding
# ---------------------------------------------------------------------------

def _sr_bf16_bits(x: torch.Tensor, rand: torch.Tensor) -> torch.Tensor:
    """Exact stochastic round f32->bf16 by add-random-truncate
    (eltwise_pallas.py:41): bf16 is a truncation of f32."""
    bits = x.float().view(torch.int32).to(torch.int64) & _M32
    bits = ((bits + (rand & 0xFFFF)) & 0xFFFF0000)
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32).to(torch.bfloat16)


def stochastic_round(x: torch.Tensor, seed, target: Datatype):
    """UNARY_STOCHASTIC_ROUND (typedefs.h:316 op 38). CPU tensors only: the
    CUDA kernel is ROADMAP.md queue 2, item 5."""
    if x.device.type == "cuda":
        raise NotImplementedError(
            "stochastic rounding has no CUDA kernel yet (ROADMAP.md queue 2,"
            " item 5: the port of _sr_tpu, eltwise_pallas.py:50)")
    tdt = to_torch(target)
    rand = _flat_bits(seed, tuple(x.shape), x.device)
    if tdt == torch.bfloat16:
        return _sr_bf16_bits(x, rand)
    # the reference's portable approximation for non-truncation targets
    # (f16/f8): dither by one target ulp of uniform noise, then round to
    # nearest even
    mant = {torch.float16: 10, torch.float8_e5m2: 2,
            torch.float8_e4m3fn: 3}.get(tdt, 10)
    u = _uniform(rand) - 0.5
    xf = x.float()
    scale = torch.exp2(torch.floor(torch.log2(
        torch.clamp_min(torch.abs(xf), 1e-30))) - mant)
    return (xf + u * scale).to(tdt)


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------

def _p_and_scale(p: float):
    """p and 1/(1-p) in f32, the reference kernel's arithmetic (p rides as
    an f32 operand, eltwise_pallas.py:126-128)."""
    p32 = np.float32(p)
    return p32, np.float32(1.0) / (np.float32(1.0) - p32)


def _dropout_plain(x: torch.Tensor, seed, p):
    """The plain torch version of the dropout kernel: the same bits, the
    same keep rule and the same f32 arithmetic."""
    p32, scale = _p_and_scale(_check_p(p))
    keep = _uniform(_flat_bits(seed, tuple(x.shape), x.device)) >= float(p32)
    scaled = x.float() * torch.tensor(scale, device=x.device)
    out = torch.where(keep, scaled, torch.zeros((), device=x.device))
    return out.to(x.dtype), keep.to(torch.uint8)


def dropout(x: torch.Tensor, seed, p):
    """UNARY_DROPOUT: returns (out, keep_mask uint8). Keeps an element iff
    u >= p and scales it by 1/(1-p); p is a runtime value (a float or a
    0-d tensor). CUDA tensors (f32, bf16, f16) launch the kernel; CPU
    tensors run dropout.plain."""
    p = _check_p(p)
    if not _on_cuda(x):
        return _dropout_plain(x, seed, p)
    code = _TYPE_CODE.get(x.dtype)
    if code is None:
        raise ValueError(f"dropout: no CUDA kernel for dtype {x.dtype}")
    x = x.contiguous()
    out = torch.empty_like(x)
    mask = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    p32, scale = _p_and_scale(p)
    lib = _kernels()
    props = torch.cuda.get_device_properties(x.device)
    with torch.cuda.device(x.device):
        err = lib.xsmm_dropout(
            _ptr(x), _ptr(out), _ptr(mask), x.numel(), code, float(p32),
            float(scale), int(seed) & _M32, int(x.data_ptr() % 16 == 0),
            props.multi_processor_count, _stream(x.device))
    _raise_on_error(err, "dropout", lib)
    launches["dropout"] += 1
    return out, mask


dropout.plain = _dropout_plain


def dropout_inv(g: torch.Tensor, mask: torch.Tensor, p):
    """UNARY_DROPOUT_INV: apply the saved keep-mask to the gradient,
    rescaled by 1/(1-p) (generator_mateltwise_reference_impl.c:2408-2424).

    `mask` is the PACKED bitmask the forward emitted (reference
    param->in.secondary bit layout); a same-shaped per-element mask is also
    accepted."""
    from ..ops.eltwise import unpack_bitmask
    p = _check_p(p)
    m, n = g.shape
    if tuple(mask.shape) == tuple(g.shape):
        bits = mask != 0
    else:
        bits = unpack_bitmask(mask, m, n)
    scale = 1.0 / (1.0 - p)
    out = torch.where(bits, g.float() * scale,
                      torch.zeros((), device=g.device))
    return out.to(g.dtype)


# ---------------------------------------------------------------------------
# quant / dequant
# ---------------------------------------------------------------------------

_INT_RANGE = {
    torch.int8: (-128, 127),
    torch.int16: (-32768, 32767),
    torch.int32: (-(2 ** 31), 2 ** 31 - 1),
    torch.uint8: (0, 255),
    torch.uint16: (0, 65535),
}


def quant(x: torch.Tensor, scale, out_dtype: torch.dtype, *,
          stochastic: bool = False, seed: int = 0, sign_sat: bool = False,
          skip_scf: bool = False):
    """UNARY_QUANT (typedefs.h op 42): q = round(x * scale), stored per the
    reference's flag semantics (generator_mateltwise_reference_impl.c:
    2197-2258):

      * skip_scf (NO_SCF_QUANT): ignore the scale operand, scf = 1.0;
      * sign_sat (SIGN_SAT_QUANT): saturate to the target's signed range;
      * default: C-truncation wraparound — the LOW BYTES of the rounded
        integer, not a clamp.

    `scale` may be a scalar or a per-column/row vector. Rounding is
    round-half-even. The stochastic variant dithers with the counter hash
    of (seed, flat index), not jax.random: statistical parity only."""
    sc = 1.0 if skip_scf else scale
    if isinstance(sc, np.ndarray):
        sc = torch.as_tensor(sc, device=x.device)
    xs = x.float() * sc
    if stochastic:
        xs = xs + _uniform(_flat_bits(seed, tuple(xs.shape), xs.device)) - 0.5
        q = torch.floor(xs + 0.5)
    else:
        q = torch.round(xs)              # round half to even, as rint()
    if out_dtype not in _INT_RANGE:
        raise ValueError(f"quant: unsupported integer target {out_dtype}")
    lo, hi = _INT_RANGE[out_dtype]
    if sign_sat or out_dtype in (torch.int32, torch.uint8, torch.uint16):
        # i32 has no narrower intermediate to wrap through; unsigned targets
        # keep the reference's clip
        return torch.clamp(q.double(), lo, hi).to(out_dtype)
    # wraparound: rounded f32 -> i32 (saturating, NaN -> 0, as XLA converts)
    # -> low bytes (a modular narrowing)
    qi = torch.nan_to_num(q.double(), nan=0.0).clamp(-(2 ** 31), 2 ** 31 - 1)
    return qi.to(torch.int32).to(out_dtype)


def dequant(q: torch.Tensor, scale, out_dtype: torch.dtype = torch.float32):
    """UNARY_DEQUANT (typedefs.h op 43)."""
    if isinstance(scale, np.ndarray):
        scale = torch.as_tensor(scale, device=q.device)
    return (q.float() * scale).to(out_dtype)


# ---------------------------------------------------------------------------
# dispatcher hook used by ops/eltwise.py
# ---------------------------------------------------------------------------

_MX = (Datatype.MXFP4X2, Datatype.NVFP4X2, Datatype.MXBF8)


def _mx_not_ported(what: str):
    return NotImplementedError(
        f"MX block {what} is not ported yet (ROADMAP.md queue 1, item 8: "
        "quant, MX and sub-byte operands)")


def run_stateful_unary(desc: MeltwDescriptor, x, *args, **state):
    op = desc.op_type
    if op == UnaryType.STOCHASTIC_ROUND:
        seed = state.get("seed", args[0] if args else 0)
        target = (desc.out_type if desc.out_type != Datatype.IMPLICIT
                  else Datatype.BF16)
        return stochastic_round(x, seed, target)
    if op == UnaryType.DROPOUT:
        p = state.get("p", desc.extra[0] if desc.extra else 0.5)
        # a positional seed is accepted as for STOCHASTIC_ROUND
        seed = state.get("seed", args[0] if args else 0)
        out, mask = dropout(x, seed, p)
        if desc.flags & UnaryFlags.BITMASK_2BYTEMULT:
            # reference contract: the side output is a PACKED bit matrix
            # with UPDIV(ldo,16)*16-bit row stride
            from ..ops.eltwise import pack_bitmask
            return out, pack_bitmask(mask != 0, two_byte_mult=True)
        return out
    if op == UnaryType.DROPOUT_INV:
        p = state.get("p", desc.extra[0] if desc.extra else 0.5)
        (mask,) = args
        return dropout_inv(x, mask, p)
    if op == UnaryType.QUANT:
        if desc.out_type in _MX:
            raise _mx_not_ported("quantization")
        scale = args[0] if args else state.get("scale", 1.0)
        odt = to_torch(desc.out_type if desc.out_type != Datatype.IMPLICIT
                       else Datatype.I8)
        return quant(x, scale, odt,
                     stochastic=bool(desc.flags & UnaryFlags.STOCHASTIC_ROUND),
                     seed=state.get("seed", 0),
                     sign_sat=bool(desc.flags & UnaryFlags.SIGN_SAT_QUANT),
                     skip_scf=bool(desc.flags & UnaryFlags.NO_SCF_QUANT))
    if op == UnaryType.DEQUANT:
        if desc.in_type in _MX:
            raise _mx_not_ported("dequantization")
        scale = args[0] if args else state.get("scale", 1.0)
        if desc.flags & UnaryFlags.NO_SCF_QUANT:
            scale = 1.0
        odt = to_torch(desc.out_type if desc.out_type != Datatype.IMPLICIT
                       else Datatype.F32)
        return dequant(x, scale, odt)
    raise NotImplementedError(f"stateful unary {op}")
