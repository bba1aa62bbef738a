"""Stateful element-wise kernels: dropout, stochastic rounding, quant.

The port of `libxsmm_tpu/kernels/eltwise_pallas.py`: the meltw ops whose
semantics need a random stream (dropout, stochastic rounding) or a
saturating integer conversion (quant).

* `dropout(x, seed, p, mask="bytes")` -> (out, keep mask) is the
  hand-written CUDA kernel of csrc/eltwise_kernels.cu on CUDA tensors (it
  replaces `_dropout_tpu`) and `dropout.plain`, the plain torch version of
  the same function, on CPU tensors. The kernel writes the mask in the
  form asked for: "bytes", one uint8 per element (the encoder block's
  _Dropout saves it); "packed", the reference's BITMASK_2BYTEMULT bit
  matrix of a 2-D x (ops/eltwise.py pack_bitmask's layout), which the
  meltw DROPOUT with that flag returns; "none", out alone, for the meltw
  DROPOUT without it. Its random bits are a stateless counter hash of
  (seed, flat index), the flash kernel's `_rand_bits` avalanche, so kernel
  and plain agree bit for bit; they are not the TPU's bits, nor jax.random's
  (the reference does not promise the same bits across backends either,
  eltwise_pallas.py:12-14).
* `stochastic_round(x, seed, target)` is exact stochastic rounding onto
  bf16, f16, bf8 or hf8: the kernel of csrc/eltwise_kernels.cu on CUDA
  tensors (it replaces `_sr_tpu`), `stochastic_round.plain` on CPU tensors,
  with the same counter-hash bits, so the two agree bit for bit.
* `dropout_inv`, `quant`, `dequant` and `run_stateful_unary` are torch ops,
  as the reference's are jnp; MX QUANT/DEQUANT go to the block quantizers
  of libxsmm_torch/quant.py.

`launches` counts kernel launches, and only those.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..descriptor import MeltwDescriptor, UnaryFlags, UnaryType
from ..dtypes import Datatype, to_torch
from .attention import _M32, _rand_bits
from .gemm import (_num_sms, _on_cuda, _on_device, _ptr, _raise_on_error,
                   _stream)

launches = {"dropout": 0, "stochastic_round": 0}
# the source behind each counter and the CUDA kernels its launches run, by
# name (lowering.py files each logged entry under its counter)
ENTRIES = {"dropout": ("eltwise_kernels", (
               "dropout_kernel", "dropout_packed_kernel",
               "dropout_block_kernel")),
           "stochastic_round": ("eltwise_kernels", ("sr_kernel",))}


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
        lib.xsmm_dropout.argtypes = [P, P, P, LL, I, I, I, F, F, U, I, I, P]
        lib.xsmm_dropout.restype = I
        lib.xsmm_dropout_block.argtypes = [P, P, P, LL, I, I, F, F, U, I, I,
                                           P, P, P, I, P]
        lib.xsmm_dropout_block.restype = I
        lib.xsmm_stochastic_round.argtypes = [P, P, LL, I, I, U, I, I, P]
        lib.xsmm_stochastic_round.restype = I
        lib.xsmm_error_string.argtypes = [I]
        lib.xsmm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _flat_bits(seed, shape, device, block=None) -> torch.Tensor:
    """u32 bits (in int64) per element of `shape`: the counter hash of
    (seed, flat row-major index), with the index's low and high 32 bits as
    the hash's row and column (csrc/eltwise_kernels.cu drop_one). With a
    block (global_shape, offset) the tensor of `shape` is that block of a
    global tensor, and the index hashed is the element's global one."""
    if block is None:
        n = int(np.prod(shape, dtype=np.int64))
        i = torch.arange(n, dtype=torch.int64, device=device)
    else:
        gshape, off = _check_block(block, shape)
        i = torch.zeros((), dtype=torch.int64, device=device)
        stride = 1
        for d in reversed(range(len(shape))):
            idx = off[d] + torch.arange(shape[d], dtype=torch.int64,
                                        device=device)
            i = i + (idx * stride).reshape(
                (-1,) + (1,) * (len(shape) - 1 - d))
            stride *= gshape[d]
        i = i.expand(tuple(shape))
    return _rand_bits(int(seed), 0, i & _M32, i >> 32).reshape(shape)


def _check_block(block, shape):
    """(global_shape, offset) of a dropout block, checked against the
    block's own shape: up to 4 dimensions, one entry each, the block inside
    the global tensor."""
    gshape, off = (tuple(int(v) for v in part) for part in block)
    shape = tuple(shape)
    if not (len(gshape) == len(off) == len(shape)) or not 1 <= len(shape) <= 4:
        raise ValueError(f"dropout block: global shape {gshape} and offset "
                         f"{off} need one entry per dimension of x "
                         f"{shape}, 1 to 4 of them")
    if any(o < 0 or o + n > g for g, o, n in zip(gshape, off, shape)):
        raise ValueError(f"dropout block: x {shape} at offset {off} does not "
                         f"lie inside the global shape {gshape}")
    return gshape, off


def _bits32(x: torch.Tensor) -> torch.Tensor:
    """u32 bits of an f32 tensor, held in int64."""
    return x.float().contiguous().view(torch.int32).to(torch.int64) & _M32


def _from_bits(b: torch.Tensor) -> torch.Tensor:
    """f32 tensor from u32 bits held in int64."""
    return torch.where(b >= 2 ** 31, b - 2 ** 32, b).to(
        torch.int32).view(torch.float32)


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

# target -> (kernel code, mantissa bits, least normal exponent, largest
# finite value or None where the add-and-truncate runs to Inf as bf16's does)
_SR_TARGETS = {
    torch.bfloat16: (0, 7, -126, None),
    torch.float16: (1, 10, -14, None),
    torch.float8_e5m2: (2, 2, -14, 57344.0),
    torch.float8_e4m3fn: (3, 3, -6, 448.0),
}
# the byte of an f8 value past the largest finite, rounded to nearest even
# as the JAX package's cast rounds it (torch's own e4m3fn cast saturates in
# some versions): e5m2 keeps 57344 below 61440 and is Inf from there;
# e4m3fn keeps 448 up to 464 and is NaN above (it has no Inf)
_SR_OVERFLOW = {torch.float8_e5m2: (61440.0, False, 0x7B, 0x7C),
                torch.float8_e4m3fn: (464.0, True, 0x7E, 0x7F)}
# the NaN each target stores, with x's sign
_SR_NAN = {torch.bfloat16: 0x7FC0, torch.float16: 0x7E00,
           torch.float8_e5m2: 0x7F, torch.float8_e4m3fn: 0x7F}


def _f32_bits(v: float) -> int:
    return int(np.float32(v).view(np.uint32))


def _sr_target(target) -> torch.dtype:
    tdt = target if isinstance(target, torch.dtype) else to_torch(target)
    if tdt not in _SR_TARGETS:
        raise ValueError(f"stochastic rounding targets bf16, f16, bf8 and "
                         f"hf8, not {tdt}")
    return tdt


def _sr_magnitude(a: torch.Tensor, r: torch.Tensor, mant: int,
                  emin: int) -> torch.Tensor:
    """|x| (f32 bits a, in int64) stochastically rounded to a target with
    `mant` mantissa bits and least normal exponent `emin`, as an f32 value,
    with the u32 random bits r: the bits below the target's ulp are added
    and cut off. In the target's subnormal range the ulp is fixed at
    2^(emin - mant), so the number of bits to drop grows as x's exponent
    falls; past 32 bits the lowest bits of x are truncated first."""
    drop = 23 - mant
    e = a >> 23
    emin_b = emin + 127
    normal = ((a + (r & ((1 << drop) - 1))) >> drop) << drop
    e_eff = torch.clamp_min(e, 1)
    d = drop + (emin_b - e_eff)
    m24 = (a & 0x7FFFFF) | torch.where(e > 0, 0x800000, 0)
    d_lo = torch.clamp_max(d, 32)
    rr = r & ((torch.ones_like(d_lo) << d_lo) - 1)
    q = ((m24 >> torch.clamp(d - 32, 0, 31)) + rr) >> d_lo
    sub = q.to(torch.float32) * 2.0 ** (emin - mant)
    return torch.where(e >= emin_b, _from_bits(normal), sub)


def _sr_plain(x: torch.Tensor, seed, target) -> torch.Tensor:
    """The plain torch version of the stochastic-rounding kernel: the same
    bits, the same integer arithmetic, the same NaN and overflow rules."""
    tdt = _sr_target(target)
    _, mant, emin, maxf = _SR_TARGETS[tdt]
    bits = _bits32(x)
    sign, a = bits & 0x80000000, bits & 0x7FFFFFFF
    r = _flat_bits(int(seed) & _M32, tuple(x.shape), x.device)
    val = _from_bits(_bits32(_sr_magnitude(a, r, mant, emin)) | sign)
    nan = a > 0x7F800000
    if tdt == torch.bfloat16:
        out = _bits32(val) >> 16
    elif tdt == torch.float16:
        out = val.to(tdt).view(torch.int16).to(torch.int64) & 0xFFFF
    else:
        out = val.to(tdt).view(torch.uint8).to(torch.int64)
        tie, up_nan, lo, hi = _SR_OVERFLOW[tdt]
        past = a > _f32_bits(maxf)
        up = a > _f32_bits(tie) if up_nan else a >= _f32_bits(tie)
        over = torch.where(up, hi, lo) | (sign >> 24)
        out = torch.where(past & ~nan, over, out)
    shift = 16 if tdt.itemsize == 2 else 24
    out = torch.where(nan, _SR_NAN[tdt] | (sign >> shift), out)
    if tdt.itemsize == 2:
        return torch.where(out >= 2 ** 15, out - 2 ** 16, out).to(
            torch.int16).view(tdt)
    return out.to(torch.uint8).view(tdt)


def stochastic_round(x: torch.Tensor, seed, target):
    """UNARY_STOCHASTIC_ROUND (typedefs.h:316 op 38): exact stochastic
    rounding of f32, bf16 or f16 x onto bf16, f16, bf8 (e5m2) or hf8
    (e4m3fn). Each value goes to one of its two neighbours in the target,
    the upper one with probability (x - lower) / (upper - lower), from the
    counter hash of (seed, flat index); NaN stays NaN, and an f8 value past
    the largest finite rounds to nearest even (e5m2: Inf from 61440;
    e4m3fn: NaN above 464). `seed` is an int or a 0-d
    tensor, taken mod 2^32. CUDA tensors launch the kernel of
    csrc/eltwise_kernels.cu (it replaces _sr_tpu); CPU tensors run
    stochastic_round.plain."""
    tdt = _sr_target(target)
    seed = int(seed) & _M32
    if not _on_cuda(x):
        return _sr_plain(x, seed, tdt)
    code = _TYPE_CODE.get(x.dtype)
    if code is None:
        raise ValueError(f"stochastic_round: no CUDA kernel for dtype "
                         f"{x.dtype}")
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=tdt, device=x.device)
    if x.numel() == 0:
        return out
    lib = _kernels()
    with _on_device(x.device):
        err = lib.xsmm_stochastic_round(
            _ptr(x), _ptr(out), x.numel(), code, _SR_TARGETS[tdt][0], seed,
            int(x.data_ptr() % 16 == 0), _num_sms(x.device),
            _stream(x.device))
    _raise_on_error(err, "stochastic_round", lib)
    launches["stochastic_round"] += 1
    return out


stochastic_round.plain = _sr_plain


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _p_and_scale(p: float):
    """p and 1/(1-p) in f32, the reference kernel's arithmetic (p rides as
    an f32 operand, eltwise_pallas.py:126-128)."""
    p32 = np.float32(p)
    return p32, np.float32(1.0) / (np.float32(1.0) - p32)


# the kernel's mask forms (csrc MASK_BYTES, MASK_PACKED, MASK_NONE)
MASK_FORMS = {"bytes": 0, "packed": 1, "none": 2}


def _mask_form(mask: str, x: torch.Tensor) -> int:
    form = MASK_FORMS.get(mask)
    if form is None:
        raise ValueError(f"dropout: mask must be one of {list(MASK_FORMS)}, "
                         f"got {mask!r}")
    if mask == "packed" and x.dim() != 2:
        raise ValueError(f"dropout: the packed bitmask takes a 2-D x, got "
                         f"shape {tuple(x.shape)}")
    return form


def _dropout_plain(x: torch.Tensor, seed, p, mask: str = "bytes",
                   block=None):
    """The plain torch version of the dropout kernel: the same bits, the
    same keep rule and the same f32 arithmetic; the mask in the same form
    (packed by ops/eltwise.py pack_bitmask)."""
    _mask_form(mask, x)
    p32, scale = _p_and_scale(_check_p(p))
    keep = _uniform(_flat_bits(seed, tuple(x.shape), x.device,
                               block)) >= float(p32)
    scaled = x.float() * torch.tensor(scale, device=x.device)
    out = torch.where(keep, scaled, torch.zeros((), device=x.device))
    out = out.to(x.dtype)
    if mask == "none":
        return out
    if mask == "packed":
        from ..ops.eltwise import pack_bitmask
        return out, pack_bitmask(keep, two_byte_mult=True)
    return out, keep.to(torch.uint8)


def dropout(x: torch.Tensor, seed, p, mask: str = "bytes", block=None):
    """UNARY_DROPOUT: keeps an element iff u >= p and scales it by
    1/(1-p); p is a runtime value (a float or a 0-d tensor). Returns (out,
    keep mask): mask="bytes" one uint8 per element; "packed" the
    (m, ceil(n/16)*2) uint8 BITMASK_2BYTEMULT bit matrix of a 2-D x; "none"
    returns out alone. CUDA tensors (f32, bf16, f16) launch the kernel,
    which writes the mask in that form; CPU tensors run dropout.plain.

    block=(global_shape, offset): x is the block at `offset` of a global
    tensor of `global_shape` (one entry per dimension of x, up to 4), and
    every element's bits are those of its global row-major flat index: the
    blocks of a sharded tensor drop, together, what the whole tensor would
    (csrc xsmm_dropout_block). Without one, the bits are those of x's own
    flat index."""
    p = _check_p(p)
    form = _mask_form(mask, x)
    if not _on_cuda(x):
        if block is None:
            return _dropout_plain(x, seed, p, mask)
        return _dropout_plain(x, seed, p, mask, block)
    code = _TYPE_CODE.get(x.dtype)
    if code is None:
        raise ValueError(f"dropout: no CUDA kernel for dtype {x.dtype}")
    x = x.contiguous()
    out = torch.empty_like(x)
    cols = 1
    keep = None
    if mask == "packed":
        rows, cols = x.shape
        keep = torch.empty((rows, (cols + 15) // 16 * 2), dtype=torch.uint8,
                           device=x.device)
    elif mask == "bytes":
        keep = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    p32, scale = _p_and_scale(p)
    lib = _kernels()
    with _on_device(x.device):
        if block is None:
            err = lib.xsmm_dropout(
                _ptr(x), _ptr(out), _ptr(keep), x.numel(), max(cols, 1),
                code, form, float(p32), float(scale), int(seed) & _M32,
                int(x.data_ptr() % 16 == 0), _num_sms(x.device),
                _stream(x.device))
        else:
            dims = ctypes.c_longlong * x.dim()
            gshape, off = _check_block(block, x.shape)
            err = lib.xsmm_dropout_block(
                _ptr(x), _ptr(out), _ptr(keep), x.numel(), code, form,
                float(p32), float(scale), int(seed) & _M32,
                int(x.data_ptr() % 16 == 0), x.dim(), dims(*x.shape),
                dims(*gshape), dims(*off), _num_sms(x.device),
                _stream(x.device))
    _raise_on_error(err, "dropout", lib)
    launches["dropout"] += 1
    return out if keep is None else (out, keep)


dropout.plain = _dropout_plain


def dropout_inv(g: torch.Tensor, mask: torch.Tensor, p):
    """UNARY_DROPOUT_INV: apply the saved keep-mask to the gradient,
    rescaled by 1/(1-p) (generator_mateltwise_reference_impl.c:2408-2424).

    `mask` is the PACKED bitmask the forward emitted (reference
    param->in.secondary bit layout); a same-shaped per-element mask is also
    accepted, of any shape. The mask is the block's own, so a dropout in a
    block (dropout's `block`) needs no description here."""
    from ..ops.eltwise import unpack_bitmask
    p = _check_p(p)
    if tuple(mask.shape) == tuple(g.shape):
        bits = mask != 0
    else:
        m, n = g.shape
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

def _mx_converters(dt: Datatype):
    """(quantize, dequantize) of an MX storage type, or None: the
    reference-exact block converters (impl.c:2260-2322 routing)."""
    from .. import quant as q_
    return {Datatype.MXFP4X2: (q_.mxfp4_quantize_blocks,
                               q_.mxfp4_dequantize_blocks),
            Datatype.NVFP4X2: (q_.nvfp4_quantize_blocks,
                               q_.nvfp4_dequantize_blocks),
            Datatype.MXBF8: (q_.mxbf8_quantize_blocks,
                             q_.mxbf8_dequantize_blocks)}.get(dt)


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
        if desc.flags & UnaryFlags.BITMASK_2BYTEMULT:
            # reference contract: the side output is a PACKED bit matrix
            # with UPDIV(ldo,16)*16-bit row stride, which the kernel writes
            return dropout(x, seed, p, mask="packed")
        return dropout(x, seed, p, mask="none")
    if op == UnaryType.DROPOUT_INV:
        from ..ops.eltwise import load_operand
        p = state.get("p", desc.extra[0] if desc.extra else 0.5)
        (mask,) = args
        return dropout_inv(x, load_operand(mask, x.device), p)
    if op == UnaryType.QUANT:
        mx = _mx_converters(desc.out_type)
        if mx is not None:
            # MX output: a (payload, scales) pair
            return mx[0](x.float())
        scale = args[0] if args else state.get("scale", 1.0)
        odt = to_torch(desc.out_type if desc.out_type != Datatype.IMPLICIT
                       else Datatype.I8)
        return quant(x, scale, odt,
                     stochastic=bool(desc.flags & UnaryFlags.STOCHASTIC_ROUND),
                     seed=state.get("seed", 0),
                     sign_sat=bool(desc.flags & UnaryFlags.SIGN_SAT_QUANT),
                     skip_scf=bool(desc.flags & UnaryFlags.NO_SCF_QUANT))
    if op == UnaryType.DEQUANT:
        mx = _mx_converters(desc.in_type)
        if mx is not None:
            (scales,) = args
            return mx[1](x, scales)
        scale = args[0] if args else state.get("scale", 1.0)
        if desc.flags & UnaryFlags.NO_SCF_QUANT:
            scale = 1.0
        odt = to_torch(desc.out_type if desc.out_type != Datatype.IMPLICIT
                       else Datatype.F32)
        return dequant(x, scale, odt)
    raise NotImplementedError(f"stateful unary {op}")
