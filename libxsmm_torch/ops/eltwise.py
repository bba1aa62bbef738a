"""Element-wise TPPs: unary / binary / ternary kernels.

The port of `libxsmm_tpu/ops/eltwise.py`: the reference's meltw generator
family (generator_mateltwise*.c, op enums include/libxsmm_typedefs.h:
278-453) — activations and their gradients, reductions, layout transforms
(transpose, VNNI pack/unpack, pad), gather/scatter, dropout, quant/dequant,
zip/unzip, decompress.

Policy, as the reference's: memory-bound element-wise math is plain torch
ops (the reference leaves it to XLA); the ops that need a random stream or
saturating conversions go through kernels/eltwise.py, whose dropout and
stochastic rounding are hand-written CUDA kernels on CUDA tensors. VNNI2/4/8 transforms are real data
transforms, bit-exact with the reference's definition.

Dispatch mirrors libxsmm_dispatch_meltw_{unary,binary,ternary}
(src/libxsmm_main.c:3449-3533). Invoke is functional: out = kernel(in_...).
Ops needing state (dropout seed, quant scale) take them as explicit
arguments. A kernel follows the device of its tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..descriptor import (BinaryFlags, BinaryType, MeltwDescriptor,
                          TernaryFlags, TernaryType, UnaryFlags, UnaryType)
from ..device import resolve_device
from ..dtypes import Datatype, to_torch
from ..interop import tensor_from_numpy
from ..registry import Kernel, KernelInfo, entry_point, get_registry

# ---------------------------------------------------------------------------
# scalar/elementwise math
# ---------------------------------------------------------------------------


def _gelu(x):
    # erf-based gelu, matching the reference's gelu definition
    return 0.5 * x * (1.0 + torch.erf(x * (2 ** -0.5)))


def _gelu_inv(x):
    # d/dx gelu(x)
    inv_sqrt2 = 2 ** -0.5
    cdf = 0.5 * (1.0 + torch.erf(x * inv_sqrt2))
    pdf = torch.exp(-0.5 * x * x) * (1.0 / math.sqrt(2.0 * math.pi))
    return cdf + x * pdf


_UNARY_MATH = {
    UnaryType.IDENTITY: lambda x: x,
    UnaryType.XOR: torch.zeros_like,
    UnaryType.X2: lambda x: x * x,
    UnaryType.SQRT: torch.sqrt,
    UnaryType.RELU: lambda x: torch.clamp_min(x, 0),
    UnaryType.TANH: torch.tanh,
    # the *_INV entries here are pure input-derivative functions, like the
    # reference's libxsmm_fp32_unary_compute; RELU_INV/LEAKY_RELU_INV/
    # ELU_INV take (grad, saved state) and live in _build_unary
    UnaryType.TANH_INV: lambda x: 1.0 - torch.tanh(x) ** 2,
    UnaryType.SIGMOID: torch.sigmoid,
    UnaryType.SIGMOID_INV: lambda x: torch.sigmoid(x) * (1 - torch.sigmoid(x)),
    UnaryType.GELU: _gelu,
    UnaryType.GELU_INV: _gelu_inv,
    UnaryType.NEGATE: lambda x: -x,
    UnaryType.INC: lambda x: x + 1,
    UnaryType.RECIPROCAL: lambda x: 1.0 / x,
    UnaryType.RECIPROCAL_SQRT: torch.rsqrt,
    UnaryType.EXP: torch.exp,
    UnaryType.LEAKY_RELU: lambda x, alpha=0.01: torch.where(x > 0, x,
                                                            alpha * x),
    UnaryType.ELU: lambda x, alpha=1.0: torch.where(x > 0, x,
                                                    alpha * torch.expm1(x)),
}

# ---------------------------------------------------------------------------
# packed bitmask layout (reference BITMASK_2BYTEMULT data contract): the bit
# for element (i, j) lives at byte[j//8 + i*(ld_bits//8)], bit j%8, with the
# row stride ld_bits = UPDIV(n,16)*16 under BITMASK_2BYTEMULT, else n
# (generator_mateltwise_reference_impl.c:151-175, :2140-2166)
# ---------------------------------------------------------------------------


def bitmask_ld(n: int, two_byte_mult: bool = True) -> int:
    """Mask row stride in BITS (reference mask_ld,
    generator_mateltwise_reference_impl.c:2142,2173)."""
    if two_byte_mult:
        return ((n + 15) // 16) * 16
    if n % 8:
        raise ValueError(f"bitmask without BITMASK_2BYTEMULT needs the row "
                         f"width to be a byte multiple (n={n}); the "
                         f"reference's byte addressing assumes ld%8==0")
    return n


_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


def pack_bitmask(mask: torch.Tensor, two_byte_mult: bool = True):
    """(m, n) boolean -> (m, bitmask_ld(n)//8) uint8, reference bit layout."""
    m, n = mask.shape
    ld = bitmask_ld(n, two_byte_mult)
    mb = torch.nn.functional.pad(mask.to(torch.int32), (0, ld - n))
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=mask.device)
    return (mb.reshape(m, ld // 8, 8) * w).sum(dim=-1).to(torch.uint8)


def unpack_bitmask(packed: torch.Tensor, m: int, n: int):
    """(m, nbytes) uint8 -> (m, n) bool; stride inferred from the packed
    width (accepts both the 2BYTEMULT-padded and tight layouts)."""
    nbytes = packed.shape[-1]
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed.to(torch.uint8).reshape(m, nbytes, 1) >> shifts) & 1
    return bits.reshape(m, nbytes * 8)[:, :n] != 0


def _trunc_f32_to_bf16_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 value truncated to a bf16-representable value, kept in f32 —
    computed by integer bit ops, as the reference does."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & -65536).view(torch.float32)      # & 0xFFFF0000


_REDUCE_OPS = {
    UnaryType.REDUCE_X_OP_ADD: ("add", False),
    UnaryType.REDUCE_X2_OP_ADD: ("add", True),
    UnaryType.REDUCE_X_X2_OP_ADD: ("add_both", None),
    UnaryType.REDUCE_X_OP_MAX: ("max", False),
    UnaryType.REDUCE_X_OP_MIN: ("min", False),
    UnaryType.REDUCE_X_OP_MUL: ("mul", False),
    UnaryType.REDUCE_X_OP_ABSMAX: ("absmax", False),
}


def _apply_reduce(op: str, x, axis: int, keepdims=True):
    if op == "add":
        return torch.sum(x, dim=axis, keepdim=keepdims)
    if op == "max":
        return torch.amax(x, dim=axis, keepdim=keepdims)
    if op == "min":
        return torch.amin(x, dim=axis, keepdim=keepdims)
    if op == "mul":
        return torch.prod(x, dim=axis, keepdim=keepdims)
    if op == "absmax":
        return torch.amax(torch.abs(x), dim=axis, keepdim=keepdims)
    raise ValueError(op)


# ---------------------------------------------------------------------------
# VNNI layout transforms — NORM (m,n) row-major; VNNIk interleaves k
# consecutive rows so that element (i, j) of NORM lives at vnni[i//k, j, i%k]
# (generator_mateltwise_transform_*.c)
# ---------------------------------------------------------------------------


def _norm_to_vnni(x, k: int, pad: bool):
    m, n = x.shape
    if m % k:
        if not pad:
            raise ValueError(f"NORM_TO_VNNI{k} needs m % {k} == 0 (m={m})")
        x = torch.nn.functional.pad(x, (0, 0, 0, k - m % k))
        m = x.shape[0]
    return x.reshape(m // k, k, n).transpose(1, 2).reshape(m // k, n * k)


def _vnni_to_norm(x, k: int, m: int, n: int):
    mk = x.shape[0]
    return (x.reshape(mk, n, k).transpose(1, 2).reshape(mk * k, n))[:m]


def _pad_mod(x, mod: int, pad_m: bool, pad_n: bool):
    m, n = x.shape
    pm = (mod - m % mod) % mod if pad_m else 0
    pn = (mod - n % mod) % mod if pad_n else 0
    return torch.nn.functional.pad(x, (0, pn, 0, pm))


# ---------------------------------------------------------------------------
# generic broadcast handling (reference BCAST_* flags)
# ---------------------------------------------------------------------------


def _bcast_unary(x, flags: UnaryFlags, m: int, n: int):
    if flags & UnaryFlags.BCAST_SCALAR:
        return x.reshape(1, 1).expand(m, n)
    if flags & UnaryFlags.BCAST_ROW:
        return x.reshape(m, 1).expand(m, n)
    if flags & UnaryFlags.BCAST_COL:
        return x.reshape(1, n).expand(m, n)
    return x


def _bcast_in(x, m, n, row, col, scalar):
    if scalar:
        return x.reshape(1, 1).expand(m, n)
    if row:
        return x.reshape(m, 1).expand(m, n)
    if col:
        return x.reshape(1, n).expand(m, n)
    return x


# numpy types without a torch counterpart by name (ml_dtypes', as
# np.asarray of a JAX array gives them), moved bit for bit
_ML_DTYPES = {"bfloat16": Datatype.BF16, "float8_e5m2": Datatype.BF8,
              "float8_e4m3fn": Datatype.HF8}


def load_operand(x, device=None) -> torch.Tensor:
    """A kernel's operand: a tensor stays on its own device; numpy data
    loads onto `device` (default: the GPU, raising without one)."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    dt = _ML_DTYPES.get(arr.dtype.name)
    if dt is not None:
        return tensor_from_numpy(arr, dt, device)
    return torch.as_tensor(arr, device=resolve_device(device))


# ---------------------------------------------------------------------------
# op application helpers (also used by BRGEMM-ext epilogues and meqn)
# ---------------------------------------------------------------------------


def apply_unary_op(op: UnaryType, flags: UnaryFlags, x, **state):
    """Apply a unary TPP to a tensor. `alpha` in state feeds LEAKY_RELU/ELU
    (the reference's runtime op.primary param)."""
    if op in _UNARY_MATH:
        f32 = (x.float() if x.dtype in (torch.bfloat16, torch.float16)
               else x)
        if op in (UnaryType.LEAKY_RELU, UnaryType.ELU) and "alpha" in state:
            y = _UNARY_MATH[op](f32, state["alpha"])
        else:
            y = _UNARY_MATH[op](f32)
        return y.to(x.dtype)
    if op in _REDUCE_OPS:
        kind, squared = _REDUCE_OPS[op]
        axis = 1 if flags & UnaryFlags.REDUCE_ROWS else 0
        if kind == "add_both":
            return (torch.sum(x, dim=axis, keepdim=True),
                    torch.sum(x * x, dim=axis, keepdim=True))
        src = x * x if squared else x
        red = _apply_reduce(kind, src, axis)
        if flags & UnaryFlags.REDUCE_RECORD_ARGOP and kind in ("max", "min"):
            arg = (torch.argmax if kind == "max" else torch.argmin)(
                src, dim=axis, keepdim=True)
            return red, arg.to(torch.int32)
        return red
    if op == UnaryType.REDUCE_TO_SCALAR_OP_ADD:
        return torch.sum(x).reshape(1, 1)
    if op == UnaryType.TRANSFORM_NORM_TO_NORMT:
        return x.T
    raise NotImplementedError(f"apply_unary_op: {op}")


def apply_matmul_node(op, a, b, a_dtype: Datatype, comp=torch.float32):
    """MATMUL/BRGEMM binary/ternary ops incl. _A_TRANS/_B_TRANS/_A_VNNI
    variants (include/libxsmm_typedefs.h:378-397,426-443), shared by
    dispatch_meltw_binary/ternary. Transposes act on the trailing 2 dims so
    BRGEMM batch dims are preserved; A_VNNI un-interleaves the stored layout
    first. Products run in `comp` (f32 at full precision: no TF32)."""
    if "A_VNNI" in op.name:
        from .gemm import _undo_vnni
        a = _undo_vnni(a, a_dtype)
    # reference name order: A_VNNI_TRANS == trans(unvnni(A))
    if "A_TRANS" in op.name or "A_VNNI_TRANS" in op.name:
        a = a.transpose(-1, -2)
    if "B_TRANS" in op.name:
        b = b.transpose(-1, -2)
    if op.name.startswith("BRGEMM"):
        return torch.einsum("bmk,bkn->mn", a.to(comp), b.to(comp))
    return torch.matmul(a.to(comp), b.to(comp))


def apply_binary_op(op: BinaryType, flags: BinaryFlags, a, b, c_prev=None):
    if op == BinaryType.ADD:
        return a + b
    if op == BinaryType.MUL:
        return a * b
    if op == BinaryType.SUB:
        return a - b
    if op == BinaryType.DIV:
        return a / b
    if op == BinaryType.MAX:
        return torch.maximum(a, b)
    if op == BinaryType.MIN:
        return torch.minimum(a, b)
    if op == BinaryType.MULADD:
        if c_prev is None:
            raise ValueError("MULADD reads the previous output")
        return c_prev + a * b
    if op == BinaryType.MUL_AND_REDUCE_TO_SCALAR_OP_ADD:
        return torch.sum(a * b).reshape(1, 1)
    cmp = {BinaryType.CMP_OP_GT: torch.gt, BinaryType.CMP_OP_GE: torch.ge,
           BinaryType.CMP_OP_LT: torch.lt, BinaryType.CMP_OP_LE: torch.le,
           BinaryType.CMP_OP_EQ: torch.eq,
           BinaryType.CMP_OP_NE: torch.ne}.get(op)
    if cmp is not None:
        return cmp(a, b)
    if op == BinaryType.MATMUL:
        return torch.matmul(a.float(), b.float())
    raise NotImplementedError(f"apply_binary_op: {op}")


def apply_ternary_op(op: TernaryType, flags: TernaryFlags, a, b, c):
    if op == TernaryType.MULADD:
        return a * b + c
    if op == TernaryType.NMULADD:
        return -(a * b) + c
    if op == TernaryType.SELECT:
        # reference: bit CLEAR selects in0, bit SET selects in1
        # (generator_mateltwise_reference_impl.c:2629) — c here is the
        # value-level (unpacked) mask
        return torch.where(c != 0, b, a)
    if op == TernaryType.MATMUL:
        return torch.matmul(a.float(), b.float()) + c
    raise NotImplementedError(f"apply_ternary_op: {op}")


# ---------------------------------------------------------------------------
# dispatchers
# ---------------------------------------------------------------------------


def _out_cast(y, out_type: Datatype, in_dtype):
    if out_type == Datatype.IMPLICIT:
        return y.to(in_dtype)
    return y.to(to_torch(out_type))


def _bits_u32(v: torch.Tensor) -> torch.Tensor:
    """The u32 value of v's elements (a 16-bit float is read by its bits),
    held in int64 — the reference's astype(uint32) in ZIP."""
    if v.dtype in (torch.bfloat16, torch.float16):
        v = v.contiguous().view(torch.int16)
        return v.to(torch.int64) & 0xFFFF
    return v.to(torch.int64) & 0xFFFFFFFF


def _i32_from_u32(v: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 values -> int32 with the same bits."""
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def _build_unary(desc: MeltwDescriptor) -> Kernel:
    op: UnaryType = desc.op_type
    flags = UnaryFlags(desc.flags)
    m, n = desc.m, desc.n
    comp = to_torch(desc.comp_type)

    def base(x, *args, **state):
        x = load_operand(x)
        xb = _bcast_unary(x, flags, m, n)
        two_byte = bool(flags & UnaryFlags.BITMASK_2BYTEMULT)

        # activation forwards with runtime alpha + optional packed bitmask
        # side output (generator_mateltwise_reference_impl.c:2140-2166)
        if op in (UnaryType.RELU, UnaryType.LEAKY_RELU, UnaryType.ELU):
            alpha = state.get(
                "alpha", args[0] if args
                else (0.01 if op == UnaryType.LEAKY_RELU else 1.0))
            y = apply_unary_op(op, flags, xb.to(comp), alpha=alpha)
            out = _out_cast(y, desc.out_type, x.dtype)
            if two_byte:
                return out, pack_bitmask(xb > 0, two_byte_mult=True)
            return out

        # gradient kernels: kernel(grad, saved_state[, alpha])
        # (generator_mateltwise_reference_impl.c:2168-2195)
        if op in (UnaryType.RELU_INV, UnaryType.LEAKY_RELU_INV):
            if not args:
                raise ValueError(f"{op.name} needs the saved relu bitmask: "
                                 "kernel(grad, mask[, alpha])")
            bits = unpack_bitmask(load_operand(args[0], x.device), m, n)
            g = xb.to(comp)
            if op == UnaryType.RELU_INV:
                y = torch.where(bits, g, torch.zeros_like(g))
            else:
                alpha = state.get("alpha",
                                  args[1] if len(args) > 1 else 0.01)
                y = torch.where(bits, g, alpha * g)
            return _out_cast(y, desc.out_type, x.dtype)
        if op == UnaryType.ELU_INV:
            # saved forward OUTPUT: out = out_fwd > 0 ? grad
            #                                         : grad * (out_fwd + alpha)
            if not args:
                raise ValueError("ELU_INV needs the saved forward output: "
                                 "kernel(grad, out_fwd[, alpha])")
            out_fwd = load_operand(args[0], x.device).to(comp)
            alpha = state.get("alpha", args[1] if len(args) > 1 else 1.0)
            g = xb.to(comp)
            y = torch.where(out_fwd > 0, g, g * (out_fwd + alpha))
            return _out_cast(y, desc.out_type, x.dtype)

        if op in _UNARY_MATH or op in _REDUCE_OPS or op in (
                UnaryType.REDUCE_TO_SCALAR_OP_ADD,):
            y = apply_unary_op(op, flags, xb.to(comp))
            if (op in _REDUCE_OPS and flags & UnaryFlags.REDUCE_INIT_ACC
                    and args):
                # accumulate into the caller's running accumulator; the
                # reference consults the flag for the ADD reduces only
                # (reference_impl.c:1168-1181)
                if _REDUCE_OPS[op][0] not in ("add", "add_both"):
                    raise ValueError(f"REDUCE_INIT_ACC is defined for the "
                                     f"ADD reduces only, not {op.name}")
                if isinstance(y, tuple):
                    if len(args) < len(y):
                        raise ValueError(
                            f"{op.name} with REDUCE_INIT_ACC needs one "
                            f"accumulator per output: kernel(x, acc_x, "
                            f"acc_x2)")
                    y = tuple(t + load_operand(a, x.device).to(comp)
                              for t, a in zip(y, args))
                else:
                    y = y + load_operand(args[0], x.device).to(comp)
            if isinstance(y, tuple):
                # argop index outputs stay integer
                return tuple(t if not (t.is_floating_point()
                                       or t.is_complex())
                             else _out_cast(t, desc.out_type, x.dtype)
                             for t in y)
            return _out_cast(y, desc.out_type, x.dtype)

        if op == UnaryType.REDUCE_X_OP_ADD_NCNC_FORMAT:
            # blocked NCNC reduce over N (reference_impl.c:2118-2137);
            # desc.extra = (C, N), blocks (bc, bn) = (desc.m, desc.n)
            bc, bn = m, n
            C, N = desc.extra
            blk = x.reshape(N // bn, C // bc, bn, bc).to(comp)
            red = torch.sum(blk, dim=(0, 2))          # (C//bc, bc)
            return _out_cast(red.reshape(1, C), desc.out_type, x.dtype)

        # transforms -------------------------------------------------------
        if op == UnaryType.TRANSFORM_NORM_TO_NORMT:
            return _out_cast(xb.T, desc.out_type, x.dtype)
        for k in (2, 4, 8):
            if op == getattr(UnaryType, f"TRANSFORM_NORM_TO_VNNI{k}"):
                return _out_cast(_norm_to_vnni(xb, k, pad=False),
                                 desc.out_type, x.dtype)
            if op == getattr(UnaryType, f"TRANSFORM_NORM_TO_VNNI{k}_PAD"):
                return _out_cast(_norm_to_vnni(xb, k, pad=True),
                                 desc.out_type, x.dtype)
            if op == getattr(UnaryType, f"TRANSFORM_NORM_TO_VNNI{k}T"):
                return _out_cast(_norm_to_vnni(xb.T, k, pad=True),
                                 desc.out_type, x.dtype)
            if op == getattr(UnaryType, f"TRANSFORM_VNNI{k}_TO_VNNI{k}T"):
                norm = _vnni_to_norm(xb, k, m, n)
                return _out_cast(_norm_to_vnni(norm.T, k, pad=True),
                                 desc.out_type, x.dtype)
            if op == getattr(UnaryType, f"TRANSFORM_VNNI{k}T_TO_NORM", None):
                normt = _vnni_to_norm(xb, k, n, m)
                return _out_cast(normt.T, desc.out_type, x.dtype)
            if op == getattr(UnaryType, f"TRANSFORM_VNNI{k}_TO_NORM", None):
                return _out_cast(_vnni_to_norm(xb, k, m, n), desc.out_type,
                                 x.dtype)
        if op == UnaryType.TRANSFORM_VNNI4_TO_VNNI2:
            norm = _vnni_to_norm(xb, 4, m, n)
            return _out_cast(_norm_to_vnni(norm, 2, pad=False),
                             desc.out_type, x.dtype)
        if op in (UnaryType.TRANSFORM_PADM_MOD2, UnaryType.TRANSFORM_PADN_MOD2,
                  UnaryType.TRANSFORM_PADNM_MOD2, UnaryType.TRANSFORM_PADM_MOD4,
                  UnaryType.TRANSFORM_PADN_MOD4, UnaryType.TRANSFORM_PADNM_MOD4):
            mod = 2 if "MOD2" in op.name else 4
            pad_m = "PADM" in op.name or "PADNM" in op.name
            pad_n = "PADN" in op.name
            return _out_cast(_pad_mod(xb, mod, pad_m, pad_n),
                             desc.out_type, x.dtype)

        # pack/unpack ------------------------------------------------------
        if op == UnaryType.UNZIP:
            # split f32 into (low16, high16) 16-bit halves
            bits = xb.float().contiguous().view(torch.int32).to(
                torch.int64) & 0xFFFFFFFF
            return ((bits & 0xFFFF).to(torch.uint16),
                    (bits >> 16).to(torch.uint16))
        if op == UnaryType.REPLICATE_COL_VAR:
            ncols = state.get("ncols", n)
            return x.reshape(m, 1).expand(m, ncols).contiguous()
        if op == UnaryType.GATHER:
            idx = load_operand(args[0], x.device).to(torch.long)
            dim = 1 if flags & UnaryFlags.GS_COLS else 0
            return torch.index_select(xb, dim, idx)
        if op == UnaryType.SCATTER:
            idx = load_operand(args[0], x.device).to(torch.long)
            out = load_operand(args[1], x.device).clone()
            if flags & UnaryFlags.GS_COLS:
                out[:, idx] = xb.to(out.dtype)
            else:
                out[idx, :] = xb.to(out.dtype)
            return out
        if op in (UnaryType.REDUCE_COLS_IDX_OP_ADD,
                  UnaryType.REDUCE_COLS_IDX_OP_MAX,
                  UnaryType.REDUCE_COLS_IDX_OP_MIN):
            idx = load_operand(args[0], x.device).to(torch.long)
            rows = torch.index_select(xb, 0, idx).to(comp)
            red = {UnaryType.REDUCE_COLS_IDX_OP_ADD: torch.sum,
                   UnaryType.REDUCE_COLS_IDX_OP_MAX: torch.amax,
                   UnaryType.REDUCE_COLS_IDX_OP_MIN: torch.amin}[op]
            return _out_cast(red(rows, dim=0, keepdim=True),
                             desc.out_type, x.dtype)
        if op in (UnaryType.DROPOUT, UnaryType.DROPOUT_INV,
                  UnaryType.STOCHASTIC_ROUND, UnaryType.QUANT,
                  UnaryType.DEQUANT):
            from ..kernels import eltwise as stateful
            return stateful.run_stateful_unary(desc, x, *args, **state)
        if op.name.startswith("DECOMPRESS_SPARSE_FACTOR"):
            (mask,) = args
            return _decompress_sparse(xb, load_operand(mask, x.device), m, n, x.dtype)
        if op == UnaryType.DECOMP_FP32_TO_BF16X2:
            # split f32 into (hi, lo) bf16 with x ~= hi + lo (splitSGD); hi
            # by truncating x's own bits
            hf = _trunc_f32_to_bf16_f32(xb)
            return hf.to(torch.bfloat16), (xb - hf).to(torch.bfloat16)
        if op == UnaryType.DECOMP_FP32_TO_BF16X3:
            h1f = _trunc_f32_to_bf16_f32(xb)
            r1 = xb - h1f
            h2f = _trunc_f32_to_bf16_f32(r1)
            h3 = (r1 - h2f).to(torch.bfloat16)
            return h1f.to(torch.bfloat16), h2f.to(torch.bfloat16), h3
        raise NotImplementedError(f"unary op {op}")

    if op == UnaryType.DUMP:
        # host-side print, as the reference's LIBXSMM_DUMP
        def dump_fn(x, *args, **state):
            x = load_operand(x)
            print(f"xsmm dump {desc.name()}:\n{x.detach().cpu().numpy()}")
            return x

        return Kernel(fn=dump_fn, descriptor=desc,
                      info=KernelInfo(kind="meltw", nflops=0),
                      name=desc.name())

    info = KernelInfo(kind="meltw", nflops=m * n)
    return Kernel(fn=base, descriptor=desc, info=info, name=desc.name())


def _decompress_sparse(values, bitmask, m, n, dtype):
    """DECOMPRESS_SPARSE_FACTOR_k: expand a compressed nonzero stream into a
    dense (m,n) by a bitmask, through a cumsum gather."""
    mask = bitmask.reshape(-1).to(torch.int64)
    pos = torch.cumsum(mask, dim=0) - 1
    flat_vals = values.reshape(-1)
    gathered = flat_vals[torch.clamp(pos, 0, flat_vals.numel() - 1)]
    dense = torch.where(mask > 0, gathered, torch.zeros_like(gathered))
    return dense.reshape(m, n).to(dtype)


def _matmul_nflops_wrapper(fn, info, m, n):
    """Refine KernelInfo.nflops for contraction-typed meltw kernels from the
    runtime operand shapes (the descriptor has no k/br): 2*m*n*k, and a
    stacked (br, ., .) BRGEMM operand multiplies by br."""
    last = []

    def wrapped(in0, *rest):
        shp = tuple(in0.shape)
        if last[:1] != [shp]:
            k = shp[-1]
            br = shp[0] if len(shp) == 3 else 1
            info.nflops = 2 * m * n * max(1, k) * max(1, br)
            last[:] = [shp]
        return fn(in0, *rest)

    return wrapped


def _build_binary(desc: MeltwDescriptor) -> Kernel:
    op: BinaryType = desc.op_type
    flags = BinaryFlags(desc.flags)
    m, n = desc.m, desc.n
    comp = to_torch(desc.comp_type)
    contraction = op.name.startswith(("MATMUL", "BRGEMM"))

    def base(in0, in1, c_prev=None):
        in0 = load_operand(in0)
        in1 = load_operand(in1, in0.device)
        if c_prev is not None:
            c_prev = load_operand(c_prev, in0.device)
        if contraction:
            # contraction ops take natural (not broadcast) operand shapes
            y = apply_matmul_node(op, in0.to(comp), in1.to(comp),
                                  desc.in_type, comp)
            return _out_cast(y, desc.out_type, in0.dtype)
        a = _bcast_in(in0, m, n, flags & BinaryFlags.BCAST_ROW_IN_0,
                      flags & BinaryFlags.BCAST_COL_IN_0,
                      flags & BinaryFlags.BCAST_SCALAR_IN_0)
        b = _bcast_in(in1, m, n, flags & BinaryFlags.BCAST_ROW_IN_1,
                      flags & BinaryFlags.BCAST_COL_IN_1,
                      flags & BinaryFlags.BCAST_SCALAR_IN_1)
        if op == BinaryType.ZIP:
            # merge lo/hi 16-bit halves back into f32; 16-bit FLOAT operands
            # are read by their bits, not converted
            word = (((_bits_u32(b) << 16) & 0xFFFFFFFF) | _bits_u32(a))
            return _i32_from_u32(word).view(torch.float32)
        if op == BinaryType.PACK:
            return torch.stack([a, b], dim=-1).reshape(m, 2 * n)
        y = apply_binary_op(op, flags, a.to(comp), b.to(comp),
                            None if c_prev is None else c_prev.to(comp))
        if op.name.startswith("CMP_OP_"):
            # the reference stores CMP results as a PACKED bitmask with
            # ld = UPDIV(ldo,16)*16 (reference_impl.c:2575-2581)
            return pack_bitmask(y)
        return _out_cast(y, desc.out_type, in0.dtype)

    info = KernelInfo(kind="meltw", nflops=m * n)
    fn = _matmul_nflops_wrapper(base, info, m, n) if contraction else base
    return Kernel(fn=fn, descriptor=desc, info=info, name=desc.name())


def _build_ternary(desc: MeltwDescriptor) -> Kernel:
    op: TernaryType = desc.op_type
    flags = TernaryFlags(desc.flags)
    m, n = desc.m, desc.n
    comp = to_torch(desc.comp_type)
    contraction = op.name.startswith(("MATMUL", "BRGEMM"))

    def base(in0, in1, in2):
        in0 = load_operand(in0)
        in1, in2 = load_operand(in1, in0.device), load_operand(in2, in0.device)
        if contraction:
            y = (apply_matmul_node(op, in0.to(comp), in1.to(comp),
                                   desc.in_type, comp) + in2.to(comp))
            return _out_cast(y, desc.out_type, in0.dtype)
        a = _bcast_in(in0, m, n, flags & TernaryFlags.BCAST_ROW_IN_0,
                      flags & TernaryFlags.BCAST_COL_IN_0,
                      flags & TernaryFlags.BCAST_SCALAR_IN_0)
        b = _bcast_in(in1, m, n, flags & TernaryFlags.BCAST_ROW_IN_1,
                      flags & TernaryFlags.BCAST_COL_IN_1,
                      flags & TernaryFlags.BCAST_SCALAR_IN_1)
        if op == TernaryType.SELECT:
            # in2 is a PACKED 2BYTEMULT bitmask: bit CLEAR -> in0, SET -> in1
            mask = unpack_bitmask(load_operand(in2, in0.device), m, n)
            y = torch.where(mask, b.to(comp), a.to(comp))
        else:
            c = _bcast_in(in2, m, n, flags & TernaryFlags.BCAST_ROW_IN_2,
                          flags & TernaryFlags.BCAST_COL_IN_2,
                          flags & TernaryFlags.BCAST_SCALAR_IN_2)
            y = apply_ternary_op(op, flags, a.to(comp), b.to(comp),
                                 c.to(comp))
        return _out_cast(y, desc.out_type, in0.dtype)

    info = KernelInfo(kind="meltw", nflops=2 * m * n)
    fn = _matmul_nflops_wrapper(base, info, m, n) if contraction else base
    return Kernel(fn=fn, descriptor=desc, info=info, name=desc.name())


@entry_point
def dispatch_meltw_unary(op_type: UnaryType, m=None, n: int = None,
                         flags: UnaryFlags = UnaryFlags.NONE,
                         in_type: Datatype = Datatype.F32,
                         out_type: Datatype = Datatype.IMPLICIT,
                         comp_type: Datatype = Datatype.F32,
                         extra=()) -> Kernel:
    """libxsmm_dispatch_meltw_unary analogue (src/libxsmm_main.c:3472).

    Second arg may be a MeltwUnaryShape (the reference signature
    `(unary_type, unary_shape, unary_flags)`) instead of flattened
    m/n/dtypes — in that case pass flags third as in the reference."""
    from ..descriptor import MeltwUnaryShape
    if isinstance(m, MeltwUnaryShape):
        s = m
        if n is not None:        # reference v2 call form: flags ride third
            flags = UnaryFlags(n)
        m, n = s.m, s.n
        in_type, out_type, comp_type = s.in0_type, s.out_type, s.comp_type
    desc = MeltwDescriptor(operation="unary", op_type=op_type,
                           flags=UnaryFlags(flags), m=m, n=n,
                           in_type=in_type, out_type=out_type,
                           comp_type=comp_type, extra=tuple(extra))
    return get_registry().dispatch(desc, _build_unary)


@entry_point
def dispatch_meltw_binary(op_type: BinaryType, m=None, n: int = None,
                          flags: BinaryFlags = BinaryFlags.NONE,
                          in_type: Datatype = Datatype.F32,
                          out_type: Datatype = Datatype.IMPLICIT,
                          comp_type: Datatype = Datatype.F32) -> Kernel:
    """Second arg may be a MeltwBinaryShape (reference v2 signature)."""
    from ..descriptor import MeltwBinaryShape
    in1 = None
    if isinstance(m, MeltwBinaryShape):
        s = m
        if n is not None:        # reference v2 call form: flags ride third
            flags = BinaryFlags(n)
        m, n = s.m, s.n
        in_type, out_type, comp_type = s.in0_type, s.out_type, s.comp_type
        in1 = s.in1_type
    desc = MeltwDescriptor(operation="binary", op_type=op_type,
                           flags=BinaryFlags(flags), m=m, n=n,
                           in_type=in_type, out_type=out_type,
                           comp_type=comp_type, in1_type=in1)
    return get_registry().dispatch(desc, _build_binary)


@entry_point
def dispatch_meltw_ternary(op_type: TernaryType, m=None, n: int = None,
                           flags: TernaryFlags = TernaryFlags.NONE,
                           in_type: Datatype = Datatype.F32,
                           out_type: Datatype = Datatype.IMPLICIT,
                           comp_type: Datatype = Datatype.F32) -> Kernel:
    """Second arg may be a MeltwTernaryShape (reference v2 signature)."""
    from ..descriptor import MeltwTernaryShape
    in1 = in2 = None
    if isinstance(m, MeltwTernaryShape):
        s = m
        if n is not None:        # reference v2 call form: flags ride third
            flags = TernaryFlags(n)
        m, n = s.m, s.n
        in_type, out_type, comp_type = s.in0_type, s.out_type, s.comp_type
        in1, in2 = s.in1_type, s.in2_type
    desc = MeltwDescriptor(operation="ternary", op_type=op_type,
                           flags=TernaryFlags(flags), m=m, n=n,
                           in_type=in_type, out_type=out_type,
                           comp_type=comp_type, in1_type=in1, in2_type=in2)
    return get_registry().dispatch(desc, _build_ternary)
