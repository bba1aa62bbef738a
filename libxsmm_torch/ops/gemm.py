"""Dense GEMM / BRGEMM dispatch — the core of the library.

The port of `libxsmm_tpu/ops/gemm.py`: the reference's GEMM dispatch + JIT
generator family (libxsmm_dispatch_gemm src/libxsmm_main.c:3390,
libxsmm_dispatch_brgemm :3409; generators src/generator_gemm.c:21-1210) as
descriptor-keyed builders of callables over torch tensors.

Routing follows the JAX package's:
  * A single GEMM or a BRGEMM (C = sum_i A_i B_i, one contraction over
    (br, k)) is a plain torch contraction, as the reference leaves it to
    XLA.
  * The independent batched case (C_i = A_i B_i, the xgemm/smmbench
    streaming workload) and the lane-packed layouts run the hand-written
    CUDA kernels of kernels/gemm.py on CUDA tensors, and their plain torch
    versions on CPU tensors. Descriptors the reference routes away from its
    Pallas kernel take the torch route here too.
  * alpha=1, beta in {0,1} exactly as the reference restricts.

Precision: f32 operands multiply in full f32 (the reference's
Precision.HIGHEST); this module never enables TF32. bf16/f16/fp8 operands
are widened to f32 before the product, and i8/u8 accumulate exactly in i32
(through float64 on the card, which has no integer matmul).

Device: a kernel follows the device of its tensors. Functions that make a
tensor from numpy take `device=`, default "cuda" (raising without a GPU).

Invoke contract (functional, no aliasing):
    kernel(a, b)          when BETA_0:      returns C = A@B
    kernel(a, b, c)       otherwise:        returns C = A@B + c
  BRGEMM STRIDE:  a:(br,m,k) b:(br,k,n)
  BRGEMM OFFSET/ADDRESS: kernel(a, b, [c,] a_idx, b_idx) — index arrays into
  the stacked leading dim.

MX and sub-byte operands (GemmShape types MXFP4X2 ... I1X8) arrive packed
along k — A as a payload (..., m, k/pack) [+ scales (..., m, k/32)], B as
(..., k/pack, n) [+ scales (..., k/32, n)] — and are decoded to NORM in
torch before the contraction (bf16, or f32 when a partner is F32), as the
reference decodes in XLA.

dispatch_brgemm_ext is the fused-epilogue BRGEMM: a/b/c unary argops (with
store_ap/store_bp/store_cp side outputs), a binary postop on the f32
accumulator, the RELU bitmask side output and the stochastic-round store,
whose rounding runs the stochastic-round kernel of kernels/eltwise.py on
CUDA tensors.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import quant as q_
from ..descriptor import (BatchReduceConfig, BatchReduceType, BinaryPostops,
                          BinaryType, GemmDescriptor, GemmExtDescriptor,
                          GemmFlags, GemmShape, UnaryArgops, UnaryFlags,
                          UnaryType)
from ..dtypes import Datatype, bits, from_torch, to_torch
from ..kernels import gemm as gemm_kernels
from ..kernels.eltwise import stochastic_round
from ..kernels.gemm import add_acc, contract
from ..registry import (Kernel, KernelInfo, entry_point, get_registry,
                        memo_dispatch)
from .eltwise import (apply_binary_op, apply_unary_op, load_operand,
                      pack_bitmask)


_INT_IN = (Datatype.I8, Datatype.U8, Datatype.I16, Datatype.U16,
           Datatype.I32, Datatype.U32)

# packed GEMM storage dtypes: MX microscaling floats arrive as (payload,
# scales) pairs; sub-byte ints as packed uint8 payloads
_MX_FLOAT = (Datatype.MXFP4X2, Datatype.NVFP4X2, Datatype.MXBF8,
             Datatype.MXBF6, Datatype.MXHF6)
_INT_SUB = (Datatype.I4X2, Datatype.U4X2, Datatype.I2X4, Datatype.I1X8)

_VNNI = GemmFlags.VNNI_A | GemmFlags.VNNI_B | GemmFlags.VNNI_C


def _comp_dtype(shape: GemmShape) -> torch.dtype:
    if shape.comp_type == Datatype.F64:
        return torch.float64
    if ((shape.a_in_type in _INT_IN or shape.a_in_type in _INT_SUB)
            and shape.out_type in _INT_IN):
        # integer GEMM accumulates in i32 (the reference's i8->i32
        # contract, generator_gemm.c dtype gating)
        return torch.int32
    return torch.float32


def _is_packed(shape: GemmShape) -> bool:
    return (shape.a_in_type in _MX_FLOAT + _INT_SUB
            or shape.b_in_type in _MX_FLOAT + _INT_SUB)


def _mx_decode(dt: Datatype, payload, scales) -> torch.Tensor:
    """Decode an MX (payload, scales) pair along the LAST axis -> f32."""
    if dt == Datatype.MXFP4X2:
        return q_.mxfp4_dequantize_blocks(payload, scales)
    if dt == Datatype.NVFP4X2:
        return q_.nvfp4_dequantize_blocks(payload, scales)
    if dt == Datatype.MXBF8:
        return q_.mxbf8_dequantize_blocks(payload, scales)
    if dt == Datatype.MXBF6:
        return q_.mxfp6_dequantize_blocks(payload, scales, "e3m2")
    if dt == Datatype.MXHF6:
        return q_.mxfp6_dequantize_blocks(payload, scales, "e2m3")
    raise ValueError(dt)


def _validate_packed_combo(shape: GemmShape, flags: GemmFlags) -> None:
    """Dtype gating for MX/sub-byte GEMMs, the reference's
    generator_gemm.c:272-296 (MX x MX -> F32 comp) and :41-57, 472-488
    (sub-byte A with I8/U8 or F16 B). Transposes are refused: packed
    payloads are k-contiguous by contract (VNNI_A is accepted and means
    'packed along k', the canonical layout)."""
    a, b, o = shape.a_in_type, shape.b_in_type, shape.out_type
    if flags & (GemmFlags.TRANS_A | GemmFlags.TRANS_B):
        raise ValueError("transposes are unsupported for packed MX/sub-byte "
                         "GEMM operands (k-contiguous payload contract)")
    if a in _MX_FLOAT or b in _MX_FLOAT:
        # MX x MX as the reference; BF16/F32 partners as the JAX package
        # (the decode target follows the partner); F16 partners are refused:
        # MX scales up to 2^127 overflow f16
        if b not in _MX_FLOAT + (Datatype.BF16, Datatype.F32):
            raise ValueError(f"MX GEMM needs an MX, BF16 or F32 B "
                             f"operand (got {b})")
        if a not in _MX_FLOAT + (Datatype.BF16, Datatype.F32):
            raise ValueError(f"MX GEMM needs an MX, BF16 or F32 A "
                             f"operand (got {a})")
        if o not in (Datatype.F32, Datatype.BF16, Datatype.F16):
            raise ValueError(f"MX GEMM output must be F32/BF16/F16 (got {o};"
                             " requantize via UNARY_QUANT if MX storage is"
                             " needed)")
        return
    if a in _INT_SUB:
        if a in (Datatype.I4X2, Datatype.U4X2) and b == Datatype.F16:
            if o not in (Datatype.F16, Datatype.F32):
                raise ValueError("i4 x f16 GEMM outputs F16/F32")
            return
        ok_b = ((Datatype.I8, Datatype.U8) if a != Datatype.I1X8
                else (Datatype.I8,))
        if b not in ok_b:
            raise ValueError(f"{a} GEMM needs B in {ok_b} (got {b}); "
                             "reference gating generator_gemm.c:472-488")
        if o not in (Datatype.I32,):
            raise ValueError(f"{a} x {b} GEMM accumulates to I32 (got {o})")
        return
    raise ValueError(f"unsupported packed combo a={a} b={b}")


def _packed_operand_decoders(shape: GemmShape):
    """(decode_a, decode_b): each turns its operand into a NORM tensor
    (identity for native dtypes).

    Payload layouts (row-major; packing always along k):
      A: payload (..., m, k/pack) [+ scales (..., m, k/32) for MX]
      B: payload (..., k/pack, n) [+ scales (..., k/32, n) for MX]
    MX values decode exactly into bf16 (grid x power-of-two scale carries
    <= 8 significand bits); into f32 when a partner carries f32 data, so
    the two operands share a type. Sub-byte ints decode to int8 (f16 beside
    an F16 B)."""

    a_dt, b_dt = shape.a_in_type, shape.b_in_type
    mx_target = (torch.float32 if Datatype.F32 in (a_dt, b_dt)
                 else torch.bfloat16)

    def _decode(dt, operand, is_b, device):
        if dt in _MX_FLOAT:
            payload, scales = (load_operand(v, device) for v in operand)
            if is_b:
                payload, scales = payload.transpose(-1, -2), scales.transpose(
                    -1, -2)
            dec = _mx_decode(dt, payload.contiguous(),
                             scales.contiguous()).to(mx_target)
            return dec.transpose(-1, -2) if is_b else dec
        p = load_operand(operand, device)
        p = p.transpose(-1, -2) if is_b else p
        dec = q_.unpack_subbyte_gemm(dt, p)
        if b_dt == Datatype.F16:
            dec = dec.to(torch.float16)
        return dec.transpose(-1, -2) if is_b else dec

    def decoder(dt, is_b):
        if dt not in _MX_FLOAT + _INT_SUB:
            return lambda x, device=None: load_operand(x, device)
        return lambda x, device=None: _decode(dt, x, is_b, device)

    return decoder(a_dt, False), decoder(b_dt, True)




def matmul_precision(shape: GemmShape) -> str:
    """Pass-precision policy, in torch.set_float32_matmul_precision's terms.

    f32 (and f64) operands get "highest": full f32, never TF32. BF32
    comp_type (the reference's 19-bit tf32-like mode) gets "high", which
    permits TF32; this module computes it at full f32, which meets that
    accuracy. Narrower operands get "default": they are widened to f32
    before the product."""
    if shape.comp_type == Datatype.BF32:
        return "high"
    f32_in = shape.a_in_type in (Datatype.F32, Datatype.F64)
    return "highest" if f32_in else "default"


def pass_precision(dtype: torch.dtype) -> str:
    """matmul_precision for raw torch dtypes: "highest" for f32/f64
    operands, "default" for narrower ones."""
    return ("highest" if dtype in (torch.float32, torch.float64)
            else "default")


def _maybe_transpose(x: torch.Tensor, trans: bool) -> torch.Tensor:
    return x.permute(*range(x.ndim - 1, -1, -1)) if trans else x


def vnni_factor(dt: Datatype) -> int:
    """Rows interleaved per VNNI group, by element width (the reference's
    layout rule: 2 for 16-bit, 4 for 8-bit, 8 for 4-bit types)."""
    return max(1, 32 // bits(dt))


def _undo_vnni(x: torch.Tensor, dt: Datatype) -> torch.Tensor:
    """Interpret x (leading batch dims allowed) as the VNNI-packed form of a
    NORM (r, c) matrix and return NORM layout (inverse of
    TRANSFORM_NORM_TO_VNNIk: element (i,j) lives at vnni[i//k, j*k+i%k])."""
    f = vnni_factor(dt)
    if f == 1:
        return x
    *lead, rk, ck = x.shape
    y = x.reshape(*lead, rk, ck // f, f).transpose(-1, -2)
    return y.reshape(*lead, rk * f, ck // f)


def _to_vnni(x: torch.Tensor, dt: Datatype) -> torch.Tensor:
    f = vnni_factor(dt)
    if f == 1:
        return x
    *lead, r, c = x.shape
    y = x.reshape(*lead, r // f, f, c).transpose(-1, -2)
    return y.reshape(*lead, r // f, c * f)


def _index(idx, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx) if not isinstance(
        idx, torch.Tensor) else idx, dtype=torch.long, device=device)


def _gemm_core(desc: GemmDescriptor, a, b, c=None, a_idx=None, b_idx=None):
    """Shared math for gemm/brgemm; operands in NORM layout after VNNI."""
    shape = desc.shape
    comp = _comp_dtype(shape)
    br_type = desc.br.br_type

    # VNNI_A/VNNI_B are functional layout contracts: the operand arrives
    # packed as TRANSFORM_NORM_TO_VNNIk produced it and is unpacked to NORM
    # before the contraction (before transposes, the reference's order).
    # For MX/sub-byte storage the flag means "packed along k": those
    # operands were decoded to NORM already.
    if desc.flags & GemmFlags.VNNI_A and shape.a_in_type not in (
            _MX_FLOAT + _INT_SUB):
        a = _undo_vnni(a, shape.a_in_type)
    if desc.flags & GemmFlags.VNNI_B and shape.b_in_type not in (
            _MX_FLOAT + _INT_SUB):
        b = _undo_vnni(b, shape.b_in_type)

    if br_type == BatchReduceType.NONE:
        am = _maybe_transpose(a, desc.trans_a)
        bm = _maybe_transpose(b, desc.trans_b)
        acc = contract(lambda x, y: torch.tensordot(
            x, y, dims=([x.ndim - 1], [0])), am, bm, comp)
    else:
        if br_type in (BatchReduceType.ADDRESS, BatchReduceType.OFFSET):
            # gather the participating slices of the stacked operands
            a = a.index_select(0, _index(a_idx, a.device))
            b = b.index_select(0, _index(b_idx, b.device))
        # (br, m, k) x (br, k, n) -> one contraction over br AND k
        am = a.transpose(1, 2) if desc.trans_a else a
        bm = b.transpose(1, 2) if desc.trans_b else b
        acc = contract(lambda x, y: torch.einsum("bmk,bkn->mn", x, y),
                        am, bm, comp)

    if c is not None:
        acc = add_acc(acc, c)
    return acc


def _finalize_out(acc, shape: GemmShape, flags: GemmFlags = GemmFlags.NONE):
    out = acc.to(to_torch(shape.out_type))
    if flags & GemmFlags.VNNI_C:
        out = _to_vnni(out, shape.out_type)
    return out


def _decoders(shape: GemmShape, flags: GemmFlags):
    """Validate the operand types at dispatch and return the operand
    decoders (the packed ones for MX/sub-byte storage)."""
    if _is_packed(shape):
        _validate_packed_combo(shape, flags)
        return _packed_operand_decoders(shape)
    for dt in (shape.a_in_type, shape.b_in_type, shape.out_type):
        to_torch(dt)  # raises for unsupported storage types
    return (lambda x, device=None: load_operand(x, device),) * 2


def _build_gemm(desc: GemmDescriptor) -> Kernel:
    shape = desc.shape
    decode_a, decode_b = _decoders(shape, desc.flags)

    beta0 = desc.beta == 0
    needs_idx = desc.br.br_type in (BatchReduceType.ADDRESS,
                                    BatchReduceType.OFFSET)

    def run(a, b, c=None, a_idx=None, b_idx=None):
        a = decode_a(a)
        b = decode_b(b, a.device)
        if c is not None:
            c = load_operand(c, a.device)
        acc = _gemm_core(desc, a, b, c, a_idx, b_idx)
        return _finalize_out(acc, shape, desc.flags)

    if beta0:
        if needs_idx:
            def fn(a, b, a_idx, b_idx):
                return run(a, b, None, a_idx, b_idx)
        else:
            def fn(a, b):
                return run(a, b)
    else:
        if needs_idx:
            def fn(a, b, c, a_idx, b_idx):
                return run(a, b, c, a_idx, b_idx)
        else:
            def fn(a, b, c):
                return run(a, b, c)

    nflops = shape.nflops(desc.br.br_count_hint or 1)
    info = KernelInfo(kind="gemm", nflops=nflops, is_reference_kernel=False)
    return Kernel(fn=fn, descriptor=desc, info=info, name=desc.name())


@entry_point
def dispatch_gemm(shape: GemmShape,
                  flags: GemmFlags = GemmFlags.NONE) -> Kernel:
    """libxsmm_dispatch_gemm analogue (src/libxsmm_main.c:3390).

    Repeat dispatches ride the per-thread memo (registry.memo_dispatch, the
    reference's thread-local cache analogue, src/libxsmm_main.c:292-302)."""
    return memo_dispatch(
        get_registry(), ("gemm", shape, flags),
        lambda: GemmDescriptor(shape=shape, flags=GemmFlags(flags)),
        _build_gemm)


@entry_point
def dispatch_brgemm(shape: GemmShape,
                    flags: GemmFlags = GemmFlags.NONE,
                    br_config: BatchReduceConfig = None) -> Kernel:
    """libxsmm_dispatch_brgemm analogue (src/libxsmm_main.c:3409)."""
    if br_config is None:
        br_config = BatchReduceConfig(br_type=BatchReduceType.STRIDE)
    return memo_dispatch(
        get_registry(), ("brgemm", shape, flags, br_config),
        lambda: GemmDescriptor(shape=shape, flags=GemmFlags(flags),
                               br=br_config),
        _build_gemm)


# ---------------------------------------------------------------------------
# BRGEMM-ext: fused argops/postops epilogues
# ---------------------------------------------------------------------------

def _build_gemm_ext(desc: GemmExtDescriptor) -> Kernel:
    base = desc.base
    shape = base.shape
    argops, postops = desc.argops, desc.postops
    # MX/sub-byte packed operands are decoded to NORM as _build_gemm does;
    # a/b argops on them are refused: a unary on an undecoded payload has
    # no reference meaning
    if _is_packed(shape) and (argops.ap_type != UnaryType.NONE
                              or argops.bp_type != UnaryType.NONE):
        _validate_packed_combo(shape, base.flags)
        raise ValueError("a/b argops are not supported on MX/sub-byte "
                         "packed operands (decode happens inside the "
                         "kernel; apply eltwise ops to NORM data)")
    decode_a, decode_b = _decoders(shape, base.flags)
    beta0 = base.beta == 0
    needs_idx = base.br.br_type in (BatchReduceType.ADDRESS,
                                    BatchReduceType.OFFSET)
    has_d = postops.d_type != BinaryType.NONE
    cp_bitmask = bool(argops.cp_flags & UnaryFlags.BITMASK_2BYTEMULT)
    cp_stochastic = argops.cp_type == UnaryType.STOCHASTIC_ROUND

    def run(a, b, c=None, d=None, a_idx=None, b_idx=None, seed=0):
        extra = {}
        a = decode_a(a)
        b = decode_b(b, a.device)
        if c is not None:
            c = load_operand(c, a.device)
        if argops.ap_type != UnaryType.NONE:
            a = apply_unary_op(argops.ap_type, argops.ap_flags, a)
            if argops.store_ap:
                extra["ap"] = a
        if argops.bp_type != UnaryType.NONE:
            b = apply_unary_op(argops.bp_type, argops.bp_flags, b)
            if argops.store_bp:
                extra["bp"] = b
        acc = _gemm_core(base, a, b, c, a_idx, b_idx)
        if argops.store_cp:
            # cp is stored before the postops
            extra["cp"] = _finalize_out(acc, shape, base.flags)
        if has_d:
            if d is None:
                raise ValueError("postop configured but no d operand passed")
            acc = apply_binary_op(postops.d_type, postops.d_flags, acc,
                                  load_operand(d, acc.device).to(acc.dtype))
        if cp_stochastic:
            # the fused stochastic-round store, after the postops
            out = stochastic_round(acc, seed, shape.out_type)
            if base.flags & GemmFlags.VNNI_C:
                out = _to_vnni(out, shape.out_type)
        else:
            if argops.cp_type != UnaryType.NONE:
                if argops.cp_type == UnaryType.RELU and cp_bitmask:
                    # the mask of acc > 0 before the relu, in the
                    # reference's packed bit layout (RELU_INV reads it)
                    extra["cp_bitmask"] = pack_bitmask(acc > 0)
                acc = apply_unary_op(argops.cp_type, argops.cp_flags, acc)
            out = _finalize_out(acc, shape, base.flags)
        return (out, extra) if extra else out

    def fn(a, b, *rest, seed=0):
        rest = list(rest)
        c = rest.pop(0) if not beta0 else None
        d = rest.pop(0) if has_d else None
        a_idx, b_idx = (rest[0], rest[1]) if needs_idx else (None, None)
        return run(a, b, c, d, a_idx, b_idx, seed)

    nflops = shape.nflops(base.br.br_count_hint or 1)
    info = KernelInfo(kind="gemm_ext", nflops=nflops)
    return Kernel(fn=fn, descriptor=desc, info=info, name=desc.name())


@entry_point
def dispatch_brgemm_ext(shape: GemmShape,
                        flags: GemmFlags = GemmFlags.NONE,
                        br_config: BatchReduceConfig = None,
                        argops: UnaryArgops = UnaryArgops(),
                        postops: BinaryPostops = BinaryPostops()) -> Kernel:
    """libxsmm_dispatch_brgemm_ext analogue (src/libxsmm_main.c:3428).

    The fused-epilogue factory: C = store(cp(postop(sum_i ap(A_i) bp(B_i)
    [+ C0], D))). Invoke: kernel(a, b, [c,] [d,] [a_idx, b_idx,] seed=0)
    — c when beta=1, d when a binary postop is set (any operand
    broadcastable to (m, n), e.g. a (1, n) bias), the index arrays in
    OFFSET/ADDRESS mode. Returns the output, or (output, extra) when a
    side output is configured: extra["ap"]/["bp"]/["cp"] under
    store_ap/store_bp/store_cp (cp before the postops), extra["cp_bitmask"]
    for RELU with BITMASK_2BYTEMULT. cp STOCHASTIC_ROUND stores the
    postop'd f32 accumulator to out_type by stochastic rounding with
    `seed` (the kernel of kernels/eltwise.py on CUDA tensors)."""
    if br_config is None:
        br_config = BatchReduceConfig(br_type=BatchReduceType.STRIDE)
    desc = GemmExtDescriptor(
        base=GemmDescriptor(shape=shape, flags=GemmFlags(flags), br=br_config),
        argops=argops, postops=postops)
    return get_registry().dispatch(desc, _build_gemm_ext)


@entry_point
def dispatch_tilecfg_gemm(shape: GemmShape,
                          flags: GemmFlags = GemmFlags.NONE) -> Kernel:
    """API-parity analogue of libxsmm_dispatch_tilecfg_gemm
    (src/libxsmm_main.c:3355): AMX tile configuration has no GPU
    equivalent, so this returns a no-op kernel."""
    desc = GemmDescriptor(shape=shape,
                          flags=GemmFlags(flags) | GemmFlags.NO_RESET_TILECONFIG)

    def _build(d):
        info = KernelInfo(kind="tilecfg", nflops=0)
        return Kernel(fn=lambda *a, **k: None, descriptor=d, info=info,
                      name=d.name() + "_tilecfg")

    return get_registry().dispatch(desc, _build)


# ---------------------------------------------------------------------------
# Batched independent small GEMM (the xgemm/smmbench streaming workload)
# ---------------------------------------------------------------------------

def _batched_torch(desc: GemmDescriptor):
    """The route for descriptors the batched kernel does not take: one
    batched torch contraction (the reference's XLA batched dot)."""
    shape = desc.shape
    comp = _comp_dtype(shape)
    out_dt = to_torch(shape.out_type)

    def fn(a, b, c=None):
        am = a.transpose(1, 2) if desc.trans_a else a
        bm = b.transpose(1, 2) if desc.trans_b else b
        acc = contract(torch.matmul, am, bm, comp)
        if c is not None:
            acc = add_acc(acc, c)
        return acc.to(out_dt)

    return fn


@functools.lru_cache(maxsize=None)
def _batched_kernel(desc: GemmDescriptor, batch: int, use_kernel: bool,
                    config=None):
    if use_kernel:
        fn = gemm_kernels.build_batched_gemm(desc, batch, config)
        if fn is not None:
            return fn
    return _batched_torch(desc)


@entry_point
def dispatch_gemm_batched(shape: GemmShape,
                          flags: GemmFlags = GemmFlags.NONE,
                          batch: int = 0,
                          tune: bool = False) -> Kernel:
    """Batched independent small GEMMs: C[i] = A[i]@B[i] (+ C0[i]).

    One CUDA kernel streams the problems through a ring of shared memory
    (kernels/gemm.py build_batched_gemm, batched_plan); descriptors it does
    not take run one batched torch contraction. a:(B,m,k) b:(B,k,n).

    tune=True times the kernel's launch configurations on CUDA operands at
    the first invocation per batch size and keeps the fastest; it never
    swaps the kernel for a library call. On CPU operands there is nothing
    to choose."""
    if GemmFlags(flags) & _VNNI:
        # neither the kernel nor the torch route applies the VNNI layout
        # contract dispatch_gemm honours
        raise ValueError("VNNI flags are not supported by the batched SMM "
                         "entry; use dispatch_gemm per item or NORM layout")
    desc = GemmDescriptor(shape=shape, flags=GemmFlags(flags))

    def _build(d):
        chosen = {}

        def pick(bsz, a, b, c):
            from ..utils.timer import bench_chain
            default = _batched_kernel(d, bsz, True)
            if (a.device.type != "cuda"
                    or gemm_kernels.build_batched_gemm(d, bsz) is None):
                return default
            args = (a, b) if c is None else (a, b, c)
            best_fn, best_t = default, float("inf")
            sh = d.shape
            for cfg in gemm_kernels.batched_gemm_configs(
                    sh.m, sh.n, sh.k, to_torch(sh.a_in_type)):
                fn_ = _batched_kernel(d, bsz, True, cfg)
                t = bench_chain(fn_, args, reps=6)
                if t < best_t:
                    best_fn, best_t = fn_, t
            return best_fn

        def fn(a, b, c=None):
            if c is not None and d.beta == 0:
                raise ValueError("c operand passed to a BETA_0 batched "
                                 "GEMM (dispatch without BETA_0 for C+=)")
            if c is None and d.beta != 0:
                raise ValueError("beta=1 batched GEMM needs the C operand "
                                 "(dispatch with BETA_0 for C=)")
            a = load_operand(a)
            b = load_operand(b, a.device)
            c = None if c is None else load_operand(c, a.device)
            bsz = a.shape[0]
            inner = chosen.get(bsz)
            if inner is None:
                inner = (pick(bsz, a, b, c) if tune
                         else _batched_kernel(d, bsz, True))
                chosen[bsz] = inner
            if c is None:
                return inner(a, b)
            return inner(a, b, c)

        if batch and not tune:
            # pre-build for the announced batch size (dispatch-time work)
            chosen[batch] = _batched_kernel(d, batch, True)

        info = KernelInfo(kind="gemm_batched", nflops=d.shape.nflops())
        return Kernel(fn=fn, descriptor=d, info=info,
                      name=d.name() + "_batched")

    key = ("batched", desc, bool(tune))
    return get_registry().dispatch(key, lambda _k: _build(desc))


# ---------------------------------------------------------------------------
# Lane-packed BRGEMM
# ---------------------------------------------------------------------------

def brgemm_pack_factor(shape: GemmShape) -> int:
    """Lane-pack factor Q for the packed BRGEMM layout (128//k)."""
    if 128 % shape.k:
        raise ValueError(f"packed BRGEMM needs k | 128 (got k={shape.k})")
    return 128 // shape.k


class _PackedBrgemmGrad(torch.autograd.Function):
    """Packed BRGEMM forward (the kernel) with a plain torch backward:
    dA_i = dC @ B_i^T, dB_i = A_i^T @ dC on the per-item view of the packed
    A (the reference's custom VJP, libxsmm_tpu/ops/gemm.py:682-706)."""

    @staticmethod
    def forward(ctx, a, b, core, q):
        ctx.save_for_backward(a, b)
        ctx.q = q
        return core(a, b)

    @staticmethod
    def backward(ctx, dout):
        a, b = ctx.saved_tensors
        q = ctx.q
        g, m, qk = a.shape
        br, k, _ = b.shape
        ai = (a.reshape(g, m, q, k).permute(0, 2, 1, 3)
              .reshape(br, m, k)).float()
        d32 = dout.float()
        da_i = torch.einsum("mn,bkn->bmk", d32, b.float())
        db = torch.einsum("bmk,mn->bkn", ai, d32)
        da = (da_i.reshape(g, q, m, k).permute(0, 2, 1, 3)
              .reshape(g, m, qk))
        return da.to(a.dtype), db.to(b.dtype), None, None


@entry_point
def dispatch_brgemm_packed(shape: GemmShape,
                           flags: GemmFlags = GemmFlags.NONE,
                           br_config: BatchReduceConfig = None,
                           step_groups: int = None,
                           pack_q: int = None,
                           acc_scratch: bool = False) -> Kernel:
    """Batch-reduce GEMM on the lane-packed A layout.

    C = sum_i A_i @ B_i with A in pack_batched(a, Q) layout (Q = 128//k by
    default, or pack_q, a multiple of it); b stays in the natural (br, k,
    n) layout; kernel(a_packed, b[, c]) -> (m, n). The CUDA kernel is
    kernels/gemm.py build_packed_brgemm; step_groups sets the groups each
    block reduces, acc_scratch is accepted and changes nothing. Each gives
    the reference's result. Differentiable (plain torch backward)."""
    if br_config is None:
        br_config = BatchReduceConfig(br_type=BatchReduceType.STRIDE)
    desc = GemmDescriptor(shape=shape, flags=GemmFlags(flags), br=br_config)
    if GemmFlags(flags) & _VNNI:
        raise ValueError("VNNI flags are not supported by the packed "
                         "BRGEMM entry (NORM layout only)")
    if not gemm_kernels.packed_brgemm_supported(desc):
        raise ValueError(f"unsupported for packed BRGEMM: {desc.name()} "
                         "(need k|128, f32/bf16, no transposes)")

    def _build(d):
        built = {}
        q = int(pack_q) if pack_q else 128 // d.shape.k
        out_dt = to_torch(d.shape.out_type)

        def _make(br):
            d0 = dataclasses.replace(d, flags=GemmFlags(d.flags)
                                     | GemmFlags.BETA_0)
            core = gemm_kernels.build_packed_brgemm(
                d0, br, step_groups, pack_q=pack_q, acc_scratch=acc_scratch)
            if core is None:
                raise ValueError(f"br={br} not compatible with pack "
                                 f"factor {q} (need br % q == 0 and "
                                 f"q a multiple of {128 // d.shape.k})")

            def wrapper(a, b, c=None):
                out = _PackedBrgemmGrad.apply(a, b, core, q)
                if c is not None:
                    out = (out.to(torch.float32)
                           + c.to(torch.float32)).to(out_dt)
                return out

            return wrapper

        def fn(a, b, c=None):
            if c is not None and d.beta == 0:
                raise ValueError("c operand passed to a BETA_0 packed "
                                 "BRGEMM")
            if c is None and d.beta != 0:
                raise ValueError("beta=1 packed BRGEMM needs the C operand "
                                 "(dispatch with BETA_0 for C=)")
            a = load_operand(a)
            b = load_operand(b, a.device)
            c = None if c is None else load_operand(c, a.device)
            br = b.shape[0]
            inner = built.get(br)
            if inner is None:
                built[br] = inner = _make(br)
            return inner(a, b) if c is None else inner(a, b, c)

        info = KernelInfo(kind="brgemm_packed", nflops=d.shape.nflops())
        return Kernel(fn=fn, descriptor=d, info=info,
                      name=d.name() + "_brpacked")

    key = ("brgemm_packed", desc, step_groups, pack_q, acc_scratch)
    return get_registry().dispatch(key, lambda _k: _build(desc))


@entry_point
def dispatch_brgemm_ext_packed(shape: GemmShape,
                               flags: GemmFlags = GemmFlags.NONE,
                               br_config: BatchReduceConfig = None,
                               argops: UnaryArgops = UnaryArgops(),
                               postops: BinaryPostops = BinaryPostops(),
                               step_groups: int = None,
                               pack_q: int = None,
                               acc_scratch: bool = False) -> Kernel:
    """BRGEMM-ext on the lane-packed path: the fused-epilogue kernel.

    The packed BRGEMM kernel with the cp-unary epilogue and the binary ADD
    postop fused into its final pass (the reference's fused AMX microkernel
    epilogues, generator_gemm_amx_microkernel.c). beta=1's C seeds the sum
    before the epilogue.

    Supported ext subset: cp_type in the elementwise epilogue set, no a/b
    argops, no store_*, postop NONE or ADD with an (m, n)-broadcastable D.
    Invoke: kernel(a_packed, b[, c][, d_op]) with a packed via pack_batched
    (Q = 128//k, or pack_q), b (br, k, n), c/d (m, n).
    """
    if br_config is None:
        br_config = BatchReduceConfig(br_type=BatchReduceType.STRIDE)
    desc = GemmExtDescriptor(
        base=GemmDescriptor(shape=shape, flags=GemmFlags(flags),
                            br=br_config),
        argops=argops, postops=postops)
    if argops.ap_type != UnaryType.NONE or argops.bp_type != UnaryType.NONE:
        raise ValueError("packed BRGEMM-ext fuses cp/postops only; a/b "
                         "argops need dispatch_brgemm_ext")
    if argops.store_ap or argops.store_bp or argops.store_cp:
        raise ValueError("store_* argops are not supported on the packed "
                         "fast path")
    cp = UnaryType(argops.cp_type).name
    if cp not in gemm_kernels._EPILOGUES:
        raise ValueError(f"unsupported packed epilogue {cp} "
                         f"(supported: {sorted(gemm_kernels._EPILOGUES)})")
    with_bias = postops.d_type != BinaryType.NONE
    if with_bias and postops.d_type != BinaryType.ADD:
        raise ValueError("packed BRGEMM-ext supports the ADD binary postop "
                         "only (bias)")
    if not gemm_kernels.packed_brgemm_supported(desc.base):
        raise ValueError(f"unsupported for packed BRGEMM: "
                         f"{desc.base.name()} (need k|128, f32/bf16, "
                         "no transposes)")

    def _build(d):
        built = {}
        q = int(pack_q) if pack_q else 128 // shape.k
        m, n = shape.m, shape.n

        def fn(a, b, c=None, d_op=None):
            a = load_operand(a)
            b = load_operand(b, a.device)
            c = None if c is None else load_operand(c, a.device)
            br = b.shape[0]
            inner = built.get(br)
            if inner is None:
                inner = gemm_kernels.build_packed_brgemm(
                    desc.base, br, step_groups, cp_type=cp,
                    with_bias=with_bias, pack_q=pack_q,
                    acc_scratch=acc_scratch)
                if inner is None:
                    raise ValueError(f"br={br} not compatible with pack "
                                     f"factor {q}")
                built[br] = inner
            if desc.base.beta == 1 and c is None:
                raise ValueError("beta=1 requires the C operand")
            if desc.base.beta == 0 and c is not None:
                # a forwarded C would land after the epilogue, matching
                # neither beta=1 seeding nor beta=0 (C unread) — reject it
                raise ValueError("c operand passed to a BETA_0 packed "
                                 "BRGEMM-ext")
            d_full = None
            if with_bias:
                if d_op is None:
                    raise ValueError("ADD postop requires the D operand")
                d_full = torch.broadcast_to(load_operand(d_op, a.device),
                                            (m, n))
            return inner(a, b, c, d_full)

        info = KernelInfo(kind="brgemm_ext_packed", nflops=shape.nflops())
        return Kernel(fn=fn, descriptor=d, info=info,
                      name=desc.base.name() + f"_extpacked_{cp.lower()}"
                      + ("_bias" if with_bias else ""))

    key = ("brgemm_ext_packed", desc, step_groups, pack_q, acc_scratch)
    return get_registry().dispatch(key, lambda _k: _build(desc))


# ---------------------------------------------------------------------------
# Lane-packed batched SMM (the headline)
# ---------------------------------------------------------------------------

def smm_pack_factor(shape: GemmShape) -> int:
    """Lane-pack factor P for the packed batched SMM layout (128//n)."""
    if shape.k != shape.n or 128 % shape.n:
        raise ValueError("packed SMM needs k == n and n | 128 "
                         f"(got n={shape.n} k={shape.k})")
    return 128 // shape.n


def pack_batched(x, p: int, device=None) -> torch.Tensor:
    """(B, r, c) -> lane-packed (B//p, r, p*c): p consecutive problems side
    by side along the last axis (the reference's SOA packing,
    src/generator_packed_gemm_common.c); inverse: unpack_batched. A tensor
    stays on its device (`device` is ignored); a numpy array is loaded onto
    `device` (default: the GPU)."""
    x = load_operand(x, device)
    bsz, r, c = x.shape
    if bsz % p:
        raise ValueError(f"batch {bsz} not divisible by pack factor {p}")
    return (x.reshape(bsz // p, p, r, c).permute(0, 2, 1, 3)
            .reshape(bsz // p, r, p * c))


def unpack_batched(x, p: int, device=None) -> torch.Tensor:
    """Inverse of pack_batched: (G, r, p*c) -> (G*p, r, c)."""
    x = load_operand(x, device)
    g, r, pc = x.shape
    c = pc // p
    return (x.reshape(g, r, p, c).permute(0, 2, 1, 3)
            .reshape(g * p, r, c))


def _per_item(x: torch.Tensor, p: int) -> torch.Tensor:
    """(G, r, p*c) -> (G*p, r, c)."""
    gg, r, pc = x.shape
    return (x.reshape(gg, r, p, pc // p).permute(0, 2, 1, 3)
            .reshape(gg * p, r, pc // p))


def _to_packed(x: torch.Tensor, p: int) -> torch.Tensor:
    """Inverse of _per_item."""
    gp, r, c = x.shape
    return (x.reshape(gp // p, p, r, c).permute(0, 2, 1, 3)
            .reshape(gp // p, r, p * c))


class _PackedSmmGrad(torch.autograd.Function):
    """Packed SMM forward (the kernel) with a plain torch backward on the
    per-item view: dA_i = dC_i B_i^T, dB_i = A_i^T dC_i (the reference's
    custom VJP, libxsmm_tpu/ops/gemm.py:967-986)."""

    @staticmethod
    def forward(ctx, a, b, core, p):
        ctx.save_for_backward(a, b)
        ctx.p = p
        return core(a, b)

    @staticmethod
    def backward(ctx, dout):
        a, b = ctx.saved_tensors
        p = ctx.p
        ai = _per_item(a, p).float()
        bi = _per_item(b, p).float()
        di = _per_item(dout, p).float()
        da = torch.einsum("gmn,gkn->gmk", di, bi)
        db = torch.einsum("gmk,gmn->gkn", ai, di)
        return (_to_packed(da, p).to(a.dtype),
                _to_packed(db, p).to(b.dtype), None, None)


def _dispatch_packed_smm(shape: GemmShape, flags: GemmFlags, cp: str,
                         step_groups, rpt) -> Kernel:
    """dispatch_gemm_batched_packed after validation, for one launch
    configuration `rpt` (None: the kernel's default)."""
    desc = GemmDescriptor(shape=shape, flags=GemmFlags(flags))

    def _build(d):
        built = {}
        p = 128 // d.shape.n
        out_dt = to_torch(d.shape.out_type)
        # transcendental epilogues keep the raw (non-differentiable) path;
        # NONE/IDENTITY get an autograd Function so the kernel is trainable
        differentiable = cp in ("NONE", "IDENTITY")

        def _make(g):
            if not differentiable:
                return gemm_kernels.build_packed_batched_gemm(
                    d, g, cp, step_groups, rpt)
            # beta0 core kernel; the beta=1 c-add happens outside the
            # kernel, where autograd differentiates it natively
            d0 = dataclasses.replace(d, flags=GemmFlags(d.flags)
                                     | GemmFlags.BETA_0)
            core = gemm_kernels.build_packed_batched_gemm(
                d0, g, cp, step_groups, rpt)

            def wrapper(a, b, c=None):
                out = _PackedSmmGrad.apply(a, b, core, p)
                if c is not None:
                    out = (out.to(torch.float32)
                           + c.to(torch.float32)).to(out_dt)
                return out

            return wrapper

        def fn(a, b, c=None):
            if c is not None and d.beta == 0:
                raise ValueError("c operand passed to a BETA_0 packed SMM")
            if c is None and d.beta != 0:
                raise ValueError("beta=1 packed SMM needs the C operand "
                                 "(dispatch with BETA_0 for C=)")
            a = load_operand(a)
            b = load_operand(b, a.device)
            c = None if c is None else load_operand(c, a.device)
            g = a.shape[0]
            if g == 0:            # empty batch: no kernel to launch
                return torch.zeros((0, d.shape.m, p * d.shape.n),
                                   dtype=out_dt, device=a.device)
            inner = built.get(g)
            if inner is None:
                built[g] = inner = _make(g)
            return inner(a, b) if c is None else inner(a, b, c)

        info = KernelInfo(kind="gemm_batched_packed",
                          nflops=d.shape.nflops() * p)
        return Kernel(fn=fn, descriptor=d, info=info,
                      name=d.name() + f"_packed{p}"
                      + ("" if cp == "NONE" else f"_{cp.lower()}"))

    key = ("batched_packed", desc, cp, step_groups, rpt)
    return get_registry().dispatch(key, lambda _k: _build(desc))


@entry_point
def dispatch_gemm_batched_packed(shape: GemmShape,
                                 flags: GemmFlags = GemmFlags.NONE,
                                 cp_type: UnaryType = UnaryType.NONE,
                                 step_groups: int = None,
                                 tune: bool = False) -> Kernel:
    """Batched independent small GEMMs on the lane-packed layout.

    The headline SMM path: operands stay in the pack_batched layout end to
    end — a:(G,m,P*k) b:(G,k,P*n) [c:(G,m,P*n)] -> (G,m,P*n), P = 128//n.
    Requires k == n, n | 128, f32/bf16/int8 (kernels/gemm.py
    build_packed_batched_gemm).

    cp_type fuses a unary epilogue (RELU/GELU/TANH/SIGMOID/X2) onto the
    accumulator inside the kernel. step_groups is accepted and changes
    nothing (one block takes one group).

    tune=True times the kernel's launch configurations on CUDA operands at
    the first invocation per group count and keeps the fastest; on CPU
    operands there is nothing to choose.
    """
    # validate before the tune return so both paths fail at dispatch time
    desc = GemmDescriptor(shape=shape, flags=GemmFlags(flags))
    if GemmFlags(flags) & _VNNI:
        raise ValueError("VNNI flags are not supported by the packed SMM "
                         "entry (NORM layout only)")
    if not gemm_kernels.packed_smm_supported(desc):
        raise ValueError(f"unsupported for packed SMM: {desc.name()} "
                         "(need k==n, n|128, f32/bf16/i8, no transposes)")
    cp = UnaryType(cp_type).name
    if cp not in gemm_kernels._EPILOGUES:
        raise ValueError(f"unsupported packed-SMM epilogue: {cp} "
                         f"(supported: {sorted(gemm_kernels._EPILOGUES)})")
    if (shape.a_in_type == Datatype.I8
            and cp not in ("NONE", "IDENTITY", "RELU", "X2")):
        raise ValueError(f"epilogue {cp} is float-only (int8 kernel)")

    if not (tune and step_groups is None):
        return _dispatch_packed_smm(shape, flags, cp, step_groups, None)

    picked = {}

    def _tuned_fn(a, b, c=None):
        g = a.shape[0]
        kern = picked.get(g)
        if kern is None:
            kern = _dispatch_packed_smm(shape, flags, cp, None, None)
            if a.device.type == "cuda" and g > 0:
                from ..utils.timer import bench_chain
                args = (a, b) if c is None else (a, b, c)
                best_t = float("inf")
                for rpt in gemm_kernels.packed_smm_configs(shape.m):
                    cand = _dispatch_packed_smm(shape, flags, cp, None, rpt)
                    t = bench_chain(cand, args, reps=12)
                    if t < best_t:
                        kern, best_t = cand, t
            picked[g] = kern
        return kern(a, b) if c is None else kern(a, b, c)

    p = 128 // shape.n
    info = KernelInfo(kind="gemm_batched_packed", nflops=shape.nflops() * p)
    return get_registry().dispatch(
        ("batched_packed_tuned", desc, cp),
        lambda _k: Kernel(fn=_tuned_fn, descriptor=desc, info=info,
                          name=desc.name() + f"_packed{p}_tuned"))


# ---------------------------------------------------------------------------
# BLAS-style convenience (libxsmm_?gemm, src/libxsmm_main.c:3933)
# ---------------------------------------------------------------------------

@entry_point
def xmmdispatch(descriptor):
    """libxsmm_xmmdispatch analogue (src/libxsmm_main.c:3323): dispatch
    directly from a pre-built descriptor."""
    builder = (_build_gemm_ext if isinstance(descriptor, GemmExtDescriptor)
               else _build_gemm)
    return get_registry().dispatch(descriptor, builder)


def gemm(a, b, c=None, *, trans_a: bool = False, trans_b: bool = False,
         beta: int = None, device=None):
    """Dispatch+invoke in one call, like libxsmm_dgemm/sgemm. Tensors stay
    on their device; numpy operands are loaded onto `device` (default: the
    GPU)."""
    a = load_operand(a, device)
    b = load_operand(b, a.device)
    c = None if c is None else load_operand(c, a.device)
    m = a.shape[1] if trans_a else a.shape[0]
    k = a.shape[0] if trans_a else a.shape[1]
    n = b.shape[0] if trans_b else b.shape[1]
    if beta is None:
        beta = 0 if c is None else 1
    flags = GemmFlags.NONE
    if trans_a:
        flags |= GemmFlags.TRANS_A
    if trans_b:
        flags |= GemmFlags.TRANS_B
    if beta == 0:
        flags |= GemmFlags.BETA_0
    adt = from_torch(a.dtype)
    bdt = from_torch(b.dtype)
    odt = from_torch(c.dtype) if c is not None else adt
    shape = GemmShape(m=m, n=n, k=k, a_in_type=adt, b_in_type=bdt,
                      out_type=odt)
    kernel = dispatch_gemm(shape, flags)
    if beta == 0:
        return kernel(a, b)
    return kernel(a, b, c)


def _typed(x, dtype, device):
    return None if x is None else load_operand(x, device).to(dtype)


def sgemm(a, b, c=None, device=None, **kw):
    a = _typed(a, torch.float32, device)
    return gemm(a, _typed(b, torch.float32, a.device),
                _typed(c, torch.float32, a.device), **kw)


def dgemm(a, b, c=None, device=None, **kw):
    a = _typed(a, torch.float64, device)
    return gemm(a, _typed(b, torch.float64, a.device),
                _typed(c, torch.float64, a.device), **kw)
