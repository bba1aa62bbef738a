"""Generator entry points — the libxsmm_generator_* analogues.

The port of `libxsmm_tpu/generator.py`. The reference's generators
(include/libxsmm_generator.h:100-211) fill a ``libxsmm_generated_code``
buffer with machine code (or asm/C text for the legacy CLI paths); the JAX
package returns the lowered StableHLO module instead. The port's counterpart
is the text of `Kernel.lower_text` (lowering.py): one call of the kernel on
zero operands, with the aten operators it dispatched and, on the card, the
hand-written CUDA kernels it launched, their resources and their SASS. Each
``generator_*`` entry drives the same builders the dispatch layer uses and
returns a :class:`GeneratedCode` carrying that text.

Example operands are meta tensors derived from the descriptor (the JAX
package's ShapeDtypeStructs); the call runs on `device` (default: the card;
pass device="cpu" to run the plain versions on the CPU). The
``*_reference_kernel`` twins are the portable oracle: the plain versions,
built outside the registry and lowered on the CPU.

Failures raise :class:`XsmmGeneratorError` carrying a numeric code that
:func:`strerror` translates, mirroring ``libxsmm_strerror``
(include/libxsmm_generator.h:100-102, codes in src/generator_common.h).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from .descriptor import (BatchReduceType, GemmDescriptor, GemmFlags,
                         GemmShape, MeltwDescriptor, SpgemmConfig)
from .dtypes import Datatype, to_torch

# --------------------------------------------------------------------------
# error codes + strerror (libxsmm_strerror analogue)
# --------------------------------------------------------------------------

ERR_GENERAL = 90000            # LIBXSMM_ERR_GENERAL
ERR_UNSUP_DATATYPE = 90011     # unsupported datatype combination
ERR_UNSUP_DESCRIPTOR = 90012   # descriptor kind this generator cannot serve
ERR_TRACE_FAILED = 90013       # tracing with derived example avals failed
ERR_BAD_INPUT_FILE = 90014     # CLI path: unreadable .mtx input

_ERRORS = {
    ERR_GENERAL: "general error",
    ERR_UNSUP_DATATYPE: "unsupported datatype (no storage mapping)",
    ERR_UNSUP_DESCRIPTOR: "descriptor kind unsupported by this generator",
    ERR_TRACE_FAILED: ("could not derive example operands for this "
                       "descriptor; pass example_args explicitly"),
    ERR_BAD_INPUT_FILE: "could not read sparse input file",
}


def strerror(error_code: int) -> str:
    """libxsmm_strerror analogue (include/libxsmm_generator.h:100-102)."""
    return _ERRORS.get(int(error_code), f"unknown error {error_code}")


class XsmmGeneratorError(RuntimeError):
    """Generator failure with a numeric code (see strerror)."""

    def __init__(self, code: int, detail: str = ""):
        self.code = code
        msg = strerror(code)
        super().__init__(f"[{code}] {msg}" + (f": {detail}" if detail
                                              else ""))


@dataclasses.dataclass
class GeneratedCode:
    """libxsmm_generated_code analogue (include/libxsmm_generator.h:77-98).

    ``code`` holds the text of one call of the kernel (lowering.py);
    ``code_size`` mirrors the reference's byte count; ``arch`` is the
    device geometry ("h100" or "cpu") in force when it was made."""

    code: str
    arch: str
    kind: str
    routine_name: str = ""
    is_reference_kernel: bool = False

    @property
    def code_size(self) -> int:
        return len(self.code)


def _arch() -> str:
    from .device import get_geometry
    return get_geometry().name


def _device(device):
    """The device a generator's call runs on: `device`, else the card
    (raises without one)."""
    from .device import resolve_device
    return resolve_device(device)


def _lower(kernel, example_args: Sequence, kind: str, device,
           reference: bool = False) -> GeneratedCode:
    try:
        text = kernel.lower_text(*example_args, device=device)
    except XsmmGeneratorError:
        raise
    except Exception as e:                       # shape or operand errors
        raise XsmmGeneratorError(ERR_TRACE_FAILED, str(e)) from e
    return GeneratedCode(code=text, arch=_arch(), kind=kind,
                         routine_name=kernel.name,
                         is_reference_kernel=reference
                         or kernel.info.is_reference_kernel)


# --------------------------------------------------------------------------
# example operands (the descriptor fully determines shapes): meta tensors
# --------------------------------------------------------------------------

def _aval(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _dtypes(*dts):
    try:
        return tuple(to_torch(dt) for dt in dts)
    except Exception as e:
        raise XsmmGeneratorError(ERR_UNSUP_DATATYPE, str(e)) from e


def _gemm_example_avals(desc: GemmDescriptor):
    s = desc.shape
    adt, bdt, odt = _dtypes(s.a_in_type, s.b_in_type, s.out_type)
    a_shape = ((s.k, s.m) if desc.flags & GemmFlags.TRANS_A
               else (s.m, s.k))
    b_shape = ((s.n, s.k) if desc.flags & GemmFlags.TRANS_B
               else (s.k, s.n))
    # VNNI-packed operands: the flag and the dtype's pack factor determine
    # the stored shape ((r, c) -> (r//f, c*f), ops/gemm._undo_vnni), by the
    # same factor helper the kernel uses
    from .ops.gemm import vnni_factor as _vf
    if desc.flags & GemmFlags.VNNI_A:
        f = _vf(s.a_in_type)
        a_shape = (a_shape[0] // f, a_shape[1] * f)
    if desc.flags & GemmFlags.VNNI_B:
        f = _vf(s.b_in_type)
        b_shape = (b_shape[0] // f, b_shape[1] * f)
    br = desc.br.br_type
    hint = desc.br.br_count_hint or 4
    avals = []
    if br == BatchReduceType.NONE:
        avals += [_aval(a_shape, adt), _aval(b_shape, bdt)]
    else:
        avals += [_aval((hint,) + a_shape, adt),
                  _aval((hint,) + b_shape, bdt)]
    if desc.beta != 0:
        avals.append(_aval((s.m, s.n), odt))
    if br in (BatchReduceType.ADDRESS, BatchReduceType.OFFSET):
        avals += [_aval((hint,), torch.int32), _aval((hint,), torch.int32)]
    return avals


def generator_gemm_kernel(descriptor: GemmDescriptor,
                          example_args: Optional[Sequence] = None,
                          device=None) -> GeneratedCode:
    """libxsmm_generator_gemm_kernel analogue (src/generator_gemm.c:21):
    run the descriptor's GEMM/BRGEMM through the kernel dispatch returns
    and return its text."""
    from .ops.gemm import xmmdispatch
    if not isinstance(descriptor, GemmDescriptor):
        raise XsmmGeneratorError(ERR_UNSUP_DESCRIPTOR,
                                 type(descriptor).__name__)
    kern = xmmdispatch(descriptor)
    args = (example_args if example_args is not None
            else _gemm_example_avals(descriptor))
    return _lower(kern, args, "gemm", _device(device))


def generator_gemm_reference_kernel(descriptor: GemmDescriptor,
                                    example_args: Optional[Sequence] = None
                                    ) -> GeneratedCode:
    """libxsmm_generator_gemm_reference_kernel analogue
    (src/generator_x86_reference.c:24): the portable always-works lowering
    — built outside the registry (the dispatch cache gets no such kernel)
    and run on the CPU, where every kernel is its plain torch version."""
    from .ops.gemm import _build_gemm
    if not isinstance(descriptor, GemmDescriptor):
        raise XsmmGeneratorError(ERR_UNSUP_DESCRIPTOR,
                                 type(descriptor).__name__)
    args = (example_args if example_args is not None
            else _gemm_example_avals(descriptor))
    return _lower(_build_gemm(descriptor), args, "gemm",
                  torch.device("cpu"), reference=True)


def _meltw_example_avals(desc: MeltwDescriptor):
    dt0, dt1, dt2 = _dtypes(desc.in_type, desc.in1_type or desc.in_type,
                            desc.in2_type or desc.in_type)
    arity = {"unary": 1, "binary": 2, "ternary": 3}.get(desc.operation)
    if arity is None:
        raise XsmmGeneratorError(ERR_UNSUP_DESCRIPTOR, desc.operation)
    shape = (desc.m, desc.n)
    return [_aval(shape, dt) for dt in (dt0, dt1, dt2)[:arity]]


def generator_mateltwise_kernel(descriptor: MeltwDescriptor,
                                example_args: Optional[Sequence] = None,
                                device=None) -> GeneratedCode:
    """libxsmm_generator_mateltwise_kernel analogue
    (src/generator_mateltwise.c:19): the TPP through the dispatch builders.
    Ops whose operand signature is not (m,n)-arrays-per-arity (gather and
    scatter indices, reduce-cols-idx, ...) need example_args — the derived
    operands raise ERR_TRACE_FAILED otherwise, as the reference's generator
    returns an error code for descriptors a backend cannot serve."""
    from . import dispatch_meltw
    try:
        kern = dispatch_meltw(descriptor)
    except (ValueError, KeyError, AttributeError, NotImplementedError) as e:
        raise XsmmGeneratorError(ERR_UNSUP_DESCRIPTOR, str(e)) from e
    args = (example_args if example_args is not None
            else _meltw_example_avals(descriptor))
    return _lower(kern, args, "meltw", _device(device))


def generator_mateltwise_reference_kernel(
        descriptor: MeltwDescriptor,
        example_args: Optional[Sequence] = None) -> GeneratedCode:
    """libxsmm_generator_mateltwise_reference_kernel analogue: the plain
    version, built outside the registry and run on the CPU."""
    from .ops import eltwise
    builder = {"unary": eltwise._build_unary,
               "binary": eltwise._build_binary,
               "ternary": eltwise._build_ternary}.get(descriptor.operation)
    if builder is None:
        raise XsmmGeneratorError(ERR_UNSUP_DESCRIPTOR, descriptor.operation)
    args = (example_args if example_args is not None
            else _meltw_example_avals(descriptor))
    try:
        kern = builder(descriptor)
    except (ValueError, KeyError, AttributeError, NotImplementedError) as e:
        raise XsmmGeneratorError(ERR_UNSUP_DESCRIPTOR, str(e)) from e
    return _lower(kern, args, "meltw", torch.device("cpu"), reference=True)


def _meqn_args(eqn_idx: int):
    """The equation's argument nodes by in_pos."""
    from .ops.equation import _eqn
    args = {}

    def walk(node):
        if node.kind == "arg":
            args.setdefault(node.in_pos, node)
        for c in node.children:
            walk(c)

    walk(_eqn(eqn_idx).root)
    return args


def _meqn_example_avals(eqn_idx: int):
    avals = []
    for pos, node in sorted(_meqn_args(eqn_idx).items()):
        (dt,) = _dtypes(node.dtype)
        shape = (node.m, node.n)
        if getattr(node, "set_card", None):      # tensor-set args stack
            shape = (node.set_card,) + shape
        avals.append(_aval(shape, dt))
    return avals


def generator_matequation_kernel(descriptor,
                                 example_args: Optional[Sequence] = None,
                                 out_m: Optional[int] = None,
                                 out_n: Optional[int] = None,
                                 out_type: Datatype = Datatype.F32,
                                 device=None) -> GeneratedCode:
    """libxsmm_generator_matequation_kernel analogue
    (src/generator_matequation.c): the fused equation tree. Takes a
    MeqnDescriptor (meqn_descriptor_init, which carries the output shape
    like the reference's libxsmm_meqn_descriptor) or a bare equation index
    — the bare form defaults the output shape to the first argument's
    (elementwise trees; pass out_m/out_n for shape-changing roots)."""
    from .ops.equation import MeqnDescriptor, dispatch_meqn, \
        dispatch_meqn_desc
    if isinstance(descriptor, MeqnDescriptor):
        kern = dispatch_meqn_desc(descriptor)
        idx = descriptor.eqn_idx
    elif isinstance(descriptor, int):
        idx = descriptor
        if out_m is None or out_n is None:
            args = _meqn_args(idx)
            if not args:
                raise XsmmGeneratorError(ERR_UNSUP_DESCRIPTOR,
                                         "equation has no args")
            first = args[min(args)]
            out_m = out_m if out_m is not None else first.m
            out_n = out_n if out_n is not None else first.n
        kern = dispatch_meqn(idx, out_m, out_n, out_type)
    else:
        raise XsmmGeneratorError(ERR_UNSUP_DESCRIPTOR,
                                 type(descriptor).__name__)
    args = (example_args if example_args is not None
            else _meqn_example_avals(idx))
    return _lower(kern, args, "meqn", _device(device))


def generator_matequation_reference_kernel(
        descriptor, example_args: Optional[Sequence] = None
        ) -> GeneratedCode:
    """libxsmm_generator_matequation_reference_kernel analogue. The
    equation evaluator is torch operators on every device, so the reference
    lowering is the same tree run on the CPU with the reference flag set —
    kept as a distinct entry for API parity."""
    out = generator_matequation_kernel(descriptor, example_args,
                                       device="cpu")
    out.is_reference_kernel = True
    return out


# --------------------------------------------------------------------------
# packed dense + packed sparse generators
# --------------------------------------------------------------------------

def _packed_gemm_gen(create, shape: GemmShape, flags: GemmFlags,
                     packed_width: int, layout: str,
                     device) -> GeneratedCode:
    adt, bdt, odt = _dtypes(shape.a_in_type, shape.b_in_type,
                            shape.out_type)
    kern = create(shape, flags, packed_width)
    p = packed_width
    if layout == "packed":           # a (m,k,p), b (k,n,p)
        avals = [_aval((shape.m, shape.k, p), adt),
                 _aval((shape.k, shape.n, p), bdt)]
    elif layout == "ac_rm":          # a (m,k,p) packed, b (k,n) row-major
        avals = [_aval((shape.m, shape.k, p), adt),
                 _aval((shape.k, shape.n), bdt)]
    else:                            # bc_rm: a row-major, b/c packed
        avals = [_aval((shape.m, shape.k), adt),
                 _aval((shape.k, shape.n, p), bdt)]
    if not (GemmFlags(flags) & GemmFlags.BETA_0):
        avals.append(_aval((shape.m, shape.n, p), odt))
    return _lower(kern, avals, "packed_gemm", _device(device))


def generator_packed_gemm(shape: GemmShape,
                          flags: GemmFlags = GemmFlags.BETA_0,
                          packed_width: int = 1,
                          device=None) -> GeneratedCode:
    """libxsmm_generator_packed_gemm analogue
    (src/generator_packed_gemm.c): SOA [row][col][packed] layout."""
    from .ops.packed import create_packed_gemm
    return _packed_gemm_gen(create_packed_gemm, shape, flags, packed_width,
                            "packed", device)


def generator_packed_gemm_ac_rm(shape: GemmShape,
                                flags: GemmFlags = GemmFlags.BETA_0,
                                packed_width: int = 1,
                                device=None) -> GeneratedCode:
    """libxsmm_generator_packed_gemm_ac_rm analogue."""
    from .ops.packed import create_packed_gemm_ac_rm
    return _packed_gemm_gen(create_packed_gemm_ac_rm, shape, flags,
                            packed_width, "ac_rm", device)


def generator_packed_gemm_bc_rm(shape: GemmShape,
                                flags: GemmFlags = GemmFlags.BETA_0,
                                packed_width: int = 1,
                                device=None) -> GeneratedCode:
    """libxsmm_generator_packed_gemm_bc_rm analogue."""
    from .ops.packed import create_packed_gemm_bc_rm
    return _packed_gemm_gen(create_packed_gemm_bc_rm, shape, flags,
                            packed_width, "bc_rm", device)


def generator_packed_spgemm_csr_kernel(shape: GemmShape,
                                       flags: GemmFlags,
                                       packed_width: int,
                                       row_ptr: np.ndarray,
                                       column_idx: np.ndarray,
                                       sparse_operand: str = "a",
                                       device=None) -> GeneratedCode:
    """libxsmm_generator_packed_spgemm_csr_kernel analogue
    (include/libxsmm_generator.h:161): bake the CSR pattern, run the
    pattern-specialized kernel."""
    from .ops.sparse import create_packed_spgemm_csr
    adt, bdt, odt = _dtypes(shape.a_in_type, shape.b_in_type,
                            shape.out_type)
    dev = _device(device)
    kern = create_packed_spgemm_csr(shape, flags, packed_width, row_ptr,
                                    column_idx, sparse_operand=sparse_operand,
                                    device=dev)
    nnz = int(np.asarray(row_ptr)[-1])
    p = max(1, packed_width)

    def packed(r, c):
        return (r, c) if p == 1 else (r, c, p)

    if sparse_operand == "a":        # kernel(values, b[, c])
        avals = [_aval((nnz,), adt), _aval(packed(shape.k, shape.n), bdt)]
    else:                            # B-sparse: kernel(a, values[, c])
        avals = [_aval(packed(shape.m, shape.k), adt), _aval((nnz,), bdt)]
    if not (GemmFlags(flags) & GemmFlags.BETA_0):
        avals.append(_aval(packed(shape.m, shape.n), odt))
    return _lower(kern, avals, "pspgemm_csr", dev)


def generator_packed_spgemm_csc_kernel(shape: GemmShape,
                                       flags: GemmFlags,
                                       packed_width: int,
                                       column_ptr: np.ndarray,
                                       row_idx: np.ndarray,
                                       sparse_operand: str = "b",
                                       device=None) -> GeneratedCode:
    """libxsmm_generator_packed_spgemm_csc_kernel analogue."""
    from .ops.sparse import create_packed_spgemm_csc
    adt, bdt, odt = _dtypes(shape.a_in_type, shape.b_in_type,
                            shape.out_type)
    dev = _device(device)
    kern = create_packed_spgemm_csc(shape, flags, packed_width, column_ptr,
                                    row_idx, sparse_operand=sparse_operand,
                                    device=dev)
    nnz = int(np.asarray(column_ptr)[-1])
    p = max(1, packed_width)

    def packed(r, c):
        return (r, c) if p == 1 else (r, c, p)

    beta1 = not (GemmFlags(flags) & GemmFlags.BETA_0)
    if sparse_operand == "b":        # kernel(a, values[, c])
        avals = [_aval(packed(shape.m, shape.k), adt), _aval((nnz,), bdt)]
        if beta1:
            avals.append(_aval(packed(shape.m, shape.n), odt))
    else:                            # SDDMM: kernel(a, b[, c_vals])
        avals = [_aval(packed(shape.m, shape.k), adt),
                 _aval(packed(shape.k, shape.n), bdt)]
        if beta1:
            avals.append(_aval((nnz,), odt))
    return _lower(kern, avals, "pspgemm_csc", dev)


def generator_packed_spgemm_bcsc_kernel(shape: GemmShape,
                                        flags: GemmFlags,
                                        config: SpgemmConfig,
                                        column_ptr: np.ndarray,
                                        row_idx: np.ndarray,
                                        strategy: str = "dense",
                                        device=None) -> GeneratedCode:
    """libxsmm_generator_packed_spgemm_bcsc_kernel analogue
    (include/libxsmm_generator.h:175). Defaults to the densify lowering —
    offline generation should not trigger the on-device autotune."""
    from .ops.sparse import create_packed_spgemm_bcsc
    adt, bdt, odt = _dtypes(shape.a_in_type, shape.b_in_type,
                            shape.out_type)
    dev = _device(device)
    kern = create_packed_spgemm_bcsc(shape, flags, config,
                                     column_ptr=column_ptr, row_idx=row_idx,
                                     strategy=strategy, device=dev)
    nblocks = int(np.asarray(column_ptr)[-1])
    avals = [_aval((shape.m, shape.k), adt),
             _aval((nblocks, config.bk, config.bn), bdt)]
    if not (GemmFlags(flags) & GemmFlags.BETA_0):
        avals.append(_aval((shape.m, shape.n), odt))
    return _lower(kern, avals, "pspgemm_bcsc", dev)


def generator_spgemm_csr_reg_kernel(shape: GemmShape,
                                    row_ptr: np.ndarray,
                                    column_idx: np.ndarray,
                                    values: np.ndarray,
                                    flags: GemmFlags = GemmFlags.BETA_0,
                                    device=None) -> GeneratedCode:
    """libxsmm_generator_spgemm_csr_reg_kernel analogue
    (src/generator_spgemm_csr_asparse_reg.c): pattern AND values baked at
    generate time (the fsspmdm backend)."""
    from .ops.sparse import create_spgemm_csr_areg
    bdt, odt = _dtypes(shape.b_in_type, shape.out_type)
    dev = _device(device)
    kern = create_spgemm_csr_areg(shape, flags, row_ptr, column_idx, values,
                                  device=dev)
    avals = [_aval((shape.k, shape.n), bdt)]
    if not (GemmFlags(flags) & GemmFlags.BETA_0):
        avals.append(_aval((shape.m, shape.n), odt))
    return _lower(kern, avals, "spgemm_areg", dev)


def generator_spgemm_csr_kernel(shape: GemmShape,
                                arch: Optional[str],
                                row_ptr: np.ndarray,
                                column_idx: np.ndarray,
                                values: np.ndarray,
                                flags: GemmFlags = GemmFlags.BETA_0,
                                device=None) -> GeneratedCode:
    """libxsmm_generator_spgemm_csr_kernel analogue (legacy A-sparse CSR
    generator, include/libxsmm_generator.h:146-151): pattern and values
    baked at generate time — the values-baked areg kernel serves it."""
    _retarget(arch)
    return generator_spgemm_csr_reg_kernel(shape, row_ptr, column_idx,
                                           values, flags, device)


def generator_spgemm_csc_kernel(shape: GemmShape,
                                arch: Optional[str],
                                column_ptr: np.ndarray,
                                row_idx: np.ndarray,
                                values: np.ndarray,
                                flags: GemmFlags = GemmFlags.BETA_0,
                                device=None) -> GeneratedCode:
    """libxsmm_generator_spgemm_csc_kernel analogue
    (include/libxsmm_generator.h:137-142): A sparse in CSC with baked
    values. The index contract is converted to CSR at generate time (the
    same matrix, a row-major kernel)."""
    _retarget(arch)
    indptr, indices, vals = _csc_to_csr(shape.m, column_ptr, row_idx, values)
    return generator_spgemm_csr_reg_kernel(shape, indptr, indices, vals,
                                           flags, device)


def _csc_to_csr(m: int, column_ptr, row_idx, values):
    """(indptr, indices, values) in CSR order of the (m, ncols) matrix a
    CSC description gives."""
    column_ptr = np.asarray(column_ptr, np.int64)
    rows = np.asarray(row_idx, np.int64)
    vals = np.asarray(values)
    cols = np.repeat(np.arange(len(column_ptr) - 1), np.diff(column_ptr))
    order = np.lexsort((cols, rows))         # row-major nnz ordering
    indptr = np.zeros(m + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    return (np.cumsum(indptr).astype(np.int32),
            cols[order].astype(np.int32), vals[order])


# --------------------------------------------------------------------------
# legacy text-emitting CLI paths (inlineasm/directasm/spgemm)
# --------------------------------------------------------------------------

def _append_text(file_out: str, routine_name: str, gen: GeneratedCode,
                 commented_header: bool) -> None:
    header = (f"// routine: {routine_name}  arch: {gen.arch}  "
              f"kind: {gen.kind}  size: {gen.code_size}\n")
    with open(file_out, "a") as f:
        if commented_header:
            f.write(header)
        else:
            f.write(header.replace("//", ";;", 1))
        f.write(gen.code)
        f.write("\n")


def generator_gemm_inlineasm(file_out: str, routine_name: str,
                             descriptor: GemmDescriptor,
                             arch: Optional[str] = None,
                             device=None) -> None:
    """libxsmm_generator_gemm_inlineasm analogue (generator driver text
    mode, src/libxsmm_generator_gemm_driver.c): APPEND the kernel's text to
    file_out with a C-comment header (arch retargets the geometry table
    first)."""
    _retarget(arch)
    gen = generator_gemm_kernel(descriptor, device=device)
    _append_text(file_out, routine_name, gen, commented_header=True)


def generator_gemm_directasm(file_out: str, routine_name: str,
                             descriptor: GemmDescriptor,
                             arch: Optional[str] = None,
                             device=None) -> None:
    """libxsmm_generator_gemm_directasm analogue: the .s-style raw text
    append (assembler-comment header)."""
    _retarget(arch)
    gen = generator_gemm_kernel(descriptor, device=device)
    _append_text(file_out, routine_name, gen, commented_header=False)


def generator_spgemm(file_out: str, routine_name: str,
                     descriptor_or_shape, arch: Optional[str],
                     file_in: str, is_csr: int,
                     sparse_operand: str = "a", device=None) -> None:
    """libxsmm_generator_spgemm analogue (generator driver sparse mode,
    include/libxsmm_generator.h:128-133): read the pattern from a .mtx
    file, generate the pattern-baked kernel, append its text.

    The reference driver routes the sparse OPERAND by which leading dim is
    <1 (lda -> A sparse of (m,k), ldb -> B sparse of (k,n)); `is_csr`
    selects the FILE format ('sparse' = CSC reader, 'sparse_csr' = CSR,
    src/libxsmm_generator_gemm_driver.c:215-260). Both .mtx readers yield
    the same matrix, which feeds the same pattern-baked kernels."""
    from .utils.mtx import read_mtx
    _retarget(arch)
    del is_csr            # both .mtx readers yield the same COO expansion
    is_desc = isinstance(descriptor_or_shape, GemmDescriptor)
    shape = descriptor_or_shape.shape if is_desc else descriptor_or_shape
    flags = descriptor_or_shape.flags if is_desc else GemmFlags.BETA_0
    if not os.path.isfile(file_in):
        raise XsmmGeneratorError(ERR_BAD_INPUT_FILE, file_in)
    dense = read_mtx(file_in)
    if sparse_operand == "a":
        if dense.shape != (shape.m, shape.k):
            raise XsmmGeneratorError(
                ERR_BAD_INPUT_FILE,
                f"A-sparse mtx is {dense.shape}, need {(shape.m, shape.k)}")
        from .ops.sparse import CsrMatrix
        csr = CsrMatrix.from_dense(dense)
        gen = generator_packed_spgemm_csr_kernel(
            shape, flags, 1, csr.indptr, csr.indices, sparse_operand="a",
            device=device)
    elif sparse_operand == "b":
        if dense.shape != (shape.k, shape.n):
            raise XsmmGeneratorError(
                ERR_BAD_INPUT_FILE,
                f"B-sparse mtx is {dense.shape}, need {(shape.k, shape.n)}")
        from .ops.sparse import CscMatrix
        csc = CscMatrix.from_dense(dense)
        gen = generator_packed_spgemm_csc_kernel(
            shape, flags, 1, csc.indptr, csc.indices, sparse_operand="b",
            device=device)
    else:
        raise XsmmGeneratorError(ERR_UNSUP_DESCRIPTOR,
                                 f"sparse_operand {sparse_operand!r}")
    _append_text(file_out, routine_name, gen, commented_header=True)


def _retarget(arch: Optional[str]) -> None:
    """Retarget the geometry table to one of the port's targets ("h100",
    "cpu"); other names raise, as get_geometry does for XSMM_TPU_TARGET."""
    if arch:
        from .config import set_target
        from .device import GEOMETRY_TABLE
        if str(arch).lower() not in GEOMETRY_TABLE:
            raise ValueError(f"unknown target {arch!r} "
                             f"(known: {sorted(GEOMETRY_TABLE)})")
        set_target(arch)
