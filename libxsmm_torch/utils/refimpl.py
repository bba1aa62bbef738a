"""ctypes bridge to the REFERENCE portable kernels (the parity oracle).

The port of `libxsmm_tpu/utils/refimpl.py`. It loads
native/libxsmm_refimpl.so — built by scripts/build_ref_impl.sh from a
throwaway copy of a libxsmm checkout named by XSMM_REFERENCE_DIR — and
exposes the reference's own portable implementations:

  * ref_meltw(...)  -> libxsmm_reference_{unary,binary,ternary}_elementwise
  * ref_gemm(...)   -> libxsmm_reference_gemm (incl. stride-BRGEMM)
  * ref_gemm_ext(...) -> the fused GEMM-ext (argops + postops)
  * ref_matdiff(...)-> libxsmm_matdiff (the reference norm collection)
  * ref_meqn_*      -> the reference's matrix equations

Without the library and without a checkout named by XSMM_REFERENCE_DIR,
available() is False and the loader returns None: nothing is built.

Layout contract: the reference is COLUMN-major. All array arguments here
must be numpy arrays in FORTRAN order (np.asfortranarray) with ld = rows;
callers compare logical values, so the order is an implementation detail
of the call. Datatype/op/flag enums are this port's own — the numbering
mirrors include/libxsmm_typedefs.h, as the JAX package's does.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SO = os.path.join(_REPO, "native", "libxsmm_refimpl.so")
_BUILD = os.path.join(_REPO, "scripts", "build_ref_impl.sh")
_lib = None
_tried = False


class MatdiffInfoC(ctypes.Structure):
    """libxsmm_matdiff_info (include/libxsmm_math.h:101-120)."""

    _fields_ = [(n, ctypes.c_double) for n in (
        "norm1_abs", "norm1_rel", "normi_abs", "normi_rel", "normf_rel",
        "linf_abs", "linf_rel", "l2_abs", "l2_rel", "rsq",
        "l1_ref", "min_ref", "max_ref", "avg_ref", "var_ref",
        "l1_tst", "min_tst", "max_tst", "avg_tst", "var_tst",
        "v_ref", "v_tst")] + [(n, ctypes.c_int) for n in
                              ("m", "n", "i", "r")]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO):
        ref = os.environ.get("XSMM_REFERENCE_DIR")
        if not ref or not os.path.isdir(os.path.join(ref, "src")):
            return None
        # a build directory of this process's own, under TMPDIR: the
        # script empties the directory it is given before it builds
        bld = tempfile.mkdtemp(prefix="xsmm_refimpl_")
        try:
            subprocess.run(["bash", _BUILD, bld], check=True, timeout=1800,
                           capture_output=True)
        except (OSError, subprocess.SubprocessError):
            return None
        finally:
            shutil.rmtree(bld, ignore_errors=True)
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.xsmm_ref_meltw.restype = ctypes.c_int
    lib.xsmm_ref_meltw.argtypes = (
        [ctypes.c_uint, ctypes.c_ushort, ctypes.c_ushort]
        + [ctypes.c_uint] * 11 + [ctypes.c_void_p] * 12)
    lib.xsmm_ref_gemm.restype = ctypes.c_int
    lib.xsmm_ref_gemm.argtypes = (
        [ctypes.c_uint] * 11 + [ctypes.c_longlong] * 2
        + [ctypes.c_ulonglong] + [ctypes.c_void_p] * 5)
    lib.libxsmm_matdiff.restype = ctypes.c_int
    lib.libxsmm_matdiff.argtypes = [
        ctypes.POINTER(MatdiffInfoC), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    _lib = lib
    return _lib


def available() -> bool:
    """True when the reference oracle library is loadable (builds it on
    first use when gcc and the XSMM_REFERENCE_DIR checkout are present)."""
    return _load() is not None


_DT_ENUM = None


def dt_enum(dt) -> int:
    """Numeric libxsmm_datatype code for one of the port's Datatypes: the
    enum member ORDER mirrors the reference's ordinal numbering."""
    global _DT_ENUM
    if _DT_ENUM is None:
        from ..dtypes import Datatype
        _DT_ENUM = {d: i for i, d in enumerate(Datatype)}
        _DT_ENUM[None] = 26                       # LIBXSMM_DATATYPE_UNSUPPORTED
    return _DT_ENUM[dt]


def _ptr(a):
    if a is None:
        return None
    assert isinstance(a, np.ndarray)
    return a.ctypes.data_as(ctypes.c_void_p)


def ref_meltw(operation: int, op_type: int, flags: int, m: int, n: int,
              dt_in0, dt_out, dt_comp,
              in0, in1=None, in2=None, out=None,
              in0_s=None, in1_s=None, in2_s=None, out_s=None,
              op_p=None, op_s=None, op_t=None,
              dt_in1=None, dt_in2=None,
              ldi=None, ldi2=None, ldi3=None, ldo=None) -> np.ndarray:
    """Run a reference mateltwise TPP. Arrays must be F-order; ld defaults
    to the row count m (packed column-major). `out` must be preallocated
    (shape knowledge stays with the caller: transforms/reductions differ).
    Returns `out`."""
    lib = _load()
    if lib is None:
        raise RuntimeError("reference oracle library unavailable")
    rc = lib.xsmm_ref_meltw(
        operation, op_type, flags, m, n,
        ldi or m, ldi2 or m, ldi3 or m, ldo if ldo is not None else m,
        dt_enum(dt_in0), dt_enum(dt_in1 if dt_in1 is not None else dt_in0),
        dt_enum(dt_in2 if dt_in2 is not None else dt_in0),
        dt_enum(dt_out), dt_enum(dt_comp),
        _ptr(in0), _ptr(in0_s), None,
        _ptr(in1), _ptr(in1_s), _ptr(in2), _ptr(in2_s),
        _ptr(op_p), _ptr(op_s), _ptr(op_t), _ptr(out), _ptr(out_s))
    if rc != 0:
        raise ValueError(f"reference meltw rejected the descriptor (rc={rc})")
    return out


def ref_gemm(m: int, n: int, k: int, dt_a, dt_b, dt_c, dt_comp, flags: int,
             a, b, c, a2=None, b2=None, brcount: int = 0,
             stride_a: int = 0, stride_b: int = 0,
             lda=None, ldb=None, ldc=None) -> np.ndarray:
    """Run the reference GEMM/BRGEMM. a/b/c are F-order column-major with
    ld = rows by default; for stride-BRGEMM pass flat per-matrix buffers
    plus byte strides. Returns `c`."""
    lib = _load()
    if lib is None:
        raise RuntimeError("reference oracle library unavailable")
    rc = lib.xsmm_ref_gemm(
        m, n, k, lda or m, ldb or k, ldc or m,
        dt_enum(dt_a), dt_enum(dt_b), dt_enum(dt_c), dt_enum(dt_comp),
        flags, stride_a, stride_b, brcount,
        _ptr(a), _ptr(a2), _ptr(b), _ptr(b2), _ptr(c))
    if rc != 0:
        raise ValueError(f"reference gemm rejected the descriptor (rc={rc})")
    return c


def ref_matdiff(ref: np.ndarray, tst: np.ndarray, dt) -> MatdiffInfoC:
    """libxsmm_matdiff over F-order column-major (m, n) arrays."""
    lib = _load()
    if lib is None:
        raise RuntimeError("reference oracle library unavailable")
    assert ref.flags.f_contiguous and tst.flags.f_contiguous
    m, n = ref.shape
    info = MatdiffInfoC()
    rc = lib.libxsmm_matdiff(ctypes.byref(info), dt_enum(dt), m, n,
                             _ptr(ref), _ptr(tst), None, None)
    if rc != 0:
        raise ValueError(f"libxsmm_matdiff failed (rc={rc})")
    return info


def ref_gemm_ext(m, n, k, dt_a, dt_b, dt_c, dt_comp, flags,
                 a, b, c, d=None, br_type: int = 0, brcount: int = 0,
                 stride_a: int = 0, stride_b: int = 0,
                 ap_op: int = 0, ap_flags: int = 0,
                 bp_op: int = 0, bp_flags: int = 0,
                 cp_op: int = 0, cp_flags: int = 0, store_cp: int = 0,
                 d_type: int = 0, d_flags: int = 0, d_dtype=None,
                 ldd=None, cp_out=None, op_p=None,
                 lda=None, ldb=None, ldc=None) -> np.ndarray:
    """Reference fused GEMM-ext (unary argops + binary postop, XGEMM ext
    ABI). br_type: 0=none 1=address 2=offset 4=stride (libxsmm_gemm_batch_reduce_type). Returns `c`."""
    lib = _load()
    if lib is None:
        raise RuntimeError("reference oracle library unavailable")
    fn = lib.xsmm_ref_gemm_ext
    if fn.argtypes is None or not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_uint] * 12 + [ctypes.c_ulonglong]
                       + [ctypes.c_longlong] * 2 + [ctypes.c_uint] * 11
                       + [ctypes.c_void_p] * 6)
    rc = fn(m, n, k, lda or m, ldb or k, ldc or m,
            dt_enum(dt_a), dt_enum(dt_b), dt_enum(dt_c), dt_enum(dt_comp),
            flags, br_type, brcount, stride_a, stride_b,
            ap_op, ap_flags, bp_op, bp_flags, cp_op, cp_flags, store_cp,
            d_type, d_flags,
            dt_enum(d_dtype if d_dtype is not None else dt_c),
            ldd if ldd is not None else m,
            _ptr(a), _ptr(b), _ptr(c), _ptr(d), _ptr(cp_out), _ptr(op_p))
    if rc != 0:
        raise ValueError(f"reference gemm_ext rejected (rc={rc})")
    return c


def _meqn_bind(lib):
    if getattr(lib, "_meqn_bound", False):
        return
    lib.xsmm_ref_meqn_create.restype = ctypes.c_int
    lib.xsmm_ref_meqn_create.argtypes = []
    lib.xsmm_ref_meqn_push_arg.restype = ctypes.c_int
    lib.xsmm_ref_meqn_push_arg.argtypes = [ctypes.c_int] * 5 + [ctypes.c_uint]
    lib.xsmm_ref_meqn_push_op.restype = ctypes.c_int
    lib.xsmm_ref_meqn_push_op.argtypes = [ctypes.c_int] + [ctypes.c_uint] * 4 \
        + [ctypes.c_int]
    lib.xsmm_ref_meqn_run.restype = ctypes.c_int
    lib.xsmm_ref_meqn_run.argtypes = [ctypes.c_int, ctypes.c_uint,
                                      ctypes.c_uint, ctypes.c_void_p,
                                      ctypes.c_void_p]
    lib._meqn_bound = True


def ref_meqn_create() -> int:
    lib = _load()
    _meqn_bind(lib)
    return lib.xsmm_ref_meqn_create()


def ref_meqn_push_arg(idx: int, m: int, n: int, in_pos: int, dt,
                      ld=None) -> None:
    lib = _load()
    _meqn_bind(lib)
    rc = lib.xsmm_ref_meqn_push_arg(idx, m, n, ld or m, in_pos, dt_enum(dt))
    if rc != 0:
        raise ValueError(f"reference meqn_push_arg failed (rc={rc})")


def ref_meqn_push_op(idx: int, arity: int, op_type: int, dt,
                     flags: int = 0, op_arg_pos: int = -1) -> None:
    lib = _load()
    _meqn_bind(lib)
    rc = lib.xsmm_ref_meqn_push_op(idx, arity, op_type, dt_enum(dt), flags,
                                   op_arg_pos)
    if rc != 0:
        raise ValueError(f"reference meqn_push_op failed (rc={rc})")


def ref_meqn_run(idx: int, inputs, out: np.ndarray, out_dt,
                 ldo=None) -> np.ndarray:
    """Execute the reference equation. `inputs` is the in_pos-ordered list
    of F-order arrays; each becomes a libxsmm_matrix_arg (primary pointer,
    rest NULL). Returns `out` (F-order, preallocated)."""
    lib = _load()
    _meqn_bind(lib)
    table = np.zeros((len(inputs), 6), np.uint64)
    for i, a in enumerate(inputs):
        table[i, 0] = a.ctypes.data
    rc = lib.xsmm_ref_meqn_run(idx, ldo if ldo is not None else out.shape[0],
                               dt_enum(out_dt), _ptr(table), _ptr(out))
    if rc != 0:
        raise ValueError(f"reference meqn_run failed (rc={rc})")
    return out
