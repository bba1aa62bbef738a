"""Matrix-difference norms — the test harness's tolerance machinery.

Semantics port of `libxsmm_matdiff` / `libxsmm_matdiff_epsilon` /
`libxsmm_matdiff_reduce` (src/libxsmm_math.c:35-447,
include/libxsmm_math.h:95-146): LAPACK-style relative norms
(one/inf/Frobenius), max-abs difference with its location, L2 norms,
R-squared, and operand statistics. A numpy-only copy of
`libxsmm_tpu/matdiff.py`: the port's tests and `chip_smoke.py` hold every
kernel against its reference through these norms, as the reference's drivers
do (samples/xgemm/gemm_kernel.c:2665-2773).

Computation is NumPy on host in float64 — this is test machinery, not a hot
path. Torch tensors (any device, any dtype) are accepted and copied to host
float64 without importing torch here.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class MatdiffInfo:
    """Field-for-field analogue of libxsmm_matdiff_info."""

    norm1_abs: float = 0.0
    norm1_rel: float = 0.0
    normi_abs: float = 0.0
    normi_rel: float = 0.0
    normf_rel: float = 0.0
    linf_abs: float = 0.0
    linf_rel: float = 0.0
    l2_abs: float = 0.0
    l2_rel: float = 0.0
    rsq: float = 0.0
    l1_ref: float = 0.0
    min_ref: float = 0.0
    max_ref: float = 0.0
    avg_ref: float = 0.0
    var_ref: float = 0.0
    l1_tst: float = 0.0
    min_tst: float = 0.0
    max_tst: float = 0.0
    avg_tst: float = 0.0
    var_tst: float = 0.0
    v_ref: float = 0.0
    v_tst: float = 0.0
    m: int = -1
    n: int = -1

    def epsilon(self) -> float:
        """libxsmm_matdiff_epsilon (src/libxsmm_math.c:319-331):
        rsq>0 -> min(normf_rel, linf_abs)/rsq, else
        max(min(norm1_abs, normi_abs), max(linf_abs, l2_abs))."""
        if self.rsq > 0:
            return min(self.normf_rel, self.linf_abs) / self.rsq
        a = min(self.norm1_abs, self.normi_abs)
        b = max(self.linf_abs, self.l2_abs)
        return max(a, b)


def _host_f64(x) -> np.ndarray:
    """numpy float64 view of an array-like; a torch tensor (duck-typed by
    its `detach`) is copied to host first, since numpy cannot read CUDA or
    bfloat16 storage."""
    if hasattr(x, "detach"):
        x = x.detach().to("cpu").double().numpy()
    return np.asarray(x, dtype=np.float64)


def matdiff(ref, tst) -> MatdiffInfo:
    """Compute the norm collection between a reference and a test array.

    Arrays may be any shape (flattened to 2D column interpretation for the
    one-/inf-norms: axis -1 is "n"). Non-finite ref/tst values follow the
    reference's sentinel contract (libxsmm_math.c:278-295): all norms
    +inf, the poisoned side's min/max set to the +inf/-inf sentinels so
    matdiff_reduce merges stay consistent.
    """
    ref = _host_f64(ref)
    tst = _host_f64(tst)
    if ref.shape != tst.shape:
        raise ValueError(f"shape mismatch {ref.shape} vs {tst.shape}")
    if ref.ndim == 0:
        ref = ref.reshape(1, 1)
        tst = tst.reshape(1, 1)
    elif ref.ndim == 1:
        ref = ref.reshape(-1, 1)
        tst = tst.reshape(-1, 1)
    else:
        ref = ref.reshape(-1, ref.shape[-1])
        tst = tst.reshape(-1, tst.shape[-1])

    info = MatdiffInfo()

    # NaN/Inf sentinel contract (libxsmm_math.c:278-295 + matdiff.h:42):
    # an element is OK when tst is not NaN AND (finite OR equal to ref) —
    # so IDENTICAL non-finite pairs (both +inf, e.g. matching EXP
    # overflow) do NOT poison anything. A bad tst element enters the
    # sentinel branch: blame tst (result_nan=1) when the ref element is
    # finite, else ref (result_nan=2). All norms become +inf, the poisoned
    # side's min/max become the +inf/-inf sentinels, avg carries the NaN —
    # NOT NumPy NaN propagation, which matdiff_reduce's comparisons would
    # silently drop. Documented divergence: the clean side's l1/min/max/
    # avg/var are computed over the FULL array here; the reference's scan
    # breaks at the first bad element, leaving scan-order-dependent
    # partial sums — junk not worth reproducing.
    with np.errstate(invalid="ignore"):
        tst_bad = np.isnan(tst) | (np.isinf(tst) & ~(tst == ref))
    if tst_bad.any():
        idx = int(np.argmax(tst_bad))
        i0, j0 = divmod(idx, ref.shape[1])
        nan_side = "tst" if np.isfinite(ref[i0, j0]) else "ref"
        bad = tst_bad
        i, j = divmod(idx, ref.shape[1])
        info.m, info.n = i, j
        info.v_ref = float(ref[i, j])
        info.v_tst = float(tst[i, j])
        for f in ("norm1_abs", "norm1_rel", "normi_abs", "normi_rel",
                  "normf_rel", "linf_abs", "linf_rel", "l2_abs", "l2_rel"):
            setattr(info, f, math.inf)
        if nan_side == "tst":
            info.l1_tst = info.var_tst = math.inf
            info.avg_tst = info.v_tst          # carries the NaN
            info.min_tst, info.max_tst = math.inf, -math.inf
            info.l1_ref = float(np.abs(ref).sum())
            info.min_ref = float(ref.min())
            info.max_ref = float(ref.max())
            info.avg_ref = info.l1_ref / ref.size   # reference: mean |x|
            info.var_ref = float(((ref - info.avg_ref) ** 2).mean())
        else:
            info.l1_ref = info.var_ref = math.inf
            info.avg_ref = info.v_ref
            info.min_ref, info.max_ref = math.inf, -math.inf
            with np.errstate(invalid="ignore"):
                info.l1_tst = float(np.abs(tst).sum())
                info.min_tst = float(tst.min())
                info.max_tst = float(tst.max())
                info.avg_tst = info.l1_tst / tst.size
                info.var_tst = float(((tst - info.avg_tst) ** 2).mean())
        return info

    # equal pairs (including equal non-finites, the reference's ti==ri OK
    # path) difference to exactly zero; a non-finite REF element with an
    # unequal finite tst maps to a +inf difference (the reference's DELTA
    # of an inf operand)
    with np.errstate(invalid="ignore"):
        diff = np.where(tst == ref, 0.0, tst - ref)
        diff = np.where(np.isnan(diff), np.inf, diff)
    adiff = np.abs(diff)
    aref = np.abs(ref)
    atst = np.abs(tst)

    # Reference field semantics (libxsmm_matdiff.h, column-major loops):
    # normi_abs = max COLUMN-sum of |diff| (:116), norm1_abs = max ROW-sum
    # (:183). NB these are swapped relative to netlib naming — parity with
    # reference-generated baselines wins over naming convention.
    col_sum = adiff.sum(axis=0)
    row_sum = adiff.sum(axis=1)
    info.normi_abs = float(col_sum.max(initial=0.0))
    info.norm1_abs = float(row_sum.max(initial=0.0))
    # relative forms via LIBXSMM_MATDIFF_DIV(nom, den_ref, fallback)
    normr = aref.sum(axis=0).max(initial=0.0)    # max col-sum of |ref|
    normt = atst.sum(axis=0).max(initial=0.0)
    info.normi_rel = (info.normi_abs / normr if normr > 0 else normt)
    normrc = aref.sum(axis=1).max(initial=0.0)   # max row-sum of |ref|
    info.norm1_rel = (info.norm1_abs / normrc if normrc > 0
                      else info.norm1_abs)

    fro_ref = float(np.sqrt((ref * ref).sum()))
    fro_diff = float(np.sqrt((diff * diff).sum()))
    info.normf_rel = fro_diff / fro_ref if fro_ref > 0 else fro_diff

    # location of largest abs difference
    idx = int(np.argmax(adiff))
    i, j = divmod(idx, adiff.shape[1])
    info.linf_abs = float(adiff[i, j])
    if info.linf_abs > 0:
        info.m, info.n = i, j
        info.v_ref = float(ref[i, j])
        info.v_tst = float(tst[i, j])
    # max PER-ELEMENT relative error (matdiff.h:60 dri = DIV(di, ra, ta)):
    # the error relative to the argmax-ABSOLUTE location under-reports by
    # orders of magnitude when a small element carries a large rel error
    dri = np.where(aref > 0, adiff / np.where(aref > 0, aref, 1.0), atst)
    info.linf_rel = float(dri.max(initial=0.0))

    nelem = ref.size
    info.l2_abs = fro_diff
    info.l2_rel = float(np.sqrt((dri * dri).sum()))

    # Reference statistics quirk, matched exactly (libxsmm_matdiff.h:107
    # + :125): avg_* = l1/ntotal — the mean of ABSOLUTE values — and
    # var_* centers the SIGNED values on that absolute mean. Verified
    # field-for-field against the reference binary
    # (tests/test_refimpl_parity.py::test_matdiff_parity).
    info.l1_ref = float(aref.sum())
    info.min_ref = float(ref.min())
    info.max_ref = float(ref.max())
    info.avg_ref = info.l1_ref / nelem
    info.var_ref = float(((ref - info.avg_ref) ** 2).mean())
    info.l1_tst = float(atst.sum())
    info.min_tst = float(tst.min())
    info.max_tst = float(tst.max())
    info.avg_tst = info.l1_tst / nelem
    info.var_tst = float(((tst - info.avg_tst) ** 2).mean())

    # rsq = max(0, 1 - DIV(l2_abs^2, var_ref_sum, l2_abs^2))
    # (libxsmm_math.c:267-268; var_ref_sum is the UN-normalized sum)
    var_sum = info.var_ref * nelem
    l2sq = fro_diff ** 2
    resrel = l2sq / var_sum if var_sum > 0 else l2sq
    info.rsq = max(0.0, 1.0 - resrel)
    return info


def matdiff_epsilon(info: MatdiffInfo) -> float:
    """Free-function form of libxsmm_matdiff_epsilon (include/
    libxsmm_math.h:129); identical to MatdiffInfo.epsilon()."""
    return info.epsilon()


def matdiff_clear(info: MatdiffInfo = None) -> MatdiffInfo:
    """libxsmm_matdiff_clear (src/libxsmm_math.c:449-466): zero the report,
    invalidate the location (m=n=-1), seed min/max at +/-inf and rsq at inf
    so the first matdiff_reduce adopts the input's statistics."""
    if info is None:
        info = MatdiffInfo()
    for f in dataclasses.fields(MatdiffInfo):
        setattr(info, f.name, 0 if f.type in (int, "int") else 0.0)
    info.m = info.n = -1
    info.min_ref = info.min_tst = math.inf
    info.max_ref = info.max_tst = -math.inf
    info.rsq = math.inf
    return info


def matdiff_reduce(output: MatdiffInfo, input_: MatdiffInfo) -> MatdiffInfo:
    """Field-wise worst-of merge into `output` (libxsmm_matdiff_reduce,
    src/libxsmm_math.c:386-446): each abs-norm keeps its max
    (carrying the paired rel field), min/max stats widen, the worse-epsilon
    report donates rsq and the error location, averages average and L1s
    accumulate. Returns the mutated `output`."""
    epsinp = input_.epsilon()
    # A freshly cleared output (rsq == inf) must adopt the input's location.
    epsout = output.epsilon() if math.isfinite(output.rsq) else math.inf
    for abs_f, rel_f in (("linf_abs", "linf_rel"), ("norm1_abs", "norm1_rel"),
                         ("normi_abs", "normi_rel"), ("l2_abs", "l2_rel")):
        if getattr(output, abs_f) <= getattr(input_, abs_f):
            setattr(output, abs_f, getattr(input_, abs_f))
            setattr(output, rel_f, getattr(input_, rel_f))
    for f in ("normf_rel", "var_ref", "var_tst", "max_ref", "max_tst"):
        if getattr(output, f) <= getattr(input_, f):
            setattr(output, f, getattr(input_, f))
    for f in ("min_ref", "min_tst"):
        if getattr(output, f) >= getattr(input_, f):
            setattr(output, f, getattr(input_, f))
    if epsout < epsinp or epsout == math.inf:
        output.rsq = input_.rsq
        output.v_ref = input_.v_ref
        output.v_tst = input_.v_tst
        output.m = input_.m
        output.n = input_.n
    output.avg_ref = 0.5 * (output.avg_ref + input_.avg_ref)
    output.avg_tst = 0.5 * (output.avg_tst + input_.avg_tst)
    output.l1_ref += input_.l1_ref
    output.l1_tst += input_.l1_tst
    return output


# Per-dtype default margins used by the test-suite, matching the spirit of
# the reference drivers' tolerances (samples/xgemm driver check_matrix).
DEFAULT_MARGINS = {
    "f64": 1e-12,
    "f32": 1e-5,
    "bf16": 5e-3,
    "f16": 2e-3,
    "bf8": 8e-2,
    "hf8": 8e-2,
    "i8": 0.0,
    "i32": 0.0,
}


def check(ref, tst, margin: float = None, dtype_name: str = "f32") -> MatdiffInfo:
    """Assert-style helper: raises AssertionError with the norm report."""
    info = matdiff(ref, tst)
    if margin is None:
        margin = DEFAULT_MARGINS.get(dtype_name, 1e-5)
    eps = info.normf_rel if _host_f64(ref).size > 1 else info.linf_abs
    if not (eps <= margin or info.linf_abs <= margin):
        raise AssertionError(
            f"matdiff failed: normf_rel={info.normf_rel:.3e} "
            f"linf_abs={info.linf_abs:.3e} (margin {margin:.1e}) "
            f"at ({info.m},{info.n}): ref={info.v_ref} tst={info.v_tst}")
    return info
