"""Synthetic spectral-element operator matrices.

A numpy copy of `libxsmm_tpu/utils/testmats.py` (that module needs nothing
of JAX, but importing it runs libxsmm_tpu/__init__.py, which does). The
reference validates its fixed-sparsity SpMM on real PyFR/GiMMiK
flux/interpolation operators downloaded as .mtx files
(upstream libxsmm's samples/xgemm_sparse_Ainregs/pyfr_download_mats.sh,
mats named p{order}/{hex,tet,...}/m{0,3,6,...}-sp.mtx). The repository does
not ship them, so this module CONSTRUCTS matrices with the same structure from
first principles: PyFR operators are tensor products of 1-D nodal-basis
derivative/interpolation matrices, giving the characteristic
block-Kronecker sparsity with dense 1-D bands.

These are not the exact PyFR values, but they have the right shapes,
densities, and value-repetition structure (the property the reference's
areg kernel exploits by deduplicating unique values,
generator_spgemm_csr_asparse_reg.c:66-96).
"""

from __future__ import annotations

import os

import numpy as np


def _lagrange_diff_1d(p: int) -> np.ndarray:
    """1-D nodal differentiation matrix on p+1 Chebyshev points."""
    x = np.cos(np.pi * np.arange(p + 1) / p)[::-1]
    n = p + 1
    d = np.zeros((n, n))
    w = np.ones(n)
    for j in range(n):
        for i in range(n):
            if i != j:
                w[j] *= (x[j] - x[i])
    for i in range(n):
        for j in range(n):
            if i != j:
                d[i, j] = (w[i] / w[j]) / (x[i] - x[j])
        d[i, i] = -d[i].sum() + 2 * d[i, i]
    return d


def hex_derivative_operator(p: int, axis: int = 0,
                            tol: float = 1e-12) -> np.ndarray:
    """Derivative operator on a p-th order hex element: kron of a 1-D
    differentiation matrix with identities — ((p+1)^3, (p+1)^3), density
    ~1/(p+1), the m3/m6-class PyFR operators."""
    d = _lagrange_diff_1d(p)
    eye = np.eye(p + 1)
    mats = [eye, eye, eye]
    mats[axis] = d
    op = np.kron(np.kron(mats[0], mats[1]), mats[2])
    op[np.abs(op) < tol] = 0.0
    return op


def hex_interp_operator(p: int, tol: float = 1e-12) -> np.ndarray:
    """Face-interpolation-like operator: (6*(p+1)^2, (p+1)^3) tall-skinny
    with one dense 1-D band per face point (the m0-class shape)."""
    n1 = p + 1
    x = np.cos(np.pi * np.arange(n1) / p)[::-1]
    # 1-D interpolation row to each endpoint (Lagrange at +-1)
    def lag_row(xi):
        row = np.ones(n1)
        for j in range(n1):
            for i in range(n1):
                if i != j:
                    row[j] *= (xi - x[i]) / (x[j] - x[i])
        return row

    ends = np.stack([lag_row(-1.0), lag_row(1.0)])   # (2, n1)
    eye = np.eye(n1)
    faces = []
    for axis in range(3):
        for e in range(2):
            mats = [eye, eye, eye]
            mats[axis] = ends[e:e + 1]               # (1, n1)
            faces.append(np.kron(np.kron(mats[0], mats[1]), mats[2]))
    op = np.concatenate(faces, axis=0)
    op[np.abs(op) < tol] = 0.0
    return op


def edge_fluxmatrix(m: int = 20, k: int = 35, seed: int = 0,
                    density: float = 0.15) -> np.ndarray:
    """EDGE-style (seismic ADER-DG) small sparse flux-matrix stand-in:
    block-triangular-ish with repeated values (common_edge_proxy.h class)."""
    rng = np.random.default_rng(seed)
    a = np.zeros((m, k), np.float32)
    values = rng.standard_normal(8)      # few unique values, like stiffness
    for i in range(m):
        cols = rng.choice(k, max(1, int(density * k)), replace=False)
        a[i, cols] = values[rng.integers(0, len(values), len(cols))]
    return a


# ---------------------------------------------------------------------------
# The upstream project's own sample matrices (PyFR/GiMMiK operators, EDGE
# seismic matrices), read in place from a libxsmm checkout named by
# XSMM_TPU_REFERENCE_DIR (utils/mtx.py reads the .mtx files); without one
# both probes return False and both readers return no matrix.
# ---------------------------------------------------------------------------

PYFR_MATS = os.path.join("samples", "xgemm_sparse_Ainregs", "mats")
EDGE_MATS = os.path.join("samples", "xgemm_norm_packed", "mats")


def _dir(sub: str):
    """The checkout's `sub` directory, or None."""
    root = os.environ.get("XSMM_TPU_REFERENCE_DIR")
    path = os.path.join(root, sub) if root else None
    return path if path and os.path.isdir(path) else None


def have_reference_pyfr_mats() -> bool:
    return _dir(PYFR_MATS) is not None


def have_reference_edge_mats() -> bool:
    return _dir(EDGE_MATS) is not None


def reference_pyfr_operators(orders=("p2", "p3", "p4"),
                             elems=("hex", "tet"),
                             kinds=("sp",)):
    """The PyFR operator matrices of the checkout: [(label, dense ndarray)],
    labelled "p{order}/{elem}/m{N}-{kind}".

    kinds: 'sp' = the sparse operators the reference's fsspmdm test sweeps
    (tests/fsspmdm.sh), 'de' = their dense counterparts."""
    import glob

    from .mtx import read_mtx

    root = _dir(PYFR_MATS)
    out = []
    if root is None:
        return out
    for p in orders:
        for elem in elems:
            d = os.path.join(root, p, elem)
            if not os.path.isdir(d):
                continue
            for path in sorted(glob.glob(os.path.join(d, "m*.mtx"))):
                base = os.path.basename(path)[:-4]       # mN-sp / mN-de
                if base.rsplit("-", 1)[1] not in kinds:
                    continue
                out.append((f"{p}/{elem}/{base}", read_mtx(path)))
    return out


def reference_edge_operators(fmt="csr", limit=None):
    """The EDGE (seismic ADER-DG) matrices of the checkout:
    [(label, dense ndarray)], the `*_{fmt}.mtx` files in name order."""
    import glob

    from .mtx import read_mtx

    root = _dir(EDGE_MATS)
    if root is None:
        return []
    paths = sorted(glob.glob(os.path.join(root, f"*_{fmt}.mtx")))
    if limit:
        paths = paths[:limit]
    return [(os.path.basename(p)[:-4], read_mtx(p)) for p in paths]
