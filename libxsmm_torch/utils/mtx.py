"""MatrixMarket (.mtx) reader and writer.

The port's own copy of `libxsmm_tpu/utils/mtx.py`, the analogue of the
reference's CSR/CSC readers used by the sparse generators and the PyFR
driver (src/generator_spgemm_csr_reader.c, generator_spgemm_csc_reader.c,
samples/xgemm_sparse_Ainregs). Host code on numpy.
"""

from __future__ import annotations

import numpy as np


def read_mtx(path: str) -> np.ndarray:
    """Read a MatrixMarket file into a dense float64 ndarray.

    The native C++ parser first (native/xsmm_native.cpp xsmm_mtx_open
    through `libxsmm_torch.native.read_mtx_coo`: a pointer walk over the
    whole file, symmetric/pattern storage expanded); then scipy.io.mmread,
    where the native library is unavailable or declines the format; then
    the pure-Python parser below.
    """
    from ..native import read_mtx_coo
    coo = read_mtx_coo(path)
    if coo is not None:
        m, n, rows, cols, vals = coo
        out = np.zeros((m, n))
        # duplicate entries accumulate, per the MM convention scipy uses
        np.add.at(out, (rows, cols), vals)
        return out
    try:
        from scipy.io import mmread
    except ImportError:
        return _read_mtx_py(path)
    mat = mmread(path)
    if hasattr(mat, "todense"):
        return np.asarray(mat.todense())
    return np.asarray(mat)


def _read_mtx_py(path: str) -> np.ndarray:
    """The dependency-free parser (real and integer fields)."""
    with open(path) as f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError(f"{path}: not a MatrixMarket file")
        is_coord = "coordinate" in header
        # the symmetry qualifier stores one triangle: expand it as the
        # native parser and scipy do
        qual = header.lower().split()[-1]
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        dims = line.split()
        if is_coord:
            m, n, nnz = int(dims[0]), int(dims[1]), int(dims[2])
            out = np.zeros((m, n))
            rows = np.empty(nnz, np.intp)
            cols = np.empty(nnz, np.intp)
            vals = np.empty(nnz, np.float64)
            for t in range(nnz):
                parts = f.readline().split()
                rows[t] = int(parts[0]) - 1
                cols[t] = int(parts[1]) - 1
                vals[t] = float(parts[2]) if len(parts) > 2 else 1.0
            # duplicates accumulate (the MM convention), never overwrite
            np.add.at(out, (rows, cols), vals)
            if qual in ("symmetric", "skew-symmetric", "hermitian"):
                off = rows != cols
                sgn = -1.0 if qual == "skew-symmetric" else 1.0
                np.add.at(out, (cols[off], rows[off]), sgn * vals[off])
            return out
        m, n = int(dims[0]), int(dims[1])
        vals = np.array(f.read().split(), dtype=np.float64)
        # array format is column-major per the MatrixMarket spec
        return vals.reshape(n, m).T


def write_mtx(path: str, a: np.ndarray) -> None:
    a = np.asarray(a)
    nz = np.nonzero(a)
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{a.shape[0]} {a.shape[1]} {len(nz[0])}\n")
        for i, j in zip(*nz):
            f.write(f"{i + 1} {j + 1} {a[i, j]:.17g}\n")
