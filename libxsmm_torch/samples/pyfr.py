"""pyfr: fixed-sparsity SpMM on spectral-element operators
(samples/pyfr.py) on the port.

    python -m libxsmm_torch.samples.pyfr [N] [--synthetic] [--device cpu]

Sweeps the PyFR operator set: an fsspmdm handle per operator (its
create-time autotune picks dense or sparse), held against float64 (matdiff
normf_rel 1e-5), and the streaming rate at N columns (default 4800):
Gnnz/s and effective GFLOP/s, by CUDA events on the card or the host clock
with --device cpu (labelled). The operators are the synthetic ones of
utils/testmats.py (hex derivative and interpolation operators, p = 1..4),
unless XSMM_TPU_REFERENCE_DIR names a checkout of the reference, whose
PyFR .mtx files are then read in place (--synthetic keeps the synthetic
set). It prints which source it used. Returns the number of failed
operators.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import _common


def operators(synthetic: bool):
    """(source description, [(label, dense operator)])."""
    from libxsmm_torch.utils.testmats import (have_reference_pyfr_mats,
                                              hex_derivative_operator,
                                              hex_interp_operator,
                                              reference_pyfr_operators)
    if have_reference_pyfr_mats() and not synthetic:
        ops = [(f"{name:18s}", a) for name, a in
               reference_pyfr_operators(orders=("p2", "p3", "p4"),
                                        elems=("hex",))]
        return (f"{len(ops)} PyFR operators of the reference checkout "
                "(XSMM_TPU_REFERENCE_DIR, read in place)"), ops
    ops = []
    for p in (1, 2, 3, 4):
        ops.append((f"p{p} hex deriv     ", hex_derivative_operator(p)))
        ops.append((f"p{p} hex interp    ", hex_interp_operator(p)))
    return f"{len(ops)} synthetic operators (utils/testmats.py)", ops


def main(argv=None) -> int:
    ap = _common.add_device(argparse.ArgumentParser(
        description="fsspmdm over the PyFR operator set"))
    ap.add_argument("n", nargs="?", type=int, default=4800)
    ap.add_argument("--synthetic", action="store_true")
    args = ap.parse_args(argv)
    dev = _common.device(args.device)
    from libxsmm_torch.matdiff import matdiff
    from libxsmm_torch.ops.fsspmdm import fsspmdm_create

    source, ops = operators(args.synthetic)
    print(source)
    print(f"times: {_common.clock(dev)}")
    n = args.n
    rng = np.random.default_rng(0)
    failures = 0
    for name, a in ops:
        m, k = a.shape
        h = fsspmdm_create(n, a.astype(np.float32), device=dev)
        b = torch.as_tensor(rng.standard_normal((k, n)), device=dev).float()
        want = a.astype(np.float64) @ b.double().cpu().numpy()
        d = matdiff(want, h.execute(b))
        ok = d.normf_rel < 1e-5
        failures += not ok
        best = _common.timed([(h.kernel, (b,))], dev, reps=256)[0]
        gnnz = h.nnz * n / best / 1e9
        eff = 2 * h.nnz * n / best / 1e9
        print(f"{name} {m:4d}x{k:4d} nnz={h.nnz:6d} "
              f"({h.nnz / (m * k):4.0%}) [{h.kind:6s}] "
              f"{'OK ' if ok else 'FAIL'} {gnnz:8.1f} Gnnz/s {eff:8.1f} "
              f"GF/s(eff) ({best * 1e6:.1f} us)")
    if failures:
        print(f"{failures} operator(s) FAILED tolerance")
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
