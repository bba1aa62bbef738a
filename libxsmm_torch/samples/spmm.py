"""spmm: the BCSC B-sparse SpMM driver (samples/spmm.py) on the port.

    python -m libxsmm_torch.samples.spmm [--bench] [--size N]
        [--densities d1,d2,...] [--device cpu]

Random block sparsity on a dense grid; every strategy of STRATEGIES
(create_packed_spgemm_bcsc) against the dense numpy product, in f32
(normf_rel 1e-5) and bf16 inputs with f32 output (2e-2), at m = n = k =
--size (default 256, 1024 with --bench), densities 0.05, 0.2, 0.5 and
blockings 32 x 32 and 16 x 64 (32 x 32 only with --bench). --bench adds
each strategy's rate (nonzeros' flops over the time per call: CUDA events
on the card, the host clock with --device cpu, labelled). A strategy the
port refuses raises (the sample prints SKIP instead). Returns the number
of failed checks.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import _common

STRATEGIES = ("dense", "sparse", "pallas", "super", "union", "union2")


def draw(rng, m, k, n, bk, bn, density):
    """(B as a dense (k, n) float32 array with the pattern's zeros, A (m,
    k)), drawn as the sample draws them."""
    bmat = rng.standard_normal((k, n)).astype(np.float32)
    keep = rng.random((k // bk, n // bn)) < density
    bmat *= np.kron(keep, np.ones((bk, bn), np.float32))
    a = rng.standard_normal((m, k)).astype(np.float32)
    return bmat, a


def run_case(m, k, n, bk, bn, density, dtype, bench, rng, fails, dev,
             results=None):
    """One (size, blocking, density, dtype) case over every strategy.
    `results`, when given, receives (strategy, output as float32 numpy)."""
    from libxsmm_torch.descriptor import GemmFlags, GemmShape, SpgemmConfig
    from libxsmm_torch.dtypes import Datatype
    from libxsmm_torch.matdiff import matdiff
    from libxsmm_torch.ops.sparse import (BcscMatrix,
                                          create_packed_spgemm_bcsc)

    bmat, a = draw(rng, m, k, n, bk, bn, density)
    bcsc = BcscMatrix.from_dense(bmat, bk, bn)
    if bcsc.nblocks == 0:
        return
    in_dt = Datatype.BF16 if dtype == "bf16" else Datatype.F32
    shape = GemmShape(m, n, k, a_in_type=in_dt, b_in_type=in_dt,
                      out_type=Datatype.F32)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    a_dev = torch.as_tensor(a, device=dev).to(tdt)
    v_dev = torch.as_tensor(bcsc.data, device=dev).to(tdt)
    if dtype == "bf16":
        vals = v_dev.float().cpu().numpy()
        dense = BcscMatrix((k, n), bk, bn, bcsc.indptr, bcsc.indices,
                           vals).to_dense()
        ref = a_dev.float().cpu().numpy() @ dense
        tol = 2e-2
    else:
        ref = a @ bmat
        tol = 1e-5

    for strat in STRATEGIES:
        name = f"{dtype} {m}x{n}x{k} b{bk}x{bn} d{density:g} {strat}"
        kern = create_packed_spgemm_bcsc(
            shape, GemmFlags.BETA_0, SpgemmConfig(1, bk, bn),
            column_ptr=bcsc.indptr, row_idx=bcsc.indices, strategy=strat,
            device=dev)
        out = kern(a_dev, v_dev).float().cpu().numpy()
        if results is not None:
            results.append((strat, out))
        info = matdiff(ref, out)
        ok = info.normf_rel < tol
        line = (f"{name:<44s} {'OK ' if ok else 'FAIL'} "
                f"normf_rel={info.normf_rel:.2e}")
        if bench:
            sec = _common.timed([(kern, (a_dev, v_dev))], dev, reps=16)[0]
            nnz = bcsc.nblocks * bk * bn
            line += (f"  {2 * nnz * m / sec / 1e9:8.1f} Gflop/s"
                     f" ({nnz / 1e3:.0f}k nnz, {sec * 1e3:.4f} ms)")
        print(line)
        if not ok:
            fails.append(name)


def main(argv=None) -> int:
    ap = _common.add_device(argparse.ArgumentParser(
        description="every BCSC strategy against the dense product"))
    ap.add_argument("--bench", action="store_true")
    ap.add_argument("--size", type=int, default=None,
                    help="m=n=k (default 256, or 1024 with --bench)")
    ap.add_argument("--densities", default="0.05,0.2,0.5")
    args = ap.parse_args(argv)
    dev = _common.device(args.device)
    size = args.size or (1024 if args.bench else 256)
    densities = [float(d) for d in args.densities.split(",")]
    if args.bench:
        print(f"times: {_common.clock(dev)}")

    rng = np.random.default_rng(7)
    fails = []
    for density in densities:
        for bk, bn in ((32, 32), (16, 64)) if not args.bench else ((32, 32),):
            for dtype in ("f32", "bf16"):
                run_case(size, size, size, bk, bn, density, dtype,
                         args.bench, rng, fails, dev)
    print(f"\n{'ALL OK' if not fails else f'{len(fails)} FAILED: {fails}'}")
    return len(fails)


if __name__ == "__main__":
    raise SystemExit(main())
