"""spmm_scaling: the distributed BSR SpMM's weak-scaling harness
(samples/spmm_scaling.py) on the port.

    python -m libxsmm_torch.samples.spmm_scaling [max_devices]
        [--density D] [--n N] [--device cpu]

C = A @ X with A block-sparse (16 x 16 blocks, density 0.1), 512 rows of A
a rank and k = 2048 fixed, so the nonzeros a rank hold constant, X (k, N)
with N = 256: DistributedBsrSpmm in worlds of 1, 2, 4 and 8 ranks (up to
max_devices, default 8), then the two-level form (DistributedBsrSpmm2Level,
dcn 2 x ici world/2) at the largest world when it has 4 ranks or more.
Each world is a set of processes (scripts/ranks.run_ranks): with --device
cpu, gloo ranks on the host; on the card, a one-rank NCCL world and gloo
ranks sharing the one card, whose collectives are staged through host
memory. Each rank's band of the result is held against the dense numpy
product (max error within 1e-2 of its largest entry), then timed on every rank in step (CUDA
events on the card, the host clock on the CPU; rank 0's time). Gloo lines
carry no scaling figure. Returns 0 (a failed check raises).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import _common

BR = BC = 16
ROWS_PER_DEV = 512          # constant rows a rank (weak scaling)
K_FIXED = 2048              # fixed contraction: nonzeros a rank constant
NOTE = ("NOTE: ranks on one host or one card share its cores -- these "
        "lines validate the harness, not the hardware; run one rank a card "
        "on a multi-card host for the >=70% weak-scaling target.")


def _draw(rng, nd, density, ncols):
    """(A (m, k) with its block pattern, X (k, ncols)), drawn as the
    sample draws them."""
    m, k = ROWS_PER_DEV * nd, K_FIXED
    mask = rng.random((m // BR, k // BC)) < density
    for i in range(m // BR):
        if not mask[i].any():
            mask[i, rng.integers(k // BC)] = True
    a = rng.standard_normal((m, k)).astype(np.float32)
    a *= np.kron(mask, np.ones((BR, BC), np.float32))
    x = rng.standard_normal((k, ncols)).astype(np.float32)
    return a, x


def rank_cases(cases, device_type, reps=8):
    """On each rank of a world: every (label, A, X, two_level) case, the
    rank's band of rows checked against numpy, then timed. Returns
    [(label, nnz, max error, its bound, seconds a call)]."""
    import torch.distributed as dist

    from libxsmm_torch.ops.sparse import BsrMatrix
    from libxsmm_torch.parallel.mesh import make_mesh
    from libxsmm_torch.parallel.spmm_dist import (DistributedBsrSpmm,
                                                  DistributedBsrSpmm2Level)

    world = dist.get_world_size()
    out = []
    for label, a, x, two_level in cases:
        bsr = BsrMatrix.from_dense(a, BR, BC)
        if two_level:
            mesh = make_mesh([("dcn", 2), ("ici", world // 2)],
                             device_type=device_type)
            spmm = DistributedBsrSpmm2Level(bsr, x.shape[1], mesh)
        else:
            mesh = make_mesh([("x", world)], device_type=device_type)
            spmm = DistributedBsrSpmm(bsr, x.shape[1], mesh)
        xt = torch.as_tensor(x, device=mesh.device)
        # this rank's band of C's rows (the output is row-sharded over all
        # ranks, dcn-major in the two-level form)
        me = (mesh.index("dcn") * (world // 2) + mesh.index("ici")
              if two_level else mesh.index("x"))
        band = a.shape[0] // world
        got = spmm(xt).to_local().cpu().numpy()
        want = a[me * band:(me + 1) * band] @ x
        err = float(np.abs(got - want).max())
        bound = 1e-2 * max(1.0, float(np.abs(a @ x).max()))
        if not err < bound:
            raise AssertionError(f"{label}: max error {err} over {bound}")
        sec = _common.timed([(spmm, (xt,))], mesh.device, reps=reps)[0]
        out.append((label, bsr.nnz, err, bound, sec))
    return out


def main(argv=None) -> int:
    ap = _common.add_device(argparse.ArgumentParser(
        description="the distributed BSR SpMM in worlds of 1 to 8 ranks"))
    ap.add_argument("max_devices", nargs="?", type=int, default=8)
    ap.add_argument("--density", type=float, default=0.1)
    ap.add_argument("--n", type=int, default=256)
    args = ap.parse_args(argv)
    dev = _common.device(args.device)
    from libxsmm_torch.samples import spmm_scaling   # not __main__
    from libxsmm_torch.scripts.ranks import run_ranks

    rng = np.random.default_rng(0)
    ndevs = [d for d in (1, 2, 4, 8, 16) if d <= args.max_devices]
    worlds = {nd: [(f"devices={nd:2d}", *_draw(rng, nd, args.density,
                                                 args.n), False)]
              for nd in ndevs}
    if max(ndevs) >= 4:
        nd = max(ndevs)
        worlds[nd].append((f"2-level dcn=2 x ici={nd // 2}",
                           *_draw(rng, nd, args.density, args.n), True))
    on_card = dev.type == "cuda"
    for nd, cases in worlds.items():
        backend = "nccl" if on_card and nd == 1 else "gloo"
        how = ("card, NCCL, CUDA events" if backend == "nccl" else
               f"gloo, {nd} ranks on one card, collectives staged through "
               "host memory: not a scaling figure" if on_card else
               f"gloo, {nd} ranks on the host CPU, host clock: not a "
               "scaling figure")
        ranks = run_ranks(spmm_scaling.rank_cases, nd, (cases, dev.type),
                          device_type=dev.type, backend=backend,
                          timeout=600.0)
        for i, (_, a, _x, _tl) in enumerate(cases):
            label, nnz, _, _, sec = ranks[0][i]
            err = max(r[i][2] for r in ranks)
            print(f"{label}  m={a.shape[0]:6d} k={a.shape[1]}  "
                  f"nnz={nnz:9d}  {nnz / sec / 1e9:7.3f} Gnnz/s "
                  f"({sec * 1e3:.3f} ms a call; max err {err:.1e}) [{how}]")
    print(NOTE)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
