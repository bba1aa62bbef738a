"""probe_bcsc: the BCSC dense and union strategies stage by stage
(samples/probe_bcsc.py) on the port.

    python -m libxsmm_torch.samples.probe_bcsc [density] [--size N]
        [--device cpu]

At bench.py's BCSC case (m = k = n = 1024, 32 x 32 blocks, bf16 -> f32,
density 0.2 by default), times each stage of the two strategies:

  densify (take + transpose)   the dense strategy's gather as torch ops
  take only                    the gather without the transpose
  a.T                          A transposed into a new buffer
  dense matmul alone           torch.mm of A and the densified B, bf16
  full dense / full union      create_packed_spgemm_bcsc, the whole call
  union rhs compaction (torch) the union RHS gathered by torch ops
  densify kernel               BcscDensify, the dense strategy's kernel
  compact rhs kernel           BcscUnionCompact, the union's compactor

The union stages use the port's own maps (build_bcsc_spmm_union's gmap).
Each stage's output is held against numpy first (the gathers and the
transpose exactly, the products against the dense product within 2e-2
normf_rel), then timed: CUDA events on the card, the host clock with
--device cpu (labelled). Returns the number of failed checks.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import _common


def stages(density: float, size: int, dev: torch.device):
    """(nblocks, U, [(name, fn, args, numpy reference, tol, useful
    flops)]): tol 0 means exact."""
    from libxsmm_torch.descriptor import GemmFlags, GemmShape, SpgemmConfig
    from libxsmm_torch.dtypes import Datatype
    from libxsmm_torch.kernels import spmm as KS
    from libxsmm_torch.ops.sparse import (BcscMatrix,
                                          create_packed_spgemm_bcsc)

    m = k = n = size
    bk = bn = 32
    rng = np.random.default_rng(2)
    bmat = rng.standard_normal((k, n)).astype(np.float32)
    keep = rng.random((k // bk, n // bn)) < density
    bmat *= np.kron(keep, np.ones((bk, bn), np.float32))
    bc = BcscMatrix.from_dense(bmat, bk, bn)
    nblocks = bc.nblocks
    shape = GemmShape(m, n, k, a_in_type=Datatype.BF16,
                      b_in_type=Datatype.BF16, out_type=Datatype.F32)
    cfg = SpgemmConfig(bk=bk, bn=bn)
    a = torch.as_tensor(rng.standard_normal((m, k)), device=dev).to(
        torch.bfloat16)
    vals = torch.as_tensor(bc.data, device=dev).to(torch.bfloat16)
    kb, nb = k // bk, n // bn
    a_np = a.float().cpu().numpy()
    v_np = vals.float().cpu().numpy()
    vpad_np = np.concatenate([v_np, np.zeros((1, bk, bn), np.float32)])
    b_np = BcscMatrix((k, n), bk, bn, bc.indptr, bc.indices,
                      v_np).to_dense()
    prod = a_np @ b_np

    # the dense strategy's gather map
    indptr, indices = bc.indptr, bc.indices
    gmap = np.full((kb, nb), nblocks, np.int32)
    for j in range(nb):
        gmap[indices[indptr[j]:indptr[j + 1]], j] = np.arange(
            indptr[j], indptr[j + 1], dtype=np.int32)
    gmapd = torch.as_tensor(gmap.reshape(-1), device=dev).long()

    def vpad(v):
        return torch.cat([v, v.new_zeros((1, bk, bn))])

    def densify(gm, v):
        dense = vpad(v)[gm].reshape(kb, nb, bk, bn)
        return dense.permute(0, 2, 1, 3).reshape(k, n)

    def take_only(gm, v):
        return vpad(v)[gm]

    def transpose_a(x):
        return x.t().contiguous()

    bdense = densify(gmapd, vals)
    out = [
        ("densify(take+transpose)", densify, (gmapd, vals), b_np, 0, None),
        ("take only", take_only, (gmapd, vals), vpad_np[gmap.reshape(-1)],
         0, None),
        ("a.T", transpose_a, (a,), a_np.T, 0, None),
        ("dense matmul alone", torch.mm, (a, bdense), prod, 2e-2,
         2 * m * n * k),
    ]
    useful = 2 * nblocks * bk * bn * m
    for strat in ("dense", "union"):
        kern = create_packed_spgemm_bcsc(shape, GemmFlags.BETA_0, cfg,
                                         indptr, indices, strategy=strat,
                                         device=dev)
        out.append((f"full {strat}", kern, (a, vals), prod, 2e-2, useful))

    pfn = KS.build_bcsc_spmm_union(shape, cfg, indptr, indices, dev)
    U, W, nsg = pfn.U, pfn.W, pfn.nsg
    gmap_u = pfn.gmap.long()
    rhs_np = vpad_np[gmap_u.cpu().numpy()].reshape(nsg, U, W, bk, bn)
    rhs_np = rhs_np.transpose(0, 1, 3, 2, 4).reshape(nsg, U * bk, W * bn)

    def compact_rhs(gm, v):
        rhs = vpad(v)[gm].reshape(nsg, U, W, bk, bn)
        return rhs.permute(0, 1, 3, 2, 4).reshape(nsg, U * bk, W * bn)

    dfn = KS.build_bcsc_densify(shape, cfg, indptr, indices, dev)
    out += [
        ("union rhs compaction(torch)", compact_rhs, (gmap_u, vals), rhs_np,
         0, None),
        ("densify kernel", dfn, (vals,), b_np, 0, None),
        ("compact rhs kernel", pfn.compactor, (vals,), rhs_np, 0, None),
    ]
    return nblocks, (U, kb), out


def main(argv=None) -> int:
    ap = _common.add_device(argparse.ArgumentParser(
        description="the BCSC strategies stage by stage"))
    ap.add_argument("density", nargs="?", type=float, default=0.2)
    ap.add_argument("--size", type=int, default=1024, help="m = k = n")
    args = ap.parse_args(argv)
    dev = _common.device(args.device)
    from libxsmm_torch.matdiff import matdiff

    nblocks, (U, kb), todo = stages(args.density, args.size, dev)
    print(f"density={args.density} nblocks={nblocks}")
    print(f"union U={U} of kb={kb} (union density {U / kb:.2f})")
    print(f"times: {_common.clock(dev)}")
    failures = 0
    for name, fn, fargs, ref, tol, useful in todo:
        got = fn(*fargs).float().cpu().numpy()
        if tol == 0:
            ok = got.shape == ref.shape and np.array_equal(got, ref)
            err = "exact" if ok else "differs"
        else:
            info = matdiff(ref, got)
            ok = info.normf_rel < tol
            err = f"normf_rel={info.normf_rel:.2e}"
        failures += not ok
        t = _common.timed([(fn, fargs)], dev, reps=30)[0]
        extra = (f"  {useful / t / 1e12:6.2f} TF/s" if useful else "")
        print(f"{name:28s} {t * 1e6:9.1f} us{extra}  "
              f"{'OK' if ok else 'FAIL'} ({err})")
    print("done")
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
