"""BCSC union-kernel lab: the union kernel's probes beside the library's
strategies, in one interleaved run on the card.

The port of scripts/bcsc_lab.py, at its shape: m = k = n = 1024, 32 x 32
blocks, bf16 -> f32, the pattern of build_pattern(density, seed=2). The
probes are variants of the port's own union kernel (kernels/spmm_lab.py,
kernels/csrc/spmm_lab_kernels.cu), each keeping one property:

  minimal   the union product over a constant, already compacted RHS: no
            gather, no slot skip; the floor of the union kernel's loop,
            on wgmma fed by TMA
  chunkN    the fused gather with the union slots in N = 1, 2 or 4 chunks,
            the fill of chunk c + 1 issued before the math of chunk c
  dspipe    the fill of the next group's union issued before the math of
            this group

All three multiply on the bf16 tensor cores, as the library's union kernel
does, so t / t(union4) compares staging schedules, not arithmetic.

main() builds the library strategies dense, union, union4, union4a, union4d
and union5 (create_packed_spgemm_bcsc) and the probes, holds every result
but minimal's against the float64 product of the bf16-rounded operands and
each probe against its plain version (1e-4 normf_rel: bf16 in, f32 sums in
another order; minimal multiplies a constant RHS, so only its plain version
holds it), then times all of them interleaved round by round and prints the
useful TF/s and the median of the paired t / t(union4). Anything that
raises propagates.

    python3 -m libxsmm_torch.scripts.bcsc_lab [--density 0.2] [--rounds 5]

--device cpu runs the plain versions on the host clock, a rehearsal of the
control flow. main(argv) returns the printed rows; a probe's row names its
kernel's path ("mma": mma.sync on the tensor cores, "wgmma": Hopper's
warpgroup products on TMA-fed tiles; None for the library's strategies).
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

LIBRARY = ("dense", "union", "union4", "union4a", "union4d", "union5")
TOL = 1e-4


def build_pattern(density, seed=2, m=1024, k=1024, n=1024, bk=32, bn=32):
    """scripts/bcsc_lab.py:30: a standard-normal (k, n) whose (bk, bn)
    blocks are kept at `density`; returns (BcscMatrix, the generator)."""
    del m
    from libxsmm_torch.ops.sparse import BcscMatrix
    rng = np.random.default_rng(seed)
    bmat = rng.standard_normal((k, n)).astype(np.float32)
    keep = rng.random((k // bk, n // bn)) < density
    bmat *= np.kron(keep, np.ones((bk, bn), np.float32))
    return BcscMatrix.from_dense(bmat, bk, bn), rng


def union_maps(indptr, indices, n, bk, bn, nblocks):
    """(krows, gmap, U, W, nsg) as build_bcsc_spmm_union computes them
    without clustering (scripts/bcsc_lab.py:39)."""
    W = 128 // bn
    nsg = n // 128
    unions = []
    for g in range(nsg):
        rows = set()
        for j in range(g * W, (g + 1) * W):
            rows.update(int(r) for r in
                        indices[int(indptr[j]):int(indptr[j + 1])])
        unions.append(sorted(rows))
    U = max(1, max(len(u) for u in unions))
    krows = np.zeros((nsg, U), np.int32)
    gmap = np.full((nsg, U, W), nblocks, np.int32)
    for g, rows in enumerate(unions):
        rows = rows[:U]
        krows[g, :len(rows)] = rows
        rpos = {r: u for u, r in enumerate(rows)}
        for wj in range(W):
            j = g * W + wj
            for pos in range(int(indptr[j]), int(indptr[j + 1])):
                r = int(indices[pos])
                if r in rpos:
                    gmap[g, rpos[r], wj] = pos
    return krows, gmap, U, W, nsg


def make_variants(shape, bcsc, density, device=None) -> Dict[str, object]:
    """{minimal, chunk1, chunk2, chunk4, dspipe}: each fn(a (m, k),
    values (nblocks, 32, 32)) -> (m, n) f32, a wrapper of
    kernels/spmm_lab.py with `.plain` and its launch counter. The plan and
    minimal's constant RHS live on `device` (default: the card). `density`
    is accepted for parity with the JAX lab."""
    del density
    from libxsmm_torch.device import resolve_device
    from libxsmm_torch.kernels import spmm_lab as KL

    m, n, k = shape
    bk, bn = bcsc.bk, bcsc.bn
    if bk != KL.BLOCK or bn != KL.BLOCK:
        raise ValueError(f"the lab's probes take 32 x 32 blocks (got "
                         f"{bk} x {bn})")
    dev = resolve_device(device)
    nblocks = bcsc.nblocks
    krows, gmap, U, W, nsg = union_maps(np.asarray(bcsc.indptr),
                                        np.asarray(bcsc.indices), n, bk, bn,
                                        nblocks)
    print(f"U={U} (union density {U * bk / k:.3f}), nsg={nsg}, "
          f"nblocks={nblocks}", flush=True)
    rhs = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (nsg, U * bk, 128)), device=dev).to(torch.bfloat16)
    out = {"minimal": KL.BcscLabMinimal(m, n, k, nblocks, rhs)}
    for nc in (1, 2, 4):
        out[f"chunk{nc}"] = KL.BcscLabChunk(m, n, k, nblocks, krows, gmap,
                                            dev, nc)
    out["dspipe"] = KL.BcscLabDspipe(m, n, k, nblocks, krows, gmap, dev)
    return out


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--density", type=float, default=0.2)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--variants", type=str, default="",
                    help="comma-separated names to keep (default: all)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from libxsmm_torch.descriptor import GemmFlags, GemmShape, SpgemmConfig
    from libxsmm_torch.device import resolve_device
    from libxsmm_torch.dtypes import Datatype
    from libxsmm_torch.kernels.spmm import build_bcsc_densify
    from libxsmm_torch.matdiff import check
    from libxsmm_torch.ops.sparse import create_packed_spgemm_bcsc
    from libxsmm_torch.utils.timer import (bench_chain_interleaved,
                                           bench_host_interleaved)

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    print("device:", torch.cuda.get_device_name(dev) if on_card else "cpu",
          flush=True)
    m = k = n = 1024
    bk = bn = 32
    bcsc, rng = build_pattern(args.density, m=m, k=k, n=n)
    shape = GemmShape(m, n, k, a_in_type=Datatype.BF16,
                      b_in_type=Datatype.BF16, out_type=Datatype.F32)
    cfg = SpgemmConfig(1, bk, bn)
    a0 = torch.as_tensor(rng.standard_normal((m, k)),
                         device=dev).to(torch.bfloat16)
    v = torch.as_tensor(bcsc.data, device=dev).to(torch.bfloat16)

    fns = {s: create_packed_spgemm_bcsc(shape, GemmFlags.BETA_0, cfg,
                                        column_ptr=bcsc.indptr,
                                        row_idx=bcsc.indices, strategy=s,
                                        device=dev)
           for s in LIBRARY}
    probes = make_variants((m, n, k), bcsc, args.density, dev)
    fns.update(probes)
    if args.variants:
        sel = set(args.variants.split(","))
        fns = {nm: fn for nm, fn in fns.items() if nm in sel}

    # correctness: the float64 product of the bf16 operands (every name but
    # minimal), and each probe against its plain version
    dense_b = build_bcsc_densify(shape, cfg, bcsc.indptr, bcsc.indices,
                                 dev).plain(v)
    want = a0.double() @ dense_b.double()
    errs = {}
    for name, fn in fns.items():
        got = fn(a0, v)
        if name != "minimal":
            errs[name] = check(want, got, margin=TOL).normf_rel
        if name in probes:
            check(fn.plain(a0, v), got, margin=TOL)
        if name in errs:
            print(f"check {name}: normf_rel {errs[name]:.2e} OK", flush=True)

    names = list(fns)
    cands = [(fns[nm], (a0, v)) for nm in names]
    timer = bench_chain_interleaved if on_card else bench_host_interleaved
    t0 = time.perf_counter()
    times, rounds = timer(cands, rounds=args.rounds, per_round=True)
    print(f"measured in {time.perf_counter() - t0:.1f}s", flush=True)

    useful = 2 * bcsc.nblocks * bk * bn * m
    print(f"\nuseful flops/call: {useful / 1e9:.3f} GF")
    rows = []
    base = names.index("union4") if "union4" in names else None
    for i, (nm, t) in enumerate(zip(names, times)):
        vs = None if base is None else float(np.median(
            [ti / tb for ti, tb in zip(rounds[i], rounds[base])]))
        path = fns[nm].path if nm in probes else None
        rows.append({"name": nm, "density": args.density, "us": t * 1e6,
                     "useful_tflops": useful / t / 1e12, "vs_union4": vs,
                     "normf_rel": errs.get(nm), "path": path})
        print(f"{nm:>10}: {t * 1e6:8.2f} us  useful "
              f"{useful / t / 1e12:6.2f} TF/s" + (f"  [{path}]" if path
                                                   else ""))
    for r in rows:
        if r["vs_union4"] is not None:
            print(f"median paired t({r['name']})/t(union4): "
                  f"{r['vs_union4']:.3f}")
    return rows


if __name__ == "__main__":
    main()
