"""Timing of the block-sparse SpMMs on the card at the streaming row count
(m = 32768, k = 1024; f32 in and out with TF32 off, or with `--dtype
bf16` bf16 in and f32 out, stream20's types), at several blockings: the
scheduled kernel ("pallas"), the k-union kernel in its fused and compacted
forms where the blocking tiles a 128-column group, and, at 32 x 32, the
supertile kernel and the strategy that "auto" picks. Each kernel is held
against its plain version (max |diff|, and normf_rel under 1e-5 in f32,
1e-4 for bf16 in) and timed by CUDA events (scripts/timing.py events_ms:
the best of 5 windows of 20 back-to-back calls), by the replay of a CUDA
graph of 20 calls (graph_ms) and by its kernels' device time
(torch.profiler, device_ms); beside them, at every blocking, the library
yardstick: torch.mm of A and the densified B (f32 out) timed the same
three ways. The pattern is bench.py's
(make_bcsc_cases): a standard-normal (k, n) whose blocks are kept at
`--density`, from default_rng(`--seed`); k is 1024 cut to a multiple of bk
(1008 at bk 48), n is 1024, or the least multiple of both bn and 128 past
it.

It uses only entry points that earlier trees of the port have too, so it
also times a checkout of one, whose kernels may take other routes at the
same shapes: put that checkout's root first on PYTHONPATH and run this
file by its path.

    python3 -m libxsmm_torch.scripts.spmm_f32_time [--blockings 32x32,8x8]
        [--dtype bf16]

The last line is one JSON object: the card, its power limit, the tree's
root and the rows.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
from typing import Optional, Sequence

import numpy as np
import torch

try:
    from . import timing
except ImportError:
    import timing   # is sys.path[0]


def _pattern(rng, k, n, bk, bn, density):
    from libxsmm_torch.ops.sparse import BcscMatrix
    bmat = rng.standard_normal((k, n)).astype(np.float32)
    keep = rng.random((k // bk, n // bn)) < density
    bmat *= np.kron(keep, np.ones((bk, bn), np.float32))
    return BcscMatrix.from_dense(bmat, bk, bn)


def _held(fn, a, vals) -> float:
    """fn against its plain version; the max |diff|."""
    from libxsmm_torch.matdiff import check
    got, want = fn(a, vals), fn.plain(a, vals)
    torch.cuda.synchronize()
    check(want.double().cpu().numpy(), got.double().cpu().numpy(),
          margin=1e-5 if a.dtype == torch.float32 else 1e-4)
    return float((got.double() - want.double()).abs().max())


def _timed(call) -> dict:
    """events, replay and device time of one call, ms a call."""
    return {"ms": timing.events_ms(call), "graph_ms": timing.graph_ms(call),
            "device_ms": timing.device_ms(call)}


def rows_at(bk: int, bn: int, m: int, density: float, seed: int,
            dtype: torch.dtype = torch.float32) -> list:
    from libxsmm_torch.descriptor import GemmFlags, GemmShape, SpgemmConfig
    from libxsmm_torch.dtypes import Datatype
    from libxsmm_torch.kernels import spmm as KS
    from libxsmm_torch.ops.sparse import assemble_supertiles, supertile_plan
    import libxsmm_torch as xt

    k = 1024 - 1024 % bk
    step = bn * 128 // math.gcd(bn, 128)
    n = 1024 if 1024 % bn == 0 else -(-1024 // step) * step
    bcsc = _pattern(np.random.default_rng(seed), k, n, bk, bn, density)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
    v = torch.as_tensor(bcsc.data, device="cuda").to(dtype)
    dt = Datatype.BF16 if dtype == torch.bfloat16 else Datatype.F32
    shape = GemmShape(m, n, k, dt, dt, Datatype.F32)
    cfg = SpgemmConfig(1, bk, bn)
    useful = 2 * bcsc.nblocks * bk * bn * m
    case = {"bk": bk, "bn": bn, "m": m, "k": k, "n": n,
            "nblocks": bcsc.nblocks, "useful_gflop": useful / 1e9}
    forms = [("pallas", KS.build_bcsc_spmm(shape, cfg, bcsc.indptr,
                                           bcsc.indices, "cuda"), v)]
    if 128 % bn == 0:
        for form, compact in (("union4", False), ("union", True)):
            forms.append((form, KS.build_bcsc_spmm_union(
                shape, cfg, bcsc.indptr, bcsc.indices, "cuda",
                compact=compact), v))
    if bk == bn == 32:
        s_indptr, s_indices, sgmap = supertile_plan(shape, cfg, bcsc.indptr,
                                                    bcsc.indices)
        sup = assemble_supertiles(v, torch.as_tensor(sgmap, device="cuda"),
                                  dtype)
        forms.append(("super", KS.build_bcsc_spmm_super(
            shape, s_indptr, s_indices, "cuda"), sup))
    rows = []
    for form, fn, vals in forms:
        err = _held(fn, a, vals)
        rows.append({**case, "form": form, "path": getattr(fn, "path", None),
                     "max_abs_err": err,
                     **_timed(lambda fn=fn, vals=vals: fn(a, vals))})
    dense_b = KS.build_bcsc_densify(shape, cfg, bcsc.indptr, bcsc.indices,
                                    "cuda").plain(v)
    rows.append({**case, "form": "torch.mm", "path": "library",
                 **_timed(lambda: torch.mm(a, dense_b,
                                           out_dtype=torch.float32))})
    if bk == bn == 32:
        kern = xt.create_packed_spgemm_bcsc(shape, GemmFlags.BETA_0, cfg,
                                            bcsc.indptr, bcsc.indices,
                                            strategy="auto")
        rows.append({**case, "form": "auto", "pick": kern.name,
                     **_timed(lambda: kern(a, v))})
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blockings", default="32x32,16x64,8x8,4x48",
                    help="bk x bn blockings, comma-separated")
    ap.add_argument("--m", type=int, default=32768)
    ap.add_argument("--density", type=float, default=0.2)
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32",
                    help="operand type (the output is f32)")
    args = ap.parse_args(argv)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    if not torch.cuda.is_available():
        raise SystemExit("spmm_f32_time: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    import libxsmm_torch
    root = str(pathlib.Path(libxsmm_torch.__file__).resolve().parents[1])
    rows = []
    for spec in args.blockings.split(","):
        bk, bn = (int(x) for x in spec.split("x"))
        for r in rows_at(bk, bn, args.m, args.density, args.seed, dtype):
            print(f"  {args.dtype} {bk}x{bn} {r['form']}: {r['ms']:.4f} ms "
                  f"events, {r['graph_ms']:.4f} replay, {r['device_ms']:.4f}"
                  f" device ({r.get('path') or r.get('pick')}; "
                  f"{r['useful_gflop'] / r['ms']:.2f} useful TFLOP/s)",
                  flush=True)
            rows.append(r)
    print(json.dumps({"card": timing.card(), "root": root, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
