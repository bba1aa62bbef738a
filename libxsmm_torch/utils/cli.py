"""xsmm-gen: kernel pre-building from a JSON manifest, and the reference's
generator driver.

The port of `libxsmm_tpu/utils/cli.py` (the reference's offline codegen
pair, src/libxsmm_generator_gemm_driver.c and
src/libxsmm_binaryexport_generator.c + samples/static_codegen JSON
manifests). The manifest form dispatches every kernel of the manifest and
invokes it once on the device, so its CUDA library is built into
kernels/build/ and any autotune pick lands in the KV log
(XSMM_TPU_AUTOTUNE_CACHE): later processes start warm, the effect of the
reference's `make MNK=...` static kernel registration
(src/libxsmm_main.c:622-666).

Manifest schema (JSON):
{
  "gemm":   [{"m":32,"n":32,"k":32,"dtype":"f32","beta":0,"br":0,
              "batch":0}, ...],
  "eltwise":[{"op":"RELU","kind":"unary","m":64,"n":64,"dtype":"f32"}, ...],
  "spgemm": [{"kind":"fsspmdm"|"csr_areg"|"csc"|"bcsc","mtx":"a.mtx",
              "n":4800, "m":16, "bk":32, "bn":32, "strategy":"dense"}, ...]
}

Usage:
  python -m libxsmm_torch.utils.cli manifest.json [--bench] [--device cpu]
  python -m libxsmm_torch.utils.cli <dense|dense_asm|sparse|sparse_csr|
      sparse_csr_reg> file_out routine M N K LDA LDB LDC alpha beta
      aligned_a aligned_c ARCH PREFETCH PRECISION [mtx_file]
The card is the default device; --device cpu runs the plain versions.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _per_call(fn, args) -> float:
    """Seconds per call of fn(*args): utils/timer.bench_chain on the card,
    the host clock on the CPU."""
    from .timer import bench_chain, bench_host_interleaved
    if any(getattr(a, "device", None) is not None and a.device.type == "cuda"
           for a in args):
        return bench_chain(fn, args, chain_idx=0, reps=20)
    return bench_host_interleaved([(fn, args)], reps=20)[0]


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _normal(rng, shape, dtype, device):
    import torch
    return torch.as_tensor(rng.standard_normal(shape)).to(dtype=dtype,
                                                          device=device)


def _gen_gemm(spec: dict, bench: bool, device) -> str:
    import libxsmm_torch as xt
    from ..descriptor import (BatchReduceConfig, BatchReduceType, GemmFlags,
                              GemmShape)
    from ..dtypes import Datatype, to_torch

    dt = Datatype(spec.get("dtype", "f32"))
    odt = Datatype(spec.get("out_dtype", spec.get("dtype", "f32")))
    shape = GemmShape(spec["m"], spec["n"], spec["k"], a_in_type=dt,
                      b_in_type=dt, out_type=odt)
    flags = GemmFlags.BETA_0 if spec.get("beta", 1) == 0 else GemmFlags.NONE
    br = int(spec.get("br", 0))
    batch = int(spec.get("batch", 0))
    if batch:
        kern = xt.dispatch_gemm_batched(shape, flags)
    elif br:
        kern = xt.dispatch_brgemm(
            shape, flags, BatchReduceConfig(BatchReduceType.STRIDE, br))
    else:
        kern = xt.dispatch_gemm(shape, flags)

    rng = np.random.default_rng(0)
    lead = (batch,) if batch else ((br,) if br else ())
    a = _normal(rng, (*lead, shape.m, shape.k), to_torch(dt), device)
    b = _normal(rng, (*lead, shape.k, shape.n), to_torch(dt), device)
    args = (a, b) if spec.get("beta", 1) == 0 else (
        a, b, a.new_zeros((*(lead if batch else ()), shape.m, shape.n),
                          dtype=to_torch(odt)))
    kern(*args)                # builds the library, runs the kernel once
    _sync(device)
    note = ""
    if bench:
        per = _per_call(kern, args)
        flops = xt.get_kernel_info(kern).nflops * max(1, batch)
        note = f"  {flops / per / 1e9:.1f} GF/s"
    return f"gemm {kern.name}{note}"


def _gen_eltwise(spec: dict, bench: bool, device) -> str:
    import libxsmm_torch as xt
    from ..descriptor import BinaryType, TernaryType, UnaryType
    from ..dtypes import Datatype, to_torch

    kind = spec.get("kind", "unary")
    m, n = spec["m"], spec["n"]
    dt = Datatype(spec.get("dtype", "f32"))
    x = _normal(np.random.default_rng(0), (m, n), to_torch(dt), device)
    if kind == "unary":
        kern = xt.dispatch_meltw_unary(UnaryType[spec["op"]], m, n,
                                       in_type=dt)
    elif kind == "binary":
        kern = xt.dispatch_meltw_binary(BinaryType[spec["op"]], m, n,
                                        in_type=dt)
    else:
        kern = xt.dispatch_meltw_ternary(TernaryType[spec["op"]], m, n,
                                         in_type=dt)
    nargs = {"unary": 1, "binary": 2}.get(kind, 3)
    kern(*(x,) * nargs)
    _sync(device)
    note = ""
    if bench:
        per = _per_call(kern, (x,) * nargs)
        nbytes = (nargs + 1) * x.numel() * x.element_size()
        note = f"  {nbytes / per / 1e9:.1f} GB/s"
    return f"eltwise {kern.name}{note}"


def _gen_spgemm(spec: dict, bench: bool, device) -> str:
    """Sparse kernels from a .mtx file — the reference CLI's sparse modes
    (bin/libxsmm_gemm_generator sparse/sparse_csr_reg consume .mtx,
    documentation/libxsmm_be.md arg list)."""
    import torch

    from ..descriptor import GemmFlags, GemmShape, SpgemmConfig
    from .mtx import read_mtx

    kind = spec.get("kind", "fsspmdm")
    a = read_mtx(spec["mtx"]).astype(np.float32)
    n = int(spec.get("n", 4800))
    rng = np.random.default_rng(0)
    f32 = torch.float32

    def warm(kern, args, nnz_ops):
        # invoke, so the library is built and any autotune pick persisted;
        # nnz_ops = nnz x the per-nonzero MAC width (N for A-sparse
        # streaming, m for the packed B-sparse kinds), the reference
        # drivers' nnz accounting
        kern(*args)
        _sync(device)
        if not bench:
            return ""
        return f"  {nnz_ops / _per_call(kern, args) / 1e9:.1f} Gnnz/s"

    if kind == "fsspmdm":
        from ..ops.fsspmdm import fsspmdm_create
        h = fsspmdm_create(n, a, beta=int(spec.get("beta", 0)), device=device)
        b = _normal(rng, (a.shape[1], n), f32, device)
        note = warm(h.kernel.fn, (b,), h.nnz * n)
        return (f"fsspmdm {a.shape[0]}x{n}x{a.shape[1]} nnz={h.nnz} "
                f"[{h.kind}]{note}")
    if kind == "csr_areg":
        from ..ops.sparse import CsrMatrix, create_spgemm_csr_areg
        csr = CsrMatrix.from_dense(a)
        kern = create_spgemm_csr_areg(
            GemmShape(a.shape[0], n, a.shape[1]), GemmFlags.BETA_0,
            row_ptr=csr.indptr, column_idx=csr.indices, values=csr.data,
            device=device)
        b = _normal(rng, (a.shape[1], n), f32, device)
        note = warm(kern, (b,), csr.nnz * n)
        return f"csr_areg {kern.name} nnz={csr.nnz}{note}"
    if kind == "csc":
        # the reference CLI's `sparse` mode: CSC .mtx -> B-sparse packed
        # kernel. The .mtx holds B (k x n); m comes from the spec.
        from ..ops.sparse import CscMatrix, create_packed_spgemm_csc
        m = int(spec.get("m", 16))
        csc = CscMatrix.from_dense(a)
        kern = create_packed_spgemm_csc(
            GemmShape(m, a.shape[1], a.shape[0]), GemmFlags.BETA_0,
            column_ptr=csc.indptr, row_idx=csc.indices, device=device)
        lhs = _normal(rng, (m, a.shape[0]), f32, device)
        vals = _normal(rng, (csc.nnz,), f32, device)
        note = warm(kern, (lhs, vals), csc.nnz * m)
        return f"csc {kern.name} nnz={csc.nnz}{note}"
    if kind == "bcsc":
        # BCSC B-sparse from .mtx with block shape + lowering strategy (the
        # xgemm_sparse workload as an offline pre-build target)
        from ..dtypes import Datatype, to_torch
        from ..ops.sparse import BcscMatrix, create_packed_spgemm_bcsc
        m = int(spec.get("m", 128))
        bk = int(spec.get("bk", 32))
        bn = int(spec.get("bn", 32))
        dt = Datatype(spec.get("dtype", "f32"))
        odt = Datatype(spec.get("out_dtype", "f32"))
        bcsc = BcscMatrix.from_dense(a, bk, bn)
        kern = create_packed_spgemm_bcsc(
            GemmShape(m, a.shape[1], a.shape[0], a_in_type=dt, b_in_type=dt,
                      out_type=odt), GemmFlags.BETA_0,
            SpgemmConfig(1, bk, bn), column_ptr=bcsc.indptr,
            row_idx=bcsc.indices, strategy=spec.get("strategy", "dense"),
            device=device)
        lhs = _normal(rng, (m, a.shape[0]), to_torch(dt), device)
        vals = _normal(rng, (bcsc.nblocks, bk, bn), to_torch(dt), device)
        note = warm(kern, (lhs, vals), bcsc.nblocks * bk * bn * m)
        return f"bcsc {kern.name} nblocks={bcsc.nblocks} b{bk}x{bn}{note}"
    raise ValueError(f"unknown spgemm kind: {kind}")


_DRIVER_TYPES = ("dense", "dense_asm", "sparse", "sparse_csr",
                 "sparse_csr_reg")


def _driver_main(argv, device) -> int:
    """The reference generator driver's 17-positional-arg form
    (src/libxsmm_generator_gemm_driver.c:87-117; arg list documented in
    documentation/libxsmm_be.md):

        <dense|dense_asm|sparse|sparse_csr|sparse_csr_reg> file_out
        routine_name M N K LDA LDB LDC alpha beta aligned_a aligned_c
        ARCH PREFETCH PRECISION [mtx_file]

    Row-major contract: LDA/LDB/LDC must equal the natural dims or be <1
    (the reference's sparse-operand routing signal). alpha must be 1,
    beta 0 or 1 (the reference restriction). ARCH accepts this port's
    targets (h100, cpu) or 'noarch' (= auto); other names (the reference's
    x86 names, the JAX package's TPU generations) map to auto with a
    notice. PREFETCH is accepted and ignored (only 'nopf' is supported
    there too). Appends the kernel's text (generator.py) to file_out.
    """
    from .. import generator as g
    from ..descriptor import GemmDescriptor, GemmFlags, GemmShape
    from ..dtypes import Datatype

    if len(argv) < 16:
        sys.stderr.write(_driver_main.__doc__ + "\n")
        return 1
    l_type, file_out, routine = argv[0], argv[1], argv[2]
    m, n, k, lda, ldb, ldc = (int(v) for v in argv[3:9])
    alpha, beta = float(argv[9]), float(argv[10])
    arch, prefetch, precision = argv[13], argv[14], argv[15]
    if alpha != 1.0 or beta not in (0.0, 1.0):
        sys.stderr.write("alpha must be 1 and beta 0/1 (reference "
                         "restriction, README 'limited to Alpha:=1')\n")
        return 1
    if prefetch != "nopf":
        sys.stderr.write(f"xsmm-gen: PREFETCH '{prefetch}' ignored (the "
                         "hardware owns prefetching)\n")
    dt = {"SP": Datatype.F32, "DP": Datatype.F64,
          "BF16": Datatype.BF16}.get(precision.upper())
    if dt is None:
        sys.stderr.write(f"unknown PRECISION {precision!r} (SP/DP/BF16)\n")
        return 1
    if arch not in ("noarch", ""):
        from ..device import ARCHIDS
        if arch in ARCHIDS:
            from ..config import set_target
            set_target(arch)
        else:
            sys.stderr.write(f"xsmm-gen: ARCH '{arch}' is not a target of "
                             "this port; using auto-detect\n")
    flags = GemmFlags.BETA_0 if beta == 0.0 else GemmFlags.NONE
    shape = GemmShape(m, n, k, a_in_type=dt, b_in_type=dt, out_type=dt)

    if l_type in ("dense", "dense_asm"):
        for name, ld, dim in (("LDA", lda, k), ("LDB", ldb, n),
                              ("LDC", ldc, n)):
            # any <1 value is the "don't care" / sparse-routing signal
            if ld >= 1 and ld != dim:
                sys.stderr.write(f"row-major contract: {name} must be "
                                 f"{dim} or <1 (row-major operands)\n")
                return 1
        desc = GemmDescriptor(shape=shape, flags=flags)
        gen = (g.generator_gemm_inlineasm if l_type == "dense"
               else g.generator_gemm_directasm)
        gen(file_out, routine, desc, device=device)
    else:
        if len(argv) < 17:
            sys.stderr.write("sparse modes need the .mtx input file\n")
            return 1
        mtx = argv[16]
        if l_type == "sparse_csr_reg":
            from ..ops.sparse import CsrMatrix
            from .mtx import read_mtx
            dense = read_mtx(mtx)
            csr = CsrMatrix.from_dense(dense)
            vdt = np.float64 if dt == Datatype.F64 else np.float32
            gen = g.generator_spgemm_csr_reg_kernel(
                shape, csr.indptr, csr.indices,
                np.asarray(dense[dense != 0], vdt), flags, device=device)
            g._append_text(file_out, routine, gen, commented_header=True)
        else:
            # the reference routes the sparse OPERAND by which ld is <1
            # (lda -> A sparse, ldb -> B sparse); the type keyword only
            # selects the .mtx reader format
            if (lda < 1) == (ldb < 1):
                sys.stderr.write("exactly one of LDA/LDB must be <1 to "
                                 "mark the sparse operand\n")
                return 1
            g.generator_spgemm(file_out, routine,
                               GemmDescriptor(shape=shape, flags=flags),
                               None, mtx,
                               is_csr=int(l_type == "sparse_csr"),
                               sparse_operand="a" if lda < 1 else "b",
                               device=device)
    print(f"xsmm-gen: appended {l_type} routine '{routine}' to {file_out}")
    return 0


def _split_device(argv):
    """(argv without --device X / --device=X, the device or None)."""
    out, device, it = [], None, iter(argv)
    for a in it:
        if a == "--device":
            device = next(it, None)
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            out.append(a)
    return out, device


def main(argv=None) -> int:
    from ..device import resolve_device
    if argv is None:
        argv = sys.argv[1:]
    argv, device = _split_device(list(argv))
    device = resolve_device(device)
    if argv and argv[0] in _DRIVER_TYPES:
        return _driver_main(argv, device)
    p = argparse.ArgumentParser(prog="xsmm-gen", description=__doc__)
    p.add_argument("manifest", help="JSON kernel manifest")
    p.add_argument("--bench", action="store_true",
                   help="report GF/s, GB/s or Gnnz/s per kernel")
    args = p.parse_args(argv)

    with open(args.manifest) as f:
        manifest = json.load(f)

    count = 0
    for spec in manifest.get("gemm", []):
        print(_gen_gemm(spec, args.bench, device))
        count += 1
    for spec in manifest.get("eltwise", []):
        print(_gen_eltwise(spec, args.bench, device))
        count += 1
    for spec in manifest.get("spgemm", []):
        print(_gen_spgemm(spec, args.bench, device))
        count += 1
    print(f"xsmm-gen: {count} kernels compiled")
    return 0


if __name__ == "__main__":
    sys.exit(main())
