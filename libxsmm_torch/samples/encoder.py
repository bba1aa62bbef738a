"""encoder: the generated text's structure, then the emitted kernels run
from their AOT records (samples/encoder.py) on the port.

    python -m libxsmm_torch.samples.encoder [--device cpu]

Phase 1 sweeps descriptor classes through the generator entry points and
checks structural invariants of the port's text (lowering.py: the
operands' types and shapes, the result, the aten operators one call runs):
declared dtypes and shapes appear, TRANS flags transpose the declared
operand, a BRGEMM takes the stacked batch and the ADDRESS form its index
operands, f32 products stay f32 (no TF32), fused epilogues and equations
are one kernel, and the register-blocked sparse kernel bakes its values
(its one operand is B).

Phase 2 is the counterpart of the sample's round trip of the emitted
module through the backend compiler. The port has no text compiler, so
each kernel is exported with libxsmm_torch.aot into a KV log, restored
from its record in a fresh process (aot.load_kernel), run there on the
saved operands, and held against the numpy oracle. Returns the number of
failed checks.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

from . import _common

_ROOT = pathlib.Path(__file__).resolve().parents[2]


def operands(code: str):
    """The operand list of a port text, as "dtype[shape]" strings."""
    line = next(ln for ln in code.splitlines()
                if ln.startswith("// operands: "))
    return re.findall(r"\w+\[[\d, ]*\]", line)


def gemm_text_checks(code: str, dtype_name: str, trans: str = ""):
    """The structural checks of a 16x24x32 GEMM's text (A, B of
    `dtype_name`, "float32" or "bfloat16", f32 result; trans "", "TRANS_A"
    or "TRANS_B"): the failed checks' names, empty when all hold."""
    a_shape = "[32, 16]" if trans == "TRANS_A" else "[16, 32]"
    b_shape = "[24, 32]" if trans == "TRANS_B" else "[32, 24]"
    failed = []
    if operands(code) != [f"{dtype_name}{a_shape}", f"{dtype_name}{b_shape}"]:
        failed.append("operand dtypes and shapes")
    if "// result: float32[16, 24]" not in code:
        failed.append("result")
    if not re.search(r"aten\.(mm|matmul|bmm)", code):
        failed.append("an aten product")
    return failed


def _checks(dev):
    import libxsmm_torch as xp
    from libxsmm_torch.descriptor import (BatchReduceConfig, BatchReduceType,
                                          BinaryType, GemmDescriptor,
                                          GemmFlags, GemmShape, UnaryType)
    from libxsmm_torch.dtypes import Datatype

    def gemm(m=16, n=24, k=32, flags=GemmFlags.BETA_0, br=None, **dts):
        return xp.generator_gemm_kernel(
            GemmDescriptor(shape=GemmShape(m, n, k, **dts), flags=flags,
                           br=br or BatchReduceConfig()), device=dev)

    yield ("gemm_f32_operand_shapes", gemm,
           lambda g: not gemm_text_checks(g.code, "float32"))
    # f32 products stay f32: the product's operands and result are f32
    yield ("gemm_f32_no_tf32", gemm,
           lambda g: re.search(r"aten\.mm\.default\(float32\[16, 32\], "
                               r"float32\[32, 24\]\) -> float32\[16, 24\]",
                               g.code) is not None)
    yield ("gemm_bf16_storage_dtypes",
           lambda: gemm(a_in_type=Datatype.BF16, b_in_type=Datatype.BF16,
                        out_type=Datatype.F32),
           lambda g: not gemm_text_checks(g.code, "bfloat16"))
    yield ("gemm_trans_a_flag",
           lambda: gemm(flags=GemmFlags.BETA_0 | GemmFlags.TRANS_A),
           lambda g: not gemm_text_checks(g.code, "float32", "TRANS_A"))
    yield ("gemm_trans_b_flag",
           lambda: gemm(flags=GemmFlags.BETA_0 | GemmFlags.TRANS_B),
           lambda g: not gemm_text_checks(g.code, "float32", "TRANS_B"))
    yield ("gemm_beta1_reads_c", lambda: gemm(flags=GemmFlags.NONE),
           lambda g: operands(g.code)[2:] == ["float32[16, 24]"])
    yield ("brgemm_stride_batch_axis",
           lambda: gemm(br=BatchReduceConfig(BatchReduceType.STRIDE,
                                             br_count_hint=5)),
           lambda g: operands(g.code)[0] == "float32[5, 16, 32]")
    yield ("brgemm_address_index_operands",
           lambda: gemm(br=BatchReduceConfig(BatchReduceType.ADDRESS,
                                             br_count_hint=5)),
           lambda g: operands(g.code)[2:] == ["int32[5]", "int32[5]"])
    yield ("meltw_relu_emits_max",
           lambda: xp.generator_mateltwise_kernel(
               xp.meltw_descriptor_init(Datatype.F32, Datatype.F32, 8, 16,
                                        op_type=UnaryType.RELU), device=dev),
           lambda g: re.search(r"aten\.(clamp_min|relu|maximum)",
                               g.code) is not None)
    yield ("meltw_binary_bf16_storage",
           lambda: xp.generator_mateltwise_kernel(
               xp.meltw_descriptor_init2(
                   Datatype.BF16, Datatype.BF16, None, Datatype.F32,
                   Datatype.BF16, 8, 16, op_type=BinaryType.ADD,
                   operation="binary"), device=dev),
           lambda g: operands(g.code) == ["bfloat16[8, 16]"] * 2)

    def _eqn():
        idx = xp.meqn_create()
        xp.meqn_push_back_binary_op(idx, BinaryType.ADD)
        xp.meqn_push_back_unary_op(idx, UnaryType.GELU)
        xp.meqn_push_back_arg(idx, 8, 8, 0)
        xp.meqn_push_back_arg(idx, 8, 8, 1)
        return xp.generator_matequation_kernel(idx, device=dev)

    # one kernel holding both the gelu's erf and the add: the fusion
    yield ("meqn_fused_single_kernel", _eqn,
           lambda g: (g.code.count("// libxsmm_torch kernel:") == 1
                      and "aten.erf" in g.code and "aten.add" in g.code))

    def _areg():
        rng = np.random.default_rng(0)
        a = ((rng.random((8, 12)) < 0.4)
             * rng.standard_normal((8, 12))).astype(np.float32)
        csr = xp.CsrMatrix.from_dense(a)
        return xp.generator_spgemm_csr_reg_kernel(
            GemmShape(8, 16, 12), csr.indptr, csr.indices,
            a[a != 0].astype(np.float32), device=dev)

    # the values are baked into the kernel: B is its one operand
    yield ("spgemm_areg_values_baked", _areg,
           lambda g: operands(g.code) == ["float32[12, 16]"])


def _exec_cases(dev):
    """(name, kernel, args, oracle, tol) of phase 2."""
    import libxsmm_torch as xp
    from libxsmm_torch.descriptor import (BatchReduceConfig, BinaryType,
                                          GemmDescriptor, GemmFlags,
                                          GemmShape, UnaryType)
    from libxsmm_torch.dtypes import Datatype

    rng = np.random.default_rng(1)
    m, n, k = 16, 24, 32
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)

    def t(v, dt=torch.float32):
        return torch.as_tensor(v, device=dev).to(dt)

    def gemm(flags, **dts):
        return xp.xmmdispatch(GemmDescriptor(shape=GemmShape(m, n, k, **dts),
                                             flags=flags,
                                             br=BatchReduceConfig()))

    yield ("exec_gemm_f32_beta0", gemm(GemmFlags.BETA_0), (t(a), t(b)),
           a @ b, 1e-5)
    yield ("exec_gemm_f32_beta1", gemm(GemmFlags.NONE), (t(a), t(b), t(c)),
           a @ b + c, 1e-5)
    ab, bb = t(a, torch.bfloat16), t(b, torch.bfloat16)
    yield ("exec_gemm_bf16",
           gemm(GemmFlags.BETA_0, a_in_type=Datatype.BF16,
                b_in_type=Datatype.BF16, out_type=Datatype.F32), (ab, bb),
           ab.float().cpu().numpy() @ bb.float().cpu().numpy(), 5e-2)
    x8 = rng.standard_normal((8, 16)).astype(np.float32)
    yield ("exec_meltw_relu", xp.dispatch_meltw_unary(UnaryType.RELU, 8, 16),
           (t(x8),), np.maximum(x8, 0.0), 0.0)
    y8 = rng.standard_normal((8, 16)).astype(np.float32)
    yield ("exec_meltw_binary_add",
           xp.dispatch_meltw_binary(BinaryType.ADD, 8, 16), (t(x8), t(y8)),
           x8 + y8, 0.0)


def _restore(workdir: str) -> None:
    """The fresh process of phase 2: load each record's kernel and run it
    on its saved operands."""
    from libxsmm_torch import aot, native
    work = pathlib.Path(workdir)
    job = torch.load(work / "job.pt", weights_only=False)
    store = native.PersistentKv(work / "aot.kv")
    outs = []
    for key, args in zip(job["keys"], job["args"]):
        kern = aot.load_kernel(store, key)
        if kern is None:
            raise RuntimeError(f"no kernel restored for {key!r}")
        outs.append(kern(*args).cpu())
    torch.save(outs, work / "outs.pt")


def round_trip(cases, workdir: pathlib.Path):
    """Export each case's kernel, restore and run them all in one fresh
    process; returns their outputs as float64 numpy arrays."""
    from libxsmm_torch import aot, native
    store = native.PersistentKv(workdir / "aot.kv")
    keys = [aot.export_kernel(kern, args, store)
            for _name, kern, args, _o, _t in cases]
    torch.save({"keys": keys, "args": [args for _n, _k, args, _o, _t
                                       in cases]}, workdir / "job.pt")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    proc = subprocess.run([sys.executable, "-m",
                           "libxsmm_torch.samples.encoder", "--restore",
                           str(workdir)], cwd=str(_ROOT), env=env,
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"the restoring process failed:\n{proc.stderr}")
    outs = torch.load(workdir / "outs.pt", weights_only=False)
    return [o.double().numpy() for o in outs]


def main(argv=None) -> int:
    ap = _common.add_device(argparse.ArgumentParser(
        description="the generated text's structure, then the AOT round "
                    "trip"))
    ap.add_argument("--restore", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.restore:
        _restore(args.restore)
        return 0
    dev = _common.device(args.device)

    failures = 0
    for name, build, check in _checks(dev):
        gen = build()
        ok = bool(check(gen))
        print(("PASS" if ok else "FAIL"), name,
              f"({gen.code_size} chars, arch={gen.arch})")
        failures += not ok
    cases = list(_exec_cases(dev))
    with tempfile.TemporaryDirectory(prefix="xsmm_encoder_") as tmp:
        outs = round_trip(cases, pathlib.Path(tmp))
    for (name, _kern, _args, want, tol), got in zip(cases, outs):
        err = float(np.abs(got - want.astype(np.float64)).max())
        ok = got.shape == want.shape and err <= tol
        print(("PASS" if ok else "FAIL"), name,
              f"(restored from its AOT record in a fresh process, "
              f"max_err={err:.2e})")
        failures += not ok
    print(f"encoder checks: {'OK' if not failures else failures} "
          f"{'failures' if failures else ''}".strip())
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
