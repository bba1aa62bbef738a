"""equation: the 11 matrix-equation drivers (samples/equation.py) on the
port.

    python -m libxsmm_torch.samples.equation [--device cpu]

Each driver builds its tree through the push-back API, dispatches it with
dispatch_meqn and holds the result against numpy with matdiff (normf_rel
1e-5; 5e-5 for the fused matmul, 1e-4 for the three-way bf16 split).
gather_bcstmul_add chains standalone meltw TPPs, as the reference driver
does. Returns the number of failed drivers.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from . import _common

m, n, k = 64, 256, 128


def drivers(dev: torch.device):
    """[(name, numpy reference, output as float32 numpy, tol)] of the 11
    drivers, from samples/equation.py's seed and in its order."""
    import libxsmm_torch as xp
    from libxsmm_torch.descriptor import (BinaryFlags, BinaryType,
                                          TernaryFlags, TernaryType,
                                          UnaryFlags, UnaryType,
                                          create_meltw_binary_shape,
                                          create_meltw_unary_shape)
    from libxsmm_torch.dtypes import Datatype

    rng = np.random.default_rng(42)
    out = []

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def t(a):
        return torch.as_tensor(a, device=dev)

    def f32(x):
        return x.detach().float().cpu().numpy()

    def add(name, ref, got, tol=1e-5):
        out.append((name, np.asarray(ref, np.float32), f32(got), tol))

    # simple: MUL(ADD(x0, INC(x1)), ADD(X2(x2), x3))
    x0, x1, x2, x3 = r(m, n), r(m, n), r(m, n), r(m, n)
    idx = xp.meqn_create()
    xp.meqn_push_back_binary_op(idx, BinaryType.MUL)
    xp.meqn_push_back_binary_op(idx, BinaryType.ADD)
    xp.meqn_push_back_arg(idx, m, n, in_pos=0)
    xp.meqn_push_back_unary_op(idx, UnaryType.INC)
    xp.meqn_push_back_arg(idx, m, n, in_pos=1)
    xp.meqn_push_back_binary_op(idx, BinaryType.ADD)
    xp.meqn_push_back_unary_op(idx, UnaryType.X2)
    xp.meqn_push_back_arg(idx, m, n, in_pos=2)
    xp.meqn_push_back_arg(idx, m, n, in_pos=3)
    kern = xp.dispatch_meqn(idx, m, n)
    add("simple", (x0 + (x1 + 1)) * (x2 * x2 + x3),
        kern(t(x0), t(x1), t(x2), t(x3)))

    # relu: RELU(ADD(x0, INC(SUB(x1, x2))))
    idx = xp.meqn_create()
    xp.meqn_push_back_unary_op(idx, UnaryType.RELU)
    xp.meqn_push_back_binary_op(idx, BinaryType.ADD)
    xp.meqn_push_back_unary_op(idx, UnaryType.INC)
    xp.meqn_push_back_binary_op(idx, BinaryType.SUB)
    xp.meqn_push_back_arg(idx, m, n, in_pos=0)
    xp.meqn_push_back_arg(idx, m, n, in_pos=1)
    xp.meqn_push_back_arg(idx, m, n, in_pos=2)
    kern = xp.dispatch_meqn(idx, m, n)
    add("relu", np.maximum((x0 - x1) + 1 + x2, 0.0),
        kern(t(x0), t(x1), t(x2)))

    # matmul fusion: MUL(s, GELU(ADD(TANH(MATMUL(A, B)), C)))
    A, B, C, S = r(m, k), r(k, n), r(m, n), r(m, n)
    idx = xp.meqn_create()
    xp.meqn_push_back_binary_op(idx, BinaryType.MUL)
    xp.meqn_push_back_arg(idx, m, n, in_pos=0)
    xp.meqn_push_back_unary_op(idx, UnaryType.GELU)
    xp.meqn_push_back_binary_op(idx, BinaryType.ADD)
    xp.meqn_push_back_unary_op(idx, UnaryType.TANH)
    xp.meqn_push_back_binary_op(idx, BinaryType.MATMUL, dtype=Datatype.F32)
    xp.meqn_push_back_arg(idx, m, k, in_pos=1)
    xp.meqn_push_back_arg(idx, k, n, in_pos=2)
    xp.meqn_push_back_arg(idx, m, n, in_pos=3)
    kern = xp.dispatch_meqn(idx, m, n)
    tt = np.tanh(A @ B) + C
    erf_v = np.vectorize(lambda v: math.erf(v / math.sqrt(2.0)))
    gelu = 0.5 * tt * (1.0 + erf_v(tt).astype(np.float32))
    add("matmul", S * gelu, kern(t(S), t(A), t(B), t(C)), tol=5e-5)

    # layernorm: MULADD(MUL(SUB(x, mean), rstd), gamma, beta)
    x = r(m, n)
    gamma, beta = r(1, n), r(1, n)
    mean = x.mean(axis=1, keepdims=True)
    rstd = 1.0 / np.sqrt(x.var(axis=1, keepdims=True) + 1e-5)
    idx = xp.meqn_create()
    xp.meqn_push_back_ternary_op(idx, TernaryType.MULADD)
    xp.meqn_push_back_binary_op(idx, BinaryType.MUL)
    xp.meqn_push_back_binary_op(idx, BinaryType.SUB)
    xp.meqn_push_back_arg(idx, m, n, in_pos=0)
    xp.meqn_push_back_arg(idx, m, 1, in_pos=1)
    xp.meqn_push_back_arg(idx, m, 1, in_pos=2)
    xp.meqn_push_back_arg(idx, 1, n, in_pos=3)
    xp.meqn_push_back_arg(idx, 1, n, in_pos=4)
    kern = xp.dispatch_meqn(idx, m, n)
    add("layernorm", (x - mean) * rstd * gamma + beta,
        kern(t(x), t(mean), t(rstd), t(gamma), t(beta)))

    # simple_layernorm: MULADD(MULADD(x, s1, b1) [scalar bcast], s2, b2)
    s1 = np.asarray([[1.7]], np.float32)
    idx = xp.meqn_create()
    xp.meqn_push_back_ternary_op(idx, TernaryType.MULADD)
    xp.meqn_push_back_ternary_op(
        idx, TernaryType.MULADD, flags=TernaryFlags.BCAST_SCALAR_IN_1)
    xp.meqn_push_back_arg(idx, m, n, in_pos=0)
    xp.meqn_push_back_arg(idx, 1, 1, in_pos=1)
    xp.meqn_push_back_arg(idx, m, n, in_pos=2)
    xp.meqn_push_back_arg(idx, 1, n, in_pos=3)
    xp.meqn_push_back_arg(idx, 1, n, in_pos=4)
    kern = xp.dispatch_meqn(idx, m, n)
    add("simple_layernorm", (x0 * 1.7 + x1) * gamma + beta,
        kern(t(x0), t(s1), t(x1), t(gamma), t(beta)))

    # softmax: DIV(EXP(SUB(x, rowmax)), rowsum)
    mx = x.max(axis=1, keepdims=True)
    e = np.exp(x - mx)
    sm = e.sum(axis=1, keepdims=True)
    idx = xp.meqn_create()
    xp.meqn_push_back_binary_op(idx, BinaryType.DIV)
    xp.meqn_push_back_unary_op(idx, UnaryType.EXP)
    xp.meqn_push_back_binary_op(idx, BinaryType.SUB)
    xp.meqn_push_back_arg(idx, m, n, in_pos=0)
    xp.meqn_push_back_arg(idx, m, 1, in_pos=1)
    xp.meqn_push_back_arg(idx, m, 1, in_pos=2)
    kern = xp.dispatch_meqn(idx, m, n)
    add("softmax", e / sm, kern(t(x), t(mx), t(sm)))

    # gather_dot: REDUCE_COLS(MUL(GATHER_cols(x, idx), y))
    ncols = 32
    cols = rng.choice(n, ncols, replace=False).astype(np.int32)
    y = r(m, ncols)
    idx = xp.meqn_create()
    xp.meqn_push_back_unary_op(idx, UnaryType.REDUCE_X_OP_ADD,
                               flags=UnaryFlags.REDUCE_COLS)
    xp.meqn_push_back_binary_op(idx, BinaryType.MUL)
    xp.meqn_push_back_unary_op(idx, UnaryType.GATHER,
                               flags=UnaryFlags.GS_COLS, op_arg_pos=2)
    xp.meqn_push_back_arg(idx, m, n, in_pos=0)
    xp.meqn_push_back_arg(idx, m, ncols, in_pos=1)
    kern = xp.dispatch_meqn(idx, 1, ncols)
    add("gather_dot", (x[:, cols] * y).sum(axis=0, keepdims=True),
        kern(t(x), t(y), t(cols)))

    # gather_reduce: REDUCE_COLS(GATHER_cols(x, idx))
    idx = xp.meqn_create()
    xp.meqn_push_back_unary_op(idx, UnaryType.REDUCE_X_OP_ADD,
                               flags=UnaryFlags.REDUCE_COLS)
    xp.meqn_push_back_unary_op(idx, UnaryType.GATHER,
                               flags=UnaryFlags.GS_COLS, op_arg_pos=1)
    xp.meqn_push_back_arg(idx, m, n, in_pos=0)
    kern = xp.dispatch_meqn(idx, 1, ncols)
    add("gather_reduce", x[:, cols].sum(axis=0, keepdims=True),
        kern(t(x), t(cols)))

    # gather_bcstmul_add: standalone TPPs chained, not an equation tree
    rowv = r(1, ncols)
    g_k = xp.dispatch_meltw_unary(UnaryType.GATHER,
                                  create_meltw_unary_shape(m, n),
                                  UnaryFlags.GS_COLS)
    mul_k = xp.dispatch_meltw_binary(BinaryType.MUL,
                                     create_meltw_binary_shape(m, ncols),
                                     BinaryFlags.BCAST_COL_IN_1)
    red_k = xp.dispatch_meltw_unary(UnaryType.REDUCE_X_OP_ADD,
                                    create_meltw_unary_shape(m, ncols),
                                    UnaryFlags.REDUCE_ROWS)
    add_k = xp.dispatch_meltw_binary(BinaryType.ADD,
                                     create_meltw_binary_shape(m, 1))
    acc = r(m, 1)
    gat = g_k(t(x), t(cols))
    add("gather_bcstmul_add",
        (x[:, cols] * rowv).sum(axis=1, keepdims=True) + acc,
        add_k(red_k(mul_k(gat, t(rowv))), t(acc)))

    # splitSGD: UNZIP(NMULADD(lr, g, ZIP(lo, hi))) on raw 16-bit halves
    w = r(m, n)
    g = r(m, n)
    lr = np.asarray([[0.01]], np.float32)
    wbits = w.view(np.uint32)
    lo = (wbits & 0xFFFF).astype(np.uint16)
    hi = (wbits >> 16).astype(np.uint16)
    idx = xp.meqn_create()
    xp.meqn_push_back_unary_op(idx, UnaryType.UNZIP)
    xp.meqn_push_back_ternary_op(idx, TernaryType.NMULADD,
                                 flags=TernaryFlags.BCAST_SCALAR_IN_0)
    xp.meqn_push_back_arg(idx, 1, 1, in_pos=0)          # lr
    xp.meqn_push_back_arg(idx, m, n, in_pos=1)          # g
    xp.meqn_push_back_binary_op(idx, BinaryType.ZIP)
    xp.meqn_push_back_arg(idx, m, n, in_pos=2, dtype=Datatype.U16)
    xp.meqn_push_back_arg(idx, m, n, in_pos=3, dtype=Datatype.U16)
    kern = xp.dispatch_meqn(idx, m, n, out_type=Datatype.U16)
    lo2, hi2 = kern(t(lr), t(g), t(lo.astype(np.int32)).to(torch.uint16),
                    t(hi.astype(np.int32)).to(torch.uint16))
    bits = ((hi2.to(torch.int64) << 16) | lo2.to(torch.int64))
    wnew = bits.cpu().numpy().astype(np.uint32).view(np.float32)
    add("splitSGD", w - 0.01 * g, torch.from_numpy(wnew))

    # bf16_x3_split_f32: f32 from a three-way bf16 split
    xf = r(m, n)
    b0 = xf.astype(np.float32)
    b0_bf = f32(xp.rne_convert_fp32_bf16(t(b0)))
    r1 = b0 - b0_bf
    b1_bf = f32(xp.rne_convert_fp32_bf16(t(r1)))
    r2 = r1 - b1_bf
    b2_bf = f32(xp.rne_convert_fp32_bf16(t(r2)))
    idx = xp.meqn_create()
    xp.meqn_push_back_binary_op(idx, BinaryType.ADD)
    xp.meqn_push_back_binary_op(idx, BinaryType.ADD)
    xp.meqn_push_back_arg(idx, m, n, in_pos=0, dtype=Datatype.BF16)
    xp.meqn_push_back_arg(idx, m, n, in_pos=1, dtype=Datatype.BF16)
    xp.meqn_push_back_arg(idx, m, n, in_pos=2, dtype=Datatype.BF16)
    kern = xp.dispatch_meqn(idx, m, n)
    # the three-way split carries about 24 bits: far below bf16's epsilon
    add("bf16_x3_split_f32", xf, kern(t(b0_bf), t(b1_bf), t(b2_bf)),
        tol=1e-4)
    return out


def main(argv=None) -> int:
    ap = _common.add_device(argparse.ArgumentParser(
        description="the 11 matrix-equation drivers"))
    dev = _common.device(ap.parse_args(argv).device)
    from libxsmm_torch.matdiff import matdiff

    fails = []
    for name, ref, got, tol in drivers(dev):
        info = matdiff(ref, got)
        ok = info.normf_rel < tol
        print(f"{name:<22s} {'OK ' if ok else 'FAIL'} "
              f"normf_rel={info.normf_rel:.2e} linf_abs={info.linf_abs:.2e}")
        if not ok:
            fails.append(name)
    print(f"\n{11 - len(fails)}/11 equation drivers OK"
          + (f"; FAILED: {fails}" if fails else ""))
    return len(fails)


if __name__ == "__main__":
    raise SystemExit(main())
