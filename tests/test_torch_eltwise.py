"""Element-wise TPPs and the stateful eltwise kernels: the port
(`libxsmm_torch.ops.eltwise`, `libxsmm_torch.kernels.eltwise`) against the
JAX package on the same numpy inputs, on the CPU (the port runs the plain
torch versions of its kernels there).

Tolerances (matdiff normf_rel): 1e-5 for f32 outputs (the two frameworks'
transcendental functions differ in the last bits); 1e-2 for bf16 outputs
(one bf16 rounding of values that may differ in the last f32 bits); exact
for layout transforms, bit manipulations, integer, mask and quant outputs,
and for dropout_inv given a mask. Dropout's random bits differ by design
(the JAX package's CPU path draws jax.random, the port a counter hash), so
dropout is held to statistical parity: keep rate within 4 sigma of 1 - p,
the 1/(1-p) scale, and mask and output agreeing.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import libxsmm_torch as xp
import libxsmm_tpu as xt
from libxsmm_torch import interop
from libxsmm_torch.kernels import eltwise as ke
from libxsmm_torch.matdiff import check
from libxsmm_tpu.descriptor import (BinaryFlags, BinaryType, TernaryFlags,
                                    TernaryType, UnaryFlags, UnaryType)
from libxsmm_tpu.dtypes import Datatype
from libxsmm_tpu.kernels import eltwise_pallas as rk

torch.set_num_threads(1)

RNG = np.random.default_rng(11)
F32, BF16, F16 = Datatype.F32, Datatype.BF16, Datatype.F16
TOL = {F32: 1e-5, BF16: 1e-2, F16: 2e-3}


def rand(*shape, positive=False):
    x = RNG.standard_normal(shape).astype(np.float32)
    return np.abs(x) + 0.5 if positive else x


def pair(x, dt=F32):
    """(JAX operand, CPU tensor) holding identical values of dt."""
    if dt == BF16:
        xj = jnp.asarray(x, jnp.bfloat16)
        return xj, interop.tensor_from_numpy(np.asarray(xj), xp.Datatype.BF16,
                                             device="cpu")
    if dt == F16:
        x = np.ascontiguousarray(x.astype(np.float16))
        return jnp.asarray(x), torch.from_numpy(x.copy())
    x = np.ascontiguousarray(x)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def np_of(x):
    """A result of either package as a numpy array (bf16 and f16 widened to
    f32, 16-bit unsigned words to int32)."""
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        if x.dtype == torch.uint16:
            x = x.to(torch.int32)
        return x.numpy()
    x = np.asarray(x)
    if x.dtype.name in ("bfloat16", "float16"):
        return x.astype(np.float32)
    if x.dtype == np.uint16:
        return x.astype(np.int32)
    return x


def same(ref, got, tol=0.0):
    if isinstance(ref, tuple):
        assert isinstance(got, tuple) and len(ref) == len(got)
        for r, g in zip(ref, got):
            same(r, g, tol)
        return
    r, g = np_of(ref), np_of(got)
    assert r.shape == g.shape, (r.shape, g.shape)
    if tol == 0.0 or r.dtype.kind in "biu":
        np.testing.assert_array_equal(g, r)
    else:
        check(r.astype(np.float64), g.astype(np.float64), margin=tol)


def pflags(cls, flags):
    return cls(int(flags))


def unary_both(op, m, n, flags=UnaryFlags.NONE, in_type=F32,
               out_type=Datatype.IMPLICIT, extra=()):
    j = xt.dispatch_meltw_unary(op, m, n, flags, in_type, out_type,
                                extra=extra)
    p = xp.dispatch_meltw_unary(
        xp.UnaryType[op.name], m, n, pflags(xp.UnaryFlags, flags),
        xp.Datatype(in_type.value), xp.Datatype(out_type.value),
        extra=extra)
    return j, p


# ---------------------------------------------------------------------------
# unary math, reductions, activations with bitmasks
# ---------------------------------------------------------------------------

MATH_OPS = [UnaryType[o.name] for o in xp.ops.eltwise._UNARY_MATH]
POSITIVE = ("SQRT", "RECIPROCAL", "RECIPROCAL_SQRT")


@pytest.mark.parametrize("dt", [F32, BF16], ids=lambda d: d.value)
@pytest.mark.parametrize("op", MATH_OPS, ids=lambda o: o.name)
def test_unary_math_parity(op, dt):
    m, n = 12, 20
    xj, xt_ = pair(rand(m, n, positive=op.name in POSITIVE), dt)
    j, p = unary_both(op, m, n, in_type=dt)
    same(j(xj), p(xt_), TOL[dt])


# (in, out) type pairs beyond F32/BF16 with an IMPLICIT output: f16 input,
# and explicit outputs that widen, narrow or cross between 16-bit types
UNARY_TYPES = [(F16, Datatype.IMPLICIT), (F32, BF16), (F32, F16),
               (BF16, F32), (F16, F32), (BF16, F16)]


@pytest.mark.parametrize("in_dt,out_dt", UNARY_TYPES,
                         ids=lambda d: d.value)
@pytest.mark.parametrize("op", MATH_OPS, ids=lambda o: o.name)
def test_unary_math_types(op, in_dt, out_dt):
    """The tolerance is the output type's (an f32 output of a 16-bit input
    is exact up to the transcendentals' last bits)."""
    m, n = 8, 24
    xj, xt_ = pair(rand(m, n, positive=op.name in POSITIVE), in_dt)
    j, p = unary_both(op, m, n, in_type=in_dt, out_type=out_dt)
    got = p(xt_)
    out = in_dt if out_dt == Datatype.IMPLICIT else out_dt
    assert got.dtype == xp.to_torch(xp.Datatype(out.value))
    same(j(xj), got, TOL[out])


@pytest.mark.parametrize("op", ["RELU", "LEAKY_RELU", "ELU"])
@pytest.mark.parametrize("alpha", [None, 0.2])
def test_activation_bitmask_and_alpha(op, alpha):
    m, n = 10, 40                      # n not a multiple of 16
    xj, xt_ = pair(rand(m, n))
    flags = UnaryFlags.BITMASK_2BYTEMULT
    j, p = unary_both(UnaryType[op], m, n, flags)
    kw = {} if alpha is None else {"alpha": alpha}
    same(j(xj, **kw), p(xt_, **kw), 1e-5)


@pytest.mark.parametrize("op", ["RELU_INV", "LEAKY_RELU_INV"])
def test_activation_backward_from_bitmask(op):
    m, n = 10, 40
    mask = RNG.random((m, n)) < 0.5
    packed = np.asarray(xt.pack_bitmask(jnp.asarray(mask)))
    gj, gt = pair(rand(m, n))
    j, p = unary_both(UnaryType[op], m, n)
    same(j(gj, packed, 0.3), p(gt, torch.from_numpy(packed), 0.3), 1e-6)


def test_elu_inv_parity():
    m, n = 8, 16
    gj, gt = pair(rand(m, n))
    oj, ot = pair(rand(m, n))
    j, p = unary_both(UnaryType.ELU_INV, m, n)
    same(j(gj, oj, 0.7), p(gt, ot, 0.7), 1e-6)


REDUCES = ["REDUCE_X_OP_ADD", "REDUCE_X2_OP_ADD", "REDUCE_X_X2_OP_ADD",
           "REDUCE_X_OP_MAX", "REDUCE_X_OP_MIN", "REDUCE_X_OP_MUL",
           "REDUCE_X_OP_ABSMAX", "REDUCE_TO_SCALAR_OP_ADD"]


@pytest.mark.parametrize("rows", [False, True])
@pytest.mark.parametrize("op", REDUCES)
def test_reduce_parity(op, rows):
    m, n = 6, 9
    flags = UnaryFlags.REDUCE_ROWS if rows else UnaryFlags.REDUCE_COLS
    xj, xt_ = pair(rand(m, n) * 0.9)
    j, p = unary_both(UnaryType[op], m, n, flags)
    same(j(xj), p(xt_), 1e-5)


@pytest.mark.parametrize("op", ["REDUCE_X_OP_MAX", "REDUCE_X_OP_MIN"])
def test_reduce_record_argop_parity(op):
    m, n = 9, 6
    flags = UnaryFlags.REDUCE_COLS | UnaryFlags.REDUCE_RECORD_ARGOP
    xj, xt_ = pair(rand(m, n))
    j, p = unary_both(UnaryType[op], m, n, flags)
    (rj, aj), (rp, ap) = j(xj), p(xt_)
    same(rj, rp, 1e-6)
    assert ap.dtype == torch.int32
    same(aj, ap)


def test_reduce_init_acc_parity():
    m, n = 8, 16
    flags = UnaryFlags.REDUCE_COLS | UnaryFlags.REDUCE_INIT_ACC
    xj, xt_ = pair(rand(m, n))
    aj, at = pair(rand(1, n))
    a2j, a2t = pair(rand(1, n))
    j, p = unary_both(UnaryType.REDUCE_X_X2_OP_ADD, m, n, flags)
    same(j(xj, aj, a2j), p(xt_, at, a2t), 1e-5)
    _, pmax = unary_both(UnaryType.REDUCE_X_OP_MAX, m, n, flags)
    with pytest.raises(ValueError, match="ADD reduces"):
        pmax(xt_, at)


def test_reduce_ncnc_parity():
    bc, bn, C, N = 4, 2, 8, 6
    xj, xt_ = pair(rand(N * C))
    j, p = unary_both(UnaryType.REDUCE_X_OP_ADD_NCNC_FORMAT, bc, bn,
                      extra=(C, N))
    same(j(xj), p(xt_), 1e-5)


@pytest.mark.parametrize("flag", ["BCAST_ROW", "BCAST_COL", "BCAST_SCALAR"])
def test_unary_bcast_parity(flag):
    m, n = 5, 7
    shape = {"BCAST_ROW": (m, 1), "BCAST_COL": (1, n),
             "BCAST_SCALAR": (1, 1)}[flag]
    xj, xt_ = pair(rand(*shape))
    j, p = unary_both(UnaryType.EXP, m, n, UnaryFlags[flag])
    same(j(xj), p(xt_), 1e-5)


# ---------------------------------------------------------------------------
# layout transforms, gather/scatter, bit manipulations
# ---------------------------------------------------------------------------

TRANSFORMS = [o.name for o in UnaryType if o.name.startswith("TRANSFORM_")]


def _transform_input_shape(op, m, n):
    """A VNNIk input is the packed (m/k, n*k) form of the (m, n) matrix, a
    VNNIkT input that of its (n, m) transpose."""
    match = re.match(r"TRANSFORM_VNNI(\d)(T?)_TO", op)
    if not match:
        return m, n
    k = int(match.group(1))
    return (n // k, m * k) if match.group(2) else (m // k, n * k)


@pytest.mark.parametrize("op", TRANSFORMS)
def test_transform_parity(op):
    m, n = 16, 8
    xj, xt_ = pair(rand(*_transform_input_shape(op, m, n)))
    j, p = unary_both(UnaryType[op], m, n)
    same(j(xj), p(xt_))


@pytest.mark.parametrize("op", ["TRANSFORM_NORM_TO_VNNI2_PAD",
                                "TRANSFORM_NORM_TO_VNNI4T",
                                "TRANSFORM_PADNM_MOD4",
                                "TRANSFORM_PADM_MOD2"])
def test_transform_ragged_parity(op):
    m, n = 13, 6
    xj, xt_ = pair(rand(m, n))
    j, p = unary_both(UnaryType[op], m, n)
    same(j(xj), p(xt_))


def test_transform_unpadded_vnni_refuses_ragged():
    x = torch.zeros(7, 4)
    p = xp.dispatch_meltw_unary(xp.UnaryType.TRANSFORM_NORM_TO_VNNI2, 7, 4)
    with pytest.raises(ValueError, match="m % 2"):
        p(x)


@pytest.mark.parametrize("cols", [False, True])
def test_gather_scatter_parity(cols):
    m, n = 10, 6
    idx = np.asarray([0, 3, 5], np.int32)
    flags = UnaryFlags.GS_COLS if cols else UnaryFlags.NONE
    xj, xt_ = pair(rand(m, n))
    j, p = unary_both(UnaryType.GATHER, m, n, flags)
    gj, gp = j(xj, idx), p(xt_, idx)
    same(gj, gp)
    out0 = np.zeros((m, n), np.float32)
    sm, sn = (m, 3) if cols else (3, n)
    js, ps = unary_both(UnaryType.SCATTER, sm, sn, flags)
    same(js(gj, idx, out0), ps(gp, idx, torch.from_numpy(out0)))


@pytest.mark.parametrize("op", ["REDUCE_COLS_IDX_OP_ADD",
                                "REDUCE_COLS_IDX_OP_MAX",
                                "REDUCE_COLS_IDX_OP_MIN"])
def test_reduce_cols_idx_parity(op):
    m, n = 12, 5
    idx = np.asarray([1, 4, 4, 9], np.int32)
    xj, xt_ = pair(rand(m, n))
    j, p = unary_both(UnaryType[op], m, n)
    same(j(xj, idx), p(xt_, torch.from_numpy(idx)), 1e-6)


def test_replicate_col_var_parity():
    m = 6
    xj, xt_ = pair(rand(m, 1))
    j, p = unary_both(UnaryType.REPLICATE_COL_VAR, m, 4)
    same(j(xj, ncols=9), p(xt_, ncols=9))


def test_unzip_zip_parity_and_roundtrip():
    m, n = 8, 8
    x = rand(m, n)
    xj, xt_ = pair(x)
    j, p = unary_both(UnaryType.UNZIP, m, n)
    (loj, hij), (lop, hip) = j(xj), p(xt_)
    assert lop.dtype == torch.uint16 and hip.dtype == torch.uint16
    same((loj, hij), (lop, hip))
    zj = xt.dispatch_meltw_binary(BinaryType.ZIP, m, n,
                                  in_type=Datatype.U16, out_type=F32)
    zp = xp.dispatch_meltw_binary(xp.BinaryType.ZIP, m, n,
                                  in_type=xp.Datatype.U16,
                                  out_type=xp.Datatype.F32)
    back = zp(lop, hip)
    same(zj(loj, hij), back)
    np.testing.assert_array_equal(back.numpy(), x)
    # the reference ABI's bf16-typed halves are read by their bits
    hb = hip.to(torch.int32).to(torch.int16).view(torch.bfloat16)
    lb = lop.to(torch.int32).to(torch.int16).view(torch.bfloat16)
    np.testing.assert_array_equal(zp(lb, hb).numpy(), x)


@pytest.mark.parametrize("factor", [1, 2, 4])
def test_decompress_sparse_parity(factor):
    m, n = 8, 8
    mask = RNG.random((m, n)) < 0.4
    dense = rand(m, n) * mask
    values = dense.reshape(-1)[mask.reshape(-1)]
    comp = np.zeros(m * n, np.float32)
    comp[:values.size] = values
    op = UnaryType[f"DECOMPRESS_SPARSE_FACTOR_{factor}"]
    xj, xt_ = pair(comp.reshape(m, n))
    j, p = unary_both(op, m, n)
    got = p(xt_, torch.from_numpy(mask.astype(np.uint8)))
    same(j(xj, mask.astype(np.uint8)), got)
    np.testing.assert_array_equal(got.numpy(), dense)


@pytest.mark.parametrize("op", ["DECOMP_FP32_TO_BF16X2",
                                "DECOMP_FP32_TO_BF16X3"])
def test_decomp_bf16_parity(op):
    m, n = 8, 8
    xj, xt_ = pair(rand(m, n) * 10)
    j, p = unary_both(UnaryType[op], m, n)
    same(j(xj), p(xt_))


def test_dump_prints(capsys):
    p = xp.dispatch_meltw_unary(xp.UnaryType.DUMP, 2, 2)
    x = torch.ones(2, 2)
    assert p(x) is x
    assert "xsmm dump" in capsys.readouterr().out


@pytest.mark.parametrize("two_byte", [True, False])
@pytest.mark.parametrize("n", [8, 16, 40])
def test_bitmask_roundtrip_parity(n, two_byte):
    m = 5
    mask = RNG.random((m, n)) < 0.5
    pj = np.asarray(xt.pack_bitmask(jnp.asarray(mask), two_byte_mult=two_byte))
    pp = xp.pack_bitmask(torch.from_numpy(mask), two_byte_mult=two_byte)
    assert pp.dtype == torch.uint8
    np.testing.assert_array_equal(pp.numpy(), pj)
    assert xp.bitmask_ld(n, two_byte) == xt.bitmask_ld(n, two_byte)
    np.testing.assert_array_equal(xp.unpack_bitmask(pp, m, n).numpy(), mask)


def test_bitmask_tight_layout_needs_byte_rows():
    with pytest.raises(ValueError, match="byte multiple"):
        xp.bitmask_ld(12, two_byte_mult=False)


def test_trunc_f32_to_bf16_parity():
    from libxsmm_torch.ops.eltwise import _trunc_f32_to_bf16_f32 as pt
    from libxsmm_tpu.ops.eltwise import _trunc_f32_to_bf16_f32 as jt
    x = np.concatenate([rand(64), [-0.0, 1e-40, -3.3e38, np.inf]]).astype(
        np.float32)
    same(jt(jnp.asarray(x)), pt(torch.from_numpy(x)))


# ---------------------------------------------------------------------------
# binary and ternary
# ---------------------------------------------------------------------------

BINARY = ["ADD", "MUL", "SUB", "DIV", "MAX", "MIN", "MUL_AND_REDUCE_TO_SCALAR_OP_ADD",
          "PACK", "CMP_OP_GT", "CMP_OP_GE", "CMP_OP_LT", "CMP_OP_LE",
          "CMP_OP_EQ", "CMP_OP_NE"]


def binary_both(op, m, n, flags=BinaryFlags.NONE, in_type=F32,
                out_type=Datatype.IMPLICIT):
    j = xt.dispatch_meltw_binary(op, m, n, flags, in_type, out_type)
    p = xp.dispatch_meltw_binary(
        xp.BinaryType[op.name], m, n, pflags(xp.BinaryFlags, flags),
        xp.Datatype(in_type.value), xp.Datatype(out_type.value))
    return j, p


@pytest.mark.parametrize("dt", [F32, BF16], ids=lambda d: d.value)
@pytest.mark.parametrize("op", BINARY)
def test_binary_parity(op, dt):
    m, n = 11, 9
    a, b = rand(m, n), rand(m, n)
    if op == "DIV":
        b = b + np.sign(b) * 0.5
    if op.startswith("CMP"):
        b[::3] = a[::3]                  # ties for GE/LE/EQ/NE
    aj, at = pair(a, dt)
    bj, bt = pair(b, dt)
    j, p = binary_both(BinaryType[op], m, n, in_type=dt)
    same(j(aj, bj), p(at, bt), TOL[dt])


# (in0, in1, out): mixed input types, f16, explicit outputs
BINARY_TYPES = [(F32, BF16, F32), (BF16, F32, F32), (F16, F32, F32),
                (F16, F16, Datatype.IMPLICIT), (BF16, BF16, F32),
                (F32, F32, BF16), (F32, F16, F16), (BF16, F16, F32)]


@pytest.mark.parametrize("in0,in1,out", BINARY_TYPES,
                         ids=lambda d: d.value)
@pytest.mark.parametrize("op", ["ADD", "MUL", "SUB", "DIV", "MAX", "MIN"])
def test_binary_mixed_types(op, in0, in1, out):
    """A MeltwBinaryShape with in0/in1/out types of their own (the
    reference's v2 call form), both packages."""
    m, n = 7, 12
    a, b = rand(m, n), rand(m, n)
    if op == "DIV":
        b = b + np.sign(b) * 0.5
    aj, at = pair(a, in0)
    bj, bt = pair(b, in1)
    j = xt.dispatch_meltw_binary(
        BinaryType[op], xt.MeltwBinaryShape(m, n, in0_type=in0,
                                            in1_type=in1, out_type=out),
        int(BinaryFlags.NONE))
    p = xp.dispatch_meltw_binary(
        xp.BinaryType[op], xp.MeltwBinaryShape(
            m, n, in0_type=xp.Datatype(in0.value),
            in1_type=xp.Datatype(in1.value), out_type=xp.Datatype(out.value)),
        int(xp.BinaryFlags.NONE))
    want, got = j(aj, bj), p(at, bt)
    res = in0 if out == Datatype.IMPLICIT else out
    assert got.dtype == xp.to_torch(xp.Datatype(res.value))
    same(want, got, TOL[res])


def test_binary_muladd_parity():
    m, n = 8, 8
    (aj, at), (bj, bt), (cj, ct) = (pair(rand(m, n)) for _ in range(3))
    j, p = binary_both(BinaryType.MULADD, m, n)
    same(j(aj, bj, cj), p(at, bt, ct), 1e-6)
    with pytest.raises(ValueError, match="previous output"):
        p(at, bt)


@pytest.mark.parametrize("flag,shape0,shape1", [
    ("BCAST_COL_IN_1", (6, 10), (1, 10)), ("BCAST_ROW_IN_1", (6, 10), (6, 1)),
    ("BCAST_SCALAR_IN_0", (1, 1), (6, 10)), ("BCAST_ROW_IN_0", (6, 1), (6, 10)),
    ("BCAST_COL_IN_0", (1, 10), (6, 10)),
    ("BCAST_SCALAR_IN_1", (6, 10), (1, 1))])
def test_binary_bcast_parity(flag, shape0, shape1):
    aj, at = pair(rand(*shape0))
    bj, bt = pair(rand(*shape1))
    j, p = binary_both(BinaryType.SUB, 6, 10, BinaryFlags[flag])
    same(j(aj, bj), p(at, bt), 1e-6)


CONTRACTIONS = [o.name for o in BinaryType
                if o.name.startswith(("MATMUL", "BRGEMM"))]


@pytest.mark.parametrize("op", CONTRACTIONS)
def test_binary_contraction_parity(op):
    m, n, k, br = 6, 5, 4, 3
    a_shape = (k, m) if "A_TRANS" in op or "A_VNNI_TRANS" in op else (m, k)
    b_shape = (n, k) if "B_TRANS" in op else (k, n)
    if op.startswith("BRGEMM"):
        a_shape, b_shape = (br,) + a_shape, (br,) + b_shape
    aj, at = pair(rand(*a_shape))
    bj, bt = pair(rand(*b_shape))
    j, p = binary_both(BinaryType[op], m, n)
    same(j(aj, bj), p(at, bt), 1e-5)
    assert p.info.nflops == 2 * m * n * a_shape[-1] * (
        br if op.startswith("BRGEMM") else 1)


TERNARY = ["MULADD", "NMULADD", "SELECT"]


@pytest.mark.parametrize("dt", [F32, BF16], ids=lambda d: d.value)
@pytest.mark.parametrize("op", TERNARY)
def test_ternary_parity(op, dt):
    m, n = 9, 7
    aj, at = pair(rand(m, n), dt)
    bj, bt = pair(rand(m, n), dt)
    j = xt.dispatch_meltw_ternary(TernaryType[op], m, n, in_type=dt)
    p = xp.dispatch_meltw_ternary(xp.TernaryType[op], m, n,
                                  in_type=xp.Datatype(dt.value))
    if op == "SELECT":
        packed = np.asarray(xt.pack_bitmask(jnp.asarray(
            RNG.random((m, n)) < 0.5)))
        same(j(aj, bj, packed), p(at, bt, torch.from_numpy(packed)))
    else:
        cj, ct = pair(rand(m, n), dt)
        same(j(aj, bj, cj), p(at, bt, ct), TOL[dt])


def test_ternary_bcast_parity():
    m, n = 6, 8
    aj, at = pair(rand(m, n))
    bj, bt = pair(rand(1, n))
    cj, ct = pair(rand(m, 1))
    flags = TernaryFlags.BCAST_COL_IN_1 | TernaryFlags.BCAST_ROW_IN_2
    j = xt.dispatch_meltw_ternary(TernaryType.MULADD, m, n, flags)
    p = xp.dispatch_meltw_ternary(xp.TernaryType.MULADD, m, n,
                                  xp.TernaryFlags(int(flags)))
    same(j(aj, bj, cj), p(at, bt, ct), 1e-6)


@pytest.mark.parametrize("op", [o.name for o in TernaryType
                                if o.name.startswith(("MATMUL", "BRGEMM"))])
def test_ternary_contraction_parity(op):
    m, n, k, br = 5, 4, 6, 2
    a_shape = (k, m) if "A_TRANS" in op or "A_VNNI_TRANS" in op else (m, k)
    b_shape = (n, k) if "B_TRANS" in op else (k, n)
    if op.startswith("BRGEMM"):
        a_shape, b_shape = (br,) + a_shape, (br,) + b_shape
    aj, at = pair(rand(*a_shape))
    bj, bt = pair(rand(*b_shape))
    cj, ct = pair(rand(m, n))
    j = xt.dispatch_meltw_ternary(TernaryType[op], m, n)
    p = xp.dispatch_meltw_ternary(xp.TernaryType[op], m, n)
    same(j(aj, bj, cj), p(at, bt, ct), 1e-5)


def test_generic_dispatch_meltw_parity():
    m, n = 4, 6
    for d in (xt.meltw_descriptor_init(F32, F32, m, n,
                                       op_type=UnaryType.TANH),
              xt.meltw_descriptor_init(F32, F32, m, n,
                                       op_type=BinaryType.MUL,
                                       operation="binary"),
              xt.meltw_descriptor_init2(F32, F32, Datatype.U8, F32, F32, m,
                                        n, op_type=TernaryType.SELECT,
                                        operation="ternary")):
        pd = interop.descriptor_from_fields(interop.descriptor_fields(d))
        j, p = xt.dispatch_meltw(d), xp.dispatch_meltw(pd)
        args = [pair(rand(m, n)) for _ in range(
            {"unary": 1, "binary": 2, "ternary": 2}[d.operation])]
        if d.operation == "ternary":
            args.append(pair(np.asarray(xt.pack_bitmask(jnp.asarray(
                RNG.random((m, n)) < 0.5)))))
        same(j(*(a for a, _ in args)), p(*(b for _, b in args)), 1e-5)
    bad = xp.MeltwDescriptor("quaternary", xp.UnaryType.TANH,
                             xp.UnaryFlags.NONE, m, n)
    with pytest.raises(ValueError, match="unknown meltw operation"):
        xp.dispatch_meltw(bad)


# ---------------------------------------------------------------------------
# quant / dequant, dropout, stochastic rounding
# ---------------------------------------------------------------------------

def _quant_input():
    x = RNG.uniform(-400.0, 400.0, (16, 16)).astype(np.float32)
    x[0, :4] = [0.5, 1.5, 2.5, -2.5]     # round-half-even ties
    return x


@pytest.mark.parametrize("out", ["int8", "int16", "int32", "uint8",
                                 "uint16"])
@pytest.mark.parametrize("sign_sat", [False, True])
def test_quant_wrap_and_saturate_parity(out, sign_sat):
    x = _quant_input()
    ref = rk.quant(jnp.asarray(x), 3.0, np.dtype(out), sign_sat=sign_sat)
    got = ke.quant(torch.from_numpy(x), 3.0, getattr(torch, out),
                   sign_sat=sign_sat)
    assert str(got.dtype).split(".")[-1] == out
    np.testing.assert_array_equal(got.to(torch.int64).numpy(),
                                  np.asarray(ref).astype(np.int64))


def test_quant_dequant_dispatch_parity():
    m, n = 16, 16
    x = _quant_input()
    xj, xt_ = pair(x)
    for flags in (UnaryFlags.NONE, UnaryFlags.SIGN_SAT_QUANT,
                  UnaryFlags.NO_SCF_QUANT):
        j, p = unary_both(UnaryType.QUANT, m, n, flags, out_type=Datatype.I8)
        same(j(xj, 0.7), p(xt_, 0.7))
    qj, qt = pair(RNG.integers(-128, 127, (m, n)).astype(np.int8))
    for flags in (UnaryFlags.NONE, UnaryFlags.NO_SCF_QUANT):
        j, p = unary_both(UnaryType.DEQUANT, m, n, flags,
                          in_type=Datatype.I8, out_type=F32)
        same(j(qj, 0.25), p(qt, 0.25), 1e-7)


def test_quant_per_column_scale_parity():
    x = _quant_input()
    scale = RNG.uniform(0.1, 2.0, (1, 16)).astype(np.float32)
    ref = rk.quant(jnp.asarray(x), jnp.asarray(scale), np.int8)
    got = ke.quant(torch.from_numpy(x), torch.from_numpy(scale), torch.int8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_quant_stochastic_statistics():
    x = np.full((256, 256), 0.25, np.float32)
    q = ke.quant(torch.from_numpy(x), 1.0, torch.int8, stochastic=True,
                 seed=5)
    frac = q.float().mean().item()          # P(round up to 1) = 0.25
    assert abs(frac - 0.25) < 4 * (0.25 * 0.75 / x.size) ** 0.5
    assert set(np.unique(q.numpy())) <= {0, 1}


@pytest.mark.parametrize("out_type", [Datatype.MXFP4X2, Datatype.MXBF8])
def test_mx_quant_dequant_parity(out_type):
    """MX QUANT/DEQUANT: the (payload, scales) bytes and the dequantized
    values equal the JAX package's (at magnitudes whose block scales stay
    where XLA's exp2 is exact, tests/test_torch_quant.py)."""
    x = rand(32, 64) * (4.0 if out_type == Datatype.MXFP4X2 else 4096.0)
    xj, xt_ = pair(x)
    j, p = unary_both(UnaryType.QUANT, 32, 64, out_type=out_type)
    (pj, sj), (pp, sp) = j(xj), p(xt_)
    np.testing.assert_array_equal(pp.view(torch.uint8).numpy(),
                                  np.asarray(pj).view(np.uint8))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
    j, p = unary_both(UnaryType.DEQUANT, 32, 64, in_type=out_type)
    same(j(pj, sj), p(pp, sp))


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("dt", [F32, BF16], ids=lambda d: d.value)
def test_dropout_inv_exact(dt, packed):
    m, n, p = 12, 40, 0.3
    mask = RNG.random((m, n)) < 0.7
    gj, gt = pair(rand(m, n), dt)
    if packed:
        mj = np.asarray(xt.pack_bitmask(jnp.asarray(mask)))
        mt = torch.from_numpy(mj)
    else:
        mj, mt = mask.astype(np.uint8), torch.from_numpy(mask.astype(np.uint8))
    same(rk.dropout_inv(gj, jnp.asarray(mj), p), ke.dropout_inv(gt, mt, p))


@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("dt", [F32, BF16, Datatype.F16],
                         ids=lambda d: d.value)
def test_dropout_statistics(dt, p):
    m, n = 256, 192
    x = np.abs(rand(m, n)) + 1.0
    _, xt_ = pair(x, dt) if dt != Datatype.F16 else (
        None, torch.from_numpy(x.astype(np.float16)))
    out, mask = ke.dropout(xt_, 17, p)
    assert out.dtype == xt_.dtype and mask.dtype == torch.uint8
    keep = mask.bool()
    sigma = (p * (1 - p) / x.size) ** 0.5
    assert abs(keep.float().mean().item() - (1 - p)) < 4 * sigma
    # the reference's own keep rate at the same size, for parity
    _, jmask = rk.dropout(jnp.asarray(x), 17, p)
    assert abs(np.asarray(jmask).mean() - (1 - p)) < 4 * sigma
    want = (xt_.float() * (np.float32(1) / (np.float32(1) - np.float32(p))))
    np.testing.assert_array_equal(out[keep].float().numpy(),
                                  want.to(xt_.dtype).float()[keep].numpy())
    assert bool((out[~keep] == 0).all())
    # deterministic in the seed, different across seeds
    out2, mask2 = ke.dropout(xt_, 17, p)
    assert torch.equal(out, out2) and torch.equal(mask, mask2)
    assert not torch.equal(mask, ke.dropout(xt_, 18, p)[1])


def test_dropout_dispatch_bitmask_parity():
    m, n, p = 64, 40, 0.3
    x = np.abs(rand(m, n)) + 1.0
    xj, xt_ = pair(x)
    flags = UnaryFlags.BITMASK_2BYTEMULT
    j, pk = unary_both(UnaryType.DROPOUT, m, n, flags, extra=(p,))
    (oj, mj), (op, mp) = j(xj, seed=3), pk(xt_, seed=3)
    assert np_of(mj).shape == tuple(mp.shape) == (m, 6)
    keep = xp.unpack_bitmask(mp, m, n)
    assert torch.equal(keep, op != 0)
    np.testing.assert_allclose(op[keep].numpy(), x[keep.numpy()] / (1 - p),
                               rtol=1e-6)
    inv_j, inv_p = unary_both(UnaryType.DROPOUT_INV, m, n, flags, extra=(p,))
    gj, gt = pair(rand(m, n))
    same(inv_j(gj, mp.numpy()), inv_p(gt, mp))
    # a positional seed is the seed, as in the reference
    assert torch.equal(pk(xt_, 3)[1], mp)
    # no flag: the output alone
    _, plain = unary_both(UnaryType.DROPOUT, m, n, extra=(p,))
    assert torch.equal(plain(xt_, seed=3), op)


def test_dropout_refuses_p_one():
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        ke.dropout(torch.ones(4, 4), 0, 1.0)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        ke.dropout_inv(torch.ones(4, 4), torch.ones(4, 4), 1.0)


def test_stochastic_round_bf16_statistics():
    # 1 + 2^-9 sits a quarter of the way from 1 to the next bf16 (1+2^-7)
    x = torch.full((128, 128), 1.0 + 2 ** -9)
    _, p = unary_both(UnaryType.STOCHASTIC_ROUND, 128, 128, out_type=BF16)
    y = p(x, 9)
    assert y.dtype == torch.bfloat16
    vals = set(np.unique(y.float().numpy()))
    assert vals <= {1.0, 1.0078125}
    up = (y.float() > 1.0).float().mean().item()
    assert abs(up - 0.25) < 4 * (0.25 * 0.75 / x.numel()) ** 0.5
    ref = np.asarray(rk.stochastic_round(jnp.asarray(x.numpy()), 9, BF16),
                     np.float32)
    assert abs((ref > 1.0).mean() - 0.25) < 4 * (0.25 * 0.75 / x.numel()) ** 0.5


def test_stochastic_round_f16_target_is_unbiased():
    x = torch.full((64, 64), 1.0 + 2 ** -12)
    y = ke.stochastic_round(x, 4, xp.Datatype.F16)
    assert y.dtype == torch.float16
    assert abs(y.float().mean().item() - (1.0 + 2 ** -12)) < 2 ** -12
