"""Matrix equations: the port (`libxsmm_torch.ops.equation`) against the JAX
package (`libxsmm_tpu.ops.equation`), on the CPU.

Each of the 30 trees of tests/test_equation.py is built in both packages
through the same builder calls and run on the same numpy inputs (the port's
as CPU tensors). Tolerances, as max |port - reference| over max(1,
max |reference|): f32 trees 1e-5, bf16 nodes or outputs 1e-2, f64 trees
1e-12. Exact: ZIP/UNZIP bits, GATHER's fill and wrap, dispatch caching,
`nflops` (also after a gather of another length), and the strings of
meqn_tree_print and meqn_rpn_print.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import libxsmm_torch
from libxsmm_torch import descriptor as PD
from libxsmm_torch import device as PDEV
from libxsmm_torch import dtypes as PDT
from libxsmm_torch.interop import tensor_from_numpy
from libxsmm_torch.ops import equation as PE

import libxsmm_tpu
from libxsmm_tpu import descriptor as RD
from libxsmm_tpu import dtypes as RDT
from libxsmm_tpu.ops import equation as RE

torch.set_num_threads(1)

TOL = {"f32": 1e-5, "bf16": 1e-2, "f64": 1e-12}


def _ns(eq, d, dt, pkg):
    return types.SimpleNamespace(
        E=eq, U=d.UnaryType, B=d.BinaryType, T=d.TernaryType,
        UF=d.UnaryFlags, BF=d.BinaryFlags, TF=d.TernaryFlags,
        DT=dt.Datatype, pkg=pkg)


REF = _ns(RE, RD, RDT, libxsmm_tpu)
PORT = _ns(PE, PD, PDT, libxsmm_torch)


def _t(a):
    """A numpy input as the port's CPU tensor (bf16 bit for bit)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return tensor_from_numpy(a, PDT.Datatype.BF16, "cpu")
    return torch.from_numpy(a.copy())


def _np(x):
    if isinstance(x, tuple):
        return tuple(_np(v) for v in x)
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.float().numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _close(ref, got, tol):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    if tol == 0:
        np.testing.assert_array_equal(got, ref)
        return
    err = np.abs(got - ref).max() if ref.size else 0.0
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def _r(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(build, out, inputs, **kw):
    """Build the tree in both packages, dispatch, run on `inputs`; returns
    (reference result, port result, (ref kernel, port kernel), (ref idx,
    port idx)). Also holds both print forms equal."""
    res, kerns, idxs = [], [], []
    for ns in (REF, PORT):
        idx = ns.E.meqn_create()
        build(ns, idx)
        m, n, ot = out
        k = ns.E.dispatch_meqn(idx, m, n, getattr(ns.DT, ot))
        args = inputs if ns is REF else [_t(a) for a in inputs]
        res.append(k(*args))
        kerns.append(k)
        idxs.append(idx)
    assert (RE.meqn_tree_print(idxs[0]) == PE.meqn_tree_print(idxs[1]))
    assert RE.meqn_rpn_print(idxs[0]) == PE.meqn_rpn_print(idxs[1])
    return res[0], res[1], kerns, idxs


# ---------------------------------------------------------------------------
# the value trees of tests/test_equation.py, one builder each
# ---------------------------------------------------------------------------

def _simple(ns, i, m=8, n=12):
    ns.E.meqn_push_back_binary_op(i, ns.B.MUL)
    ns.E.meqn_push_back_binary_op(i, ns.B.ADD)
    for p in range(3):
        ns.E.meqn_push_back_arg(i, m, n, in_pos=p)


def _relu_matmul(ns, i, m=16, k=8, n=24):
    ns.E.meqn_push_back_unary_op(i, ns.U.RELU)
    ns.E.meqn_push_back_binary_op(i, ns.B.ADD)
    ns.E.meqn_push_back_binary_op(i, ns.B.MATMUL)
    ns.E.meqn_push_back_arg(i, m, k, in_pos=0)
    ns.E.meqn_push_back_arg(i, k, n, in_pos=1)
    ns.E.meqn_push_back_arg(i, 1, n, in_pos=2)


def _layernorm(ns, i, m=32, n=64):
    ns.E.meqn_push_back_ternary_op(i, ns.T.MULADD)
    ns.E.meqn_push_back_binary_op(i, ns.B.MUL)
    ns.E.meqn_push_back_binary_op(i, ns.B.SUB)
    ns.E.meqn_push_back_arg(i, m, n, in_pos=0)
    ns.E.meqn_push_back_arg(i, m, 1, in_pos=1)
    ns.E.meqn_push_back_arg(i, m, 1, in_pos=2)
    ns.E.meqn_push_back_arg(i, 1, n, in_pos=3)
    ns.E.meqn_push_back_arg(i, 1, n, in_pos=4)


def _softmax(ns, i, m=16, n=32):
    ns.E.meqn_push_back_binary_op(i, ns.B.DIV)
    ns.E.meqn_push_back_unary_op(i, ns.U.EXP)
    ns.E.meqn_push_back_binary_op(i, ns.B.SUB)
    ns.E.meqn_push_back_arg(i, m, n, in_pos=0)
    ns.E.meqn_push_back_arg(i, m, 1, in_pos=1)
    ns.E.meqn_push_back_arg(i, m, 1, in_pos=2)


def _gather_dot(ns, i, m=12, n=20):
    ns.E.meqn_push_back_unary_op(i, ns.U.REDUCE_X_OP_ADD,
                                 flags=ns.UF.REDUCE_ROWS)
    ns.E.meqn_push_back_binary_op(i, ns.B.MUL)
    ns.E.meqn_push_back_arg(i, m, n, in_pos=0)
    ns.E.meqn_push_back_arg(i, m, n, in_pos=1)


def _sgd_bf16(ns, i, m=16, n=16):
    ns.E.meqn_push_back_ternary_op(i, ns.T.NMULADD)
    ns.E.meqn_push_back_arg(i, 1, 1, in_pos=0)
    ns.E.meqn_push_back_arg(i, m, n, in_pos=1)
    ns.E.meqn_push_back_arg(i, m, n, in_pos=2)


def _brgemm(ns, i, m=8, k=6, n=10):
    ns.E.meqn_push_back_binary_op(i, ns.B.BRGEMM)
    ns.E.meqn_push_back_arg(i, m, k, in_pos=0)
    ns.E.meqn_push_back_arg(i, k, n, in_pos=1)


def _ternary_matmul_a_trans(ns, i, m=10, k=4, n=12):
    ns.E.meqn_push_back_ternary_op(i, ns.T.MATMUL_A_TRANS)
    ns.E.meqn_push_back_arg(i, k, m, in_pos=0)
    ns.E.meqn_push_back_arg(i, k, n, in_pos=1)
    ns.E.meqn_push_back_arg(i, m, n, in_pos=2)


def _nested_matmul(ns, i, m=8, k1=6, k2=12, n=16):
    ns.E.meqn_push_back_binary_op(i, ns.B.MATMUL)
    ns.E.meqn_push_back_arg(i, m, k1, in_pos=0)
    ns.E.meqn_push_back_binary_op(i, ns.B.MATMUL)
    ns.E.meqn_push_back_arg(i, k1, k2, in_pos=1)
    ns.E.meqn_push_back_arg(i, k2, n, in_pos=2)


def _layernorm_inputs(rng):
    x = _r(rng, 32, 64)
    mean = x.mean(axis=1, keepdims=True)
    rstd = 1.0 / np.sqrt(x.var(axis=1, keepdims=True) + 1e-5)
    return [x, mean, rstd, _r(rng, 1, 64), _r(rng, 1, 64)]


def _softmax_inputs(rng):
    x = _r(rng, 16, 32)
    mx = x.max(axis=1, keepdims=True)
    return [x, mx, np.exp(x - mx).sum(axis=1, keepdims=True)]


VALUE_CASES = {
    "simple": (_simple, (8, 12, "F32"),
               lambda r: [_r(r, 8, 12) for _ in range(3)], "f32"),
    "relu_of_matmul": (_relu_matmul, (16, 24, "F32"),
                       lambda r: [_r(r, 16, 8), _r(r, 8, 24), _r(r, 1, 24)],
                       "f32"),
    "layernorm": (_layernorm, (32, 64, "F32"), _layernorm_inputs, "f32"),
    "softmax": (_softmax, (16, 32, "F32"), _softmax_inputs, "f32"),
    "gather_dot": (_gather_dot, (12, 1, "F32"),
                   lambda r: [_r(r, 12, 20), _r(r, 12, 20)], "f32"),
    "split_sgd_bf16": (_sgd_bf16, (16, 16, "BF16"),
                       lambda r: [np.asarray([[0.01]], np.float32),
                                  _r(r, 16, 16), _r(r, 16, 16)], "bf16"),
    "brgemm_node": (_brgemm, (8, 10, "F32"),
                    lambda r: [_r(r, 4, 8, 6), _r(r, 4, 6, 10)], "f32"),
    "ternary_matmul_a_trans": (
        _ternary_matmul_a_trans, (10, 12, "F32"),
        lambda r: [_r(r, 4, 10), _r(r, 4, 12), _r(r, 10, 12)], "f32"),
    "nested_matmul": (_nested_matmul, (8, 16, "F32"),
                      lambda r: [_r(r, 8, 6), _r(r, 6, 12), _r(r, 12, 16)],
                      "f32"),
}


@pytest.mark.parametrize("case", sorted(VALUE_CASES))
def test_value_tree_matches_reference(case):
    build, out, make, tol = VALUE_CASES[case]
    inputs = make(np.random.default_rng(17))
    ref, got, kerns, idxs = _both(build, out, inputs)
    _close(_np(ref), _np(got), TOL[tol])
    assert (libxsmm_torch.get_kernel_info(kerns[1]).nflops
            == libxsmm_tpu.get_kernel_info(kerns[0]).nflops)
    RE.meqn_destroy(idxs[0])
    PE.meqn_destroy(idxs[1])


def test_out_dtype_matches_reference():
    ref, got, _, _ = _both(*VALUE_CASES["split_sgd_bf16"][:2],
                           VALUE_CASES["split_sgd_bf16"][2](
                               np.random.default_rng(1)))
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16


TRANS_OPS = ("MATMUL_B_TRANS", "MATMUL_A_TRANS", "MATMUL_A_TRANS_B_TRANS",
             "BRGEMM_B_TRANS", "BRGEMM_A_TRANS", "BRGEMM_A_TRANS_B_TRANS")


@pytest.mark.parametrize("op", TRANS_OPS)
def test_trans_variants(op):
    rng = np.random.default_rng(5)
    br, m, k, n = 3, 12, 8, 16
    batch = (br,) if op.startswith("BRGEMM") else ()
    a, b = _r(rng, *batch, m, k), _r(rng, *batch, k, n)
    if "A_TRANS" in op:
        a = np.ascontiguousarray(np.swapaxes(a, -1, -2))
    if "B_TRANS" in op:
        b = np.ascontiguousarray(np.swapaxes(b, -1, -2))

    def build(ns, i):
        ns.E.meqn_push_back_binary_op(i, getattr(ns.B, op))
        ns.E.meqn_push_back_arg(i, *a.shape[-2:], in_pos=0)
        ns.E.meqn_push_back_arg(i, *b.shape[-2:], in_pos=1)

    ref, got, kerns, _ = _both(build, (m, n, "F32"), [a, b])
    _close(_np(ref), _np(got), TOL["f32"])
    assert (libxsmm_torch.get_kernel_info(kerns[1]).nflops
            == libxsmm_tpu.get_kernel_info(kerns[0]).nflops)


def test_matmul_a_vnni():
    from libxsmm_tpu.ops.eltwise import _norm_to_vnni
    rng = np.random.default_rng(6)
    m, k, n = 8, 6, 16
    a_bf16 = np.asarray(jnp.asarray(_r(rng, m, k), jnp.bfloat16))
    a_vnni = np.asarray(_norm_to_vnni(jnp.asarray(a_bf16), 2, pad=False))
    b = _r(rng, k, n)

    def build(ns, i):
        ns.E.meqn_push_back_binary_op(i, ns.B.MATMUL_A_VNNI)
        ns.E.meqn_push_back_arg(i, m // 2, k * 2, in_pos=0,
                                dtype=ns.DT.BF16)
        ns.E.meqn_push_back_arg(i, k, n, in_pos=1)

    ref, got, _, _ = _both(build, (m, n, "F32"), [a_vnni, b])
    _close(_np(ref), _np(got), TOL["f32"])


def test_f64_tree_runs_f64():
    rng = np.random.default_rng(7)
    m, n = 24, 48
    x = rng.standard_normal((m, n)) * 1e6
    mean = x.mean(axis=1, keepdims=True)
    rstd = 1.0 / np.sqrt(x.var(axis=1, keepdims=True) + 1e-12)

    def build(ns, i):
        F64 = ns.DT.F64
        ns.E.meqn_push_back_binary_op(i, ns.B.MUL, dtype=F64)
        ns.E.meqn_push_back_binary_op(i, ns.B.SUB, dtype=F64)
        ns.E.meqn_push_back_arg(i, m, n, in_pos=0, dtype=F64)
        ns.E.meqn_push_back_arg(i, m, 1, in_pos=1, dtype=F64)
        ns.E.meqn_push_back_arg(i, m, 1, in_pos=2, dtype=F64)

    ref, got, _, _ = _both(build, (m, n, "F64"), [x, mean, rstd])
    assert got.dtype == torch.float64
    _close(_np(ref), _np(got), TOL["f64"])
    _close((x - mean) * rstd, _np(got), TOL["f64"])


def test_mixed_bf16_f32_tree():
    rng = np.random.default_rng(8)
    m, n = 16, 32
    a, b, c = _r(rng, m, n), _r(rng, m, n), _r(rng, m, n)

    def build(ns, i):
        ns.E.meqn_push_back_binary_op(i, ns.B.ADD, dtype=ns.DT.F32)
        ns.E.meqn_push_back_binary_op(i, ns.B.MUL, dtype=ns.DT.BF16)
        ns.E.meqn_push_back_arg(i, m, n, in_pos=0, dtype=ns.DT.BF16)
        ns.E.meqn_push_back_arg(i, m, n, in_pos=1, dtype=ns.DT.BF16)
        ns.E.meqn_push_back_arg(i, m, n, in_pos=2, dtype=ns.DT.F32)

    ref, got, _, _ = _both(build, (m, n, "F32"), [a, b, c])
    _close(_np(ref), _np(got), TOL["bf16"])
    # the bf16 node reads its inputs at bf16 storage precision: the
    # result is not the all-f32 evaluation
    assert not np.allclose(_np(got), a * b + c, rtol=1e-6, atol=0)
    abf = _np(_t(np.asarray(jnp.asarray(a, jnp.bfloat16))))
    bbf = _np(_t(np.asarray(jnp.asarray(b, jnp.bfloat16))))
    want = abf * bbf + c
    assert np.abs(_np(got) - want).max() <= 2.0 ** -8 * np.abs(want).max()


def test_shared_subtree_memoized(monkeypatch):
    """ADD(MUL(x, x), MUL(x, x)): the second MUL is the first's, so one call
    computes two binary nodes through the port's own apply_binary_op."""
    m, n = 8, 8
    calls = []
    real = PE.apply_binary_op

    def counting(op, *a, **kw):
        calls.append(op.name)
        return real(op, *a, **kw)

    monkeypatch.setattr(PE, "apply_binary_op", counting)

    def build(ns, i):
        ns.E.meqn_push_back_binary_op(i, ns.B.ADD)
        for _ in range(2):
            ns.E.meqn_push_back_binary_op(i, ns.B.MUL)
            ns.E.meqn_push_back_arg(i, m, n, in_pos=0)
            ns.E.meqn_push_back_arg(i, m, n, in_pos=0)

    x = _r(np.random.default_rng(9), m, n)
    ref, got, _, _ = _both(build, (m, n, "F32"), [x])
    _close(_np(ref), _np(got), TOL["f32"])
    assert calls == ["MUL", "ADD"], calls


def test_nflops_accounting():
    m, k, n = 8, 6, 16

    def build(ns, i):
        ns.E.meqn_push_back_unary_op(i, ns.U.RELU)
        ns.E.meqn_push_back_binary_op(i, ns.B.MATMUL)
        ns.E.meqn_push_back_arg(i, m, k, in_pos=0)
        ns.E.meqn_push_back_arg(i, k, n, in_pos=1)

    rng = np.random.default_rng(10)
    ref, got, kerns, _ = _both(build, (m, n, "F32"),
                               [_r(rng, m, k), _r(rng, k, n)])
    _close(_np(ref), _np(got), TOL["f32"])
    nf = libxsmm_torch.get_kernel_info(kerns[1]).nflops
    assert nf == libxsmm_tpu.get_kernel_info(kerns[0]).nflops
    assert nf == 2 * m * n * k + m * n


@pytest.mark.parametrize("flavor", ["cols_reduced", "rows"])
def test_gather_node(flavor):
    rng = np.random.default_rng(3)
    m, n = 16, 64
    x = _r(rng, m, n)
    if flavor == "cols_reduced":
        ids = rng.choice(n, 10, replace=False).astype(np.int32)

        def build(ns, i):
            ns.E.meqn_push_back_unary_op(i, ns.U.REDUCE_X_OP_ADD,
                                         flags=ns.UF.REDUCE_COLS)
            ns.E.meqn_push_back_unary_op(i, ns.U.GATHER,
                                         flags=ns.UF.GS_COLS, op_arg_pos=1)
            ns.E.meqn_push_back_arg(i, m, n, in_pos=0)
        out = (1, 10, "F32")
    else:
        ids = np.asarray([3, 1, 7], np.int32)

        def build(ns, i):
            ns.E.meqn_push_back_unary_op(i, ns.U.GATHER,
                                         flags=ns.UF.GS_ROWS, op_arg_pos=1)
            ns.E.meqn_push_back_arg(i, m, n, in_pos=0)
        out = (3, n, "F32")
    ref, got, kerns, _ = _both(build, out, [x, ids])
    _close(_np(ref), _np(got), TOL["f32"])
    assert (libxsmm_torch.get_kernel_info(kerns[1]).nflops
            == libxsmm_tpu.get_kernel_info(kerns[0]).nflops)


def test_gather_needs_op_arg_pos():
    for ns in (REF, PORT):
        with pytest.raises(ValueError):
            ns.E.meqn_push_back_unary_op(ns.E.meqn_create(), ns.U.GATHER)


# jnp.take's "fill" mode: -1 and -4 count from the end of 4 rows, 5 and -5
# lie outside and fill (NaN for floats, the type's extreme for integers)
FILL_IDS = np.asarray([0, -1, 5, -4, -5, 2], np.int32)


@pytest.mark.parametrize("dtype,axis", [
    ("F32", 0), ("F32", 1), ("BF16", 0), ("F64", 1), ("I32", 0),
    ("U16", 0)])
def test_gather_fill_and_wrap(dtype, axis):
    m, n = 4, 4
    x = np.arange(m * n, dtype=np.float32).reshape(m, n) + 1

    def build(ns, i):
        dt = getattr(ns.DT, dtype)
        flags = ns.UF.GS_COLS if axis else ns.UF.GS_ROWS
        ns.E.meqn_push_back_unary_op(i, ns.U.GATHER, dtype=dt,
                                     flags=flags, op_arg_pos=1)
        ns.E.meqn_push_back_arg(i, m, n, in_pos=0, dtype=dt)

    out = (m, len(FILL_IDS)) if axis else (len(FILL_IDS), n)
    ref, got, _, _ = _both(build, (*out, dtype), [x, FILL_IDS])
    np.testing.assert_array_equal(_np(got), _np(ref))


@pytest.mark.parametrize("op", ["ADD", "MAX", "MIN"])
@pytest.mark.parametrize("ids", [[0, 5, 9, 2], [0, -1, 3], [1, 16, -17]],
                         ids=["in_range", "wrapped", "filled"])
def test_reduce_cols_idx_node(op, ids):
    rng = np.random.default_rng(4)
    m, n = 16, 32
    x = _r(rng, m, n)
    ids = np.asarray(ids, np.int32)

    def build(ns, i):
        ns.E.meqn_push_back_unary_op(
            i, getattr(ns.U, f"REDUCE_COLS_IDX_OP_{op}"), op_arg_pos=1)
        ns.E.meqn_push_back_arg(i, m, n, in_pos=0)

    ref, got, kerns, _ = _both(build, (1, n, "F32"), [x, ids])
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-5, atol=1e-5)
    assert np.isnan(_np(got)).all() == (ids[-1] == -17)
    assert (libxsmm_torch.get_kernel_info(kerns[1]).nflops
            == libxsmm_tpu.get_kernel_info(kerns[0]).nflops)


def _split_sgd(ns, i, m=16, n=32):
    ns.E.meqn_push_back_unary_op(i, ns.U.UNZIP)
    ns.E.meqn_push_back_ternary_op(i, ns.T.NMULADD,
                                   flags=ns.TF.BCAST_SCALAR_IN_0)
    ns.E.meqn_push_back_arg(i, 1, 1, in_pos=0)
    ns.E.meqn_push_back_arg(i, m, n, in_pos=1)
    ns.E.meqn_push_back_binary_op(i, ns.B.ZIP)
    ns.E.meqn_push_back_arg(i, m, n, in_pos=2, dtype=ns.DT.U16)
    ns.E.meqn_push_back_arg(i, m, n, in_pos=3, dtype=ns.DT.U16)


@pytest.mark.parametrize("out_type", ["U16", "I16"])
def test_zip_unzip_split_sgd_bit_for_bit(out_type):
    rng = np.random.default_rng(12)
    m, n = 16, 32
    w, g = _r(rng, m, n) * 100, _r(rng, m, n)
    lr = np.asarray([[0.01]], np.float32)
    bits = w.view(np.uint32)
    lo = (bits & 0xFFFF).astype(np.uint16)
    hi = (bits >> 16).astype(np.uint16)
    ref, got, _, _ = _both(_split_sgd, (m, n, out_type), [lr, g, lo, hi])
    for r_, g_ in zip(ref, got):
        assert g_.dtype == getattr(torch, "uint16" if out_type == "U16"
                                   else "int16")
        np.testing.assert_array_equal(g_.numpy(), np.asarray(r_))
    if out_type == "U16":
        wnew = ((got[1].numpy().astype(np.uint32) << 16)
                | got[0].numpy().astype(np.uint32)).view(np.float32)
        np.testing.assert_allclose(wnew, w - 0.01 * g, rtol=1e-6)


def test_unzip_root_only():
    m, n = 8, 16
    for ns in (REF, PORT):
        idx = ns.E.meqn_create()
        ns.E.meqn_push_back_unary_op(idx, ns.U.X2)
        ns.E.meqn_push_back_unary_op(idx, ns.U.UNZIP)
        ns.E.meqn_push_back_arg(idx, m, n, in_pos=0)
        kern = ns.E.dispatch_meqn(idx, m, n)
        x = _r(np.random.default_rng(1), m, n)
        with pytest.raises(ValueError, match="root-only"):
            kern(x if ns is REF else _t(x))


def test_unzip_out_type_validated():
    m, n = 8, 16
    x = _r(np.random.default_rng(2), m, n)
    for ns in (REF, PORT):
        idx = ns.E.meqn_create()
        ns.E.meqn_push_back_unary_op(idx, ns.U.UNZIP)
        ns.E.meqn_push_back_arg(idx, m, n, in_pos=0)
        with pytest.raises(ValueError, match="16-bit"):
            ns.E.dispatch_meqn(idx, m, n)
    ref, got, _, _ = _both(
        lambda ns, i: (ns.E.meqn_push_back_unary_op(i, ns.U.UNZIP),
                       ns.E.meqn_push_back_arg(i, m, n, in_pos=0)),
        (m, n, "U16"), [x])
    bits = x.view(np.uint32)
    np.testing.assert_array_equal(got[0].numpy(),
                                  (bits & 0xFFFF).astype(np.uint16))
    np.testing.assert_array_equal(got[1].numpy(),
                                  (bits >> 16).astype(np.uint16))
    for r_, g_ in zip(ref, got):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(r_))


def test_zip_value_converts_float_halves():
    """ZIP of f32-typed halves converts them by value to u32, as the
    reference's astype(uint32) does (truncation, saturation at 0)."""
    m, n = 2, 3
    lo = np.asarray([[1.7, 0.0, 65535.0], [-3.0, 7.2, 12.0]], np.float32)
    hi = np.asarray([[16256.0, 0.0, 1.0], [2.0, -1.0, 16384.0]], np.float32)

    def build(ns, i):
        ns.E.meqn_push_back_binary_op(i, ns.B.ZIP)
        ns.E.meqn_push_back_arg(i, m, n, in_pos=0)
        ns.E.meqn_push_back_arg(i, m, n, in_pos=1)

    ref, got, _, _ = _both(build, (m, n, "F32"), [lo, hi])
    np.testing.assert_array_equal(_np(got).view(np.uint32),
                                  np.asarray(ref).view(np.uint32))


def test_incomplete_and_overcomplete_raise():
    for ns in (REF, PORT):
        idx = ns.E.meqn_create()
        ns.E.meqn_push_back_binary_op(idx, ns.B.ADD)
        ns.E.meqn_push_back_arg(idx, 4, 4, in_pos=0)
        with pytest.raises(ValueError):
            ns.E.dispatch_meqn(idx, 4, 4)
        idx2 = ns.E.meqn_create()
        ns.E.meqn_push_back_arg(idx2, 4, 4, in_pos=0)
        with pytest.raises(ValueError):
            ns.E.meqn_push_back_arg(idx2, 4, 4, in_pos=1)


def test_cache_and_print():
    m, n = 4, 4

    def build(ns, i):
        ns.E.meqn_push_back_binary_op(i, ns.B.ADD)
        ns.E.meqn_push_back_arg(i, m, n, in_pos=0)
        ns.E.meqn_push_back_arg(i, m, n, in_pos=1)

    kerns = []
    for _ in range(2):
        idx = PE.meqn_create()
        build(PORT, idx)
        s = PE.meqn_tree_print(idx)
        assert "BINARY ADD" in s and "ARG[0]" in s
        kerns.append(PE.dispatch_meqn(idx, m, n))
        PE.meqn_destroy(idx)
    assert kerns[0] is kerns[1]
    with pytest.raises(ValueError, match="unknown equation"):
        PE.meqn_tree_print(idx)


def test_in_pos_validation():
    for ns in (REF, PORT):
        idx = ns.E.meqn_create()
        ns.E.meqn_push_back_unary_op(idx, ns.U.X2)
        with pytest.raises(ValueError, match="in_pos"):
            ns.E.meqn_push_back_arg(idx, 8, 8, in_pos=-1)
        with pytest.raises(ValueError, match="in_pos"):
            ns.E.meqn_push_back_arg(idx, 8, 8)
        ns.E.meqn_push_back_arg(idx, 8, 8, in_pos=0)
        ns.E.dispatch_meqn(idx, 8, 8)
        ns.E.meqn_destroy(idx)


def _set_brgemm(ns, i, br=4, m=8, k=6, n=10):
    attr = ns.E.create_matrix_arg_attributes(arg_type=1, set_type=3,
                                             set_cardinality_hint=br)
    ns.E.meqn_push_back_binary_op(i, ns.B.BRGEMM)
    ns.E.meqn_push_back_arg(ns.E.create_meqn_arg_metadata(i, 0),
                            ns.E.create_meqn_arg_shape(m, k, 0), attr)
    ns.E.meqn_push_back_arg(ns.E.create_meqn_arg_metadata(i, 1),
                            ns.E.create_meqn_arg_shape(k, n, 0), attr)


def test_set_args_brgemm():
    rng = np.random.default_rng(13)
    a, b = _r(rng, 4, 8, 6), _r(rng, 4, 6, 10)
    ref, got, kerns, _ = _both(_set_brgemm, (8, 10, "F32"), [a, b])
    _close(_np(ref), _np(got), TOL["f32"])
    with pytest.raises(ValueError, match="cardinality"):
        kerns[1](_t(a[:2]), _t(b))
    with pytest.raises(ValueError):
        PE.meqn_push_back_arg(
            PE.create_meqn_arg_metadata(PE.meqn_create(), 0),
            PE.create_meqn_arg_shape(8, 6, 0),
            PE.create_matrix_arg_attributes(arg_type=1, set_type=9))


def test_set_args_nflops_cardinality():
    idx = PE.meqn_create()
    _set_brgemm(PORT, idx)
    kern = PE.dispatch_meqn(idx, 8, 10)
    assert libxsmm_torch.get_kernel_info(kern).nflops == 2 * 8 * 10 * 6 * 4
    PE.meqn_destroy(idx)


def test_nflops_gather_refined():
    m, n, ncols = 16, 64, 8
    rng = np.random.default_rng(7)
    x, y = _r(rng, m, n), _r(rng, m, ncols)
    cols = rng.choice(n, ncols, replace=False).astype(np.int32)

    def build(ns, i):
        ns.E.meqn_push_back_unary_op(i, ns.U.REDUCE_X_OP_ADD,
                                     flags=ns.UF.REDUCE_COLS)
        ns.E.meqn_push_back_binary_op(i, ns.B.MUL)
        ns.E.meqn_push_back_unary_op(i, ns.U.GATHER, flags=ns.UF.GS_COLS,
                                     op_arg_pos=2)
        ns.E.meqn_push_back_arg(i, m, n, in_pos=0)
        ns.E.meqn_push_back_arg(i, m, ncols, in_pos=1)

    ref, got, kerns, _ = _both(build, (1, ncols, "F32"), [x, y, cols])
    _close(_np(ref), _np(got), TOL["f32"])
    nf = libxsmm_torch.get_kernel_info(kerns[1]).nflops
    assert nf == libxsmm_tpu.get_kernel_info(kerns[0]).nflops == 3 * m * ncols


def test_nflops_gather_rechecked_per_call():
    m, n = 16, 64
    x = _r(np.random.default_rng(14), m, n)

    def build(ns, i):
        ns.E.meqn_push_back_unary_op(i, ns.U.REDUCE_COLS_IDX_OP_ADD,
                                     op_arg_pos=1)
        ns.E.meqn_push_back_arg(i, m, n, in_pos=0)

    kerns = []
    for ns in (REF, PORT):
        idx = ns.E.meqn_create()
        build(ns, idx)
        kerns.append(ns.E.dispatch_meqn(idx, 1, n))
    for rows in (4, 12, 4):
        ridx = np.arange(rows, dtype=np.int32)
        want = np.asarray(kerns[0](x, ridx))
        got = kerns[1](_t(x), _t(ridx))
        _close(want, _np(got), TOL["f32"])
        nf = libxsmm_torch.get_kernel_info(kerns[1]).nflops
        assert nf == libxsmm_tpu.get_kernel_info(kerns[0]).nflops == rows * n


def test_meltw_shape_form_flags_honored():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    cols = np.asarray([2, 0], np.int32)
    outs = []
    for ns, d in ((REF, RD), (PORT, PD)):
        k = ns.pkg.dispatch_meltw_unary(ns.U.GATHER,
                                        d.create_meltw_unary_shape(3, 4),
                                        ns.UF.GS_COLS)
        kb = ns.pkg.dispatch_meltw_binary(ns.B.MUL,
                                          d.create_meltw_binary_shape(3, 4),
                                          ns.BF.BCAST_COL_IN_1)
        row = np.asarray([[1., 2., 3., 4.]], np.float32)
        if ns is REF:
            outs.append((np.asarray(k(x, cols)), np.asarray(kb(x, row))))
        else:
            outs.append((_np(k(_t(x), cols)), _np(kb(_t(x), row))))
    for r_, g_ in zip(*outs):
        np.testing.assert_array_equal(g_, r_)
    assert outs[1][0].shape == (3, 2)


def test_dispatch_meqn_desc_and_shape_form():
    rng = np.random.default_rng(15)
    a, b = _r(rng, 8, 12), _r(rng, 8, 12)
    idx = PE.meqn_create()
    PE.meqn_push_back_binary_op(PE.create_meqn_op_metadata(idx),
                                PD.BinaryType.ADD)
    PE.meqn_push_back_arg(idx, 8, 12, in_pos=0)
    PE.meqn_push_back_arg(idx, 8, 12, in_pos=1)
    k1 = PE.dispatch_meqn_desc(PE.MeqnDescriptor(8, 12, 12,
                                                 PDT.Datatype.F32, idx))
    k2 = PE.dispatch_meqn(idx, PE.create_meqn_arg_shape(8, 12, 12))
    assert k1 is k2
    np.testing.assert_allclose(_np(k1(_t(a), _t(b))), a + b, rtol=1e-6)
    with pytest.raises(ValueError, match="ldo"):
        PE.dispatch_meqn_desc(PE.MeqnDescriptor(8, 12, 16,
                                                PDT.Datatype.F32, idx))


def test_arguments_load_as_the_kernels_do(monkeypatch):
    """numpy arguments load onto the default device (the GPU: without one
    they raise); tensors stay where they are; arguments on two devices
    raise."""
    idx = PE.meqn_create()
    _simple(PORT, idx, 2, 3)
    kern = PE.dispatch_meqn(idx, 2, 3)
    x = np.ones((2, 3), np.float32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            kern(x, x, x)
    with pytest.raises(ValueError, match="different devices"):
        kern(_t(x), _t(x), torch.ones((2, 3), device="meta"))
    monkeypatch.setattr(PDEV, "default_device", lambda: torch.device("cpu"))
    got = kern(x, _t(x), x)
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), (x + x) * x)
