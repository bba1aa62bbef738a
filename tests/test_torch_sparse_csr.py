"""The CSR/CSC packed SpGEMM routings and the values-baked CSR kernel: the
port (`libxsmm_torch.ops.sparse`) against the JAX package on the same numpy
inputs, on the CPU (device="cpu"), over the shapes and strategies of
tests/test_sparse.py:67-131 and :510-597: packed widths, beta = 1, empty
patterns, the routing by `sparse_operand` and its refusals.

Tolerances (matdiff normf_rel): 1e-5 for f32 in and out (the sums run in
another order); 1e-4 for bf16 in / f32 out (bf16 products are exact in f32,
the order of the sum differs); 1e-12 for f64; empty patterns exactly zero.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import libxsmm_torch as xp
from libxsmm_torch.matdiff import check
from libxsmm_tpu.descriptor import GemmFlags, GemmShape
from libxsmm_tpu.dtypes import Datatype
from libxsmm_tpu.ops import sparse as ro

torch.set_num_threads(1)

F32, BF16, F64 = Datatype.F32, Datatype.BF16, Datatype.F64
B0 = GemmFlags.BETA_0
TOL = {F32: 1e-5, BF16: 1e-4, F64: 1e-12}
SHAPES = [(16, 24, 12, 0.3), (13, 5, 7, 0.5), (8, 128, 32, 0.1)]


def pshape(shape):
    return xp.GemmShape(shape.m, shape.n, shape.k,
                        xp.Datatype[shape.a_in_type.name],
                        xp.Datatype[shape.b_in_type.name],
                        xp.Datatype[shape.out_type.name],
                        xp.Datatype[shape.comp_type.name])


def pflags(flags):
    return xp.GemmFlags(int(flags))


def sparse_dense(rng, m, k, density):
    a = rng.standard_normal((m, k)).astype(np.float32)
    a[rng.random((m, k)) >= density] = 0.0
    return a


def pair(x, dt=F32):
    """(reference operand, CPU tensor) with identical values of dt."""
    if dt == BF16:
        xj = jnp.asarray(x, jnp.bfloat16)
        return xj, torch.from_numpy(np.asarray(xj, np.float32)).bfloat16()
    x = np.ascontiguousarray(np.asarray(x).astype(
        np.float64 if dt == F64 else np.float32))
    return x, torch.from_numpy(x.copy())


def as64(x):
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    x = jnp.asarray(x)
    return np.asarray(x if x.dtype == jnp.float64 else x.astype(jnp.float32),
                      np.float64)


def both(name, shape, flags, *args, **kw):
    """(reference kernel, port kernel) of one create entry point."""
    ref = getattr(ro, name)(shape, flags, *args, **kw)
    port = getattr(xp, name)(pshape(shape), pflags(flags), *args,
                             device="cpu", **kw)
    assert port.name == ref.name
    return ref, port


@pytest.mark.parametrize("strategy", ["sparse", "dense", "auto"])
@pytest.mark.parametrize("m,n,k,density", SHAPES)
def test_csr_a_sparse(m, n, k, density, strategy):
    rng = np.random.default_rng(m * 100 + n)
    a = sparse_dense(rng, m, k, density)
    csr = ro.CsrMatrix.from_dense(a)
    b = pair(rng.standard_normal((k, n)))
    v = pair(csr.data)
    ref, port = both("create_packed_spgemm_csr", GemmShape(m, n, k), B0, 1,
                     csr.indptr, csr.indices, strategy)
    got = port(v[1], b[1])
    assert got.dtype == torch.float32 and got.shape == (m, n)
    check(as64(ref(v[0], b[0])), as64(got), margin=TOL[F32])
    check(a.astype(np.float64) @ as64(b[0]), as64(got), margin=1e-5)
    # new values at run time, the pattern reused
    check(as64(ref(2 * v[0], b[0])), as64(port(2 * v[1], b[1])),
          margin=TOL[F32])


@pytest.mark.parametrize("strategy", ["sparse", "dense"])
@pytest.mark.parametrize("p", [1, 4, 16])
def test_csr_a_sparse_packed_width(p, strategy):
    m, n, k = 8, 6, 10
    rng = np.random.default_rng(p)
    csr = ro.CsrMatrix.from_dense(sparse_dense(rng, m, k, 0.4))
    b = pair(rng.standard_normal((k, n, p)))
    v = pair(csr.data)
    ref, port = both("create_packed_spgemm_csr", GemmShape(m, n, k), B0, p,
                     csr.indptr, csr.indices, strategy)
    got = port(v[1], b[1])
    assert got.shape == (m, n, p)
    check(as64(ref(v[0], b[0])), as64(got), margin=TOL[F32])


@pytest.mark.parametrize("strategy", ["sparse", "dense"])
@pytest.mark.parametrize("dt", [F32, BF16, F64])
def test_csr_a_sparse_beta1_types(dt, strategy):
    m, n, k = 9, 7, 11
    rng = np.random.default_rng(3)
    csr = ro.CsrMatrix.from_dense(sparse_dense(rng, m, k, 0.4))
    out = F64 if dt == F64 else F32
    shape = GemmShape(m, n, k, a_in_type=dt, b_in_type=dt, out_type=out)
    b, v = pair(rng.standard_normal((k, n)), dt), pair(csr.data, dt)
    c = pair(rng.standard_normal((m, n)), out)
    ref, port = both("create_packed_spgemm_csr", shape, GemmFlags.NONE, 1,
                     csr.indptr, csr.indices, strategy)
    got = port(v[1], b[1], c[1])
    assert got.dtype == (torch.float64 if dt == F64 else torch.float32)
    check(as64(ref(v[0], b[0], c[0])), as64(got), margin=TOL[dt])


def test_csr_empty_pattern_is_zero():
    """nnz == 0 takes the dense lowering's zero slot in both packages."""
    m, n, k = 6, 5, 4
    indptr, indices = np.zeros(m + 1, np.int32), np.zeros(0, np.int32)
    ref, port = both("create_packed_spgemm_csr", GemmShape(m, n, k), B0, 1,
                     indptr, indices, "sparse")
    b = np.random.default_rng(0).standard_normal((k, n)).astype(np.float32)
    got = port(torch.zeros(0), torch.from_numpy(b))
    assert got.shape == (m, n) and bool((got == 0).all())
    assert np.all(np.asarray(ref(np.zeros(0, np.float32), b)) == 0)


def test_csr_pattern_cache():
    csr = ro.CsrMatrix.from_dense(sparse_dense(np.random.default_rng(4), 8,
                                               8, 0.4))
    make = (lambda: xp.create_packed_spgemm_csr(
        xp.GemmShape(8, 8, 8), xp.GemmFlags.BETA_0, row_ptr=csr.indptr,
        column_idx=csr.indices, device="cpu"))
    assert make() is make()


def test_csc_b_sparse():
    m, n, k = 12, 10, 8
    rng = np.random.default_rng(5)
    bmat = sparse_dense(rng, k, n, 0.3)
    csc = ro.CscMatrix.from_dense(bmat)
    a, v = pair(rng.standard_normal((m, k))), pair(csc.data)
    ref, port = both("create_packed_spgemm_csc", GemmShape(m, n, k), B0, 1,
                     csc.indptr, csc.indices)
    got = port(a[1], v[1])
    check(as64(ref(a[0], v[0])), as64(got), margin=TOL[F32])
    check(as64(a[0]) @ bmat, as64(got), margin=1e-5)


@pytest.mark.parametrize("p", [2, 8])
def test_csc_b_sparse_packed_beta1(p):
    m, n, k = 6, 8, 10
    rng = np.random.default_rng(p)
    csc = ro.CscMatrix.from_dense(sparse_dense(rng, k, n, 0.4))
    a, v = pair(rng.standard_normal((m, k, p))), pair(csc.data)
    c = pair(rng.standard_normal((m, n, p)))
    ref, port = both("create_packed_spgemm_csc", GemmShape(m, n, k),
                     GemmFlags.NONE, p, csc.indptr, csc.indices)
    got = port(a[1], v[1], c[1])
    assert got.shape == (m, n, p)
    check(as64(ref(a[0], v[0], c[0])), as64(got), margin=TOL[F32])


def test_csc_routing_and_refusals():
    """sparse_operand routes to the SDDMM; another name, or a strategy on
    the single-lowering B-sparse routing, raises in both packages."""
    m, n, k = 9, 7, 11
    rng = np.random.default_rng(6)
    csc = ro.CscMatrix.from_dense(sparse_dense(rng, m, n, 0.35))
    a, b = pair(rng.standard_normal((m, k))), pair(rng.standard_normal((k, n)))
    ref, port = both("create_packed_spgemm_csc", GemmShape(m, n, k), B0, 1,
                     csc.indptr, csc.indices, sparse_operand="c")
    check(as64(ref(a[0], b[0])), as64(port(a[1], b[1])), margin=TOL[F32])
    for mod, kw in ((ro, {}), (xp, {"device": "cpu"})):
        shape = GemmShape(m, n, k) if mod is ro else xp.GemmShape(m, n, k)
        flags = B0 if mod is ro else xp.GemmFlags.BETA_0
        with pytest.raises(ValueError, match="sparse_operand"):
            mod.create_packed_spgemm_csc(shape, flags, 1, csc.indptr,
                                         csc.indices, sparse_operand="x",
                                         **kw)
        with pytest.raises(ValueError, match="strategy"):
            mod.create_packed_spgemm_csc(shape, flags, 1, csc.indptr,
                                         csc.indices, strategy="dense", **kw)
        with pytest.raises(ValueError, match="sparse_operand"):
            mod.create_packed_spgemm_csr(shape, flags, 1, csc.indptr,
                                         csc.indices, sparse_operand="x",
                                         **kw)


@pytest.mark.parametrize("strategy", ["sparse", "dense", "auto"])
@pytest.mark.parametrize("m,n,k,density", SHAPES[:2])
def test_csr_b_sparse(m, n, k, density, strategy):
    rng = np.random.default_rng(m + 7)
    bmat = sparse_dense(rng, k, n, density)
    csr = ro.CsrMatrix.from_dense(bmat)        # CSR over B: rows along k
    a, v = pair(rng.standard_normal((m, k))), pair(csr.data)
    ref, port = both("create_packed_spgemm_csr_bsparse", GemmShape(m, n, k),
                     B0, 1, csr.indptr, csr.indices, strategy)
    got = port(a[1], v[1])
    check(as64(ref(a[0], v[0])), as64(got), margin=TOL[F32])
    check(as64(a[0]) @ bmat, as64(got), margin=1e-5)
    check(as64(ref(a[0], 2 * v[0])), as64(port(a[1], 2 * v[1])),
          margin=TOL[F32])


@pytest.mark.parametrize("strategy", ["sparse", "dense"])
def test_csr_b_sparse_packed_beta1(strategy):
    m, n, k, p = 8, 6, 10, 4
    rng = np.random.default_rng(8)
    csr = ro.CsrMatrix.from_dense(sparse_dense(rng, k, n, 0.4))
    a, v = pair(rng.standard_normal((m, k, p))), pair(csr.data)
    c = pair(rng.standard_normal((m, n, p)))
    ref, port = both("create_packed_spgemm_csr_bsparse", GemmShape(m, n, k),
                     GemmFlags.NONE, p, csr.indptr, csr.indices, strategy)
    check(as64(ref(a[0], v[0], c[0])), as64(port(a[1], v[1], c[1])),
          margin=TOL[F32])


def test_csr_routing_by_operand():
    """create_packed_spgemm_csr(sparse_operand="b") is the B-sparse
    routing (generator_packed_spgemm.c:24-56)."""
    m, n, k = 12, 9, 10
    rng = np.random.default_rng(9)
    csr = ro.CsrMatrix.from_dense(sparse_dense(rng, k, n, 0.3))
    a, v = pair(rng.standard_normal((m, k))), pair(csr.data)
    ref, port = both("create_packed_spgemm_csr", GemmShape(m, n, k), B0, 1,
                     csr.indptr, csr.indices, sparse_operand="b")
    assert port.name.startswith("pspgemm_csr_b_")
    check(as64(ref(a[0], v[0])), as64(port(a[1], v[1])), margin=TOL[F32])


@pytest.mark.parametrize("strategy", ["gather", "dense", "auto"])
@pytest.mark.parametrize("m,n,k,density", SHAPES[:2])
def test_csc_c_sparse(m, n, k, density, strategy):
    rng = np.random.default_rng(n + 11)
    csc = ro.CscMatrix.from_dense(sparse_dense(rng, m, n, density))
    a, b = pair(rng.standard_normal((m, k))), pair(rng.standard_normal((k, n)))
    ref, port = both("create_packed_spgemm_csc_csparse", GemmShape(m, n, k),
                     B0, 1, csc.indptr, csc.indices, strategy)
    got = port(a[1], b[1])
    assert got.shape == (csc.nnz,)
    check(as64(ref(a[0], b[0])), as64(got), margin=TOL[F32])
    cols = np.repeat(np.arange(n), np.diff(csc.indptr))
    check((as64(a[0]) @ as64(b[0]))[csc.indices, cols], as64(got),
          margin=1e-5)


@pytest.mark.parametrize("strategy", ["gather", "dense"])
def test_csc_c_sparse_packed_reduces(strategy):
    """The packed dimension joins the contraction (the reference's "reduce
    C" stage); beta = 1 adds the prior values."""
    m, n, k, p = 10, 8, 6, 4
    rng = np.random.default_rng(12)
    csc = ro.CscMatrix.from_dense(sparse_dense(rng, m, n, 0.4))
    a = pair(rng.standard_normal((m, k, p)))
    b = pair(rng.standard_normal((k, n, p)))
    prior = pair(rng.standard_normal(csc.nnz))
    ref, port = both("create_packed_spgemm_csc_csparse", GemmShape(m, n, k),
                     GemmFlags.NONE, p, csc.indptr, csc.indices, strategy)
    check(as64(ref(a[0], b[0], prior[0])),
          as64(port(a[1], b[1], prior[1])), margin=TOL[F32])


@pytest.mark.parametrize("dt", [F32, BF16])
def test_areg(dt):
    m, n, k = 16, 48, 12
    rng = np.random.default_rng(13)
    a = sparse_dense(rng, m, k, 0.25)
    csr = ro.CsrMatrix.from_dense(a)
    shape = GemmShape(m, n, k, a_in_type=dt, b_in_type=dt, out_type=F32)
    b = pair(rng.standard_normal((k, n)), dt)
    ref, port = both("create_spgemm_csr_areg", shape, B0, csr.indptr,
                     csr.indices, csr.data)
    got = port(b[1])
    check(as64(ref(b[0])), as64(got), margin=TOL[dt])
    # the values are baked: other values make another kernel
    port2 = xp.create_spgemm_csr_areg(pshape(shape), xp.GemmFlags.BETA_0,
                                      csr.indptr, csr.indices, 2 * csr.data,
                                      device="cpu")
    assert port2 is not port
    check(2 * as64(got), as64(port2(b[1])), margin=TOL[dt])


def test_areg_beta1_and_cap():
    m, n, k = 9, 16, 11
    rng = np.random.default_rng(14)
    csr = ro.CsrMatrix.from_dense(sparse_dense(rng, m, k, 0.3))
    b, c = pair(rng.standard_normal((k, n))), pair(rng.standard_normal((m, n)))
    ref, port = both("create_spgemm_csr_areg", GemmShape(m, n, k),
                     GemmFlags.NONE, csr.indptr, csr.indices, csr.data)
    check(as64(ref(b[0], c[0])), as64(port(b[1], c[1])), margin=TOL[F32])
    full = ro.CsrMatrix.from_dense(np.ones((300, 300), np.float32))
    for make in (lambda: ro.create_spgemm_csr_areg(
                     GemmShape(300, 8, 300), B0, full.indptr, full.indices,
                     full.data),
                 lambda: xp.create_spgemm_csr_areg(
                     xp.GemmShape(300, 8, 300), xp.GemmFlags.BETA_0,
                     full.indptr, full.indices, full.data, device="cpu")):
        with pytest.raises(ValueError, match="cap"):
            make()


def test_areg_empty_pattern_and_edge_matrix():
    """An empty pattern bakes zeros; the EDGE-class flux matrix (few
    unique values) through the baked kernel, both packages."""
    from libxsmm_torch.utils.testmats import edge_fluxmatrix
    from libxsmm_tpu.utils import testmats as rt
    m, n, k = 5, 8, 6
    ref, port = both("create_spgemm_csr_areg", GemmShape(m, n, k), B0,
                     np.zeros(m + 1, np.int32), np.zeros(0, np.int32),
                     np.zeros(0, np.float32))
    b = pair(np.random.default_rng(15).standard_normal((k, n)))
    assert bool((port(b[1]) == 0).all()) and np.all(np.asarray(ref(b[0])) == 0)
    a = edge_fluxmatrix(20, 35, seed=3)
    np.testing.assert_array_equal(a, rt.edge_fluxmatrix(20, 35, seed=3))
    csr = ro.CsrMatrix.from_dense(a)
    ref, port = both("create_spgemm_csr_areg", GemmShape(20, 64, 35), B0,
                     csr.indptr, csr.indices, csr.data)
    b = pair(np.random.default_rng(16).standard_normal((35, 64)))
    check(as64(ref(b[0])), as64(port(b[1])), margin=TOL[F32])


def test_default_device_is_the_card():
    """A create that names no device plans on the GPU and raises without
    one."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    csr = ro.CsrMatrix.from_dense(np.eye(4, dtype=np.float32))
    for name in ("create_packed_spgemm_csr", "create_packed_spgemm_csc",
                 "create_packed_spgemm_csr_bsparse",
                 "create_packed_spgemm_csc_csparse"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(xp, name)(xp.GemmShape(4, 4, 4), xp.GemmFlags.BETA_0, 1,
                              csr.indptr, csr.indices)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xp.create_spgemm_csr_areg(xp.GemmShape(4, 4, 4), xp.GemmFlags.BETA_0,
                                  csr.indptr, csr.indices, csr.data)
