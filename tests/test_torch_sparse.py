"""The block-sparse (BCSC) SpGEMM path: the port (`libxsmm_torch.ops.sparse`,
`libxsmm_torch.kernels.spmm`) against the JAX package on the same numpy
inputs, on the CPU. The JAX side runs as its own tests run it (its Pallas
kernels in interpret mode); the port runs the plain torch version of each
CUDA kernel (device="cpu").

Every strategy name goes through both packages. Where the reference refuses
a descriptor for a Mosaic limit that the port does not copy (the sublane
alignment of "pallas", union5's 128-row tile), the port's result is held
against float64 and against the reference's result of the same lowering
family; a refusal that is semantic (blocking, the 128-column groups of the
union kernel, the supertile's 128 | (k, n), f64/i8 on the SpMM kernels) must
be the port's too.

Tolerances (matdiff normf_rel): 1e-5 for f32 in and out (sums in another
order); 1e-4 for bf16 in / f32 out (products exact in f32, the order of the
sum differs); 1e-2 for bf16 outputs (one rounding to bf16, at another point
of the sum on the kernel and torch routes); integers and the densified
values exact; empty block columns and empty patterns exactly zero.
"""

import functools
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import libxsmm_torch as xp
from libxsmm_torch.kernels import spmm as pk
from libxsmm_torch.matdiff import check
from libxsmm_torch.ops import sparse as po
from libxsmm_tpu.descriptor import GemmFlags, GemmShape, SpgemmConfig
from libxsmm_tpu.dtypes import Datatype
from libxsmm_tpu.kernels import spmm_pallas as rk
from libxsmm_tpu.ops import sparse as ro

torch.set_num_threads(1)

F32, BF16, I8, I32, F64 = (Datatype.F32, Datatype.BF16, Datatype.I8,
                           Datatype.I32, Datatype.F64)
JNP = {F32: jnp.float32, BF16: jnp.bfloat16}
TORCH = {F32: torch.float32, BF16: torch.bfloat16}
NAMES = ("auto",) + po.STRATEGIES
FAMILY = {s: "union" for s in po.STRATEGIES if s.startswith("union")}

# name -> (m, k, n, bk, bn, in type, out type, block density); the shapes of
# tests/test_sparse.py's BCSC tests
CASES = {
    "32x32x64_b4x4": (32, 32, 64, 4, 4, F32, F32, 0.2),
    "32x32x64_b8x16": (32, 32, 64, 8, 16, F32, F32, 0.2),
    "64x128x128_bf16out": (64, 128, 128, 32, 32, BF16, BF16, 0.3),
    "64x128x128_bf16in": (64, 128, 128, 32, 32, BF16, F32, 0.3),
    "32x256x384_3groups": (32, 256, 384, 32, 32, F32, F32, 0.25),
}


def tol(a_dt, o_dt):
    if o_dt == BF16:
        return 1e-2
    return 1e-5 if a_dt == F32 else 1e-4


def pshape(shape):
    """The port's copy of a reference GemmShape."""
    return xp.GemmShape(shape.m, shape.n, shape.k,
                        xp.Datatype[shape.a_in_type.name],
                        xp.Datatype[shape.b_in_type.name],
                        xp.Datatype[shape.out_type.name],
                        xp.Datatype[shape.comp_type.name])


def pconfig(config):
    return xp.SpgemmConfig(config.packed_width, config.bk, config.bn)


def pair(x, dt):
    """(reference operand, CPU tensor) with identical values of dt."""
    if dt in (F32, F64, I8, I32):
        x = np.ascontiguousarray(np.asarray(x).astype(
            {F32: np.float32, F64: np.float64, I8: np.int8,
             I32: np.int32}[dt]))
        return x, torch.from_numpy(x.copy())
    xj = jnp.asarray(x, JNP[dt])
    return xj, torch.from_numpy(np.asarray(xj, np.float32)).to(TORCH[dt])


def as64(x):
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def block_pattern(rng, k, n, bk, bn, density):
    """A random (k, n) matrix whose zero (bk, bn) blocks are dropped."""
    keep = rng.random((k // bk, n // bn)) < density
    b = rng.standard_normal((k, n)) * np.kron(keep, np.ones((bk, bn)))
    return ro.BcscMatrix.from_dense(b.astype(np.float32), bk, bn)


@functools.lru_cache(maxsize=None)
def case_data(name):
    m, k, n, bk, bn, a_dt, o_dt, density = CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    bm = block_pattern(rng, k, n, bk, bn, density)
    shape = GemmShape(m, n, k, a_in_type=a_dt, b_in_type=a_dt, out_type=o_dt)
    a = pair(rng.standard_normal((m, k)), a_dt)
    v = pair(bm.data, a_dt)
    c = pair(rng.standard_normal((m, n)), F32)
    want = as64(a[0]) @ ro.BcscMatrix(bm.shape, bk, bn, bm.indptr,
                                      bm.indices, as64(v[0])).to_dense()
    return shape, SpgemmConfig(1, bk, bn), bm, a, v, c, want


def ref_create(shape, config, bm, strategy):
    """The reference's kernel, or None where it refuses the descriptor."""
    try:
        return ro.create_packed_spgemm_bcsc(
            shape, GemmFlags.BETA_0, config, column_ptr=bm.indptr,
            row_idx=bm.indices, strategy=strategy)
    except ValueError:
        return None


def port_create(shape, config, bm, strategy):
    try:
        return xp.create_packed_spgemm_bcsc(
            pshape(shape), xp.GemmFlags.BETA_0, pconfig(config),
            column_ptr=bm.indptr, row_idx=bm.indices, strategy=strategy,
            device="cpu")
    except ValueError:
        return None


@functools.lru_cache(maxsize=None)
def ref_output(name, family, with_c=False):
    """The reference's result on a case for one lowering family (union
    stands for every union name), or None where it refuses."""
    shape, config, bm, a, v, c, _ = case_data(name)
    kern = ref_create(shape, config, bm, family)
    if kern is None:
        return None
    return as64(kern(a[0], v[0], c[0]) if with_c else kern(a[0], v[0]))


def strategy_of(kernel_name):
    """The resolved strategy in a kernel name (pspgemm_bcsc_MxNxK_<s>...)."""
    tail = kernel_name.split("_")[3]
    return "super" if tail.startswith("super") else tail


@pytest.mark.parametrize("strategy", NAMES)
@pytest.mark.parametrize("case", list(CASES))
def test_strategy_parity(case, strategy):
    """Every strategy name: the same refusals, the same kernel name (the
    resolved auto pick, the union depth U, the supertile count), and the
    same result within the case's tolerance."""
    shape, config, bm, a, v, _, want = case_data(case)
    ref = ref_create(shape, config, bm, strategy)
    port = port_create(shape, config, bm, strategy)
    mosaic_only = ((strategy == "pallas" and config.bk % 8)
                   or strategy == "union5")
    if port is None:
        assert ref is None, f"the port refuses {strategy}, the reference not"
        return
    if ref is not None:
        assert port.name == ref.name
    else:
        assert mosaic_only, f"the reference refuses {strategy}, the port not"
    got = port(a[1], v[1])
    assert got.dtype == TORCH[shape.out_type]
    assert tuple(got.shape) == (shape.m, shape.n)
    t = tol(shape.a_in_type, shape.out_type)
    check(want, as64(got), margin=t)
    resolved = strategy_of(port.name)
    ref_out = ref_output(case, FAMILY.get(resolved, resolved))
    if ref_out is not None:
        check(ref_out, as64(got), margin=t)


@pytest.mark.parametrize("strategy", ["dense", "sparse", "pallas", "union",
                                      "super"])
@pytest.mark.parametrize("case", ["64x128x128_bf16out",
                                  "32x256x384_3groups"])
def test_beta1_with_c(case, strategy):
    """beta=1: the kernel routes round to the output type, then add c in
    it; "dense" and "sparse" add c in f32, then round."""
    shape, config, bm, a, v, c, want = case_data(case)
    port = port_create(shape, config, bm, strategy)
    got = port(a[1], v[1], c[1])
    t = tol(shape.a_in_type, shape.out_type)
    check(want + as64(c[0]), as64(got), margin=t)
    check(ref_output(case, strategy, True), as64(got), margin=t)


def test_super_beta1_matches_reference():
    """tests/test_sparse.py:468-490: 64x256x256, 15% of the 32x32 blocks."""
    rng = np.random.default_rng(9)
    m, k, n, bk, bn = 64, 256, 256, 32, 32
    bmat = rng.standard_normal((k, n)).astype(np.float32)
    keep = rng.random((k // bk, n // bn)) < 0.15
    bmat *= np.kron(keep, np.ones((bk, bn), np.float32))
    bm = ro.BcscMatrix.from_dense(bmat, bk, bn)
    shape, config = GemmShape(m, n, k), SpgemmConfig(1, bk, bn)
    ref = ref_create(shape, config, bm, "super")
    port = port_create(shape, config, bm, "super")
    assert port.name == ref.name and "_super" in port.name
    a = rng.standard_normal((m, k)).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)
    for args in ((a, bm.data), (a, bm.data, c)):
        want = np.asarray(ref(*args), np.float64)
        got = port(*(torch.from_numpy(x) for x in args))
        check(want, as64(got), margin=1e-5)
    check(a.astype(np.float64) @ bmat + c, as64(port(a, bm.data, c)),
          margin=1e-5)


def cluster_pattern():
    """tests/test_sparse.py:706-772: 64x256x1024, bk = bn = 32, two
    interleaved families of 16 block rows, 10 blocks per column."""
    bk = bn = 32
    m, n, k = 64, 256, 1024
    nb = n // bn
    rng = np.random.default_rng(11)
    fam_a, fam_b = np.arange(0, 16), np.arange(16, 32)
    cols = [np.sort(rng.choice(fam_a if j % 2 == 0 else fam_b, 10,
                               replace=False)) for j in range(nb)]
    indptr = np.arange(0, 10 * nb + 1, 10, dtype=np.int32)
    indices = np.concatenate(cols).astype(np.int32)
    values = rng.standard_normal((len(indices), bk, bn)).astype(np.float32)
    a = rng.standard_normal((m, k)).astype(np.float32)
    return (m, n, k, bk, bn), indptr, indices, values, a


def test_cluster_permutation_matches_reference():
    _, indptr, indices, _, _ = cluster_pattern()
    for gain in (1, 8, 11, 12, 16):
        want = rk._cluster_union_groups(indptr, indices, 4, min_gain=gain)
        got = pk._cluster_union_groups(indptr, indices, 4, min_gain=gain)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(want, got)
    assert pk._cluster_union_groups(indptr, indices, 4) is not None
    assert pk._cluster_union_groups(indptr, indices, 4, min_gain=16) is None


@pytest.mark.parametrize("a_dt,o_dt", [(F32, F32), (BF16, BF16),
                                       (BF16, F32)])
@pytest.mark.parametrize("cluster", [True, False])
def test_union_plan_matches_reference(a_dt, o_dt, cluster):
    """union_panels and clustered of the union builder, at every u_align
    the strategies use, equal the reference's (geometry-derived gate)."""
    (m, n, k, bk, bn), indptr, indices, _, _ = cluster_pattern()
    shape = GemmShape(m, n, k, a_in_type=a_dt, b_in_type=a_dt, out_type=o_dt)
    config = SpgemmConfig(1, bk, bn)
    for ua in (1, 128 // bk, k // bk):
        ref = rk.build_bcsc_spmm_union(shape, config, indptr, indices,
                                       cluster=cluster, u_align=ua)
        port = pk.build_bcsc_spmm_union(pshape(shape), pconfig(config),
                                        indptr, indices, "cpu",
                                        cluster=cluster, u_align=ua)
        assert (port.union_panels, port.clustered) == (ref.union_panels,
                                                       ref.clustered)
    if cluster and a_dt == F32:
        assert port.clustered       # the cpu gate (4 panels) lets it in


def test_clustered_union_matches_reference():
    """The clustered plan's result: the column restore folded into the
    store gives the reference's gathered columns."""
    (m, n, k, bk, bn), indptr, indices, values, a = cluster_pattern()
    shape, config = GemmShape(m, n, k), SpgemmConfig(1, bk, bn)
    ref = rk.build_bcsc_spmm_union(shape, config, indptr, indices)
    want = np.asarray(ref(a, values), np.float64)
    bm = ro.BcscMatrix((k, n), bk, bn, indptr, indices, values)
    check(a.astype(np.float64) @ bm.to_dense().astype(np.float64), want,
          margin=1e-5)
    for s in ("union", "union4a", "union4d"):
        port = xp.create_packed_spgemm_bcsc(
            pshape(shape), xp.GemmFlags.BETA_0, pconfig(config), indptr,
            indices, strategy=s, device="cpu")
        assert port.name == ref_create(shape, config, bm, s).name
        check(want, as64(port(torch.from_numpy(a), torch.from_numpy(values))),
              margin=1e-5)


def empty_column_pattern():
    """32x128x256, bk = bn = 32: block columns 1, 4, 5, 6 and 7 empty, so
    the second 128-column group has no block."""
    rng = np.random.default_rng(5)
    m, k, n, bk, bn = 32, 128, 256, 32, 32
    b = np.zeros((k, n), np.float32)
    b[:32, :32] = rng.standard_normal((32, 32))
    b[64:128, 64:128] = rng.standard_normal((64, 64))
    return (m, k, n, bk, bn), ro.BcscMatrix.from_dense(b, bk, bn), rng


@pytest.mark.parametrize("strategy", po.STRATEGIES)
def test_empty_block_columns_are_zero(strategy):
    (m, k, n, bk, bn), bm, rng = empty_column_pattern()
    shape, config = GemmShape(m, n, k), SpgemmConfig(1, bk, bn)
    a = rng.standard_normal((m, k)).astype(np.float32)
    port = port_create(shape, config, bm, strategy)
    got = port(torch.from_numpy(a), torch.from_numpy(bm.data)).numpy()
    empty = np.diff(bm.indptr) == 0
    cols = np.repeat(empty, bn)
    assert cols.sum() == 5 * bn
    assert np.all(got[:, cols] == 0)
    check(a.astype(np.float64) @ bm.to_dense(), got, margin=1e-5)
    ref = np.asarray(ref_create(shape, config, bm, FAMILY.get(
        strategy, strategy))(a, bm.data))
    assert np.all(ref[:, cols] == 0)
    check(ref, got, margin=1e-5)


def test_pallas_empty_columns_small():
    """tests/test_sparse.py:377-390: 16x16x32 at 8x8, block column 0
    only."""
    rng = np.random.default_rng(3)
    m, k, n, bk, bn = 16, 16, 32, 8, 8
    b = np.zeros((k, n), np.float32)
    b[:8, :8] = rng.standard_normal((8, 8))
    bm = ro.BcscMatrix.from_dense(b, bk, bn)
    a = rng.standard_normal((m, k)).astype(np.float32)
    shape, config = GemmShape(m, n, k), SpgemmConfig(1, bk, bn)
    for s in ("pallas", "dense", "sparse"):
        got = port_create(shape, config, bm, s)(a, bm.data).numpy()
        assert np.all(got[:, 8:] == 0)
        check(np.asarray(ref_create(shape, config, bm, s)(a, bm.data)), got,
              margin=1e-5)


@pytest.mark.parametrize("strategy", po.STRATEGIES)
def test_empty_pattern_is_zero(strategy):
    """nblocks == 0: exact zeros on every route, in both packages."""
    m, k, n, bk, bn = 32, 128, 256, 32, 32
    bm = ro.BcscMatrix((k, n), bk, bn, np.zeros(n // bn + 1, np.int32),
                       np.zeros(0, np.int32),
                       np.zeros((0, bk, bn), np.float32))
    shape, config = GemmShape(m, n, k), SpgemmConfig(1, bk, bn)
    a = np.random.default_rng(4).standard_normal((m, k)).astype(np.float32)
    got = port_create(shape, config, bm, strategy)(a, bm.data)
    assert got.shape == (m, n) and bool((got == 0).all())
    ref = np.asarray(ref_create(shape, config, bm, FAMILY.get(
        strategy, strategy))(a, bm.data))
    assert ref.shape == (m, n) and np.all(ref == 0)


@pytest.mark.parametrize("m", [37, 200, 384])
@pytest.mark.parametrize("strategy", ["pallas", "union", "super"])
def test_rows_not_a_tile_multiple(m, strategy):
    """m = 384 takes a 192-row tile in the reference (_pick_m_tile); 37 it
    refuses (sublane alignment); the port's kernels mask the ragged last
    64-row tile."""
    rng = np.random.default_rng(m)
    k, n, bk, bn = 128, 256, 32, 32
    bm = block_pattern(rng, k, n, bk, bn, 0.3)
    a = rng.standard_normal((m, k)).astype(np.float32)
    shape, config = GemmShape(m, n, k), SpgemmConfig(1, bk, bn)
    got = as64(port_create(shape, config, bm, strategy)(a, bm.data))
    check(a.astype(np.float64) @ bm.to_dense(), got, margin=1e-5)
    ref = ref_create(shape, config, bm, strategy)
    if m % 8 == 0:
        check(np.asarray(ref(a, bm.data), np.float64), got, margin=1e-5)
    else:
        assert ref is None


@pytest.mark.parametrize("strategy", ["dense", "sparse"])
def test_int8_to_int32_exact(strategy):
    """tests/test_sparse.py:407-423: i8 x i8 -> i32, exact."""
    rng = np.random.default_rng(8)
    m, k, n, bk, bn = 32, 32, 32, 8, 8
    bq = rng.integers(-50, 50, (k, n)).astype(np.int8)
    keep = rng.random((k // bk, n // bn)) < 0.5
    bq *= np.kron(keep, np.ones((bk, bn), np.int8))
    bm = ro.BcscMatrix.from_dense(bq.astype(np.float32), bk, bn)
    aq = rng.integers(-50, 50, (m, k)).astype(np.int8)
    vq = bm.data.astype(np.int8)
    shape = GemmShape(m, n, k, a_in_type=I8, b_in_type=I8, out_type=I32,
                      comp_type=I32)
    config = SpgemmConfig(1, bk, bn)
    want = np.asarray(ref_create(shape, config, bm, "dense")(
        jnp.asarray(aq), jnp.asarray(vq)))
    np.testing.assert_array_equal(
        aq.astype(np.int32) @ bm.to_dense().astype(np.int32), want)
    got = port_create(shape, config, bm, strategy)(torch.from_numpy(aq),
                                                   torch.from_numpy(vq))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())
    for s in ("pallas", "union", "super"):      # the SpMM kernels refuse i8
        assert ref_create(shape, config, bm, s) is None
        assert port_create(shape, config, bm, s) is None


def test_f64_routes():
    """f64: "dense" and "sparse" compute in f64; the SpMM kernels refuse
    it, as the reference's do."""
    rng = np.random.default_rng(6)
    m, k, n, bk, bn = 32, 128, 128, 32, 32
    bm = block_pattern(rng, k, n, bk, bn, 0.4)
    shape = xp.GemmShape(m, n, k, xp.Datatype.F64, xp.Datatype.F64,
                         xp.Datatype.F64)
    a = rng.standard_normal((m, k))
    for s in po.STRATEGIES:
        make = functools.partial(
            xp.create_packed_spgemm_bcsc, shape, xp.GemmFlags.BETA_0,
            xp.SpgemmConfig(1, bk, bn), bm.indptr, bm.indices, strategy=s,
            device="cpu")
        if s in ("dense", "sparse"):
            got = make()(a, bm.data.astype(np.float64))
            assert got.dtype == torch.float64
            check(a @ bm.to_dense().astype(np.float64), got.numpy(),
                  margin=1e-12)
        else:
            with pytest.raises(ValueError):
                make()


def test_blocking_validated_at_create():
    """tests/test_sparse.py:797-813, in both packages."""
    for mod, shape_cls, cfg_cls, flags in (
            (ro, GemmShape, SpgemmConfig, GemmFlags.BETA_0),
            (po, xp.GemmShape, xp.SpgemmConfig, xp.GemmFlags.BETA_0)):
        kw = {"device": "cpu"} if mod is po else {}
        cfg = cfg_cls(bk=8, bn=8)
        with pytest.raises(ValueError, match="divide"):
            mod.create_packed_spgemm_bcsc(
                shape_cls(16, 100, 64), flags, cfg,
                column_ptr=np.zeros(13, np.int32),
                row_idx=np.zeros(0, np.int32), strategy="dense", **kw)
        with pytest.raises(ValueError, match="column_ptr"):
            mod.create_packed_spgemm_bcsc(
                shape_cls(16, 96, 64), flags, cfg,
                column_ptr=np.zeros(5, np.int32),
                row_idx=np.zeros(0, np.int32), strategy="dense", **kw)
        # tests/test_sparse.py:493-500: the supertile needs 128 | (k, n)
        with pytest.raises(ValueError):
            mod.create_packed_spgemm_bcsc(
                shape_cls(64, 192, 192), flags, cfg_cls(1, 32, 32),
                column_ptr=np.zeros(7, np.int32),
                row_idx=np.zeros(0, np.int32), strategy="super", **kw)
    with pytest.raises(ValueError, match="unknown BCSC strategy"):
        xp.create_packed_spgemm_bcsc(
            xp.GemmShape(16, 96, 64), xp.GemmFlags.BETA_0,
            xp.SpgemmConfig(bk=8, bn=8), np.zeros(13, np.int32),
            np.zeros(0, np.int32), strategy="unoin", device="cpu")


def test_auto_pick_follows_the_roofline_rule():
    """On the CPU "auto" takes the roofline rule (cpu geometry: hbm 50 GB/s,
    peaks 1 TFLOP/s) in both packages: "sparse" while the gathered A panels
    (nblocks * m * bk elements) move less than the dense product's time
    allows, "dense" at a high block density."""
    rng = np.random.default_rng(12)
    m, k, n, bk, bn = 64, 128, 128, 32, 32
    picks = set()
    for density in (0.2, 0.5, 0.95):
        bm = block_pattern(rng, k, n, bk, bn, density)
        shape, config = GemmShape(m, n, k), SpgemmConfig(1, bk, bn)
        ref = ref_create(shape, config, bm, "auto")
        port = port_create(shape, config, bm, "auto")
        assert port.name == ref.name
        sparse_bytes = bm.nblocks * m * bk * 4
        assert ro._dense_beats_sparse(shape, sparse_bytes) == \
            po._dense_beats_sparse(pshape(shape), sparse_bytes)
        picks.add(strategy_of(port.name))
    assert picks == {"dense", "sparse"}


@pytest.mark.parametrize("dt", [F32, BF16])
def test_densify_matches_reference_exactly(dt):
    """The densify kernel's plain version against the reference's
    densifier (interpret mode): the same values, bit for bit."""
    rng = np.random.default_rng(13)
    k, n, bk, bn = 128, 256, 16, 32
    bm = block_pattern(rng, k, n, bk, bn, 0.3)
    shape = GemmShape(32, n, k, a_in_type=dt, b_in_type=dt)
    config = SpgemmConfig(1, bk, bn)
    ref = rk.build_bcsc_densify(shape, config, bm.indptr, bm.indices)
    vj, vt = pair(bm.data, dt)
    want = np.asarray(jnp.asarray(ref(ref.gmap, vj)).astype(jnp.float32))
    got = pk.build_bcsc_densify(pshape(shape), pconfig(config), bm.indptr,
                                bm.indices, "cpu")(vt)
    assert got.dtype == TORCH[dt]
    np.testing.assert_array_equal(want, got.float().numpy())


def test_schedule_matches_reference():
    _, bm, _ = empty_column_pattern()
    want = rk._pad_empty_columns(bm.indptr, bm.indices, bm.nblocks)
    got = pk._pad_empty_columns(bm.indptr, bm.indices, bm.nblocks)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    ptr, rows, cols, vidx = pk._block_schedule(bm.indptr, bm.indices,
                                               bm.nblocks, "cpu")
    np.testing.assert_array_equal(rows.numpy(), want[0])
    np.testing.assert_array_equal(cols.numpy(), want[1])
    np.testing.assert_array_equal(vidx.numpy(), want[2])
    # every column's steps lie in [ptr[j], ptr[j+1]), at least one each
    steps = np.diff(ptr.numpy())
    assert np.all(steps >= 1) and ptr[-1] == len(want[0])
    np.testing.assert_array_equal(np.repeat(np.arange(len(steps)), steps),
                                  want[1])


def test_containers_and_fingerprints_match_reference():
    rng = np.random.default_rng(14)
    a = rng.standard_normal((12, 16)) * (rng.random((12, 16)) < 0.3)
    b = block_pattern(rng, 64, 96, 16, 32, 0.4).to_dense()
    pairs = (
        (ro.CsrMatrix.from_dense(a), po.CsrMatrix.from_dense(a)),
        (ro.CscMatrix.from_dense(a), po.CscMatrix.from_dense(a)),
        (ro.BcscMatrix.from_dense(b, 16, 32), po.BcscMatrix.from_dense(b, 16,
                                                                       32)),
        (ro.BsrMatrix.from_dense(b, 16, 32), po.BsrMatrix.from_dense(b, 16,
                                                                     32)))
    for ref, port in pairs:
        np.testing.assert_array_equal(ref.indptr, port.indptr)
        np.testing.assert_array_equal(ref.indices, port.indices)
        np.testing.assert_array_equal(ref.data, port.data)
        assert ref.fingerprint() == port.fingerprint()
        assert (ref.fingerprint(include_values=True)
                == port.fingerprint(include_values=True))
    csr = pairs[0][1]
    np.testing.assert_array_equal(csr.to_dense(), a)
    for w, g in zip(pairs[0][0].ell(), csr.ell()):
        np.testing.assert_array_equal(w, g)
    np.testing.assert_array_equal(pairs[2][1].to_dense(), b)
    np.testing.assert_array_equal(pairs[3][1].to_dense(), b)
    assert pairs[3][1].nnz == pairs[3][0].nnz
    with pytest.raises(ValueError, match="not divisible"):
        po.BcscMatrix.from_dense(b, 24, 32)


def test_registry_and_tilecfg():
    """One kernel per (pattern, strategy, device); the tilecfg create is
    the no-op kernel of dispatch_tilecfg_gemm."""
    rng = np.random.default_rng(15)
    bm = block_pattern(rng, 128, 128, 32, 32, 0.3)
    shape, config = GemmShape(32, 128, 128), SpgemmConfig(1, 32, 32)
    k1 = port_create(shape, config, bm, "union")
    assert port_create(shape, config, bm, "union") is k1
    assert port_create(shape, config, bm, "union2") is not k1
    assert k1.info.nflops == 2 * bm.nblocks * 32 * 32 * 32
    tk = xp.create_tilecfg_packed_spgemm_bcsc(pshape(shape))
    assert tk() is None and tk.info.nflops == 0


def test_default_device_is_the_card():
    """A create that names no device plans on the GPU and raises without
    one: nothing quietly runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    bm = block_pattern(np.random.default_rng(16), 32, 32, 8, 8, 0.5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xp.create_packed_spgemm_bcsc(
            xp.GemmShape(8, 32, 32), xp.GemmFlags.BETA_0,
            xp.SpgemmConfig(1, 8, 8), bm.indptr, bm.indices,
            strategy="pallas")
