"""The f32 block-sparse SpMMs' TMA-fed FMA route ("tma_fma"), on the CPU:
the route planner by dtype and blocking (`kernels.spmm.spmm_path`), the
path each builder fixes at create time, and the port against the JAX
package in f32 at small shapes for every form the route serves (scheduled
with an empty block column, supertile, every union name fused and
compacted, clustered, u_align pad slots, ragged m, f32 in / bf16 out) and
for the f32 blockings the rule leaves to the FMA kernel. The
port's wrappers run their plain versions on CPU tensors; the JAX side runs
its Pallas kernels in interpret mode, as its own tests do.

Tolerances (matdiff normf_rel), as tests/test_torch_sparse.py states them:
1e-5 for f32 in and out (the same f32 products, summed in another order),
1e-2 for bf16 outputs (one rounding at another point of the sum).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import libxsmm_torch as xp
from libxsmm_torch.kernels import spmm as pk
from libxsmm_torch.matdiff import check
from libxsmm_tpu.descriptor import GemmFlags, GemmShape, SpgemmConfig
from libxsmm_tpu.dtypes import Datatype
from libxsmm_tpu.ops import sparse as ro

torch.set_num_threads(1)

F32, BF16 = Datatype.F32, Datatype.BF16
UNION_NAMES = ("union", "union2", "union3", "union4", "union4a", "union4d",
               "union5")


def tol(o_dt):
    return 1e-2 if o_dt == BF16 else 1e-5


def pshape(m, n, k, o_dt=F32):
    return xp.GemmShape(m, n, k, xp.Datatype.F32, xp.Datatype.F32,
                        xp.Datatype[o_dt.name])


# ---------------------------------------------------------------------------
# the route planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,bk,bn,union,want", [
    (torch.float32, 32, 32, False, "tma_fma"),
    (torch.float32, 16, 64, False, "tma_fma"),
    (torch.float32, 128, 128, False, "tma_fma"),
    (torch.float32, 48, 4, False, "tma_fma"),
    (torch.float32, 2, 2, False, "fma"), (torch.float32, 6, 32, False, "fma"),
    (torch.float32, 32, 30, False, "fma"),
    (torch.float32, 32, 32, True, "tma_fma"),
    (torch.float32, 16, 64, True, "tma_fma"),
    (torch.float32, 64, 128, True, "tma_fma"),
    (torch.float32, 16, 16, True, "fma"), (torch.float32, 8, 4, True, "fma"),
    (torch.bfloat16, 8, 8, False, "fma"), (torch.bfloat16, 4, 48, False, "fma"),
    (torch.bfloat16, 32, 32, False, "wgmma"),
    (torch.bfloat16, 32, 32, True, "wgmma"),
    (torch.bfloat16, 16, 8, True, "wgmma")])
def test_route_planner(dtype, bk, bn, union, want):
    """f32 blocks of whole 16-byte units take tma_fma (the union only with
    at most four value blocks a group); bf16 of whole k16 steps and
    16-byte rows wgmma, in the union too; the rest fma."""
    assert pk.spmm_path(dtype, bk, bn, union) == want


def _pattern(k, n, bk, bn, density=0.4, seed=0, empty=()):
    rng = np.random.default_rng(seed)
    keep = rng.random((n // bn, k // bk)) < density
    keep[list(empty)] = False
    indptr = np.zeros(n // bn + 1, np.int32)
    indptr[1:] = np.cumsum(keep.sum(axis=1))
    return indptr, np.nonzero(keep)[1].astype(np.int32)


@pytest.mark.parametrize("bk,bn", [(32, 32), (16, 64), (128, 128)])
def test_builders_name_their_path(bk, bn):
    """Every f32 builder at these blockings takes tma_fma, fixed at create
    time: the scheduled kernel, the supertiles at 128 x 128 and the union
    in both forms."""
    shape = pshape(40, 256, 256)
    indptr, indices = _pattern(shape.k, shape.n, bk, bn)
    cfg = xp.SpgemmConfig(1, bk, bn)
    fns = [pk.build_bcsc_spmm(shape, cfg, indptr, indices, "cpu")]
    if bn == bk == 128:
        fns.append(pk.build_bcsc_spmm_super(shape, indptr, indices, "cpu"))
    for compact in (False, True):
        fns.append(pk.build_bcsc_spmm_union(shape, cfg, indptr, indices,
                                            "cpu", compact=compact))
    assert [fn.path for fn in fns] == ["tma_fma"] * len(fns)


def test_path_launches_count_by_route():
    """The route counters exist for the three SpMM kernels and reset with
    the launch counts; CPU calls run the plain version and count nothing."""
    assert set(pk.path_launches) == {"bcsc_spmm", "bcsc_spmm_super",
                                     "bcsc_spmm_union"}
    for counts in pk.path_launches.values():
        assert set(counts) == set(pk.ROUTES) == {"tma_fma", "fma", "wgmma"}
    shape = pshape(8, 128, 64)
    indptr, indices = _pattern(64, 128, 32, 32)
    fn = pk.build_bcsc_spmm(shape, xp.SpgemmConfig(1, 32, 32), indptr,
                            indices, "cpu")
    before = {k: dict(v) for k, v in pk.path_launches.items()}
    fn(torch.zeros(8, 64), torch.zeros(len(indices), 32, 32))
    assert pk.path_launches == before
    pk.path_launches["bcsc_spmm"]["tma_fma"] += 1
    pk.reset_launches()
    assert all(c == 0 for v in pk.path_launches.values() for c in v.values())


# ---------------------------------------------------------------------------
# the port against the JAX package in f32, every form the route serves
# ---------------------------------------------------------------------------

def _case(m, k, n, bk, bn, seed, density=0.3, empty_cols=(),
          empty_groups=False):
    """A block pattern with the given empty block columns (and, with
    `empty_groups`, its last 128-column group empty); (reference operand
    arrays, CPU tensors, the BcscMatrix)."""
    rng = np.random.default_rng(seed)
    keep = rng.random((k // bk, n // bn)) < density
    keep[:, list(empty_cols)] = False
    if empty_groups:
        keep[:, -(128 // bn):] = False
    b = rng.standard_normal((k, n)) * np.kron(keep, np.ones((bk, bn)))
    bm = ro.BcscMatrix.from_dense(b.astype(np.float32), bk, bn)
    a = rng.standard_normal((m, k)).astype(np.float32)
    v = np.ascontiguousarray(bm.data, np.float32)
    return (a, v), (torch.from_numpy(a.copy()), torch.from_numpy(v.copy())), bm


_REF = {}


def _ref_f32(shape, bk, bn, bm, strategy, a, v):
    """The reference's f32-out result of `strategy` (None where it refuses
    the descriptor for a Mosaic limit), computed once a case: a bf16-out
    case is held against it too (one rounding apart)."""
    key = (shape.m, shape.n, shape.k, bk, bn, bm.fingerprint(), strategy)
    if key not in _REF:
        try:
            ref = ro.create_packed_spgemm_bcsc(
                GemmShape(shape.m, shape.n, shape.k, F32, F32, F32),
                GemmFlags.BETA_0, SpgemmConfig(1, bk, bn),
                column_ptr=bm.indptr, row_idx=bm.indices, strategy=strategy)
        except ValueError:
            ref = None
        _REF[key] = None if ref is None else np.asarray(
            ref(jnp.asarray(a), jnp.asarray(v)), np.float64)
    return _REF[key]


def _port(shape, bk, bn, bm, strategy):
    return xp.create_packed_spgemm_bcsc(
        pshape(shape.m, shape.n, shape.k, shape.out_type),
        xp.GemmFlags.BETA_0, xp.SpgemmConfig(1, bk, bn),
        column_ptr=bm.indptr, row_idx=bm.indices, strategy=strategy,
        device="cpu")


def _family(strategy):
    """The reference lowering a port strategy is held against: the
    compacted union names against "union", the fused ones against "union4"
    (the reference's names differ only in their TPU schedules), the rest
    against themselves."""
    if strategy in ("union", "union2", "union3"):
        return "union"
    return "union4" if strategy.startswith("union") else strategy


def _hold(shape, bk, bn, bm, strategy, arrays, tensors):
    """The port's result of `strategy` against the reference's of its
    family (or against float64 alone where the reference refuses the
    descriptor for a Mosaic limit) and against float64; returns the port's
    output."""
    got = _port(shape, bk, bn, bm, strategy)(*tensors)
    assert tuple(got.shape) == (shape.m, shape.n)
    assert got.dtype == (torch.bfloat16 if shape.out_type == BF16
                         else torch.float32)
    got64 = got.float().numpy().astype(np.float64)
    a, v = arrays
    want64 = a.astype(np.float64) @ ro.BcscMatrix(
        bm.shape, bk, bn, bm.indptr, bm.indices,
        v.astype(np.float64)).to_dense()
    check(want64, got64, margin=tol(shape.out_type))
    want = _ref_f32(shape, bk, bn, bm, _family(strategy), a, v)
    if want is not None:
        check(want, got64, margin=tol(shape.out_type))
    return got


def _path(shape, bk, bn, bm, builder, **kw):
    return builder(pshape(shape.m, shape.n, shape.k, shape.out_type),
                   xp.SpgemmConfig(1, bk, bn), bm.indptr, bm.indices, "cpu",
                   **kw).path


@pytest.mark.parametrize("o_dt", [F32, BF16])
@pytest.mark.parametrize("bk,bn", [(32, 32), (16, 64)])
def test_scheduled_parity(bk, bn, o_dt):
    """Strategy "pallas" with an empty block column (its zero-block step)
    and f32 in / bf16 out."""
    m, k, n = 16, 64, 128
    arrays, tensors, bm = _case(m, k, n, bk, bn, seed=bk + bn,
                                density=0.5, empty_cols=(1,))
    shape = GemmShape(m, n, k, F32, F32, o_dt)
    assert _path(shape, bk, bn, bm, pk.build_bcsc_spmm) == "tma_fma"
    got = _hold(shape, bk, bn, bm, "pallas", arrays, tensors)
    assert bool((got[:, bn:2 * bn] == 0).all())


@pytest.mark.parametrize("o_dt", [F32, BF16])
def test_supertile_parity(o_dt):
    """Strategy "super": the occupied 128 x 128 supertiles on the route."""
    m, k, n, bk, bn = 16, 256, 256, 32, 32
    arrays, tensors, bm = _case(m, k, n, bk, bn, seed=5, density=0.2,
                                empty_cols=range(4, 8))
    shape = GemmShape(m, n, k, F32, F32, o_dt)
    from libxsmm_torch.ops.sparse import supertile_plan
    s_indptr, s_indices, _ = supertile_plan(
        pshape(m, n, k, o_dt), xp.SpgemmConfig(1, bk, bn), bm.indptr,
        bm.indices)
    assert pk.build_bcsc_spmm_super(pshape(m, n, k, o_dt), s_indptr,
                                    s_indices, "cpu").path == "tma_fma"
    got = _hold(shape, bk, bn, bm, "super", arrays, tensors)
    assert bool((got[:, 128:256] == 0).all())     # an empty supertile column


@pytest.mark.parametrize("strategy", UNION_NAMES)
def test_union_names_parity(strategy):
    """Every union name, fused or compacted as the name selects it, with
    u_align pad slots (union4a, union4d), an empty block column and an
    empty 128-column group, in f32 on the route."""
    m, k, n, bk, bn = 16, 128, 256, 32, 32
    arrays, tensors, bm = _case(m, k, n, bk, bn, seed=11, density=0.4,
                                empty_cols=(1,), empty_groups=True)
    shape = GemmShape(m, n, k, F32, F32, F32)
    compact = strategy in ("union", "union2", "union3")
    assert _path(shape, bk, bn, bm, pk.build_bcsc_spmm_union,
                 compact=compact) == "tma_fma"
    got = _hold(shape, bk, bn, bm, strategy, arrays, tensors)
    assert bool((got[:, 128:] == 0).all())


@pytest.mark.parametrize("strategy", ["union", "union4"])
@pytest.mark.parametrize("bk,bn", [(16, 64), (64, 128)])
def test_union_blockings_parity(strategy, bk, bn):
    """The union at the route's wider blockings (two and one value blocks
    a group; 16 and 64 deep), compacted and fused, f32 in / bf16 out."""
    m, k, n = 16, 128, 128
    arrays, tensors, bm = _case(m, k, n, bk, bn, seed=bk, density=0.5,
                                empty_cols=(0,))
    shape = GemmShape(m, n, k, F32, F32, BF16)
    assert _path(shape, bk, bn, bm, pk.build_bcsc_spmm_union,
                 compact=strategy == "union") == "tma_fma"
    _hold(shape, bk, bn, bm, strategy, arrays, tensors)


@pytest.mark.parametrize("strategy", ["union", "union4"])
def test_union_clustered_parity(strategy):
    """Two families of block rows (tests/test_sparse.py's cluster case):
    the clustered f32 plan's permuted groups restored in the store."""
    bk = bn = 32
    m, n, k = 16, 256, 256
    rng = np.random.default_rng(11)
    cols = [np.sort(rng.choice(np.arange(0, 4) if j % 2 == 0
                               else np.arange(4, 8), 3, replace=False))
            for j in range(n // bn)]
    indptr = np.arange(0, 3 * (n // bn) + 1, 3, dtype=np.int32)
    indices = np.concatenate(cols).astype(np.int32)
    v = rng.standard_normal((len(indices), bk, bn)).astype(np.float32)
    bm = ro.BcscMatrix((k, n), bk, bn, indptr, indices, v)
    a = rng.standard_normal((m, k)).astype(np.float32)
    shape = GemmShape(m, n, k, F32, F32, F32)
    plan = pk.build_bcsc_spmm_union(pshape(m, n, k), xp.SpgemmConfig(1, bk,
                                                                      bn),
                                    indptr, indices, "cpu",
                                    compact=strategy == "union")
    assert plan.path == "tma_fma" and plan.clustered
    _hold(shape, bk, bn, bm, strategy, (a, v),
          (torch.from_numpy(a.copy()), torch.from_numpy(v.copy())))


@pytest.mark.parametrize("strategy", ["pallas", "union", "union4"])
def test_ragged_m(strategy):
    """m = 37, a ragged last row tile on the card: against float64, and
    against the reference where it takes the descriptor."""
    m, k, n, bk, bn = 37, 64, 128, 32, 32
    arrays, tensors, bm = _case(m, k, n, bk, bn, seed=37, density=0.5,
                                empty_cols=(2,))
    shape = GemmShape(m, n, k, F32, F32, F32)
    _hold(shape, bk, bn, bm, strategy, arrays, tensors)


@pytest.mark.parametrize("strategy,bk,bn", [
    ("pallas", 6, 32), ("pallas", 2, 2), ("union", 16, 16)])
def test_fma_route_parity(strategy, bk, bn):
    """f32 blockings the rule leaves to the FMA kernel: blocks whose depth
    or rows are not whole 16-byte units, and unions of more than four
    value blocks a group (the compacted form; the fused one shares its
    plain version here and is held on the card)."""
    m, k, n = 16, 96, 128
    arrays, tensors, bm = _case(m, k, n, bk, bn, seed=bk * bn, density=0.4,
                                empty_cols=(1,))
    shape = GemmShape(m, n, k, F32, F32, F32)
    if strategy == "pallas":
        assert _path(shape, bk, bn, bm, pk.build_bcsc_spmm) == "fma"
    else:
        assert _path(shape, bk, bn, bm, pk.build_bcsc_spmm_union,
                     compact=strategy == "union") == "fma"
    got = _hold(shape, bk, bn, bm, strategy, arrays, tensors)
    assert bool((got[:, bn:2 * bn] == 0).all())
