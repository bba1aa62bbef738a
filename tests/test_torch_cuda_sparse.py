"""The BCSC SpMM kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one. On the GPU
machine run:

    python -m pytest tests/test_torch_cuda_sparse.py --noconftest -q

(`--noconftest`: the repo's tests/conftest.py sets JAX up for the JAX
package's tests, and this file imports nothing of JAX or libxsmm_tpu.)

Tolerances (matdiff normf_rel): 1e-5 for f32 in and out and 1e-4 for bf16
in / f32 out (the sums run in another order than the plain version's);
1e-2 for bf16 outputs (one rounding, at another point of the sum); the
densify kernel, the union RHS compactor, empty block columns and empty
patterns exact. bf16 operands at blockings of whole k16 steps and
16-byte rows run the scheduled, supertile and union SpMMs on wgmma
("wgmma"): 32 x 32, 64 x 128, 128 x 128 and the narrow blockings 16 x 64,
16 x 8, 48 x 24, 48 x 32, 32 x 16 (16-deep slices, value boxes 8 or 16
wide), all at the same margins: their bf16 products are exact in the f32
accumulator. f32 operands at blockings of whole 16-byte
units run the TMA-fed FMA kernels ("tma_fma"; the union at bn >= 32), at
the same margins; TF32 stays off. The FMA kernels ("fma") are held at the
blockings the rule sends to them.
"""

import numpy as np
import pytest
import torch

import libxsmm_torch as xp
from libxsmm_torch.descriptor import GemmFlags, GemmShape, SpgemmConfig
from libxsmm_torch.dtypes import Datatype
from libxsmm_torch.kernels import spmm as pk
from libxsmm_torch.matdiff import check
from libxsmm_torch.ops import sparse as po

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F32, BF16, F64, I8, I32 = (Datatype.F32, Datatype.BF16, Datatype.F64,
                           Datatype.I8, Datatype.I32)
TORCH = {F32: torch.float32, BF16: torch.bfloat16}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.Generator(device="cuda").manual_seed(0)


def rand(gen, shape, dt=F32):
    return torch.randn(*shape, generator=gen, device="cuda").to(TORCH[dt])


def tol(a_dt, o_dt):
    if o_dt == BF16:
        return 1e-2
    return 1e-5 if a_dt == F32 else 1e-4


def pattern(k, n, bk, bn, density, seed=0, empty_cols=()):
    """indptr, indices of a random block pattern; `empty_cols` block
    columns hold no block."""
    rng = np.random.default_rng(seed)
    keep = rng.random((n // bn, k // bk)) < density
    keep[list(empty_cols)] = False
    indptr = np.zeros(n // bn + 1, np.int32)
    indptr[1:] = np.cumsum(keep.sum(axis=1))
    indices = np.nonzero(keep)[1].astype(np.int32)
    return indptr, indices


def same(want, got, t):
    torch.cuda.synchronize()
    assert got.is_cuda and got.dtype == want.dtype
    assert got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    check(want.double().cpu().numpy(), got.double().cpu().numpy(), margin=t)


def launched(name, fn, *args):
    before = pk.launches[name]
    out = fn(*args)
    assert pk.launches[name] == before + 1
    return out


DTYPES = [(F32, F32), (BF16, F32), (BF16, BF16), (F32, BF16)]


@pytest.mark.parametrize("a_dt,o_dt", DTYPES)
@pytest.mark.parametrize("m,k,n,bk,bn", [
    (1, 64, 64, 8, 8), (37, 256, 384, 32, 32), (200, 128, 256, 16, 64),
    (64, 96, 144, 4, 48), (130, 512, 128, 128, 128)])
def test_bcsc_spmm(gen, m, k, n, bk, bn, a_dt, o_dt):
    indptr, indices = pattern(k, n, bk, bn, 0.3, seed=m,
                              empty_cols=(0,))
    shape = GemmShape(m, n, k, a_dt, a_dt, o_dt)
    fn = pk.build_bcsc_spmm(shape, SpgemmConfig(1, bk, bn), indptr, indices,
                            "cuda")
    a, v = rand(gen, (m, k), a_dt), rand(gen, (len(indices), bk, bn), a_dt)
    got = launched("bcsc_spmm", fn, a, v)
    same(fn.plain(a, v), got, tol(a_dt, o_dt))
    assert bool((got[:, :bn] == 0).all())        # block column 0 is empty


@pytest.mark.parametrize("a_dt,o_dt", DTYPES)
@pytest.mark.parametrize("m", [1, 64, 200])
def test_bcsc_spmm_super(gen, m, a_dt, o_dt):
    k, n = 384, 512
    indptr, indices = pattern(k, n, 128, 128, 0.5, seed=m, empty_cols=(1,))
    shape = GemmShape(m, n, k, a_dt, a_dt, o_dt)
    fn = pk.build_bcsc_spmm_super(shape, indptr, indices, "cuda")
    a, sup = rand(gen, (m, k), a_dt), rand(gen, (len(indices), 128, 128), a_dt)
    got = launched("bcsc_spmm_super", fn, a, sup)
    same(fn.plain(a, sup), got, tol(a_dt, o_dt))
    assert bool((got[:, 128:256] == 0).all())


# blockings the tensor-core kernels serve with bf16 operands (bk % 16 == 0,
# bn % 8 == 0), all on wgmma (the f32 tests below take the first three)
MMA_BLOCKINGS = [(32, 32), (16, 64), (128, 128)]
# the narrow ones: 16-deep slices (bk 16, 48), value boxes 8, 16 or 32 wide
# with columns past bn zero-filled (bn 8, 24, 16)
NARROW_BLOCKINGS = [(16, 8), (48, 24), (48, 32), (32, 16)]


def depth(bk, k=512):
    """k cut to a multiple of bk (480 at bk = 48)."""
    return k - k % bk


@pytest.mark.parametrize("o_dt", [F32, BF16])
@pytest.mark.parametrize("m", [1, 37, 200, 32768])
@pytest.mark.parametrize("bk,bn", MMA_BLOCKINGS + NARROW_BLOCKINGS)
def test_bcsc_spmm_mma(gen, bk, bn, m, o_dt):
    """The tensor-core kernel at every blocking class: ragged and
    streaming m, an empty block column (its zero-block step multiplied),
    both output types, the launch counted on route wgmma."""
    k, n = depth(bk), 384
    indptr, indices = pattern(k, n, bk, bn, 0.3, seed=m + bk,
                              empty_cols=(1,))
    shape = GemmShape(m, n, k, BF16, BF16, o_dt)
    fn = pk.build_bcsc_spmm(shape, SpgemmConfig(1, bk, bn), indptr, indices,
                            "cuda")
    assert fn.path == pk.spmm_path(torch.bfloat16, bk, bn) == "wgmma"
    a, v = rand(gen, (m, k), BF16), rand(gen, (len(indices), bk, bn), BF16)
    got = on_route("bcsc_spmm", "wgmma", fn, a, v)
    same(fn.plain(a, v), got, tol(BF16, o_dt))
    assert bool((got[:, bn:2 * bn] == 0).all())


@pytest.mark.parametrize("bk,bn,union,compact", [
    (16, 8, False, False), (48, 24, False, False), (32, 16, False, False),
    (16, 64, False, False), (16, 8, True, False), (16, 8, True, True),
    (32, 16, True, False), (48, 32, True, True)])
def test_wgmma_plan_is_the_launched_tile(gen, bk, bn, union, compact):
    """kernels.spmm.wgmma_plan names the instantiation that runs: the
    launched entry's template arguments (the library's launch log) carry
    the plan's TN and KC (scheduled) or KC and box (union)."""
    from libxsmm_torch import lowering
    from libxsmm_torch.kernels import _build
    m, k, n = 200, depth(bk, 256), 384
    indptr, indices = pattern(k, n, bk, bn, 0.3, seed=bk + bn)
    shape, cfg = GemmShape(m, n, k, BF16, BF16, F32), SpgemmConfig(1, bk, bn)
    fn = (pk.build_bcsc_spmm_union(shape, cfg, indptr, indices, "cuda",
                                   compact=compact) if union else
          pk.build_bcsc_spmm(shape, cfg, indptr, indices, "cuda"))
    a, v = rand(gen, (m, k), BF16), rand(gen, (len(indices), bk, bn), BF16)
    fn(a, v)
    torch.cuda.synchronize()
    before = _build.launch_log()
    got = on_route(fn.counter, "wgmma", fn, a, v)
    torch.cuda.synchronize()
    ran = [e for e in lowering.launched_entries(
        before, _build.launch_log()).get("spmm_kernels", {}) if "wgmma" in e]
    plan = pk.wgmma_plan(bk, bn, union=union, compact=compact)
    if union:
        want = (f"bcsc_union_wgmma_kernelIfLi{plan['kc']}ELi{plan['box']}E"
                f"Li{32 if bn % 32 == 0 else 8}ELb{int(compact)}E")
    else:
        want = f"bcsc_spmm_wgmma_kernelIfLi{plan['tn']}ELi{plan['kc']}E"
    assert len(ran) == 1 and want in ran[0], ran
    same(fn.plain(a, v), got, 1e-4)


@pytest.mark.parametrize("o_dt", [F32, BF16])
@pytest.mark.parametrize("m", [37, 32768])
def test_bcsc_spmm_super_mma(gen, m, o_dt):
    k, n = 512, 384
    indptr, indices = pattern(k, n, 128, 128, 0.6, seed=m, empty_cols=(2,))
    shape = GemmShape(m, n, k, BF16, BF16, o_dt)
    fn = pk.build_bcsc_spmm_super(shape, indptr, indices, "cuda")
    assert fn.path == "wgmma"
    a = rand(gen, (m, k), BF16)
    sup = rand(gen, (len(indices), 128, 128), BF16)
    got = launched("bcsc_spmm_super", fn, a, sup)
    same(fn.plain(a, sup), got, tol(BF16, o_dt))
    assert bool((got[:, 256:] == 0).all())


@pytest.mark.parametrize("bk,bn", MMA_BLOCKINGS + NARROW_BLOCKINGS)
def test_bcsc_spmm_mma_nan_in_block_row_0(gen, bk, bn):
    """An empty block column multiplies A's block row 0 by the zero block,
    as the reference does: a NaN there gives NaN, as the plain version."""
    m, k, n = 70, depth(bk, 256), 384
    indptr, indices = pattern(k, n, bk, bn, 0.4, seed=bk, empty_cols=(0,))
    fn = pk.build_bcsc_spmm(GemmShape(m, n, k, BF16, BF16, F32),
                            SpgemmConfig(1, bk, bn), indptr, indices, "cuda")
    assert fn.path == "wgmma"
    a, v = rand(gen, (m, k), BF16), rand(gen, (len(indices), bk, bn), BF16)
    a[5, 3] = float("nan")
    got = on_route("bcsc_spmm", "wgmma", fn, a, v)
    want = fn.plain(a, v)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[5, :bn]).all())
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    keep = ~torch.isnan(want)
    check(want[keep].double().cpu().numpy(), got[keep].double().cpu().numpy(),
          margin=1e-4)
    assert bool((got[torch.arange(m, device="cuda") != 5, :bn] == 0).all())


# the wgmma kernel's tiles: 32 / 64 / 128 columns (a wider block column in
# 128-column chunks, the last cut), 32- or 64-deep slices
WGMMA_BLOCKINGS = [(32, 32), (64, 128), (128, 128), (32, 96), (64, 32),
                   (96, 64), (64, 256)]


@pytest.mark.parametrize("o_dt", [F32, BF16])
@pytest.mark.parametrize("m", [1, 37, 200, 1000, 32768])
@pytest.mark.parametrize("bk,bn", WGMMA_BLOCKINGS)
def test_bcsc_spmm_wgmma(gen, bk, bn, m, o_dt):
    """The wgmma kernel at each of its tiles: ragged and streaming m, an
    empty block column (the zero block loaded past the value map), both
    output types; the launch counted on route wgmma."""
    k, n = 384, 512 if bn != 96 else 384
    indptr, indices = pattern(k, n, bk, bn, 0.35, seed=m + bk + bn,
                              empty_cols=(1,))
    shape = GemmShape(m, n, k, BF16, BF16, o_dt)
    fn = pk.build_bcsc_spmm(shape, SpgemmConfig(1, bk, bn), indptr, indices,
                            "cuda")
    assert fn.path == "wgmma"
    a, v = rand(gen, (m, k), BF16), rand(gen, (len(indices), bk, bn), BF16)
    routed = pk.path_launches["bcsc_spmm"]["wgmma"]
    got = launched("bcsc_spmm", fn, a, v)
    assert pk.path_launches["bcsc_spmm"]["wgmma"] == routed + 1
    same(fn.plain(a, v), got, tol(BF16, o_dt))
    assert bool((got[:, bn:2 * bn] == 0).all())


@pytest.mark.parametrize("o_dt", [F32, BF16])
@pytest.mark.parametrize("bk,bn", [(32, 32), (128, 128), (16, 64)]
                         + NARROW_BLOCKINGS)
def test_bcsc_spmm_wgmma_empty_store(gen, bk, bn, o_dt):
    """No block at all: every column's one step multiplies A's block row 0
    by the zero block (the value map over A's memory, never read in
    bounds): zeros, and NaN where block row 0 holds one."""
    m, k, n = 150, depth(bk, 256), 384
    indptr = np.zeros(n // bn + 1, np.int32)
    indices = np.zeros(0, np.int32)
    fn = pk.build_bcsc_spmm(GemmShape(m, n, k, BF16, BF16, o_dt),
                            SpgemmConfig(1, bk, bn), indptr, indices, "cuda")
    assert fn.path == "wgmma"
    a, v = rand(gen, (m, k), BF16), rand(gen, (0, bk, bn), BF16)
    got = on_route("bcsc_spmm", "wgmma", fn, a, v)
    torch.cuda.synchronize()
    assert bool((got == 0).all())
    a[7, bk - 1] = float("nan")
    got = launched("bcsc_spmm", fn, a, v)
    want = fn.plain(a, v)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert bool(torch.isnan(got[7]).all())


@pytest.mark.parametrize("o_dt", [F32, BF16])
@pytest.mark.parametrize("bk,bn", [(32, 32), (64, 128), (128, 128), (16, 64)]
                         + NARROW_BLOCKINGS)
def test_bcsc_spmm_wgmma_repeats_bit_for_bit(gen, bk, bn, o_dt):
    """One block writes each output tile once, summing in schedule order:
    two calls give the same bits, the scheduled and supertile entries
    alike."""
    m, k, n = 3000, depth(bk), 384 if bn % 24 == 0 else 512
    indptr, indices = pattern(k, n, bk, bn, 0.5, seed=bk + bn)
    shape = GemmShape(m, n, k, BF16, BF16, o_dt)
    a, v = rand(gen, (m, k), BF16), rand(gen, (len(indices), bk, bn), BF16)
    fns = [pk.build_bcsc_spmm(shape, SpgemmConfig(1, bk, bn), indptr,
                              indices, "cuda")]
    if bk == bn == 128:
        fns.append(pk.build_bcsc_spmm_super(shape, indptr, indices, "cuda"))
    for fn in fns:
        assert fn.path == "wgmma"
        x, y = fn(a, v), fn(a, v)
        torch.cuda.synchronize()
        assert torch.equal(x, y)
        same(fn.plain(a, v), x, tol(BF16, o_dt))


@pytest.mark.parametrize("bk,bn,route", [(32, 32, "wgmma"),
                                         (128, 128, "wgmma"),
                                         (16, 64, "wgmma"), (16, 8, "wgmma"),
                                         (48, 24, "wgmma"),
                                         (32, 16, "wgmma")])
@pytest.mark.parametrize("o_dt", [F32, BF16])
def test_bcsc_spmm_mma_unaligned_views(gen, o_dt, bk, bn, route):
    """A and the values 6 and 2 bytes past a 16-byte boundary: the wrapper
    copies them into fresh tensors for the kernel's TMA maps."""
    m, k, n = 100, depth(bk, 256), 384
    indptr, indices = pattern(k, n, bk, bn, 0.4, seed=9)
    fn = pk.build_bcsc_spmm(GemmShape(m, n, k, BF16, BF16, o_dt),
                            SpgemmConfig(1, bk, bn), indptr, indices, "cuda")
    assert fn.path == route
    a = rand(gen, (m * k + 3,), BF16)[3:].view(m, k)
    v = rand(gen, (len(indices) * bk * bn + 1,), BF16)[1:].view(
        len(indices), bk, bn)
    assert a.data_ptr() % 16 == 6 and v.data_ptr() % 16 == 2
    got = on_route("bcsc_spmm", route, fn, a, v)
    same(fn.plain(a, v), got, tol(BF16, o_dt))


@pytest.mark.parametrize("a_dt,o_dt", DTYPES)
@pytest.mark.parametrize("u_align", [1, 4, 8])
@pytest.mark.parametrize("m,k,n,bk,bn", [
    (37, 256, 384, 32, 32), (200, 128, 256, 16, 64), (64, 64, 128, 8, 8)])
def test_bcsc_spmm_union(gen, m, k, n, bk, bn, u_align, a_dt, o_dt):
    """Three groups, odd rows, pad slots (u_align), an empty group."""
    indptr, indices = pattern(k, n, bk, bn, 0.25, seed=m,
                              empty_cols=range(128 // bn))
    shape = GemmShape(m, n, k, a_dt, a_dt, o_dt)
    fn = pk.build_bcsc_spmm_union(shape, SpgemmConfig(1, bk, bn), indptr,
                                  indices, "cuda", u_align=u_align)
    a, v = rand(gen, (m, k), a_dt), rand(gen, (len(indices), bk, bn), a_dt)
    got = launched("bcsc_spmm_union", fn, a, v)
    same(fn.plain(a, v), got, tol(a_dt, o_dt))
    assert bool((got[:, :128] == 0).all())


@pytest.mark.parametrize("a_dt,o_dt,clusters", [
    (F32, F32, True), (F32, BF16, True), (BF16, BF16, True),
    (BF16, F32, False)])
def test_bcsc_spmm_union_clustered(gen, a_dt, o_dt, clusters):
    """bench.py's two-family pattern (bcsc_cluster, k = 2048, n = 1024):
    the clustered plan's permuted groups, restored in the kernel's store.
    Clustering saves about 22 union panels; the H100 gate, ceil(osz * peak
    / hbm / bk), is 3 panels for f32 in, 19 for bf16 in with bf16 out and
    37 for bf16 in with f32 out, which therefore keeps the plain plan."""
    bk = bn = 32
    m, k, n = 96, 2048, 1024
    kb, nb = k // bk, n // bn
    rng = np.random.default_rng(7)
    fam_a, fam_b = np.arange(0, kb // 2 - 2), np.arange(kb // 2, kb - 2)
    cols = []
    for j in range(nb):
        fam = fam_a if j % 2 == 0 else fam_b
        take = min(int(0.64 * len(fam)) + (j % 2), len(fam))
        cols.append(np.sort(rng.choice(fam, take, replace=False)))
    indptr = np.concatenate(
        [[0], np.cumsum([len(c) for c in cols])]).astype(np.int32)
    indices = np.concatenate(cols).astype(np.int32)
    shape = GemmShape(m, n, k, a_dt, a_dt, o_dt)
    cfg = SpgemmConfig(1, bk, bn)
    fn = pk.build_bcsc_spmm_union(shape, cfg, indptr, indices, "cuda")
    base = pk.build_bcsc_spmm_union(shape, cfg, indptr, indices, "cuda",
                                    cluster=False)
    assert fn.clustered == clusters
    if clusters:
        assert fn.union_panels < base.union_panels
    a, v = rand(gen, (m, k), a_dt), rand(gen, (len(indices), bk, bn), a_dt)
    got = launched("bcsc_spmm_union", fn, a, v)
    same(fn.plain(a, v), got, tol(a_dt, o_dt))
    same(base(a, v), got, tol(a_dt, o_dt))


def cluster_pattern(k=2048, n=1024, bk=32, bn=32):
    """bench.py's two-family pattern (bcsc_cluster): even block columns
    draw from the first half of the block rows, odd ones from the second."""
    kb, nb = k // bk, n // bn
    rng = np.random.default_rng(7)
    fam_a, fam_b = np.arange(0, kb // 2 - 2), np.arange(kb // 2, kb - 2)
    cols = []
    for j in range(nb):
        fam = fam_a if j % 2 == 0 else fam_b
        take = min(int(0.64 * len(fam)) + (j % 2), len(fam))
        cols.append(np.sort(rng.choice(fam, take, replace=False)))
    indptr = np.concatenate(
        [[0], np.cumsum([len(c) for c in cols])]).astype(np.int32)
    return indptr, np.concatenate(cols).astype(np.int32)


# (m, k, n, bk, bn, u_align) of the compactor cases: the CPU cases' union
# blockings (tests/test_torch_sparse.py), odd rows, pad slots, bn = 4 (the
# 8-byte and 4-byte copy units) and the clustered plan
COMPACT_CASES = [(32, 32, 128, 4, 4, 1), (32, 128, 128, 8, 16, 1),
                 (64, 128, 128, 32, 32, 1), (37, 256, 384, 32, 32, 4),
                 (200, 128, 256, 16, 64, 8), (96, 2048, 1024, 32, 32, 1)]


@pytest.mark.parametrize("a_dt,o_dt", [(F32, F32), (BF16, F32),
                                       (BF16, BF16)])
@pytest.mark.parametrize("m,k,n,bk,bn,u_align", COMPACT_CASES)
def test_union_compactor_and_compact_form(gen, m, k, n, bk, bn, u_align,
                                          a_dt, o_dt):
    """The compactor byte-equal to its plain version; the compacted union
    form (two launches) against the fused form and the plain version."""
    if k == 2048:
        indptr, indices = cluster_pattern(k, n, bk, bn)
    else:
        indptr, indices = pattern(k, n, bk, bn, 0.3, seed=m,
                                  empty_cols=range(128 // bn))
    shape = GemmShape(m, n, k, a_dt, a_dt, o_dt)
    cfg = SpgemmConfig(1, bk, bn)
    fused = pk.build_bcsc_spmm_union(shape, cfg, indptr, indices, "cuda",
                                     u_align=u_align)
    comp = pk.build_bcsc_spmm_union(shape, cfg, indptr, indices, "cuda",
                                    u_align=u_align, compact=True)
    if k == 2048:         # the H100 gate keeps bf16 -> f32 unclustered
        assert comp.clustered == (a_dt == F32 or o_dt == BF16)
    a, v = rand(gen, (m, k), a_dt), rand(gen, (len(indices), bk, bn), a_dt)
    rhs = launched("bcsc_union_compact", comp.compactor, v)
    torch.cuda.synchronize()
    want_rhs = comp.compactor.plain(v)
    assert rhs.dtype == want_rhs.dtype and rhs.shape == want_rhs.shape
    assert torch.equal(rhs.view(torch.uint8), want_rhs.view(torch.uint8))
    before = dict(pk.launches)
    got = comp(a, v)
    torch.cuda.synchronize()
    assert pk.launches["bcsc_union_compact"] == before[
        "bcsc_union_compact"] + 1
    assert pk.launches["bcsc_spmm_union"] == before["bcsc_spmm_union"] + 1
    t = tol(a_dt, o_dt)
    same(fused(a, v), got, t)
    same(comp.plain(a, v), got, t)
    assert pk.launches["bcsc_union_compact"] == before[
        "bcsc_union_compact"] + 1             # the fused form: no compactor


def test_compactor_unaligned_values(gen):
    """A value tensor that starts 4 bytes past an aligned address takes the
    element route (4-byte units) and still matches its plain version."""
    indptr, indices = pattern(128, 256, 32, 32, 0.4, seed=5)
    fn = pk.build_bcsc_spmm_union(GemmShape(16, 256, 128), SpgemmConfig(
        1, 32, 32), indptr, indices, "cuda", compact=True)
    store = rand(gen, (len(indices) * 32 * 32 + 1,))
    v = store[1:].view(len(indices), 32, 32)
    assert v.data_ptr() % 16 == 4
    assert fn.compactor.route(v, fn.compactor.rhs(v))[0] == "element"
    got = launched("bcsc_union_compact", fn.compactor, v)
    torch.cuda.synchronize()
    assert torch.equal(got, fn.compactor.plain(v))


def _compactor(nsg, U, bk, bn, nblocks, dtype, pad=0.2, seed=0):
    """A compactor over a random (nsg, U, 128/bn) map into `nblocks` value
    blocks of `dtype`, a `pad` share of its entries the zero block and
    group 0's slots all pad."""
    rng = np.random.default_rng(seed)
    W = 128 // bn
    gmap = rng.integers(0, nblocks, (nsg, U, W))
    gmap[rng.random(gmap.shape) < pad] = nblocks
    gmap[0] = nblocks
    return pk.BcscUnionCompact(
        nsg, U, W, bk, bn, nblocks,
        torch.as_tensor(gmap.reshape(-1), dtype=torch.int32, device="cuda"),
        dtype)


def _values(gen, shape, dtype):
    if dtype == torch.int8:
        return torch.randint(-128, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("nsg,U,bk,bn,route", [
    (8, 21, 32, 32, "bulk"),        # the streaming case's plan
    (16, 40, 32, 32, "bulk"),       # 640 slots, more than 4 x 132
    (1, 1, 32, 32, "bulk"),         # one slot (all pad: group 0)
    (2, 3, 256, 128, "bulk"),       # deep blocks, several tiles a slot
    (3, 5, 16, 64, "bulk"),
    (2, 4, 16, 4, None)])           # 4-16 byte rows: by element size
def test_compactor_routes_byte_equal(gen, nsg, U, bk, bn, route, dtype):
    """The compactor byte-equal to its plain version on both routes, f32,
    bf16 and int8 values, with pad slots and an all-pad group; the route
    the shape and alignment choose."""
    nblocks = 37
    fn = _compactor(nsg, U, bk, bn, nblocks, dtype, seed=U)
    v = _values(gen, (nblocks, bk, bn), dtype)
    want_route = route or ("bulk" if (bn * v.element_size()) % 16 == 0
                           else "element")
    assert fn.route(v, fn.rhs(v))[0] == want_route
    got = launched("bcsc_union_compact", fn, v)
    torch.cuda.synchronize()
    want = fn.plain(v)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert not got[0].any()                     # the all-pad group


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_compactor_offset_view_takes_element_route(gen, dtype):
    """A value view one element past an aligned base goes the element
    route, byte-equal to the plain version."""
    nblocks, bk, bn = 21, 32, 32
    fn = _compactor(4, 9, bk, bn, nblocks, dtype, seed=3)
    store = _values(gen, (nblocks * bk * bn + 1,), dtype)
    v = store[1:].view(nblocks, bk, bn)
    assert fn.route(v, fn.rhs(v))[0] == "element"
    got = launched("bcsc_union_compact", fn, v)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.uint8), fn.plain(v).view(torch.uint8))


@pytest.mark.parametrize("a_dt", [BF16, F32])
def test_compacted_form_replays_from_a_cuda_graph(gen, a_dt):
    """The compacted form's one host call (the compactor, then the union
    kernel as a programmatic dependent launch) captured in a CUDA graph:
    each replay gives the eager result bit for bit, and the capture counts
    both kernels once."""
    indptr, indices = pattern(1024, 1024, 32, 32, 0.2, seed=2)
    shape = GemmShape(256, 1024, 1024, a_dt, a_dt, F32)
    fn = pk.build_bcsc_spmm_union(shape, SpgemmConfig(1, 32, 32), indptr,
                                  indices, "cuda", compact=True)
    a = rand(gen, (256, 1024), a_dt)
    v = rand(gen, (len(indices), 32, 32), a_dt)
    want = fn(a, v)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(a, v)
    torch.cuda.current_stream().wait_stream(side)
    before = dict(pk.launches)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fn(a, v)
    for name in ("bcsc_union_compact", "bcsc_spmm_union"):
        assert pk.launches[name] == before[name] + 1
    for _ in range(3):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("build,kw", [
    (pk.build_bcsc_spmm_union, {"compact": True}),
    (pk.build_bcsc_spmm_union, {"compact": False}),
    (pk.build_bcsc_spmm, {})])
def test_empty_m_launches_nothing(gen, build, kw):
    """m = 0: an empty C on the card, and no kernel counted, since none is
    launched (the compactor included)."""
    indptr, indices = pattern(128, 256, 32, 32, 0.4, seed=4)
    fn = build(GemmShape(0, 256, 128, BF16, BF16, F32),
               SpgemmConfig(1, 32, 32), indptr, indices, "cuda", **kw)
    before = dict(pk.launches)
    got = fn(rand(gen, (0, 128), BF16), rand(gen, (len(indices), 32, 32),
                                             BF16))
    assert got.is_cuda and got.shape == (0, 256) and got.dtype == torch.float32
    assert dict(pk.launches) == before


def test_compactor_element_route_on_aligned_values(gen):
    """The C entry takes the element route on any input (the wrapper picks
    it only where bulk copies cannot serve; scripts/stream_time.py times it
    beside the bulk route): byte-equal to the bulk route and the plain
    version on 16-byte-aligned bf16 values; the bulk route on misaligned
    values is refused."""
    fn = _compactor(8, 21, 32, 32, 37, torch.bfloat16, seed=2)
    v = _values(gen, (37, 32, 32), torch.bfloat16)
    lib = pk._kernels()
    outs = {}
    for route in ("bulk", "element"):
        out = fn.rhs(v)
        grid = fn.route(v, out)[1]
        err = lib.xsmm_bcsc_union_compact(
            v.data_ptr(), fn.gmap.data_ptr(), out.data_ptr(), fn.nsg, fn.U,
            fn.bk, fn.bn, fn.nblocks, 2, pk._CP_ROUTES[route], grid,
            torch.cuda.current_stream().cuda_stream)
        assert err == 0
        outs[route] = out
    torch.cuda.synchronize()
    want = fn.plain(v).view(torch.uint8)
    for out in outs.values():
        assert torch.equal(out.view(torch.uint8), want)
    store = _values(gen, (37 * 32 * 32 + 1,), torch.bfloat16)
    bad = store[1:].view(37, 32, 32)          # 2 bytes past an aligned base
    out = fn.rhs(v)
    grid = fn.route(v, out)[1]
    assert lib.xsmm_bcsc_union_compact(
        bad.data_ptr(), fn.gmap.data_ptr(), out.data_ptr(), fn.nsg, fn.U,
        fn.bk, fn.bn, fn.nblocks, 2, pk._CP_ROUTES["bulk"], grid,
        torch.cuda.current_stream().cuda_stream) != 0


# blockings the union's wgmma kernel serves with bf16 operands (bk % 16 ==
# 0, bn % 8 == 0, bn | 128): whole 32-deep, 32-wide blocks, and the narrow
# ones (16-deep slices; the fused form's value boxes 8 or 16 wide)
UNION_WGMMA_BLOCKINGS = [(32, 32), (64, 128), (128, 128)]
UNION_MMA_BLOCKINGS = [(16, 64), (16, 8), (32, 16), (48, 32)]
FORMS = {"fused": False, "compacted": True}


def union_plan(gen, m, k, n, bk, bn, o_dt, form, seed, **kw):
    """A bf16 union plan on the card in one form, with block group 0 empty,
    and its operands; its route is the one spmm_path names for the
    blocking."""
    indptr, indices = pattern(k, n, bk, bn, 0.3, seed=seed,
                              empty_cols=range(128 // bn))
    fn = pk.build_bcsc_spmm_union(GemmShape(m, n, k, BF16, BF16, o_dt),
                                  SpgemmConfig(1, bk, bn), indptr, indices,
                                  "cuda", compact=FORMS[form], **kw)
    assert fn.path == pk.spmm_path(torch.bfloat16, bk, bn, union=True)
    a = rand(gen, (m, k), BF16)
    v = rand(gen, (len(indices), bk, bn), BF16)
    return fn, a, v


def union_mma(gen, m, k, n, bk, *args, **kw):
    """union_plan at a narrow blocking, k cut to a multiple of bk."""
    fn, a, v = union_plan(gen, m, depth(bk, k), n, bk, *args, **kw)
    assert fn.path == "wgmma"
    return fn, a, v


def union_wgmma(gen, *args, **kw):
    fn, a, v = union_plan(gen, *args, **kw)
    assert fn.path == "wgmma"
    return fn, a, v


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("o_dt", [F32, BF16])
@pytest.mark.parametrize("m", [1, 37, 200])
@pytest.mark.parametrize("bk,bn", UNION_MMA_BLOCKINGS)
def test_bcsc_spmm_union_mma(gen, bk, bn, m, o_dt, form):
    """The union's wgmma kernel at the narrow blockings, both forms,
    ragged m (rows past m neither computed into nor stored), an empty group
    (all slots dead: zeros), both output types."""
    fn, a, v = union_mma(gen, m, 512, 384, bk, bn, o_dt, form, seed=m + bk)
    got = on_route("bcsc_spmm_union", "wgmma", fn, a, v)
    same(fn.plain(a, v), got, tol(BF16, o_dt))
    assert bool((got[:, :128] == 0).all())


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("u_align", [4, 16])
@pytest.mark.parametrize("bk,bn", UNION_MMA_BLOCKINGS)
def test_bcsc_spmm_union_mma_pad_slots(gen, bk, bn, u_align, form):
    """u_align pads each group's union with dead slots (union4a): they are
    skipped, block-uniformly."""
    fn, a, v = union_mma(gen, 100, 512, 384, bk, bn, F32, form, seed=u_align,
                         u_align=u_align)
    same(fn.plain(a, v), on_route("bcsc_spmm_union", "wgmma", fn, a, v),
         1e-4)


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("o_dt", [F32, BF16])
def test_bcsc_spmm_union_mma_streaming(gen, o_dt, form):
    """m = 32768 (256 row tiles) through a 0.2-density pattern of 16 x 64
    blocks, on wgmma."""
    indptr, indices = pattern(1024, 1024, 16, 64, 0.2, seed=3)
    fn = pk.build_bcsc_spmm_union(GemmShape(32768, 1024, 1024, BF16, BF16,
                                            o_dt), SpgemmConfig(1, 16, 64),
                                  indptr, indices, "cuda",
                                  compact=FORMS[form])
    assert fn.path == "wgmma"
    a = rand(gen, (32768, 1024), BF16)
    v = rand(gen, (len(indices), 16, 64), BF16)
    same(fn.plain(a, v), on_route("bcsc_spmm_union", "wgmma", fn, a, v),
         tol(BF16, o_dt))


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("o_dt", [F32, BF16])
@pytest.mark.parametrize("m", [1, 37, 200, 1000])
@pytest.mark.parametrize("bk,bn", UNION_WGMMA_BLOCKINGS)
def test_bcsc_spmm_union_wgmma(gen, bk, bn, m, o_dt, form):
    """The union's wgmma kernel at each blocking that takes it (boxes of 32
    columns at 32 x 32 in the fused form, of 64 otherwise), both forms,
    ragged m, an empty group (all slots dead: zeros), both output types;
    the launch counted on route wgmma."""
    fn, a, v = union_wgmma(gen, m, 512, 384, bk, bn, o_dt, form,
                           seed=m + bk + bn)
    got = on_route("bcsc_spmm_union", "wgmma", fn, a, v)
    same(fn.plain(a, v), got, tol(BF16, o_dt))
    assert bool((got[:, :128] == 0).all())


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("u_align", [4, 16])
@pytest.mark.parametrize("bk,bn", [(32, 32), (64, 128)])
def test_bcsc_spmm_union_wgmma_pad_slots(gen, bk, bn, u_align, form):
    """u_align pads each group's union with dead slots (union4a; 16 is the
    full depth at bk = 32, union4d; at bk = 64 the depth is capped at k /
    bk): they are skipped, block-uniformly."""
    fn, a, v = union_wgmma(gen, 100, 512, 384, bk, bn, F32, form,
                           seed=u_align + bk, u_align=u_align)
    same(fn.plain(a, v), on_route("bcsc_spmm_union", "wgmma", fn, a, v),
         1e-4)


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("o_dt", [F32, BF16])
@pytest.mark.parametrize("bk,bn", [(32, 32), (64, 128)])
def test_bcsc_spmm_union_wgmma_streaming(gen, bk, bn, o_dt, form):
    """m = 32768 (256 row tiles) through a 0.2-density pattern, stream20's
    shape at 32 x 32."""
    indptr, indices = pattern(1024, 1024, bk, bn, 0.2, seed=3)
    fn = pk.build_bcsc_spmm_union(GemmShape(32768, 1024, 1024, BF16, BF16,
                                            o_dt), SpgemmConfig(1, bk, bn),
                                  indptr, indices, "cuda",
                                  compact=FORMS[form])
    assert fn.path == "wgmma"
    a = rand(gen, (32768, 1024), BF16)
    v = rand(gen, (len(indices), bk, bn), BF16)
    same(fn.plain(a, v), on_route("bcsc_spmm_union", "wgmma", fn, a, v),
         tol(BF16, o_dt))


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("o_dt", [F32, BF16])
def test_bcsc_spmm_union_wgmma_clustered(gen, o_dt, form):
    """bench.py's two-family pattern in bf16: bf16 out clusters (the column
    restore folded into the store), f32 out keeps the plain plan."""
    indptr, indices = cluster_pattern()
    fn = pk.build_bcsc_spmm_union(GemmShape(96, 1024, 2048, BF16, BF16,
                                            o_dt), SpgemmConfig(1, 32, 32),
                                  indptr, indices, "cuda",
                                  compact=FORMS[form])
    assert fn.path == "wgmma" and fn.clustered == (o_dt == BF16)
    a = rand(gen, (96, 2048), BF16)
    v = rand(gen, (len(indices), 32, 32), BF16)
    same(fn.plain(a, v), on_route("bcsc_spmm_union", "wgmma", fn, a, v),
         tol(BF16, o_dt))


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("bk,bn,route", [(32, 32, "wgmma"),
                                         (64, 128, "wgmma"),
                                         (16, 64, "wgmma"),
                                         (16, 8, "wgmma")])
def test_bcsc_spmm_union_unaligned_views(gen, bk, bn, route, form):
    """A and the values 6 and 2 bytes past a 16-byte boundary: copied into
    fresh tensors for the kernels' 16-byte staging (TMA on wgmma)."""
    m, k, n = 100, 256, 256
    indptr, indices = pattern(k, n, bk, bn, 0.4, seed=9)
    fn = pk.build_bcsc_spmm_union(GemmShape(m, n, k, BF16, BF16, F32),
                                  SpgemmConfig(1, bk, bn), indptr, indices,
                                  "cuda", compact=FORMS[form])
    assert fn.path == route
    a = rand(gen, (m * k + 3,), BF16)[3:].view(m, k)
    v = rand(gen, (len(indices) * bk * bn + 1,), BF16)[1:].view(
        len(indices), bk, bn)
    assert a.data_ptr() % 16 == 6 and v.data_ptr() % 16 == 2
    same(fn.plain(a, v), on_route("bcsc_spmm_union", route, fn, a, v),
         1e-4)


def _twice_bit_for_bit(fn, a, v):
    x, y = fn(a, v), fn(a, v)
    torch.cuda.synchronize()
    assert torch.equal(x, y)


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("bk,bn", UNION_MMA_BLOCKINGS)
def test_bcsc_spmm_union_mma_deterministic(gen, bk, bn, form):
    """One writer per output tile, no atomics: two runs bit for bit."""
    _twice_bit_for_bit(*union_mma(gen, 300, 512, 384, bk, bn, F32, form,
                                  seed=bk))


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("o_dt", [F32, BF16])
@pytest.mark.parametrize("bk,bn", UNION_WGMMA_BLOCKINGS)
def test_bcsc_spmm_union_wgmma_deterministic(gen, bk, bn, o_dt, form):
    """One writer per output tile, no atomics, the slots summed in order:
    two runs bit for bit."""
    _twice_bit_for_bit(*union_wgmma(gen, 3000, 512, 384, bk, bn, o_dt, form,
                                    seed=bk + bn))


def _nan_in_block_row_0(gen, bk, bn, form, route):
    """A NaN in A's block row 0, read by a live slot of group 1 (its union
    holds block row 0): NaN across that group's row, as the plain version
    (the slot's dead blocks are zeros, multiplied). Group 0 (no block: all
    slots dead) and group 2 (block row 0 not in its union) stay finite:
    their pad slots, which the plain version multiplies with krows 0, are
    skipped (the recorded divergence of the union kernels)."""
    m, k, n = 70, depth(bk, 256), 384
    indptr, indices = pattern(k, n, bk, bn, 0.3, seed=bk,
                              empty_cols=range(128 // bn))
    # block row 0 in group 1's union and not in group 2's
    keep = np.zeros((n // bn, k // bk), bool)
    for j, (s0, s1) in enumerate(zip(indptr[:-1], indptr[1:])):
        keep[j, indices[s0:s1]] = True
    keep[128 // bn, 0] = True
    keep[256 // bn:, 0] = False
    indptr = np.concatenate([[0], np.cumsum(keep.sum(axis=1))]).astype(
        np.int32)
    indices = np.nonzero(keep)[1].astype(np.int32)
    fn = pk.build_bcsc_spmm_union(GemmShape(m, n, k, BF16, BF16, F32),
                                  SpgemmConfig(1, bk, bn), indptr, indices,
                                  "cuda", cluster=False, compact=FORMS[form])
    assert fn.path == route
    a, v = rand(gen, (m, k), BF16), rand(gen, (len(indices), bk, bn), BF16)
    a[5, 3] = float("nan")
    got = on_route("bcsc_spmm_union", route, fn, a, v)
    want = fn.plain(a, v)
    torch.cuda.synchronize()
    nan = torch.zeros_like(got, dtype=torch.bool)
    nan[5, 128:256] = True
    assert torch.equal(torch.isnan(got), nan)
    assert bool(torch.isnan(want[5, 128:256]).all())
    keep_ = ~torch.isnan(want)
    check(want[keep_].double().cpu().numpy(),
          got[keep_].double().cpu().numpy(), margin=1e-4)


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("bk,bn", UNION_MMA_BLOCKINGS)
def test_bcsc_spmm_union_mma_nan_in_block_row_0(gen, bk, bn, form):
    """_nan_in_block_row_0 on the wgmma kernel at the narrow blockings."""
    _nan_in_block_row_0(gen, bk, bn, form, "wgmma")


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("bk,bn", UNION_WGMMA_BLOCKINGS)
def test_bcsc_spmm_union_wgmma_nan_in_block_row_0(gen, bk, bn, form):
    """_nan_in_block_row_0 on the wgmma kernel."""
    _nan_in_block_row_0(gen, bk, bn, form, "wgmma")


# ---------------------------------------------------------------------------
# the f32 route on TMA-fed FMA tiles ("tma_fma"), and the FMA kernels
# ("fma") at the blockings the rule sends to them
# ---------------------------------------------------------------------------


def on_route(name, route, fn, *args):
    """fn(*args), which must launch `name` once, on `route` alone."""
    before = dict(pk.path_launches[name])
    out = launched(name, fn, *args)
    after = pk.path_launches[name]
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == route) for r in after}
    return out


def test_tf32_is_off(gen):
    """f32 means f32 here: the module turns TF32 off for the plain
    versions' matmuls, and nothing turns it back on."""
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("o_dt", [F32, BF16])
@pytest.mark.parametrize("m", [1, 37, 200, 32768])
@pytest.mark.parametrize("bk,bn", MMA_BLOCKINGS)
def test_bcsc_spmm_tma_fma(gen, bk, bn, m, o_dt):
    """The f32 scheduled kernel at the tensor-core tests' blockings and m:
    ragged and streaming m, an empty block column (its zero-block step
    multiplied), both output types."""
    k, n = 512, 384
    indptr, indices = pattern(k, n, bk, bn, 0.3, seed=m + bk,
                              empty_cols=(1,))
    fn = pk.build_bcsc_spmm(GemmShape(m, n, k, F32, F32, o_dt),
                            SpgemmConfig(1, bk, bn), indptr, indices, "cuda")
    assert fn.path == "tma_fma"
    a, v = rand(gen, (m, k)), rand(gen, (len(indices), bk, bn))
    got = on_route("bcsc_spmm", "tma_fma", fn, a, v)
    same(fn.plain(a, v), got, tol(F32, o_dt))
    assert bool((got[:, bn:2 * bn] == 0).all())


@pytest.mark.parametrize("m,k,n,bk,bn", [
    (77, 384, 256, 48, 32), (65, 96, 64, 12, 8), (130, 256, 320, 16, 80),
    (40, 256, 512, 32, 256)])
def test_bcsc_spmm_tma_fma_blockings(gen, m, k, n, bk, bn):
    """Blocks deeper than a slice and not a whole number of them (48),
    shallower ones (12, 16), narrower than a tile (8) and wider (80: a
    64-column chunk, columns past bn zero-filled; 256: two chunks)."""
    indptr, indices = pattern(k, n, bk, bn, 0.4, seed=bk * bn,
                              empty_cols=(0,))
    fn = pk.build_bcsc_spmm(GemmShape(m, n, k), SpgemmConfig(1, bk, bn),
                            indptr, indices, "cuda")
    a, v = rand(gen, (m, k)), rand(gen, (len(indices), bk, bn))
    got = on_route("bcsc_spmm", "tma_fma", fn, a, v)
    same(fn.plain(a, v), got, 1e-5)
    assert bool((got[:, :bn] == 0).all())


@pytest.mark.parametrize("o_dt", [F32, BF16])
@pytest.mark.parametrize("m", [37, 32768])
def test_bcsc_spmm_super_tma_fma(gen, m, o_dt):
    k, n = 512, 384
    indptr, indices = pattern(k, n, 128, 128, 0.6, seed=m, empty_cols=(2,))
    fn = pk.build_bcsc_spmm_super(GemmShape(m, n, k, F32, F32, o_dt),
                                  indptr, indices, "cuda")
    assert fn.path == "tma_fma"
    a, sup = rand(gen, (m, k)), rand(gen, (len(indices), 128, 128))
    got = on_route("bcsc_spmm_super", "tma_fma", fn, a, sup)
    same(fn.plain(a, sup), got, tol(F32, o_dt))
    assert bool((got[:, 256:] == 0).all())


@pytest.mark.parametrize("bk,bn", MMA_BLOCKINGS)
def test_bcsc_spmm_tma_fma_nan_in_block_row_0(gen, bk, bn):
    """An empty block column multiplies A's block row 0 by the zero block:
    a NaN there gives NaN, as the plain version and the reference."""
    m, k, n = 70, 256, 256
    indptr, indices = pattern(k, n, bk, bn, 0.4, seed=bk, empty_cols=(0,))
    fn = pk.build_bcsc_spmm(GemmShape(m, n, k), SpgemmConfig(1, bk, bn),
                            indptr, indices, "cuda")
    a, v = rand(gen, (m, k)), rand(gen, (len(indices), bk, bn))
    a[5, 3] = float("nan")
    got = on_route("bcsc_spmm", "tma_fma", fn, a, v)
    want = fn.plain(a, v)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[5, :bn]).all())
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    keep = ~torch.isnan(want)
    check(want[keep].double().cpu().numpy(), got[keep].double().cpu().numpy(),
          margin=1e-5)
    assert bool((got[torch.arange(m, device="cuda") != 5, :bn] == 0).all())


def test_bcsc_spmm_tma_fma_empty_store(gen):
    """A pattern with no block: every column is one zero-block step, read
    from past the value map's extent (a map over A's memory), never from
    the empty store."""
    m, k, n = 50, 128, 256
    indptr = np.zeros(n // 32 + 1, np.int32)
    fn = pk.build_bcsc_spmm(GemmShape(m, n, k), SpgemmConfig(1, 32, 32),
                            indptr, np.zeros(0, np.int32), "cuda")
    assert fn.path == "tma_fma"
    got = on_route("bcsc_spmm", "tma_fma", fn, rand(gen, (m, k)),
                   torch.zeros(0, 32, 32, device="cuda"))
    torch.cuda.synchronize()
    assert bool((got == 0).all())


@pytest.mark.parametrize("union", [False, True])
def test_bcsc_spmm_tma_fma_deterministic(gen, union):
    """One writer per output tile, no atomics: two runs bit for bit."""
    indptr, indices = pattern(512, 384, 32, 32, 0.3, seed=4)
    cfg = SpgemmConfig(1, 32, 32)
    build = pk.build_bcsc_spmm_union if union else pk.build_bcsc_spmm
    fn = build(GemmShape(3000, 384, 512), cfg, indptr, indices, "cuda")
    assert fn.path == "tma_fma"
    a, v = rand(gen, (3000, 512)), rand(gen, (len(indices), 32, 32))
    x, y = fn(a, v), fn(a, v)
    torch.cuda.synchronize()
    assert torch.equal(x, y)


@pytest.mark.parametrize("form", list(FORMS) + ["scheduled"])
def test_bcsc_spmm_tma_fma_offset_view(gen, form):
    """A and the values 4 and 8 bytes past a 16-byte boundary: copied into
    fresh tensors first, and still the tma_fma kernel."""
    m, k, n, bk, bn = 100, 256, 256, 32, 32
    indptr, indices = pattern(k, n, bk, bn, 0.4, seed=9)
    cfg = SpgemmConfig(1, bk, bn)
    if form == "scheduled":
        fn, name = pk.build_bcsc_spmm(GemmShape(m, n, k), cfg, indptr,
                                      indices, "cuda"), "bcsc_spmm"
    else:
        fn, name = pk.build_bcsc_spmm_union(
            GemmShape(m, n, k), cfg, indptr, indices, "cuda",
            compact=FORMS[form]), "bcsc_spmm_union"
    a = rand(gen, (m * k + 1,))[1:].view(m, k)
    v = rand(gen, (len(indices) * bk * bn + 2,))[2:].view(len(indices), bk,
                                                          bn)
    assert a.data_ptr() % 16 == 4 and v.data_ptr() % 16 == 8
    same(fn.plain(a, v), on_route(name, "tma_fma", fn, a, v), 1e-5)


# the union's tma_fma blockings (bn >= 32: at most four value blocks a
# group), a slice-deep and a shallower and deeper block among them
UNION_TMA_BLOCKINGS = [(32, 32), (16, 64), (64, 128), (48, 32), (12, 64)]


def union_f32(gen, m, k, n, bk, bn, o_dt, form, seed, **kw):
    """An f32 union plan on the card in one form, on tma_fma, with block
    group 0 empty, and its operands."""
    indptr, indices = pattern(k, n, bk, bn, 0.3, seed=seed,
                              empty_cols=range(128 // bn))
    fn = pk.build_bcsc_spmm_union(GemmShape(m, n, k, F32, F32, o_dt),
                                  SpgemmConfig(1, bk, bn), indptr, indices,
                                  "cuda", compact=FORMS[form], **kw)
    assert fn.path == "tma_fma"
    return fn, rand(gen, (m, k)), rand(gen, (len(indices), bk, bn))


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("o_dt", [F32, BF16])
@pytest.mark.parametrize("m", [1, 37, 200, 32768])
@pytest.mark.parametrize("bk,bn", UNION_TMA_BLOCKINGS)
def test_bcsc_spmm_union_tma_fma(gen, bk, bn, m, o_dt, form):
    """The f32 union at every blocking the route takes, both forms, ragged
    and streaming m, an empty group (all slots dead: zeros), both output
    types."""
    fn, a, v = union_f32(gen, m, 384, 384, bk, bn, o_dt, form, m + bk)
    got = on_route("bcsc_spmm_union", "tma_fma", fn, a, v)
    same(fn.plain(a, v), got, tol(F32, o_dt))
    assert bool((got[:, :128] == 0).all())


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("u_align", [4, 12])
def test_bcsc_spmm_union_tma_fma_pad_slots(gen, u_align, form):
    """u_align pads each group's union with dead slots (12: the full depth
    at k = 384, union4d); they are skipped, block-uniformly."""
    fn, a, v = union_f32(gen, 100, 384, 384, 32, 32, F32, form, u_align,
                         u_align=u_align)
    same(fn.plain(a, v), on_route("bcsc_spmm_union", "tma_fma", fn, a, v),
         1e-5)


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("o_dt", [F32, BF16])
def test_bcsc_spmm_union_tma_fma_clustered(gen, o_dt, form):
    """bench.py's two-family pattern in f32: clustered (the H100 gate is 3
    panels for f32 in), the column restore folded into the store."""
    indptr, indices = cluster_pattern()
    fn = pk.build_bcsc_spmm_union(GemmShape(96, 1024, 2048, F32, F32, o_dt),
                                  SpgemmConfig(1, 32, 32), indptr, indices,
                                  "cuda", compact=FORMS[form])
    assert fn.path == "tma_fma" and fn.clustered
    a, v = rand(gen, (96, 2048)), rand(gen, (len(indices), 32, 32))
    same(fn.plain(a, v), on_route("bcsc_spmm_union", "tma_fma", fn, a, v),
         tol(F32, o_dt))


@pytest.mark.parametrize("form", list(FORMS))
def test_bcsc_spmm_union_tma_fma_nan_in_block_row_0(gen, form):
    """A NaN in A's block row 0 read by a live slot of group 1: NaN across
    that group's row (the slot's dead blocks, zero-filled, are multiplied),
    as the plain version; groups whose unions lack block row 0 stay
    finite (their pad slots are skipped)."""
    m, k, n, bk, bn = 70, 256, 384, 32, 32
    indptr, indices = pattern(k, n, bk, bn, 0.3, seed=bk,
                              empty_cols=range(128 // bn))
    keep = np.zeros((n // bn, k // bk), bool)
    for j, (s0, s1) in enumerate(zip(indptr[:-1], indptr[1:])):
        keep[j, indices[s0:s1]] = True
    keep[128 // bn, 0] = True
    keep[256 // bn:, 0] = False
    indptr = np.concatenate([[0], np.cumsum(keep.sum(axis=1))]).astype(
        np.int32)
    indices = np.nonzero(keep)[1].astype(np.int32)
    fn = pk.build_bcsc_spmm_union(GemmShape(m, n, k), SpgemmConfig(1, bk, bn),
                                  indptr, indices, "cuda", cluster=False,
                                  compact=FORMS[form])
    a, v = rand(gen, (m, k)), rand(gen, (len(indices), bk, bn))
    a[5, 3] = float("nan")
    got = on_route("bcsc_spmm_union", "tma_fma", fn, a, v)
    want = fn.plain(a, v)
    torch.cuda.synchronize()
    nan = torch.zeros_like(got, dtype=torch.bool)
    nan[5, 128:256] = True
    assert torch.equal(torch.isnan(got), nan)
    assert bool(torch.isnan(want[5, 128:256]).all())
    keep_ = ~torch.isnan(want)
    check(want[keep_].double().cpu().numpy(),
          got[keep_].double().cpu().numpy(), margin=1e-5)


# blockings the rule leaves to the FMA kernels: f32 blocks whose depth or
# rows are not whole 16-byte units, bf16 blocks that are not whole k16 steps
FMA_BLOCKINGS = [(F32, 6, 32), (F32, 2, 2), (F32, 32, 30), (BF16, 8, 8),
                 (BF16, 4, 48)]


@pytest.mark.parametrize("o_dt", [F32, BF16])
@pytest.mark.parametrize("m", [1, 37, 200, 32768])
@pytest.mark.parametrize("a_dt,bk,bn", FMA_BLOCKINGS)
def test_bcsc_spmm_fma_route(gen, a_dt, bk, bn, m, o_dt):
    """The scheduled FMA kernel where the rule sends it, at the tma_fma
    tests' m: ragged and streaming m, an empty block column."""
    k, n = 192, 480
    indptr, indices = pattern(k, n, bk, bn, 0.3, seed=m + bk,
                              empty_cols=(1,))
    fn = pk.build_bcsc_spmm(GemmShape(m, n, k, a_dt, a_dt, o_dt),
                            SpgemmConfig(1, bk, bn), indptr, indices, "cuda")
    assert fn.path == "fma"
    a, v = rand(gen, (m, k), a_dt), rand(gen, (len(indices), bk, bn), a_dt)
    got = on_route("bcsc_spmm", "fma", fn, a, v)
    same(fn.plain(a, v), got, tol(a_dt, o_dt))
    assert bool((got[:, bn:2 * bn] == 0).all())


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("m", [1, 37, 32768])
@pytest.mark.parametrize("a_dt,bk,bn", [(F32, 16, 8), (F32, 32, 16),
                                        (F32, 6, 32), (BF16, 8, 8)])
def test_bcsc_spmm_union_fma_route(gen, a_dt, bk, bn, m, form):
    """The union's FMA kernel where the rule sends it: f32 unions of more
    than four value blocks a group (16 x 8, 32 x 16), f32 blocks not whole
    16-byte units deep (6 x 32), bf16 8 x 8; both forms, an empty group."""
    k, n = 384, 384
    indptr, indices = pattern(k, n, bk, bn, 0.3, seed=m + bn,
                              empty_cols=range(128 // bn))
    fn = pk.build_bcsc_spmm_union(GemmShape(m, n, k, a_dt, a_dt, F32),
                                  SpgemmConfig(1, bk, bn), indptr, indices,
                                  "cuda", compact=FORMS[form])
    assert fn.path == "fma"
    a, v = rand(gen, (m, k), a_dt), rand(gen, (len(indices), bk, bn), a_dt)
    got = on_route("bcsc_spmm_union", "fma", fn, a, v)
    same(fn.plain(a, v), got, tol(a_dt, F32))
    assert bool((got[:, :128] == 0).all())


def densify_route(bn, dtype):
    """The densifier's route for 16-byte-aligned operands: 16-byte units
    where a tile row is whole units, elements otherwise."""
    return "vector" if (bn * dtype.itemsize) % 16 == 0 else "element"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8, torch.float64])
@pytest.mark.parametrize("k,n,bk,bn", [(128, 256, 32, 32), (96, 80, 8, 16),
                                       (64, 64, 4, 4), (1024, 1024, 32, 32),
                                       (65552, 32, 16, 16)])
def test_bcsc_densify_exact(gen, dtype, k, n, bk, bn):
    """Byte-equal to the plain version, one launch, for element sizes 1-8
    on both routes (bn = 4 in int8 and bf16: element units) and for k past
    65,535 rows."""
    indptr, indices = pattern(k, n, bk, bn, 0.4, seed=k, empty_cols=(0,))
    shape = GemmShape(8, n, k)
    fn = pk.build_bcsc_densify(shape, SpgemmConfig(1, bk, bn), indptr,
                               indices, "cuda")
    v = (torch.randn(len(indices), bk, bn, generator=gen, device="cuda")
         * 50).to(dtype)
    got = launched("bcsc_densify", fn, v)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (k, n)
    assert fn.route(v, got) == densify_route(bn, dtype)
    assert torch.equal(fn.plain(v), got)


def test_bcsc_densify_stream_pattern(gen):
    """The streaming case's pattern (k = n = 1024, 32 x 32 blocks, density
    0.2, bf16) takes the vector route, byte-equal to the plain version."""
    indptr, indices = pattern(1024, 1024, 32, 32, 0.2, seed=2)
    fn = pk.build_bcsc_densify(GemmShape(8, 1024, 1024),
                               SpgemmConfig(1, 32, 32), indptr, indices,
                               "cuda")
    v = rand(gen, (len(indices), 32, 32), BF16)
    got = launched("bcsc_densify", fn, v)
    torch.cuda.synchronize()
    assert fn.route(v, got) == "vector"
    assert torch.equal(fn.plain(v).view(torch.int16), got.view(torch.int16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8, torch.float64])
def test_bcsc_densify_values_off_alignment(gen, dtype):
    """A contiguous values view one element past a 16-byte boundary takes
    the element route (it is not copied), byte-equal to the plain
    version."""
    k, n, bk, bn = 128, 256, 32, 32
    indptr, indices = pattern(k, n, bk, bn, 0.4, seed=5, empty_cols=(2,))
    fn = pk.build_bcsc_densify(GemmShape(8, n, k), SpgemmConfig(1, bk, bn),
                               indptr, indices, "cuda")
    base = (torch.randn(len(indices) * bk * bn + 1, generator=gen,
                        device="cuda") * 50).to(dtype)
    v = base[1:].view(len(indices), bk, bn)
    assert v.is_contiguous() and v.data_ptr() % 16
    got = launched("bcsc_densify", fn, v)
    torch.cuda.synchronize()
    assert fn.route(v, got) == "element"
    assert torch.equal(fn.plain(v), got)


@pytest.mark.parametrize("bn", [4, 32])
def test_bcsc_densify_all_zero_pattern(gen, bn):
    """No block at all: zeros on either route (bf16, bn = 4 element units,
    bn = 32 vector units), written over memory that held other values."""
    k, n, bk = 64, 128, 16
    fn = pk.build_bcsc_densify(GemmShape(8, n, k), SpgemmConfig(1, bk, bn),
                               np.zeros(n // bn + 1, np.int32),
                               np.zeros(0, np.int32), "cuda")
    junk = torch.full((k, n), 7.0, device="cuda", dtype=torch.bfloat16)
    del junk                    # its block goes back to the allocator
    v = torch.zeros(0, bk, bn, device="cuda", dtype=torch.bfloat16)
    got = launched("bcsc_densify", fn, v)
    torch.cuda.synchronize()
    assert fn.route(v, got) == densify_route(bn, torch.bfloat16)
    assert got.shape == (k, n) and not bool(got.any())


def test_bcsc_densify_refuses_16_byte_elements(gen):
    """A CUDA tensor the kernel does not take raises: complex128 values
    (16-byte elements) never reach the plain version."""
    indptr, indices = pattern(64, 64, 8, 8, 0.5)
    fn = pk.build_bcsc_densify(GemmShape(8, 64, 64), SpgemmConfig(1, 8, 8),
                               indptr, indices, "cuda")
    v = torch.zeros(len(indices), 8, 8, device="cuda",
                    dtype=torch.complex128)
    before = pk.launches["bcsc_densify"]
    with pytest.raises(ValueError, match="no CUDA kernel"):
        fn(v)
    assert pk.launches["bcsc_densify"] == before


@pytest.mark.parametrize("strategy", po.STRATEGIES)
def test_empty_pattern_is_zero(gen, strategy):
    m, k, n, bk, bn = 40, 128, 256, 32, 32
    kern = xp.create_packed_spgemm_bcsc(
        GemmShape(m, n, k), GemmFlags.BETA_0, SpgemmConfig(1, bk, bn),
        np.zeros(n // bn + 1, np.int32), np.zeros(0, np.int32),
        strategy=strategy, device="cuda")
    got = kern(rand(gen, (m, k)), torch.zeros(0, bk, bn, device="cuda"))
    torch.cuda.synchronize()
    assert got.shape == (m, n) and bool((got == 0).all())


KERNEL_OF = {"pallas": "bcsc_spmm", "super": "bcsc_spmm_super",
             "dense": "bcsc_densify"}


@pytest.mark.parametrize("a_dt,o_dt", DTYPES)
@pytest.mark.parametrize("strategy", ("auto",) + po.STRATEGIES)
def test_create_on_the_card(gen, strategy, a_dt, o_dt):
    """Every strategy through the public entry point on CUDA tensors:
    against float64, with c (beta=1), and its kernel launched."""
    m, k, n, bk, bn = 100, 256, 384, 32, 32
    indptr, indices = pattern(k, n, bk, bn, 0.2, seed=1, empty_cols=(3,))
    shape = GemmShape(m, n, k, a_dt, a_dt, o_dt)
    kern = xp.create_packed_spgemm_bcsc(
        shape, GemmFlags.NONE, SpgemmConfig(1, bk, bn), indptr, indices,
        strategy=strategy)
    a, v = rand(gen, (m, k), a_dt), rand(gen, (len(indices), bk, bn), a_dt)
    c = rand(gen, (m, n))
    bd = pk.build_bcsc_densify(shape, SpgemmConfig(1, bk, bn), indptr,
                               indices, "cuda").plain(v)
    want = a.double() @ bd.double()
    name = (KERNEL_OF.get(strategy, "bcsc_spmm_union")
            if strategy not in ("auto", "sparse") else None)
    before = dict(pk.launches)
    got = kern(a, v)
    torch.cuda.synchronize()
    if name is not None:
        assert pk.launches[name] == before[name] + 1
    assert got.dtype == TORCH[o_dt] and got.is_cuda
    check(want.cpu().numpy(), got.double().cpu().numpy(),
          margin=tol(a_dt, o_dt))
    got_c = kern(a, v, c)
    check((want + c.double()).cpu().numpy(), got_c.double().cpu().numpy(),
          margin=tol(a_dt, o_dt))


def test_int8_dense_on_the_card(gen):
    m, k, n, bk, bn = 32, 64, 64, 8, 8
    indptr, indices = pattern(k, n, bk, bn, 0.5, seed=3)
    shape = GemmShape(m, n, k, I8, I8, I32, I32)
    a = torch.randint(-50, 50, (m, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    v = torch.randint(-50, 50, (len(indices), bk, bn), generator=gen,
                      device="cuda", dtype=torch.int8)
    outs = [xp.create_packed_spgemm_bcsc(
        shape, GemmFlags.BETA_0, SpgemmConfig(1, bk, bn), indptr, indices,
        strategy=s)(a, v) for s in ("dense", "sparse")]
    bd = pk.build_bcsc_densify(shape, SpgemmConfig(1, bk, bn), indptr,
                               indices, "cuda")(v)
    want = (a.double() @ bd.double()).round().to(torch.int32)
    for got in outs:
        assert got.dtype == torch.int32 and torch.equal(want, got)


def test_operands_must_share_the_plan_device(gen):
    indptr, indices = pattern(64, 128, 32, 32, 0.5)
    fn = pk.build_bcsc_spmm(GemmShape(8, 128, 64), SpgemmConfig(1, 32, 32),
                            indptr, indices, "cuda")
    with pytest.raises(ValueError, match="different devices"):
        fn(torch.zeros(8, 64), torch.zeros(len(indices), 32, 32))
