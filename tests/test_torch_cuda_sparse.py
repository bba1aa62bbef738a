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
patterns exact. bf16 operands at blockings of whole k16 steps and 16-byte
rows (32 x 32, 16 x 64, 128 x 128) run the tensor-core kernel, at the same
margins: its bf16 products are exact in the f32 accumulator.
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


# blockings the tensor-core kernel serves with bf16 operands (bk % 16 == 0,
# bn % 8 == 0)
MMA_BLOCKINGS = [(32, 32), (16, 64), (128, 128)]


@pytest.mark.parametrize("o_dt", [F32, BF16])
@pytest.mark.parametrize("m", [1, 37, 200, 32768])
@pytest.mark.parametrize("bk,bn", MMA_BLOCKINGS)
def test_bcsc_spmm_mma(gen, bk, bn, m, o_dt):
    """The tensor-core kernel: ragged and streaming m, an empty block
    column (its zero-block step multiplied), both output types."""
    k, n = 512, 384
    indptr, indices = pattern(k, n, bk, bn, 0.3, seed=m + bk,
                              empty_cols=(1,))
    shape = GemmShape(m, n, k, BF16, BF16, o_dt)
    fn = pk.build_bcsc_spmm(shape, SpgemmConfig(1, bk, bn), indptr, indices,
                            "cuda")
    assert fn.path == "mma"
    a, v = rand(gen, (m, k), BF16), rand(gen, (len(indices), bk, bn), BF16)
    got = launched("bcsc_spmm", fn, a, v)
    same(fn.plain(a, v), got, tol(BF16, o_dt))
    assert bool((got[:, bn:2 * bn] == 0).all())


@pytest.mark.parametrize("o_dt", [F32, BF16])
@pytest.mark.parametrize("m", [37, 32768])
def test_bcsc_spmm_super_mma(gen, m, o_dt):
    k, n = 512, 384
    indptr, indices = pattern(k, n, 128, 128, 0.6, seed=m, empty_cols=(2,))
    shape = GemmShape(m, n, k, BF16, BF16, o_dt)
    fn = pk.build_bcsc_spmm_super(shape, indptr, indices, "cuda")
    assert fn.path == "mma"
    a = rand(gen, (m, k), BF16)
    sup = rand(gen, (len(indices), 128, 128), BF16)
    got = launched("bcsc_spmm_super", fn, a, sup)
    same(fn.plain(a, sup), got, tol(BF16, o_dt))
    assert bool((got[:, 256:] == 0).all())


@pytest.mark.parametrize("bk,bn", MMA_BLOCKINGS)
def test_bcsc_spmm_mma_nan_in_block_row_0(gen, bk, bn):
    """An empty block column multiplies A's block row 0 by the zero block,
    as the reference does: a NaN there gives NaN, as the plain version."""
    m, k, n = 70, 256, 256
    indptr, indices = pattern(k, n, bk, bn, 0.4, seed=bk, empty_cols=(0,))
    fn = pk.build_bcsc_spmm(GemmShape(m, n, k, BF16, BF16, F32),
                            SpgemmConfig(1, bk, bn), indptr, indices, "cuda")
    a, v = rand(gen, (m, k), BF16), rand(gen, (len(indices), bk, bn), BF16)
    a[5, 3] = float("nan")
    got = launched("bcsc_spmm", fn, a, v)
    want = fn.plain(a, v)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[5, :bn]).all())
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    keep = ~torch.isnan(want)
    check(want[keep].double().cpu().numpy(), got[keep].double().cpu().numpy(),
          margin=1e-4)
    assert bool((got[torch.arange(m, device="cuda") != 5, :bn] == 0).all())


@pytest.mark.parametrize("o_dt", [F32, BF16])
def test_bcsc_spmm_mma_unaligned_views(gen, o_dt):
    """A and the values 6 and 2 bytes past a 16-byte boundary: the wrapper
    copies them into fresh tensors for the kernel's 16-byte staging."""
    m, k, n, bk, bn = 100, 256, 256, 32, 32
    indptr, indices = pattern(k, n, bk, bn, 0.4, seed=9)
    fn = pk.build_bcsc_spmm(GemmShape(m, n, k, BF16, BF16, o_dt),
                            SpgemmConfig(1, bk, bn), indptr, indices, "cuda")
    a = rand(gen, (m * k + 3,), BF16)[3:].view(m, k)
    v = rand(gen, (len(indices) * bk * bn + 1,), BF16)[1:].view(
        len(indices), bk, bn)
    assert a.data_ptr() % 16 == 6 and v.data_ptr() % 16 == 2
    got = launched("bcsc_spmm", fn, a, v)
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
    4-byte copy unit and still matches its plain version."""
    indptr, indices = pattern(128, 256, 32, 32, 0.4, seed=5)
    fn = pk.build_bcsc_spmm_union(GemmShape(16, 256, 128), SpgemmConfig(
        1, 32, 32), indptr, indices, "cuda", compact=True)
    store = rand(gen, (len(indices) * 32 * 32 + 1,))
    v = store[1:].view(len(indices), 32, 32)
    assert v.data_ptr() % 16 == 4
    got = fn.compactor(v)
    torch.cuda.synchronize()
    assert torch.equal(got, fn.compactor.plain(v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8, torch.float64])
@pytest.mark.parametrize("k,n,bk,bn", [(128, 256, 32, 32), (96, 80, 8, 16),
                                       (64, 64, 4, 4)])
def test_bcsc_densify_exact(gen, dtype, k, n, bk, bn):
    indptr, indices = pattern(k, n, bk, bn, 0.4, seed=k, empty_cols=(0,))
    shape = GemmShape(8, n, k)
    fn = pk.build_bcsc_densify(shape, SpgemmConfig(1, bk, bn), indptr,
                               indices, "cuda")
    v = (torch.randn(len(indices), bk, bn, generator=gen, device="cuda")
         * 50).to(dtype)
    got = launched("bcsc_densify", fn, v)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (k, n)
    assert torch.equal(fn.plain(v), got)


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
