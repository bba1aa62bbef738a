"""The tensor-core paths of the port, on the CPU: which CUDA kernel a
scheduled/supertile/union BCSC SpMM and a flash forward take (the
predicates that mirror the choice csrc makes: wgmma or the FMA kernels),
the bf16 flash forward's tile of each hd bucket, and the bf16 wrappers at
shapes that reach the tensor-core kernels on the card (the union in both forms,
with pad slots, a clustered plan and ragged m), held against the JAX
package on the same numpy inputs.
The port's wrappers run their plain versions on CPU tensors; the JAX side
runs as its own tests run it (the Pallas kernels in interpret mode).

Tolerances (matdiff normf_rel): 1e-4 for bf16 in / f32 out SpMM (products
exact in f32, sums in another order), 1e-2 for bf16 outputs (one rounding at
another point of the sum), 1e-5 for the LSE.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import libxsmm_torch as xp
from libxsmm_torch.kernels import attention as pa
from libxsmm_torch.kernels import spmm as pk
from libxsmm_torch.matdiff import check
from libxsmm_tpu.descriptor import GemmFlags, GemmShape, SpgemmConfig
from libxsmm_tpu.dtypes import Datatype
from libxsmm_tpu.kernels import attention_pallas as ra
from libxsmm_tpu.ops import sparse as ro

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,bk,bn,want", [
    (BF16, 32, 32, "wgmma"), (BF16, 16, 64, "wgmma"),
    (BF16, 128, 128, "wgmma"), (BF16, 48, 24, "wgmma"),
    (BF16, 16, 8, "wgmma"), (BF16, 64, 256, "wgmma"), (BF16, 8, 8, "fma"),
    (BF16, 4, 48, "fma"), (BF16, 32, 4, "fma"), (BF16, 24, 32, "fma"),
    (F32, 32, 32, "tma_fma"), (F32, 128, 128, "tma_fma"), (F32, 2, 2, "fma"),
    (torch.float16, 32, 32, "fma"), (BF16, 64, 128, "wgmma"),
    (BF16, 32, 96, "wgmma"), (BF16, 48, 32, "wgmma"),
    (BF16, 32, 48, "wgmma")])
def test_spmm_path(dtype, bk, bn, want):
    """bf16 blocks of whole k16 steps and whole 16-byte rows take the
    wgmma kernel, whether or not they are whole 32-wide pieces; f32 (no
    TF32) blocks of whole 16-byte units the TMA-fed FMA kernel; other
    blockings the FMA one."""
    assert pk.spmm_path(dtype, bk, bn) == want


@pytest.mark.parametrize("bk,bn,want", [
    (32, 32, "wgmma"), (128, 128, "wgmma"), (64, 128, "wgmma"),
    (16, 64, "wgmma"), (16, 8, "wgmma"), (48, 32, "wgmma"),
    (32, 16, "wgmma"), (8, 8, "fma")])
def test_spmm_path_union_keeps_mma(bk, bn, want):
    """The k-union takes the route the scheduled SpMM takes at its
    blocking: its own wgmma kernel at every blocking of whole k16 steps and
    16-byte rows (the mma.sync kernels are gone), chosen by blocking
    alone."""
    assert pk.spmm_path(BF16, bk, bn, union=True) == want


@pytest.mark.parametrize("a_dt,bk,bn,want", [
    (xp.Datatype.BF16, 32, 32, "wgmma"), (xp.Datatype.BF16, 16, 64, "wgmma"),
    (xp.Datatype.BF16, 8, 8, "fma"), (xp.Datatype.F32, 32, 32, "tma_fma")])
def test_spmm_wrappers_name_their_path(a_dt, bk, bn, want):
    """The scheduled wrapper names the route of its blocking, the
    supertile wrapper (128 x 128) wgmma in bf16, and the union wrapper at
    the same blocking the same route."""
    k, n = 256, 256
    indptr = np.arange(n // bn + 1, dtype=np.int32)     # one block a column
    indices = np.zeros(n // bn, np.int32)
    shape = xp.GemmShape(40, n, k, a_dt, a_dt, xp.Datatype.F32)
    fn = pk.build_bcsc_spmm(shape, xp.SpgemmConfig(1, bk, bn), indptr,
                            indices, "cpu")
    assert fn.path == want
    sup = pk.build_bcsc_spmm_super(shape, np.array([0, 1, 1], np.int32),
                                   np.zeros(1, np.int32), "cpu")
    assert sup.path == ("wgmma" if a_dt == xp.Datatype.BF16 else "tma_fma")
    union = pk.build_bcsc_spmm_union(shape, xp.SpgemmConfig(1, bk, bn),
                                     indptr, indices, "cpu")
    assert union.path == want


def test_flash_path():
    """bf16 takes the wgmma kernel at every hd, f32 the TMA-fed FMA kernel,
    by dtype alone."""
    for hd in (8, 40, 64, 128, 136, 192, 256):
        assert pa.flash_path(BF16, hd) == "wgmma"
        assert pa.build_flash_attention(2, 128, hd, BF16).path == "wgmma"
        assert pa.flash_path(F32, hd) == "tma_fma"
    assert pa.flash_path(F32) == "tma_fma"
    assert pa.flash_path(BF16) == "wgmma"
    assert pa.build_flash_attention(2, 128, 40, F32).path == "tma_fma"


@pytest.mark.parametrize("hd,hdp", [
    (8, 64), (32, 64), (40, 64), (64, 64), (72, 128), (96, 128), (104, 128),
    (128, 128), (136, 192), (192, 192), (200, 256), (256, 256)])
def test_bf16_flash_configs(hd, hdp):
    """One tile per hd bucket of the wgmma kernel (csrc fw_fwd_bk): 128
    rows against 128-key tiles up to a padded 128, 64-key tiles at 192 and
    256, named in the kernel object's name."""
    want = (128, 128) if hdp <= 128 else (128, 64)
    assert pa._fwd_tile(BF16, hd) == want
    fn = pa.build_flash_attention(2, 256, hd, BF16)
    assert (fn.path, fn.block_q, fn.block_k) == ("wgmma",) + want
    assert fn.name.endswith(f"_wgmma_bk{want[1]}")


def test_f32_flash_configs_keep_their_values():
    """The f32 kernel takes one tile per hd bucket, so f32 names none and
    a block_override only has to tile s."""
    for hd in (40, 128, 256):
        assert pa._fwd_tile(F32, hd) == (None, None)
    fn = pa.build_flash_attention(2, 256, 128, F32, block_override=(32, 32))
    assert fn.path == "tma_fma" and (fn.block_q, fn.block_k) == (None, None)
    assert fn.name == "flash_fwd_2x256x128_float32_tma_fma"
    with pytest.raises(ValueError, match="does not tile"):
        pa.build_flash_attention(2, 256, 128, F32, block_override=(96, 128))


@pytest.mark.parametrize("hd", [40, 64, 128, 256])
def test_bf16_block_override_picks(hd):
    """The wgmma kernel keeps its one tile of hd's bucket whatever the
    override, which only has to tile s: every override taken before is
    still taken, and (32, 32) too."""
    want = (128, 128) if hd <= 128 else (128, 64)
    for override in ((128, 128), (64, 32), (256, 64), (64, 64), (32, 32)):
        fn = pa.build_flash_attention(2, 256, hd, BF16,
                                      block_override=override)
        assert (fn.block_q, fn.block_k) == want
        assert fn.path == pa.flash_path(BF16, hd) == "wgmma"
    with pytest.raises(ValueError, match="does not tile"):
        pa.build_flash_attention(2, 256, hd, BF16, block_override=(96, 128))


def flash_operands(seed, bh, s, hd):
    """q, kT, v as (JAX bf16 arrays, CPU bf16 tensors) of equal values."""
    rng = np.random.default_rng(seed)
    out_j, out_t = [], []
    for shape in ((bh, s, hd), (bh, hd, s), (bh, s, hd)):
        xj = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
        out_j.append(xj)
        out_t.append(torch.from_numpy(np.asarray(xj, np.float32)).to(BF16))
    return out_j, out_t


@pytest.mark.parametrize("flag", ["plain", "causal", "dropout", "lse"])
@pytest.mark.parametrize("hd", [40, 72])
def test_bf16_flash_padded_depth_parity(hd, flag):
    """hd 40 and 72 (padded to 64 and 128 on the card's wgmma route)
    against the JAX package's flash kernel on the same inputs."""
    bh, s = 2, 128
    kw = {"causal": flag == "causal", "return_lse": flag == "lse",
          "dropout_p": 0.2 if flag == "dropout" else 0.0}
    (qj, kj, vj), (qt, kt, vt) = flash_operands(hd, bh, s, hd)
    want = ra.build_flash_attention(bh, s, hd, jnp.bfloat16, **kw)(
        -77, qj, kj, vj)
    fn = pa.build_flash_attention(bh, s, hd, BF16, **kw)
    assert fn.path == "wgmma" and (fn.block_q, fn.block_k) == (128, 128)
    got = fn(-77, qt, kt, vt)
    if flag == "lse":
        (want, want_lse), (got, got_lse) = want, got
        check(np.asarray(want_lse, np.float64),
              got_lse.numpy().astype(np.float64), margin=1e-5)
    assert got.dtype == BF16 and tuple(got.shape) == (bh, s, hd)
    check(np.asarray(want.astype(jnp.float32), np.float64),
          got.float().numpy().astype(np.float64), margin=1e-2)


@pytest.mark.parametrize("strategy,bk,bn,o_dt", [
    ("pallas", 32, 32, Datatype.F32), ("pallas", 16, 64, Datatype.F32),
    ("pallas", 32, 32, Datatype.BF16), ("super", 32, 32, Datatype.F32),
    ("pallas", 32, 16, Datatype.F32), ("pallas", 16, 8, Datatype.BF16)])
def test_bf16_spmm_mma_shapes_parity(strategy, bk, bn, o_dt):
    """bf16 SpMM at blockings the wgmma kernel serves, with m = 40
    (a part of the card's 128-row tile; the reference's Pallas kernel needs
    8 | m) and an empty block column, against the JAX package's lowering."""
    m, k, n = 40, 256, 256
    rng = np.random.default_rng(bk * 1000 + bn)
    keep = rng.random((k // bk, n // bn)) < 0.3
    keep[:, 1] = False
    b = rng.standard_normal((k, n)) * np.kron(keep, np.ones((bk, bn)))
    bm = ro.BcscMatrix.from_dense(b.astype(np.float32), bk, bn)
    a = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    v = jnp.asarray(bm.data, jnp.bfloat16)
    shape = GemmShape(m, n, k, Datatype.BF16, Datatype.BF16, o_dt)
    ref = ro.create_packed_spgemm_bcsc(
        shape, GemmFlags.BETA_0, SpgemmConfig(1, bk, bn),
        column_ptr=bm.indptr, row_idx=bm.indices, strategy=strategy)
    port = xp.create_packed_spgemm_bcsc(
        xp.GemmShape(m, n, k, xp.Datatype.BF16, xp.Datatype.BF16,
                     xp.Datatype[o_dt.name]),
        xp.GemmFlags.BETA_0, xp.SpgemmConfig(1, bk, bn),
        column_ptr=bm.indptr, row_idx=bm.indices, strategy=strategy,
        device="cpu")
    assert port.name == ref.name
    at, vt = (torch.from_numpy(np.asarray(x, np.float32)).to(BF16)
              for x in (a, v))
    got = port(at, vt)
    assert tuple(got.shape) == (m, n)
    assert bool((got[:, bn:2 * bn] == 0).all())     # the empty column
    want = np.asarray(ref(a, v).astype(jnp.float32), np.float64)
    check(want, got.float().numpy().astype(np.float64),
          margin=1e-2 if o_dt == Datatype.BF16 else 1e-4)


# the union strategies' tensor-core form: bf16 operands at blockings of
# whole k16 steps and 16-byte rows; the reference's names run its own union
# lowerings (interpret mode), the port's the compacted form (union) or the
# fused one (union4, union4a with u_align pad slots, union4d at full depth)
UNION_BLOCKINGS = [(32, 32), (16, 64), (64, 128), (128, 128), (16, 8)]


@pytest.mark.parametrize("dtype,bk,bn,want", [
    (BF16, 32, 32, "wgmma"), (BF16, 16, 64, "wgmma"),
    (BF16, 64, 128, "wgmma"), (BF16, 16, 8, "wgmma"), (BF16, 8, 8, "fma"),
    (BF16, 16, 4, "fma"), (BF16, 8, 32, "fma"), (F32, 32, 32, "tma_fma"),
    (F32, 16, 8, "fma")])
def test_union_wrapper_names_its_path(dtype, bk, bn, want):
    """The union wrapper takes the wgmma kernel exactly where the
    scheduled SpMM does, and the TMA-fed FMA kernel where the scheduled
    SpMM does and a group holds at most four value blocks (spmm_path with
    union=True; f32 16 x 8: eight blocks a group, the FMA kernel), in both
    forms."""
    k, n = 256, 256
    indptr = np.arange(n // bn + 1, dtype=np.int32)     # one block a column
    indices = np.zeros(n // bn, np.int32)
    a_dt = xp.Datatype.BF16 if dtype == BF16 else xp.Datatype.F32
    shape = xp.GemmShape(40, n, k, a_dt, a_dt, xp.Datatype.F32)
    for compact in (False, True):
        fn = pk.build_bcsc_spmm_union(shape, xp.SpgemmConfig(1, bk, bn),
                                      indptr, indices, "cpu",
                                      compact=compact)
        assert fn.path == want == pk.spmm_path(dtype, bk, bn, union=True)


def union_case(m, k, n, bk, bn, seed, density=0.3):
    """A bf16 block pattern with block column 1 and the last 128-column
    group empty; (reference operands, CPU tensors, the BcscMatrix)."""
    rng = np.random.default_rng(seed)
    keep = rng.random((k // bk, n // bn)) < density
    keep[:, 1] = False
    keep[:, -(128 // bn):] = False
    b = rng.standard_normal((k, n)) * np.kron(keep, np.ones((bk, bn)))
    bm = ro.BcscMatrix.from_dense(b.astype(np.float32), bk, bn)
    a = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    v = jnp.asarray(bm.data, jnp.bfloat16)
    at, vt = (torch.from_numpy(np.asarray(x, np.float32)).to(BF16)
              for x in (a, v))
    return (a, v), (at, vt), bm


def union_pair(shape, bk, bn, bm, strategy):
    """The reference's and the port's kernels for one strategy name (the
    reference's None where it refuses the descriptor)."""
    try:
        ref = ro.create_packed_spgemm_bcsc(
            shape, GemmFlags.BETA_0, SpgemmConfig(1, bk, bn),
            column_ptr=bm.indptr, row_idx=bm.indices, strategy=strategy)
    except ValueError:
        ref = None
    port = xp.create_packed_spgemm_bcsc(
        xp.GemmShape(shape.m, shape.n, shape.k, xp.Datatype.BF16,
                     xp.Datatype.BF16, xp.Datatype[shape.out_type.name]),
        xp.GemmFlags.BETA_0, xp.SpgemmConfig(1, bk, bn),
        column_ptr=bm.indptr, row_idx=bm.indices, strategy=strategy,
        device="cpu")
    return ref, port


@pytest.mark.parametrize("o_dt", [Datatype.F32, Datatype.BF16])
@pytest.mark.parametrize("strategy", ["union", "union4", "union4a"])
@pytest.mark.parametrize("bk,bn", UNION_BLOCKINGS)
def test_bf16_union_mma_shapes_parity(bk, bn, strategy, o_dt):
    """bf16 union SpMM at the wgmma blockings (32 x 32, 64 x 128, 128 x
    128, 16 x 64 and 16 x 8), compacted (union)
    and fused (union4; union4a with u_align pad slots), m = 208 (a 128-row
    tile and a ragged one on the card; the reference needs 16 | m for bf16), an
    empty block column and an empty 128-column group, against the JAX
    package's union lowering. 16 x 8 blocks run at k = 64, which keeps the
    reference's interpret-mode gather of W = 16 blocks a slot short."""
    m, k, n = 208, 64 if bn == 8 else 256, 384
    (a, v), (at, vt), bm = union_case(m, k, n, bk, bn, seed=bk * 100 + bn)
    shape = GemmShape(m, n, k, Datatype.BF16, Datatype.BF16, o_dt)
    ref, port = union_pair(shape, bk, bn, bm, strategy)
    assert port.name == ref.name
    got = port(at, vt)
    assert got.dtype == (BF16 if o_dt == Datatype.BF16 else F32)
    assert tuple(got.shape) == (m, n)
    assert bool((got[:, bn:2 * bn] == 0).all())     # the empty column
    assert bool((got[:, 256:] == 0).all())          # the empty group
    want = np.asarray(ref(a, v).astype(jnp.float32), np.float64)
    check(want, got.float().numpy().astype(np.float64),
          margin=1e-2 if o_dt == Datatype.BF16 else 1e-4)


@pytest.mark.parametrize("bk,bn", [(32, 32), (64, 128)])
@pytest.mark.parametrize("strategy", ["union", "union4d"])
@pytest.mark.parametrize("o_dt", [Datatype.F32, Datatype.BF16])
def test_bf16_union_ragged_m(o_dt, strategy, bk, bn):
    """m = 37: the reference refuses the sublane-unaligned m (a Mosaic
    limit), the port serves it (on the card: rows past m zero-filled, not
    stored); union4d pads every group to the full depth with dead slots.
    Held against the float64 product, at both wgmma blockings."""
    m, k, n = 37, 256, 384
    (a, v), (at, vt), bm = union_case(m, k, n, bk, bn, seed=37)
    shape = GemmShape(m, n, k, Datatype.BF16, Datatype.BF16, o_dt)
    ref, port = union_pair(shape, bk, bn, bm, strategy)
    assert ref is None
    got = port(at, vt)
    want = np.asarray(a, np.float64) @ ro.BcscMatrix(
        bm.shape, bk, bn, bm.indptr, bm.indices,
        np.asarray(v, np.float64)).to_dense()
    check(want, got.float().numpy().astype(np.float64),
          margin=1e-2 if o_dt == Datatype.BF16 else 1e-4)


@pytest.mark.parametrize("o_dt", [Datatype.F32, Datatype.BF16])
@pytest.mark.parametrize("strategy", ["union", "union4"])
def test_bf16_union_clustered_parity(strategy, o_dt):
    """The two-family pattern (tests/test_sparse.py's cluster case) in bf16:
    the clustered plan's permuted groups restored in the store, against the
    JAX package's union lowering on the same plan decision."""
    bk = bn = 32
    m, n, k = 64, 256, 1024
    rng = np.random.default_rng(11)
    cols = [np.sort(rng.choice(np.arange(0, 16) if j % 2 == 0
                               else np.arange(16, 32), 10, replace=False))
            for j in range(n // bn)]
    indptr = np.arange(0, 10 * (n // bn) + 1, 10, dtype=np.int32)
    indices = np.concatenate(cols).astype(np.int32)
    values = rng.standard_normal((len(indices), bk, bn))
    bm = ro.BcscMatrix((k, n), bk, bn, indptr, indices,
                       values.astype(np.float32))
    a = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    v = jnp.asarray(values, jnp.bfloat16)
    shape = GemmShape(m, n, k, Datatype.BF16, Datatype.BF16, o_dt)
    ref, port = union_pair(shape, bk, bn, bm, strategy)
    assert port.name == ref.name
    plan = pk.build_bcsc_spmm_union(
        xp.GemmShape(m, n, k, xp.Datatype.BF16, xp.Datatype.BF16,
                     xp.Datatype[o_dt.name]), xp.SpgemmConfig(1, bk, bn),
        indptr, indices, "cpu")
    assert plan.path == "wgmma"
    at, vt = (torch.from_numpy(np.asarray(x, np.float32)).to(BF16)
              for x in (a, v))
    got = port(at, vt)
    want = np.asarray(ref(a, v).astype(jnp.float32), np.float64)
    check(want, got.float().numpy().astype(np.float64),
          margin=1e-2 if o_dt == Datatype.BF16 else 1e-4)
