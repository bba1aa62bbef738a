"""The wgmma routes of the bf16 flash forward and of the bf16 scheduled and
supertile BCSC SpMM, on the CPU: which shapes take them (`flash_path` and
`spmm_path`, the predicates that mirror csrc xsmm_flash_fwd and
spmm_route: by dtype, or by dtype, blocking and union, alone), the
forward's block_override acceptance and refusals, the counters' entries,
and the port's plain versions at every shape the routes take held against
the JAX package on the same numpy inputs: `build_flash_attention` (its
Pallas kernel in interpret mode) at every hd bucket of the route (64, 128,
192, 256) and every flag, a head map under dropout against the reference's whole
attention, and the scheduled and supertile SpMMs at 32 x 32, 64 x 128 and
128 x 128 blocks through the reference's strategies. The port's wrappers
run their plain versions on CPU tensors.

Tolerances (matdiff normf_rel): 1e-2 for bf16 outputs (the flash output,
the SpMM with a bf16 output: one rounding at another point of the sum),
1e-5 for the LSE, 1e-4 for bf16 in / f32 out SpMM (products exact in f32,
sums in another order), the margins of tests/test_torch_mma.py.
"""

import pathlib

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
CSRC = (pathlib.Path(__file__).resolve().parents[1] / "libxsmm_torch"
        / "kernels" / "csrc")


# ---------------------------------------------------------------------------
# the routes and the entries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("override", [None, (128, 128), (64, 32),
                                      (256, 256), (32, 32)])
@pytest.mark.parametrize("hd,want", [
    (8, "wgmma"), (40, "wgmma"), (64, "wgmma"), (72, "wgmma"),
    (128, "wgmma"), (136, "wgmma"), (192, "wgmma"), (256, "wgmma")])
def test_fwd_route_by_hd_and_override(hd, want, override):
    """bf16 takes the wgmma kernel at every hd, whatever the override;
    the built object names the same route and the tile of hd's bucket (128
    rows against 128-key tiles up to hd 128, 64-key tiles past it); f32
    keeps tma_fma."""
    assert pa.flash_path(BF16, hd) == want
    fn = pa.build_flash_attention(2, 256, hd, BF16, block_override=override)
    assert fn.path == want
    assert (fn.block_q, fn.block_k) == (128, 128 if hd <= 128 else 64)
    assert fn.name.endswith(f"_bfloat16_{want}_bk{fn.block_k}")
    f32 = pa.build_flash_attention(2, 256, hd, F32, block_override=override)
    assert f32.path == pa.flash_path(F32, hd) == "tma_fma"


def test_fwd_override_refusals():
    """An override that does not tile s is refused on every route."""
    for hd in (64, 128, 256):
        for dt in (BF16, F32):
            with pytest.raises(ValueError, match="does not tile"):
                pa.build_flash_attention(2, 256, hd, dt,
                                         block_override=(96, 128))
            with pytest.raises(ValueError, match="does not tile"):
                pa.build_flash_attention(2, 256, hd, dt,
                                         block_override=(128, 0))


def test_entries_name_the_wgmma_kernels():
    """The forward's counter and the scheduled and supertile SpMMs'
    counters name their wgmma kernel beside the others, each a kernel of
    its source; both modules count launches by that route."""
    stem, names = pa.ENTRIES["flash_attention_fwd"]
    assert "flash_fwd_wgmma_kernel" in names
    assert "flash_fwd_wgmma_kernel(" in (CSRC / f"{stem}.cu").read_text()
    assert pa.path_launches["flash_attention_fwd"]["wgmma"] == 0
    src = (CSRC / "spmm_kernels.cu").read_text()
    for counter in ("bcsc_spmm", "bcsc_spmm_super"):
        stem, names = pk.ENTRIES[counter]
        assert stem == "spmm_kernels" and "bcsc_spmm_wgmma_kernel" in names
        assert pk.path_launches[counter]["wgmma"] == 0
    assert "bcsc_spmm_wgmma_kernel(" in src
    assert "bcsc_spmm_wgmma_kernel" not in pk.ENTRIES["bcsc_spmm_union"][1]
    assert "bcsc_union_wgmma_kernel" in pk.ENTRIES["bcsc_spmm_union"][1]
    assert "bcsc_union_wgmma_kernel(" in src
    assert "wgmma" in pa.ROUTES and "wgmma" in pk.ROUTES


@pytest.mark.parametrize("bk,bn", [(32, 32), (64, 128), (128, 128),
                                   (32, 96), (64, 32), (96, 64), (16, 64),
                                   (16, 8), (48, 32), (32, 16)])
def test_spmm_wgmma_route_by_blocking(bk, bn):
    """bf16 blocks of whole k16 steps and 16-byte rows take wgmma in the
    scheduled and supertile SpMMs and in the union (its own kernel); f32 at
    the same blocking keeps tma_fma."""
    assert pk.spmm_path(BF16, bk, bn) == "wgmma"
    assert pk.spmm_path(BF16, bk, bn, union=True) == "wgmma"
    assert pk.spmm_path(F32, bk, bn) == "tma_fma"


# ---------------------------------------------------------------------------
# the plain forward against the JAX package at the wgmma route's shapes
# ---------------------------------------------------------------------------

FLAGS = {
    "plain": {},
    "causal": {"causal": True},
    "dropout": {"dropout_p": 0.1},
    "bias_bh": {"bias_bh": "bh"},
    "bias1": {"bias_bh": 1},
    "lse": {"return_lse": True},
    "causal_dropout_bias": {"causal": True, "dropout_p": 0.2, "bias_bh": 1},
}


def fwd_operands(bh, s, hd, bias_bh, seed):
    """q, kT, v as bf16 (JAX arrays, CPU tensors) of equal values, and the
    f32 bias (or None) both ways."""
    rng = np.random.default_rng(seed)
    js, ts = [], []
    for shape in ((bh, s, hd), (bh, hd, s), (bh, s, hd)):
        xj = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
        js.append(xj)
        ts.append(torch.from_numpy(np.asarray(xj, np.float32)).to(BF16))
    if not bias_bh:
        return js, ts, None, None
    bias = (rng.standard_normal((bias_bh, s, s)) * 0.5).astype(np.float32)
    return js, ts, jnp.asarray(bias), torch.from_numpy(bias)


def held(want, got, lse):
    """The port's output (and LSE) within the margins of the reference's."""
    if lse:
        (want, want_lse), (got, got_lse) = want, got
        assert got_lse.dtype == F32 and tuple(got_lse.shape) == \
            np.shape(want_lse)
        check(np.asarray(want_lse, np.float64),
              got_lse.numpy().astype(np.float64), margin=1e-5)
    assert got.dtype == BF16 and tuple(got.shape) == np.shape(want)
    check(np.asarray(want.astype(jnp.float32), np.float64),
          got.float().numpy().astype(np.float64), margin=1e-2)


@pytest.mark.parametrize("flag", list(FLAGS))
@pytest.mark.parametrize("hd,s", [(40, 128), (64, 256), (80, 128),
                                  (128, 256), (136, 128), (256, 256)])
def test_fwd_wgmma_parity(hd, s, flag):
    """bf16 forward at every hd bucket of the wgmma route (64: hd 40 and
    64; 128: hd 80 and 128; 192: hd 136; 256; zero-padded on the card),
    each flag, against the JAX package's forward kernel on the same
    operands."""
    bh = 2
    kw = dict(FLAGS[flag])
    if kw.get("bias_bh") == "bh":
        kw["bias_bh"] = bh
    js, ts, bj, bt = fwd_operands(bh, s, hd, kw.get("bias_bh"), hd + s)
    want = ra.build_flash_attention(bh, s, hd, jnp.bfloat16, **kw)(
        -77, *js, *(() if bj is None else (bj,)))
    fn = pa.build_flash_attention(bh, s, hd, BF16, **kw)
    assert fn.path == "wgmma"
    assert (fn.block_q, fn.block_k) == (128, 128 if hd <= 128 else 64)
    held(want, fn(-77, *ts, bt), kw.get("return_lse", False))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_fwd_wgmma_head_map_dropout_parity(hd, causal):
    """A block of heads under a head map hashes its global batch-heads: the
    port on batch 1, heads 2-3 of 2 x 4 (head_map (1, 2, 2, 4)) with
    dropout equals the reference's forward of the whole attention at those
    batch-heads (6 and 7); the same block hashed by its local indices
    draws other bits."""
    nb, nhg, s = 2, 4, 128
    kw = {"dropout_p": 0.2, "causal": causal}
    js, ts, _, _ = fwd_operands(nb * nhg, s, hd, 0, hd + causal)
    want = ra.build_flash_attention(nb * nhg, s, hd, jnp.bfloat16, **kw)(
        -77, *js)
    sel = slice(6, 8)
    part = tuple(t[sel] for t in ts)
    fn = pa.build_flash_attention(2, s, hd, BF16, head_map=(1, 2, 2, 4),
                                  **kw)
    assert fn.path == "wgmma" and fn.head_map == (1, 2, 2, 4)
    got = fn(-77, *part)
    held(np.asarray(want.astype(jnp.float32))[sel].astype(jnp.bfloat16),
         got, False)
    local = pa.build_flash_attention(2, s, hd, BF16, **kw)(-77, *part)
    assert not torch.equal(local, got)


# ---------------------------------------------------------------------------
# the plain SpMMs against the JAX package at the wgmma route's blockings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("o_dt", [Datatype.F32, Datatype.BF16])
@pytest.mark.parametrize("strategy,bk,bn", [
    ("pallas", 32, 32), ("pallas", 64, 128), ("pallas", 128, 128),
    ("super", 32, 32), ("super", 128, 128)])
def test_spmm_wgmma_shapes_parity(strategy, bk, bn, o_dt):
    """The scheduled ("pallas") and supertile ("super") SpMMs in bf16 at
    the blockings the wgmma kernel serves, m = 48 (a part of the card's
    128-row tile), an empty block column, against the JAX package's
    lowering of the same strategy: the port names the same kernel, takes
    the wgmma route, and its plain version matches."""
    m, k, n = 48, 256, 512
    rng = np.random.default_rng(bk * 7 + bn + (strategy == "super"))
    keep = rng.random((k // bk, n // bn)) < 0.4
    keep[:, 1] = False
    b = rng.standard_normal((k, n)) * np.kron(keep, np.ones((bk, bn)))
    bm = ro.BcscMatrix.from_dense(b.astype(np.float32), bk, bn)
    a = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    v = jnp.asarray(bm.data, jnp.bfloat16)
    shape = GemmShape(m, n, k, Datatype.BF16, Datatype.BF16, o_dt)
    ref = ro.create_packed_spgemm_bcsc(
        shape, GemmFlags.BETA_0, SpgemmConfig(1, bk, bn),
        column_ptr=bm.indptr, row_idx=bm.indices, strategy=strategy)
    pshape = xp.GemmShape(m, n, k, xp.Datatype.BF16, xp.Datatype.BF16,
                          xp.Datatype[o_dt.name])
    port = xp.create_packed_spgemm_bcsc(
        pshape, xp.GemmFlags.BETA_0, xp.SpgemmConfig(1, bk, bn),
        column_ptr=bm.indptr, row_idx=bm.indices, strategy=strategy,
        device="cpu")
    assert port.name == ref.name
    if strategy == "pallas":
        built = pk.build_bcsc_spmm(pshape, xp.SpgemmConfig(1, bk, bn),
                                   bm.indptr, bm.indices, "cpu")
    else:   # one occupied supertile in a 128-wide, 128-deep pattern
        built = pk.build_bcsc_spmm_super(
            xp.GemmShape(m, 128, 128, xp.Datatype.BF16, xp.Datatype.BF16,
                         xp.Datatype[o_dt.name]),
            np.array([0, 1], np.int32), np.zeros(1, np.int32), "cpu")
    assert built.path == "wgmma"
    at, vt = (torch.from_numpy(np.asarray(x, np.float32)).to(BF16)
              for x in (a, v))
    got = port(at, vt)
    assert tuple(got.shape) == (m, n)
    assert bool((got[:, bn:2 * bn] == 0).all())     # the empty column
    want = np.asarray(ref(a, v).astype(jnp.float32), np.float64)
    check(want, got.float().numpy().astype(np.float64),
          margin=1e-2 if o_dt == Datatype.BF16 else 1e-4)


@pytest.mark.parametrize("o_dt", [Datatype.F32, Datatype.BF16])
@pytest.mark.parametrize("bk,bn", [(32, 32), (128, 128)])
def test_spmm_wgmma_builders_parity(bk, bn, o_dt):
    """build_bcsc_spmm at 32 x 32 and build_bcsc_spmm_super over 128 x 128
    supertiles (the reference's builders, interpret mode) against the
    port's, m = 40 with an empty block column: the same values."""
    from libxsmm_tpu.kernels import spmm_pallas as rk
    m, k, n = 40, 256, 384
    rng = np.random.default_rng(bk + bn + (o_dt == Datatype.BF16))
    keep = rng.random((n // bn, k // bk)) < 0.5
    keep[1] = False
    indptr = np.zeros(n // bn + 1, np.int32)
    indptr[1:] = np.cumsum(keep.sum(axis=1))
    indices = np.nonzero(keep)[1].astype(np.int32)
    a = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((len(indices), bk, bn)),
                    jnp.bfloat16)
    shape = GemmShape(m, n, k, Datatype.BF16, Datatype.BF16, o_dt)
    pshape = xp.GemmShape(m, n, k, xp.Datatype.BF16, xp.Datatype.BF16,
                          xp.Datatype[o_dt.name])
    if bk == 32:
        ref = rk.build_bcsc_spmm(shape, SpgemmConfig(1, bk, bn), indptr,
                                 indices)
        port = pk.build_bcsc_spmm(pshape, xp.SpgemmConfig(1, bk, bn), indptr,
                                  indices, "cpu")
    else:
        ref = rk.build_bcsc_spmm_super(shape, indptr, indices)
        port = pk.build_bcsc_spmm_super(pshape, indptr, indices, "cpu")
    assert port.path == "wgmma"
    at, vt = (torch.from_numpy(np.asarray(x, np.float32)).to(BF16)
              for x in (a, v))
    got = port(at, vt)
    assert bool((got[:, bn:2 * bn] == 0).all())
    want = np.asarray(jnp.asarray(ref(a, v)).astype(jnp.float32), np.float64)
    check(want, got.float().numpy().astype(np.float64),
          margin=1e-2 if o_dt == Datatype.BF16 else 1e-4)
