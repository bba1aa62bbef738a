"""The tensor-core paths of the port, on the CPU: which CUDA kernel a
scheduled/supertile BCSC SpMM and a flash forward take (the predicates that
mirror the choice csrc makes), the bf16 flash tile configurations and their
shared memory, and the bf16 wrappers at shapes that reach the tensor-core
kernels on the card, held against the JAX package on the same numpy inputs.
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
SMEM_MAX = 232448            # a block's shared memory on sm_90


@pytest.mark.parametrize("dtype,bk,bn,want", [
    (BF16, 32, 32, "mma"), (BF16, 16, 64, "mma"), (BF16, 128, 128, "mma"),
    (BF16, 48, 24, "mma"), (BF16, 16, 8, "mma"), (BF16, 64, 256, "mma"),
    (BF16, 8, 8, "fma"), (BF16, 4, 48, "fma"), (BF16, 32, 4, "fma"),
    (BF16, 24, 32, "fma"), (F32, 32, 32, "fma"), (F32, 128, 128, "fma"),
    (torch.float16, 32, 32, "fma")])
def test_spmm_path(dtype, bk, bn, want):
    """bf16 tiles of whole k16 steps and whole 16-byte rows take the
    tensor-core kernel; f32 (no TF32) and other blockings the FMA one."""
    assert pk.spmm_path(dtype, bk, bn) == want


@pytest.mark.parametrize("a_dt,bk,bn,want", [
    (xp.Datatype.BF16, 32, 32, "mma"), (xp.Datatype.BF16, 16, 64, "mma"),
    (xp.Datatype.BF16, 8, 8, "fma"), (xp.Datatype.F32, 32, 32, "fma")])
def test_spmm_wrappers_name_their_path(a_dt, bk, bn, want):
    k, n = 256, 256
    indptr = np.arange(n // bn + 1, dtype=np.int32)     # one block a column
    indices = np.zeros(n // bn, np.int32)
    shape = xp.GemmShape(40, n, k, a_dt, a_dt, xp.Datatype.F32)
    fn = pk.build_bcsc_spmm(shape, xp.SpgemmConfig(1, bk, bn), indptr,
                            indices, "cpu")
    assert fn.path == want
    sup = pk.build_bcsc_spmm_super(shape, np.array([0, 1, 1], np.int32),
                                   np.zeros(1, np.int32), "cpu")
    assert sup.path == ("mma" if a_dt == xp.Datatype.BF16 else "fma")


def test_flash_path():
    assert pa.flash_path(BF16) == "mma"
    assert pa.flash_path(F32) == "fma"
    assert pa.build_flash_attention(2, 128, 40, BF16).path == "mma"
    assert pa.build_flash_attention(2, 128, 40, F32).path == "fma"


@pytest.mark.parametrize("hd,hdp", [
    (8, 32), (32, 32), (40, 64), (64, 64), (72, 96), (96, 96), (104, 128),
    (128, 128), (136, 192), (192, 192), (200, 256), (256, 256)])
def test_bf16_flash_configs(hd, hdp):
    """hd padded to its bucket; 64-column K tiles first up to a padded 128,
    32 past it; every configuration's shared memory fits a block."""
    assert pa._mma_hdp(hd) == hdp
    configs = pa.flash_configs(hd, BF16)
    want = [(64, 64), (64, 32)] if hdp <= 128 else [(64, 32), (64, 64)]
    assert configs == want
    for _, bk in configs:
        assert pa._smem_bytes(hd, bk, BF16) <= SMEM_MAX
    assert pa.build_flash_attention(2, 256, hd, BF16).block_k == want[0][1]


def test_bf16_smem_bytes():
    """Q (64 x hdp), two K^T (hdp x bk) and two V (bk x hdp) tiles in bf16,
    each row padded by 8 elements (csrc mma_smem_bytes)."""
    for hd, bk, want in ((128, 64, 89088), (128, 32, 55296),
                         (256, 64, 175104), (256, 32, 108544),
                         (40, 64, 46080), (72, 32, 41984)):
        assert pa._smem_bytes(hd, bk, BF16) == want, (hd, bk)


def test_f32_flash_configs_keep_their_values():
    assert pa.flash_configs(64) == [(64, 64), (64, 32)]
    assert pa.flash_configs(64, F32) == [(64, 64), (64, 32)]
    assert pa.flash_configs(128) == [(64, 32), (64, 64)]
    assert pa.flash_configs(256) == [(64, 32), (64, 64)]
    assert pa._smem_bytes(128, 64) == pa._smem_bytes(128, 64, F32) == 117760


@pytest.mark.parametrize("hd", [40, 64, 128, 256])
def test_bf16_block_override_picks(hd):
    """The TPU tile stays an upper bound on the bf16 kernel's tile."""
    for override, want in (((128, 128), (64, 64)), ((64, 32), (64, 32)),
                           ((256, 64), (64, 64)), ((64, 64), (64, 64))):
        fn = pa.build_flash_attention(2, 256, hd, BF16,
                                      block_override=override)
        assert (fn.block_q, fn.block_k) == want
    with pytest.raises(ValueError, match="smaller than every"):
        pa.build_flash_attention(2, 256, hd, BF16, block_override=(32, 32))


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
    """hd 40 and 72 (padded to 64 and 96 on the card) against the JAX
    package's flash kernel on the same inputs."""
    bh, s = 2, 128
    kw = {"causal": flag == "causal", "return_lse": flag == "lse",
          "dropout_p": 0.2 if flag == "dropout" else 0.0}
    (qj, kj, vj), (qt, kt, vt) = flash_operands(hd, bh, s, hd)
    want = ra.build_flash_attention(bh, s, hd, jnp.bfloat16, **kw)(
        -77, qj, kj, vj)
    fn = pa.build_flash_attention(bh, s, hd, BF16, **kw)
    assert fn.path == "mma" and (fn.block_q, fn.block_k) == (64, 64)
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
    ("pallas", 32, 32, Datatype.BF16), ("super", 32, 32, Datatype.F32)])
def test_bf16_spmm_mma_shapes_parity(strategy, bk, bn, o_dt):
    """bf16 SpMM at blockings the tensor-core kernel serves, with m = 40
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
