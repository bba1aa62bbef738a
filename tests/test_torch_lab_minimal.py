"""The BCSC lab's `minimal` probe on wgmma, on the CPU: its launch planner
(`kernels.spmm_lab.minimal_plan`) over every union k = 1024 allows, ragged
row counts and n from 128 to 1024 (and the lab's grid against 132, 114
and 78 SMs), the constants and formulas it mirrors from
csrc/spmm_lab_kernels.cu, and the probe's plain version held against the
JAX lab's `minimal` (scripts/bcsc_lab.py, loaded from its file, its Pallas
kernel in interpret mode) on the same numpy inputs.

Tolerance (matdiff normf_rel): 1e-4 for the probe (bf16 in, f32 sums in
another order; the constant RHS rounded to bf16 by each framework).
"""

import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libxsmm_torch.kernels import spmm_lab as pl
from libxsmm_torch.matdiff import check
from libxsmm_torch.ops.sparse import BcscMatrix
from libxsmm_torch.scripts import bcsc_lab
from libxsmm_tpu.ops.sparse import BcscMatrix as JaxBcsc

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "libxsmm_torch" / "kernels" / "csrc" / "spmm_lab_kernels.cu"
SMS = (132, 114, 78)
ROWS = (1, 63, 64, 65, 127, 1000, 1024, 2049, 4100, 32768)


def _jax_lab():
    """scripts/bcsc_lab.py, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "jax_bcsc_lab_minimal", ROOT / "scripts" / "bcsc_lab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("U", range(1, 33))
@pytest.mark.parametrize("n", (128, 384, 1024))
def test_minimal_plan(n, U):
    """Every union k = 1024 allows, at each row count: a ring of
    min(4, ceil(32U / 64)) stages of 24 KB, 1024-byte aligned (the 128-byte
    swizzle), at least two whenever there are two slices (a consumer frees
    a stage one slice late); a block per 64-row tile and group; shared
    memory within a block's limit, two blocks an SM."""
    for m in ROWS:
        plan = pl.minimal_plan(m, n, U)
        slices = -(-U // 2)
        assert plan.stages == min(4, slices)
        assert plan.stages >= 2 or slices == 1
        assert plan.blocks == -(-m // 64) * (n // 128)
        stage = 64 * 128 + 2 * 8192
        assert stage % 1024 == 0
        assert plan.smem == 1024 + plan.stages * stage + 16 * plan.stages
        assert 2 * (plan.smem + 1024) <= 233472 and plan.smem <= pl.SMEM_MAX


@pytest.mark.parametrize("sms", SMS)
def test_minimal_plan_at_the_lab_shape(sms):
    """The lab's 1024^3, U = 21: 16 x 8 = 128 blocks of 64 rows, 4 stages
    of 24 KB; on 132 SMs one wave, on 114 and 78 two blocks an SM (the
    shared memory allows it) still hold the grid in one wave."""
    plan = pl.minimal_plan(1024, 1024, 21)
    assert plan == pl.MinimalPlan(4, 128, 1024 + 4 * 24576 + 64)
    assert plan.blocks <= 2 * sms


def test_minimal_constants_mirror_the_cuda_source():
    src = SRC.read_text()
    got = {n: int(v) for n, v in re.findall(
        r"constexpr int (MIN_BK|MIN_STAGES|MIN_ROWS|GW) = (\d+);", src)}
    assert got == {"MIN_BK": pl.MIN_BK, "MIN_STAGES": pl.MIN_STAGES,
                   "MIN_ROWS": pl.MIN_ROWS, "GW": 128}
    assert "constexpr int MIN_B_BOX = MIN_BK * 64 * 2;" in src
    assert "constexpr int MIN_A_BOX = MIN_ROWS * MIN_BK * 2;" in src
    assert "constexpr int MIN_STAGE = MIN_A_BOX + 2 * MIN_B_BOX;" in src
    assert ("return 1024 + (size_t)stages * MIN_STAGE + 2 * stages * 8;"
            in src)
    # the ring's depth: the slices, capped
    assert ("const int slices = (U * BK + MIN_BK - 1) / MIN_BK;\n"
            "  return slices < MIN_STAGES ? slices : MIN_STAGES;") in src
    # one producer warp beside one consumer warpgroup, a block per 64-row
    # tile and group, A's box as tall as the tile
    assert "__launch_bounds__(128 + 32, 1)" in src
    assert "const dim3 grid((m + MIN_ROWS - 1) / MIN_ROWS, n / GW);" in src
    assert "<<<grid, 128 + 32, smem, st>>>" in src
    assert "const cuuint32_t box[2] = {MIN_BK, MIN_ROWS};" in src
    assert "template <int WG>" not in src
    assert pl.TENSOR_MAP_BYTES == 128
    # the RHS map is encoded apart from the launch (once per probe), A's
    # per launch, both through the shared header's encode_map
    assert "int xsmm_bcsc_lab_minimal_rhs_map(" in src
    assert src.count("encode_map(&") == 2
    # the FMA kernel is gone and no route falls back to another kernel
    assert "fmaf" not in src and "Rs[BK][GW]" not in src


def _pattern(U, n):
    """A BCSC pattern whose every column group's union is U block rows."""
    rng = np.random.default_rng(U + n)
    keep = np.zeros((U, n // 32), bool)
    for g in range(n // 128):
        keep[:, 4 * g + (g % 4)] = True
    bmat = rng.standard_normal((32 * U, n)).astype(np.float32)
    bmat *= np.kron(keep, np.ones((32, 32), np.float32))
    return bmat


@pytest.mark.parametrize("m,U,n,extra_k", [
    (1, 1, 128, 0),        # one row, one slot: a single ragged slice
    (70, 3, 256, 32),      # ragged m, odd U (the last slice half empty)
    (130, 21, 384, 0),     # the lab's union depth
    (33, 32, 128, 64),     # the deepest union k = 1024 allows, k > 32U
])
def test_minimal_parity_with_jax_lab(m, U, n, extra_k):
    lab = _jax_lab()
    bmat = _pattern(U, n)
    k = 32 * U + extra_k
    bmat = np.vstack([bmat, np.zeros((extra_k, n), np.float32)])
    ref = lab.make_variants((m, n, k), JaxBcsc.from_dense(bmat, 32, 32),
                            0.0)["minimal"]
    probes = bcsc_lab.make_variants((m, n, k), BcscMatrix.from_dense(
        bmat, 32, 32), 0.0, "cpu")
    got = probes["minimal"]
    assert got.U == U and got.path == "wgmma" and got.rhs_map is None
    a = np.random.default_rng(3).standard_normal((m, k)).astype(np.float32)
    v = np.asarray(BcscMatrix.from_dense(bmat, 32, 32).data)
    before = dict(pl.launches)
    out = got(torch.from_numpy(a), torch.from_numpy(v))
    assert pl.launches == before       # CPU tensors: the plain version
    assert out.dtype == torch.float32 and tuple(out.shape) == (m, n)
    want = np.asarray(ref(jnp.asarray(a, jnp.bfloat16),
                          jnp.asarray(v, jnp.bfloat16)), np.float64)
    check(want, out, margin=1e-4)
