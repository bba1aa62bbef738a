"""The BCSC lab's fused probes on the tensor cores, on the CPU: the staging
planners (`kernels.spmm_lab.chunk_plan`, `dspipe_plan`) over every union
k = 1024 allows and past the edge of each plan, the constants and formulas
they mirror from csrc/spmm_lab_kernels.cu, and the path each probe reports.
The probes' arithmetic is held against the JAX lab by test_torch_labs.py
(their plain versions, which the card tests hold the kernels against).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from libxsmm_torch.kernels import spmm_lab as pl
from libxsmm_torch.matdiff import check
from libxsmm_torch.ops.sparse import BcscMatrix
from libxsmm_torch.scripts import bcsc_lab

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "libxsmm_torch" / "kernels" / "csrc" / "spmm_lab_kernels.cu"
PLANS = {"chunk1": lambda U: pl.chunk_plan(U, 1),
         "chunk2": lambda U: pl.chunk_plan(U, 2),
         "chunk4": lambda U: pl.chunk_plan(U, 4),
         "dspipe": pl.dspipe_plan}
HEIGHTS = {"chunk1": pl.CHUNK_ROWS, "chunk2": pl.CHUNK_ROWS,
           "chunk4": pl.CHUNK_ROWS, "dspipe": pl.DSPIPE_ROWS}
# the first union each plan refuses (k = 32 U deep enough to hold it)
REFUSED_AT = {"chunk1": 42, "chunk2": 41, "chunk4": 81, "dspipe": 33}


def _slots(probe, U):
    return -(-U // int(probe[-1])) if probe.startswith("chunk") else U


@pytest.mark.parametrize("U", range(1, 33))
@pytest.mark.parametrize("probe", list(PLANS))
def test_plan_fits_every_union_of_k1024(probe, U):
    """Every union k = 1024 allows (U <= 32) is staged: at most SMEM_MAX
    bytes, the tallest tile that fits, 16-byte aligned row strides and
    buffer offsets (ldmatrix's and cp.async's rule), and the warps the
    kernel's Tile gives that height and width."""
    plan = PLANS[probe](U)
    assert plan is not None
    cols = pl.DSPIPE_CW if probe == "dspipe" else pl.CHUNK_CW
    buffers = 1 if probe == "chunk1" else 2
    slots = _slots(probe, U)
    assert (plan.cols, plan.slots, plan.buffers) == (cols, slots, buffers)
    assert plan.smem == pl.stage_bytes(plan.rows, cols, slots, buffers)
    assert plan.smem <= pl.SMEM_MAX
    taller = [r for r in HEIGHTS[probe] if r > plan.rows]
    assert all(pl.stage_bytes(r, cols, slots, buffers) > pl.SMEM_MAX
               for r in taller)
    a_stride = (slots * pl.BLOCK + 8) * 2           # bytes per staged A row
    r_stride = (cols + 8) * 2                       # bytes per RHS row
    a_bytes = plan.rows * a_stride                  # the RHS starts here
    assert a_stride % 16 == 0 and r_stride % 16 == 0 and a_bytes % 16 == 0
    # the buffers start after the barriers, each a whole number of units
    assert pl.BAR_BYTES % 16 == 0
    assert ((plan.smem - pl.BAR_BYTES) // buffers) % 16 == 0
    # ldmatrix's 8 rows of one matrix on 8 distinct 16-byte bank groups
    for stride in (a_stride, r_stride):
        assert len({(i * stride) % 128 for i in range(8)}) == 8
    warps_m = 2 if plan.rows >= 32 else 1
    producers = (pl.DSPIPE_PRODUCERS if probe == "dspipe"
                 else pl.CHUNK_PRODUCERS)
    assert plan.threads == 32 * warps_m * (cols // 16) + producers
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    assert plan.rows % (16 * warps_m) == 0 and cols % 16 == 0


@pytest.mark.parametrize("probe", list(PLANS))
def test_plan_refuses_past_its_edge(probe):
    """Past the 16-row tile's deepest union the plan is None (the launcher
    returns cudaErrorInvalidValue and the wrapper raises)."""
    U = REFUSED_AT[probe]
    last = PLANS[probe](U - 1)
    assert last is not None and last.rows == 16
    assert PLANS[probe](U) is None
    assert all(PLANS[probe](u) is None for u in range(U, U + 40))


def test_lab_shape_plans():
    """The lab's U = 21: chunk1 and chunk2 one block an SM (64 x 64 tiles,
    8 consumer warps, 8 producer warps), chunk4 two, dspipe a 32 x 32 tile
    (4 consumer warps, 12 producer warps) over two whole unions."""
    assert pl.chunk_plan(21, 1) == pl.StagePlan(64, 64, 21, 1, 512, 183824)
    assert pl.chunk_plan(21, 2) == pl.StagePlan(64, 64, 11, 2, 512, 193552)
    assert pl.chunk_plan(21, 4) == pl.StagePlan(64, 64, 6, 2, 512, 106512)
    assert pl.dspipe_plan(21) == pl.StagePlan(32, 32, 21, 2, 512, 194576)
    assert 2 * (pl.chunk_plan(21, 4).smem + 1024) <= 233472


def _src():
    return SRC.read_text()


def test_constants_mirror_the_cuda_source():
    src = _src()
    got = {n: int(v) for n, v in re.findall(
        r"constexpr int (SMEM_MAX|CHUNK_CW|DSPIPE_CW|BK|BN|BAR_BYTES) = "
        r"(\d+);", src)}
    assert got == {"SMEM_MAX": pl.SMEM_MAX, "CHUNK_CW": pl.CHUNK_CW,
                   "DSPIPE_CW": pl.DSPIPE_CW, "BK": pl.BLOCK,
                   "BN": pl.BLOCK, "BAR_BYTES": pl.BAR_BYTES}
    # the staging bytes, the warps of a tile and the heights tried in order
    assert ("return BAR_BYTES + (size_t)buffers * sizeof(bf16) *\n"
            "         ((size_t)rows * (slots * BK + 8) + (size_t)slots * BK * "
            "(cw + 8));") in src
    assert "WARPS_M = TM >= 32 ? 2 : 1;" in src
    assert "WARPS_N = CW / 16;" in src
    assert "NC = 32 * WARPS_M * WARPS_N;" in src
    assert "THREADS = NC + NP;" in src
    got = {n: int(v) for n, v in re.findall(
        r"constexpr int (CHUNK_PRODUCERS|DSPIPE_PRODUCERS) = (\d+);", src)}
    assert got == {"CHUNK_PRODUCERS": pl.CHUNK_PRODUCERS,
                   "DSPIPE_PRODUCERS": pl.DSPIPE_PRODUCERS}
    chunk = re.findall(r"bcsc_lab_chunk_kernel<N, (\d+)>", src)
    assert tuple(int(r) for r in dict.fromkeys(chunk)) == pl.CHUNK_ROWS
    ds = re.findall(r"bcsc_lab_dspipe_kernel<(\d+)>", src)
    assert tuple(int(r) for r in dict.fromkeys(ds)) == pl.DSPIPE_ROWS
    assert "const int csl = (p.U + N - 1) / N, nbuf = N > 1 ? 2 : 1;" in src
    assert "stage_bytes(32, DSPIPE_CW, p.U, 2)" in src


def test_fused_probes_have_no_fma_loop():
    """chunkN and dspipe multiply with mma.sync only, minimal with wgmma
    only: no FMA loop is left in the source."""
    src = _src()
    for kern in ("bcsc_lab_chunk_kernel", "bcsc_lab_dspipe_kernel"):
        start = src.index(f"    {kern}(")
        body = src[start:src.index("\n}\n", start)]
        assert "mma_slots<T::MT>" in body and "fmaf" not in body
    start = src.index("    bcsc_lab_minimal_wgmma_kernel(")
    body = src[start:src.index("\n}\n", start)]
    assert "wgmma_m64n128k16_bf16(acc, da, db);" in body
    assert "fmaf" not in src
    assert "fma_slots" not in src


def _deep(U, m=50):
    rng = np.random.default_rng(0)
    keep = np.zeros((U, 4), bool)
    keep[0::2, 0] = keep[1::2, 3] = True
    bmat = rng.standard_normal((32 * U, 128)).astype(np.float32)
    bmat *= np.kron(keep, np.ones((32, 32), np.float32))
    return (m, 128, 32 * U), BcscMatrix.from_dense(bmat, 32, 32)


@pytest.mark.parametrize("U", [1, 5, 21, 26, 32, 41, 42, 81])
def test_probes_report_path_and_plan(U):
    shape, bcsc = _deep(U)
    probes = bcsc_lab.make_variants(shape, bcsc, 0.0, "cpu")
    assert probes["minimal"].path == "wgmma"
    for name, plan in PLANS.items():
        assert probes[name].U == U
        assert probes[name].path == "mma"
        assert probes[name].stage == plan(U)


@pytest.mark.parametrize("U", [26, 42, 81])
def test_refused_plan_still_runs_plain_on_cpu(U):
    """The plan bounds the kernel only: on CPU tensors every probe runs its
    plain version, the refused ones too, and launches nothing (1e-4
    normf_rel against float64: bf16 in, f32 sums)."""
    (m, n, k), bcsc = _deep(U, m=5)
    probes = bcsc_lab.make_variants((m, n, k), bcsc, 0.0, "cpu")
    a = torch.as_tensor(np.random.default_rng(1).standard_normal((m, k)))
    v = torch.as_tensor(bcsc.data)
    want = (a.to(torch.bfloat16).double()
            @ torch.as_tensor(bcsc.to_dense()).to(torch.bfloat16).double())
    before = dict(pl.launches)
    for name in PLANS:
        got = probes[name](a, v)
        check(want, got, margin=1e-4)
    assert pl.launches == before
