"""The "wgmma" route's tile at every bf16 blocking it serves
(`libxsmm_torch.kernels.spmm.wgmma_plan`), against the CUDA source's
constants and formulas (csrc/spmm_kernels.cu `SwTile`, `sw_kc` and the
launchers that pick the tile), on the CPU.

bf16 blocks of whole k16 steps and whole 16-byte rows (bk % 16 == 0, bn %
8 == 0) all take `bcsc_spmm_wgmma_kernel` (scheduled, supertile) or
`bcsc_union_wgmma_kernel` (the k-union, both forms): a slice KC deep (the
deepest of 64, 32, 16 that divides bk), value boxes at most 64 columns
wide, each landing in the swizzle of its rows' bytes (128, 64, 32, or
none at 16), stages padded to 1024 bytes, two blocks an SM. Past that
envelope the plan refuses and the route is another. Exact: integers only.
"""

import pathlib
import re

import pytest
import torch

from libxsmm_torch.kernels import spmm as pk

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "libxsmm_torch" / "kernels" / "csrc" / "spmm_kernels.cu"
BF16 = torch.bfloat16

BKS = [16, 32, 48, 64, 80, 96, 128, 256]
BNS = [8, 16, 24, 32, 40, 48, 64, 96, 128, 256]
UNION_BNS = [8, 16, 32, 64, 128]


def test_plan_constants_mirror_the_cuda_source():
    """Tile rows, ring alignment and the shared-memory cap are the
    kernel's; the source sizes the slice, the stage, the ring and the
    tile's columns by the plan's formulas. The source is read with every
    run of white space taken as one blank, so its layout does not
    matter."""
    src = " ".join(SRC.read_text().split())
    got = {name: int(v) for name, v in re.findall(
        r"constexpr int (SW_TM|SF_ALIGN|SF_SMEM_MAX) = (\d+);", src)}
    assert got == {"SW_TM": pk._SW_TM, "SF_ALIGN": pk._SW_ALIGN,
                   "SF_SMEM_MAX": pk._SW_SMEM_MAX}
    assert "return bk % 64 == 0 ? 64 : bk % 32 == 0 ? 32 : 16;" in src
    assert "static constexpr int STAGE = (LOAD + 1023) / 1024 * 1024;" in src
    assert ("static constexpr int STAGES = KC == 64 ? 3 : KC == 32 ? 4 : 8;"
            in src)
    assert ("static constexpr int SMEM = SF_ALIGN + STAGES * STAGE + 2 * "
            "STAGES * 8;") in src
    assert "static constexpr int LOAD = A_BYTES + NB * V_BOX;" in src
    assert "template <int TN, int KC, int BOX = (TN < 64 ? TN : 64)>" in src
    assert 'static_assert(2 * SMEM <= SF_SMEM_MAX, "two blocks an SM");' in src
    # the scheduled launcher's column widths, the union's box widths
    for tn in (8, 16, 32):
        assert (f"if (bn <= {tn}) return "
                f"launch_spmm_wgmma_tn<TO, {tn}, KC>") in src
    assert "launch_union_wgmma_at<TO, KC, 64, 32, true>" in src
    assert "launch_union_wgmma_at<TO, KC, 64, 8, true>" in src
    for box, pw in ((8, 8), (16, 8), (32, 32)):
        assert (f"if (bn == {box}) return launch_union_wgmma_at<TO, KC, "
                f"{box}, {pw}, false>") in src
    # the route: every bf16 blocking of whole k16 steps and 16-byte rows
    assert ("if (in_type == T_BF16 && bk % 16 == 0 && bn % 8 == 0) return "
            "SP_WGMMA;") in src
    assert "SP_MMA" not in src and not re.search(r"(?<!wg)mma_kernel", src)


def _check_tile(plan, bk):
    kc, box = plan["kc"], plan["box"]
    assert kc in (16, 32, 64) and bk % kc == 0
    assert all(bk % d for d in (32, 64) if d > kc)     # the deepest
    assert box in (8, 16, 32, 64) and plan["tn"] % box == 0
    a_bytes = pk._SW_TM * kc * 2
    v_box = kc * box * 2
    assert plan["load"] == a_bytes + (plan["boxes"] - 1) * v_box
    # A's slice and every box start on their swizzle's repeat (8 rows)
    assert a_bytes % 1024 == 0 and v_box % (8 * box * 2) == 0
    assert plan["stage"] % 1024 == 0
    assert 0 <= plan["stage"] - plan["load"] < 1024
    assert plan["stages"] == {64: 3, 32: 4, 16: 8}[kc]
    assert plan["smem"] == (pk._SW_ALIGN + plan["stages"] * plan["stage"]
                            + 16 * plan["stages"])
    assert 2 * plan["smem"] <= pk._SW_SMEM_MAX


@pytest.mark.parametrize("bn", BNS)
@pytest.mark.parametrize("bk", BKS)
def test_scheduled_plan(bk, bn):
    """The scheduled and supertile kernel's tile: the least of 8, 16, 32,
    64, 128 columns that covers bn (a wider block column in 128-column
    chunks), boxes of min(TN, 64) columns, one box of A a stage."""
    assert pk.spmm_path(BF16, bk, bn) == "wgmma"
    plan = pk.wgmma_plan(bk, bn)
    _check_tile(plan, bk)
    tn = plan["tn"]
    assert tn >= min(bn, 128) and (tn == 8 or tn // 2 < min(bn, 128))
    assert plan["box"] == min(tn, 64)
    assert plan["boxes"] == 1 + tn // min(tn, 64)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("bn", UNION_BNS)
@pytest.mark.parametrize("bk", BKS)
def test_union_plan(bk, bn, compact):
    """The union kernel's tile: the 128-column group; the fused form's
    boxes never straddle two value blocks (min(bn, 64) columns, so 128 /
    bn x bn / box of them), the compacted form's are 64 wide."""
    assert pk.spmm_path(BF16, bk, bn, union=True) == "wgmma"
    plan = pk.wgmma_plan(bk, bn, union=True, compact=compact)
    _check_tile(plan, bk)
    assert plan["tn"] == pk.GROUP
    if compact:
        assert (plan["box"], plan["boxes"]) == (64, 3)
    else:
        assert plan["box"] == min(bn, 64) and bn % plan["box"] == 0
        assert plan["boxes"] == 1 + (pk.GROUP // bn) * (bn // plan["box"])


@pytest.mark.parametrize("bk,bn,union,compact,want", [
    (16, 64, False, False, (16, 64, 64, 2, 8, 50304)),
    (16, 8, False, False, (16, 8, 8, 2, 8, 42112)),
    (48, 32, False, False, (16, 32, 32, 2, 8, 42112)),
    (32, 16, False, False, (32, 16, 16, 2, 4, 37952)),
    (48, 24, False, False, (16, 32, 32, 2, 8, 42112)),
    (32, 32, False, False, (32, 32, 32, 2, 4, 42048)),
    (128, 128, False, False, (64, 128, 64, 3, 3, 99376)),
    (16, 64, True, False, (16, 128, 64, 3, 8, 66688)),
    (16, 64, True, True, (16, 128, 64, 3, 8, 66688)),
    (16, 8, True, False, (16, 128, 8, 17, 8, 66688)),
    (16, 8, True, True, (16, 128, 64, 3, 8, 66688)),
    (32, 16, True, False, (32, 128, 16, 9, 4, 66624)),
    (48, 32, True, False, (16, 128, 32, 5, 8, 66688)),
    (32, 32, True, False, (32, 128, 32, 5, 4, 66624))])
def test_plan_at_the_named_blockings(bk, bn, union, compact, want):
    """(KC, TN, box, boxes a stage, stages, shared memory) where the
    narrow blockings land: 16 x 64 lands two boxes a 6 KB stage, as 32 x
    32 does a 10 KB one; the fused union at 16 x 8 lands 17."""
    plan = pk.wgmma_plan(bk, bn, union=union, compact=compact)
    assert tuple(plan[key] for key in ("kc", "tn", "box", "boxes", "stages",
                                       "smem")) == want


@pytest.mark.parametrize("bk,bn,union", [
    (8, 8, False), (24, 32, False), (32, 4, False), (4, 48, False),
    (16, 12, False), (0, 8, False), (16, 0, False), (16, 24, True),
    (32, 48, True), (16, 256, True), (8, 64, True), (16, 4, True)])
def test_plan_refuses_past_the_route(bk, bn, union):
    """Blocks not whole k16 steps deep or 16-byte rows wide (and unions
    whose blocks do not tile a 128-column group) get no wgmma tile; where
    the builders take such a blocking, the route is another."""
    with pytest.raises(ValueError, match="no wgmma tile"):
        pk.wgmma_plan(bk, bn, union=union)
    if bk > 0 and bn > 0 and (bk % 16 or bn % 8):
        assert pk.spmm_path(BF16, bk, bn, union) == "fma"
