"""The union RHS compactor's routes and plan
(`libxsmm_torch.kernels.spmm.compact_route`, `compact_plan`) against the
CUDA kernels' constants and formulas, and both routes' walks simulated in
numpy, on the CPU.

The bulk route (csrc/spmm_kernels.cu `bcsc_union_compact_bulk_kernel`)
cuts each slot's bk rows into tiles of the plan's rows; block x takes
tiles x, x + grid, ...; a tile's W value-block pieces land in a stage of
shared memory `piece` bytes apart and its rows leave as 16-byte units, unit
u at row u >> lg(upr), piece w = (u % upr) >> lg(cpr). The element route
(`bcsc_union_compact_kernel`) takes one slot a block. The simulations count
what each route writes; exact: integers only.
"""

import pathlib
import re

import numpy as np
import pytest

from libxsmm_torch.kernels import spmm as pk

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "libxsmm_torch" / "kernels" / "csrc" / "spmm_kernels.cu"


def test_compact_constants_mirror_the_cuda_source():
    """Block size, blocks an SM, stage bytes and route codes are the
    kernel's (csrc CP_*), and the source routes, sizes tiles and pads
    pieces by the plan's formulas."""
    src = SRC.read_text()
    got = {name: int(v) for name, v in
           re.findall(r"constexpr int (CP_[A-Z]+) = (\d+);", src)}
    assert got == {"CP_THREADS": pk._CP_THREADS, "CP_BLOCKS": pk._CP_BLOCKS,
                   "CP_STAGE": pk._CP_STAGE}
    assert "enum { CP_BULK = 0, CP_ELEM = 1 };" in src
    assert pk._CP_ROUTES == {"bulk": 0, "element": 1}
    assert ("sized && (bn * esz) % 16 == 0 && addr % 16 == 0 ? CP_BULK : "
            "CP_ELEM") in src
    # the entry refuses bulk copies where compact_route says element
    assert ("(route == CP_BULK && compact_route(bn, esz, vals, out) != "
            "CP_BULK)") in src
    assert "const int fit = (CP_STAGE - W * 128) / row;" in src
    assert ("return rb * cpr * 16 + (((cpr * 16 * (1 - rb)) % 128) + 128) "
            "% 128;") in src
    assert "return (16 + 8 * W + 127) / 128 * 128;" in src


@pytest.mark.parametrize("itemsize", [1, 2, 4, 8])
@pytest.mark.parametrize("bn", [1, 2, 4, 8, 16, 32, 64, 128])
def test_compact_route_by_size_and_alignment(bn, itemsize):
    """Bulk where a block row is whole 16-byte units and both addresses
    are 16-byte aligned; element units otherwise, whatever the other
    conditions say."""
    whole = (bn * itemsize) % 16 == 0
    assert pk.compact_route(bn, itemsize, 0, 4096) == (
        "bulk" if whole else "element")
    for off in (1, 2, 4, 8):
        assert pk.compact_route(bn, itemsize, off, 4096) == "element"
        assert pk.compact_route(bn, itemsize, 4096, 4096 + off) == "element"
    assert pk.compact_route(bn, 3, 0, 0) == "element"   # no 3-byte type


# (nsg, U, bk, bn, itemsize, sms): the streaming case (bf16 32 x 32, U =
# 21), more slots than 4 x 132, U = 1, one group, f32 and int8 blockings,
# deep blocks cut into tiles (bk 256 f32, bk 96 f64), tiny grids
PLANS = [(8, 21, 32, 32, 2, 132), (40, 16, 32, 32, 2, 132),
         (1, 1, 32, 32, 4, 132), (1, 5, 16, 64, 2, 132),
         (3, 7, 32, 32, 4, 78), (2, 9, 32, 16, 1, 114),
         (2, 3, 256, 128, 4, 132), (1, 2, 96, 8, 8, 132),
         (5, 4, 8, 4, 4, 2), (2, 33, 64, 128, 2, 1)]


def _bulk_walk(nsg, U, bk, bn, itemsize, sms):
    rows, per_slot, tiles, grid, piece, smem = pk.compact_plan(
        nsg, U, bk, bn, itemsize, sms)
    writes = np.zeros((nsg * U, bk), np.int64)
    taken = []
    for x in range(grid):
        ts = list(range(x, tiles, grid))
        taken.append(len(ts))
        for t in ts:
            slot, part = divmod(t, per_slot)
            r0 = part * rows
            writes[slot, r0:min(bk, r0 + rows)] += 1
    return writes, taken


@pytest.mark.parametrize("nsg,U,bk,bn,itemsize,sms", PLANS)
def test_compact_bulk_tiles_cover_every_slot_once(nsg, U, bk, bn, itemsize,
                                                  sms):
    """Every row of every slot is in exactly one tile, the tiles spread
    over a grid of at most CP_BLOCKS blocks an SM that keeps the rounds,
    and the two stages fit 48 KB (no shared-memory opt-in)."""
    rows, per_slot, tiles, grid, piece, smem = pk.compact_plan(
        nsg, U, bk, bn, itemsize, sms)
    W = 128 // bn
    assert 1 <= rows <= bk and per_slot == -(-bk // rows)
    assert W * piece <= pk._CP_STAGE and smem <= 48 * 1024
    assert 1 <= grid <= min(tiles, sms * pk._CP_BLOCKS)
    writes, taken = _bulk_walk(nsg, U, bk, bn, itemsize, sms)
    assert (writes == 1).all()
    assert min(taken) >= 1 and max(taken) - min(taken) <= 1
    assert max(taken) == -(-tiles // (sms * pk._CP_BLOCKS))


@pytest.mark.parametrize("nsg,U,bk,bn,itemsize,sms", PLANS)
def test_compact_bulk_units_cover_the_tile(nsg, U, bk, bn, itemsize, sms):
    """A tile's 16-byte units reach every (row, piece, unit) of the stage
    once, each piece's rows lie inside the piece, and the eight units of a
    quarter warp read distinct banks."""
    rows = pk.compact_plan(nsg, U, bk, bn, itemsize, sms)[0]
    piece = pk.compact_plan(nsg, U, bk, bn, itemsize, sms)[4]
    cpr, upr = bn * itemsize // 16, 128 * itemsize // 16
    lg_cpr, lg_upr = cpr.bit_length() - 1, upr.bit_length() - 1
    u = np.arange(rows * upr)
    r, cu = u >> lg_upr, u & (upr - 1)
    w, c = cu >> lg_cpr, cu & (cpr - 1)
    assert np.unique(r * upr + w * cpr + c).size == u.size
    off = w * piece + (r * cpr + c) * 16
    assert np.unique(off).size == u.size
    assert (r * cpr + c).max() * 16 + 16 <= rows * cpr * 16 <= piece
    quarters = (off % 128).reshape(-1, 8)
    assert all(np.unique(q).size == 8 for q in quarters)


@pytest.mark.parametrize("bn,itemsize", [(4, 2), (2, 4), (8, 1), (32, 4)])
def test_compact_element_units_cover_every_slot_once(bn, itemsize):
    """The element route: block x copies slot x, its units walk every
    (row, block, unit) of the slot once, whatever unit size the addresses
    allow."""
    bk, W = 8, 128 // bn
    for unit in (1, 2, 4, 8, 16):
        if (bn * itemsize) % unit:
            continue
        cpr = bn * itemsize // unit
        row_units = W * cpr
        i = np.arange(bk * row_units)
        r, cu = i // row_units, i % row_units
        w, c = cu // cpr, cu % cpr
        assert np.unique((r * W + w) * cpr + c).size == i.size
    src = SRC.read_text()
    assert "const long long slot = blockIdx.x;" in src
    assert ("launch_pdl(bcsc_union_compact_kernel<V>, dim3((unsigned)slots),"
            "\n                    CP_THREADS,") in src
