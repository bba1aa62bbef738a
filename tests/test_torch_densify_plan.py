"""The BCSC densifier's routes and launch plan (`libxsmm_torch.kernels.spmm`
`BcscDensify.route`, `densify_plan`) against the CUDA kernel's constants
and formulas, and its walk simulated in numpy, on the CPU.

The kernel (csrc/spmm_kernels.cu `bcsc_densify_kernel`) copies whole output
tiles of bk rows of cpr units: 16-byte units on the vector route, units of
the element's size on the element route. Block b takes the run of tiles
j0 .. j0 + tb - 1 of block row b // runs; thread (tid % qb, tid // qb)
takes unit columns q, q + qb, ... of the run and rows r0, r0 + rs, ....
The simulations count what each unit of the output receives; exact:
integers only.
"""

import pathlib

import numpy as np
import pytest
import torch

from libxsmm_torch.kernels import spmm as pk

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "libxsmm_torch" / "kernels" / "csrc" / "spmm_kernels.cu"


def test_densify_constants_mirror_the_cuda_source():
    """Block size and route codes are the kernel's (csrc DN_*), and the
    source routes, sizes the block and the grid and walks the run by the
    plan's formulas."""
    src = SRC.read_text()
    assert f"constexpr int DN_THREADS = {pk._DN_THREADS};" in src
    assert f"constexpr int DN_ROWS = {pk._DN_ROWS};" in src
    assert "enum { DN_VECTOR = 0, DN_ELEM = 1 };" in src
    assert pk._DN_ROUTES == {"vector": 0, "element": 1}
    # the vector route only where compact_route allows it
    assert ("(route == DN_VECTOR &&\n       compact_route(bn, elem_size, "
            "vals, out) != CP_BULK)") in src
    assert "bn * elem_size / 16, tb, rs, nzero, st);" in src
    assert "const long long qb = cols < DN_THREADS ? cols : DN_THREADS;" \
        in src
    assert "const long long grid = (long long)kb * ((nb + tb - 1) / tb);" \
        in src
    assert "if (qb * rs > DN_THREADS) return cudaErrorInvalidValue;" in src
    assert "const int q = threadIdx.x % qb, r0 = threadIdx.x / qb;" in src
    assert "for (int cq = q; cq < nt * cpr; cq += qb) {" in src
    assert "const int t = cq / cpr, c = cq - t * cpr;" in src


def _tensor(dtype, numel, offset=0):
    """A CPU tensor of `numel` elements whose first element lies `offset`
    elements past a 16-byte-aligned allocation."""
    base = torch.zeros(numel + offset + 16, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    return base[offset:offset + numel]


DTYPES = [torch.int8, torch.bfloat16, torch.float32, torch.float64]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bn", [1, 2, 4, 8, 12, 16, 32, 48, 128])
def test_densify_route_by_size_and_alignment(dtype, bn):
    """Vector where a tile row is whole 16-byte units (below 16 bytes never,
    at and past it where the bytes divide) and both addresses are 16-byte
    aligned; element units otherwise: a values view one element off, or
    an output off alignment, takes the element route at every size."""
    itemsize = dtype.itemsize
    fn = pk.BcscDensify(4 * 8, 2 * bn, 8, bn,
                        np.zeros((4, 2), np.int32), 1, "cpu")
    whole = (bn * itemsize) % 16 == 0
    values, out = _tensor(dtype, 8 * bn), _tensor(dtype, 64 * bn)
    assert fn.route(values, out) == ("vector" if whole else "element")
    assert fn.route(_tensor(dtype, 8 * bn, 1), out) == "element"
    assert fn.route(values, _tensor(dtype, 64 * bn, 1)) == "element"
    if bn * itemsize < 16:
        assert fn.route(values, out) == "element"


def _walk(kb, nb, bk, cpr, sms):
    """Each output unit's writes, and each tile's map reads, over the
    kernel's grid and threads; every write checked against its source."""
    tb, qb, rs, grid = pk.densify_plan(kb, nb, bk, cpr, sms)
    runs = -(-nb // tb)
    writes = np.zeros((kb * bk, nb * cpr), np.int64)
    reads = np.zeros((kb, nb), np.int64)
    tid = np.arange(qb * rs)
    q, r0 = tid % qb, tid // qb
    for b in range(grid):
        i, j0 = b // runs, (b % runs) * tb
        nt = min(tb, nb - j0)
        reads[i, j0:j0 + nt] += 1
        passes = -(-nt * cpr // qb)
        steps = -(-bk // rs)
        cq = q[:, None, None] + qb * np.arange(passes)[None, :, None]
        r = r0[:, None, None] + rs * np.arange(steps)[None, None, :]
        cq, r = np.broadcast_arrays(cq, r)
        live = (cq < nt * cpr) & (r < bk)
        cq, r = cq[live], r[live]
        t, c = cq // cpr, cq % cpr
        rows, cols = i * bk + r, j0 * cpr + cq
        # the unit copied is unit (r, c) of tile (i, j0 + t)
        assert (rows // bk == i).all() and (cols // cpr == j0 + t).all()
        assert (rows % bk == r).all() and (cols % cpr == c).all()
        np.add.at(writes, (rows, cols), 1)
    return (tb, qb, rs, grid), writes, reads


# (kb, nb, bk, cpr, sms): the streaming case (k = n = 1024, 32 x 32 bf16:
# 4 units a row on the vector route), its element route (bn = 4 bf16), f32
# 32 x 32, 16 x 128 bf16, bn = 48 f32 (12 units, no power of two), int8
# 16 wide (one unit), a tile row wider than a block (bn = 1024 f64: 512
# units), one tile, k past 65,535 rows at small n, cards of 1, 78 and 114
# SMs
PLANS = [(32, 32, 32, 4, 132), (32, 256, 32, 4, 132), (32, 32, 32, 8, 132),
         (8, 8, 16, 16, 132), (4, 6, 8, 12, 132), (16, 8, 16, 1, 132),
         (2, 1, 8, 512, 132), (1, 1, 8, 1, 132), (4400, 2, 16, 2, 132),
         (5, 7, 24, 3, 1), (3, 40, 8, 4, 78), (2, 33, 64, 2, 114)]


@pytest.mark.parametrize("kb,nb,bk,cpr,sms", PLANS)
def test_densify_plan_covers_every_tile_once(kb, nb, bk, cpr, sms):
    """Every unit of every output tile is written exactly once, from its
    own source unit; every tile's map entry is read by exactly one block;
    a block has at most _DN_THREADS threads; the grid covers the SMs
    unless one tile a block cannot."""
    (tb, qb, rs, grid), writes, reads = _walk(kb, nb, bk, cpr, sms)
    assert (writes == 1).all()
    assert (reads == 1).all()
    assert 1 <= tb <= min(nb, pk._DN_THREADS)
    assert qb == min(tb * cpr, pk._DN_THREADS) and 1 <= rs <= bk
    assert qb * rs <= pk._DN_THREADS
    # each thread a batch of at most _DN_ROWS rows where the block allows
    assert rs == min(-(-bk // pk._DN_ROWS), pk._DN_THREADS // qb)
    assert grid == kb * -(-nb // tb)
    assert grid >= sms or tb == 1
    assert grid < 2 ** 31


def test_densify_plan_at_the_streaming_case():
    """k = n = 1024, 32 x 32 bf16 on 132 SMs: runs of 4 tiles, 16 column
    and 8 row threads, 256 blocks of 128 threads, four units a thread."""
    assert pk.densify_plan(32, 32, 32, 4, 132) == (4, 16, 8, 256)


def test_densify_launch_plan_follows_the_route():
    """The wrapper's plan counts 16-byte units on the vector route and
    elements on the element route; it is made once a route and type."""
    fn = pk.BcscDensify(1024, 1024, 32, 32, np.zeros((32, 32), np.int32),
                        0, "cpu")
    sms = [132]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pk, "_num_sms", lambda device: sms[0])
        assert fn.launch_plan("vector", 2) == (4, 8)
        tb, _, rs, _ = pk.densify_plan(32, 32, 32, 32, 132)
        assert fn.launch_plan("element", 2) == (tb, rs)
        sms[0] = 1              # a plan made once is not made again
        assert fn.launch_plan("vector", 2) == (4, 8)
        assert fn.launch_plan("vector", 4) == pk.densify_plan(
            32, 32, 32, 8, 1)[::2]


def test_densify_cpu_call_checks_shape_and_device():
    """On the CPU the call runs the plain version; a shape other than
    (nblocks, bk, bn) and a device other than the map's raise."""
    gmap = np.array([[0, 1], [1, 1]], np.int32)
    fn = pk.BcscDensify(16, 16, 8, 8, gmap, 1, "cpu")
    v = torch.arange(64, dtype=torch.float32).reshape(1, 8, 8)
    got = fn(v)
    assert torch.equal(got[:8, :8], v[0]) and not got[:8, 8:].any()
    assert not got[8:].any()
    with pytest.raises(ValueError, match="expected shape"):
        fn(v.reshape(8, 8))
    with pytest.raises(ValueError, match="different devices"):
        fn(torch.zeros(1, 8, 8, device="meta"))
