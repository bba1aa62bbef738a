"""The packed SMM's passthrough twin as one streaming pass: its plan
(`libxsmm_torch.kernels.gemm.passthrough_plan`) against the CUDA kernel's
constants, and the kernel's walk over the operands simulated in numpy from
that plan, on the CPU.

The kernel (csrc/gemm_kernels.cu `packed_smm_passthrough_kernel`) views
the (G, m, 128) f32 operands as a flat run of float4 units; thread t of
block x adds unit x * PT_THREADS + t, those past the end masked. The
simulation replays exactly that and counts the writes of every element.
Exact: integers only.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from libxsmm_torch.kernels import gemm as pk

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "libxsmm_torch" / "kernels" / "csrc" / "gemm_kernels.cu"


def test_passthrough_constants_mirror_the_cuda_source():
    """The plan's block size is the kernel's (csrc PT_THREADS), and the
    entry launches the plan's grid: one block per PT_THREADS units."""
    src = SRC.read_text()
    got = {name: int(v) for name, v in
           re.findall(r"constexpr int (PT_[A-Z]+) = (\d+);", src)}
    assert got == {"PT_THREADS": pk._PT_THREADS}
    assert "const long long grid = (units + PT_THREADS - 1) / PT_THREADS;" \
        in src
    assert ("const long long i = (long long)blockIdx.x * PT_THREADS + "
            "threadIdx.x;") in src
    assert "if (i < units) {" in src


def _walk(units, grid):
    """Writes per float4 unit of the kernel's walk: thread t of block x on
    unit x * PT_THREADS + t, masked past the end."""
    i = (np.arange(grid)[:, None] * pk._PT_THREADS
         + np.arange(pk._PT_THREADS)[None, :]).reshape(-1)
    return np.bincount(i[i < units], minlength=units)


@pytest.mark.parametrize("m", [1, 8, 17, 32, 33])
@pytest.mark.parametrize("G", [1, 3, 4096])
def test_passthrough_writes_every_element_once(G, m):
    units, grid = pk.passthrough_plan(G, m)
    assert units == G * m * 128 // 4
    # no block is empty: the last one holds at least one unit
    assert (grid - 1) * pk._PT_THREADS < units <= grid * pk._PT_THREADS
    writes = _walk(units, grid)
    # every element of (G, m, 128): its unit's count, four floats a unit
    elems = np.repeat(writes.astype(np.uint8), 4).reshape(G, m, 128)
    assert (elems == 1).all()


def test_passthrough_wrapper_follows_the_plan():
    """On the CPU the wrapper runs the plain a + b; its unit count is the
    plan's."""
    pt = pk.build_packed_smm_passthrough(3, 17)
    assert pt.units == pk.passthrough_plan(3, 17)[0]
    a = torch.arange(3 * 17 * 128, dtype=torch.float32).view(3, 17, 128)
    assert torch.equal(pt(a, a), a + a)
    assert pk.launches["packed_smm_passthrough"] == 0


def test_stream_time_rows_and_refusals():
    """scripts/stream_time.py refuses a row it does not have, and times the
    card only: without one it exits before timing anything."""
    from libxsmm_torch.scripts import stream_time
    with pytest.raises(SystemExit, match="no row"):
        stream_time.main(["--rows", "passthrough,bogus"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a CUDA device"):
            stream_time.main(["--rows", "designs"])


def test_designs_source_serves_every_timed_configuration():
    """Every persistent (unroll, hint) and ring chunk the designs row times
    has its instantiation in scripts/passthrough_designs.cu, and the ring's
    stages fit in an SM's shared memory at its blocks an SM."""
    from libxsmm_torch.scripts import stream_time as stt
    src = (ROOT / "libxsmm_torch" / "scripts"
           / "passthrough_designs.cu").read_text()
    cases = set(re.findall(r"PT_CASE\((\d), (\d)\)", src))
    assert {(str(u), str(h)) for u, _bps, h in stt.PERSISTENT} <= cases
    head = int(re.search(r"constexpr int RING_HEAD = (\d+);", src).group(1))
    for chunk, stages, bps in stt.RING:
        assert f"case {chunk}: return launch_ring<{chunk}>" in src
        assert bps * (head + stages * 2 * chunk) <= 228 * 1024
