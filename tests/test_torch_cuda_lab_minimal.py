"""The BCSC lab's `minimal` probe on the card: the wgmma kernel fed by TMA
(csrc/spmm_lab_kernels.cu bcsc_lab_minimal_wgmma_kernel) against its plain
version.

Every test here needs a CUDA device and skips without one. On the GPU
machine run:

    python -m pytest tests/test_torch_cuda_lab_minimal.py --noconftest -q

(`--noconftest`: the repo's tests/conftest.py sets JAX up for the JAX
package's tests, and this file imports nothing of JAX or libxsmm_tpu.)

Shapes: ragged m (1, 70, 1000, 4100; 4100 x 1024 is 520 blocks, four
waves), U = 1 (one half-empty slice), U = 21 (the
lab's) and U = 32 (the deepest k = 1024 allows), n from 128 to 1024, and k
past 32U with A's extra columns NaN (the tensor map spans the first 32U
columns only).

Tolerance (matdiff normf_rel): 1e-4 (bf16 in, f32 sums in another order).
"""

import pytest
import torch

from libxsmm_torch.kernels import spmm_lab as pl
from libxsmm_torch.matdiff import check

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.Generator(device="cuda").manual_seed(0)


def _probe(gen, m, n, U, extra_k=0):
    k = 32 * U + extra_k
    rhs = torch.randn(n // 128, 32 * U, 128, generator=gen,
                      device="cuda").to(torch.bfloat16)
    fn = pl.BcscLabMinimal(m, n, k, 3, rhs)
    a = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    if extra_k:
        a[:, 32 * U:] = float("nan")
    v = torch.zeros(3, 32, 32, device="cuda", dtype=torch.bfloat16)
    return fn, a, v


def _run(fn, a, v):
    before = pl.launches["bcsc_lab_minimal"]
    out = fn(a, v)
    torch.cuda.synchronize()
    assert pl.launches["bcsc_lab_minimal"] == before + 1
    return out


@pytest.mark.parametrize("n", [128, 384, 1024])
@pytest.mark.parametrize("U", [1, 21, 32])
@pytest.mark.parametrize("m", [1, 70, 1000, 4100])
def test_minimal_matches_plain(gen, m, U, n):
    fn, a, v = _probe(gen, m, n, U)
    assert fn.path == "wgmma" and fn.rhs_map is not None
    got = _run(fn, a, v)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    check(fn.plain(a, v), got, margin=1e-4)
    # against float64 of the same bf16 operands
    want = (a[:, :32 * U].double()
            @ fn.rhs.double()).transpose(0, 1).reshape(m, n)
    check(want, got, margin=1e-4)


@pytest.mark.parametrize("U,extra_k", [(1, 32), (5, 64), (21, 320)])
def test_minimal_reads_only_its_panel(gen, U, extra_k):
    """k > 32U, A's columns past 32U NaN: the map's extent stops at 32U,
    so the result is finite and equal to the plain version's."""
    fn, a, v = _probe(gen, 130, 256, U, extra_k)
    got = _run(fn, a, v)
    assert torch.isfinite(got).all()
    check(fn.plain(a, v), got, margin=1e-4)


def test_minimal_tile_follows_the_plan(gen):
    """At the lab's U and ragged m, minimal_plan's grid of 64-row tiles,
    the last one cut short, yields the plain version's result."""
    for m in (1000, 4100):
        fn, a, v = _probe(gen, m, 1024, 21)
        assert pl.minimal_plan(m, 1024, 21).blocks == -(-m // 64) * 8
        check(fn.plain(a, v), _run(fn, a, v), margin=1e-4)


def test_minimal_unaligned_operands_and_repeats(gen):
    """A view of A off 16-byte alignment is copied first; a repeat is bit
    for bit (each block writes its tile once)."""
    fn, a, v = _probe(gen, 333, 512, 7)
    buf = torch.zeros(a.numel() + 3, dtype=a.dtype, device="cuda")
    au = buf[3:].view(a.shape)
    au.copy_(a)
    assert au.data_ptr() % 16
    got = _run(fn, au, v)
    check(fn.plain(a, v), got, margin=1e-4)
    assert torch.equal(got, _run(fn, a, v))


def test_minimal_refuses_a_rhs_that_does_not_fit(gen):
    rhs = torch.zeros(2, 64, 128, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="does not fit"):
        pl.BcscLabMinimal(10, 256, 32, 1, rhs)
