"""The streaming twins and the BCSC lab's probe kernels on the card, against
their plain versions.

Every test here needs a CUDA device and skips without one. On the GPU
machine run:

    python -m pytest tests/test_torch_cuda_labs.py --noconftest -q

(`--noconftest`: the repo's tests/conftest.py sets JAX up for the JAX
package's tests, and this file imports nothing of JAX or libxsmm_tpu.)

Shapes are ragged on purpose: row counts that are not a multiple of any
tile, a ragged last K chunk of the BRGEMM twin, odd union depths, a column
group with no block (every slot padded), the deepest union k = 1024 allows
(dspipe's 16-row tile), and value tensors 2 and 8 bytes off 16-byte
alignment (the wrappers copy them into aligned tensors).

Tolerances (matdiff normf_rel): 1e-5 for the BRGEMM twin (f32 sums of the
same values in another order); bit for bit for the passthrough; 1e-4 for the
probes (bf16 in, f32 sums in another order).
"""

import numpy as np
import pytest
import torch

from libxsmm_torch.descriptor import (BatchReduceConfig, BatchReduceType,
                                      GemmDescriptor, GemmFlags, GemmShape)
from libxsmm_torch.dtypes import Datatype
from libxsmm_torch.kernels import gemm as pk
from libxsmm_torch.kernels import spmm_lab as pl
from libxsmm_torch.matdiff import check
from libxsmm_torch.ops.sparse import BcscMatrix
from libxsmm_torch.scripts import bcsc_lab

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False

F32, BF16 = Datatype.F32, Datatype.BF16
TORCH = {F32: torch.float32, BF16: torch.bfloat16}
PROBES = ("minimal", "chunk1", "chunk2", "chunk4", "dspipe")


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.Generator(device="cuda").manual_seed(0)


def rand(gen, shape, dt=torch.float32, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda")
            * scale).to(dt)


def launched(counts, kernel, fn):
    before = counts[kernel]
    out = fn()
    torch.cuda.synchronize()
    assert counts[kernel] == before + 1
    assert out.is_cuda
    return out


# ---------------------------------------------------------------------------
# the BRGEMM's streaming twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", [F32, BF16], ids=lambda d: d.value)
@pytest.mark.parametrize("m,n,k,br,sg,mult", [
    (256, 256, 64, 1024, None, 1),    # the lab's shape, default K split
    (256, 256, 64, 1024, 16, 1),      # the lab's q2_sg16
    (256, 256, 64, 1024, 1, 32),      # the lab's q64_sg1
    (100, 72, 32, 12, 2, 1),          # ragged tiles, ragged last K chunk
    (64, 200, 64, 40, 3, 1),          # 20 groups at 3 a block
    (48, 96, 16, 64, None, 2),        # pack_q = 2 * 128/k
    (1, 1, 128, 3, None, 1),
    (70, 36, 64, 16, None, 1),        # n % 8 != 0: the FMA route in bf16
    (130, 136, 128, 8, 1, 1),         # ragged 128-row and 128-column tiles
])
def test_brgemm_sol_matches_plain(gen, dt, m, n, k, br, sg, mult):
    shape = GemmShape(m, n, k, a_in_type=dt, b_in_type=dt, out_type=F32)
    desc = GemmDescriptor(shape, GemmFlags.BETA_0,
                          BatchReduceConfig(BatchReduceType.STRIDE, br))
    q = 128 // k * mult
    sol = pk.build_packed_brgemm_sol(desc, br, step_groups=sg,
                                     pack_q=q if mult > 1 else None)
    a = rand(gen, (br // q, m, q * k), TORCH[dt])
    b = rand(gen, (br, k, n), TORCH[dt], 0.1)
    path = ("wgmma" if dt == BF16 and n % 8 == 0 else
            "tma_fma" if dt == F32 and n % 4 == 0 else "fma")
    assert sol.path == path
    before = pk.path_launches["packed_brgemm_sol"][path]
    got = launched(pk.launches, "packed_brgemm_sol", lambda: sol(a, b))
    assert pk.path_launches["packed_brgemm_sol"][path] == before + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    check(sol.plain(a, b), got, margin=1e-5)


def test_brgemm_sol_views_and_refusals(gen):
    shape = GemmShape(64, 64, 64, a_in_type=BF16, b_in_type=BF16,
                      out_type=F32)
    desc = GemmDescriptor(shape, GemmFlags.BETA_0,
                          BatchReduceConfig(BatchReduceType.STRIDE, 8))
    sol = pk.build_packed_brgemm_sol(desc, 8)
    a = rand(gen, (4, 64, 256), torch.bfloat16)[:, :, :128]   # a view
    b = rand(gen, (8, 64, 64), torch.bfloat16)
    check(sol.plain(a, b), sol(a, b), margin=1e-5)
    with pytest.raises(ValueError, match="different devices"):
        sol(a, b.cpu())


# ---------------------------------------------------------------------------
# the packed SMM's passthrough twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G,m", [(4096, 32), (7, 40), (3, 5), (1, 1),
                                 (5, 33), (6, 20), (9, 16), (2, 15)])
def test_passthrough_bit_exact(gen, G, m):
    pt = pk.build_packed_smm_passthrough(G, m)   # rows per thread 16, 8, 4
    a, b = rand(gen, (G, m, 128)), rand(gen, (G, m, 128), scale=0.1)
    got = launched(pk.launches, "packed_smm_passthrough", lambda: pt(a, b))
    assert torch.equal(got, a + b)


def test_passthrough_refuses_misaligned(gen):
    pt = pk.build_packed_smm_passthrough(2, 8)
    buf = rand(gen, (2 * 8 * 128 + 1,))
    a = buf[1:].view(2, 8, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pt(a, a)


# ---------------------------------------------------------------------------
# the BCSC lab's probes
# ---------------------------------------------------------------------------

def _pattern(kb, nb, cols, seed=0):
    """A BcscMatrix (kb*32, nb*32) whose block column j holds the block
    rows cols.get(j, ())."""
    rng = np.random.default_rng(seed)
    keep = np.zeros((kb, nb), bool)
    for j, rows in cols.items():
        keep[list(rows), j] = True
    bmat = rng.standard_normal((kb * 32, nb * 32)).astype(np.float32)
    bmat *= np.kron(keep, np.ones((32, 32), np.float32))
    return BcscMatrix.from_dense(bmat, 32, 32)


def _cases():
    """name -> (m, k, n, BcscMatrix)."""
    lab20, _ = bcsc_lab.build_pattern(0.2)
    lab05, _ = bcsc_lab.build_pattern(0.05)
    small, _ = bcsc_lab.build_pattern(0.3, m=256, k=256, n=256)
    return {
        "lab20_m1024": (1024, 1024, 1024, lab20),           # U = 21
        "lab05_m1000": (1000, 1024, 1024, lab05),           # U = 10
        "lab30_256_m100": (100, 256, 256, small),
        # three groups: unions of 3 and 5 (odd), the middle one empty
        "empty_group_m70": (70, 256, 384, _pattern(
            8, 12, {0: (0, 2, 5), 1: (2,), 9: (1, 3, 4, 6, 7), 11: (4,)})),
        # one group with all 32 block rows: dspipe's 16-row tile
        "deep_U32_m50": (50, 1024, 128, _pattern(
            32, 4, {0: range(0, 32, 2), 3: range(1, 32, 2)})),
        "one_slot_m3": (3, 128, 256, _pattern(4, 8, {5: (3,)})),
    }


CASES = _cases()


@pytest.fixture(scope="module")
def probes():
    """name -> (make_variants output, a, values) on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    out = {}
    for name, (m, k, n, bcsc) in CASES.items():
        rng = np.random.default_rng(1)
        a = torch.as_tensor(rng.standard_normal((m, k)),
                            device="cuda").to(torch.bfloat16)
        v = torch.as_tensor(bcsc.data, device="cuda").to(torch.bfloat16)
        out[name] = (bcsc_lab.make_variants((m, n, k), bcsc, 0.0, "cuda"),
                     a, v)
    return out


def _counter(probe):
    return ("bcsc_lab_minimal" if probe == "minimal" else
            "bcsc_lab_dspipe" if probe == "dspipe" else "bcsc_lab_chunk")


@pytest.mark.parametrize("probe", PROBES)
@pytest.mark.parametrize("case", list(CASES))
def test_probe_matches_plain(probes, case, probe):
    variants, a, v = probes[case]
    fn = variants[probe]
    got = launched(pl.launches, _counter(probe), lambda: fn(a, v))
    assert got.dtype == torch.float32 and got.shape == (a.shape[0],
                                                        fn.n)
    check(fn.plain(a, v), got, margin=1e-4)
    if probe != "minimal":
        bcsc = CASES[case][3]
        dense = torch.as_tensor(bcsc.to_dense(), device="cuda")
        want = a.double() @ dense.to(torch.bfloat16).double()
        check(want, got, margin=1e-4)


@pytest.mark.parametrize("offset", [1, 4])        # 2 and 8 bytes off
@pytest.mark.parametrize("probe", PROBES[1:])
def test_probe_unaligned_values(probes, probe, offset):
    variants, a, v = probes["empty_group_m70"]
    buf = torch.zeros(v.numel() + offset, dtype=v.dtype, device="cuda")
    vu = buf[offset:].view(v.shape)
    vu.copy_(v)
    assert vu.data_ptr() % 16
    fn = variants[probe]
    got = launched(pl.launches, _counter(probe), lambda: fn(a, vu))
    check(fn.plain(a, v), got, margin=1e-4)
    au = torch.zeros(a.numel() + offset, dtype=a.dtype, device="cuda")
    au = au[offset:].view(a.shape)
    au.copy_(a)
    check(fn.plain(a, v), fn(au, vu), margin=1e-4)


def test_probe_repeats_bit_for_bit(probes):
    variants, a, v = probes["lab20_m1024"]
    for probe in PROBES:
        assert torch.equal(variants[probe](a, v), variants[probe](a, v))
