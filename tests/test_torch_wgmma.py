"""The packed BRGEMM's tensor-core route, on the CPU: which CUDA kernel a
packed BRGEMM and its streaming twin take (`kernels.gemm.brgemm_path`, the
predicate that mirrors what csrc/gemm_kernels.cu accepts), the K-split
planner of both routes across SM counts, and the port at the shapes that
reach the wgmma kernel on the card, held against the JAX package's
`build_packed_brgemm` and `build_packed_brgemm_sol` on the same numpy
inputs. The port's wrappers run their plain versions on CPU tensors; the JAX
side runs its Pallas kernels in interpret mode, as its own tests do.

Tolerances (matdiff normf_rel): 1e-4 for bf16 in / f32 out (bf16 products
exact in f32, sums in another order), 1e-2 for bf16 outputs (one rounding
at another point of the sum), 1e-5 for the twin (f32 sums of the same
values in another order).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import libxsmm_torch as xp
from libxsmm_torch import interop
from libxsmm_torch.kernels import gemm as pk
from libxsmm_torch.matdiff import check
from libxsmm_tpu.descriptor import GemmDescriptor, GemmFlags, GemmShape
from libxsmm_tpu.dtypes import Datatype
from libxsmm_tpu.kernels import gemm_pallas as rk

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32, BF16 = Datatype.F32, Datatype.BF16
B0 = GemmFlags.BETA_0
EPILOGUES = ["NONE", "IDENTITY", "RELU", "X2", "TANH", "SIGMOID", "GELU"]
SMS = (132, 114, 78)      # H100 SXM, H100 PCIe, a smaller part
TOL = {F32: 1e-4, BF16: 1e-2}


def port(obj):
    """The port's copy of a reference descriptor, via plain fields."""
    return interop.descriptor_from_fields(interop.descriptor_fields(obj))


def pair(x, dt):
    """(JAX array, CPU tensor) holding identical values of dt."""
    xj = jnp.asarray(x, jnp.bfloat16 if dt == BF16 else jnp.float32)
    return xj, interop.tensor_from_numpy(np.asarray(xj),
                                         xp.Datatype(dt.value), device="cpu")


def _desc(m, n, k, a_dt=BF16, o_dt=F32, flags=B0):
    return GemmDescriptor(GemmShape(m, n, k, a_in_type=a_dt, b_in_type=a_dt,
                                    out_type=o_dt), flags)


def _operands(rng, br, q, m, n, k):
    """Packed A (br/Q, m, Q*k) and B (br, k, n) as numpy arrays."""
    a = rng.standard_normal((br, m, k))
    a = a.reshape(br // q, q, m, k).transpose(0, 2, 1, 3).reshape(
        br // q, m, q * k)
    return a, rng.standard_normal((br, k, n)) * 0.5


# ---------------------------------------------------------------------------
# the route predicate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,n,want", [
    (torch.bfloat16, 8, "wgmma"), (torch.bfloat16, 40, "wgmma"),
    (torch.bfloat16, 136, "wgmma"), (torch.bfloat16, 256, "wgmma"),
    (torch.bfloat16, 1024, "wgmma"), (torch.bfloat16, 1, "fma"),
    (torch.bfloat16, 4, "fma"), (torch.bfloat16, 36, "fma"),
    (torch.bfloat16, 65, "fma"), (torch.float32, 8, "fma"),
    (torch.float32, 256, "fma"), (torch.float16, 256, "fma")])
def test_brgemm_path(dtype, n, want):
    """bf16 with whole 16-byte rows of B takes the tensor-core kernel; f32
    (no TF32) and other widths the FMA kernel."""
    assert pk.brgemm_path(dtype, n) == want


@pytest.mark.parametrize("a_dt,n,want", [(BF16, 256, "wgmma"),
                                         (BF16, 72, "wgmma"),
                                         (BF16, 20, "fma"),
                                         (F32, 256, "fma")], ids=str)
def test_wrappers_name_their_path(a_dt, n, want):
    d = port(_desc(64, n, 64, a_dt))
    fn = pk.build_packed_brgemm(d, 8)
    sol = pk.build_packed_brgemm_sol(d, 8)
    assert fn.path == sol.path == want


def test_tiles_mirror_the_cuda_source():
    """The planner's tile and slice are the kernel's (csrc TC_BM, TC_BN,
    TC_BK), and the kernel refuses what the predicate sends elsewhere."""
    src = (ROOT / "libxsmm_torch" / "kernels" / "csrc"
           / "gemm_kernels.cu").read_text()
    got = dict(re.findall(r"\b(TC_B[MNK]) = (\d+)", src))
    assert got == {"TC_BM": str(pk._TC_TILE), "TC_BN": str(pk._TC_TILE),
                   "TC_BK": str(pk._TC_BK)}
    assert "n % 8 || qk % TC_BK || kchunk % TC_BK" in src


# ---------------------------------------------------------------------------
# the K-split planner
# ---------------------------------------------------------------------------

PLAN_SHAPES = [
    # (m, n, k, br, pack_q multiple): the lab's shape and its deep packs,
    # ragged tiles, one group, a tall K
    (256, 256, 64, 1024, 1), (256, 256, 64, 1024, 8),
    (256, 256, 64, 1024, 32), (70, 40, 16, 16, 1), (1, 136, 128, 3, 1),
    (1024, 1024, 64, 64, 1), (130, 264, 32, 4096, 2), (8, 8, 128, 1, 1),
    (300, 8, 1, 128, 1),
]


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("step_groups", [None, 1, 5])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_wgmma_planner(shape, step_groups, sms):
    m, n, k, br, mult = shape
    q = 128 // k * mult
    fn = pk.build_packed_brgemm(port(_desc(m, n, k)), br, step_groups,
                                pack_q=q)
    assert fn.path == "wgmma"
    qk, total = q * k, br * k
    kchunk, splits = fn.splits(sms)
    assert kchunk % 64 == 0
    assert splits * kchunk >= total > (splits - 1) * kchunk
    assert splits <= 65535
    # every block's K range is whole 64-deep slices, each inside one group
    for z in range(splits):
        lo, hi = z * kchunk, min(total, (z + 1) * kchunk)
        assert (hi - lo) % 64 == 0 and hi > lo
        for kb in range(lo, hi, 64):
            assert kb // qk == (kb + 63) // qk
    tiles = -(-m // 128) * -(-n // 128)
    slices = total // 64
    if step_groups:
        assert kchunk == step_groups * qk
    else:
        # one block per SM, as close to the SM count as whole slices allow
        assert tiles * splits <= sms
        assert splits == slices or tiles * splits > (sms - tiles) / 2


@pytest.mark.parametrize("sms,want", [(132, (2048, 32)), (114, (2368, 28)),
                                      (78, (3456, 19))])
def test_wgmma_planner_at_the_lab_shape(sms, want):
    """br = 1024, 256^2 x 64: 4 tiles x 32 splits = 128 blocks on 132
    SMs."""
    fn = pk.build_packed_brgemm(port(_desc(256, 256, 64)), 1024)
    assert fn.splits(sms) == want


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("a_dt,n", [(F32, 256), (BF16, 36)], ids=str)
def test_fma_planner_keeps_its_split(a_dt, n, sms):
    """The FMA route keeps its own plan: 64 x 64 tiles, 16-deep slices,
    about four blocks per SM."""
    m, k, br = 256, 64, 1024
    fn = pk.build_packed_brgemm(port(_desc(m, n, k, a_dt)), br)
    assert fn.path == "fma"
    total = br * k
    tiles = -(-m // 64) * -(-n // 64)
    want = max(1, -(-4 * sms // tiles))
    kchunk = -(-(-(-total // want)) // 16) * 16
    assert fn.splits(sms) == (kchunk, -(-total // kchunk))


# ---------------------------------------------------------------------------
# parity with the JAX package at the shapes of the tensor-core route
# ---------------------------------------------------------------------------

PARITY_SHAPES = [
    # (m, n, k, br, pack_q multiple, step_groups)
    (1, 8, 64, 4, 1, None),
    (70, 40, 16, 16, 1, 1),
    (70, 136, 128, 3, 1, 5),
    (1, 136, 1, 256, 1, None),
    (70, 8, 64, 8, 2, 1),
    (33, 40, 16, 32, 2, 5),
    (1, 40, 128, 5, 1, 1),
]


@pytest.mark.parametrize("o_dt", [F32, BF16], ids=lambda d: d.value)
@pytest.mark.parametrize("shape", PARITY_SHAPES, ids=str)
def test_bf16_brgemm_parity(shape, o_dt):
    m, n, k, br, mult, sg = shape
    q = 128 // k * mult
    pack_q = q if mult > 1 else None
    d = _desc(m, n, k, BF16, o_dt)
    ref = rk.build_packed_brgemm(d, br, sg, pack_q=pack_q)
    got = pk.build_packed_brgemm(port(d), br, sg, pack_q=pack_q)
    assert got.path == "wgmma"
    a, b = _operands(np.random.default_rng(m + n + k + br), br, q, m, n, k)
    (aj, at), (bj, bt) = pair(a, BF16), pair(b, BF16)
    out = got(at, bt)
    assert out.dtype == xp.to_torch(xp.Datatype(o_dt.value))
    assert tuple(out.shape) == (m, n)
    check(np.asarray(ref(aj, bj), np.float64), out, margin=TOL[o_dt])


@pytest.mark.parametrize("shape", PARITY_SHAPES, ids=str)
def test_bf16_brgemm_sol_parity(shape):
    m, n, k, br, mult, sg = shape
    q = 128 // k * mult
    pack_q = q if mult > 1 else None
    d = _desc(m, n, k)
    ref = rk.build_packed_brgemm_sol(d, br, step_groups=sg, pack_q=pack_q)
    got = pk.build_packed_brgemm_sol(port(d), br, step_groups=sg,
                                     pack_q=pack_q)
    assert got.path == "wgmma"
    a, b = _operands(np.random.default_rng(br), br, q, m, n, k)
    (aj, at), (bj, bt) = pair(a, BF16), pair(b, BF16)
    out = got(at, bt)
    assert out.dtype == torch.float32 and tuple(out.shape) == (m, n)
    check(np.asarray(ref(aj, bj), np.float64), out, margin=1e-5)


@pytest.mark.parametrize("o_dt", [F32, BF16], ids=lambda d: d.value)
@pytest.mark.parametrize("cp", EPILOGUES)
def test_bf16_brgemm_epilogue_bias_beta1_parity(cp, o_dt):
    """Every fused epilogue with the bias operand D and beta = 1's C0, on a
    ragged tile of the tensor-core route."""
    m, n, k, br = 70, 40, 64, 8
    d = _desc(m, n, k, BF16, o_dt, GemmFlags.NONE)
    ref = rk.build_packed_brgemm(d, br, cp_type=cp, with_bias=True)
    got = pk.build_packed_brgemm(port(d), br, cp_type=cp, with_bias=True)
    assert got.path == "wgmma"
    rng = np.random.default_rng(len(cp))
    a, b = _operands(rng, br, 2, m, n, k)
    (aj, at), (bj, bt) = pair(a, BF16), pair(b, BF16)
    cj, ct = pair(rng.standard_normal((m, n)), F32)
    dj, dt = pair(rng.standard_normal((m, n)), F32)
    out = got(at, bt, ct, dt)
    assert tuple(out.shape) == (m, n)
    check(np.asarray(ref(aj, bj, cj, dj), np.float64), out,
          margin=TOL[o_dt])
