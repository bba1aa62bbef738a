"""The batched SMM's shared-memory ring and the f32 packed BRGEMM's TMA-fed
FMA route, on the CPU: the batched SMM's plan (`kernels.gemm.batched_plan`:
copy route, rows per stage, stages, blocks per SM) over the corners of the
reference's envelope, the f32 route's K-split planner across SM counts, the
constants both mirror from csrc/gemm_kernels.cu, and the port against the
JAX package at the shapes of both routes. The port's wrappers run their
plain versions on CPU tensors; the JAX side runs its Pallas kernels in
interpret mode, as its own tests do.

Tolerances (matdiff normf_rel): 1e-5 for f32 in and out (the same f32
products, summed in another order), 1e-4 for bf16 in / f32 out (bf16
products exact in f32), 1e-2 for bf16 outputs (one rounding at another
point of the sum), 1e-5 for the BRGEMM's twin.
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
SRC = ROOT / "libxsmm_torch" / "kernels" / "csrc" / "gemm_kernels.cu"
F32, BF16 = Datatype.F32, Datatype.BF16
B0 = GemmFlags.BETA_0
EPILOGUES = ["NONE", "IDENTITY", "RELU", "X2", "TANH", "SIGMOID", "GELU"]
SMS = (132, 114, 78)      # H100 SXM, H100 PCIe, a smaller part
TORCH = {F32: torch.float32, BF16: torch.bfloat16}


def tol(a_dt, o_dt):
    return 1e-2 if o_dt == BF16 else 1e-4 if a_dt == BF16 else 1e-5


def port(obj):
    """The port's copy of a reference descriptor, via plain fields."""
    return interop.descriptor_from_fields(interop.descriptor_fields(obj))


def pair(x, dt):
    """(JAX array, CPU tensor) holding identical values of dt."""
    xj = jnp.asarray(x, jnp.bfloat16 if dt == BF16 else jnp.float32)
    return xj, interop.tensor_from_numpy(np.asarray(xj),
                                         xp.Datatype(dt.value), device="cpu")


def _desc(m, n, k, a_dt=F32, o_dt=F32, flags=B0):
    return GemmDescriptor(GemmShape(m, n, k, a_in_type=a_dt, b_in_type=a_dt,
                                    out_type=o_dt), flags)


def _packed(rng, br, q, m, n, k):
    """Packed A (br/Q, m, Q*k) and B (br, k, n) as numpy arrays."""
    a = rng.standard_normal((br, m, k))
    a = a.reshape(br // q, q, m, k).transpose(0, 2, 1, 3).reshape(
        br // q, m, q * k)
    return a, rng.standard_normal((br, k, n)) * 0.5


def _src_constants(pattern):
    return {name: int(v) for name, v in
            re.findall(pattern, SRC.read_text())}


# ---------------------------------------------------------------------------
# constants mirrored from the CUDA source
# ---------------------------------------------------------------------------

def test_tma_fma_tiles_mirror_the_cuda_source():
    """The f32 route's tile and slice are the kernel's (csrc TF_BM, TF_BN,
    TF_BK), and the kernel refuses what the predicate sends elsewhere."""
    got = _src_constants(r"\b(TF_B[MNK]) = (\d+)")
    assert got == {"TF_BM": pk._TF_TILE, "TF_BN": pk._TF_TILE,
                   "TF_BK": pk._TF_BK}
    assert "n % 4 || qk % TF_BK || kchunk % TF_BK" in SRC.read_text()


def test_batched_constants_mirror_the_cuda_source():
    """The plan's shared-memory budget, block size and block count are the
    kernel's (csrc BG_*), and the source pads and routes as the plan does."""
    got = _src_constants(r"constexpr int (BG_[A-Z_]+) = (\d+);")
    assert got == {"BG_CONSUMERS": pk._BG_CONSUMERS,
                   "BG_SMEM_MAX": pk._BG_SMEM_MAX,
                   "BG_SMEM_SM": pk._BG_SMEM_SM,
                   "BG_MAX_BLOCKS": pk._BG_MAX_BLOCKS}
    src = SRC.read_text()
    assert "enum { BG_BULK = 0, BG_CPASYNC = 1 };" in src
    assert pk._BG_ROUTES == {"bulk": 0, "cp_async": 1}
    assert "((long)m * k * sz) % 16 == 0 && ((long)k * n * sz) % 16 == 0" \
        in src
    assert "(size_t)stages * (stage_bytes + 16)" in src
    assert "(route == BG_CPASYNC ? 16 : 0)" in src


# ---------------------------------------------------------------------------
# the batched SMM's plan
# ---------------------------------------------------------------------------

DIMS_M = (1, 2, 7, 8, 33, 64, 255, 256)
DIMS_NK = (1, 2, 3, 4, 17, 31, 32, 64, 127, 128)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("m", DIMS_M)
def test_batched_plan_fits_every_corner(m, dtype):
    """Every (m, n, k) of the reference's envelope (m <= 256, n and k <=
    128, odd k, n = 1) gets a plan: its ring fits a block's 227 KB, the
    blocks it asks for fit the SM, and its route follows alignment."""
    sz = 2 if dtype == torch.bfloat16 else 4
    for n in DIMS_NK:
        for k in DIMS_NK:
            route, mt, stages, blocks = pk.batched_plan(m, n, k, dtype)
            aligned = (m * k * sz) % 16 == 0 and (k * n * sz) % 16 == 0
            assert route == ("bulk" if aligned else "cp_async")
            assert 2 <= stages <= 4 and 1 <= blocks <= 4
            assert mt == m or (mt < m and mt in (128, 64, 32, 16, 8))
            if route == "bulk":
                assert (mt * k * sz) % 16 == 0
            smem = pk.batched_smem(route, mt, stages, n, k, dtype)
            assert smem <= 232448
            assert blocks * (smem + 1024) <= 233472 or blocks == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("m,n,k", [(32, 32, 32), (33, 31, 17), (256, 128, 128),
                                   (1, 1, 1), (256, 1, 128), (13, 5, 7),
                                   (64, 128, 4)])
def test_batched_configs(m, n, k, dtype):
    """tune=True's candidates: the plan's (a two-stage ring) first, each
    one fitting."""
    cfgs = pk.batched_gemm_configs(m, n, k, dtype)
    route = pk.batched_route(m, n, k, dtype)
    assert pk.batched_plan(m, n, k, dtype) == (route,) + cfgs[0]
    assert cfgs[0][1] == 2
    assert len(cfgs) == len(set(cfgs)) >= 2
    for mt, stages, blocks in cfgs:
        assert pk.batched_smem(route, mt, stages, n, k, dtype) <= 232448
        assert 1 <= mt <= m and blocks >= 1


@pytest.mark.parametrize("shape,dtype,want", [
    ((32, 32, 32), torch.float32, ("bulk", 32, 2, 4)),
    ((32, 32, 32), torch.bfloat16, ("bulk", 32, 2, 4)),
    ((33, 31, 17), torch.float32, ("cp_async", 33, 2, 4)),
    ((256, 128, 128), torch.float32, ("bulk", 64, 2, 1)),
    ((256, 128, 128), torch.bfloat16, ("bulk", 256, 2, 1)),
    ((9, 8, 3), torch.bfloat16, ("cp_async", 9, 2, 4)),
    ((8, 8, 3), torch.bfloat16, ("bulk", 8, 2, 4))], ids=str)
def test_batched_plan_at_known_shapes(shape, dtype, want):
    """The headline's 32^3 takes two 4 KB bulk copies a problem (f32) in a
    2-stage ring at four blocks per SM; the largest f32 shape cuts A into
    64-row tiles; odd k stays on the bulk route where the runs are whole
    16-byte units (8 x 3 bf16: 48 bytes)."""
    assert pk.batched_plan(*shape, dtype) == want


def test_batched_wrapper_takes_the_plan():
    d = port(_desc(33, 31, 17))
    fn = pk.build_batched_gemm(d, 5)
    assert fn.route == "cp_async"
    assert fn.config == pk.batched_plan(33, 31, 17, torch.float32)[1:]
    fn = pk.build_batched_gemm(port(_desc(32, 32, 32)), 5, (16, 4, 4))
    assert (fn.route, fn.config) == ("bulk", (16, 4, 4))


# ---------------------------------------------------------------------------
# the f32 route's K-split planner
# ---------------------------------------------------------------------------

PLAN_SHAPES = [
    # (m, n, k, br, pack_q multiple)
    (256, 256, 64, 1024, 1), (256, 256, 64, 1024, 8),
    (256, 256, 64, 1024, 32), (70, 40, 16, 16, 1), (1, 136, 128, 3, 1),
    (1024, 1024, 64, 64, 1), (130, 264, 32, 4096, 2), (8, 4, 128, 1, 1),
    (300, 8, 1, 128, 1),
]


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("step_groups", [None, 1, 5])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_tma_fma_planner(shape, step_groups, sms):
    m, n, k, br, mult = shape
    q = 128 // k * mult
    fn = pk.build_packed_brgemm(port(_desc(m, n, k)), br, step_groups,
                                pack_q=q)
    assert fn.path == "tma_fma"
    qk, total = q * k, br * k
    kchunk, splits = fn.splits(sms)
    assert kchunk % 32 == 0
    assert splits * kchunk >= total > (splits - 1) * kchunk
    # every block's K range is whole 32-deep slices, each inside one group
    for z in range(splits):
        lo, hi = z * kchunk, min(total, (z + 1) * kchunk)
        assert (hi - lo) % 32 == 0 and hi > lo
        for kb in range(lo, hi, 32):
            assert kb // qk == (kb + 31) // qk
    tiles = -(-m // 128) * -(-n // 128)
    if step_groups:
        assert kchunk == step_groups * qk
    else:
        # one block per SM, as close to the SM count as whole slices allow
        assert tiles * splits <= sms
        assert splits == total // 32 or tiles * splits > (sms - tiles) / 2


@pytest.mark.parametrize("sms,want", [(132, (2016, 33)), (114, (2368, 28)),
                                      (78, (3456, 19))])
def test_tma_fma_planner_at_the_lab_shape(sms, want):
    """br = 1024, 256^2 x 64 f32: 4 tiles x 33 splits = 132 blocks on 132
    SMs; the twin plans the same."""
    d = port(_desc(256, 256, 64))
    assert pk.build_packed_brgemm(d, 1024).splits(sms) == want
    assert pk.build_packed_brgemm_sol(d, 1024).splits(sms) == want


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

BRGEMM_SHAPES = [
    # (m, n, k, br, pack_q multiple, step_groups): ragged 128-row tiles,
    # one row, n % 4 == 0 off the 128-column tile, deep packs
    (70, 40, 64, 8, 1, None), (1, 4, 128, 3, 1, 1), (130, 36, 32, 16, 2, 5),
    (33, 132, 16, 24, 1, None), (70, 8, 64, 8, 2, 1),
]


@pytest.mark.parametrize("o_dt", [F32, BF16], ids=lambda d: d.value)
@pytest.mark.parametrize("shape", BRGEMM_SHAPES, ids=str)
def test_f32_brgemm_parity(shape, o_dt):
    m, n, k, br, mult, sg = shape
    q = 128 // k * mult
    pack_q = q if mult > 1 else None
    d = _desc(m, n, k, F32, o_dt)
    ref = rk.build_packed_brgemm(d, br, sg, pack_q=pack_q)
    got = pk.build_packed_brgemm(port(d), br, sg, pack_q=pack_q)
    assert got.path == "tma_fma"
    a, b = _packed(np.random.default_rng(m + n + br), br, q, m, n, k)
    (aj, at), (bj, bt) = pair(a, F32), pair(b, F32)
    out = got(at, bt)
    assert out.dtype == TORCH[o_dt] and tuple(out.shape) == (m, n)
    check(np.asarray(ref(aj, bj), np.float64), out, margin=tol(F32, o_dt))


@pytest.mark.parametrize("shape", BRGEMM_SHAPES, ids=str)
def test_f32_brgemm_sol_parity(shape):
    m, n, k, br, mult, sg = shape
    q = 128 // k * mult
    pack_q = q if mult > 1 else None
    d = _desc(m, n, k)
    ref = rk.build_packed_brgemm_sol(d, br, step_groups=sg, pack_q=pack_q)
    got = pk.build_packed_brgemm_sol(port(d), br, step_groups=sg,
                                     pack_q=pack_q)
    assert got.path == "tma_fma"
    a, b = _packed(np.random.default_rng(br), br, q, m, n, k)
    (aj, at), (bj, bt) = pair(a, F32), pair(b, F32)
    out = got(at, bt)
    assert out.dtype == torch.float32 and tuple(out.shape) == (m, n)
    check(np.asarray(ref(aj, bj), np.float64), out, margin=1e-5)


@pytest.mark.parametrize("o_dt", [F32, BF16], ids=lambda d: d.value)
@pytest.mark.parametrize("cp", EPILOGUES)
def test_f32_brgemm_epilogue_bias_beta1_parity(cp, o_dt):
    """Every fused epilogue with the bias operand D and beta = 1's C0, on a
    ragged tile of the f32 route."""
    m, n, k, br = 70, 44, 64, 8
    d = _desc(m, n, k, F32, o_dt, GemmFlags.NONE)
    ref = rk.build_packed_brgemm(d, br, cp_type=cp, with_bias=True)
    got = pk.build_packed_brgemm(port(d), br, cp_type=cp, with_bias=True)
    assert got.path == "tma_fma"
    rng = np.random.default_rng(len(cp) + 1)
    a, b = _packed(rng, br, 2, m, n, k)
    (aj, at), (bj, bt) = pair(a, F32), pair(b, F32)
    cj, ct = pair(rng.standard_normal((m, n)), F32)
    dj, dt = pair(rng.standard_normal((m, n)), F32)
    out = got(at, bt, ct, dt)
    assert tuple(out.shape) == (m, n)
    check(np.asarray(ref(aj, bj, cj, dj), np.float64), out,
          margin=tol(F32, o_dt))


BATCHED_SHAPES = [(32, 32, 32), (33, 31, 17), (13, 5, 7), (1, 1, 1),
                  (64, 128, 4), (40, 1, 128), (9, 12, 3)]


@pytest.mark.parametrize("beta", [0, 1])
@pytest.mark.parametrize("a_dt,o_dt", [(F32, F32), (BF16, F32), (F32, BF16),
                                       (BF16, BF16)], ids=str)
@pytest.mark.parametrize("shape", BATCHED_SHAPES, ids=str)
def test_batched_parity(shape, a_dt, o_dt, beta):
    """Both copy routes' shapes (aligned, odd k and n, n = 1), bf16 in and
    out, beta = 1's C operand; ragged m against the tile."""
    m, n, k = shape
    batch = 3
    d = _desc(m, n, k, a_dt, o_dt, B0 if beta == 0 else GemmFlags.NONE)
    ref = rk.build_batched_gemm(d, batch)
    got = pk.build_batched_gemm(port(d), batch)
    rng = np.random.default_rng(m * n + k + beta)
    (aj, at) = pair(rng.standard_normal((batch, m, k)), a_dt)
    (bj, bt) = pair(rng.standard_normal((batch, k, n)) * 0.5, a_dt)
    args_j, args_t = [aj, bj], [at, bt]
    if beta:
        cj, ct = pair(rng.standard_normal((batch, m, n)), o_dt)
        args_j.append(cj)
        args_t.append(ct)
    out = got(*args_t)
    assert out.dtype == TORCH[o_dt] and tuple(out.shape) == (batch, m, n)
    check(np.asarray(ref(*args_j), np.float64), out, margin=tol(a_dt, o_dt))


def test_batched_entry_point_parity_at_the_headline_shape():
    """dispatch_gemm_batched at 32^3 f32 with tune=True (on the CPU there
    is nothing to choose) against the JAX package's entry point."""
    import libxsmm_tpu as xt
    batch, m = 6, 32
    rng = np.random.default_rng(5)
    (aj, at) = pair(rng.standard_normal((batch, m, m)), F32)
    (bj, bt) = pair(rng.standard_normal((batch, m, m)), F32)
    ref = xt.dispatch_gemm_batched(GemmShape(m, m, m), B0)(aj, bj)
    got = xp.dispatch_gemm_batched(xp.GemmShape(m, m, m), xp.GemmFlags.BETA_0,
                                   tune=True)(at, bt)
    check(np.asarray(ref, np.float64), got, margin=1e-5)
