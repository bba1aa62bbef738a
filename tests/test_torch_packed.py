"""The packed (SOA) dense GEMM: the port (`libxsmm_torch.ops.packed`)
against the JAX package on the same numpy inputs, on the CPU: the cases of
tests/test_packed.py (packed widths, beta = 1, the AC_RM and BC_RM
variants, the registry cache, the flag and beta refusals), plus bf16 and
f64 operands.

Tolerances (matdiff normf_rel): 1e-5 for f32 (sums in another order), 1e-4
for bf16 in / f32 out, 1e-12 for f64.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import libxsmm_torch as xp
from libxsmm_torch.matdiff import check
from libxsmm_tpu.descriptor import GemmFlags, GemmShape
from libxsmm_tpu.dtypes import Datatype
from libxsmm_tpu.ops import packed as ro

torch.set_num_threads(1)

RNG = np.random.default_rng(41)
SPEC = {"create_packed_gemm": ("mkp", "knp"),
        "create_packed_gemm_ac_rm": ("mkp", "kn"),
        "create_packed_gemm_bc_rm": ("mk", "knp")}


def operand(dims, m, n, k, p, dt):
    shape = tuple({"m": m, "n": n, "k": k, "p": p}[d] for d in dims)
    x = RNG.standard_normal(shape)
    if dt == Datatype.BF16:
        xj = jnp.asarray(x, jnp.bfloat16)
        return xj, torch.from_numpy(np.asarray(xj, np.float32)).bfloat16()
    x = x.astype(np.float64 if dt == Datatype.F64 else np.float32)
    return x, torch.from_numpy(x.copy())


def pshape(shape):
    return xp.GemmShape(shape.m, shape.n, shape.k,
                        xp.Datatype[shape.a_in_type.name],
                        xp.Datatype[shape.b_in_type.name],
                        xp.Datatype[shape.out_type.name])


@pytest.mark.parametrize("beta", [0, 1])
@pytest.mark.parametrize("p", [1, 4, 8, 16])
@pytest.mark.parametrize("entry", list(SPEC))
def test_packed_variants(entry, p, beta):
    m, n, k = 9, 7, 11
    shape = GemmShape(m, n, k)
    flags = GemmFlags.BETA_0 if beta == 0 else GemmFlags.NONE
    ref = getattr(ro, entry)(shape, flags, p)
    port = getattr(xp, entry)(pshape(shape), xp.GemmFlags(int(flags)), p)
    assert port.name == ref.name and port.info.nflops == ref.info.nflops
    a_dims, b_dims = SPEC[entry]
    a = operand(a_dims, m, n, k, p, Datatype.F32)
    b = operand(b_dims, m, n, k, p, Datatype.F32)
    args = [a, b] + ([operand("mnp", m, n, k, p, Datatype.F32)] if beta
                     else [])
    got = port(*(x[1] for x in args))
    assert got.shape == (m, n, p) and got.dtype == torch.float32
    want = np.asarray(ref(*(x[0] for x in args)), np.float64)
    check(want, got.double().numpy(), margin=1e-5)
    oracle = np.einsum(f"{a_dims},{b_dims}->mnp", a[0].astype(np.float64),
                       b[0].astype(np.float64))
    if beta:
        oracle = oracle + args[2][0]
    check(oracle, got.double().numpy(), margin=1e-5)


@pytest.mark.parametrize("dt,margin", [(Datatype.BF16, 1e-4),
                                       (Datatype.F64, 1e-12)])
@pytest.mark.parametrize("entry", list(SPEC))
def test_packed_types(entry, dt, margin):
    m, n, k, p = 8, 10, 6, 8
    out = Datatype.F64 if dt == Datatype.F64 else Datatype.F32
    shape = GemmShape(m, n, k, a_in_type=dt, b_in_type=dt, out_type=out)
    ref = getattr(ro, entry)(shape, GemmFlags.BETA_0, p)
    port = getattr(xp, entry)(pshape(shape), xp.GemmFlags.BETA_0, p)
    a_dims, b_dims = SPEC[entry]
    a = operand(a_dims, m, n, k, p, dt)
    b = operand(b_dims, m, n, k, p, dt)
    got = port(a[1], b[1])
    assert got.dtype == xp.to_torch(xp.Datatype[out.name])
    want = np.asarray(ref(a[0], b[0]), np.float64)
    check(want, got.double().numpy(), margin=margin)


def test_packed_gemm_cached():
    k1 = xp.create_packed_gemm(xp.GemmShape(4, 4, 4), xp.GemmFlags.BETA_0, 2)
    k2 = xp.create_packed_gemm(xp.GemmShape(4, 4, 4), xp.GemmFlags.BETA_0, 2)
    assert k1 is k2
    assert k1 is not xp.create_packed_gemm_ac_rm(xp.GemmShape(4, 4, 4),
                                                 xp.GemmFlags.BETA_0, 2)


@pytest.mark.parametrize("flag", ["TRANS_A", "TRANS_B", "VNNI_A", "VNNI_B",
                                  "VNNI_C"])
def test_flag_refusals(flag):
    """The reference refuses TRANS/VNNI on the packed dense entries
    (generator_packed_gemm.c:41-48); so does the port."""
    with pytest.raises(ValueError, match="NORM"):
        ro.create_packed_gemm(GemmShape(4, 4, 4), GemmFlags[flag], 2)
    with pytest.raises(ValueError, match="NORM"):
        xp.create_packed_gemm(xp.GemmShape(4, 4, 4), xp.GemmFlags[flag], 2)


def test_beta_contracts():
    """BETA_0 means C is unread, so a C operand raises; beta = 1 needs C."""
    a = torch.ones(4, 4, 2)
    k0 = xp.create_packed_gemm(xp.GemmShape(4, 4, 4), xp.GemmFlags.BETA_0, 2)
    with pytest.raises(ValueError, match="BETA_0"):
        k0(a, a, a)
    k1 = xp.create_packed_gemm(xp.GemmShape(4, 4, 4), xp.GemmFlags.NONE, 2)
    with pytest.raises(ValueError, match="C operand"):
        k1(a, a)


def test_numpy_operands_go_to_the_card():
    """Numpy operands are loaded onto the card, as dispatch_gemm's are: a
    host without one raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: numpy operands would load")
    k0 = xp.create_packed_gemm(xp.GemmShape(4, 4, 4), xp.GemmFlags.BETA_0, 2)
    a = np.ones((4, 4, 2), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        k0(a, a)
