"""The streaming twins, the labs and the rest of the timer: the port against
the JAX package on the same numpy inputs, on the CPU.

The JAX side runs as its own tests run it (its Pallas kernels in interpret
mode): `build_packed_brgemm_sol` from `libxsmm_tpu/kernels/gemm_pallas.py`,
and the BCSC lab's probes from `scripts/bcsc_lab.py`, loaded from its file
(it is a script, not a module of the package). The port runs the plain
torch version of each CUDA kernel on CPU tensors, and its BCSC lab end to
end with device="cpu" at the lab's own shape.

Tolerances (matdiff normf_rel): 1e-5 for the BRGEMM twin (f32 sums of the
same values in another order); bit for bit for the passthrough; 1e-4 for the
BCSC probes (bf16 in, f32 sums in another order, minimal's constant RHS
rounded to bf16 by each framework); the union maps exactly.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import libxsmm_torch as xp
import libxsmm_tpu as xt
from libxsmm_torch import interop
from libxsmm_torch.kernels import gemm as pk
from libxsmm_torch.kernels import spmm_lab as pl
from libxsmm_torch.matdiff import check
from libxsmm_torch.ops.sparse import BcscMatrix
from libxsmm_torch.scripts import bcsc_lab, brgemm_lab
from libxsmm_torch.utils import timer as ptimer
from libxsmm_tpu.descriptor import (BatchReduceConfig, BatchReduceType,
                                    GemmDescriptor, GemmFlags, GemmShape)
from libxsmm_tpu.dtypes import Datatype
from libxsmm_tpu.kernels import gemm_pallas as rk
from libxsmm_tpu.utils import timer as rtimer

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(7)
F32, BF16, F16, I8 = Datatype.F32, Datatype.BF16, Datatype.F16, Datatype.I8
B0 = GemmFlags.BETA_0


def port(obj):
    """The port's copy of a reference descriptor, via plain fields."""
    return interop.descriptor_from_fields(interop.descriptor_fields(obj))


def pair(x, dt):
    """(JAX array, CPU tensor) holding identical values of dt."""
    xj = jnp.asarray(x, jnp.bfloat16 if dt == BF16 else jnp.float32)
    return xj, interop.tensor_from_numpy(np.asarray(xj),
                                         xp.Datatype(dt.value), device="cpu")


def _jax_lab():
    """scripts/bcsc_lab.py, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "jax_bcsc_lab", ROOT / "scripts" / "bcsc_lab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_LAB = _jax_lab()


# ---------------------------------------------------------------------------
# the BRGEMM's streaming twin
# ---------------------------------------------------------------------------

def _sol_desc(m, n, k, br, dt=F32):
    shape = GemmShape(m, n, k, a_in_type=dt, b_in_type=dt, out_type=F32)
    return GemmDescriptor(shape, B0,
                          BatchReduceConfig(BatchReduceType.STRIDE, br))


@pytest.mark.parametrize("dt", [F32, BF16], ids=lambda d: d.value)
@pytest.mark.parametrize("k,br,sg,mult", [
    (64, 16, None, 1),     # the default K split
    (32, 16, 2, 1),        # step_groups dividing the groups
    (32, 12, 2, 1),        # 3 groups at 2 a step: a ragged final step
    (64, 32, 4, 2),        # pack_q = 2 * 128/k
    (32, 24, 3, 2),        # pack_q = 8, 3 groups at 3 a step
])
def test_brgemm_sol_parity(dt, k, br, sg, mult):
    m, n = 40, 72
    desc = _sol_desc(m, n, k, br, dt)
    q = 128 // k * mult
    pack_q = q if mult > 1 else None
    ref = rk.build_packed_brgemm_sol(desc, br, step_groups=sg, pack_q=pack_q)
    got = pk.build_packed_brgemm_sol(port(desc), br, step_groups=sg,
                                     pack_q=pack_q)
    assert ref is not None and got is not None
    a = RNG.standard_normal((br, m, k))
    a = a.reshape(br // q, q, m, k).transpose(0, 2, 1, 3).reshape(
        br // q, m, q * k)
    aj, at = pair(a, dt)
    bj, bt = pair(RNG.standard_normal((br, k, n)), dt)
    out = got(at, bt)
    assert out.dtype == torch.float32 and tuple(out.shape) == (m, n)
    check(np.asarray(ref(aj, bj), np.float64), out, margin=1e-5)
    # the closed form: rowsum(A) + colsum(B) over the whole contraction
    a64 = np.asarray(aj, np.float64)
    b64 = np.asarray(bj, np.float64)
    check(a64.sum((0, 2))[:, None] + b64.reshape(-1, n).sum(0)[None, :],
          out, margin=1e-5)


@pytest.mark.parametrize("case", [
    dict(m=32, n=32, k=48, br=8),                 # k does not divide 128
    dict(m=32, n=32, k=64, br=3),                 # br % Q
    dict(m=32, n=32, k=64, br=8, pack_q=3),       # pack_q below 128/k
    dict(m=32, n=32, k=64, br=8, pack_q=6),       # not a multiple of 128/k
    dict(m=32, n=32, k=64, br=8, pack_q=16),      # br % pack_q
    dict(m=32, n=32, k=64, br=0),
    dict(m=2048, n=32, k=64, br=8),               # m > 1024
    dict(m=32, n=32, k=64, br=8, dt=F16),
    dict(m=32, n=32, k=64, br=8, dt=I8),
    dict(m=32, n=32, k=64, br=8, flags=GemmFlags.TRANS_A | B0),
    dict(m=32, n=32, k=64, br=8, pack_q=8),       # accepted by both
], ids=lambda c: "_".join(f"{k_}{getattr(v, 'name', v)}"
                          for k_, v in c.items()))
def test_brgemm_sol_refuses_like_reference(case):
    case = dict(case)
    dt, flags = case.pop("dt", F32), case.pop("flags", B0)
    pack_q = case.pop("pack_q", None)
    shape = GemmShape(case["m"], case["n"], case["k"], a_in_type=dt,
                      b_in_type=dt, out_type=F32)
    desc = GemmDescriptor(shape, flags, BatchReduceConfig(
        BatchReduceType.STRIDE, max(case["br"], 1)))
    ref = rk.build_packed_brgemm_sol(desc, case["br"], pack_q=pack_q)
    got = pk.build_packed_brgemm_sol(port(desc), case["br"], pack_q=pack_q)
    assert (ref is None) == (got is None)


def test_brgemm_sol_checks_operands():
    sol = pk.build_packed_brgemm_sol(port(_sol_desc(16, 16, 64, 4)), 4)
    a = torch.zeros(2, 16, 128)
    with pytest.raises(ValueError, match="shape"):
        sol(a, torch.zeros(4, 64, 8))
    with pytest.raises(ValueError, match="dtype"):
        sol(a.to(torch.bfloat16), torch.zeros(4, 64, 16))
    assert tuple(sol(a, torch.zeros(4, 64, 16)).shape) == (16, 16)


# ---------------------------------------------------------------------------
# the packed SMM's passthrough twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G,m,S", [(4096, 32, None), (7, 40, 24), (3, 5, 96),
                                   (1, 1, 48)])
def test_passthrough_bit_exact(G, m, S):
    a = RNG.standard_normal((G, m, 128)).astype(np.float32)
    b = (RNG.standard_normal((G, m, 128)) * 0.1).astype(np.float32)
    pt = pk.build_packed_smm_passthrough(G, m, S)
    out = pt(torch.from_numpy(a), torch.from_numpy(b))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), a + b)
    assert pt.units == G * m * 32    # the streaming pass's float4 units


def test_passthrough_refusals_and_checks():
    assert pk.build_packed_smm_passthrough(0, 32) is None
    assert pk.build_packed_smm_passthrough(4, 0) is None
    pt = pk.build_packed_smm_passthrough(4, 8)
    with pytest.raises(ValueError, match="shape"):
        pt(torch.zeros(4, 8, 64), torch.zeros(4, 8, 64))
    with pytest.raises(ValueError, match="dtype"):
        pt(torch.zeros(4, 8, 128, dtype=torch.float64),
           torch.zeros(4, 8, 128, dtype=torch.float64))
    assert pk.launches["packed_smm_passthrough"] == 0


# ---------------------------------------------------------------------------
# the BCSC lab
# ---------------------------------------------------------------------------

def _patterns():
    """(name, (m, k, n), JAX BcscMatrix, port BcscMatrix) of the lab's
    generator at 256^3 and of a pattern with an empty column group."""
    from libxsmm_tpu.ops.sparse import BcscMatrix as JaxBcsc
    out = []
    for density in (0.3, 0.05):
        rb, _ = JAX_LAB.build_pattern(density, m=256, k=256, n=256)
        pb, _ = bcsc_lab.build_pattern(density, m=256, k=256, n=256)
        out.append((f"lab256_d{round(density * 100):02d}", (256, 256, 256),
                    rb, pb))
    # three groups of 128 columns; the middle one holds no block, the
    # others unions of 3 and 5 block rows (odd U, padded slots)
    rng = np.random.default_rng(3)
    bmat = rng.standard_normal((256, 384)).astype(np.float32)
    keep = np.zeros((8, 12), bool)
    keep[[0, 2, 5], 0] = keep[[2], 1] = True
    keep[[1, 3, 4, 6, 7], 9] = keep[[4], 11] = True
    bmat *= np.kron(keep, np.ones((32, 32), np.float32))
    out.append(("empty_group", (96, 256, 384),
                JaxBcsc.from_dense(bmat, 32, 32),
                BcscMatrix.from_dense(bmat, 32, 32)))
    return out


PATTERNS = _patterns()
PROBES = ("minimal", "chunk1", "chunk2", "chunk4", "dspipe")


@pytest.mark.parametrize("case", PATTERNS, ids=lambda c: c[0])
def test_union_maps_equal_reference(case):
    _, (m, k, n), rb, pb = case
    np.testing.assert_array_equal(pb.indptr, np.asarray(rb.indptr))
    np.testing.assert_array_equal(pb.indices, np.asarray(rb.indices))
    want = JAX_LAB.union_maps(np.asarray(rb.indptr), np.asarray(rb.indices),
                              n, 32, 32, rb.nblocks)
    got = bcsc_lab.union_maps(pb.indptr, pb.indices, n, 32, 32, pb.nblocks)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.fixture(scope="module")
def variants():
    """{case: (JAX variants, port variants, a, values)} on shared inputs."""
    out = {}
    for name, (m, k, n), rb, pb in PATTERNS:
        a = np.random.default_rng(5).standard_normal((m, k))
        aj, at = pair(a, BF16)
        vj, vt = pair(np.asarray(pb.data), BF16)
        out[name] = (JAX_LAB.make_variants((m, n, k), rb, 0.0),
                     bcsc_lab.make_variants((m, n, k), pb, 0.0, "cpu"),
                     (aj, at), (vj, vt))
    return out


@pytest.mark.parametrize("probe", PROBES)
@pytest.mark.parametrize("case", [c[0] for c in PATTERNS])
def test_probe_parity(variants, case, probe):
    ref, got, (aj, at), (vj, vt) = variants[case]
    before = dict(pl.launches)
    out = got[probe](at, vt)
    assert out.dtype == torch.float32
    check(np.asarray(ref[probe](aj, vj), np.float64), out, margin=1e-4)
    assert pl.launches == before       # CPU tensors: the plain version
    if probe != "minimal":
        want = (np.asarray(aj, np.float64)
                @ np.asarray(jnp.asarray(_dense(case), jnp.bfloat16),
                             np.float64))
        check(want, out, margin=1e-4)


def _dense(case):
    return next(pb for name, _, _, pb in PATTERNS if name == case).to_dense()


def test_probes_check_operands():
    _, (m, k, n), _, pb = PATTERNS[-1]
    probes = bcsc_lab.make_variants((m, n, k), pb, 0.0, "cpu")
    assert probes["dspipe"].U == 5 and probes["chunk4"].nchunks == 4
    with pytest.raises(ValueError, match="shape"):
        probes["chunk2"](torch.zeros(m, k + 32), torch.zeros(pb.nblocks, 32,
                                                            32))
    with pytest.raises(ValueError, match="32 x 32 blocks"):
        bcsc_lab.make_variants((m, n, k), BcscMatrix.from_dense(
            pb.to_dense(), 16, 16), 0.0, "cpu")
    with pytest.raises(ValueError, match="1, 2 or 4"):
        pl.BcscLabChunk(m, n, k, pb.nblocks, np.zeros((3, 5), np.int32),
                        np.zeros((3, 5, 4), np.int32), "cpu", 3)


def test_probe_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    _, (m, k, n), _, pb = PATTERNS[-1]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bcsc_lab.make_variants((m, n, k), pb, 0.0)


# ---------------------------------------------------------------------------
# the BCSC lab end to end on the CPU at its shape (a rehearsal of its
# control flow), and both labs' refusal of a missing card
# ---------------------------------------------------------------------------

def test_bcsc_lab_runs_on_cpu(capsys):
    rows = bcsc_lab.main(["--device", "cpu", "--rounds", "1", "--density",
                          "0.05"])
    names = [r["name"] for r in rows]
    assert names == list(bcsc_lab.LIBRARY) + list(PROBES)
    paths = {"minimal": "wgmma", "chunk1": "mma", "chunk2": "mma",
             "chunk4": "mma", "dspipe": "mma"}
    for r in rows:
        assert r["us"] > 0 and r["vs_union4"] > 0
        assert (r["normf_rel"] is None) == (r["name"] == "minimal")
        assert r["path"] == paths.get(r["name"])
    assert next(r for r in rows if r["name"] == "union4")["vs_union4"] == 1.0
    out = capsys.readouterr().out
    assert "useful flops/call" in out and "check dspipe" in out


def test_bcsc_lab_variant_filter():
    rows = bcsc_lab.main(["--device", "cpu", "--rounds", "1", "--variants",
                          "union4,chunk2"])
    assert [r["name"] for r in rows] == ["union4", "chunk2"]


def test_labs_refuse_the_default_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        brgemm_lab.main(["--rounds", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bcsc_lab.main(["--rounds", "1"])


# ---------------------------------------------------------------------------
# utils/timer.py
# ---------------------------------------------------------------------------

def test_timer_ticks_like_reference():
    for mod in (ptimer, rtimer):
        t0 = mod.tick()
        t1 = mod.tick()
        assert t1 >= t0 and mod.duration(t0, t1) == t1 - t0
        i0, i1 = mod.tickint(), mod.tickint()
        assert isinstance(i0, int) and i1 >= i0
    for t0, t1 in ((0, 10), (10, 0), (5, 5), (3.9, 12.2)):
        assert ptimer.ncycles(t0, t1) == rtimer.ncycles(t0, t1)
    assert ptimer.get_timer_info().tsc == rtimer.get_timer_info().tsc == 0
    assert ptimer.TimerInfo(1).tsc == 1
    assert ptimer.gflops(2e9, 0.5) == rtimer.gflops(2e9, 0.5) == 4.0
    assert ptimer.gflops(1, 0.0) == rtimer.gflops(1, 0.0)


def test_timer_exports_match_reference():
    for name in ("timer_tick", "timer_duration", "timer_tickint",
                 "timer_ncycles", "TimerInfo", "get_timer_info"):
        assert hasattr(xt, name) and hasattr(xp, name)
    assert xp.timer_tick is ptimer.tick
    assert xp.timer_ncycles(1, 4) == xt.timer_ncycles(1, 4) == 3
    assert xp.get_timer_info().tsc == xt.get_timer_info().tsc


def test_bench_on_host_clock():
    calls = []

    def fn(x):
        calls.append(1)
        return x + 1

    t = ptimer.bench(fn, (torch.zeros(8),), reps=5, warmup=3)
    assert t > 0 and len(calls) == 8
    assert ptimer.bench(lambda: None, reps=2, warmup=1) >= 0


def test_bench_propagates_errors():
    def boom(x):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        ptimer.bench(boom, (torch.zeros(2),))


def test_launch_overhead_cached_on_host():
    t = ptimer.launch_overhead(device="cpu")
    assert 0 < t < 1.0
    assert ptimer.launch_overhead(device="cpu") == t
    assert ptimer.launch_overhead(refresh=True, device="cpu") > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ptimer.launch_overhead()
