"""Parity of libxsmm_torch's GEMM family with libxsmm_tpu's, on the CPU.

The same inputs, made from a numpy seed, go through the JAX package (its
Pallas kernels in interpret mode, as the other tests run them) and through
the port on CPU tensors (each CUDA kernel's plain torch version), and are
compared with matdiff. Descriptors cross over through libxsmm_torch.interop;
bf16/fp8 operands cross bit for bit.

Tolerances (matdiff normf_rel): 1e-5 for f32 in and out; 1e-4 for narrower
float inputs with f32 output (the products are exact in f32 on both sides,
only the order of the sum differs); matdiff.DEFAULT_MARGINS for bf16, f16
and fp8 outputs (one rounding of the output type); 1e-12 for f64; exact for
integer outputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import libxsmm_torch as xp
import libxsmm_tpu as xt
from libxsmm_torch import interop
from libxsmm_torch.kernels import gemm as pk
from libxsmm_torch.matdiff import DEFAULT_MARGINS, check
from libxsmm_tpu.descriptor import (BatchReduceConfig, BatchReduceType,
                                    BinaryPostops, BinaryType,
                                    GemmDescriptor, GemmExtDescriptor,
                                    GemmFlags, GemmShape, UnaryArgops,
                                    UnaryType)
from libxsmm_tpu.dtypes import Datatype, to_jnp
from libxsmm_tpu.kernels import gemm_pallas as rk

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RNG = np.random.default_rng(2025)

F64, F32, BF16, F16 = Datatype.F64, Datatype.F32, Datatype.BF16, Datatype.F16
BF8, HF8, I8, U8, I32 = (Datatype.BF8, Datatype.HF8, Datatype.I8,
                         Datatype.U8, Datatype.I32)
B0 = GemmFlags.BETA_0
EPILOGUES = ["NONE", "IDENTITY", "RELU", "X2", "TANH", "SIGMOID", "GELU"]

# the non-MX dtype combos of samples/xgemm.py BASE_COMBOS
BASE_COMBOS = [(F64, F64, F64), (F32, F32, F32), (BF16, BF16, F32),
               (BF16, BF16, BF16), (F16, F16, F32), (F16, F16, F16),
               (BF8, BF8, F32), (BF8, BF8, BF16), (HF8, HF8, F32),
               (I8, I8, I32), (U8, U8, I32)]


def port(obj):
    """The port's copy of a reference descriptor, via plain fields."""
    return interop.descriptor_from_fields(interop.descriptor_fields(obj))


def pflags(flags):
    return xp.GemmFlags(int(flags))


def operand(shape, dt):
    if dt == I8:
        return RNG.integers(-100, 100, shape)
    if dt == U8:
        return RNG.integers(0, 200, shape)
    if dt == I32:
        return RNG.integers(-1000, 1000, shape)
    return RNG.standard_normal(shape)


def pair(x, dt=F32):
    """(reference operand, CPU tensor) holding identical values of dt."""
    if dt in (F32, F64, I8, U8, I32):
        x = np.ascontiguousarray(np.asarray(x).astype(np.dtype(to_jnp(dt))))
        return x, torch.from_numpy(x.copy())
    xj = jnp.asarray(x, to_jnp(dt))
    return xj, interop.tensor_from_numpy(np.asarray(xj),
                                         xp.Datatype(dt.value), device="cpu")


def margin(a_dt, o_dt):
    if o_dt in (I32, I8, U8):
        return 0.0
    if o_dt == F64:
        return 1e-12
    if o_dt == F32:
        return 1e-5 if a_dt in (F32, F64) else 1e-4
    return DEFAULT_MARGINS[o_dt.value]


def compare(ref, got, a_dt=F32, o_dt=F32):
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    tol = margin(a_dt, o_dt)
    if tol == 0.0:
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        assert got.dtype == xp.to_torch(xp.Datatype(o_dt.value))
        check(ref.astype(np.float64), got, margin=tol)


# ---------------------------------------------------------------------------
# dispatch_gemm / dispatch_brgemm (the torch route)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("combo", BASE_COMBOS,
                         ids=lambda c: "".join(d.value for d in c))
@pytest.mark.parametrize("br_mode", ["none", "stride", "offset", "address"])
@pytest.mark.parametrize("beta", [0, 1])
def test_gemm_combo_parity(combo, br_mode, beta):
    a_dt, b_dt, o_dt = combo
    m, n, k, br, pool = 8, 6, 16, 3, 5
    shape = GemmShape(m, n, k, a_in_type=a_dt, b_in_type=b_dt, out_type=o_dt)
    flags = B0 if beta == 0 else GemmFlags.NONE
    idx = ()
    if br_mode == "none":
        ref_k = xt.dispatch_gemm(shape, flags)
        got_k = xp.dispatch_gemm(port(shape), pflags(flags))
        a, b = operand((m, k), a_dt), operand((k, n), b_dt)
    else:
        cfg = BatchReduceConfig(BatchReduceType[br_mode.upper()], br)
        ref_k = xt.dispatch_brgemm(shape, flags, cfg)
        got_k = xp.dispatch_brgemm(port(shape), pflags(flags), port(cfg))
        lead = br if br_mode == "stride" else pool
        a, b = operand((lead, m, k), a_dt), operand((lead, k, n), b_dt)
        if br_mode != "stride":
            idx = (np.asarray([0, 3, 1], np.int32),
                   np.asarray([4, 2, 2], np.int32))
    assert ref_k.name == got_k.name
    assert ref_k.info.nflops == got_k.info.nflops
    (aj, at), (bj, bt) = pair(a, a_dt), pair(b, b_dt)
    rargs, pargs = [aj, bj], [at, bt]
    if beta:
        cj, ct = pair(operand((m, n), o_dt), o_dt)
        rargs.append(cj)
        pargs.append(ct)
    rargs += list(idx)
    pargs += [torch.from_numpy(i) for i in idx]
    compare(ref_k(*rargs), got_k(*pargs), a_dt, o_dt)


@pytest.mark.parametrize("ta,tb", [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("br_mode", ["none", "stride"])
@pytest.mark.parametrize("dt", [F32, BF16], ids=lambda d: d.value)
def test_gemm_transposes_parity(ta, tb, br_mode, dt):
    m, n, k, br = 9, 14, 6, 3
    flags = B0 | (GemmFlags.TRANS_A if ta else 0) | (
        GemmFlags.TRANS_B if tb else 0)
    shape = GemmShape(m, n, k, a_in_type=dt, b_in_type=dt, out_type=F32)
    lead = () if br_mode == "none" else (br,)
    a = operand(lead + ((k, m) if ta else (m, k)), dt)
    b = operand(lead + ((n, k) if tb else (k, n)), dt)
    if br_mode == "none":
        ref_k = xt.dispatch_gemm(shape, flags)
        got_k = xp.dispatch_gemm(port(shape), pflags(flags))
    else:
        cfg = BatchReduceConfig(BatchReduceType.STRIDE, br)
        ref_k = xt.dispatch_brgemm(shape, flags, cfg)
        got_k = xp.dispatch_brgemm(port(shape), pflags(flags), port(cfg))
    (aj, at), (bj, bt) = pair(a, dt), pair(b, dt)
    compare(ref_k(aj, bj), got_k(at, bt), dt, F32)


@pytest.mark.parametrize("dt,out", [(BF16, BF16), (BF16, F32), (I8, I32),
                                    (F32, F32)],
                         ids=lambda d: d.value)
@pytest.mark.parametrize("vnni", ["A", "B", "C", "ABC"])
def test_gemm_vnni_parity(dt, out, vnni):
    from libxsmm_tpu.ops.gemm import _to_vnni
    m, n, k = 16, 8, 32
    flags = B0
    for letter in vnni:
        flags |= GemmFlags[f"VNNI_{letter}"]
    shape = GemmShape(m, n, k, a_in_type=dt, b_in_type=dt, out_type=out)
    aj, _ = pair(operand((m, k), dt), dt)
    bj, _ = pair(operand((k, n), dt), dt)
    if "A" in vnni:
        aj = _to_vnni(jnp.asarray(aj), dt)
    if "B" in vnni:
        bj = _to_vnni(jnp.asarray(bj), dt)
    at = interop.tensor_from_numpy(np.asarray(aj), xp.Datatype(dt.value),
                                   device="cpu")
    bt = interop.tensor_from_numpy(np.asarray(bj), xp.Datatype(dt.value),
                                   device="cpu")
    ref = xt.dispatch_gemm(shape, flags)(aj, bj)
    got = xp.dispatch_gemm(port(shape), pflags(flags))(at, bt)
    compare(ref, got, dt, out)


def test_brgemm_vnni_a_parity():
    from libxsmm_tpu.ops.gemm import _to_vnni
    br, m, n, k = 3, 8, 8, 16
    aj, _ = pair(operand((br, m, k), BF16), BF16)
    bj, bt = pair(operand((br, k, n), BF16), BF16)
    av = _to_vnni(aj, BF16)
    at = interop.tensor_from_numpy(np.asarray(av), xp.Datatype.BF16, "cpu")
    shape = GemmShape(m, n, k, a_in_type=BF16, b_in_type=BF16, out_type=F32)
    cfg = BatchReduceConfig(BatchReduceType.STRIDE, br)
    ref = xt.dispatch_brgemm(shape, B0 | GemmFlags.VNNI_A, cfg)(av, bj)
    got = xp.dispatch_brgemm(port(shape), pflags(B0 | GemmFlags.VNNI_A),
                             port(cfg))(at, bt)
    compare(ref, got, BF16, F32)


@pytest.mark.parametrize("dt", [BF16, I8, F32, Datatype.I4X2],
                         ids=lambda d: d.value)
def test_vnni_layout_helpers_parity(dt):
    from libxsmm_torch.ops.gemm import _to_vnni as p_to, _undo_vnni as p_undo
    from libxsmm_tpu.ops.gemm import _to_vnni as r_to, _undo_vnni as r_undo
    x = RNG.standard_normal((2, 16, 24)).astype(np.float32)
    assert xp.ops.gemm.vnni_factor(xp.Datatype(dt.value)) == \
        __import__("libxsmm_tpu.ops.gemm", fromlist=["x"]).vnni_factor(dt)
    v_ref = np.asarray(r_to(jnp.asarray(x), dt))
    v_got = p_to(torch.from_numpy(x), xp.Datatype(dt.value))
    np.testing.assert_array_equal(v_got.numpy(), v_ref)
    np.testing.assert_array_equal(
        p_undo(v_got, xp.Datatype(dt.value)).numpy(),
        np.asarray(r_undo(jnp.asarray(v_ref), dt)))


@pytest.mark.parametrize("case", ["ab", "abc", "ta", "tb", "beta0c"])
def test_gemm_wrapper_parity(case):
    m, n, k = 6, 9, 4
    a = operand((k, m) if case == "ta" else (m, k), F32).astype(np.float32)
    b = operand((n, k) if case == "tb" else (k, n), F32).astype(np.float32)
    c = operand((m, n), F32).astype(np.float32)
    kw = {}
    args_r, args_p = [a, b], [torch.from_numpy(a), torch.from_numpy(b)]
    if case in ("abc", "beta0c"):
        args_r.append(c)
        args_p.append(torch.from_numpy(c))
    if case == "ta":
        kw["trans_a"] = True
    if case == "tb":
        kw["trans_b"] = True
    if case == "beta0c":
        kw["beta"] = 0
    compare(xt.gemm(*[jnp.asarray(x) for x in args_r], **kw),
            xp.gemm(*args_p, **kw))


def test_sgemm_dgemm_parity():
    a = operand((5, 3), F64)
    b = operand((3, 7), F64)
    c = operand((5, 7), F64)
    compare(xt.sgemm(a, b), xp.sgemm(a, b, device="cpu"))
    compare(xt.sgemm(a, b, c), xp.sgemm(a, b, c, device="cpu"))
    compare(xt.dgemm(a, b, c), xp.dgemm(a, b, c, device="cpu"), F64, F64)
    compare(xt.dgemm(a, b), xp.dgemm(torch.from_numpy(a), b), F64, F64)


def test_xmmdispatch_tilecfg_and_cache():
    desc = GemmDescriptor(GemmShape(12, 10, 8), B0)
    kr, kp = xt.xmmdispatch(desc), xp.xmmdispatch(port(desc))
    assert kr.name == kp.name
    assert kp is xp.xmmdispatch(port(desc))          # registry hit
    a, b = operand((12, 8), F32), operand((8, 10), F32)
    (aj, at), (bj, bt) = pair(a), pair(b)
    compare(kr(aj, bj), kp(at, bt))
    k1 = xp.dispatch_gemm(xp.GemmShape(24, 24, 24), xp.GemmFlags.BETA_0)
    assert k1 is xp.dispatch_gemm(xp.GemmShape(24, 24, 24),
                                  xp.GemmFlags.BETA_0)
    assert k1 is not xp.dispatch_gemm(xp.GemmShape(24, 24, 25),
                                      xp.GemmFlags.BETA_0)
    t = xp.dispatch_tilecfg_gemm(xp.GemmShape(8, 8, 8))
    assert t() is None and t.info.kind == "tilecfg"
    assert t.name == xt.dispatch_tilecfg_gemm(GemmShape(8, 8, 8)).name


def test_unported_parts_raise():
    shape = xp.GemmShape(16, 16, 16)
    with pytest.raises(NotImplementedError, match="item 7"):
        xp.dispatch_brgemm_ext(shape)
    with pytest.raises(NotImplementedError, match="item 7"):
        xp.xmmdispatch(xp.descriptor.GemmExtDescriptor(
            xp.GemmDescriptor(shape)))
    with pytest.raises(NotImplementedError, match="item 8"):
        xp.dispatch_gemm(xp.GemmShape(16, 64, 64,
                                      a_in_type=xp.Datatype.MXFP4X2,
                                      b_in_type=xp.Datatype.BF16))
    kern = xp.dispatch_gemm(shape, xp.GemmFlags.BETA_0)
    with pytest.raises(NotImplementedError, match="item 14"):
        kern.lower_text()
    with pytest.raises(NotImplementedError, match="item 14"):
        kern.dump()


def test_gemm_grad_through_torch_route():
    m, n, k = 8, 6, 4
    a, b = operand((m, k), F32), operand((k, n), F32)
    kr = xt.dispatch_gemm(GemmShape(m, n, k), B0)
    kp = xp.dispatch_gemm(xp.GemmShape(m, n, k), xp.GemmFlags.BETA_0)
    ga, gb = jax.grad(lambda x, y: jnp.sum(kr(x, y) ** 2), argnums=(0, 1))(
        jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))
    at = torch.tensor(a, dtype=torch.float32, requires_grad=True)
    bt = torch.tensor(b, dtype=torch.float32, requires_grad=True)
    (kp(at, bt) ** 2).sum().backward()
    check(np.asarray(ga), at.grad, margin=1e-5)
    check(np.asarray(gb), bt.grad, margin=1e-5)


# ---------------------------------------------------------------------------
# support predicates and the batched kernel's routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", [F32, BF16, F16, I8], ids=lambda d: d.value)
@pytest.mark.parametrize("flags", [B0, B0 | GemmFlags.TRANS_A,
                                   GemmFlags.TRANS_B])
def test_support_predicates_parity(dt, flags):
    for m in (1, 8, 256, 300, 512, 600, 1024, 1100):
        for n in (1, 2, 16, 32, 48, 64, 128, 256):
            for k in (1, 16, 32, 48, 64, 128, 256):
                for out in (F32, BF16, I32):
                    d = GemmDescriptor(GemmShape(m, n, k, a_in_type=dt,
                                                 b_in_type=dt, out_type=out),
                                       flags)
                    dp = port(d)
                    assert rk._supported(d) == pk._supported(dp)
                    assert (rk.packed_brgemm_supported(d)
                            == pk.packed_brgemm_supported(dp))
                    assert (rk.packed_smm_supported(d)
                            == pk.packed_smm_supported(dp))


@pytest.mark.parametrize("cp", EPILOGUES + ["SQRT"])
@pytest.mark.parametrize("br,pack_q", [(8, None), (8, 4), (6, 4), (8, 3),
                                       (0, None)])
def test_build_returns_none_parity(cp, br, pack_q):
    d = GemmDescriptor(GemmShape(16, 32, 64), B0)
    ref = rk.build_packed_brgemm(d, br, cp_type=cp, pack_q=pack_q)
    got = pk.build_packed_brgemm(port(d), br, cp_type=cp, pack_q=pack_q)
    assert (ref is None) == (got is None)
    di = GemmDescriptor(GemmShape(32, 32, 32, a_in_type=I8, b_in_type=I8,
                                  out_type=I32), B0)
    for g in (0, 3):
        for desc in (d, di):
            assert ((rk.build_packed_batched_gemm(desc, g, cp) is None)
                    == (pk.build_packed_batched_gemm(port(desc), g, cp)
                        is None))


# ---------------------------------------------------------------------------
# dispatch_gemm_batched (the batched kernel, or the torch route)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch,m,n,k", [(4, 32, 32, 32), (7, 13, 5, 7),
                                         (16, 8, 8, 8), (3, 64, 48, 16),
                                         (2, 256, 128, 128), (2, 300, 8, 8)])
def test_gemm_batched_parity(batch, m, n, k):
    shape = GemmShape(m, n, k)
    (aj, at), (bj, bt) = pair(operand((batch, m, k), F32)), pair(
        operand((batch, k, n), F32))
    compare(xt.dispatch_gemm_batched(shape, B0)(aj, bj),
            xp.dispatch_gemm_batched(port(shape), pflags(B0))(at, bt))


@pytest.mark.parametrize("a_dt,o_dt", [(F32, BF16), (BF16, F32),
                                       (BF16, BF16), (F16, F32), (I8, I32),
                                       (U8, I32)],
                         ids=lambda d: d.value)
@pytest.mark.parametrize("beta", [0, 1])
def test_gemm_batched_dtypes_parity(a_dt, o_dt, beta):
    batch, m, n, k = 5, 16, 12, 8
    shape = GemmShape(m, n, k, a_in_type=a_dt, b_in_type=a_dt, out_type=o_dt)
    flags = B0 if beta == 0 else GemmFlags.NONE
    (aj, at), (bj, bt) = pair(operand((batch, m, k), a_dt), a_dt), pair(
        operand((batch, k, n), a_dt), a_dt)
    rargs, pargs = [aj, bj], [at, bt]
    if beta:
        cj, ct = pair(operand((batch, m, n), o_dt), o_dt)
        rargs.append(cj)
        pargs.append(ct)
    compare(xt.dispatch_gemm_batched(shape, flags)(*rargs),
            xp.dispatch_gemm_batched(port(shape), pflags(flags))(*pargs),
            a_dt, o_dt)


@pytest.mark.parametrize("ta,tb", [(True, False), (False, True)])
def test_gemm_batched_transposes_parity(ta, tb):
    batch, m, n, k = 3, 9, 7, 5
    flags = B0 | (GemmFlags.TRANS_A if ta else 0) | (
        GemmFlags.TRANS_B if tb else 0)
    a = operand((batch,) + ((k, m) if ta else (m, k)), F32)
    b = operand((batch,) + ((n, k) if tb else (k, n)), F32)
    (aj, at), (bj, bt) = pair(a), pair(b)
    shape = GemmShape(m, n, k)
    compare(xt.dispatch_gemm_batched(shape, flags)(aj, bj),
            xp.dispatch_gemm_batched(port(shape), pflags(flags))(at, bt))


def test_gemm_batched_routes_like_reference():
    from libxsmm_torch.ops.gemm import _batched_kernel
    for shape, flags in ((GemmShape(32, 32, 32), B0),
                         (GemmShape(300, 8, 8), B0),
                         (GemmShape(8, 8, 8), B0 | GemmFlags.TRANS_A),
                         (GemmShape(8, 8, 8, a_in_type=F16, b_in_type=F16),
                          B0)):
        d = GemmDescriptor(shape, flags)
        uses_kernel = rk.build_batched_gemm(d, 4) is not None
        fn = _batched_kernel(port(d), 4, True)
        assert isinstance(fn, pk.BatchedGemm) == uses_kernel


def test_gemm_batched_tuned_and_announced():
    batch, m, n, k = 8, 16, 16, 16
    shape = GemmShape(m, n, k)
    (aj, at), (bj, bt) = pair(operand((batch, m, k), F32)), pair(
        operand((batch, k, n), F32))
    ref = xt.dispatch_gemm_batched(shape, B0, tune=True)(aj, bj)
    kp = xp.dispatch_gemm_batched(port(shape), pflags(B0), tune=True)
    compare(ref, kp(at, bt))
    compare(ref, kp(at, bt))       # second call reuses the pick
    kb = xp.dispatch_gemm_batched(port(shape), pflags(B0), batch=batch)
    compare(ref, kb(at, bt))


def test_gemm_batched_empty_and_refusals():
    shape = GemmShape(32, 32, 32)
    z = np.zeros((0, 32, 32), np.float32)
    ref = xt.dispatch_gemm_batched(shape, B0)(z, z)
    got = xp.dispatch_gemm_batched(port(shape), pflags(B0))(
        torch.from_numpy(z), torch.from_numpy(z))
    assert got.shape == ref.shape == (0, 32, 32)
    a = torch.from_numpy(operand((4, 16, 16), F32).astype(np.float32))
    k0 = xp.dispatch_gemm_batched(xp.GemmShape(16, 16, 16),
                                  xp.GemmFlags.BETA_0)
    with pytest.raises(ValueError, match="BETA_0"):
        k0(a, a, a)
    k1 = xp.dispatch_gemm_batched(xp.GemmShape(16, 16, 16))
    with pytest.raises(ValueError, match="needs the C operand"):
        k1(a, a)
    with pytest.raises(ValueError, match="VNNI"):
        xp.dispatch_gemm_batched(
            xp.GemmShape(32, 32, 32, a_in_type=xp.Datatype.BF16,
                         b_in_type=xp.Datatype.BF16),
            xp.GemmFlags.BETA_0 | xp.GemmFlags.VNNI_A)
    with pytest.raises(ValueError, match="dtype"):
        k0(a.double(), a.double())


# ---------------------------------------------------------------------------
# dispatch_gemm_batched_packed (the headline kernel)
# ---------------------------------------------------------------------------

def _packed_pair(x, p, dt=F32):
    xj, xt_ = pair(x, dt)
    return xt.pack_batched(jnp.asarray(xj), p), xp.pack_batched(xt_, p)


@pytest.mark.parametrize("n,batch,m", [(32, 64, 32), (16, 24, 40),
                                       (64, 8, 16), (128, 2, 8),
                                       (8, 32, 5), (1, 128, 3)])
def test_packed_smm_parity(n, batch, m):
    k = n
    shape = GemmShape(m, n, k)
    p = xp.smm_pack_factor(port(shape))
    assert p == xt.smm_pack_factor(shape) == 128 // n
    aj, at = _packed_pair(operand((batch, m, k), F32), p)
    bj, bt = _packed_pair(operand((batch, k, n), F32), p)
    kr = xt.dispatch_gemm_batched_packed(shape, B0)
    kp = xp.dispatch_gemm_batched_packed(port(shape), pflags(B0))
    assert kr.name == kp.name and kr.info.nflops == kp.info.nflops
    ref = xt.unpack_batched(kr(aj, bj), p)
    compare(ref, xp.unpack_batched(kp(at, bt), p))


@pytest.mark.parametrize("cp", EPILOGUES)
@pytest.mark.parametrize("a_dt,o_dt", [(F32, F32), (BF16, F32),
                                       (BF16, BF16), (F32, BF16)],
                         ids=lambda d: d.value)
def test_packed_smm_epilogue_parity(cp, a_dt, o_dt):
    m = n = k = 32
    batch, p = 8, 4
    shape = GemmShape(m, n, k, a_in_type=a_dt, b_in_type=a_dt, out_type=o_dt)
    aj, at = _packed_pair(operand((batch, m, k), a_dt) * 0.5, p, a_dt)
    bj, bt = _packed_pair(operand((batch, k, n), a_dt) * 0.5, p, a_dt)
    ref = xt.dispatch_gemm_batched_packed(shape, B0,
                                          cp_type=UnaryType[cp])(aj, bj)
    got = xp.dispatch_gemm_batched_packed(port(shape), pflags(B0),
                                          cp_type=xp.UnaryType[cp])(at, bt)
    compare(ref, got, a_dt, o_dt)


@pytest.mark.parametrize("cp", ["NONE", "IDENTITY", "RELU", "X2"])
@pytest.mark.parametrize("beta", [0, 1])
def test_packed_smm_int8_parity(cp, beta):
    # full-range int8 operands: X2 of the i32 accumulator overflows and must
    # wrap exactly as the reference's int32 arithmetic does
    m = n = k = 32
    batch, p = 8, 4
    shape = GemmShape(m, n, k, a_in_type=I8, b_in_type=I8, out_type=I32)
    flags = B0 if beta == 0 else GemmFlags.NONE
    aj, at = _packed_pair(RNG.integers(-128, 128, (batch, m, k)), p, I8)
    bj, bt = _packed_pair(RNG.integers(-128, 128, (batch, k, n)), p, I8)
    rargs, pargs = [aj, bj], [at, bt]
    if beta:
        cj, ct = _packed_pair(RNG.integers(-2 ** 20, 2 ** 20, (batch, m, n)),
                              p, I32)
        rargs.append(cj)
        pargs.append(ct)
    ref = xt.dispatch_gemm_batched_packed(shape, flags,
                                          cp_type=UnaryType[cp])(*rargs)
    got = xp.dispatch_gemm_batched_packed(port(shape), pflags(flags),
                                          cp_type=xp.UnaryType[cp])(*pargs)
    compare(ref, got, I8, I32)


@pytest.mark.parametrize("cp", ["NONE", "RELU", "GELU"])
@pytest.mark.parametrize("o_dt", [F32, BF16], ids=lambda d: d.value)
def test_packed_smm_beta1_parity(cp, o_dt):
    m = n = k = 16
    batch, p = 16, 8
    shape = GemmShape(m, n, k, out_type=o_dt)
    aj, at = _packed_pair(operand((batch, m, k), F32), p)
    bj, bt = _packed_pair(operand((batch, k, n), F32), p)
    cj, ct = _packed_pair(operand((batch, m, n), o_dt), p, o_dt)
    ref = xt.dispatch_gemm_batched_packed(shape, GemmFlags.NONE,
                                          cp_type=UnaryType[cp])(aj, bj, cj)
    got = xp.dispatch_gemm_batched_packed(
        port(shape), xp.GemmFlags.NONE, cp_type=xp.UnaryType[cp])(at, bt, ct)
    compare(ref, got, F32, o_dt)


@pytest.mark.parametrize("step_groups", [None, 3])
def test_packed_smm_ragged_and_tuned(step_groups):
    m, n, k, batch, p = 40, 32, 32, 28, 4   # 7 groups, 40 rows
    shape = GemmShape(m, n, k)
    aj, at = _packed_pair(operand((batch, m, k), F32), p)
    bj, bt = _packed_pair(operand((batch, k, n), F32), p)
    ref = xt.dispatch_gemm_batched_packed(shape, B0,
                                          step_groups=step_groups)(aj, bj)
    got = xp.dispatch_gemm_batched_packed(port(shape), pflags(B0),
                                          step_groups=step_groups)(at, bt)
    compare(ref, got)
    tuned = xp.dispatch_gemm_batched_packed(port(shape), pflags(B0),
                                            tune=True)
    compare(ref, tuned(at, bt))
    compare(ref, tuned(at, bt))


def test_packed_smm_empty_batch():
    shape = GemmShape(32, 32, 32)
    z = np.zeros((0, 32, 128), np.float32)
    ref = xt.dispatch_gemm_batched_packed(shape, B0)(z, z)
    got = xp.dispatch_gemm_batched_packed(port(shape), pflags(B0))(
        torch.from_numpy(z), torch.from_numpy(z))
    assert got.shape == ref.shape == (0, 32, 128)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("case", ["k!=n", "n=48", "f16", "trans", "dropout",
                                  "i8-gelu", "vnni"])
def test_packed_smm_dispatch_refusals_parity(case):
    shape, flags, cp = GemmShape(32, 32, 32), B0, UnaryType.NONE
    if case == "k!=n":
        shape = GemmShape(32, 32, 16)
    elif case == "n=48":
        shape = GemmShape(32, 48, 48)
    elif case == "f16":
        shape = GemmShape(32, 32, 32, a_in_type=F16, b_in_type=F16)
    elif case == "trans":
        flags = B0 | GemmFlags.TRANS_B
    elif case == "dropout":
        cp = UnaryType.DROPOUT
    elif case == "i8-gelu":
        shape = GemmShape(32, 32, 32, a_in_type=I8, b_in_type=I8,
                          out_type=I32)
        cp = UnaryType.GELU
    elif case == "vnni":
        flags = B0 | GemmFlags.VNNI_A
    with pytest.raises(ValueError):
        xt.dispatch_gemm_batched_packed(shape, flags, cp_type=cp)
    with pytest.raises(ValueError):
        xp.dispatch_gemm_batched_packed(port(shape), pflags(flags),
                                        cp_type=xp.UnaryType[cp.name])


def test_packed_smm_call_refusals():
    a = torch.zeros((4, 32, 128))
    k0 = xp.dispatch_gemm_batched_packed(xp.GemmShape(32, 32, 32),
                                         xp.GemmFlags.BETA_0)
    with pytest.raises(ValueError, match="BETA_0"):
        k0(a, a, a)
    k1 = xp.dispatch_gemm_batched_packed(xp.GemmShape(32, 32, 32))
    with pytest.raises(ValueError, match="needs the C operand"):
        k1(a, a)
    with pytest.raises(ValueError, match="shape"):
        k0(a, torch.zeros((4, 16, 128)))
    with pytest.raises(ValueError):
        xp.pack_batched(torch.zeros((10, 4, 4)), 4)
    with pytest.raises(ValueError):
        xp.smm_pack_factor(xp.GemmShape(32, 32, 16))


def test_pack_unpack_parity():
    x = RNG.standard_normal((24, 8, 16)).astype(np.float32)
    ref = np.asarray(xt.pack_batched(x, 8))
    got = xp.pack_batched(torch.from_numpy(x), 8)
    assert got.shape == (3, 8, 128)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(xp.unpack_batched(got, 8).numpy(), x)
    np.testing.assert_array_equal(
        xp.pack_batched(x, 8, device="cpu").numpy(), ref)


def test_packed_smm_grad_parity():
    m = n = k = 32
    batch, p = 8, 4
    a, b, c = (operand((batch, m, k), F32), operand((batch, k, n), F32),
               operand((batch, m, n), F32))
    kr = xt.dispatch_gemm_batched_packed(GemmShape(m, n, k))
    kp = xp.dispatch_gemm_batched_packed(xp.GemmShape(m, n, k))
    ap, bp, cp = (xt.pack_batched(jnp.asarray(x, jnp.float32), p)
                  for x in (a, b, c))
    grads = jax.grad(lambda x, y, z: jnp.sum(kr(x, y, z) ** 2),
                     argnums=(0, 1, 2))(ap, bp, cp)
    ts = [xp.pack_batched(torch.tensor(x, dtype=torch.float32), p)
          .requires_grad_() for x in (a, b, c)]
    (kp(*ts) ** 2).sum().backward()
    for g_ref, t in zip(grads, ts):
        check(np.asarray(g_ref), t.grad, margin=1e-5)


# ---------------------------------------------------------------------------
# dispatch_brgemm_packed / dispatch_brgemm_ext_packed
# ---------------------------------------------------------------------------

def _br_operands(br, m, n, k, q, dt=F32, scale=1.0):
    a = operand((br, m, k), dt) * scale
    b = operand((br, k, n), dt) * scale
    aj, at = _packed_pair(a, q, dt)
    bj, bt = pair(b, dt)
    return aj, at, bj, bt


@pytest.mark.parametrize("k,br", [(64, 8), (32, 16), (128, 4), (16, 8)])
def test_brgemm_packed_parity(k, br):
    m, n = 32, 64
    shape = GemmShape(m, n, k)
    q = xp.brgemm_pack_factor(port(shape))
    assert q == xt.brgemm_pack_factor(shape) == 128 // k
    cfg = BatchReduceConfig(BatchReduceType.STRIDE, br)
    aj, at, bj, bt = _br_operands(br, m, n, k, q)
    kr = xt.dispatch_brgemm_packed(shape, B0, cfg)
    kp = xp.dispatch_brgemm_packed(port(shape), pflags(B0), port(cfg))
    assert kr.name == kp.name
    compare(kr(aj, bj), kp(at, bt))


@pytest.mark.parametrize("a_dt,o_dt", [(BF16, F32), (BF16, BF16),
                                       (F32, BF16)],
                         ids=lambda d: d.value)
@pytest.mark.parametrize("beta", [0, 1])
def test_brgemm_packed_dtypes_parity(a_dt, o_dt, beta):
    br, m, n, k = 8, 16, 32, 64
    shape = GemmShape(m, n, k, a_in_type=a_dt, b_in_type=a_dt, out_type=o_dt)
    cfg = BatchReduceConfig(BatchReduceType.STRIDE, br)
    flags = B0 if beta == 0 else GemmFlags.NONE
    aj, at, bj, bt = _br_operands(br, m, n, k, 2, a_dt)
    rargs, pargs = [aj, bj], [at, bt]
    if beta:
        cj, ct = pair(operand((m, n), o_dt), o_dt)
        rargs.append(cj)
        pargs.append(ct)
    compare(xt.dispatch_brgemm_packed(shape, flags, cfg)(*rargs),
            xp.dispatch_brgemm_packed(port(shape), pflags(flags),
                                      port(cfg))(*pargs), a_dt, o_dt)


@pytest.mark.parametrize("mult,sg", [(4, 2), (8, 1), (8, 4), (1, 3)])
def test_brgemm_packed_deep_pack_parity(mult, sg):
    m, n, k, br = 16, 32, 64, 32
    shape = GemmShape(m, n, k)
    q = xt.brgemm_pack_factor(shape) * mult
    cfg = BatchReduceConfig(BatchReduceType.STRIDE, br)
    aj, at, bj, bt = _br_operands(br, m, n, k, q)
    kr = xt.dispatch_brgemm_packed(shape, B0, cfg, step_groups=sg, pack_q=q)
    kp = xp.dispatch_brgemm_packed(port(shape), pflags(B0), port(cfg),
                                   step_groups=sg, pack_q=q)
    compare(kr(aj, bj), kp(at, bt))
    ga, gb = jax.grad(lambda x, y: jnp.sum(kr(x, y) ** 2),
                      argnums=(0, 1))(aj, jnp.asarray(bj))
    at.requires_grad_()
    bt.requires_grad_()
    (kp(at, bt) ** 2).sum().backward()
    check(np.asarray(ga), at.grad, margin=1e-5)
    check(np.asarray(gb), bt.grad, margin=1e-5)


def test_brgemm_packed_nondivisible_and_scratch():
    # groups % step_groups != 0: the last chunk of the K range is ragged
    m = n = 64
    k, br = 64, 20
    shape = GemmShape(m, n, k)
    cfg = BatchReduceConfig(BatchReduceType.STRIDE, br)
    aj, at, bj, bt = _br_operands(br, m, n, k, 2)
    ref = xt.dispatch_brgemm_packed(shape, B0, cfg)(aj, bj)
    for sg, scratch in ((None, False), (4, False), (3, True)):
        got = xp.dispatch_brgemm_packed(port(shape), pflags(B0), port(cfg),
                                        step_groups=sg,
                                        acc_scratch=scratch)(at, bt)
        compare(ref, got)


def test_brgemm_packed_refusals():
    m, n, k, br = 16, 32, 64, 12
    kp = xp.dispatch_brgemm_packed(
        xp.GemmShape(m, n, k), xp.GemmFlags.BETA_0,
        xp.BatchReduceConfig(xp.BatchReduceType.STRIDE, br), pack_q=3)
    a = torch.from_numpy(operand((br, m, k), F32).astype(np.float32))
    b = torch.from_numpy(operand((br, k, n), F32).astype(np.float32))
    with pytest.raises(ValueError, match="pack"):
        kp(xp.pack_batched(a, 3), b)       # q=3 is not a multiple of 2
    k2 = xp.dispatch_brgemm_packed(xp.GemmShape(m, n, k), xp.GemmFlags.BETA_0)
    with pytest.raises(ValueError, match="pack"):
        k2(xp.pack_batched(a, 2)[:1], b[:3])   # br % q
    with pytest.raises(ValueError, match="BETA_0"):
        k2(xp.pack_batched(a, 2), b, torch.zeros(m, n))
    k1 = xp.dispatch_brgemm_packed(xp.GemmShape(m, n, k))
    with pytest.raises(ValueError, match="needs the C operand"):
        k1(xp.pack_batched(a, 2), b)
    for bad in (xp.GemmShape(16, 16, 48),
                xp.GemmShape(16, 16, 64, a_in_type=xp.Datatype.F16,
                             b_in_type=xp.Datatype.F16)):
        with pytest.raises(ValueError):
            xp.dispatch_brgemm_packed(bad)
    with pytest.raises(ValueError, match="VNNI"):
        xp.dispatch_brgemm_packed(xp.GemmShape(16, 16, 64),
                                  xp.GemmFlags.VNNI_B)


@pytest.mark.parametrize("cp", EPILOGUES)
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("beta", [0, 1])
def test_brgemm_ext_packed_parity(cp, bias, beta):
    m, n, k, br, q = 16, 32, 64, 8, 2
    shape = GemmShape(m, n, k)
    cfg = BatchReduceConfig(BatchReduceType.STRIDE, br)
    flags = B0 if beta == 0 else GemmFlags.NONE
    argops = UnaryArgops(cp_type=UnaryType[cp])
    postops = BinaryPostops(d_type=BinaryType.ADD if bias else
                            BinaryType.NONE)
    aj, at, bj, bt = _br_operands(br, m, n, k, q, scale=0.3)
    kr = xt.dispatch_brgemm_ext_packed(shape, flags, cfg, argops=argops,
                                       postops=postops)
    kp = xp.dispatch_brgemm_ext_packed(port(shape), pflags(flags), port(cfg),
                                       argops=port(argops),
                                       postops=port(postops))
    assert kr.name == kp.name
    rkw, pkw = {}, {}
    rargs, pargs = [aj, bj], [at, bt]
    if beta:
        cj, ct = pair(operand((m, n), F32))
        rargs.append(cj)
        pargs.append(ct)
    if bias:
        dj, dt_ = pair(operand((1, n), F32))
        rkw["d_op"], pkw["d_op"] = dj, dt_
    compare(kr(*rargs, **rkw), kp(*pargs, **pkw))


@pytest.mark.parametrize("d_shape", [(1, 32), (16, 32), (16, 1)])
def test_brgemm_ext_packed_bias_and_deep_pack(d_shape):
    m, n, k, br = 16, 32, 64, 16
    shape = GemmShape(m, n, k)
    q = xt.brgemm_pack_factor(shape) * 4
    cfg = BatchReduceConfig(BatchReduceType.STRIDE, br)
    argops = UnaryArgops(cp_type=UnaryType.RELU)
    postops = BinaryPostops(d_type=BinaryType.ADD)
    aj, at, bj, bt = _br_operands(br, m, n, k, q)
    dj, dt_ = pair(operand(d_shape, F32))
    ref = xt.dispatch_brgemm_ext_packed(shape, B0, cfg, argops=argops,
                                        postops=postops, pack_q=q,
                                        step_groups=3)(aj, bj, d_op=dj)
    got = xp.dispatch_brgemm_ext_packed(port(shape), pflags(B0), port(cfg),
                                        argops=port(argops),
                                        postops=port(postops), pack_q=q,
                                        step_groups=3)(at, bt, d_op=dt_)
    compare(ref, got)


@pytest.mark.parametrize("case", ["sqrt", "mul", "k63", "argop-a", "store"])
def test_brgemm_ext_packed_dispatch_refusals_parity(case):
    shape, argops, postops = (GemmShape(16, 32, 64), UnaryArgops(),
                              BinaryPostops())
    if case == "sqrt":
        argops = UnaryArgops(cp_type=UnaryType.SQRT)
    elif case == "mul":
        postops = BinaryPostops(d_type=BinaryType.MUL)
    elif case == "k63":
        shape = GemmShape(16, 32, 63)
    elif case == "argop-a":
        argops = UnaryArgops(ap_type=UnaryType.X2)
    elif case == "store":
        argops = UnaryArgops(cp_type=UnaryType.RELU, store_cp=True)
    with pytest.raises(ValueError):
        xt.dispatch_brgemm_ext_packed(shape, B0, argops=argops,
                                      postops=postops)
    with pytest.raises(ValueError):
        xp.dispatch_brgemm_ext_packed(port(shape), pflags(B0),
                                      argops=port(argops),
                                      postops=port(postops))


def test_brgemm_ext_packed_call_refusals():
    m, n, k, br = 16, 32, 64, 4
    a = torch.zeros((br // 2, m, 2 * k))
    b = torch.zeros((br, k, n))
    kb = xp.dispatch_brgemm_ext_packed(
        xp.GemmShape(m, n, k), xp.GemmFlags.BETA_0,
        postops=xp.BinaryPostops(d_type=xp.BinaryType.ADD))
    with pytest.raises(ValueError, match="D operand"):
        kb(a, b)
    with pytest.raises(ValueError, match="BETA_0"):
        kb(a, b, torch.zeros(m, n), d_op=torch.zeros(1, n))
    k1 = xp.dispatch_brgemm_ext_packed(xp.GemmShape(m, n, k))
    with pytest.raises(ValueError, match="C operand"):
        k1(a, b)


def test_build_packed_brgemm_late_c_parity():
    # beta-0 callers of the raw builder may pass c for an add after the
    # kernel (the reference's legacy convenience)
    m, n, k, br = 16, 32, 64, 8
    d = GemmDescriptor(GemmShape(m, n, k, out_type=BF16), B0)
    aj, at, bj, bt = _br_operands(br, m, n, k, 2)
    cj, ct = pair(operand((m, n), F32))
    ref = rk.build_packed_brgemm(d, br)(aj, jnp.asarray(bj), cj)
    got = pk.build_packed_brgemm(port(d), br)(at, bt, ct)
    compare(ref, got, F32, BF16)


def test_brgemm_packed_grad_parity():
    m, n, k, br, q = 16, 32, 64, 8, 2
    shape = GemmShape(m, n, k)
    cfg = BatchReduceConfig(BatchReduceType.STRIDE, br)
    aj, at, bj, bt = _br_operands(br, m, n, k, q)
    cj, ct = pair(operand((m, n), F32))
    kr = xt.dispatch_brgemm_packed(shape, GemmFlags.NONE, cfg)
    kp = xp.dispatch_brgemm_packed(port(shape), xp.GemmFlags.NONE, port(cfg))
    grads = jax.grad(lambda x, y, z: jnp.sum(kr(x, y, z) ** 2),
                     argnums=(0, 1, 2))(aj, jnp.asarray(bj), jnp.asarray(cj))
    ts = [at.requires_grad_(), bt.requires_grad_(), ct.requires_grad_()]
    (kp(*ts) ** 2).sum().backward()
    for g_ref, t in zip(grads, ts):
        check(np.asarray(g_ref), t.grad, margin=1e-5)


# ---------------------------------------------------------------------------
# the headline sequence end to end, and the device policy
# ---------------------------------------------------------------------------

def test_headline_sequence_end_to_end():
    """numpy -> pack -> dispatch -> unpack, at a small size, through both
    packages' public entry points."""
    B, m, n, k = 64, 32, 32, 32
    rng = np.random.default_rng(0)
    a = rng.standard_normal((B, m, k)).astype(np.float32)
    b = (rng.standard_normal((B, k, n)) * 0.1).astype(np.float32)
    p = xt.smm_pack_factor(GemmShape(m, n, k))
    kr = xt.dispatch_gemm_batched_packed(GemmShape(m, n, k), B0)
    ref = xt.unpack_batched(kr(xt.pack_batched(a, p),
                               xt.pack_batched(b, p)), p)
    pp = xp.smm_pack_factor(xp.GemmShape(m, n, k))
    kp = xp.dispatch_gemm_batched_packed(xp.GemmShape(m, n, k),
                                         xp.GemmFlags.BETA_0)
    got = xp.unpack_batched(kp(xp.pack_batched(a, pp, device="cpu"),
                               xp.pack_batched(b, pp, device="cpu")), pp)
    compare(ref, got)
    check(np.einsum("bmk,bkn->bmn", a.astype(np.float64), b), got,
          margin=1e-5)


def test_wrappers_refuse_mixed_devices():
    d = xp.GemmDescriptor(xp.GemmShape(8, 8, 8), xp.GemmFlags.BETA_0)
    fn = pk.build_batched_gemm(d, 2)
    cpu = torch.zeros((2, 8, 8))
    with pytest.raises(ValueError, match="different devices"):
        fn(cpu, torch.zeros((2, 8, 8), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        fn(torch.zeros((2, 8, 8), device="meta"),
           torch.zeros((2, 8, 8), device="meta"))
