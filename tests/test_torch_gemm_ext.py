"""The fused BRGEMM-ext (`dispatch_brgemm_ext`, `xmmdispatch` of a
GemmExtDescriptor) against the JAX package's, on the CPU, feature by
feature: a/b/c unary argops with their store_* side outputs, binary
postops on the f32 accumulator (full and broadcast D), the RELU bitmask
side output, the stochastic-round store (then VNNI_C), the OFFSET/ADDRESS
modes with the positional order c, d, a_idx, b_idx, the seed keyword, MX
operands, and the refusals.

Tolerances (matdiff normf_rel): 1e-5 for f32 in and out (sums in another
order, transcendentals differ in the last bits), 1e-4 for bf16 inputs with
f32 output; masks exact. The stochastic-round store is held within one
bf16 ulp of the f32 accumulator, in both packages (their random bits
differ by design).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import libxsmm_torch as xp
import libxsmm_tpu as xt
from libxsmm_torch import interop
from libxsmm_torch.matdiff import check
from libxsmm_tpu.descriptor import (BatchReduceConfig, BatchReduceType,
                                    BinaryPostops, BinaryType,
                                    GemmDescriptor, GemmExtDescriptor,
                                    GemmFlags, GemmShape, UnaryArgops,
                                    UnaryFlags, UnaryType)
from libxsmm_tpu.dtypes import Datatype

torch.set_num_threads(1)

RNG = np.random.default_rng(77)
F32, BF16 = Datatype.F32, Datatype.BF16
B0 = GemmFlags.BETA_0


def port(obj):
    return interop.descriptor_from_fields(interop.descriptor_fields(obj))


def both(shape, dt=F32, scale=0.5):
    x = (RNG.standard_normal(shape) * scale).astype(np.float32)
    if dt == BF16:
        xj = jnp.asarray(x, jnp.bfloat16)
        return xj, interop.tensor_from_numpy(np.asarray(xj),
                                             xp.Datatype.BF16, "cpu")
    return jnp.asarray(x), torch.from_numpy(x)


def kernels(shape, flags=B0, br=3, br_type=BatchReduceType.STRIDE,
            argops=UnaryArgops(), postops=BinaryPostops()):
    cfg = BatchReduceConfig(br_type, br)
    kr = xt.dispatch_brgemm_ext(shape, flags, cfg, argops=argops,
                                postops=postops)
    kp = xp.dispatch_brgemm_ext(port(shape), xp.GemmFlags(int(flags)),
                                port(cfg), argops=port(argops),
                                postops=port(postops))
    assert kr.name == kp.name and kr.info.nflops == kp.info.nflops
    assert kp.info.kind == "gemm_ext"
    return kr, kp


def same(ref, got, tol=1e-5):
    if isinstance(ref, tuple):
        (ref, rx), (got, gx) = ref, got
        assert sorted(rx) == sorted(gx)
        for k in rx:
            if k == "cp_bitmask":
                np.testing.assert_array_equal(gx[k].numpy(),
                                              np.asarray(rx[k]))
            else:
                same(rx[k], gx[k], tol)
    assert tuple(got.shape) == np.asarray(ref).shape
    check(np.asarray(ref, np.float64), got, margin=tol)


M, N, K, BR = 12, 20, 16, 3


@pytest.mark.parametrize("which", ["ap", "bp", "cp"])
@pytest.mark.parametrize("op", ["RELU", "X2", "TANH", "GELU", "SIGMOID"])
@pytest.mark.parametrize("store", [False, True])
def test_argops_and_stores(which, op, store):
    kw = {f"{which}_type": UnaryType[op], f"store_{which}": store}
    argops = UnaryArgops(**kw)
    kr, kp = kernels(GemmShape(M, N, K), argops=argops)
    (aj, at), (bj, bt) = both((BR, M, K)), both((BR, K, N))
    out = kp(at, bt)
    assert isinstance(out, tuple) == store
    same(kr(aj, bj), out)


@pytest.mark.parametrize("post", ["ADD", "MUL", "SUB", "MAX", "MIN", "DIV"])
@pytest.mark.parametrize("d_shape", [(M, N), (1, N), (M, 1)])
def test_binary_postops(post, d_shape):
    postops = BinaryPostops(d_type=BinaryType[post])
    kr, kp = kernels(GemmShape(M, N, K), postops=postops)
    (aj, at), (bj, bt) = both((BR, M, K)), both((BR, K, N))
    dj, dt_ = both(d_shape)
    if post == "DIV":
        dj, dt_ = dj + 3.0, dt_ + 3.0
    same(kr(aj, bj, dj), kp(at, bt, dt_))


@pytest.mark.parametrize("dt", [F32, BF16], ids=lambda d: d.value)
@pytest.mark.parametrize("beta", [0, 1])
def test_relu_bitmask_bias_beta(dt, beta):
    argops = UnaryArgops(cp_type=UnaryType.RELU,
                         cp_flags=UnaryFlags.BITMASK_2BYTEMULT, store_cp=True)
    postops = BinaryPostops(d_type=BinaryType.ADD)
    shape = GemmShape(M, N, K, a_in_type=dt, b_in_type=dt, out_type=F32)
    kr, kp = kernels(shape, B0 if beta == 0 else GemmFlags.NONE,
                     argops=argops, postops=postops)
    (aj, at), (bj, bt) = both((BR, M, K), dt), both((BR, K, N), dt)
    rargs, pargs = [aj, bj], [at, bt]
    if beta:
        cj, ct = both((M, N))
        rargs.append(cj)
        pargs.append(ct)
    dj, dt_ = both((1, N))
    out, extra = kp(*pargs, dt_)
    same(kr(*rargs, dj), (out, extra), 1e-5 if dt == F32 else 1e-4)
    # the mask is acc > 0 before the relu; cp is stored before the postop
    acc = extra["cp"] + dt_
    assert torch.equal(xp.unpack_bitmask(extra["cp_bitmask"], M, N),
                       acc > 0)
    assert extra["cp_bitmask"].shape == (M, 4)


@pytest.mark.parametrize("br_type", ["OFFSET", "ADDRESS"])
def test_index_modes_positional_order(br_type):
    postops = BinaryPostops(d_type=BinaryType.ADD)
    kr, kp = kernels(GemmShape(M, N, K), GemmFlags.NONE,
                     br_type=BatchReduceType[br_type],
                     argops=UnaryArgops(cp_type=UnaryType.GELU),
                     postops=postops)
    (aj, at), (bj, bt) = both((5, M, K)), both((5, K, N))
    (cj, ct), (dj, dt_) = both((M, N)), both((1, N))
    ia, ib = np.asarray([0, 3, 1], np.int32), np.asarray([4, 2, 2], np.int32)
    same(kr(aj, bj, cj, dj, ia, ib),
         kp(at, bt, ct, dt_, torch.from_numpy(ia), ib))


def _within_one_ulp(out, acc, mant=7):
    """One target ulp of the float64 accumulator, plus 1e-6 of its largest
    magnitude for the f32 accumulator's own rounding."""
    out = np.asarray(out, np.float64)
    ulp = np.exp2(np.floor(np.log2(np.abs(acc) + 1e-30)) - mant)
    return bool((np.abs(out - acc) <= ulp + 1e-6 * np.abs(acc).max()).all())


@pytest.mark.parametrize("vnni_c", [False, True])
def test_stochastic_round_store(vnni_c):
    argops = UnaryArgops(cp_type=UnaryType.STOCHASTIC_ROUND)
    postops = BinaryPostops(d_type=BinaryType.ADD)
    flags = B0 | (GemmFlags.VNNI_C if vnni_c else 0)
    shape = GemmShape(M, N, K, out_type=BF16)
    kr, kp = kernels(shape, flags, argops=argops, postops=postops)
    (aj, at), (bj, bt), (dj, dt_) = (both((BR, M, K)), both((BR, K, N)),
                                     both((1, N)))
    acc = (np.einsum("bmk,bkn->mn", np.asarray(aj, np.float64),
                     np.asarray(bj, np.float64)) + np.asarray(dj))
    got, ref = kp(at, bt, dt_, seed=11), kr(aj, bj, dj, seed=11)
    assert got.dtype == torch.bfloat16
    for out in (got.float().numpy(), np.asarray(ref, np.float32)):
        if vnni_c:
            assert out.shape == (M // 2, 2 * N)
            out = out.reshape(M // 2, N, 2).swapaxes(1, 2).reshape(M, N)
        assert _within_one_ulp(out, acc)
    # the seed keyword: the same seed, the same bits; another, others
    assert torch.equal(got, kp(at, bt, dt_, seed=11))
    assert not torch.equal(got, kp(at, bt, dt_, seed=12))
    assert torch.equal(got, kp(at, bt, dt_, seed=torch.tensor(11)))


def test_xmmdispatch_ext_descriptor():
    desc = GemmExtDescriptor(
        GemmDescriptor(GemmShape(M, N, K), B0,
                       BatchReduceConfig(BatchReduceType.STRIDE, BR)),
        UnaryArgops(cp_type=UnaryType.TANH),
        BinaryPostops(d_type=BinaryType.ADD))
    kr, kp = xt.xmmdispatch(desc), xp.xmmdispatch(port(desc))
    assert kr.name == kp.name
    assert kp is xp.xmmdispatch(port(desc))             # registry hit
    (aj, at), (bj, bt), (dj, dt_) = (both((BR, M, K)), both((BR, K, N)),
                                     both((M, N)))
    same(kr(aj, bj, dj), kp(at, bt, dt_))


def test_mx_operand_through_ext():
    from libxsmm_tpu import quant as rq
    shape = GemmShape(8, 16, 64, a_in_type=Datatype.MXFP4X2,
                      b_in_type=BF16, out_type=F32)
    argops = UnaryArgops(cp_type=UnaryType.RELU)
    postops = BinaryPostops(d_type=BinaryType.ADD)
    kr, kp = kernels(shape, B0 | GemmFlags.VNNI_A, br=2, argops=argops,
                     postops=postops)
    p, s = rq.mxfp4_quantize_blocks(jnp.asarray(
        RNG.standard_normal((2, 8, 64)).astype(np.float32)))
    pt = (torch.from_numpy(np.asarray(p).copy()),
          torch.from_numpy(np.asarray(s).copy()))
    (bj, bt), (dj, dt_) = both((2, 64, 16), BF16), both((1, 16))
    same(kr((p, s), bj, dj), kp(pt, bt, dt_), 1e-4)


def test_refusals():
    packed = GemmShape(8, 16, 64, a_in_type=Datatype.MXFP4X2, b_in_type=BF16)
    for argops in (UnaryArgops(ap_type=UnaryType.X2),
                   UnaryArgops(bp_type=UnaryType.RELU)):
        with pytest.raises(ValueError, match="argops"):
            xt.dispatch_brgemm_ext(packed, B0, argops=argops)
        with pytest.raises(ValueError, match="argops"):
            xp.dispatch_brgemm_ext(port(packed), xp.GemmFlags.BETA_0,
                                   argops=port(argops))
    with pytest.raises(ValueError, match="transposes"):
        xp.dispatch_brgemm_ext(port(packed), xp.GemmFlags.TRANS_A)
    kp = xp.dispatch_brgemm_ext(
        xp.GemmShape(M, N, K), xp.GemmFlags.BETA_0,
        postops=xp.BinaryPostops(d_type=xp.BinaryType.ADD))
    a, b = torch.zeros(BR, M, K), torch.zeros(BR, K, N)
    with pytest.raises(IndexError):
        kp(a, b)                      # the D operand is positional
    with pytest.raises(ValueError, match="no d operand"):
        xp.dispatch_brgemm_ext(
            xp.GemmShape(M, N, K), xp.GemmFlags.BETA_0,
            postops=xp.BinaryPostops(d_type=xp.BinaryType.ADD)).fn(
                a, b, None)
    sr = xp.dispatch_brgemm_ext(
        xp.GemmShape(M, N, K, out_type=xp.Datatype.I32), xp.GemmFlags.BETA_0,
        argops=xp.UnaryArgops(cp_type=xp.UnaryType.STOCHASTIC_ROUND))
    with pytest.raises(ValueError, match="stochastic rounding targets"):
        sr(a, b)
