"""The flash-attention backward: the port (`libxsmm_torch.kernels.attention`
build_flash_attention_bwd, `libxsmm_torch.ops.attention` gradients) against
the JAX package on the same numpy inputs, on the CPU. The JAX side runs as
its own tests run it (the Pallas kernels in interpret mode, or jax.grad
through its custom_vjp); the port runs the plain torch version of its CUDA
kernels.

Tolerances (matdiff normf_rel): 1e-4 for f32 gradients (dS = p * (dP -
delta) cancels, so summation order shows); 2e-2 for bf16 gradients (p~ and
dS rounded to bf16 against scores that differ in the last f32 bits, then
the outputs rounded to bf16); 2e-3 for f16 gradients (computed in f32 on
both sides, then rounded to f16). The dropout mask is compared bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import libxsmm_torch as xp
from libxsmm_torch.kernels import attention as pa
from libxsmm_torch.matdiff import check
from libxsmm_tpu.dtypes import Datatype
from libxsmm_tpu.kernels import attention_pallas as ra
from libxsmm_tpu.ops import attention as ro
from libxsmm_tpu.ops.attention import dispatch_flash_attention

torch.set_num_threads(1)

F32, BF16, F16, F64 = (Datatype.F32, Datatype.BF16, Datatype.F16,
                       Datatype.F64)
JNP = {F32: jnp.float32, BF16: jnp.bfloat16, F16: jnp.float16,
       F64: jnp.float32}    # the JAX package runs without x64: f64 is f32
TORCH = {F32: torch.float32, BF16: torch.bfloat16, F16: torch.float16,
         F64: torch.float64}
TOL = {F32: 1e-4, BF16: 2e-2, F16: 2e-3, F64: 1e-4}


def arrays(seed, shapes, dt):
    """Random arrays rounded to dt: (JAX arrays, CPU tensors), same values."""
    rng = np.random.default_rng(seed)
    out_j, out_t = [], []
    for shape in shapes:
        xj = jnp.asarray(rng.standard_normal(shape), JNP[dt])
        out_j.append(xj)
        out_t.append(torch.from_numpy(
            np.array(xj, np.float32)).to(TORCH[dt]))
    return out_j, out_t


def same(ref, got, dt, tol=None):
    ref = np.asarray(ref, np.float32)
    assert tuple(got.shape) == ref.shape
    assert bool(torch.isfinite(got.float()).all())
    check(ref.astype(np.float64), got.detach().double().numpy(),
          margin=TOL[dt] if tol is None else tol)


def bwd_operands(dt, bh, s, hd, kw, seed=3):
    """q, kT, v, dout (both sides), the bias, and lse/delta from the JAX
    forward with return_lse (the same numpy arrays go to both sides)."""
    (qj, kj, vj, oj), ts = arrays(seed, ((bh, s, hd), (bh, hd, s),
                                         (bh, s, hd), (bh, s, hd)), dt)
    bias = None
    if kw.get("bias_bh"):
        bias = (np.random.default_rng(seed + 1).standard_normal(
            (kw["bias_bh"], s, s)) * 0.5).astype(np.float32)
    fwd = ra.build_flash_attention(
        bh, s, hd, JNP[dt], return_lse=True,
        **{k: v for k, v in kw.items() if k != "bias_grad"})
    out, lse = fwd(-321, qj, kj, vj, None if bias is None else
                   jnp.asarray(bias))
    delta = np.sum(np.asarray(oj, np.float32) * np.asarray(out, np.float32),
                   axis=-1)
    delta = np.ascontiguousarray(np.broadcast_to(delta[..., None],
                                                 (bh, s, 128)))
    lse = np.array(lse)
    jargs = (-321, qj, kj, vj, oj, lse, delta) + (
        () if bias is None else (jnp.asarray(bias),))
    targs = (-321, *ts, torch.from_numpy(lse), torch.from_numpy(delta)) + (
        () if bias is None else (torch.from_numpy(bias),))
    return jargs, targs


OPTIONS = {
    "plain": {},
    "causal": {"causal": True},
    "scale": {"scale": 0.3},
    "dropout": {"dropout_p": 0.2},
    "bias1": {"bias_bh": 1},
    "bias_bh_grad": {"bias_bh": "bh", "bias_grad": True},
    "causal_dropout_bias_grad": {"causal": True, "dropout_p": 0.3,
                                 "bias_bh": "bh", "bias_grad": True},
}


@pytest.mark.parametrize("opt", list(OPTIONS))
@pytest.mark.parametrize("dt", [F32, BF16], ids=lambda d: d.value)
def test_bwd_plain_parity(dt, opt):
    """build_flash_attention_bwd(...).plain against the reference's two
    Pallas kernels (interpret mode) on the same operands."""
    bh, s, hd = 2, 256, 32
    kw = dict(OPTIONS[opt])
    if kw.get("bias_bh") == "bh":
        kw["bias_bh"] = bh
    jargs, targs = bwd_operands(dt, bh, s, hd, kw)
    ref = ra.build_flash_attention_bwd(bh, s, hd, JNP[dt], **kw)(*jargs)
    fn = pa.build_flash_attention_bwd(bh, s, hd, TORCH[dt], **kw)
    got = fn(*targs)
    assert len(got) == len(ref) == (4 if kw.get("bias_grad") else 3)
    for i, (r, g) in enumerate(zip(ref, got)):
        want_dt = torch.float32 if i == 3 else TORCH[dt]
        assert g.dtype == want_dt, i
        same(r, g, dt)
    # the two kernels one at a time give the same results
    dkv = fn.dkv(*targs)
    assert torch.equal(fn.dq(*targs), got[0])
    assert all(torch.equal(a, b) for a, b in zip(dkv, got[1:]))


@pytest.mark.parametrize("dt", [F32, BF16], ids=lambda d: d.value)
def test_bwd_block_override_parity(dt):
    """The reference's multi-block schedule (block_override=(128, 128):
    dK/dV accumulate over two Q blocks, dQ over two K blocks, causal skips)
    against the port at the same override, which picks a CUDA tile."""
    bh, s, hd = 2, 256, 64
    kw = {"causal": True, "dropout_p": 0.1, "bias_bh": bh, "bias_grad": True}
    jargs, targs = bwd_operands(dt, bh, s, hd, kw, seed=7)
    ref = ra.build_flash_attention_bwd(bh, s, hd, JNP[dt],
                                       block_override=(128, 128),
                                       **kw)(*jargs)
    fn = pa.build_flash_attention_bwd(bh, s, hd, TORCH[dt],
                                      block_override=(128, 128), **kw)
    assert (fn.block_q, fn.block_k) == (64, 64)
    for r, g in zip(ref, fn(*targs)):
        same(r, g, dt)
    # the causal dbias above the diagonal is exactly zero on both sides
    upper = np.triu(np.ones((s, s), bool), 1)
    assert not np.asarray(ref[3])[:, upper].any()
    assert not fn(*targs)[3][:, torch.from_numpy(upper)].any()


def test_bwd_dropout_mask_bit_exact():
    """The plain backward's replayed mask (p~ == 0 exactly where dropped)
    is the reference's position-hash mask, bit for bit."""
    bh, s, hd = 2, 128, 32
    for seed, p in ((0, 0.1), (-321, 0.3), (2 ** 31 - 1, 0.5)):
        kw = {"dropout_p": p}
        _, targs = bwd_operands(F32, bh, s, hd, kw)
        targs = (seed,) + targs[1:]
        fn = pa.build_flash_attention_bwd(bh, s, hd, torch.float32, **kw)
        p_drop, _ = fn._recompute(*targs, None)
        keep = np.asarray(ro._hash_keep(bh, s, seed,
                                        ra._dropout_threshold(p)))
        np.testing.assert_array_equal((p_drop != 0).numpy(), keep)


def test_bwd_factory_refusals_and_configs():
    with pytest.raises(ValueError, match="per-\\(batch\\*head\\)"):
        pa.build_flash_attention_bwd(2, 128, 32, torch.float32, bias_bh=1,
                                     bias_grad=True)
    with pytest.raises(ValueError, match="per-\\(batch\\*head\\)"):
        pa.build_flash_attention_bwd(2, 128, 32, torch.float32,
                                     bias_grad=True)
    with pytest.raises(ValueError, match="unsupported flash shape"):
        pa.build_flash_attention_bwd(2, 200, 32, torch.float32)
    for hd, want in ((32, [(64, 64), (64, 32)]), (128, [(64, 64), (64, 32)]),
                     (192, [(64, 32)]), (256, [(64, 32)])):
        assert pa.bwd_configs(hd) == want
        assert pa._bwd_smem_bytes(hd, want[-1][1]) <= 232448
    assert pa._bwd_smem_bytes(256, 64) > 232448
    # the dQ kernel keeps two blocks per SM where it can
    assert pa.bwd_configs(64, "dq") == [(64, 64), (64, 32)]
    assert pa.bwd_configs(128, "dq") == [(64, 32), (64, 64)]
    assert pa.bwd_configs(256, "dq") == [(64, 32)]
    fn = pa.build_flash_attention_bwd(2, 256, 128, torch.float32)
    assert (fn.block_k, fn.block_k_dq) == (64, 32)
    fn = pa.build_flash_attention_bwd(2, 256, 128, torch.float32,
                                      block_override=(128, 128))
    assert (fn.block_k, fn.block_k_dq) == (64, 64)
    fn = pa.build_flash_attention_bwd(2, 256, 256, torch.bfloat16,
                                      block_override=(256, 256))
    assert (fn.block_q, fn.block_k, fn.block_k_dq) == (64, 32, 32)
    fn = pa.build_flash_attention_bwd(2, 128, 32, torch.float32)
    q = torch.zeros(2, 128, 32)
    kT = torch.zeros(2, 32, 128)
    stat = torch.zeros(2, 128, 128)
    with pytest.raises(ValueError, match="lse"):
        fn(0, q, kT, q, q, stat[..., :1], stat)
    with pytest.raises(ValueError, match="dtype"):
        fn(0, q, kT, q, q.double(), stat, stat)
    with pytest.raises(ValueError, match="without bias_bh"):
        fn(0, q, kT, q, q, stat, stat, torch.zeros(1, 128, 128))


# ---------------------------------------------------------------------------
# gradients through dispatch_flash_attention, both routes
# ---------------------------------------------------------------------------

def grad_parity(dt, bh, s, hd, kw):
    """Gradients of sum(out * w) with respect to q, kT, v (and the bias)
    through both packages' dispatch_flash_attention; returns whether the
    port's kernel took the fused route."""
    (qj, kj, vj, wj), (qt, kt, vt, wt) = arrays(
        5, ((bh, s, hd), (bh, hd, s), (bh, s, hd), (bh, s, hd)), dt)
    call = {}
    if kw.get("dropout_p"):
        call["seed"] = 17
    bias = None
    if kw.get("bias_bh"):
        bias = (np.random.default_rng(6).standard_normal(
            (kw["bias_bh"], s, s)) * 0.5).astype(np.float32)
    jk = dispatch_flash_attention(bh, s, hd, dt, **kw)
    pk = xp.dispatch_flash_attention(bh, s, hd, xp.Datatype(dt.value), **kw)
    assert pk.info.is_reference_kernel == jk.info.is_reference_kernel

    def jloss(q, kT, v, b):
        extra = dict(call, **({} if b is None else {"bias": b}))
        out = jk(q, kT, v, **extra)
        return jnp.sum(out.astype(jnp.float32) * wj.astype(jnp.float32))

    argnums = (0, 1, 2, 3) if bias is not None else (0, 1, 2)
    ref = jax.grad(jloss, argnums=argnums)(
        qj, kj, vj, None if bias is None else jnp.asarray(bias))

    leaves = [t.requires_grad_(True) for t in (qt, kt, vt)]
    if bias is not None:
        bt = torch.from_numpy(bias).requires_grad_(True)
        leaves.append(bt)
        call["bias"] = bt
    out = pk(qt, kt, vt, **call)
    assert out.dtype == TORCH[dt] and out.requires_grad
    got = torch.autograd.grad(out, leaves, wt)
    for r, g in zip(ref, got):
        same(r, g, dt)
    return not pk.info.is_reference_kernel


FUSED = {
    "plain": {},
    "causal": {"causal": True},
    "dropout": {"dropout_p": 0.25},
    "bias1": {"bias_bh": 1},
    "bias_bh_grad": {"bias_bh": 2, "bias_requires_grad": True},
    "causal_dropout_bias_grad": {"causal": True, "dropout_p": 0.2,
                                 "bias_bh": 2, "bias_requires_grad": True},
}


@pytest.mark.parametrize("opt", list(FUSED))
@pytest.mark.parametrize("dt", [F32, BF16], ids=lambda d: d.value)
def test_dispatch_grad_parity_fused(dt, opt):
    assert grad_parity(dt, 2, 128, 32, FUSED[opt])


COMPOSED = {
    "f16": (F16, 128, {"causal": True, "dropout_p": 0.2}),
    "f64": (F64, 128, {"dropout_p": 0.2, "bias_bh": 2,
                       "bias_requires_grad": True}),
    "f32_s96": (F32, 96, {"causal": True, "dropout_p": 0.2}),
    "bf16_s96": (BF16, 96, {"bias_bh": 1}),
    "f32_bias1_grad": (F32, 128, {"bias_bh": 1, "bias_requires_grad": True}),
    "f32_bias1_grad_dropout": (F32, 128, {"bias_bh": 1, "dropout_p": 0.1,
                                          "bias_requires_grad": True}),
}


@pytest.mark.parametrize("case", list(COMPOSED))
def test_dispatch_grad_parity_composition(case):
    dt, s, kw = COMPOSED[case]
    assert not grad_parity(dt, 2, s, 16, kw)


@pytest.mark.parametrize("bias_bh", [1, 2])
def test_bias_cotangent_zero_without_bias_requires_grad(bias_bh):
    """A bias dispatched without bias_requires_grad is a constant: its
    cotangent is exactly zero on both sides (FUSED["bias1"] holds q, kT and
    v to the reference)."""
    (qj, kj, vj, wj), (qt, kt, vt, wt) = arrays(
        5, ((2, 128, 32), (2, 32, 128), (2, 128, 32), (2, 128, 32)), F32)
    bias = (np.random.default_rng(6).standard_normal(
        (bias_bh, 128, 128)) * 0.5).astype(np.float32)
    bt = torch.from_numpy(bias).requires_grad_(True)
    out = xp.dispatch_flash_attention(2, 128, 32, bias_bh=bias_bh)(
        qt, kt, vt, bias=bt)
    (db,) = torch.autograd.grad(out, [bt], wt)
    assert db.shape == bt.shape and not db.any()
    jk = dispatch_flash_attention(2, 128, 32, F32, bias_bh=bias_bh)
    jdb = jax.grad(lambda b: jnp.sum(jk(qj, kj, vj, bias=b) * wj))(
        jnp.asarray(bias))
    assert not np.asarray(jdb).any()


def test_serving_runs_no_lse_forward_and_no_backward(monkeypatch):
    """Served calls (inference mode, or no operand requiring grad) run the
    forward without the LSE; a call under autograd runs the LSE forward,
    and its backward runs the backward."""
    calls = []
    orig_fwd, orig_bwd = pa.FlashAttention.plain, pa.FlashAttentionBwd.plain
    orig_dkv, orig_dq = (pa.FlashAttentionBwd.dkv_plain,
                         pa.FlashAttentionBwd.dq_plain)

    def spy(name, orig):
        def fn(self, *args):
            calls.append((name, getattr(self, "return_lse", None)))
            return orig(self, *args)
        return fn

    monkeypatch.setattr(pa.FlashAttention, "plain", spy("fwd", orig_fwd))
    monkeypatch.setattr(pa.FlashAttentionBwd, "plain", spy("bwd", orig_bwd))
    monkeypatch.setattr(pa.FlashAttentionBwd, "dkv_plain",
                        spy("dkv", orig_dkv))
    monkeypatch.setattr(pa.FlashAttentionBwd, "dq_plain", spy("dq", orig_dq))
    _, (q, kT, v) = arrays(1, ((2, 128, 32), (2, 32, 128), (2, 128, 32)),
                           F32)
    kern = xp.dispatch_flash_attention(2, 128, 32)
    with torch.inference_mode():
        a = kern(q, kT, v)
    b = kern(q, kT, v)
    assert calls == [("fwd", False), ("fwd", False)]
    assert not a.requires_grad and not b.requires_grad
    calls.clear()
    q.requires_grad_(True)
    c = kern(q, kT, v)
    assert calls == [("fwd", True)]
    assert torch.equal(c.detach(), b)
    c.sum().backward()
    assert calls == [("fwd", True), ("dkv", None), ("dq", None)]
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())
    with torch.no_grad():
        calls.clear()
        kern(q, kT, v)
        assert calls == [("fwd", False)]
