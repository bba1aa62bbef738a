"""Flash attention: the port (`libxsmm_torch.kernels.attention`,
`libxsmm_torch.ops.attention`) against the JAX package on the same numpy
inputs, on the CPU. The JAX side runs as its own tests run it (the Pallas
kernel in interpret mode); the port runs the plain torch version of its
CUDA kernel.

Tolerances (matdiff normf_rel): 1e-5 for f32 outputs and the LSE (sums in
another order; the reference's online softmax against the plain version's
single pass); 1e-2 for bf16 outputs (probabilities rounded to bf16 at other
points, then the output rounded to bf16). The dropout mask is compared bit
for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import libxsmm_torch as xp
from libxsmm_torch.kernels import attention as pa
from libxsmm_torch.matdiff import check
from libxsmm_torch.ops import attention as po
from libxsmm_tpu.dtypes import Datatype
from libxsmm_tpu.kernels import attention_pallas as ra
from libxsmm_tpu.ops import attention as ro
from libxsmm_tpu.ops.attention import dispatch_flash_attention

torch.set_num_threads(1)

F32, BF16 = Datatype.F32, Datatype.BF16
JNP = {F32: jnp.float32, BF16: jnp.bfloat16}
TORCH = {F32: torch.float32, BF16: torch.bfloat16}
TOL = {F32: 1e-5, BF16: 1e-2}


def operands(seed, bh, s, hd, dt):
    """q, kT, v as (JAX arrays, CPU tensors) with identical values."""
    rng = np.random.default_rng(seed)
    out_j, out_t = [], []
    for shape in ((bh, s, hd), (bh, hd, s), (bh, s, hd)):
        xj = jnp.asarray(rng.standard_normal(shape), JNP[dt])
        out_j.append(xj)
        out_t.append(torch.from_numpy(
            np.asarray(xj, np.float32)).to(TORCH[dt]))
    return out_j, out_t


def same(ref, got, dt):
    ref = np.asarray(ref, np.float32)
    assert tuple(got.shape) == ref.shape
    assert got.dtype == TORCH[dt]
    assert bool(torch.isfinite(got.float()).all())
    check(ref.astype(np.float64), got.float().numpy().astype(np.float64),
          margin=TOL[dt])


OPTIONS = {
    "plain": {},
    "causal": {"causal": True},
    "scale": {"scale": 0.3},
    "bias1": {"bias_bh": 1},
    "bias_bh": {"bias_bh": "bh"},
    "dropout": {"dropout_p": 0.2},
    "causal_dropout_bias": {"causal": True, "dropout_p": 0.3, "bias_bh": 1},
}


@pytest.mark.parametrize("opt", list(OPTIONS))
@pytest.mark.parametrize("dt", [F32, BF16], ids=lambda d: d.value)
def test_flash_dispatch_parity(dt, opt):
    bh, s, hd = 2, 128, 32
    kw = dict(OPTIONS[opt])
    if kw.get("bias_bh") == "bh":
        kw["bias_bh"] = bh
    (qj, kj, vj), (qt, kt, vt) = operands(3, bh, s, hd, dt)
    call = {}
    if kw.get("bias_bh"):
        bias = np.random.default_rng(4).standard_normal(
            (kw["bias_bh"], s, s)).astype(np.float32)
        call["bias"] = bias
    if kw.get("dropout_p"):
        call["seed"] = -321
    jk = dispatch_flash_attention(bh, s, hd, dt, **kw)
    pk = xp.dispatch_flash_attention(bh, s, hd, xp.Datatype(dt.value), **kw)
    assert not jk.info.is_reference_kernel and not pk.info.is_reference_kernel
    assert pk.info.nflops == jk.info.nflops
    assert pk.name == jk.name
    ref = jk(qj, kj, vj, **{k: (jnp.asarray(v) if k == "bias" else v)
                            for k, v in call.items()})
    got = pk(qt, kt, vt, **{k: (torch.from_numpy(v) if k == "bias" else v)
                            for k, v in call.items()})
    same(ref, got, dt)


@pytest.mark.parametrize("dt", [F32, BF16], ids=lambda d: d.value)
def test_flash_lse_multiblock_parity(dt):
    """The reference's online recurrence over two K blocks
    (block_override=(128, 128)) against the port at the same override, with
    the LSE output in the (bh, s, 128) layout."""
    bh, s, hd = 2, 256, 64
    (qj, kj, vj), (qt, kt, vt) = operands(5, bh, s, hd, dt)
    jfn = ra.build_flash_attention(bh, s, hd, JNP[dt], causal=True,
                                   return_lse=True,
                                   block_override=(128, 128))
    pfn = pa.build_flash_attention(bh, s, hd, TORCH[dt], causal=True,
                                   return_lse=True,
                                   block_override=(128, 128))
    assert (pfn.block_q, pfn.block_k) == (64, 64)
    out_j, lse_j = jfn(0, qj, kj, vj)
    out_p, lse_p = pfn(0, qt, kt, vt)
    same(out_j, out_p, dt)
    assert lse_p.shape == (bh, s, 128) and lse_p.dtype == torch.float32
    check(np.asarray(lse_j, np.float64), lse_p.numpy().astype(np.float64),
          margin=1e-5)


def test_flash_dropout_mask_bit_exact():
    bh, s = 3, 256
    for seed in (0, 7, -1, -2 ** 31, 2 ** 31 - 1):
        for p in (0.1, 0.5):
            thr = ra._dropout_threshold(p)
            assert pa._dropout_threshold(p) == int(thr)
            ref = np.asarray(ro._hash_keep(bh, s, seed, thr))
            got = po._hash_keep(bh, s, seed, int(thr), "cpu").numpy()
            np.testing.assert_array_equal(got, ref)


def test_rand_bits_bit_exact_grid():
    rng = np.random.default_rng(9)
    rows = np.concatenate([np.arange(4), rng.integers(0, 2 ** 31 - 1, 60)])
    cols = np.concatenate([np.arange(4), rng.integers(0, 2 ** 31 - 1, 60)])
    bs = np.asarray([0, 1, 95, 2 ** 20])
    for seed in (0, 1, -1, -12345, 2 ** 31 - 1, -2 ** 31, 104729):
        ref = np.asarray(ra._rand_bits(
            jnp.int32(seed), jnp.asarray(bs, jnp.int32)[:, None, None],
            jnp.asarray(rows, jnp.int32)[None, :, None],
            jnp.asarray(cols, jnp.int32)[None, None, :]))
        got = pa._rand_bits(seed, torch.from_numpy(bs)[:, None, None],
                            torch.from_numpy(rows)[None, :, None],
                            torch.from_numpy(cols)[None, None, :])
        np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("p", [0.0, 1e-9, 0.25, 0.5, 0.999999999])
def test_dropout_threshold_parity(p):
    assert pa._dropout_threshold(p) == int(ra._dropout_threshold(p))


def test_supported_parity():
    for s in (64, 128, 200, 256, 384):
        for hd in (8, 12, 32, 64, 100, 128, 256, 264):
            for jd, td in ((jnp.float32, torch.float32),
                           (jnp.bfloat16, torch.bfloat16),
                           (jnp.float16, torch.float16)):
                assert pa.supported(s, hd, td) == ra.supported(s, hd, jd), \
                    (s, hd, td)


@pytest.mark.parametrize("dt", [F32, BF16, Datatype.F16],
                         ids=lambda d: d.value)
@pytest.mark.parametrize("causal", [False, True])
def test_reference_route_parity(dt, causal):
    """Shapes outside the envelope (s % 128 != 0) and f16 take the torch
    composition, as the reference takes XLA's; both evaluate the same
    dropout mask."""
    bh, s, hd = 2, 96, 16
    rng = np.random.default_rng(6)
    jdt = {F32: jnp.float32, BF16: jnp.bfloat16,
           Datatype.F16: jnp.float16}[dt]
    tdt = {F32: torch.float32, BF16: torch.bfloat16,
           Datatype.F16: torch.float16}[dt]
    ops = [jnp.asarray(rng.standard_normal(sh), jdt)
           for sh in ((bh, s, hd), (bh, hd, s), (bh, s, hd))]
    tops = [torch.from_numpy(np.asarray(o, np.float32)).to(tdt) for o in ops]
    jk = dispatch_flash_attention(bh, s, hd, dt, causal=causal,
                                  dropout_p=0.2)
    pk = xp.dispatch_flash_attention(bh, s, hd, xp.Datatype(dt.value),
                                     causal=causal, dropout_p=0.2)
    assert jk.info.is_reference_kernel and pk.info.is_reference_kernel
    ref = np.asarray(jk(*ops, seed=11), np.float32)
    got = pk(*tops, seed=11)
    assert got.dtype == tdt
    tol = {F32: 1e-5, BF16: 1e-2, Datatype.F16: 2e-3}[dt]
    check(ref.astype(np.float64), got.float().numpy().astype(np.float64),
          margin=tol)


def test_f16_in_envelope_takes_reference_route():
    pk = xp.dispatch_flash_attention(2, 128, 32, xp.Datatype.F16)
    assert pk.info.is_reference_kernel
    pk = xp.dispatch_flash_attention(2, 128, 32, xp.Datatype.F32,
                                     bias_bh=1, bias_requires_grad=True)
    assert pk.info.is_reference_kernel        # as the reference routes it


def test_nflops_names_and_cache():
    for causal in (False, True):
        jk = dispatch_flash_attention(4, 256, 64, F32, causal=causal)
        pk = xp.dispatch_flash_attention(4, 256, 64, xp.Datatype.F32,
                                         causal=causal)
        assert pk.info.nflops == jk.info.nflops
        assert pk.info.kind == "flash_attention"
        assert pk.name == jk.name
    assert (xp.dispatch_flash_attention(4, 256, 64, causal=True).info.nflops
            == 2 * 4 * 256 * 257 * 64)
    assert xp.dispatch_flash_attention(4, 256, 64) is \
        xp.dispatch_flash_attention(4, 256, 64)


def test_flash_bad_args():
    for bad in (lambda: xp.dispatch_flash_attention(0, 128, 64),
                lambda: xp.dispatch_flash_attention(1, 128, 64,
                                                    xp.Datatype.I8),
                lambda: xp.dispatch_flash_attention(2, 128, 64,
                                                    dropout_p=1.0),
                lambda: xp.dispatch_flash_attention(2, 128, 64, bias_bh=3)):
        with pytest.raises(ValueError):
            bad()
    q = torch.zeros(2, 128, 64)
    kT = torch.zeros(2, 64, 128)
    with pytest.raises(ValueError, match="bias_bh"):
        xp.dispatch_flash_attention(2, 128, 64)(q, kT, q,
                                                bias=torch.zeros(1, 128, 128))
    with pytest.raises(ValueError, match="pass bias="):
        xp.dispatch_flash_attention(2, 128, 64, bias_bh=1)(q, kT, q)
    with pytest.raises(ValueError, match="seed="):
        xp.dispatch_flash_attention(2, 128, 64, dropout_p=0.1)(q, kT, q)
    with pytest.raises(ValueError, match="unsupported flash shape"):
        pa.build_flash_attention(2, 200, 64, torch.float32)
    with pytest.raises(ValueError, match="dropout_p"):
        pa.build_flash_attention(2, 128, 64, torch.float32, dropout_p=-0.1)
    fn = pa.build_flash_attention(2, 128, 64, torch.float32)
    with pytest.raises(ValueError, match="shape"):
        fn(0, q[:, :64], kT, q)
    with pytest.raises(ValueError, match="dtype"):
        fn(0, q.double(), kT, q)


def test_block_override_picks_a_cuda_tile():
    for hd, want in ((64, (64, 64)), (256, (64, 32))):
        assert pa.build_flash_attention(2, 256, hd, torch.float32).block_k \
            == want[1]
    for override, want in (((128, 128), (64, 64)), ((64, 32), (64, 32)),
                           ((256, 64), (64, 64))):
        fn = pa.build_flash_attention(2, 256, 64, torch.float32,
                                      block_override=override)
        assert (fn.block_q, fn.block_k) == want
    with pytest.raises(ValueError, match="smaller than every"):
        pa.build_flash_attention(2, 256, 64, torch.float32,
                                 block_override=(32, 32))
    with pytest.raises(ValueError, match="does not tile"):
        pa.build_flash_attention(2, 256, 64, torch.float32,
                                 block_override=(128, 96))


def test_backward_not_ported_yet():
    """The flash backward is ported now: the autograd node's backward runs
    the backward kernels' plain versions on CPU tensors and gives the
    gradient of the float64 torch composition (1e-4: f32 against f64)."""
    pk = xp.dispatch_flash_attention(2, 128, 32)
    _, (q, kT, v) = operands(1, 2, 128, 32, F32)
    q.requires_grad_(True)
    out = pk(q, kT, v)
    assert out.requires_grad
    out.sum().backward()
    q64 = q.detach().double().requires_grad_(True)
    po._naive(q64, kT.double(), v.double(), 32 ** -0.5, False).sum() \
        .backward()
    check(q64.grad, q.grad.double(), margin=1e-4)


def test_cpu_never_counts_a_launch():
    before = dict(pa.launches)
    pk = xp.dispatch_flash_attention(2, 128, 32)
    pk(*operands(2, 2, 128, 32, F32)[1])
    assert pa.launches == before
