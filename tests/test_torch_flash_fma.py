"""The f32 flash-attention route "tma_fma" (TMA-fed FMA tiles): which
kernels f32 takes, the wrappers' f32 state and launch counts, and the port
against the JAX package at small f32 shapes for every form the route
serves and every hd bucket (64, 128, 256) it takes. Runs on the CPU: the
kernels' plain versions against the Pallas kernels in interpret mode (the
CUDA kernels themselves are held against their plain versions by
tests/test_torch_cuda_attention.py and tests/test_torch_cuda_train.py on
the card; their tile plans are held to their thread counts, stages and 227
KB of shared memory by static assertions in csrc/xsmm_flash_fma.cuh).

Tolerances (matdiff normf_rel), as the existing flash tests state them:
1e-5 for the f32 forward and the LSE, 1e-4 for f32 gradients (dS = p (dP -
delta) cancels, so the order of the sums shows). The dropout mask is the
reference's position hash on both sides.
"""

import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libxsmm_torch.kernels import attention as pa
from libxsmm_torch.matdiff import check
from libxsmm_tpu.kernels import attention_pallas as ra

torch.set_num_threads(1)

F32, BF16 = torch.float32, torch.bfloat16
CSRC = pathlib.Path(pa.__file__).resolve().parent / "csrc"
TOL_FWD, TOL_BWD = 1e-5, 1e-4


# ---------------------------------------------------------------------------
# the route f32 takes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [8, 64, 120, 128, 136, 256])
def test_f32_takes_tma_fma_at_every_hd(hd):
    """The dtype picks the kernel: f32 runs tma_fma (one tile per hd
    bucket, so no tile to keep: block_q and block_k are None, and a
    block_override only has to tile s), bf16 the tensor cores (the
    forward and the backward wgmma at every hd)."""
    assert pa.flash_path(F32) == pa.flash_bwd_path(F32, hd) == "tma_fma"
    assert pa.flash_path(BF16, hd) == "wgmma"
    assert pa.flash_bwd_path(BF16, hd) == "wgmma"
    for override in (None, (128, 128), (256, 128)):
        fn = pa.build_flash_attention(2, 256, hd, F32, causal=True,
                                      block_override=override)
        bwd = pa.build_flash_attention_bwd(2, 256, hd, F32,
                                           block_override=override)
        assert fn.path == bwd.path == "tma_fma"
        assert (fn.block_q, fn.block_k) == (None, None)
        assert (bwd.block_k, bwd.block_k_dq) == (None, None)
        assert fn.name.endswith("_float32_tma_fma")
    for bad in ((96, 128), (0, 128)):
        with pytest.raises(ValueError, match="does not tile"):
            pa.build_flash_attention(2, 256, hd, F32, block_override=bad)
        with pytest.raises(ValueError, match="does not tile"):
            pa.build_flash_attention_bwd(2, 256, hd, F32, block_override=bad)
    with pytest.raises(ValueError, match="one tile per hd bucket"):
        pa.bwd_configs(hd, "dkv", F32)


def test_cpu_calls_run_the_plain_version_and_count_nothing():
    fn = pa.build_flash_attention(2, 128, 32, F32, causal=True)
    q, v = torch.randn(2, 128, 32), torch.randn(2, 128, 32)
    kT = torch.randn(2, 32, 128)
    pa.reset_launches()
    assert torch.equal(fn(0, q, kT, v), fn.plain(0, q, kT, v))
    assert fn.path == "tma_fma"
    assert all(n == 0 for n in pa.launches.values())
    assert all(c == 0 for counts in pa.path_launches.values()
               for c in counts.values())
    assert set(pa.path_launches["flash_attention_bwd_dq"]) == \
        {"tma_fma", "wgmma"} == set(pa.ROUTES)
    assert all(c == 0 for c in pa.kernel_launches.values())


def test_entries_name_the_kernels_of_both_routes():
    """Each counter names the kernels of its routes (bf16 and f32; the
    bf16 wgmma ones, the backward's wide ones past hd 128 among them),
    each defined in its source, and nothing else."""
    for counter, kernels in (
            ("flash_attention_fwd",
             ("flash_fwd_tma_fma_kernel", "flash_fwd_wgmma_kernel")),
            ("flash_attention_bwd_dkv",
             ("flash_bwd_dkv_tma_fma_kernel", "flash_bwd_dkv_wgmma_kernel",
              "flash_bwd_dkv_wgmma_wide_kernel")),
            ("flash_attention_bwd_dq",
             ("flash_bwd_dq_tma_fma_kernel", "flash_bwd_dq_wgmma_kernel",
              "flash_bwd_dq_wgmma_wide_kernel"))):
        stem, names = pa.ENTRIES[counter]
        assert names == kernels
        text = (CSRC / f"{stem}.cu").read_text()
        for kernel in kernels:
            assert f"{kernel}(" in text


# ---------------------------------------------------------------------------
# the port against the JAX package, every form the route serves
# ---------------------------------------------------------------------------

def _arrays(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(ref, got, tol):
    ref = np.asarray(ref, np.float32)
    assert tuple(got.shape) == ref.shape
    assert bool(torch.isfinite(got.float()).all())
    check(ref.astype(np.float64), got.detach().double().numpy(), margin=tol)


FWD_FORMS = {
    "plain": {},
    "causal": {"causal": True},
    "dropout": {"dropout_p": 0.2},
    "bias_per_head": {"bias_bh": "bh"},
    "bias_broadcast": {"bias_bh": 1},
    "lse": {"return_lse": True},
    "causal_dropout_bias_lse": {"causal": True, "dropout_p": 0.3,
                                "bias_bh": 1, "return_lse": True},
}


@pytest.mark.parametrize("hd", [40, 64, 120, 256])
@pytest.mark.parametrize("form", list(FWD_FORMS))
def test_forward_parity(form, hd):
    """The f32 forward (tma_fma on the card) against the reference's Pallas
    kernel on the same inputs, at hd in each bucket (64, 128, 256)."""
    bh, s = 2, 128
    kw = dict(FWD_FORMS[form])
    if kw.get("bias_bh") == "bh":
        kw["bias_bh"] = bh
    q, kT, v = _arrays(1, ((bh, s, hd), (bh, hd, s), (bh, s, hd)))
    bias = None
    if kw.get("bias_bh"):
        bias = _arrays(2, ((kw["bias_bh"], s, s),))[0] * 0.5
    fn = pa.build_flash_attention(bh, s, hd, F32, **kw)
    assert fn.path == "tma_fma"
    ref = ra.build_flash_attention(bh, s, hd, jnp.float32, **kw)(
        -321, jnp.asarray(q), jnp.asarray(kT), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias))
    got = fn(-321, *(torch.from_numpy(x) for x in (q, kT, v)),
             None if bias is None else torch.from_numpy(bias))
    if kw.get("return_lse"):
        (ref, ref_lse), (got, got_lse) = ref, got
        assert got_lse.shape == (bh, s, 128)
        _close(ref_lse, got_lse, TOL_FWD)
    _close(ref, got, TOL_FWD)


def test_forward_parity_block_override():
    """The reference's two-K-block schedule (block_override=(128, 128))
    against the port's f32 kernel, whose tile the override leaves as is."""
    bh, s, hd = 2, 256, 128
    q, kT, v = _arrays(3, ((bh, s, hd), (bh, hd, s), (bh, s, hd)))
    kw = {"causal": True, "return_lse": True, "block_override": (128, 128)}
    fn = pa.build_flash_attention(bh, s, hd, F32, **kw)
    assert fn.path == "tma_fma"
    ref, ref_lse = ra.build_flash_attention(bh, s, hd, jnp.float32, **kw)(
        0, jnp.asarray(q), jnp.asarray(kT), jnp.asarray(v))
    got, got_lse = fn(0, *(torch.from_numpy(x) for x in (q, kT, v)))
    _close(ref, got, TOL_FWD)
    _close(ref_lse, got_lse, TOL_FWD)


def _head_block(bh_global, nhg, b0, h0, nhl, nb):
    """The global batch-heads a block of nb batches from b0 and nhl heads
    from h0 holds, in its local order."""
    return [(b0 + i // nhl) * nhg + h0 + i % nhl for i in range(nb * nhl)]


def test_forward_dropout_head_map_parity():
    """A block of heads with a head map draws the whole attention's mask:
    its output is the reference's whole-attention output at those heads."""
    nb, nhg, s, hd = 2, 4, 128, 32
    q, kT, v = _arrays(5, ((nb * nhg, s, hd), (nb * nhg, hd, s),
                           (nb * nhg, s, hd)))
    ref = np.asarray(ra.build_flash_attention(
        nb * nhg, s, hd, jnp.float32, dropout_p=0.25)(
            77, jnp.asarray(q), jnp.asarray(kT), jnp.asarray(v)))
    for b0, h0, nhl, bl in ((0, 2, 2, 2), (1, 1, 3, 1), (0, 0, 4, 2)):
        idx = _head_block(nb * nhg, nhg, b0, h0, nhl, bl)
        fn = pa.build_flash_attention(len(idx), s, hd, F32, dropout_p=0.25,
                                      head_map=(b0, h0, nhl, nhg))
        assert fn.path == "tma_fma"
        got = fn(77, *(torch.from_numpy(np.ascontiguousarray(x[idx]))
                       for x in (q, kT, v)))
        _close(ref[idx], got, TOL_FWD)


def _bwd_operands(bh, s, hd, kw, seed=3):
    q, kT, v, dout = _arrays(seed, ((bh, s, hd), (bh, hd, s), (bh, s, hd),
                                    (bh, s, hd)))
    bias = None
    if kw.get("bias_bh"):
        bias = _arrays(seed + 1, ((kw["bias_bh"], s, s),))[0] * 0.5
    fwd = ra.build_flash_attention(
        bh, s, hd, jnp.float32, return_lse=True,
        **{k: x for k, x in kw.items()
           if k not in ("bias_grad", "block_override")})
    out, lse = fwd(-321, jnp.asarray(q), jnp.asarray(kT), jnp.asarray(v),
                   None if bias is None else jnp.asarray(bias))
    delta = np.sum(dout * np.asarray(out, np.float32), axis=-1)
    delta = np.ascontiguousarray(np.broadcast_to(delta[..., None],
                                                 (bh, s, 128)))
    lse = np.array(lse)
    ops = (q, kT, v, dout, lse, delta) + (() if bias is None else (bias,))
    return ops


BWD_FORMS = {
    "plain": {},
    "causal": {"causal": True},
    "dropout": {"dropout_p": 0.2},
    "bias_per_head_dbias": {"bias_bh": "bh", "bias_grad": True},
    "bias_broadcast": {"bias_bh": 1},
    "causal_dropout_bias_dbias": {"causal": True, "dropout_p": 0.3,
                                  "bias_bh": "bh", "bias_grad": True},
    "block_override": {"causal": True, "block_override": (128, 128)},
}


@pytest.mark.parametrize("hd", [40, 120, 256])
@pytest.mark.parametrize("form", list(BWD_FORMS))
def test_backward_parity(form, hd):
    """The f32 backward (both tma_fma kernels on the card) against the
    reference's two Pallas kernels on the same operands, at hd in each
    bucket (64, 128, 256)."""
    bh, s = 2, 256 if form == "block_override" else 128
    kw = dict(BWD_FORMS[form])
    if kw.get("bias_bh") == "bh":
        kw["bias_bh"] = bh
    ops = _bwd_operands(bh, s, hd, kw)
    ref = ra.build_flash_attention_bwd(bh, s, hd, jnp.float32, **kw)(
        -321, *(jnp.asarray(x) for x in ops))
    fn = pa.build_flash_attention_bwd(bh, s, hd, F32, **kw)
    assert fn.path == "tma_fma"
    got = fn(-321, *(torch.from_numpy(x) for x in ops))
    assert len(got) == len(ref) == (4 if kw.get("bias_grad") else 3)
    for r, g in zip(ref, got):
        assert g.dtype == F32
        _close(r, g, TOL_BWD)


def test_backward_dropout_head_map_parity():
    """The backward of a block of heads with a head map replays the whole
    attention's mask: its gradients are the reference's at those heads."""
    nb, nhg, s, hd = 2, 4, 128, 32
    kw = {"dropout_p": 0.25, "causal": True}
    ops = _bwd_operands(nb * nhg, s, hd, kw, seed=9)
    ref = [np.asarray(r) for r in ra.build_flash_attention_bwd(
        nb * nhg, s, hd, jnp.float32, **kw)(
            -321, *(jnp.asarray(x) for x in ops))]
    for b0, h0, nhl, bl in ((0, 1, 2, 2), (1, 0, 4, 1)):
        idx = _head_block(nb * nhg, nhg, b0, h0, nhl, bl)
        fn = pa.build_flash_attention_bwd(len(idx), s, hd, F32,
                                          head_map=(b0, h0, nhl, nhg), **kw)
        assert fn.path == "tma_fma"
        got = fn(-321, *(torch.from_numpy(np.ascontiguousarray(x[idx]))
                         for x in ops))
        for r, g in zip(ref, got):
            _close(r[idx], g, TOL_BWD)
