"""The flash backward's tensor-core forms, on the CPU: which CUDA kernels
a backward call takes (`flash_bwd_path`, the predicate that mirrors the
choice csrc makes: the wgmma kernels up to hd 128, mma.sync past it), the
bf16 tile configurations at every head-dim bucket and the mma.sync
kernels' shared memory, the f32 configurations unchanged, and the bf16
wrapper at shapes that reach the tensor-core kernels on the card (hd 64
and a padded 80 on wgmma, a padded 200 on mma.sync) held against the JAX
package on the same numpy inputs. The port's wrapper runs its plain
version on CPU tensors; the JAX side runs as its own tests run it (the
Pallas kernels in interpret mode).

Tolerance (matdiff normf_rel): 1e-2 for the bf16 gradients (p~ and dS are
rounded to bf16 against scores that differ in the last f32 bits, then each
output is rounded to bf16) and for dbias from bf16 inputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libxsmm_torch.kernels import attention as pa
from libxsmm_torch.matdiff import check
from libxsmm_tpu.kernels import attention_pallas as ra

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32
SMEM_MAX = 232448            # a block's shared memory on sm_90
TOL = 1e-2


def test_flash_bwd_path():
    """bf16 takes the wgmma kernels up to hd 128 and the mma.sync ones past
    it, whatever the tile override; f32 the TMA-fed FMA ones (no TF32)."""
    assert pa.flash_bwd_path(BF16, 40) == "wgmma"
    assert pa.flash_bwd_path(BF16, 128) == "wgmma"
    assert pa.flash_bwd_path(BF16, 136) == "mma"
    assert pa.flash_bwd_path(F32) == "tma_fma"
    with pytest.raises(ValueError, match="depends on hd"):
        pa.flash_bwd_path(BF16)
    assert pa.build_flash_attention_bwd(2, 128, 40, BF16).path == "wgmma"
    assert pa.build_flash_attention_bwd(
        2, 128, 40, BF16, block_override=(64, 64)).path == "wgmma"
    assert pa.build_flash_attention_bwd(2, 128, 136, BF16).path == "mma"
    assert pa.build_flash_attention_bwd(2, 128, 40, F32).path == "tma_fma"


@pytest.mark.parametrize("kernel", ["dkv", "dq"])
@pytest.mark.parametrize("hd,hdp", [
    (8, 32), (32, 32), (40, 64), (64, 64), (80, 96), (96, 96), (104, 128),
    (128, 128), (136, 192), (192, 192), (200, 256), (256, 256)])
def test_bf16_bwd_configs(hd, hdp, kernel):
    """Up to a padded 128 the wgmma tile (128 K columns), past it the
    mma.sync kernels' 32-column K tile, whose shared memory fits a block;
    the mma.sync buckets are 192 and 256 only."""
    if hdp <= 128:
        with pytest.raises(ValueError, match="wgmma"):
            pa._mma_hdp(hd)
    else:
        assert pa._mma_hdp(hd) == hdp
    configs = pa.bwd_configs(hd, kernel, BF16)
    wg = (64, 128) if kernel == "dkv" else (128, 128)
    assert configs == ([wg] if hdp <= 128 else [(64, 32)])
    if hdp > 128:
        assert pa._bwd_smem_bytes(hd, 32, kernel, BF16) <= SMEM_MAX
    fn = pa.build_flash_attention_bwd(2, 256, hd, BF16)
    if hdp <= 128:
        assert (fn.path, fn.block_q, fn.block_k, fn.block_q_dq,
                fn.block_k_dq) == ("wgmma", 64, 128, 128, 128)
    else:
        assert (fn.path, fn.block_q, fn.block_k, fn.block_k_dq) == (
            "mma", 64, 32, 32)


def test_bf16_bwd_smem_bytes():
    """dK/dV: K^T (hdp x bk), V (bk x hdp), two Q and two dO (64 x hdp),
    bf16 with rows padded by 8 elements, and two lse and delta rows of 64
    f32; dQ: Q and dO, two K^T and two V tiles (csrc dkv_mma_smem,
    dq_mma_smem); past hd 128 only, where the mma.sync kernels serve."""
    for hd, bk, dkv, dq in ((256, 64, 206848, 208896),
                            (256, 32, 173568, 142336),
                            (192, 32, 131584, 107520),
                            (136, 32, 131584, 107520)):
        assert pa._bwd_smem_bytes(hd, bk, "dkv", BF16) == dkv, (hd, bk)
        assert pa._bwd_smem_bytes(hd, bk, "dq", BF16) == dq, (hd, bk)
    for hd in (40, 64, 128):
        with pytest.raises(ValueError, match="wgmma"):
            pa._bwd_smem_bytes(hd, 32, "dkv", BF16)


def test_f32_bwd_configs_keep_their_values():
    """The configurations are the bf16 kernels' (the default dtype); the
    f32 kernels take one tile per hd bucket, so f32 has none to pick."""
    for hd, want in ((32, [(64, 128)]), (128, [(64, 128)]),
                     (192, [(64, 32)]), (256, [(64, 32)])):
        assert pa.bwd_configs(hd) == pa.bwd_configs(hd, "dkv", BF16) == want
    assert pa._bwd_smem_bytes(256, 32) == \
        pa._bwd_smem_bytes(256, 32, "dkv", BF16) == 173568
    for call in (lambda: pa.bwd_configs(128, "dq", F32),
                 lambda: pa._bwd_smem_bytes(256, 32, "dkv", F32)):
        with pytest.raises(ValueError, match="one tile per hd bucket"):
            call()
    fn = pa.build_flash_attention_bwd(2, 256, 128, F32)
    assert fn.path == "tma_fma" and (fn.block_k, fn.block_k_dq) == (None,
                                                                     None)


@pytest.mark.parametrize("hd", [40, 64, 128, 256])
def test_bf16_bwd_block_override_picks(hd):
    """Up to hd 128 an override only has to tile s: the wgmma kernels keep
    their one tile each. Past it the TPU tile stays an upper bound on the
    mma.sync kernels' 32-column tile, and one under it is refused."""
    wide = hd <= 128
    for override in ((128, 128), (64, 32), (256, 64), (64, 16)):
        if not wide and override == (64, 16):
            with pytest.raises(ValueError, match="smaller than every"):
                pa.build_flash_attention_bwd(2, 256, hd, BF16,
                                             block_override=override)
            continue
        fn = pa.build_flash_attention_bwd(2, 256, hd, BF16,
                                          block_override=override)
        assert (fn.block_q, fn.block_k, fn.block_q_dq, fn.block_k_dq) == (
            (64, 128, 128, 128) if wide else (64, 32, 64, 32))
        assert fn.path == ("wgmma" if wide else "mma")


def bwd_operands(bh, s, hd, kw, seed):
    """q, kT, v, dout as bf16 (JAX arrays, CPU tensors) of equal values, the
    bias, and lse/delta from the JAX forward with return_lse."""
    rng = np.random.default_rng(seed)
    js, ts = [], []
    for shape in ((bh, s, hd), (bh, hd, s), (bh, s, hd), (bh, s, hd)):
        xj = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
        js.append(xj)
        ts.append(torch.from_numpy(np.asarray(xj, np.float32)).to(BF16))
    bias = None
    if kw.get("bias_bh"):
        bias = (rng.standard_normal((kw["bias_bh"], s, s)) * 0.5
                ).astype(np.float32)
    fwd = ra.build_flash_attention(
        bh, s, hd, jnp.bfloat16, return_lse=True,
        **{k: v for k, v in kw.items() if k != "bias_grad"})
    out, lse = fwd(-77, js[0], js[1], js[2],
                   None if bias is None else jnp.asarray(bias))
    delta = np.sum(np.asarray(js[3], np.float32) * np.asarray(out, np.float32),
                   axis=-1)
    delta = np.ascontiguousarray(np.broadcast_to(delta[..., None],
                                                 (bh, s, 128)))
    lse = np.array(lse)
    tail_j = () if bias is None else (jnp.asarray(bias),)
    tail_t = () if bias is None else (torch.from_numpy(bias),)
    return ((-77, *js, lse, delta) + tail_j,
            (-77, *ts, torch.from_numpy(lse), torch.from_numpy(delta))
            + tail_t)


FLAGS = {
    "plain": {},
    "causal": {"causal": True},
    "dropout": {"dropout_p": 0.1},
    "bias_bh_grad": {"bias_bh": "bh", "bias_grad": True},
    "bias1": {"bias_bh": 1},
}


@pytest.mark.parametrize("flag", list(FLAGS))
@pytest.mark.parametrize("hd,s", [(64, 256), (80, 128), (200, 128)])
def test_bf16_bwd_mma_shapes_parity(hd, s, flag):
    """bf16 backward at hd 64 and 80 (the wgmma route; 80 padded to 128)
    and 200 (the mma.sync route, padded to 256), each flag, against the JAX
    package's two backward kernels on the same operands: dQ, dK^T and dV
    (and dbias) each within the margin."""
    bh = 2
    kw = dict(FLAGS[flag])
    if kw.get("bias_bh") == "bh":
        kw["bias_bh"] = bh
    jargs, targs = bwd_operands(bh, s, hd, kw, seed=hd + s)
    ref = ra.build_flash_attention_bwd(bh, s, hd, jnp.bfloat16, **kw)(*jargs)
    fn = pa.build_flash_attention_bwd(bh, s, hd, BF16, **kw)
    assert fn.path == ("wgmma" if hd <= 128 else "mma")
    assert (fn.block_k, fn.block_k_dq) == ((128, 128) if hd <= 128
                                           else (32, 32))
    got = fn(*targs)
    assert len(got) == len(ref) == (4 if kw.get("bias_grad") else 3)
    for i, (r, g) in enumerate(zip(ref, got)):
        assert g.dtype == (F32 if i == 3 else BF16), i
        assert tuple(g.shape) == np.shape(r), i
        check(np.asarray(jnp.asarray(r).astype(jnp.float32), np.float64),
              g.float().numpy().astype(np.float64), margin=TOL)
