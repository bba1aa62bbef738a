"""The flash backward's tensor-core forms, on the CPU: which CUDA kernels
a backward call takes (`flash_bwd_path` and `bwd_kernel`, the predicates
that mirror the choice csrc makes: the wgmma kernels at every bf16 hd, the
128-key plan up to hd 128 and the wide kernels past it), the bf16 tile
plan and shared-memory budget of every head-dim bucket, the override
acceptance, the f32 configurations unchanged, and the bf16 wrapper at
shapes that reach both plans on the card (hd 64 and a padded 80, a padded
200) held against the JAX package on the same numpy inputs. The port's
wrapper runs its plain version on CPU tensors; the JAX side runs as its
own tests run it (the Pallas kernels in interpret mode).

Tolerance (matdiff normf_rel): 1e-2 for the bf16 gradients (p~ and dS are
rounded to bf16 against scores that differ in the last f32 bits, then each
output is rounded to bf16) and for dbias from bf16 inputs.
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

BF16, F32 = torch.bfloat16, torch.float32
SMEM_MAX = 232448            # a block's shared memory on sm_90
TOL = 1e-2


def test_flash_bwd_path():
    """bf16 takes the wgmma kernels at every hd, whatever the tile override
    (the wide ones past hd 128); f32 the TMA-fed FMA ones (no TF32)."""
    for hd in (40, 128, 136, 256):
        assert pa.flash_bwd_path(BF16, hd) == "wgmma"
    assert pa.flash_bwd_path(BF16) == "wgmma"
    assert pa.flash_bwd_path(F32) == "tma_fma"
    for hd, plan in ((40, "wgmma"), (128, "wgmma"), (136, "wgmma_wide"),
                     (256, "wgmma_wide")):
        assert pa.bwd_kernel("dq", BF16, hd) == f"flash_bwd_dq_{plan}_kernel"
        assert pa.bwd_kernel("dkv", BF16, hd) == \
            f"flash_bwd_dkv_{plan}_kernel"
        assert pa.bwd_kernel("dkv", F32, hd) == "flash_bwd_dkv_tma_fma_kernel"
    assert pa.build_flash_attention_bwd(2, 128, 40, BF16).path == "wgmma"
    assert pa.build_flash_attention_bwd(
        2, 128, 40, BF16, block_override=(64, 64)).path == "wgmma"
    wide = pa.build_flash_attention_bwd(2, 128, 136, BF16)
    assert wide.path == "wgmma" and wide.kernels == {
        "dkv": "flash_bwd_dkv_wgmma_wide_kernel",
        "dq": "flash_bwd_dq_wgmma_wide_kernel"}
    assert pa.build_flash_attention_bwd(2, 128, 40, F32).path == "tma_fma"


# (dK/dV, dQ) shared memory of a block by padded hd: csrc fw_dkv_smem and
# fw_dq_smem (64, 128), fw_dkv_wide_smem and fw_dq_wide_smem (192, 256)
SMEM = {64: (84536, 99368), 128: (166456, 197672), 192: (182312, 197704),
        256: (198696, 230456)}


@pytest.mark.parametrize("kernel", ["dkv", "dq"])
@pytest.mark.parametrize("hd,hdp", [
    (8, 64), (32, 64), (40, 64), (64, 64), (80, 128), (96, 128), (104, 128),
    (128, 128), (136, 192), (192, 192), (200, 256), (256, 256)])
def test_bf16_bwd_configs(hd, hdp, kernel):
    """The tile plan by hd bucket: up to a padded 128 dK/dV 64-row Q tiles
    against a block of 128 keys and dQ 128 rows against 128-key tiles;
    past it (the wide kernels) blocks of 64 keys and 64-key tiles; one tile
    a kernel, which the built object names, and a block's shared memory
    within 227 KB."""
    assert pa._bwd_hdp(hd) == hdp
    configs = pa.bwd_configs(hd, kernel, BF16)
    keys = 128 if hdp <= 128 else 64
    assert configs == [(64, keys) if kernel == "dkv" else (128, keys)]
    smem = pa._bwd_smem_bytes(hd, kernel, BF16)
    assert smem == SMEM[hdp][kernel == "dq"] <= SMEM_MAX
    fn = pa.build_flash_attention_bwd(2, 256, hd, BF16)
    assert (fn.path, fn.block_q, fn.block_k, fn.block_q_dq,
            fn.block_k_dq) == ("wgmma", 64, keys, 128, keys)
    assert fn.name.endswith(f"_wgmma_bk{keys}_{keys}")


def test_bf16_bwd_smem_bytes():
    """dK/dV: the alignment slack, K^T and V of the block's keys, a ring of
    64-row Q and dO tiles with their lse and delta rows (three stages up to
    hd 128; past it two, the tiles 256 columns wide) and its barriers; dQ:
    Q and dO of 128 rows, two 128-key K^T and V stages up to hd 128, past
    it three or four 64-key K^T or V units (csrc xsmm_flash_wgmma.cuh),
    mirrored term by term; the C header's static assertion holds the same
    budgets."""
    for hdp, (dkv, dq) in SMEM.items():
        keys = 128 if hdp <= 128 else 64
        stages, width = (3, hdp) if hdp <= 128 else (2, 256)
        assert dkv == (1024 + 2 * keys * hdp * 2
                       + stages * (2 * 64 * width * 2 + 2 * 64 * 4)
                       + (2 * stages + 1) * 8)
        units, unit = ((2, 2 * 128 * hdp * 2) if hdp <= 128 else
                       (4 if hdp <= 192 else 3, 64 * hdp * 2))
        assert dq == (1024 + 2 * 128 * hdp * 2 + units * unit
                      + (2 * units + 1) * 8)
        assert pa._bwd_smem_bytes(hdp, "dkv", BF16) == dkv
        assert pa._bwd_smem_bytes(hdp, "dq", BF16) == dq
    head = (pathlib.Path(pa.__file__).parent / "csrc"
            / "xsmm_flash_wgmma.cuh").read_text()
    for fn in ("fw_dkv_wide_smem(192)", "fw_dkv_wide_smem(256)",
               "fw_dq_wide_smem(192)", "fw_dq_wide_smem(256)"):
        assert f"{fn} <= TF_SMEM_MAX" in head


def test_f32_bwd_configs_keep_their_values():
    """The configurations are the bf16 kernels' (the default dtype); the
    f32 kernels take one tile per hd bucket, so f32 has none to pick."""
    for hd, want in ((32, [(64, 128)]), (128, [(64, 128)]),
                     (192, [(64, 64)]), (256, [(64, 64)])):
        assert pa.bwd_configs(hd) == pa.bwd_configs(hd, "dkv", BF16) == want
    assert pa._bwd_smem_bytes(256) == \
        pa._bwd_smem_bytes(256, "dkv", BF16) == 198696
    for call in (lambda: pa.bwd_configs(128, "dq", F32),
                 lambda: pa._bwd_smem_bytes(256, "dkv", F32)):
        with pytest.raises(ValueError, match="one tile per hd bucket"):
            call()
    fn = pa.build_flash_attention_bwd(2, 256, 128, F32)
    assert fn.path == "tma_fma" and (fn.block_k, fn.block_k_dq) == (None,
                                                                     None)


@pytest.mark.parametrize("hd", [40, 64, 128, 256])
def test_bf16_bwd_block_override_picks(hd):
    """An override only has to tile s, at every hd: the wgmma kernels keep
    their one tile each (the wide ones' past hd 128), and every override
    the port took before is still taken, (64, 16) past hd 128 too."""
    keys = 128 if hd <= 128 else 64
    for override in ((128, 128), (64, 32), (256, 64), (64, 16)):
        fn = pa.build_flash_attention_bwd(2, 256, hd, BF16,
                                          block_override=override)
        assert (fn.block_q, fn.block_k, fn.block_q_dq, fn.block_k_dq) == (
            64, keys, 128, keys)
        assert fn.path == "wgmma"


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
    """bf16 backward at hd 64 and 80 (the 128-key plan; 80 padded to 128)
    and 200 (the wide kernels, padded to 256), each flag, against the JAX
    package's two backward kernels on the same operands: dQ, dK^T and dV
    (and dbias) each within the margin."""
    bh = 2
    kw = dict(FLAGS[flag])
    if kw.get("bias_bh") == "bh":
        kw["bias_bh"] = bh
    jargs, targs = bwd_operands(bh, s, hd, kw, seed=hd + s)
    ref = ra.build_flash_attention_bwd(bh, s, hd, jnp.bfloat16, **kw)(*jargs)
    fn = pa.build_flash_attention_bwd(bh, s, hd, BF16, **kw)
    assert fn.path == "wgmma"
    assert (fn.block_k, fn.block_k_dq) == ((128, 128) if hd <= 128
                                           else (64, 64))
    got = fn(*targs)
    assert len(got) == len(ref) == (4 if kw.get("bias_grad") else 3)
    for i, (r, g) in enumerate(zip(ref, got)):
        assert g.dtype == (F32 if i == 3 else BF16), i
        assert tuple(g.shape) == np.shape(r), i
        check(np.asarray(jnp.asarray(r).astype(jnp.float32), np.float64),
              g.float().numpy().astype(np.float64), margin=TOL)
