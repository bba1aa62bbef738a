"""The flash backward's wgmma route, on the CPU: which bf16 shapes take it
(`flash_bwd_path`, the predicate that mirrors csrc run: every bf16 hd,
whatever the tile override; past hd 128 the wide kernels), the
block_override picks, the counters' entries, and the port at each hd
bucket of the route (64, 128, 192, 256) held against the JAX package's
`build_flash_attention_bwd` (its Pallas kernels in interpret mode) on the
same numpy inputs, at every flag and with a head map under dropout. The
port's wrapper runs its plain version on CPU tensors.

Tolerance (matdiff normf_rel): 1e-2 for the bf16 gradients and for dbias
from bf16 inputs (p~ and dS are rounded to bf16 against scores that differ
in the last f32 bits, then each output is rounded to bf16), the margin of
tests/test_torch_mma_bwd.py.
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
CSRC = (pathlib.Path(__file__).resolve().parents[1] / "libxsmm_torch"
        / "kernels" / "csrc")
TOL = 1e-2


# ---------------------------------------------------------------------------
# the route, the tiles and the entries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("override", [None, (128, 128), (64, 32),
                                      (256, 256)])
@pytest.mark.parametrize("hd,want", [
    (8, "wgmma"), (40, "wgmma"), (64, "wgmma"), (72, "wgmma"),
    (128, "wgmma"), (136, "wgmma"), (192, "wgmma"), (256, "wgmma")])
def test_route_by_shape_and_override(hd, want, override):
    """bf16 takes the wgmma kernels at every hd (the wide ones past 128),
    whatever the override; the built object names the same route; f32
    keeps tma_fma."""
    assert pa.flash_bwd_path(BF16, hd) == want
    fn = pa.build_flash_attention_bwd(2, 256, hd, BF16,
                                      block_override=override)
    assert fn.path == want
    assert fn.name.endswith(f"_bfloat16_{want}_bk{fn.block_k}_"
                            f"{fn.block_k_dq}")
    assert pa.flash_bwd_path(F32, hd) == "tma_fma"
    assert pa.build_flash_attention_bwd(2, 256, hd, F32,
                                        block_override=override).path \
        == "tma_fma"


@pytest.mark.parametrize("hd", [40, 64, 128, 200, 256])
@pytest.mark.parametrize("override", [
    None, (128, 128), (512, 512), (128, 64), (64, 128), (64, 32), (512, 32),
    (64, 16)])
def test_block_override_picks(hd, override):
    """The wgmma kernels take one tile each (dK/dV 64 x 128 and dQ 128 x
    128 up to hd 128; past it 64 x 64 and 128 x 64): an override only has
    to tile s, as on the f32 route; every override the port took before is
    still taken."""
    fn = pa.build_flash_attention_bwd(2, 512, hd, BF16,
                                      block_override=override)
    keys = 128 if hd <= 128 else 64
    assert (fn.block_q, fn.block_k, fn.block_q_dq, fn.block_k_dq) == (
        64, keys, 128, keys)


def test_block_override_refusals():
    """An override that does not tile s is refused on every route; past hd
    128 one under the retired mma.sync kernels' 64 x 32 tile is now
    taken."""
    assert pa.build_flash_attention_bwd(
        2, 256, 256, BF16, block_override=(64, 16)).block_k == 64
    for hd in (64, 256):
        with pytest.raises(ValueError, match="does not tile"):
            pa.build_flash_attention_bwd(2, 256, hd, BF16,
                                         block_override=(96, 128))


def test_entries_name_the_wgmma_kernels():
    """Both backward counters name their wgmma kernels (the 128-key plan's
    and the wide ones) beside the tma_fma one, each a kernel of the source;
    the route has its own launch counts, each kernel its own."""
    src = (CSRC / "attention_bwd_kernels.cu").read_text()
    for counter in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        stem, names = pa.ENTRIES[counter]
        part = counter.rsplit("_", 1)[1]
        assert stem == "attention_bwd_kernels"
        for kernel in (f"flash_bwd_{part}_wgmma_kernel",
                       f"flash_bwd_{part}_wgmma_wide_kernel"):
            assert kernel in names and f"{kernel}(" in src
            assert pa.kernel_launches[kernel] == 0
        assert pa.path_launches[counter]["wgmma"] == 0
    assert "wgmma" in pa.ROUTES and "mma" not in pa.ROUTES


# ---------------------------------------------------------------------------
# parity with the JAX package at each wgmma tile and hd bucket
# ---------------------------------------------------------------------------

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


def held(ref, got):
    """Each output of the port within the margin of the reference's."""
    assert len(got) == len(ref)
    for i, (r, g) in enumerate(zip(ref, got)):
        assert g.dtype == (F32 if i == 3 else BF16), i
        assert tuple(g.shape) == np.shape(r), i
        check(np.asarray(jnp.asarray(r).astype(jnp.float32), np.float64),
              g.float().numpy().astype(np.float64), margin=TOL)


FLAGS = {
    "plain": {},
    "causal": {"causal": True},
    "dropout": {"dropout_p": 0.1},
    "bias_bh_grad": {"bias_bh": "bh", "bias_grad": True},
    "bias1": {"bias_bh": 1},
    "causal_dropout_bias_grad": {"causal": True, "dropout_p": 0.2,
                                 "bias_bh": "bh", "bias_grad": True},
}


@pytest.mark.parametrize("flag", list(FLAGS))
@pytest.mark.parametrize("hd,s", [(40, 128), (64, 256), (80, 128),
                                  (128, 256), (192, 256), (256, 256)])
def test_wgmma_parity(hd, s, flag):
    """bf16 backward on the wgmma route at every hd bucket (64: hd 40 and
    64; 128: hd 80 and 128, zero-padded on the card; 192 and 256, the wide
    kernels), each flag, against the JAX package's two backward kernels on
    the same operands: dQ, dK^T and dV (and dbias) each within the
    margin."""
    bh = 2
    kw = dict(FLAGS[flag])
    if kw.get("bias_bh") == "bh":
        kw["bias_bh"] = bh
    jargs, targs = bwd_operands(bh, s, hd, kw, seed=hd + s)
    ref = ra.build_flash_attention_bwd(bh, s, hd, jnp.bfloat16, **kw)(*jargs)
    fn = pa.build_flash_attention_bwd(bh, s, hd, BF16, **kw)
    assert fn.path == "wgmma"
    keys = 128 if hd <= 128 else 64
    assert (fn.block_q, fn.block_k, fn.block_q_dq, fn.block_k_dq) == (
        64, keys, 128, keys)
    held(ref, fn(*targs))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_wgmma_head_map_dropout_parity(hd, causal):
    """A block of heads under a head map hashes its global batch-heads: the
    port on batch 1, heads 2-3 of 2 x 4 (head_map (1, 2, 2, 4)) with
    dropout equals the reference's backward of the whole attention at those
    batch-heads (6 and 7)."""
    nb, nhg, s = 2, 4, 128
    kw = {"dropout_p": 0.2, "causal": causal}
    jargs, targs = bwd_operands(nb * nhg, s, hd, kw, seed=hd + causal)
    ref = ra.build_flash_attention_bwd(nb * nhg, s, hd, jnp.bfloat16,
                                       **kw)(*jargs)
    sel = slice(6, 8)
    part = (targs[0],) + tuple(t[sel] for t in targs[1:])
    fn = pa.build_flash_attention_bwd(2, s, hd, BF16, head_map=(1, 2, 2, 4),
                                      **kw)
    assert fn.path == "wgmma" and fn.head_map == (1, 2, 2, 4)
    held(tuple(np.asarray(r)[sel] for r in ref), fn(*part))
    # the same block hashed by its local indices draws other bits
    local = pa.build_flash_attention_bwd(2, s, hd, BF16, **kw)(*part)
    assert not torch.equal(local[2], fn(*part)[2])
