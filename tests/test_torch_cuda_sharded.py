"""The kernels of the sharded encoder block on the card: the dropout kernel
on a block of a global tensor, and the flash forward and backward kernels
with a head map, against their plain versions and against the same kernels
on the whole tensor.

Every test here needs a CUDA device and skips without one. On the GPU
machine run:

    python -m pytest tests/test_torch_cuda_sharded.py --noconftest -q

(`--noconftest`: the repo's tests/conftest.py sets JAX up for the JAX
package's tests, and this file imports nothing of JAX or libxsmm_tpu.)

Tolerances. The dropout is bit for bit: kernel and plain version compute
the same hash of the same global index and the same f32 arithmetic; and a
block's output and mask are the whole tensor's, cut, bit for bit. Flash
against its plain version (matdiff normf_rel): 1e-5 for f32 outputs,
gradients and the LSE, 1e-2 for bf16 (the existing card tests' margins,
tests/test_torch_cuda_attention.py). Flash with a head map against the same
kernel on the whole tensor, cut to the block's heads: bit for bit (each
head is computed alone, by the same tile configuration, from the same
hashed bits).
"""

import pytest
import torch

from libxsmm_torch.kernels import attention as ka
from libxsmm_torch.kernels import eltwise as ke
from libxsmm_torch.matdiff import check

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False

DTYPES = [torch.float32, torch.bfloat16, torch.float16]
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# (global shape, block offset, block shape)
BLOCKS = [
    ((4096, 3072), (2048, 1536), (2048, 1536)),   # the FFN's dp x tp block
    ((64, 48), (16, 16), (16, 32)),
    ((33, 1001), (5, 7), (11, 499)),              # odd offsets and widths
    ((7, 37), (0, 3), (7, 33)),                   # rows off 16 bytes
    ((1, 40), (0, 1), (1, 39)),
    ((8, 12, 128, 128), (4, 6, 0, 0), (4, 6, 128, 128)),   # probabilities
    ((3, 5, 9, 17), (1, 2, 3, 4), (2, 3, 5, 11)),
    ((6, 10, 12), (2, 3, 1), (3, 5, 11))]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.Generator(device="cuda").manual_seed(0)


def _block(full, off, shape):
    return full[tuple(slice(o, o + n) for o, n in zip(off, shape))]


def _launched(fn, name, module=ke, count=1):
    before = module.launches[name]
    out = fn()
    torch.cuda.synchronize()
    assert module.launches[name] == before + count
    return out


@pytest.mark.parametrize("case", BLOCKS,
                         ids=lambda c: "x".join(map(str, c[2])))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "off16"])
def test_dropout_block_bit_exact(gen, dtype, case, offset):
    """bytes and none on a block: the kernel against the plain version,
    and against the whole tensor's dropout, cut to the block; with the
    operand 16-byte aligned and one element off."""
    gshape, off, shape = case
    full = (torch.randn(*gshape, generator=gen, device="cuda") + 2).to(dtype)
    numel = _block(full, off, shape).numel()
    x = torch.empty(numel + offset, dtype=dtype,
                    device="cuda")[offset:].view(shape)
    x.copy_(_block(full, off, shape))
    block = (gshape, off)
    out, mask = _launched(lambda: ke.dropout(x, 99, 0.3, block=block),
                          "dropout")
    want, want_mask = ke.dropout.plain(x, 99, 0.3, block=block)
    assert torch.equal(out.view(torch.uint8), want.view(torch.uint8))
    assert torch.equal(mask, want_mask)
    whole, whole_mask = ke.dropout(full, 99, 0.3)
    assert torch.equal(out.view(torch.uint8),
                       _block(whole, off, shape).view(torch.uint8))
    assert torch.equal(mask, _block(whole_mask, off, shape))
    none = _launched(lambda: ke.dropout(x, 99, 0.3, mask="none",
                                        block=block), "dropout")
    assert torch.equal(none.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.parametrize("case", [c for c in BLOCKS if len(c[0]) == 2],
                         ids=lambda c: "x".join(map(str, c[2])))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16", "f16"])
def test_dropout_block_packed(gen, dtype, case):
    """The packed bitmask of a 2-D block, against the plain version."""
    gshape, off, shape = case
    x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    block = (gshape, off)
    out, mask = _launched(lambda: ke.dropout(x, 5, 0.5, mask="packed",
                                             block=block), "dropout")
    want, want_mask = ke.dropout.plain(x, 5, 0.5, mask="packed", block=block)
    assert torch.equal(out.view(torch.uint8), want.view(torch.uint8))
    assert torch.equal(mask, want_mask)


def test_dropout_blocks_tile_the_whole_mask(gen):
    """Four ranks' blocks of the FFN's (batch * s, 4 d) hidden layer (dp 2
    x tp 2), put together, are the single-device mask bit for bit."""
    rows, cols = 8 * 512, 3072
    full = torch.randn(rows, cols, generator=gen, device="cuda").to(
        torch.bfloat16)
    _, whole = ke.dropout(full, 8, 0.1)
    parts = [[None, None], [None, None]]
    for d in range(2):
        for t in range(2):
            off = (d * rows // 2, t * cols // 2)
            blk = _block(full, off, (rows // 2, cols // 2)).contiguous()
            parts[d][t] = ke.dropout(blk, 8, 0.1,
                                     block=((rows, cols), off))[1]
    assert torch.equal(torch.cat([torch.cat(r, 1) for r in parts], 0),
                       whole)


def test_dropout_without_block_keeps_its_bits(gen):
    """No block: the bits of x's own flat index, as before; the identity
    block (the whole tensor at offset 0) gives the same bits through the
    block kernel."""
    x = torch.randn(333, 77, generator=gen, device="cuda")
    out, mask = ke.dropout(x, 3, 0.25)
    want, want_mask = ke.dropout.plain(x, 3, 0.25)
    assert torch.equal(mask, want_mask) and torch.equal(out, want)
    out2, mask2 = ke.dropout(x, 3, 0.25, block=((333, 77), (0, 0)))
    assert torch.equal(mask2, mask) and torch.equal(out2, out)


def test_dropout_block_refusals(gen):
    x = torch.ones(4, 8, device="cuda")
    with pytest.raises(ValueError, match="inside"):
        ke.dropout(x, 1, 0.1, block=((8, 8), (5, 0)))
    with pytest.raises(ValueError, match="one entry per dimension"):
        ke.dropout(x, 1, 0.1, block=((8, 8, 8), (0, 0, 0)))

# ------------------------------------------------------------------ flash


# (batch, heads, s, hd, b0, batch_l, h0, nh_local): the block holds
# batches [b0, b0 + batch_l) and heads [h0, h0 + nh_local)
HEAD_CASES = [(8, 12, 512, 64, 4, 4, 6, 6),  # the encoder block, dp 2 x tp 2
              (4, 6, 256, 64, 1, 2, 3, 2),
              (3, 5, 128, 32, 1, 1, 1, 3)]


def _flash_inputs(gen, batch, nh, s, hd, dtype):
    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    return (r(batch * nh, s, hd), r(batch * nh, hd, s), r(batch * nh, s, hd),
            r(batch * nh, s, hd))


def _heads(batch_l, b0, h0, nhl, nh):
    return torch.tensor([(b0 + b) * nh + h0 + h for b in range(batch_l)
                         for h in range(nhl)], device="cuda")


@pytest.mark.parametrize("case", HEAD_CASES, ids=lambda c: f"s{c[2]}")
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_head_map(gen, case, dtype, causal):
    """Forward (out, LSE) and both backward kernels with a head map:
    within the margins of their plain versions with the same map, and bit
    for bit the whole tensor's kernels cut to the block's heads."""
    batch, nh, s, hd, b0, batch_l, h0, nhl = case
    q, kT, v, dout = _flash_inputs(gen, batch, nh, s, hd, dtype)
    idx = _heads(batch_l, b0, h0, nhl, nh)
    hm = (b0, h0, nhl, nh)
    bh = batch_l * nhl
    kw = dict(causal=causal, dropout_p=0.1)
    fwd = ka.build_flash_attention(bh, s, hd, dtype, return_lse=True,
                                   head_map=hm, **kw)
    ops = [t[idx].contiguous() for t in (q, kT, v)]
    out, lse = _launched(lambda: fwd(11, *ops), "flash_attention_fwd", ka)
    want, want_lse = fwd.plain(11, *ops)
    check(want.float(), out.float(), margin=TOL[dtype])
    check(want_lse.float(), lse.float(), margin=1e-5)
    whole = ka.build_flash_attention(batch * nh, s, hd, dtype,
                                     return_lse=True, **kw)
    w_out, w_lse = whole(11, q, kT, v)
    assert torch.equal(out, w_out[idx]) and torch.equal(lse, w_lse[idx])

    d = dout[idx].contiguous()
    delta = (d.float() * out.float()).sum(-1, keepdim=True).expand(
        bh, s, 128)
    bwd = ka.build_flash_attention_bwd(bh, s, hd, dtype, head_map=hm, **kw)
    got = _launched(lambda: bwd.dkv(11, *ops, d, lse, delta),
                    "flash_attention_bwd_dkv", ka)
    got = (_launched(lambda: bwd.dq(11, *ops, d, lse, delta),
                     "flash_attention_bwd_dq", ka),) + got
    want = bwd.plain(11, *ops, d, lse, delta)
    for g, w in zip(got, want):
        check(w.float(), g.float(), margin=TOL[dtype])
    w_delta = (dout.float() * w_out.float()).sum(-1, keepdim=True).expand(
        batch * nh, s, 128)
    w_bwd = ka.build_flash_attention_bwd(batch * nh, s, hd, dtype, **kw)
    for g, w in zip(got, w_bwd(11, q, kT, v, dout, w_lse, w_delta)):
        assert torch.equal(g, w[idx])


def test_flash_default_head_map_keeps_its_bits(gen):
    """No head map: the local batch-head index, as before; the explicit
    identity map (0, 0, 1, 1) gives the same bits."""
    q, kT, v, _ = _flash_inputs(gen, 2, 4, 256, 64, torch.bfloat16)
    a = ka.build_flash_attention(8, 256, 64, torch.bfloat16, dropout_p=0.2)
    b = ka.build_flash_attention(8, 256, 64, torch.bfloat16, dropout_p=0.2,
                                 head_map=(0, 0, 1, 1))
    assert torch.equal(a(4, q, kT, v), b(4, q, kT, v))
    check(a.plain(4, q, kT, v).float(), a(4, q, kT, v).float(),
          margin=TOL[torch.bfloat16])
