"""The dropout kernel's three mask forms on the card, bit for bit against
the plain version, and the meltw DROPOUT entry taking its packed mask from
the kernel.

Every test here needs a CUDA device and skips without one. On the GPU
machine run:

    python -m pytest tests/test_torch_cuda_dropout.py --noconftest -q

(`--noconftest`: the repo's tests/conftest.py sets JAX up for the JAX
package's tests, and this file imports nothing of JAX or libxsmm_tpu.)

Shapes: one row and many, n ragged (not a multiple of 16, nor of 8), a row
stride that is not a multiple of 16 bytes, and x off 16-byte alignment
(the element-wise path), beside aligned shapes (the vector path).
Everything is bit for bit: kernel and plain version compute the same hash
and the same f32 arithmetic.
"""

import pytest
import torch

import libxsmm_torch as xp
from libxsmm_torch.kernels import eltwise as ke
from libxsmm_torch.ops import eltwise as oe

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.bfloat16, torch.float16]
SHAPES = [(1, 1), (1, 40), (5, 37), (3, 16), (33, 48), (7, 1000),
          (4096, 3072)]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.Generator(device="cuda").manual_seed(0)


def _x(gen, shape, dtype, offset=0):
    numel = shape[0] * shape[1]
    base = torch.randn(numel + offset, generator=gen, device="cuda") + 2.0
    return base.to(dtype)[offset:].view(shape)


def _launched(fn):
    before = ke.launches["dropout"]
    out = fn()
    torch.cuda.synchronize()
    assert ke.launches["dropout"] == before + 1
    return out


@pytest.mark.parametrize("form", ["bytes", "packed", "none"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16", "f16"])
def test_dropout_form_bit_exact(gen, dtype, shape, form):
    x = _x(gen, shape, dtype)
    got = _launched(lambda: ke.dropout(x, 1234, 0.3, mask=form))
    want = ke.dropout.plain(x, 1234, 0.3, mask=form)
    if form == "none":
        assert isinstance(got, torch.Tensor) and torch.equal(got, want)
        return
    assert got[1].dtype == torch.uint8 and got[1].shape == want[1].shape
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("shape", [(1, 64), (9, 48), (4, 37)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16", "f16"])
def test_dropout_packed_unaligned(gen, dtype, shape, offset):
    x = _x(gen, shape, dtype, offset)
    assert x.data_ptr() % 16
    out, packed = _launched(lambda: ke.dropout(x, 77, 0.5, mask="packed"))
    want_out, want_packed = ke.dropout.plain(x, 77, 0.5, mask="packed")
    assert torch.equal(out, want_out) and torch.equal(packed, want_packed)


def test_dropout_forms_agree(gen):
    """The three forms draw the same bits: one output, the packed mask the
    packing of the byte mask, pad bits 0."""
    x = _x(gen, (129, 200), torch.bfloat16)
    out_b, keep = ke.dropout(x, 5, 0.1)
    out_p, packed = ke.dropout(x, 5, 0.1, mask="packed")
    out_n = ke.dropout(x, 5, 0.1, mask="none")
    torch.cuda.synchronize()
    assert torch.equal(out_b, out_p) and torch.equal(out_b, out_n)
    assert torch.equal(packed, oe.pack_bitmask(keep != 0))
    assert not bool(oe.unpack_bitmask(packed, 129, 208)[:, 200:].any())


def test_dropout_byte_form_unchanged(gen):
    """The default form stays the byte mask the encoder block's _Dropout
    saves: the same result as before the forms, element for element."""
    x = torch.randn(2, 3, 129, generator=gen,
                    device="cuda").to(torch.bfloat16)
    out, mask = _launched(lambda: ke.dropout(x, -7, 0.2))
    want_out, want_mask = ke.dropout.plain(x, -7, 0.2)
    assert mask.shape == x.shape and mask.dtype == torch.uint8
    assert torch.equal(out, want_out) and torch.equal(mask, want_mask)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16", "f16"])
def test_meltw_dropout_packs_in_the_kernel(gen, dtype, monkeypatch):
    """dispatch_meltw_unary(DROPOUT, BITMASK_2BYTEMULT) takes its packed
    mask from the kernel (pack_bitmask is not called), equal to the packing
    of the plain mask; without the flag it returns out alone."""
    m, n = 300, 77
    x = _x(gen, (m, n), dtype, offset=1)
    dt = xp.Datatype[{torch.float32: "F32", torch.bfloat16: "BF16",
                      torch.float16: "F16"}[dtype]]

    def refuse(*_a, **_k):
        raise AssertionError("pack_bitmask called on the card's path")

    kern = xp.dispatch_meltw_unary(xp.UnaryType.DROPOUT, m, n,
                                   xp.UnaryFlags.BITMASK_2BYTEMULT, dt,
                                   extra=(0.1,))
    bare = xp.dispatch_meltw_unary(xp.UnaryType.DROPOUT, m, n, in_type=dt,
                                   extra=(0.1,))
    monkeypatch.setattr(oe, "pack_bitmask", refuse)
    out, packed = _launched(lambda: kern(x, 7))
    alone = _launched(lambda: bare(x, 7))
    monkeypatch.undo()
    want_out, want_keep = ke.dropout.plain(x, 7, 0.1)
    assert torch.equal(out, want_out) and torch.equal(alone, want_out)
    assert torch.equal(packed, oe.pack_bitmask(want_keep != 0))
