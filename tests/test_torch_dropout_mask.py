"""The dropout kernel's mask forms, on the CPU: the port's dropout
(`libxsmm_torch.kernels.eltwise.dropout`, its plain version on CPU tensors)
in the "bytes", "packed" and "none" forms, against the JAX package's
BITMASK_2BYTEMULT layout (`libxsmm_tpu.ops.eltwise.pack_bitmask`) and its
meltw DROPOUT entry on the same numpy inputs.

Tolerances: the packed mask is bit for bit the JAX package's packing of the
same keep mask, and each form's output is bit for bit the byte form's.
Dropout's random bits differ by design between the packages (the JAX
package's CPU path draws jax.random, the port a counter hash), so the meltw
entry is held to statistical parity: each package's keep rate within 4
sigma of 1 - p.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import libxsmm_torch as xp
import libxsmm_tpu as xt
from libxsmm_torch.kernels import eltwise as ke
from libxsmm_tpu.descriptor import UnaryFlags, UnaryType
from libxsmm_tpu.dtypes import Datatype
from libxsmm_tpu.ops.eltwise import pack_bitmask as jax_pack_bitmask

torch.set_num_threads(1)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}


def _x(m, n, dtype, seed=0):
    x = np.random.default_rng(seed).standard_normal((m, n)) + 3.0
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


@pytest.mark.parametrize("n", range(1, 41))
@pytest.mark.parametrize("dt", list(DTYPES))
def test_packed_plain_is_reference_pack_bitmask(dt, n):
    """n from 1 to 40 (ragged words and pad bits), m 1-5: the packed form
    is the JAX package's pack_bitmask of the byte form's keep mask, bit for
    bit, with the (m, ceil(n/16) * 2) shape; out is the byte form's."""
    for m in range(1, 6):
        x = _x(m, n, DTYPES[dt], seed=n * 7 + m)
        out_b, keep = ke.dropout(x, 9 + n, 0.3)
        out_p, packed = ke.dropout(x, 9 + n, 0.3, mask="packed")
        assert packed.dtype == torch.uint8
        assert tuple(packed.shape) == (m, (n + 15) // 16 * 2)
        want = np.asarray(jax_pack_bitmask(jnp.asarray(keep.numpy() != 0),
                                           two_byte_mult=True))
        np.testing.assert_array_equal(packed.numpy(), want)
        assert torch.equal(out_p, out_b)
        assert torch.equal(ke.dropout(x, 9 + n, 0.3, mask="none"), out_b)


@pytest.mark.parametrize("m,n", [(1, 16), (3, 37), (5, 48), (2, 1)])
def test_packed_words_are_the_reference_layout(m, n):
    """The kernel's packing: step t = r * W + w (W = ceil(n/16)) stores the
    keep bits of columns 16 w .. 16 w + 15 of row r as one little-endian
    16-bit word at byte 2 t, bit e for column 16 w + e, pad bits 0. A
    numpy model of those words is the JAX package's layout."""
    keep = np.random.default_rng(m * n).random((m, n)) < 0.6
    W = (n + 15) // 16
    words = np.zeros(m * W, np.uint16)
    for t in range(m * W):
        r, w = divmod(t, W)
        for e in range(16):
            c = 16 * w + e
            if c < n and keep[r, c]:
                words[t] |= np.uint16(1 << e)
    got = words.astype("<u2").view(np.uint8).reshape(m, 2 * W)
    want = np.asarray(jax_pack_bitmask(jnp.asarray(keep), two_byte_mult=True))
    np.testing.assert_array_equal(got, want)


def test_mask_form_refusals():
    x = _x(4, 8, torch.float32)
    with pytest.raises(ValueError, match="mask must be one of"):
        ke.dropout(x, 0, 0.1, mask="bits")
    with pytest.raises(ValueError, match="2-D"):
        ke.dropout(x.reshape(2, 2, 8), 0, 0.1, mask="packed")
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        ke.dropout(x, 0, 1.0, mask="packed")


@pytest.mark.parametrize("n", [40, 3072])
@pytest.mark.parametrize("dt", [Datatype.F32, Datatype.BF16, Datatype.F16],
                         ids=lambda d: d.value)
def test_meltw_dropout_entry(dt, n):
    """dispatch_meltw_unary(DROPOUT) with BITMASK_2BYTEMULT returns (out,
    packed mask) in the reference's layout, without the flag out alone; the
    port's packed mask is its dropout's, the keep rates of both packages
    within 4 sigma of 1 - p."""
    m, p = 64, 0.3
    x = np.random.default_rng(n).standard_normal((m, n)).astype(np.float32)
    x = np.abs(x) + 1.0
    tdt = {Datatype.F32: torch.float32, Datatype.BF16: torch.bfloat16,
           Datatype.F16: torch.float16}[dt]
    xt_ = torch.from_numpy(x).to(tdt)
    flags = UnaryFlags.BITMASK_2BYTEMULT
    jk = xt.dispatch_meltw_unary(UnaryType.DROPOUT, m, n, flags, dt,
                                 extra=(p,))
    pk = xp.dispatch_meltw_unary(xp.UnaryType.DROPOUT, m, n,
                                 xp.UnaryFlags.BITMASK_2BYTEMULT,
                                 xp.Datatype(dt.value), extra=(p,))
    jx = jnp.asarray(x).astype({Datatype.F32: jnp.float32,
                                Datatype.BF16: jnp.bfloat16,
                                Datatype.F16: jnp.float16}[dt])
    oj, mj = jk(jx, seed=5)
    op, mp = pk(xt_, seed=5)
    assert op.dtype == tdt and mp.dtype == torch.uint8
    assert np.asarray(mj).shape == tuple(mp.shape) == (m, (n + 15) // 16 * 2)
    want_out, want_packed = ke.dropout(xt_, 5, p, mask="packed")
    assert torch.equal(mp, want_packed) and torch.equal(op, want_out)
    keep = xp.unpack_bitmask(mp, m, n)
    assert torch.equal(keep, op != 0)
    # pad bits of the last word are 0
    assert not bool(xp.unpack_bitmask(mp, m, (n + 15) // 16 * 16)[:, n:].any())
    sigma = (p * (1 - p) / (m * n)) ** 0.5
    jkeep = np.asarray(xt.unpack_bitmask(mj, m, n))
    assert abs(jkeep.mean() - (1 - p)) < 4 * sigma
    assert abs(keep.float().mean().item() - (1 - p)) < 4 * sigma
    # without the flag: the output alone, the same values
    _, plain = (xt.dispatch_meltw_unary(UnaryType.DROPOUT, m, n, in_type=dt,
                                        extra=(p,)),
                xp.dispatch_meltw_unary(xp.UnaryType.DROPOUT, m, n,
                                        in_type=xp.Datatype(dt.value),
                                        extra=(p,)))
    got = plain(xt_, seed=5)
    assert isinstance(got, torch.Tensor) and torch.equal(got, op)


def test_dropout_time_refuses_without_a_card():
    """scripts/dropout_time.py times the card's kernels only: without a
    CUDA device it exits before timing anything."""
    from libxsmm_torch.scripts import dropout_time
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        dropout_time.main([])
