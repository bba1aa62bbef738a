"""The flash-attention and dropout CUDA kernels on the card, against their
plain versions.

Every test here needs a CUDA device and skips without one. On the GPU
machine run:

    python -m pytest tests/test_torch_cuda_attention.py --noconftest -q

(`--noconftest`: the repo's tests/conftest.py sets JAX up for the JAX
package's tests, and this file imports nothing of JAX or libxsmm_tpu.)

Tolerances (matdiff normf_rel, kernel against plain on the same inputs):
1e-5 for f32 flash outputs and the LSE (the online softmax rescales per K
tile where the plain version takes the row's max at once: rounding only);
1e-2 for bf16 flash outputs (the exponentials are rounded to bf16 against a
per-tile running max, so they round at other points than the plain
version's, then the output is rounded to bf16). Dropout is bit-exact: the
kernel and its plain version compute the same hash and the same f32
arithmetic.
"""

import pytest
import torch

import libxsmm_torch as xp
from libxsmm_torch.dtypes import Datatype
from libxsmm_torch.kernels import attention as ka
from libxsmm_torch.kernels import eltwise as ke
from libxsmm_torch.matdiff import check

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
FLAGS = ["plain", "causal", "dropout", "bias1", "bias_bh", "lse", "scale",
         "causal_dropout_bias"]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.Generator(device="cuda").manual_seed(0)


def randn(gen, *shape, dtype=torch.float32, scale=1.0):
    x = torch.randn(*shape, generator=gen, device="cuda") * scale
    return x.to(dtype)


def _flash_case(gen, bh, s, hd, dtype, flag, block_override=None):
    kw = {}
    if "causal" in flag:
        kw["causal"] = True
    if "dropout" in flag:
        kw["dropout_p"] = 0.2
    if flag in ("bias1", "causal_dropout_bias"):
        kw["bias_bh"] = 1
    if flag == "bias_bh":
        kw["bias_bh"] = bh
    if flag == "lse":
        kw["return_lse"] = True
    if flag == "scale":
        kw["scale"] = 0.3
    fn = ka.build_flash_attention(bh, s, hd, dtype,
                                  block_override=block_override, **kw)
    q, v = randn(gen, bh, s, hd, dtype=dtype), randn(gen, bh, s, hd, dtype=dtype)
    kT = randn(gen, bh, hd, s, dtype=dtype)
    bias = None
    if kw.get("bias_bh"):
        bias = randn(gen, kw["bias_bh"], s, s, scale=0.5)
    return fn, (-12345, q, kT, v, bias)


@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernel_matches_plain(gen, dtype, hd, flag):
    fn, args = _flash_case(gen, 3, 256, hd, dtype, flag)
    before = ka.launches["flash_attention_fwd"]
    got = fn(*args)
    assert ka.launches["flash_attention_fwd"] == before + 1
    want = fn.plain(*args)
    torch.cuda.synchronize()
    if flag == "lse":
        (got, got_lse), (want, want_lse) = got, want
        assert got_lse.shape == (3, 256, 128)
        check(want_lse, got_lse, margin=1e-5)
    assert got.dtype == dtype and got.shape == (3, 256, hd) and got.is_cuda
    assert bool(torch.isfinite(got.float()).all())
    check(want.float(), got.float(), margin=TOL[dtype])


@pytest.mark.parametrize("config", [(64, 64), (64, 32)])
@pytest.mark.parametrize("flag", ["plain", "causal_dropout_bias"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_tile_configs(gen, dtype, flag, config):
    fn, args = _flash_case(gen, 2, 384, 64, dtype, flag,
                           block_override=config)
    assert (fn.block_q, fn.block_k) == config
    got = fn(*args)
    check(fn.plain(*args).float(), got.float(), margin=TOL[dtype])


def test_flash_deterministic_and_seeded(gen):
    fn, (seed, q, kT, v, _) = _flash_case(gen, 2, 256, 64, torch.bfloat16,
                                          "dropout")
    a, b = fn(seed, q, kT, v), fn(seed, q, kT, v)
    c = fn(seed + 1, q, kT, v)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_flash_dispatch_routes(gen):
    kern = xp.dispatch_flash_attention(4, 256, 64, Datatype.BF16,
                                       causal=True)
    assert not kern.info.is_reference_kernel
    q, v = (randn(gen, 4, 256, 64, dtype=torch.bfloat16) for _ in range(2))
    kT = randn(gen, 4, 64, 256, dtype=torch.bfloat16)
    before = ka.launches["flash_attention_fwd"]
    out = kern(q, kT, v)
    assert ka.launches["flash_attention_fwd"] == before + 1
    assert out.shape == (4, 256, 64) and out.dtype == torch.bfloat16
    # outside the envelope: the torch composition, no launch
    ref = xp.dispatch_flash_attention(4, 200, 64, Datatype.F32)
    assert ref.info.is_reference_kernel
    q2, v2 = randn(gen, 4, 200, 64), randn(gen, 4, 200, 64)
    kT2 = randn(gen, 4, 64, 200)
    ref(q2, kT2, v2)
    assert ka.launches["flash_attention_fwd"] == before + 1


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("shape", [(4096, 768), (37, 53), (3, 5, 129)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["f32", "bf16", "f16"])
def test_dropout_kernel_bit_exact(gen, dtype, shape, p):
    x = randn(gen, *shape, dtype=dtype)
    before = ke.launches["dropout"]
    out, mask = ke.dropout(x, -7, p)
    assert ke.launches["dropout"] == before + 1
    want_out, want_mask = ke.dropout.plain(x, -7, p)
    torch.cuda.synchronize()
    assert out.dtype == dtype and mask.dtype == torch.uint8
    assert torch.equal(mask, want_mask)
    assert torch.equal(out, want_out)


def test_dropout_kernel_unaligned_view(gen):
    base = randn(gen, 1001, dtype=torch.bfloat16)
    x = base[3:]                       # 6 bytes past a 16-byte boundary
    assert x.data_ptr() % 16
    out, mask = ke.dropout(x, 11, 0.25)
    want_out, want_mask = ke.dropout.plain(x, 11, 0.25)
    torch.cuda.synchronize()
    assert torch.equal(out, want_out) and torch.equal(mask, want_mask)


def test_dropout_kernel_statistics(gen):
    x = torch.ones(4096, 3072, device="cuda", dtype=torch.bfloat16)
    out, mask = ke.dropout(x, 3, 0.1)
    rate = mask.float().mean().item()
    n = x.numel()
    assert abs(rate - 0.9) < 4 * (0.9 * 0.1 / n) ** 0.5
    kept = out[mask.bool()].float()
    assert torch.allclose(kept, torch.full_like(kept, 1 / 0.9), rtol=1e-2)
    assert bool((out[~mask.bool()] == 0).all())


def test_dropout_and_sr_refusals(gen):
    with pytest.raises(ValueError, match="no CUDA kernel"):
        ke.dropout(randn(gen, 8, 8).double(), 0, 0.1)
    # stochastic rounding runs its kernel on the card now
    x = randn(gen, 8, 8)
    before = ke.launches["stochastic_round"]
    y = ke.stochastic_round(x, 0, Datatype.BF16)
    assert ke.launches["stochastic_round"] == before + 1
    assert torch.equal(y, ke.stochastic_round.plain(x, 0, Datatype.BF16))
    with pytest.raises(ValueError, match="no CUDA kernel"):
        ke.stochastic_round(x.double(), 0, Datatype.BF16)
    with pytest.raises(ValueError):
        ke.dropout(randn(gen, 8, 8), 0, 1.0)
