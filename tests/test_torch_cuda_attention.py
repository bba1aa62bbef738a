"""The flash-attention and dropout CUDA kernels on the card, against their
plain versions.

Every test here needs a CUDA device and skips without one. On the GPU
machine run:

    python -m pytest tests/test_torch_cuda_attention.py --noconftest -q

(`--noconftest`: the repo's tests/conftest.py sets JAX up for the JAX
package's tests, and this file imports nothing of JAX or libxsmm_tpu.)

f32 runs the TMA-fed FMA kernel ("tma_fma"), held against the plain
version at every form; the tests set and assert TF32 off. bf16 runs the
wgmma kernel ("wgmma") at every hd, 128-key tiles up to hd 128 and 64-key
tiles past it, held against the plain version at every form.

Tolerances (matdiff normf_rel, kernel against plain on the same inputs):
1e-5 for f32 flash outputs and the LSE (the online softmax rescales per K
tile where the plain version takes the row's max at once: rounding only);
1e-2 for bf16 flash outputs (the exponentials are rounded to bf16 against a
per-tile running max, so they round at other points than the plain
version's, then the output is rounded to bf16; the same margin for the
bf16 tensor-core kernels, whose bf16 products are exact in their f32
accumulators). Dropout is bit-exact: the
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
    if flag == "dropout_head_map":
        kw["head_map"] = (1, 2, bh, bh + 3)
    fn = ka.build_flash_attention(bh, s, hd, dtype,
                                  block_override=block_override, **kw)
    q, v = randn(gen, bh, s, hd, dtype=dtype), randn(gen, bh, s, hd, dtype=dtype)
    kT = randn(gen, bh, hd, s, dtype=dtype)
    bias = None
    if kw.get("bias_bh"):
        bias = randn(gen, kw["bias_bh"], s, s, scale=0.5)
    return fn, (-12345, q, kT, v, bias)


@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("hd", [8, 32, 40, 64, 72, 96, 128, 136, 192, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernel_matches_plain(gen, dtype, hd, flag):
    """Every flag at every depth; bf16 on wgmma (hd padded with zeros to
    64, 128, 192 or 256), f32 on the TMA-fed FMA kernel; the launch counted
    on the route flash_path names."""
    fn, args = _flash_case(gen, 3, 256, hd, dtype, flag)
    assert fn.path == ka.flash_path(dtype, hd) == (
        "tma_fma" if dtype == torch.float32 else "wgmma")
    routed = ka.path_launches["flash_attention_fwd"][fn.path]
    before = ka.launches["flash_attention_fwd"]
    got = fn(*args)
    assert ka.launches["flash_attention_fwd"] == before + 1
    assert ka.path_launches["flash_attention_fwd"][fn.path] == routed + 1
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
    # the override only has to tile s: bf16 at hd 64 keeps the wgmma
    # kernel's tile, f32 its own
    assert (fn.block_q, fn.block_k) == (
        (128, 128) if dtype == torch.bfloat16 else (None, None))
    got = fn(*args)
    check(fn.plain(*args).float(), got.float(), margin=TOL[dtype])


@pytest.mark.parametrize("flag", ["plain", "causal_dropout_bias", "lse"])
@pytest.mark.parametrize("hd", [40, 128, 256])
def test_flash_bf16_tile_configs(gen, hd, flag):
    """The bf16 kernel's one tile of hd's bucket (128 rows against
    128-key tiles up to hd 128, 64-key tiles past it), whatever the
    block_override."""
    for override in (None, (64, 32), (128, 128)):
        fn, args = _flash_case(gen, 2, 384, hd, torch.bfloat16, flag,
                               block_override=override)
        assert (fn.block_q, fn.block_k) == (128, 128 if hd <= 128 else 64)
        assert fn.path == ka.flash_path(torch.bfloat16, hd) == "wgmma"
        got, want = fn(*args), fn.plain(*args)
        torch.cuda.synchronize()
        if flag == "lse":
            (got, got_lse), (want, want_lse) = got, want
            check(want_lse, got_lse, margin=1e-5)
        check(want.float(), got.float(), margin=TOL[torch.bfloat16])


def test_flash_bf16_unaligned_views(gen):
    """q, kT and v 2 bytes past a 16-byte boundary: the wrapper copies them
    into fresh tensors for the kernel's 16-byte staging."""
    bh, s, hd = 2, 256, 64
    n = bh * s * hd
    q, kT, v = (randn(gen, n + 1, dtype=torch.bfloat16)[1:] for _ in range(3))
    q, v = q.view(bh, s, hd), v.view(bh, s, hd)
    kT = kT.view(bh, hd, s)
    assert q.data_ptr() % 16 == 2
    fn = ka.build_flash_attention(bh, s, hd, torch.bfloat16, causal=True)
    got = fn(0, q, kT, v)
    check(fn.plain(0, q, kT, v).float(), got.float(),
          margin=TOL[torch.bfloat16])


@pytest.mark.parametrize("flag", ["causal", "causal_dropout_bias", "lse"])
@pytest.mark.parametrize("s", [384, 640])
@pytest.mark.parametrize("hd", [64, 128, 192, 256])
def test_flash_wgmma_causal_odd_tile_counts(gen, hd, s, flag):
    """Causal at s = 384 and 640 (3 and 5 Q tiles of 128 rows): the
    diagonal crosses each warpgroup's rows, the longest tiles start
    first; past hd 128 a block's last 64-key tile lies wholly above the
    first warpgroup's rows."""
    fn, args = _flash_case(gen, 2, s, hd, torch.bfloat16, flag)
    assert fn.path == "wgmma"
    got, want = fn(*args), fn.plain(*args)
    torch.cuda.synchronize()
    if flag == "lse":
        (got, got_lse), (want, want_lse) = got, want
        check(want_lse, got_lse, margin=1e-5)
    check(want.float(), got.float(), margin=TOL[torch.bfloat16])


@pytest.mark.parametrize("hd", [64, 80, 128, 200, 256])
def test_flash_wgmma_dropout_head_map(gen, hd):
    """Dropout under a head map: the kernel draws the plain version's
    bits of the global batch-heads, not the local ones."""
    fn, args = _flash_case(gen, 3, 256, hd, torch.bfloat16,
                           "dropout_head_map")
    assert fn.path == "wgmma" and fn.head_map == (1, 2, 3, 6)
    got = fn(*args)
    check(fn.plain(*args).float(), got.float(), margin=TOL[torch.bfloat16])
    local = ka.build_flash_attention(3, 256, hd, torch.bfloat16,
                                     dropout_p=fn.dropout_p)
    torch.cuda.synchronize()
    assert not torch.equal(local(*args), got)


@pytest.mark.parametrize("flag", ["plain", "causal_dropout_bias", "bias_bh",
                                  "lse"])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_wgmma_repeats_bit_for_bit(gen, hd, flag):
    """Two calls on the same operands give the same bits: one block owns
    each output tile, and the sums run in one order."""
    fn, args = _flash_case(gen, 2, 512, hd, torch.bfloat16, flag)
    assert fn.path == "wgmma"
    a, b = fn(*args), fn(*args)
    torch.cuda.synchronize()
    for x, y in zip(a if flag == "lse" else (a,), b if flag == "lse" else (b,)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_wgmma_unaligned_views_and_bias(gen, hd):
    """q, kT, v and a per-head bias off 16-byte alignment: the wrapper
    copies them for the kernel's TMA maps and its bias pairs."""
    bh, s = 2, 256
    n = bh * s * hd
    q, kT, v = (randn(gen, n + 1, dtype=torch.bfloat16)[1:] for _ in range(3))
    q, v, kT = q.view(bh, s, hd), v.view(bh, s, hd), kT.view(bh, hd, s)
    bias = randn(gen, bh * s * s + 1, scale=0.5)[1:].view(bh, s, s)
    assert q.data_ptr() % 16 == 2 and bias.data_ptr() % 16 == 4
    fn = ka.build_flash_attention(bh, s, hd, torch.bfloat16, causal=True,
                                  bias_bh=bh)
    assert fn.path == "wgmma"
    check(fn.plain(0, q, kT, v, bias).float(), fn(0, q, kT, v, bias).float(),
          margin=TOL[torch.bfloat16])


@pytest.mark.parametrize("flag", ["plain", "causal", "dropout",
                                  "dropout_head_map", "bias1", "bias_bh",
                                  "lse"])
@pytest.mark.parametrize("bh,s,hd", [(16, 2048, 128), (96, 512, 64)])
def test_flash_wgmma_main_shapes(gen, bh, s, hd, flag):
    """The bench's serving shape and the encoder block's, every form, on
    the wgmma route (counted by route)."""
    fn, args = _flash_case(gen, bh, s, hd, torch.bfloat16, flag)
    routed = ka.path_launches["flash_attention_fwd"]["wgmma"]
    got = fn(*args)
    assert fn.path == "wgmma"
    assert ka.path_launches["flash_attention_fwd"]["wgmma"] == routed + 1
    want = fn.plain(*args)
    torch.cuda.synchronize()
    if flag == "lse":
        (got, got_lse), (want, want_lse) = got, want
        check(want_lse, got_lse, margin=1e-5)
    check(want.float(), got.float(), margin=TOL[torch.bfloat16])


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


# the tma_fma route: head dims at each bucket (64, 128, 256) and padded into
# them (8, 120); s at one 128-row tile and at the bench's 2048
TF_HDS = [8, 64, 120, 128, 256]
TF_FLAGS = FLAGS + ["dropout_head_map"]


@pytest.mark.parametrize("s", [128, 2048])
@pytest.mark.parametrize("flag", TF_FLAGS)
@pytest.mark.parametrize("hd", TF_HDS)
def test_flash_tma_fma_matches_plain(gen, hd, flag, s):
    """The TMA-fed f32 kernel at every form against its plain version; the
    launch counts its route."""
    assert not torch.backends.cuda.matmul.allow_tf32
    fn, args = _flash_case(gen, 2, s, hd, torch.float32, flag)
    assert fn.path == "tma_fma"
    before = ka.path_launches["flash_attention_fwd"]["tma_fma"]
    got = fn(*args)
    assert fn.path == "tma_fma"
    assert ka.path_launches["flash_attention_fwd"]["tma_fma"] == before + 1
    want = fn.plain(*args)
    torch.cuda.synchronize()
    if flag == "lse":
        (got, got_lse), (want, want_lse) = got, want
        assert got_lse.shape == (2, s, 128)
        check(want_lse, got_lse, margin=1e-5)
    assert got.dtype == torch.float32 and got.shape == (2, s, hd)
    assert bool(torch.isfinite(got).all())
    check(want, got, margin=TOL[torch.float32])


def test_flash_tma_fma_deterministic(gen):
    """The tma_fma kernel gives the same bits twice on the same operands."""
    fn, args = _flash_case(gen, 3, 512, 128, torch.float32,
                           "causal_dropout_bias")
    a, b = fn(*args), fn(*args)
    torch.cuda.synchronize()
    assert fn.path == "tma_fma"
    assert torch.equal(a, b)
    check(fn.plain(*args), a, margin=TOL[torch.float32])


def test_flash_f32_offset_view(gen):
    """q 4 bytes past a 16-byte boundary: TMA cannot take it, so the
    wrapper copies it first and the call runs the tma_fma kernel."""
    bh, s, hd = 2, 256, 64
    n = bh * s * hd
    q = randn(gen, n + 1)[1:].view(bh, s, hd)
    kT, v = randn(gen, bh, hd, s), randn(gen, bh, s, hd)
    assert q.data_ptr() % 16 == 4
    fn = ka.build_flash_attention(bh, s, hd, torch.float32, causal=True)
    before = dict(ka.path_launches["flash_attention_fwd"])
    got = fn(0, q, kT, v)
    after = ka.path_launches["flash_attention_fwd"]
    assert fn.path == "tma_fma"
    assert after == dict(before, tma_fma=before["tma_fma"] + 1)
    check(fn.plain(0, q, kT, v), got, margin=TOL[torch.float32])
    assert torch.equal(got, fn(0, q.clone(), kT, v))


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
