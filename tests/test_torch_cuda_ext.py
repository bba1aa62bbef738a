"""The stochastic-rounding CUDA kernel and the GEMM-ext path on the card.

Every test here needs a CUDA device and skips without one. On the GPU
machine run:

    python -m pytest tests/test_torch_cuda_ext.py --noconftest -q

(`--noconftest`: the repo's tests/conftest.py sets JAX up for the JAX
package's tests, and this file imports nothing of JAX or libxsmm_tpu.)

Tolerances: the stochastic-rounding kernel is held to its plain version bit
for bit (the same counter-hash bits, the same integer arithmetic); the
quantizers' bytes on the card equal the same call on CPU copies; the ext
store and the xgemm classes are held to float64 at xgemm's margins
(libxsmm_torch/xgemm.py), the SR store within one bf16 ulp of the float64
accumulator plus 1e-5 of its largest magnitude (the f32 accumulator's own
rounding).
"""

import numpy as np
import pytest
import torch

import libxsmm_torch as xp
from libxsmm_torch import quant as pq
from libxsmm_torch import xgemm as PX
from libxsmm_torch.dtypes import Datatype
from libxsmm_torch.kernels import eltwise as ke
from libxsmm_torch.models import tpp_cnn as PC

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

IN_TYPES = [torch.float32, torch.bfloat16, torch.float16]
TARGETS = [Datatype.BF16, Datatype.F16, Datatype.BF8, Datatype.HF8]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.Generator(device="cuda").manual_seed(0)


def randn(gen, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(
        dtype)


def wild(gen, n):
    """Values of every class: normal at many scales, the targets' subnormal
    ranges, past the f8 maxima, and NaN/Inf bit patterns."""
    x = randn(gen, n) * torch.exp2(torch.randint(
        -30, 30, (n,), generator=gen, device="cuda").float())
    bits = torch.tensor(np.asarray(
        [0x7F800001, 0xFF800001, 0x7FC00000, 0x7F800000, 0xFF800000,
         0x00000001, 0x80000000, 0x47700000, 0x43E80000, 0x43E80001,
         0x477FF000, 0x38000001], np.uint32).view(np.int32),
        device="cuda").view(torch.float32)
    return torch.cat([x, bits, torch.linspace(-600, 600, 999,
                                              device="cuda")])


@pytest.mark.parametrize("target", TARGETS, ids=lambda t: t.value)
@pytest.mark.parametrize("in_dtype", IN_TYPES,
                         ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("shape", [(4096, 768), (37, 53), (3, 5, 129),
                                   (1,), (0, 8)])
def test_sr_kernel_bit_exact(gen, target, in_dtype, shape):
    x = randn(gen, *shape, dtype=in_dtype, scale=3.0)
    before = ke.launches["stochastic_round"]
    y = ke.stochastic_round(x, 1234567, target)
    assert ke.launches["stochastic_round"] == before + (x.numel() > 0)
    want = ke.stochastic_round.plain(x, 1234567, target)
    torch.cuda.synchronize()
    assert y.dtype == want.dtype and y.shape == x.shape and y.is_cuda
    assert torch.equal(y.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.parametrize("target", TARGETS, ids=lambda t: t.value)
def test_sr_kernel_every_value_class(gen, target):
    x = wild(gen, 100003)
    y = ke.stochastic_round(x, -5, target)
    want = ke.stochastic_round.plain(x, -5, target)
    torch.cuda.synchronize()
    assert torch.equal(y.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.parametrize("target", TARGETS, ids=lambda t: t.value)
@pytest.mark.parametrize("in_dtype", IN_TYPES,
                         ids=["f32", "bf16", "f16"])
def test_sr_kernel_unaligned_view(gen, target, in_dtype):
    base = randn(gen, 4099, dtype=in_dtype)
    x = base[3:]                      # not 16-byte aligned
    assert x.data_ptr() % 16
    y = ke.stochastic_round(x, 11, target)
    want = ke.stochastic_round.plain(x, 11, target)
    torch.cuda.synchronize()
    assert torch.equal(y.view(torch.uint8), want.view(torch.uint8))
    # a strided view is made contiguous first
    xs = randn(gen, 64, 80, dtype=in_dtype)[:, ::2]
    assert torch.equal(ke.stochastic_round(xs, 3, target).view(torch.uint8),
                       ke.stochastic_round.plain(xs, 3, target).view(
                           torch.uint8))


def test_sr_kernel_statistics_and_refusals(gen):
    x = torch.full((4096, 1024), 1.0 + 2 ** -9, device="cuda")
    y = ke.stochastic_round(x, 9, Datatype.BF16).float()
    up = (y > 1.0).float().mean().item()
    assert abs(up - 0.25) < 4 * (0.25 * 0.75 / x.numel()) ** 0.5
    assert set(torch.unique(y).tolist()) <= {1.0, 1.0078125}
    with pytest.raises(ValueError, match="no CUDA kernel"):
        ke.stochastic_round(x.double(), 0, Datatype.BF16)
    with pytest.raises(ValueError, match="stochastic rounding targets"):
        ke.stochastic_round(x, 0, Datatype.F32)


def test_sr_entry_points_on_card(gen):
    x = randn(gen, 512, 768)
    before = ke.launches["stochastic_round"]
    kern = xp.dispatch_meltw_unary(xp.UnaryType.STOCHASTIC_ROUND, 512, 768,
                                   out_type=Datatype.HF8)
    a = kern(x, 3)
    b = pq.stochastic_convert_fp32_bf16(x, 3)
    c = pq.stochastic_convert_fp32_bf8(x, 3)
    assert ke.launches["stochastic_round"] == before + 3
    for got, dt in ((a, Datatype.HF8), (b, Datatype.BF16),
                    (c, Datatype.BF8)):
        assert torch.equal(got.view(torch.uint8), ke.stochastic_round.plain(
            x, 3, dt).view(torch.uint8))


@pytest.mark.parametrize("fmt", ["mxfp4", "nvfp4", "mxbf8"])
def test_mx_quant_bytes_match_cpu(gen, fmt):
    x = randn(gen, 256, 512, scale=4.0)
    p, s = getattr(pq, f"{fmt}_quantize_blocks")(x)
    pc, sc = getattr(pq, f"{fmt}_quantize_blocks")(x.cpu())
    assert p.is_cuda
    assert torch.equal(p.view(torch.uint8).cpu(), pc.view(torch.uint8))
    assert torch.equal(s.cpu(), sc)
    d = getattr(pq, f"{fmt}_dequantize_blocks")(p, s)
    dc = getattr(pq, f"{fmt}_dequantize_blocks")(pc, sc)
    assert torch.equal(d.cpu(), dc)


@pytest.mark.parametrize("vnni_c", [False, True])
def test_ext_sr_store_on_card(gen, vnni_c):
    m, n, k, br = 256, 192, 64, 4
    flags = xp.GemmFlags.BETA_0 | (xp.GemmFlags.VNNI_C if vnni_c else 0)
    kern = xp.dispatch_brgemm_ext(
        xp.GemmShape(m, n, k, out_type=Datatype.BF16), flags,
        xp.BatchReduceConfig(xp.BatchReduceType.STRIDE, br),
        argops=xp.UnaryArgops(cp_type=xp.UnaryType.STOCHASTIC_ROUND),
        postops=xp.BinaryPostops(d_type=xp.BinaryType.ADD))
    a, b, d = randn(gen, br, m, k), randn(gen, br, k, n), randn(gen, 1, n)
    before = ke.launches["stochastic_round"]
    out = kern(a, b, d, seed=5)
    assert ke.launches["stochastic_round"] == before + 1
    acc = torch.einsum("bmk,bkn->mn", a.double(), b.double()) + d.double()
    got = out.double()
    if vnni_c:
        got = got.reshape(m // 2, n, 2).transpose(1, 2).reshape(m, n)
    # one bf16 ulp of the float64 accumulator, plus the f32 accumulator's
    # own rounding (1e-5 of the largest magnitude)
    ulp = torch.exp2(torch.floor(torch.log2(acc.abs() + 1e-30)) - 7)
    assert bool(((got - acc).abs()
                 <= ulp + 1e-5 * acc.abs().max()).all())


@pytest.mark.parametrize("idx", [i for i, c in enumerate(
    PX.build_class_list()) if c["kind"] in ("packed", "ext", "ext_packed")])
def test_xgemm_classes_on_card(gen, idx):
    cls = PX.build_class_list()[idx]
    ok, label, err = PX.run_class(cls, np.random.default_rng(idx), "cuda")
    assert ok, f"{label}: normf_rel {err}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_conv2d_kernel_on_card(gen, dtype):
    x = randn(gen, 4, 20, 20, 32, dtype=dtype)
    w = randn(gen, 3, 3, 32, 48, dtype=dtype, scale=1 / 17)
    b = randn(gen, 48, dtype=dtype)
    fn = PC.conv2d_kernel(tuple(x.shape), tuple(w.shape), 1, True, True,
                          dtype)
    got = fn(x, w, b)
    want = PC.conv2d_tpp(x.double(), w.double(), b.double(), 1, "relu")
    tol = 1e-5 if dtype == torch.float32 else 5e-3
    assert got.dtype == dtype and got.shape == (4, 18, 18, 48)
    err = ((got.double() - want).norm() / want.norm()).item()
    assert err < tol
