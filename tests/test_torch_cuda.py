"""The hand-written CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one. On the GPU
machine run:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(`--noconftest`: the repo's tests/conftest.py sets JAX up for the JAX
package's tests, and this file imports nothing of JAX or libxsmm_tpu.)

Tolerances (matdiff normf_rel): 1e-5 for f32 in and out and 1e-4 for bf16
in / f32 out (the sums run in another order than the plain version's);
5e-3 for bf16 outputs (one bf16 rounding, matdiff.DEFAULT_MARGINS);
bit-exact for int8 -> int32.
"""

import pytest
import torch

import libxsmm_torch as xp
from libxsmm_torch.descriptor import (BatchReduceConfig, BatchReduceType,
                                      BinaryPostops, BinaryType,
                                      GemmDescriptor, GemmFlags, GemmShape,
                                      UnaryArgops, UnaryType)
from libxsmm_torch.dtypes import Datatype
from libxsmm_torch.kernels import gemm as pk
from libxsmm_torch.matdiff import check

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F32, BF16, I8, I32 = Datatype.F32, Datatype.BF16, Datatype.I8, Datatype.I32
B0 = GemmFlags.BETA_0
EPILOGUES = ["NONE", "IDENTITY", "RELU", "X2", "TANH", "SIGMOID", "GELU"]
TORCH = {F32: torch.float32, BF16: torch.bfloat16, I8: torch.int8,
         I32: torch.int32}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.Generator(device="cuda").manual_seed(0)


def rand(gen, shape, dt=F32, scale=0.5):
    if dt == I8:
        return torch.randint(-128, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)
    if dt == I32:
        return torch.randint(-2 ** 20, 2 ** 20, shape, generator=gen,
                             device="cuda", dtype=torch.int32)
    x = torch.randn(*shape, generator=gen, device="cuda") * scale
    return x.to(TORCH[dt])


def same(want, got, a_dt=F32, o_dt=F32):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.is_cuda
    if o_dt == I32:
        assert torch.equal(want, got)
    else:
        check(want, got, margin=5e-3 if o_dt == BF16 else
              1e-5 if a_dt == F32 else 1e-4)


def launched(kernel, fn):
    before = pk.launches[kernel]
    out = fn()
    assert pk.launches[kernel] == before + 1
    return out


# ---------------------------------------------------------------------------
# packed batched SMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("m", [1, 5, 33])
def test_packed_smm_shapes(gen, n, m):
    g = 3
    d = GemmDescriptor(GemmShape(m, n, n), B0)
    fn = pk.build_packed_batched_gemm(d, g)
    a, b = rand(gen, (g, m, 128)), rand(gen, (g, n, 128))
    same(fn.plain(a, b), launched("packed_batched_gemm", lambda: fn(a, b)))


@pytest.mark.parametrize("cp", EPILOGUES)
@pytest.mark.parametrize("a_dt,o_dt", [(F32, F32), (F32, BF16), (BF16, F32),
                                       (BF16, BF16)], ids=str)
@pytest.mark.parametrize("beta", [0, 1])
def test_packed_smm_epilogues(gen, cp, a_dt, o_dt, beta):
    g, m, n = 5, 40, 32
    d = GemmDescriptor(GemmShape(m, n, n, a_in_type=a_dt, b_in_type=a_dt,
                                 out_type=o_dt), B0 if beta == 0 else
                       GemmFlags.NONE)
    fn = pk.build_packed_batched_gemm(d, g, cp)
    args = [rand(gen, (g, m, 128), a_dt), rand(gen, (g, n, 128), a_dt)]
    if beta:
        args.append(rand(gen, (g, m, 128), o_dt))
    same(fn.plain(*args), fn(*args), a_dt, o_dt)


@pytest.mark.parametrize("cp", ["NONE", "RELU", "X2"])
@pytest.mark.parametrize("beta", [0, 1])
def test_packed_smm_int8_wraps(gen, cp, beta):
    # full-range int8: X2 of the int32 sum overflows and must wrap
    g, m, n = 4, 32, 32
    d = GemmDescriptor(GemmShape(m, n, n, a_in_type=I8, b_in_type=I8,
                                 out_type=I32),
                       B0 if beta == 0 else GemmFlags.NONE)
    fn = pk.build_packed_batched_gemm(d, g, cp)
    args = [rand(gen, (g, m, 128), I8), rand(gen, (g, n, 128), I8)]
    if beta:
        args.append(rand(gen, (g, m, 128), I32))
    same(fn.plain(*args), fn(*args), I8, I32)


@pytest.mark.parametrize("rpt", pk.packed_smm_configs(32))
def test_packed_smm_launch_configs(gen, rpt):
    d = GemmDescriptor(GemmShape(50, 16, 16), B0)
    fn = pk.build_packed_batched_gemm(d, 9, rpt=rpt)
    a, b = rand(gen, (9, 50, 128)), rand(gen, (9, 16, 128))
    same(fn.plain(a, b), fn(a, b))


def test_packed_smm_refuses_on_cuda(gen):
    d = GemmDescriptor(GemmShape(8, 32, 32, out_type=Datatype.F16), B0)
    fn = pk.build_packed_batched_gemm(d, 2)
    a, b = rand(gen, (2, 8, 128)), rand(gen, (2, 32, 128))
    with pytest.raises(ValueError, match="no CUDA kernel"):
        fn(a, b)
    assert fn.plain(a, b).dtype == torch.float16   # the plain version has it
    fn32 = pk.build_packed_batched_gemm(
        GemmDescriptor(GemmShape(8, 32, 32), B0), 2)
    with pytest.raises(ValueError, match="different devices"):
        fn32(a, b.cpu())
    with pytest.raises(ValueError, match="aligned"):
        fn32(torch.empty(2 * 8 * 128 + 1, device="cuda")[1:].view(2, 8, 128),
             b)


# ---------------------------------------------------------------------------
# unpacked batched SMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,k", [(1, 1, 1), (13, 5, 7), (32, 32, 32),
                                   (256, 128, 128), (64, 48, 16),
                                   (200, 100, 3)])
@pytest.mark.parametrize("a_dt,o_dt", [(F32, F32), (BF16, F32), (F32, BF16),
                                       (BF16, BF16)], ids=str)
@pytest.mark.parametrize("beta", [0, 1])
def test_batched_gemm(gen, m, n, k, a_dt, o_dt, beta):
    batch = 6
    d = GemmDescriptor(GemmShape(m, n, k, a_in_type=a_dt, b_in_type=a_dt,
                                 out_type=o_dt),
                       B0 if beta == 0 else GemmFlags.NONE)
    args = [rand(gen, (batch, m, k), a_dt), rand(gen, (batch, k, n), a_dt)]
    if beta:
        args.append(rand(gen, (batch, m, n), o_dt))
    for cfg in pk.batched_gemm_configs(m, n, k, TORCH[a_dt]):
        fn = pk.build_batched_gemm(d, batch, cfg)
        same(fn.plain(*args), launched("batched_gemm", lambda: fn(*args)),
             a_dt, o_dt)


# ---------------------------------------------------------------------------
# packed BRGEMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,k,br,q", [(256, 256, 64, 64, 2),
                                        (70, 40, 32, 12, 4),
                                        (1, 1, 128, 3, 1), (33, 65, 1, 256,
                                                            128),
                                        (16, 32, 64, 16, 8),
                                        (1, 136, 16, 24, 8),
                                        (130, 8, 128, 4, 1),
                                        (129, 264, 64, 40, 4)])
@pytest.mark.parametrize("step_groups", [None, 1, 5])
@pytest.mark.parametrize("a_dt", [F32, BF16], ids=str)
def test_packed_brgemm_shapes(gen, m, n, k, br, q, step_groups, a_dt):
    """Both routes: bf16 with n % 8 == 0 on the tensor cores, the rest on
    the FMA kernel (ragged m and n, one-column and one-row outputs, a
    ragged last K chunk at step_groups 5)."""
    d = GemmDescriptor(GemmShape(m, n, k, a_in_type=a_dt, b_in_type=a_dt),
                       B0)
    fn = pk.build_packed_brgemm(d, br, step_groups, pack_q=q)
    a = rand(gen, (br // q, m, q * k), a_dt)
    b = rand(gen, (br, k, n), a_dt)
    before = pk.path_launches["packed_brgemm"][fn.path]
    same(fn.plain(a, b), launched("packed_brgemm", lambda: fn(a, b)), a_dt)
    assert pk.path_launches["packed_brgemm"][fn.path] == before + 1


@pytest.mark.parametrize("a_dt,n,want", [(BF16, 256, "wgmma"),
                                         (BF16, 8, "wgmma"),
                                         (BF16, 40, "wgmma"),
                                         (BF16, 36, "fma"), (BF16, 1, "fma"),
                                         (F32, 256, "tma_fma"),
                                         (F32, 4, "tma_fma"),
                                         (F32, 6, "fma")], ids=str)
def test_packed_brgemm_path_launches(gen, a_dt, n, want):
    """bf16 with n % 8 == 0 launches the tensor-core kernel, f32 with n % 4
    == 0 the TMA-fed FMA kernel, the rest the FMA kernel, and only it; the
    twin follows the same route."""
    m, k, br = 64, 64, 8
    d = GemmDescriptor(GemmShape(m, n, k, a_in_type=a_dt, b_in_type=a_dt),
                       B0)
    fn = pk.build_packed_brgemm(d, br)
    sol = pk.build_packed_brgemm_sol(d, br)
    assert fn.path == sol.path == want
    a = rand(gen, (br // 2, m, 128), a_dt)
    b = rand(gen, (br, k, n), a_dt)
    pk.reset_launches()
    same(fn.plain(a, b), fn(a, b), a_dt)
    check(sol.plain(a, b), sol(a, b), margin=1e-5)
    torch.cuda.synchronize()
    for name in ("packed_brgemm", "packed_brgemm_sol"):
        assert pk.path_launches[name] == {
            path: int(path == want) for path in ("wgmma", "tma_fma", "fma")}
        assert pk.launches[name] == 1


@pytest.mark.parametrize("groups,step_groups,splits", [
    (1, None, 2), (1, 1, 1), (6, 6, 1), (6, 50, 1)])
def test_packed_brgemm_one_split(gen, groups, step_groups, splits):
    """A K of a single group (two 64-deep slices, one block each or one
    block for both), and step_groups covering every group (or more): one
    block along K."""
    m, n, k, q = 100, 72, 64, 2
    d = GemmDescriptor(GemmShape(m, n, k, a_in_type=BF16, b_in_type=BF16),
                       B0)
    fn = pk.build_packed_brgemm(d, groups * q, step_groups)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert fn.splits(sms)[1] == splits
    a = rand(gen, (groups, m, q * k), BF16)
    b = rand(gen, (groups * q, k, n), BF16)
    same(fn.plain(a, b), launched("packed_brgemm", lambda: fn(a, b)), BF16)


@pytest.mark.parametrize("offset", [1, 4])        # 2 and 8 bytes off
@pytest.mark.parametrize("operand", ["a", "b"])
def test_packed_brgemm_unaligned(gen, offset, operand):
    """Operands off 16-byte alignment reach the tensor-core kernel through
    aligned copies (TMA needs a 16-byte aligned base)."""
    m, n, k, br = 64, 64, 64, 8
    d = GemmDescriptor(GemmShape(m, n, k, a_in_type=BF16, b_in_type=BF16),
                       B0)
    fn = pk.build_packed_brgemm(d, br)
    sol = pk.build_packed_brgemm_sol(d, br)
    ops = {"a": rand(gen, (br // 2, m, 128), BF16),
           "b": rand(gen, (br, k, n), BF16)}
    x = ops[operand]
    buf = torch.zeros(x.numel() + offset, dtype=x.dtype, device="cuda")
    xu = buf[offset:].view(x.shape)
    xu.copy_(x)
    assert xu.data_ptr() % 16
    args = (xu, ops["b"]) if operand == "a" else (ops["a"], xu)
    same(fn.plain(ops["a"], ops["b"]),
         launched("packed_brgemm", lambda: fn(*args)), BF16)
    check(sol.plain(ops["a"], ops["b"]), sol(*args), margin=1e-5)


@pytest.mark.parametrize("cp", EPILOGUES)
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("beta", [0, 1])
@pytest.mark.parametrize("a_dt,o_dt", [(BF16, F32), (F32, BF16),
                                       (BF16, BF16)], ids=str)
def test_packed_brgemm_epilogues(gen, cp, bias, beta, a_dt, o_dt):
    m, n, k, br = 48, 80, 64, 20
    d = GemmDescriptor(GemmShape(m, n, k, a_in_type=a_dt, b_in_type=a_dt,
                                 out_type=o_dt),
                       B0 if beta == 0 else GemmFlags.NONE)
    fn = pk.build_packed_brgemm(d, br, cp_type=cp, with_bias=bias)
    a, b = rand(gen, (br // 2, m, 128), a_dt), rand(gen, (br, k, n), a_dt)
    c = rand(gen, (m, n)) if beta else None
    dd = rand(gen, (m, n)) if bias else None
    same(fn.plain(a, b, c, dd), fn(a, b, c, dd), a_dt, o_dt)


def test_packed_brgemm_deterministic(gen):
    d = GemmDescriptor(GemmShape(256, 256, 64, a_in_type=BF16,
                                 b_in_type=BF16), B0)
    fn = pk.build_packed_brgemm(d, 512)
    assert fn.path == "wgmma"
    a = rand(gen, (256, 256, 128), BF16)
    b = rand(gen, (512, 64, 256), BF16)
    assert torch.equal(fn(a, b), fn(a, b))


# ---------------------------------------------------------------------------
# the public entry points on the card
# ---------------------------------------------------------------------------

def test_entry_points_launch_kernels_and_train(gen):
    m = n = k = 32
    p = xp.smm_pack_factor(GemmShape(m, n, k))
    a = rand(gen, (64, m, k)).requires_grad_()
    b = rand(gen, (64, k, n)).requires_grad_()
    kern = xp.dispatch_gemm_batched_packed(GemmShape(m, n, k), B0)
    ap, bp = xp.pack_batched(a, p), xp.pack_batched(b, p)
    out = launched("packed_batched_gemm", lambda: kern(ap, bp))
    (xp.unpack_batched(out, p) ** 2).sum().backward()
    a0, b0 = a.detach().requires_grad_(), b.detach().requires_grad_()
    (torch.matmul(a0, b0) ** 2).sum().backward()
    check(a0.grad, a.grad, margin=1e-5)
    check(b0.grad, b.grad, margin=1e-5)

    kb = xp.dispatch_gemm_batched(GemmShape(m, n, k), B0, tune=True)
    x, y = rand(gen, (64, m, k)), rand(gen, (64, k, n))
    same(torch.matmul(x, y), kb(x, y))
    kt = xp.dispatch_gemm_batched_packed(GemmShape(m, n, k), B0, tune=True)
    same(xp.unpack_batched(kern(xp.pack_batched(x, p), xp.pack_batched(y, p)),
                           p),
         xp.unpack_batched(kt(xp.pack_batched(x, p), xp.pack_batched(y, p)),
                           p))

    br = 16
    shape = GemmShape(64, 64, 64, a_in_type=BF16, b_in_type=BF16)
    cfg = BatchReduceConfig(BatchReduceType.STRIDE, br)
    a3 = rand(gen, (br, 64, 64), BF16)
    b3 = rand(gen, (br, 64, 64), BF16)
    kx = xp.dispatch_brgemm_ext_packed(
        shape, B0, cfg, argops=UnaryArgops(cp_type=UnaryType.RELU),
        postops=BinaryPostops(d_type=BinaryType.ADD))
    bias = rand(gen, (1, 64))
    got = launched("packed_brgemm",
                   lambda: kx(xp.pack_batched(a3, 2), b3, d_op=bias))
    want = (torch.einsum("bmk,bkn->mn", a3.float(), b3.float())
            + bias).clamp_min(0.0)
    same(want, got, BF16, F32)
    z = xp.dispatch_gemm_batched_packed(GemmShape(m, n, k), B0)(
        torch.zeros((0, m, 128), device="cuda"),
        torch.zeros((0, k, 128), device="cuda"))
    assert z.shape == (0, m, 128) and z.is_cuda
