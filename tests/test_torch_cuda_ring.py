"""The batched SMM's shared-memory ring (both copy routes) and the f32
packed BRGEMM's TMA-fed FMA route on the card, against their plain versions.

Every test here needs a CUDA device and skips without one. On the GPU
machine run:

    python -m pytest tests/test_torch_cuda_ring.py --noconftest -q

(`--noconftest`: the repo's tests/conftest.py sets JAX up for the JAX
package's tests, and this file imports nothing of JAX or libxsmm_tpu.)

Tolerances (matdiff normf_rel): 1e-5 for f32 in and out (the same f32
products summed in another order), 1e-4 for bf16 in / f32 out, 5e-3 for
bf16 outputs (one bf16 rounding, matdiff.DEFAULT_MARGINS), 1e-5 for the
BRGEMM's twin.
"""

import pytest
import torch

from libxsmm_torch.descriptor import GemmDescriptor, GemmFlags, GemmShape
from libxsmm_torch.dtypes import Datatype
from libxsmm_torch.kernels import gemm as pk
from libxsmm_torch.matdiff import check

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False

F32, BF16 = Datatype.F32, Datatype.BF16
B0 = GemmFlags.BETA_0
EPILOGUES = ["NONE", "IDENTITY", "RELU", "X2", "TANH", "SIGMOID", "GELU"]
TORCH = {F32: torch.float32, BF16: torch.bfloat16}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.Generator(device="cuda").manual_seed(0)


def rand(gen, shape, dt=F32, scale=0.5):
    return (torch.randn(*shape, generator=gen, device="cuda")
            * scale).to(TORCH[dt])


def same(want, got, a_dt=F32, o_dt=F32):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.is_cuda
    check(want, got, margin=5e-3 if o_dt == BF16 else
          1e-5 if a_dt == F32 else 1e-4)


def on_route(counts, kernel, route, fn):
    """fn(), which must launch `kernel` once, on `route`."""
    before = dict(counts[kernel])
    total = pk.launches[kernel]
    out = fn()
    torch.cuda.synchronize()
    assert pk.launches[kernel] == total + 1
    assert counts[kernel] == {r: before[r] + int(r == route)
                              for r in before}
    return out


def _desc(m, n, k, a_dt=F32, o_dt=F32, beta=0):
    return GemmDescriptor(GemmShape(m, n, k, a_in_type=a_dt, b_in_type=a_dt,
                                    out_type=o_dt),
                          B0 if beta == 0 else GemmFlags.NONE)


# ---------------------------------------------------------------------------
# the batched SMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beta", [0, 1])
@pytest.mark.parametrize("a_dt,o_dt", [(F32, F32), (BF16, F32), (F32, BF16),
                                       (BF16, BF16)], ids=str)
@pytest.mark.parametrize("m,n,k", [
    (32, 32, 32), (256, 128, 128), (256, 1, 128), (1, 1, 1), (33, 31, 17),
    (13, 5, 7), (64, 128, 4), (40, 1, 128), (8, 8, 3), (9, 8, 3),
    (255, 127, 127), (100, 36, 20)])
def test_batched_routes(gen, m, n, k, a_dt, o_dt, beta):
    """Both routes at the corners: m = 256, n = 1, odd k and n (problem
    strides off 16 and off 4 bytes), bf16 in and out, beta = 1; each call
    on the route its shape takes, under every tune candidate."""
    batch = 7
    d = _desc(m, n, k, a_dt, o_dt, beta)
    args = [rand(gen, (batch, m, k), a_dt), rand(gen, (batch, k, n), a_dt)]
    if beta:
        args.append(rand(gen, (batch, m, n), o_dt))
    route = pk.batched_route(m, n, k, TORCH[a_dt])
    for cfg in pk.batched_gemm_configs(m, n, k, TORCH[a_dt]):
        fn = pk.build_batched_gemm(d, batch, cfg)
        assert fn.route == route
        same(fn.plain(*args),
             on_route(pk.path_launches, "batched_gemm", route,
                      lambda: fn(*args)), a_dt, o_dt)


@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("dt", [F32, BF16], ids=str)
def test_batched_unaligned_views(gen, offset, dt):
    """Operands that start off 16 bytes: the bulk route copies them into
    aligned tensors; the cp.async route reads them where they lie."""
    batch = 5
    for m, n, k in ((32, 32, 32), (33, 31, 17)):
        d = _desc(m, n, k, dt, F32, beta=1)
        fn = pk.build_batched_gemm(d, batch)
        views = []
        for shape, odt in (((batch, m, k), dt), ((batch, k, n), dt),
                           ((batch, m, n), F32)):
            x = rand(gen, shape, odt)
            buf = torch.zeros(x.numel() + offset, dtype=x.dtype,
                              device="cuda")
            v = buf[offset:].view(shape)
            v.copy_(x)
            assert v.data_ptr() % 16
            views.append(v)
        same(fn.plain(*views), fn(*views), dt)


@pytest.mark.parametrize("batch", [1, 2, 131, 1000])
def test_batched_grid_against_batch(gen, batch):
    """Fewer problems than blocks, one problem per block, and many problems
    per block through the ring (the ring's phases wrap many times)."""
    d = _desc(32, 32, 32)
    fn = pk.build_batched_gemm(d, batch)
    a, b = rand(gen, (batch, 32, 32)), rand(gen, (batch, 32, 32))
    same(fn.plain(a, b), fn(a, b))


def test_batched_deterministic(gen):
    for m, n, k in ((32, 32, 32), (33, 31, 17)):
        fn = pk.build_batched_gemm(_desc(m, n, k), 4096)
        a, b = rand(gen, (4096, m, k)), rand(gen, (4096, k, n))
        assert torch.equal(fn(a, b), fn(a, b))


def test_batched_refuses_a_foreign_route(gen):
    """The kernel takes the route its shape takes and no other."""
    fn = pk.build_batched_gemm(_desc(32, 32, 32), 4)
    fn.route = "cp_async"
    a, b = rand(gen, (4, 32, 32)), rand(gen, (4, 32, 32))
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        fn(a, b)


# ---------------------------------------------------------------------------
# the f32 packed BRGEMM on TMA-fed FMA tiles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step_groups", [None, 1])
@pytest.mark.parametrize("m,n,k,br,q", [
    (256, 256, 64, 64, 2), (70, 40, 32, 12, 4), (1, 4, 128, 3, 1),
    (130, 132, 64, 40, 2), (129, 260, 16, 48, 8), (33, 36, 1, 256, 128),
    (256, 256, 64, 1024, 2)])
def test_f32_brgemm_shapes(gen, m, n, k, br, q, step_groups):
    """Ragged m, n % 4 == 0 off the 128-column tile, one row, deep packs;
    the BRGEMM and its twin both on the tma_fma route."""
    d = _desc(m, n, k)
    fn = pk.build_packed_brgemm(d, br, step_groups, pack_q=q)
    sol = pk.build_packed_brgemm_sol(d, br, step_groups, pack_q=q)
    assert fn.path == sol.path == "tma_fma"
    a = rand(gen, (br // q, m, q * k))
    b = rand(gen, (br, k, n))
    same(fn.plain(a, b), on_route(pk.path_launches, "packed_brgemm",
                                  "tma_fma", lambda: fn(a, b)))
    got = on_route(pk.path_launches, "packed_brgemm_sol", "tma_fma",
                   lambda: sol(a, b))
    check(sol.plain(a, b), got, margin=1e-5)


@pytest.mark.parametrize("cp", EPILOGUES)
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("beta", [0, 1])
@pytest.mark.parametrize("o_dt", [F32, BF16], ids=str)
def test_f32_brgemm_epilogues(gen, cp, bias, beta, o_dt):
    """Every epilogue with D and C0, on a ragged tile."""
    m, n, k, br = 70, 44, 64, 20
    fn = pk.build_packed_brgemm(_desc(m, n, k, F32, o_dt, beta), br,
                                cp_type=cp, with_bias=bias)
    assert fn.path == "tma_fma"
    a, b = rand(gen, (br // 2, m, 128)), rand(gen, (br, k, n))
    c = rand(gen, (m, n)) if beta else None
    dd = rand(gen, (m, n)) if bias else None
    same(fn.plain(a, b, c, dd), fn(a, b, c, dd), F32, o_dt)


@pytest.mark.parametrize("offset", [1, 2])
@pytest.mark.parametrize("operand", ["a", "b"])
def test_f32_brgemm_unaligned(gen, offset, operand):
    """Operands off 16-byte alignment reach the TMA-fed kernel through
    aligned copies."""
    m, n, k, br = 64, 64, 64, 8
    d = _desc(m, n, k)
    fn = pk.build_packed_brgemm(d, br)
    ops = {"a": rand(gen, (br // 2, m, 128)), "b": rand(gen, (br, k, n))}
    x = ops[operand]
    buf = torch.zeros(x.numel() + offset, device="cuda")
    xu = buf[offset:].view(x.shape)
    xu.copy_(x)
    args = (xu, ops["b"]) if operand == "a" else (ops["a"], xu)
    same(fn.plain(ops["a"], ops["b"]), fn(*args))


def test_f32_brgemm_deterministic(gen):
    """The partials are added in z order: two calls agree bit for bit."""
    d = _desc(256, 256, 64)
    fn = pk.build_packed_brgemm(d, 512)
    sol = pk.build_packed_brgemm_sol(d, 512)
    a = rand(gen, (256, 256, 128))
    b = rand(gen, (512, 64, 256))
    assert torch.equal(fn(a, b), fn(a, b))
    assert torch.equal(sol(a, b), sol(a, b))
