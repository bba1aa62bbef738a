"""The flash-attention backward kernels and the training path on the card,
against their plain versions.

Every test here needs a CUDA device and skips without one. On the GPU
machine run:

    python -m pytest tests/test_torch_cuda_train.py --noconftest -q

(`--noconftest`: the repo's tests/conftest.py sets JAX up for the JAX
package's tests, and this file imports nothing of JAX or libxsmm_tpu.)

Tolerances (matdiff normf_rel, kernel against plain on the same inputs):
1e-4 for f32 outputs (dS = p * (dP - delta) cancels, so the products'
summation order shows more than in the forward); 1e-2 for bf16 outputs and
for dbias from bf16 inputs (p~ and dS are rounded to bf16 against scores
that differ in the last f32 bits, then the outputs are rounded to bf16).
bf16 runs the wgmma kernels (route "wgmma": the 128-key plan up to hd
128, the wide kernels past it), f32 the TMA-fed FMA ones (route
"tma_fma"); the tests set and assert TF32 off.
"""

import pytest
import torch

import libxsmm_torch as xp
from libxsmm_torch.dtypes import Datatype
from libxsmm_torch.kernels import attention as ka
from libxsmm_torch.matdiff import check
from libxsmm_torch.models import tpp_attention as ta
from libxsmm_torch.models import tpp_mlp as tm

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
FLAGS = ["plain", "causal", "dropout", "bias_bh_grad", "bias1",
         "causal_dropout_bias_grad"]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.Generator(device="cuda").manual_seed(0)


def randn(gen, *shape, dtype=torch.float32, scale=1.0):
    x = torch.randn(*shape, generator=gen, device="cuda") * scale
    return x.to(dtype)


def _bwd_case(gen, bh, s, hd, dtype, flag, block_override=None):
    """A backward kernel and its operands: lse and delta from the forward's
    plain version on the same inputs."""
    kw = {}
    if "causal" in flag:
        kw["causal"] = True
    if "dropout" in flag:
        kw["dropout_p"] = 0.2
    if flag == "bias1":
        kw["bias_bh"] = 1
    if "bias_grad" in flag:
        kw["bias_bh"] = bh
    if "head_map" in flag:
        kw["head_map"] = (1, 2, bh, bh + 3)
    q, v = randn(gen, bh, s, hd, dtype=dtype), randn(gen, bh, s, hd, dtype=dtype)
    kT = randn(gen, bh, hd, s, dtype=dtype)
    dout = randn(gen, bh, s, hd, dtype=dtype)
    bias = randn(gen, kw["bias_bh"], s, s, scale=0.5) if kw.get("bias_bh") \
        else None
    seed = -12345
    out, lse = ka.build_flash_attention(bh, s, hd, dtype, return_lse=True,
                                        **kw).plain(seed, q, kT, v, bias)
    delta = (dout.float() * out.float()).sum(-1, keepdim=True).expand(
        bh, s, 128)
    fn = ka.build_flash_attention_bwd(bh, s, hd, dtype,
                                      bias_grad="bias_grad" in flag,
                                      block_override=block_override, **kw)
    return fn, (seed, q, kT, v, dout, lse, delta, bias)


def _same(got, want, dtype):
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype and g.is_cuda, i
        assert bool(torch.isfinite(g.float()).all()), i
        check(w.float(), g.float(), margin=TOL[dtype])


@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_bwd_kernels_match_plain(gen, dtype, hd, flag):
    fn, args = _bwd_case(gen, 3, 256, hd, dtype, flag)
    assert fn.path == ka.flash_bwd_path(dtype, hd) == (
        "tma_fma" if dtype == torch.float32 else "wgmma")
    before = dict(ka.launches)
    routes = {k: dict(v) for k, v in ka.path_launches.items()}
    got = fn(*args)
    for k in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        assert ka.path_launches[k][fn.path] == routes[k][fn.path] + 1
    assert ka.launches["flash_attention_bwd_dkv"] == \
        before["flash_attention_bwd_dkv"] + 1
    assert ka.launches["flash_attention_bwd_dq"] == \
        before["flash_attention_bwd_dq"] + 1
    want = fn.plain(*args)
    assert len(got) == (4 if "bias_grad" in flag else 3)
    _same(got, want, dtype)


@pytest.mark.parametrize("config", [(64, 64), (64, 32)])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("flag", ["plain", "causal_dropout_bias_grad"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_bwd_tile_configs(gen, dtype, flag, hd, config):
    fn, args = _bwd_case(gen, 2, 384, hd, dtype, flag,
                         block_override=config)
    # an override only has to tile s on the wgmma (bf16) and tma_fma (f32)
    # routes: each kernel keeps its tile (64 keys past hd 128)
    want = ((None,) * 3 if dtype == torch.float32 else (64, 128, 128)
            if hd <= 128 else (64, 64, 64))
    assert (fn.block_q, fn.block_k, fn.block_k_dq) == want
    _same(fn(*args), fn.plain(*args), dtype)


def test_bwd_kernels_one_at_a_time(gen):
    fn, args = _bwd_case(gen, 2, 256, 64, torch.bfloat16, "causal")
    dkT, dv = fn.dkv(*args)
    dq = fn.dq(*args)
    _same((dq, dkT, dv), fn.plain(*args), torch.bfloat16)


def test_bwd_deterministic(gen):
    fn, args = _bwd_case(gen, 2, 256, 64, torch.float32,
                         "causal_dropout_bias_grad")
    a, b = fn(*args), fn(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_bwd_causal_dbias_zero_above_diagonal(gen):
    fn, args = _bwd_case(gen, 2, 512, 64, torch.float32,
                         "causal_dropout_bias_grad", block_override=(64, 32))
    dbias = fn(*args)[3]
    torch.cuda.synchronize()
    upper = torch.ones(512, 512, dtype=torch.bool, device="cuda").triu(1)
    assert bool((dbias[:, upper] == 0).all())


# the tma_fma route: head dims at each bucket (64, 128, 256) and padded into
# them (8, 120); s at one 128-row tile and at the bench's 2048
TF_HDS = [8, 64, 120, 128, 256]
TF_FLAGS = ["plain", "causal", "dropout", "dropout_head_map", "bias_bh_grad",
            "bias1", "causal_dropout_bias_grad"]


@pytest.mark.parametrize("s", [128, 2048])
@pytest.mark.parametrize("flag", TF_FLAGS)
@pytest.mark.parametrize("hd", TF_HDS)
def test_bwd_tma_fma_matches_plain(gen, hd, flag, s):
    """The TMA-fed f32 dK/dV and dQ kernels at every form against their
    plain versions; the launch counts their route."""
    assert not torch.backends.cuda.matmul.allow_tf32
    fn, args = _bwd_case(gen, 2, s, hd, torch.float32, flag)
    assert fn.path == "tma_fma"
    before = {k: ka.path_launches[k]["tma_fma"] for k in ka.path_launches}
    got = fn(*args)
    assert fn.path == "tma_fma"
    for k in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        assert ka.path_launches[k]["tma_fma"] == before[k] + 1
    assert len(got) == (4 if "bias_grad" in flag else 3)
    _same(got, fn.plain(*args), torch.float32)
    if "causal" in flag and "bias_grad" in flag:
        upper = torch.ones(s, s, dtype=torch.bool, device="cuda").triu(1)
        assert bool((got[3][:, upper] == 0).all())


def test_bwd_tma_fma_deterministic(gen):
    """The tma_fma kernels give the same bits twice on the same operands."""
    fn, args = _bwd_case(gen, 3, 512, 128, torch.float32,
                         "causal_dropout_bias_grad")
    a, b = fn(*args), fn(*args)
    torch.cuda.synchronize()
    assert fn.path == "tma_fma"
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    _same(a, fn.plain(*args), torch.float32)


def test_bwd_f32_offset_view(gen):
    """dout 4 bytes past a 16-byte boundary: TMA cannot take it, so the
    wrapper copies it first and both kernels run on tma_fma."""
    fn, args = _bwd_case(gen, 2, 256, 64, torch.float32, "causal")
    dout = args[4]
    off = torch.empty(dout.numel() + 1, device="cuda")[1:].view(dout.shape)
    off.copy_(dout)
    assert off.data_ptr() % 16 == 4
    args = args[:4] + (off,) + args[5:]
    before = {k: dict(v) for k, v in ka.path_launches.items()}
    got = fn(*args)
    assert fn.path == "tma_fma"
    for k in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        assert ka.path_launches[k] == dict(before[k], tma_fma=before[k][
            "tma_fma"] + 1)
    _same(got, fn.plain(*args), torch.float32)


# bf16 head dims past 128, the wide wgmma kernels': both buckets (192,
# 256) and head dims zero-padded into them
BUCKET_HDS = [136, 160, 192, 200, 232, 256]


def _wide(fn):
    """The wide wgmma plan: dK/dV blocks of 64 keys, dQ 64-key units."""
    return (fn.path == "wgmma" and fn.block_k == fn.block_k_dq == 64
            and fn.kernels == {"dkv": "flash_bwd_dkv_wgmma_wide_kernel",
                               "dq": "flash_bwd_dq_wgmma_wide_kernel"})


@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("hd", BUCKET_HDS)
def test_bwd_mma_every_bucket(gen, hd, flag):
    """The wide wgmma dK/dV and dQ kernels at every bucket they take and
    every form, against their plain versions; the launches count their
    route and their kernels."""
    fn, args = _bwd_case(gen, 2, 256, hd, torch.bfloat16, flag)
    assert _wide(fn)
    before = {k: dict(v) for k, v in ka.path_launches.items()}
    kernels = dict(ka.kernel_launches)
    got = fn(*args)
    for k in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        assert ka.path_launches[k] == dict(before[k], wgmma=before[k][
            "wgmma"] + 1)
    assert ka.kernel_launches == dict(
        kernels, **{n: kernels[n] + 1 for n in fn.kernels.values()})
    _same(got, fn.plain(*args), torch.bfloat16)


@pytest.mark.parametrize("config", [None, (64, 32)])
@pytest.mark.parametrize("s", [384, 640])
@pytest.mark.parametrize("hd", [192, 256])
def test_bwd_mma_causal_odd_tile_counts(gen, hd, s, config):
    """Causal at s = 384 and 640 (3 and 5 dQ blocks of 128 rows, 6 and 10
    dK/dV blocks of 64 keys), with dbias, by default and under a small
    override (the wide kernels keep their tile): the diagonal crosses the
    tiles, and dbias is zero wherever the key follows the query."""
    fn, args = _bwd_case(gen, 2, s, hd, torch.bfloat16,
                         "causal_dropout_bias_grad", block_override=config)
    assert _wide(fn)
    got = fn(*args)
    _same(got, fn.plain(*args), torch.bfloat16)
    upper = torch.ones(s, s, dtype=torch.bool, device="cuda").triu(1)
    assert bool((got[3][:, upper] == 0).all())


@pytest.mark.parametrize("hd", [136, 192, 256])
def test_bwd_mma_dropout_each_gradient(gen, hd):
    """Dropout: dQ, dK^T and dV each against the plain version's, whose
    mask is the position hash of (query row i, key column j). The dK/dV
    kernel's fragments hold keys as rows, so a swapped (i, j) there would
    show in dK^T and dV even where dQ agrees."""
    fn, args = _bwd_case(gen, 2, 256, hd, torch.bfloat16, "dropout")
    assert _wide(fn)
    _each_gradient(fn, args)


def _each_gradient(fn, args):
    want = fn.plain(*args)
    dkv = fn.dkv(*args)    # dkT, dv (and dbias)
    dq = fn.dq(*args)
    torch.cuda.synchronize()
    assert len(dkv) + 1 == len(want)
    for g, w in zip((dq,) + tuple(dkv), want):
        assert g.shape == w.shape and g.dtype == w.dtype
        check(w.float(), g.float(), margin=TOL[torch.bfloat16])


@pytest.mark.parametrize("flag", ["bias1", "bias_bh_grad"])
@pytest.mark.parametrize("hd", [200, 256])
def test_bwd_mma_bias(gen, hd, flag):
    """Broadcast bias (bias_bh 1) and a per-head bias with dbias."""
    fn, args = _bwd_case(gen, 3, 256, hd, torch.bfloat16, flag)
    assert _wide(fn)
    _same(fn(*args), fn.plain(*args), torch.bfloat16)


def test_bwd_mma_unaligned_views(gen):
    """q, kT, v and dout 2-14 bytes past a 16-byte boundary, lse and delta
    4 bytes past one: the wrapper copies them for the 16-byte staging."""
    fn, args = _bwd_case(gen, 2, 256, 200, torch.bfloat16, "causal")
    assert _wide(fn)
    _unaligned(fn, args)


def _unaligned(fn, args):
    seed, rest = args[0], args[1:7]

    def shifted(t, elems):
        store = torch.empty(t.numel() + elems, dtype=t.dtype, device="cuda")
        view = store[elems:].view(t.shape)
        view.copy_(t)
        return view

    moved = [shifted(t, e) for t, e in zip(rest, (1, 3, 5, 7))]
    moved += [shifted(t.contiguous(), 1) for t in rest[4:]]
    assert [t.data_ptr() % 16 for t in moved] == [2, 6, 10, 14, 4, 4]
    _same(fn(seed, *moved), fn.plain(*args), torch.bfloat16)


def test_bwd_mma_deterministic(gen):
    fn, args = _bwd_case(gen, 2, 256, 256, torch.bfloat16,
                         "causal_dropout_bias_grad")
    assert _wide(fn)
    a, b = fn(*args), fn(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# the wgmma route: both of its hd buckets (64, 128) and head dims zero-padded
# into them
WG_HDS = [8, 32, 40, 64, 72, 80, 96, 104, 128]


@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("hd", WG_HDS)
def test_bwd_wgmma_every_bucket(gen, hd, flag):
    """The wgmma dK/dV and dQ kernels at every hd they take and every form
    against their plain versions; the launches count their route."""
    fn, args = _bwd_case(gen, 2, 256, hd, torch.bfloat16, flag)
    assert fn.path == "wgmma" and fn.block_k == fn.block_k_dq == 128
    before = {k: dict(v) for k, v in ka.path_launches.items()}
    got = fn(*args)
    for k in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        assert ka.path_launches[k] == dict(before[k], wgmma=before[k][
            "wgmma"] + 1)
    _same(got, fn.plain(*args), torch.bfloat16)


@pytest.mark.parametrize("s", [384, 640, 1152])
@pytest.mark.parametrize("hd", [64, 128])
def test_bwd_wgmma_causal_odd_tile_counts(gen, hd, s):
    """Causal with dropout and dbias at 3, 5 and 9 blocks of 128 keys (6,
    10 and 18 Q stages): the diagonal crosses the first stage of each
    block, and dbias is zero wherever the key follows the query."""
    fn, args = _bwd_case(gen, 2, s, hd, torch.bfloat16,
                         "causal_dropout_bias_grad")
    assert fn.path == "wgmma"
    got = fn(*args)
    _same(got, fn.plain(*args), torch.bfloat16)
    upper = torch.ones(s, s, dtype=torch.bool, device="cuda").triu(1)
    assert bool((got[3][:, upper] == 0).all())


@pytest.mark.parametrize("flag", ["dropout", "causal_dropout_bias_grad"])
@pytest.mark.parametrize("hd", [64, 128])
def test_bwd_wgmma_dropout_each_gradient(gen, hd, flag):
    """Dropout: dQ, dK^T and dV each against the plain version's. The
    dK/dV kernel's accumulators hold keys as rows, so a swapped (i, j) in
    its hash would show in dK^T and dV even where dQ agrees."""
    fn, args = _bwd_case(gen, 2, 256, hd, torch.bfloat16, flag)
    assert fn.path == "wgmma"
    _each_gradient(fn, args)


@pytest.mark.parametrize("flag", ["bias1", "bias_bh_grad"])
@pytest.mark.parametrize("hd", [40, 80, 128])
def test_bwd_wgmma_bias(gen, hd, flag):
    """Broadcast bias (bias_bh 1) and a per-head bias with dbias."""
    fn, args = _bwd_case(gen, 3, 512, hd, torch.bfloat16, flag)
    assert fn.path == "wgmma"
    _same(fn(*args), fn.plain(*args), torch.bfloat16)


@pytest.mark.parametrize("hd", [64, 96])
def test_bwd_wgmma_unaligned_views(gen, hd):
    """q, kT, v and dout 2-14 bytes past a 16-byte boundary, lse and delta
    4 bytes past one: the wrapper copies them for TMA."""
    fn, args = _bwd_case(gen, 2, 256, hd, torch.bfloat16, "causal")
    assert fn.path == "wgmma"
    _unaligned(fn, args)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_bwd_wgmma_head_map(gen, hd, causal):
    """A head map under dropout: both kernels hash the global batch-head,
    as the plain version does, and other bits than the local index draws."""
    flag = ("causal_" if causal else "") + "dropout_head_map"
    fn, args = _bwd_case(gen, 4, 256, hd, torch.bfloat16, flag)
    assert fn.path == "wgmma" and fn.head_map != ka.NO_HEAD_MAP
    got = fn(*args)
    _same(got, fn.plain(*args), torch.bfloat16)
    local = ka.build_flash_attention_bwd(4, 256, hd, torch.bfloat16,
                                         causal=causal, dropout_p=0.2)
    assert not torch.equal(local(*args)[2], got[2])


@pytest.mark.parametrize("hd", [64, 128])
def test_bwd_wgmma_deterministic(gen, hd):
    """Each output tile has one writer: two calls give the same bits."""
    fn, args = _bwd_case(gen, 2, 512, hd, torch.bfloat16,
                         "causal_dropout_bias_grad")
    assert fn.path == "wgmma"
    a, b = fn(*args), fn(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", [Datatype.F32, Datatype.BF16])
@pytest.mark.parametrize("opts", [{}, {"causal": True, "dropout_p": 0.1},
                                  {"bias_bh": 4, "bias_requires_grad": True}])
def test_dispatch_backward_launches_kernels(gen, dtype, opts):
    """dispatch_flash_attention under autograd: the LSE forward and both
    backward kernels on the fused route, gradients equal to the plain
    backward's on the same forward."""
    bh, s, hd = 4, 256, 64
    tdt = xp.to_torch(dtype)
    kern = xp.dispatch_flash_attention(bh, s, hd, dtype, **opts)
    q, v = randn(gen, bh, s, hd, dtype=tdt), randn(gen, bh, s, hd, dtype=tdt)
    kT = randn(gen, bh, hd, s, dtype=tdt)
    call = {"seed": 3} if opts.get("dropout_p") else {}
    leaves = [q, kT, v]
    if opts.get("bias_bh"):
        bias = randn(gen, bh, s, s, scale=0.5).requires_grad_(True)
        call["bias"] = bias
        leaves.append(bias)
    for t in (q, kT, v):
        t.requires_grad_(True)
    before = dict(ka.launches)
    out = kern(q, kT, v, **call)
    dout = randn(gen, bh, s, hd, dtype=tdt)
    grads = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    for name in ka.launches:
        assert ka.launches[name] == before[name] + 1, name
    fwd = ka.build_flash_attention(
        bh, s, hd, tdt, causal=opts.get("causal", False),
        dropout_p=opts.get("dropout_p", 0.0), bias_bh=opts.get("bias_bh", 0),
        return_lse=True)
    with torch.no_grad():
        b = call.get("bias")
        o, lse = fwd(call.get("seed", 0), q, kT, v, b)
        delta = (dout.float() * o.float()).sum(-1, keepdim=True).expand(
            bh, s, 128)
        bwd = ka.build_flash_attention_bwd(
            bh, s, hd, tdt, causal=opts.get("causal", False),
            dropout_p=opts.get("dropout_p", 0.0),
            bias_bh=opts.get("bias_bh", 0),
            bias_grad=opts.get("bias_requires_grad", False))
        want = bwd.plain(call.get("seed", 0), q, kT, v, dout, lse, delta, b)
    _same(grads, want, tdt)


def test_served_call_runs_no_backward(gen):
    kern = xp.dispatch_flash_attention(4, 256, 64, Datatype.BF16)
    q, v = (randn(gen, 4, 256, 64, dtype=torch.bfloat16) for _ in range(2))
    kT = randn(gen, 4, 64, 256, dtype=torch.bfloat16)
    ka.reset_launches()
    with torch.inference_mode():
        out = kern(q, kT, v)
    assert not out.requires_grad
    assert ka.launches == {"flash_attention_fwd": 1,
                           "flash_attention_bwd_dkv": 0,
                           "flash_attention_bwd_dq": 0}


def test_bwd_refusals(gen):
    with pytest.raises(ValueError, match="per-\\(batch\\*head\\)"):
        ka.build_flash_attention_bwd(4, 256, 64, torch.float32, bias_bh=1,
                                     bias_grad=True)
    assert ka.bwd_configs(256) == [(64, 64)]
    # the wide kernels keep their tile: a small override only has to tile s
    assert ka.build_flash_attention_bwd(
        4, 256, 256, torch.bfloat16, block_override=(64, 16)).block_k == 64
    with pytest.raises(ValueError, match="does not tile"):
        ka.build_flash_attention_bwd(4, 256, 256, torch.float32,
                                     block_override=(96, 16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_on_the_card(gen, dtype):
    """A seeded flash train step on CUDA tensors launches the flash forward,
    dropout and both backward kernels, and its gradients equal those of the
    same step on the CPU (plain versions; the same dropout bits on both
    devices). Tolerance as the card tests' outputs: 1e-4 f32, 2e-2 bf16
    (bf16 activations rounded at other points)."""
    from libxsmm_torch.kernels import eltwise as ke
    cfg = ta.AttentionConfig(dim=128, heads=2, ffn_mult=2, dtype=dtype,
                             flash=True, dropout_p=0.1)
    params = ta.init_params(cfg, seed=0, device="cuda")
    x = randn(gen, 2, 128, 128, dtype=params["wqkv"].dtype)
    y = randn(gen, 2, 128, 128, dtype=params["wqkv"].dtype)
    ka.reset_launches()
    ke.reset_launches()
    new, loss = ta.train_step(params, x, y, cfg, lr=1e-2, seed=7)
    torch.cuda.synchronize()
    assert all(c > 0 for c in ka.launches.values()), ka.launches
    assert ke.launches["dropout"] > 0
    assert torch.isfinite(loss)
    _, g_card = ta.loss_and_grads(params, x, y, cfg, seed=7)
    cpu = {k: v.cpu() for k, v in params.items()}
    _, g_cpu = ta.loss_and_grads(cpu, x.cpu(), y.cpu(), cfg, seed=7)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for name in g_cpu:
        check(g_cpu[name].double(), g_card[name].cpu().double(), margin=tol)


def test_split_sgd_on_the_card(gen):
    cfg = tm.MlpConfig()
    ps = tm.split_params(tm.init_params(cfg, seed=0, device="cuda"))
    x, y = randn(gen, 256, 256), randn(gen, 256, 128, scale=0.1)
    losses = []
    for _ in range(5):
        ps, loss = tm.split_sgd_train_step(ps, x, y, cfg, lr=5e-2)
        losses.append(loss.item())
    assert all(layer["w"][0].is_cuda for layer in ps)
    assert losses[-1] < losses[0]
