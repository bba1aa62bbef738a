"""The TPP-Attention encoder block's serving path: the port
(`libxsmm_torch.models.tpp_attention`) against the JAX model, on the CPU,
with the reference's weights carried across bit for bit by
params_from_numpy. The JAX side runs its flash kernel in interpret mode, as
its own tests do.

Tolerances (matdiff normf_rel): 1e-5 for f32 outputs (sums in another
order); 1e-2 for bf16 outputs (activations rounded to bf16 between the
block's stages, each side from values that differ in the last f32 bits).
A seeded forward draws dropout bits that differ by design between the two
packages (the JAX package's CPU dropout is jax.random), so it is held to
its properties: finite, deterministic in the seed, and the reference's
keep rate.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libxsmm_torch.kernels import attention as pa
from libxsmm_torch.kernels import eltwise as pe
from libxsmm_torch.matdiff import check
from libxsmm_torch.models import tpp_attention as pm
from libxsmm_tpu.models import tpp_attention as rm

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def configs(**kw):
    base = dict(dim=128, heads=2, ffn_mult=2)
    base.update(kw)
    return rm.AttentionConfig(**base), pm.AttentionConfig(**base)


def inputs(cfg_j, seed=1, b=2, s=128):
    rng = np.random.default_rng(seed)
    xj = jnp.asarray(rng.standard_normal((b, s, cfg_j.dim)), cfg_j.dtype)
    xt = torch.from_numpy(np.asarray(xj, np.float32)).to(
        getattr(torch, cfg_j.dtype))
    return xj, xt


def same(ref, got, dtype):
    ref = np.asarray(ref, np.float32)
    assert tuple(got.shape) == ref.shape
    assert got.dtype == getattr(torch, dtype)
    assert bool(torch.isfinite(got.float()).all())
    check(ref.astype(np.float64), got.float().numpy().astype(np.float64),
          margin=TOL[dtype])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_parity(dtype, flash, causal):
    cj, cp = configs(dtype=dtype, flash=flash, causal=causal)
    params = rm.init_params(cj, seed=3)
    pp = pm.params_from_numpy({k: np.asarray(v) for k, v in params.items()},
                              device="cpu")
    xj, xt = inputs(cj)
    same(rm.forward(params, xj, cj), pm.forward(pp, xt, cp), dtype)


def test_params_from_numpy_bit_exact():
    cj, _ = configs(dtype="bfloat16")
    params = rm.init_params(cj, seed=5)
    pp = pm.params_from_numpy({k: np.asarray(v) for k, v in params.items()},
                              device="cpu")
    assert sorted(pp) == sorted(params)
    for name, v in params.items():
        ref = np.asarray(v)
        assert pp[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            pp[name].view(torch.int16).numpy(), ref.view(np.int16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_matches_reference(dtype):
    cj, cp = configs(dtype=dtype)
    ref = rm.init_params(cj, seed=2)
    got = pm.init_params(cp, seed=2, device="cpu")
    for name, v in ref.items():
        r = np.asarray(v, np.float32)
        g = got[name].float().numpy()
        assert g.shape == r.shape and got[name].dtype == getattr(torch, dtype)
        if dtype == "float32":
            np.testing.assert_array_equal(g, r)
        else:   # f64 -> bf16 may round once differently: one bf16 ulp
            np.testing.assert_allclose(g, r, rtol=2 ** -7, atol=0)


def test_loss_and_stages_parity():
    cj, cp = configs(flash=True)
    params = rm.init_params(cj, seed=4)
    pp = pm.params_from_numpy({k: np.asarray(v) for k, v in params.items()},
                              device="cpu")
    xj, xt = inputs(cj, seed=8)
    yj, yt = inputs(cj, seed=9)
    check(np.float64(rm.loss_fn(params, xj, yj, cj)),
          pm.loss_fn(pp, xt, yt, cp).double().reshape(()), margin=1e-5)
    check(np.asarray(rm._layernorm(xj, params["ln1_g"], params["ln1_b"]),
                     np.float64),
          pm._layernorm(xt, pp["ln1_g"], pp["ln1_b"]).double(), margin=1e-6)
    check(np.asarray(rm._softmax_rows(xj), np.float64),
          pm._softmax_rows(xt).double(), margin=1e-6)
    check(np.asarray(rm.attention(params, xj, cj), np.float64),
          pm.attention(pp, xt, cp).double(), margin=1e-5)


def test_encoder_block_module():
    cj, cp = configs(flash=True)
    params = rm.init_params(cj, seed=6)
    pp = pm.params_from_numpy({k: np.asarray(v) for k, v in params.items()},
                              device="cpu")
    block = pm.EncoderBlock(cp, params=pp)
    names = sorted(n for n, _ in block.named_parameters())
    assert names == sorted(params)
    _, xt = inputs(cj, seed=2)
    with torch.inference_mode():
        out = block(xt)
    assert torch.equal(out, pm.forward(pp, xt, cp))
    fresh = pm.EncoderBlock(cp, init_seed=6, device="cpu")
    assert all(torch.equal(getattr(fresh, n), pp[n]) for n in pp)
    assert all(p.device.type == "cpu" for p in fresh.parameters())


@pytest.mark.parametrize("flash", [False, True])
def test_seeded_forward_properties(flash):
    cj, cp = configs(flash=flash, dropout_p=0.1)
    params = rm.init_params(cj, seed=7)
    pp = pm.params_from_numpy({k: np.asarray(v) for k, v in params.items()},
                              device="cpu")
    xj, xt = inputs(cj, seed=3)
    a = pm.forward(pp, xt, cp, seed=7)
    b = pm.forward(pp, xt, cp, seed=7)
    c = pm.forward(pp, xt, cp, seed=8)
    serve = pm.forward(pp, xt, cp)
    assert bool(torch.isfinite(a).all())
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert not torch.equal(a, serve)
    # the unseeded forward is the serving path on both sides
    same(rm.forward(params, xj, cj), serve, "float32")


def test_seeded_forward_runs_both_dropouts(monkeypatch):
    """The seeded flash forward reaches the flash kernel's hash dropout
    (seed + 2) and the FFN dropout (seed + 1); on the CPU both run their
    plain versions. The flash mask's keep rate over the probabilities is
    1 - p."""
    cj, cp = configs(flash=True, dropout_p=0.25)
    params = rm.init_params(cj, seed=1)
    pp = pm.params_from_numpy({k: np.asarray(v) for k, v in params.items()},
                              device="cpu")
    _, xt = inputs(cj, seed=4)
    calls = []
    orig_flash, orig_drop = pa.FlashAttention.plain, pe._dropout_plain

    def spy_flash(self, seed, *args):
        calls.append(("flash", seed, self.dropout_p))
        return orig_flash(self, seed, *args)

    def spy_drop(x, seed, p, *mask):
        calls.append(("dropout", seed, p, tuple(x.shape)))
        assert mask == ("bytes",)      # the block saves the byte mask
        return orig_drop(x, seed, p, *mask)

    monkeypatch.setattr(pa.FlashAttention, "plain", spy_flash)
    monkeypatch.setattr(pe, "_dropout_plain", spy_drop)
    pm.forward(pp, xt, cp, seed=40)
    assert ("flash", 42, 0.25) in calls
    assert ("dropout", 41, 0.25, (2 * 128, 2 * 128)) in calls
    keep = pa._rand_bits(42, torch.arange(4)[:, None, None],
                         torch.arange(128)[:, None],
                         torch.arange(128)[None, :]) >= \
        pa._dropout_threshold(0.25)
    n = keep.numel()
    assert abs(keep.float().mean().item() - 0.75) < 4 * (
        0.25 * 0.75 / n) ** 0.5


def test_dropout_backward_replays_mask():
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    x.requires_grad_(True)
    y = pm._dropout(x, 0.3, 5)
    g = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    y.backward(g)
    keep = y.detach() != 0
    scale = 1.0 / (1.0 - 0.3)
    np.testing.assert_allclose(x.grad[keep].numpy(),
                               (g[keep] * scale).numpy(), rtol=1e-6)
    assert bool((x.grad[~keep] == 0).all())
    assert pm._dropout(x, 0.0, 5) is x


def test_flash_block_backward_matches_composition():
    """The flash block's backward: its input gradient equals
    the flash=False block's (1e-4: f32, sums in another order)."""
    _, cp = configs(flash=True)
    pp = pm.init_params(cp, seed=0, device="cpu")
    x = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (1, 128, 128)).astype(np.float32)).requires_grad_(True)
    pm.forward(pp, x, cp).sum().backward()
    x2 = x.detach().clone().requires_grad_(True)
    pm.forward(pp, x2, dataclasses.replace(cp, flash=False)).sum().backward()
    assert bool(torch.isfinite(x.grad).all())
    check(x2.grad.double(), x.grad.double(), margin=1e-4)


def test_encoder_block_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.EncoderBlock(pm.AttentionConfig(dim=64, heads=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.params_from_numpy({n: np.zeros(2, np.float32)
                              for n in pm._PARAM_NAMES})


def test_config_head_dim():
    assert pm.AttentionConfig(dim=768, heads=12).head_dim == 64
    with pytest.raises(ValueError, match="multiple of heads"):
        pm.AttentionConfig(dim=100, heads=3).head_dim
