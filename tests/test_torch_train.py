"""The training path: the port's TPP-Attention and TPP-MLP models
(`libxsmm_torch.models.tpp_attention`, `libxsmm_torch.models.tpp_mlp`)
against the JAX models on the CPU, with the reference's weights carried
across bit for bit by params_from_numpy. The JAX side runs its flash
kernels in interpret mode, as its own tests do.

Gradients are compared, not updated params: lr * g lies below the params'
rounding. Tolerances (matdiff normf_rel): 1e-4 for f32 gradients (sums in
another order; dS = p * (dP - delta) cancels) and 1e-5 for f32 losses and
forwards; 2e-2 for bf16 gradients and 1e-2 for bf16 forwards and losses
(activations rounded to bf16 between the stages, each side from values
that differ in the last f32 bits). The splitSGD bit patterns are compared
exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libxsmm_torch.matdiff import check
from libxsmm_torch.models import tpp_attention as pm
from libxsmm_torch.models import tpp_mlp as pmlp
from libxsmm_tpu.models import tpp_attention as rm
from libxsmm_tpu.models import tpp_mlp as rmlp

torch.set_num_threads(1)

GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
OUT_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def tensor(a, dtype):
    """A JAX array as a CPU tensor of the same values and dtype."""
    return torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))


def same(ref, got, tol):
    ref = np.asarray(ref, np.float64)
    assert tuple(got.shape) == ref.shape
    assert bool(torch.isfinite(got.float()).all())
    check(ref, got.detach().double().numpy(), margin=tol)


# ---------------------------------------------------------------------------
# TPP-Attention
# ---------------------------------------------------------------------------

def attention_setup(dtype, seed=3, **kw):
    base = dict(dim=128, heads=2, ffn_mult=2, dtype=dtype)
    base.update(kw)
    cj, cp = rm.AttentionConfig(**base), pm.AttentionConfig(**base)
    params = rm.init_params(cj, seed=seed)
    pp = pm.params_from_numpy({k: np.asarray(v) for k, v in params.items()},
                              device="cpu")
    rng = np.random.default_rng(seed + 10)
    xj = jnp.asarray(rng.standard_normal((2, 128, cj.dim)), dtype)
    yj = jnp.asarray(rng.standard_normal((2, 128, cj.dim)) * 0.5, dtype)
    return cj, cp, params, pp, (xj, yj), (tensor(xj, dtype),
                                          tensor(yj, dtype))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_loss_grad_parity(dtype, flash, causal):
    cj, cp, params, pp, (xj, yj), (xt, yt) = attention_setup(
        dtype, flash=flash, causal=causal)
    loss_j, grads_j = jax.value_and_grad(rm.loss_fn)(params, xj, yj, cj)
    loss_p, grads_p = pm.loss_and_grads(pp, xt, yt, cp)
    check(np.float64(loss_j), loss_p.double().reshape(()),
          margin=OUT_TOL[dtype])
    assert sorted(grads_p) == sorted(grads_j)
    for name, g in grads_p.items():
        assert g.dtype == pp[name].dtype, name
        same(grads_j[name], g, GRAD_TOL[dtype])
    # the params were left as they were
    assert not any(p.requires_grad for p in pp.values())


def test_attention_train_step_matches_sgd_on_the_gradients():
    """train_step = loss_and_grads + p - lr * g in the param dtype; the
    loss it returns is the reference's."""
    cj, cp, params, pp, (xj, yj), (xt, yt) = attention_setup(
        "float32", flash=True, causal=True)
    new, loss = pm.train_step(pp, xt, yt, cp, lr=1e-2)
    _, grads = pm.loss_and_grads(pp, xt, yt, cp)
    for name, p in pp.items():
        assert torch.equal(new[name], p - 1e-2 * grads[name]), name
    check(np.float64(rm.loss_fn(params, xj, yj, cj)),
          loss.double().reshape(()), margin=1e-5)


def test_attention_train_steps_reduce_loss():
    """The reference's test_model_flash_train_step on the port: three
    flash, causal steps at lr 1e-2 lower the loss."""
    _, cp, _, pp, _, (xt, yt) = attention_setup("float32", seed=6,
                                                flash=True, causal=True)
    yt = yt * 0.2
    l0 = pm.loss_fn(pp, xt, yt, cp).item()
    for _ in range(3):
        pp, loss = pm.train_step(pp, xt, yt, cp, lr=1e-2)
    assert loss.item() < l0
    assert pm.loss_fn(pp, xt, yt, cp).item() < loss.item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_seeded_flash_train_step(dtype):
    """A seeded flash step with dropout: finite, deterministic in the seed,
    seed-sensitive; without a seed it refuses to train."""
    _, cp, _, pp, _, (xt, yt) = attention_setup(dtype, flash=True,
                                                dropout_p=0.1)
    a, la = pm.train_step(pp, xt, yt, cp, seed=7)
    b, lb = pm.train_step(pp, xt, yt, cp, seed=7)
    c, lc = pm.train_step(pp, xt, yt, cp, seed=8)
    assert torch.isfinite(la) and torch.equal(la, lb)
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert all(bool(torch.isfinite(a[n].float()).all()) for n in a)
    assert la.item() != lc.item()
    _, grads = pm.loss_and_grads(pp, xt, yt, cp, seed=7)
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads.values())
    with pytest.raises(ValueError, match="requires a seed"):
        pm.train_step(pp, xt, yt, cp)


def test_attention_seeded_grads_follow_the_reference_masks():
    """With attention-probability dropout only (the flash kernel's position
    hash, bit-exact with the reference's; the FFN dropout is off with
    p = 0 there), the seeded gradients match the reference's. The FFN
    dropout draws other bits by design (ROADMAP divergences), so the block
    is cut to its attention half by a zero FFN."""
    cj, cp, params, pp, (xj, yj), (xt, yt) = attention_setup(
        "float32", flash=True, dropout_p=0.2)
    for name in ("w1", "b1", "w2", "b2"):
        params[name] = jnp.zeros_like(params[name])
        pp[name] = torch.zeros_like(pp[name])
    # the FFN's dropout sees zeros; its mask cannot change the result
    loss_j, grads_j = jax.value_and_grad(rm.loss_fn)(params, xj, yj, cj, 31)
    loss_p, grads_p = pm.loss_and_grads(pp, xt, yt, cp, seed=31)
    check(np.float64(loss_j), loss_p.double().reshape(()), margin=1e-5)
    for name in ("wqkv", "bqkv", "wo", "bo", "ln1_g", "ln1_b"):
        same(grads_j[name], grads_p[name], GRAD_TOL["float32"])


# ---------------------------------------------------------------------------
# TPP-MLP
# ---------------------------------------------------------------------------

CFG = dict(in_dim=16, hidden=(32, 24), out_dim=8)


def mlp_setup(dtype, seed=0, rows=16):
    cj = rmlp.MlpConfig(dtype=dtype, **CFG)
    cp = pmlp.MlpConfig(dtype=dtype, **CFG)
    params = rmlp.init_params(cj, seed=seed)
    pp = pmlp.params_from_numpy([{k: np.asarray(v) for k, v in l.items()}
                                 for l in params], device="cpu")
    rng = np.random.default_rng(seed + 1)
    xj = jnp.asarray(rng.standard_normal((rows, CFG["in_dim"])), dtype)
    yj = jnp.asarray(rng.standard_normal((rows, CFG["out_dim"])), dtype)
    return cj, cp, params, pp, (xj, yj), (tensor(xj, dtype),
                                          tensor(yj, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_forward_and_grad_parity(dtype):
    cj, cp, params, pp, (xj, yj), (xt, yt) = mlp_setup(dtype)
    out = pmlp.forward(pp, xt, cp)
    assert out.dtype == getattr(torch, dtype)
    same(rmlp.forward(params, xj, cj), out, OUT_TOL[dtype])
    loss_j, grads_j = jax.value_and_grad(rmlp.loss_fn)(params, xj, yj, cj)
    loss_p, grads_p = pmlp.loss_and_grads(pp, xt, yt, cp)
    check(np.float64(loss_j), loss_p.double().reshape(()),
          margin=OUT_TOL[dtype])
    assert len(grads_p) == len(grads_j)
    for gj, gp in zip(grads_j, grads_p):
        for k in ("w", "b"):
            assert gp[k].dtype == getattr(torch, dtype)
            same(gj[k], gp[k], GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_init_params_matches_reference(dtype):
    cj = rmlp.MlpConfig(dtype=dtype, **CFG)
    cp = pmlp.MlpConfig(dtype=dtype, **CFG)
    ref = rmlp.init_params(cj, seed=4)
    got = pmlp.init_params(cp, seed=4, device="cpu")
    assert len(got) == len(ref)
    for lr_, lg in zip(ref, got):
        for k in ("w", "b"):
            r, g = np.asarray(lr_[k], np.float32), lg[k].float().numpy()
            assert g.shape == r.shape and lg[k].dtype == getattr(torch, dtype)
            if dtype == "float32":
                np.testing.assert_array_equal(g, r)
            else:   # f64 -> bf16 may round once differently: one bf16 ulp
                np.testing.assert_allclose(g, r, rtol=2 ** -7, atol=0)


def test_mlp_train_step_reduces_loss():
    """The reference's test_forward_and_train_step on the port."""
    _, cp, _, pp, _, (xt, yt) = mlp_setup("float32")
    l0 = pmlp.loss_fn(pp, xt, yt, cp).item()
    new, loss = pmlp.train_step(pp, xt, yt, cp)
    assert loss.item() == pytest.approx(l0)
    assert pmlp.loss_fn(new, xt, yt, cp).item() < l0


def _bits(t):
    return t.contiguous().view(torch.int16).numpy()


def test_split_f32_combine_bit_exact():
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((32, 32)) * 5).astype(np.float32)
    w[0, :4] = [0.0, -0.0, 1e-30, 3e38]
    hi_j, lo_j = rmlp.split_f32(jnp.asarray(w))
    hi_p, lo_p = pmlp.split_f32(torch.from_numpy(w))
    assert hi_p.dtype == lo_p.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(hi_p), np.asarray(hi_j).view(np.int16))
    np.testing.assert_array_equal(_bits(lo_p), np.asarray(lo_j).view(np.int16))
    np.testing.assert_array_equal(
        pmlp.combine_f32(hi_p, lo_p).numpy(),
        np.asarray(rmlp.combine_f32(hi_j, lo_j)))
    err = np.abs(pmlp.combine_f32(hi_p, lo_p).numpy() - w).max()
    assert err <= np.abs(w).max() * 2 ** -15


def test_split_sgd_update_parity():
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((16, 16)) * 3).astype(np.float32)
    g = rng.standard_normal((16, 16)).astype(np.float32)
    hj, lj = rmlp.split_f32(jnp.asarray(w))
    hp, lp = pmlp.split_f32(torch.from_numpy(w))
    for _ in range(5):
        hj, lj = rmlp.split_sgd_update(hj, lj, jnp.asarray(g), 1e-2)
        hp, lp = pmlp.split_sgd_update(hp, lp, torch.from_numpy(g), 1e-2)
    np.testing.assert_array_equal(_bits(hp), np.asarray(hj).view(np.int16))
    np.testing.assert_array_equal(_bits(lp), np.asarray(lj).view(np.int16))


def test_split_sgd_beats_pure_bf16():
    """The reference's test of the same name on the port: tiny updates
    vanish in bf16 weights but accumulate in the split representation."""
    w = torch.full((64, 64), 100.0)
    g = torch.full((64, 64), 1.0)
    lr = 1e-2
    hi, lo = pmlp.split_f32(w)
    bf16_w = w.to(torch.bfloat16)
    for _ in range(50):
        hi, lo = pmlp.split_sgd_update(hi, lo, g, lr)
        bf16_w = (bf16_w.float() - lr * g).to(torch.bfloat16)
    split_val = float(pmlp.combine_f32(hi, lo)[0, 0])
    bf16_val = float(bf16_w.float()[0, 0])
    assert abs(split_val - 99.5) < 0.02
    assert bf16_val == 100.0


def test_split_sgd_train_step_parity():
    """Three splitSGD steps on both sides: the same losses, and split
    params that combine to the same f32 weights (the bf16 gradients may
    round differently, so within the bf16 gradient tolerance times lr)."""
    cj, cp, params, pp, (xj, yj), (xt, yt) = mlp_setup("float32", seed=2)
    sj, sp = rmlp.split_params(params), pmlp.split_params(pp)
    for layer_j, layer_p in zip(sj, sp):
        for k in ("w", "b"):
            for a, b in zip(layer_j[k], layer_p[k]):
                np.testing.assert_array_equal(_bits(b),
                                              np.asarray(a).view(np.int16))
    for _ in range(3):
        sj, loss_j = rmlp.split_sgd_train_step(sj, xj, yj * 0.1, cj, lr=5e-2)
        sp, loss_p = pmlp.split_sgd_train_step(sp, xt, yt * 0.1, cp, lr=5e-2)
        check(np.float64(loss_j), loss_p.double().reshape(()), margin=1e-2)
    for layer_j, layer_p in zip(sj, sp):
        for k in ("w", "b"):
            same(rmlp.combine_f32(*layer_j[k]),
                 pmlp.combine_f32(*layer_p[k]), 1e-3)


def test_split_sgd_training_converges():
    """The reference's test of the same name on the port."""
    _, cp, _, pp, _, _ = mlp_setup("float32")
    ps = pmlp.split_params(pp)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((16, 16)).astype(np.float32))
    y = torch.from_numpy((rng.standard_normal((16, 8)) * 0.1).astype(
        np.float32))
    losses = []
    for _ in range(10):
        ps, loss = pmlp.split_sgd_train_step(ps, x, y, cp, lr=5e-2)
        losses.append(loss.item())
    assert losses[-1] < losses[0] * 0.9


def test_mlp_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmlp.init_params(pmlp.MlpConfig())
