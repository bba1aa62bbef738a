"""TPP-MoE on one device: the port (`libxsmm_torch.models.tpp_moe`) against
the JAX package's model (`libxsmm_tpu.models.tpp_moe`), on the CPU, with the
reference's parameters carried across bit for bit (params_from_numpy).

Tolerances, as max |port - reference|: f32 outputs, losses and one train
step's parameters 1e-5; bf16 outputs 1e-2 of the largest magnitude.
Dispatch tensors, dropped tokens and tie picks are exactly equal. The
combine tensors have exactly the same nonzero slots, and their values (gate
probabilities <= 1) agree within 1e-6: XLA's exp and torch's differ by an
ulp on some inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libxsmm_torch.models import tpp_moe as P
from libxsmm_tpu.models import tpp_moe as R

torch.set_num_threads(1)

RNG = np.random.default_rng(21)


def _cfgs(**kw):
    return R.MoeConfig(**kw), P.MoeConfig(**kw)


def _params(cfg_r, seed):
    pr = R.init_params(cfg_r, seed=seed)
    pp = P.params_from_numpy({k: np.asarray(v) for k, v in pr.items()},
                             device="cpu")
    return pr, pp


def _x(s, d, dtype, rng=RNG):
    x = rng.standard_normal((s, d)).astype(np.float32)
    xr = jnp.asarray(x, dtype)
    xp = torch.from_numpy(np.array(xr, np.float32)).to(getattr(torch, dtype))
    return xr, xp


def _f32(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return np.asarray(v, np.float32)


def test_init_params_match_reference_bit_for_bit():
    cfg_r, cfg_p = _cfgs(dim=16, hidden=32, n_experts=4)
    pr = R.init_params(cfg_r, seed=3)
    pp = P.init_params(cfg_p, seed=3, device="cpu")
    for k in pr:
        np.testing.assert_array_equal(pp[k].numpy(), np.asarray(pr[k]))
    assert P.capacity(cfg_p, 24) == R.capacity(cfg_r, 24)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_forward_matches_reference(top_k, dtype):
    cfg_r, cfg_p = _cfgs(dim=16, hidden=32, n_experts=4, top_k=top_k,
                         capacity_factor=1.0, dtype=dtype)
    pr, pp = _params(cfg_r, seed=2 + top_k)
    xr, xp = _x(48, 16, dtype)
    yr, ar = R.forward(pr, xr, cfg_r)
    yp, ap = P.forward(pp, xp, cfg_p)
    assert yp.dtype == getattr(torch, dtype) and yp.shape == (48, 16)
    tol = 1e-5 if dtype == "float32" else 1e-2 * np.abs(_f32(yr)).max()
    assert np.abs(_f32(yp) - _f32(yr)).max() <= tol
    assert abs(float(ap) - float(ar)) <= 1e-6


@pytest.mark.parametrize("top_k,cf", [(1, 1.0), (1, 0.5), (2, 1.0),
                                      (2, 0.5)])
def test_route_matches_reference(top_k, cf):
    s, e = 64, 4
    logits = RNG.standard_normal((s, e)).astype(np.float32) * 2
    cfg_r, _ = _cfgs(n_experts=e, top_k=top_k, capacity_factor=cf)
    cap = R.capacity(cfg_r, s)
    dr, cr, ar = R._route(jnp.asarray(logits), e, cap, top_k)
    dp, cp, ap = P._route(torch.from_numpy(logits), e, cap, top_k)
    np.testing.assert_array_equal(dp.numpy(), np.asarray(dr))
    np.testing.assert_array_equal(cp.numpy() != 0, np.asarray(cr) != 0)
    assert np.abs(cp.numpy() - np.asarray(cr)).max() <= 1e-6
    assert abs(float(ap) - float(ar)) <= 1e-6
    if cf < 1:      # scarce slots: some tokens are dropped, the same ones
        kept = dp.numpy().sum(axis=(1, 2))
        assert (kept < top_k).any()
        np.testing.assert_array_equal(kept, np.asarray(dr).sum(axis=(1, 2)))


def test_capacity_drops_zero_overflow_tokens():
    cfg_r, cfg_p = _cfgs(dim=8, hidden=16, n_experts=4, capacity_factor=0.5)
    pr, pp = _params(cfg_r, seed=3)
    s = 16
    cap = P.capacity(cfg_p, s)           # 2 slots per expert
    row = RNG.standard_normal((1, 8)).astype(np.float32)
    x = np.broadcast_to(row, (s, 8)).copy()
    yr, _ = R.forward(pr, jnp.asarray(x), cfg_r)
    yp, _ = P.forward(pp, torch.from_numpy(x), cfg_p)
    alive_p = (yp != 0).any(dim=-1).numpy()
    alive_r = np.asarray(jnp.any(yr != 0.0, axis=-1))
    np.testing.assert_array_equal(alive_p, alive_r)
    assert alive_p.sum() == cap and alive_p[:cap].all()
    # a dropped token has zero dispatch and zero combine weight
    logits = torch.from_numpy(x) @ pp["wg"]
    d, c, _ = P._route(logits, 4, cap, 1)
    assert float(d[cap:].abs().sum()) == 0 and float(c[cap:].abs().sum()) == 0


def test_top2_rank_major_capacity():
    """GShard seating: when capacity is scarce, FIRST choices win slots over
    any second choice (the reference's test_moe_top2_rank_major_capacity)."""
    cfg_r, cfg_p = _cfgs(dim=8, hidden=16, n_experts=4, top_k=2,
                         capacity_factor=0.25)
    s = 16
    cap = P.capacity(cfg_p, s)           # 2 slots per expert
    pr, pp = _params(cfg_r, seed=7)
    row = RNG.standard_normal((1, 8)).astype(np.float32)
    x = torch.from_numpy(np.broadcast_to(row, (s, 8)).copy())
    logits = x @ pp["wg"]
    dispatch, _, _ = P._route(logits, 4, cap, top_k=2)
    per_expert = dispatch.sum(dim=(0, 2)).numpy()
    assert sorted(per_expert, reverse=True)[:2] == [cap, cap]
    e0 = int(torch.argmax(torch.softmax(logits, -1)[0]))
    seated = dispatch[:, e0, :].sum(dim=-1).numpy()
    assert seated[:cap].sum() == cap and seated[cap:].sum() == 0
    dr, _, _ = R._route(jnp.asarray(logits.numpy()), 4, cap, top_k=2)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(dr))


@pytest.mark.parametrize("top_k", [1, 2])
def test_zero_router_ties_pick_the_lower_index(top_k):
    """A zero router gives every token equal gates: every token goes to
    expert 0 (and 1 for top-2), as jax.lax.top_k orders ties."""
    s, e = 12, 4
    cap = s
    logits = np.zeros((s, e), np.float32)
    dr, cr, ar = R._route(jnp.asarray(logits), e, cap, top_k)
    dp, cp, ap = P._route(torch.from_numpy(logits), e, cap, top_k)
    np.testing.assert_array_equal(dp.numpy(), np.asarray(dr))
    np.testing.assert_array_equal(cp.numpy(), np.asarray(cr))
    per_expert = dp.sum(dim=(0, 2)).numpy()
    want = np.zeros(e)
    want[:top_k] = s
    np.testing.assert_array_equal(per_expert, want)
    assert float(ap) == float(ar) == 1.0


def test_aux_loss_and_its_gradient():
    """The aux loss and its gradient flow through the gate values only (the
    first-choice fractions carry none): the router's gradient of
    aux_loss_weight * aux matches jax.grad's."""
    s, d, e = 32, 8, 4
    x = RNG.standard_normal((s, d)).astype(np.float32)
    wg = RNG.standard_normal((d, e)).astype(np.float32)

    def aux_r(w):
        return R._route(jnp.asarray(x) @ w, e, s, 1)[2]

    g_r = np.asarray(jax.grad(aux_r)(jnp.asarray(wg)))
    w_p = torch.from_numpy(wg.copy()).requires_grad_(True)
    aux_p = P._route(torch.from_numpy(x) @ w_p, e, s, 1)[2]
    (g_p,) = torch.autograd.grad(aux_p, [w_p])
    assert abs(float(aux_p.detach()) - float(aux_r(jnp.asarray(wg)))) <= 1e-6
    np.testing.assert_allclose(g_p.numpy(), g_r, atol=1e-6)


@pytest.mark.parametrize("top_k", [1, 2])
def test_train_step_matches_reference(top_k):
    cfg_r, cfg_p = _cfgs(dim=16, hidden=32, n_experts=4, top_k=top_k,
                         capacity_factor=1.0, aux_loss_weight=0.1)
    pr, pp = _params(cfg_r, seed=5)
    xr, xp = _x(32, 16, "float32")
    y = RNG.standard_normal((32, 16)).astype(np.float32)
    new_r, loss_r = R.train_step(pr, xr, jnp.asarray(y), cfg_r, lr=0.1)
    new_p, loss_p = P.train_step(pp, xp, torch.from_numpy(y), cfg_p, lr=0.1)
    assert abs(float(loss_p) - float(loss_r)) <= 1e-5
    for k in new_r:
        assert new_p[k].dtype == pp[k].dtype
        assert np.abs(new_p[k].numpy() - np.asarray(new_r[k])).max() <= 1e-5
        assert not torch.equal(new_p[k], pp[k]) or k in ("b1",)


def test_bf16_train_step_close_to_reference():
    cfg_r, cfg_p = _cfgs(dim=16, hidden=32, n_experts=4, capacity_factor=1.0,
                         dtype="bfloat16")
    pr, pp = _params(cfg_r, seed=6)
    xr, xp = _x(32, 16, "bfloat16")
    y = RNG.standard_normal((32, 16)).astype(np.float32)
    new_r, loss_r = R.train_step(pr, xr, jnp.asarray(y, jnp.bfloat16),
                                 cfg_r, lr=0.1)
    new_p, loss_p = P.train_step(pp, xp, torch.from_numpy(y).bfloat16(),
                                 cfg_p, lr=0.1)
    assert abs(float(loss_p) - float(loss_r)) <= 1e-4
    for k in new_r:
        ref = _f32(new_r[k])
        assert new_p[k].dtype == torch.bfloat16
        assert np.abs(_f32(new_p[k]) - ref).max() <= 1e-2 * max(
            1.0, np.abs(ref).max())


@pytest.mark.parametrize("top_k,cf", [(1, 4.0), (2, 2.0)])
def test_per_token_oracle(top_k, cf):
    """With capacity that covers the draw, the forward equals the per-token
    oracle; the port's oracle equals the reference's."""
    cfg_r, cfg_p = _cfgs(dim=16, hidden=32, n_experts=4, top_k=top_k,
                         capacity_factor=cf)
    pr, pp = _params(cfg_r, seed=2)
    xr, xp = _x(24, 16, "float32")
    yp, _ = P.forward(pp, xp, cfg_p)
    want_p = P.reference_forward(pp, xp, cfg_p)
    want_r = R.reference_forward(pr, xr, cfg_r)
    assert np.abs(yp.numpy() - want_p).max() < 1e-4
    np.testing.assert_allclose(want_p, want_r, atol=1e-5)


def test_mesh_is_not_ported_yet():
    """A mesh is now taken (the sharded MoE is ported: its cases are in
    tests/test_torch_sharded_moe.py). On a one-rank (dp 1, ep 1) mesh, in
    a gloo world of one, the einsum variant's forward and train step
    equal the unsharded ones (forward within 1e-6, the step's loss and
    parameters within 1e-6: the same routing, the same products)."""
    import torch_sharded_ranks as SR
    from libxsmm_torch.scripts.ranks import run_ranks
    (got,) = run_ranks(SR.world_moe_one, 1, timeout=120.0)
    cfg = SR.MOE_CFGS["step"]
    params = P.init_params(cfg, seed=SR.MOE_SEEDS["step"], device="cpu")
    x, y = (torch.as_tensor(a) for a in SR.moe_inputs("step"))
    want_y, want_aux = P.forward(params, x, cfg)
    new, loss = P.train_step(params, x, y, cfg)
    assert float((got["y"] - want_y).abs().max()) < 1e-6
    assert abs(float(got["aux"]) - float(want_aux)) < 1e-6
    assert abs(float(got["loss"]) - float(loss)) < 1e-6
    for k in new:
        assert float((got["params"][k] - new[k]).abs().max()) < 1e-6
