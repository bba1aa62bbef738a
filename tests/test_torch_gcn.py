"""TPP-GCN on one device: the port (`libxsmm_torch.models.tpp_gcn`) against
the JAX model on the same numpy inputs, on the CPU, at the sizes of
tests/test_models.py:105-145 (32 nodes of a ring graph, 8 x 8 blocks): the
normalized operator, the forward against the JAX model and the dense
float64 oracle, the loss, its gradients against jax.value_and_grad, and the
parameters after three train steps.

Tolerances: the operator's blocks exact; f32 forward and loss 1e-5
normf_rel against the JAX model (sums in another order) and the reference
test's rtol 2e-4 / atol 2e-5 against float64; gradients and parameters
after the steps 1e-5 normf_rel; bf16 activations 1e-2 (one rounding per
stage, at other points of the sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libxsmm_torch.matdiff import check
from libxsmm_torch.models import tpp_gcn as pg
from libxsmm_tpu.models import tpp_gcn as rg

torch.set_num_threads(1)

N, BLOCK = 32, 8


def ring_graph(n):
    a = np.zeros((n, n), np.float32)
    for i in range(n):
        a[i, (i + 1) % n] = a[(i + 1) % n, i] = 1.0
        a[i, (i + 3) % n] = a[(i + 3) % n, i] = 1.0
    return a


def setup(cfg_kw, dtype="float32", seed=1):
    rcfg = rg.GcnConfig(dtype=dtype, **cfg_kw)
    pcfg = pg.GcnConfig(dtype=dtype, **cfg_kw)
    rbsr = rg.normalize_adjacency(ring_graph(N), BLOCK)
    pbsr = pg.normalize_adjacency(ring_graph(N), BLOCK)
    rparams = rg.init_params(rcfg, seed=seed)
    pparams = pg.params_from_numpy(
        [{k: np.asarray(v) for k, v in layer.items()} for layer in rparams],
        device="cpu")
    rng = np.random.default_rng(seed + 1)
    h = rng.standard_normal((N, cfg_kw["in_dim"])).astype(np.float32)
    labels = rng.integers(0, cfg_kw["out_dim"], N)
    return (rcfg, pcfg, rbsr, pbsr, rparams, pparams,
            jnp.asarray(h, dtype), torch.from_numpy(h).to(getattr(torch,
                                                                 dtype)),
            labels)


def f64(x):
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def test_normalize_adjacency_matches():
    rbsr = rg.normalize_adjacency(ring_graph(N), BLOCK)
    pbsr = pg.normalize_adjacency(ring_graph(N), BLOCK)
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(rbsr, name),
                                      getattr(pbsr, name))
    with pytest.raises(ValueError, match="divisible"):
        pg.normalize_adjacency(ring_graph(30), BLOCK)
    with pytest.raises(ValueError, match="square"):
        pg.normalize_adjacency(np.zeros((8, 16)), BLOCK)


@pytest.mark.parametrize("hidden", [(16,), (16, 8)])
def test_forward_matches(hidden):
    cfg_kw = dict(in_dim=12, hidden=hidden, out_dim=4)
    rcfg, pcfg, rbsr, pbsr, rp, pp, hj, ht, _ = setup(cfg_kw)
    want = f64(rg.forward(rp, rg._bsr_plan(rbsr), N // BLOCK, hj, rcfg))
    got = pg.forward(pp, pg._bsr_plan(pbsr, "cpu"), N // BLOCK, ht, pcfg)
    assert got.dtype == torch.float32 and got.shape == (N, 4)
    check(want, f64(got), margin=1e-5)
    # the dense float64 oracle of tests/test_models.py:105-124
    ahat, x = pbsr.to_dense().astype(np.float64), f64(ht)
    for i, layer in enumerate(pp):
        x = ahat @ (x @ f64(layer["w"])) + f64(layer["b"])[None, :]
        if i < len(pp) - 1:
            x = np.maximum(x, 0)
    np.testing.assert_allclose(f64(got), x, rtol=2e-4, atol=2e-5)


def test_bf16_forward_matches():
    cfg_kw = dict(in_dim=12, hidden=(16,), out_dim=4)
    rcfg, pcfg, rbsr, pbsr, rp, pp, hj, ht, _ = setup(cfg_kw, "bfloat16")
    want = f64(rg.forward(rp, rg._bsr_plan(rbsr), N // BLOCK, hj, rcfg))
    got = pg.forward(pp, pg._bsr_plan(pbsr, "cpu"), N // BLOCK, ht, pcfg)
    assert got.dtype == torch.bfloat16
    check(want, f64(got), margin=1e-2)


def test_loss_and_gradients_match():
    cfg_kw = dict(in_dim=8, hidden=(16,), out_dim=3)
    rcfg, pcfg, rbsr, pbsr, rp, pp, hj, ht, labels = setup(cfg_kw, seed=3)
    rplan, pplan = rg._bsr_plan(rbsr), pg._bsr_plan(pbsr, "cpu")
    rloss, rgrads = jax.value_and_grad(rg.loss_fn)(
        rp, rplan, N // BLOCK, hj, jnp.asarray(labels, jnp.int32), rcfg)
    ploss, pgrads = pg.loss_and_grads(pp, pplan, N // BLOCK, ht,
                                      torch.from_numpy(labels), pcfg)
    check(np.float64(rloss), np.float64(ploss), margin=1e-5)
    for rl, pl_ in zip(rgrads, pgrads):
        for name in ("w", "b"):
            check(f64(rl[name]), f64(pl_[name]), margin=1e-5)


def test_train_steps_match():
    """Three SGD steps at the reference's default lr 1e-2: the same
    parameters and losses; the loss falls."""
    cfg_kw = dict(in_dim=8, hidden=(16,), out_dim=3)
    rcfg, pcfg, rbsr, pbsr, rp, pp, hj, ht, labels = setup(cfg_kw, seed=3)
    rplan, pplan = rg._bsr_plan(rbsr), pg._bsr_plan(pbsr, "cpu")
    lab_j, lab_t = jnp.asarray(labels, jnp.int32), torch.from_numpy(labels)
    rlosses, plosses = [], []
    for _ in range(3):
        rp, rloss = rg.train_step(rp, rplan, N // BLOCK, hj, lab_j, rcfg)
        pp, ploss = pg.train_step(pp, pplan, N // BLOCK, ht, lab_t, pcfg)
        rlosses.append(float(rloss))
        plosses.append(float(ploss))
    check(np.array(rlosses), np.array(plosses), margin=1e-5)
    for rl, pl_ in zip(rp, pp):
        for name in ("w", "b"):
            assert pl_[name].dtype == torch.float32
            check(f64(rl[name]), f64(pl_[name]), margin=1e-5)
    after = float(pg.loss_fn(pp, pplan, N // BLOCK, ht, lab_t, pcfg))
    assert after < plosses[0]


def test_init_params_match():
    cfg = pg.GcnConfig(in_dim=12, hidden=(16,), out_dim=4)
    rparams = rg.init_params(rg.GcnConfig(in_dim=12, hidden=(16,),
                                          out_dim=4), seed=5)
    for rl, pl_ in zip(rparams, pg.init_params(cfg, seed=5, device="cpu")):
        for name in ("w", "b"):
            np.testing.assert_array_equal(np.asarray(rl[name]),
                                          pl_[name].numpy())


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pg._bsr_plan(pg.normalize_adjacency(ring_graph(N), BLOCK))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pg.init_params(pg.GcnConfig())
