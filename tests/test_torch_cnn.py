"""TPP-CNN: the port (`libxsmm_torch.models.tpp_cnn`) against the JAX model
on the CPU, on the same numpy inputs and, through params_from_numpy, the
same parameters.

Tolerances (matdiff normf_rel): 1e-5 for f32 convolutions, logits, losses
and gradients (sums in another order); 5e-3 (DEFAULT_MARGINS bf16) for bf16
conv outputs, which round the same f32 sums once to bf16. The conv is also
held against a float64 numpy convolution.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import libxsmm_torch as xp
from libxsmm_torch import interop
from libxsmm_torch.matdiff import check
from libxsmm_torch.models import tpp_cnn as PC
from libxsmm_tpu.models import tpp_cnn as RC

torch.set_num_threads(1)

RNG = np.random.default_rng(31)
TOL = {"float32": 1e-5, "bfloat16": 5e-3}


def both(x, dtype="float32"):
    xj = jnp.asarray(np.asarray(x, np.float32), getattr(jnp, dtype))
    return xj, interop.tensor_from_numpy(
        np.asarray(xj), xp.Datatype({"float32": "f32",
                                     "bfloat16": "bf16"}[dtype]), "cpu")


def conv64(x, w, b, stride):
    """float64 VALID NHWC x RSCK convolution, + bias, relu."""
    x, w = np.asarray(x, np.float64), np.asarray(w, np.float64)
    n, h, wd, c = x.shape
    R, S, _, K = w.shape
    p, q = (h - R) // stride + 1, (wd - S) // stride + 1
    out = np.zeros((n, p, q, K))
    for r in range(R):
        for s in range(S):
            patch = x[:, r:r + (p - 1) * stride + 1:stride,
                      s:s + (q - 1) * stride + 1:stride, :]
            out += np.einsum("npqc,ck->npqk", patch, w[r, s])
    return np.maximum(out + np.asarray(b, np.float64), 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("epilogue", ["none", "bias", "relu", "bias_relu"])
def test_conv2d_tpp_and_kernel_parity(dtype, stride, epilogue):
    xj, xt_ = both(RNG.standard_normal((2, 9, 11, 4)), dtype)
    wj, wt = both(RNG.standard_normal((3, 3, 4, 8)) / 6.0, dtype)
    bj, bt = both(RNG.standard_normal((8,)), dtype)
    bias = "bias" in epilogue
    relu = "relu" in epilogue
    act = "relu" if relu else None
    ref = RC.conv2d_tpp(xj, wj, bj if bias else None, stride, act)
    got = PC.conv2d_tpp(xt_, wt, bt if bias else None, stride, act)
    assert got.dtype == xt_.dtype and got.shape == ref.shape
    check(np.asarray(ref, np.float64), got, margin=TOL[dtype])
    kr = RC.conv2d_kernel(xj.shape, wj.shape, stride, bias, relu,
                          dtype=getattr(jnp, dtype))
    kp = PC.conv2d_kernel(tuple(xt_.shape), tuple(wt.shape), stride, bias,
                          relu, dtype=getattr(torch, dtype))
    assert kr.kernel.name == kp.kernel.name
    rk = kr(xj, wj, bj) if bias else kr(xj, wj)
    pk = kp(xt_, wt, bt) if bias else kp(xt_, wt)
    check(np.asarray(rk, np.float64), pk, margin=TOL[dtype])
    # the kernel and the differentiable formulation agree in the port
    check(got.double(), pk, margin=TOL[dtype])


def test_conv2d_kernel_against_float64():
    # samples/cnn.py's check at a small layer: fused bias + relu, f32
    x = RNG.standard_normal((2, 12, 12, 8)).astype(np.float32)
    w = (RNG.standard_normal((3, 3, 8, 16)) / np.sqrt(72)).astype(np.float32)
    b = RNG.standard_normal((16,)).astype(np.float32)
    for stride in (1, 2):
        fn = PC.conv2d_kernel(x.shape, w.shape, stride, fused_bias=True,
                              relu=True)
        got = fn(torch.from_numpy(x), torch.from_numpy(w),
                 torch.from_numpy(b))
        want = conv64(x, w, b, stride)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err < 1e-5


def test_conv2d_kernel_refusals_and_dtype_names():
    with pytest.raises(ValueError, match="channels"):
        PC.conv2d_kernel((1, 8, 8, 4), (3, 3, 5, 8))
    fn = PC.conv2d_kernel((1, 8, 8, 4), (3, 3, 4, 8), relu=True,
                          dtype="float32")
    with pytest.raises(ValueError, match="fused_bias"):
        fn(torch.zeros(1, 8, 8, 4), torch.zeros(3, 3, 4, 8), torch.zeros(8))
    fb = PC.conv2d_kernel((1, 8, 8, 4), (3, 3, 4, 8), fused_bias=True,
                          dtype=np.float32)
    with pytest.raises(ValueError, match="needs the bias"):
        fb(torch.zeros(1, 8, 8, 4), torch.zeros(3, 3, 4, 8))
    assert fb.kernel.info.kind == "gemm_ext"
    assert PC.conv2d_kernel((1, 8, 8, 4), (3, 3, 4, 8)).kernel.info.kind \
        == "gemm"


CFG = dict(height=10, width=10, channels=4, filters=((3, 8), (3, 8)),
           strides=(1, 2), classes=5)


def _model(dtype="float32"):
    rcfg = RC.CnnConfig(**CFG, dtype=dtype)
    pcfg = PC.CnnConfig(**CFG, dtype=dtype)
    rp = RC.init_params(rcfg, seed=3)
    # non-zero biases so the bias path counts
    rp = [{"w": layer["w"], "b": layer["b"] + jnp.asarray(
        RNG.standard_normal(layer["b"].shape) * 0.1, layer["b"].dtype)}
          for layer in rp]
    pp = PC.params_from_numpy([{k: np.asarray(v) for k, v in layer.items()}
                               for layer in rp], device="cpu")
    x = RNG.standard_normal((3, 10, 10, 4)).astype(np.float32)
    labels = RNG.integers(0, 5, (3,))
    return rcfg, pcfg, rp, pp, x, labels


def test_init_params_match_reference():
    cfg = RC.CnnConfig(**CFG)
    rp = RC.init_params(cfg, seed=9)
    pp = PC.init_params(PC.CnnConfig(**CFG), seed=9, device="cpu")
    assert len(rp) == len(pp) == 3
    for r, p in zip(rp, pp):
        for k in ("w", "b"):
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(r[k]))


def test_forward_loss_and_gradients_parity():
    rcfg, pcfg, rp, pp, x, labels = _model()
    ref = RC.forward(rp, jnp.asarray(x), rcfg)
    got = PC.forward(pp, torch.from_numpy(x), pcfg)
    check(np.asarray(ref, np.float64), got, margin=1e-5)
    rloss, rgrads = jax.value_and_grad(RC.loss_fn)(rp, jnp.asarray(x),
                                                   jnp.asarray(labels), rcfg)
    ploss, pgrads = PC.loss_and_grads(pp, torch.from_numpy(x),
                                      torch.from_numpy(labels), pcfg)
    check(np.asarray(rloss, np.float64).reshape(1), ploss.reshape(1),
          margin=1e-5)
    for r, p in zip(rgrads, pgrads):
        for k in ("w", "b"):
            check(np.asarray(r[k], np.float64), p[k], margin=1e-5)


def test_train_step_parity_and_loss_falls():
    rcfg, pcfg, rp, pp, x, labels = _model()
    xj, lj = jnp.asarray(x), jnp.asarray(labels)
    xt_, lt = torch.from_numpy(x), torch.from_numpy(labels)
    losses = []
    for _ in range(3):
        rp, rloss = RC.train_step(rp, xj, lj, rcfg, lr=0.5)
        pp, ploss = PC.train_step(pp, xt_, lt, pcfg, lr=0.5)
        check(np.asarray(rloss, np.float64).reshape(1), ploss.reshape(1),
              margin=1e-5)
        losses.append(float(ploss))
    for r, p in zip(rp, pp):
        for k in ("w", "b"):
            check(np.asarray(r[k], np.float64), p[k], margin=1e-5)
    assert losses[-1] < losses[0]


def test_bf16_forward_parity():
    rcfg, pcfg, rp, pp, x, labels = _model("bfloat16")
    xj, xt_ = both(x, "bfloat16")
    ref = RC.forward(rp, xj, rcfg)
    got = PC.forward(pp, xt_, pcfg)
    assert got.dtype == torch.float32
    check(np.asarray(ref, np.float64), got, margin=1e-2)
