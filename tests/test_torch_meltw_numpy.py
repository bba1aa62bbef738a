"""numpy operands of the meltw kernels (`dispatch_meltw_unary/binary/
ternary`), on the CPU.

The JAX package's kernels take numpy operands. The port's load a numpy main
operand onto the default device (the GPU; without one they raise "no CUDA
device", never an AttributeError), keep a tensor on its own device, and
load side operands onto the main operand's device. With the default device
patched to the CPU, each result equals the JAX kernel's on the same numpy
inputs within 1e-6 relative (f32: XLA's exp, its fused multiply-adds and
its summation order differ from torch's by an ulp); a bf16 numpy operand
loads bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import libxsmm_torch as xp
import libxsmm_tpu as xt
from libxsmm_torch import device as PDEV
from libxsmm_torch.interop import tensor_from_numpy

torch.set_num_threads(1)

M, N = 4, 6
RNG = np.random.default_rng(31)
X = RNG.standard_normal((M, N)).astype(np.float32)
Y = RNG.standard_normal((M, N)).astype(np.float32)
Z = RNG.standard_normal((M, N)).astype(np.float32)
COL = RNG.standard_normal((1, N)).astype(np.float32)
IDX = np.asarray([3, 0, 2], np.int32)


def _unary(pkg, op, flags="NONE"):
    return pkg.dispatch_meltw_unary(getattr(pkg.UnaryType, op), M, N,
                                    getattr(pkg.UnaryFlags, flags))


def _binary(pkg, op, flags="NONE"):
    return pkg.dispatch_meltw_binary(getattr(pkg.BinaryType, op), M, N,
                                     getattr(pkg.BinaryFlags, flags))


def _ternary(pkg, op, flags="NONE"):
    return pkg.dispatch_meltw_ternary(getattr(pkg.TernaryType, op), M, N,
                                      getattr(pkg.TernaryFlags, flags))


# (name, kernel maker, numpy operands)
CASES = {
    "unary RELU": (lambda p: _unary(p, "RELU"), (X,)),
    "unary EXP": (lambda p: _unary(p, "EXP"), (X,)),
    "unary REDUCE_X_OP_ADD rows": (
        lambda p: _unary(p, "REDUCE_X_OP_ADD", "REDUCE_ROWS"), (X,)),
    "unary GATHER rows": (lambda p: _unary(p, "GATHER"), (X, IDX)),
    "binary ADD": (lambda p: _binary(p, "ADD"), (X, Y)),
    "binary MUL col": (lambda p: _binary(p, "MUL", "BCAST_COL_IN_1"),
                       (X, COL)),
    "binary MAX": (lambda p: _binary(p, "MAX"), (X, Y)),
    "ternary MULADD": (lambda p: _ternary(p, "MULADD"), (X, Y, Z)),
    "ternary NMULADD": (lambda p: _ternary(p, "NMULADD"), (X, Y, Z)),
}


def _np(out):
    if isinstance(out, tuple):
        return tuple(_np(o) for o in out)
    if isinstance(out, torch.Tensor):
        return out.numpy()
    return np.asarray(out)


@pytest.mark.parametrize("case", sorted(CASES))
def test_numpy_operand_without_gpu_raises_no_cuda(case):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: numpy operands load onto it")
    make, args = CASES[case]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(xp)(*args)


@pytest.mark.parametrize("case", sorted(CASES))
def test_numpy_operand_matches_jax_kernel(case, monkeypatch):
    monkeypatch.setattr(PDEV, "default_device", lambda: torch.device("cpu"))
    make, args = CASES[case]
    got = make(xp)(*args)
    want = make(xt)(*args)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    # a tensor main operand stays where it is and numpy side operands
    # follow it, whatever the default device
    monkeypatch.undo()
    mixed = make(xp)(torch.from_numpy(args[0].copy()), *args[1:])
    np.testing.assert_array_equal(_np(mixed), _np(got))


def test_bf16_numpy_operand_loads_bit_for_bit(monkeypatch):
    monkeypatch.setattr(PDEV, "default_device", lambda: torch.device("cpu"))
    xb = np.asarray(jnp.asarray(X, jnp.bfloat16))       # ml_dtypes bfloat16
    kern = xp.dispatch_meltw_unary(xp.UnaryType.IDENTITY, M, N,
                                   in_type=xp.Datatype.BF16,
                                   out_type=xp.Datatype.BF16)
    got = kern(xb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  xb.view(np.int16))


@pytest.mark.parametrize("main", ["tensor", "numpy"])
def test_bf16_numpy_side_operand_matches_jax_kernel(main, monkeypatch):
    monkeypatch.setattr(PDEV, "default_device", lambda: torch.device("cpu"))
    xb = np.asarray(jnp.asarray(X, jnp.bfloat16))       # ml_dtypes bfloat16
    yb = np.asarray(jnp.asarray(Y, jnp.bfloat16))
    kerns = [pkg.dispatch_meltw_binary(pkg.BinaryType.ADD, M, N,
                                       in_type=pkg.Datatype.BF16,
                                       out_type=pkg.Datatype.BF16)
             for pkg in (xp, xt)]
    x0 = (tensor_from_numpy(xb, xp.Datatype.BF16, "cpu")
          if main == "tensor" else xb)
    got = kerns[0](x0, yb)
    want = np.asarray(kerns[1](xb, yb))
    assert got.dtype == torch.bfloat16 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
