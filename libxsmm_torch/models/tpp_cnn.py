"""TPP-CNN: convolution as the library's own batch-reduce GEMM.

The port of `libxsmm_tpu/models/tpp_cnn.py`. Convolution lowers to a BRGEMM
over the R*S filter taps (the TPP paper's formulation, arXiv:2104.05755):

    conv(x, w)[n,p,q,k] = sum_{r,s} Apatch_{r,s} @ w[r,s]
    Apatch_{r,s} = x[n, p*stride+r, q*stride+s, :]          (N*P*Q, C)

a stride-mode batch-reduce GEMM with br = R*S, m = N*P*Q, k = C, n = K,
with the fused bias + activation epilogue of dispatch_brgemm_ext.

Two paths, value-identical:
  * conv2d_tpp: the differentiable formulation (the same contraction as
    torch ops, so autograd runs through the train step);
  * conv2d_kernel: the dispatched library kernel, dispatch_brgemm_ext with
    the bias-ADD postop and the RELU cp-unary, the serving path. cuDNN's
    convolution is not used (it would also allow TF32 by default).

Layouts are the JAX package's: x NHWC, w RSCK (HWIO), VALID padding. The
tap stack is materialized: (R*S, N*P*Q, C) in device memory, 9x the
activations at a 3x3 layer, where XLA folds the strided tap slices into the
operand windows. The products accumulate in f32 (bf16 products are exact
there; f32 runs at full f32, no TF32).

make_sharded_train_step runs over a dp mesh of the port's parallel layer:
the batch split over dp, the parameters replicated, their gradients summed
over dp by one explicit all-reduce (parallel/spmd.py), where the reference
lets GSPMD derive it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..descriptor import (BatchReduceConfig, BatchReduceType, BinaryPostops,
                          BinaryType, GemmFlags, GemmShape, UnaryArgops,
                          UnaryType)
from ..device import resolve_device
from ..dtypes import from_torch
from ..ops.gemm import dispatch_brgemm, dispatch_brgemm_ext
from ..parallel import spmd
from ..parallel.mesh import NamedSharding, P, local


@dataclasses.dataclass(frozen=True)
class CnnConfig:
    height: int = 16
    width: int = 16
    channels: int = 8
    filters: Tuple[Tuple[int, int], ...] = ((3, 16), (3, 32))  # (R==S, K)
    strides: Tuple[int, ...] = (1, 2)
    classes: int = 10
    dtype: str = "float32"


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a name or a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name if not isinstance(
        dtype, str) else dtype)


def _tap_stack(x: torch.Tensor, R: int, S: int, stride: int):
    """(br=R*S, N*P*Q, C) stack of the strided tap views (VALID padding),
    and (N, P, Q)."""
    n, h, w, c = x.shape
    p = (h - R) // stride + 1
    q = (w - S) // stride + 1
    taps = [x[:, r:r + (p - 1) * stride + 1:stride,
              s:s + (q - 1) * stride + 1:stride, :].reshape(n * p * q, c)
            for r in range(R) for s in range(S)]
    return torch.stack(taps), (n, p, q)


def conv2d_tpp(x, w, b=None, stride: int = 1,
               activation: Optional[str] = None):
    """NHWC x RSCK VALID conv as the BRGEMM contraction (differentiable).
    Bias-add and relu follow the brgemm_ext epilogue order (postop, then
    cp-unary, on the f32 accumulator); the output is rounded once to x's
    type."""
    R, S, C, K = w.shape
    a_stack, (n, p, q) = _tap_stack(x, R, S, stride)
    acc = torch.einsum("tmc,tck->mk", a_stack.to(x.dtype).float(),
                       w.reshape(R * S, C, K).to(x.dtype).float())
    if b is not None:
        acc = acc + b[None, :].float()
    if activation == "relu":
        acc = torch.clamp_min(acc, 0.0)
    return acc.reshape(n, p, q, K).to(x.dtype)


def conv2d_kernel(x_shape: Tuple[int, int, int, int], w_shape, stride=1,
                  fused_bias: bool = False, relu: bool = False,
                  dtype=torch.float32):
    """Dispatch the library's BRGEMM(-ext) for this conv geometry, once.

    Returns fn(x, w[, bias]) -> NHWC output: one registry-cached kernel
    call, kernel(a_stack, w_stack[, bias (1, K)]), with the fused bias-ADD
    postop and the RELU cp-unary when asked for (the reference's
    libxsmm_dispatch_brgemm_ext fused conv epilogues). The (1, K) bias
    rides the postop's broadcast. fn.kernel is the dispatched kernel."""
    n, h, wid, c = x_shape
    R, S, C, K = w_shape
    if c != C:
        raise ValueError(f"x has {c} channels, w expects {C}")
    p = (h - R) // stride + 1
    q = (wid - S) // stride + 1
    tdt = _torch_dtype(dtype)
    dt = from_torch(tdt)
    shape = GemmShape(n * p * q, K, C, a_in_type=dt, b_in_type=dt,
                      out_type=dt)
    br = BatchReduceConfig(BatchReduceType.STRIDE, br_count_hint=R * S)
    if fused_bias or relu:
        kern = dispatch_brgemm_ext(
            shape, GemmFlags.BETA_0, br,
            argops=(UnaryArgops(cp_type=UnaryType.RELU) if relu
                    else UnaryArgops()),
            postops=(BinaryPostops(d_type=BinaryType.ADD) if fused_bias
                     else BinaryPostops()))
    else:
        kern = dispatch_brgemm(shape, GemmFlags.BETA_0, br)

    def fn(x, w, bias=None):
        if (bias is None) == fused_bias:
            raise ValueError("bias needs fused_bias=True at dispatch, and "
                             "fused_bias=True needs the bias")
        a_stack, (nn, pp, qq) = _tap_stack(x, R, S, stride)
        args = [a_stack, w.reshape(R * S, C, K)]
        if fused_bias:
            args.append(bias[None, :].to(tdt))
        return kern(*args).reshape(nn, pp, qq, K)

    fn.kernel = kern
    return fn


# ---------------------------------------------------------------------------
# the model: conv stack -> global average pool -> linear classifier
# ---------------------------------------------------------------------------

def init_params(cfg: CnnConfig, seed: int = 0,
                device=None) -> List[Dict[str, torch.Tensor]]:
    """Weights from numpy's default_rng(seed) in the reference's order,
    scaled by 1/sqrt(fan_in), rounded to cfg.dtype by torch (a bf16 weight
    may differ from the reference's by one rounding; parity tests carry the
    reference's weights with params_from_numpy); zero biases."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    rng = np.random.default_rng(seed)
    params = []
    c = cfg.channels
    for (r, k), _ in zip(cfg.filters, cfg.strides):
        w = rng.standard_normal((r, r, c, k)) / np.sqrt(r * r * c)
        params.append({"w": torch.as_tensor(w).to(device=dev, dtype=dt),
                       "b": torch.zeros((k,), dtype=dt, device=dev)})
        c = k
    wd = rng.standard_normal((c, cfg.classes)) / np.sqrt(c)
    params.append({"w": torch.as_tensor(wd).to(device=dev, dtype=dt),
                   "b": torch.zeros((cfg.classes,), dtype=dt, device=dev)})
    return params


def params_from_numpy(params, device=None) -> List[Dict[str, torch.Tensor]]:
    """The reference's parameter list (numpy arrays: np.asarray of each JAX
    array) as the port's, bit for bit (bf16 included)."""
    from .tpp_mlp import params_from_numpy as _from_numpy
    return _from_numpy(params, device)


def forward(params, x, cfg: CnnConfig):
    """Logits (N, classes) in f32: relu(conv + bias) per layer, global
    average pool, linear head."""
    h = x
    for layer, stride in zip(params[:-1], cfg.strides):
        h = conv2d_tpp(h, layer["w"], layer["b"], stride=stride,
                       activation="relu")
    h = torch.mean(h.float(), dim=(1, 2))                # global avg pool
    head = params[-1]
    return h @ head["w"].float() + head["b"][None, :].float()


def loss_fn(params, x, labels, cfg: CnnConfig):
    """Softmax cross-entropy, mean over the batch."""
    logits = forward(params, x, cfg)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.to(torch.long)[:, None])[:, 0]
    return torch.mean(logz - ll)


def loss_and_grads(params, x, labels, cfg: CnnConfig):
    """(loss, grads): loss_fn and its gradient over the parameter list, as
    jax.value_and_grad(loss_fn) gives them; the params are left untouched."""
    leaves = [{k: v.detach().requires_grad_(True) for k, v in layer.items()}
              for layer in params]
    flat = [layer[k] for layer in leaves for k in ("w", "b")]
    with torch.enable_grad():
        loss = loss_fn(leaves, x, labels, cfg)
        grads = torch.autograd.grad(loss, flat)
    return loss.detach(), [{"w": grads[2 * i], "b": grads[2 * i + 1]}
                           for i in range(len(leaves))]


def train_step(params, x, labels, cfg: CnnConfig, lr: float = 1e-2):
    """One SGD step, p - lr * g in the parameter dtype: (new_params, loss)."""
    loss, grads = loss_and_grads(params, x, labels, cfg)
    with torch.no_grad():
        new = [{k: (p - lr * g[k]).to(p.dtype) for k, p in layer.items()}
               for layer, g in zip(params, grads)]
    return new, loss


def make_sharded_train_step(cfg: CnnConfig, mesh, lr: float = 1e-2):
    """The full train step over the mesh: (step, xsharding). The batch is
    split over dp (x NHWC placed by xsharding, labels by P("dp")), the
    parameters replicated (the global list, or DTensors placed with
    P(None) everywhere); step(params, x, labels) -> (new_params, loss),
    the loss the mean over the global batch on every rank, each gradient
    summed over dp."""
    xsharding = NamedSharding(mesh, P("dp", None, None, None))
    lsharding = NamedSharding(mesh, P("dp"))
    n_layers = len(cfg.filters) + 1
    shards = spmd.shardings(mesh, [{"w": P(None), "b": P(None)}
                                   for _ in range(n_layers)])

    def step(params, x, labels):
        batch = x.shape[0]
        spmd.divide(batch, spmd.axis_size(mesh, "dp"), "batch")
        xl, ll = local(x, xsharding), local(labels, lsharding)

        def local_loss(lp):
            logits = forward(lp, xl, cfg)
            logz = torch.logsumexp(logits, dim=-1)
            picked = torch.gather(logits, -1,
                                  ll.to(torch.long)[:, None])[:, 0]
            term = torch.sum(logz - picked) / batch
            return term, term

        return spmd.sgd_step(params, shards, mesh, lr, local_loss, ("dp",),
                             ("dp",))

    return step, xsharding
