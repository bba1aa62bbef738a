"""TPP-MLP: the flagship end-to-end model built from library primitives.

The port of `libxsmm_tpu/models/tpp_mlp.py`: a stack of fully-connected
layers, each the fused brgemm_ext pattern (matmul + bias-add binary postop
+ activation), differentiable end to end, with plain SGD and the splitSGD
family (bf16 master weights held as two bf16 halves).

  * The products are torch.matmul on f32 operands: bf16 products are exact
    in f32 and accumulate in f32, f32 products run at full f32 (no TF32),
    as the reference's preferred_element_type + precision policy computes
    them outside any Pallas kernel. This model runs no kernel of its own.
  * Parameters are a list of {"w", "b"} dicts with the reference's layout
    (w: (fan_in, fan_out)); init_params draws them from numpy's
    default_rng(seed) in the reference's order.

Not ported yet: shard_params and the sharded step (ROADMAP.md queue 1,
item 13).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..descriptor import UnaryFlags, UnaryType
from ..device import resolve_device
from ..ops.eltwise import _trunc_f32_to_bf16_f32, apply_unary_op


@dataclasses.dataclass(frozen=True)
class MlpConfig:
    in_dim: int = 256
    hidden: Tuple[int, ...] = (512, 512)
    out_dim: int = 128
    activation: UnaryType = UnaryType.GELU
    dtype: str = "float32"


def init_params(cfg: MlpConfig, seed: int = 0,
                device=None) -> List[Dict[str, torch.Tensor]]:
    """Weights from numpy's default_rng(seed) in the reference's order,
    scaled by 1/sqrt(fan_in), rounded to cfg.dtype by torch (a bf16 weight
    may differ from the reference's by one rounding; parity tests carry the
    reference's weights with params_from_numpy); zero biases."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    rng = np.random.default_rng(seed)
    dims = (cfg.in_dim, *cfg.hidden, cfg.out_dim)
    params = []
    for i in range(len(dims) - 1):
        w = rng.standard_normal((dims[i], dims[i + 1])) / np.sqrt(dims[i])
        params.append({
            "w": torch.as_tensor(w).to(device=dev, dtype=dt),
            "b": torch.zeros((dims[i + 1],), dtype=dt, device=dev),
        })
    return params


def params_from_numpy(params, device=None) -> List[Dict[str, torch.Tensor]]:
    """The reference's parameter list (numpy arrays: np.asarray of each JAX
    array) as the port's, bit for bit (bf16 included)."""
    from ..dtypes import Datatype
    from ..interop import tensor_from_numpy
    types = {"float32": Datatype.F32, "bfloat16": Datatype.BF16,
             "float16": Datatype.F16, "float64": Datatype.F64}
    out = []
    for layer in params:
        out.append({})
        for name in ("w", "b"):
            arr = np.asarray(layer[name])
            out[-1][name] = tensor_from_numpy(arr, types[arr.dtype.name],
                                              device)
    return out


def forward(params, x, cfg: MlpConfig):
    """y = MLP(x); each layer is the fused brgemm_ext pattern (matmul +
    bias-add binary postop + activation cp-unary), accumulated in f32 and
    rounded once to x's dtype."""
    h = x
    for i, layer in enumerate(params):
        acc = torch.matmul(h.float(), layer["w"].float()) + layer["b"].float()
        if i < len(params) - 1:
            acc = apply_unary_op(cfg.activation, UnaryFlags.NONE, acc)
        h = acc.to(x.dtype)
    return h


def loss_fn(params, x, y, cfg: MlpConfig):
    pred = forward(params, x, cfg)
    return torch.mean((pred.float() - y.float()) ** 2)


def loss_and_grads(params, x, y, cfg: MlpConfig):
    """(loss, grads): loss_fn and its gradient over the parameter list, as
    jax.value_and_grad(loss_fn) gives them; the params are left untouched."""
    leaves = [{k: v.detach().requires_grad_(True) for k, v in layer.items()}
              for layer in params]
    flat = [layer[k] for layer in leaves for k in ("w", "b")]
    with torch.enable_grad():
        loss = loss_fn(leaves, x, y, cfg)
        grads = torch.autograd.grad(loss, flat)
    return loss.detach(), [{"w": grads[2 * i], "b": grads[2 * i + 1]}
                           for i in range(len(leaves))]


def train_step(params, x, y, cfg: MlpConfig, lr: float = 1e-3):
    """One SGD step, p - lr * g in the parameter dtype: (new_params, loss)."""
    loss, grads = loss_and_grads(params, x, y, cfg)
    with torch.no_grad():
        new = [{k: (p - lr * g[k]).to(p.dtype) for k, p in layer.items()}
               for layer, g in zip(params, grads)]
    return new, loss


# ---------------------------------------------------------------------------
# splitSGD: bf16 master-weight training without f32 storage (the reference's
# equation_splitSGD.c use case: the f32 weight is held as two bf16 halves —
# the truncated high part and the residual low part — updated in f32 and
# re-split; the split uses integer bit ops, as the reference's does)
# ---------------------------------------------------------------------------

def split_f32(w):
    """f32 -> (hi, lo) bf16 pair with hi + lo == w up to 2^-16 rel."""
    hf = _trunc_f32_to_bf16_f32(w.float())
    return hf.to(torch.bfloat16), (w - hf).to(torch.bfloat16)


def combine_f32(hi, lo):
    return hi.float() + lo.float()


def split_sgd_update(hi, lo, grad, lr: float):
    """One splitSGD step: recombine, update in f32, re-split."""
    w = combine_f32(hi, lo) - lr * grad.float()
    return split_f32(w)


def split_params(params):
    return [{"w": split_f32(layer["w"].float()),
             "b": split_f32(layer["b"].float())} for layer in params]


def split_sgd_train_step(split_ps, x, y, cfg: MlpConfig, lr: float = 1e-3):
    """Train step over split-precision parameters: forward and backward run
    in bf16 (the hi halves), the update keeps f32 effective precision."""
    hi_params = [{"w": layer["w"][0], "b": layer["b"][0]}
                 for layer in split_ps]
    loss, grads = loss_and_grads(hi_params, x, y, cfg)
    with torch.no_grad():
        new_ps = [{"w": split_sgd_update(*layer["w"], g["w"], lr),
                   "b": split_sgd_update(*layer["b"], g["b"], lr)}
                  for layer, g in zip(split_ps, grads)]
    return new_ps, loss
