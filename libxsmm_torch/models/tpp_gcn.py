"""TPP-GCN: a graph convolutional network over a fixed sparse operator.

The port of `libxsmm_tpu/models/tpp_gcn.py`, single device. The propagate
step H' = act(Â·H·W + b) is a fixed-sparsity SpMM (the fsspmdm workload
shape: a sparse operator applied to a streaming dense right-hand side)
after a dense product. Â = D^-1/2 (A+I) D^-1/2 is fixed at model build, as
the reference bakes a pattern at kernel-create time, and stored block-CSR.

The BSR SpMM is torch ops, as the reference's is jnp: the nonzero blocks'
H block rows gathered, one batched block product accumulated in f32,
`index_add_` into the output block rows (jax.ops.segment_sum there). The
backward is torch autograd over the same ops (the reference's
jax.value_and_grad); no kernel of the port runs here.

Parameters are a list of {"w", "b"} dicts with the reference's layout
(w: (fan_in, fan_out)). Not ported yet: make_sharded_train_step (ROADMAP.md
queue 1, item 13).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..descriptor import UnaryFlags, UnaryType
from ..device import resolve_device
from ..ops.eltwise import apply_unary_op
from ..ops.sparse import BsrMatrix
from . import tpp_mlp


@dataclasses.dataclass(frozen=True)
class GcnConfig:
    in_dim: int = 64
    hidden: Tuple[int, ...] = (128,)
    out_dim: int = 16
    activation: UnaryType = UnaryType.RELU
    dtype: str = "float32"


def normalize_adjacency(adj: np.ndarray, block: int = 8) -> BsrMatrix:
    """Â = D^-1/2 (A + I) D^-1/2 (the Kipf-Welling propagation operator),
    stored BSR with the given block size (pattern fixed at build time)."""
    a = np.asarray(adj, np.float64)
    if a.shape[0] != a.shape[1]:
        raise ValueError("adjacency must be square")
    n = a.shape[0]
    if n % block:
        raise ValueError(f"nodes ({n}) must be divisible by block ({block})")
    a = a + np.eye(n)
    d = a.sum(axis=1)
    dm = 1.0 / np.sqrt(np.maximum(d, 1e-12))
    ahat = (a * dm[:, None]) * dm[None, :]
    return BsrMatrix.from_dense(ahat.astype(np.float32), block, block)


def _bsr_plan(bsr: BsrMatrix, device=None):
    """(rows, cols, blocks) of the nonzero blocks, on `device` (default:
    the GPU): each block's block row, block column and (br, bc) values."""
    dev = resolve_device(device)
    rows = np.repeat(np.arange(len(bsr.indptr) - 1), np.diff(bsr.indptr))
    return (torch.as_tensor(rows, device=dev),
            torch.as_tensor(bsr.indices.astype(np.int64), device=dev),
            torch.as_tensor(bsr.data, device=dev))


def bsr_spmm(plan, h: torch.Tensor, num_block_rows: int) -> torch.Tensor:
    """out = Â @ h, differentiable: h's block rows gathered per nonzero
    block, one batched block product (the blocks rounded to h's type, the
    products accumulated in f32), summed into the output block rows; the
    result in h's type."""
    rows, cols, blocks = plan
    br = blocks.shape[1]
    n = h.shape[1]
    gathered = h.reshape(-1, br, n)[cols]                    # (E, br, n)
    contrib = torch.bmm(blocks.to(h.dtype).float(), gathered.float())
    acc = contrib.new_zeros((num_block_rows, br, n)).index_add(0, rows,
                                                               contrib)
    return acc.reshape(num_block_rows * br, n).to(h.dtype)


def init_params(cfg: GcnConfig, seed: int = 0,
                device=None) -> List[Dict[str, torch.Tensor]]:
    """Weights from numpy's default_rng(seed) in the reference's order,
    scaled by 1/sqrt(fan_in), in cfg.dtype; zero biases."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    rng = np.random.default_rng(seed)
    dims = (cfg.in_dim, *cfg.hidden, cfg.out_dim)
    return [{"w": torch.as_tensor(rng.standard_normal((dims[i], dims[i + 1]))
                                  / np.sqrt(dims[i])).to(device=dev, dtype=dt),
             "b": torch.zeros((dims[i + 1],), dtype=dt, device=dev)}
            for i in range(len(dims) - 1)]


def params_from_numpy(params, device=None) -> List[Dict[str, torch.Tensor]]:
    """The reference's parameter list (numpy arrays: np.asarray of each JAX
    array) as the port's, bit for bit (bf16 included)."""
    return tpp_mlp.params_from_numpy(params, device)


def forward(params, plan, num_block_rows: int, h: torch.Tensor,
            cfg: GcnConfig) -> torch.Tensor:
    """Each layer: h @ w accumulated in f32 and rounded to h's type, the
    propagate Â (.), the bias added in f32, the activation between layers,
    the result rounded to h's type."""
    for i, layer in enumerate(params):
        hw = torch.matmul(h.float(), layer["w"].float()).to(h.dtype)
        hw = bsr_spmm(plan, hw, num_block_rows)
        acc = hw.float() + layer["b"].float()[None, :]
        if i < len(params) - 1:
            acc = apply_unary_op(cfg.activation, UnaryFlags.NONE, acc)
        h = acc.to(h.dtype)
    return h


def loss_fn(params, plan, num_block_rows: int, h, labels,
            cfg: GcnConfig) -> torch.Tensor:
    """Mean softmax cross-entropy over all nodes (labels: int (n,))."""
    logits = forward(params, plan, num_block_rows, h, cfg).float()
    logz = torch.logsumexp(logits, dim=1)
    picked = logits.gather(1, labels.long()[:, None])[:, 0]
    return torch.mean(logz - picked)


def loss_and_grads(params, plan, num_block_rows: int, h, labels,
                   cfg: GcnConfig):
    """(loss, grads): loss_fn and its gradient over the parameter list, as
    jax.value_and_grad(loss_fn) gives them; the params are left untouched."""
    leaves = [{k: v.detach().requires_grad_(True) for k, v in layer.items()}
              for layer in params]
    flat = [layer[k] for layer in leaves for k in ("w", "b")]
    with torch.enable_grad():
        loss = loss_fn(leaves, plan, num_block_rows, h, labels, cfg)
        grads = torch.autograd.grad(loss, flat)
    return loss.detach(), [{"w": grads[2 * i], "b": grads[2 * i + 1]}
                           for i in range(len(leaves))]


def train_step(params, plan, num_block_rows: int, h, labels, cfg: GcnConfig,
               lr: float = 1e-2):
    """One SGD step, p - lr * g in the parameter dtype: (new_params, loss)."""
    loss, grads = loss_and_grads(params, plan, num_block_rows, h, labels,
                                 cfg)
    with torch.no_grad():
        new = [{k: (p - lr * g[k]).to(p.dtype) for k, p in layer.items()}
               for layer, g in zip(params, grads)]
    return new, loss
