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
(w: (fan_in, fan_out)).

make_sharded_train_step runs over a 1-D node mesh ("sp") of the port's
parallel layer: H and the labels split by node rows, the weights
replicated. The halo gather the reference leaves to GSPMD is written out:
each layer all-gathers h @ W over sp (differentiable: its backward is a
reduce-scatter) before this rank's block rows of the propagate.
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
from ..parallel import collectives as C
from ..parallel import spmd
from ..parallel.mesh import NamedSharding, P, local


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


def _local_plan(plan, r0: int, r1: int):
    """The nonzero blocks of block rows [r0, r1), their rows counted from
    r0: a rank's share of the propagate."""
    rows, cols, blocks = plan
    keep = (rows >= r0) & (rows < r1)
    return rows[keep] - r0, cols[keep], blocks[keep]


def make_sharded_train_step(cfg: GcnConfig, mesh, plan,
                            num_block_rows: int, lr: float = 1e-2):
    """The train step over a 1-D node mesh: (step, hsharding, lsharding).
    H (n, in_dim) and the labels (n,) are node-sharded over "sp" (placed by
    hsharding and lsharding, or global tensors cut locally), the weights
    replicated; step(params, h, labels) -> (new_params, loss). Each layer
    all-gathers h @ W over sp and multiplies this rank's block rows of the
    operator; the loss is the mean over all nodes, the gradients summed
    over sp. The plan is bound on the mesh's device once, here, and cut to
    this rank's block rows."""
    hsharding = NamedSharding(mesh, P("sp", None))
    lsharding = NamedSharding(mesh, P("sp"))
    sp = spmd.axis_size(mesh, "sp")
    rows_l = spmd.divide(num_block_rows, sp, "block rows (nodes / block)")
    r0 = spmd.axis_index(mesh, "sp") * rows_l
    plan_dev = tuple(a.to(mesh.device) for a in plan)
    mine = _local_plan(plan_dev, r0, r0 + rows_l)
    group = spmd.group(mesh, "sp")
    shards = spmd.shardings(mesh, [{"w": P(None), "b": P(None)}
                                   for _ in range(len(cfg.hidden) + 1)])

    def local_forward(lp, h):
        for i, layer in enumerate(lp):
            hw = torch.matmul(h.float(), layer["w"].float()).to(h.dtype)
            if group is not None:
                hw = C.all_gather(hw, group, axis=0)
            hw = bsr_spmm(mine, hw, rows_l)
            acc = hw.float() + layer["b"].float()[None, :]
            if i < len(lp) - 1:
                acc = apply_unary_op(cfg.activation, UnaryFlags.NONE, acc)
            h = acc.to(h.dtype)
        return h

    def step(params, h, labels):
        n = h.shape[0]
        hl, ll = local(h, hsharding), local(labels, lsharding)

        def local_loss(lp):
            logits = local_forward(lp, hl).float()
            logz = torch.logsumexp(logits, dim=1)
            picked = logits.gather(1, ll.long()[:, None])[:, 0]
            term = torch.sum(logz - picked) / n
            return term, term

        return spmd.sgd_step(params, shards, mesh, lr, local_loss, ("sp",),
                             ("sp",))

    return step, hsharding, lsharding
