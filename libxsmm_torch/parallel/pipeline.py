"""Pipeline parallelism (pp) over a mesh axis: GPipe-style microbatching.

The port of `libxsmm_tpu/parallel/pipeline.py`. Stage weights stay on
their rank; activations hop stage to stage on a `ppermute` ring
(parallel/collectives.py). The whole M-microbatch fill/steady/drain
schedule is a Python loop of T = M + P - 1 ticks (the reference's
fori_loop):

    tick t: stage p computes microbatch (t - p) when 0 <= t - p < M,
            then rotates its activation to stage p + 1.

Each stage is the library's fused layer pattern, matmul + bias + the
activation (ops.eltwise.apply_unary_op), accumulated in f32 and rounded
once to the activation type.

The graph is the same shape on every rank, as the reference's
`jnp.where` selects keep it: stage 0 selects its feed over the received
carry and the last stage its output over the slot's old value with
torch.where on a per-rank condition, so every rank records the same
operations and its backward issues the same collectives in the same order
(a Python `if` on the rank would leave a reverse send unmatched). The final
tick's rotation has no consumer on any rank; its backward runs nowhere.

Differentiable end to end: ppermute's backward is the reverse rotation, so
autograd derives the mirrored drain/fill ladder. Under pp x dp the stage
weights are replicated over dp, and their gradients are all-reduced over
the dp group in the train step (the reference gets that sum from
shard_map's transpose; here it is explicit).

Comm model (per device, per forward): T rotations of one (mb/dp, d)
microbatch. Outputs are not broadcast: the forward returns a DTensor whose
pp placement is Partial (a sum), since every stage but the last holds
zeros, so any movement is left to the consumer, as the reference leaves
its last-stage slice to the use site.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..descriptor import UnaryFlags, UnaryType
from ..ops.eltwise import apply_unary_op
from . import collectives as C
from .mesh import Mesh, NamedSharding, PartitionSpec as P, local, shard, wrap


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """n_stages chained (d -> d) fused layers, one per pp-mesh rank."""
    dim: int = 64
    n_stages: int = 4
    n_micro: int = 8          # microbatches per global batch (>= n_stages)
    micro_batch: int = 8      # rows per microbatch
    activation: UnaryType = UnaryType.GELU
    dtype: str = "float32"


def _torch_dtype(cfg: PipelineConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def pipeline_comm_bytes_per_device(cfg: PipelineConfig, dp: int = 1) -> int:
    """Analytic per-device comm volume of one forward: one (mb, d)
    activation rotation per tick, T = M + P - 1 ticks; under a pp x dp
    mesh each rank rotates only its mb/dp row slice."""
    if cfg.micro_batch % dp:
        raise ValueError(f"micro_batch={cfg.micro_batch} must divide over "
                         f"dp={dp}")
    isz = _torch_dtype(cfg).itemsize
    ticks = cfg.n_micro + cfg.n_stages - 1
    return ticks * (cfg.micro_batch // dp) * cfg.dim * isz


def init_params(cfg: PipelineConfig, seed: int = 0, device=None) -> dict:
    """The reference's seeded weights (the same arrays, rounded once to
    cfg.dtype) on `device` (the card by default)."""
    from ..device import resolve_device
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((cfg.n_stages, cfg.dim, cfg.dim)) / np.sqrt(
        cfg.dim)
    dev, dt = resolve_device(device), _torch_dtype(cfg)
    return {"w": torch.as_tensor(w).to(device=dev, dtype=dt),
            "b": torch.zeros((cfg.n_stages, cfg.dim), dtype=dt, device=dev)}


def params_from_numpy(params, device=None) -> dict:
    """The reference's parameters (numpy arrays: np.asarray of each JAX
    array) as the port's, bit for bit (bf16 included)."""
    from ..dtypes import Datatype
    from ..interop import tensor_from_numpy
    types = {"float32": Datatype.F32, "bfloat16": Datatype.BF16}
    out = {}
    for name in ("w", "b"):
        arr = np.asarray(params[name])
        out[name] = tensor_from_numpy(arr, types[arr.dtype.name], device)
    return out


def _stage_layer(w, b, x, cfg: PipelineConfig):
    """One stage = the fused brgemm_ext pattern (matmul+bias+activation)."""
    acc = torch.matmul(x.float(), w.float()) + b.float()
    acc = apply_unary_op(cfg.activation, UnaryFlags.NONE, acc)
    return acc.to(x.dtype)


def reference_forward(params: dict, xs, cfg: PipelineConfig):
    """Sequential (unpipelined) oracle: xs (M, mb, d) -> (M, mb, d)."""
    x = xs
    for p in range(cfg.n_stages):
        x = _stage_layer(params["w"][p], params["b"][p], x, cfg)
    return x


def _geometry(cfg: PipelineConfig, mesh: Mesh, axis: str, dp_axis):
    """(P, M, rows a rank, T), refusing what the reference refuses."""
    pn = mesh.shape[axis]
    if pn != cfg.n_stages:
        raise ValueError(f"n_stages={cfg.n_stages} must equal the pp mesh "
                         f"extent {pn} (one resident stage per device)")
    m, mb = cfg.n_micro, cfg.micro_batch
    if m < pn:
        raise ValueError(f"n_micro={m} < n_stages={pn}: the pipeline would "
                         f"be all bubble")
    if dp_axis is not None:
        dpn = mesh.shape[dp_axis]
        if mb % dpn:
            raise ValueError(f"micro_batch={mb} must divide over "
                             f"dp={dpn}")
        mb //= dpn
    return pn, m, mb, m + pn - 1


def _shardings(mesh: Mesh, axis: str, dp_axis):
    xspec = P(None, dp_axis, None) if dp_axis is not None else P()
    return (NamedSharding(mesh, P(axis, None, None)),
            NamedSharding(mesh, P(axis, None)), NamedSharding(mesh, xspec))


def _local_forward(w, b, xs, cfg, mesh, axis, pn, m, mb, ticks):
    """One rank's GPipe schedule: w (d, d) and b (d,) its stage, xs its
    (M, mb, d) rows. Returns (M, mb, d): the outputs on the last stage,
    zeros elsewhere."""
    group, p = mesh.group(axis), mesh.index(axis)
    perm = C.ring_perm(pn)
    dev = xs.device
    is_first = torch.tensor(p == 0, device=dev)
    carry = torch.zeros((mb, cfg.dim), dtype=xs.dtype, device=dev)
    outs = [torch.zeros((mb, cfg.dim), dtype=xs.dtype, device=dev)
            for _ in range(m)]
    for t in range(ticks):
        # stage 0 takes microbatch t (clamped in the drain), the others the
        # activation rotated in at the end of the previous tick
        xin = torch.where(is_first, xs[min(t, m - 1)], carry)
        y = _stage_layer(w, b, xin, cfg)
        # the last stage completes microbatch t - (P-1) once t >= P-1
        oidx = min(max(t - (pn - 1), 0), m - 1)
        live = torch.tensor(p == pn - 1 and t >= pn - 1, device=dev)
        outs[oidx] = torch.where(live, y, outs[oidx])
        carry = C.ppermute(y, group, perm)
    return torch.stack(outs)


def make_pipeline_forward(cfg: PipelineConfig, mesh: Mesh, axis: str = "pp",
                          dp_axis: str = None):
    """Build fn(params, xs) -> ys running the GPipe schedule over
    mesh[axis]; params one stage per rank (shard_params, or full tensors
    cut locally), xs (M, mb, d) replicated (or, with dp_axis, its rows
    split over dp). ys is a DTensor (M, mb, d), Partial over pp (the last
    stage holds it, the others zeros) and split like xs over dp."""
    from torch.distributed.tensor import DTensor, Partial
    pn, m, mb, ticks = _geometry(cfg, mesh, axis, dp_axis)
    wsh, bsh, xsh = _shardings(mesh, axis, dp_axis)
    placements = [Partial() if a == axis else pl for a, pl in
                  zip(mesh.axis_names, xsh.placements(3))]

    def fn(params, xs):
        out = _local_forward(local(params["w"], wsh)[0],
                             local(params["b"], bsh)[0], local(xs, xsh),
                             cfg, mesh, axis, pn, m, mb, ticks)
        shape = (m, cfg.micro_batch, cfg.dim)
        return DTensor.from_local(out, mesh.device_mesh, placements,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=(shape[1] * shape[2], shape[2], 1))

    return fn


def shard_params(params: dict, mesh: Mesh, axis: str = "pp") -> dict:
    return {"w": shard(params["w"], mesh, P(axis, None, None)),
            "b": shard(params["b"], mesh, P(axis, None))}


def make_pipeline_value_and_grad(cfg: PipelineConfig, mesh: Mesh,
                                 axis: str = "pp", dp_axis: str = None):
    """fn(params, xs, ys) -> (loss, grads): the mean squared error of the
    pipelined forward over the global batch, on every rank, and the
    gradient of this rank's stage ({"w": (1, d, d), "b": (1, d)}, summed
    over dp), as jax.value_and_grad gives the reference's train step."""
    pn, m, mb, ticks = _geometry(cfg, mesh, axis, dp_axis)
    wsh, bsh, xsh = _shardings(mesh, axis, dp_axis)
    count = m * cfg.micro_batch * cfg.dim
    is_last = mesh.index(axis) == pn - 1

    def value_and_grad(params, xs, ys):
        w = local(params["w"], wsh).detach().requires_grad_(True)
        b = local(params["b"], bsh).detach().requires_grad_(True)
        with torch.enable_grad():
            pred = _local_forward(w[0], b[0], local(xs, xsh), cfg, mesh,
                                  axis, pn, m, mb, ticks)
            sq = torch.sum((pred.float() - local(ys, xsh).float()) ** 2)
            # only the last stage's rows are predictions: the others add
            # zero, through the same graph
            mine = torch.where(torch.tensor(is_last, device=sq.device), sq,
                               torch.zeros_like(sq)) / count
            gw, gb = torch.autograd.grad(mine, (w, b))
        loss = C.all_reduce(mine.detach(), mesh.group(axis))
        if dp_axis is not None:
            # the stage weights are replicated over dp: their gradients
            # (and the loss) sum over the dp group
            gw = C.all_reduce(gw, mesh.group(dp_axis))
            gb = C.all_reduce(gb, mesh.group(dp_axis))
            loss = C.all_reduce(loss, mesh.group(dp_axis))
        return loss, {"w": gw, "b": gb}

    return value_and_grad


def make_pipeline_train_step(cfg: PipelineConfig, mesh: Mesh,
                             axis: str = "pp", dp_axis: str = None,
                             lr: float = 1e-3):
    """The full train step (forward pipeline, backprop through the
    schedule, SGD) over mesh[axis] (optionally x dp_axis). Returns
    (step, x_sharding); step(params, xs, ys) -> (new_params, loss), with
    the loss on every rank and the new parameters placed as shard_params
    places them."""
    value_and_grad = make_pipeline_value_and_grad(cfg, mesh, axis, dp_axis)
    wsh, bsh, xsh = _shardings(mesh, axis, dp_axis)
    pn = mesh.shape[axis]

    def step(params, xs, ys):
        loss, grads = value_and_grad(params, xs, ys)
        new = {}
        with torch.no_grad():
            for name, sh in (("w", wsh), ("b", bsh)):
                p = local(params[name], sh)
                q = (p - lr * grads[name]).to(p.dtype)
                new[name] = wrap(q, sh, (pn,) + tuple(q.shape[1:]))
        return new, loss

    return step, xsh
