"""The explicit SPMD pieces of the port's sharded train steps.

New in the port, with no counterpart in the reference: where the JAX
package jits a whole train step over a mesh and lets GSPMD derive the
collectives from the shardings, the port's sharded steps (models/tpp_*.py
make_sharded_train_step) run their local math on the local blocks of
DTensors and issue every collective themselves, through
parallel/collectives.py, so each one is in its log. DTensor's own sharding
propagation never runs through a hand-written kernel.

  * column_linear / row_linear: Megatron's pair over a mesh axis. A
    column-parallel product takes an input replicated over the axis and
    this rank's columns of the weight (copy_to: identity forward, the
    input's gradient summed over the axis backward); a row-parallel
    product takes an input split on its features and this rank's rows of
    the weight, and sums the partial products over the axis (all_reduce:
    identity backward). Products accumulate in f32, as the models' own
    _linear does, and the sums are of f32 partials.
  * sgd_step: one SGD step over a tree of sharded parameters: the local
    blocks' gradients of a local loss term, summed over the axes a
    parameter's gradient is partial on (the dp gradient sum of parameters
    replicated over dp), then p - lr * g in the parameter dtype, placed
    back as DTensors of the same shardings.
  * place: shard_params-style placement of a parameter tree (a dict, or a
    list of dicts) through mesh.shard, one PartitionSpec a leaf.

The rule for gradients. Each rank's loss term is its share of the global
loss, except for terms computed from values that are replicated over an
axis (after an all_reduce), which every rank of that axis counts whole:
their gradient reaches each rank's own contribution once, through
all_reduce's identity backward. A gradient taken from a value replicated
over an axis is then whole on every rank of it and is not summed over that
axis; a gradient of a rank's own share is summed over the axes the loss is
split on.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple, Union

import torch

from . import collectives as C
from .mesh import Mesh, NamedSharding, local, shard, wrap

Tree = Union[Dict[str, object], List[Dict[str, object]]]


def axis_size(mesh: Mesh, axis) -> int:
    """The size of a mesh axis; 1 for None or an axis the mesh lacks."""
    return mesh.shape.get(axis, 1) if axis is not None else 1


def axis_index(mesh: Mesh, axis) -> int:
    """This rank's index along a mesh axis; 0 for None or an absent one."""
    return mesh.index(axis) if axis is not None and axis in mesh.shape \
        else 0


def group(mesh: Mesh, axis):
    """The process group of a mesh axis; None for None or an absent axis
    (the collectives over it are skipped: an axis of one)."""
    return mesh.group(axis) if axis is not None and axis in mesh.shape \
        else None


def present(mesh: Mesh, axes: Sequence) -> Tuple[str, ...]:
    """The axes among `axes` that the mesh has (None and absent dropped)."""
    return tuple(a for a in axes if a is not None and a in mesh.shape)


def ranks(mesh: Mesh, axes: Sequence) -> int:
    """The number of ranks over `axes` (those the mesh has)."""
    n = 1
    for axis in present(mesh, axes):
        n *= mesh.shape[axis]
    return n


def divide(n: int, parts: int, what: str) -> int:
    """n // parts; raises where the mesh axis does not divide n."""
    if parts <= 0 or n % parts:
        raise ValueError(f"{what}={n} does not divide over {parts} ranks")
    return n // parts


def column_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  group) -> torch.Tensor:
    """Column-parallel x @ w + b in f32: x (rows, d) replicated over the
    group, w this rank's (d, n / P) columns, b its (n / P,) bias; returns
    this rank's (rows, n / P) columns. The backward sums x's gradient over
    the group (copy_to). group None: a mesh without the axis, no
    collective."""
    x = x.float() if group is None else C.copy_to(x.float(), group)
    return x @ w.float() + b.float()[None, :]


def row_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               group) -> torch.Tensor:
    """Row-parallel x @ w + b in f32: x (rows, d / P) this rank's input
    features, w its (d / P, n) rows, b the replicated (n,) bias; the
    partial products are summed over the group (all_reduce), and the
    result is replicated over it. group None: no collective."""
    acc = x.float() @ w.float()
    if group is not None:
        acc = C.all_reduce(acc, group)
    return acc + b.float()[None, :]


# ------------------------------------------------------------ parameter trees

def _items(tree: Tree) -> List[Tuple[tuple, object]]:
    if isinstance(tree, dict):
        return [((k,), v) for k, v in tree.items()]
    return [((i, k), v) for i, layer in enumerate(tree)
            for k, v in layer.items()]


def _get(tree: Tree, path: tuple):
    return tree[path[0]] if len(path) == 1 else tree[path[0]][path[1]]


def _build(tree: Tree, values: Dict[tuple, object]) -> Tree:
    if isinstance(tree, dict):
        return {k: values[(k,)] for k in tree}
    return [{k: values[(i, k)] for k in layer}
            for i, layer in enumerate(tree)]


def shardings(mesh: Mesh, specs: Tree) -> Tree:
    """The NamedSharding of each leaf of a tree of PartitionSpecs."""
    return _build(specs, {path: NamedSharding(mesh, spec)
                          for path, spec in _items(specs)})


def place(params: Tree, mesh: Mesh, specs: Tree) -> Tree:
    """Each parameter (a global tensor) placed on the mesh by its spec
    (mesh.shard: this rank's block, as a DTensor; no collective)."""
    return _build(params, {path: shard(v, mesh, _get(specs, path))
                           for path, v in _items(params)})


def local_tree(params: Tree, shards: Tree) -> Tree:
    """This rank's block of each parameter (a DTensor's local tensor, or
    the block cut from a global tensor)."""
    return _build(params, {path: local(v, _get(shards, path))
                           for path, v in _items(params)})


def _sum_over(tensors: List[torch.Tensor], mesh: Mesh,
              axes: Sequence[str]) -> List[torch.Tensor]:
    """Each tensor summed over each of `axes`, the tensors of one dtype
    flattened into one buffer (one all-reduce a dtype and axis)."""
    out = list(tensors)
    for axis in axes:
        group = mesh.group(axis)
        for dt in sorted({t.dtype for t in out}, key=str):
            idx = [i for i, t in enumerate(out) if t.dtype == dt]
            flat = torch.cat([out[i].reshape(-1) for i in idx])
            flat = C.all_reduce(flat, group)
            for i, piece in zip(idx, torch.split(
                    flat, [out[i].numel() for i in idx])):
                out[i] = piece.view_as(out[i])
    return out


def total(share: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """A rank's share of a loss summed over the mesh axes it is split on,
    as a 0-d f32 tensor on every rank (no gradient)."""
    return _sum_over([share.detach().float().reshape(1)], mesh,
                     present(mesh, axes))[0].reshape(())


def sgd_step(params: Tree, shards: Tree, mesh: Mesh, lr: float,
             local_loss: Callable, grad_axes, loss_axes):
    """One SGD step over sharded parameters: (new_params, loss).

    local_loss(local_params) -> (term, share): `term` is differentiated
    with respect to this rank's parameter blocks; `share` is this rank's
    share of the loss, summed over `loss_axes` for the loss returned. The
    gradients are summed over `grad_axes` (a dict from the leaf's path to
    its axes, or one sequence of axes for every leaf), then p - lr * g in
    the parameter dtype, returned as DTensors of the parameters' shardings
    and global shapes."""
    items = _items(params)
    leaves = {path: local(v, _get(shards, path)).detach().requires_grad_(True)
              for path, v in items}
    with torch.enable_grad():
        term, share = local_loss(_build(params, leaves))
        grads = list(torch.autograd.grad(term, [leaves[p] for p, _ in items]))
    with torch.no_grad():
        by_axes: Dict[Tuple[str, ...], List[int]] = {}
        for i, (path, _) in enumerate(items):
            axes = (grad_axes.get(path, ()) if isinstance(grad_axes, dict)
                    else grad_axes)
            by_axes.setdefault(present(mesh, axes), []).append(i)
        for axes, idx in by_axes.items():
            for i, g in zip(idx, _sum_over([grads[i] for i in idx], mesh,
                                           axes)):
                grads[i] = g
        loss = total(share, mesh, loss_axes)
        new = {}
        for (path, v), g in zip(items, grads):
            p_loc = leaves[path].detach()
            new[path] = wrap((p_loc - lr * g).to(p_loc.dtype),
                             _get(shards, path), tuple(v.shape))
    return _build(params, new), loss

