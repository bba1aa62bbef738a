"""Device meshes, process groups and sharded operands on torch.distributed.

The port of `libxsmm_tpu/parallel/mesh.py`. A mesh is a DeviceMesh
(`init_device_mesh`) over the ranks of one process group, with named axes;
each axis has a process group of its own, which the bodies of the parallel
layer hand to the port's collectives (parallel/collectives.py).

Operands follow the reference's contract of global arrays: `shard(x, mesh,
spec)` (the reference's `jax.device_put` with a NamedSharding) takes the
caller's full tensor, cuts this rank's block locally and wraps it as a
DTensor (`DTensor.from_local`): no collective is issued, as device_put from
the host issues none. A PartitionSpec names, for each tensor dimension, the
mesh axis (or the tuple of axes, major first) it is split over, or None.

Backends: NCCL for the card, gloo for the CPU, unless the caller names one.
The one-card machine runs NCCL as a one-rank world; several ranks on one
card run over gloo, chosen by the caller (NCCL refuses two ranks on one
card), and the collectives stage card tensors through host memory there
(parallel/collectives.py).
"""

from __future__ import annotations

import atexit
import math
import os
import shutil
import tempfile
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class PartitionSpec(tuple):
    """Per tensor dimension: None (not split), an axis name, or a tuple of
    axis names (split over their product, the first axis major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        # pickle rebuilds a tuple subclass from these: the entries, not
        # the tuple of them
        return tuple(self)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def distributed_init(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device_type: str = "cuda") -> None:
    """init_process_group for this process; a no-op when the process group
    is already up.

    coordinator is the init method (`tcp://localhost:<port>` or
    `file://<path>`), num_processes the world size, process_id this rank.
    Without a coordinator a one-rank world is made from a FileStore in a
    temporary directory, so a plain script can build a mesh of one rank.
    backend defaults to NCCL for device_type "cuda", gloo for "cpu"."""
    if dist.is_initialized():
        return
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    world = int(num_processes or 1)
    rank = int(process_id or 0)
    if coordinator is None:
        if world != 1:
            raise ValueError(f"a world of {world} processes needs a "
                             f"coordinator (tcp:// or file://)")
        tmp = tempfile.mkdtemp(prefix="xsmm_store_")
        atexit.register(shutil.rmtree, tmp, True)
        coordinator = "file://" + os.path.join(tmp, "store")
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", rank
                                       % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=coordinator, rank=rank,
                            world_size=world, **kw)


class Mesh:
    """A named mesh of ranks: `shape` maps each axis name to its size, in
    the order given (the last axis the fastest varying, as the reference
    lays its ICI axis last). Built by make_mesh."""

    def __init__(self, device_mesh, axis_names: Tuple[str, ...],
                 sizes: Tuple[int, ...]):
        self.device_mesh = device_mesh
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(axis_names, sizes))
        self.device_type = device_mesh.device_type
        if self.device_type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = torch.device(self.device_type)

    def group(self, axis: str):
        """The process group of `axis` that holds this rank."""
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis` (jax.lax.axis_index)."""
        return self.device_mesh.get_local_rank(axis)

    def backend(self) -> str:
        return dist.get_backend(self.device_mesh.get_group(
            self.axis_names[0]))

    def __repr__(self):
        return f"Mesh({self.shape}, {self.device_type})"


def make_mesh(axis_shapes: Sequence[Tuple[str, int]] = None,
              device_type: str = "cuda",
              backend: Optional[str] = None) -> Mesh:
    """Build a Mesh from (axis_name, size) pairs over the ranks of the
    process group (made for one rank when none is up); defaults to 1-D "x"
    over every rank. Axis order should put the fastest-varying
    (NVLink-adjacent) axis last. The mesh spans the whole world."""
    distributed_init(backend=backend, device_type=device_type)
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if axis_shapes is None:
        axis_shapes = [("x", world)]
    names = tuple(a for a, _ in axis_shapes)
    sizes = tuple(int(s) for _, s in axis_shapes)
    total = math.prod(sizes)
    if total > world:
        raise ValueError(f"mesh wants {total} devices, have {world}")
    if total != world:
        raise ValueError(f"a mesh of {total} ranks in a world of {world}: "
                         f"the port's meshes span the whole world")
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    dm = init_device_mesh(device_type, sizes, mesh_dim_names=names)
    return Mesh(dm, names, sizes)


class NamedSharding:
    """A mesh and a PartitionSpec: how a global tensor lies on the mesh."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def placements(self, ndim: int):
        """The DTensor placements of the spec, one per mesh axis."""
        from torch.distributed.tensor import Replicate, Shard
        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        out = []
        for axis in self.mesh.axis_names:
            dims = [d for d, e in enumerate(spec)
                    if e == axis or (isinstance(e, tuple) and axis in e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return out

    def local_slices(self, shape) -> Tuple[slice, ...]:
        """This rank's block of a global tensor of `shape`."""
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        out = []
        for dim, entry in enumerate(spec):
            if entry is None:
                out.append(slice(None))
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            order = [a for a in self.mesh.axis_names if a in axes]
            if list(axes) != order:
                raise ValueError(f"axes {axes} of dimension {dim} must "
                                 f"follow the mesh's order {order}")
            parts, idx = 1, 0
            for a in axes:
                parts *= self.mesh.shape[a]
                idx = idx * self.mesh.shape[a] + self.mesh.index(a)
            if shape[dim] % parts:
                raise ValueError(f"dimension {dim} of size {shape[dim]} "
                                 f"does not split over {parts} ranks")
            n = shape[dim] // parts
            out.append(slice(idx * n, (idx + 1) * n))
        return tuple(out)


def _stride(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of `shape`."""
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= int(n)
    return tuple(reversed(out))


def shard(x, mesh: Mesh, spec: PartitionSpec):
    """Place a global tensor on the mesh (the reference's device_put with a
    NamedSharding): this rank's block, cut locally and moved to the mesh's
    device, as a DTensor. Issues no collective."""
    return device_put(x, NamedSharding(mesh, spec))


def device_put(x, sharding: NamedSharding):
    """shard(x, sharding.mesh, sharding.spec)."""
    from torch.distributed.tensor import DTensor
    x = torch.as_tensor(x)
    local = x[sharding.local_slices(x.shape)].to(sharding.mesh.device)
    return DTensor.from_local(local.contiguous(),
                              sharding.mesh.device_mesh,
                              sharding.placements(x.dim()), run_check=False,
                              shape=x.shape, stride=_stride(x.shape))


def local(x, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of `x`: a DTensor's local tensor, or the block of
    a global tensor cut as shard() cuts it (on the mesh's device)."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return x.to_local()
    x = torch.as_tensor(x)
    return x[sharding.local_slices(x.shape)].to(sharding.mesh.device)


def wrap(local_tensor: torch.Tensor, sharding: NamedSharding, shape):
    """A DTensor of global `shape` from this rank's block (no collective)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local_tensor, sharding.mesh.device_mesh,
                              sharding.placements(len(shape)),
                              run_check=False, shape=torch.Size(shape),
                              stride=_stride(shape))
