"""Distributed BSR SpMM: block-row partitioning + ring halo exchange.

The port of `libxsmm_tpu/parallel/spmm_dist.py`: C = A_sparse @ X with A
block-row partitioned across a mesh axis and X row-partitioned the same
way. A sparse row may reference any column of X, so segments of X rotate
around the ring (collectives.ppermute) while each rank multiplies the
blocks that reference the segment it currently holds:

    step s: rank d holds the X segment owned by (d - s) mod P
            C_local += A_blocks[cols in segment (d-s)%P] @ X_seg
            X_seg -> neighbour (d+1)

The per-(rank, step) block lists are built once, in numpy (`_build_plan`,
the reference's), padded to a common length L. Each step is one batched
product of the step's (L, br, bc) blocks with their (L, bc, n) X blocks in
f32 and a segment sum into the rank's rows (`_step_contrib`, torch ops: the
reference's is jnp, no Pallas kernel). f32 means f32: the products run with
PyTorch's default, TF32 off.

Schedules (comm=): "ring" rotates after each step's multiply; "ring2" is
the double-buffered ring, whose next segment's rotation is issued before
the step's multiply and waited after it (collectives.ppermute_start), one
more hop and one more resident segment; "allgather" gathers the whole X and
multiplies the densified row band once. DistributedBsrSpmm2Level runs the
ring on the "ici" axis of a ("dcn", "ici") mesh, X replicated across "dcn".

overlap_report reads one call's collective log: whether the step's
rotation was issued before the first multiply (prefetch_issue_order), how
many rotations were issued as a start with a separate wait (n_start,
async_split), and overlap_verified: "backend-synchronous" on gloo; on NCCL,
whether a profiler trace of one call shows a collective's kernel running
beside a compute kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..dtypes import Datatype, to_torch
from ..ops.sparse import BsrMatrix
from . import collectives as C
from .mesh import Mesh, NamedSharding, PartitionSpec as P, local, wrap


@dataclasses.dataclass
class _PlanArrays:
    rows: np.ndarray    # (P, S, L) local block-row of each scheduled block
    cols: np.ndarray    # (P, S, L) block-col WITHIN the step's segment
    vidx: np.ndarray    # (P, S, L) index into the device's value store
    mask: np.ndarray    # (P, S, L) 1.0 for real blocks, 0.0 for padding
    vals: np.ndarray    # (P, Lv, br, bc) per-device block values (padded)
    l_max: int
    lv_max: int


def _build_plan(a: BsrMatrix, num_devices: int,
                ring_size: int = 0) -> _PlanArrays:
    """Block schedules for `num_devices` row bands with a halo ring of
    `ring_size` X segments (== num_devices for a flat mesh; == the ICI
    axis size for a two-level DCN x ICI mesh, where each DCN group runs
    an independent ring and the device's ICI rank is d % ring_size)."""
    if ring_size == 0:
        ring_size = num_devices
    m, k = a.shape
    mb = m // a.br
    kb = k // a.bc
    if mb % num_devices or kb % ring_size:
        raise ValueError(f"block grid ({mb}x{kb}) not divisible by "
                         f"{num_devices} devices / ring {ring_size}")
    mb_loc = mb // num_devices
    kb_seg = kb // ring_size

    # per-device block store
    dev_blocks = [[] for _ in range(num_devices)]   # (row_loc, col, data)
    for ib in range(mb):
        d = ib // mb_loc
        s, e = int(a.indptr[ib]), int(a.indptr[ib + 1])
        for l in range(s, e):
            dev_blocks[d].append((ib - d * mb_loc, int(a.indices[l]),
                                  a.data[l]))

    lv_max = max(1, max(len(bl) for bl in dev_blocks))
    vals = np.zeros((num_devices, lv_max, a.br, a.bc), a.data.dtype)
    sched = [[[] for _ in range(ring_size)] for _ in range(num_devices)]
    for d in range(num_devices):
        rank = d % ring_size               # position within the ICI ring
        for vi, (r, c, blk) in enumerate(dev_blocks[d]):
            vals[d, vi] = blk
            owner = c // kb_seg            # which ring rank owns this segment
            step = (rank - owner) % ring_size
            sched[d][step].append((r, c % kb_seg, vi))

    l_max = max(1, max(len(sched[d][s]) for d in range(num_devices)
                       for s in range(ring_size)))
    rows = np.zeros((num_devices, ring_size, l_max), np.int32)
    cols = np.zeros_like(rows)
    vidx = np.zeros_like(rows)
    mask = np.zeros(rows.shape, np.float32)
    for d in range(num_devices):
        for s in range(ring_size):
            for j, (r, c, vi) in enumerate(sched[d][s]):
                rows[d, s, j] = r
                cols[d, s, j] = c
                vidx[d, s, j] = vi
                mask[d, s, j] = 1.0
    return _PlanArrays(rows, cols, vidx, mask, vals, l_max, lv_max)


def _step_contrib(vals0, rows0, cols0, vidx0, mask0, s, x_seg,
                  kb_seg, bc, n, mb_loc, br):
    """One ring step's local block multiply, shared by the plain ring, the
    double-buffered ring2 and the two-level build: gathers the step's
    scheduled blocks and their X segment block-columns, multiplies in f32,
    masks the padding slots and segment-sums into the rank's (mb_loc*br, n)
    partial."""
    blocks = vals0[vidx0[s]].float()                  # (L, br, bc)
    xs = x_seg.reshape(kb_seg, bc, n)
    xg = xs[cols0[s]].float()                         # (L, bc, n)
    contrib = torch.bmm(blocks, xg) * mask0[s][:, None, None]
    accb = torch.zeros((mb_loc, br, n), dtype=torch.float32,
                       device=contrib.device)
    accb.index_add_(0, rows0[s], contrib)
    C.mark_compute()
    return accb.reshape(mb_loc * br, n)


def _ring_loop(comm, x_local, lp, group, ring, mb_loc, a, n):
    """The halo ring over `group` (ring ranks): each step multiplies the
    blocks that reference the resident X segment, and the segment moves to
    the next rank after the multiply ("ring") or, double-buffered, the next
    segment is issued before it and waited after ("ring2"). Returns the
    rank's (mb_loc * br, n) rows in f32."""
    kb_seg = (a.shape[1] // a.bc) // ring
    perm = C.ring_perm(ring)

    def compute(s, x_seg):
        return _step_contrib(lp["vals"], lp["rows"], lp["cols"], lp["vidx"],
                             lp["mask"], s, x_seg, kb_seg, a.bc, n, mb_loc,
                             a.br)

    acc = torch.zeros((mb_loc * a.br, n), dtype=torch.float32,
                      device=x_local.device)
    if comm == "ring":
        x_seg = x_local
        for s in range(ring):
            acc = acc + compute(s, x_seg)
            # rotate the segment to the next rank
            x_seg = C.ppermute_start(x_seg, group, perm,
                                     started=False).wait()[0]
        return acc
    # double-buffered: the next segment is in flight BEFORE this step's
    # multiply consumes `cur`
    fly = C.ppermute_start(x_local, group, perm)
    cur = x_local
    for s in range(ring):
        nxt = fly.wait()[0]
        fly = C.ppermute_start(nxt, group, perm)
        acc = acc + compute(s, cur)
        cur = nxt
    fly.wait()
    return acc


def _port_bsr(bsr) -> BsrMatrix:
    """The port's BsrMatrix from a reference one (its numpy fields)."""
    return BsrMatrix(tuple(bsr.shape), int(bsr.br), int(bsr.bc),
                     np.asarray(bsr.indptr), np.asarray(bsr.indices),
                     np.asarray(bsr.data))


def _overlap_report(run, backend: str, device: torch.device) -> dict:
    """The schedule evidence of one call (see the module docstring)."""
    start, marks = len(C.log), C._marks[0]
    if backend == "nccl":
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize(device)
        spans = [(e.time_range.start, e.time_range.end,
                  "nccl" in e.name.lower()) for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        comm = [sp for sp in spans if sp[2]]
        comp = [sp for sp in spans if not sp[2]]
        overlap = any(a0 < b1 and b0 < a1 for a0, a1, _ in comm
                      for b0, b1, _ in comp)
    else:
        run()
        overlap = "backend-synchronous"
    entries = C.log[start:]
    perms = [e for e in entries if e["kind"] == "collective_permute"]
    n_start = sum(e["started"] for e in perms)
    return {"async_split": n_start > 0,
            "overlap_verified": overlap,
            "prefetch_issue_order": bool(perms)
            and perms[0]["computes_before"] == marks,
            "n_start": n_start,
            "trace_available": backend == "nccl"}


class DistributedBsrSpmm:
    """Handle for C = A_bsr @ X over a 1-D mesh axis.

    Usage:
        mesh = make_mesh([("x", 8)])
        spmm = DistributedBsrSpmm(a_bsr, n, mesh)
        c = spmm(x)        # x: (k, n), a DTensor row-sharded over "x" or
                           # a full tensor (cut locally)

    The returned C (m, n) is a DTensor row-sharded over the same axis.
    """

    def __init__(self, a: BsrMatrix, n: int, mesh: Mesh, axis: str = "x",
                 dtype: Optional[Datatype] = None, comm: str = "ring"):
        """comm: "ring" rotates X segments via ppermute; "ring2" is the
        double-buffered ring (segment s+1 permuted while segment s
        multiplies, one more hop); "allgather" gathers the full X on every
        rank and multiplies the densified local row band once."""
        if comm not in ("ring", "ring2", "allgather"):
            raise ValueError(f"unknown comm strategy {comm}")
        self.a = a
        self.n = n
        self.mesh = mesh
        self.axis = axis
        self.comm = comm
        self.num_devices = mesh.shape[axis]
        self.dtype = to_torch(Datatype.F32 if dtype is None else dtype)
        m, k = a.shape
        self.m, self.k = m, k
        self.nnz = a.nnz
        self.flops = 2 * a.nnz * n
        self.x_sharding = NamedSharding(mesh, P(axis, None))
        self._group = mesh.group(axis)
        dev, me = mesh.device, mesh.index(axis)
        if comm in ("ring", "ring2"):
            plan = _build_plan(a, self.num_devices)
            self._plan = plan
            self._local = _local_plan(plan, me, self.dtype, dev)
        else:
            if (m // a.br) % self.num_devices:
                raise ValueError("block rows not divisible by devices")
            if k % self.num_devices:
                raise ValueError(
                    f"allgather needs k ({k}) divisible by the device "
                    f"count ({self.num_devices}) to shard X rows")
            band = m // self.num_devices
            dense = a.to_dense().astype(np.float32)[me * band:
                                                    (me + 1) * band]
            self.a_dense = torch.as_tensor(dense).to(dev, self.dtype)

    @classmethod
    def from_reference(cls, bsr, n: int, mesh: Mesh, **kw):
        """The handle for a reference BsrMatrix (its numpy arrays carried
        across), so both packages multiply the same matrix."""
        return cls(_port_bsr(bsr), n, mesh, **kw)

    def _ring(self, x_local):
        num = self.num_devices
        return _ring_loop(self.comm, x_local, self._local, self._group, num,
                          (self.m // self.a.br) // num, self.a, self.n)

    def _allgather(self, x_local):
        x_full = C.all_gather(x_local, self._group, axis=0)
        return self.a_dense.float() @ x_full.float()

    def __call__(self, x):
        x_local = local(x, self.x_sharding).to(self.dtype)
        acc = (self._allgather(x_local) if self.comm == "allgather"
               else self._ring(x_local))
        return wrap(acc.to(self.dtype), NamedSharding(self.mesh,
                                                      P(self.axis, None)),
                    (self.m, self.n))

    def comm_bytes_per_device(self) -> int:
        """Analytic per-device communication volume per call: ring P
        segments of (k/P, n) (the final rotation restores ownership),
        ring2 P + 1 (the prefetch hop), allgather the other P - 1."""
        seg = (self.k // self.num_devices) * self.n * self.dtype.itemsize
        if self.comm == "ring":
            return self.num_devices * seg
        if self.comm == "ring2":
            return (self.num_devices + 1) * seg
        return (self.num_devices - 1) * seg

    def overlap_report(self, x) -> dict:
        """Run one call and report the schedule evidence from its
        collective log (and, on NCCL, a profiler trace)."""
        return _overlap_report(lambda: self(x), self.mesh.backend(),
                               self.mesh.device)


def _local_plan(plan: _PlanArrays, d: int, dtype, dev) -> dict:
    """Rank d's slice of the plan, on its device."""
    return {"rows": torch.as_tensor(plan.rows[d], dtype=torch.int64,
                                    device=dev),
            "cols": torch.as_tensor(plan.cols[d], dtype=torch.int64,
                                    device=dev),
            "vidx": torch.as_tensor(plan.vidx[d], dtype=torch.int64,
                                    device=dev),
            "mask": torch.as_tensor(plan.mask[d]).to(dev, dtype),
            "vals": torch.as_tensor(plan.vals[d]).to(dev, dtype)}


def _projection_geometry(geom_name: str):
    from ..device import GEOMETRY_TABLE
    return GEOMETRY_TABLE[geom_name]


def projected_weak_scaling(spmm: "DistributedBsrSpmm",
                           geom_name: str = "h100") -> dict:
    """PROJECTED weak-scaling efficiency: an analytic MODEL, not a
    measurement, on the card's data-sheet parameters
    (device.GEOMETRY_TABLE).

    Model (the reference's):
      t_comp = max(local memory stream / hbm_gbps, local flops / f32 peak)
               with local bytes = A values (nnz/P) + the full X streamed
               across the P ring steps (k*n) + the C shard (m/P * n);
      t_comm = comm_bytes_per_device / NVLink's one-way bandwidth;
      exposed = max(0, t_comm - t_comp) for ring2 (prefetch overlap),
               max(t_comm / 2, t_comm - t_comp) for the plain ring, the
               full t_comm for allgather (an up-front barrier);
      efficiency = t_comp / (t_comp + exposed)."""
    return projected_weak_scaling_params(
        spmm.m, spmm.k, spmm.n, spmm.nnz, spmm.num_devices, spmm.comm,
        itemsize=spmm.dtype.itemsize, geom_name=geom_name,
        comm_bytes=spmm.comm_bytes_per_device())


def projected_weak_scaling_params(m: int, k: int, n: int, nnz: int,
                                  ndev: int, comm: str = "ring",
                                  itemsize: int = 4,
                                  geom_name: str = "h100",
                                  comm_bytes: int = None) -> dict:
    """Pure-parameter core of projected_weak_scaling."""
    g = _projection_geometry(geom_name)
    p = ndev
    if comm_bytes is None:
        seg = (k // p) * n * itemsize
        comm_bytes = {"ring": p * seg, "ring2": (p + 1) * seg,
                      "allgather": (p - 1) * seg}[comm]
    local_bytes = (nnz // p) * itemsize + k * n * itemsize \
        + (m // p) * n * itemsize
    local_flops = 2 * (nnz // p) * n
    t_hbm = local_bytes / (g.hbm_gbps * 1e9)
    t_fma = local_flops / (g.peak_f32_tflops * 1e12)
    t_comp = max(t_hbm, t_fma)
    # one device: every "collective" is a self-permute, a local copy
    t_comm = 0.0 if p == 1 else comm_bytes / (g.nvlink_gbps * 1e9)
    if comm == "ring2":
        exposed = max(0.0, t_comm - t_comp)
    elif comm == "ring":
        exposed = max(t_comm * 0.5, t_comm - t_comp)
    else:
        exposed = t_comm
    eff = t_comp / (t_comp + exposed) if t_comp + exposed > 0 else 0.0
    return {
        "model": f"{geom_name} params: hbm={g.hbm_gbps} GB/s, "
                 f"nvlink={g.nvlink_gbps} GB/s one-way "
                 f"(PROJECTION, not a measurement)",
        "t_comp_us": round(t_comp * 1e6, 3),
        "t_comm_us": round(t_comm * 1e6, 3),
        "t_exposed_us": round(exposed * 1e6, 3),
        "projected_efficiency": round(eff, 4),
    }


class DistributedBsrSpmm2Level:
    """Two-level (DCN x ICI) distributed BSR SpMM.

    A's block-rows are partitioned across ALL ranks (dcn-major); X is
    row-sharded over the ICI axis only and replicated across the DCN
    groups, so the halo ring rides the ICI axis within each group and no
    steady-state traffic crosses the DCN axis. comm="ring2" (default) is
    the double-buffered ring, comm="ring" the plain one.
    """

    def __init__(self, a: BsrMatrix, n: int, mesh: Mesh,
                 dcn_axis: str = "dcn", ici_axis: str = "ici",
                 dtype: Optional[Datatype] = None,
                 comm: str = "ring2"):
        self.a = a
        self.n = n
        self.mesh = mesh
        self.dcn_axis = dcn_axis
        self.ici_axis = ici_axis
        groups = mesh.shape[dcn_axis]
        ring = mesh.shape[ici_axis]
        total = groups * ring
        self.num_devices = total
        self.ring_size = ring
        self.dtype = to_torch(Datatype.F32 if dtype is None else dtype)
        m, k = a.shape
        self.m, self.k = m, k
        self.nnz = a.nnz

        plan = _build_plan(a, total, ring_size=ring)
        self._plan = plan
        d = mesh.index(dcn_axis) * ring + mesh.index(ici_axis)
        self._local = _local_plan(plan, d, self.dtype, mesh.device)
        self.x_sharding = NamedSharding(mesh, P(ici_axis, None))
        self._out = NamedSharding(mesh, P((dcn_axis, ici_axis), None))
        if comm not in ("ring", "ring2"):
            raise ValueError(f"unknown comm {comm!r} (ring | ring2)")
        self.comm = comm
        self._group = mesh.group(ici_axis)
        self._mb_loc = (m // a.br) // total

    @classmethod
    def from_reference(cls, bsr, n: int, mesh: Mesh, **kw):
        """The handle for a reference BsrMatrix (its numpy arrays carried
        across)."""
        return cls(_port_bsr(bsr), n, mesh, **kw)

    def __call__(self, x):
        x_local = local(x, self.x_sharding).to(self.dtype)
        # the flat ring over the ici group, on this rank's band of
        # mb / total block rows
        acc = _ring_loop(self.comm, x_local, self._local, self._group,
                         self.ring_size, self._mb_loc, self.a, self.n)
        return wrap(acc.to(self.dtype), self._out, (self.m, self.n))

    def comm_bytes_per_device(self) -> int:
        """DistributedBsrSpmm's model over the ici ring: ring R segments of
        (k/R, n), ring2 R + 1."""
        seg = (self.k // self.ring_size) * self.n * self.dtype.itemsize
        return (self.ring_size + (self.comm == "ring2")) * seg

    def overlap_report(self, x) -> dict:
        """Schedule evidence of one call (see DistributedBsrSpmm)."""
        return _overlap_report(lambda: self(x), self.mesh.backend(),
                               self.mesh.device)
