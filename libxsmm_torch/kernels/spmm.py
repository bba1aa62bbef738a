"""Block-sparse (BCSC) SpMM kernels — the wrappers around the hand-written
CUDA kernels of csrc/spmm_kernels.cu, each with its plain torch version.

The port of `libxsmm_tpu/kernels/spmm_pallas.py`: the schedule helpers
(`_pad_empty_columns`, `_block_schedule`), the clustering of block columns
(`_cluster_union_groups`, host numpy, as the reference's) and five kernels:

* build_bcsc_spmm — strategy "pallas": one schedule step per (block column,
  nonzero block) in CSC order, an empty block column padded with one zero
  block.
* build_bcsc_spmm_union — the union strategies: per 128-column group, A's
  compacted k-union times the group's compacted values. The reference's
  TPU schedules (double buffering, DMA assembly, A in HBM) are one CUDA
  kernel here, in two forms: the fused form assembles each slot's RHS from
  the value store itself (union4, union4a, union4d, union5); the compacted
  form (compact=True: union, union2, union3) launches the compactor, then
  reads its contiguous RHS, as the reference runs its separate pass: both
  from one host call, the kernel launched programmatically so that its
  launch overlaps the compactor's tail.
* BcscUnionCompact (a union plan's `.compactor`), the port of
  build_union_compact_rhs (:885): values -> the per-group compacted RHS
  (nsg, U*bk, 128) through the plan's gather map, on the bulk-copy engine
  where the blocks' rows are whole 16-byte units (compact_route,
  compact_plan). The reference refuses a
  value store larger than a quarter of VMEM and falls back to XLA
  (:899-900, :777-783), a Mosaic limit: the compactor serves every plan the
  union kernel takes.
* build_bcsc_densify — strategy "dense": values -> dense B (k, n) through
  the create-time gather map, whole tiles copied in 16-byte units where
  their rows are whole units and the addresses aligned (BcscDensify.route),
  in element units otherwise, on densify_plan's one-shot grid.
* build_bcsc_spmm_super — strategy "super": the scheduled kernel over the
  occupied 128 x 128 supertiles.

The scheduled, supertile and union strategies run on one of three CUDA
kernels, the route (`spmm_path`, as csrc spmm_route takes it): "wgmma",
Hopper's warpgroup products on TMA-fed tiles, wherever the operands are
bf16 and the blocks are whole k16 steps deep and whole 16-byte rows wide
(bk % 16 == 0, bn % 8 == 0: 32 x 32, 16 x 64, 16 x 8, 48 x 32, 32 x 16,
64 x 128, 128 x 128, the supertiles), the k-union in both forms included,
on the tile `wgmma_plan` describes; "tma_fma", f32 tiles fed by TMA into
the CUDA cores' FMAs (f32 means f32, no TF32), wherever the operands are
f32 and the blocks' rows and depth are whole 16-byte units (bk % 4 == 0,
bn % 4 == 0; the union also bn >= 32, at most four value blocks a stage);
"fma", the FMA kernel with its own loads, for every other case. The route
follows from the shape alone and is fixed at create time (`.path`); there
is no fallback between the kernels: a build or launch that fails raises.

Every builder makes its plan (schedule, unions, gather maps) once, in numpy,
and puts it on `device`; a call never re-uploads it. Calling the returned
object checks the operands' shapes, then follows their device: on CUDA
tensors it launches the kernel on the current stream (a build failure or a
refused launch raises; there is no fallback), on CPU tensors it runs
`.plain`, the plain torch version of the same function, which chip_smoke.py
also holds the kernel against on the card. Operands and plan must lie on
one device. `launches` counts kernel launches, and only those.

The reference's row-tile choice (`_pick_m_tile`, and the union builder's
VMEM budget) exists for Mosaic's block shapes; the CUDA kernels take 64- or
128-row tiles and mask the ragged last one, so any m is served and nothing
here picks a tile. The kernels stage in 16-byte units: an operand off
16-byte alignment is copied into a fresh tensor first.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from .. import device as device_mod
from ..descriptor import GemmShape, SpgemmConfig
from ..dtypes import Datatype, to_torch
from .gemm import (_aligned16, _check, _num_sms, _on_cuda, _on_device, _ptr,
                   _raise_on_error, _stream)

# kernel launches since the last reset_launches(); the wrappers add one where
# they launch their CUDA kernel, and nowhere else
launches = {"bcsc_spmm": 0, "bcsc_spmm_union": 0, "bcsc_densify": 0,
            "bcsc_spmm_super": 0, "bcsc_union_compact": 0}
# the SpMM kernels' launches split by the route that served them
# (spmm_path)
ROUTES = ("tma_fma", "fma", "wgmma")
path_launches = {name: {r: 0 for r in ROUTES}
                 for name in ("bcsc_spmm", "bcsc_spmm_super",
                              "bcsc_spmm_union")}
# the source behind each counter and the CUDA kernels its launches run, by
# name (lowering.py files each logged entry under its counter)
_SCHEDULED = ("bcsc_spmm_kernel", "bcsc_spmm_tma_fma_kernel",
              "bcsc_spmm_wgmma_kernel")
ENTRIES = {"bcsc_spmm": ("spmm_kernels", _SCHEDULED),
           "bcsc_spmm_super": ("spmm_kernels", _SCHEDULED),
           "bcsc_spmm_union": ("spmm_kernels", ("bcsc_union_kernel",
                                                 "bcsc_union_tma_fma_kernel",
                                                 "bcsc_union_wgmma_kernel")),
           "bcsc_union_compact": ("spmm_kernels", (
               "bcsc_union_compact_bulk_kernel",
               "bcsc_union_compact_kernel")),
           "bcsc_densify": ("spmm_kernels", ("bcsc_densify_kernel",))}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    for counts in path_launches.values():
        for route in counts:
            counts[route] = 0


GROUP = 128          # output columns per union group (csrc GW)
SUPER = 128          # supertile edge
_TYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_UNION_BOXES = 4     # value blocks a tma_fma union stage, at most (csrc
                     # SF_UNION_BOXES)
# operand types of the SpMM kernels; f64 and integers are refused, as the
# reference's builders refuse them (spmm_pallas.py:100, :322, :958)
_SPMM_TYPES = (Datatype.F32, Datatype.BF16)
_lib = None


def _kernels() -> ctypes.CDLL:
    """The CUDA library, built and loaded on first use."""
    global _lib
    if _lib is None:
        from . import _build
        lib = _build.load("spmm_kernels")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.xsmm_bcsc_spmm.argtypes = [P, P, P, P, P, P] + [I] * 8 + [P]
        lib.xsmm_bcsc_spmm_super.argtypes = [P, P, P, P, P, P] + [I] * 6 + [P]
        lib.xsmm_bcsc_spmm_union.argtypes = [P, P, P, P, P, P] + [I] * 9 + [P]
        lib.xsmm_bcsc_spmm_union_compacted.argtypes = (
            [P] * 7 + [I] * 11 + [P])
        lib.xsmm_bcsc_densify.argtypes = [P, P, P] + [I] * 9 + [P]
        lib.xsmm_bcsc_union_compact.argtypes = [P, P, P] + [I] * 8 + [P]
        for f in (lib.xsmm_bcsc_spmm, lib.xsmm_bcsc_spmm_super,
                  lib.xsmm_bcsc_spmm_union,
                  lib.xsmm_bcsc_spmm_union_compacted,
                  lib.xsmm_bcsc_densify, lib.xsmm_bcsc_union_compact):
            f.restype = I
        lib.xsmm_error_string.argtypes = [I]
        lib.xsmm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def spmm_path(in_dtype: torch.dtype, bk: int, bn: int,
              union: bool = False) -> str:
    """The kernel that serves the scheduled, supertile and (`union`) k-union
    SpMM (csrc spmm_route), chosen by dtype, blocking and union alone,
    before any launch: "wgmma", the warpgroup kernels on TMA-fed tiles,
    for bf16 operands whose blocks are whole k16 steps deep (bk % 16 == 0:
    a slice is one, two or four k16 steps) and whole 16-byte rows wide (bn
    % 8 == 0: TMA's row stride and wgmma's n8 steps; 32 x 32, 16 x 64, 16 x
    8, 48 x 32, 32 x 16, 64 x 128, 128 x 128), scheduled, supertile and
    k-union (both forms) alike, on `wgmma_plan`'s tile; "tma_fma", the f32
    kernel on TMA-fed FMA tiles, for f32 operands whose blocks' rows and
    depth are whole 16-byte units (bk % 4 == 0, bn % 4 == 0: TMA's strides;
    f32 means f32, no TF32) and, in the union, at most four value blocks a
    128-column group (bn >= 32: each is one box of a stage, read without
    bank conflicts); "fma", the FMA kernel with its own loads, for every
    other case (blockings such as 8 x 8 or 4 x 48 in bf16, 2 x 2 in
    f32)."""
    if in_dtype == torch.bfloat16 and bk % 16 == 0 and bn % 8 == 0:
        return "wgmma"
    if (in_dtype == torch.float32 and bk % 4 == 0 and bn % 4 == 0
            and (not union or GROUP // bn <= _UNION_BOXES)):
        return "tma_fma"
    return "fma"


_SW_TM = 128         # output rows of a wgmma tile (csrc SW_TM)
_SW_ALIGN = 1024     # slack to align the ring (csrc SF_ALIGN)
_SW_SMEM_MAX = 232448   # a block's shared memory on sm_90 (csrc SF_SMEM_MAX)


def wgmma_plan(bk: int, bn: int, union: bool = False,
               compact: bool = False) -> dict:
    """The tile of the "wgmma" route at a bf16 blocking (csrc SwTile and
    the launchers that pick it): `kc` the slice depth, the deepest of 64,
    32, 16 that divides bk; `tn` the tile's columns (the scheduled kernel:
    the least of 8, 16, 32, 64, 128 that covers bn; the union: its
    128-column group); `box` the columns of a value box (at most 64, a
    128-byte swizzled row; the fused union's at most bn, so a box never
    straddles two value blocks; the compacted union's 64); `boxes` the TMA
    boxes a stage lands, A's slice included, and `load` their bytes (the
    fused union's at most: a dead entry whose place in the stage already
    holds TMA's zero fill lands none); `stage`
    the bytes of a stage, padded to 1024; `stages` the ring's depth (3, 4
    or 8 at kc 64, 32, 16); `smem` a block's dynamic shared memory, two
    blocks an SM. Raises ValueError where the route does not serve the
    blocking (bk % 16, bn % 8; the union also 128 % bn)."""
    if bk <= 0 or bn <= 0 or bk % 16 or bn % 8 or (union and GROUP % bn):
        raise ValueError(f"no wgmma tile for a {bk} x {bn} "
                         f"{'union' if union else 'scheduled'} blocking")
    kc = 64 if bk % 64 == 0 else 32 if bk % 32 == 0 else 16
    if union:
        tn = GROUP
        box = 64 if compact else min(bn, 64)
    else:
        tn = next(t for t in (8, 16, 32, 64, 128) if t >= min(bn, 128))
        box = min(tn, 64)
    vboxes = tn // box
    load = _SW_TM * kc * 2 + vboxes * kc * box * 2
    stage = -(-load // 1024) * 1024
    stages = {64: 3, 32: 4, 16: 8}[kc]
    smem = _SW_ALIGN + stages * stage + 2 * stages * 8
    assert 2 * smem <= _SW_SMEM_MAX
    return {"kc": kc, "tn": tn, "box": box, "boxes": 1 + vboxes,
            "load": load, "stage": stage, "stages": stages, "smem": smem}


def _index(x, device) -> torch.Tensor:
    """A create-time index array as an int32 tensor on `device`."""
    return torch.as_tensor(np.ascontiguousarray(x, np.int32), device=device)


def _zero_block(values: torch.Tensor, dtype=None) -> torch.Tensor:
    """values (nblocks, bk, bn) with the zero block appended at index
    nblocks (the reference's padded value store)."""
    dtype = dtype or values.dtype
    pad = torch.zeros((1,) + tuple(values.shape[1:]), dtype=dtype,
                      device=values.device)
    return torch.cat([values.to(dtype), pad])


def _spmm_dtypes(shape: GemmShape):
    """(in, kernel out, out) torch dtypes of an SpMM kernel. Output types
    the kernels do not store (f16, f64) are written in f32 and cast once."""
    out_dt = to_torch(shape.out_type)
    kout = out_dt if out_dt in _TYPE_CODE else torch.float32
    return to_torch(shape.a_in_type), kout, out_dt


# ---------------------------------------------------------------------------
# schedule helpers (spmm_pallas.py:37-72)
# ---------------------------------------------------------------------------

def _pad_empty_columns(indptr: np.ndarray, indices: np.ndarray,
                       nblocks_data: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Insert a dummy block (row 0, value index -> zero slot) into every
    empty block-column; returns (rows, cols, val_idx) flattened schedules."""
    nb = len(indptr) - 1
    rows, cols, vidx = [], [], []
    for jb in range(nb):
        s, e = int(indptr[jb]), int(indptr[jb + 1])
        if s == e:
            rows.append(0)
            cols.append(jb)
            vidx.append(nblocks_data)     # the appended zero block
        else:
            for l in range(s, e):
                rows.append(int(indices[l]))
                cols.append(jb)
                vidx.append(l)
    return (np.asarray(rows, np.int32), np.asarray(cols, np.int32),
            np.asarray(vidx, np.int32))


def _block_schedule(indptr: np.ndarray, indices: np.ndarray,
                    nblocks_data: int, device):
    """The padded schedule of the pattern-driven kernels, on `device`: one
    implementation so bcsc_spmm and the supertile kernel cannot diverge.

    Returns (ptr, rows, cols, vidx) int32 tensors. ptr (nb + 1) bounds each
    block column's steps: a CUDA block walks its column's steps itself,
    where the reference's sequential grid marks each column's first step
    instead (`first`)."""
    rows, cols, vidx = _pad_empty_columns(np.asarray(indptr),
                                          np.asarray(indices), nblocks_data)
    nb = len(indptr) - 1
    ptr = np.zeros(nb + 1, np.int64)
    ptr[1:] = np.cumsum(np.bincount(cols, minlength=nb))
    return tuple(_index(x, device) for x in (ptr, rows, cols, vidx))


# ---------------------------------------------------------------------------
# 1. scheduled SpMM (strategy "pallas") and 4. supertile SpMM ("super")
# ---------------------------------------------------------------------------

class _SpmmKernel:
    """fn(a (m, k), values (nblocks, bk, bn)) -> C (m, n), beta=0: the
    operand checks, the device rule and the launch count of the three SpMM
    kernels, and `path`, the CUDA kernel that serves it (spmm_path). A
    subclass sets `counter`, `name`, `plan` (a create-time tensor on the
    kernel's device), `_launch` and `plain`."""

    counter = ""

    def __init__(self, shape: GemmShape, bk: int, bn: int, nblocks: int,
                 union: bool = False):
        self.m, self.n, self.k = shape.m, shape.n, shape.k
        self.bk, self.bn = bk, bn
        self.nblocks = nblocks
        self.in_dt, self.kout_dt, self.out_dt = _spmm_dtypes(shape)
        self.path = spmm_path(self.in_dt, bk, bn, union)

    def _operands(self, a, values):
        if (a.shape != (self.m, self.k)
                or values.shape != (self.nblocks, self.bk, self.bn)):
            _check("a", a, (self.m, self.k))
            _check("values", values, (self.nblocks, self.bk, self.bn))
        if a.dtype != self.in_dt:
            a = a.to(self.in_dt)
        if values.dtype != self.in_dt:
            values = values.to(self.in_dt)
        return a, values

    def __call__(self, a, values):
        a, values = self._operands(a, values)
        dev = a.device
        if (dev.type != "cuda" or values.device != dev
                or self.plan.device != dev):
            if not _on_cuda(a, values, self.plan):
                return self.plain(a, values)
        if self.m == 0 or self.n == 0:   # an empty C: nothing is launched
            return a.new_empty((self.m, self.n), dtype=self.out_dt)
        a, values = _aligned16(a), _aligned16(values)
        out = a.new_empty((self.m, self.n), dtype=self.kout_dt)
        lib = _kernels()
        with _on_device(dev):
            err = self._launch(lib, a, values, out)
        _raise_on_error(err, self.name, lib)
        launches[self.counter] += 1
        path_launches[self.counter][self.path] += 1
        return out if self.kout_dt == self.out_dt else out.to(self.out_dt)


class BcscSpmm(_SpmmKernel):
    """The scheduled kernel over the padded block schedule."""

    counter = "bcsc_spmm"

    def __init__(self, shape: GemmShape, bk: int, bn: int,
                 indptr: np.ndarray, indices: np.ndarray, device):
        super().__init__(shape, bk, bn, len(indices))
        self.ptr, self.rows, self.cols, self.vidx = _block_schedule(
            indptr, indices, self.nblocks, device)
        self.plan = self.ptr
        self.name = (f"{self.counter}_{self.m}x{self.n}x{self.k}"
                     f"_b{bk}x{bn}")

    def _launch(self, lib, a, values, out):
        return lib.xsmm_bcsc_spmm(
            _ptr(a), _ptr(values), _ptr(self.ptr), _ptr(self.rows),
            _ptr(self.vidx), _ptr(out), self.m, self.k, self.n, self.bk,
            self.bn, self.nblocks, _TYPE_CODE[self.in_dt],
            _TYPE_CODE[self.kout_dt], _stream(a.device))

    def plain(self, a, values):
        """Each schedule step's (m, bk) x (bk, bn) product in f32, added
        into its block column in schedule order, cast once."""
        m, n, k, bk, bn = self.m, self.n, self.k, self.bk, self.bn
        a, values = self._operands(a, values)
        vpad = _zero_block(values, torch.float32)
        panels = a.float().reshape(m, k // bk, bk).transpose(0, 1)
        prod = torch.bmm(panels[self.rows.long()], vpad[self.vidx.long()])
        acc = prod.new_zeros((n // bn, m, bn)).index_add_(
            0, self.cols.long(), prod)
        return acc.transpose(0, 1).reshape(m, n).to(self.out_dt)


class BcscSpmmSuper(BcscSpmm):
    """fn(a (m, k), sup (ns, 128, 128)) -> C (m, n), beta=0: the scheduled
    kernel over the supertile CSC pattern, with its own entry point and
    launch count."""

    counter = "bcsc_spmm_super"

    def __init__(self, shape: GemmShape, s_indptr: np.ndarray,
                 s_indices: np.ndarray, device):
        super().__init__(shape, SUPER, SUPER, s_indptr, s_indices, device)

    def _launch(self, lib, a, values, out):
        return lib.xsmm_bcsc_spmm_super(
            _ptr(a), _ptr(values), _ptr(self.ptr), _ptr(self.rows),
            _ptr(self.vidx), _ptr(out), self.m, self.k, self.n,
            self.nblocks, _TYPE_CODE[self.in_dt], _TYPE_CODE[self.kout_dt],
            _stream(a.device))


def build_bcsc_spmm(shape: GemmShape, config: SpgemmConfig,
                    indptr: np.ndarray, indices: np.ndarray,
                    device) -> Optional[BcscSpmm]:
    """fn(a, values) -> C(m, n) with beta=0 semantics, or None when the
    operand type is not f32/bf16. The blocking must divide (k, n)."""
    if shape.a_in_type not in _SPMM_TYPES:
        return None
    return BcscSpmm(shape, config.bk, config.bn, indptr, indices, device)


def build_bcsc_spmm_super(shape: GemmShape, s_indptr: np.ndarray,
                          s_indices: np.ndarray,
                          device) -> Optional[BcscSpmmSuper]:
    """fn(a, sup_values (ns, 128, 128) in CSC supertile order) -> C(m, n),
    beta=0, or None when 128 does not divide (k, n) or the operand type is
    not f32/bf16."""
    if shape.k % SUPER or shape.n % SUPER:
        return None
    if shape.a_in_type not in _SPMM_TYPES:
        return None
    return BcscSpmmSuper(shape, s_indptr, s_indices, device)


# ---------------------------------------------------------------------------
# 2. k-union SpMM (the union strategies)
# ---------------------------------------------------------------------------

def _cluster_union_groups(indptr: np.ndarray, indices: np.ndarray,
                          W: int, min_gain: int = 1
                          ) -> Optional[np.ndarray]:
    """Greedy block-column clustering for the union kernel
    (spmm_pallas.py:184, copied as it is).

    The union kernel's compute scales with the largest per-group k-union U,
    so columns with similar row supports are grouped together: place
    columns in decreasing support order into the non-full group whose union
    grows least (ties: smallest union). Python-int bitmasks make union and
    popcount O(kb/64) words.

    Returns the permuted block-column order (len nb), or None when the
    saving does not clear `min_gain` union panels: the caller derives it
    from the geometry as the restore's break-even, osz * peak / hbm saved
    k-rows over bk.
    """
    nb = len(indptr) - 1
    if nb % W or len(indices) == 0:
        return None
    nsg = nb // W
    masks = []
    for j in range(nb):
        mask = 0
        for r in indices[int(indptr[j]):int(indptr[j + 1])]:
            mask |= 1 << int(r)
        masks.append(mask)

    def max_union(groups_cols):
        worst = 1
        for cols in groups_cols:
            u = 0
            for j in cols:
                u |= masks[j]
            worst = max(worst, u.bit_count())
        return worst

    base = max_union([range(g * W, (g + 1) * W) for g in range(nsg)])

    order = sorted(range(nb), key=lambda j: -masks[j].bit_count())
    groups: list = [[] for _ in range(nsg)]
    gmasks = [0] * nsg
    for j in order:
        best, bestcost = None, None
        mj = masks[j]
        for g in range(nsg):
            if len(groups[g]) == W:
                continue
            u = gmasks[g] | mj
            cost = (u.bit_count() - gmasks[g].bit_count(), u.bit_count())
            if bestcost is None or cost < bestcost:
                best, bestcost = g, cost
        groups[best].append(j)
        gmasks[best] |= mj
    clustered = max(u.bit_count() for u in gmasks) if nsg else 1
    if clustered > base - max(1, min_gain):
        return None
    return np.asarray([j for g in groups for j in g], np.int32)


_CP_THREADS = 256    # threads of a block (csrc CP_THREADS)
_CP_BLOCKS = 4       # blocks an SM of the bulk route's grid (csrc CP_BLOCKS)
_CP_STAGE = 16384    # bytes of one stage, pads included (csrc CP_STAGE)
_CP_ROUTES = {"bulk": 0, "element": 1}   # csrc CP_BULK, CP_ELEM


def compact_route(bn: int, itemsize: int, *addresses: int) -> str:
    """The compactor's route, as csrc compact_route takes it: "bulk" (1-D
    bulk copies into shared memory, 16-byte stores out) where a block row
    is whole 16-byte units (bn * itemsize % 16 == 0, itemsize 1, 2, 4 or 8)
    and every address is 16-byte aligned; "element" (raw units of 1-16
    bytes, one block a slot) otherwise. It follows the shape and the
    addresses alone; neither route falls back to the other."""
    addr = 0
    for x in addresses:
        addr |= x
    sized = itemsize in (1, 2, 4, 8) and (bn * itemsize) % 16 == 0
    return "bulk" if sized and addr % 16 == 0 else "element"


def compact_plan(nsg: int, U: int, bk: int, bn: int, itemsize: int,
                 sms: int):
    """(rows a tile, tiles a slot, tiles, grid, piece stride, shared memory)
    of the compactor's bulk route (csrc cp_rows, cp_piece, cp_head): a tile
    is up to `rows` rows of one slot, all bk where one stage holds them
    (W pieces of rows * bn * itemsize bytes, each padded so a quarter
    warp's 16-byte reads fall in distinct banks); block x walks tiles x, x
    + grid, ... through two stages, the grid the least of at most
    _CP_BLOCKS blocks an SM that keeps the number of rounds."""
    W, cpr, row = GROUP // bn, bn * itemsize // 16, GROUP * itemsize
    rows = min(bk, (_CP_STAGE - W * 128) // row)
    per_slot = -(-bk // rows)
    tiles = nsg * U * per_slot
    rounds = max(1, -(-tiles // (sms * _CP_BLOCKS)))
    grid = -(-tiles // rounds)
    piece = rows * cpr * 16 + (cpr * 16 * (1 - rows)) % 128
    smem = -(-(16 + 8 * W) // 128) * 128 + 2 * W * piece
    return rows, per_slot, tiles, grid, piece, smem


class BcscUnionCompact:
    """fn(values (nblocks, bk, bn)) -> the compacted RHS (nsg, U*bk, 128) in
    the operand type: out[g, u*bk:(u+1)*bk, w*bn:(w+1)*bn] =
    values[gmap[g, u, w]], the zero block where the map says nblocks. gmap
    is the union plan's flattened (nsg, U, W) map, on the plan's device.
    Values of another element type are converted to the operand type
    first; the kernel copies bytes, so any operand type of 1-8 bytes takes
    the bulk route where compact_route allows it."""

    def __init__(self, nsg: int, U: int, W: int, bk: int, bn: int,
                 nblocks: int, gmap: torch.Tensor, in_dt: torch.dtype):
        self.nsg, self.U, self.W, self.bk, self.bn = nsg, U, W, bk, bn
        self.nblocks = nblocks
        self.gmap = gmap
        self.in_dt = in_dt
        self.itemsize = in_dt.itemsize
        self.name = f"bcsc_union_compact_{nsg}x{U}x{W}_b{bk}x{bn}"
        self._grid = None    # the bulk route's, on the map's device

    def route(self, values: torch.Tensor, out: torch.Tensor):
        """(route, grid) of a launch that reads `values` and writes `out`
        (both on the map's card)."""
        route = compact_route(self.bn, self.itemsize, values.data_ptr(),
                              out.data_ptr())
        if route == "element":
            return route, 0
        if self._grid is None:
            self._grid = compact_plan(self.nsg, self.U, self.bk, self.bn,
                                      self.itemsize,
                                      _num_sms(self.gmap.device))[3]
        return route, self._grid

    def rhs(self, like: torch.Tensor) -> torch.Tensor:
        """An uninitialised compacted RHS on `like`'s device (the output)."""
        return like.new_empty((self.nsg, self.U * self.bk, GROUP),
                              dtype=self.in_dt)

    def __call__(self, values):
        if values.shape != (self.nblocks, self.bk, self.bn):
            _check("values", values, (self.nblocks, self.bk, self.bn))
        if values.dtype != self.in_dt:
            values = values.to(self.in_dt)
        dev = values.device
        if dev.type != "cuda" or self.gmap.device != dev:
            if not _on_cuda(values, self.gmap):
                return self.plain(values)
        if not values.is_contiguous():
            values = values.contiguous()
        out = self.rhs(values)
        route, grid = self.route(values, out)
        lib = _kernels()
        with _on_device(dev):
            err = lib.xsmm_bcsc_union_compact(
                values.data_ptr(), self.gmap.data_ptr(), out.data_ptr(),
                self.nsg, self.U, self.bk, self.bn, self.nblocks,
                self.itemsize, _CP_ROUTES[route], grid, _stream(dev))
        _raise_on_error(err, self.name, lib)
        launches["bcsc_union_compact"] += 1
        return out

    def plain(self, values):
        """The padded value store gathered by the map, each slot's W blocks
        laid side by side (BcscSpmmUnion.plain's right-hand side)."""
        vpad = _zero_block(values.to(self.in_dt))
        rhs = vpad[self.gmap.long()].reshape(self.nsg, self.U, self.W,
                                             self.bk, self.bn)
        return rhs.permute(0, 1, 3, 2, 4).reshape(self.nsg, self.U * self.bk,
                                                  GROUP)


class BcscSpmmUnion(_SpmmKernel):
    """The k-union kernel over the create-time union plan: krows (nsg, U)
    block rows, gmap (nsg, U, W) value indices (nblocks = the zero block),
    ocol (nb,) the caller's block column at each group position. With
    `compact` each call launches the compactor, then the kernel's compacted
    form, from one host call into a workspace for the RHS;
    `launches["bcsc_spmm_union"]` counts both forms, and
    `launches["bcsc_union_compact"]` the compactor's launches."""

    counter = "bcsc_spmm_union"

    def __init__(self, shape: GemmShape, bk: int, bn: int,
                 krows: np.ndarray, gmap: np.ndarray, ocol: np.ndarray,
                 nblocks: int, clustered: bool, device, compact: bool = False):
        super().__init__(shape, bk, bn, nblocks, union=True)
        self.nsg, self.U, self.W = gmap.shape
        self.union_panels = self.U      # introspection for tests and logs
        self.clustered = clustered
        self.compact = compact
        self.krows = _index(krows.reshape(-1), device)
        self.gmap = _index(gmap.reshape(-1), device)
        self.ocol = _index(ocol, device)
        self.plan = self.krows
        self.compactor = BcscUnionCompact(self.nsg, self.U, self.W, bk, bn,
                                          nblocks, self.gmap, self.in_dt)
        self.name = (f"{self.counter}_{self.m}x{self.n}x{self.k}"
                     f"_b{bk}x{bn}_U{self.U}")
        # the launch's arguments that no call changes
        self._plan_ptrs = tuple(t.data_ptr() for t in (self.krows, self.gmap,
                                                       self.ocol))
        self._dims = (self.m, self.k, self.n, bk, bn, self.U, nblocks,
                      _TYPE_CODE[self.in_dt], _TYPE_CODE[self.kout_dt])

    def _launch(self, lib, a, values, out):
        if not self.compact:
            return lib.xsmm_bcsc_spmm_union(
                a.data_ptr(), values.data_ptr(), *self._plan_ptrs,
                out.data_ptr(), *self._dims, _stream(a.device))
        rhs = self.compactor.rhs(a)
        route, grid = self.compactor.route(values, rhs)
        err = lib.xsmm_bcsc_spmm_union_compacted(
            a.data_ptr(), values.data_ptr(), *self._plan_ptrs,
            rhs.data_ptr(), out.data_ptr(), *self._dims, _CP_ROUTES[route],
            grid, _stream(a.device))
        if err == 0:
            launches["bcsc_union_compact"] += 1
        return err

    def plain(self, a, values):
        """Per group, A's (m, U*bk) compacted panel stack times the group's
        (U*bk, 128) compacted values in f32, pad slots included; each
        group position stored at its caller's block column; cast once."""
        m, n, k, bk, bn = self.m, self.n, self.k, self.bk, self.bn
        nsg, U = self.nsg, self.U
        a, values = self._operands(a, values)
        panels = a.float().reshape(m, k // bk, bk).transpose(0, 1)
        pa = panels[self.krows.long()].reshape(nsg, U, m, bk)
        pa = pa.permute(0, 2, 1, 3).reshape(nsg, m, U * bk)
        rhs = self.compactor.plain(values).float()
        grouped = torch.bmm(pa, rhs).transpose(0, 1).reshape(m, n // bn, bn)
        out = torch.empty_like(grouped).index_copy_(1, self.ocol.long(),
                                                    grouped)
        return out.reshape(m, n).to(self.out_dt)


def build_bcsc_spmm_union(shape: GemmShape, config: SpgemmConfig,
                          indptr: np.ndarray, indices: np.ndarray,
                          device, cluster: bool = True,
                          u_align: int = 1,
                          compact: bool = False) -> Optional[BcscSpmmUnion]:
    """K-union-compacted BCSC SpMM: fn(a, values) -> C(m, n), beta=0, or
    None when the blocking does not tile 128-column groups (bn | 128,
    128 | n, bk | k) or the operand type is not f32/bf16. `compact` selects
    the compacted form (the compactor, then the kernel over its RHS).

    The create-time plan is the reference's (spmm_pallas.py:339-407): the
    optional clustering permutation, the per-group unions of block rows,
    the union depth U (padded to a multiple of `u_align`, capped at k/bk),
    the A block row per union slot and the value index per (slot, column
    of the group). The reference's refusals for Mosaic's sublane alignment,
    its VMEM budget and union5's 128-row tile have no counterpart here.
    """
    bk, bn = config.bk, config.bn
    m, n, k = shape.m, shape.n, shape.k
    if GROUP % bn or n % GROUP or k % bk:
        return None
    if shape.a_in_type not in _SPMM_TYPES:
        return None
    W = GROUP // bn
    nb = n // bn
    nsg = n // GROUP
    nblocks = len(indices)
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)

    # the clustering's break-even: osz * peak / hbm saved k-rows
    geo = device_mod.get_geometry()
    peak = (geo.peak_bf16_tflops if shape.a_in_type == Datatype.BF16
            else geo.peak_f32_tflops)
    gain_rows = (to_torch(shape.out_type).itemsize
                 * peak * 1e12 / (geo.hbm_gbps * 1e9))
    perm = (_cluster_union_groups(indptr, indices, W,
                                  min_gain=-(-int(gain_rows) // bk))
            if cluster else None)
    vmap = None
    ocol = np.arange(nb)
    if perm is not None:
        counts = np.diff(indptr)[perm]
        vmap = np.concatenate(
            [np.arange(int(indptr[j]), int(indptr[j + 1]), dtype=np.int64)
             for j in perm])
        indices = indices[vmap]
        indptr = np.concatenate(
            [[0], np.cumsum(counts)]).astype(indptr.dtype)
        ocol = perm

    # per-group union of block rows + value-gather map
    unions = []
    for g in range(nsg):
        rows = set()
        for j in range(g * W, (g + 1) * W):
            rows.update(int(r) for r in
                        indices[int(indptr[j]):int(indptr[j + 1])])
        unions.append(sorted(rows))
    U = max(1, max(len(u) for u in unions))
    if u_align > 1:
        U = -(-U // u_align) * u_align
    if U * bk > k:
        U = k // bk                 # fully dense union: still correct
    krows = np.zeros((nsg, U), np.int32)
    gmap = np.full((nsg, U, W), nblocks, np.int32)   # -> the zero block
    for g, rows in enumerate(unions):
        rows = rows[:U]
        krows[g, :len(rows)] = rows
        rpos = {r: u for u, r in enumerate(rows)}
        for wj in range(W):
            j = g * W + wj
            for pos in range(int(indptr[j]), int(indptr[j + 1])):
                r = int(indices[pos])
                if r in rpos:
                    # value indices address the caller's ORIGINAL value
                    # array; map back through the clustering permutation
                    gmap[g, rpos[r], wj] = (int(vmap[pos])
                                            if vmap is not None else pos)
    return BcscSpmmUnion(shape, bk, bn, krows, gmap, ocol, nblocks,
                         perm is not None, device, compact)


# ---------------------------------------------------------------------------
# 3. densify (strategy "dense")
# ---------------------------------------------------------------------------

_DN_THREADS = 256    # threads of a block at most (csrc DN_THREADS)
_DN_ROWS = 4         # rows' loads a thread issues at once (csrc DN_ROWS)
_DN_ROUTES = {"vector": 0, "element": 1}   # csrc DN_VECTOR, DN_ELEM


def densify_plan(kb: int, nb: int, bk: int, cpr: int, sms: int):
    """(tiles a block, column threads, row threads, grid) of the densifier
    (csrc bcsc_densify_kernel) over kb x nb tiles of bk rows of cpr units:
    block b copies the run of tiles j0 .. j0 + tb - 1 of block row b // runs
    (runs = ceil(nb / tb) a block row); thread (tid % qb, tid // qb) copies
    unit columns q, q + qb, ... of the run, rows r0, r0 + rs, .... tb is the
    most tiles whose rows one pass of _DN_THREADS threads covers, halved
    while the grid has fewer blocks than the card has SMs; rs gives each
    thread _DN_ROWS rows where the block has threads for it (at the
    streaming case 128-thread blocks of four rows a thread replayed
    faster than 256 of two: `scripts/stream_time.py --rows dplans`,
    PERF.md section 6)."""
    tb = max(1, min(nb, _DN_THREADS // cpr))
    while tb > 1 and kb * -(-nb // tb) < sms:
        tb = -(-tb // 2)
    qb = min(tb * cpr, _DN_THREADS)
    rs = max(1, min(-(-bk // _DN_ROWS), _DN_THREADS // qb))
    return tb, qb, rs, kb * -(-nb // tb)


class BcscDensify:
    """fn(values (nblocks, bk, bn)) -> dense B (k, n) in the values' type,
    through the create-time gather map gmap (kb, nb) (nblocks = the zero
    block). On the card a launch takes one of two routes (`route`):
    "vector", 16-byte units, where a tile row is whole 16-byte units and
    both addresses are 16-byte aligned (compact_route's test), "element",
    units of the element's size, otherwise; its grid is densify_plan's."""

    def __init__(self, k: int, n: int, bk: int, bn: int, gmap: np.ndarray,
                 nblocks: int, device):
        self.k, self.n, self.bk, self.bn = k, n, bk, bn
        self.nblocks = nblocks
        self.gmap = _index(gmap.reshape(-1), device)
        self.name = f"bcsc_densify_{k}x{n}_b{bk}x{bn}"
        self._vshape = (nblocks, bk, bn)
        self._plans = {}     # (route, itemsize) -> (tb, rs) for the card
        # the launch's arguments that no call changes
        self._gmap_ptr = self.gmap.data_ptr()
        self._dims = (k, n, bk, bn, nblocks)

    def route(self, values: torch.Tensor, out: torch.Tensor) -> str:
        """The route of a launch that reads `values` and writes `out`."""
        bulk = compact_route(self.bn, values.element_size(),
                             values.data_ptr(), out.data_ptr()) == "bulk"
        return "vector" if bulk else "element"

    def launch_plan(self, route: str, itemsize: int):
        """(tiles a block, row threads) of a launch on `route`
        (densify_plan's), for the map's card."""
        plan = self._plans.get((route, itemsize))
        if plan is None:
            cpr = self.bn * itemsize // 16 if route == "vector" else self.bn
            tb, _, rs, _ = densify_plan(self.k // self.bk, self.n // self.bn,
                                        self.bk, cpr,
                                        _num_sms(self.gmap.device))
            plan = self._plans[(route, itemsize)] = (tb, rs)
        return plan

    def __call__(self, values):
        if values.shape != self._vshape:
            _check("values", values, self._vshape)
        dev = values.device
        if dev.type != "cuda" or self.gmap.device != dev:
            if not _on_cuda(values, self.gmap):
                return self.plain(values)
        itemsize = values.element_size()
        if itemsize not in (1, 2, 4, 8):
            raise ValueError(f"{self.name}: no CUDA kernel for dtype "
                             f"{values.dtype}")
        if not values.is_contiguous():
            values = values.contiguous()
        out = values.new_empty((self.k, self.n))
        route = self.route(values, out)
        lib = _kernels()
        with _on_device(dev):
            err = lib.xsmm_bcsc_densify(
                values.data_ptr(), self._gmap_ptr, out.data_ptr(),
                *self._dims, itemsize, _DN_ROUTES[route],
                *self.launch_plan(route, itemsize), _stream(dev))
        _raise_on_error(err, self.name, lib)
        launches["bcsc_densify"] += 1
        return out

    def plain(self, values):
        k, n, bk, bn = self.k, self.n, self.bk, self.bn
        dense = _zero_block(values)[self.gmap.long()]
        dense = dense.reshape(k // bk, n // bn, bk, bn).permute(0, 2, 1, 3)
        return dense.reshape(k, n)


def build_bcsc_densify(shape: GemmShape, config: SpgemmConfig,
                       indptr: np.ndarray, indices: np.ndarray,
                       device) -> BcscDensify:
    """The densifier of the "dense" strategy: fn(values) -> (k, n). It
    copies elements, so it serves every value type; the reference's i8 and
    VMEM refusals (spmm_pallas.py:822, :831) are Mosaic limits."""
    bk, bn = config.bk, config.bn
    kb, nb = shape.k // bk, shape.n // bn
    nblocks = len(indices)
    gmap = np.full((kb, nb), nblocks, np.int32)
    for j in range(nb):
        gmap[indices[indptr[j]:indptr[j + 1]], j] = np.arange(
            indptr[j], indptr[j + 1], dtype=np.int32)
    return BcscDensify(shape.k, shape.n, bk, bn, gmap, nblocks, device)
