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
  form (compact=True: union, union2, union3) first launches the compactor,
  then reads its contiguous RHS, as the reference runs its separate pass.
* BcscUnionCompact (a union plan's `.compactor`), the port of
  build_union_compact_rhs (:885): values -> the per-group compacted RHS
  (nsg, U*bk, 128) through the plan's gather map. The reference refuses a
  value store larger than a quarter of VMEM and falls back to XLA
  (:899-900, :777-783), a Mosaic limit: the compactor serves every plan the
  union kernel takes.
* build_bcsc_densify — strategy "dense": values -> dense B (k, n) through
  the create-time gather map.
* build_bcsc_spmm_super — strategy "super": the scheduled kernel over the
  occupied 128 x 128 supertiles.

The scheduled and supertile strategies run on the bf16 tensor cores
wherever the operands are bf16 and the blocks are whole k16 steps deep and
whole 16-byte units wide (bk % 16 == 0, bn % 8 == 0: 32 x 32, 16 x 64, the
128 x 128 supertiles); every other case, f32 operands among them, runs the
f32 FMA kernel. `spmm_path` names the kernel a call takes, as csrc
spmm_entry chooses it; there is no fallback between the two.

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
from .gemm import _aligned16, _check, _on_cuda, _ptr, _raise_on_error, _stream

# kernel launches since the last reset_launches(); the wrappers add one where
# they launch their CUDA kernel, and nowhere else
launches = {"bcsc_spmm": 0, "bcsc_spmm_union": 0, "bcsc_densify": 0,
            "bcsc_spmm_super": 0, "bcsc_union_compact": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


GROUP = 128          # output columns per union group (csrc GW)
SUPER = 128          # supertile edge
_TYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
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
        lib.xsmm_bcsc_spmm_union_compact.argtypes = (
            [P, P, P, P, P, P] + [I] * 9 + [P])
        lib.xsmm_bcsc_densify.argtypes = [P, P, P] + [I] * 6 + [P]
        lib.xsmm_bcsc_union_compact.argtypes = [P, P, P] + [I] * 6 + [P]
        for f in (lib.xsmm_bcsc_spmm, lib.xsmm_bcsc_spmm_super,
                  lib.xsmm_bcsc_spmm_union, lib.xsmm_bcsc_spmm_union_compact,
                  lib.xsmm_bcsc_densify, lib.xsmm_bcsc_union_compact):
            f.restype = I
        lib.xsmm_error_string.argtypes = [I]
        lib.xsmm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def spmm_path(in_dtype: torch.dtype, bk: int, bn: int) -> str:
    """The kernel that serves the scheduled and supertile SpMM (csrc
    spmm_entry): "mma", the bf16 tensor-core kernel, for bf16 operands whose
    blocks are whole k16 steps deep (bk % 16 == 0) and whole 16-byte units
    wide (bn % 8 == 0); "fma", the f32 FMA kernel, for every other case
    (f32 operands, f32 meaning f32; blockings such as 8 x 8 or 4 x 48)."""
    if in_dtype == torch.bfloat16 and bk % 16 == 0 and bn % 8 == 0:
        return "mma"
    return "fma"


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
    kernels. A subclass sets `counter`, `name`, `plan` (a create-time tensor
    on the kernel's device), `_launch` and `plain`."""

    counter = ""

    def __init__(self, shape: GemmShape, bk: int, bn: int, nblocks: int):
        self.m, self.n, self.k = shape.m, shape.n, shape.k
        self.bk, self.bn = bk, bn
        self.nblocks = nblocks
        self.in_dt, self.kout_dt, self.out_dt = _spmm_dtypes(shape)

    def _operands(self, a, values):
        _check("a", a, (self.m, self.k))
        _check("values", values, (self.nblocks, self.bk, self.bn))
        return a.to(self.in_dt), values.to(self.in_dt)

    def __call__(self, a, values):
        a, values = self._operands(a, values)
        if not _on_cuda(a, values, self.plan):
            return self.plain(a, values)
        a, values = _aligned16(a), _aligned16(values)
        out = torch.empty((self.m, self.n), dtype=self.kout_dt,
                          device=a.device)
        lib = _kernels()
        with torch.cuda.device(a.device):
            err = self._launch(lib, a, values, out)
        _raise_on_error(err, self.name, lib)
        launches[self.counter] += 1
        return out.to(self.out_dt)


class BcscSpmm(_SpmmKernel):
    """The scheduled kernel over the padded block schedule; `path` names
    the CUDA kernel that serves it (spmm_path)."""

    counter = "bcsc_spmm"

    def __init__(self, shape: GemmShape, bk: int, bn: int,
                 indptr: np.ndarray, indices: np.ndarray, device):
        super().__init__(shape, bk, bn, len(indices))
        self.path = spmm_path(self.in_dt, bk, bn)
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


class BcscUnionCompact:
    """fn(values (nblocks, bk, bn)) -> the compacted RHS (nsg, U*bk, 128) in
    the operand type: out[g, u*bk:(u+1)*bk, w*bn:(w+1)*bn] =
    values[gmap[g, u, w]], the zero block where the map says nblocks. gmap
    is the union plan's flattened (nsg, U, W) map, on the plan's device."""

    def __init__(self, nsg: int, U: int, W: int, bk: int, bn: int,
                 nblocks: int, gmap: torch.Tensor, in_dt: torch.dtype):
        self.nsg, self.U, self.W, self.bk, self.bn = nsg, U, W, bk, bn
        self.nblocks = nblocks
        self.gmap = gmap
        self.in_dt = in_dt
        self.name = f"bcsc_union_compact_{nsg}x{U}x{W}_b{bk}x{bn}"

    def __call__(self, values):
        _check("values", values, (self.nblocks, self.bk, self.bn))
        values = values.to(self.in_dt)
        if not _on_cuda(values, self.gmap):
            return self.plain(values)
        values = values.contiguous()
        out = torch.empty((self.nsg, self.U * self.bk, GROUP),
                          dtype=self.in_dt, device=values.device)
        lib = _kernels()
        with torch.cuda.device(values.device):
            err = lib.xsmm_bcsc_union_compact(
                _ptr(values), _ptr(self.gmap), _ptr(out), self.nsg, self.U,
                self.bk, self.bn, self.nblocks, values.element_size(),
                _stream(values.device))
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
    form; `launches["bcsc_spmm_union"]` counts both forms."""

    counter = "bcsc_spmm_union"

    def __init__(self, shape: GemmShape, bk: int, bn: int,
                 krows: np.ndarray, gmap: np.ndarray, ocol: np.ndarray,
                 nblocks: int, clustered: bool, device, compact: bool = False):
        super().__init__(shape, bk, bn, nblocks)
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

    def _launch(self, lib, a, values, out):
        entry, rhs = lib.xsmm_bcsc_spmm_union, values
        if self.compact:
            entry, rhs = (lib.xsmm_bcsc_spmm_union_compact,
                          self.compactor(values))
        return entry(
            _ptr(a), _ptr(rhs), _ptr(self.krows), _ptr(self.gmap),
            _ptr(self.ocol), _ptr(out), self.m, self.k, self.n, self.bk,
            self.bn, self.U, self.nblocks, _TYPE_CODE[self.in_dt],
            _TYPE_CODE[self.kout_dt], _stream(a.device))

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
    the two-launch form (compactor, then the kernel over its RHS).

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

class BcscDensify:
    """fn(values (nblocks, bk, bn)) -> dense B (k, n) in the values' type,
    through the create-time gather map gmap (kb, nb) (nblocks = the zero
    block)."""

    def __init__(self, k: int, n: int, bk: int, bn: int, gmap: np.ndarray,
                 nblocks: int, device):
        self.k, self.n, self.bk, self.bn = k, n, bk, bn
        self.nblocks = nblocks
        self.gmap = _index(gmap.reshape(-1), device)
        self.name = f"bcsc_densify_{k}x{n}_b{bk}x{bn}"

    def __call__(self, values):
        _check("values", values, (self.nblocks, self.bk, self.bn))
        if not _on_cuda(values, self.gmap):
            return self.plain(values)
        if values.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"{self.name}: no CUDA kernel for dtype "
                             f"{values.dtype}")
        values = values.contiguous()
        out = torch.empty((self.k, self.n), dtype=values.dtype,
                          device=values.device)
        lib = _kernels()
        with torch.cuda.device(values.device):
            err = lib.xsmm_bcsc_densify(
                _ptr(values), _ptr(self.gmap), _ptr(out), self.k, self.n,
                self.bk, self.bn, self.nblocks, values.element_size(),
                _stream(values.device))
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
