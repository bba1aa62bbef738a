"""Sparse GEMM: the host containers and the block-sparse (BCSC) packed
SpGEMM.

The port of the BCSC part of `libxsmm_tpu/ops/sparse.py` (the reference's
libxsmm_create_packed_spgemm_bcsc family,
generator_packed_spgemm_bcsc_bsparse*.c):

  * The sparsity PATTERN is a create-time constant, fingerprinted into the
    kernel key (descriptor.SparsePattern), so identical patterns share one
    kernel; the VALUES are runtime operands.
  * `create_packed_spgemm_bcsc` resolves a strategy ("auto" times every
    lowering on the card, or takes the roofline rule on the CPU), makes the
    chosen lowering's plan once, in numpy, and puts it on the create's
    device (default: the GPU, raising without one; device="cpu" runs the
    plain torch versions). The lowerings: "pallas", the union family and
    "super" run the hand-written CUDA kernels of kernels/spmm.py; "dense"
    runs the densify kernel, then one library matmul (the reference leaves
    that product to XLA); "sparse" is torch ops (panel gather, bmm,
    index_add_).
  * Rounding follows each of the reference's routes: the kernel routes
    compute in f32, round to the output type, then add `c` in the output
    type; "dense" and "sparse" add `c` in the compute type, then round.

Not ported yet (ROADMAP.md queue 1, item 11): the CSR/CSC routings,
create_spgemm_csr_areg, ops/fsspmdm.py and ops/packed.py.
Layouts are row-major; alpha=1, beta in {0,1} as everywhere in this library.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import device as device_mod
from ..config import CONFIG
from ..descriptor import GemmFlags, GemmShape, SparsePattern, SpgemmConfig
from ..device import resolve_device
from ..dtypes import Datatype, itemsize, to_torch
from ..kernels import spmm as spmm_kernels
from ..kernels.gemm import add_acc, contract, wrap_i32
from ..registry import Kernel, KernelInfo, get_registry
from .gemm import _as_tensor, _comp_dtype

_UNION = ("union", "union2", "union3", "union4", "union4a", "union4d",
          "union5")
# every lowering, in the order the autotuner builds them
STRATEGIES = ("dense",) + _UNION + ("super", "sparse", "pallas")


def _dense_beats_sparse(shape: GemmShape, sparse_bytes: int) -> bool:
    """Roofline rule of the auto strategy on the CPU: the dense product's
    time at the geometry's peak against the sparse path's dominant memory
    traffic at its memory rate."""
    geom = device_mod.get_geometry()
    peak = (geom.peak_bf16_tflops if shape.a_in_type in
            (Datatype.BF16, Datatype.F16, Datatype.I8, Datatype.U8)
            else geom.peak_f32_tflops) * 1e12
    dense_s = 2.0 * shape.m * shape.n * shape.k / peak
    sparse_s = sparse_bytes / (geom.hbm_gbps * 1e9)
    return dense_s < sparse_s


# ---------------------------------------------------------------------------
# host-side sparse containers (pattern handling; numpy)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CsrMatrix:
    """Host CSR: the currency for A-sparse kernels."""

    shape: Tuple[int, int]
    indptr: np.ndarray      # (m+1,) int32
    indices: np.ndarray     # (nnz,) int32 column ids
    data: Optional[np.ndarray] = None

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @staticmethod
    def from_dense(a, tol: float = 0.0) -> "CsrMatrix":
        a = np.asarray(a)
        mask = np.abs(a) > tol
        m, k = a.shape
        indptr = np.zeros(m + 1, np.int32)
        indptr[1:] = np.cumsum(mask.sum(axis=1))
        indices = np.nonzero(mask)[1].astype(np.int32)
        data = a[mask]
        return CsrMatrix((m, k), indptr, indices, data)

    def to_dense(self) -> np.ndarray:
        m, k = self.shape
        out = np.zeros((m, k), self.data.dtype if self.data is not None
                       else np.float64)
        for i in range(m):
            s, e = self.indptr[i], self.indptr[i + 1]
            out[i, self.indices[s:e]] = self.data[s:e]
        return out

    def ell(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """ELL-pad: returns (col_idx (m,rmax), pos (m,rmax), mask, rmax).

        pos maps each ELL slot to its position in the nnz value stream so
        runtime value vectors can be gathered without re-deriving layout.
        """
        m = self.shape[0]
        deg = np.diff(self.indptr)
        rmax = max(1, int(deg.max(initial=0)))
        col = np.zeros((m, rmax), np.int32)
        pos = np.zeros((m, rmax), np.int32)
        mask = np.zeros((m, rmax), np.float32)
        for i in range(m):
            s, e = int(self.indptr[i]), int(self.indptr[i + 1])
            col[i, : e - s] = self.indices[s:e]
            pos[i, : e - s] = np.arange(s, e, dtype=np.int32)
            mask[i, : e - s] = 1.0
        return col, pos, mask, rmax

    def fingerprint(self, include_values: bool = False) -> int:
        return SparsePattern.fingerprint_of(
            self.indptr, self.indices,
            values=self.data if include_values else None)


@dataclasses.dataclass
class CscMatrix:
    """Host CSC: the currency for B-sparse kernels."""

    shape: Tuple[int, int]
    indptr: np.ndarray      # (n+1,) column pointers
    indices: np.ndarray     # (nnz,) row ids
    data: Optional[np.ndarray] = None

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @staticmethod
    def from_dense(b, tol: float = 0.0) -> "CscMatrix":
        csr_t = CsrMatrix.from_dense(np.asarray(b).T, tol)
        return CscMatrix(b.shape, csr_t.indptr, csr_t.indices, csr_t.data)

    def fingerprint(self, include_values: bool = False) -> int:
        return SparsePattern.fingerprint_of(
            self.indptr, self.indices,
            values=self.data if include_values else None)


@dataclasses.dataclass
class BcscMatrix:
    """Host block-CSC: (bk x bn) dense blocks, sparse block structure.

    Mirrors the reference's BCSC B-sparse operand
    (generator_packed_spgemm_bcsc_bsparse*.c): values are stored block by
    block in column-major block order, each block dense row-major here.
    """

    shape: Tuple[int, int]          # (k, n) element dims
    bk: int
    bn: int
    indptr: np.ndarray              # (n//bn + 1,) block-column pointers
    indices: np.ndarray             # (nblocks,) block-row ids
    data: Optional[np.ndarray] = None   # (nblocks, bk, bn)

    @property
    def nblocks(self) -> int:
        return len(self.indices)

    @staticmethod
    def from_dense(b, bk: int, bn: int, tol: float = 0.0) -> "BcscMatrix":
        b = np.asarray(b)
        k, n = b.shape
        if k % bk or n % bn:
            raise ValueError(f"dims ({k},{n}) not divisible by block "
                             f"({bk},{bn})")
        kb, nb = k // bk, n // bn
        blocks = b.reshape(kb, bk, nb, bn).transpose(2, 0, 1, 3)  # (nb,kb,bk,bn)
        nz = np.abs(blocks).max(axis=(2, 3)) > tol                # (nb, kb)
        indptr = np.zeros(nb + 1, np.int32)
        indptr[1:] = np.cumsum(nz.sum(axis=1))
        indices = np.nonzero(nz)[1].astype(np.int32)
        data = blocks[nz]                                         # (nblk,bk,bn)
        return BcscMatrix((k, n), bk, bn, indptr, indices, data)

    def to_dense(self) -> np.ndarray:
        k, n = self.shape
        out = np.zeros((k, n), self.data.dtype)
        for jb in range(n // self.bn):
            s, e = int(self.indptr[jb]), int(self.indptr[jb + 1])
            for l in range(s, e):
                ib = int(self.indices[l])
                out[ib * self.bk:(ib + 1) * self.bk,
                    jb * self.bn:(jb + 1) * self.bn] = self.data[l]
        return out

    def fingerprint(self, include_values: bool = False) -> int:
        return SparsePattern.fingerprint_of(
            self.indptr, self.indices, np.asarray([self.bk, self.bn]),
            values=self.data if include_values else None)


@dataclasses.dataclass
class BsrMatrix:
    """Host block-CSR: (br x bc) dense blocks, block-row major (the
    distribution currency of the reference's multi-chip SpMM)."""

    shape: Tuple[int, int]          # (m, k) element dims
    br: int
    bc: int
    indptr: np.ndarray              # (m//br + 1,) block-row pointers
    indices: np.ndarray             # (nblocks,) block-col ids
    data: Optional[np.ndarray] = None   # (nblocks, br, bc)

    @property
    def nblocks(self) -> int:
        return len(self.indices)

    @property
    def nnz(self) -> int:
        """Stored element count (blocks are dense)."""
        return self.nblocks * self.br * self.bc

    @staticmethod
    def from_dense(a, br: int, bc: int, tol: float = 0.0) -> "BsrMatrix":
        a = np.asarray(a)
        m, k = a.shape
        if m % br or k % bc:
            raise ValueError(f"dims ({m},{k}) not divisible by block "
                             f"({br},{bc})")
        mb, kb = m // br, k // bc
        blocks = a.reshape(mb, br, kb, bc).transpose(0, 2, 1, 3)  # (mb,kb,br,bc)
        nz = np.abs(blocks).max(axis=(2, 3)) > tol
        indptr = np.zeros(mb + 1, np.int32)
        indptr[1:] = np.cumsum(nz.sum(axis=1))
        indices = np.nonzero(nz)[1].astype(np.int32)
        data = blocks[nz]
        return BsrMatrix((m, k), br, bc, indptr, indices, data)

    def to_dense(self) -> np.ndarray:
        m, k = self.shape
        out = np.zeros((m, k), self.data.dtype)
        for ib in range(m // self.br):
            s, e = int(self.indptr[ib]), int(self.indptr[ib + 1])
            for l in range(s, e):
                jb = int(self.indices[l])
                out[ib * self.br:(ib + 1) * self.br,
                    jb * self.bc:(jb + 1) * self.bc] = self.data[l]
        return out

    def fingerprint(self, include_values: bool = False) -> int:
        return SparsePattern.fingerprint_of(
            self.indptr, self.indices, np.asarray([self.br, self.bc]),
            values=self.data if include_values else None)


# ---------------------------------------------------------------------------
# packed SpGEMM, B block-sparse (BCSC)
# ---------------------------------------------------------------------------

def create_tilecfg_packed_spgemm_bcsc(shape: GemmShape,
                                      flags: GemmFlags = GemmFlags.NONE,
                                      config: SpgemmConfig = SpgemmConfig()):
    """API-parity analogue of libxsmm_create_tilecfg_packed_spgemm_bcsc
    (include/libxsmm.h:187): AMX tileconfig has no GPU equivalent, so this
    returns the same no-op kernel as dispatch_tilecfg_gemm."""
    from .gemm import dispatch_tilecfg_gemm
    return dispatch_tilecfg_gemm(shape, flags)


def _kernel_route(pfn, dev):
    """fn(a, values[, c]) around a kernel wrapper: the kernel's output in
    the output type, then c added in that type."""
    def fn(a, values, c=None):
        out = pfn(_as_tensor(a, dev), _as_tensor(values, dev))
        if c is not None:
            out = out + _as_tensor(c, dev).to(out.dtype)
        return out
    return fn


def supertile_plan(shape: GemmShape, config: SpgemmConfig,
                   indptr: np.ndarray, indices: np.ndarray):
    """The supertile pattern of a BCSC pattern (create time, numpy): map
    every (bk, bn) sub-block into its (128, 128) supertile. Returns
    (s_indptr, s_indices, gmap): the supertile CSC pattern and the gather
    map (ns, 128/bk, 128/bn) of sub-block value indices (missing -> the
    appended zero block, index nblocks)."""
    bk, bn = config.bk, config.bn
    SB = spmm_kernels.SUPER
    if SB % bk or SB % bn or shape.k % SB or shape.n % SB:
        raise ValueError("strategy='super' needs bk|128, bn|128, and "
                         f"128 | (k, n) (got bk={bk} bn={bn} "
                         f"k={shape.k} n={shape.n})")
    rk, rn = SB // bk, SB // bn
    nb_s = shape.n // SB
    nblocks = len(indices)

    # occupied supertiles in CSC (column-major) order + sub-block slots
    slots: dict = {}
    for j in range(shape.n // bn):
        sj, jj = divmod(j, rn)
        for pos in range(int(indptr[j]), int(indptr[j + 1])):
            r = int(indices[pos])
            si, ii = divmod(r, rk)
            key = (sj, si)
            if key not in slots:
                slots[key] = np.full((rk, rn), nblocks, np.int32)
            slots[key][ii, jj] = pos
    skeys = sorted(slots)                       # CSC order: by sj, then si
    s_indptr = np.zeros(nb_s + 1, np.int32)
    for sj, _si in skeys:
        s_indptr[sj + 1] += 1
    s_indptr = np.cumsum(s_indptr).astype(np.int32)
    s_indices = np.asarray([si for _sj, si in skeys], np.int32)
    gmap = (np.stack([slots[kq] for kq in skeys])
            if skeys else np.zeros((0, rk, rn), np.int32))  # (ns, rk, rn)
    return s_indptr, s_indices, gmap


def assemble_supertiles(values: torch.Tensor, gmap: torch.Tensor,
                        in_dt: torch.dtype) -> torch.Tensor:
    """values (nblocks, bk, bn) -> the occupied supertiles' dense values
    (ns, 128, 128), through the gather map of supertile_plan on the
    values' device (a torch gather; XLA in the reference)."""
    ns, rk, rn = gmap.shape
    bk, bn = values.shape[1:]
    vpad = spmm_kernels._zero_block(values, in_dt)
    sup = vpad[gmap.reshape(-1).long()].reshape(ns, rk, rn, bk, bn)
    # (ns, rk, rn, bk, bn) -> (ns, rk*bk, rn*bn) row-major supertiles
    return sup.permute(0, 1, 3, 2, 4).reshape(ns, rk * bk, rn * bn)


def _build_bcsc_super(shape: GemmShape, config: SpgemmConfig,
                      indptr: np.ndarray, indices: np.ndarray, desc,
                      nblocks: int, dev) -> Kernel:
    """128x128-supertile BCSC lowering (strategy='super'): the supertile
    plan at create time; per call, one gather assembles the occupied
    supertiles' dense values, then the supertile kernel visits only the
    occupied supertiles."""
    bk, bn = config.bk, config.bn
    s_indptr, s_indices, gmap = supertile_plan(shape, config, indptr,
                                               indices)
    ns = len(s_indices)
    tiles = (shape.k // spmm_kernels.SUPER) * (shape.n // spmm_kernels.SUPER)
    gmap_d = torch.as_tensor(gmap.astype(np.int64), device=dev)
    pfn = spmm_kernels.build_bcsc_spmm_super(shape, s_indptr, s_indices, dev)
    if pfn is None:
        raise ValueError("descriptor unsupported by the supertile kernel "
                         "(need f32/bf16 operands)")
    in_dt = to_torch(shape.a_in_type)
    run = _kernel_route(pfn, dev)

    def fn(a, values, c=None):
        sup = assemble_supertiles(_as_tensor(values, dev), gmap_d, in_dt)
        return run(a, sup, c)

    occupancy = ns / max(1, tiles)
    info = KernelInfo(kind="pspgemm_bcsc",
                      nflops=2 * nblocks * bk * bn * shape.m)
    return Kernel(fn=fn, descriptor=desc, info=info,
                  name=f"pspgemm_bcsc_{shape.m}x{shape.n}x{shape.k}"
                       f"_super{ns}of{tiles}_occ{int(occupancy * 100)}")


def _bcsc_autotune(shape: GemmShape, flags: GemmFlags, config: SpgemmConfig,
                   indptr: np.ndarray, indices: np.ndarray,
                   bcsc: "BcscMatrix", dev: torch.device) -> str:
    """Create-time strategy selection for BCSC SpMM.

    On a CUDA device: build every lowering that takes the descriptor and
    time them on the card with CUDA events, their windows interleaved round
    by round (the reference's fsspmdm autotune-then-select pattern,
    libxsmm_fsspmdm.c:285-382); keep the fastest. On the CPU: the roofline
    rule (_dense_beats_sparse), as the reference takes off its TPU. The
    reference persists its picks in the native KV store; the port tunes at
    every create, as the reference does without that store.
    """
    nblocks = bcsc.nblocks
    bk, bn = config.bk, config.bn
    if dev.type != "cuda":
        sparse_bytes = nblocks * shape.m * bk * itemsize(shape.a_in_type)
        return ("dense" if _dense_beats_sparse(shape, sparse_bytes)
                else "sparse")

    from ..utils.timer import bench_chain_interleaved
    rng = np.random.default_rng(0)
    in_dt = to_torch(shape.a_in_type)
    a = torch.as_tensor(rng.standard_normal((shape.m, shape.k)),
                        device=dev).to(in_dt)
    v = torch.as_tensor(rng.standard_normal((nblocks, bk, bn)),
                        device=dev).to(in_dt)
    cands = []
    for s in STRATEGIES:
        try:
            kern = create_packed_spgemm_bcsc(shape, flags, config, indptr,
                                             indices, strategy=s, device=dev)
        except ValueError:
            continue          # a lowering that refuses this descriptor
        cands.append((s, kern))
    times = bench_chain_interleaved([(kern, (a, v)) for _s, kern in cands],
                                    reps=12, rounds=3)
    tuned = {s: t for (s, _k), t in zip(cands, times)}
    pick = min(tuned, key=tuned.get)
    if CONFIG.verbose >= 2:
        us = {s: round(t * 1e6, 1) for s, t in tuned.items()}
        print(f"libxsmm_torch: bcsc {shape.m}x{shape.n}x{shape.k} "
              f"b{bk}x{bn} nblk={nblocks} -> {pick} ({us})")
    return pick


def create_packed_spgemm_bcsc(shape: GemmShape,
                              flags: GemmFlags = GemmFlags.NONE,
                              config: SpgemmConfig = SpgemmConfig(),
                              column_ptr: np.ndarray = None,
                              row_idx: np.ndarray = None,
                              strategy: str = "auto",
                              device=None) -> Kernel:
    """libxsmm_create_packed_spgemm_bcsc analogue (src/libxsmm_main.c:3640).

    kernel(a, values[, c]): a (m,k), values (nblocks, bk, bn), c (m, n);
    tensors stay on their device, numpy arrays are loaded onto the
    create's. The plan lives on `device` (default: the GPU).

    Lowerings, picked by `strategy` ("auto"|"sparse"|"dense"|"pallas"|
    "super"|"union"|"union2"|"union3"|"union4"|"union4a"|"union4d"|
    "union5"); "auto" times all of them on a CUDA device at create time and
    keeps the fastest (_bcsc_autotune):
      * sparse: gather A panels per nonzero block -> one batched matmul ->
        index_add_ per block column.
      * dense: densify the blocks (kernels/spmm.py build_bcsc_densify),
        then one dense matmul.
      * pallas: the scheduled kernel at the native (bk, bn) granularity.
      * super: the scheduled kernel over the occupied 128x128 supertiles.
      * union...union5: per 128-column group, A's compacted k-union times
        the group's compacted values in one kernel; union4a pads the union
        depth to a multiple of 128/bk, union4d takes the full depth k/bk,
        and the other names are the same kernel (their TPU schedules have
        no counterpart).
    """
    bk, bn = config.bk, config.bn
    indptr = np.asarray(column_ptr, np.int32)
    indices = np.asarray(row_idx, np.int32)
    if strategy != "auto" and strategy not in STRATEGIES:
        raise ValueError(f"unknown BCSC strategy {strategy!r} (known: auto, "
                         f"{', '.join(STRATEGIES)})")
    # validate the blocking AT CREATE: a floored nb would silently drop
    # output columns
    if shape.n % bn or shape.k % bk:
        raise ValueError(f"BCSC blocking must divide the shape: "
                         f"n={shape.n} % bn={bn}, k={shape.k} % bk={bk}")
    nb = shape.n // bn
    if len(indptr) != nb + 1:
        raise ValueError(f"column_ptr must have n/bn+1 = {nb + 1} entries, "
                         f"got {len(indptr)}")
    dev = resolve_device(device)
    bcsc = BcscMatrix((shape.k, shape.n), bk, bn, indptr, indices)
    nblocks = bcsc.nblocks
    if strategy == "auto":
        strategy = _bcsc_autotune(shape, flags, config, indptr, indices,
                                  bcsc, dev)
    pattern = SparsePattern(format="bcsc", rows=shape.k, cols=shape.n,
                            nnz=nblocks * bk * bn,
                            fingerprint=bcsc.fingerprint(), block=(bk, bn))
    desc = ("pspgemm_bcsc", shape, GemmFlags(flags), config, pattern,
            strategy, dev)
    info = KernelInfo(kind="pspgemm_bcsc",
                      nflops=2 * nblocks * bk * bn * shape.m)
    name = f"pspgemm_bcsc_{shape.m}x{shape.n}x{shape.k}"

    def _build(_key):
        if strategy == "super":
            return _build_bcsc_super(shape, config, indptr, indices, desc,
                                     nblocks, dev)
        if strategy in _UNION:
            ua = {"union4a": max(1, 128 // bk),
                  "union4d": max(1, shape.k // bk)}.get(strategy, 1)
            pfn = spmm_kernels.build_bcsc_spmm_union(
                shape, config, indptr, indices, dev, u_align=ua)
            if pfn is None:
                raise ValueError("descriptor unsupported by the k-union "
                                 "BCSC kernel (need bn|128, 128|n, bk|k, "
                                 "f32/bf16 operands)")
            return Kernel(fn=_kernel_route(pfn, dev), descriptor=desc,
                          info=info,
                          name=f"{name}_{strategy}_u{pfn.union_panels}")
        if strategy == "pallas":
            pfn = spmm_kernels.build_bcsc_spmm(shape, config, indptr,
                                               indices, dev)
            if pfn is None:
                raise ValueError("descriptor unsupported by the scheduled "
                                 "BCSC kernel (need f32/bf16 operands); use "
                                 "strategy='sparse'/'dense'")
            return Kernel(fn=_kernel_route(pfn, dev), descriptor=desc,
                          info=info, name=f"{name}_pallas")
        return Kernel(fn=_torch_route(shape, config, indptr, indices,
                                      strategy, dev),
                      descriptor=desc, info=info, name=f"{name}_{strategy}")

    return get_registry().dispatch(desc, _build)


def _dense_product(a: torch.Tensor, b: torch.Tensor,
                   comp: torch.dtype) -> torch.Tensor:
    """a @ b accumulated in `comp` (lax.dot_general with
    preferred_element_type): 16-bit float operands on the card go to one
    matmul with an f32 output; elsewhere kernels.gemm.contract (widened
    operands, integers exact through float64)."""
    if (a.is_cuda and comp == torch.float32
            and a.dtype in (torch.bfloat16, torch.float16)):
        return torch.mm(a, b, out_dtype=torch.float32)
    return contract(torch.mm, a, b, comp)


def _torch_route(shape: GemmShape, config: SpgemmConfig, indptr: np.ndarray,
                 indices: np.ndarray, strategy: str, dev):
    """fn(a, values[, c]) of the "dense" and "sparse" lowerings: the sum in
    the compute type, c added in it, one rounding to the output type."""
    bk, bn = config.bk, config.bn
    m, n, k = shape.m, shape.n, shape.k
    kb, nb = k // bk, n // bn
    comp = _comp_dtype(shape)
    out_dt = to_torch(shape.out_type)
    if strategy == "dense":
        densifier = spmm_kernels.build_bcsc_densify(shape, config, indptr,
                                                    indices, dev)
        b_dt = to_torch(shape.b_in_type or shape.a_in_type)
    else:
        rowd = torch.as_tensor(indices.astype(np.int64), device=dev)
        segd = torch.as_tensor(np.repeat(np.arange(nb), np.diff(indptr)),
                               device=dev)
        # integers sum exactly in float64 and wrap to int32 at the end
        acc_dt = torch.float64 if not comp.is_floating_point else comp

    def fn(a, values, c=None):
        a = _as_tensor(a, dev)
        values = _as_tensor(values, dev)
        if strategy == "dense":
            bdense = densifier(values.to(b_dt))
            acc = _dense_product(a, bdense.to(a.dtype), comp)
        else:
            # A panels: (m, k) -> (kb, m, bk) -> gather by block row
            panels = a.reshape(m, kb, bk).transpose(0, 1)
            pb = torch.bmm(panels.index_select(0, rowd).to(acc_dt),
                           values.to(acc_dt))          # (nblk, m, bn)
            acc = pb.new_zeros((nb, m, bn)).index_add_(0, segd, pb)
            acc = acc.transpose(0, 1).reshape(m, n)
            if not comp.is_floating_point:
                acc = wrap_i32(acc.to(torch.int64))
        if c is not None:
            acc = add_acc(acc, _as_tensor(c, dev))
        return acc.to(out_dt)

    return fn
