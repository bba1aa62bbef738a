"""The BCSC lab's probe kernels — the wrappers around the hand-written CUDA
kernels of csrc/spmm_lab_kernels.cu, each with its plain torch version.

The port of the Pallas probes of `scripts/bcsc_lab.py` make_variants (:67):
variants of the k-union SpMM kernel (kernels/spmm.py build_bcsc_spmm_union)
that `libxsmm_torch/scripts/bcsc_lab.py` times against the library's
strategies. All take the lab's operands: A (m, k) and the BCSC values
(nblocks, 32, 32), cast to bf16, f32 out, over a union plan without
clustering (krows (n/128, U), gmap (n/128, U, 4), nblocks = the zero block):

* BcscLabMinimal — `minimal`: out[:, 128g:128g+128] = A[:, :32U] @ rhs[g]
  over a constant (n/128, 32U, 128) RHS, no gather and no slot skip: the
  floor of the union kernel's loop. It runs Hopper's own tensor-core path
  (path "wgmma"): TMA loads of A's panel and rhs[g] into a ring of
  128-byte swizzled stages and wgmma.m64n128k16 by one warpgroup a 64 x
  128 tile, over a ring that `minimal_plan` sizes (the launcher mirrors
  it). The RHS's
  tensor map is encoded once, when the probe is built on the card; A's on
  every call.
* BcscLabChunk — `chunk1/2/4`: the union product with the fused gather, the
  U slots in N chunks, the fill of chunk c+1 issued before chunk c's math.
* BcscLabDspipe — `dspipe`: the same product, the fill of the next group's
  union issued before this group's math.

chunkN and dspipe multiply on the bf16 tensor cores too (path "mma":
mma.sync m16n8k16, f32 accumulators; the library's union kernel runs
wgmma), over a cp.async staging whose tile `chunk_plan` and `dspipe_plan` choose
(the launcher in the CUDA source mirrors them); a union too deep for any
of their tiles is refused.

Calling a probe checks the operands' shapes, then follows their device: on
CUDA tensors it launches its kernel on the current stream (a build failure
or a refused launch, such as a union too deep for the shared-memory
staging, raises; an operand off 16-byte alignment is copied first), on CPU
tensors it runs `.plain`. `launches` counts kernel
launches, and only those.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from .gemm import (_aligned16, _check, _on_cuda, _on_device, _ptr,
                   _raise_on_error, _stream)
from .spmm import GROUP, BcscUnionCompact, _index

# kernel launches since the last reset_launches(); the wrappers add one where
# they launch their CUDA kernel, and nowhere else
launches = {"bcsc_lab_minimal": 0, "bcsc_lab_chunk": 0, "bcsc_lab_dspipe": 0}
# the source behind each counter and the CUDA kernels its launches run, by
# name (lowering.py files each logged entry under its counter)
ENTRIES = {"bcsc_lab_minimal": ("spmm_lab_kernels",
                                ("bcsc_lab_minimal_wgmma_kernel",)),
           "bcsc_lab_chunk": ("spmm_lab_kernels", ("bcsc_lab_chunk_kernel",)),
           "bcsc_lab_dspipe": ("spmm_lab_kernels",
                               ("bcsc_lab_dspipe_kernel",))}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


BLOCK = 32           # the lab's block edge (bk = bn)
SMEM_MAX = 232448    # bytes of shared memory a block may use (csrc SMEM_MAX)
CHUNK_CW = 64        # chunkN's tile columns, half a group (csrc CHUNK_CW)
DSPIPE_CW = 32       # dspipe's tile columns, one block column (csrc DSPIPE_CW)
CHUNK_ROWS = (64, 32, 16)   # chunkN's tile heights, tried in order
DSPIPE_ROWS = (32, 16)      # dspipe's
CHUNK_PRODUCERS = 256   # staging threads beside the consumers (csrc)
DSPIPE_PRODUCERS = 384
BAR_BYTES = 16       # the staging ring's barriers (csrc BAR_BYTES)
MIN_BK = 64          # minimal's K per ring stage (csrc MIN_BK)
MIN_STAGES = 4       # minimal's ring depth, at most (csrc MIN_STAGES)
MIN_ROWS = 64        # minimal's tile rows (csrc MIN_ROWS)
TENSOR_MAP_BYTES = 128   # sizeof(CUtensorMap)
_lib = None


class StagePlan(NamedTuple):
    """A fused probe's tile and staging: `rows` x `cols` output tile,
    `buffers` buffers of `slots` union slots each, `smem` bytes of shared
    memory, `threads` per block: the consumers (a warp per 16 columns, two
    warps down the rows of a tile of 32 rows or more) and the producers
    (CHUNK_PRODUCERS or DSPIPE_PRODUCERS)."""
    rows: int
    cols: int
    slots: int
    buffers: int
    threads: int
    smem: int


def stage_bytes(rows: int, cols: int, slots: int, buffers: int) -> int:
    """csrc stage_bytes: the ring's two 8-byte barriers, then per buffer A
    (rows x 32 slots) and the RHS (32 slots x cols) in bf16, every row
    padded by 8 elements (16 bytes)."""
    return BAR_BYTES + buffers * 2 * (rows * (slots * BLOCK + 8)
                                      + slots * BLOCK * (cols + 8))


def _plan(heights, cols: int, slots: int, buffers: int,
          producers: int) -> Optional[StagePlan]:
    for rows in heights:
        smem = stage_bytes(rows, cols, slots, buffers)
        if smem <= SMEM_MAX:
            threads = (32 * (2 if rows >= 32 else 1) * (cols // 16)
                       + producers)
            return StagePlan(rows, cols, slots, buffers, threads, smem)
    return None


def chunk_plan(U: int, nchunks: int) -> Optional[StagePlan]:
    """chunkN's staging (csrc launch_chunk): chunks of ceil(U/N) slots, two
    buffers when N > 1, the first of 64, 32, 16 rows that fits; None when
    none does (the launch is refused)."""
    return _plan(CHUNK_ROWS, CHUNK_CW, -(-U // nchunks),
                 2 if nchunks > 1 else 1, CHUNK_PRODUCERS)


def dspipe_plan(U: int) -> Optional[StagePlan]:
    """dspipe's staging (csrc launch_dspipe): two buffers of the whole
    union, 32 rows if they fit, else 16; None when neither does."""
    return _plan(DSPIPE_ROWS, DSPIPE_CW, U, 2, DSPIPE_PRODUCERS)


class MinimalPlan(NamedTuple):
    """minimal's launch: a ring of `stages` 64-deep stages, `blocks` in
    the grid (64-row tiles times groups, 160 threads each: one consumer
    warpgroup and one producer warp), `smem` bytes of dynamic shared
    memory (csrc min_smem_bytes: 1024 bytes of alignment slack, the
    stages, two mbarriers a stage)."""
    stages: int
    blocks: int
    smem: int


def minimal_plan(m: int, n: int, U: int) -> MinimalPlan:
    """csrc minimal_stages and launch_minimal: min(MIN_STAGES,
    ceil(32U / 64)) stages of 24 KB, a block per 64-row tile and group."""
    stages = min(MIN_STAGES, -(-U * BLOCK // MIN_BK))
    stage = MIN_ROWS * MIN_BK * 2 + 2 * MIN_BK * 64 * 2
    return MinimalPlan(stages, -(-m // MIN_ROWS) * (n // GROUP),
                       1024 + stages * stage + 2 * stages * 8)


def _kernels() -> ctypes.CDLL:
    """The CUDA library, built and loaded on first use."""
    global _lib
    if _lib is None:
        from . import _build
        lib = _build.load("spmm_lab_kernels")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.xsmm_bcsc_lab_minimal_rhs_map.argtypes = [P, I, I, P]
        lib.xsmm_bcsc_lab_minimal.argtypes = [P, P, P] + [I] * 4 + [P]
        lib.xsmm_bcsc_lab_chunk.argtypes = [P] * 5 + [I] * 6 + [P]
        lib.xsmm_bcsc_lab_dspipe.argtypes = [P] * 5 + [I] * 5 + [P]
        for f in (lib.xsmm_bcsc_lab_minimal_rhs_map,
                  lib.xsmm_bcsc_lab_minimal, lib.xsmm_bcsc_lab_chunk,
                  lib.xsmm_bcsc_lab_dspipe):
            f.restype = I
        lib.xsmm_error_string.argtypes = [I]
        lib.xsmm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


class _LabProbe:
    """fn(a (m, k), values (nblocks, 32, 32)) -> (m, n) f32: the operand
    checks, the device rule and the launch count of the three probes. A
    subclass sets `counter`, `_launch` and `plain`."""

    counter = ""

    def __init__(self, m: int, n: int, k: int, nblocks: int, U: int,
                 plan: torch.Tensor):
        if k % BLOCK or n % GROUP:
            raise ValueError(f"the lab's probes need 32 | k and 128 | n "
                             f"(got k={k}, n={n})")
        self.m, self.n, self.k = m, n, k
        self.nblocks, self.U = nblocks, U
        self.nsg = n // GROUP
        self.plan = plan
        self.name = f"{self.counter}_{m}x{n}x{k}_U{U}"

    def _operands(self, a, values):
        _check("a", a, (self.m, self.k))
        _check("values", values, (self.nblocks, BLOCK, BLOCK))
        return a.to(torch.bfloat16), values.to(torch.bfloat16)

    def __call__(self, a, values):
        a, values = self._operands(a, values)
        if not _on_cuda(a, values, self.plan):
            return self.plain(a, values)
        a, values = _aligned16(a), _aligned16(values)
        out = torch.empty((self.m, self.n), dtype=torch.float32,
                          device=a.device)
        lib = _kernels()
        with _on_device(a.device):
            err = self._launch(lib, a, values, out)
        _raise_on_error(err, self.name, lib)
        launches[self.counter] += 1
        return out


class BcscLabMinimal(_LabProbe):
    """`minimal`: per group g, A[:, :32U] @ rhs[g] in f32 over the constant
    RHS `rhs` (n/128, 32U, 128) bf16, which lives on the probe's device
    (on the card, its TMA map is encoded here, once); `values` is checked
    and not read."""

    counter = "bcsc_lab_minimal"
    path = "wgmma"

    def __init__(self, m: int, n: int, k: int, nblocks: int,
                 rhs: torch.Tensor):
        U = rhs.shape[1] // BLOCK
        if tuple(rhs.shape) != (n // GROUP, U * BLOCK, GROUP) or U * BLOCK > k:
            raise ValueError(f"minimal: rhs of shape {tuple(rhs.shape)} does "
                             f"not fit m={m}, n={n}, k={k}")
        self.rhs = _aligned16(rhs.to(torch.bfloat16))
        super().__init__(m, n, k, nblocks, U, self.rhs)
        self.rhs_map = None
        if self.rhs.is_cuda:
            lib = _kernels()
            self.rhs_map = ctypes.create_string_buffer(TENSOR_MAP_BYTES)
            err = lib.xsmm_bcsc_lab_minimal_rhs_map(
                _ptr(self.rhs), n, U, self.rhs_map)
            _raise_on_error(err, f"{self.name}: the RHS's tensor map", lib)

    def _launch(self, lib, a, values, out):
        return lib.xsmm_bcsc_lab_minimal(
            _ptr(a), self.rhs_map, _ptr(out), self.m, self.k, self.n,
            self.U, _stream(a.device))

    def plain(self, a, values):
        a, _ = self._operands(a, values)
        panel = a[:, :self.U * BLOCK].float()
        out = torch.matmul(panel, self.rhs.float())        # (nsg, m, 128)
        return out.transpose(0, 1).reshape(self.m, self.n)


class _UnionProbe(_LabProbe):
    """The union product over the create-time plan (krows, gmap on
    `device`): per group, A's (m, 32U) panel stack at the union's block rows
    times the (32U, 128) RHS gathered through gmap, in f32, pad slots
    included; the plain version of chunkN and dspipe. Both run on the bf16
    tensor cores; `stage` is the kernel's staging plan (None: refused)."""

    path = "mma"

    def __init__(self, m: int, n: int, k: int, nblocks: int,
                 krows: np.ndarray, gmap: np.ndarray, device):
        nsg, U, W = gmap.shape
        if W != GROUP // BLOCK or nsg != n // GROUP:
            raise ValueError(f"union plan of shape {gmap.shape} does not "
                             f"fit n={n} with 32-column blocks")
        self.krows = _index(np.asarray(krows).reshape(-1), device)
        self.gmap = _index(np.asarray(gmap).reshape(-1), device)
        super().__init__(m, n, k, nblocks, U, self.krows)
        self.compactor = BcscUnionCompact(nsg, U, W, BLOCK, BLOCK, nblocks,
                                          self.gmap, torch.bfloat16)

    def plain(self, a, values):
        a, values = self._operands(a, values)
        m, k, nsg, U = self.m, self.k, self.nsg, self.U
        panels = a.float().reshape(m, k // BLOCK, BLOCK).transpose(0, 1)
        pa = panels[self.krows.long()].reshape(nsg, U, m, BLOCK)
        pa = pa.permute(0, 2, 1, 3).reshape(nsg, m, U * BLOCK)
        out = torch.bmm(pa, self.compactor.plain(values).float())
        return out.transpose(0, 1).reshape(m, self.n)


class BcscLabChunk(_UnionProbe):
    """`chunkN`, N in (1, 2, 4): the U slots in N chunks of ceil(U/N), the
    fill of chunk c+1 overlapping the math of chunk c."""

    counter = "bcsc_lab_chunk"

    def __init__(self, m, n, k, nblocks, krows, gmap, device, nchunks: int):
        if nchunks not in (1, 2, 4):
            raise ValueError(f"chunkN: N must be 1, 2 or 4 (got {nchunks})")
        super().__init__(m, n, k, nblocks, krows, gmap, device)
        self.nchunks = nchunks
        self.stage = chunk_plan(self.U, nchunks)
        self.name = f"{self.name}_chunk{nchunks}"

    def _launch(self, lib, a, values, out):
        return lib.xsmm_bcsc_lab_chunk(
            _ptr(a), _ptr(values), _ptr(self.krows), _ptr(self.gmap),
            _ptr(out), self.m, self.k, self.n, self.U, self.nblocks,
            self.nchunks, _stream(a.device))


class BcscLabDspipe(_UnionProbe):
    """`dspipe`: a block walks the groups of its tile, the next group's
    union staged while this group's is multiplied."""

    counter = "bcsc_lab_dspipe"

    def __init__(self, m, n, k, nblocks, krows, gmap, device):
        super().__init__(m, n, k, nblocks, krows, gmap, device)
        self.stage = dspipe_plan(self.U)

    def _launch(self, lib, a, values, out):
        return lib.xsmm_bcsc_lab_dspipe(
            _ptr(a), _ptr(values), _ptr(self.krows), _ptr(self.gmap),
            _ptr(out), self.m, self.k, self.n, self.U, self.nblocks,
            _stream(a.device))
