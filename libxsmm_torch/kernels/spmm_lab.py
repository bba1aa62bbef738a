"""The BCSC lab's probe kernels — the wrappers around the hand-written CUDA
kernels of csrc/spmm_lab_kernels.cu, each with its plain torch version.

The port of the Pallas probes of `scripts/bcsc_lab.py` make_variants (:67):
variants of the k-union SpMM kernel (kernels/spmm.py build_bcsc_spmm_union)
that `libxsmm_torch/scripts/bcsc_lab.py` times against the library's
strategies. All take the lab's operands: A (m, k) and the BCSC values
(nblocks, 32, 32), cast to bf16, f32 out, over a union plan without
clustering (krows (n/128, U), gmap (n/128, U, 4), nblocks = the zero block):

* BcscLabMinimal — `minimal`: out[:, 128g:128g+128] = A[:, :32U] @ rhs[g]
  over a constant (n/128, 32U, 128) RHS; the union kernel's tile and loop
  with no gather and no slot skip, the floor of the port's own kernel.
* BcscLabChunk — `chunk1/2/4`: the union product with the fused gather, the
  U slots in N chunks, the fill of chunk c+1 issued before chunk c's math.
* BcscLabDspipe — `dspipe`: the same product, the fill of the next group's
  union issued before this group's math.

Calling a probe checks the operands' shapes, then follows their device: on
CUDA tensors it launches its kernel on the current stream (a build failure
or a refused launch, such as a union too deep for the shared-memory
staging, raises; an operand off 16-byte alignment is copied first), on CPU
tensors it runs `.plain`. `launches` counts kernel
launches, and only those.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .gemm import _aligned16, _check, _on_cuda, _ptr, _raise_on_error, _stream
from .spmm import GROUP, BcscUnionCompact, _index

# kernel launches since the last reset_launches(); the wrappers add one where
# they launch their CUDA kernel, and nowhere else
launches = {"bcsc_lab_minimal": 0, "bcsc_lab_chunk": 0, "bcsc_lab_dspipe": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


BLOCK = 32           # the lab's block edge (bk = bn)
_lib = None


def _kernels() -> ctypes.CDLL:
    """The CUDA library, built and loaded on first use."""
    global _lib
    if _lib is None:
        from . import _build
        lib = _build.load("spmm_lab_kernels")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.xsmm_bcsc_lab_minimal.argtypes = [P, P, P, I, I, I, I, P]
        lib.xsmm_bcsc_lab_chunk.argtypes = [P] * 5 + [I] * 6 + [P]
        lib.xsmm_bcsc_lab_dspipe.argtypes = [P] * 5 + [I] * 5 + [P]
        for f in (lib.xsmm_bcsc_lab_minimal, lib.xsmm_bcsc_lab_chunk,
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
        with torch.cuda.device(a.device):
            err = self._launch(lib, a, values, out)
        _raise_on_error(err, self.name, lib)
        launches[self.counter] += 1
        return out


class BcscLabMinimal(_LabProbe):
    """`minimal`: per group g, A[:, :32U] @ rhs[g] in f32 over the constant
    RHS `rhs` (n/128, 32U, 128) bf16, which lives on the probe's device;
    `values` is checked and not read."""

    counter = "bcsc_lab_minimal"

    def __init__(self, m: int, n: int, k: int, nblocks: int,
                 rhs: torch.Tensor):
        U = rhs.shape[1] // BLOCK
        if tuple(rhs.shape) != (n // GROUP, U * BLOCK, GROUP) or U * BLOCK > k:
            raise ValueError(f"minimal: rhs of shape {tuple(rhs.shape)} does "
                             f"not fit m={m}, n={n}, k={k}")
        self.rhs = rhs.to(torch.bfloat16).contiguous()
        super().__init__(m, n, k, nblocks, U, self.rhs)

    def _launch(self, lib, a, values, out):
        return lib.xsmm_bcsc_lab_minimal(
            _ptr(a), _ptr(self.rhs), _ptr(out), self.m, self.k, self.n,
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
    included; the plain version of chunkN and dspipe."""

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

    def _launch(self, lib, a, values, out):
        return lib.xsmm_bcsc_lab_dspipe(
            _ptr(a), _ptr(values), _ptr(self.krows), _ptr(self.gmap),
            _ptr(out), self.m, self.k, self.n, self.U, self.nblocks,
            _stream(a.device))
