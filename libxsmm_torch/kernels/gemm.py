"""Batched small-GEMM kernels — the wrappers around the hand-written CUDA
kernels of csrc/gemm_kernels.cu, each with its plain torch version.

The port of `libxsmm_tpu/kernels/gemm_pallas.py`. The same three kernels,
the same support predicates and the same fused epilogues:

* build_batched_gemm — (B,m,k)x(B,k,n) [+C] -> (B,m,n), f32/bf16, m <= 256,
  n,k <= 128, no transposes, problems streamed through a ring of shared
  memory by bulk copies or cp.async (batched_plan); other descriptors take
  the torch route in ops.gemm (the reference routes them to XLA).
* build_packed_batched_gemm — the lane-packed batched SMM (the headline):
  P = 128//n problems side by side along the last axis (ops.gemm.
  pack_batched); f32/bf16/int8.
* build_packed_brgemm — the lane-packed batch-reduce GEMM with the fused
  cp epilogue and the ADD bias operand; bf16 with n % 8 == 0 runs a wgmma
  kernel on TMA-fed tiles, f32 with n % 4 == 0 an FMA kernel on TMA-fed
  tiles, the rest an FMA kernel with its own loads (brgemm_path).

Beside them, the two streaming twins the JAX package times its kernels
against: build_packed_brgemm_sol (gemm_pallas.py:334), the BRGEMM's grid and
loads without the products, and build_packed_smm_passthrough (bench.py:438),
o = a + b over the packed SMM's bytes as one streaming pass
(passthrough_plan).

Every builder returns a wrapper object. Calling it checks the operands'
shape and dtype, then follows their device: on CUDA tensors it allocates the
output with torch.empty and launches the kernel on the current stream (a
build failure, a refused launch or a combination the kernel lacks raises —
there is no fallback); on CPU tensors it runs `.plain`, the plain torch
version of the same function, which is also what chip_smoke.py holds each
kernel against on the card. `launches` counts kernel launches per kernel,
and only those.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Optional

import torch

from ..descriptor import GemmDescriptor
from ..dtypes import Datatype, to_torch

# kernel launches per kernel since the last reset_launches(); the wrappers
# add one where they launch their CUDA kernel, and nowhere else
launches = {"batched_gemm": 0, "packed_batched_gemm": 0, "packed_brgemm": 0,
            "packed_brgemm_sol": 0, "packed_smm_passthrough": 0}
# the same launches split by the CUDA route that served them: the BRGEMM's
# and its twin's kernel (brgemm_path), the batched SMM's copy route
# (batched_route)
path_launches = {name: {"wgmma": 0, "tma_fma": 0, "fma": 0}
                 for name in ("packed_brgemm", "packed_brgemm_sol")}
path_launches["batched_gemm"] = {"bulk": 0, "cp_async": 0}
# the source behind each counter and the CUDA kernels its launches run, by
# name (lowering.py files each logged entry under its counter)
_BRGEMM = ("brgemm_partial_wgmma_kernel", "brgemm_partial_tma_fma_kernel",
           "brgemm_partial_kernel", "brgemm_reduce_kernel")
ENTRIES = {"batched_gemm": ("gemm_kernels", ("batched_gemm_ring_kernel",)),
           "packed_batched_gemm": ("gemm_kernels", ("packed_smm_kernel",)),
           "packed_brgemm": ("gemm_kernels", _BRGEMM),
           "packed_brgemm_sol": ("gemm_kernels", _BRGEMM),
           "packed_smm_passthrough": ("gemm_kernels",
                                      ("packed_smm_passthrough_kernel",))}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    for counts in path_launches.values():
        for path in counts:
            counts[path] = 0


_TYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
              torch.int32: 3}
_EPI_CODE = {"NONE": 0, "IDENTITY": 0, "RELU": 1, "X2": 2, "TANH": 3,
             "SIGMOID": 4, "GELU": 5}

_lib = None


def _kernels() -> ctypes.CDLL:
    """The CUDA library, built and loaded on first use."""
    global _lib
    if _lib is None:
        from . import _build
        lib = _build.load("gemm_kernels")
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.xsmm_packed_smm.argtypes = [P, P, P, P, I, I, I, I, I, I, I, P]
        lib.xsmm_batched_gemm.argtypes = [P, P, P, P] + [I] * 10 + [P]
        lib.xsmm_packed_brgemm.argtypes = [P, P, P, P, P, P, I, I, I, I, LL,
                                           I, I, I, I, P]
        lib.xsmm_packed_brgemm_sol.argtypes = [P, P, P, P, I, I, I, I, LL, I,
                                               I, P]
        lib.xsmm_packed_brgemm_wgmma.argtypes = \
            lib.xsmm_packed_brgemm.argtypes
        lib.xsmm_packed_brgemm_sol_wgmma.argtypes = \
            lib.xsmm_packed_brgemm_sol.argtypes
        lib.xsmm_packed_brgemm_tma_fma.argtypes = \
            lib.xsmm_packed_brgemm.argtypes
        lib.xsmm_packed_brgemm_sol_tma_fma.argtypes = \
            lib.xsmm_packed_brgemm_sol.argtypes
        lib.xsmm_packed_smm_passthrough.argtypes = [P, P, P, LL, P]
        for f in (lib.xsmm_packed_smm, lib.xsmm_batched_gemm,
                  lib.xsmm_packed_brgemm, lib.xsmm_packed_brgemm_sol,
                  lib.xsmm_packed_brgemm_wgmma,
                  lib.xsmm_packed_brgemm_sol_wgmma,
                  lib.xsmm_packed_brgemm_tma_fma,
                  lib.xsmm_packed_brgemm_sol_tma_fma,
                  lib.xsmm_packed_smm_passthrough):
            f.restype = I
        lib.xsmm_error_string.argtypes = [I]
        lib.xsmm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on_error(err: int, what: str, lib=None) -> None:
    """Raise when a launch returned a CUDA error; `lib` (default: this
    module's library) names the error."""
    if err != 0:
        msg = (lib or _kernels()).xsmm_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed, error {err} ({msg})")


def _on_cuda(*tensors) -> bool:
    """True when the operands lie on one CUDA device, False when they lie
    on the CPU (the plain version's device); raises on a mix."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"operands lie on different devices: "
                         f"{sorted(str(d) for d in devices)}")
    device = devices.pop()
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device.type == "cuda"


def _ptr(t: Optional[torch.Tensor]):
    """A tensor's address for a ctypes pointer argument (every entry
    declares its argtypes, so a plain int converts; None is NULL)."""
    return None if t is None else t.data_ptr()


def _stream(device: torch.device) -> int:
    """The address of the current CUDA stream of `device`, read without
    building a torch.cuda.Stream (a few microseconds of host time a
    call)."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return torch._C._cuda_getCurrentRawStream(index)


def _on_device(device: torch.device):
    """The context a launch on `device` runs in: torch.cuda.device(device),
    or none when `device` is already the current device (a launch's usual
    case, which then pays no device switch on the host)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


_sm_counts: Dict[int, int] = {}


def _num_sms(device: torch.device) -> int:
    """The SM count of a CUDA device, read from its properties once."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    count = _sm_counts.get(index)
    if count is None:
        count = _sm_counts[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return count


def _type_code(dtype: torch.dtype, what: str) -> int:
    code = _TYPE_CODE.get(dtype)
    if code is None:
        raise ValueError(f"{what}: no CUDA kernel for dtype {dtype}")
    return code


def _check(name: str, t: torch.Tensor, shape, dtype=None) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name}: expected dtype {dtype}, got {t.dtype}")


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and starting on a 16-byte boundary, for kernels that
    stage in 16-byte units: a view off that alignment is copied into a
    fresh (aligned) tensor."""
    if t.data_ptr() % 16 == 0:
        return t.contiguous()
    return t.clone(memory_format=torch.contiguous_format)


def wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound (the reference's
    int32 arithmetic)."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def contract(fn, a: torch.Tensor, b: torch.Tensor,
             comp: torch.dtype) -> torch.Tensor:
    """fn(a, b) (a matmul or einsum) accumulated in `comp`. Integer operands
    run through float64 (exact while |sum| < 2**53; CUDA has no integer
    matmul) and wrap to int32."""
    if comp.is_floating_point:
        return fn(a.to(comp), b.to(comp))
    return wrap_i32(fn(a.double(), b.double()).to(torch.int64))


def add_acc(acc: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """acc + c in acc's type (int32 wraps)."""
    if acc.is_floating_point():
        return acc + c.to(acc.dtype)
    return wrap_i32(acc.to(torch.int64) + c.to(torch.int64))


# ---------------------------------------------------------------------------
# support predicates (the reference's, libxsmm_tpu/kernels/gemm_pallas.py)
# ---------------------------------------------------------------------------

def _supported(desc: GemmDescriptor) -> bool:
    s = desc.shape
    if desc.trans_a or desc.trans_b:
        return False  # the torch route handles transposes
    # the reference has no f16 kernel (Mosaic lacks f16); F16 descriptors
    # take the torch route, as they take XLA's there
    if s.a_in_type not in (Datatype.F32, Datatype.BF16):
        return False
    if s.b_in_type != s.a_in_type:
        return False
    if s.out_type not in (Datatype.F32, Datatype.BF16):
        return False
    if s.m > 256 or s.n > 128 or s.k > 128:
        return False
    return True


def packed_brgemm_supported(desc: GemmDescriptor) -> bool:
    """Lane-packed BRGEMM needs k | 128 and f32/bf16 operands."""
    s = desc.shape
    if desc.trans_a or desc.trans_b:
        return False
    if s.a_in_type not in (Datatype.F32, Datatype.BF16):
        return False
    if s.b_in_type != s.a_in_type:
        return False
    if 128 % s.k or s.k > 128:
        return False
    return s.m <= 1024 and s.n <= 1024


def packed_smm_supported(desc: GemmDescriptor) -> bool:
    """Lane-packing needs k == n, n dividing 128, and f32/bf16/int8."""
    s = desc.shape
    if desc.trans_a or desc.trans_b:
        return False
    if s.a_in_type not in (Datatype.F32, Datatype.BF16, Datatype.I8):
        return False
    if s.b_in_type != s.a_in_type:
        return False
    if s.k != s.n or 128 % s.n or s.n > 128:
        return False
    return s.m <= 512


# ---------------------------------------------------------------------------
# fused output epilogues (the BRGEMM-ext cp_type subset that is elementwise
# on the accumulator; csrc/gemm_kernels.cu apply_epi is the CUDA side)
# ---------------------------------------------------------------------------

def _erf_approx(x: torch.Tensor) -> torch.Tensor:
    """erf via Abramowitz-Stegun 7.1.26 (|err| <= 1.5e-7), the reference's
    in-kernel approximation (libxsmm_tpu/kernels/gemm_pallas.py:443)."""
    sign = torch.where(x < 0, -torch.ones((), dtype=x.dtype, device=x.device),
                       torch.ones((), dtype=x.dtype, device=x.device))
    ax = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return sign * (1.0 - poly * torch.exp(-ax * ax))


def _x2(x: torch.Tensor) -> torch.Tensor:
    if x.is_floating_point():
        return x * x
    return wrap_i32(x.to(torch.int64) * x.to(torch.int64))


_EPILOGUES = {
    "NONE": lambda x: x,
    "IDENTITY": lambda x: x,
    "RELU": lambda x: torch.maximum(x, torch.zeros((), dtype=x.dtype,
                                                   device=x.device)),
    "X2": _x2,
    "TANH": torch.tanh,
    "SIGMOID": lambda x: 1.0 / (1.0 + torch.exp(-x)),
    "GELU": lambda x: 0.5 * x * (1.0 + _erf_approx(x * 0.7071067811865476)),
}


# ---------------------------------------------------------------------------
# 1. unpacked batched SMM
# ---------------------------------------------------------------------------

_BG_CONSUMERS = 128      # consumer threads of a block (csrc BG_CONSUMERS)
_BG_SMEM_MAX = 232448    # a block's dynamic shared memory (csrc BG_SMEM_MAX)
_BG_SMEM_SM = 233472     # an SM's, 1 KB kept per block (csrc BG_SMEM_SM)
_BG_MAX_BLOCKS = 4       # blocks per SM, the launch bounds' (csrc BG_MAX_BLOCKS)
_BG_ROUTES = {"bulk": 0, "cp_async": 1}   # csrc BG_BULK, BG_CPASYNC


def _align16(x: int) -> int:
    return -(-x // 16) * 16


def batched_route(m: int, n: int, k: int, in_dtype: torch.dtype) -> str:
    """The batched SMM's copy route, as csrc bg_route takes it: "bulk"
    (1-D bulk copies) where every problem's A and B runs are whole 16-byte
    units, "cp_async" (16- and 4-byte cp.async) otherwise. It follows the
    shape
    alone; neither falls back to the other."""
    sz = in_dtype.itemsize
    return ("bulk" if (m * k * sz) % 16 == 0 and (k * n * sz) % 16 == 0
            else "cp_async")


def batched_smem(route: str, mt: int, stages: int, n: int, k: int,
                 in_dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block (csrc bg_stage_bytes): `stages`
    stages of an mt-row tile of A and the whole B, each run padded to 16
    bytes (and 16 more on the cp.async route, which places each run at
    its address mod 16), plus
    a full and an empty mbarrier per stage."""
    sz = in_dtype.itemsize
    pad = 16 if route == "cp_async" else 0
    stage = _align16(mt * k * sz) + pad + _align16(k * n * sz) + pad
    return stages * (stage + 16)


def batched_gemm_configs(m: int, n: int, k: int,
                         in_dtype: torch.dtype = torch.float32):
    """Launch configurations (rows per stage, stages, blocks per SM) that
    tune=True chooses among; the first is the plan's (batched_plan). The
    plan takes the largest tile of rows (all m, else 128, 64, ... 8) whose
    two-stage ring fits a block's shared memory (one unit's copies land
    while the other is computed; deeper rings ran slower at 32^3 f32 on an
    H100, `chip_smoke.py`'s configuration lines), and as many blocks per SM
    (up to four, the kernel's launch bounds) as the SM's shared memory
    holds. The other candidates are the deepest ring of 3 or 4 stages that
    fits that tile, and the next smaller tile."""
    route = batched_route(m, n, k, in_dtype)

    def config(mt, stages):
        smem = batched_smem(route, mt, stages, n, k, in_dtype)
        if smem > _BG_SMEM_MAX:
            return None
        return mt, stages, max(1, min(_BG_MAX_BLOCKS,
                                      _BG_SMEM_SM // (smem + 1024)))

    tiles = [c for c in (config(mt, 2) for mt in [m] + [
        r for r in (128, 64, 32, 16, 8) if r < m]) if c is not None]
    deep = next((c for c in (config(tiles[0][0], s) for s in (4, 3))
                 if c is not None), None)
    cands = [tiles[0]] + ([deep] if deep else []) + tiles[1:2]
    return list(dict.fromkeys(cands))


def batched_plan(m: int, n: int, k: int, in_dtype: torch.dtype):
    """(route, rows per stage, stages, blocks per SM) of the batched SMM
    for a shape the reference accepts (m <= 256, n and k <= 128, f32/bf16
    in and out). Every such shape fits: at worst an 8-row tile of A and all
    of B (n = k = 128 f32: 68 KB) twice. The output type does not enter:
    outputs go from registers to device memory."""
    return (batched_route(m, n, k, in_dtype),) + batched_gemm_configs(
        m, n, k, in_dtype)[0]


class BatchedGemm:
    """fn(a, b[, c]) for a:(B,m,k) b:(B,k,n) [c:(B,m,n)] -> (B,m,n)."""

    def __init__(self, desc: GemmDescriptor, batch: int, config=None):
        s = desc.shape
        self.m, self.n, self.k = s.m, s.n, s.k
        self.batch = batch
        self.in_dt = to_torch(s.a_in_type)
        self.out_dt = to_torch(s.out_type)
        self.beta0 = desc.beta == 0
        self.route = batched_route(s.m, s.n, s.k, self.in_dt)
        self.config = (tuple(config) if config else
                       batched_gemm_configs(s.m, s.n, s.k, self.in_dt)[0])
        self.name = desc.name() + "_batched_cuda"

    def _operands(self, a, b, c):
        _check("a", a, (self.batch, self.m, self.k), self.in_dt)
        _check("b", b, (self.batch, self.k, self.n), self.in_dt)
        if self.beta0:
            return None
        if c is None:
            raise ValueError("beta=1 batched GEMM needs the C operand")
        _check("c", c, (self.batch, self.m, self.n))
        return c

    def __call__(self, a, b, c=None):
        c = self._operands(a, b, c)
        if not _on_cuda(a, b, c):
            return self.plain(a, b, c)
        mt, stages, blocks = self.config
        units = self.batch * -(-self.m // mt)
        grid = min(units, _num_sms(a.device) * blocks)
        out = torch.empty((self.batch, self.m, self.n), dtype=self.out_dt,
                          device=a.device)
        # the bulk route copies from 16-byte aligned bases and reads C0 in
        # 16-byte units: views off that alignment are copied
        if self.route == "bulk":
            a, b = _aligned16(a), _aligned16(b)
        else:
            a, b = a.contiguous(), b.contiguous()
        c = None if c is None else _aligned16(c.to(torch.float32))
        lib = _kernels()
        with torch.cuda.device(a.device):
            err = lib.xsmm_batched_gemm(
                _ptr(a), _ptr(b), _ptr(c), _ptr(out), self.batch, self.m,
                self.n, self.k, _type_code(self.in_dt, self.name),
                _type_code(self.out_dt, self.name), _BG_ROUTES[self.route],
                mt, stages, grid, _stream(a.device))
        _raise_on_error(err, self.name)
        launches["batched_gemm"] += 1
        path_launches["batched_gemm"][self.route] += 1
        return out

    def plain(self, a, b, c=None):
        acc = torch.matmul(a.float(), b.float())
        if c is not None:
            acc = acc + c.float()
        return acc.to(self.out_dt)


def build_batched_gemm(desc: GemmDescriptor, batch: int,
                       config=None) -> Optional[BatchedGemm]:
    """Return fn(a, b[, c]) for a:(B,m,k) b:(B,k,n), or None if the
    descriptor should take the torch route. `config` is a launch
    configuration from batched_gemm_configs (default: the plan's)."""
    if not _supported(desc) or batch <= 0:
        return None
    return BatchedGemm(desc, batch, config)


# ---------------------------------------------------------------------------
# 2. lane-packed BRGEMM
# ---------------------------------------------------------------------------

_BR_BK = 16     # K slice of one partial-sum step (csrc BR_BK)
_BR_TILE = 64   # output tile edge (csrc BR_BM == BR_BN)
_TC_BK = 64     # the tensor-core kernel's K slice (csrc TC_BK)
_TC_TILE = 128  # its output tile edge (csrc TC_BM == TC_BN)
_TF_BK = 32     # the f32 TMA-fed kernel's K slice (csrc TF_BK)
_TF_TILE = 128  # its output tile edge (csrc TF_BM == TF_BN)
# (output tile edge, K slice) of the routes that plan one block per SM
_ONE_PER_SM = {"wgmma": (_TC_TILE, _TC_BK), "tma_fma": (_TF_TILE, _TF_BK)}


def brgemm_path(in_dtype: torch.dtype, n: int) -> str:
    """The CUDA kernel that serves a packed BRGEMM (and its twin), as csrc
    takes it: "wgmma" (bf16 tiles fed by TMA into the tensor cores) for bf16
    operands whose B rows are whole 16-byte units (n % 8 == 0: TMA's global
    stride), "tma_fma" (f32 tiles fed by TMA into the CUDA cores' FMAs; f32
    means f32, no TF32) for f32 operands with n % 4 == 0, "fma" (the FMA
    kernel with its own loads) for the rest. A's row stride, Q*k elements,
    is always a multiple of 128. No route falls back to another."""
    if in_dtype == torch.bfloat16 and n % 8 == 0:
        return "wgmma"
    if in_dtype == torch.float32 and n % 4 == 0:
        return "tma_fma"
    return "fma"


class PackedBrgemm:
    """fn(a, b[, c][, d]) with a:(br/Q, m, Q*k) packed, b:(br, k, n),
    c/d:(m, n) -> (m, n) = epi(sum_i A_i B_i + C0 + D)."""

    def __init__(self, desc: GemmDescriptor, br: int, q: int,
                 step_groups: Optional[int], cp_type: str, with_bias: bool):
        s = desc.shape
        self.m, self.n, self.k = s.m, s.n, s.k
        self.q, self.groups = q, br // q
        self.br = br
        self.in_dt = to_torch(s.a_in_type)
        self.out_dt = to_torch(s.out_type)
        self.beta0 = desc.beta == 0
        self.cp_type = cp_type
        self.epilogue = _EPILOGUES[cp_type]
        self.with_bias = with_bias
        self.step_groups = step_groups
        self.path = brgemm_path(self.in_dt, self.n)
        self.name = (desc.name() + "_packed_brgemm"
                     + ("" if cp_type == "NONE" else f"_{cp_type.lower()}")
                     + ("_bias" if with_bias else ""))

    def splits(self, num_sms: int):
        """(K per block, number of blocks along K). step_groups, when
        given, is the number of groups one block reduces; otherwise the K
        range is cut so that about four blocks per SM are in flight on the
        FMA path, and on the TMA-fed paths (128 x 128 tiles, whole 64-deep
        bf16 or 32-deep f32 slices, one block per SM) so that tiles x
        splits stays at or under the SM count, as close to it as whole
        slices allow."""
        qk = self.q * self.k
        total = self.groups * qk
        if self.step_groups:
            kchunk = max(1, int(self.step_groups)) * qk
        else:
            one = _ONE_PER_SM.get(self.path)
            tile, bk = one or (_BR_TILE, _BR_BK)
            tiles = (-(-self.m // tile)) * (-(-self.n // tile))
            want = max(1, num_sms // tiles if one
                       else -(-4 * num_sms // tiles))
            kchunk = -(-total // want)
            kchunk = -(-kchunk // bk) * bk
        return kchunk, -(-total // kchunk)

    def __call__(self, a, b, c=None, d=None):
        m, n, k, q = self.m, self.n, self.k, self.q
        _check("a", a, (self.groups, m, q * k), self.in_dt)
        _check("b", b, (self.br, k, n), self.in_dt)
        c0 = None
        if not self.beta0:
            if c is None:
                raise ValueError("beta=1 packed BRGEMM needs the C operand")
            _check("c", c, (m, n))
            c0 = c
        if self.with_bias:
            if d is None:
                raise ValueError("bias-fused packed BRGEMM needs the D "
                                 "operand")
            _check("d", d, (m, n))
        else:
            d = None
        # legacy convenience: beta-0 callers may still pass c for an add
        # after the kernel, in f32 before the final cast
        late_c = c if self.beta0 else None
        out_dt = torch.float32 if late_c is not None else self.out_dt
        if _on_cuda(a, b, c0, d, late_c):
            out = self._launch(a, b, c0, d, out_dt)
        else:
            out = self.plain(a, b, c0, d, out_dt)
        if late_c is not None:
            out = (out + late_c.to(torch.float32)).to(self.out_dt)
        return out

    def _workspace(self, device):
        """(K per block, K splits, the f32 partial-sum workspace) of a
        launch on `device`."""
        kchunk, splits = self.splits(_num_sms(device))
        if splits > 65535:
            raise ValueError(f"{self.name}: {splits} K splits exceed the "
                             "grid's z limit (raise step_groups)")
        ws = torch.empty((splits, self.m, self.n), dtype=torch.float32,
                         device=device)
        return kchunk, splits, ws

    def _operands(self, a, b):
        """a and b as the kernel takes them: contiguous, and on the TMA-fed
        paths 16-byte aligned (TMA's base address)."""
        if self.path in _ONE_PER_SM:
            return _aligned16(a), _aligned16(b)
        return a.contiguous(), b.contiguous()

    def _launch(self, a, b, c0, d, out_dt):
        m, n = self.m, self.n
        kchunk, splits, ws = self._workspace(a.device)
        a, b = self._operands(a, b)
        c0 = None if c0 is None else c0.to(torch.float32).contiguous()
        d = None if d is None else d.to(torch.float32).contiguous()
        out = torch.empty((m, n), dtype=out_dt, device=a.device)
        lib = _kernels()
        launch = {"wgmma": lib.xsmm_packed_brgemm_wgmma,
                  "tma_fma": lib.xsmm_packed_brgemm_tma_fma,
                  "fma": lib.xsmm_packed_brgemm}[self.path]
        with torch.cuda.device(a.device):
            err = launch(
                _ptr(a), _ptr(b), _ptr(ws), _ptr(c0), _ptr(d), _ptr(out),
                self.groups, m, n, self.q * self.k, kchunk, splits,
                _type_code(self.in_dt, self.name),
                _type_code(out_dt, self.name), _EPI_CODE[self.cp_type],
                _stream(a.device))
        _raise_on_error(err, self.name)
        launches["packed_brgemm"] += 1
        path_launches["packed_brgemm"][self.path] += 1
        return out

    def plain(self, a, b, c0=None, d=None, out_dt=None):
        m, n = self.m, self.n
        qk = self.q * self.k
        # contraction index K = g*Q*k + j pairs a[g, :, j] with row K of b
        # viewed as (br*k, n): the whole batch-reduce is one matmul
        a2 = a.permute(1, 0, 2).reshape(m, self.groups * qk)
        acc = torch.matmul(a2.float(), b.reshape(self.groups * qk, n).float())
        if c0 is not None:
            acc = c0.float() + acc
        if d is not None:
            acc = acc + d.float()
        return self.epilogue(acc).to(out_dt or self.out_dt)


def _brgemm_pack(desc: GemmDescriptor, br: int,
                 pack_q: Optional[int]) -> Optional[int]:
    """The lane-pack factor Q of a packed BRGEMM (pack_q or 128//k), or
    None where the reference refuses the build."""
    if not packed_brgemm_supported(desc) or br <= 0:
        return None
    q_min = 128 // desc.shape.k
    q = int(pack_q) if pack_q else q_min
    if q < q_min or q % q_min or br % q:
        return None
    return q


def build_packed_brgemm(desc: GemmDescriptor, br: int,
                        step_groups: Optional[int] = None,
                        cp_type: str = "NONE",
                        with_bias: bool = False,
                        pack_q: Optional[int] = None,
                        acc_scratch: bool = False) -> Optional[PackedBrgemm]:
    """Lane-packed batch-reduce GEMM: C = epi(sum_i A_i @ B_i + C0 + D).

    fn(a, b[, c][, d]) with a: (br/Q, m, Q*k) packed (Q = pack_q or
    128//k), b: (br, k, n), c/d: (m, n) -> (m, n). beta=1's C0 seeds the
    sum before the epilogue; `with_bias` adds D before it.

    The CUDA kernel splits the K range over blocks and adds the partial
    sums in a fixed order (csrc/gemm_kernels.cu); `step_groups` sets the
    groups per block. bf16 operands with n % 8 == 0 take the wgmma kernel
    and f32 operands with n % 4 == 0 the TMA-fed FMA kernel (both 128 x 128
    tiles, one block per SM), the rest the FMA kernel (`brgemm_path`; the
    wrapper's `path`); a refused launch raises, with no retry on another
    kernel. `acc_scratch` names a TPU accumulator
    schedule and changes nothing here: the partial sums always live in
    registers."""
    del acc_scratch
    q = _brgemm_pack(desc, br, pack_q)
    if q is None or cp_type not in _EPILOGUES:
        return None
    return PackedBrgemm(desc, br, q, step_groups, cp_type, with_bias)


class PackedBrgemmSol(PackedBrgemm):
    """fn(a, b) with a:(br/Q, m, Q*k) packed, b:(br, k, n) -> (m, n) f32 =
    rowsum(A)[:, None] + colsum(B)[None, :] over the whole contraction: the
    streaming twin of PackedBrgemm, with its K split and workspace."""

    def __init__(self, desc: GemmDescriptor, br: int, q: int,
                 step_groups: Optional[int]):
        super().__init__(desc, br, q, step_groups, "NONE", False)
        self.out_dt = torch.float32
        self.name = desc.name() + "_packed_brgemm_sol"

    def __call__(self, a, b):
        _check("a", a, (self.groups, self.m, self.q * self.k), self.in_dt)
        _check("b", b, (self.br, self.k, self.n), self.in_dt)
        if not _on_cuda(a, b):
            return self.plain(a, b)
        kchunk, splits, ws = self._workspace(a.device)
        a, b = self._operands(a, b)
        out = torch.empty((self.m, self.n), dtype=torch.float32,
                          device=a.device)
        lib = _kernels()
        launch = {"wgmma": lib.xsmm_packed_brgemm_sol_wgmma,
                  "tma_fma": lib.xsmm_packed_brgemm_sol_tma_fma,
                  "fma": lib.xsmm_packed_brgemm_sol}[self.path]
        with torch.cuda.device(a.device):
            err = launch(
                _ptr(a), _ptr(b), _ptr(ws), _ptr(out), self.groups, self.m,
                self.n, self.q * self.k, kchunk, splits,
                _type_code(self.in_dt, self.name), _stream(a.device))
        _raise_on_error(err, self.name)
        launches["packed_brgemm_sol"] += 1
        path_launches["packed_brgemm_sol"][self.path] += 1
        return out

    def plain(self, a, b):
        return (a.float().sum((0, 2))[:, None]
                + b.float().reshape(-1, self.n).sum(0)[None, :])


def build_packed_brgemm_sol(desc: GemmDescriptor, br: int,
                            step_groups: Optional[int] = None,
                            pack_q: Optional[int] = None
                            ) -> Optional[PackedBrgemmSol]:
    """The streaming twin of build_packed_brgemm (the reference's
    structural speed-of-light twin, gemm_pallas.py:334): fn(a, b) -> (m, n)
    f32 = rowsum(A)[:, None] + colsum(B)[None, :], with a: (br/Q, m, Q*k)
    packed and b: (br, k, n).

    The kernel keeps the BRGEMM kernel's route (`brgemm_path`), grid, K
    split (step_groups as there), loads (on the TMA-fed routes its ring
    and barriers) and its fixed-order reduce, with the products replaced
    by running row and column sums (csrc/gemm_kernels.cu), so t_sol /
    t_brgemm says how far the BRGEMM is from its own streaming floor.
    Returns None where the reference's twin refuses."""
    q = _brgemm_pack(desc, br, pack_q)
    return None if q is None else PackedBrgemmSol(desc, br, q, step_groups)


# ---------------------------------------------------------------------------
# 3. lane-packed batched SMM (the headline)
# ---------------------------------------------------------------------------

def packed_smm_configs(m: int):
    """Rows per thread (a block holds 2x that many rows) that tune=True
    chooses among; the first is the default for this m."""
    first = 16 if m >= 32 else 8 if m >= 16 else 4
    return [first] + [r for r in (4, 8, 16) if r != first]


class PackedBatchedGemm:
    """fn(a, b[, c]) with a:(G,m,P*k), b:(G,k,P*n) [c:(G,m,P*n)] ->
    (G,m,P*n) = [epi(A_0B_0 [+C_0]) | ... | epi(A_{P-1}B_{P-1} [+...])]."""

    def __init__(self, desc: GemmDescriptor, groups: int, cp_type: str,
                 rpt: Optional[int] = None):
        s = desc.shape
        self.m, self.n, self.k = s.m, s.n, s.k
        self.p = 128 // s.n
        self.groups = groups
        self.in_dt = to_torch(s.a_in_type)
        self.out_dt = to_torch(s.out_type)
        self.comp_dt = (torch.int32 if s.a_in_type == Datatype.I8
                        else torch.float32)
        self.beta0 = desc.beta == 0
        self.cp_type = cp_type
        self.epilogue = _EPILOGUES[cp_type]
        self.rpt = int(rpt) if rpt else packed_smm_configs(s.m)[0]
        self.name = desc.name() + "_packed_smm"

    def _operands(self, a, b, c):
        g, m, w = self.groups, self.m, self.p * self.n
        _check("a", a, (g, m, self.p * self.k), self.in_dt)
        _check("b", b, (g, self.k, w), self.in_dt)
        if self.beta0:
            return None
        if c is None:
            raise ValueError("beta=1 packed SMM needs the C operand")
        _check("c", c, (g, m, w))
        return c

    def __call__(self, a, b, c=None):
        c = self._operands(a, b, c)
        if not _on_cuda(a, b, c):
            return self.plain(a, b, c)
        a, b = a.contiguous(), b.contiguous()
        c = None if c is None else c.to(self.comp_dt).contiguous()
        for name, t in (("a", a), ("b", b), ("c", c)):
            if t is not None and t.data_ptr() % 16:
                raise ValueError(f"{self.name}: operand {name} is not "
                                 "16-byte aligned")
        out = torch.empty((self.groups, self.m, self.p * self.n),
                          dtype=self.out_dt, device=a.device)
        lib = _kernels()
        with torch.cuda.device(a.device):
            err = lib.xsmm_packed_smm(
                _ptr(a), _ptr(b), _ptr(c), _ptr(out), self.groups, self.m,
                self.k, _type_code(self.in_dt, self.name),
                _type_code(self.out_dt, self.name), _EPI_CODE[self.cp_type],
                self.rpt, _stream(a.device))
        _raise_on_error(err, self.name)
        launches["packed_batched_gemm"] += 1
        return out

    def plain(self, a, b, c=None):
        g, m, n, k, p = self.groups, self.m, self.n, self.k, self.p
        ai = a.reshape(g, m, p, k).permute(0, 2, 1, 3)     # (G, P, m, k)
        bi = b.reshape(g, k, p, n).permute(0, 2, 1, 3)     # (G, P, k, n)
        acc = contract(torch.matmul, ai, bi, self.comp_dt)
        acc = acc.permute(0, 2, 1, 3).reshape(g, m, p * n)
        if c is not None:
            acc = add_acc(acc, c)
        return self.epilogue(acc).to(self.out_dt)


def build_packed_batched_gemm(desc: GemmDescriptor,
                              groups: int,
                              cp_type: str = "NONE",
                              step_groups: Optional[int] = None,
                              rpt: Optional[int] = None
                              ) -> Optional[PackedBatchedGemm]:
    """Lane-packed batched SMM: P = 128//n problems per lane group.

    fn(a, b[, c]) with PACKED operands (see ops.gemm.pack_batched):
      a: (G, m, P*k), b: (G, k, P*n), c: (G, m, P*n) (beta=1 only)
    -> (G, m, P*n) = [A_0B_0 | ... | A_{P-1}B_{P-1}]

    The CUDA kernel runs one block per (group, row tile) and each slot's
    product directly on the packed layout (csrc/gemm_kernels.cu). `rpt`
    (rows per thread, from packed_smm_configs) is its launch
    configuration. `step_groups` names the TPU's groups per grid step and
    changes nothing here: one block always takes one group."""
    del step_groups
    if not packed_smm_supported(desc) or groups <= 0:
        return None
    if desc.shape.a_in_type == Datatype.I8 and cp_type not in (
            "NONE", "IDENTITY", "RELU", "X2"):
        return None   # transcendental epilogues are float-only
    return PackedBatchedGemm(desc, groups, cp_type, rpt)


_PT_THREADS = 1024   # float4 units a block (csrc PT_THREADS)


def passthrough_plan(groups: int, m: int):
    """(float4 units, grid) of the passthrough over (groups, m, 128) f32:
    one float4 pair a thread, block x covering units x * _PT_THREADS ...
    + _PT_THREADS - 1, the last block masked."""
    units = groups * m * 32
    return units, -(-units // _PT_THREADS)


class PackedSmmPassthrough:
    """fn(a, b) -> a + b over (G, m, 128) f32, bit for bit as torch's: one
    streaming pass over the packed SMM's bytes (passthrough_plan)."""

    def __init__(self, groups: int, m: int):
        self.groups, self.m = groups, m
        self.shape = (groups, m, 128)
        self.units = passthrough_plan(groups, m)[0]
        self.name = f"packed_smm_passthrough_{groups}x{m}x128"

    def __call__(self, a, b):
        f32 = torch.float32
        if (a.shape != self.shape or b.shape != self.shape
                or a.dtype != f32 or b.dtype != f32):
            _check("a", a, self.shape, f32)
            _check("b", b, self.shape, f32)
        dev = a.device
        if dev.type != "cuda" or b.device != dev:
            if not _on_cuda(a, b):
                return self.plain(a, b)
        a, b = a.contiguous(), b.contiguous()
        pa, pb = a.data_ptr(), b.data_ptr()
        if (pa | pb) % 16:
            raise ValueError(f"{self.name}: operand {'a' if pa % 16 else 'b'}"
                             " is not 16-byte aligned")
        out = torch.empty_like(a)
        lib = _kernels()
        with _on_device(dev):
            err = lib.xsmm_packed_smm_passthrough(
                pa, pb, out.data_ptr(), self.units, _stream(dev))
        _raise_on_error(err, self.name)
        launches["packed_smm_passthrough"] += 1
        return out

    def plain(self, a, b):
        return a + b


def build_packed_smm_passthrough(groups: int, m: int, S: Optional[int] = None
                                 ) -> Optional[PackedSmmPassthrough]:
    """The packed SMM's passthrough twin (bench.py:438-448, the denominator
    of the headline fraction t_passthrough / t_packed_smm, bench.py:869):
    fn(a, b) -> a + b over (G, m, 128) f32, the fastest streaming pass over
    the headline kernel's bytes (bench.py:865-867's "true DMA speed of
    light"; csrc/gemm_kernels.cu). `S` is the TPU twin's groups per block
    and changes nothing. None when there is nothing to launch (groups or m
    not positive)."""
    del S
    if groups <= 0 or m <= 0:
        return None
    return PackedSmmPassthrough(groups, m)
