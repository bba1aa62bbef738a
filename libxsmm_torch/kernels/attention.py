"""Flash attention — the wrappers around the hand-written CUDA kernels of
csrc/attention_kernels.cu (forward) and csrc/attention_bwd_kernels.cu
(backward: dK/dV and dQ), with their plain torch versions.

The port of `libxsmm_tpu/kernels/attention_pallas.py`: the support
predicate, the position-hash dropout helpers, `build_flash_attention` and
`build_flash_attention_bwd`.

`build_flash_attention(...)` returns a FlashAttention object; calling it
with `(seed, q, kT, v[, bias])` checks the operands, then follows their
device: on CUDA tensors it launches the kernel on the current stream (a
build failure or a refused launch raises; there is no fallback), on CPU
tensors it runs `.plain`, the plain torch version of the same function,
which chip_smoke.py also holds the kernel against on the card.
`build_flash_attention_bwd(...)` returns a FlashAttentionBwd object that
works the same way with `(seed, q, kT, v, dout, lse, delta[, bias])`.
`launches` counts kernel launches, and only those. Both factories take a
`head_map` (check_head_map): an attention whose batch-heads are a block of
a larger one (a rank's share of a data- and head-sharded attention)
hashes each head's global batch-head index, so its dropout mask is its
block of the whole attention's; without one, the local index is hashed.

The CUDA routes: f32 on the CUDA cores' f32 FMAs fed by TMA ("tma_fma",
forward and backward: a producer warpgroup's ring of tiles, 8 x 8
micro-tiles, one tile per hd bucket: 64, 128 or 256; f32 means f32, no
TF32); bf16 on Hopper's warpgroup products ("wgmma": TMA-fed 128-byte
swizzled tiles, hd padded to 64, 128, 192 or 256; the forward one tile per
bucket: `_fwd_tile`; the backward one tile per kernel up to hd 128 and
another past it: `bwd_configs`). `flash_path` and `flash_bwd_path` name
the route a call takes, as the C entry points choose it (by dtype, before
any launch), and each wrapper reports
it as `.path`; an operand off 16-byte alignment is copied first, and a
failed build or launch raises: there is no fallback between the routes.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from .gemm import _aligned16, _check, _on_cuda, _ptr, _raise_on_error, _stream

_NEG = float(np.finfo(np.float32).min)
_M32 = 0xFFFFFFFF

# kernel launches since the last reset_launches(); the wrapper adds one where
# it launches its CUDA kernel, and nowhere else
launches = {"flash_attention_fwd": 0, "flash_attention_bwd_dkv": 0,
            "flash_attention_bwd_dq": 0}
ROUTES = ("tma_fma", "wgmma")
# the same launches split by the route that served them (flash_path,
# flash_bwd_path)
path_launches = {name: dict.fromkeys(ROUTES, 0) for name in launches}
# the source behind each counter and the CUDA kernels its launches run, by
# name (lowering.py files each logged entry under its counter)
ENTRIES = {"flash_attention_fwd": ("attention_kernels", (
               "flash_fwd_tma_fma_kernel", "flash_fwd_wgmma_kernel")),
           "flash_attention_bwd_dkv": ("attention_bwd_kernels", (
               "flash_bwd_dkv_tma_fma_kernel", "flash_bwd_dkv_wgmma_kernel",
               "flash_bwd_dkv_wgmma_wide_kernel")),
           "flash_attention_bwd_dq": ("attention_bwd_kernels", (
               "flash_bwd_dq_tma_fma_kernel", "flash_bwd_dq_wgmma_kernel",
               "flash_bwd_dq_wgmma_wide_kernel"))}


# the backward's launches split by the CUDA kernel that served them
# (bwd_kernel: on the wgmma route, the 128-key plan's kernels up to hd 128,
# the wide ones past it)
kernel_launches = dict.fromkeys(ENTRIES["flash_attention_bwd_dkv"][1]
                                + ENTRIES["flash_attention_bwd_dq"][1], 0)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    for counts in path_launches.values():
        for route in counts:
            counts[route] = 0
    for name in kernel_launches:
        kernel_launches[name] = 0


def bwd_kernel(part: str, dtype: torch.dtype, hd: int) -> str:
    """The CUDA kernel the backward's `part` ("dkv" or "dq") runs at dtype
    and hd (csrc run): flash_bwd_<part>_tma_fma_kernel for f32, and for
    bf16 flash_bwd_<part>_wgmma_kernel up to hd 128 and
    flash_bwd_<part>_wgmma_wide_kernel past it."""
    route = flash_bwd_path(dtype, hd)
    wide = "_wide" if route == "wgmma" and hd > _WG_HD_MAX else ""
    return f"flash_bwd_{part}_{route}{wide}_kernel"


_TYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
_bwd_lib = None


def _kernels() -> ctypes.CDLL:
    """The CUDA library, built and loaded on first use."""
    global _lib
    if _lib is None:
        from . import _build
        lib = _build.load("attention_kernels")
        P, I, LL, F, U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float, ctypes.c_uint)
        lib.xsmm_flash_fwd.argtypes = [P, P, P, P, LL, P, P, I, I, I, I, F,
                                       I, I, U, U, F, U, U, U, U, P]
        lib.xsmm_flash_fwd.restype = I
        lib.xsmm_error_string.argtypes = [I]
        lib.xsmm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _bwd_kernels() -> ctypes.CDLL:
    """The backward's CUDA library, built and loaded on first use."""
    global _bwd_lib
    if _bwd_lib is None:
        from . import _build
        lib = _build.load("attention_bwd_kernels")
        P, I, LL, F, U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float, ctypes.c_uint)
        head = [P, P, P, P, P, P, P, LL]    # q kT v dout lse delta bias stride
        tail = [I, I, I, I, F, I, I, U, U, F, U, U, U, U, P]
        lib.xsmm_flash_bwd_dkv.argtypes = head + [P, P, P] + tail
        lib.xsmm_flash_bwd_dkv.restype = I
        lib.xsmm_flash_bwd_dq.argtypes = head + [P] + tail
        lib.xsmm_flash_bwd_dq.restype = I
        lib.xsmm_error_string.argtypes = [I]
        lib.xsmm_error_string.restype = ctypes.c_char_p
        _bwd_lib = lib
    return _bwd_lib


# ---------------------------------------------------------------------------
# support predicate and the position-hash dropout mask
# ---------------------------------------------------------------------------

def supported(s: int, hd: int, dtype: torch.dtype) -> bool:
    """Shapes the fused kernel serves; others take the torch composition
    (ops.attention._naive). The reference also asks its VMEM block formula
    for blocks (attention_pallas.py:133-134); inside this envelope its
    smallest (128, 128) blocks always fit, so the formula refuses nothing
    here."""
    if dtype not in (torch.float32, torch.bfloat16):
        return False
    if s % 128 != 0:
        return False
    return hd % 8 == 0 and hd <= 256


def _dropout_threshold(p: float) -> int:
    """keep iff u32 bits >= thr (attention_pallas.py:137)."""
    return min(int(p * 2.0 ** 32), 2 ** 32 - 1)


def _u32(x):
    """x as u32 in int64 (two's complement for negative int32 values, as
    astype(uint32) reinterprets); Python ints stay ints."""
    if isinstance(x, torch.Tensor):
        x = x.to(torch.int64)
    return x & _M32


def _mul32(a, c: int):
    """(a * c) mod 2**32 for a in [0, 2**32) and a constant c < 2**32,
    computed in 16-bit halves so no int64 product overflows."""
    return ((a & 0xFFFF) * c + (((a >> 16) * (c & 0xFFFF)) << 16)) & _M32


# the identity head map: the hash reads the local batch-head index
NO_HEAD_MAP = (0, 0, 1, 1)


def check_head_map(head_map, bh: int) -> tuple:
    """(b0, h0, nh_local, nh_global) of an attention over bh = batches *
    nh_local local heads that is a block of one over nh_global heads: its
    local batch-head i hashes global batch-head (b0 + i // nh_local) *
    nh_global + h0 + i % nh_local (a rank of a sharded attention draws the
    unsharded attention's dropout bits). None is NO_HEAD_MAP."""
    if head_map is None:
        return NO_HEAD_MAP
    b0, h0, nhl, nhg = (int(v) for v in head_map)
    if min(b0, h0) < 0 or nhl <= 0 or h0 + nhl > nhg or bh % nhl:
        raise ValueError(f"head_map {tuple(head_map)}: needs b0, h0 >= 0, "
                         f"h0 + nh_local <= nh_global and nh_local dividing "
                         f"bh={bh}")
    return b0, h0, nhl, nhg


def head_index(bh: int, head_map, device) -> torch.Tensor:
    """The batch-head index the dropout hash reads for each local
    batch-head, (bh, 1, 1) int64 (check_head_map's mapping)."""
    b0, h0, nhl, nhg = check_head_map(head_map, bh)
    i = torch.arange(bh, device=device)
    return ((b0 + i // nhl) * nhg + h0 + i % nhl)[:, None, None]


def _rand_bits(seed, b, row, col):
    """The reference's counter hash (attention_pallas.py:144), bit for bit:
    a splitmix32-style avalanche of (seed, batch, global row, global col).
    Arguments are int tensors or Python ints (broadcast together); the
    result holds the u32 bits in int64."""
    seed, b, row, col = _u32(seed), _u32(b), _u32(row), _u32(col)
    h = _mul32(row, 0x9E3779B1) ^ _mul32(col, 0x85EBCA77)
    h = h ^ ((seed + _mul32(b, 0xC2B2AE3D)) & _M32)
    h = _mul32(h ^ (h >> 15), 0x2C1B3C6D)
    h = _mul32(h ^ (h >> 12), 0x297A2D39)
    return h ^ (h >> 15)


# ---------------------------------------------------------------------------
# launch configurations
# ---------------------------------------------------------------------------

# the wgmma backward (csrc xsmm_flash_wgmma.cuh): one tile a kernel, (rows,
# K columns), up to a padded hd of 128 (FW_HDP_MAX): dQ a block of 128 rows
# against 128-key tiles, dK/dV 64-row Q tiles against a block of 128 keys;
# past it (the wide kernels): dQ 128 rows against 64-key units, dK/dV
# 64-row Q tiles against a block of 64 keys
_WG_HD_MAX = 128
_WG_TILES = {"dkv": (64, 128), "dq": (128, 128)}
_WG_WIDE_TILES = {"dkv": (64, 64), "dq": (128, 64)}
_ALIGN = 1024                             # csrc TF_ALIGN


def flash_path(dtype: torch.dtype, hd: Optional[int] = None) -> str:
    """The forward route (csrc xsmm_flash_fwd), chosen by dtype alone,
    before any launch, at every hd the kernels take (hd <= 256): "tma_fma"
    for f32 (the kernel on the CUDA cores' FMAs fed by TMA; f32 means f32,
    no TF32), "wgmma" for bf16 (the warpgroup kernel on TMA-fed tiles; past
    hd 128 its K tiles narrow to 64 keys so that O, 64 x hd f32 a
    warpgroup, fits a consumer thread's registers beside the scores and
    P: `_fwd_tile`). hd is taken for symmetry with flash_bwd_path."""
    return "wgmma" if dtype == torch.bfloat16 else "tma_fma"


def _fwd_tile(dtype: torch.dtype, hd: int) -> Tuple:
    """The forward kernel's (rows, K columns) (csrc fw_fwd_bk): bf16
    blocks of 128 rows against 128-key tiles up to hd 128 and 64-key tiles
    past it; f32 (None, None): one tile per hd bucket, not named here."""
    if dtype != torch.bfloat16:
        return None, None
    return (128, 128) if hd <= _WG_HD_MAX else (128, 64)


def _bf16_only(dtype: torch.dtype) -> None:
    if dtype != torch.bfloat16:
        raise ValueError(f"{dtype}: only the bf16 kernels have tile "
                         f"configurations; the f32 (tma_fma) kernels take "
                         f"one tile per hd bucket")


def flash_bwd_path(dtype: torch.dtype, hd: Optional[int] = None) -> str:
    """The route both backward kernels take (csrc run), chosen by dtype
    alone, before any launch, at every hd the kernels take (hd <= 256):
    "tma_fma" for f32 (the kernels on TMA-fed FMA tiles), "wgmma" for bf16
    (the warpgroup kernels on TMA-fed tiles; past hd 128 the wide ones,
    whose dK/dV block owns 64 keys and splits hd's columns over its two
    warpgroups, and whose dQ block streams 64-key tiles, so that the
    accumulators fit a consumer thread's registers: `bwd_configs`). hd is
    taken for symmetry with flash_path."""
    return "wgmma" if dtype == torch.bfloat16 else "tma_fma"


def _bwd_hdp(hd: int) -> int:
    """hd padded with zeros to the wgmma backward's bucket: 64, 128, 192 or
    256."""
    return next(p for p in (64, 128, 192, 256) if hd <= p)


def _bwd_smem_bytes(hd: int, kernel: str = "dkv",
                    dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory of one bf16 wgmma backward block (csrc fw_dkv_smem,
    fw_dq_smem, fw_dkv_wide_smem, fw_dq_wide_smem), hd padded to its
    bucket: the alignment slack, the tiles that land once, the ring and its
    barriers. dK/dV: K^T and V of the block's keys once, a ring of stages
    of a 64-row Q and dO tile with their lse and delta rows (three stages
    up to hd 128; past it two, the tiles 256 columns wide at either
    bucket); dQ: Q and dO of its 128 rows once, a ring of two 128-key K^T
    and V stages, past hd 128 of 64-key K^T or V units (four, three at
    256)."""
    _bf16_only(dtype)
    hdp = _bwd_hdp(hd)
    rows, keys = bwd_configs(hd, kernel, dtype)[0]
    if kernel == "dkv":
        stages, width = (3, hdp) if hdp <= _WG_HD_MAX else (2, 256)
        ring = stages * (2 * rows * width * 2 + 2 * rows * 4)
        return _ALIGN + 2 * keys * hdp * 2 + ring + (2 * stages + 1) * 8
    if hdp <= _WG_HD_MAX:
        stages, unit = 2, 2 * keys * hdp * 2
    else:
        stages, unit = (4 if hdp <= 192 else 3), keys * hdp * 2
    return (_ALIGN + 2 * rows * hdp * 2 + stages * unit
            + (2 * stages + 1) * 8)


def bwd_configs(hd: int, kernel: str = "dkv",
                dtype: torch.dtype = torch.bfloat16) -> list:
    """(rows, K columns) per block the bf16 backward kernel `kernel` ("dkv"
    or "dq") takes at hd, on the wgmma route: up to hd 128 dK/dV (64, 128)
    and dQ (128, 128) (_WG_TILES), past it dK/dV (64, 64) and dQ (128, 64)
    (_WG_WIDE_TILES). One tile a kernel and hd bucket, so block_override
    only has to tile s. f32 has none (ValueError)."""
    _bf16_only(dtype)
    return [(_WG_TILES if hd <= _WG_HD_MAX else _WG_WIDE_TILES)[kernel]]


def _check_override(s: int, block_override) -> None:
    """block_override, the reference's TPU tile, must tile s; the CUDA
    kernels take one tile a kernel and hd bucket whatever it is."""
    if block_override is not None:
        bq, bk = (int(x) for x in block_override)
        if bq <= 0 or bk <= 0 or s % bq or s % bk:
            raise ValueError(f"block_override {block_override} does not "
                             f"tile s={s}")


# ---------------------------------------------------------------------------
# the forward kernel
# ---------------------------------------------------------------------------

class FlashAttention:
    """fn(seed, q, kT, v[, bias]) -> out, or (out, lse) with return_lse, for
    q/v: (bh, s, hd), kT: (bh, hd, s), bias: (bias_bh, s, s)."""

    def __init__(self, bh: int, s: int, hd: int, dtype: torch.dtype,
                 causal: bool, scale: float, bias_bh: int, dropout_p: float,
                 return_lse: bool, config: Tuple,
                 head_map=None):
        self.bh, self.s, self.hd, self.dtype = bh, s, hd, dtype
        self.head_map = check_head_map(head_map, bh)
        self.causal = bool(causal)
        self.scale = float(scale)
        self.bias_bh = int(bias_bh)
        self.dropout_p = float(dropout_p)
        self.return_lse = bool(return_lse)
        # the bf16 kernel's tile (_fwd_tile); None, None for f32
        self.block_q, self.block_k = config
        self.path = flash_path(dtype, hd)
        self.thr = (_dropout_threshold(self.dropout_p)
                    if self.dropout_p > 0.0 else None)
        self.inv_keep = (1.0 / (1.0 - self.dropout_p)
                         if self.dropout_p > 0.0 else 1.0)
        self.name = (f"flash_fwd_{bh}x{s}x{hd}_{str(dtype).split('.')[-1]}"
                     f"_{self.path}"
                     + (f"_bk{self.block_k}" if self.block_k else ""))

    def _operands(self, q, kT, v, bias):
        bh, s, hd = self.bh, self.s, self.hd
        _check("q", q, (bh, s, hd), self.dtype)
        _check("kT", kT, (bh, hd, s), self.dtype)
        _check("v", v, (bh, s, hd), self.dtype)
        if self.bias_bh == 0:
            if bias is not None:
                raise ValueError("bias passed to a flash kernel built "
                                 "without bias_bh")
            return None
        if bias is None:
            raise ValueError("this flash kernel was built with a bias "
                             "operand; pass bias")
        _check("bias", bias, (self.bias_bh, s, s))
        return bias

    def __call__(self, seed, q, kT, v, bias=None):
        bias = self._operands(q, kT, v, bias)
        if not _on_cuda(q, kT, v, bias):
            return self.plain(seed, q, kT, v, bias)
        bh, s, hd = self.bh, self.s, self.hd
        # every kernel reads 16-byte units (cp.async, TMA): an operand off
        # that alignment is copied first (the wgmma kernel reads the bias
        # in pairs)
        q, kT, v = (_aligned16(t) for t in (q, kT, v))
        if bias is not None:
            bias = _aligned16(bias.to(torch.float32))
        out = torch.empty((bh, s, hd), dtype=self.dtype, device=q.device)
        lse = (torch.empty((bh, s, 128), dtype=torch.float32,
                           device=q.device) if self.return_lse else None)
        lib = _kernels()
        with torch.cuda.device(q.device):
            err = lib.xsmm_flash_fwd(
                _ptr(q), _ptr(kT), _ptr(v), _ptr(bias),
                0 if self.bias_bh == 1 else s * s, _ptr(out), _ptr(lse),
                bh, s, hd, _TYPE_CODE[self.dtype], self.scale, int(self.causal), int(self.thr is not None),
                int(seed) & _M32 if self.thr is not None else 0,
                self.thr or 0, self.inv_keep, *self.head_map,
                _stream(q.device))
        _raise_on_error(err, self.name, lib)
        launches["flash_attention_fwd"] += 1
        path_launches["flash_attention_fwd"][self.path] += 1
        return (out, lse) if self.return_lse else out

    def plain(self, seed, q, kT, v, bias=None):
        """The same function in torch ops: the reference kernel with one K
        block spanning the row (its schedule whenever bk == s): scores in
        f32, the row max m, l = sum of the undropped exponentials, the
        dropped and rescaled exponentials rounded to the input type before
        the product with v, out = acc / l cast once, lse = m + log(l)."""
        bh, s = self.bh, self.s
        scores = torch.matmul(q.float(), kT.float()) * self.scale
        if bias is not None:
            scores = scores + bias.float()
        row = torch.arange(s, device=q.device)[:, None]
        col = torch.arange(s, device=q.device)[None, :]
        if self.causal:
            scores = torch.where(col <= row, scores,
                                 torch.full((), _NEG, device=q.device))
        m = scores.amax(dim=-1, keepdim=True)
        e = torch.exp(scores - m)
        l = e.sum(dim=-1, keepdim=True)
        if self.thr is not None:
            b = head_index(bh, self.head_map, q.device)
            keep = _rand_bits(int(seed), b, row, col) >= self.thr
            e = torch.where(keep, e * self.inv_keep,
                            torch.zeros((), device=q.device))
        acc = torch.matmul(e.to(self.dtype).float(), v.float())
        out = (acc / l).to(self.dtype)
        if not self.return_lse:
            return out
        lse = (m + torch.log(l)).expand(bh, s, 128).contiguous()
        return out, lse


def build_flash_attention(bh: int, s: int, hd: int, dtype: torch.dtype,
                          causal: bool = False,
                          scale: Optional[float] = None,
                          bias_bh: int = 0,
                          dropout_p: float = 0.0,
                          return_lse: bool = False,
                          block_override=None,
                          head_map=None) -> FlashAttention:
    """Forward kernel factory (attention_pallas.py:159).

    Returns fn(seed, q, kT, v[, bias]) -> out or (out, lse) for
    q/v: (bh, s, hd), kT: (bh, hd, s), bias: (bias_bh, s, s) with bias_bh
    in {0 (none), 1 (broadcast), bh}; lse is (bh, s, 128) f32, the row's
    log-sum-exp in every column. seed is an int (read only when
    dropout_p > 0). block_override=(bq, bk), the reference's TPU tile,
    must tile s; the kernels take one tile per hd bucket whatever the
    override (_fwd_tile). head_map=(b0, h0, nh_local, nh_global): the
    dropout hash reads each local batch-head's global index
    (check_head_map); None hashes the local index, as before. The dtype
    picks the kernel (flash_path)."""
    if not supported(s, hd, dtype):
        raise ValueError(f"unsupported flash shape s={s} hd={hd} {dtype}")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    sc = float(scale) if scale is not None else float(hd) ** -0.5
    _check_override(s, block_override)
    return FlashAttention(bh, s, hd, dtype, causal, sc, bias_bh, dropout_p,
                          return_lse, _fwd_tile(dtype, hd), head_map)


# ---------------------------------------------------------------------------
# the backward kernels
# ---------------------------------------------------------------------------

class FlashAttentionBwd:
    """fn(seed, q, kT, v, dout, lse, delta[, bias]) -> (dq, dkT, dv) or, with
    bias_grad, (dq, dkT, dv, dbias), for q/v/dout: (bh, s, hd), kT:
    (bh, hd, s), lse/delta: (bh, s, 128) f32 lane-broadcast (the kernels read
    column 0), bias: (bias_bh, s, s); dbias is (bh, s, s) f32.

    `dkv` and `dq` run the two kernels one at a time (each with its plain
    version, `dkv_plain` and `dq_plain`); calling the object runs both.
    The bf16 kernels each have their own tile: (`block_q`, `block_k`)
    (dK/dV) and (`block_q_dq`, `block_k_dq`) (None for f32: one tile per
    hd bucket); `path` names the route both kernels take
    (flash_bwd_path), `kernels` the CUDA kernel of each (bwd_kernel)."""

    def __init__(self, bh: int, s: int, hd: int, dtype: torch.dtype,
                 causal: bool, scale: float, bias_bh: int, dropout_p: float,
                 bias_grad: bool, config: Tuple, config_dq: Tuple,
                 head_map=None):
        self.bh, self.s, self.hd, self.dtype = bh, s, hd, dtype
        self.head_map = check_head_map(head_map, bh)
        self.causal = bool(causal)
        self.scale = float(scale)
        self.bias_bh = int(bias_bh)
        self.dropout_p = float(dropout_p)
        self.bias_grad = bool(bias_grad)
        self.block_q, self.block_k = config
        self.block_q_dq, self.block_k_dq = config_dq
        self.path = flash_bwd_path(dtype, hd)
        # the CUDA kernel of each part (bwd_kernel)
        self.kernels = {p: bwd_kernel(p, dtype, hd) for p in ("dkv", "dq")}
        self.thr = (_dropout_threshold(self.dropout_p)
                    if self.dropout_p > 0.0 else None)
        self.inv_keep = (1.0 / (1.0 - self.dropout_p)
                         if self.dropout_p > 0.0 else 1.0)
        self.name = (f"flash_bwd_{bh}x{s}x{hd}_{str(dtype).split('.')[-1]}"
                     f"_{self.path}"
                     + (f"_bk{self.block_k}_{self.block_k_dq}"
                        if self.block_k else ""))

    def _operands(self, q, kT, v, dout, lse, delta, bias):
        bh, s, hd = self.bh, self.s, self.hd
        _check("q", q, (bh, s, hd), self.dtype)
        _check("kT", kT, (bh, hd, s), self.dtype)
        _check("v", v, (bh, s, hd), self.dtype)
        _check("dout", dout, (bh, s, hd), self.dtype)
        _check("lse", lse, (bh, s, 128), torch.float32)
        _check("delta", delta, (bh, s, 128), torch.float32)
        if self.bias_bh == 0:
            if bias is not None:
                raise ValueError("bias passed to a flash backward built "
                                 "without bias_bh")
            return None
        if bias is None:
            raise ValueError("this flash backward was built with a bias "
                             "operand; pass bias")
        _check("bias", bias, (self.bias_bh, s, s))
        return bias

    def _launch(self, which, seed, q, kT, v, dout, lse, delta, bias):
        """Launch one kernel on CUDA operands; returns its outputs."""
        bh, s, hd = self.bh, self.s, self.hd
        # every route reads 16-byte units (cp.async, TMA): an operand off
        # that alignment is copied first
        q, kT, v, dout = (_aligned16(t) for t in (q, kT, v, dout))
        # one column of each lane-broadcast statistic: (bh, s) f32
        lse, delta = _aligned16(lse[..., 0]), _aligned16(delta[..., 0])
        if bias is not None:
            bias = bias.to(torch.float32).contiguous()
        head = (_ptr(q), _ptr(kT), _ptr(v), _ptr(dout), _ptr(lse),
                _ptr(delta), _ptr(bias), 0 if self.bias_bh == 1 else s * s)
        tail = (bh, s, hd, _TYPE_CODE[self.dtype], self.scale,
                int(self.causal), int(self.thr is not None),
                int(seed) & _M32 if self.thr is not None else 0,
                self.thr or 0, self.inv_keep, *self.head_map,
                _stream(q.device))
        lib = _bwd_kernels()
        if which == "dkv":
            dkT, dv = torch.empty_like(kT), torch.empty_like(v)
            dbias = (torch.empty((bh, s, s), dtype=torch.float32,
                                 device=q.device) if self.bias_grad else None)
            with torch.cuda.device(q.device):
                err = lib.xsmm_flash_bwd_dkv(*head, _ptr(dkT), _ptr(dv),
                                             _ptr(dbias), *tail)
            _raise_on_error(err, f"{self.name} dkv", lib)
            launches["flash_attention_bwd_dkv"] += 1
            path_launches["flash_attention_bwd_dkv"][self.path] += 1
            kernel_launches[self.kernels["dkv"]] += 1
            return (dkT, dv, dbias) if self.bias_grad else (dkT, dv)
        dq = torch.empty_like(q)
        with torch.cuda.device(q.device):
            err = lib.xsmm_flash_bwd_dq(*head, _ptr(dq), *tail)
        _raise_on_error(err, f"{self.name} dq", lib)
        launches["flash_attention_bwd_dq"] += 1
        path_launches["flash_attention_bwd_dq"][self.path] += 1
        kernel_launches[self.kernels["dq"]] += 1
        return dq

    def dkv(self, seed, q, kT, v, dout, lse, delta, bias=None):
        """(dkT, dv[, dbias]): the dK/dV kernel on CUDA operands, dkv_plain
        on CPU operands."""
        bias = self._operands(q, kT, v, dout, lse, delta, bias)
        if not _on_cuda(q, kT, v, dout, lse, delta, bias):
            return self.dkv_plain(seed, q, kT, v, dout, lse, delta, bias)
        return self._launch("dkv", seed, q, kT, v, dout, lse, delta, bias)

    def dq(self, seed, q, kT, v, dout, lse, delta, bias=None):
        """dq: the dQ kernel on CUDA operands, dq_plain on CPU operands."""
        bias = self._operands(q, kT, v, dout, lse, delta, bias)
        if not _on_cuda(q, kT, v, dout, lse, delta, bias):
            return self.dq_plain(seed, q, kT, v, dout, lse, delta, bias)
        return self._launch("dq", seed, q, kT, v, dout, lse, delta, bias)

    def __call__(self, seed, q, kT, v, dout, lse, delta, bias=None):
        dkv = self.dkv(seed, q, kT, v, dout, lse, delta, bias)
        return (self.dq(seed, q, kT, v, dout, lse, delta, bias),) + dkv

    # -- the plain torch version ------------------------------------------

    def _recompute(self, seed, q, kT, v, dout, lse, delta, bias):
        """The reference's shared block math (attention_pallas.py:356-384)
        over whole rows: p from the LSE (undropped), dP = dO V^T, the
        replayed position-hash mask; returns (p~, dS) in f32."""
        bh, s = self.bh, self.s
        dev = q.device
        scores = torch.matmul(q.float(), kT.float()) * self.scale
        if bias is not None:
            scores = scores + bias.float()
        row = torch.arange(s, device=dev)[:, None]
        col = torch.arange(s, device=dev)[None, :]
        if self.causal:
            scores = torch.where(col <= row, scores,
                                 torch.full((), _NEG, device=dev))
        p = torch.exp(scores - lse[..., :1])
        dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
        if self.thr is not None:
            b = head_index(bh, self.head_map, dev)
            keep = _rand_bits(int(seed), b, row, col) >= self.thr
            zero = torch.zeros((), device=dev)
            p_drop = torch.where(keep, p * self.inv_keep, zero)
            dp = torch.where(keep, dp * self.inv_keep, zero)
        else:
            p_drop = p
        return p_drop, p * (dp - delta[..., :1])

    def _rounded(self, x):
        """x rounded to the input type and widened back (astype(dtype))."""
        return x.to(self.dtype).float()

    def dkv_plain(self, seed, q, kT, v, dout, lse, delta, bias=None):
        """dV = p~^T dO and dK^T = Q^T dS, with p~ and dS rounded to the
        input type before the products, dK^T scaled once, one cast each;
        dbias = dS in f32."""
        p_drop, ds = self._recompute(seed, q, kT, v, dout, lse, delta, bias)
        dv = torch.matmul(self._rounded(p_drop).transpose(-1, -2),
                          dout.float())
        dkT = torch.matmul(q.float().transpose(-1, -2), self._rounded(ds))
        outs = ((dkT * self.scale).to(self.dtype), dv.to(self.dtype))
        return outs + (ds,) if self.bias_grad else outs

    def dq_plain(self, seed, q, kT, v, dout, lse, delta, bias=None):
        """dQ = dS K, with dS rounded to the input type, scaled once, one
        cast."""
        _, ds = self._recompute(seed, q, kT, v, dout, lse, delta, bias)
        dq = torch.matmul(self._rounded(ds), kT.float().transpose(-1, -2))
        return (dq * self.scale).to(self.dtype)

    def plain(self, seed, q, kT, v, dout, lse, delta, bias=None):
        return ((self.dq_plain(seed, q, kT, v, dout, lse, delta, bias),)
                + self.dkv_plain(seed, q, kT, v, dout, lse, delta, bias))


def build_flash_attention_bwd(bh: int, s: int, hd: int, dtype: torch.dtype,
                              causal: bool = False,
                              scale: Optional[float] = None,
                              bias_bh: int = 0,
                              dropout_p: float = 0.0,
                              bias_grad: bool = False,
                              block_override=None,
                              head_map=None) -> FlashAttentionBwd:
    """Backward kernel factory (attention_pallas.py:322).

    Returns fn(seed, q, kT, v, dout, lse, delta[, bias]) -> (dq, dkT, dv) or,
    with bias_grad, (dq, dkT, dv, dbias): dq/dv like q/v, dkT like kT, dbias
    (bh, s, s) f32. lse and delta are the forward's (bh, s, 128) f32
    lane-broadcast layout; delta = rowsum(dout * out). bias_grad needs a
    per-(batch*head) bias (bias_bh == bh), as the reference's. The tiling is
    chosen independently of the forward's: the dropout mask depends only on
    global coordinates. block_override=(bq, bk), the reference's TPU tile,
    must tile s; the wgmma (bf16) and tma_fma (f32) kernels take one tile
    each whatever the override (bwd_configs). head_map as
    build_flash_attention's: the mask replayed is the one the forward with
    that map drew."""
    if not supported(s, hd, dtype):
        raise ValueError(f"unsupported flash shape s={s} hd={hd} {dtype}")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    if bias_grad and bias_bh != bh:
        raise ValueError("bias_grad requires a per-(batch*head) bias")
    sc = float(scale) if scale is not None else float(hd) ** -0.5
    _check_override(s, block_override)
    config, config_dq = (
        bwd_configs(hd, k, dtype)[0] if dtype == torch.bfloat16
        else (None, None) for k in ("dkv", "dq"))
    return FlashAttentionBwd(
        bh, s, hd, dtype, causal, sc, bias_bh, dropout_p, bias_grad,
        config, config_dq, head_map)
