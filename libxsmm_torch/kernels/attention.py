"""Flash-attention forward — the wrapper around the hand-written CUDA kernel
of csrc/attention_kernels.cu, with its plain torch version.

The port of the forward half of `libxsmm_tpu/kernels/attention_pallas.py`:
the support predicate, the position-hash dropout helpers and
`build_flash_attention`. The backward kernels (`build_flash_attention_bwd`)
are not ported yet (ROADMAP.md queue 2, item 8).

`build_flash_attention(...)` returns a FlashAttention object; calling it
with `(seed, q, kT, v[, bias])` checks the operands, then follows their
device: on CUDA tensors it launches the kernel on the current stream (a
build failure or a refused launch raises; there is no fallback), on CPU
tensors it runs `.plain`, the plain torch version of the same function,
which chip_smoke.py also holds the kernel against on the card. `launches`
counts kernel launches, and only those.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from .gemm import _check, _on_cuda, _ptr, _raise_on_error, _stream

_NEG = float(np.finfo(np.float32).min)
_M32 = 0xFFFFFFFF

# kernel launches since the last reset_launches(); the wrapper adds one where
# it launches its CUDA kernel, and nowhere else
launches = {"flash_attention_fwd": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


_TYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BQ = 64                      # query rows per block (csrc BQ)
_lib = None


def _kernels() -> ctypes.CDLL:
    """The CUDA library, built and loaded on first use."""
    global _lib
    if _lib is None:
        from . import _build
        lib = _build.load("attention_kernels")
        P, I, LL, F, U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float, ctypes.c_uint)
        lib.xsmm_flash_fwd.argtypes = [P, P, P, P, LL, P, P, I, I, I, I, I,
                                       F, I, I, U, U, F, P]
        lib.xsmm_flash_fwd.restype = I
        lib.xsmm_error_string.argtypes = [I]
        lib.xsmm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


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

def _smem_bytes(hd: int, bk: int) -> int:
    """Shared memory of one block (csrc launch_flash): Q^T and P^T at a
    64+4 row stride, the K^T and V tiles, in f32, hd padded to 64."""
    hdp = -(-hd // 64) * 64
    return (hdp * (_BQ + 4) + 2 * hdp * bk + bk * (_BQ + 4)) * 4


def flash_configs(hd: int) -> list:
    """(rows, K columns) per block the CUDA kernel is built for; the first
    is the default for this head dim: 64-column K tiles while two blocks
    still fit an SM's shared memory, else 32."""
    wide = (_BQ, 64)
    narrow = (_BQ, 32)
    return [wide, narrow] if 2 * _smem_bytes(hd, 64) <= 228 * 1024 \
        else [narrow, wide]


def _pick_config(s: int, hd: int, block_override) -> Tuple[int, int]:
    if block_override is None:
        return flash_configs(hd)[0]
    bq, bk = (int(x) for x in block_override)
    if bq <= 0 or bk <= 0 or s % bq or s % bk:
        raise ValueError(f"block_override {block_override} does not tile "
                         f"s={s}")
    # the TPU's (bq, bk) is an upper bound here: take the kernel's largest
    # tile within it
    for cbq, cbk in sorted(flash_configs(hd), key=lambda c: -c[1]):
        if cbq <= bq and cbk <= bk:
            return cbq, cbk
    raise ValueError(f"block_override {block_override} is smaller than "
                     f"every CUDA tile configuration {flash_configs(hd)}")


# ---------------------------------------------------------------------------
# the forward kernel
# ---------------------------------------------------------------------------

class FlashAttention:
    """fn(seed, q, kT, v[, bias]) -> out, or (out, lse) with return_lse, for
    q/v: (bh, s, hd), kT: (bh, hd, s), bias: (bias_bh, s, s)."""

    def __init__(self, bh: int, s: int, hd: int, dtype: torch.dtype,
                 causal: bool, scale: float, bias_bh: int, dropout_p: float,
                 return_lse: bool, config: Tuple[int, int]):
        self.bh, self.s, self.hd, self.dtype = bh, s, hd, dtype
        self.causal = bool(causal)
        self.scale = float(scale)
        self.bias_bh = int(bias_bh)
        self.dropout_p = float(dropout_p)
        self.return_lse = bool(return_lse)
        self.block_q, self.block_k = config
        self.thr = (_dropout_threshold(self.dropout_p)
                    if self.dropout_p > 0.0 else None)
        self.inv_keep = (1.0 / (1.0 - self.dropout_p)
                         if self.dropout_p > 0.0 else 1.0)
        self.name = (f"flash_fwd_{bh}x{s}x{hd}_{str(dtype).split('.')[-1]}"
                     f"_bk{self.block_k}")

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
        q, kT, v = q.contiguous(), kT.contiguous(), v.contiguous()
        if bias is not None:
            bias = bias.to(torch.float32).contiguous()
        out = torch.empty((bh, s, hd), dtype=self.dtype, device=q.device)
        lse = (torch.empty((bh, s, 128), dtype=torch.float32,
                           device=q.device) if self.return_lse else None)
        lib = _kernels()
        with torch.cuda.device(q.device):
            err = lib.xsmm_flash_fwd(
                _ptr(q), _ptr(kT), _ptr(v), _ptr(bias),
                0 if self.bias_bh == 1 else s * s, _ptr(out), _ptr(lse),
                bh, s, hd, _TYPE_CODE[self.dtype], self.block_k, self.scale,
                int(self.causal), int(self.thr is not None),
                int(seed) & _M32 if self.thr is not None else 0,
                self.thr or 0, self.inv_keep, _stream(q.device))
        _raise_on_error(err, self.name, lib)
        launches["flash_attention_fwd"] += 1
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
            b = torch.arange(bh, device=q.device)[:, None, None]
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
                          block_override=None) -> FlashAttention:
    """Forward kernel factory (attention_pallas.py:159).

    Returns fn(seed, q, kT, v[, bias]) -> out or (out, lse) for
    q/v: (bh, s, hd), kT: (bh, hd, s), bias: (bias_bh, s, s) with bias_bh
    in {0 (none), 1 (broadcast), bh}; lse is (bh, s, 128) f32, the row's
    log-sum-exp in every column. seed is an int (read only when
    dropout_p > 0). block_override=(bq, bk), the reference's TPU tile,
    picks the largest CUDA tile configuration within it (flash_configs)."""
    if not supported(s, hd, dtype):
        raise ValueError(f"unsupported flash shape s={s} hd={hd} {dtype}")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    sc = float(scale) if scale is not None else float(hd) ** -0.5
    return FlashAttention(bh, s, hd, dtype, causal, sc, bias_bh, dropout_p,
                          return_lse, _pick_config(s, hd, block_override))
