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
`launches` counts kernel launches, and only those.

The forward has two CUDA kernels: bf16 operands run on the tensor cores
(mma.sync, f32 accumulators, hd padded to a bucket of `_MMA_HDP`), f32
operands on the CUDA cores' f32 FMAs; `flash_path` names the one a dtype
takes, and each has its own tile configurations (`flash_configs`). The
backward kernels run f32 FMAs for both types.
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


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


_TYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BQ = 64                      # query rows per block (csrc BQ)
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
        lib.xsmm_flash_fwd.argtypes = [P, P, P, P, LL, P, P, I, I, I, I, I,
                                       F, I, I, U, U, F, P]
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
        tail = [I, I, I, I, I, F, I, I, U, U, F, P]
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

_MMA_HDP = (32, 64, 96, 128, 192, 256)   # csrc launch_mma_hd's buckets
_SMEM_MAX = 232448                        # a block's shared memory on sm_90


def flash_path(dtype: torch.dtype) -> str:
    """The forward kernel that serves `dtype` (csrc xsmm_flash_fwd): "mma",
    the bf16 tensor-core kernel, or "fma", the f32 kernel on the CUDA cores
    (f32 means f32: no TF32)."""
    return "mma" if dtype == torch.bfloat16 else "fma"


def _mma_hdp(hd: int) -> int:
    """hd padded with zeros to the tensor-core kernel's bucket."""
    return next(p for p in _MMA_HDP if hd <= p)


def _smem_bytes(hd: int, bk: int, dtype: torch.dtype = torch.float32) -> int:
    """Shared memory of one forward block (csrc launch_flash,
    mma_smem_bytes). f32: Q^T and P^T at a 64+4 row stride, the K^T and V
    tiles, in f32, hd padded to 64. bf16: Q and two K^T and V tiles each,
    in bf16, hd padded to its bucket, every row padded by 16 bytes."""
    if flash_path(dtype) == "mma":
        hdp = _mma_hdp(hd)
        return (_BQ * (hdp + 8) + 2 * hdp * (bk + 8)
                + 2 * bk * (hdp + 8)) * 2
    hdp = -(-hd // 64) * 64
    return (hdp * (_BQ + 4) + 2 * hdp * bk + bk * (_BQ + 4)) * 4


def flash_configs(hd: int, dtype: torch.dtype = torch.float32) -> list:
    """(rows, K columns) per block the CUDA kernel for `dtype` is built
    for; the first is the default for this head dim. f32: 64-column K tiles
    while two blocks still fit an SM's shared memory, else 32. bf16: 64
    columns up to hd = 128, where the f32 S fragments cost 32 registers a
    thread beside O's 64; past it O alone takes up to 128, so 32 columns."""
    wide = (_BQ, 64)
    narrow = (_BQ, 32)
    if flash_path(dtype) == "mma":
        order = [wide, narrow] if _mma_hdp(hd) <= 128 else [narrow, wide]
        return [c for c in order if _smem_bytes(hd, c[1], dtype) <= _SMEM_MAX]
    return [wide, narrow] if 2 * _smem_bytes(hd, 64) <= 228 * 1024 \
        else [narrow, wide]


def _bwd_smem_bytes(hd: int, bk: int, kernel: str = "dkv") -> int:
    """Shared memory of one backward block (csrc dkv_smem, dq_smem): Q, dO,
    K and V tiles at a row stride of hd + 4 (hd padded to 64), plus the
    dK/dV kernel's p~ and dS tiles or the dQ kernel's dS^T tile, in f32."""
    ld = -(-hd // 64) * 64 + 4
    tiles = 2 * _BQ * ld + 2 * bk * ld
    extra = 2 * _BQ * (bk + 4) if kernel == "dkv" else bk * (_BQ + 4)
    return (tiles + extra) * 4


def bwd_configs(hd: int, kernel: str = "dkv") -> list:
    """(rows, K columns) per block the backward kernel `kernel` ("dkv" or
    "dq") is built for, the default first. Both take 64-column K tiles where
    a block's shared memory holds them (hd <= 128) and 32 columns up to
    hd = 256. The dK/dV kernel prefers 64 wherever it fits: each Q tile it
    stages then serves twice the columns. The dQ kernel prefers 64 only
    while two blocks still fit an SM's shared memory, else 32 (at hd = 128
    the 32-column tile keeps two blocks per SM and runs faster)."""
    fits = [c for c in ((_BQ, 64), (_BQ, 32))
            if _bwd_smem_bytes(hd, c[1], kernel) <= 227 * 1024]
    if kernel == "dq" and len(fits) == 2 and \
            2 * _bwd_smem_bytes(hd, 64, "dq") > 228 * 1024:
        fits.reverse()
    return fits


def _pick_config(s: int, configs: list, block_override) -> Tuple[int, int]:
    if block_override is None:
        return configs[0]
    bq, bk = (int(x) for x in block_override)
    if bq <= 0 or bk <= 0 or s % bq or s % bk:
        raise ValueError(f"block_override {block_override} does not tile "
                         f"s={s}")
    # the TPU's (bq, bk) is an upper bound here: take the kernel's largest
    # tile within it
    for cbq, cbk in sorted(configs, key=lambda c: -c[1]):
        if cbq <= bq and cbk <= bk:
            return cbq, cbk
    raise ValueError(f"block_override {block_override} is smaller than "
                     f"every CUDA tile configuration {configs}")


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
        self.path = flash_path(dtype)
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
        q, kT, v = (_aligned16(t) for t in (q, kT, v))
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
                          return_lse,
                          _pick_config(s, flash_configs(hd, dtype),
                                       block_override))


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
    Each kernel has its own K-tile width: `block_k` (dK/dV) and
    `block_k_dq`."""

    def __init__(self, bh: int, s: int, hd: int, dtype: torch.dtype,
                 causal: bool, scale: float, bias_bh: int, dropout_p: float,
                 bias_grad: bool, config: Tuple[int, int],
                 config_dq: Tuple[int, int]):
        self.bh, self.s, self.hd, self.dtype = bh, s, hd, dtype
        self.causal = bool(causal)
        self.scale = float(scale)
        self.bias_bh = int(bias_bh)
        self.dropout_p = float(dropout_p)
        self.bias_grad = bool(bias_grad)
        self.block_q, self.block_k = config
        self.block_k_dq = config_dq[1]
        self.thr = (_dropout_threshold(self.dropout_p)
                    if self.dropout_p > 0.0 else None)
        self.inv_keep = (1.0 / (1.0 - self.dropout_p)
                         if self.dropout_p > 0.0 else 1.0)
        self.name = (f"flash_bwd_{bh}x{s}x{hd}_{str(dtype).split('.')[-1]}"
                     f"_bk{self.block_k}_{self.block_k_dq}")

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
        q, kT, v, dout = (t.contiguous() for t in (q, kT, v, dout))
        # one column of each lane-broadcast statistic: (bh, s) f32
        lse, delta = lse[..., 0].contiguous(), delta[..., 0].contiguous()
        if bias is not None:
            bias = bias.to(torch.float32).contiguous()
        head = (_ptr(q), _ptr(kT), _ptr(v), _ptr(dout), _ptr(lse),
                _ptr(delta), _ptr(bias), 0 if self.bias_bh == 1 else s * s)
        bk = self.block_k if which == "dkv" else self.block_k_dq
        tail = (bh, s, hd, _TYPE_CODE[self.dtype], bk, self.scale,
                int(self.causal), int(self.thr is not None),
                int(seed) & _M32 if self.thr is not None else 0,
                self.thr or 0, self.inv_keep, _stream(q.device))
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
            return (dkT, dv, dbias) if self.bias_grad else (dkT, dv)
        dq = torch.empty_like(q)
        with torch.cuda.device(q.device):
            err = lib.xsmm_flash_bwd_dq(*head, _ptr(dq), *tail)
        _raise_on_error(err, f"{self.name} dq", lib)
        launches["flash_attention_bwd_dq"] += 1
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
            b = torch.arange(bh, device=dev)[:, None, None]
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
                              block_override=None) -> FlashAttentionBwd:
    """Backward kernel factory (attention_pallas.py:322).

    Returns fn(seed, q, kT, v, dout, lse, delta[, bias]) -> (dq, dkT, dv) or,
    with bias_grad, (dq, dkT, dv, dbias): dq/dv like q/v, dkT like kT, dbias
    (bh, s, s) f32. lse and delta are the forward's (bh, s, 128) f32
    lane-broadcast layout; delta = rowsum(dout * out). bias_grad needs a
    per-(batch*head) bias (bias_bh == bh), as the reference's. The tiling is
    chosen independently of the forward's: the dropout mask depends only on
    global coordinates. block_override=(bq, bk), the reference's TPU tile,
    picks for each kernel the largest CUDA tile configuration within it
    (bwd_configs)."""
    if not supported(s, hd, dtype):
        raise ValueError(f"unsupported flash shape s={s} hd={hd} {dtype}")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    if bias_grad and bias_bh != bh:
        raise ValueError("bias_grad requires a per-(batch*head) bias")
    sc = float(scale) if scale is not None else float(hd) ** -0.5
    return FlashAttentionBwd(
        bh, s, hd, dtype, causal, sc, bias_bh, dropout_p, bias_grad,
        _pick_config(s, bwd_configs(hd, "dkv"), block_override),
        _pick_config(s, bwd_configs(hd, "dq"), block_override))
