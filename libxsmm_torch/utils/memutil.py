"""Host-side memory/string utilities.

The port's own copy of `libxsmm_tpu/utils/memutil.py`, the reference's L0
memory services (include/libxsmm_memory.h, src/libxsmm_memory.c): buffer
diff/search, CRC32C-based hashing (the polynomial of the registry key hash:
the native C++ library's crc32 when it is built, `libxsmm_torch/native.py`,
table-driven Python otherwise, both giving the same values),
case-insensitive string search/scoring, and aligned host-buffer allocation.

On the GPU the device allocator is PyTorch's; what remains useful on the
host is ALIGNED staging buffers (torch.from_numpy shares them without a
copy, and pinned or DMA-friendly staging wants >= 64-byte alignment) and
the alignment introspection helper.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .. import native

LIBXSMM_ALIGNMENT = 64  # reference default malloc alignment


# ---------------------------------------------------------------------------
# CRC32C hashing (reference: src/libxsmm_memory.c:497-549, libxsmm_hash.c)
# ---------------------------------------------------------------------------

_CRC32C_POLY = 0x82F63B78  # reflected Castagnoli, matches SSE4.2 crc32
_crc_table = None


def _table():
    global _crc_table
    if _crc_table is None:
        tab = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ (_CRC32C_POLY if c & 1 else 0)
            tab.append(c)
        _crc_table = tab
    return _crc_table


def _crc32c_py(data: bytes, seed: int = 0) -> int:
    # Canonical convention (~seed in, ~crc out), matching the native
    # implementation (native/xsmm_native.cpp:42-49) and the check value
    # crc32c("123456789", 0) == 0xE3069283.
    crc = ~seed & 0xFFFFFFFF
    tab = _table()
    for b in data:
        crc = (crc >> 8) ^ tab[(crc ^ b) & 0xFF]
    return ~crc & 0xFFFFFFFF


def _crc32c_raw(data: bytes, seed: int) -> int:
    """RAW CRC32C (seed in, crc out, NO pre/post complement) — the exact
    convention of the reference's SSE4.2 crc32 instruction path
    (src/libxsmm_hash.c:284-299: LIBXSMM_HASH over the raw table update).
    Derived from the canonical (~seed in, ~crc out) primitive via
    raw(seed, d) == ~canonical(~seed, d)."""
    inv = (~seed) & 0xFFFFFFFF
    got = native.crc32(data, inv)
    c = _crc32c_py(data, inv) if got is None else got
    return (~c) & 0xFFFFFFFF


def hash(data, size: Optional[int] = None, seed: int = 0) -> int:  # noqa: A001
    """libxsmm_hash (src/libxsmm_memory.c:497): CRC32C of the buffer,
    value-identical to the reference (raw crc32 convention — the SSE4.2
    instruction applies no pre/post complement, so neither does
    libxsmm_crc32; persisted keys and cross-implementation comparisons
    depend on matching bytes). Accepts bytes/bytearray/np arrays; None
    hashes as empty."""
    if data is None:
        data = b""
    if isinstance(data, np.ndarray):
        data = data.tobytes()
    elif not isinstance(data, (bytes, bytearray)):
        data = bytes(data)
    if size is not None:
        data = data[:size]
    return _crc32c_raw(bytes(data), seed)


def hash16(data: int) -> int:
    """libxsmm_hash16 (src/libxsmm_memory.c:511): CRC32C of the low 16 bits
    seeded with the high 16, folded to 16 bits."""
    data = int(data) & 0xFFFFFFFF
    lo = (data & 0xFFFF).to_bytes(2, "little")
    return hash(lo, seed=data >> 16) & 0xFFFF


def hash8(data: int) -> int:
    """libxsmm_hash8 (src/libxsmm_memory.c:504): hash16 folded through a
    1-byte CRC seeded with data>>8."""
    data = int(data) & 0xFFFFFFFF
    h = hash16(data) & 0xFF
    return hash(bytes([h]), seed=data >> 8) & 0xFF


def hash32(data: int) -> int:
    """libxsmm_hash32 (src/libxsmm_memory.c:518): CRC32C of the low 32 bits
    seeded with the high 32."""
    data = int(data) & 0xFFFFFFFFFFFFFFFF
    lo = (data & 0xFFFFFFFF).to_bytes(4, "little")
    return hash(lo, seed=data >> 32)


def hash_string(string: Optional[str]) -> int:
    """libxsmm_hash_string (src/libxsmm_memory.c:525-547): strings up to
    8 bytes reinterpret directly as the 64-bit value (little-endian,
    zero-padded); longer strings fold two CRC32C halves."""
    if not string:
        return 0
    raw = string.encode() if isinstance(string, str) else bytes(string)
    n = len(raw)
    if n <= 8:
        return int.from_bytes(raw.ljust(8, b"\0"), "little")
    half = max(n // 2, 8)
    seed32 = hash(raw[:half], seed=0)
    hash32_ = hash(raw[half:], seed=seed32)
    return (hash32_ << 32) | seed32


# ---------------------------------------------------------------------------
# Buffer compare/search (reference: src/libxsmm_memory.c:382-460)
# ---------------------------------------------------------------------------

def _as_bytes(buf) -> bytes:
    if buf is None:
        return b""
    if isinstance(buf, np.ndarray):
        return buf.tobytes()
    if isinstance(buf, (bytes, bytearray)):
        return bytes(buf)
    return bytes(buf)


def memcmp(a, b, size: Optional[int] = None) -> int:
    """libxsmm_memcmp: conceptually-boolean compare (0 == equal)."""
    ab, bb = _as_bytes(a), _as_bytes(b)
    if size is not None:
        ab, bb = ab[:size], bb[:size]
    return 0 if ab == bb else 1


def diff(a, b, size: Optional[int] = None) -> int:
    """libxsmm_diff (src/libxsmm_memory.c:382): non-zero iff buffers differ."""
    return memcmp(a, b, size)


def diff_n(a, bn, elemsize: int, stride: int, hint: int, count: int) -> int:
    """libxsmm_diff_n (src/libxsmm_memory.c:413): search the strided array
    `bn` (count elements of elemsize bytes, stride bytes apart) for an
    element equal to `a`, starting at index `hint` and wrapping; returns the
    matching index or `count` when there is no match."""
    ab = _as_bytes(a)[:elemsize]
    raw = _as_bytes(bn)
    hint = hint % count if count else 0
    for step in range(count):
        i = (hint + step) % count
        if raw[i * stride:i * stride + elemsize] == ab:
            return i
    return count


# ---------------------------------------------------------------------------
# Case-insensitive string search / scoring (src/libxsmm_memory.c:550-622)
# ---------------------------------------------------------------------------

def stristrn(a: Optional[str], b: Optional[str],
             maxlen: int) -> Optional[int]:
    """libxsmm_stristrn: index of the first case-insensitive match of (up to
    maxlen chars of) `b` inside `a`, or None. The C API returns a pointer
    into `a`; the Python contract returns the index."""
    if not a or not b or maxlen == 0:
        return None
    needle = b[:maxlen].lower()
    idx = a.lower().find(needle)
    return idx if idx >= 0 else None


def stristr(a: Optional[str], b: Optional[str]) -> Optional[int]:
    """libxsmm_stristr (src/libxsmm_memory.c:579)."""
    return stristrn(a, b, len(b) if b else 0)


_DEFAULT_DELIMS = " \t;,:-"


def strimatch(a: Optional[str], b: Optional[str],
              delims: Optional[str] = None) -> int:
    """libxsmm_strimatch (src/libxsmm_memory.c:592-622): word-overlap score
    between A and B (case-insensitive), symmetric, capped by the word count
    of either side; -1 for NULL/empty inputs."""
    if not a or not b:
        return -1
    sep = delims if delims else _DEFAULT_DELIMS

    def words(s):
        out, cur = [], []
        for ch in s:
            if ch in sep:
                if cur:
                    out.append("".join(cur).lower())
                    cur = []
            else:
                cur.append(ch)
        if cur:
            out.append("".join(cur).lower())
        return out

    wa, wb = words(a), words(b)
    if not wa or not wb:
        return 0
    aset = set(wa)
    result = sum(1 for w in wb if w in aset)
    return min(result, len(wa), len(wb))


# ---------------------------------------------------------------------------
# Aligned host buffers (reference: src/libxsmm_malloc.c host-side role)
# ---------------------------------------------------------------------------

def aligned(buf, inc: Optional[int] = None) -> Tuple[bool, int]:
    """libxsmm_aligned (include/libxsmm_memory.h:70-72): whether the
    buffer's address (and optionally address+inc) is LIBXSMM_ALIGNMENT-
    aligned; also returns the actual alignment in bytes."""
    if isinstance(buf, np.ndarray):
        addr = buf.ctypes.data
    else:
        addr = int(buf)
    align = addr & -addr if addr else LIBXSMM_ALIGNMENT
    if inc:
        a2 = (addr + inc) & -(addr + inc)
        align = min(align, a2)
    align = min(align, 4096)
    return align >= LIBXSMM_ALIGNMENT, int(align)


class _AlignedArray(np.ndarray):
    """ndarray subclass so the aligned view can carry its backing buffer
    (plain ndarrays reject attribute assignment)."""


def aligned_malloc(size: int, alignment: int = LIBXSMM_ALIGNMENT) -> np.ndarray:
    """libxsmm_aligned_malloc analogue: a uint8 host buffer whose data
    pointer is aligned (over-allocate + offset view); torch.from_numpy
    shares it without a copy."""
    if alignment & (alignment - 1):
        raise ValueError("alignment must be a power of two")
    raw = np.zeros(size + alignment, dtype=np.uint8)
    off = (-raw.ctypes.data) % alignment
    view = raw[off:off + size].view(_AlignedArray)
    view._xsmm_base = raw          # keep backing alive + findable
    view._xsmm_alignment = alignment
    return view


def free(buf) -> None:
    """libxsmm_free analogue: drops the backing reference (GC owns host
    memory; kept for API-shape parity)."""
    if hasattr(buf, "_xsmm_base"):
        del buf._xsmm_base


def realloc(buf: np.ndarray, size: int) -> np.ndarray:
    """libxsmm_realloc analogue: new aligned buffer, old prefix copied."""
    alignment = getattr(buf, "_xsmm_alignment", LIBXSMM_ALIGNMENT)
    out = aligned_malloc(size, alignment)
    n = min(size, buf.size)
    out[:n] = buf[:n]
    return out


def get_malloc_info(buf) -> dict:
    """libxsmm_get_malloc_info analogue (include/libxsmm_malloc.h): size and
    alignment of a buffer from this allocator (or any ndarray)."""
    arr = np.asarray(buf)
    ok, align = aligned(arr)
    return {"size": int(arr.nbytes), "alignment": align,
            "address": int(arr.ctypes.data)}


def offset(offsets, shape, ndims: Optional[int] = None):
    """libxsmm_offset (src/libxsmm_memory.c:67-81): linearize a multi-dim
    index against `shape` (first dimension fastest, dims beyond the first
    1-based as in the reference). Returns (linear_offset, total_size) — the
    C API writes total_size through a pointer."""
    if not shape or ndims == 0:
        return 0, 0
    n = ndims if ndims is not None else len(shape)
    result = offsets[0] if offsets else 0
    size1 = shape[0]
    for i in range(1, n):
        oi = offsets[i] if offsets and offsets[i] else 0
        result += (oi - 1 if oi else 0) * size1
        size1 *= shape[i]
    return int(result), int(size1)
