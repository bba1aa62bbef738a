"""ctypes bridge to the native host runtime (native/xsmm_native.cpp).

The port's own copy of `libxsmm_tpu/native_bridge.py`: `load`, `crc32`
(utils/memutil.py's hash), `read_mtx_coo` (utils/mtx.py's MatrixMarket
reader), `NativeRegistry`, the C++ descriptor registry (a CRC32-hashed,
open-addressed table with a canary per slot), and `PersistentKv`, the
append-only, CRC-checked key-value log in which the autotuners persist their
picks and aot.py its exported kernels. The log format is the C++ code's, so
a log written by either package is read by the other.

The library is built at first use from the tracked source with the flags of
`native/Makefile`,

    g++ -O2 -fPIC -std=c++17 -shared -pthread -o <lib> native/xsmm_native.cpp

into `libxsmm_torch/kernels/build/` (listed in .gitignore), named by a hash
of the source as kernels/_build.py names the CUDA libraries. The tracked
`native/libxsmm_native.so` is never rebuilt or written here. `load()`
returns None when the library cannot be built or loaded; callers treat that
as "no persistent store", as the reference's do. This is a host cache, not
part of any device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Optional

_REPO = pathlib.Path(__file__).resolve().parents[1]
SRC = _REPO / "native" / "xsmm_native.cpp"
BUILD = pathlib.Path(__file__).resolve().parent / "kernels" / "build"
FLAGS = ["-O2", "-fPIC", "-std=c++17", "-shared", "-pthread"]

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> pathlib.Path:
    """The library built from SRC, named by a hash of the source and the
    flags."""
    data = SRC.read_bytes() + " ".join(FLAGS).encode()
    return BUILD / f"xsmm_native-{hashlib.sha1(data).hexdigest()[:12]}.so"


def _build(out: pathlib.Path) -> bool:
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)     # atomic publish: never load a partial .so
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def load() -> Optional[ctypes.CDLL]:
    """The native library (built on first use); None when unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not SRC.exists():
            return None
        out = library_path()
        if not out.exists() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            return None
        P, U64 = ctypes.c_void_p, ctypes.c_uint64
        lib.xsmm_crc32.restype = ctypes.c_uint32
        lib.xsmm_crc32.argtypes = [P, U64, ctypes.c_uint32]
        U64P = ctypes.POINTER(U64)
        lib.xsmm_registry_create.restype = P
        lib.xsmm_registry_create.argtypes = []
        lib.xsmm_registry_destroy.restype = None
        lib.xsmm_registry_destroy.argtypes = [P]
        lib.xsmm_registry_insert.restype = ctypes.c_int
        lib.xsmm_registry_insert.argtypes = [P, P, U64, U64]
        lib.xsmm_registry_find.restype = ctypes.c_int
        lib.xsmm_registry_find.argtypes = [P, P, U64, U64P]
        lib.xsmm_registry_stats.restype = None
        lib.xsmm_registry_stats.argtypes = [P] + [U64P] * 4
        lib.xsmm_registry_verify.restype = U64
        lib.xsmm_registry_verify.argtypes = [P]
        lib.xsmm_registry_ncorrupt.restype = U64
        lib.xsmm_registry_ncorrupt.argtypes = [P]
        lib.xsmm_registry_poison.restype = ctypes.c_int
        lib.xsmm_registry_poison.argtypes = [P, P, U64]
        lib.xsmm_kv_append.restype = ctypes.c_int
        lib.xsmm_kv_append.argtypes = [ctypes.c_char_p, P, U64, P, U64]
        lib.xsmm_kv_lookup.restype = ctypes.c_int64
        lib.xsmm_kv_lookup.argtypes = [ctypes.c_char_p, P, U64, P, U64]
        I64P = ctypes.POINTER(ctypes.c_int64)
        lib.xsmm_mtx_open.restype = ctypes.c_int
        lib.xsmm_mtx_open.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_void_p),
                                      I64P, I64P, I64P]
        lib.xsmm_mtx_fill.restype = None
        lib.xsmm_mtx_fill.argtypes = [P, P, P, P]
        lib.xsmm_mtx_close.restype = None
        lib.xsmm_mtx_close.argtypes = [P]
        _lib = lib
        return _lib


def crc32(data: bytes, seed: int = 0) -> Optional[int]:
    """CRC32C of `data` (the native runtime's hash); None without the
    library."""
    lib = load()
    if lib is None:
        return None
    buf = ctypes.create_string_buffer(data, len(data))
    return int(lib.xsmm_crc32(ctypes.cast(buf, ctypes.c_void_p), len(data),
                              seed))


def read_mtx_coo(path):
    """Parse a MatrixMarket file with the native reader (the counterpart of
    the reference's generator_spgemm_{csr,csc}_reader.c). Returns
    (m, n, rows, cols, vals) COO arrays (0-based, symmetric/pattern storage
    expanded), or None when the library is unavailable or the format needs
    the Python reader (complex fields, malformed files); raises
    FileNotFoundError when the file cannot be read."""
    lib = load()
    if lib is None:
        return None
    import numpy as np

    handle = ctypes.c_void_p()
    m, n, nnz = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    rc = lib.xsmm_mtx_open(os.fsencode(str(path)), ctypes.byref(handle),
                           ctypes.byref(m), ctypes.byref(n),
                           ctypes.byref(nnz))
    if rc == -1:
        raise FileNotFoundError(path)
    if rc != 0:
        return None
    try:
        rows = np.empty(nnz.value, np.int32)
        cols = np.empty(nnz.value, np.int32)
        vals = np.empty(nnz.value, np.float64)
        if nnz.value:
            lib.xsmm_mtx_fill(handle, rows.ctypes.data, cols.ctypes.data,
                              vals.ctypes.data)
    finally:
        lib.xsmm_mtx_close(handle)
    return int(m.value), int(n.value), rows, cols, vals


class NativeRegistry:
    """Descriptor-blob -> uint64 handle table backed by the C++ registry:
    keys of 1-96 bytes, the first insert of a key wins."""

    def __init__(self):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._ptr = self._lib.xsmm_registry_create()

    def __del__(self):
        lib = getattr(self, "_lib", None)
        ptr = getattr(self, "_ptr", None)
        if lib is not None and ptr:
            lib.xsmm_registry_destroy(ptr)

    @staticmethod
    def _key(key: bytes):
        return ctypes.cast(ctypes.create_string_buffer(key, len(key)),
                           ctypes.c_void_p)

    def insert(self, key: bytes, value: int) -> int:
        """0 when inserted, 1 when the key was present (its value kept), -1
        for a key the table refuses (empty or over 96 bytes)."""
        return self._lib.xsmm_registry_insert(self._ptr, self._key(key),
                                              len(key), value)

    def find(self, key: bytes) -> Optional[int]:
        """The key's value, or None when it is absent or its slot fails its
        canary."""
        out = ctypes.c_uint64()
        hit = self._lib.xsmm_registry_find(self._ptr, self._key(key),
                                           len(key), ctypes.byref(out))
        return int(out.value) if hit else None

    def stats(self) -> dict:
        vals = [ctypes.c_uint64() for _ in range(4)]
        self._lib.xsmm_registry_stats(self._ptr,
                                      *[ctypes.byref(v) for v in vals])
        return {"nentries": vals[0].value, "nhits": vals[1].value,
                "ncollisions": vals[2].value, "capacity": vals[3].value,
                "ncorrupt": int(self._lib.xsmm_registry_ncorrupt(self._ptr))}

    def verify(self) -> int:
        """Full-table canary sweep: every published slot carries crc32c(key
        || value) written at publish, so a torn write or a stray store shows
        up here (and as a find() miss) instead of a wrong handle. Returns
        the number of corrupt slots."""
        return int(self._lib.xsmm_registry_verify(self._ptr))

    def _poison(self, key: bytes) -> bool:
        """For tests: damage key's stored value without refreshing its
        canary, so the detection path can be shown to work."""
        return bool(self._lib.xsmm_registry_poison(self._ptr, self._key(key),
                                                   len(key)))


class PersistentKv:
    """File-backed KV log (autotune decisions, exported kernels): put
    appends a record, get returns the value of the last record with the
    key."""

    def __init__(self, path):
        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self.path = os.fsencode(str(path))

    def put(self, key: bytes, value: bytes) -> bool:
        kbuf = ctypes.create_string_buffer(key, len(key))
        vbuf = ctypes.create_string_buffer(value, len(value))
        rc = self._lib.xsmm_kv_append(
            self.path, ctypes.cast(kbuf, ctypes.c_void_p), len(key),
            ctypes.cast(vbuf, ctypes.c_void_p), len(value))
        return rc == 0

    def get(self, key: bytes) -> Optional[bytes]:
        kbuf = ctypes.create_string_buffer(key, len(key))
        n = self._lib.xsmm_kv_lookup(
            self.path, ctypes.cast(kbuf, ctypes.c_void_p), len(key), None, 0)
        # the size probe and the fill are two scans of a log other processes
        # may append to between them (later record wins): retry until the
        # fill sees the same length, so a grown record is never truncated
        for _ in range(4):
            if n < 0:
                return None
            out = ctypes.create_string_buffer(int(n))
            got = self._lib.xsmm_kv_lookup(
                self.path, ctypes.cast(kbuf, ctypes.c_void_p), len(key),
                ctypes.cast(out, ctypes.c_void_p), int(n))
            if got == n:
                return out.raw
            n = got
        return None
