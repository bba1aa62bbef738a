"""The port's native bridge (`libxsmm_torch.native`) against the JAX
package's (`libxsmm_tpu.native_bridge`), on the CPU: one log format, so a KV
log written by either package is read by the other; the same CRC32C; and
the port builds its own copy of the library without touching the tracked
native/libxsmm_native.so. Every comparison is exact.
"""

import hashlib
import pathlib

import pytest

from libxsmm_torch import native
from libxsmm_tpu import native_bridge

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRACKED = ROOT / "native" / "libxsmm_native.so"


def _digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


@pytest.fixture(scope="module")
def both_loaded():
    """Both libraries, the tracked .so's bytes checked around the port's
    build."""
    before = _digest(TRACKED) if TRACKED.exists() else None
    lib = native.load()
    if lib is None:
        pytest.skip("no C++ compiler: the native library cannot be built")
    assert (_digest(TRACKED) if TRACKED.exists() else None) == before
    if native_bridge.load() is None:
        pytest.skip("the JAX package's native library is unavailable")
    return lib


def test_port_builds_its_own_copy(both_loaded):
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD
    assert path.resolve() != TRACKED.resolve()
    assert path.name.startswith("xsmm_native-")


@pytest.mark.parametrize("data,seed", [(b"", 0), (b"hello world", 0),
                                       (b"hello world", 1),
                                       (bytes(range(256)) * 3, 7)])
def test_crc32_matches(both_loaded, data, seed):
    assert native.crc32(data, seed) == native_bridge.crc32(data, seed)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_kv_log_round_trip(both_loaded, tmp_path, writer):
    """Records appended by one package are read by the other; the later
    record of a key wins; a missing key reads None; an fsspmdm3 ratio
    history and a bcsc2 pick keep their bytes."""
    path = tmp_path / "tune.xkv"
    put_kv = (native_bridge.PersistentKv if writer == "reference"
              else native.PersistentKv)(path)
    get_kv = (native.PersistentKv if writer == "reference"
              else native_bridge.PersistentKv)(path)
    records = {b"fsspmdm3:16:8:12:0:f32:ab12": b"0.10000,2.00000,2.00000",
               b"bcsc2:1024:1024:1024:32:32:bf16:ff00": b"dense:65.700",
               b"empty": b"", b"binary\x00key": bytes(range(256))}
    for k, v in records.items():
        assert put_kv.put(k, b"stale")
        assert put_kv.put(k, v)
    for k, v in records.items():
        assert get_kv.get(k) == v
    assert get_kv.get(b"absent") is None
    assert get_kv.put(b"empty", b"x")       # the reader appends in turn
    assert put_kv.get(b"empty") == b"x"


def test_missing_log_reads_none(both_loaded, tmp_path):
    assert native.PersistentKv(tmp_path / "none.xkv").get(b"k") is None
