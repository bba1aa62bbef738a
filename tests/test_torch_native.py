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


# ---------------------------------------------------------------------------
# the registry bindings (tests/test_native.py's five registry tests): the
# same key sets through both packages' NativeRegistry, with equal insert
# codes, find results and stats
# ---------------------------------------------------------------------------

def _both_registries():
    return native.NativeRegistry(), native_bridge.NativeRegistry()


def _same(fn):
    """fn(registry) run on the port's and the JAX package's registries."""
    port, ref = _both_registries()
    got, want = fn(port), fn(ref)
    assert got == want
    assert port.stats() == ref.stats()
    return got


def test_registry_insert_find(both_loaded):
    def run(reg):
        return [reg.find(b"key"), reg.insert(b"key", 42), reg.find(b"key"),
                reg.insert(b"key", 99), reg.find(b"key"), reg.stats()]
    out = _same(run)
    assert out[:5] == [None, 0, 42, 1, 42]
    assert out[5]["nentries"] == 1 and out[5]["capacity"] == 131072


def test_registry_many_keys(both_loaded):
    import numpy as np
    rng = np.random.default_rng(3)
    keys = [rng.bytes(48) for _ in range(5000)]

    def run(reg):
        codes = [reg.insert(k, i) for i, k in enumerate(keys)]
        return codes, [reg.find(k) for k in keys], reg.stats()["nentries"]
    codes, found, n = _same(run)
    assert codes == [0] * 5000 and found == list(range(5000)) and n == 5000


def test_registry_threaded(both_loaded):
    import concurrent.futures
    keys = [f"desc-{i % 64}".encode() for i in range(2048)]

    def run(reg):
        def work(k):
            reg.insert(k, hash(k) & 0xFFFFFFFF)
            return reg.find(k)
        with concurrent.futures.ThreadPoolExecutor(max_workers=16) as ex:
            return list(ex.map(work, keys))
    port, ref = _both_registries()
    got, want = run(port), run(ref)
    assert got == want == [hash(k) & 0xFFFFFFFF for k in keys]
    # hits and collisions depend on the threads' interleaving
    for key in ("nentries", "capacity", "ncorrupt"):
        assert port.stats()[key] == ref.stats()[key]
    assert port.stats()["nentries"] == 64


def test_registry_key_limits(both_loaded):
    def run(reg):
        return [reg.insert(b"", 1), reg.insert(b"x" * 96, 7),
                reg.insert(b"x" * 97, 7)]
    assert _same(run) == [-1, 0, -1]


def test_registry_canary_detects_damage(both_loaded):
    def run(reg):
        codes = [reg.insert(f"desc-{i}".encode(), 1000 + i)
                 for i in range(32)]
        return [codes, reg.verify(), reg.stats()["ncorrupt"],
                reg._poison(b"desc-7"), reg.verify(), reg.find(b"desc-7"),
                reg.find(b"desc-8"), reg.stats()["ncorrupt"]]
    out = _same(run)
    assert out[:7] == [[0] * 32, 0, 0, True, 1, None, 1008]
    assert out[7] >= 2
