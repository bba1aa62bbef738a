"""The port's host utilities (`libxsmm_torch.utils.{mathx,memutil,sync,mtx}`
and the .mtx readers of `utils/testmats.py`) against the JAX package's
(`libxsmm_tpu.utils.*`), on the CPU. Every comparison is exact: these are
integer, byte and string functions, and the .mtx readers parse the same
text into float64.
"""

import threading

import numpy as np
import pytest

import libxsmm_torch
from libxsmm_torch import native
from libxsmm_torch.utils import mathx as PM
from libxsmm_torch.utils import memutil as PMU
from libxsmm_torch.utils import mtx as PX
from libxsmm_torch.utils import sync as PS
from libxsmm_torch.utils import testmats as PT
from libxsmm_tpu.utils import mathx as RM
from libxsmm_tpu.utils import memutil as RMU
from libxsmm_tpu.utils import mtx as RX

INTS = [0, 1, 2, 3, 7, 8, 12, 23, 64, 97, 255, 256, 1000, 4096, 65535,
        2 ** 31 - 1, 2 ** 32 - 1, 2 ** 40 + 3]


@pytest.mark.parametrize("name", ["gcd", "lcm"])
def test_mathx_pairs(name):
    for a in INTS[:14]:
        for b in INTS[:14]:
            assert getattr(PM, name)(a, b) == getattr(RM, name)(a, b)


@pytest.mark.parametrize("name", [
    "isqrt2", "icbrt2", "icbrt_u32", "icbrt_u64", "widen_u32i64",
    "widen_u32u64", "isqrt_u64", "isqrt_u32", "primes_u32", "isqrt2_u32",
    "coprime2"])
def test_mathx_unary_integers(name):
    for x in INTS:
        assert getattr(PM, name)(x) == getattr(RM, name)(x), x


def test_mathx_limits_and_remainders():
    for p in (1, 12, 64, 97, 360, 1024, 4096):
        for lim in (0, 1, 5, 16, 100, 5000):
            for lower in (False, True):
                assert (PM.product_limit(p, lim, lower)
                        == RM.product_limit(p, lim, lower))
        for co in (1, 3, 10, 50):
            assert PM.coprime(p, co) == RM.coprime(p, co)
    for a, b in ((23, 8), (1, 1), (100, 7), (64, 64), (5, 0)):
        assert PM.remainder(a, b) == RM.remainder(a, b)
        assert PM.remainder(a, b, 200, 1) == RM.remainder(a, b, 200, 1)
    assert PM.remainder(23, 8) == 184


def test_mathx_floats():
    xs = [-300.0, -5.0, -4.97, -1.0, -0.5, 0.0, 0.5, 1.5, 2.5, 4.97, 10.0]
    for x in xs:
        assert PM.stanh_pade78(x) == RM.stanh_pade78(x)
        assert PM.nearbyint(x) == RM.nearbyint(x)
        assert PM.nearbyintf(x) == RM.nearbyintf(x)
        assert PM.kahan_sum(x, 1.0, 1e-9) == RM.kahan_sum(x, 1.0, 1e-9)
        if x >= 0:
            assert PM.dsqrt(x) == RM.dsqrt(x) and PM.ssqrt(x) == RM.ssqrt(x)
    np.testing.assert_array_equal(PM.stanh_pade78(np.asarray(xs)),
                                  RM.stanh_pade78(np.asarray(xs)))
    for e in range(0, 256, 17):
        assert PM.sexp2_u8(e) == RM.sexp2_u8(e)
    for e in range(-128, 128, 13):
        assert PM.sexp2_i8(e) == RM.sexp2_i8(e) == PM.sexp2_i8i(e)
        assert PM.sexp2(e) == RM.sexp2(e)
    with pytest.raises(ValueError):
        PM.sexp2_u8(256)


def test_matdiff_log(tmp_path, monkeypatch):
    monkeypatch.delenv("XSMM_TPU_MATDIFF", raising=False)
    PM.matdiff_log(1e-3)                       # no path: nothing written
    log_p, log_r = tmp_path / "p.log", tmp_path / "r.log"
    for mod, log in ((PM, log_p), (RM, log_r)):
        mod.matdiff_log(1.25e-7, str(log), note="gemm")
        mod.matdiff_log(3.0, str(log))
    assert log_p.read_text() == log_r.read_text()
    assert log_p.read_text().split("\n")[1:] == ["3", ""]
    monkeypatch.setenv("XSMM_TPU_MATDIFF", str(tmp_path))
    PM.matdiff_log(0.5)
    assert (tmp_path / "libxsmm_matdiff.log").read_text() == "0.5\n"


HASH_DATA = [b"", b"1", b"123456789", bytes(range(256)) * 3,
             np.arange(37, dtype=np.float32)]


@pytest.mark.parametrize("path", ["native", "python"])
@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF])
def test_hash_matches_reference(path, seed, monkeypatch):
    if path == "native":
        if native.load() is None:
            pytest.skip("no C++ compiler: the native library cannot be "
                        "built")
    else:
        monkeypatch.setattr(native, "crc32", lambda data, seed=0: None)
    for data in HASH_DATA:
        assert PMU.hash(data, seed=seed) == RMU.hash(data, seed=seed)
    assert PMU.hash(b"123456789", 5) == RMU.hash(b"123456789", 5)
    for v in (0, 1, 0x1234, 0xDEADBEEF, 2 ** 63 + 5):
        assert PMU.hash8(v) == RMU.hash8(v)
        assert PMU.hash16(v) == RMU.hash16(v)
        assert PMU.hash32(v) == RMU.hash32(v)
    for s in (None, "", "abc", "12345678", "a longer key string"):
        assert PMU.hash_string(s) == RMU.hash_string(s)


def test_crc32c_check_value():
    assert PMU._crc32c_py(b"123456789", 0) == 0xE3069283
    assert libxsmm_torch.hash(b"123456789") == RMU.hash(b"123456789")


def test_memutil_compare_and_search():
    a = np.arange(16, dtype=np.int32)
    b = a.copy()
    b[5] = -1
    for mod in (PMU, RMU):
        assert mod.memcmp(a, a) == 0 and mod.diff(a, b) == 1
        assert mod.diff(a, b, 20) == 0
    strided = np.arange(40, dtype=np.int32).tobytes()
    for hint in (0, 3, 9):
        for key in (np.asarray([v], np.int32) for v in (12, 39, -3)):
            assert (PMU.diff_n(key, strided, 4, 8, hint, 10)
                    == RMU.diff_n(key, strided, 4, 8, hint, 10))
    for hay, needle, n in (("Hello World", "world", 5), ("abc", "", 3),
                           (None, "x", 1), ("ABCabc", "CA", 2)):
        assert PMU.stristrn(hay, needle, n) == RMU.stristrn(hay, needle, n)
        assert PMU.stristr(hay, needle) == RMU.stristr(hay, needle)
    for x, y in (("the quick fox", "Fox, the"), ("", "a"), ("a b c", "c")):
        assert PMU.strimatch(x, y) == RMU.strimatch(x, y)
    for offs, shape in (((1, 2, 3), (4, 5, 6)), ((0,), (7,)), (None, (2, 2))):
        assert PMU.offset(offs, shape) == RMU.offset(offs, shape)


@pytest.mark.parametrize("alignment", [16, 64, 4096])
def test_aligned_buffers(alignment):
    buf = PMU.aligned_malloc(1000, alignment)
    assert buf.size == 1000 and buf.ctypes.data % alignment == 0
    ok, align = PMU.aligned(buf)
    assert align >= alignment and ok == (align >= PMU.LIBXSMM_ALIGNMENT)
    assert PMU.aligned(buf) == RMU.aligned(buf)
    buf[:] = np.arange(1000) % 251
    grown = PMU.realloc(buf, 2000)
    assert grown.ctypes.data % alignment == 0
    np.testing.assert_array_equal(grown[:1000], buf)
    info = PMU.get_malloc_info(grown)
    assert info == RMU.get_malloc_info(grown)
    assert info["size"] == 2000 and info["alignment"] >= alignment
    PMU.free(grown)
    m = libxsmm_torch.malloc(100)
    assert m.ctypes.data % PMU.LIBXSMM_ALIGNMENT == 0
    with pytest.raises(ValueError):
        PMU.aligned_malloc(10, 48)


def test_sync_ids_and_barrier():
    assert PS.get_pid() == libxsmm_torch.get_pid()
    tids, lock = [], threading.Lock()
    nthreads, rounds = 6, 20
    bar = PS.barrier_create(3, 2)
    counter = [0]
    seen = []

    def work(t):
        PS.barrier_init(bar, t)
        tid = PS.get_tid()
        assert tid == PS.get_tid()
        with lock:
            tids.append(tid)
        for r in range(rounds):
            with lock:
                counter[0] += 1
            PS.barrier_wait(bar, t)
            with lock:          # every thread of the round has counted
                seen.append(counter[0] >= (r + 1) * nthreads)
            PS.barrier_wait(bar, t)

    threads = [threading.Thread(target=work, args=(t,))
               for t in range(nthreads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(set(tids)) == nthreads and all(seen)
    assert len(seen) == rounds * nthreads
    with pytest.raises(ValueError):
        PS.barrier_wait(bar, nthreads)
    PS.barrier_destroy(bar)
    with pytest.raises(ValueError):
        PS.Barrier(0)
    PS.stdio_acquire()
    PS.stdio_acquire()          # reentrant
    PS.stdio_release()
    PS.stdio_release()


MTX_TEXTS = {
    "general": ("%%MatrixMarket matrix coordinate real general\n"
                "% a comment\n3 4 5\n1 1 1.5\n2 3 -2\n3 4 4.25\n"
                "1 1 0.5\n3 1 7\n"),
    "symmetric": ("%%MatrixMarket matrix coordinate real symmetric\n"
                  "3 3 4\n1 1 2\n2 1 -1\n3 2 5\n3 3 1\n"),
    "skew": ("%%MatrixMarket matrix coordinate real skew-symmetric\n"
             "3 3 2\n2 1 3\n3 1 -4\n"),
    "pattern": ("%%MatrixMarket matrix coordinate pattern general\n"
                "2 3 3\n1 2\n2 1\n2 3\n"),
    "array": ("%%MatrixMarket matrix array real general\n"
              "2 3\n1\n2\n3\n4\n5\n6\n"),
}


@pytest.mark.parametrize("reader", ["native", "scipy", "python"])
@pytest.mark.parametrize("kind", sorted(MTX_TEXTS))
def test_read_mtx_matches_reference(reader, kind, tmp_path, monkeypatch):
    path = tmp_path / f"{kind}.mtx"
    path.write_text(MTX_TEXTS[kind])
    want = RX.read_mtx(str(path))
    if reader == "native":
        if native.load() is None:
            pytest.skip("no C++ compiler: the native library cannot be "
                        "built")
        got = PX.read_mtx(str(path))
    elif reader == "scipy":
        pytest.importorskip("scipy")
        monkeypatch.setattr(native, "read_mtx_coo", lambda p: None)
        got = PX.read_mtx(str(path))
    else:
        got = PX._read_mtx_py(str(path))
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_write_then_read_round_trip(tmp_path):
    a = np.zeros((5, 7))
    a[0, 3], a[4, 6], a[2, 2] = 1.0 / 3.0, -2.5e-8, 7.0
    PX.write_mtx(str(tmp_path / "p.mtx"), a)
    RX.write_mtx(str(tmp_path / "r.mtx"), a)
    assert ((tmp_path / "p.mtx").read_text()
            == (tmp_path / "r.mtx").read_text())
    np.testing.assert_array_equal(PX.read_mtx(str(tmp_path / "p.mtx")), a)
    with pytest.raises(FileNotFoundError):
        PX.read_mtx(str(tmp_path / "missing.mtx"))


def test_reference_matrices_read_from_a_checkout(tmp_path, monkeypatch):
    """reference_pyfr_operators / reference_edge_operators read the .mtx
    files of a libxsmm checkout named by XSMM_TPU_REFERENCE_DIR."""
    monkeypatch.delenv("XSMM_TPU_REFERENCE_DIR", raising=False)
    assert PT.reference_pyfr_operators() == []
    assert PT.reference_edge_operators() == []
    mats = {}
    for sub, name in ((PT.PYFR_MATS, "p3/hex/m0-sp.mtx"),
                      (PT.PYFR_MATS, "p3/hex/m3-sp.mtx"),
                      (PT.PYFR_MATS, "p3/hex/m3-de.mtx"),
                      (PT.PYFR_MATS, "p2/tet/m6-sp.mtx"),
                      (PT.EDGE_MATS, "tet4_0_csr.mtx"),
                      (PT.EDGE_MATS, "tet4_1_csr.mtx"),
                      (PT.EDGE_MATS, "tet4_0_csc.mtx")):
        path = tmp_path / sub / name
        path.parent.mkdir(parents=True, exist_ok=True)
        a = PT.edge_fluxmatrix(4, 6, seed=len(mats))
        PX.write_mtx(str(path), a)
        mats[str(path)] = a
    monkeypatch.setenv("XSMM_TPU_REFERENCE_DIR", str(tmp_path))
    assert PT.have_reference_pyfr_mats() and PT.have_reference_edge_mats()
    pyfr = PT.reference_pyfr_operators(orders=("p2", "p3"))
    assert [lbl for lbl, _ in pyfr] == ["p2/tet/m6-sp", "p3/hex/m0-sp",
                                        "p3/hex/m3-sp"]
    dense = PT.reference_pyfr_operators(orders=("p3",), kinds=("de",))
    assert [lbl for lbl, _ in dense] == ["p3/hex/m3-de"]
    edge = PT.reference_edge_operators()
    assert [lbl for lbl, _ in edge] == ["tet4_0_csr", "tet4_1_csr"]
    assert len(PT.reference_edge_operators(fmt="csc", limit=1)) == 1
    for lbl, a in pyfr:
        path = tmp_path / PT.PYFR_MATS / f"{lbl}.mtx"
        np.testing.assert_array_equal(a, RX.read_mtx(str(path)))
        np.testing.assert_allclose(a, mats[str(path)], rtol=1e-7)
