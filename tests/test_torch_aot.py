"""The port's AOT export (libxsmm_torch.aot) against the JAX package's
(libxsmm_tpu.aot), on the CPU.

The round trip gives the JAX package's load_kernel result on the same
inputs (f32, matdiff normf_rel 1e-5); a missing key gives None; a corrupt
record, one whose library bytes miss their hash and one built from other
sources each warn and give None; the key binds the torch version and the
device name; and the JAX package's entries and the port's share one KV
file without either reading the other's. On the CPU the exporting call
launches no CUDA kernel, so the record holds no library. The JAX side runs
in a one-device subprocess, as tests/test_native.py's AOT test runs it (an
executable binds the device topology it was compiled for).
"""

import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import libxsmm_torch as xp
from libxsmm_torch import aot, native
from libxsmm_torch.matdiff import check

ROOT = pathlib.Path(__file__).resolve().parents[1]

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(native.load() is None,
                                reason="no C++ compiler: no native KV log")

# the JAX package: export into the log, load, run on the saved operands,
# save the result and its key
_JAX = r"""
import os, sys
os.environ.pop("XLA_FLAGS", None)
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import libxsmm_tpu as xt
from libxsmm_tpu import aot, native_bridge
from libxsmm_tpu.descriptor import GemmFlags, GemmShape
log, tmp = sys.argv[1], sys.argv[2]
a, b = np.load(tmp + "/a.npy"), np.load(tmp + "/b.npy")
kern = xt.dispatch_gemm(GemmShape(8, 8, 8), GemmFlags.BETA_0)
store = native_bridge.PersistentKv(log)
key = aot.export_kernel(kern, (a, b), store)
loaded = aot.load_kernel(store, key)
np.save(tmp + "/jax_out.npy", np.asarray(loaded(a, b)))
open(tmp + "/jax_key", "wb").write(key)
port_key = open(tmp + "/port_key", "rb").read()
assert store.get(port_key) is not None
print("JAX-AOT-OK")
"""


def _jax(log, tmp):
    out = subprocess.run([sys.executable, "-c", _JAX, str(log), str(tmp)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert "JAX-AOT-OK" in out.stdout, out.stderr[-3000:]


def _gemm():
    return xp.dispatch_gemm(xp.GemmShape(8, 8, 8), xp.GemmFlags.BETA_0)


def _operands(tmp):
    rng = np.random.default_rng(7)
    a, b = (rng.standard_normal((8, 8)).astype(np.float32) for _ in "ab")
    np.save(tmp / "a.npy", a)
    np.save(tmp / "b.npy", b)
    return torch.from_numpy(a), torch.from_numpy(b)


def test_round_trip_against_the_jax_package(tmp_path):
    """Both packages export into one log and load their own records: the
    same product on the same inputs, and each key read by its package
    alone."""
    log = tmp_path / "aot.xkv"
    a, b = _operands(tmp_path)
    store = native.PersistentKv(log)
    kern = _gemm()
    key = aot.export_kernel(kern, (a, b), store)
    (tmp_path / "port_key").write_bytes(key)
    _jax(log, tmp_path)                 # appends after the port's record
    jax_key = (tmp_path / "jax_key").read_bytes()
    assert key.startswith(b"aot-torch:") and not jax_key.startswith(
        b"aot-torch:")
    assert key != jax_key
    loaded = aot.load_kernel(store, key)
    assert loaded is not None and loaded.descriptor == kern.descriptor
    got = loaded(a, b)
    check(np.load(tmp_path / "jax_out.npy").astype(np.float64),
          got.double().numpy(), 1e-5)
    check(a.double().numpy() @ b.double().numpy(), got.double().numpy(),
          1e-5)
    # the port's record: no library on the CPU, its entry and descriptor
    record = pickle.loads(store.get(key))
    assert record["libraries"] == {}
    assert record["entry"][0] == "libxsmm_torch.ops.gemm:dispatch_gemm"
    assert record["descriptor"] == kern.descriptor


def test_missing_key_gives_none(tmp_path):
    store = native.PersistentKv(tmp_path / "aot.xkv")
    assert aot.load_kernel(store, b"missing") is None
    a = torch.zeros(8, 8)
    aot.export_kernel(_gemm(), (a, a), store)
    assert aot.load_kernel(store, b"missing") is None


def _record(kern, **libraries):
    return pickle.dumps({"format": aot.FORMAT, "name": kern.name,
                         "descriptor": kern.descriptor, "entry": kern.entry,
                         "libraries": libraries})


@pytest.mark.parametrize("case", ["garbage", "format", "hash", "sources",
                                  "entry"])
def test_corrupt_record_warns_and_gives_none(tmp_path, case):
    from libxsmm_torch.kernels import _build
    store = native.PersistentKv(tmp_path / "aot.xkv")
    kern = _gemm()
    a = torch.zeros(8, 8)
    aot.export_kernel(kern, (a, a), store)      # kern.entry is set
    name = _build.library_path("gemm_kernels").name
    payload = {
        "garbage": b"\x80\x04not a pickle",
        "format": pickle.dumps({"format": aot.FORMAT + 1}),
        # bytes that do not match their hash, under this checkout's name
        "hash": _record(kern, **{name: ("0" * 64, b"\x7fELF")}),
        # a library built from other sources than this checkout's
        "sources": _record(kern, **{"gemm_kernels-000000000000.so": (
            "0" * 64, b"")}),
        "entry": pickle.dumps({"format": aot.FORMAT, "name": "k",
                               "descriptor": None, "libraries": {},
                               "entry": ("libxsmm_torch.ops.gemm:nope", (),
                                         {})})}[case]
    assert store.put(b"bad", payload)
    with pytest.warns(UserWarning, match="discarding unloadable AOT record"):
        assert aot.load_kernel(store, b"bad") is None
    # nothing was written back
    lib = _build.BUILD / name
    assert not lib.exists() or lib.read_bytes() != b"\x7fELF"


def test_key_binds_torch_version_and_device(monkeypatch):
    a = torch.zeros(8, 8)
    key = aot.default_key("k", (a, a))
    parts = key.decode().split(":")
    assert parts[:6] == ["aot-torch", torch.__version__,
                         str(torch.version.cuda), "cpu", "cpu", "k"]
    assert parts[6] == "float32[8, 8],float32[8, 8]"
    monkeypatch.setattr(torch, "__version__", "0.0.0")
    assert aot.default_key("k", (a, a)) != key
    assert aot.default_key("k", (a, torch.zeros(8, 4))) != key


def test_unexportable_kernel_refused(tmp_path):
    """A kernel no public entry point made (built outside the registry)
    cannot be made again in another process: export refuses it."""
    from libxsmm_torch.ops.gemm import _build_gemm
    kern = _build_gemm(_gemm().descriptor)
    assert kern.entry is None
    with pytest.raises(ValueError, match="public dispatch or create"):
        aot.export_kernel(kern, (torch.zeros(8, 8),) * 2,
                          native.PersistentKv(tmp_path / "aot.xkv"))


def test_port_log_leaves_jax_out(tmp_path):
    """Exporting and loading in a process without JAX loads no JAX."""
    code = ("import sys, torch, libxsmm_torch as xp\n"
            "from libxsmm_torch import aot, native\n"
            "k = xp.dispatch_gemm(xp.GemmShape(4, 4, 4), xp.GemmFlags.BETA_0)\n"
            "a = torch.ones(4, 4)\n"
            f"s = native.PersistentKv({str(tmp_path / 'a.xkv')!r})\n"
            "key = aot.export_kernel(k, (a, a), s)\n"
            "assert torch.equal(aot.load_kernel(s, key)(a, a), a * 4)\n"
            "print('LOADED', sorted(m for m in sys.modules if m.split('.')[0]"
            " in ('jax', 'jaxlib', 'libxsmm_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert "LOADED []" in out.stdout, out.stderr[-2000:]
