"""AOT kernel export/import: built kernels and their CUDA libraries in the
native KV log.

The port of `libxsmm_tpu/aot.py` (the reference's binary-export tool and
static-kernel registration, src/libxsmm_binaryexport_generator.c,
samples/static_codegen, internal_register_static_code
src/libxsmm_main.c:622-666). The JAX package serializes XLA executables so
that a later process neither traces nor compiles. The port's cold-start
cost is nvcc (kernels/_build.py), so a record holds what a later process
needs to skip it:

  * the kernel's descriptor and its entry (the public dispatch or create
    call that made it, registry.entry_point);
  * the bytes of every CUDA library the exporting call launched a kernel
    from, under the library's name (which carries the hash of the sources
    it was built from) with a SHA-256 of the bytes.

`load_kernel` writes back each library kernels/build/ lacks — only when
its name is the one this checkout's sources give and its bytes match their
hash, published atomically — and makes the kernel again through its entry,
so no nvcc runs. Keys bind the torch and CUDA versions, the device type and
name, the kernel and its arguments' dtypes and shapes: libraries are built
for sm_90a, as the reference's exported binaries are ISA-specific. On the
CPU the call launches nothing and the record holds no library.
"""

from __future__ import annotations

import hashlib
import importlib
import os
import pickle
import warnings
from typing import Optional, Sequence

import torch

from .native import PersistentKv

FORMAT = 1


def _aval_sig(args) -> str:
    import numpy as np

    def sig(a):
        if isinstance(a, torch.Tensor):
            return f"{str(a.dtype)[6:]}{list(a.shape)}"
        if isinstance(a, (tuple, list)):
            return "(" + ",".join(sig(v) for v in a) + ")"
        a = np.asarray(a)
        return f"{a.dtype}{list(a.shape)}"

    return ",".join(sig(a) for a in args)


def _device(args) -> torch.device:
    from .lowering import _tensors
    return next((t.device for t in _tensors(tuple(args))),
                torch.device("cpu"))


def default_key(name: str, args) -> bytes:
    """aot-torch:<torch>:<cuda>:<device type>:<device name>:<kernel>:<the
    arguments' dtypes and shapes>. The prefix keeps the port's records
    apart from the JAX package's in a shared log."""
    dev = _device(args)
    dname = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return (f"aot-torch:{torch.__version__}:{torch.version.cuda}:{dev.type}:"
            f"{dname}:{name}:{_aval_sig(args)}").encode()


def export_kernel(kernel, args: Sequence, store: PersistentKv,
                  key: Optional[bytes] = None) -> bytes:
    """Run `kernel` once on `args` and persist its record; returns the
    key."""
    from .kernels import _build
    if getattr(kernel, "entry", None) is None:
        raise ValueError(f"{getattr(kernel, 'name', kernel)!r} was not made "
                         "by a public dispatch or create call, so another "
                         "process cannot make it again")
    if key is None:
        key = default_key(kernel.name, args)
    dev = _device(args)
    before = _build.launch_log()
    kernel(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    libraries = {}
    for stem, log in _build.launch_log().items():
        if log == before.get(stem, {}):
            continue
        path = _build.library_path(stem)
        data = path.read_bytes()
        libraries[path.name] = (hashlib.sha256(data).hexdigest(), data)
    record = {"format": FORMAT, "name": kernel.name,
              "descriptor": kernel.descriptor, "entry": kernel.entry,
              "libraries": libraries}
    if not store.put(key, pickle.dumps(record)):
        raise IOError("failed to persist the AOT record")
    return key


def _restore(name: str, digest: str, data: bytes) -> None:
    """Write a library back into kernels/build/ unless it is there."""
    from .kernels import _build
    stem = name.rsplit("-", 1)[0]
    path = _build.library_path(stem)
    if path.name != name:
        raise ValueError(f"library {name} was built from other sources than "
                         f"this checkout's ({path.name})")
    if hashlib.sha256(data).hexdigest() != digest:
        raise ValueError(f"library {name}: its bytes do not match their "
                         "hash")
    if path.exists():
        return
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)     # atomic publish: never load a partial .so


def _same(a, b) -> bool:
    try:
        return bool(a == b)
    except (ValueError, RuntimeError):     # descriptors holding arrays
        return repr(a) == repr(b)


def load_kernel(store: PersistentKv, key: bytes):
    """The exported kernel, made again with its libraries restored; None
    when the key is absent. A corrupt or incompatible record warns and
    gives None (the caller rebuilds and re-exports), as the JAX package's
    does."""
    payload = store.get(key)
    if payload is None:
        return None
    try:
        record = pickle.loads(payload)
        if record.get("format") != FORMAT:
            raise ValueError(f"record format {record.get('format')!r}")
        for name, (digest, data) in sorted(record["libraries"].items()):
            _restore(name, digest, data)
        where, args, kwargs = record["entry"]
        module, fn = where.split(":")
        kernel = getattr(importlib.import_module(module), fn)(*args,
                                                               **kwargs)
        if not _same(kernel.descriptor, record["descriptor"]):
            raise ValueError(f"{where} now makes {kernel.descriptor!r}")
        return kernel
    except Exception as e:                       # stale/incompatible record
        warnings.warn(f"discarding unloadable AOT record for key {key!r}: "
                      f"{e}")
        return None
