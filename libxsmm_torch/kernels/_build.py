"""Build and load the hand-written CUDA kernels.

Every `csrc/*.cu` file has a plain C interface and includes no torch
headers, so nvcc compiles it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/<stem>-<hash>.so csrc/<stem>.cu

The build happens at first use, into `kernels/build/` (listed in
.gitignore), one nvcc process per source, all started together. The
library name carries a hash of its source and of the shared headers
(`csrc/*.cuh`), so an edited source is rebuilt and a stale library is never
loaded. Libraries are loaded with ctypes;
kernels/gemm.py declares the argument types. A failed build raises: there
is no fallback to the plain torch versions for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

_HERE = pathlib.Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD = _HERE / "build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's -Xptxas -v report (registers, shared memory, spills) per source
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (PATH, CUDA_HOME or "
                       "/usr/local/cuda)")


def _target(src: pathlib.Path) -> pathlib.Path:
    """The library built from `src`, named by a hash of the source, the
    shared headers (csrc/*.cuh) and the target."""
    data = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))) + ARCH.encode()
    digest = hashlib.sha1(data).hexdigest()[:12]
    return BUILD / f"{src.stem}-{digest}.so"


def build_all(timeout: float = 600.0) -> Dict[str, float]:
    """Compile every source whose library is missing, in parallel; return
    seconds per source built (empty when all were current)."""
    sources = sorted(CSRC.glob("*.cu"))
    todo = [(s, _target(s)) for s in sources if not _target(s).exists()]
    if not todo:
        return {}
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    t0 = time.perf_counter()
    for src, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
               "-fPIC", "-Xptxas", "-v", "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    times = {}
    failed = []
    for src, out, tmp, proc in procs:
        try:
            log, _ = proc.communicate(timeout=max(1.0, timeout - (
                time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            failed.append(f"{src.name}: nvcc timed out\n{log}")
            continue
        build_log[src.stem] = log
        if proc.returncode != 0:
            failed.append(f"{src.name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)     # atomic publish: never load a partial .so
        times[src.stem] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return times


def kernel_resources(stem: str, needle: str = "") -> List[tuple]:
    """(mangled name, registers, spill store bytes, spill load bytes) of
    each kernel of csrc/<stem>.cu whose mangled name holds `needle`, read
    from nvcc's -Xptxas -v report of this process's build (empty when the
    library was already built)."""
    found, name, spill = [], None, (0, 0)
    for line in build_log.get(stem, "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            if needle in name:
                found.append((name, int(m.group(1))) + spill)
            name = None
    return found


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from csrc/<stem>.cu (built on first use)."""
    lib: Optional[ctypes.CDLL] = _libs.get(stem)
    if lib is not None:
        return lib
    with _lock:
        if stem not in _libs:
            src = CSRC / f"{stem}.cu"
            if not src.exists():
                raise FileNotFoundError(src)
            if not _target(src).exists():
                build_all()
            _libs[stem] = ctypes.CDLL(str(_target(src)))
        return _libs[stem]
