"""Build and load the hand-written CUDA kernels.

Every `csrc/*.cu` file has a plain C interface and includes no torch
headers, so nvcc compiles it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/<stem>-<hash>.so csrc/<stem>.cu

The build happens at first use, into `kernels/build/` (listed in
.gitignore), one nvcc process per source, all started together. The
library name carries a hash of its source and of the shared headers
(`csrc/*.cuh`), so an edited source is rebuilt and a stale library is never
loaded. Libraries are loaded with ctypes; kernels/gemm.py declares the
argument types. Every library keeps a launch log (csrc/xsmm_launches.cuh),
which launch_log() reads. No library links against libcuda: the one call
into it, cuTensorMapEncodeTiled for the BRGEMM's TMA maps, is looked up at
run time (cudaGetDriverEntryPoint). A failed build
raises: there is no fallback to the plain torch versions for CUDA
tensors.
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


def tool(name: str) -> str:
    """The path of one of the CUDA toolkit's programs (nvcc, cuobjdump),
    looked up on PATH, then under CUDA_HOME and /usr/local/cuda; raises
    when it is not found."""
    found = shutil.which(name)
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", name)):
            return os.path.join(root, "bin", name)
    raise RuntimeError(f"{name} not found: it comes with the CUDA toolkit "
                       "(PATH, CUDA_HOME or /usr/local/cuda)")


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
    nvcc = tool("nvcc")
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


def library_path(stem: str) -> pathlib.Path:
    """The path of the library built from csrc/<stem>.cu for this checkout's
    sources (it need not exist yet)."""
    return _target(CSRC / f"{stem}.cu")


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


def read_launch_log(lib: ctypes.CDLL) -> Dict[int, int]:
    """{host address of a kernel: launches so far} of one library's launch
    log (csrc/xsmm_launches.cuh)."""
    lib.xsmm_launch_log.restype = ctypes.c_int
    lib.xsmm_launch_log.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                    ctypes.POINTER(ctypes.c_longlong),
                                    ctypes.c_int]
    cap = 256
    fns = (ctypes.c_void_p * cap)()
    counts = (ctypes.c_longlong * cap)()
    n = lib.xsmm_launch_log(fns, counts, cap)
    if not 0 <= n <= cap:
        raise RuntimeError("the launch log overflowed: more kernels were "
                           "launched than csrc/xsmm_launches.cuh holds")
    return {fns[i]: counts[i] for i in range(n)}


def launch_log() -> Dict[str, Dict[int, int]]:
    """The launch log of every loaded library, by source stem."""
    return {stem: read_launch_log(lib) for stem, lib in list(_libs.items())}
