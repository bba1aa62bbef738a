"""A warm start from an AOT record, in a fresh process without nvcc.

    python3 -m libxsmm_torch.scripts.aot_warm <log> <key hex> <groups>

`cold_start(log, key, groups, workdir)` copies the package (and the native
runtime's source) into `workdir` without kernels/build/, and runs this
module there as a child process whose PATH holds no nvcc and whose
CUDA_HOME names no toolkit. The child loads the exported packed-SMM kernel
(aot.load_kernel, which writes its CUDA library back), with
kernels._build.build_all replaced by a function that raises, so no nvcc can
run; runs it on `groups` seeded lane-packed groups on the card; holds the
result against the kernel's plain version (matdiff normf_rel 1e-5, f32);
and prints one JSON line: the error, its seconds from the start of
load_kernel to the first result, and the libraries it restored. The parent
adds the child's wall time, interpreter start included.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

_ROOT = pathlib.Path(__file__).resolve().parents[2]


def _child(log: str, key: str, groups: int) -> dict:
    import torch

    from libxsmm_torch import aot, native
    from libxsmm_torch.kernels import _build
    from libxsmm_torch.kernels import gemm as K
    from libxsmm_torch.matdiff import check

    def refuse(*args, **kwargs):
        raise RuntimeError("nvcc would run: a library was not restored")

    _build.build_all = refuse
    t0 = time.perf_counter()
    kern = aot.load_kernel(native.PersistentKv(log), bytes.fromhex(key))
    if kern is None:
        raise RuntimeError("load_kernel gave None")
    s = kern.descriptor.shape
    p = 128 // s.n
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(groups, s.m, p * s.k, generator=gen, device="cuda")
    b = torch.randn(groups, s.k, p * s.n, generator=gen, device="cuda")
    K.reset_launches()
    out = kern(a, b)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    if K.launches["packed_batched_gemm"] != 1:
        raise RuntimeError(f"the kernel was not launched: {K.launches}")
    want = K.build_packed_batched_gemm(kern.descriptor, groups).plain(a, b)
    info = check(want, out, 1e-5)
    return {"normf_rel": info.normf_rel, "first_result_s": first,
            "restored": sorted(p_.name for p_ in _build.BUILD.glob("*.so")
                               if not p_.name.startswith("xsmm_native")),
            "build_log": sorted(_build.build_log)}


def cold_start(log, key: bytes, groups: int, workdir) -> dict:
    """Run the child in a copy of the package without kernels/build/;
    returns its JSON line with its wall time ("process_s")."""
    work = pathlib.Path(workdir)
    pkg = _ROOT / "libxsmm_torch"
    shutil.copytree(pkg, work / "libxsmm_torch", ignore=shutil.ignore_patterns(
        "build", "__pycache__"))
    (work / "native").mkdir()
    shutil.copy(_ROOT / "native" / "xsmm_native.cpp", work / "native")
    path = [d for d in os.environ.get("PATH", "").split(os.pathsep)
            if d and not os.path.exists(os.path.join(d, "nvcc"))]
    env = dict(os.environ, PATH=os.pathsep.join(path),
               CUDA_HOME=str(work / "no-toolkit"), PYTHONPATH=str(work))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "libxsmm_torch.scripts."
                          "aot_warm", str(log), key.hex(), str(groups)],
                         cwd=str(work), env=env, capture_output=True,
                         text=True, timeout=300)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise RuntimeError(f"the AOT child failed ({out.returncode}):\n"
                           f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    res["process_s"] = wall
    return res


if __name__ == "__main__":
    print(json.dumps(_child(sys.argv[1], sys.argv[2], int(sys.argv[3]))))
