"""dispatch_bench: dispatch and invoke costs (samples/dispatch_bench.py) on
the port.

    python -m libxsmm_torch.samples.dispatch_bench [iterations] [--device cpu]

Measures, on the host clock:

  * a cache-hit dispatch (descriptor -> the registry's Kernel object);
  * a cache-miss dispatch and its first call, over five fresh shapes. The
    CUDA libraries are built (nvcc) once a process, not per shape, so they
    are built first and the build time prints on a line of its own;
  * the invoke cost of a chain of 200 calls at 23^3, closed by
    torch.cuda.synchronize() on the card;
  * a find in the native C++ registry (native.NativeRegistry), which must
    return the value inserted; it raises when the native library cannot be
    built (no C++ compiler).

Returns 0, or 1 when the registry's find misses.
"""

from __future__ import annotations

import argparse
import time

import torch

from . import _common


def measure(iters: int, dev: torch.device) -> dict:
    """The sample's figures, with the registry's hits before and after and
    the native registry's find result."""
    import libxsmm_torch as xp
    from libxsmm_torch import native
    from libxsmm_torch.descriptor import GemmFlags, GemmShape

    res = {"hits_before": xp.get_registry_info()["hits"]}
    t0 = time.perf_counter()
    if dev.type == "cuda":
        from libxsmm_torch.kernels import _build
        res["built"] = sorted(_build.build_all())
    if native.load() is None:
        raise RuntimeError("the native library could not be built (g++)")
    res["build_s"] = time.perf_counter() - t0

    shape = GemmShape(23, 23, 23)
    xp.dispatch_gemm(shape, GemmFlags.BETA_0)             # prime
    t0 = time.perf_counter()
    for _ in range(iters):
        xp.dispatch_gemm(shape, GemmFlags.BETA_0)
    res["hit_ns"] = (time.perf_counter() - t0) / iters * 1e9

    nmiss = 5
    t0 = time.perf_counter()
    for i in range(nmiss):
        kern = xp.dispatch_gemm(GemmShape(29, 29, 29 + i), GemmFlags.BETA_0)
        a = torch.ones((29, 29 + i), device=dev)
        b = torch.ones((29 + i, 29), device=dev)
        kern(a, b).cpu()                          # the result on the host
    res["miss_ms"] = (time.perf_counter() - t0) / nmiss * 1e3

    kern = xp.dispatch_gemm(shape, GemmFlags.BETA_0)
    a = torch.ones((23, 23), device=dev)
    out = kern(a, a)
    _common.sync(dev)
    t0 = time.perf_counter()
    n = 200
    for _ in range(n):
        out = kern(out, a)                        # chained
    _common.sync(dev)
    res["invoke_us"] = (time.perf_counter() - t0) / n * 1e6

    reg = native.NativeRegistry()
    key = b"gemm_23x23x23_f32_beta0"
    reg.insert(key, 42)
    t0 = time.perf_counter()
    for _ in range(iters):
        found = reg.find(key)
    res["find_ns"] = (time.perf_counter() - t0) / iters * 1e9
    res["found"] = found
    info = xp.get_registry_info()
    res["hits_after"], res["nkernels"] = info["hits"], info["nkernels"]
    return res


def main(argv=None) -> int:
    ap = _common.add_device(argparse.ArgumentParser(
        description="dispatch and invoke costs"))
    ap.add_argument("iterations", nargs="?", type=int, default=10000)
    args = ap.parse_args(argv)
    dev = _common.device(args.device)
    r = measure(args.iterations, dev)
    what = ("nvcc for every CUDA library and g++ for the native one"
            if dev.type == "cuda" else "g++ for the native library")
    print(f"build ({what}; once a process): {r['build_s']:.2f} s"
          + (f" (built {', '.join(r['built'])})" if r.get("built") else ""))
    print(f"times: host clock, {dev}")
    print(f"dispatch (cache hit):   {r['hit_ns']:10.0f} ns")
    print(f"dispatch (miss+call):   {r['miss_ms']:10.2f} ms")
    print(f"invoke (chained 23^3):  {r['invoke_us']:10.1f} us")
    print(f"native registry find:   {r['find_ns']:10.0f} ns "
          f"(found {r['found']})")
    print(f"registry: {r['nkernels']} kernels, {r['hits_after']} hits")
    return 0 if r["found"] == 42 else 1


if __name__ == "__main__":
    raise SystemExit(main())
