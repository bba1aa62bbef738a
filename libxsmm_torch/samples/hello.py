"""hello: the four-TPP walkthrough (samples/hello.py) on the port.

    python -m libxsmm_torch.samples.hello [--device cpu]

A 13x5x7 GEMM with beta=1, a unary ReLU, a binary add and a ternary
muladd, each dispatched through the two-phase API and held against numpy
(matdiff normf_rel < 1e-5). Prints the registry's counts and the device:
on_gpu() and the card's geometry. Returns the number of failed checks.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import _common


def walkthrough(dev: torch.device):
    """[(name, result tensor, numpy reference)] of the four TPPs, from
    samples/hello.py's seed."""
    import libxsmm_torch as xp
    from libxsmm_torch.descriptor import (BinaryType, GemmShape, TernaryType,
                                          UnaryType)

    m, n, k = 13, 5, 7
    rng = np.random.default_rng(0)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    c = np.zeros((m, n), np.float32)

    gemm = xp.dispatch_gemm(GemmShape(m, n, k))          # beta=1
    relu = xp.dispatch_meltw_unary(UnaryType.RELU, m, n)
    add = xp.dispatch_meltw_binary(BinaryType.ADD, m, n)
    muladd = xp.dispatch_meltw_ternary(TernaryType.MULADD, m, n)

    ta, tb, tc = (torch.as_tensor(v, device=dev) for v in (a, b, c))
    c1 = gemm(ta, tb, tc)             # C = A@B + C
    c2 = relu(c1)                     # C = relu(C)
    c3 = add(c1, c2)                  # C = C + relu(C)
    c4 = muladd(c1, c2, c3)           # C = C1*C2 + C3

    ref1 = a @ b + c
    ref2 = np.maximum(ref1, 0)
    ref3 = ref1 + ref2
    ref4 = ref1 * ref2 + ref3
    return [("gemm", c1, ref1), ("relu", c2, ref2), ("add", c3, ref3),
            ("muladd", c4, ref4)]


def main(argv=None) -> int:
    ap = _common.add_device(argparse.ArgumentParser(
        description="the four-TPP walkthrough"))
    dev = _common.device(ap.parse_args(argv).device)
    import libxsmm_torch as xp

    failures = 0
    for name, got, ref in walkthrough(dev):
        info = xp.matdiff(ref, got)
        ok = info.normf_rel < 1e-5
        failures += not ok
        print(f"{name:8s} {'OK' if ok else 'FAIL'}  "
              f"normf_rel={info.normf_rel:.2e} linf_abs={info.linf_abs:.2e}")
    info = xp.get_registry_info()
    print(f"registry: {info['nkernels']} kernels, {info['hits']} hits, "
          f"{info['builds']} builds")
    geo = xp.get_geometry()
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {name} ({dev}), on_gpu={xp.on_gpu()}; geometry "
          f"{geo.name}: {geo.num_sms} SMs, {geo.smem_per_block} B shared "
          f"memory a block, {geo.l2_bytes >> 20} MiB L2, {geo.hbm_gbps:g} "
          f"GB/s, {geo.peak_bf16_tflops:g} / {geo.peak_f32_tflops:g} "
          "TFLOP/s bf16 / f32")
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
