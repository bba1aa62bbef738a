"""utilities: the service layer's rates (samples/utilities.py) on the port.

    python -m libxsmm_torch.samples.utilities [m] [n] [--device cpu]

  matcopy    the IDENTITY meltw TPP on an (m, n) f32 matrix, GB/s
  transpose  the NORM_TO_NORMT meltw TPP, GB/s

Both TPPs return a view of their operand (no bytes move), so each is
timed with its result materialized into a new buffer (clone, contiguous)
and the line says so.
  rng        an f32 uniform sequence from an explicit torch.Generator on
             the device, GB/s
  crc32      the native CRC32C of 1 MiB on the host (native.crc32), GB/s;
             raises when the native library cannot be built

Defaults m = n = 4096. Device rates by CUDA events, or the host clock with
--device cpu (labelled). Returns 0.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from . import _common


def crc_data() -> bytes:
    """The sample's 1 MiB of random bytes."""
    return np.random.default_rng(1).bytes(1 << 20)


def crc_rate(data: bytes, reps: int = 200):
    """(the CRC of data, GB/s over reps calls on the host clock)."""
    from libxsmm_torch import native
    crc = native.crc32(data)
    if crc is None:
        raise RuntimeError("the native library could not be built (g++)")
    t0 = time.perf_counter()
    for _ in range(reps):
        native.crc32(data)
    return crc, len(data) * reps / (time.perf_counter() - t0) / 1e9


def main(argv=None) -> int:
    ap = _common.add_device(argparse.ArgumentParser(
        description="copy, transpose and random-number rates, the CRC"))
    ap.add_argument("m", nargs="?", type=int, default=4096)
    ap.add_argument("n", nargs="?", type=int, default=4096)
    args = ap.parse_args(argv)
    dev = _common.device(args.device)
    import libxsmm_torch as xp
    from libxsmm_torch.descriptor import UnaryType

    m, n = args.m, args.n
    x0 = torch.as_tensor(np.random.default_rng(0).standard_normal((m, n)),
                         device=dev).float()

    def rate(fn, nbytes):
        return nbytes / _common.timed([(fn, (x0,))], dev, reps=32)[0] / 1e9

    print(f"times: {_common.clock(dev)}")
    copy = xp.dispatch_meltw_unary(UnaryType.IDENTITY, m, n)
    if not torch.equal(copy(x0), x0):
        raise AssertionError("IDENTITY changed its operand")
    gb = rate(lambda x: copy(x).clone(), 2 * m * n * 4)
    print(f"matcopy  (IDENTITY TPP):      {gb:7.1f} GB/s (a view, cloned)")
    tr = xp.dispatch_meltw_unary(UnaryType.TRANSFORM_NORM_TO_NORMT, m, n)
    if not torch.equal(tr(x0), x0.T):
        raise AssertionError("NORM_TO_NORMT is not the transpose")
    gb = rate(lambda x: tr(x).contiguous(), 2 * m * n * 4)
    print(f"transpose (NORM_TO_NORMT):    {gb:7.1f} GB/s (a view, made "
          "contiguous)")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rng_step(s):
        return torch.rand(s.shape, generator=gen, device=dev)

    print(f"rng      (f32 sequence):      {rate(rng_step, m * n * 4):7.1f} "
          "GB/s")
    crc, gbs = crc_rate(crc_data())
    print(f"crc32    (native, 1 MiB):     {gbs:7.1f} GB/s (host clock; "
          f"crc {crc:#010x})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
