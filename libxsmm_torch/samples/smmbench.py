"""smmbench: the streaming small-matrix-multiply cases (samples/smmbench.py)
on the port.

    python -m libxsmm_torch.samples.smmbench [size] [batch] [--device cpu]

C = A @ B (+ C) over `batch` (default 16384) products of size^3 (default
32), in f32, with each combination of operands streamed from memory:

  case 1  stream A, B, C   the packed SMM (dispatch_gemm_batched_packed)
  case 2  stream A, B      C accumulated over the batch (dispatch_brgemm)
  case 3  stream A, C      B shared: the packed SMM over B tiled into every
                           group once, before timing (the kernel takes no
                           shared B, so it reads B per group)
  case 4  stream B, C      A shared: one plain f32 product on the packed
                           layout (torch.matmul, TF32 off)
  case 5  stream nothing   the same dispatch_gemm call repeated

Each case's output is held against float64 once (matdiff normf_rel 1e-5),
then timed: CUDA events on the card, the host clock with --device cpu
(labelled). GB/s counts each streamed operand once. Returns the number of
failed checks.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import _common


def cases(size: int, batch: int, dev: torch.device):
    """[(name, fn, args, float64 reference of fn(*args), streamed bytes,
    flops, reps)] of the five cases, from samples/smmbench.py's seed."""
    import libxsmm_torch as xp
    from libxsmm_torch.descriptor import (BatchReduceConfig,
                                          BatchReduceType, GemmFlags,
                                          GemmShape)

    m = n = k = size
    p = xp.smm_pack_factor(GemmShape(m, n, k))
    G = batch // p
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev).float()

    def packed64(a, b):
        """float64 product of packed operands, in the packed layout."""
        a4 = a.double().reshape(G, m, p, k).permute(0, 2, 1, 3)
        b4 = b.double().reshape(G, k, p, n).permute(0, 2, 1, 3)
        return (a4 @ b4).permute(0, 2, 1, 3).reshape(G, m, p * n)

    a_u = t(rng.standard_normal((batch, m, k)))
    b_u = t(rng.standard_normal((batch, k, n)) * 0.1)
    a_p, b_p = xp.pack_batched(a_u, p), xp.pack_batched(b_u, p)
    flops = 2 * batch * m * n * k
    out = []

    kern1 = xp.dispatch_gemm_batched_packed(GemmShape(m, n, k),
                                            GemmFlags.BETA_0)
    out.append(("case 1 (stream A,B,C; batched SMM):  ", kern1, (a_p, b_p),
                packed64(a_p, b_p), batch * (m * k + k * n + m * n) * 4,
                flops, 16))

    kern2 = xp.dispatch_brgemm(GemmShape(m, n, k), GemmFlags.BETA_0,
                               BatchReduceConfig(BatchReduceType.STRIDE,
                                                 batch))
    a3 = t(rng.standard_normal((batch, m, k)))
    b3 = t(rng.standard_normal((batch, k, n)) * 0.01)
    out.append(("case 2 (stream A,B; C on-chip; BRGEMM):", kern2, (a3, b3),
                torch.einsum("bmk,bkn->mn", a3.double(), b3.double()),
                batch * (m * k + k * n) * 4, flops, 16))

    bs = t(rng.standard_normal((k, n)) * 0.1)
    b_tiled = xp.pack_batched(bs.expand(p, k, n), p)[0]
    b_all = b_tiled.expand(G, k, p * n).contiguous()
    out.append(("case 3 (stream A,C; B cached):       ", kern1,
                (a_p, b_all), packed64(a_p, b_all),
                batch * (m * k + m * n) * 4, flops, 16))

    a_sh = t(rng.standard_normal((m, k)) * 0.1)
    out.append(("case 4 (stream B,C; A cached):       ", torch.matmul,
                (a_sh, b_p), torch.matmul(a_sh.double(), b_p.double()),
                batch * (k * n + m * n) * 4, flops, 16))

    kern5 = xp.dispatch_gemm(GemmShape(m, n, k), GemmFlags.BETA_0)
    a5 = t(rng.standard_normal((m, k)))
    b5 = t(rng.standard_normal((k, n)) * 0.1)
    # a tiny serial workload: a deep chain of calls
    out.append(("case 5 (cached; repeated single SMM):", kern5, (a5, b5),
                a5.double() @ b5.double(), 0, 2 * m * n * k, 4096))
    return out


def main(argv=None) -> int:
    ap = _common.add_device(argparse.ArgumentParser(
        description="the streaming SMM cases"))
    ap.add_argument("size", nargs="?", type=int, default=32)
    ap.add_argument("batch", nargs="?", type=int, default=16384)
    args = ap.parse_args(argv)
    dev = _common.device(args.device)
    from libxsmm_torch.matdiff import matdiff

    print(f"times: {_common.clock(dev)}")
    failures = 0
    for name, fn, fargs, ref, nbytes, flops, reps in cases(
            args.size, args.batch, dev):
        info = matdiff(ref, fn(*fargs))
        ok = info.normf_rel <= 1e-5
        failures += not ok
        best = _common.timed([(fn, fargs)], dev, reps=reps)[0]
        gf, gb = flops / best / 1e9, nbytes / best / 1e9
        tail = (f"{gb:7.1f} GB/s" if nbytes
                else f"per call {best * 1e9:.0f} ns")
        print(f"{name} {gf:8.1f} GF/s {tail} ({best * 1e3:.4f} ms; "
              f"{'OK' if ok else 'FAIL'} normf_rel={info.normf_rel:.2e})")
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
