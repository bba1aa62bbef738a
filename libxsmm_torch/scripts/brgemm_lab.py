"""BRGEMM streaming lab: every packed BRGEMM variant against its own
streaming twin, in one interleaved run on the card.

The port of scripts/brgemm_lab.py. At br = 1024, m = n = 256, k = 64, bf16
-> f32, for each of the JAX lab's four variants (pack_q as a multiple of
128/k, step_groups, acc_scratch) it times the kernel
(dispatch_brgemm_packed) and its twin (kernels/gemm.py
build_packed_brgemm_sol: the same grid, K split and loads, running row and
column sums in place of the products), then a copy probe (x + 1 over 4096 x
4096 bf16) that labels the window, all interleaved round by round
(utils/timer.bench_chain_interleaved). Before timing, each twin is held
against its plain version (1e-5 normf_rel: f32 sums of the same values in
another order). It prints each variant's time, TF/s, the twin's time and
the median of the paired t_sol / t_brg: how far the kernel is from its own
streaming floor. A twin that cannot be built prints UNBUILDABLE; anything
that raises propagates.

    python3 -m libxsmm_torch.scripts.brgemm_lab [--rounds 5]

--device cpu runs the plain versions on the host clock, a rehearsal of the
control flow. main(argv) returns the printed rows.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

# (pack_q as a multiple of 128/k, step_groups, acc_scratch): scripts/
# brgemm_lab.py:55, bench.py:489
VARIANTS = ((1, 16, False), (8, 2, False), (32, 1, False), (32, 1, True))
COPY_SHAPE = (4096, 4096)
TOL_SOL = 1e-5


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import libxsmm_torch as xt
    from libxsmm_torch.descriptor import (BatchReduceConfig,
                                          BatchReduceType, GemmDescriptor,
                                          GemmFlags, GemmShape)
    from libxsmm_torch.device import resolve_device
    from libxsmm_torch.dtypes import Datatype
    from libxsmm_torch.kernels.gemm import build_packed_brgemm_sol
    from libxsmm_torch.matdiff import check
    from libxsmm_torch.utils.timer import (bench_chain_interleaved,
                                           bench_host_interleaved)

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    print("device:", torch.cuda.get_device_name(dev) if on_card else "cpu",
          flush=True)
    br, m, n, k = 1024, 256, 256, 64
    rng = np.random.default_rng(0)
    bf16 = torch.bfloat16
    a = torch.as_tensor(rng.standard_normal((br, m, k)), device=dev).to(bf16)
    b0 = torch.as_tensor(rng.standard_normal((br, k, n)), device=dev).to(bf16)
    shape = GemmShape(m, n, k, a_in_type=Datatype.BF16,
                      b_in_type=Datatype.BF16, out_type=Datatype.F32)
    q = xt.brgemm_pack_factor(shape)
    br_cfg = BatchReduceConfig(BatchReduceType.STRIDE, br)
    desc = GemmDescriptor(shape=shape, flags=GemmFlags.BETA_0, br=br_cfg)

    a_packed = {}
    names, cands, sols = [], [], {}
    for mult, sg, scr in VARIANTS:
        if mult not in a_packed:
            a_packed[mult] = xt.pack_batched(a, q * mult)
        a_p = a_packed[mult]
        pack_q = q * mult if mult > 1 else None
        kern = xt.dispatch_brgemm_packed(
            shape, GemmFlags.BETA_0, br_cfg, step_groups=sg, pack_q=pack_q,
            acc_scratch=scr)
        sol = build_packed_brgemm_sol(desc, br, step_groups=sg,
                                      pack_q=pack_q)
        tag = f"q{q * mult}_sg{sg}{'_scr' if scr else ''}"
        names.append(f"brg_{tag}")
        cands.append((lambda b_, c_=kern, ap_=a_p: c_(ap_, b_), (b0,)))
        if sol is None:
            print(f"sol twin for {tag}: UNBUILDABLE", flush=True)
            continue
        got = sol(a_p, b0)
        sols[tag] = check(sol.plain(a_p, b0), got, margin=TOL_SOL).normf_rel
        names.append(f"sol_{tag}")
        cands.append((lambda b_, c_=sol, ap_=a_p: c_(ap_, b_), (b0,)))

    # copy probe to label the window
    big = torch.as_tensor(rng.standard_normal(COPY_SHAPE),
                          device=dev).to(bf16)
    names.append("copy")
    cands.append((lambda x: x + 1.0, (big,)))
    copy_bytes = 2 * big.numel() * big.element_size()

    timer = bench_chain_interleaved if on_card else bench_host_interleaved
    t0 = time.perf_counter()
    times, rounds = timer(cands, rounds=args.rounds, per_round=True)
    print(f"measured in {time.perf_counter() - t0:.1f}s", flush=True)

    flops = 2 * br * m * n * k
    idx = {nm: i for i, nm in enumerate(names)}
    print(f"window copy bw: {copy_bytes / times[idx['copy']] / 1e9:.0f} GB/s")
    print(f"\n{'variant':>16} {'brg_us':>9} {'TF/s':>7} {'sol_us':>9} "
          f"{'sol_frac(med)':>14}")
    rows = []
    for mult, sg, scr in VARIANTS:
        tag = f"q{q * mult}_sg{sg}{'_scr' if scr else ''}"
        bi, si = idx[f"brg_{tag}"], idx.get(f"sol_{tag}")
        tb = times[bi]
        ts = None if si is None else times[si]
        frac = None if si is None else float(np.median(
            [s_ / b_ for b_, s_ in zip(rounds[bi], rounds[si])]))
        rows.append({"variant": tag, "pack_q": q * mult, "step_groups": sg,
                     "acc_scratch": scr, "brg_us": tb * 1e6,
                     "tflops": flops / tb / 1e12,
                     "sol_us": None if ts is None else ts * 1e6,
                     "sol_frac": frac, "sol_normf_rel": sols.get(tag)})
        nan = float("nan")
        print(f"{tag:>16} {tb * 1e6:9.1f} {flops / tb / 1e12:7.1f} "
              f"{ts * 1e6 if ts else nan:9.1f} "
              f"{frac if frac is not None else nan:14.3f}")
    return rows


if __name__ == "__main__":
    main()
