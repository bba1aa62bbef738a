"""Kernel timing on the card.

The part of `libxsmm_tpu/utils/timer.py` that `tune=True` needs:
`bench_chain`. PyTorch runs eagerly and does not memoise repeated calls, so
no data dependency needs chaining through the reps; each timed window is a
pair of CUDA events around `reps` calls, closed by a host sync.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def bench_chain(fn: Callable, args: Tuple, chain_idx: int = 0,
                reps: int = 20, rounds: int = 3, warmup: int = 2) -> float:
    """Best seconds per call of fn(*args) over `rounds` windows of `reps`
    calls, timed with CUDA events. The operands must lie on a CUDA device:
    a measurement never falls back to the CPU. `chain_idx` is accepted for
    signature parity with the JAX package."""
    del chain_idx
    devices = {a.device for a in args if isinstance(a, torch.Tensor)}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise RuntimeError("bench_chain times CUDA operands only (got "
                           f"{sorted(str(d) for d in devices)})")
    device = devices.pop()
    with torch.cuda.device(device):
        for _ in range(max(1, warmup)):
            fn(*args)
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(max(1, rounds)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn(*args)
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end) * 1e-3 / reps)
    return best
