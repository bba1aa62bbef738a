"""Kernel timing on the card.

The part of `libxsmm_tpu/utils/timer.py` that the port's tuners need:
`bench_chain` (tune=True of the batched GEMMs) and `bench_chain_interleaved`
(the BCSC and fsspmdm autotuners). PyTorch runs eagerly and does not
memoise repeated calls, so no data dependency needs chaining through the
reps; each timed window is a pair of CUDA events around `reps` calls, closed
by a host sync. `bench_host_interleaved` is the same discipline on the host
clock for CPU operands: fsspmdm's create-time autotune times whatever device
its handle lives on, as the reference's does.
"""

from __future__ import annotations

import time
from typing import Callable, List, Sequence, Tuple

import torch


def _devices(cands) -> set:
    return {a.device for _fn, args in cands for a in args
            if isinstance(a, torch.Tensor)}


def _cuda_device(cands) -> torch.device:
    """The one CUDA device the tensors among the candidates' args lie on;
    raises otherwise: a measurement never falls back to the CPU."""
    devices = _devices(cands)
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise RuntimeError("timing needs CUDA operands on one device (got "
                           f"{sorted(str(d) for d in devices)})")
    return devices.pop()


def _cuda_window(fn: Callable, args: Tuple, reps: int) -> float:
    """Seconds per call over one window of `reps` calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e-3 / reps


def _host_window(fn: Callable, args: Tuple, reps: int) -> float:
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    return (time.perf_counter() - t0) / reps


def _warm(cands, warmup: int) -> None:
    for fn, args in cands:
        for _ in range(max(1, warmup)):
            fn(*args)


def _interleaved(cands, reps, rounds, window, per_round):
    rows: List[List[float]] = [[] for _ in cands]
    for _ in range(max(1, rounds)):
        for i, (fn, args) in enumerate(cands):
            rows[i].append(window(fn, args, reps))
    best = [min(r) for r in rows]
    return (best, rows) if per_round else best


def bench_chain(fn: Callable, args: Tuple, chain_idx: int = 0,
                reps: int = 20, rounds: int = 3, warmup: int = 2) -> float:
    """Best seconds per call of fn(*args) over `rounds` windows of `reps`
    calls, timed with CUDA events. The operands must lie on a CUDA device.
    `chain_idx` is accepted for signature parity with the JAX package."""
    del chain_idx
    return bench_chain_interleaved([(fn, args)], reps, rounds, warmup)[0]


def bench_chain_interleaved(cands: Sequence[Tuple], reps: int = 20,
                            rounds: int = 3, warmup: int = 2,
                            per_round: bool = False):
    """Best seconds per call for several candidates, their windows
    INTERLEAVED round by round: candidate i's window in round r runs next
    to candidate j's, so every candidate samples the same state of the card
    and the ratios between the returned times survive a change of clocks or
    neighbours between rounds.

    cands: (fn, args) pairs (a third element, the JAX package's chain
    index, is ignored); every tensor among all args lies on one CUDA
    device. Returns seconds per call in candidate order; with per_round=True
    also the per-round times ([[sec, ...] per candidate]), so a caller can
    decide on the median of same-round ratios. A candidate that raises is
    not dropped: the error propagates."""
    cands = [(c[0], tuple(c[1])) for c in cands]
    device = _cuda_device(cands)
    with torch.cuda.device(device):
        _warm(cands, warmup)
        torch.cuda.synchronize()
        return _interleaved(cands, reps, rounds, _cuda_window, per_round)


def bench_host_interleaved(cands: Sequence[Tuple], reps: int = 20,
                           rounds: int = 3, warmup: int = 2,
                           per_round: bool = False):
    """bench_chain_interleaved on the host clock, for candidates whose
    operands lie on the CPU (raises for any other device)."""
    cands = [(c[0], tuple(c[1])) for c in cands]
    devices = _devices(cands)
    if any(d.type != "cpu" for d in devices):
        raise RuntimeError("host timing needs CPU operands (got "
                           f"{sorted(str(d) for d in devices)})")
    _warm(cands, warmup)
    return _interleaved(cands, reps, rounds, _host_window, per_round)
