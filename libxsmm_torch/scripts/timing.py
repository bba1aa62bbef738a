"""The card's timers, shared by chip_smoke.py and the timing scripts
(stream_time, dropout_time).

* events_ms: the best of `rounds` windows of `reps` back-to-back calls
  between two CUDA events (the host's cost of a call included where it
  exceeds the card's, and the first launch of a window);
* graph_ms: the best of `rounds` replays of a CUDA graph of the calls, per
  call: the card's time with the launches back to back and no host cost
  between them (the device stays busy, as under a loaded caller);
* host_ms: the best of `rounds` windows of `reps` calls on the host clock,
  with no synchronize inside a window (the card drains the queue after
  it); where it exceeds the device's time a call, the host sets an
  event-timed row;
* device_split / device_ms: the CUDA kernels' time from torch.profiler,
  by kernel name / summed, per call.

graph_ms, device_split and device_ms take one thunk, called `reps` times,
or a list of thunks, called once each (operands rotated past L2, say).
card() is the line `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader` prints, to stand beside every number.

A script that times a checkout of an older tree (that checkout's root first
on PYTHONPATH) runs by its path in this directory, so it imports this file
from here, not from the checkout.
"""

from __future__ import annotations

import os
import subprocess
import time
from typing import Callable, Dict, List, Sequence, Union

import torch

Calls = Union[Callable[[], object], Sequence[Callable[[], object]]]


def _calls(fn: Calls, reps: int) -> List[Callable[[], object]]:
    return list(fn) if isinstance(fn, (list, tuple)) else [fn] * reps


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def events_ms(fn: Callable[[], object], reps: int = 20,
              rounds: int = 5) -> float:
    """Milliseconds per call of fn() between two CUDA events around `reps`
    back-to-back calls, the best of `rounds` windows, after two calls to
    warm up."""
    for _ in range(2):
        fn()
    best = float("inf")
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def graph_ms(fn: Calls, reps: int = 20, rounds: int = 5) -> float:
    """Milliseconds per call replayed from a CUDA graph of the captured
    calls, the best of `rounds` replays timed with CUDA events. Two calls
    warm up on a side stream first, as capture asks."""
    calls = _calls(fn, reps)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in (calls * 2)[:2]:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for f in calls:
            f()
    best = float("inf")
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / len(calls))
    return best


def host_ms(fn: Callable[[], object], reps: int = 100,
            rounds: int = 5) -> float:
    """Milliseconds of the host's own time per call of fn(), the best of
    `rounds` windows of `reps` calls with no synchronize inside one."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, (time.perf_counter() - t0) / reps)
        torch.cuda.synchronize()
    return best * 1e3


# profiler sessions device_split runs before it gives up on a call whose
# sessions record no CUDA kernel, and the empty sessions seen so far in this
# process (each also printed as it happens)
_PROFILER_TRIES = 3
empty_sessions = 0


def device_split(fn: Calls, reps: int = 20) -> Dict[str, float]:
    """Device time per call by kernel name, in ms: each CUDA kernel's summed
    time over the calls, from torch.profiler, after one call to warm up. A
    session that records no CUDA kernel at all (seen in a few long runs of
    chip_smoke.py, after its parallel phases; the cause is not known) is
    counted in `empty_sessions`, printed, and run again, up to
    _PROFILER_TRIES in all; empty after them all, the split is empty."""
    global empty_sessions
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    calls = _calls(fn, reps)
    calls[0]()
    torch.cuda.synchronize()
    split: Dict[str, float] = {}
    for session in range(1, _PROFILER_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for f in calls:
                f()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                split[e.name] = (split.get(e.name, 0.0)
                                 + e.time_range.elapsed_us() / len(calls)
                                 / 1e3)
        if split:
            break
        empty_sessions += 1
        print(f"device_split: profiler session {session} of "
              f"{_PROFILER_TRIES} recorded no CUDA kernel for "
              f"{_label(fn)} ({len(calls)} calls)", flush=True)
    return split


def _label(fn: Calls) -> str:
    """Where the timed function was defined (file:line), else its repr."""
    f = fn[0] if isinstance(fn, (list, tuple)) else fn
    code = getattr(f, "__code__", None)
    if code is None:
        return repr(f)
    return f"{os.path.basename(code.co_filename)}:{code.co_firstlineno}"


def device_ms(fn: Calls, reps: int = 20) -> float:
    """The CUDA kernels' summed device time per call (device_split)."""
    total = sum(device_split(fn, reps).values())
    if not total:
        raise AssertionError("device_ms: the profiler recorded no kernel")
    return total
