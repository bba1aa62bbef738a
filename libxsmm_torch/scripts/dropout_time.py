"""Dropout kernel timing: each mask form of `kernels.eltwise.dropout` on the
card, by events, CUDA-graph replay and torch.profiler, with the operand warm
in L2 and rotated past it.

At 4096 x 3072 (the encoder block's FFN shape) in bf16, p = 0.1, for each
form it prints one line with

* events: back-to-back calls between two CUDA events (the host's cost of a
  call included where it exceeds the card's);
* replay: a CUDA graph of the calls on one x, back to back;
* replay, rotated: the same over enough copies of x to span four times the
  L2 cache, so that no call reads x from L2;
* profiler, warm and rotated: the kernels' own time per call;
* the bound: the bytes the form moves (x read, out and its mask written
  once) over the card's memory rate (`libxsmm_torch.device`).

Before timing, each form's output and mask are held against its plain
version bit for bit. "bytes" calls `dropout(x, seed, p)` with no mask
argument, so the script also times a checkout whose dropout has no mask
forms: put that checkout's root first on PYTHONPATH and pass --forms bytes.

    python3 -m libxsmm_torch.scripts.dropout_time [--forms bytes,packed,none]

The last line is one JSON object: the card, its power limit and the rows.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
from typing import List, Optional, Sequence

import torch

SHAPE = (4096, 3072)
SEED, P = 7, 0.1
REPS, ROUNDS = 20, 5


def _events_ms(fn) -> float:
    for _ in range(2):
        fn()
    best = float("inf")
    for _ in range(ROUNDS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / REPS)
    return best


def _replay_ms(calls) -> float:
    """Best replay of a graph holding `calls` (a list of thunks), per call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls[:2]:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    best = float("inf")
    for _ in range(ROUNDS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / len(calls))
    return best


def _profiler_ms(calls) -> float:
    """The CUDA kernels' summed time over `calls`, per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    calls[0]()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    total = sum(e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA)
    if not total:
        raise AssertionError("the profiler recorded no kernel")
    return total / len(calls) / 1e3


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--forms", default="bytes,packed,none",
                    help="comma-separated mask forms to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dropout_time: needs a CUDA device")

    from libxsmm_torch.device import get_geometry
    from libxsmm_torch.kernels import eltwise as KE

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(smi)
    geo = get_geometry()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
    copies = max(2, math.ceil(4 * geo.l2_bytes / (x.numel() * 2)))
    xs = [x.clone() for _ in range(copies)]
    m, n = SHAPE
    mask_bytes = {"bytes": m * n, "packed": m * ((n + 15) // 16 * 2),
                  "none": 0}
    rows = []
    for form in args.forms.split(","):
        def call(t, form=form):
            if form == "bytes":
                return KE.dropout(t, SEED, P)
            return KE.dropout(t, SEED, P, mask=form)

        got = call(x)
        want = (KE.dropout.plain(x, SEED, P) if form == "bytes"
                else KE.dropout.plain(x, SEED, P, mask=form))
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            if not torch.equal(g, w.to(g.dtype)):
                raise AssertionError(f"dropout {form}: kernel != plain")
        warm = [lambda: call(x)] * REPS
        rotated = [lambda t=t: call(t) for t in xs] * max(1, REPS // copies)
        nbytes = x.numel() * 4 + mask_bytes[form]
        row = {"form": form, "events_ms": _events_ms(lambda: call(x)),
               "replay_ms": _replay_ms(warm),
               "replay_rotated_ms": _replay_ms(rotated),
               "profiler_ms": _profiler_ms(warm),
               "profiler_rotated_ms": _profiler_ms(rotated),
               "bound_ms": geo.bound_ms(nbytes, 0, geo.peak_bf16_tflops)}
        rows.append(row)
        print(f"dropout {m}x{n} bf16 {form}: events {row['events_ms']:.4f} "
              f"ms, replay {row['replay_ms']:.4f} (rotated "
              f"{row['replay_rotated_ms']:.4f}), profiler "
              f"{row['profiler_ms']:.4f} (rotated "
              f"{row['profiler_rotated_ms']:.4f}), bound "
              f"{row['bound_ms']:.4f}; {copies} copies of x rotated")
    print(json.dumps({"card": smi, "rows": rows}))
    return rows


if __name__ == "__main__":
    main()
