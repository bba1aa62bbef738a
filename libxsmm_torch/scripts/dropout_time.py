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
from typing import List, Optional, Sequence

import torch

if __package__:
    from . import timing
else:   # run by its path (a checkout first on PYTHONPATH): its directory
    import timing   # is sys.path[0]

SHAPE = (4096, 3072)
SEED, P = 7, 0.1
REPS = 20


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--forms", default="bytes,packed,none",
                    help="comma-separated mask forms to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dropout_time: needs a CUDA device")

    from libxsmm_torch.device import get_geometry
    from libxsmm_torch.kernels import eltwise as KE

    smi = timing.card()
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
        row = {"form": form, "events_ms": timing.events_ms(lambda: call(x)),
               "replay_ms": timing.graph_ms(warm),
               "replay_rotated_ms": timing.graph_ms(rotated),
               "profiler_ms": timing.device_ms(warm),
               "profiler_rotated_ms": timing.device_ms(rotated),
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
