"""Dispatch tracing and profiler annotations.

The part of `libxsmm_tpu/utils/trace.py` the registry needs: `trace_event`,
the dispatch-level call tracing (reference: libxsmm_trace instrumented
builds, src/libxsmm_trace.c:106-111, enabled via the LIBXSMM_TRACE env),
and `annotate`, a named region in torch.profiler traces.
"""

from __future__ import annotations

import contextlib
from typing import Iterator


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """User-level named region (shows up in torch.profiler traces)."""
    import torch
    with torch.profiler.record_function(name):
        yield


_TRACE_SINK = None      # None = unresolved, False = disabled, else file obj


def _trace_sink():
    """Resolve the trace sink once per process: XSMM_TPU_TRACE=1 traces to
    stderr; XSMM_TPU_TRACE=<path> appends to that file."""
    global _TRACE_SINK
    if _TRACE_SINK is None:
        import os
        import sys
        val = os.environ.get("XSMM_TPU_TRACE", "")
        if not val or val == "0":
            _TRACE_SINK = False
        elif val == "1":
            _TRACE_SINK = sys.stderr
        else:
            try:
                _TRACE_SINK = open(val, "a")
            except OSError:
                _TRACE_SINK = sys.stderr
    return _TRACE_SINK


def trace_event(event: str, name: str, **fields) -> None:
    """Emit one dispatch-trace line (no-op unless XSMM_TPU_TRACE is set):

        xsmm_trace <epoch_us> tid=<thread> <event> <name> k=v ...

    Called by registry.Registry.dispatch on cache hits and kernel builds.
    Tracing must not alter program behaviour, so a failed write is
    dropped."""
    sink = _TRACE_SINK
    if sink is False:        # resolved-disabled: the dispatch hot path
        return
    sink = _trace_sink()
    if not sink:
        return
    try:
        import threading
        import time
        tail = "".join(f" {k}={v}" for k, v in fields.items())
        sink.write(f"xsmm_trace {int(time.time() * 1e6)} "
                   f"tid={threading.get_ident() & 0xffff} {event} "
                   f"{name}{tail}\n")
        sink.flush()
    except (OSError, ValueError):
        pass
