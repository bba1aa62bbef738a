"""Host-side synchronization utilities.

The port's own copy of `libxsmm_tpu/utils/sync.py`: the API shape of the
reference's sync layer (src/libxsmm_sync.c, include/libxsmm_sync.h,
src/libxsmm_barrier.c) for USER thread pools that parallelize around
kernels ("the library is thread-safe; you bring the threads"). On the
device, ordering is the CUDA streams' job; these primitives serve the host
side: test drivers, data loaders, and multi-threaded dispatch loops.
"""

from __future__ import annotations

import os
import threading

# LIBXSMM_NTHREADS_MAX analogue (src/libxsmm_main.h:19): tid wraps at this.
NTHREADS_MAX = 1024

_tid_lock = threading.Lock()
_tid_next = 0
_tls = threading.local()


def get_pid() -> int:
    """libxsmm_get_pid (src/libxsmm_sync.c:37)."""
    return os.getpid()


def get_tid() -> int:
    """libxsmm_get_tid (src/libxsmm_sync.c:65): a stable, dense thread id
    assigned on first call per thread, wrapping at NTHREADS_MAX."""
    tid = getattr(_tls, "tid", None)
    if tid is None:
        global _tid_next
        with _tid_lock:
            tid = _tid_next % NTHREADS_MAX
            _tid_next += 1
        _tls.tid = tid
    return tid


_stdio_lock = threading.RLock()


def stdio_acquire() -> None:
    """libxsmm_stdio_acquire (src/libxsmm_generator.c:610): serialize
    console output across this process's threads (reentrant)."""
    _stdio_lock.acquire()


def stdio_release() -> None:
    """libxsmm_stdio_release (src/libxsmm_generator.c:625)."""
    _stdio_lock.release()


class Barrier:
    """libxsmm_barrier analogue (src/libxsmm_barrier.c:16-40).

    The reference builds a two-level sense-reversal tree (threads spin on a
    per-core flag, core masters on a cross-core flag) to keep spinning
    traffic core-local. A Python thread pool has no such cache topology to
    exploit (the GIL serializes the spin anyway), so the tree collapses to
    one process-level generation barrier with the same API and blocking
    semantics; ncores*nthreads_per_core fixes the team size exactly like
    libxsmm_barrier_create(ncores, nthreads_per_core).
    """

    def __init__(self, ncores: int, nthreads_per_core: int = 1):
        if ncores <= 0 or nthreads_per_core <= 0:
            raise ValueError("barrier team must be positive")
        self.ncores = ncores
        self.nthreads_per_core = nthreads_per_core
        self.nthreads = ncores * nthreads_per_core
        self._barrier = threading.Barrier(self.nthreads)
        self._initialized: set = set()
        self._lock = threading.Lock()

    def init(self, tid: int) -> None:
        """libxsmm_barrier_init: per-thread registration (tid bounds are
        the only state the flat barrier needs)."""
        if not 0 <= tid < self.nthreads:
            raise ValueError(f"tid {tid} outside team of {self.nthreads}")
        with self._lock:
            self._initialized.add(tid)

    def wait(self, tid: int) -> None:
        """libxsmm_barrier_wait: block until the whole team arrives."""
        if not 0 <= tid < self.nthreads:
            raise ValueError(f"tid {tid} outside team of {self.nthreads}")
        self._barrier.wait()

    def destroy(self) -> None:
        """libxsmm_barrier_destroy: release waiters and invalidate."""
        self._barrier.abort()


def barrier_create(ncores: int, nthreads_per_core: int = 1) -> Barrier:
    """libxsmm_barrier_create (include/utils/libxsmm_barrier.h:21)."""
    return Barrier(ncores, nthreads_per_core)


def barrier_init(barrier: Barrier, tid: int) -> None:
    """libxsmm_barrier_init (include/utils/libxsmm_barrier.h:23)."""
    barrier.init(tid)


def barrier_wait(barrier: Barrier, tid: int) -> None:
    """libxsmm_barrier_wait (include/utils/libxsmm_barrier.h:25)."""
    barrier.wait(tid)


def barrier_destroy(barrier: Barrier) -> None:
    """libxsmm_barrier_destroy (include/utils/libxsmm_barrier.h:27)."""
    barrier.destroy()
