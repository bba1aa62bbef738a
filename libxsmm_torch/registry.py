"""Dispatch cache and kernel registry.

The port of `libxsmm_tpu/registry.py`, the replacement for the reference's
code registry + thread cache (src/libxsmm_main.c: internal_registry :317,
internal_find_code :2730-2969, per-thread cache :292-302): descriptors are
frozen dataclasses (descriptor.py), so dispatch is a dict lookup under a lock
instead of crc32+memcmp over packed bytes; the "JIT build" step becomes a
kernel-builder call that returns a callable over torch tensors.

Also ports:
  * the user key-value registry (libxsmm_xregister/xdispatch/xrelease,
    src/libxsmm_main.c:3225-3313) with enumeration;
  * kernel introspection (libxsmm_get_kernel_info, :3004 — kind, nflops,
    is_reference_kernel);
  * registry stats + the at-exit statistic dump keyed by precision and
    size bucket (internal_print_statistic, :497-620; buckets sml<=13^3,
    med<=23^3, big<=64^3 per README.md:268-282).
"""

from __future__ import annotations

import atexit
import dataclasses
import functools
import threading
from collections import defaultdict
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

from .config import CONFIG
from .utils.trace import trace_event


@dataclasses.dataclass
class KernelInfo:
    """libxsmm_kernel_info analogue (include/libxsmm_typedefs.h:820-827)."""

    kind: str                    # "gemm" | "meltw" | "meqn" | "spgemm" | ...
    nflops: int = 0
    is_reference_kernel: bool = False   # True when served by the torch fallback


@dataclasses.dataclass
class Kernel:
    """A dispatched kernel: a bare callable plus introspection data.

    The two-phase contract of the reference (dispatch expensive+cached,
    invoke a bare call — documentation/libxsmm_tpp.md) holds: `fn` is a
    callable over torch tensors; invoking it is the hot path.
    """

    fn: Callable
    descriptor: Any
    info: KernelInfo
    name: str

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)

    # (module:function, args, kwargs) of the public entry point that made
    # this kernel (entry_point), so aot.load_kernel can make it again
    entry: Optional[Tuple[str, tuple, dict]] = None

    def lower_text(self, *args, device=None, **kwargs) -> str:
        """The port's counterpart of the reference's JIT code dump
        (negative LIBXSMM_VERBOSE, src/libxsmm_main.c internal_dump): the
        text of one call of this kernel on zeros shaped like the example
        args (tensors or meta tensors) on `device` — the aten operators it
        dispatched and, on the card, the CUDA kernels it launched with their
        resources and SASS (lowering.py). The JAX package lowers without
        running; this runs the call once."""
        from .lowering import lower_text
        return lower_text(self, args, kwargs, device)

    def dump(self, *args, device=None, **kwargs) -> Optional[str]:
        """Write lower_text's text into CONFIG.dump_dir (XSMM_TPU_DUMP) as
        <name>.cuda.txt; returns the file path, or None when dumping is
        disabled."""
        import os
        if not CONFIG.dump_dir:
            return None
        os.makedirs(CONFIG.dump_dir, exist_ok=True)
        path = os.path.join(CONFIG.dump_dir, f"{self.name}.cuda.txt")
        with open(path, "w") as f:
            f.write(self.lower_text(*args, device=device, **kwargs))
        return path


def entry_point(fn: Callable) -> Callable:
    """Decorate a public dispatch or create function: the Kernel it returns
    records (module:function, args, kwargs) of its first making."""
    where = f"{fn.__module__}:{fn.__qualname__}"

    @functools.wraps(fn)
    def make(*args, **kwargs):
        kernel = fn(*args, **kwargs)
        if isinstance(kernel, Kernel) and kernel.entry is None:
            kernel.entry = (where, args, kwargs)
        return kernel

    return make


class _Stats:
    def __init__(self):
        self.hits = 0
        self.builds = 0
        self.fallbacks = 0
        self.by_bucket: Dict[Tuple[str, str, str], int] = defaultdict(int)

    @staticmethod
    def bucket(m: int, n: int, k: int) -> str:
        mnk = (max(1, m) * max(1, n) * max(1, k)) ** (1.0 / 3.0)
        if mnk <= 13:
            return "sml"
        if mnk <= 23:
            return "med"
        if mnk <= 64:
            return "big"
        return "xxl"


class Registry:
    """Process-wide kernel cache + user key-value registry.

    Capacity mirrors LIBXSMM_CAPACITY_REGISTRY (src/libxsmm_main.h:17-18;
    override via XSMM_TPU_REGISTRY_CAPACITY). At capacity the default
    matches the reference — warn and keep growing (main.c:2902-2907 counts
    a collision; a dict has no fixed slots) — while long-running processes
    can opt into LRU eviction (XSMM_TPU_REGISTRY_EVICT=1): the kernel
    dict is insertion-ordered and hits refresh recency, so eviction drops
    the least-recently-dispatched kernel. Evicted kernels keep working for
    holders of the Kernel object; only the cache entry is dropped (a
    re-dispatch rebuilds; the CUDA library itself stays loaded)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._kernels: Dict[Any, Kernel] = {}
        self._user: Dict[bytes, Any] = {}
        self._stats = _Stats()
        self.evictions = 0

    @property
    def CAPACITY(self) -> int:
        return CONFIG.registry_capacity

    # -- kernel dispatch ---------------------------------------------------

    def dispatch(self, descriptor: Any,
                 builder: Callable[[Any], Kernel]) -> Kernel:
        """Return the cached kernel for `descriptor`, building on miss.

        Thread-safe; concurrent dispatch of the same descriptor returns the
        same Kernel object (the contract tests/threadsafety.c checks in the
        reference).
        """
        if CONFIG.cache_enabled:
            with self._lock:
                hit = self._kernels.get(descriptor)
                if hit is not None:
                    self._stats.hits += 1
                    if CONFIG.registry_evict:
                        # refresh recency (dicts are insertion-ordered)
                        self._kernels.pop(descriptor)
                        self._kernels[descriptor] = hit
                    trace_event("dispatch_hit", hit.name)
                    return hit
        import time as _time
        _t0 = _time.perf_counter()
        kernel = builder(descriptor)
        trace_event("dispatch_build", getattr(kernel, "name", "?"),
                    build_ms=round((_time.perf_counter() - _t0) * 1e3, 3))
        with self._lock:
            # lost-race check: first build wins, like the registry's atomic
            # slot publish (src/libxsmm_main.c:2853-2857)
            existing = self._kernels.get(descriptor)
            if existing is not None and CONFIG.cache_enabled:
                return existing
            if CONFIG.cache_enabled:
                if len(self._kernels) >= self.CAPACITY:
                    if CONFIG.registry_evict:
                        oldest = next(iter(self._kernels))
                        self._kernels.pop(oldest)
                        self.evictions += 1
                    elif CONFIG.verbose:
                        print("libxsmm_torch: registry capacity exceeded "
                              f"({self.CAPACITY}); kernels keep "
                              "accumulating (XSMM_TPU_REGISTRY_EVICT=1 "
                              "enables LRU eviction)")
                self._kernels[descriptor] = kernel
            self._stats.builds += 1
            if kernel.info.is_reference_kernel:
                self._stats.fallbacks += 1
            shape = getattr(descriptor, "shape", None)
            if shape is not None and hasattr(shape, "m"):
                key = (kernel.info.kind,
                       getattr(shape, "a_in_type",
                               getattr(shape, "in_type", None)),
                       _Stats.bucket(shape.m, shape.n, shape.k))
                self._stats.by_bucket[key] += 1
        if CONFIG.verbose >= 2:
            print(f"libxsmm_torch: built {kernel.name}")
        return kernel

    def release(self, descriptor: Any) -> None:
        """libxsmm_release_kernel analogue; evicts the cache entry."""
        with self._lock:
            self._kernels.pop(descriptor, None)
        _bump_memo_generation()

    # -- user key-value registry ------------------------------------------

    def xregister(self, key: bytes, value: Any) -> None:
        """Register an arbitrary binary key -> value (libxsmm_xregister)."""
        if not isinstance(key, (bytes, bytearray)):
            raise TypeError("registry keys must be bytes")
        with self._lock:
            if bytes(key) in self._user:
                raise KeyError("key already registered")
            self._user[bytes(key)] = value

    def xdispatch(self, key: bytes) -> Optional[Any]:
        with self._lock:
            return self._user.get(bytes(key))

    def xrelease(self, key: bytes) -> None:
        with self._lock:
            self._user.pop(bytes(key), None)

    def items(self) -> Iterator[Tuple[bytes, Any]]:
        """Enumeration (libxsmm_get_registry_begin/next analogue)."""
        with self._lock:
            return iter(list(self._user.items()))

    # -- introspection -----------------------------------------------------

    def get_registry_info(self) -> Dict[str, int]:
        """libxsmm_get_registry_info analogue."""
        with self._lock:
            return {
                "capacity": self.CAPACITY,
                "size": len(self._kernels) + len(self._user),
                "nkernels": len(self._kernels),
                "nuser": len(self._user),
                "hits": self._stats.hits,
                "builds": self._stats.builds,
                "fallbacks": self._stats.fallbacks,
                "evictions": self.evictions,
            }

    def print_statistic(self) -> None:
        """At-exit style stats dump (internal_print_statistic analogue)."""
        info = self.get_registry_info()
        print(f"libxsmm_torch registry: {info['nkernels']} kernels, "
              f"{info['hits']} hits, {info['builds']} builds, "
              f"{info['fallbacks']} reference fallbacks")
        with self._lock:
            rows = sorted(self._stats.by_bucket.items())
        for (kind, dtype, bucket), count in rows:
            print(f"  {kind:8s} {str(dtype):6s} {bucket:4s} {count}")

    def clear(self) -> None:
        with self._lock:
            self._kernels.clear()
            self._user.clear()
            self._stats = _Stats()
        _bump_memo_generation()


_REGISTRY: Optional[Registry] = None
_INIT_LOCK = threading.Lock()
_ATEXIT_REGISTERED = False

# ---------------------------------------------------------------------------
# Per-thread recent-dispatch cache — the reference's thread-local descriptor
# cache (src/libxsmm_main.c:292-302, LIBXSMM_CACHE_MAXSIZE): repeat
# dispatches from the same thread skip descriptor construction, the registry
# lock, and the full structural hash. Keys are the dispatch entry-point's
# raw argument tuple; invalidation is a global generation counter bumped by
# release()/clear()/finalize().
# ---------------------------------------------------------------------------

_TLS = threading.local()
_MEMO_GEN = [0]          # mutable cell shared by all threads
_MEMO_MAX = 512          # bound per thread (reference uses 4; dict is cheap)


def _bump_memo_generation() -> None:
    _MEMO_GEN[0] += 1


def memo_dispatch(registry: "Registry", key: Tuple,
                  make_descriptor: Callable[[], Any],
                  builder: Callable[[Any], Kernel]) -> Kernel:
    """Thread-cached dispatch: `key` is the entry-point argument tuple
    (hash-cheap — descriptor shapes memoize their hash); on miss the real
    descriptor is constructed and dispatched through `registry`."""
    if not CONFIG.cache_enabled:
        return registry.dispatch(make_descriptor(), builder)
    memo = getattr(_TLS, "memo", None)
    if memo is None or _TLS.gen != _MEMO_GEN[0]:
        memo = {}
        _TLS.memo, _TLS.gen = memo, _MEMO_GEN[0]
    hit = memo.get(key)
    if hit is not None:
        # relaxed counter, like the reference's statistics (no lock on the
        # thread-cache fast path)
        registry._stats.hits += 1
        trace_event("dispatch_hit", hit.name)
        return hit
    kernel = registry.dispatch(make_descriptor(), builder)
    if len(memo) >= _MEMO_MAX:
        memo.clear()
    memo[key] = kernel
    return kernel


def init() -> Registry:
    """libxsmm_init analogue: idempotent, lazy, thread-safe."""
    global _REGISTRY
    if _REGISTRY is None:
        with _INIT_LOCK:
            if _REGISTRY is None:
                _REGISTRY = Registry()
                if CONFIG.verbose:
                    # register ONCE per process: init() after finalize()
                    # would otherwise stack one duplicate dump hook per
                    # re-init cycle
                    global _ATEXIT_REGISTERED
                    if not _ATEXIT_REGISTERED:
                        atexit.register(_atexit_dump)
                        _ATEXIT_REGISTERED = True
                # crash diagnostics (reference installs SIGSEGV/SIGABRT
                # handlers that force-dump registry state and re-raise,
                # src/libxsmm_main.c:349,961-976): faulthandler gives the
                # same post-mortem value without altering signal disposition
                # for user code
                import faulthandler
                if not faulthandler.is_enabled():
                    try:
                        faulthandler.enable()
                    except (AttributeError, ValueError, OSError):
                        pass    # no usable stderr (embedded interpreters)
    return _REGISTRY


def finalize() -> None:
    """libxsmm_finalize analogue."""
    global _REGISTRY
    if _REGISTRY is not None:
        if CONFIG.verbose:
            _REGISTRY.print_statistic()
        _REGISTRY = None
        _bump_memo_generation()


def _atexit_dump() -> None:
    if _REGISTRY is not None and CONFIG.verbose:
        _REGISTRY.print_statistic()


def get_registry() -> Registry:
    return init()


def get_kernel_info(kernel: Kernel) -> KernelInfo:
    """libxsmm_get_kernel_info analogue."""
    return kernel.info


def get_mmkernel_info(kernel: Kernel) -> KernelInfo:
    """libxsmm_get_mmkernel_info analogue (include/libxsmm.h): typed view
    of get_kernel_info for GEMM-family kernels."""
    if not kernel.info.kind.startswith(("gemm", "brgemm", "pspgemm",
                                        "spgemm", "fsspmdm", "tilecfg")):
        raise ValueError(f"not a matmul-family kernel: {kernel.info.kind}")
    return kernel.info


def get_meltwkernel_info(kernel: Kernel) -> KernelInfo:
    """libxsmm_get_meltwkernel_info analogue: typed view for eltwise TPPs."""
    if kernel.info.kind not in ("meltw", "meqn"):
        raise ValueError(f"not an eltwise kernel: {kernel.info.kind}")
    return kernel.info


def get_registry_begin():
    """libxsmm_get_registry_begin analogue (src/libxsmm_main.c:3197):
    returns an iterator over the user key-value entries; advance it with
    get_registry_next. The pair replaces the C begin/next pointer walk."""
    return get_registry().items()


def get_registry_next(iterator):
    """libxsmm_get_registry_next analogue: the next (key, value) entry or
    None at the end of the registry."""
    return next(iterator, None)
