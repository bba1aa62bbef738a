"""Runtime configuration for libxsmm_torch.

The counterpart of `libxsmm_tpu/config.py`: the reference's three-tier flag
system (env vars read in src/libxsmm_main.c:1089-1107 and the per-arch
tuning knobs behind include/libxsmm_cpuid.h:74-151) as one typed config
object, populated from environment variables at import, with programmatic
overrides (libxsmm_set_verbosity / libxsmm_set_target_arch,
include/libxsmm.h:74-93).

Environment variables (the same names as the JAX package's, prefixed
XSMM_TPU_, so one environment configures both):
  XSMM_TPU_VERBOSE     int  verbosity level; >=1 summary stats at exit,
                            >=2 per-dispatch logging.
  XSMM_TPU_TARGET      str  override the detected device ("h100", "cpu");
                            like LIBXSMM_TARGET retargeting.
  XSMM_TPU_CACHE       int  0 disables the dispatch cache (always rebuild);
                            like LIBXSMM_CACHE.
  XSMM_TPU_FALLBACK    int  0 disables the torch reference fallback when a
                            kernel builder rejects a descriptor (analogue of
                            LIBXSMM_DISABLE_*_REFERENCE_FALLBACK).
  XSMM_TPU_FSSPMDM_HINT       int  0 auto, 1 force sparse, 2 force dense.
  XSMM_TPU_FSSPMDM_DENSE_BIAS float  dense-kernel selection bias, default 0.1.
  XSMM_TPU_FSSPMDM_NTUNE      int  autotune reps, default 250.
  XSMM_TPU_DUMP        str  directory for kernel dumps (LIBXSMM_DUMP).
  XSMM_TPU_AUTOTUNE_CACHE     str  persistent autotune KV log.
  XSMM_TPU_REGISTRY_CAPACITY  int  registry capacity, default 131072.
  XSMM_TPU_REGISTRY_EVICT     int  1 enables LRU eviction at capacity.

Two fields of the JAX package have no counterpart here: `interpret`
(XSMM_TPU_INTERPRET, Pallas interpret mode — a kernel here follows the
device of its tensors, and a CPU tensor runs the plain torch version) and
`compilation_cache_dir` (XSMM_TPU_COMPILATION_CACHE, XLA's persistent
compile cache — PyTorch runs eagerly and the CUDA kernels are built once
per checkout by kernels/_build.py).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


@dataclasses.dataclass
class Config:
    verbose: int = 0
    target: Optional[str] = None          # device geometry override
    cache_enabled: bool = True
    fallback_enabled: bool = True         # torch reference fallback allowed
    fsspmdm_hint: int = 0                 # 0 auto | 1 sparse | 2 dense
    fsspmdm_dense_bias: float = 0.1
    fsspmdm_ntune: int = 250   # reference LIBXSMM_FSSPMDM_NTUNE default
    dump_dir: Optional[str] = None
    autotune_cache_path: Optional[str] = None   # persistent autotune KV log
    registry_capacity: int = 131072   # LIBXSMM_CAPACITY_REGISTRY analogue
    registry_evict: bool = False      # LRU eviction at capacity (opt-in; the
                                      # reference warns-and-keeps, main.c:2902)

    @staticmethod
    def from_env() -> "Config":
        return Config(
            verbose=_env_int("XSMM_TPU_VERBOSE", 0),
            target=os.environ.get("XSMM_TPU_TARGET") or None,
            cache_enabled=_env_int("XSMM_TPU_CACHE", 1) != 0,
            fallback_enabled=_env_int("XSMM_TPU_FALLBACK", 1) != 0,
            fsspmdm_hint=_env_int("XSMM_TPU_FSSPMDM_HINT", 0),
            fsspmdm_dense_bias=_env_float("XSMM_TPU_FSSPMDM_DENSE_BIAS", 0.1),
            fsspmdm_ntune=_env_int("XSMM_TPU_FSSPMDM_NTUNE", 250),
            dump_dir=os.environ.get("XSMM_TPU_DUMP") or None,
            autotune_cache_path=os.environ.get("XSMM_TPU_AUTOTUNE_CACHE")
            or None,
            registry_capacity=_env_int("XSMM_TPU_REGISTRY_CAPACITY", 131072),
            registry_evict=_env_int("XSMM_TPU_REGISTRY_EVICT", 0) != 0,
        )


CONFIG = Config.from_env()


def get_config() -> Config:
    return CONFIG


def set_verbosity(level: int) -> int:
    """Programmatic verbosity override (libxsmm_set_verbosity analogue)."""
    prev = CONFIG.verbose
    CONFIG.verbose = int(level)
    return prev


def set_target(target: Optional[str]) -> None:
    """Override the detected device (libxsmm_set_target_arch analogue).

    Invalidates the device-geometry cache so subsequent dispatches re-tile.
    """
    from . import device

    CONFIG.target = target
    device.invalidate_geometry_cache()
