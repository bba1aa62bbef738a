"""GPU device model: detection + geometry table.

The counterpart of `libxsmm_tpu/device.py` (itself the replacement for the
reference's CPUID layer, src/libxsmm_cpuid_x86.c, include/libxsmm_cpuid.h:
23-59): instead of ISA ids and vector lengths, a per-device geometry (SMs,
shared memory per block, L2, memory rate, peak rates) that the kernel
wrappers size their launches by and that measurements state bounds against.

Device policy of the port: entry points run on the card unless the caller
asks for the CPU. `default_device()` is "cuda" and raises when no GPU is
present — it never quietly returns the CPU. A kernel follows the device of
its input tensors.

Retargeting: XSMM_TPU_TARGET / config.set_target override detection, like
LIBXSMM_TARGET retargets the JIT (include/libxsmm.h:84-85).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .config import CONFIG


@dataclasses.dataclass(frozen=True)
class GpuGeometry:
    """Per-device hardware model (public data-sheet numbers, dense rates)."""

    name: str
    num_sms: int = 1
    smem_per_block: int = 48 * 1024      # bytes a block may use
    l2_bytes: int = 0
    hbm_gbps: float = 50.0               # device memory rate, GB/s
    peak_bf16_tflops: float = 1.0        # tensor cores, bf16/fp16 inputs
    peak_f32_tflops: float = 1.0         # CUDA cores, f32 FMA
    warp: int = 32

    def bound_ms(self, nbytes: int, flops: int, peak_tflops: float) -> float:
        """Least time for the work: the larger of bytes over the memory
        rate and operations over the given peak rate, in milliseconds."""
        return max(nbytes / (self.hbm_gbps * 1e9),
                   flops / (peak_tflops * 1e12)) * 1e3

    def bound_by(self, nbytes: int, flops: int, peak_tflops: float) -> str:
        t_bytes = nbytes / (self.hbm_gbps * 1e9)
        t_ops = flops / (peak_tflops * 1e12)
        return "bytes" if t_bytes >= t_ops else "operations"


# NVIDIA's data sheet for the H100 SXM (dense rates, 700 W power limit).
GEOMETRY_TABLE = {
    "h100": GpuGeometry("h100", num_sms=132, smem_per_block=232448,
                        l2_bytes=50 * 2**20, hbm_gbps=3350.0,
                        peak_bf16_tflops=989.0, peak_f32_tflops=67.0),
    # the CPU runs the plain torch versions; no rates are promised
    "cpu": GpuGeometry("cpu"),
}


def _detect() -> str:
    # the table's only GPU entry: the kernels are built for sm_90a (Hopper)
    return "h100" if torch.cuda.is_available() else "cpu"


_cache: dict = {}


def invalidate_geometry_cache() -> None:
    _cache.clear()


def get_geometry() -> GpuGeometry:
    """Detected (or overridden) geometry for the current process."""
    key = CONFIG.target or "auto"
    if key not in _cache:
        if CONFIG.target:
            name = str(CONFIG.target).lower()
            if name not in GEOMETRY_TABLE:
                raise ValueError(
                    f"unknown XSMM_TPU_TARGET {CONFIG.target!r} "
                    f"(known: {sorted(GEOMETRY_TABLE)})")
        else:
            name = _detect()
        _cache[key] = GEOMETRY_TABLE[name]
    return _cache[key]


def on_gpu() -> bool:
    """True when a CUDA device is present."""
    return torch.cuda.is_available()


def default_device() -> torch.device:
    """The device entry points create tensors on when the caller names
    none: the first CUDA device. Raises without a GPU — pass device="cpu"
    to run on the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is present; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device, or default_device() when None."""
    return default_device() if device is None else torch.device(device)


# Numeric arch ids, the libxsmm_get/set_target_archid analogue
# (include/libxsmm_cpuid.h:23-59 numbers its ISAs; here the CUDA compute
# capability times 1000, the kernels' sm_90a target).
ARCHID_CPU = 0
ARCHIDS = {"cpu": ARCHID_CPU, "h100": 9000}
_ARCHID_NAMES = {v: k for k, v in ARCHIDS.items()}


def get_target_archid() -> int:
    """libxsmm_get_target_archid analogue (include/libxsmm.h:72-79)."""
    return ARCHIDS.get(get_geometry().name, ARCHID_CPU)


def set_target_archid(archid: Optional[int]) -> None:
    """libxsmm_set_target_archid analogue: retarget the geometry table by
    numeric id (None/0 restores auto-detect, like LIBXSMM_TARGET)."""
    from .config import set_target
    if archid in (None, 0):
        set_target(None)
        return
    name = _ARCHID_NAMES.get(int(archid))
    if name is None:
        raise ValueError(f"unknown archid {archid}; known: {ARCHIDS}")
    set_target(name)


def cpuid_name(archid: int) -> str:
    """libxsmm_cpuid_name analogue (src/libxsmm_cpuid_x86.c:443)."""
    name = _ARCHID_NAMES.get(int(archid))
    if name is None:
        raise ValueError(f"unknown archid {archid}; known: {ARCHIDS}")
    return name


def cpuid_id(arch: str) -> int:
    """libxsmm_cpuid_id analogue (src/libxsmm_cpuid_x86.c:552): device name
    -> numeric target id (0 == unknown)."""
    return ARCHIDS.get(str(arch).lower(), 0)


def cpuid_dot_pack_factor(itemsize_or_dtype) -> int:
    """libxsmm_cpuid_dot_pack_factor analogue (src/libxsmm_cpuid_x86.c:775):
    elements of the given dtype packed per 32-bit contraction lane (f32 ->
    1, 16-bit -> 2, 8-bit -> 4; the VNNI factor, and the packing of the
    GPU's dp2a/dp4a and tensor-core k-steps). Accepts an itemsize, a torch
    dtype, or a Datatype enum member."""
    item = itemsize_or_dtype
    if hasattr(item, "value") and isinstance(getattr(item, "value"), str):
        from .dtypes import to_torch
        item = to_torch(item)
    if isinstance(item, torch.dtype):
        item = item.itemsize
    return {4: 1, 2: 2, 1: 4}.get(int(item), 1)


def cpuid_x86(info=None) -> int:
    """libxsmm_cpuid_x86 analogue: the GPU is never an x86 JIT target, so
    this returns 0 (the reference's LIBXSMM_TARGET_ARCH_UNKNOWN)."""
    del info
    return 0


def cpuid_arm(info=None) -> int:
    """libxsmm_cpuid_arm analogue: see cpuid_x86, returns 0."""
    del info
    return 0


def cpuid_rv64(info=None) -> int:
    """libxsmm_cpuid_rv64 analogue: see cpuid_x86, returns 0."""
    del info
    return 0


def cpuid_vlen32(archid: Optional[int] = None) -> int:
    """libxsmm_cpuid_vlen32 analogue (include/libxsmm_cpuid.h:123): 32-bit
    lanes per vector instruction — a warp's 32 threads here (archid
    accepted for signature parity)."""
    del archid
    return get_geometry().warp
