"""RNG utilities.

The port of `libxsmm_tpu/rng.py`: the API shape of the reference's
src/libxsmm_rng.c (xoshiro128+ scalar and vectorized float sequences with
external-state variants, :123-239) on torch generators. An explicit
`torch.Generator` takes the place of the JAX package's threefry key. The
sequences are not the reference's, nor the JAX package's: as the reference
itself ships distinct scalar and AVX-512 streams, only the distribution is
contractual. `lsfr_i32` is the exception: it is the reference's xoshiro128+
step bit for bit, the host oracle of the stochastic-rounding contract.

Device: a state lives on the device it was created for (default: the GPU,
raising without one); pass device="cpu" for a host stream.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


class RngState:
    """libxsmm_rng_create_extstate analogue: an explicit, advanceable
    state handle (a torch.Generator) for reproducible sequences."""

    def __init__(self, seed: int, device=None):
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)

    def split(self) -> "RngState":
        """A new, independent state seeded from this one's stream (which
        advances)."""
        seed = int(torch.randint(0, 2 ** 62, (), generator=self.generator,
                                 device=self.device))
        return RngState(seed, self.device)


def set_seed(seed: int, device=None) -> RngState:
    """libxsmm_rng_set_seed analogue: returns the process-default state."""
    global _default_state
    _default_state = RngState(seed, device)
    return _default_state


# created lazily, on first use, so that importing the module touches no
# device
_default_state = None


def _default() -> RngState:
    global _default_state
    if _default_state is None:
        _default_state = RngState(25071975)
    return _default_state


def f32_seq(shape, state: RngState = None) -> torch.Tensor:
    """libxsmm_rng_f32_seq: uniform [0,1) float32 of the given shape."""
    st = state or _default()
    return torch.rand(shape, generator=st.generator, device=st.device,
                      dtype=torch.float32)


def _u32(st: RngState, shape) -> torch.Tensor:
    """Uniform u32 draws, held in int64."""
    return torch.randint(0, 2 ** 32, shape, generator=st.generator,
                         device=st.device, dtype=torch.int64)


def u32_seq(shape, state: RngState = None) -> torch.Tensor:
    """Uniform draws in [0, 2^32), held in int64 (torch has no full-range
    unsigned 32-bit arithmetic)."""
    return _u32(state or _default(), shape)


def rand_u32(state: RngState = None) -> int:
    """libxsmm_rng_u32-style scalar draw in [0, 2^32)."""
    return int(_u32(state or _default(), ()))


def rand_u64(state: RngState = None) -> int:
    """libxsmm_rng_u64-ish scalar draw: two u32 draws, high then low."""
    hi, lo = (int(v) for v in _u32(state or _default(), (2,)))
    return hi << 32 | lo


def create_extstate(seed: int, device=None) -> RngState:
    """libxsmm_rng_create_extstate (src/libxsmm_rng.c:172-189): an explicit
    state handle independent of the process-default stream."""
    return RngState(seed, device)


def get_extstate_size(device=None) -> int:
    """libxsmm_rng_get_extstate_size: bytes of the port's external state,
    the torch.Generator's state on `device` (default: the GPU's Philox
    seed and offset; the CPU's is the Mersenne twister's)."""
    return int(torch.Generator(device=resolve_device(device))
               .get_state().numel())


def destroy_extstate(state: RngState) -> None:
    """libxsmm_rng_destroy_extstate: garbage-collected; kept for API
    parity."""
    state.generator = None


def rng_f64(state: RngState = None) -> float:
    """libxsmm_rng_f64 (src/libxsmm_utils.c:76): one uniform double in
    [0,1)."""
    st = state or _default()
    return float(torch.rand((), generator=st.generator, device=st.device,
                            dtype=torch.float64))


def rng_seq(nbytes: int, state: RngState = None) -> bytes:
    """libxsmm_rng_seq (src/libxsmm_utils.c:50): nbytes of pseudo-random
    bytes (returned, not written through a pointer)."""
    if nbytes <= 0:
        return b""
    words = (nbytes + 3) // 4
    buf = _u32(state or _default(), (words,)).cpu().numpy().astype(np.uint32)
    return buf.tobytes()[:nbytes]


def lsfr_i32(rng_state: np.ndarray, seed_idx: int = 0) -> int:
    """libxsmm_lsfr_i32 (src/libxsmm_lpflt_quant.c:303): one xoshiro128+
    step over the reference's 16-lane strided state block (4 state words at
    stride 16 starting at seed_idx). Mutates rng_state (a numpy uint32
    array) IN PLACE and returns the u32 draw, bit-exact to the reference
    recurrence."""
    s = np.asarray(rng_state, np.uint32)
    ld = 16
    s0, s1, s2, s3 = (s[seed_idx + 0 * ld], s[seed_idx + 1 * ld],
                      s[seed_idx + 2 * ld], s[seed_idx + 3 * ld])
    with np.errstate(over="ignore"):
        t = np.uint32(s0 + s3)
        out = np.uint32(((t << np.uint32(7)) | (t >> np.uint32(25))) + s0)
        t1 = np.uint32(s1 << np.uint32(9))
        s2 ^= s0
        s3 ^= s1
        s1 ^= s2
        s0 ^= s3
        s2 ^= t1
        s3 = np.uint32((s3 << np.uint32(11)) | (s3 >> np.uint32(21)))
    rng_state[seed_idx + 0 * ld] = s0
    rng_state[seed_idx + 1 * ld] = s1
    rng_state[seed_idx + 2 * ld] = s2
    rng_state[seed_idx + 3 * ld] = s3
    return int(out)
