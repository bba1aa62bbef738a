"""Scalar math helpers.

The port's own copy of `libxsmm_tpu/utils/mathx.py` (that module needs
nothing of JAX, but importing it runs libxsmm_tpu/__init__.py, which does):
the reference's math utilities (include/utils/libxsmm_math.h:22-57,
src/libxsmm_math.c): gcd/lcm, integer cbrt/sqrt bounds, exp2 for 8-bit
exponents (isqrt/icbrt/sexp2 family), plus the LIBXSMM_MATDIFF-style epsilon
log used to calibrate test margins. Host code on Python numbers and numpy.
"""

from __future__ import annotations

import math
import os
from typing import Optional


def gcd(a: int, b: int) -> int:
    """Greatest common divisor; GCD(0, 0) == 1 (reference corner case)."""
    if a == 0 and b == 0:
        return 1
    return math.gcd(a, b)


def lcm(a: int, b: int) -> int:
    return abs(a * b) // gcd(a, b) if (a or b) else 0


def isqrt2(x: int) -> int:
    """Largest i with i*i <= x (libxsmm_isqrt2 semantics)."""
    return math.isqrt(max(0, x))


def icbrt2(x: int) -> int:
    """Largest i with i^3 <= x."""
    if x <= 0:
        return 0
    i = round(x ** (1.0 / 3.0))
    while i ** 3 > x:
        i -= 1
    while (i + 1) ** 3 <= x:
        i += 1
    return i


def sexp2(n: int) -> float:
    """2^n for small integer n (libxsmm_sexp2_u8/i8 family)."""
    return float(2.0 ** n)


def sexp2_u8(x: int) -> float:
    """libxsmm_sexp2_u8 (include/utils/libxsmm_math.h:44): 2^x for an
    unsigned 8-bit exponent, bit-accurate in f32 (inf beyond f32 range)."""
    if not 0 <= x <= 255:
        raise ValueError("sexp2_u8 takes an unsigned 8-bit value")
    import numpy as np
    with np.errstate(over="ignore"):
        return float(np.exp2(np.float32(x)))


def sexp2_i8(x: int) -> float:
    """libxsmm_sexp2_i8 (src/libxsmm_utils.c:219): 2^x for a signed 8-bit
    exponent; subnormal/zero below f32 range, inf above."""
    if not -128 <= x <= 127:
        raise ValueError("sexp2_i8 takes a signed 8-bit value")
    import numpy as np
    with np.errstate(over="ignore", under="ignore"):
        return float(np.exp2(np.float32(x)))


def sexp2_i8i(x: int) -> float:
    """libxsmm_sexp2_i8i (src/libxsmm_utils.c:248): int-typed convenience
    over sexp2_i8 with the same 8-bit domain check."""
    return sexp2_i8(x)


def icbrt_u32(x: int) -> int:
    """libxsmm_icbrt_u32 semantics (src/libxsmm_utils.c:99): floor cube
    root of an unsigned 32-bit integer (the reference uses the classic
    shift-subtract digit recurrence; exact floor is the contract)."""
    return icbrt2(int(x) & 0xFFFFFFFF)


def icbrt_u64(x: int) -> int:
    """libxsmm_icbrt_u64 semantics (src/libxsmm_utils.c:88): floor cube
    root of an unsigned 64-bit integer."""
    return icbrt2(int(x) & 0xFFFFFFFFFFFFFFFF)


def stanh_pade78(x: float) -> float:
    """libxsmm_stanh_pade78 (include/utils/libxsmm_math.h:57): fast tanh
    via the degree-7/8 Pade rational with hard +-1 clamps beyond |x|>4.97.
    Accepts scalars or arrays (the host-side oracle used by tests and
    tools).

    NOTE the clamp compares |x|, like the reference's VECTORIZED tanh
    kernels (libxsmm_intrinsics_x86.h) — the reference's scalar header has
    a quirk that compares the RATIO instead (which never exceeds ~1, so
    its clamp is dead and the rational decays toward 0 for large |x|);
    faithfully porting that quirk would make the advertised oracle wrong
    beyond |x| ~ 10."""
    import numpy as np
    xf = np.asarray(x, np.float32)
    x2 = xf * xf
    nom = ((np.float32(36.0) * x2 + np.float32(6930.0)) * x2
           + np.float32(270270.0)) * x2 + np.float32(2027025.0)
    nom = nom * xf
    den = (((x2 + np.float32(630.0)) * x2 + np.float32(51975.0)) * x2
           + np.float32(945945.0)) * x2 + np.float32(2027025.0)
    r = nom / den
    r = np.where(xf > np.float32(4.97), np.float32(1.0), r)
    r = np.where(xf < np.float32(-4.97), np.float32(-1.0), r)
    return float(r) if np.isscalar(x) or getattr(x, "ndim", 0) == 0 else r


def widen_u32i64(value: int) -> int:
    """libxsmm_widen_u32i64 (include/libxsmm_macros.h:652): u32 -> i64."""
    return int(value) & 0xFFFFFFFF


def widen_u32u64(value: int) -> int:
    """libxsmm_widen_u32u64 (include/libxsmm_macros.h:653): u32 -> u64."""
    return int(value) & 0xFFFFFFFF


def isqrt_u64(x: int) -> int:
    """Largest y with y*y <= x (libxsmm_isqrt_u64,
    src/libxsmm_math.c:508-515)."""
    return math.isqrt(max(0, int(x)))


def isqrt_u32(x: int) -> int:
    """32-bit variant (libxsmm_isqrt_u32, src/libxsmm_math.c:518-526)."""
    return math.isqrt(max(0, int(x) & 0xFFFFFFFF))


def primes_u32(num: int) -> list:
    """Prime factorization, smallest factor first (libxsmm_primes_u32,
    src/libxsmm_generator.c:495-521). Returns the factor
    list (the reference fills a caller array and returns the count)."""
    c = int(num)
    out = []
    if c > 0:
        while c % 2 == 0:
            out.append(2)
            c //= 2
        i = 3
        while i * i <= c:
            while c % i == 0:
                out.append(i)
                c //= i
            i += 2
        if c > 1 and out:
            out.append(c)
    return out


def _divisors(product: int) -> list:
    """All divisors of product, from its prime factorization."""
    divs = [1]
    for p in primes_u32(product):
        divs += [d * p for d in divs]
    return sorted(set(divs))


def product_limit(product: int, limit: int, is_lower: bool = False) -> int:
    """libxsmm_product_limit (src/libxsmm_generator.c:578-608):
    the largest divisor of `product` that is <= `limit` (is_lower false), or
    the smallest blocking >= `limit` (is_lower true; falls back to a 2x-wide
    divisor search, then `product` itself / the rounded-up multiple).

    Exact divisor search here — the reference's capped DP "can miss best
    solution" above its table limit (its own comment); semantics-compatible.
    """
    product = int(product)
    limit = int(limit)
    if limit > 1:
        result = 1
        for d in _divisors(product):
            if d <= limit:
                result = d
            else:
                break
    else:
        result = limit
    if is_lower:
        if limit < product:
            if result < limit:
                wide = 1
                for d in _divisors(product):
                    if d <= 2 * limit - 1:
                        wide = d
                    else:
                        break
                result = wide
            if result < limit:
                result = product
        elif product:
            result = ((limit + product - 1) // product) * product
        else:
            result = 0
    elif product < result:
        result = product
    return result


def isqrt2_u32(x: int) -> int:
    """Largest FACTOR of x that is <= sqrt(x) (libxsmm_isqrt2_u32,
    src/libxsmm_math.c:529-532 — product_limit over isqrt_u32)."""
    return product_limit(x, isqrt_u32(x), False)


def coprime(n: int, minco: int) -> int:
    """A co-prime R of N with R <= minco (libxsmm_coprime,
    src/libxsmm_math.c:470-499). Contract-equivalent
    implementation: the largest r <= minco with gcd(r, n) == 1 (the
    reference's scan may select a different valid co-prime);
    coprime(0|1, ·) == 0 per the header note."""
    n = int(n)
    if n <= 1:
        return 0
    for r in range(min(int(minco), n - 1), 0, -1):
        if math.gcd(r, n) == 1:
            return r
    return 1


def coprime2(n: int) -> int:
    """Co-prime of N not exceeding sqrt(N) (libxsmm_coprime2,
    src/libxsmm_math.c:502-505)."""
    return coprime(n, isqrt_u64(n))


def remainder(a: int, b: int, limit: Optional[int] = None,
              remainder_target: Optional[int] = None) -> int:
    """libxsmm_remainder (src/libxsmm_generator.c:472-492):
    smallest multiple of b (>= a-normalized start) whose remainder modulo a
    is minimal (or <= remainder_target), optionally bounded by limit.
    Example from the reference header: remainder(23, 8) == 184."""
    a, b = int(a), int(b)
    ci = (((a + b - 1) // b) * b) if (b < a and b != 0) else b
    c = a * ci
    if limit is not None and (b == 0 or (limit // b) * b < a):
        limit = None
    if a >= 1:
        r = a - 1
        target = remainder_target if remainder_target is not None else 0
        while target < r and (limit is None or ci <= limit):
            ri = ci % a
            if ri < r:
                c = ci
                r = ri
            ci += b
    return c


def kahan_sum(value: float, accumulator: float, compensation: float):
    """Compensated summation step (libxsmm_kahan_sum,
    src/libxsmm_math.c:535): returns
    (new_accumulator, new_compensation). The C API mutates pointers; the
    Python contract returns the updated pair."""
    y = value - compensation
    t = accumulator + y
    comp = (t - accumulator) - y
    return t, comp


def dsqrt(x: float) -> float:
    """libxsmm_dsqrt (src/libxsmm_math.c:914)."""
    return math.sqrt(x)


def ssqrt(x: float) -> float:
    """libxsmm_ssqrt (src/libxsmm_math.c:935): f32-rounded sqrt."""
    import numpy as np
    return float(np.float32(math.sqrt(np.float32(x))))


def nearbyint(x: float) -> float:
    """Round-half-to-even (libxsmm_nearbyint, src/libxsmm_math.c:955)."""
    return float(round(x))


def nearbyintf(x: float) -> float:
    """f32 variant (libxsmm_nearbyintf, src/libxsmm_math.c:993)."""
    import numpy as np
    return float(np.float32(round(float(np.float32(x)))))


def matdiff_log(epsilon: float, path: Optional[str] = None,
                note: str = "") -> None:
    """Append a measured epsilon to a calibration log, mirroring the
    LIBXSMM_MATDIFF env-file behavior (src/libxsmm_math.c:331-370):
    test drivers record their achieved tolerance so margins can be tuned.
    Path from arg or XSMM_TPU_MATDIFF env; silently no-op when unset."""
    path = path or os.environ.get("XSMM_TPU_MATDIFF")
    if not path:
        return
    if os.path.isdir(path):
        path = os.path.join(path, "libxsmm_matdiff.log")
    with open(path, "a") as f:
        f.write(f"{epsilon:.17g}{' ' + note if note else ''}\n")
