"""FsSpMDM: fixed-sparsity sparse-A x dense-B with create-time autotune.

The port of `libxsmm_tpu/ops/fsspmdm.py`, the semantics of the reference's
src/libxsmm_fsspmdm.c, the north-star workload (PyFR/GiMMiK spectral-element
operators):

  create(N, a_dense, alpha, beta)  -> handle     (:24-489)
  execute(handle, B[, C])          -> C          (:491-515)

create() builds both candidates on the handle's device (default: the GPU,
raising without one; device="cpu" for the CPU) and times them there, then
keeps the winner:
  * dense: A with alpha folded in, stored on the device, one product (a
    plain product the reference leaves to XLA, so torch.matmul here, at
    full precision: no TF32);
  * sparse: the pattern- and values-baked ELL kernel of
    create_spgemm_csr_areg.

Selection applies a dense bias (default 10%, XSMM_TPU_FSSPMDM_DENSE_BIAS;
the reference's LIBXSMM_FSSPMDM_DENSE_BIAS :16-17) and honours the hint
(XSMM_TPU_FSSPMDM_HINT, read at create: 0 auto | 1 sparse | 2 dense;
LIBXSMM_FSSPMDM_HINT :35-36). A first tune takes XSMM_TPU_FSSPMDM_NTUNE
reps (default 250, :19-21) per window. The measured dense/sparse ratios
persist in the autotune KV log (XSMM_TPU_AUTOTUNE_CACHE, native.py) as a
history capped at 9; each create adds one fresh ratio and decides on the
median, so a single distorted window cannot flip a persisted pick.

`_bench_candidates` times with CUDA events on the card (utils.timer.
bench_chain_interleaved) and on the host clock for a CPU handle; it is
module-level so tests can replace it, as the reference's tests do. Alpha is
folded into A's values (:196-236); beta must be 0 or 1 (:80-120).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import CONFIG, _env_int
from ..descriptor import GemmFlags, GemmShape
from ..device import resolve_device
from ..dtypes import Datatype, to_torch
from ..interop import tensor_from_numpy
from ..registry import Kernel, KernelInfo
from .eltwise import load_operand
from .sparse import CsrMatrix, create_spgemm_csr_areg

_HISTORY_CAP = 9
# numpy dtype name -> Datatype of the handle (bfloat16: ml_dtypes' arrays)
_NP_TYPES = {"float64": Datatype.F64, "float32": Datatype.F32,
             "bfloat16": Datatype.BF16, "float16": Datatype.F16}


@dataclasses.dataclass
class Fsspmdm:
    """Handle mirroring libxsmm_fsspmdm (include/libxsmm_fsspmdm.h:17-24)."""

    m: int
    n: int
    k: int
    beta: int
    kernel: Kernel
    kind: str                 # "dense" | "sparse"
    nnz: int
    tuned_us: dict            # per-candidate measurements

    def execute(self, b, c=None):
        """C = A @ B (+ C if beta=1); b: (k, n)."""
        if self.beta == 0:
            return self.kernel(b)
        if c is None:
            raise ValueError("beta=1 requires the C operand")
        return self.kernel(b, c)

    def __call__(self, b, c=None):
        return self.execute(b, c)


def _autotune_cache():
    """The persistent KV log for autotune picks (XSMM_TPU_AUTOTUNE_CACHE);
    None when no path is set or the native library is unavailable."""
    path = CONFIG.autotune_cache_path
    if not path:
        return None
    try:
        from ..native import PersistentKv
        return PersistentKv(path)
    except RuntimeError:
        return None


def _bench_candidates(cands, reps: int, rounds: int = 3):
    """(microseconds per call of each (fn, args) candidate, the median of
    the same-round time ratios candidate 0 / candidate 1), their windows
    interleaved round by round so the ratio survives a change of the
    device's state between rounds; a median of paired rounds, not a ratio
    of minima, so one lucky window cannot decide a marginal pick."""
    from ..utils.timer import bench_chain_interleaved, bench_host_interleaved
    on_cuda = any(a.is_cuda for _fn, args in cands for a in args
                  if isinstance(a, torch.Tensor))
    bench = bench_chain_interleaved if on_cuda else bench_host_interleaved
    times, rows = bench([(fn, args) for fn, args in cands], reps=reps,
                        rounds=rounds, per_round=True)
    ratio = None
    if len(rows) == 2:
        pairs = sorted(a / b for a, b in zip(rows[0], rows[1]) if b > 0)
        if pairs:
            ratio = pairs[len(pairs) // 2]
    return [t * 1e6 for t in times], ratio


def _dense_kernel(av: torch.Tensor, shape: GemmShape, dev) -> Kernel:
    """Candidate 1: the stored A (alpha folded in) times B, one product in
    the compute type."""
    m, n, k = shape.m, shape.n, shape.k
    comp = torch.float64 if shape.comp_type == Datatype.F64 else torch.float32
    out_dt = to_torch(shape.out_type)
    a_c = av.to(comp)

    def fn(b, c=None):
        acc = torch.matmul(a_c, load_operand(b, dev).to(comp))
        if c is not None:
            acc = acc + load_operand(c, dev).to(comp)
        return acc.to(out_dt)

    return Kernel(fn=fn, descriptor=("fsspmdm_dense", shape, dev),
                  info=KernelInfo(kind="fsspmdm_dense", nflops=2 * m * n * k),
                  name=f"fsspmdm_dense_{m}x{n}x{k}")


def fsspmdm_create(n: int, a_dense, alpha: float = 1.0, beta: int = 0,
                   dtype: Optional[Datatype] = None,
                   device=None) -> Fsspmdm:
    """libxsmm_fsspmdm_create analogue.

    a_dense: (m, k) host array whose ZERO PATTERN is fixed for the handle's
    lifetime; alpha is folded into the stored values (:196-236). An
    explicit `dtype` governs the stored A (both candidates), whatever the
    array's own type, as the reference's handles are typed."""
    a = np.asarray(a_dense)
    m, k = a.shape
    if beta not in (0, 1):
        raise ValueError("beta must be 0 or 1 (reference restriction)")
    if dtype is None:
        dtype = _NP_TYPES[a.dtype.name]
    dev = resolve_device(device)
    a_t = tensor_from_numpy(a, dtype, "cpu")
    av = (alpha * a_t).to(a_t.dtype)
    csr = CsrMatrix.from_dense(av.double().numpy() if dtype == Datatype.BF16
                               else av.numpy())
    nnz = csr.nnz
    shape = GemmShape(m, n, k, a_in_type=dtype, b_in_type=dtype,
                      out_type=dtype)
    flags = GemmFlags.BETA_0 if beta == 0 else GemmFlags.NONE

    dense_kernel = _dense_kernel(av.to(dev), shape, dev)
    sparse_kernel = None
    if nnz > 0:
        try:
            sparse_kernel = create_spgemm_csr_areg(
                shape, flags, csr.indptr, csr.indices, csr.data, device=dev)
        except ValueError:
            sparse_kernel = None      # nnz over the cap: dense only

    cache = _autotune_cache()
    cache_key = (f"fsspmdm3:{m}:{n}:{k}:{beta}:{dtype.value}:"
                 f"{csr.fingerprint(include_values=True):x}").encode()
    history = []
    raw = cache.get(cache_key) if cache is not None else None
    if raw:
        try:
            history = [float(t) for t in raw.decode().split(",") if t]
        except ValueError:
            history = []

    # the env is read at create time, as the reference's getenv inside
    # libxsmm_fsspmdm_create (:35-36); CONFIG holds import-time values
    hint = _env_int("XSMM_TPU_FSSPMDM_HINT", CONFIG.fsspmdm_hint)
    tuned = {}

    def _decide():
        """Measure the dense/sparse ratio now (a full tune without history,
        a lighter probe with it), fold it into the persisted history and
        decide on the history's median against 1 + the dense bias."""
        rng = np.random.default_rng(0)
        tdt = to_torch(dtype)
        b_probe = torch.as_tensor(rng.standard_normal((k, n)),
                                  device=dev).to(tdt)
        args = ((b_probe,) if beta == 0 else
                (b_probe, torch.zeros((m, n), dtype=tdt, device=dev)))
        if history:
            tuned["cached"] = True
            reps = 8
        else:
            reps = max(1, CONFIG.fsspmdm_ntune)
        times, ratio = _bench_candidates(
            [(dense_kernel.fn, args), (sparse_kernel.fn, args)], reps,
            rounds=3)
        tuned["dense_us"], tuned["sparse_us"] = times
        if ratio is None:
            ratio = times[0] / max(times[1], 1e-9)
        tuned["dense_over_sparse"] = round(ratio, 4)
        history.append(ratio)
        del history[:-_HISTORY_CAP]
        agg = sorted(history)[len(history) // 2]
        tuned["ratio_history"] = [round(r, 4) for r in history]
        tuned["ratio_median"] = round(agg, 4)
        kind_ = "sparse" if agg > 1.0 + CONFIG.fsspmdm_dense_bias else "dense"
        if cache is not None:
            cache.put(cache_key,
                      ",".join(f"{r:.5f}" for r in history).encode())
        return kind_

    if hint == 2 or sparse_kernel is None:
        kind = "dense"
    elif hint == 1:
        kind = "sparse"
    else:
        kind = _decide()
    pick = sparse_kernel if kind == "sparse" else dense_kernel
    if CONFIG.verbose >= 2:
        print(f"libxsmm_torch: fsspmdm {m}x{n}x{k} nnz={nnz} -> {kind} "
              f"({tuned})")
    return Fsspmdm(m=m, n=n, k=k, beta=beta, kernel=pick, kind=kind,
                   nnz=nnz, tuned_us=tuned)


def fsspmdm_execute(handle: Fsspmdm, b, c=None):
    """libxsmm_fsspmdm_execute analogue."""
    return handle.execute(b, c)


def fsspmdm_destroy(handle: Fsspmdm) -> None:
    """API parity (libxsmm_fsspmdm_destroy); kernels are GC-managed."""
    handle.kernel = None


# ---------------------------------------------------------------------------
# Typed wrappers (include/libxsmm_fsspmdm.h:17-45: libxsmm_dfsspmdm_* pins
# f64, libxsmm_sfsspmdm_* pins f32; both alias the generic handle)
# ---------------------------------------------------------------------------

def _typed(x, np_dt):
    """x as np_dt: a tensor is cast on its device, anything else in numpy
    (the kernel loads it onto the handle's device)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to({np.float64: torch.float64,
                     np.float32: torch.float32}[np_dt])
    return np.asarray(x, np_dt)


def dfsspmdm_create(n: int, a_dense, alpha: float = 1.0, beta: int = 0,
                    device=None) -> Fsspmdm:
    """libxsmm_dfsspmdm_create: double-precision pinned handle."""
    return fsspmdm_create(n, np.asarray(a_dense, np.float64), alpha, beta,
                          dtype=Datatype.F64, device=device)


def sfsspmdm_create(n: int, a_dense, alpha: float = 1.0, beta: int = 0,
                    device=None) -> Fsspmdm:
    """libxsmm_sfsspmdm_create: single-precision pinned handle."""
    return fsspmdm_create(n, np.asarray(a_dense, np.float32), alpha, beta,
                          dtype=Datatype.F32, device=device)


def dfsspmdm_execute(handle: Fsspmdm, b, c=None):
    """libxsmm_dfsspmdm_execute (include/libxsmm_fsspmdm.h:40)."""
    return handle.execute(_typed(b, np.float64), _typed(c, np.float64))


def sfsspmdm_execute(handle: Fsspmdm, b, c=None):
    """libxsmm_sfsspmdm_execute (include/libxsmm_fsspmdm.h:41)."""
    return handle.execute(_typed(b, np.float32), _typed(c, np.float32))


def dfsspmdm_destroy(handle: Fsspmdm) -> None:
    fsspmdm_destroy(handle)


def sfsspmdm_destroy(handle: Fsspmdm) -> None:
    fsspmdm_destroy(handle)
