"""Ulysses (all-to-all head-parallel) sequence parallelism.

The port of `libxsmm_tpu/parallel/ulysses.py` (DeepSpeed-Ulysses,
arXiv:2309.14509). Activations arrive SEQUENCE-sharded: q/v (bh, s/P, hd)
and kT (bh, hd, s/P) a rank. One all-to-all per operand reshards

    (bh, s/P, hd)  ->  (bh/P, s, hd)

(parallel/collectives.all_to_all, jax.lax.all_to_all's tiled chunk
order): every rank then runs the port's flash attention
(ops.attention.dispatch_flash_attention, the hand-written kernels on the
card) on its bh/P heads over the FULL sequence, with exact causality and no
LSE combining, and one reverse all-to-all restores sequence sharding on the
output.

Comm model (per device, per call): 4 all-to-alls (q, kT, v in; out back),
each moving the (P-1)/P remote fraction of one local operand:

    bytes = 4 * bh * (s/P) * hd * itemsize * (P-1)/P

a factor 2/P of the ring's (P-1) * 2 * bh * (s/P) * hd * itemsize, so
Ulysses wins whenever heads divide over the axis; `recommend_cp_flavor`
encodes that crossover. The log (collectives.log) holds exactly those
bytes.

Gradients come from the all-to-all's autograd (the reverse all-to-all) and
the flash attention's (the port's flash backward kernels).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import collectives as C
from .mesh import Mesh, local, wrap
from .ring_attention import _shardings, ring_comm_bytes_per_device


def ulysses_comm_bytes_per_device(bh: int, s: int, hd: int, ndev: int,
                                  dtype: torch.dtype) -> int:
    """Analytic per-device comm volume: 4 all-to-alls (q, kT, v, out),
    each sending the (P-1)/P remote fraction of one local shard."""
    shard = bh * (s // ndev) * hd * dtype.itemsize
    return 4 * shard * (ndev - 1) // ndev


def recommend_cp_flavor(bh: int, s: int, hd: int, ndev: int,
                        dtype) -> dict:
    """The CP-flavor crossover, as data: Ulysses moves 2/P of the ring's
    bytes but needs heads divisible by the axis (bh >= P); the ring has
    no head constraint and overlaps its hops with compute."""
    ring = ring_comm_bytes_per_device(bh, s, hd, ndev, dtype)
    out = {"ring_bytes": ring, "ulysses_applicable": bh % ndev == 0}
    if bh % ndev == 0:
        uly = ulysses_comm_bytes_per_device(bh, s, hd, ndev, dtype)
        out["ulysses_bytes"] = uly
        out["pick"] = "ulysses" if uly < ring else "ring"
    else:
        out["pick"] = "ring"
    return out


def make_ulysses_attention(mesh: Mesh, axis: str, bh: int, s: int, hd: int,
                           dtype=torch.bfloat16, causal: bool = False,
                           scale: Optional[float] = None):
    """Build a Ulysses sequence-parallel attention over mesh[axis].

    Same contract as make_ring_attention: returns (fn, shardings) where
    fn(q, kT, v) -> out for GLOBAL q/v (bh, s, hd) and kT (bh, hd, s), all
    sequence-sharded over `axis`; the result matches single-device
    attention on the full sequence."""
    from ..dtypes import from_torch
    from ..ops.attention import dispatch_flash_attention

    ndev = mesh.shape[axis]
    if s % ndev:
        raise ValueError(f"s={s} must divide over {ndev} devices")
    if bh % ndev:
        raise ValueError(f"Ulysses needs heads divisible by the axis: "
                         f"bh={bh} % {ndev} != 0 (use the ring flavor)")
    sc = float(scale) if scale is not None else float(hd) ** -0.5
    # the local kernel sees bh/P heads over the FULL sequence
    kern = dispatch_flash_attention(bh // ndev, s, hd, from_torch(dtype),
                                    causal=causal, scale=sc)
    group = mesh.group(axis)
    shardings = _shardings(mesh, axis)

    def fn(q, kT, v):
        q, kT, v = (local(x, shardings[k])
                    for x, k in ((q, "q"), (kT, "kT"), (v, "v")))
        # sequence-sharded -> head-sharded: one all-to-all per operand
        qh = C.all_to_all(q, group, 0, 1)
        vh = C.all_to_all(v, group, 0, 1)
        kTh = C.all_to_all(kT, group, 0, 2)
        o = kern(qh, kTh, vh)
        # head-sharded -> sequence-sharded
        out = C.all_to_all(o, group, 1, 0)
        return wrap(out, shardings["q"], (bh, s, hd))

    return fn, shardings
