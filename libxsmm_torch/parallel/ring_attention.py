"""Ring (sequence-parallel) attention over a mesh axis, on the flash kernels.

The port of `libxsmm_tpu/parallel/ring_attention.py`. Each rank holds one
sequence segment of q, kT and v; the K/V segments rotate around the axis on
`ppermute` (parallel/collectives.py) while every rank folds each incoming
segment into its query block's online-softmax state. The per-segment math
is the port's flash forward kernel asked for its LSE
(kernels/attention.build_flash_attention, return_lse=True); partial results
combine in f32 with the log-sum-exp weighting:

    m   = max(lse_a, lse_b)
    sa, sb = exp(lse_a - m), exp(lse_b - m)
    out = (out_a * sa + out_b * sb) / (sa + sb)
    lse = m + log(sa + sb)

The forward ring issues the next segment's rotation before the step's
kernel consumes the resident one (ppermute_start, waited after the kernel),
as the reference's dataflow allows its scheduler to.

Causality is chunk-wise, as the reference's: the resident (diagonal)
segment runs the causal kernel; a rotated segment is either wholly visible
(source index < own index: the full kernel) or wholly masked. Where the
reference runs the kernels of a masked pair and zeroes their weight
(`include`), the port skips them, forward and backward: the result is the
same (a zero weight leaves out and lse as they were) and the collectives are
unchanged, so every rank still issues the same rotations. The launch counts
show it: with causal=True the rank at index i launches the forward kernel
1 + i times a call (P times without causality), and each backward kernel as
often.

Differentiable end to end: one torch.autograd.Function over the whole ring
(the reference's custom_vjp). The forward saves the global LSE; the
backward is a second ring pass in which each (q_i, kv_j) pair goes through
the port's flash backward kernels (build_flash_attention_bwd) fed the
GLOBAL lse and delta, lane-broadcast to (bh, s_loc, 128) as the reference
does (the port's kernels read column 0): p_ij = exp(s_ij - lse_i) is the
exact global softmax, so the segment-wise backward decomposes exactly. The
dK^T/dV accumulators (f32) travel with their segment, and one more rotation
brings them home.

Comm model (per device, per forward call): (P-1) rotations of the local
kT and v segments, (P-1) * 2 * bh * s_loc * hd * itemsize bytes; the log
(collectives.log) holds exactly that.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import attention as ka
from . import collectives as C
from .mesh import Mesh, NamedSharding, PartitionSpec as P, local, wrap


def ring_comm_bytes_per_device(bh: int, s: int, hd: int, ndev: int,
                               dtype: torch.dtype) -> int:
    """Analytic per-device comm volume: (P-1) hops x (kT + v) segment."""
    seg = bh * (s // ndev) * hd * dtype.itemsize
    return (ndev - 1) * 2 * seg


def _combine(out, lse, o_t, lse_t):
    """Log-sum-exp weighted merge of two normalized partial results, in f32.
    out/o_t: (bh, s_loc, hd) f32; lse/lse_t: (bh, s_loc) f32. (The
    reference's `include` mask has no counterpart: the ring skips a masked
    pair instead of weighting it zero.)"""
    m = torch.maximum(lse, lse_t)
    sa = torch.exp(lse - m)
    sb = torch.exp(lse_t - m)
    denom = sa + sb
    out = (out * sa[..., None] + o_t * sb[..., None]) / denom[..., None]
    return out, m + torch.log(denom)


def _shardings(mesh: Mesh, axis: str) -> dict:
    return {"q": NamedSharding(mesh, P(None, axis, None)),
            "kT": NamedSharding(mesh, P(None, None, axis)),
            "v": NamedSharding(mesh, P(None, axis, None))}


def make_ring_attention(mesh: Mesh, axis: str, bh: int, s: int, hd: int,
                        dtype=torch.bfloat16, causal: bool = False,
                        scale: Optional[float] = None):
    """Build a sequence-parallel attention fn over `mesh[axis]`.

    Returns (fn, shardings) where fn(q, kT, v) -> out for GLOBAL q/v
    (bh, s, hd) and kT (bh, hd, s): DTensors placed with `shardings`
    (mesh.device_put) or full tensors, which fn cuts locally. out is a
    DTensor (bh, s, hd) sharded over the sequence like q. The result
    matches single-device attention on the full sequence."""
    ndev = mesh.shape[axis]
    if s % ndev:
        raise ValueError(f"s={s} must divide over {ndev} devices")
    s_loc = s // ndev
    sc = float(scale) if scale is not None else float(hd) ** -0.5
    if not ka.supported(s_loc, hd, dtype):
        raise ValueError(f"local shard s_loc={s_loc} hd={hd} outside the "
                         f"fused kernel envelope")
    kern_full = ka.build_flash_attention(bh, s_loc, hd, dtype, causal=False,
                                         scale=sc, return_lse=True)
    bwd_full = ka.build_flash_attention_bwd(bh, s_loc, hd, dtype,
                                            causal=False, scale=sc)
    if causal:
        kern_diag = ka.build_flash_attention(bh, s_loc, hd, dtype,
                                             causal=True, scale=sc,
                                             return_lse=True)
        bwd_diag = ka.build_flash_attention_bwd(bh, s_loc, hd, dtype,
                                                causal=True, scale=sc)
    else:
        kern_diag, bwd_diag = kern_full, bwd_full
    group = mesh.group(axis)
    idx = mesh.index(axis)
    perm = C.ring_perm(ndev)

    def _include(t):
        """After t forward rotations the resident segment originated at
        index (idx - t) mod ndev; causally it is visible iff it precedes
        this rank's own."""
        return not causal or (idx - t) % ndev < idx

    def _fwd_ring(q, kT, v):
        # t = 0: the resident (diagonal) segment, causal kernel when causal
        o0, lse0 = kern_diag(0, q, kT, v)
        out = o0.float()
        lse = lse0[..., 0]
        fly = C.ppermute_start((kT, v), group, perm) if ndev > 1 else None
        for t in range(1, ndev):
            cur = fly.wait()
            if t < ndev - 1:
                # the next segment starts moving BEFORE this step's kernel
                # consumes `cur`
                fly = C.ppermute_start(cur, group, perm)
            if _include(t):
                o_t, lse_t = kern_full(0, q, cur[0], cur[1])
                out, lse = _combine(out, lse, o_t.float(), lse_t[..., 0])
        return out.to(q.dtype), lse

    class _Ring(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, kT, v):
            out, lse = _fwd_ring(q, kT, v)
            ctx.save_for_backward(q, kT, v, out, lse)
            return out

        @staticmethod
        def backward(ctx, g):
            q, kT, v, out, lse = ctx.saved_tensors
            g_ = g.to(dtype).contiguous()
            delta = (g.float() * out.float()).sum(dim=-1)
            lse128 = lse[..., None].expand(*lse.shape, 128)
            d128 = delta[..., None].expand(*delta.shape, 128)
            dq0, dkT0, dv0 = bwd_diag(0, q, kT, v, g_, lse128, d128)
            dq_acc = dq0.float()
            # (segment, its gradient accumulators) travel together
            cur = (kT, v, dkT0.float(), dv0.float())
            for t in range(1, ndev):
                cur = C.ppermute_start(cur, group, perm).wait()
                kT_t, v_t, dkT_a, dv_a = cur
                if _include(t):
                    dq_t, dkT_t, dv_t = bwd_full(0, q, kT_t, v_t, g_, lse128,
                                                 d128)
                    dq_acc = dq_acc + dq_t.float()
                    dkT_a = dkT_a + dkT_t.float()
                    dv_a = dv_a + dv_t.float()
                cur = (kT_t, v_t, dkT_a, dv_a)
            # ndev-1 rotations so far: one more brings each segment's
            # gradients back to its home rank
            dkT_home, dv_home = C.ppermute_start(cur[2:], group, perm).wait()
            return (dq_acc.to(q.dtype), dkT_home.to(kT.dtype),
                    dv_home.to(v.dtype))

    shardings = _shardings(mesh, axis)

    def fn(q, kT, v):
        out = _Ring.apply(local(q, shardings["q"]),
                          local(kT, shardings["kT"]),
                          local(v, shardings["v"]))
        return wrap(out, shardings["q"], (bh, s, hd))

    return fn, shardings
