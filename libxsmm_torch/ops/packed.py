"""Packed (SOA) dense GEMM: P independent small GEMMs interleaved in the
trailing dimension.

The port of `libxsmm_tpu/ops/packed.py`, the reference's packed dense
generators (generator_packed_gemm*.c, create API src/libxsmm_main.c:
3733-3841): the SOA layout [row][col][packed] is a row-major tensor with the
packed width as the trailing axis, C[m,n,p] = A[m,k,p] @ B[k,n,p] for each
p. The row-major packed variants share one operand across p: AC_RM (A and
C packed, B shared) and BC_RM (B and C packed, A shared).

The reference computes these with one einsum that it leaves to XLA, so the
port runs torch.einsum in the compute type (f32 products at full f32, no
TF32; integers exact, kernels.gemm.contract). Tensors stay on their device;
numpy operands are loaded onto the card, as dispatch_gemm's are.
"""

from __future__ import annotations

import torch

from ..descriptor import GemmFlags, GemmShape
from ..dtypes import to_torch
from ..kernels.gemm import add_acc, contract
from ..registry import Kernel, KernelInfo, entry_point, get_registry
from .eltwise import load_operand
from .gemm import _comp_dtype

_SPEC = {
    "packed": "mkp,knp->mnp",     # all operands packed
    "ac_rm": "mkp,kn->mnp",       # A, C packed; B shared
    "bc_rm": "mk,knp->mnp",       # B, C packed; A shared
}


def _build_packed(desc):
    kind, shape, flags, packed_width = desc
    # the reference rejects transpose and VNNI flags on the packed dense
    # entries (generator_packed_gemm.c:41-48): an untransposed kernel would
    # compute A@B where the caller asked for A@B^T
    bad = (GemmFlags.TRANS_A | GemmFlags.TRANS_B | GemmFlags.VNNI_A
           | GemmFlags.VNNI_B | GemmFlags.VNNI_C)
    if GemmFlags(flags) & bad:
        raise ValueError("packed dense GEMM supports NORM layouts only "
                         "(no TRANS_*/VNNI_* flags; reference "
                         "generator_packed_gemm.c:41-48)")
    comp = _comp_dtype(shape)
    out_dt = to_torch(shape.out_type)
    beta0 = bool(flags & GemmFlags.BETA_0)
    spec = _SPEC[kind]

    def fn(a, b, c=None):
        if beta0 and c is not None:
            # BETA_0 means C is unread (the reference's contract)
            raise ValueError("c operand passed to a BETA_0 packed GEMM")
        if not beta0 and c is None:
            raise ValueError("beta=1 packed GEMM needs the C operand "
                             "(pass GemmFlags.BETA_0 for C=)")
        a = load_operand(a)
        acc = contract(lambda x, y: torch.einsum(spec, x, y), a,
                       load_operand(b, a.device), comp)
        if c is not None:
            acc = add_acc(acc, load_operand(c, a.device))
        return acc.to(out_dt)

    nflops = 2 * shape.m * shape.n * shape.k * packed_width
    return Kernel(fn=fn, descriptor=desc,
                  info=KernelInfo(kind=f"packed_gemm_{kind}", nflops=nflops),
                  name=f"packed_gemm_{kind}_{shape.m}x{shape.n}x{shape.k}"
                       f"_p{packed_width}")


@entry_point
def create_packed_gemm(shape: GemmShape, flags: GemmFlags = GemmFlags.NONE,
                       packed_width: int = 1) -> Kernel:
    """libxsmm_create_packed_gemm analogue (src/libxsmm_main.c:3733).
    kernel(a, b[, c]): a (m,k,p), b (k,n,p) -> c (m,n,p)."""
    desc = ("packed", shape, GemmFlags(flags), packed_width)
    return get_registry().dispatch(desc, _build_packed)


@entry_point
def create_packed_gemm_ac_rm(shape: GemmShape,
                             flags: GemmFlags = GemmFlags.NONE,
                             packed_width: int = 1) -> Kernel:
    """libxsmm_create_packed_gemm_ac_rm analogue (:3769).
    kernel(a, b[, c]): a (m,k,p), b (k,n) shared -> c (m,n,p)."""
    desc = ("ac_rm", shape, GemmFlags(flags), packed_width)
    return get_registry().dispatch(desc, _build_packed)


@entry_point
def create_packed_gemm_bc_rm(shape: GemmShape,
                             flags: GemmFlags = GemmFlags.NONE,
                             packed_width: int = 1) -> Kernel:
    """libxsmm_create_packed_gemm_bc_rm analogue (:3805).
    kernel(a, b[, c]): a (m,k) shared, b (k,n,p) -> c (m,n,p)."""
    desc = ("bc_rm", shape, GemmFlags(flags), packed_width)
    return get_registry().dispatch(desc, _build_packed)
