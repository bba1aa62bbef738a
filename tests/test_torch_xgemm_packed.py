"""The 24 packed MX/sub-byte classes of samples/xgemm.py through both
packages on the same operands, on the CPU, at the classes' smallest shapes
(m = n = 8, k = 64, br = 2).

The operands are quantized once, by the JAX package, and the same payload
and scale bytes go to both (tests/test_torch_quant.py holds the two
packages' quantizers to the same bytes). Tolerances: integer outputs
exact; float outputs 1e-5 normf_rel (the decoded products are exact in
both, only the order of the sum differs).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import libxsmm_torch as xp
import libxsmm_tpu as xt
from libxsmm_torch import interop
from libxsmm_torch import xgemm as PX
from libxsmm_torch.matdiff import check
from libxsmm_tpu import quant as rq
from libxsmm_tpu.descriptor import (BatchReduceConfig, BatchReduceType,
                                    GemmFlags, GemmShape)
from libxsmm_tpu.dtypes import Datatype, to_jnp

torch.set_num_threads(1)

CLASSES = PX.build_class_list()
PACKED = [i for i, c in enumerate(CLASSES) if c["kind"] == "packed"]
MX = {Datatype.MXFP4X2: rq.mxfp4_quantize_blocks,
      Datatype.NVFP4X2: rq.nvfp4_quantize_blocks,
      Datatype.MXBF8: rq.mxbf8_quantize_blocks,
      Datatype.MXBF6: lambda v: rq.mxfp6_quantize_blocks(v, "e3m2"),
      Datatype.MXHF6: lambda v: rq.mxfp6_quantize_blocks(v, "e2m3")}


def _u8(x):
    return torch.from_numpy(np.asarray(x).view(np.uint8).copy())


def _packed(rng, dt, shp):
    """(JAX operand, port operand) of a packed type, same bytes."""
    vals = PX.packed_values(rng, xp.Datatype(dt.value), shp)
    if dt in MX:
        p, s = MX[dt](jnp.asarray(vals))
        pt = _u8(p)
        if dt == Datatype.MXBF8:
            pt = pt.view(torch.float8_e5m2)
        return (p, s), (pt, _u8(s))
    p = rq.pack_subbyte_gemm(dt, jnp.asarray(vals, jnp.int32))
    return p, _u8(p)


def _native(rng, dt, shp):
    if dt in (Datatype.I8, Datatype.U8):
        v = rng.integers(0 if dt == Datatype.U8 else -100, 100, shp)
    else:
        v = rng.standard_normal(shp)
    xj = jnp.asarray(v, to_jnp(dt))
    return xj, interop.tensor_from_numpy(np.asarray(xj),
                                         xp.Datatype(dt.value), "cpu")


def _swap(pair):
    return tuple(jnp.swapaxes(jnp.asarray(v), -1, -2) for v in pair)


@pytest.mark.parametrize("idx", PACKED, ids=lambda i: f"{i:03d}")
def test_packed_class_parity_with_jax(idx):
    cls = CLASSES[idx]
    adt, bdt, odt = (Datatype(d.value) for d in cls["combo"][:3])
    rng = np.random.default_rng(9000 + idx)
    m, n, k = 8, 8, 64
    br = 2 if cls["br_mode"] == "stride" else 0
    lead = (br,) if br else ()
    shape = GemmShape(m, n, k, a_in_type=adt, b_in_type=bdt, out_type=odt)
    flags = GemmFlags.BETA_0 | GemmFlags.VNNI_A
    aj, at = _packed(rng, adt, lead + (m, k))
    if bdt in MX:
        bj, bt = _packed(rng, bdt, lead + (n, k))
        bj = _swap(bj)
        bt = tuple(v.transpose(-1, -2) for v in bt)
    else:
        bj, bt = _native(rng, bdt, lead + (k, n))
    port_shape = interop.descriptor_from_fields(
        interop.descriptor_fields(shape))
    if br:
        cfg = BatchReduceConfig(BatchReduceType.STRIDE, br)
        ref = xt.dispatch_brgemm(shape, flags, cfg)(aj, bj)
        got = xp.dispatch_brgemm(port_shape, xp.GemmFlags(int(flags)),
                                 xp.BatchReduceConfig(
                                     xp.BatchReduceType.STRIDE, br))(at, bt)
    else:
        ref = xt.dispatch_gemm(shape, flags)(aj, bj)
        got = xp.dispatch_gemm(port_shape, xp.GemmFlags(int(flags)))(at, bt)
    assert got.dtype == xp.to_torch(xp.Datatype(odt.value))
    if odt == Datatype.I32:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    else:
        check(np.asarray(ref, np.float64), got, margin=1e-5)


def test_packed_refusals_parity():
    cases = [
        (GemmShape(8, 8, 64, a_in_type=Datatype.MXFP4X2,
                   b_in_type=Datatype.F16), GemmFlags.NONE),
        (GemmShape(8, 8, 64, a_in_type=Datatype.MXFP4X2,
                   b_in_type=Datatype.BF16, out_type=Datatype.I32),
         GemmFlags.NONE),
        (GemmShape(8, 8, 64, a_in_type=Datatype.I4X2,
                   b_in_type=Datatype.BF16, out_type=Datatype.I32),
         GemmFlags.NONE),
        (GemmShape(8, 8, 64, a_in_type=Datatype.I1X8,
                   b_in_type=Datatype.U8, out_type=Datatype.I32),
         GemmFlags.NONE),
        (GemmShape(8, 8, 64, a_in_type=Datatype.I4X2,
                   b_in_type=Datatype.I8, out_type=Datatype.F32),
         GemmFlags.NONE),
        (GemmShape(8, 8, 64, a_in_type=Datatype.MXBF8,
                   b_in_type=Datatype.BF16), GemmFlags.TRANS_B),
    ]
    for shape, flags in cases:
        with pytest.raises(ValueError):
            xt.dispatch_gemm(shape, flags)
        with pytest.raises(ValueError):
            xp.dispatch_gemm(interop.descriptor_from_fields(
                interop.descriptor_fields(shape)), xp.GemmFlags(int(flags)))
