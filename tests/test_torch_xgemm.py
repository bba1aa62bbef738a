"""The GEMM acceptance matrix of samples/xgemm.py through the port, on the
CPU.

* Every one of the 225 classes of `build_class_list` runs through the
  port's entry points (`libxsmm_torch.xgemm.run_class`, CPU tensors, the
  plain versions of the kernels) against its float64 oracle at xgemm's
  shapes and margins (samples/xgemm.py:436-444: integer outputs exact, MX
  1e-5 * sqrt(k) normf_rel, the others matdiff.DEFAULT_MARGINS scaled by
  sqrt(k * br)).
* The port's class table is held equal to samples/xgemm.py's.
* The BRGEMM-ext and lane-packed ext classes also run through the JAX
  package on the same operands, and the two outputs are compared: 1e-5
  normf_rel for f32 outputs (the order of the sums and the transcendental
  functions differ in the last bits), 1e-4 for bf16 inputs with f32
  outputs; the stochastic-round store's bits differ by design (the JAX
  package draws jax.random, the port a counter hash), so there each output
  is held within one bf16 ulp of the float64 accumulator. The packed
  MX/sub-byte classes are compared with the JAX package in
  tests/test_torch_xgemm_packed.py.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import libxsmm_torch as xp
import libxsmm_tpu as xt
from libxsmm_torch import interop
from libxsmm_torch import xgemm as PX
from libxsmm_torch.matdiff import check
from libxsmm_tpu.descriptor import (BatchReduceConfig, BatchReduceType,
                                    BinaryPostops, BinaryType, GemmFlags,
                                    GemmShape, UnaryArgops, UnaryFlags,
                                    UnaryType)
from libxsmm_tpu.dtypes import Datatype

# samples/xgemm.py, the JAX tester, loaded by path (samples/ stays off
# sys.path, where its module names would shadow others)
_spec = importlib.util.spec_from_file_location(
    "samples_xgemm", pathlib.Path(__file__).resolve().parents[1]
    / "samples" / "xgemm.py")
RX = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(RX)

torch.set_num_threads(1)

CLASSES = PX.build_class_list()
EXT = [i for i, c in enumerate(CLASSES) if c["kind"] in ("ext",
                                                          "ext_packed")]


def _plain(cls):
    """A class dict with every Datatype as its value string."""
    out = dict(cls)
    if "combo" in out:
        out["combo"] = tuple(getattr(v, "value", v) for v in out["combo"])
    return out


def test_class_table_matches_samples_xgemm():
    ref = RX.build_class_list()
    assert len(CLASSES) == len(ref) == 225
    assert [_plain(c) for c in CLASSES] == [_plain(c) for c in ref]
    kinds = [c["kind"] for c in CLASSES]
    assert (kinds.count("packed"), kinds.count("ext"),
            kinds.count("ext_packed")) == (24, 47, 4)


@pytest.mark.parametrize("idx", range(len(CLASSES)),
                         ids=lambda i: f"{i:03d}-{CLASSES[i]['kind']}")
def test_class_through_port_against_float64(idx):
    ok, label, err = PX.run_class(CLASSES[idx],
                                  np.random.default_rng(20260816 + idx),
                                  "cpu")
    assert ok, f"{label}: normf_rel {err}"


# ---------------------------------------------------------------------------
# the ext classes through both packages on the same operands
# ---------------------------------------------------------------------------

def _jdt(dt):
    return {Datatype.F32: jnp.float32, Datatype.BF16: jnp.bfloat16}[dt]


def _both(x, dt):
    """(JAX array, CPU tensor) of the same values in dt."""
    xj = jnp.asarray(np.asarray(x, np.float32), _jdt(dt))
    return xj, interop.tensor_from_numpy(np.asarray(xj),
                                         xp.Datatype(dt.value), "cpu")


def _port(obj):
    return interop.descriptor_from_fields(interop.descriptor_fields(obj))


@pytest.mark.parametrize("idx", EXT, ids=lambda i: f"{i:03d}")
def test_ext_class_parity_with_jax(idx):
    cls = CLASSES[idx]
    rng = np.random.default_rng(7000 + idx)
    if cls["kind"] == "ext_packed":
        m, n, k, br, q = 32, 32, 64, 8, 2
        a = rng.standard_normal((br, m, k)).astype(np.float32)
        b = rng.standard_normal((br, k, n)).astype(np.float32)
        d = rng.standard_normal((1, n)).astype(np.float32)
        argops = UnaryArgops(cp_type=UnaryType[cls["cp"]])
        postops = (BinaryPostops(d_type=BinaryType.ADD) if cls["bias"]
                   else BinaryPostops())
        cfg = BatchReduceConfig(BatchReduceType.STRIDE, br)
        kr = xt.dispatch_brgemm_ext_packed(GemmShape(m, n, k),
                                           GemmFlags.BETA_0, cfg,
                                           argops=argops, postops=postops)
        kp = xp.dispatch_brgemm_ext_packed(
            xp.GemmShape(m, n, k), xp.GemmFlags.BETA_0, _port(cfg),
            argops=_port(argops), postops=_port(postops))
        kw_r = {"d_op": jnp.asarray(d)} if cls["bias"] else {}
        kw_p = {"d_op": torch.from_numpy(d)} if cls["bias"] else {}
        ref = kr(xt.pack_batched(jnp.asarray(a), q), jnp.asarray(b), **kw_r)
        got = kp(xp.pack_batched(torch.from_numpy(a), q),
                 torch.from_numpy(b), **kw_p)
        check(np.asarray(ref, np.float64), got, margin=1e-5)
        return
    adt, bdt, odt = (Datatype(d.value) for d in cls["combo"][:3])
    m, n, k, br = 12, 10, 16, 3
    shape = GemmShape(m, n, k, a_in_type=adt, b_in_type=bdt, out_type=odt)
    flags = GemmFlags.BETA_0 if cls["beta"] == 0 else GemmFlags.NONE
    cfg = BatchReduceConfig(BatchReduceType.STRIDE, br)
    argops = UnaryArgops(
        ap_type=UnaryType[cls.get("argop_a", "NONE")],
        cp_type=UnaryType[cls["cp"]],
        cp_flags=(UnaryFlags.BITMASK_2BYTEMULT if cls.get("bitmask")
                  else UnaryFlags.NONE),
        store_cp=bool(cls.get("store_cp")))
    postops = (BinaryPostops(d_type=BinaryType.ADD) if cls["bias"]
               else BinaryPostops())
    aj, at = _both(rng.standard_normal((br, m, k)) * 0.5, adt)
    bj, bt = _both(rng.standard_normal((br, k, n)) * 0.5, bdt)
    rargs, pargs = [aj, bj], [at, bt]
    if cls["beta"]:
        cj, ct = _both(rng.standard_normal((m, n)), odt)
        rargs.append(cj)
        pargs.append(ct)
    if cls["bias"]:
        dj, dt_ = _both(rng.standard_normal((m, n)), adt)
        rargs.append(dj)
        pargs.append(dt_)
    kr = xt.dispatch_brgemm_ext(shape, flags, cfg, argops=argops,
                                postops=postops)
    kp = xp.dispatch_brgemm_ext(_port(shape), xp.GemmFlags(int(flags)),
                                _port(cfg), argops=_port(argops),
                                postops=_port(postops))
    assert kr.name == kp.name and kr.info.nflops == kp.info.nflops
    ref, got = kr(*rargs, seed=7), kp(*pargs, seed=7)
    if cls["cp"] == "STOCHASTIC_ROUND":
        # both within one bf16 ulp of the float64 accumulator (plus 1e-6
        # of its largest magnitude: the f32 accumulator's own rounding)
        acc = np.einsum("bmk,bkn->mn", np.asarray(aj, np.float64),
                        np.asarray(bj, np.float64))
        for out in (np.asarray(ref, np.float64), got.double().numpy()):
            ulp = np.exp2(np.floor(np.log2(np.abs(acc) + 1e-30)) - 7)
            assert (np.abs(out - acc) <= ulp + 1e-6 * np.abs(acc).max()).all()
        assert got.dtype == torch.bfloat16
        return
    tol = 1e-5 if adt == Datatype.F32 else 1e-4
    if isinstance(ref, tuple):
        (ref, rx), (got, gx) = ref, got
        assert sorted(rx) == sorted(gx)
        for key in rx:
            if key == "cp_bitmask":
                np.testing.assert_array_equal(gx[key].numpy(),
                                              np.asarray(rx[key]))
            else:
                check(np.asarray(rx[key], np.float64), gx[key], margin=tol)
    check(np.asarray(ref, np.float64), got, margin=tol)
