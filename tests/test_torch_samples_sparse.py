"""The port's sparse, convolution, distributed and tooling samples
(libxsmm_torch/samples/) against the JAX package, on the CPU (--device
cpu).

* spmm: at 128^3 every strategy of the sample's STRATEGIES gives the JAX
  package's create_packed_spgemm_bcsc result on the same draw (f32 1e-5,
  bf16 inputs 2e-2, matdiff normf_rel); at 64^3 the strategies both
  packages serve agree the same way, and where the JAX package refuses
  (super and the union names need 128 | n) the port's sample raises.
* probe_bcsc at 128^3: each stage against numpy (the gathers and the
  transpose exact, the products 2e-2), and the sample's exit code 0.
* cnn on a small layer: the fused conv against the JAX package's
  conv2d_kernel on the same numpy draw (1e-5 of the largest entry).
* pyfr, synthetic operators, N = 64: every operator against float64.
* spmm_scaling in gloo worlds of 1, 2 and 4 ranks and the two-level form.
* encoder: phase 1's checks and phase 2's AOT round trip.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libxsmm_tpu.descriptor import GemmFlags, GemmShape, SpgemmConfig
from libxsmm_tpu.dtypes import Datatype
from libxsmm_tpu.ops.sparse import BcscMatrix, create_packed_spgemm_bcsc
from libxsmm_torch.matdiff import matdiff
from libxsmm_torch.samples import (cnn, encoder, probe_bcsc, pyfr, spmm,
                                   spmm_scaling)

CPU = torch.device("cpu")
torch.set_num_threads(1)


def _jax_outputs(size, bk, bn, density, dtype, seed):
    """{strategy: the JAX package's output} on the sample's draw, None for
    a strategy it refuses."""
    bmat, a = spmm.draw(np.random.default_rng(seed), size, size, size, bk,
                        bn, density)
    bc = BcscMatrix.from_dense(bmat, bk, bn)
    in_dt = Datatype.BF16 if dtype == "bf16" else Datatype.F32
    shape = GemmShape(size, size, size, a_in_type=in_dt, b_in_type=in_dt,
                      out_type=Datatype.F32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    out = {}
    for strat in spmm.STRATEGIES:
        try:
            kern = create_packed_spgemm_bcsc(
                shape, GemmFlags.BETA_0, SpgemmConfig(1, bk, bn),
                column_ptr=bc.indptr, row_idx=bc.indices, strategy=strat)
        except ValueError:
            out[strat] = None
            continue
        out[strat] = np.asarray(kern(jnp.asarray(a, jdt),
                                     jnp.asarray(bc.data, jdt)), np.float32)
    return out


SPMM_CASES = [(size, bk, bn, dtype) for size in (64, 128)
              for bk, bn in ((32, 32), (16, 64)) for dtype in ("f32", "bf16")]


@pytest.mark.parametrize("size,bk,bn,dtype", SPMM_CASES,
                         ids=[f"{s}-b{bk}x{bn}-{d}"
                              for s, bk, bn, d in SPMM_CASES])
def test_spmm_strategies_match_jax_package(size, bk, bn, dtype):
    want = _jax_outputs(size, bk, bn, 0.5, dtype, 11)
    got, fails = [], []
    refused = [s for s in spmm.STRATEGIES if want[s] is None]
    raises = (pytest.raises(ValueError) if refused
              else contextlib.nullcontext())
    with contextlib.redirect_stdout(io.StringIO()), raises:
        spmm.run_case(size, size, size, bk, bn, 0.5, dtype, False,
                      np.random.default_rng(11), fails, CPU, results=got)
    assert not fails
    served = [s for s in spmm.STRATEGIES if want[s] is not None]
    # the port serves what the JAX package serves, in the sample's order,
    # and raises at the first strategy the JAX package refuses
    assert [s for s, _ in got] == served[:len(got)]
    assert len(got) == (spmm.STRATEGIES.index(refused[0]) if refused
                        else len(spmm.STRATEGIES))
    assert (size == 64) == bool(refused)
    tol = 2e-2 if dtype == "bf16" else 1e-5
    for strat, out in got:
        assert matdiff(want[strat].astype(np.float64), out).normf_rel <= tol


def test_spmm_main_small(capsys):
    assert spmm.main(["--size", "128", "--densities", "0.3", "--device",
                      "cpu"]) == 0
    assert "ALL OK" in capsys.readouterr().out


PROBE = probe_bcsc.stages(0.5, 128, CPU)[2]


@pytest.mark.parametrize("i", range(len(PROBE)),
                         ids=[s[0] for s in PROBE])
def test_probe_bcsc_stage_against_numpy(i):
    name, fn, args, ref, tol, useful = PROBE[i]
    got = fn(*args).float().numpy()
    assert got.shape == ref.shape
    if tol == 0:
        np.testing.assert_array_equal(got, ref)
    else:
        assert matdiff(ref, got).normf_rel < tol


def test_probe_bcsc_main(capsys):
    assert probe_bcsc.main(["0.5", "--size", "128", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count(" OK (") == len(PROBE) and "host clock" in out


def test_cnn_matches_jax_conv2d_kernel():
    from libxsmm_torch.models.tpp_cnn import conv2d_kernel
    from libxsmm_tpu.models import tpp_cnn as JC
    n, h, w, c, k, r, stride = 2, 9, 11, 8, 16, 3, 2
    x, wt, b, want = cnn.layer(n, h, w, c, k, r, stride, CPU)
    got = conv2d_kernel(x.shape, wt.shape, stride=stride, fused_bias=True,
                        relu=True)(x, wt, b)
    jfn = JC.conv2d_kernel(tuple(x.shape), tuple(wt.shape), stride=stride,
                           fused_bias=True, relu=True)
    jout = np.asarray(jfn(jnp.asarray(x.numpy()), jnp.asarray(wt.numpy()),
                          jnp.asarray(b.numpy())))
    scale = float(np.abs(jout).max())
    assert float(np.abs(got.numpy() - jout).max()) <= 1e-5 * scale
    assert float((got.double() - want).abs().max()) <= 1e-5 * scale


def test_cnn_main_small():
    assert cnn.main(["2", "10", "10", "4", "8", "3", "1", "--device",
                     "cpu"]) == 0


def test_pyfr_synthetic_small(capsys):
    assert pyfr.main(["64", "--synthetic", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "8 synthetic operators" in out and out.count(" OK ") == 8


def test_spmm_scaling_gloo_worlds(capsys):
    assert spmm_scaling.main(["4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for label in ("devices= 1", "devices= 2", "devices= 4",
                  "2-level dcn=2 x ici=2"):
        assert label in out
    assert out.count("not a scaling figure") == 4
    assert "weak-eff" not in out and spmm_scaling.NOTE in out


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_encoder_gemm_text_checks_catch_a_wrong_text(dt):
    """The structural checks fail on a text whose operands are swapped."""
    import libxsmm_torch as xp
    from libxsmm_torch.descriptor import GemmDescriptor
    from libxsmm_torch.descriptor import GemmFlags as PF
    from libxsmm_torch.descriptor import GemmShape as PS
    t = xp.Datatype.F32 if dt == "float32" else xp.Datatype.BF16
    g = xp.generator_gemm_kernel(GemmDescriptor(
        shape=PS(16, 24, 32, a_in_type=t, b_in_type=t,
                 out_type=xp.Datatype.F32), flags=PF.BETA_0), device="cpu")
    assert encoder.gemm_text_checks(g.code, dt) == []
    assert encoder.gemm_text_checks(g.code, dt, "TRANS_A") == [
        "operand dtypes and shapes"]
    assert encoder.gemm_text_checks(g.code.replace("aten.mm", "aten.xx"),
                                    dt) == ["an aten product"]


def test_encoder_both_phases(capsys):
    assert encoder.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("PASS") == 17 and "FAIL" not in out
    assert out.count("restored from its AOT record") == 5
