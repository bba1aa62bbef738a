"""The port's generator entry points (libxsmm_torch.generator) against the
JAX package's (libxsmm_tpu.generator), on the CPU: the 17 tests of
tests/test_generator.py, each building the same descriptor in both packages.

Success or refusal agrees, with the same error code and strerror text;
kind and is_reference_kernel agree; the text modes' header lines agree
byte for byte apart from the arch and size values (the port's code is the
text of one call, lowering.py, not a StableHLO module); the CSC index
conversion gives the same indptr, indices and values; the kernels the
generators serve give the JAX kernels' results on the same numpy inputs
(matdiff normf_rel 1e-5 for f32, 1e-4 for bf16 in and f32 out). The port
runs on the CPU (device="cpu": the plain torch versions), where its text
lists the aten operators of the call and no kernel launch.
"""

import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

import libxsmm_torch as xp
import libxsmm_tpu as x
from libxsmm_torch import interop
from libxsmm_torch import generator as pg
from libxsmm_torch.matdiff import check
from libxsmm_tpu import generator as rg
from libxsmm_tpu.descriptor import (BatchReduceConfig, BatchReduceType,
                                    GemmDescriptor, GemmFlags, GemmShape,
                                    SpgemmConfig)
from libxsmm_tpu.dtypes import Datatype
from libxsmm_tpu.ops.sparse import BcscMatrix, CscMatrix, CsrMatrix

torch.set_num_threads(1)
CPU = "cpu"


def port(obj):
    """The port's copy of a reference descriptor or shape."""
    return interop.descriptor_from_fields(interop.descriptor_fields(obj))


def _desc(m=16, n=16, k=16, flags=GemmFlags.BETA_0, br=None, **dts):
    return GemmDescriptor(shape=GemmShape(m, n, k, **dts), flags=flags,
                          br=br or BatchReduceConfig())


def _both(ref_fn, port_fn):
    """(reference result, port result); when the reference refuses with an
    XsmmGeneratorError, the port must refuse with the same code."""
    try:
        want = ref_fn()
    except rg.XsmmGeneratorError as e:
        with pytest.raises(pg.XsmmGeneratorError) as ei:
            port_fn()
        assert ei.value.code == e.code
        # "[code] strerror text" before any detail
        assert str(ei.value).split(": ")[0] == str(e).split(": ")[0]
        return e, ei.value
    return want, port_fn()


def _same_meta(want, got):
    assert got.kind == want.kind
    assert got.is_reference_kernel == want.is_reference_kernel
    assert got.code_size == len(got.code) > 0
    assert got.arch == xp.get_geometry().name == "cpu"
    assert "// aten ops: " in got.code and "// kernel launches: 0" in got.code


def _operands(code):
    """The operand list of a port text."""
    line = next(ln for ln in code.splitlines()
                if ln.startswith("// operands: "))
    return re.findall(r"\w+\[[\d, ]*\]", line)


def _tensor_pair(a, dt=Datatype.F32):
    """(jax array, CPU tensor) holding the same values of dt."""
    import jax.numpy as jnp
    from libxsmm_tpu.dtypes import to_jnp
    aj = jnp.asarray(a, to_jnp(dt))
    return aj, interop.tensor_from_numpy(np.asarray(aj),
                                         xp.Datatype(dt.value), device=CPU)


def _run_both(kref, kport, arrays, dts=None, margin=1e-5):
    dts = dts or [Datatype.F32] * len(arrays)
    pairs = [_tensor_pair(a, dt) for a, dt in zip(arrays, dts)]
    want = np.asarray(kref(*[p[0] for p in pairs]), np.float64)
    got = kport(*[p[1] for p in pairs])
    assert tuple(got.shape) == want.shape
    check(want, got.double().numpy(), margin)


RNG = np.random.default_rng(19)


def test_generator_gemm_kernel():
    for flags in (GemmFlags.BETA_0, GemmFlags.NONE):
        d = _desc(flags=flags)
        want, got = _both(lambda: x.generator_gemm_kernel(d),
                          lambda: xp.generator_gemm_kernel(port(d),
                                                           device=CPU))
        _same_meta(want, got)
        assert not got.is_reference_kernel
        assert "aten.mm.default(float32[16, 16], float32[16, 16])" \
            in got.code
        # beta=1 adds the C operand
        assert _operands(got.code) == ["float32[16, 16]"] * (
            2 if flags == GemmFlags.BETA_0 else 3)
        arrays = [RNG.standard_normal((16, 16))
                  for _ in _operands(got.code)]
        _run_both(x.xmmdispatch(d), xp.xmmdispatch(port(d)), arrays)


def test_generator_gemm_brgemm_forms():
    for brt in (BatchReduceType.STRIDE, BatchReduceType.ADDRESS):
        d = _desc(br=BatchReduceConfig(brt, br_count_hint=3))
        want, got = _both(lambda: x.generator_gemm_kernel(d),
                          lambda: xp.generator_gemm_kernel(port(d),
                                                           device=CPU))
        _same_meta(want, got)
        ops = _operands(got.code)
        assert ops[:2] == ["float32[3, 16, 16]"] * 2
        assert ops[2:] == ([] if brt == BatchReduceType.STRIDE
                           else ["int32[3]"] * 2)
    d = _desc(br=BatchReduceConfig(BatchReduceType.STRIDE, br_count_hint=3))
    _run_both(x.xmmdispatch(d), xp.xmmdispatch(port(d)),
              [RNG.standard_normal((3, 16, 16)) for _ in range(2)])


def test_generator_gemm_reference_kernel():
    d = _desc()
    before = xp.get_registry_info()["nkernels"]
    want, got = _both(lambda: x.generator_gemm_reference_kernel(d),
                      lambda: xp.generator_gemm_reference_kernel(port(d)))
    _same_meta(want, got)
    assert got.is_reference_kernel and "aten.mm" in got.code
    # built outside the registry: the dispatch cache got no kernel
    assert xp.get_registry_info()["nkernels"] == before
    kern = xp.xmmdispatch(port(d))
    assert not kern.info.is_reference_kernel
    assert not x.xmmdispatch(d).info.is_reference_kernel


def test_generator_gemm_rejects_non_descriptor():
    err, perr = _both(lambda: x.generator_gemm_kernel("not a descriptor"),
                      lambda: xp.generator_gemm_kernel("not a descriptor",
                                                       device=CPU))
    assert perr.code == err.code == rg.ERR_UNSUP_DESCRIPTOR
    assert xp.strerror(perr.code) == x.strerror(err.code)
    assert str(perr) == str(err)


def test_generator_mateltwise():
    d = x.meltw_descriptor_init(x.Datatype.F32, x.Datatype.F32, 8, 16,
                                op_type=x.UnaryType.GELU)
    want, got = _both(lambda: x.generator_mateltwise_kernel(d),
                      lambda: xp.generator_mateltwise_kernel(port(d),
                                                             device=CPU))
    _same_meta(want, got)
    want, got = _both(lambda: x.generator_mateltwise_reference_kernel(d),
                      lambda: xp.generator_mateltwise_reference_kernel(
                          port(d)))
    _same_meta(want, got)
    assert got.is_reference_kernel
    _run_both(x.dispatch_meltw(d), xp.dispatch_meltw(port(d)),
              [RNG.standard_normal((8, 16))])
    d2 = x.meltw_descriptor_init2(
        x.Datatype.BF16, x.Datatype.BF16, None, x.Datatype.F32,
        x.Datatype.BF16, 8, 16, op_type=x.BinaryType.MUL,
        operation="binary")
    want, got = _both(lambda: x.generator_mateltwise_kernel(d2),
                      lambda: xp.generator_mateltwise_kernel(port(d2),
                                                             device=CPU))
    _same_meta(want, got)
    assert "bf16" in want.code and "bfloat16[8, 16]" in got.code
    # unknown operations surface as ERR_UNSUP_DESCRIPTOR in both
    bad = dataclasses.replace(d, operation="quaternary")
    for gen, pgen in ((x.generator_mateltwise_kernel,
                       xp.generator_mateltwise_kernel),
                      (x.generator_mateltwise_reference_kernel,
                       xp.generator_mateltwise_reference_kernel)):
        err, perr = _both(lambda: gen(bad),
                          lambda: pgen(dataclasses.replace(
                              port(d), operation="quaternary")))
        assert perr.code == rg.ERR_UNSUP_DESCRIPTOR


def _equation(pkg):
    idx = pkg.meqn_create()
    pkg.meqn_push_back_binary_op(idx, pkg.BinaryType.ADD)
    pkg.meqn_push_back_unary_op(idx, pkg.UnaryType.RELU)
    pkg.meqn_push_back_arg(idx, 8, 8, 0)
    pkg.meqn_push_back_arg(idx, 8, 8, 1)
    return idx


def test_generator_matequation():
    ri, pi = _equation(x), _equation(xp)
    try:
        want, got = _both(lambda: x.generator_matequation_kernel(ri),
                          lambda: xp.generator_matequation_kernel(
                              pi, device=CPU))
        _same_meta(want, got)
        # the relu: XLA's maximum, the port's clamp_min
        assert "maximum" in want.code and "aten.clamp_min" in got.code
        want, got = _both(
            lambda: x.generator_matequation_reference_kernel(ri),
            lambda: xp.generator_matequation_reference_kernel(pi))
        _same_meta(want, got)
        assert got.is_reference_kernel
        _run_both(x.dispatch_meqn(ri, 8, 8), xp.dispatch_meqn(pi, 8, 8),
                  [RNG.standard_normal((8, 8)) for _ in range(2)])
    finally:
        x.meqn_destroy(ri)
        xp.meqn_destroy(pi)


def test_generator_packed_dense():
    shape = GemmShape(8, 8, 8)
    for name in ("generator_packed_gemm", "generator_packed_gemm_ac_rm",
                 "generator_packed_gemm_bc_rm"):
        want, got = _both(
            lambda: getattr(x, name)(shape, GemmFlags.BETA_0, 4),
            lambda: getattr(xp, name)(port(shape), xp.GemmFlags.BETA_0, 4,
                                      device=CPU))
        _same_meta(want, got)
    kref = x.create_packed_gemm(shape, GemmFlags.BETA_0, 4)
    kport = xp.create_packed_gemm(port(shape), xp.GemmFlags.BETA_0, 4)
    _run_both(kref, kport, [RNG.standard_normal((8, 8, 4))
                            for _ in range(2)])


def _sparse(shape, density, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random(shape) < density)
            * rng.standard_normal(shape)).astype(np.float32)


def test_generator_packed_spgemm_and_areg():
    a = _sparse((8, 12), 0.4, 1)
    csr = CsrMatrix.from_dense(a)
    shape = GemmShape(8, 16, 12)
    want, got = _both(
        lambda: x.generator_packed_spgemm_csr_kernel(
            shape, GemmFlags.BETA_0, 1, csr.indptr, csr.indices),
        lambda: xp.generator_packed_spgemm_csr_kernel(
            port(shape), xp.GemmFlags.BETA_0, 1, csr.indptr, csr.indices,
            device=CPU))
    _same_meta(want, got)
    kref = x.create_packed_spgemm_csr(shape, GemmFlags.BETA_0, 1,
                                      csr.indptr, csr.indices)
    kport = xp.create_packed_spgemm_csr(port(shape), xp.GemmFlags.BETA_0, 1,
                                        csr.indptr, csr.indices, device=CPU)
    _run_both(kref, kport, [csr.data, RNG.standard_normal((12, 16))])
    vals = a[a != 0]
    want, got = _both(
        lambda: x.generator_spgemm_csr_reg_kernel(shape, csr.indptr,
                                                  csr.indices, vals),
        lambda: xp.generator_spgemm_csr_reg_kernel(
            port(shape), csr.indptr, csr.indices, vals, device=CPU))
    _same_meta(want, got)

    b = _sparse((64, 64), 0.5, 2)
    bc = BcscMatrix.from_dense(b, 32, 32)
    s2 = GemmShape(16, 64, 64)
    want, got = _both(
        lambda: x.generator_packed_spgemm_bcsc_kernel(
            s2, GemmFlags.BETA_0, SpgemmConfig(1, 32, 32), bc.indptr,
            bc.indices),
        lambda: xp.generator_packed_spgemm_bcsc_kernel(
            port(s2), xp.GemmFlags.BETA_0, xp.SpgemmConfig(1, 32, 32),
            bc.indptr, bc.indices, device=CPU))
    _same_meta(want, got)
    kref = x.create_packed_spgemm_bcsc(
        s2, GemmFlags.BETA_0, SpgemmConfig(1, 32, 32), column_ptr=bc.indptr,
        row_idx=bc.indices, strategy="dense")
    kport = xp.create_packed_spgemm_bcsc(
        port(s2), xp.GemmFlags.BETA_0, xp.SpgemmConfig(1, 32, 32),
        column_ptr=bc.indptr, row_idx=bc.indices, strategy="dense",
        device=CPU)
    _run_both(kref, kport, [RNG.standard_normal((16, 64)), bc.data])
    csc = CscMatrix.from_dense(b)
    want, got = _both(
        lambda: x.generator_packed_spgemm_csc_kernel(
            s2, GemmFlags.BETA_0, 1, csc.indptr, csc.indices),
        lambda: xp.generator_packed_spgemm_csc_kernel(
            port(s2), xp.GemmFlags.BETA_0, 1, csc.indptr, csc.indices,
            device=CPU))
    _same_meta(want, got)


def test_generator_packed_spgemm_beta1_has_c_operand():
    """A beta=1 descriptor runs WITH the C operand in both packages: one
    more operand than beta=0 (the reference module's @main arity, the
    port's operand list)."""
    a = _sparse((8, 12), 0.4, 3)
    csr = CsrMatrix.from_dense(a)
    shape = GemmShape(8, 16, 12)

    def n_inputs(gen):
        m = re.search(r"func\.func public @main\((.*?)\)", gen.code)
        return m.group(1).count("tensor<")

    for flags in (GemmFlags.BETA_0, GemmFlags.NONE):
        want, got = _both(
            lambda: x.generator_packed_spgemm_csr_kernel(
                shape, flags, 1, csr.indptr, csr.indices),
            lambda: xp.generator_packed_spgemm_csr_kernel(
                port(shape), xp.GemmFlags(int(flags)), 1, csr.indptr,
                csr.indices, device=CPU))
        assert len(_operands(got.code)) == n_inputs(want)
    assert len(_operands(got.code)) == 3          # values, b, c
    b = _sparse((64, 64), 0.5, 4)
    csc = CscMatrix.from_dense(b)
    cc = CscMatrix.from_dense(_sparse((16, 64), 0.5, 5))
    bc = BcscMatrix.from_dense(b, 32, 32)
    s2 = GemmShape(16, 64, 64)
    for ref_fn, port_fn in (
            (lambda: x.generator_packed_spgemm_csc_kernel(
                s2, GemmFlags.NONE, 1, csc.indptr, csc.indices),
             lambda: xp.generator_packed_spgemm_csc_kernel(
                 port(s2), xp.GemmFlags.NONE, 1, csc.indptr, csc.indices,
                 device=CPU)),
            (lambda: x.generator_packed_spgemm_bcsc_kernel(
                s2, GemmFlags.NONE, SpgemmConfig(1, 32, 32), bc.indptr,
                bc.indices),
             lambda: xp.generator_packed_spgemm_bcsc_kernel(
                 port(s2), xp.GemmFlags.NONE, xp.SpgemmConfig(1, 32, 32),
                 bc.indptr, bc.indices, device=CPU)),
            # SDDMM (C sparse): the pattern is C's, (m, n)
            (lambda: x.generator_packed_spgemm_csc_kernel(
                s2, GemmFlags.NONE, 1, cc.indptr, cc.indices,
                sparse_operand="c"),
             lambda: xp.generator_packed_spgemm_csc_kernel(
                 port(s2), xp.GemmFlags.NONE, 1, cc.indptr, cc.indices,
                 sparse_operand="c", device=CPU))):
        want, got = _both(ref_fn, port_fn)
        assert len(_operands(got.code)) == n_inputs(want) == 3
    # B's (64, 64) pattern as C's (16, 64) one: rows past m. The JAX
    # package traces it (an XLA gather clamps its indices); the port runs
    # the call, whose gather refuses them
    want = x.generator_packed_spgemm_csc_kernel(
        s2, GemmFlags.NONE, 1, csc.indptr, csc.indices, sparse_operand="c")
    assert n_inputs(want) == 3
    with pytest.raises(pg.XsmmGeneratorError) as ei:
        xp.generator_packed_spgemm_csc_kernel(
            port(s2), xp.GemmFlags.NONE, 1, csc.indptr, csc.indices,
            sparse_operand="c", device=CPU)
    assert ei.value.code == pg.ERR_TRACE_FAILED


def test_generator_spgemm_csc_kernel_index_conversion(monkeypatch):
    """The legacy CSC entry converts to CSR at generate time: the same
    indptr, indices and values in both packages, and a kernel computing
    A @ B for the CSC-described A."""
    m, k, n = 6, 9, 8
    a = _sparse((m, k), 0.4, 5)
    cols = [np.nonzero(a[:, j])[0] for j in range(k)]
    column_ptr = np.concatenate(
        [[0], np.cumsum([len(c) for c in cols])]).astype(np.int32)
    row_idx = np.concatenate(cols).astype(np.int32)
    values = np.concatenate([a[c, j] for j, c in enumerate(cols)])
    seen = {}

    def spy(pkg, name):
        real = getattr(pkg, "generator_spgemm_csr_reg_kernel")

        def fn(shape, indptr, indices, vals, flags=GemmFlags.BETA_0,
               *rest, **kw):
            seen[name] = (np.asarray(indptr), np.asarray(indices),
                          np.asarray(vals))
            return real(shape, indptr, indices, vals, flags, *rest, **kw)

        monkeypatch.setattr(pkg, "generator_spgemm_csr_reg_kernel", fn)

    spy(rg, "ref")
    spy(pg, "port")
    want, got = _both(
        lambda: x.generator_spgemm_csc_kernel(GemmShape(m, n, k), None,
                                              column_ptr, row_idx, values),
        lambda: xp.generator_spgemm_csc_kernel(
            port(GemmShape(m, n, k)), None, column_ptr, row_idx, values,
            device=CPU))
    _same_meta(want, got)
    for r, p in zip(seen["ref"], seen["port"]):
        np.testing.assert_array_equal(p, r)
    indptr, indices, vals = seen["port"]
    kport = xp.create_spgemm_csr_areg(port(GemmShape(m, n, k)),
                                      xp.GemmFlags.BETA_0, indptr, indices,
                                      vals, device=CPU)
    bm = RNG.standard_normal((k, n)).astype(np.float32)
    check((a.astype(np.float64) @ bm), kport(torch.from_numpy(bm))
          .double().numpy(), 1e-5)


_HEADER = re.compile(r"^(//|;;) routine: (\S+)  arch: (\S+)  kind: (\S+)  "
                     r"size: (\d+)$", re.M)


def _headers(path):
    """The header lines of a text-mode file, with their arch and size
    values cut out, and each size against the text it heads."""
    text = open(path).read()
    out = []
    for m in _HEADER.finditer(text):
        out.append(m.group(0).replace(f"arch: {m.group(3)}", "arch: _")
                   .replace(f"size: {m.group(5)}", "size: _"))
        body = text[m.end() + 1:m.end() + 1 + int(m.group(5))]
        assert len(body) == int(m.group(5))
    return out


def test_generator_text_modes(tmp_path):
    d = _desc(8, 8, 8)
    for pkg, sub, kw in ((x, "ref", {}), (xp, "port", {"device": CPU})):
        (tmp_path / sub).mkdir()
        desc = d if pkg is x else port(d)
        cfile = str(tmp_path / sub / "kernels.c")
        sfile = str(tmp_path / sub / "kernels.s")
        pkg.generator_gemm_inlineasm(cfile, "k8", desc, **kw)
        pkg.generator_gemm_inlineasm(cfile, "k8b", desc, **kw)   # appends
        pkg.generator_gemm_directasm(sfile, "k8", desc, **kw)
    for name in ("kernels.c", "kernels.s"):
        ref = _headers(tmp_path / "ref" / name)
        got = _headers(tmp_path / "port" / name)
        assert got == ref and len(got) == (2 if name == "kernels.c" else 1)
    assert open(tmp_path / "port" / "kernels.s").read().startswith(
        ";; routine: k8  arch: cpu  kind: gemm  size: ")


def test_generator_spgemm_from_mtx(tmp_path):
    a = _sparse((8, 12), 0.4, 6)
    from libxsmm_tpu.utils.mtx import write_mtx
    mtx = str(tmp_path / "a.mtx")
    write_mtx(mtx, a)
    outs = {}
    for pkg, sub, kw in ((x, "ref", {}), (xp, "port", {"device": CPU})):
        out = str(tmp_path / f"{sub}.c")
        shape = GemmShape(8, 16, 12) if pkg is x else port(
            GemmShape(8, 16, 12))
        pkg.generator_spgemm(out, "spk", shape, None, mtx, 1, **kw)
        outs[sub] = out
    assert _headers(outs["port"]) == _headers(outs["ref"])
    assert "// routine: spk" in open(outs["port"]).read()
    missing = str(tmp_path / "missing.mtx")
    err, perr = _both(
        lambda: x.generator_spgemm(outs["ref"], "spk", GemmShape(8, 16, 12),
                                   None, missing, 1),
        lambda: xp.generator_spgemm(outs["port"], "spk",
                                    port(GemmShape(8, 16, 12)), None,
                                    missing, 1, device=CPU))
    assert perr.code == rg.ERR_BAD_INPUT_FILE


def test_strerror_contract():
    for code in (rg.ERR_GENERAL, rg.ERR_UNSUP_DATATYPE,
                 rg.ERR_UNSUP_DESCRIPTOR, rg.ERR_TRACE_FAILED,
                 rg.ERR_BAD_INPUT_FILE, 12345):
        assert xp.strerror(code) == x.strerror(code)
    assert (pg.ERR_GENERAL, pg.ERR_UNSUP_DATATYPE, pg.ERR_UNSUP_DESCRIPTOR,
            pg.ERR_TRACE_FAILED, pg.ERR_BAD_INPUT_FILE) == (
        90000, 90011, 90012, 90013, 90014)
    assert "example" in xp.strerror(pg.ERR_TRACE_FAILED)


def test_generated_code_dump_roundtrip(tmp_path, monkeypatch):
    """GeneratedCode is the text the registry's dump path writes; the same
    descriptor and operands give the same text twice."""
    d = port(_desc(8, 8, 8))
    g = xp.generator_gemm_kernel(d, device=CPU)
    kern = xp.xmmdispatch(d)
    avals = [torch.empty(8, 8, device="meta")] * 2
    assert kern.lower_text(*avals, device=CPU) == g.code
    assert xp.generator_gemm_kernel(d, device=CPU).code == g.code
    # real tensors: their device and shapes, zeros as values
    assert kern.lower_text(torch.randn(8, 8), torch.randn(8, 8)) == g.code
    monkeypatch.setattr(xp.config.CONFIG, "dump_dir", str(tmp_path))
    path = kern.dump(*avals, device=CPU)
    assert path.endswith(f"{kern.name}.cuda.txt")
    assert open(path).read() == g.code
    ref = x.generator_gemm_kernel(_desc(8, 8, 8))
    refk = x.xmmdispatch(_desc(8, 8, 8))
    assert refk.lower_text(*[jax.ShapeDtypeStruct((8, 8), np.float32)] * 2
                           ) == ref.code


@pytest.mark.parametrize("flags", ["", "TRANS_A", "TRANS_B"])
@pytest.mark.parametrize("dt", ["F32", "BF16"])
def test_encoder_driver(flags, dt):
    """samples/encoder.py's structural checks on the emitted code, on the
    port's text: the declared operand dtypes and shapes (TRANS flags
    transpose the declared operand), the product an aten matmul of the
    declared result; and the generated kernel runs to the JAX package's
    result."""
    fl = GemmFlags.BETA_0 | (GemmFlags[flags] if flags else GemmFlags.NONE)
    t = Datatype[dt]
    d = _desc(16, 24, 32, fl, a_in_type=t, b_in_type=t,
              out_type=Datatype.F32)
    want, got = _both(lambda: x.generator_gemm_kernel(d),
                      lambda: xp.generator_gemm_kernel(port(d), device=CPU))
    _same_meta(want, got)
    name = {"F32": "float32", "BF16": "bfloat16"}[dt]
    a_shape = "[32, 16]" if flags == "TRANS_A" else "[16, 32]"
    b_shape = "[24, 32]" if flags == "TRANS_B" else "[32, 24]"
    assert _operands(got.code) == [f"{name}{a_shape}", f"{name}{b_shape}"]
    assert "// result: float32[16, 24]" in got.code
    assert re.search(r"aten\.(mm|matmul|bmm)", got.code)
    shapes = [tuple(int(v) for v in s[1:-1].split(", "))
              for s in (a_shape, b_shape)]
    _run_both(x.xmmdispatch(d), xp.xmmdispatch(port(d)),
              [RNG.standard_normal(s) for s in shapes], [t, t],
              1e-5 if dt == "F32" else 1e-4)


def test_generator_gemm_vnni_avals_derived():
    """VNNI-packed operand shapes follow from the flag and the dtype's pack
    factor in both packages, and the kernels agree on VNNI operands."""
    for fl in (GemmFlags.VNNI_A, GemmFlags.VNNI_B,
               GemmFlags.VNNI_A | GemmFlags.VNNI_B):
        d = GemmDescriptor(
            shape=GemmShape(16, 32, 64, a_in_type=Datatype.BF16,
                            b_in_type=Datatype.BF16,
                            out_type=Datatype.F32),
            flags=fl | GemmFlags.BETA_0)
        want, got = _both(lambda: x.generator_gemm_kernel(d),
                          lambda: xp.generator_gemm_kernel(port(d),
                                                           device=CPU))
        _same_meta(want, got)
        a_shape = (8, 128) if fl & GemmFlags.VNNI_A else (16, 64)
        b_shape = (32, 64) if fl & GemmFlags.VNNI_B else (64, 32)
        assert _operands(got.code) == [
            f"bfloat16{list(a_shape)}", f"bfloat16{list(b_shape)}"]
        _run_both(x.xmmdispatch(d), xp.xmmdispatch(port(d)),
                  [RNG.standard_normal(a_shape),
                   RNG.standard_normal(b_shape)],
                  [Datatype.BF16] * 2, 1e-4)


def test_generator_reference_kernel_error_contract():
    err, perr = _both(
        lambda: x.generator_gemm_reference_kernel("not a descriptor"),
        lambda: xp.generator_gemm_reference_kernel("not a descriptor"))
    assert perr.code == err.code == rg.ERR_UNSUP_DESCRIPTOR


def test_generator_arch_targets():
    """arch takes the port's target names; other names raise, and the
    target is left as it was."""
    d = port(_desc(8, 8, 8))
    try:
        pg._retarget("h100")
        assert xp.get_geometry().name == "h100"
        with pytest.raises(ValueError, match="unknown target 'v5e'"):
            pg._retarget("v5e")
        assert xp.get_geometry().name == "h100"
        g = xp.generator_spgemm_csr_kernel(
            port(GemmShape(4, 4, 4)), "cpu", np.array([0, 1, 1, 1, 1]),
            np.array([0]), np.array([1.0], np.float32), device=CPU)
        assert g.arch == "cpu"
    finally:
        xp.set_target(None)
    assert xp.generator_gemm_kernel(d, device=CPU).arch == "cpu"
