"""The port's samples (libxsmm_torch/samples/) against samples/ and
the JAX package, on the CPU (--device cpu: the kernels' plain versions).

* hello: the four outputs against samples/hello.py's (loaded by path, run
  through the JAX package), within 1e-6.
* eltwise: 60 cases from the sample's seed give the labels and shapes of
  samples/eltwise.py's run_case (its printed lines) in the same order; the
  deterministic kinds' outputs match the JAX sample's (recorded from its
  matdiff calls) within matdiff normf_rel 1e-6 (a reduction's order of
  summation differs), gather/scatter and i8 QUANT are exact in
  both, and the dropout's outputs agree with their own masks.
* equation: the 11 drivers' outputs against samples/equation.py's
  (recorded from its matdiff calls), matdiff normf_rel 1e-5.
* xgemm: the same ten classes as samples/xgemm.py's draw, all passing.
* smmbench at 8^3 x 64: each case against float64 (1e-5).
* dispatch_bench and utilities at small sizes: the registry's hits rise,
  the native registry's find returns the inserted value, the CRC equals
  the JAX package's native_bridge.crc32.
* Every sample raises "no CUDA device" without a card unless given
  --device cpu.
"""

import contextlib
import importlib
import importlib.util
import io
import pathlib
import re

import numpy as np
import pytest
import torch

from libxsmm_torch.matdiff import matdiff
from libxsmm_torch.samples import (dispatch_bench, eltwise, equation, hello,
                                   smmbench, utilities, xgemm)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SAMPLES = ("hello", "eltwise", "equation", "xgemm", "smmbench",
           "dispatch_bench", "utilities", "spmm", "probe_bcsc", "cnn",
           "pyfr", "spmm_scaling", "encoder")

torch.set_num_threads(1)


def _load(name):
    """samples/<name>.py loaded by path (samples/ stays off sys.path), its
    standard output captured; SystemExit at its end is caught."""
    spec = importlib.util.spec_from_file_location(
        f"samples_{name}", ROOT / "samples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            spec.loader.exec_module(mod)
        except SystemExit:
            pass
    return mod, out.getvalue()


# ---------------------------------------------------------------------------
# hello


@pytest.fixture(scope="module")
def jax_hello():
    return _load("hello")[0]


@pytest.mark.parametrize("idx,var", list(enumerate(("c1", "c2", "c3",
                                                     "c4"))))
def test_hello_matches_jax_sample(idx, var, jax_hello):
    name, got, ref = hello.walkthrough(CPU)[idx]
    want = np.asarray(getattr(jax_hello, var))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert matdiff(ref, got).normf_rel < 1e-5


def test_hello_main():
    assert hello.main(["--device", "cpu"]) == 0


# ---------------------------------------------------------------------------
# eltwise

NCASES = 60
_LINE = re.compile(r"^(OK  |FAIL) (.{28}) +(\d+)x(\d+)")


@pytest.fixture(scope="module")
def eltwise_pair():
    """(the JAX sample's [(label, (m, n), ok, output or None)], the port
    sample's run_case results), 60 cases each from the sample's seed."""
    rx = _load("eltwise")[0]
    recorded = []
    real = rx.matdiff

    def recorder(ref, out):
        recorded.append(np.asarray(out))
        return real(ref, out)

    rx.matdiff = recorder
    rng = np.random.default_rng(20260816)
    jax_cases = []
    for _ in range(NCASES):
        recorded.clear()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ok = rx.run_case(rng)
        mt = _LINE.match(buf.getvalue())
        jax_cases.append((mt.group(2).rstrip(), (int(mt.group(3)),
                                                 int(mt.group(4))),
                          bool(ok), recorded[0] if recorded else None))
    rng = np.random.default_rng(20260816)
    with contextlib.redirect_stdout(io.StringIO()):
        port_cases = [eltwise.run_case(rng, CPU) for _ in range(NCASES)]
    return jax_cases, port_cases


@pytest.mark.parametrize("i", range(NCASES))
def test_eltwise_case_matches_jax_sample(i, eltwise_pair):
    (jlabel, jshape, jok, jout), (label, shape, ok, out) = (
        eltwise_pair[0][i], eltwise_pair[1][i])
    assert (label, shape) == (jlabel, jshape)
    assert ok and jok
    if label.startswith("dropout"):
        fwd, inv = out
        # both outputs zero exactly where the forward dropped
        assert np.array_equal(fwd == 0, inv == 0)
    elif jout is not None:
        # the order of a reduction's sum differs: normf_rel, not elementwise
        assert out.shape == jout.shape
        assert matdiff(jout.astype(np.float64), out).normf_rel <= 1e-6


def test_eltwise_main():
    assert eltwise.main(["12", "--device", "cpu"]) == 0


# ---------------------------------------------------------------------------
# equation

EQN_NAMES = ("simple", "relu", "matmul", "layernorm", "simple_layernorm",
             "softmax", "gather_dot", "gather_reduce", "gather_bcstmul_add",
             "splitSGD", "bf16_x3_split_f32")


@pytest.fixture(scope="module")
def equation_pair():
    """({name: the JAX sample's output}, {name: (ref, port output, tol)})."""
    import sys
    jm = sys.modules["libxsmm_tpu.matdiff"]     # the module, not the name
    recorded = []
    real = jm.matdiff

    def recorder(ref, out):
        recorded.append(np.asarray(out, np.float32))
        return real(ref, out)

    jm.matdiff = recorder
    try:
        _, text = _load("equation")
    finally:
        jm.matdiff = real
    names = [ln.split()[0] for ln in text.splitlines()
             if re.match(r"^\w+ +(OK|FAIL)", ln)]
    port = {name: (ref, got, tol)
            for name, ref, got, tol in equation.drivers(CPU)}
    return dict(zip(names, recorded)), port


@pytest.mark.parametrize("name", EQN_NAMES)
def test_equation_driver_matches_jax_sample(name, equation_pair):
    jax_out, port = equation_pair
    ref, got, tol = port[name]
    assert matdiff(ref, got).normf_rel < tol
    assert matdiff(jax_out[name].astype(np.float64), got).normf_rel <= 1e-5


def test_equation_main():
    assert equation.main(["--device", "cpu"]) == 0


# ---------------------------------------------------------------------------
# xgemm


def _plain(cls):
    out = dict(cls)
    if "combo" in out:
        out["combo"] = tuple(getattr(v, "value", v) for v in out["combo"])
    return out


def test_xgemm_draws_the_jax_samples_classes():
    rx = _load("xgemm")[0]
    rng = np.random.default_rng(20260816)
    jclasses = rx.build_class_list()
    want = [jclasses[int(rng.integers(0, len(jclasses)))] for _ in range(10)]
    from libxsmm_torch import xgemm as PX
    got = xgemm.draw(PX.build_class_list(), 10,
                     np.random.default_rng(20260816))
    assert [_plain(c) for c in got] == [_plain(c) for c in want]


@pytest.mark.parametrize("bench", [False, True])
def test_xgemm_main_ten_classes_pass(bench, capsys):
    args = ["10", "--device", "cpu"] + (["--bench"] if bench else [])
    assert xgemm.main(args) == 0
    out = capsys.readouterr().out
    assert "10/10 passed" in out
    assert ("GF/s" in out and "host clock" in out) == bench


def test_xgemm_full_prints_tally_and_writes_nothing(tmp_path, monkeypatch,
                                                    capsys):
    """--full's tally line, over a table cut to three classes; no file is
    written (XGEMM_FULL.json is the JAX package's)."""
    from libxsmm_torch import xgemm as PX
    table = PX.build_class_list()
    monkeypatch.setattr(PX, "build_class_list",
                        lambda: [table[1], table[30], table[200]])
    before = (ROOT / "XGEMM_FULL.json").read_bytes()
    monkeypatch.chdir(tmp_path)
    assert xgemm.main(["--full", "--device", "cpu"]) == 0
    tally = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("xgemm_full ")]
    assert len(tally) == 1 and '"classes": 3' in tally[0]
    assert '"pass": 3' in tally[0] and '"device": "cpu"' in tally[0]
    assert list(tmp_path.iterdir()) == []
    assert (ROOT / "XGEMM_FULL.json").read_bytes() == before


# ---------------------------------------------------------------------------
# smmbench

SMM_CASES = smmbench.cases(8, 64, CPU)


@pytest.mark.parametrize("i", range(5))
def test_smmbench_case_against_float64(i):
    name, fn, args, ref, nbytes, flops, reps = SMM_CASES[i]
    out = fn(*args)
    assert tuple(out.shape) == tuple(ref.shape)
    assert matdiff(ref, out).normf_rel <= 1e-5, name


def test_smmbench_main(capsys):
    assert smmbench.main(["8", "64", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("OK normf_rel") == 5 and "host clock" in out


# ---------------------------------------------------------------------------
# dispatch_bench, utilities


def test_dispatch_bench_registry_and_find():
    r = dispatch_bench.measure(50, CPU)
    assert r["hits_after"] >= r["hits_before"] + 50
    assert r["found"] == 42
    assert dispatch_bench.main(["50", "--device", "cpu"]) == 0


def test_utilities_crc_matches_jax_native_bridge():
    from libxsmm_tpu import native_bridge
    data = utilities.crc_data()
    crc, gbs = utilities.crc_rate(data, reps=2)
    assert crc == native_bridge.crc32(data) and gbs > 0
    assert utilities.main(["64", "48", "--device", "cpu"]) == 0


# ---------------------------------------------------------------------------
# the device rule


@pytest.mark.parametrize("name", SAMPLES)
def test_sample_without_gpu_raises_no_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the samples run on it")
    mod = importlib.import_module(f"libxsmm_torch.samples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
