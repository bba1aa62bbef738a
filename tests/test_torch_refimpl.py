"""The port's reference-oracle loader (libxsmm_torch.utils.refimpl) against
the JAX package's (libxsmm_tpu.utils.refimpl), on the CPU. The oracle
library (native/libxsmm_refimpl.so) is built from a libxsmm checkout that
this repo does not hold: without the library and without a checkout named
by XSMM_REFERENCE_DIR, available() is False, the loader returns None and
nothing is built. The datatype codes equal the JAX package's for every
Datatype.
"""

import subprocess

import numpy as np
import pytest

import libxsmm_torch as xp
from libxsmm_torch.utils import refimpl
from libxsmm_tpu.utils import refimpl as ref_refimpl


@pytest.fixture
def fresh(monkeypatch, tmp_path):
    """The loader as at import, pointed at a library path that does not
    exist; any subprocess (a build) is recorded and fails."""
    calls = []

    def run(cmd, *a, **kw):
        calls.append(cmd)
        raise subprocess.CalledProcessError(1, cmd)

    monkeypatch.setattr(refimpl, "_SO", str(tmp_path / "none.so"))
    monkeypatch.setattr(refimpl, "_lib", None)
    monkeypatch.setattr(refimpl, "_tried", False)
    monkeypatch.setattr(refimpl.subprocess, "run", run)
    monkeypatch.delenv("XSMM_REFERENCE_DIR", raising=False)
    return calls


def test_unavailable_without_library(fresh):
    assert refimpl.available() is False
    assert refimpl._load() is None
    assert fresh == []                      # nothing was built
    a = np.zeros((2, 2), np.float32, order="F")
    for call in (lambda: refimpl.ref_gemm(2, 2, 2, *[xp.Datatype.F32] * 4,
                                          0, a, a, a),
                 lambda: refimpl.ref_matdiff(a, a, xp.Datatype.F32),
                 lambda: refimpl.ref_meltw(0, 0, 0, 2, 2, xp.Datatype.F32,
                                           xp.Datatype.F32, xp.Datatype.F32,
                                           a, out=a)):
        with pytest.raises(RuntimeError, match="oracle library unavailable"):
            call()


def test_checkout_without_sources_builds_nothing(fresh, monkeypatch,
                                                 tmp_path):
    monkeypatch.setenv("XSMM_REFERENCE_DIR", str(tmp_path / "libxsmm"))
    (tmp_path / "libxsmm").mkdir()
    assert refimpl.available() is False and fresh == []


def test_checkout_build_failure_gives_none(fresh, monkeypatch, tmp_path):
    """With a checkout named, the loader runs the build script; its failure
    leaves the oracle unavailable."""
    (tmp_path / "libxsmm" / "src").mkdir(parents=True)
    monkeypatch.setenv("XSMM_REFERENCE_DIR", str(tmp_path / "libxsmm"))
    assert refimpl.available() is False
    assert len(fresh) == 1 and fresh[0][0] == "bash"
    assert fresh[0][1].endswith("scripts/build_ref_impl.sh")
    assert refimpl.available() is False and len(fresh) == 1   # tried once


def test_build_dir_is_private_and_removed(monkeypatch, tmp_path):
    """The script empties the build directory it is given: the loader gives
    it one of its own under TMPDIR, never the script's fixed default, and
    removes it after the build."""
    import os
    import tempfile
    seen = []

    def run(cmd, *a, **kw):
        seen.append((cmd, os.path.isdir(cmd[2])))
        raise subprocess.CalledProcessError(1, cmd)

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    (tmp_path / "libxsmm" / "src").mkdir(parents=True)
    monkeypatch.setenv("XSMM_REFERENCE_DIR", str(tmp_path / "libxsmm"))
    monkeypatch.setattr(refimpl, "_SO", str(tmp_path / "none.so"))
    monkeypatch.setattr(refimpl, "_lib", None)
    monkeypatch.setattr(refimpl, "_tried", False)
    monkeypatch.setattr(refimpl.subprocess, "run", run)
    assert refimpl.available() is False
    (cmd, existed), = seen
    bld = cmd[2]
    assert cmd[:2] == ["bash", refimpl._BUILD] and len(cmd) == 3
    assert os.path.dirname(bld) == tempfile.gettempdir()
    assert os.path.basename(bld).startswith("xsmm_refimpl_") and existed
    assert not os.path.exists(bld)          # removed after the build


@pytest.mark.parametrize("name", [d.name for d in xp.Datatype])
def test_dt_enum_matches(name):
    from libxsmm_tpu.dtypes import Datatype
    assert refimpl.dt_enum(xp.Datatype[name]) == ref_refimpl.dt_enum(
        Datatype[name])


def test_dt_enum_unsupported():
    assert refimpl.dt_enum(None) == ref_refimpl.dt_enum(None) == 26
    assert [f[0] for f in refimpl.MatdiffInfoC._fields_] == [
        f[0] for f in ref_refimpl.MatdiffInfoC._fields_]
