"""libxsmm_torch stands alone: it never imports jax or libxsmm_tpu, its
CUDA source uses no library GEMM and no TF32, its entry points default to
the GPU (raising without one), and chip_smoke.py refuses to report without
a GPU.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "libxsmm_torch"
FORBIDDEN = ("jax", "jaxlib", "libxsmm_tpu")

torch.set_num_threads(1)


def _env(with_repo: bool):
    """The current environment, with the repo root first on PYTHONPATH or
    (with_repo=False) kept off it."""
    env = dict(os.environ)
    paths = [q for q in env.get("PYTHONPATH", "").split(os.pathsep)
             if q and pathlib.Path(q).resolve() != ROOT]
    if with_repo:
        paths.insert(0, str(ROOT))
    env["PYTHONPATH"] = os.pathsep.join(paths)
    return env


def test_import_leaves_jax_out():
    code = ("import sys, importlib, pkgutil, libxsmm_torch\n"
            "for m in pkgutil.walk_packages(libxsmm_torch.__path__, "
            "'libxsmm_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print('LOADED', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=_env(True), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_labs_leave_jax_out():
    """The labs (libxsmm_torch.scripts) import and parse their arguments
    without JAX or the JAX package, as `python3 -m` runs them."""
    code = ("import sys\n"
            "from libxsmm_torch.scripts import bcsc_lab, brgemm_lab\n"
            "for lab in (bcsc_lab, brgemm_lab):\n"
            "    try:\n"
            "        lab.main(['--help'])\n"
            "    except SystemExit as e:\n"
            "        assert e.code == 0\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print('LOADED', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=_env(True), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
    assert "--density" in out.stdout and "--rounds" in out.stdout


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_cuda_source_is_hand_written():
    """No library GEMM and no PyTorch headers in the sources or the shared
    headers. The tensor cores are reached only through hand-written PTX on
    bf16 tiles (csrc/xsmm_mma.cuh), never in TF32: f32 means f32."""
    for src in (PKG / "kernels" / "csrc").glob("*.cu*"):
        text = src.read_text().lower()
        for word in ("cublas", "cudnn", "cutlass", "cute/", "torch/", "at::",
                     "wmma", ".tf32"):
            assert word not in text, f"{src.name} uses {word}"
    mma = (PKG / "kernels" / "csrc" / "xsmm_mma.cuh").read_text()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in mma


def test_device_defaults_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    import libxsmm_torch as xp
    from libxsmm_torch import interop
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xp.default_device()
    x = np.zeros((4, 2, 2), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xp.pack_batched(x, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xp.unpack_batched(x, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xp.sgemm(x[0], x[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        interop.tensor_from_numpy(x, xp.Datatype.F32)
    k = xp.dispatch_gemm_batched_packed(xp.GemmShape(2, 2, 2),
                                        xp.GemmFlags.BETA_0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        k(np.zeros((1, 2, 128), np.float32), np.zeros((1, 2, 128),
                                                      np.float32))


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run")
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        cwd, env = tmp_path, _env(False)
    else:
        cwd, env = ROOT, _env(True)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
