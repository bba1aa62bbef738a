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
                         + [ROOT / "chip_smoke.py",
                            ROOT / "tests" / "torch_parallel_ranks.py",
                            ROOT / "tests" / "torch_sharded_ranks.py",
                            ROOT / "tests" / "test_torch_cuda_sharded.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


# packages of finished kernels: the port's kernels are its own
KERNEL_LIBRARIES = ("flash_attn", "xformers", "apex", "transformer_engine",
                    "cupy", "triton", "deepspeed", "megatron", "fairscale")


@pytest.mark.parametrize("path", [
    PKG / "parallel" / "spmd.py", PKG / "parallel" / "collectives.py",
    PKG / "models" / "tpp_attention.py", PKG / "models" / "tpp_mlp.py",
    PKG / "models" / "tpp_cnn.py", PKG / "models" / "tpp_gcn.py",
    PKG / "models" / "tpp_moe.py", ROOT / "tests" / "torch_sharded_ranks.py",
    ROOT / "tests" / "test_torch_cuda_sharded.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_sharded_steps_import_no_kernel_library(path):
    """The sharded train steps and their tests import no JAX and no
    library of finished kernels (no library GEMM or attention, no
    Megatron): the collectives are the port's own (parallel/collectives.py)
    and the attention and dropout its hand-written kernels. No path calls
    PyTorch's attention or dropout in their place, nor DTensor's
    redistribution."""
    mods = [m.split(".")[0] for m in _imports(path)]
    bad = [m for m in mods if m in FORBIDDEN + KERNEL_LIBRARIES]
    assert not bad, f"{path} imports {bad}"
    text = path.read_text()
    for word in ("scaled_dot_product_attention", "F.dropout(",
                 "functional.dropout", "redistribute(", "torch.compile"):
        assert word not in text, f"{path} uses {word}"


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


def test_wgmma_header_is_hand_written():
    """The Hopper path's PTX is the port's own: wgmma on bf16 tiles that
    TMA (cp.async.bulk.tensor) stages, paced by mbarriers, with the tensor
    map encoded through a run-time lookup of cuTensorMapEncodeTiled (no
    -lcuda)."""
    csrc = PKG / "kernels" / "csrc"
    wg = (csrc / "xsmm_wgmma.cuh").read_text()
    for needle in ("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16",
                   "cp.async.bulk.tensor.2d", "cp.async.bulk.tensor.3d",
                   "mbarrier.try_wait.parity", "wgmma.fence",
                   "wgmma.commit_group", "wgmma.wait_group"):
        assert needle in wg, needle
    assert "cuTensorMapEncodeTiled" in wg and "static bool encode_map(" in wg
    for name in ("gemm_kernels.cu", "spmm_lab_kernels.cu"):
        src = (csrc / name).read_text()
        assert '#include "xsmm_wgmma.cuh"' in src
        assert "encode_map(" in src and "__grid_constant__" in src
        assert "cudaGetDriverEntryPoint" not in src   # the header's only
    build = (PKG / "kernels" / "_build.py").read_text()
    assert "-lcuda" not in build


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
    # the meltw kernels, an equation and the MoE model
    relu = xp.dispatch_meltw_unary(xp.UnaryType.RELU, 2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        relu(x[0])
    idx = xp.meqn_create()
    xp.meqn_push_back_binary_op(idx, xp.BinaryType.ADD)
    xp.meqn_push_back_arg(idx, 2, 2, in_pos=0)
    xp.meqn_push_back_arg(idx, 2, 2, in_pos=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xp.dispatch_meqn(idx, 2, 2)(x[0], x[0])
    xp.meqn_destroy(idx)
    from libxsmm_torch.models import tpp_moe
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpp_moe.init_params(tpp_moe.MoeConfig(dim=4, hidden=8, n_experts=2))


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


def _ranks():
    sys.path.insert(0, str(ROOT / "tests"))
    try:
        import torch_parallel_ranks
    finally:
        sys.path.pop(0)
    from libxsmm_torch.scripts.ranks import run_ranks
    return torch_parallel_ranks, run_ranks


def test_spawned_ranks_leave_jax_out():
    """A rank of the launcher (scripts/ranks.py) imports the rank functions'
    module and the port afresh, and no JAX: this process has JAX loaded."""
    R, run_ranks = _ranks()
    assert run_ranks(R.world_modules, 2, timeout=120.0) == [[], []]


def test_hanging_rank_is_killed_at_the_timeout(tmp_path):
    """A world whose ranks outlive the launcher's timeout raises
    TimeoutError (the test fails, not the session), and every rank process
    is gone afterwards."""
    import time
    R, run_ranks = _ranks()
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="ranks killed"):
        run_ranks(R.world_hang, 2, (600, str(tmp_path)), timeout=30.0)
    assert time.monotonic() - t0 < 60.0
    pids = [int(p.read_text()) for p in sorted(tmp_path.glob("*.pid"))]
    assert len(pids) == 2
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_failing_rank_ends_the_world():
    """One rank's exception ends the world at once (the other, waiting in a
    collective, is killed) and raises with the failing rank's stderr."""
    import time
    R, run_ranks = _ranks()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        run_ranks(R.world_fail, 2, timeout=120.0)
    assert time.monotonic() - t0 < 60.0


def test_failing_ranks_all_reported():
    """Every rank that fails is named and its standard error is in the
    message, though the launcher sees the first rank's exit half a second
    before the second's."""
    R, run_ranks = _ranks()
    with pytest.raises(RuntimeError) as ei:
        run_ranks(R.world_fail_in_order, 2, timeout=120.0)
    msg = str(ei.value)
    assert "ranks [0, 1] failed" in msg
    assert "rank 0 gives up first" in msg and "rank 1 gives up later" in msg
    assert msg.index("--- rank 0 ---") < msg.index("--- rank 1 ---")
