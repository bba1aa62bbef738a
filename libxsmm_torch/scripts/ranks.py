"""Run a function on the ranks of a torch.distributed world, one process a
rank.

    from libxsmm_torch.scripts.ranks import run_ranks
    results = run_ranks(fn, world, args, device_type="cpu", timeout=120)

`fn` is a function defined at the top level of a module that imports
neither JAX nor the JAX package (each rank imports it afresh); each rank
calls fn(*args) once its process group is up and returns the results in
rank order. The launcher:

  * spawns `world` processes (`python -m libxsmm_torch.scripts.ranks`),
    whose process group meets in a FileStore in a temporary directory (no
    ports, so concurrent worlds cannot collide);
  * runs one torch thread a rank (torch.set_num_threads(1) and
    OMP_NUM_THREADS=1);
  * hands each rank's result back through a file (torch.save in the rank,
    torch.load here: bytes only these processes wrote);
  * joins with a timeout: on expiry it kills every rank and raises
    TimeoutError with their standard error; when a rank fails, the others
    get GRACE seconds to exit before they are killed, and RuntimeError
    names every failed rank with every rank's standard error in rank
    order;
  * on the card (device_type "cuda") builds the CUDA kernels here first
    (kernels._build.build_all), so the ranks load them and none runs nvcc.

backend defaults to NCCL for "cuda" and gloo for "cpu"; several ranks on
one card need backend="gloo" (NCCL refuses two ranks on one card).
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import pathlib
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

_ROOT = pathlib.Path(__file__).resolve().parents[2]
# seconds the other ranks of a world get to exit after one rank failed
GRACE = 5.0


def _target(fn: Callable) -> tuple:
    """(module name, module file, function name) of a top-level function."""
    if "<" in fn.__qualname__ or "." in fn.__qualname__:
        raise ValueError(f"{fn.__qualname__} is not a top-level function")
    mod = sys.modules[fn.__module__]
    return fn.__module__, getattr(mod, "__file__", None), fn.__qualname__


def run_ranks(fn: Callable, world: int, args: Sequence[Any] = (),
              device_type: str = "cpu", backend: Optional[str] = None,
              timeout: float = 120.0) -> List[Any]:
    """fn(*args) on each of `world` ranks; their results in rank order."""
    import torch
    if device_type == "cuda":
        from ..kernels import _build
        _build.build_all()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="xsmm_ranks_"))
    procs = []
    try:
        with open(tmp / "spec.pkl", "wb") as f:
            pickle.dump({"target": _target(fn), "args": tuple(args),
                         "world": world, "device_type": device_type,
                         "backend": backend}, f)
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        env["PYTHONPATH"] = os.pathsep.join(
            [str(_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        for rank in range(world):
            err = open(tmp / f"rank{rank}.err", "wb")
            try:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "libxsmm_torch.scripts.ranks",
                     str(tmp), str(rank)], env=env, cwd=str(_ROOT),
                    stdout=err, stderr=subprocess.STDOUT))
            finally:
                err.close()
        deadline = time.monotonic() + timeout
        # poll, so that one rank's failure ends the world at once instead
        # of leaving the others to wait in a collective until the timeout
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"a world of {world} ranks ran past {timeout} s; ranks "
                    f"killed\n{_errors(tmp, world)}")
            time.sleep(0.05)
        if failed:
            raise RuntimeError(_failure(procs, tmp, world))
        return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                for r in range(world)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def _failure(procs, tmp: pathlib.Path, world: int) -> str:
    """The message of a world in which a rank failed. The other ranks get
    GRACE seconds to exit on their own before they are killed: a rank's
    failure often ends its peers too (a collective's connection reset), and
    a peer may exit before the rank that caused it, so the message names
    every failed rank and holds every rank's standard error in rank
    order."""
    deadline = time.monotonic() + GRACE
    while (any(p.poll() is None for p in procs)
           and time.monotonic() < deadline):
        time.sleep(0.05)
    killed = [r for r, p in enumerate(procs) if p.poll() is None]
    for r in killed:
        procs[r].kill()
        procs[r].wait()
    failed = [r for r, p in enumerate(procs)
              if r not in killed and p.returncode != 0]
    kill_note = (f"; ranks {killed} killed after {GRACE} s" if killed
                 else "")
    return f"ranks {failed} failed{kill_note}\n{_errors(tmp, world)}"


def _errors(tmp: pathlib.Path, world: int) -> str:
    out = []
    for r in range(world):
        path = tmp / f"rank{r}.err"
        text = path.read_text(errors="replace") if path.exists() else ""
        out.append(f"--- rank {r} ---\n{text[-4000:]}")
    return "\n".join(out)


def _load(target: tuple) -> Callable:
    name, file, fn = target
    if name != "__main__":
        try:
            return getattr(importlib.import_module(name), fn)
        except ModuleNotFoundError:
            if file is None:
                raise
    # a script run as __main__ or a module off the path: load it from its
    # file under another name, so its __main__ block does not run
    spec = importlib.util.spec_from_file_location(
        "_xsmm_rank_" + pathlib.Path(file).stem, file)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return getattr(mod, fn)


def _rank_main(tmp: str, rank: int) -> None:
    import torch
    import torch.distributed as dist
    from ..parallel.mesh import distributed_init
    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    with open(tmp / "spec.pkl", "rb") as f:
        spec = pickle.load(f)
    fn = _load(spec["target"])
    if spec["device_type"] == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    distributed_init(f"file://{tmp / 'store'}", spec["world"], rank,
                     backend=spec["backend"],
                     device_type=spec["device_type"])
    try:
        result = fn(*spec["args"])
        torch.save(result, tmp / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
