"""xgemm: the GEMM acceptance matrix's driver (samples/xgemm.py's main) on
the port.

    python -m libxsmm_torch.samples.xgemm [ncases] [--bench] [--device cpu]
    python -m libxsmm_torch.samples.xgemm --full [--bench] [--device cpu]

Runs `ncases` classes (default 25) drawn from the sample's seed out of
libxsmm_torch.xgemm's class table, or with --full every class, each
through xgemm.run_class against its float64 oracle. --bench times each
plain GEMM/BRGEMM class's kernel after its check (GF/s from the kernel's
nflops). With --full the tally prints as one line, "xgemm_full {...}";
no file is written. Returns 0 when every class passes, else 1.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import time

import numpy as np

from . import _common


def draw(classes, ncases: int, rng):
    """The sample's random draw of `ncases` classes (before any class
    runs, from the same generator)."""
    return [classes[int(rng.integers(0, len(classes)))]
            for _ in range(ncases)]


def _commit():
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=pathlib.Path(__file__).resolve().parents[2],
            capture_output=True, text=True, timeout=10).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    ap = _common.add_device(argparse.ArgumentParser(
        description="the GEMM acceptance matrix"))
    ap.add_argument("ncases", nargs="?", type=int, default=25)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--bench", action="store_true")
    args = ap.parse_args(argv)
    dev = _common.device(args.device)
    import libxsmm_torch as xp
    from libxsmm_torch import xgemm as PX

    rng = np.random.default_rng(20260816)
    classes = PX.build_class_list()
    if args.full:
        todo = classes
        print(f"xgemm --full: {len(classes)} descriptor classes")
    else:
        todo = draw(classes, args.ncases, rng)
    if args.bench:
        print(f"times: {_common.clock(dev)}")
    results = []
    for cls in todo:
        keep = {}
        try:
            ok, label, err = PX.run_class(cls, rng, dev, keep=keep)
        except Exception as e:                     # noqa: BLE001
            print(f"FAIL {cls}: {type(e).__name__}: {e}")
            results.append(False)
            continue
        gflops = ""
        if ok and args.bench and keep and not keep["extra"]:
            per = _common.timed([(keep["kern"], keep["args"])], dev,
                                reps=50)[0]
            gflops = (f"  {xp.get_kernel_info(keep['kern']).nflops / per / 1e9:8.1f}"
                      " GF/s")
        if ok:
            print(f"OK   {label:64s} normf_rel={err:.2e}{gflops}")
        results.append(bool(ok))
    info = xp.get_registry_info()
    print(f"\n{sum(results)}/{len(results)} passed; registry: "
          f"{info['nkernels']} kernels, {info['hits']} hits")
    if args.full:
        tally = {"classes": len(todo), "pass": int(sum(results)),
                 "ref_fallbacks": int(info["fallbacks"]),
                 "device": "gpu" if dev.type == "cuda" else "cpu",
                 "ran_at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
                 "commit": _commit()}
        print("xgemm_full " + json.dumps(tally))
    return 0 if all(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
