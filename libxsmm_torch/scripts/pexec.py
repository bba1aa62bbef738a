#!/usr/bin/env python3
"""Process-parallel command runner (scripts/pexec.py, the reference's
tool_pexec.sh analogue), in the port's package.

    # run each line of a command list, N-way parallel, logs under LOGDIR
    python -m libxsmm_torch.scripts.pexec --jobs 4 --log LOGDIR cmds.txt

    # or shard a pytest suite by test file:
    python -m libxsmm_torch.scripts.pexec --pytest tests/ --jobs 4

Exit code = number of failed commands (0 = all passed; at most 125). Each
command's stdout and stderr go to <log>/<slug>.log; the summary prints at
the end and is written to <log>/summary.txt. A per-command timeout kills
the command's whole process group, so one hang cannot stall the rest. The
default log directory is pexec_logs/ under the current directory. It
imports nothing of either package.
"""

import argparse
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor


def _slug(cmd: str) -> str:
    s = re.sub(r"[^A-Za-z0-9._-]+", "_", cmd.strip())
    return s[:80].strip("_") or "cmd"


def run_one(cmd: str, logdir: str, timeout_s: float):
    path = os.path.join(logdir, _slug(cmd) + ".log")
    t0 = time.time()
    with open(path, "wb") as log:
        try:
            proc = subprocess.Popen(cmd, shell=True, stdout=log,
                                    stderr=subprocess.STDOUT,
                                    start_new_session=True)
            try:
                rc = proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                # kill the process group we started (never by name)
                try:
                    os.killpg(proc.pid, 9)
                except OSError:
                    proc.kill()
                proc.wait()
                rc = "timeout"
        except OSError as e:
            rc = f"spawn-error:{e}"
    return cmd, rc, time.time() - t0, path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="run commands N-way parallel")
    ap.add_argument("list_file", nargs="?",
                    help="file with one shell command per line "
                         "(# comments ok); or use --pytest")
    ap.add_argument("--pytest", metavar="DIR",
                    help="shard `pytest <file> -q` per test file in DIR")
    ap.add_argument("--jobs", type=int,
                    default=max(2, (os.cpu_count() or 4) // 2))
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="per-command timeout seconds")
    ap.add_argument("--log", default="pexec_logs")
    args = ap.parse_args(argv)

    cmds = []
    if args.pytest:
        for name in sorted(os.listdir(args.pytest)):
            if name.startswith("test_") and name.endswith(".py"):
                cmds.append(f"{sys.executable} -m pytest "
                            f"{os.path.join(args.pytest, name)} -q")
    if args.list_file:
        with open(args.list_file) as f:
            cmds += [ln.strip() for ln in f
                     if ln.strip() and not ln.lstrip().startswith("#")]
    if not cmds:
        ap.error("nothing to run (give a list file or --pytest DIR)")

    os.makedirs(args.log, exist_ok=True)
    results = []
    with ThreadPoolExecutor(max_workers=args.jobs) as pool:
        futs = [pool.submit(run_one, c, args.log, args.timeout)
                for c in cmds]
        for fut in futs:
            cmd, rc, dt, path = fut.result()
            ok = rc == 0
            print(f"{'ok  ' if ok else 'FAIL'} rc={rc!s:>3} {dt:7.1f}s  "
                  f"{cmd}" + ("" if ok else f"   [log: {path}]"))
            results.append((cmd, rc, dt))
    failed = [r for r in results if r[1] != 0]
    summary = (f"{len(results) - len(failed)}/{len(results)} passed, "
               f"{len(failed)} failed")
    print(summary)
    with open(os.path.join(args.log, "summary.txt"), "w") as f:
        for cmd, rc, dt in results:
            f.write(f"rc={rc} {dt:.1f}s {cmd}\n")
        f.write(summary + "\n")
    return min(len(failed), 125)


if __name__ == "__main__":
    sys.exit(main())
