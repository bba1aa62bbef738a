"""The port's process-parallel runner (libxsmm_torch/scripts/pexec.py)
against the contract of scripts/pexec.py, on the CPU: the exit code is the
number of failed commands, each command's output goes to its own log, the
summary prints and is written to summary.txt, a command past its timeout
is killed with its whole process group, --pytest shards a directory by
test file, and the script imports nothing of either package. It also
returns what scripts/pexec.py returns on the same command list.
"""

import os
import pathlib
import subprocess
import sys
import time

import pytest

from libxsmm_torch.scripts import pexec

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _list(tmp_path, *lines):
    path = tmp_path / "cmds.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("lines,want", [
    (("true", "echo hello"), 0),
    (("true", "false"), 1),
    (("exit 3", "false", "# a comment", "true"), 2),
])
def test_exit_code_counts_failed_commands(lines, want, tmp_path, capsys):
    log = tmp_path / "log"
    assert pexec.main([_list(tmp_path, *lines), "--log", str(log),
                       "--jobs", "2"]) == want
    out = capsys.readouterr().out
    ncmd = len([ln for ln in lines if not ln.startswith("#")])
    assert f"{ncmd - want}/{ncmd} passed, {want} failed" in out
    summary = (log / "summary.txt").read_text().splitlines()
    assert summary[-1] == f"{ncmd - want}/{ncmd} passed, {want} failed"
    assert len(summary) == ncmd + 1
    assert len(list(log.glob("*.log"))) == ncmd


def test_each_command_logs_its_output(tmp_path):
    log = tmp_path / "log"
    pexec.main([_list(tmp_path, "echo out-line; echo err-line 1>&2"),
                "--log", str(log)])
    text = (log / f"{pexec._slug('echo out-line; echo err-line 1>&2')}"
            ".log").read_text()
    assert "out-line" in text and "err-line" in text


def test_timeout_kills_the_process_group(tmp_path, capsys):
    """A command past its timeout fails as "timeout", and the child it
    started in the background is killed with it."""
    pidfile = tmp_path / "child.pid"
    cmd = f"sleep 60 & echo $! > {pidfile}; wait"
    t0 = time.monotonic()
    rc = pexec.main([_list(tmp_path, "true", "false", cmd), "--log",
                     str(tmp_path / "log"), "--timeout", "2", "--jobs", "3"])
    assert rc == 2 and time.monotonic() - t0 < 30
    assert "rc=timeout" in capsys.readouterr().out
    pid = int(pidfile.read_text())
    for _ in range(50):
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.1)
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)
    summary = (tmp_path / "log" / "summary.txt").read_text()
    assert "rc=timeout" in summary and "rc=1 " in summary


def test_pytest_shards_by_file(tmp_path, capsys):
    tests = tmp_path / "suite"
    tests.mkdir()
    (tests / "test_pass.py").write_text("def test_a():\n    assert True\n")
    (tests / "test_fail.py").write_text("def test_b():\n    assert False\n")
    (tests / "helper.py").write_text("X = 1\n")
    rc = pexec.main(["--pytest", str(tests), "--log", str(tmp_path / "log"),
                     "--jobs", "2"])
    out = capsys.readouterr().out
    assert rc == 1 and "1/2 passed, 1 failed" in out
    assert "test_fail.py" in out and "helper.py" not in out


def test_nothing_to_run_is_an_error(tmp_path):
    with pytest.raises(SystemExit) as ei:
        pexec.main(["--log", str(tmp_path / "log")])
    assert ei.value.code == 2


def test_same_exit_code_as_scripts_pexec(tmp_path):
    """Both scripts, run as programs on one command list, return the same
    exit code and summary line; the port's imports neither package."""
    lst = _list(tmp_path, "true", "false", "exit 4")
    outs = []
    for i, cmd in enumerate(([sys.executable, str(ROOT / "scripts" /
                                                  "pexec.py")],
                             [sys.executable, "-m",
                              "libxsmm_torch.scripts.pexec"])):
        log = tmp_path / f"log{i}"
        p = subprocess.run(cmd + [lst, "--log", str(log)], cwd=ROOT,
                           capture_output=True, text=True, timeout=120)
        outs.append((p.returncode, p.stdout.splitlines()[-1]))
    assert outs[0] == outs[1] == (2, "1/3 passed, 2 failed")
    code = ("import sys, runpy\nsys.argv = ['pexec', '--help']\n"
            "try:\n    runpy.run_module('libxsmm_torch.scripts.pexec', "
            "run_name='__main__')\nexcept SystemExit:\n    pass\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'libxsmm_tpu')))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.stdout.splitlines()[-1] == "[]"
