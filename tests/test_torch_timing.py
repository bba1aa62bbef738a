"""device_split's handling of a profiler session that records no CUDA
kernel, on the CPU with a scripted profiler: each empty session is counted
and printed with the timed function's file and line, and run again up to
_PROFILER_TRIES sessions in all."""

import types

import pytest
import torch
from torch.autograd import DeviceType

from libxsmm_torch.scripts import timing


def _event(name, us):
    return types.SimpleNamespace(
        device_type=DeviceType.CUDA, name=name,
        time_range=types.SimpleNamespace(elapsed_us=lambda: us))


@pytest.fixture
def sessions(monkeypatch):
    """Scripted profiler sessions: each entry is the events one session
    records; the list records the sessions run."""
    script, ran = [], []

    class Profile:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            ran.append(1)
            return False

        def events(self):
            return script[len(ran) - 1]

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(timing, "empty_sessions", 0)
    return script, ran


def test_empty_session_is_counted_printed_and_run_again(sessions, capsys):
    script, ran = sessions
    script += [[], [_event("k", 40.0), _event("k", 20.0)]]
    split = timing.device_split(lambda: None, reps=4)
    assert split == {"k": pytest.approx(60.0 / 4 / 1e3)}
    assert len(ran) == 2 and timing.empty_sessions == 1
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1
    assert out[0].startswith(
        f"device_split: profiler session 1 of {timing._PROFILER_TRIES} "
        "recorded no CUDA kernel for test_torch_timing.py:")
    assert out[0].endswith("(4 calls)")


def test_split_is_empty_after_every_try(sessions, capsys):
    script, ran = sessions
    script += [[]] * timing._PROFILER_TRIES
    assert timing.device_split([lambda: None] * 3) == {}
    assert len(ran) == timing._PROFILER_TRIES
    assert timing.empty_sessions == timing._PROFILER_TRIES
    assert len(capsys.readouterr().out.splitlines()) == (
        timing._PROFILER_TRIES)
    with pytest.raises(AssertionError, match="recorded no kernel"):
        script += [[]] * timing._PROFILER_TRIES
        timing.device_ms(lambda: None)


def test_first_session_with_kernels_is_not_repeated(sessions, capsys):
    script, ran = sessions
    script += [[_event("a", 10.0), _event("b", 30.0)]]
    assert timing.device_split(lambda: None, reps=2) == {
        "a": pytest.approx(0.005), "b": pytest.approx(0.015)}
    assert len(ran) == 1 and timing.empty_sessions == 0
    assert capsys.readouterr().out == ""
