"""The launch log behind Kernel.lower_text's entry list, on the CPU.

Every CUDA library of the port keeps a launch log
(libxsmm_torch/kernels/csrc/xsmm_launches.cuh): each launch site notes the
host address of the kernel it launches, and lowering.py resolves the
address to the exported symbol there, the entry's mangled name. The card
is not needed to test that machinery: the header has no CUDA in it, so g++
builds it here beside plain template functions that stand for the host
stubs nvcc makes of `__global__` templates (the same linkage, the same
mangling). The sources are held to the log too: every launch site notes its
kernel, and every kernel belongs to one launch counter's ENTRIES.
"""

import ctypes
import re
import shutil
import subprocess

import pytest

from libxsmm_torch import lowering
from libxsmm_torch.kernels import _build

_SRC = r"""
#include <utility>
#include "xsmm_launches.cuh"

template <int R> void kern(int* p) { p[0] = R; }
void plain(float, const double*) {}

template <std::size_t... I> void every(std::index_sequence<I...>) {
  (note_launch(kern<100 + (int)I>), ...);
}

extern "C" void launch(int which) {
  if (which == 0) note_launch(kern<4>);
  if (which == 1) note_launch(kern<8>);
  if (which == 2) note_launch(plain);
  if (which == 3) every(std::make_index_sequence<300>{});
}
"""


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the launch log's header")
    d = tmp_path_factory.mktemp("launch_log")
    (d / "log.cpp").write_text(_SRC)
    out = d / "liblog.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I",
                    str(_build.CSRC), "-o", str(out), str(d / "log.cpp")],
                   check=True, capture_output=True, timeout=300)
    return out


@pytest.fixture
def logged(built, tmp_path):
    """A load of its own, with an empty log."""
    path = tmp_path / "liblog.so"
    shutil.copy(built, path)
    lib = ctypes.CDLL(str(path))
    lib.launch.argtypes = [ctypes.c_int]
    return lib


def test_log_names_each_launched_instantiation(logged):
    assert _build.read_launch_log(logged) == {}
    logged.launch(0)
    before = {"log": _build.read_launch_log(logged)}
    logged.launch(0)
    logged.launch(1)
    logged.launch(1)
    logged.launch(2)
    after = {"log": _build.read_launch_log(logged)}
    assert lowering.launched_entries(before, after) == {"log": {
        "_Z4kernILi4EEvPi": 1, "_Z4kernILi8EEvPi": 2,
        "_Z5plainfPKd": 1}}
    # the whole log, in the order of first launch
    assert [lowering.entry_name(a) for a in after["log"]] == [
        "_Z4kernILi4EEvPi", "_Z4kernILi8EEvPi", "_Z5plainfPKd"]
    assert lowering.launched_entries(after, after) == {}
    assert [lowering.kernel_of(e) for e in ("_Z4kernILi4EEvPi",
                                            "_Z5plainfPKd")] == [
        "kern", "plain"]


def test_entry_name_refuses_an_address_inside_a_function(logged):
    logged.launch(0)
    address = next(iter(_build.read_launch_log(logged)))
    with pytest.raises(RuntimeError, match="no exported symbol"):
        lowering.entry_name(address + 1)
    with pytest.raises(ValueError, match="not a mangled kernel name"):
        lowering.kernel_of("kern")


def test_log_overflow_raises(logged):
    logged.launch(3)       # 300 kernels: more than the log holds
    with pytest.raises(RuntimeError, match="overflowed"):
        _build.read_launch_log(logged)


def _code(path):
    """A source's lines with // comments blanked."""
    return [re.sub(r"//.*", "", line) for line in
            path.read_text().splitlines()]


def test_every_launch_site_notes_its_kernel():
    sites = 0
    for src in sorted(_build.CSRC.glob("*.cu")):
        lines = _code(src)
        for i, line in enumerate(lines):
            m = re.match(r"\s*(.*?)<<<", line)
            if m:
                kern = m.group(1).strip()
            elif "cudaLaunchKernelEx(" in line:
                kern = re.search(r"cudaLaunchKernelEx\(&\w+, (\w+)",
                                 line).group(1)
            else:
                continue
            sites += 1
            assert lines[i - 1].strip() == f"note_launch({kern});", (
                f"{src.name}:{i + 1} launches {kern} without noting it")
        assert '#include "xsmm_launches.cuh"' in src.read_text(), src.name
    assert sites >= 20


def _kernels(stem):
    text = "\n".join(_code(_build.CSRC / f"{stem}.cu"))
    return set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
        text))


def test_every_counter_declares_its_entries():
    table = lowering.entry_table()
    declared = {}
    for mod in lowering._kernel_modules():
        assert set(mod.ENTRIES) == set(mod.launches), mod.__name__
        for name, (stem, kernels) in mod.ENTRIES.items():
            assert table[name] == (stem, kernels)
            assert set(kernels) <= _kernels(stem), (name, stem)
            declared.setdefault(stem, set()).update(kernels)
    # every kernel of every source belongs to a counter
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == set(declared)
    for stem, kernels in declared.items():
        assert _kernels(stem) == kernels, stem
