"""What one call of a kernel issues: the port's "generated code".

The JAX package lowers a kernel to StableHLO without running it
(`Kernel.lower_text`, libxsmm_tpu/registry.py). A kernel of the port
launches hand-written CUDA through ctypes and has no graph to lower, so
`lower_text(kernel, args)` runs the kernel once, on zero operands made from
the example arguments (tensors, or `device="meta"` tensors, the port's
ShapeDtypeStruct) on the kernel's device, and writes down what that call
issued:

  * a header: the kernel's name, kind and descriptor, the device and the
    geometry (arch) it ran under, its operands and its result;
  * every aten operator the call dispatched, in order, with the dtypes and
    shapes of its tensors (a TorchDispatchMode);
  * on the card, every hand-written kernel the call launched and its route,
    read from the launch counters of kernels/{gemm,attention,eltwise,spmm,
    spmm_lab}.py around the call (the mode does not see ctypes launches);
    under each, the CUDA entries that ran, read from the launch log of
    each library kernels/_build.py loaded (csrc/xsmm_launches.cuh: the host
    address of each launched kernel, whose exported symbol is the entry's
    mangled name), each with its launches, its registers, shared and local
    memory (cuobjdump -res-usage; with the spills of nvcc's -Xptxas -v
    report when this process built the library) and its SASS (cuobjdump
    -sass), the machine code the card ran.

There is no fallback: a launch with no logged entry, a logged entry that no
launched counter claims, an address without its symbol and an entry
without SASS all raise, as does a missing cuobjdump. On the CPU the kernels
run their plain torch versions, so the text lists aten operators and no
launches. The same kernel
and arguments give the same text.
"""

from __future__ import annotations

import ctypes
import functools
import re
import subprocess
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .device import default_device, get_geometry


def _kernel_modules():
    from .kernels import attention, eltwise, gemm, spmm, spmm_lab
    return gemm, attention, eltwise, spmm, spmm_lab


def entry_table() -> Dict[str, Tuple[str, Tuple[str, ...]]]:
    """Every launch counter's (source stem, CUDA kernel names), as each
    kernel module declares them beside its counters (ENTRIES)."""
    out = {}
    for mod in _kernel_modules():
        out.update(mod.ENTRIES)
    return out


def launch_counts() -> Dict[str, Tuple[int, Dict[str, int]]]:
    """Every kernel's launch count and its counts by route."""
    out = {}
    for mod in _kernel_modules():
        paths = getattr(mod, "path_launches", {})
        for name, n in mod.launches.items():
            out[name] = (n, dict(paths.get(name, {})))
    return out


def launched(before, after) -> List[Tuple[str, int, Dict[str, int]]]:
    """(counter, launches, launches by route) of the kernels launched
    between two launch_counts()."""
    out = []
    for name, (n, routes) in after.items():
        n0, routes0 = before.get(name, (0, {}))
        if n > n0:
            out.append((name, n - n0, {r: c - routes0.get(r, 0)
                                       for r, c in routes.items()
                                       if c > routes0.get(r, 0)}))
    return out

# ---------------------------------------------------------------- aten ops


def _fmt(x) -> str:
    if isinstance(x, torch.Tensor):
        return f"{str(x.dtype)[6:]}[{', '.join(map(str, x.shape))}]"
    if isinstance(x, (list, tuple)):
        inner = ", ".join(_fmt(v) for v in x)
        return f"[{inner}]" if isinstance(x, list) else f"({inner})"
    if isinstance(x, dict):
        return "{" + ", ".join(f"{k}: {_fmt(v)}" for k, v in x.items()) + "}"
    if isinstance(x, torch.dtype):
        return str(x)[6:]
    return repr(x)


class _OpRecorder(TorchDispatchMode):
    """Writes down each aten operator dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.ops: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        parts = [_fmt(a) for a in args]
        parts += [f"{k}={_fmt(v)}" for k, v in sorted(kwargs.items())]
        self.ops.append(f"{func}({', '.join(parts)}) -> {_fmt(out)}")
        return out

# ---------------------------------------------------------------- the CUDA
# library: entries, resources, SASS


def _cuobjdump(lib: str, *flags: str) -> str:
    from .kernels import _build
    out = subprocess.run([_build.tool("cuobjdump"), *flags, lib],
                         check=True, capture_output=True, text=True,
                         timeout=300)
    return out.stdout


@functools.lru_cache(maxsize=None)
def res_usage(lib: str) -> Dict[str, Dict[str, int]]:
    """Mangled entry name -> {"REG", "SHARED", "LOCAL", "STACK", ...} of
    every entry of a library (cuobjdump -res-usage), in its order."""
    found: Dict[str, Dict[str, int]] = {}
    name = None
    for line in _cuobjdump(lib, "-res-usage").splitlines():
        m = re.match(r"\s*Function (\S+):\s*$", line)
        if m:
            name = m.group(1)
            continue
        if name is not None and "REG:" in line:
            found[name] = {k: int(v) for k, v in re.findall(
                r"([A-Z]+(?:\[\d+\])?):(\d+)", line)}
            name = None
    return found


@functools.lru_cache(maxsize=None)
def sass(lib: str, names: Tuple[str, ...]) -> Dict[str, List[str]]:
    """Mangled entry name -> its SASS lines, for the named entries of a
    library (cuobjdump -sass -fun)."""
    found: Dict[str, List[str]] = {}
    body: Optional[List[str]] = None
    for line in _cuobjdump(lib, "-sass", "-fun", ",".join(names)
                           ).splitlines():
        m = re.match(r"\s*Function : (\S+)\s*$", line)
        if m:
            body = found.setdefault(m.group(1), [])
        elif body is not None:
            if re.match(r"\s*\.{10,}\s*$", line) or line.startswith("Fatbin"):
                body = None
            elif line.strip():
                body.append(line.rstrip())
    return found


class _DlInfo(ctypes.Structure):
    _fields_ = [("dli_fname", ctypes.c_char_p), ("dli_fbase", ctypes.c_void_p),
                ("dli_sname", ctypes.c_char_p), ("dli_saddr", ctypes.c_void_p)]


@functools.lru_cache(maxsize=None)
def entry_name(address: int) -> str:
    """The mangled name of the kernel whose host address is `address`: the
    exported symbol there (dladdr), which is also its device entry's
    name."""
    dladdr = ctypes.CDLL(None).dladdr
    dladdr.argtypes = [ctypes.c_void_p, ctypes.POINTER(_DlInfo)]
    info = _DlInfo()
    if (not dladdr(address, ctypes.byref(info)) or info.dli_sname is None
            or info.dli_saddr != address):
        raise RuntimeError(f"no exported symbol at the kernel address "
                           f"{address:#x}")
    return info.dli_sname.decode()


def kernel_of(entry: str) -> str:
    """The kernel's own name in a mangled entry name (_Z<length><name>...)."""
    m = re.match(r"_Z(\d+)", entry)
    if m is None:
        raise ValueError(f"not a mangled kernel name: {entry}")
    return entry[m.end():m.end() + int(m.group(1))]


def launched_entries(before, after) -> Dict[str, Dict[str, int]]:
    """{source stem: {mangled entry: launches}} of the kernels launched
    between two kernels._build.launch_log()s."""
    out: Dict[str, Dict[str, int]] = {}
    for stem, log in after.items():
        old = before.get(stem, {})
        for address, n in log.items():
            if n > old.get(address, 0):
                out.setdefault(stem, {})[entry_name(address)] = (
                    n - old.get(address, 0))
    return out


def _resources(stem: str, lib: str, entry: str) -> str:
    from .kernels import _build
    use = res_usage(lib)[entry]
    text = (f"registers {use.get('REG', 0)}, shared {use.get('SHARED', 0)} B,"
            f" local {use.get('LOCAL', 0)} B, stack {use.get('STACK', 0)} B")
    for name, _, st, ld in _build.kernel_resources(stem, entry):
        if name == entry:
            text += f", spill stores {st} B, spill loads {ld} B"
    return text


def _launch_lines(name: str, count: int, routes: Dict[str, int],
                  ran: Dict[str, Dict[str, int]],
                  claimed: set) -> List[str]:
    from .kernels import _build
    stem, kernels = entry_table()[name]
    path = _build.library_path(stem)
    lib = str(path)
    by_route = "".join(f" {r} x{c}" for r, c in sorted(routes.items()))
    lines = [f"// launch {name} x{count}: route cuda{by_route}, source "
             f"kernels/csrc/{stem}.cu, library {path.name}"]
    found = [(e, n) for e, n in ran.get(stem, {}).items()
             if kernel_of(e) in kernels]
    if not found:
        raise RuntimeError(f"{name} launched, but the launch log of {lib} "
                           f"holds no entry of {', '.join(kernels)}")
    code = sass(lib, tuple(e for e, _ in found))
    for entry, n in found:
        if not code.get(entry):
            raise RuntimeError(f"cuobjdump -sass gave no code for {entry}")
        claimed.add((stem, entry))
        lines.append(f"// entry {entry} x{n}: "
                     f"{_resources(stem, lib, entry)}")
        lines.append(f"// sass {entry}: {len(code[entry])} lines")
        lines.extend(code[entry])
    return lines

# ---------------------------------------------------------------- the text


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def kernel_device(args, device=None) -> torch.device:
    """`device`, else the device of the first example tensor that is not a
    meta tensor, else the default device (the card)."""
    if device is not None:
        return torch.device(device)
    for t in _tensors(args):
        if t.device.type != "meta":
            return t.device
    return default_device()


def zero_operands(x, device: torch.device):
    """Zeros of each example tensor's shape and dtype on `device`; other
    arguments as they are."""
    if isinstance(x, torch.Tensor):
        return torch.zeros(x.shape, dtype=x.dtype, device=device)
    if isinstance(x, (list, tuple)):
        return type(x)(zero_operands(v, device) for v in x)
    if isinstance(x, dict):
        return {k: zero_operands(v, device) for k, v in x.items()}
    return x


def _describe(descriptor) -> str:
    text = repr(descriptor)
    return text if len(text) <= 400 else text[:400] + "..."


def lower_text(kernel, args: Sequence = (), kwargs: Optional[dict] = None,
               device=None) -> str:
    """The text of one call of `kernel` on zeros shaped like `args` and
    `kwargs`, run on `device` (kernel_device's choice when None)."""
    kwargs = kwargs or {}
    dev = kernel_device((args, kwargs), device)
    ops_args = zero_operands(tuple(args), dev)
    ops_kwargs = zero_operands(kwargs, dev)
    from .kernels import _build
    before, log = launch_counts(), _build.launch_log()
    with _OpRecorder() as rec:
        out = kernel(*ops_args, **ops_kwargs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    runs = launched(before, launch_counts())
    ran = launched_entries(log, _build.launch_log())
    lines = [f"// libxsmm_torch kernel: {kernel.name}",
             f"// kind: {kernel.info.kind}",
             f"// descriptor: {_describe(kernel.descriptor)}",
             f"// device: {dev}  arch: {get_geometry().name}",
             f"// operands: {_fmt(ops_args)[1:-1]}"
             + (f"; {_fmt(ops_kwargs)}" if ops_kwargs else ""),
             f"// result: {_fmt(out)}",
             f"// aten ops: {len(rec.ops)}"]
    lines += [f"  {op}" for op in rec.ops]
    lines.append(f"// kernel launches: {sum(n for _, n, _ in runs)}")
    claimed: set = set()
    for name, n, routes in runs:
        lines += _launch_lines(name, n, routes, ran, claimed)
    stray = sorted({(stem, e) for stem, es in ran.items() for e in es}
                   - claimed)
    if stray:
        raise RuntimeError(f"entries launched that no launched counter "
                           f"claims: {stray}")
    return "\n".join(lines) + "\n"
