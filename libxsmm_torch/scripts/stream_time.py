"""Timing of the packed SMM's passthrough twin, the union RHS compactor and
the BCSC densifier on the card, each beside its yardstick, by CUDA events,
CUDA-graph replay and the host's own time a call. Rows, chosen by name
(--rows):

* passthrough: `out = a + b` over the headline's (4096, 32, 128) f32 (bit
  for bit against a + b), beside `torch.add`, and the headline packed SMM
  (16384 x 32^3 f32, packed four problems a group) for bench.py:869's
  fraction t_passthrough / t_packed_smm;
* designs: the port's passthrough kernel beside the two other designs of
  it (scripts/passthrough_designs.cu: a persistent grid with U unrolled
  16-byte load pairs a thread and streaming hints, and a ring of bulk
  copies through shared memory, each at several sizes), all on one
  preallocated output through their C entries, with the wrapper and
  `torch.add` (and `torch.add(out=)`) beside; the port's kernel and
  `torch.add` are timed first and again last;
* compactor: the compacted RHS of the union plan at the streaming case
  (bench.py's bcsc20 pattern: k = n = 1024, 32 x 32 blocks, density 0.2,
  bf16; byte-equal to its plain version), beside `torch.clone` of that RHS;
* routes: the compactor's two routes at that case through its C entry,
  both programmatic launches, on the same aligned values: bulk copies and
  16-byte element units, beside the wrapper and the clone;
* union: the union kernel's compacted form (union, union2, union3: the
  compactor, then the kernel over its RHS) beside its fused form (union4
  ...) at bcsc20 and bcsc05 (m = 1024), ragged (m = 1000 on bcsc05's
  pattern) and stream20 (m = 32768 on bcsc20's), bf16 in, f32 out, the two
  forms held to each other at normf_rel 1e-4 (bf16 products exact, sums in
  another order);
* densify: the densifier of the "dense" strategy at the streaming pattern
  (bcsc20's: k = n = 1024, 32 x 32 blocks, bf16; byte-equal to its plain
  version), beside `sparse_bsc_tensor(...).to_dense()`; its route where the
  tree names one;
* dplans: the densifier's C entry at that pattern on one aligned values
  tensor: the vector route at runs of 1-32 tiles a block and 1, 1/2 and
  1/4 of a block's threads, and the element route, beside the wrapper's
  plan (densify_plan's);
* dense: the "dense" strategy through create_packed_spgemm_bcsc (the
  densifier, then one torch.mm with an f32 output) at bcsc20, bcsc05,
  ragged and stream20, held to float64 at normf_rel 1e-4;
* split: the host's time a call of the densifier, step by step, as the
  tree's BcscDensify takes them (the earlier wrapper, with no `route`, or
  the lean one; each step alone on the host clock, the best of 5 windows
  of 100 calls), and the steps of the "dense" strategy's call around it at
  bcsc20.

The timers are scripts/timing.py's (events: the best of 5 windows of 20
back-to-back calls; replay: a CUDA graph of 20 calls, the best of 5
replays; host: the best of 5 windows of 100 calls on the host clock). The
bound: the bytes moved (each input read once, each output written once)
over the card's memory rate (`libxsmm_torch.device`).

The passthrough, compactor, union, densify, dense and split rows use only
entry points that earlier trees of the port have too, so they also time a
checkout of one: put that checkout's root first on PYTHONPATH and run this
file by its path with, say, --rows densify,dense,split.

    python3 -m libxsmm_torch.scripts.stream_time [--rows densify,dense]

The last line is one JSON object: the card, its power limit and the rows.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import subprocess
from typing import Optional, Sequence

import numpy as np
import torch

if __package__:
    from . import timing
else:   # run by its path (a checkout first on PYTHONPATH): its directory
    import timing   # is sys.path[0]

ROWS = ("passthrough", "designs", "compactor", "routes", "union", "densify",
        "dplans", "dense", "split")
HERE = pathlib.Path(__file__).resolve().parent
# the other passthrough designs timed by the designs row: (unroll, blocks
# an SM, hint) of the persistent grid and (chunk bytes, stages, blocks an
# SM) of the bulk-copy ring
PERSISTENT = [(u, bps, hint) for u in (2, 4, 8) for bps in (4, 8)
              for hint in (0, 1, 2)]
RING = [(4096, 6, 4), (8192, 4, 3), (8192, 6, 2), (16384, 3, 2),
        (16384, 2, 3)]
HINTS = {0: "default caching", 1: "ld.cs/st.cs",
         2: "ld.nc.L1::no_allocate/st.cs"}


def _times(prefix: str, fn) -> dict:
    return {f"{prefix}events_ms": timing.events_ms(fn),
            f"{prefix}replay_ms": timing.graph_ms(fn),
            f"{prefix}host_ms": timing.host_ms(fn)}


def _pattern(density: float):
    """bench.py's BCSC pattern (make_bcsc_cases, bench.py:694-697) from
    default_rng(2): a standard-normal (1024, 1024) whose 32 x 32 blocks are
    kept at `density`, and the generator after it (A is drawn next)."""
    from libxsmm_torch.ops.sparse import BcscMatrix
    rng = np.random.default_rng(2)
    bmat = rng.standard_normal((1024, 1024)).astype(np.float32)
    keep = rng.random((32, 32)) < density
    bmat *= np.kron(keep, np.ones((32, 32), np.float32))
    return BcscMatrix.from_dense(bmat, 32, 32), rng


def _line(name: str, row: dict, keys) -> None:
    print(f"{name}: " + ", ".join(f"{k} {row[k]:.4f}" for k in keys
                                   if k in row))


def _designs_lib() -> ctypes.CDLL:
    """passthrough_designs.cu, built with nvcc into the port's build
    directory (named by a hash of the source and the header it includes)."""
    from libxsmm_torch.kernels import _build
    src = HERE / "passthrough_designs.cu"
    csrc = HERE.parent / "kernels" / "csrc"
    digest = hashlib.sha1(src.read_bytes() + (csrc / "xsmm_wgmma.cuh")
                          .read_bytes() + _build.ARCH.encode()).hexdigest()
    out = _build.BUILD / f"passthrough_designs-{digest[:12]}.so"
    if not out.exists():
        _build.BUILD.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.tool("nvcc"), _build.ARCH, "-std=c++17", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-I", str(csrc),
                        "-o", str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pt_persistent.argtypes = [P, P, P, LL, I, I, I, P]
    lib.pt_ring.argtypes = [P, P, P, LL, I, I, I, P]
    lib.pt_persistent.restype = lib.pt_ring.restype = I
    return lib


def _passthrough(dev, gen, geo, K) -> list:
    from libxsmm_torch.descriptor import GemmDescriptor, GemmFlags, GemmShape
    G, m = 4096, 32
    a = torch.randn(G, m, 128, generator=gen, device=dev)
    b = torch.randn(G, m, 128, generator=gen, device=dev) * 0.1
    pt = K.build_packed_smm_passthrough(G, m)
    if not torch.equal(pt(a, b), a + b):
        raise AssertionError("passthrough: kernel != a + b")
    smm = K.build_packed_batched_gemm(
        GemmDescriptor(GemmShape(32, 32, 32), GemmFlags.BETA_0), G)
    row = {"name": "packed_smm_passthrough", "shape": [G, m, 128],
           **_times("", lambda: pt(a, b)),
           **_times("add_", lambda: torch.add(a, b)),
           **_times("smm_", lambda: smm(a, b)),
           "bound_ms": geo.bound_ms(3 * a.numel() * 4, 0, 1.0)}
    for how in ("events", "replay"):
        row[f"kl_{how}"] = row[f"{how}_ms"] / row[f"add_{how}_ms"]
        row[f"fraction_{how}"] = row[f"{how}_ms"] / row[f"smm_{how}_ms"]
    row["bound_share"] = row["bound_ms"] / row["replay_ms"]
    _line("passthrough (4096, 32, 128) f32", row, (
        "events_ms", "replay_ms", "host_ms", "add_events_ms",
        "add_replay_ms", "add_host_ms", "kl_events", "kl_replay",
        "smm_events_ms", "smm_replay_ms", "fraction_events",
        "fraction_replay", "bound_ms", "bound_share"))
    return [row]


def _designs(dev, gen, geo, K) -> list:
    """The port's passthrough kernel and the two other designs on one
    preallocated output, each held bit for bit against a + b first."""
    G, m = 4096, 32
    a = torch.randn(G, m, 128, generator=gen, device=dev)
    b = torch.randn(G, m, 128, generator=gen, device=dev) * 0.1
    want = a + b
    out = torch.empty_like(a)
    units, sms = a.numel() // 4, K._num_sms(dev)
    pa, pb, po = a.data_ptr(), b.data_ptr(), out.data_ptr()
    lib, dlib = K._kernels(), _designs_lib()
    pt = K.build_packed_smm_passthrough(G, m)

    def entry(name, call):
        """A C entry's launch on the current stream (a graph's capture
        stream too) into `out`."""
        def run():
            err = call(K._stream(dev))
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            return out
        return name, run

    port = entry("port kernel", lambda st: lib.xsmm_packed_smm_passthrough(
        pa, pb, po, units, st))
    add_out = ("torch.add(out=)", lambda: torch.add(a, b, out=out))
    cands = [entry(f"persistent U{u} {bps}/SM {HINTS[h]}",
                   lambda st, u=u, bps=bps, h=h: dlib.pt_persistent(
                       pa, pb, po, units, bps * sms, u, h, st))
             for u, bps, h in PERSISTENT]
    cands += [entry(f"ring {ch} B x {s} stages {bps}/SM",
                    lambda st, ch=ch, s=s, bps=bps: dlib.pt_ring(
                        pa, pb, po, units * 16, bps * sms, ch, s, st))
              for ch, s, bps in RING]
    order = ([port, add_out] + cands
             + [("port wrapper", lambda: pt(a, b)),
                ("torch.add", lambda: torch.add(a, b)), port, add_out])
    bound = geo.bound_ms(3 * a.numel() * 4, 0, 1.0)
    rows = []
    for name, fn in order:
        out.zero_()
        if not torch.equal(fn(), want):
            raise AssertionError(f"passthrough {name}: != a + b")
        row = {"name": f"passthrough design: {name}",
               "events_ms": timing.events_ms(fn),
               "replay_ms": timing.graph_ms(fn)}
        row["bound_share"] = bound / row["replay_ms"]
        rows.append(row)
        _line(row["name"], row, ("events_ms", "replay_ms", "bound_share"))
    for family in ("persistent", "ring"):
        best = min((r for r in rows if family in r["name"]),
                   key=lambda r: r["replay_ms"])
        print(f"best {family} by replay: {best['name']}")
    return rows


def _stream_case(dev, KS):
    """The compactor of bench.py's bcsc20 pattern at m = 32768 (8 groups x
    21 slots, bf16) and its values on the card."""
    from libxsmm_torch.descriptor import GemmShape, SpgemmConfig
    from libxsmm_torch.dtypes import Datatype
    bcsc, _ = _pattern(0.2)
    v = torch.as_tensor(bcsc.data, device=dev).to(torch.bfloat16)
    plan = KS.build_bcsc_spmm_union(
        GemmShape(32768, 1024, 1024, Datatype.BF16, Datatype.BF16,
                  Datatype.F32),
        SpgemmConfig(1, 32, 32), bcsc.indptr, bcsc.indices, dev, compact=True)
    comp = plan.compactor
    rhs = comp(v)
    torch.cuda.synchronize()
    if not torch.equal(rhs.view(torch.uint8),
                       comp.plain(v).view(torch.uint8)):
        raise AssertionError("compactor: kernel != plain")
    return plan, comp, v, rhs


def _compactor(dev, gen, geo, K) -> list:
    from libxsmm_torch.kernels import spmm as KS
    plan, comp, v, rhs = _stream_case(dev, KS)
    row = {"name": "bcsc_union_compact", "slots": plan.nsg * plan.U,
           **_times("", lambda: comp(v)),
           **_times("clone_", lambda: torch.clone(rhs)),
           "bound_ms": geo.bound_ms(
               v.numel() * 2 + rhs.numel() * 2, 0, 1.0)}
    row["bound_share"] = row["bound_ms"] / row["replay_ms"]
    _line(f"compactor stream20 ({plan.nsg} x {plan.U} slots, bf16)", row, (
        "events_ms", "replay_ms", "host_ms", "clone_events_ms",
        "clone_replay_ms", "clone_host_ms", "bound_ms", "bound_share"))
    return [row]


def _routes(dev, gen, geo, K) -> list:
    """Both routes of the compactor through its C entry on the same aligned
    values and output, byte-equal to the plain version first."""
    from libxsmm_torch.kernels import spmm as KS
    plan, comp, v, rhs = _stream_case(dev, KS)
    lib = KS._kernels()
    out = comp.rhs(v)
    want = comp.plain(v).view(torch.uint8)
    grid = comp.route(v, out)[1]
    args = (v.data_ptr(), comp.gmap.data_ptr(), out.data_ptr(), comp.nsg,
            comp.U, comp.bk, comp.bn, comp.nblocks, comp.itemsize)

    def raw(route, g):
        def run():   # on the current stream (a capture stream too)
            err = lib.xsmm_bcsc_union_compact(*args, route, g,
                                              K._stream(dev))
            if err:
                raise RuntimeError(f"compactor route {route}: error {err}")
        return run

    row = {"name": "bcsc_union_compact routes",
           "slots": plan.nsg * plan.U, "bulk_grid": grid}
    for name, fn in (("bulk_", raw(KS._CP_ROUTES["bulk"], grid)),
                     ("element_", raw(KS._CP_ROUTES["element"], 0))):
        out.zero_()
        fn()
        torch.cuda.synchronize()
        if not torch.equal(out.view(torch.uint8), want):
            raise AssertionError(f"compactor {name[:-1]} route != plain")
        row.update(_times(name, fn))
    row.update(_times("wrapper_", lambda: comp(v)))
    row.update(_times("clone_", lambda: torch.clone(rhs)))
    _line(f"compactor routes ({plan.nsg} x {plan.U} slots, bf16)", row, (
        "bulk_events_ms", "bulk_replay_ms", "bulk_host_ms",
        "element_events_ms", "element_replay_ms", "element_host_ms",
        "wrapper_events_ms", "wrapper_replay_ms", "clone_events_ms",
        "clone_replay_ms"))
    return [row]


def _union(dev, gen, geo, K) -> list:
    from libxsmm_torch.descriptor import GemmShape, SpgemmConfig
    from libxsmm_torch.dtypes import Datatype
    from libxsmm_torch.kernels import spmm as KS
    from libxsmm_torch.matdiff import check
    bf16 = torch.bfloat16
    cfg = SpgemmConfig(1, 32, 32)
    pats = {}
    for density in (0.2, 0.05):
        bcsc, rng = _pattern(density)
        a0 = torch.as_tensor(rng.standard_normal((1024, 1024)),
                             device=dev).to(bf16)
        pats[density] = (bcsc, torch.as_tensor(bcsc.data, device=dev)
                         .to(bf16), a0)
    a_stream = torch.randn(32768, 1024, generator=gen, device=dev).to(bf16)
    (bcsc20, v20, a20), (bcsc05, v05, a05) = pats[0.2], pats[0.05]
    cases = (("bcsc20", 1024, bcsc20, v20, a20),
             ("bcsc05", 1024, bcsc05, v05, a05),
             ("ragged", 1000, bcsc05, v05,
              torch.randn(1000, 1024, generator=gen, device=dev).to(bf16)),
             ("stream20", 32768, bcsc20, v20, a_stream))
    rows = []
    for case, mm, pat, vv, aa in cases:
        shape = GemmShape(mm, 1024, 1024, Datatype.BF16, Datatype.BF16,
                          Datatype.F32)
        forms = {form: KS.build_bcsc_spmm_union(
            shape, cfg, pat.indptr, pat.indices, dev, compact=compact)
            for form, compact in (("compact", True), ("fused", False))}
        got = {form: fn(aa, vv) for form, fn in forms.items()}
        torch.cuda.synchronize()
        err = check(got["fused"].double().cpu().numpy(),
                    got["compact"].double().cpu().numpy(), margin=1e-4)
        row = {"name": f"union {case}", "m": mm, "U": forms["fused"].U,
               "normf_rel": float(err.normf_rel)}
        for form, fn in forms.items():
            row.update(_times(f"{form}_", lambda fn=fn: fn(aa, vv)))
        rows.append(row)
        _line(f"union {case} (m {mm}, U {row['U']})", row, (
            "compact_events_ms", "compact_replay_ms", "compact_host_ms",
            "fused_events_ms", "fused_replay_ms", "fused_host_ms",
            "normf_rel"))
    return rows


def _densifier(dev, KS):
    """The densifier of bench.py's bcsc20 pattern (k = n = 1024, 32 x 32
    blocks, bf16) and its values on the card, byte-equal to its plain
    version first; the pattern."""
    from libxsmm_torch.descriptor import GemmShape, SpgemmConfig
    from libxsmm_torch.dtypes import Datatype
    bcsc, _ = _pattern(0.2)
    v = torch.as_tensor(bcsc.data, device=dev).to(torch.bfloat16)
    fn = KS.build_bcsc_densify(
        GemmShape(1024, 1024, 1024, Datatype.BF16, Datatype.BF16,
                  Datatype.F32),
        SpgemmConfig(1, 32, 32), bcsc.indptr, bcsc.indices, dev)
    got = fn(v)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.uint8), fn.plain(v).view(torch.uint8)):
        raise AssertionError("densify: kernel != plain")
    return fn, v, got, bcsc


def _densify(dev, gen, geo, K) -> list:
    from libxsmm_torch.kernels import spmm as KS
    fn, v, got, bcsc = _densifier(dev, KS)
    ccol = torch.as_tensor(bcsc.indptr.astype(np.int64), device=dev)
    rows = torch.as_tensor(bcsc.indices.astype(np.int64), device=dev)

    def lib():
        return torch.sparse_bsc_tensor(ccol, rows, v, (1024, 1024)).to_dense()

    if not torch.equal(lib(), got):
        raise AssertionError("densify: sparse_bsc_tensor().to_dense() "
                             "differs")
    row = {"name": "bcsc_densify", "blocks": len(bcsc.indices),
           **_times("", lambda: fn(v)), **_times("library_", lib),
           "bound_ms": geo.bound_ms(v.numel() * 2 + got.numel() * 2, 0,
                                    1.0)}
    if hasattr(fn, "route"):
        row["route"] = fn.route(v, got)
    row["bound_share"] = row["bound_ms"] / row["replay_ms"]
    _line(f"densify bcsc20 ({row['blocks']} blocks of 32 x 32, bf16, route "
          f"{row.get('route', 'not named')})", row, (
              "events_ms", "replay_ms", "host_ms", "library_events_ms",
              "library_replay_ms", "library_host_ms", "bound_ms",
              "bound_share"))
    return [row]


def _dplans(dev, gen, geo, K) -> list:
    """The densifier's C entry on one aligned values tensor and output, at
    the streaming pattern: the vector route at runs of 1-32 tiles a block,
    each with a full block of threads and with a half and a quarter of
    one (more rows a thread), and the element route at densify_plan's
    plan; each byte-equal to the plain version first. The wrapper's plan
    is timed first and again last."""
    from libxsmm_torch.kernels import spmm as KS
    fn, v, got, _ = _densifier(dev, KS)
    lib = KS._kernels()
    out = torch.empty_like(got)
    want = got.view(torch.uint8)
    kb, nb, bk, bn = fn.k // fn.bk, fn.n // fn.bn, fn.bk, fn.bn
    cpr = bn * 2 // 16

    def raw(route, tb, rs):
        def run():   # on the current stream (a capture stream too)
            err = lib.xsmm_bcsc_densify(
                v.data_ptr(), fn.gmap.data_ptr(), out.data_ptr(), fn.k,
                fn.n, bk, bn, fn.nblocks, 2, KS._DN_ROUTES[route], tb, rs,
                K._stream(dev))
            if err:
                raise RuntimeError(f"densify {route} {tb}/{rs}: error {err}")
        return run

    plan = ("vector",) + fn.launch_plan("vector", 2)
    cands = [plan]
    for tb in (1, 2, 4, 8, 16, 32):
        full = min(bk, KS._DN_THREADS // min(tb * cpr, KS._DN_THREADS))
        cands += [("vector", tb, rs) for rs in (full, full // 2, full // 4)
                  if rs >= 1 and (tb, rs) != plan[1:]]
    etb, _, ers, _ = KS.densify_plan(kb, nb, bk, bn, K._num_sms(dev))
    cands += [("element", etb, ers), plan]
    rows = []
    for route, tb, rs in cands:
        fn_ = raw(route, tb, rs)
        out.zero_()
        fn_()
        torch.cuda.synchronize()
        if not torch.equal(out.view(torch.uint8), want):
            raise AssertionError(f"densify {route} {tb}/{rs} != plain")
        tag = " (the wrapper's plan)" if (route, tb, rs) == plan else ""
        row = {"name": f"densify {route}, {tb} tiles a block, {rs} rows "
                       f"of threads{tag}", "blocks": kb * -(-nb // tb),
               "events_ms": timing.events_ms(fn_),
               "replay_ms": timing.graph_ms(fn_)}
        rows.append(row)
        _line(row["name"], row, ("events_ms", "replay_ms"))
    best = min(rows, key=lambda r: r["replay_ms"])
    print(f"best by replay: {best['name']}")
    return rows


def _dense(dev, gen, geo, K) -> list:
    import libxsmm_torch as xp
    from libxsmm_torch.descriptor import GemmFlags, GemmShape, SpgemmConfig
    from libxsmm_torch.dtypes import Datatype
    from libxsmm_torch.matdiff import check
    bf16 = torch.bfloat16
    pats = {}
    for density in (0.2, 0.05):
        bcsc, rng = _pattern(density)
        a0 = torch.as_tensor(rng.standard_normal((1024, 1024)),
                             device=dev).to(bf16)
        pats[density] = (bcsc, torch.as_tensor(bcsc.data, device=dev)
                         .to(bf16), a0)
    (bcsc20, v20, a20), (bcsc05, v05, a05) = pats[0.2], pats[0.05]
    cases = (("bcsc20", bcsc20, v20, a20), ("bcsc05", bcsc05, v05, a05),
             ("ragged", bcsc05, v05,
              torch.randn(1000, 1024, generator=gen, device=dev).to(bf16)),
             ("stream20", bcsc20, v20,
              torch.randn(32768, 1024, generator=gen, device=dev).to(bf16)))
    rows = []
    for case, pat, vv, aa in cases:
        mm = aa.shape[0]
        kern = xp.create_packed_spgemm_bcsc(
            GemmShape(mm, 1024, 1024, Datatype.BF16, Datatype.BF16,
                      Datatype.F32),
            GemmFlags.BETA_0, SpgemmConfig(1, 32, 32), pat.indptr,
            pat.indices, strategy="dense", device=dev)
        got = kern(aa, vv)
        dense_b = torch.as_tensor(pat.to_dense(), device=dev).to(bf16)
        want = aa.double() @ dense_b.double()
        err = check(want.cpu().numpy(), got.double().cpu().numpy(),
                    margin=1e-4)
        row = {"name": f"dense {case}", "m": mm,
               "normf_rel": float(err.normf_rel),
               **_times("", lambda: kern(aa, vv))}
        rows.append(row)
        _line(f"dense strategy {case} (m {mm})", row, (
            "events_ms", "replay_ms", "host_ms", "normf_rel"))
    return rows


def _step_us(fn) -> float:
    """Microseconds of the host's own time a call of fn (timing.host_ms)."""
    return timing.host_ms(fn) * 1e3


def _in(make):
    """A step that enters and leaves the context make() returns."""
    def step():
        with make():
            pass
    return step


def _split(dev, gen, geo, K) -> list:
    """The densifier's call step by step as the tree's wrapper takes it,
    then the "dense" strategy's call around it (bcsc20, m = 1024)."""
    import libxsmm_torch as xp
    from libxsmm_torch.descriptor import GemmFlags, GemmShape, SpgemmConfig
    from libxsmm_torch.dtypes import Datatype
    from libxsmm_torch.kernels import spmm as KS
    from libxsmm_torch.ops import sparse as po
    fn, v, out, bcsc = _densifier(dev, KS)
    lib = KS._kernels()
    gmap, k, n, shape = fn.gmap, fn.k, fn.n, (fn.nblocks, fn.bk, fn.bn)
    if hasattr(fn, "route"):     # the lean call
        wrapper = "lean"
        route = fn.route(v, out)
        plan = fn.launch_plan(route, 2)
        args = (v.data_ptr(), gmap.data_ptr(), out.data_ptr(), k, n, fn.bk,
                fn.bn, fn.nblocks, 2, KS._DN_ROUTES[route]) + plan
        steps = [
            ("shape check", lambda: v.shape != shape),
            ("device check",
             lambda: v.device.type != "cuda" or gmap.device != v.device),
            ("element size", lambda: v.element_size() in (1, 2, 4, 8)),
            ("contiguity", lambda: v.is_contiguous()),
            ("output", lambda: v.new_empty((k, n))),
            ("route", lambda: fn.route(v, out)),
            ("plan", lambda: fn.launch_plan(route, 2)),
            ("library", KS._kernels),
            ("device context", _in(lambda: K._on_device(dev))),
            ("stream", lambda: K._stream(dev)),
            ("launch", lambda: lib.xsmm_bcsc_densify(*args,
                                                     K._stream(dev)))]
    else:                        # the earlier wrapper
        wrapper = "earlier"
        steps = [
            ("shape check", lambda: K._check("values", v, shape)),
            ("device check", lambda: K._on_cuda(v, gmap)),
            ("element size", lambda: v.element_size() in (1, 2, 4, 8)),
            ("contiguity", lambda: v.contiguous()),
            ("output", lambda: torch.empty((k, n), dtype=v.dtype,
                                           device=v.device)),
            ("library", KS._kernels),
            ("device context", _in(lambda: torch.cuda.device(v.device))),
            ("pointers", lambda: (K._ptr(v), K._ptr(gmap), K._ptr(out))),
            ("stream", lambda: K._stream(v.device)),
            ("launch", lambda: lib.xsmm_bcsc_densify(
                K._ptr(v), K._ptr(gmap), K._ptr(out), k, n, fn.bk, fn.bn,
                fn.nblocks, 2, K._stream(v.device)))]
    row = {"name": f"densify host split ({wrapper} wrapper)",
           "steps_us": {name: _step_us(step) for name, step in steps},
           "call_us": _step_us(lambda: fn(v))}
    row["steps_sum_us"] = sum(row["steps_us"].values())
    print(f"densify host split, {wrapper} wrapper: " + ", ".join(
        f"{name} {us:.2f}" for name, us in row["steps_us"].items())
        + f" us; steps {row['steps_sum_us']:.2f}, whole call "
        f"{row['call_us']:.2f} us")
    # the "dense" strategy's call (ops/sparse.py _torch_route's fn)
    a = torch.randn(1024, 1024, generator=gen, device=dev).to(torch.bfloat16)
    kern = xp.create_packed_spgemm_bcsc(
        GemmShape(1024, 1024, 1024, Datatype.BF16, Datatype.BF16,
                  Datatype.F32),
        GemmFlags.BETA_0, SpgemmConfig(1, 32, 32), bcsc.indptr,
        bcsc.indices, strategy="dense", device=dev)
    acc = po._dense_product(a, out, torch.float32)
    dsteps = [
        ("entry (registry Kernel)", lambda: kern(a, v)),
        ("as_tensor a, values", lambda: (po.load_operand(a, dev),
                                         po.load_operand(v, dev))),
        ("values.to(b_dt)", lambda: v.to(torch.bfloat16)),
        ("densify", lambda: fn(v)),
        ("bdense.to(a.dtype)", lambda: out.to(torch.bfloat16)),
        ("product", lambda: po._dense_product(a, out, torch.float32)),
        ("acc.to(out_dt)", lambda: acc.to(torch.float32))]
    drow = {"name": "dense strategy host split (bcsc20)",
            "steps_us": {name: _step_us(step) for name, step in dsteps}}
    print("dense strategy host split, bcsc20: " + ", ".join(
        f"{name} {us:.2f}" for name, us in drow["steps_us"].items()) + " us")
    return [row, drow]


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", default=",".join(ROWS),
                    help=f"comma-separated rows to time, of {ROWS}")
    args = ap.parse_args(argv)
    names = args.rows.split(",")
    unknown = sorted(set(names) - set(ROWS))
    if unknown:
        raise SystemExit(f"stream_time: no row {unknown}; rows are {ROWS}")
    if not torch.cuda.is_available():
        raise SystemExit("stream_time: needs a CUDA device")

    from libxsmm_torch.device import GEOMETRY_TABLE
    from libxsmm_torch.kernels import gemm as K

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = timing.card()
    print(smi)
    geo = GEOMETRY_TABLE["h100"]
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    timers = {"passthrough": _passthrough, "designs": _designs,
              "compactor": _compactor, "routes": _routes, "union": _union,
              "densify": _densify, "dplans": _dplans, "dense": _dense,
              "split": _split}
    rows = []
    for name in names:
        rows += timers[name](dev, gen, geo, K)
    print(json.dumps({"card": smi, "rows": rows}))
    return rows


if __name__ == "__main__":
    main()
