"""Timing of the bf16 flash-attention kernels on the card: the forward of
`build_flash_attention` and the dK/dV and dQ kernels of
`build_flash_attention_bwd`, at bench.py's serving shape (bh 16, s 2048, hd
128), at the BERT-base encoder block's (8 x 12 heads, s 512, hd 64), at
(16, 1024, 256) and at the training path's (2, 256, 192) (past hd 128: the
forward's 64-key tiles, the backward's wide kernels), non-causal and
causal, and non-causal at dropout 0.1.
Each kernel is held against its plain version on the same operands
(matdiff normf_rel within 1e-2, the bf16 outputs' margin; max |diff|
printed) and timed three ways (scripts/timing.py): CUDA events around 20
back-to-back calls, the best of 5 windows (events_ms; the host's cost of
a call shows where it exceeds the card's); the replay of a CUDA graph of 20
calls (graph_ms: the wrapper's copy of lse's column included); and the
kernel's own device time by torch.profiler (device_split: the CUDA kernels
whose name holds "flash_fwd" or "flash_bwd"). lse comes from the LSE
forward on the
same q, kT and v, delta = rowsum(dout * out), as the autograd node computes
them. Each row carries the bound: 4 (forward), 8 (dK/dV) and 6 (dQ) x hd
flops per (query, key) pair the call needs (causal pairs only where
causal) at the bf16 tensor cores' peak, against q, kT, v (and dout, one
column each of lse and delta) read once and the outputs written once at
3.35 TB/s. Beside the plain and causal forms stands the yardstick:
F.scaled_dot_product_attention on the same q, k and v (its forward; its
backward, through autograd, on the same dout: dq, dk and dv together)
under each bf16 backend, by device time; a backend that refuses the
operands is printed as such.

It uses only entry points that earlier trees of the port have too, so it
also times a checkout of one, whose kernels may take other routes at the
same shapes (the route is printed with every row): put that checkout's
root first on PYTHONPATH and run this file by its path.

    python3 -m libxsmm_torch.scripts.flash_bwd_time [--shapes bench,encoder]
        [--kernels fwd,bwd]

The last line is one JSON object: the card, its power limit, the tree's
root and the rows.
"""

from __future__ import annotations

import argparse
import json
import pathlib
from typing import Optional, Sequence

import torch

try:
    from . import timing
except ImportError:
    import timing   # is sys.path[0]

SHAPES = {"bench": (16, 2048, 128), "encoder": (96, 512, 64),
          "hd256": (16, 1024, 256), "hd192": (2, 256, 192)}
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH")
FORMS = {"plain": {}, "causal": {"causal": True},
         "dropout": {"dropout_p": 0.1}}
TOL = 1e-2                     # normf_rel of the bf16 outputs
PEAK_BF16 = 989e12             # the H100's dense bf16 tensor-core rate
HBM = 3.35e12                  # and its memory rate, bytes a second


def _held(got, want) -> float:
    """got against want (tensors or tuples of them); the max |diff|."""
    from libxsmm_torch.matdiff import check
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    worst = 0.0
    for g, w in zip(got, want):
        check(w.double().cpu().numpy(), g.double().cpu().numpy(),
              margin=TOL)
        worst = max(worst, float((g.double() - w.double()).abs().max()))
    return worst


def _bound_ms(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16, nbytes / HBM) * 1e3


def sdpa_fwd_ms(q, kT, v, causal: bool, timer=None) -> dict:
    """{backend: ms of SDPA's forward by `timer` (device time unless told
    otherwise), or the refusal}."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    ops = (q[None], kT.transpose(-1, -2).contiguous()[None], v[None])
    out = {}
    for name in SDPA_BACKENDS:
        def call(name=name):
            with sdpa_kernel(getattr(SDPBackend, name)):
                return torch.nn.functional.scaled_dot_product_attention(
                    *ops, is_causal=causal)
        try:
            call()
        except (RuntimeError, AttributeError) as e:
            out[name] = str(e).splitlines()[0][:100]
            continue
        out[name] = (timer or timing.device_ms)(call)
    return out


def fwd_rows_at(shape: str, form: str, seed: int, sdpa_timer=None) -> list:
    """The forward's row at one shape and form, with SDPA's forward under
    each backend beside the plain and causal forms (by device time, or by
    `sdpa_timer`)."""
    from libxsmm_torch.kernels import attention as KA

    bh, s, hd = SHAPES[shape]
    kw = FORMS[form]
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*dims):
        return torch.randn(*dims, device="cuda",
                           generator=gen).to(torch.bfloat16)

    q, v, kT = randn(bh, s, hd), randn(bh, s, hd), randn(bh, hd, s)
    fn = KA.build_flash_attention(bh, s, hd, torch.bfloat16, **kw)
    args = (seed, q, kT, v)
    err = _held(fn(*args), fn.plain(*args))
    split = timing.device_split(lambda: fn(*args))
    dev = sum(t for k, t in split.items() if "flash_fwd" in k)
    pairs = bh * (s * (s + 1) // 2 if kw.get("causal") else s * s)
    flops = 4 * pairs * hd
    bound = _bound_ms(flops, 4 * bh * s * hd * 2)
    row = {"shape": shape, "bh": bh, "s": s, "hd": hd, "form": form,
           "kernel": "fwd", "route": fn.path,
           "ms": timing.events_ms(lambda: fn(*args)),
           "graph_ms": timing.graph_ms(lambda: fn(*args)),
           "device_ms": dev, "bound_ms": bound,
           "of_bound": bound / dev if dev else None,
           "tflops": flops / dev / 1e9 if dev else None,
           "max_abs_err": err}
    if "dropout_p" not in kw:
        row["sdpa_ms"] = sdpa_fwd_ms(q, kT, v, bool(kw), sdpa_timer)
    return [row]


def sdpa_ms(q, kT, v, dout, causal: bool) -> dict:
    """{backend: device ms of SDPA's backward, or the refusal}."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    out = {}
    for name in SDPA_BACKENDS:
        leaves = tuple(t.detach().requires_grad_(True) for t in (
            q[None], kT.transpose(-1, -2).contiguous()[None], v[None]))
        try:
            with sdpa_kernel(getattr(SDPBackend, name)):
                o = torch.nn.functional.scaled_dot_product_attention(
                    *leaves, is_causal=causal)
            torch.autograd.grad(o, leaves, dout[None], retain_graph=True)
        except (RuntimeError, AttributeError) as e:
            out[name] = str(e).splitlines()[0][:100]
            continue
        out[name] = timing.device_ms(lambda: torch.autograd.grad(
            o, leaves, dout[None], retain_graph=True))
    return out


def rows_at(shape: str, form: str, seed: int) -> list:
    from libxsmm_torch.kernels import attention as KA

    bh, s, hd = SHAPES[shape]
    kw = FORMS[form]
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*dims):
        return torch.randn(*dims, device="cuda", generator=gen).to(bf16)

    q, v, dout, kT = (randn(bh, s, hd), randn(bh, s, hd), randn(bh, s, hd),
                      randn(bh, hd, s))
    out, lse = KA.build_flash_attention(bh, s, hd, bf16, return_lse=True,
                                        **kw)(seed, q, kT, v)
    delta = (dout.float() * out.float()).sum(-1, keepdim=True).expand(
        bh, s, 128)
    args = (seed, q, kT, v, dout, lse, delta)
    bwd = KA.build_flash_attention_bwd(bh, s, hd, bf16, **kw)
    pairs = bh * (s * (s + 1) // 2 if kw.get("causal") else s * s)
    io = 4 * bh * s * hd * 2 + 2 * bh * s * 4
    rows = []
    for part, fn, plain, flops, nout in (
            ("dkv", bwd.dkv, bwd.dkv_plain, 8 * pairs * hd, 2),
            ("dq", bwd.dq, bwd.dq_plain, 6 * pairs * hd, 1)):
        err = _held(fn(*args), plain(*args))
        t = timing.events_ms(lambda: fn(*args))
        split = timing.device_split(lambda: fn(*args))
        dev = sum(v for k, v in split.items() if "flash_bwd" in k)
        bound = _bound_ms(flops, io + nout * bh * s * hd * 2)
        rows.append({"shape": shape, "bh": bh, "s": s, "hd": hd,
                     "form": form, "kernel": part, "route": bwd.path,
                     "ms": t, "graph_ms": timing.graph_ms(lambda: fn(*args)),
                     "device_ms": dev, "bound_ms": bound,
                     "of_bound": bound / dev if dev else None,
                     "tflops": flops / dev / 1e9 if dev else None,
                     "max_abs_err": err})
    if "dropout_p" not in kw:
        rows[-1]["sdpa_ms"] = sdpa_ms(q, kT, v, dout, bool(kw))
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shapes", default=",".join(SHAPES))
    p.add_argument("--forms", default=",".join(FORMS))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--kernels", default="fwd,bwd",
                   help="fwd (the forward), bwd (dK/dV and dQ), or both")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the kernels time only on the card")
    import libxsmm_torch
    root = str(pathlib.Path(libxsmm_torch.__file__).resolve().parents[1])
    card = timing.card()
    print(f"card: {card}; tree: {root}")
    rows = []
    makers = {"fwd": fwd_rows_at, "bwd": rows_at}
    runs = [(shape, form, kind) for shape in args.shapes.split(",")
            for form in args.forms.split(",")
            for kind in args.kernels.split(",")]
    for shape, form, kind in runs:
        new = makers[kind](shape, form, args.seed)
        rows.extend(new)
        for r in new:
            rate = (f"{r['tflops']:.1f} TFLOP/s, {r['of_bound']:.3f} of "
                    f"its bound" if r["device_ms"] else
                    "the profiler recorded no kernel")
            print(f"  {shape} {r['bh']}x{r['s']}x{r['hd']} {form} "
                  f"{r['kernel']} [{r['route']}]: device "
                  f"{r['device_ms']:.4f} ms ({rate} "
                  f"{r['bound_ms']:.4f} ms), events {r['ms']:.4f}, "
                  f"replay {r['graph_ms']:.4f}; max_abs_err "
                  f"{r['max_abs_err']:.3e}")
        sdpa = new[-1].get("sdpa_ms")
        if sdpa:
            mine = sum(x["device_ms"] for x in new)
            what = "dkv + dq" if kind == "bwd" else "forward"
            print(f"  {shape} {form} {what} device {mine:.4f} ms; sdpa "
                  f"{'backward' if kind == 'bwd' else 'forward'} device: "
                  + "; ".join(
                      f"{n} {t:.4f} ms (kernels / sdpa {mine / t:.3f})"
                      if isinstance(t, float) else f"{n} refused ({t})"
                      for n, t in sdpa.items()))
    print(json.dumps({"card": card, "root": root, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
