"""cnn: the TPP-CNN conv layer (samples/cnn.py) on the port.

    python -m libxsmm_torch.samples.cnn [N H W C K R stride] [--device cpu]

Default 32 56 56 64 64 3 1 (a ResNet layer). A VALID NHWC conv with bias
and ReLU as the BRGEMM over the R*S filter taps: conv2d_kernel (one
dispatch_brgemm_ext call with the fused bias + RELU epilogue) and
conv2d_tpp (the same contraction as torch ops), each held against a
float64 conv (relative max error < 1e-5). Then conv2d_kernel and cuDNN's
f32 conv (F.conv2d on the channels-last view, TF32 off) are timed
interleaved, GFLOP/s each: cuDNN is a yardstick printed beside, not the
port's route. CUDA events on the card, the host clock with --device cpu
(labelled). Returns the number of failed checks.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from . import _common


def layer(n, h, w, c, k, r, stride, dev):
    """(x NHWC, w RSCK, bias, float64 reference of relu(conv + bias)) from
    samples/cnn.py's seed."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((n, h, w, c)),
                        device=dev).float()
    wt = torch.as_tensor(rng.standard_normal((r, r, c, k))
                         / np.sqrt(r * r * c), device=dev).float()
    b = torch.as_tensor(rng.standard_normal((k,)), device=dev).float()
    want = F.conv2d(x.double().permute(0, 3, 1, 2),
                    wt.double().permute(3, 2, 0, 1), b.double(), stride)
    want = want.clamp_min(0.0).permute(0, 2, 3, 1)
    return x, wt, b, want


def _rel(got, want):
    return float((got.double() - want).abs().max()
                 / max(1e-9, float(want.abs().max())))


def main(argv=None) -> int:
    ap = _common.add_device(argparse.ArgumentParser(
        description="the fused conv layer against cuDNN"))
    ap.add_argument("shape", nargs="*", type=int,
                    help="N H W C K R stride (default 32 56 56 64 64 3 1)")
    args = ap.parse_args(argv)
    dev = _common.device(args.device)
    from libxsmm_torch.models.tpp_cnn import conv2d_kernel, conv2d_tpp

    defaults = [32, 56, 56, 64, 64, 3, 1]
    n, h, w, c, k, r, stride = (args.shape + defaults[len(args.shape):])[:7]
    x, wt, b, want = layer(n, h, w, c, k, r, stride, dev)
    p = (h - r) // stride + 1
    q = (w - r) // stride + 1
    flops = 2.0 * n * p * q * r * r * c * k

    failures = 0
    fused = conv2d_kernel(x.shape, wt.shape, stride=stride,
                          fused_bias=True, relu=True)
    err = _rel(fused(x, wt, b), want)
    ok = err < 1e-5
    failures += not ok
    print(f"{'PASS' if ok else 'FAIL'} fused conv {n}x{h}x{w}x{c} -> "
          f"{p}x{q}x{k} (r={r}, stride={stride}) rel_err={err:.2e}")
    err2 = _rel(conv2d_tpp(x, wt, b, stride=stride, activation="relu"),
                want)
    ok2 = err2 < 1e-5
    failures += not ok2
    print(f"{'PASS' if ok2 else 'FAIL'} tpp formulation rel_err={err2:.2e}")

    def cudnn_conv(x, wt, b):
        out = F.conv2d(x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1), b,
                       stride)
        return out.clamp_min(0.0).permute(0, 2, 3, 1)

    print(f"times: {_common.clock(dev)}")
    times = _common.timed([(fused, (x, wt, b)), (cudnn_conv, (x, wt, b))],
                          dev, reps=8)
    lib = "cudnn" if dev.type == "cuda" else "torch conv2d"
    for name, t in zip(("brgemm-fused", f"{lib} (yardstick)"), times):
        print(f"{name}: {flops / t / 1e9:9.1f} GFLOP/s ({t * 1e6:.0f} us)")
    print(f"brgemm/{lib} ratio: {times[1] / times[0]:.3f}")
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
