#!/usr/bin/env python3
"""Drive libxsmm_torch's main paths on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout; it needs one CUDA device and the CUDA
toolkit's nvcc, and imports nothing of JAX or libxsmm_tpu. In order:

1. prints the card's name and power limit (nvidia-smi);
2. builds the hand-written kernels from libxsmm_torch/kernels/csrc/ with
   nvcc for sm_90a (one nvcc per source, all started together) and prints
   the build time;
3. drives the small-GEMM main path through the public entry points, with
   every kernel's launch count set to 0 just before and read just after:
   - the headline: dispatch_gemm_batched_packed(GemmShape(32,32,32),
     BETA_0) on 16384 f32 problems (4096 lane-packed groups), then
     unpack_batched; then smaller runs in bf16->f32, i8->i32, with RELU and
     GELU epilogues, with beta=1, and with a group count and row count that
     leave ragged tiles;
   - dispatch_gemm_batched on 16384 x 32^3 f32;
   - dispatch_brgemm_packed at br=1024, m=n=256, k=64 bf16->f32, then
     dispatch_brgemm_ext_packed with RELU + bias and with beta=1 GELU;
   - dispatch_gemm / dispatch_brgemm (the torch route) for f32, bf16->f32,
     f64 and i8->i32;
   each phase checks its output for shape and finiteness, holds it against
   a float64 reference and against the plain torch version of its kernel
   (computed on the card, launching nothing) with matdiff, and checks that
   its kernel's launch count rose;
4. fails unless every kernel of the path was launched in that run, then
   times every phase with CUDA events (outside the counted run);
5. drives the TPP-Attention encoder block's serving path the same way,
   with the flash-attention and dropout counts set to 0 just before:
   - EncoderBlock at BERT-base width (dim 768, 12 heads, FFN 3072; Devlin
     et al. 2018, BERT_BASE), bf16, flash=True, batch 8 x seq 512, served
     (seed=None), held against a float64 torch composition of the same
     block and against the port's own flash=False path;
   - the same widths in f32, causal, batch 2;
   - the bf16 block seeded (dropout_p=0.1, seed=7): finite, repeatable,
     the FFN keep rate within 4 sigma of 0.9;
   - dispatch_flash_attention at bench.py's serving shape (bh=16, s=2048,
     hd=128, bf16): plain, causal, dropout, bias per head and broadcast,
     and the LSE output; f32 at (4, 1024, 64) and hd=256 at (2, 256, 256);
   - dispatch_meltw_unary(DROPOUT, BITMASK_2BYTEMULT) at the FFN shape
     4096 x 3072 in bf16, f32 and f16;
   then fails unless both kernels were launched, and times every phase;
6. holds each kernel against its plain version once more at its main-path
   shape, and times kernel, plain version and one library call computing
   the same function (a yardstick the port never calls), and each launch
   configuration the kernel chooses among;
7. prints one JSON line with the per-kernel numbers and, last, the result
   line {"ok": true, "device": {...}}.

Any failure raises and exits non-zero; nothing is caught. Without a CUDA
device it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

# tolerances (matdiff normf_rel bound; 0 means bit-exact):
TOL_F32 = 1e-5        # f32 in and out: products and sums in f32, only the
                      # order of the sum differs
TOL_BF16_IN = 1e-4    # bf16 in, f32 out: products exact in f32, order differs
TOL_EXACT = 0.0       # int8 in, int32 out; dropout (same hash, same f32
                      # arithmetic in kernel and plain version)
TOL_BF16_OUT = 1e-2   # bf16 out: flash rounds its probabilities to bf16
                      # against a per-tile running max, the plain version
                      # against the row max, then the output is rounded
TOL_BLOCK_BF16 = 2e-2  # bf16 encoder block against its float64 composition:
                       # activations rounded to bf16 between the stages
TOL_BLOCK_F32 = 1e-5   # f32 encoder block against its float64 composition


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def _check(name, ref, out, margin, shape=None):
    """Hold `out` (a tensor or a tuple of them) against `ref`: shape,
    finiteness, then matdiff within `margin` (0: bit-exact). Returns the
    largest normf_rel."""
    from libxsmm_torch.matdiff import check
    if isinstance(out, tuple):
        return max(_check(f"{name}[{i}]", r, o, margin)
                   for i, (r, o) in enumerate(zip(ref, out)))
    if shape is not None and tuple(out.shape) != tuple(shape):
        raise AssertionError(f"{name}: shape {tuple(out.shape)} != {shape}")
    if out.is_floating_point() and not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{name}: non-finite values in the output")
    if margin == 0.0:
        if not torch.equal(ref.to(out.dtype), out):
            raise AssertionError(f"{name}: output differs")
        return 0.0
    return check(ref, out, margin=margin).normf_rel


def _max_abs(ref, out):
    if isinstance(out, tuple):
        return max(_max_abs(r, o) for r, o in zip(ref, out))
    return float((ref.double() - out.double()).abs().max())


def _count(name):
    """The launch count of the kernel called `name`."""
    from libxsmm_torch.kernels import attention, eltwise, gemm
    for launches in (gemm.launches, attention.launches, eltwise.launches):
        if name in launches:
            return launches[name]
    raise KeyError(name)


def encoder_path(randn, dev):
    """The TPP-Attention encoder block's serving path, driven through the
    public entry points with the flash-attention and dropout launch counts
    set to 0 just before and read just after. Returns the phases (to time),
    the counts, and the operands the per-kernel rows reuse."""
    import dataclasses

    import libxsmm_torch as xt
    from libxsmm_torch.descriptor import UnaryFlags, UnaryType
    from libxsmm_torch.dtypes import Datatype
    from libxsmm_torch.kernels import attention as KA
    from libxsmm_torch.kernels import eltwise as KE
    from libxsmm_torch.models import tpp_attention as TA

    bf16, f32 = torch.bfloat16, torch.float32
    phases = []

    def run(name, kernels, fn, *fargs):
        before = {k: _count(k) for k in kernels}
        out = fn(*fargs)
        torch.cuda.synchronize()
        for k in kernels:
            if _count(k) <= before[k]:
                raise AssertionError(f"{name}: {k} was not launched")
        phases.append((name, fn, fargs))
        return out

    def block64(block, x):
        """The same block as a float64 torch composition (flash=False)."""
        cfg64 = dataclasses.replace(block.cfg, dtype="float64", flash=False)
        p64 = {k: v.double() for k, v in block.params().items()}
        return TA.forward(p64, x.double(), cfg64)

    KA.reset_launches()
    KE.reset_launches()
    t_path = time.perf_counter()
    # BERT-base widths (Devlin et al. 2018, BERT_BASE): d=768, 12 heads of
    # 64, FFN 3072; batch 8 x seq 512, random weights from the seed
    cfg = TA.AttentionConfig(dim=768, heads=12, ffn_mult=4, dtype="bfloat16",
                             flash=True)
    block = TA.EncoderBlock(cfg, init_seed=0, device=dev)
    x = randn(8, 512, 768, dtype=bf16)
    with torch.inference_mode():
        y = run("block bert-base bf16 serve 8x512", ["flash_attention_fwd"],
                block, x)
        e64 = _check("block bf16 vs float64", block64(block, x), y,
                     TOL_BLOCK_BF16, (8, 512, 768))
        nonflash = TA.forward(block.params(), x,
                              dataclasses.replace(cfg, flash=False))
        enf = _check("block bf16 vs flash=False", nonflash, y, TOL_BF16_OUT)
        print(f"  block bf16: normf_rel vs float64 {e64:.3e}, vs flash=False"
              f" {enf:.3e}")

        cfg32 = dataclasses.replace(cfg, dtype="float32", causal=True)
        block32 = TA.EncoderBlock(cfg32, init_seed=1, device=dev)
        x32 = randn(2, 512, 768)
        y32 = run("block bert-base f32 causal 2x512",
                  ["flash_attention_fwd"], block32, x32)
        e64 = _check("block f32 causal vs float64", block64(block32, x32),
                     y32, TOL_BLOCK_F32, (2, 512, 768))
        enf = _check("block f32 causal vs flash=False",
                     TA.forward(block32.params(), x32,
                                dataclasses.replace(cfg32, flash=False)),
                     y32, TOL_F32)
        print(f"  block f32 causal: normf_rel vs float64 {e64:.3e}, vs "
              f"flash=False {enf:.3e}")

        cfg_d = dataclasses.replace(cfg, dropout_p=0.1)
        block_d = TA.EncoderBlock(cfg_d, params=block.params())
        yd = run("block bert-base bf16 seeded 8x512",
                 ["flash_attention_fwd", "dropout"],
                 lambda t: block_d(t, seed=7), x)
        if not bool(torch.isfinite(yd.float()).all()):
            raise AssertionError("seeded block: non-finite output")
        if not torch.equal(yd, block_d(x, seed=7)):
            raise AssertionError("seeded block: the same seed gave another "
                                 "result")
        # the FFN dropout's mask (seed + 1, (b*s, 4*dim)), recomputed by the
        # plain version, which draws the kernel's bits and launches nothing
        _, ffn_mask = KE.dropout.plain(
            torch.zeros(8 * 512, 3072, dtype=bf16, device=dev), 8, 0.1)
        rate = ffn_mask.float().mean().item()
        sigma = (0.9 * 0.1 / ffn_mask.numel()) ** 0.5
        print(f"  seeded block: FFN keep rate {rate:.5f} (0.9 +- 4 x "
              f"{sigma:.1e})")
        if abs(rate - 0.9) > 4 * sigma:
            raise AssertionError(f"seeded block: FFN keep rate {rate}")

    # dispatch_flash_attention at bench.py's serving shape (bench.py:568)
    bh, s, hd = 16, 2048, 128
    q, v = randn(bh, s, hd, dtype=bf16), randn(bh, s, hd, dtype=bf16)
    kT = randn(bh, hd, s, dtype=bf16)
    bias_h, bias_1 = randn(bh, s, s, scale=0.5), randn(1, s, s, scale=0.5)
    for name, kw, call in (
            ("plain", {}, {}), ("causal", {"causal": True}, {}),
            ("dropout", {"dropout_p": 0.1}, {"seed": 5}),
            ("bias per head", {"bias_bh": bh}, {"bias": bias_h}),
            ("bias broadcast", {"bias_bh": 1}, {"bias": bias_1})):
        kern = xt.dispatch_flash_attention(bh, s, hd, Datatype.BF16, **kw)
        out = run(f"flash {name} bf16 {bh}x{s}x{hd}", ["flash_attention_fwd"],
                  lambda a, b, c, kern=kern, call=call: kern(a, b, c, **call),
                  q, kT, v)
        plain = KA.build_flash_attention(bh, s, hd, bf16, **kw).plain(
            call.get("seed", 0), q, kT, v, call.get("bias"))
        _check(f"flash {name} vs plain", plain, out, TOL_BF16_OUT,
               (bh, s, hd))
    lse_fn = KA.build_flash_attention(bh, s, hd, bf16, return_lse=True)
    got = run(f"flash lse bf16 {bh}x{s}x{hd}", ["flash_attention_fwd"],
              lse_fn, 0, q, kT, v)
    want = lse_fn.plain(0, q, kT, v)
    _check("flash lse: out vs plain", want[0], got[0], TOL_BF16_OUT)
    _check("flash lse: lse vs plain", want[1], got[1], TOL_F32,
           (bh, s, 128))
    for fbh, fs, fhd in ((4, 1024, 64), (2, 256, 256)):
        fq, fv = randn(fbh, fs, fhd), randn(fbh, fs, fhd)
        fkT = randn(fbh, fhd, fs)
        kern = xt.dispatch_flash_attention(fbh, fs, fhd, Datatype.F32)
        out = run(f"flash f32 {fbh}x{fs}x{fhd}", ["flash_attention_fwd"],
                  kern, fq, fkT, fv)
        _check(f"flash f32 {fbh}x{fs}x{fhd} vs plain",
               KA.build_flash_attention(fbh, fs, fhd, f32).plain(
                   0, fq, fkT, fv), out, TOL_F32, (fbh, fs, fhd))

    # dispatch_meltw_unary(DROPOUT) with the packed bitmask at the FFN shape
    m, n = 8 * 512, 3072
    for dt, dtn in ((bf16, "BF16"), (f32, "F32"), (torch.float16, "F16")):
        kern = xt.dispatch_meltw_unary(
            UnaryType.DROPOUT, m, n, UnaryFlags.BITMASK_2BYTEMULT,
            in_type=Datatype[dtn], extra=(0.1,))
        xd = randn(m, n, dtype=dt)
        out, packed = run(f"meltw dropout {dtn.lower()} {m}x{n}", ["dropout"],
                          kern, xd, 7)
        want_out, want_mask = KE.dropout.plain(xd, 7, 0.1)
        _check(f"meltw dropout {dtn}: out vs plain", want_out, out,
               TOL_EXACT, (m, n))
        _check(f"meltw dropout {dtn}: mask vs plain",
               xt.pack_bitmask(want_mask != 0), packed, TOL_EXACT,
               (m, n // 8))

    torch.cuda.synchronize()
    counts = {**KA.launches, **KE.launches}
    print(f"encoder path: {len(phases)} phases in "
          f"{time.perf_counter() - t_path:.2f} s, kernel launches {counts}")
    missing = [k for k, c in counts.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the encoder path: "
                             f"{missing}")
    # the block's attention shape: 8 x 12 heads, s=512, hd=64
    block_ops = (randn(96, 512, 64, dtype=bf16), randn(96, 64, 512, dtype=bf16),
                 randn(96, 512, 64, dtype=bf16))
    return {"phases": phases, "counts": counts,
            "flash_operands": (q, kT, v), "block_operands": block_ops,
            "dropout_operand": randn(m, n, dtype=bf16),
            "block": (block, x)}


def block_breakdown(block, x, block_ops, ms):
    """Where the served block's time goes: each stage of forward() timed
    alone at its shape, beside the whole forward."""
    from libxsmm_torch.descriptor import UnaryFlags, UnaryType
    from libxsmm_torch.kernels import attention as KA
    from libxsmm_torch.models import tpp_attention as TA
    from libxsmm_torch.ops.eltwise import apply_unary_op

    p = block.params()
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    hid = TA._linear(x2, p["w1"], p["b1"])
    flash = KA.build_flash_attention(*block_ops[0].shape, x.dtype)
    stages = {
        "layernorm x2": 2 * ms(TA._layernorm, x, p["ln1_g"], p["ln1_b"]),
        "qkv linear": ms(TA._linear, x2, p["wqkv"], p["bqkv"]),
        "flash": ms(flash, 0, *block_ops),
        "out linear": ms(TA._linear, x2, p["wo"], p["bo"]),
        "ffn1 linear": ms(TA._linear, x2, p["w1"], p["b1"]),
        "gelu": ms(lambda t: apply_unary_op(UnaryType.GELU, UnaryFlags.NONE,
                                            t), hid),
        "ffn2 linear": ms(TA._linear, hid.to(x.dtype), p["w2"], p["b2"]),
    }
    total = ms(block, x)
    parts = ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
    print(f"  block breakdown (ms, each stage alone): {parts}; sum "
          f"{sum(stages.values()):.4f}; whole forward {total:.4f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is present", file=sys.stderr)
        return 2

    import libxsmm_torch as xt
    from libxsmm_torch.descriptor import (BatchReduceConfig, BatchReduceType,
                                          BinaryPostops, BinaryType,
                                          GemmDescriptor, GemmFlags,
                                          GemmShape, UnaryArgops, UnaryType)
    from libxsmm_torch.device import GEOMETRY_TABLE
    from libxsmm_torch.dtypes import Datatype
    from libxsmm_torch.kernels import _build
    from libxsmm_torch.kernels import attention as KA
    from libxsmm_torch.kernels import eltwise as KE
    from libxsmm_torch.kernels import gemm as K
    from libxsmm_torch.utils.timer import bench_chain

    # f32 means f32: no TF32 anywhere, in the port or in the references
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = _smi()
    print(smi)
    dev = torch.device("cuda", 0)
    geo = GEOMETRY_TABLE["h100"]

    # 2. build
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(sorted(built)) or 'up to date'})")
    for stem, log in _build.build_log.items():
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes")]
        print(f"  {stem}: {log.count('Used ')} kernels compiled, "
              f"{len(spills)} with spills {spills}")

    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        x = torch.randn(*shape, generator=gen, device=dev) * scale
        return x.to(dtype)

    def randint8(*shape):
        return torch.randint(-100, 100, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def bmm64(a, b):
        return torch.matmul(a.double(), b.double())

    B0 = GemmFlags.BETA_0
    F32, BF16, I8, I32 = (Datatype.F32, Datatype.BF16, Datatype.I8,
                          Datatype.I32)

    # 3. the main path, counted. Each phase runs one public entry point,
    # holds its output against a float64 reference and, where a kernel runs,
    # against that kernel's plain torch version (which launches nothing),
    # and checks that the kernel's launch count rose.
    phases = []

    def phase(name, kernel, fn, args, post, ref, plain, tol, shape):
        before = K.launches.get(kernel, 0)
        out = post(fn(*args))
        torch.cuda.synchronize()
        _check(f"{name} vs float64", ref, out, tol, shape)
        if plain is not None:
            _check(f"{name} vs plain", post(plain(*args)), out, tol, shape)
        if kernel is not None and K.launches[kernel] <= before:
            raise AssertionError(f"{name}: {kernel} was not launched")
        phases.append((name, fn, args))

    def ident(x):
        return x

    def unpacked(x):
        return xt.unpack_batched(x, p)

    def gelu(x):
        return 0.5 * x * (1.0 + torch.special.erf(x / 2 ** 0.5))

    def smm_plain(shape, flags=B0, cp="NONE", groups=None):
        d = GemmDescriptor(shape, flags)
        return K.build_packed_batched_gemm(d, groups, cp).plain

    K.reset_launches()
    t_path = time.perf_counter()
    B, m, n, k = 16384, 32, 32, 32
    p = xt.smm_pack_factor(GemmShape(m, n, k))
    G = B // p
    a_u, b_u = randn(B, m, k), randn(B, k, n, scale=0.1)
    ap, bp = xt.pack_batched(a_u, p), xt.pack_batched(b_u, p)
    smm = GemmShape(m, n, k)
    phase("headline packed f32", "packed_batched_gemm",
          xt.dispatch_gemm_batched_packed(smm, B0), (ap, bp), unpacked,
          bmm64(a_u, b_u), smm_plain(smm, groups=G), TOL_F32, (B, m, n))

    Bs = 1024
    Gs = Bs // p
    sbf = GemmShape(m, n, k, a_in_type=BF16, b_in_type=BF16, out_type=F32)
    ab = randn(Bs, m, k, dtype=torch.bfloat16)
    bb = randn(Bs, k, n, dtype=torch.bfloat16)
    phase("packed bf16->f32", "packed_batched_gemm",
          xt.dispatch_gemm_batched_packed(sbf, B0),
          (xt.pack_batched(ab, p), xt.pack_batched(bb, p)), unpacked,
          bmm64(ab, bb), smm_plain(sbf, groups=Gs), TOL_BF16_IN, (Bs, m, n))

    si8 = GemmShape(m, n, k, a_in_type=I8, b_in_type=I8, out_type=I32)
    ai, bi = randint8(Bs, m, k), randint8(Bs, k, n)
    phase("packed i8->i32", "packed_batched_gemm",
          xt.dispatch_gemm_batched_packed(si8, B0),
          (xt.pack_batched(ai, p), xt.pack_batched(bi, p)), unpacked,
          bmm64(ai, bi).round().to(torch.int32), smm_plain(si8, groups=Gs),
          TOL_EXACT, (Bs, m, n))

    af, bf = randn(Bs, m, k), randn(Bs, k, n, scale=0.2)
    apf, bpf = xt.pack_batched(af, p), xt.pack_batched(bf, p)
    for cp, ref_fn in ((UnaryType.RELU, lambda x: x.clamp_min(0.0)),
                       (UnaryType.GELU, gelu)):
        phase(f"packed {cp.name}", "packed_batched_gemm",
              xt.dispatch_gemm_batched_packed(smm, B0, cp_type=cp),
              (apf, bpf), unpacked, ref_fn(bmm64(af, bf)),
              smm_plain(smm, cp=cp.name, groups=Gs), TOL_F32, (Bs, m, n))

    cf = randn(Bs, m, n)
    phase("packed beta=1", "packed_batched_gemm",
          xt.dispatch_gemm_batched_packed(smm),
          (apf, bpf, xt.pack_batched(cf, p)), unpacked,
          bmm64(af, bf) + cf.double(),
          smm_plain(smm, GemmFlags.NONE, groups=Gs), TOL_F32, (Bs, m, n))

    # 1001 groups of 40 rows: ragged in the group count and the row tile
    Gr, mr = 1001, 40
    sr = GemmShape(mr, n, k)
    ar, brr = randn(Gr * p, mr, k), randn(Gr * p, k, n)
    phase("packed ragged", "packed_batched_gemm",
          xt.dispatch_gemm_batched_packed(sr, B0),
          (xt.pack_batched(ar, p), xt.pack_batched(brr, p)), unpacked,
          bmm64(ar, brr), smm_plain(sr, groups=Gr), TOL_F32, (Gr * p, mr, n))

    phase("batched f32", "batched_gemm",
          xt.dispatch_gemm_batched(smm, B0), (a_u, b_u), ident,
          bmm64(a_u, b_u), K.build_batched_gemm(GemmDescriptor(smm, B0),
                                                B).plain,
          TOL_F32, (B, m, n))

    br, M, N, KK = 1024, 256, 256, 64
    q = xt.brgemm_pack_factor(GemmShape(M, N, KK))
    shape_br = GemmShape(M, N, KK, a_in_type=BF16, b_in_type=BF16,
                         out_type=F32)
    cfg = BatchReduceConfig(BatchReduceType.STRIDE, br)
    a_br = randn(br, M, KK, dtype=torch.bfloat16)
    b_br = randn(br, KK, N, scale=0.1, dtype=torch.bfloat16)
    ap_br = xt.pack_batched(a_br, q)
    ref_br = torch.einsum("bmk,bkn->mn", a_br.double(), b_br.double())

    def br_plain(flags=B0, cp="NONE", bias=False):
        return K.build_packed_brgemm(GemmDescriptor(shape_br, flags, cfg), br,
                                     cp_type=cp, with_bias=bias).plain

    phase("brgemm packed", "packed_brgemm",
          xt.dispatch_brgemm_packed(shape_br, B0, cfg), (ap_br, b_br), ident,
          ref_br, br_plain(), TOL_BF16_IN, (M, N))
    bias = randn(1, N)
    kx = xt.dispatch_brgemm_ext_packed(
        shape_br, B0, cfg, argops=UnaryArgops(cp_type=UnaryType.RELU),
        postops=BinaryPostops(d_type=BinaryType.ADD))
    bias_mn = bias.expand(M, N)
    relu_plain = br_plain(cp="RELU", bias=True)
    phase("brgemm ext relu+bias", "packed_brgemm",
          lambda a, b: kx(a, b, d_op=bias), (ap_br, b_br), ident,
          (ref_br + bias.double()).clamp_min(0.0),
          lambda a, b: relu_plain(a, b, None, bias_mn), TOL_BF16_IN, (M, N))
    c0 = randn(M, N)
    phase("brgemm ext beta=1 gelu", "packed_brgemm",
          xt.dispatch_brgemm_ext_packed(
              shape_br, GemmFlags.NONE, cfg,
              argops=UnaryArgops(cp_type=UnaryType.GELU)),
          (ap_br, b_br, c0), ident, gelu(ref_br + c0.double()),
          br_plain(GemmFlags.NONE, "GELU"), TOL_BF16_IN, (M, N))

    # the torch route (the reference's XLA route): no kernel of its own
    gm, gn, gk, gbr = 64, 48, 32, 8
    for a_t, o_t, tol in ((F32, F32, TOL_F32), (BF16, F32, TOL_BF16_IN),
                          (Datatype.F64, Datatype.F64, 1e-12),
                          (I8, I32, TOL_EXACT)):
        sh = GemmShape(gm, gn, gk, a_in_type=a_t, b_in_type=a_t, out_type=o_t)
        if a_t == I8:
            a2, b2 = randint8(gm, gk), randint8(gk, gn)
            a3, b3 = randint8(gbr, gm, gk), randint8(gbr, gk, gn)
        else:
            tdt = xt.to_torch(a_t)
            a2, b2 = randn(gm, gk, dtype=tdt), randn(gk, gn, dtype=tdt)
            a3, b3 = (randn(gbr, gm, gk, dtype=tdt),
                      randn(gbr, gk, gn, dtype=tdt))
        ref2 = bmm64(a2, b2)
        ref3 = torch.einsum("bmk,bkn->mn", a3.double(), b3.double())
        if a_t == I8:
            ref2, ref3 = (r.round().to(torch.int32) for r in (ref2, ref3))
        phase(f"gemm {a_t.value}->{o_t.value}", None,
              xt.dispatch_gemm(sh, B0), (a2, b2), ident, ref2, None, tol,
              (gm, gn))
        phase(f"brgemm {a_t.value}->{o_t.value}", None,
              xt.dispatch_brgemm(sh, B0, BatchReduceConfig(
                  BatchReduceType.STRIDE, gbr)), (a3, b3), ident, ref3, None,
              tol, (gm, gn))
    torch.cuda.synchronize()
    counts = dict(K.launches)
    print(f"main path: {len(phases)} phases in "
          f"{time.perf_counter() - t_path:.2f} s, kernel launches {counts}")

    # 4. every kernel of the path ran
    missing = [name for name, c in counts.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")

    def ms(fn, *fargs):
        return bench_chain(fn, fargs, reps=20, rounds=3) * 1e3

    for name, fn, fargs in phases:
        print(f"  phase {name}: {ms(fn, *fargs):.4f} ms per call")

    # 5. the encoder block's serving path, counted on its own
    enc = encoder_path(randn, dev)
    for name, fn, fargs in enc["phases"]:
        print(f"  phase {name}: {ms(fn, *fargs):.4f} ms per call")
    counts.update(enc["counts"])
    block_breakdown(*enc["block"], enc["block_operands"], ms)

    # 6. each kernel against its plain version, and timed
    rows = []

    def record(name, source, replaces, fn, fargs, ref_tol, nbytes, flops,
               peak, lib):
        got, want = fn(*fargs), fn.plain(*fargs)
        torch.cuda.synchronize()
        _check(f"{name} kernel vs plain", want, got, ref_tol)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"libxsmm_torch/kernels/csrc/{source}",
            "replaces": f"libxsmm_tpu/kernels/{replaces}",
            "launches": counts[name],
            "max_abs_err": _max_abs(want, got),
            "ms": ms(fn, *fargs), "plain_ms": ms(fn.plain, *fargs),
            "bound_ms": geo.bound_ms(nbytes, flops, peak),
            "bound_by": geo.bound_by(nbytes, flops, peak),
            "library_ms": lib,
        })

    gemm_src = "gemm_kernels.cu"
    desc = GemmDescriptor(smm, B0)
    smm_bytes, smm_flops = 3 * B * m * n * 4, 2 * B * m * n * k
    record("packed_batched_gemm", gemm_src, "gemm_pallas.py:467",
           K.build_packed_batched_gemm(desc, G), (ap, bp), TOL_F32,
           smm_bytes, smm_flops, geo.peak_f32_tflops,
           ms(torch.bmm, a_u, b_u))
    record("batched_gemm", gemm_src, "gemm_pallas.py:67",
           K.build_batched_gemm(desc, B), (a_u, b_u),
           TOL_F32, smm_bytes, smm_flops, geo.peak_f32_tflops,
           ms(torch.bmm, a_u, b_u))
    desc_br = GemmDescriptor(shape_br, B0, cfg)
    # the library yardstick: one bf16 matmul with an f32 output over the
    # whole (m, br*k) x (br*k, n) contraction
    a_lib = ap_br.permute(1, 0, 2).reshape(M, br * KK).contiguous()
    b_lib = b_br.reshape(br * KK, N)

    def mm_f32(x, y):
        return torch.mm(x, y, out_dtype=torch.float32)

    br_bytes = 2 * br * KK * (M + N) + 4 * M * N
    record("packed_brgemm", gemm_src, "gemm_pallas.py:163",
           K.build_packed_brgemm(desc_br, br),
           (ap_br, b_br), TOL_BF16_IN, br_bytes, 2 * M * N * KK * br,
           geo.peak_bf16_tflops, ms(mm_f32, a_lib, b_lib))

    # flash forward at bench.py's serving shape: two (s, s, hd) products
    # over the bf16 tensor cores' peak; q, kT and v read once, out written
    # once. The yardstick is PyTorch's fused attention on the same q, k, v,
    # laid out as its fused kernels take them: (1, bh, s, hd), contiguous.
    fq, fkT, fv = enc["flash_operands"]
    fbh, fs, fhd = fq.shape
    flash = KA.build_flash_attention(fbh, fs, fhd, torch.bfloat16)

    def sdpa_operands(q_, kT_, v_):
        return q_[None], kT_.transpose(-1, -2).contiguous()[None], v_[None]

    def sdpa(q4, k4, v4, causal=False):
        return torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal)

    record("flash_attention_fwd", "attention_kernels.cu",
           "attention_pallas.py:159", flash, (0, fq, fkT, fv), TOL_BF16_OUT,
           4 * fbh * fs * fhd * 2, 4 * fbh * fs * fs * fhd,
           geo.peak_bf16_tflops, ms(sdpa, *sdpa_operands(fq, fkT, fv)))
    # dropout at the FFN shape: x read once, out and the byte mask written
    # once; the yardstick is torch's dropout (its own random bits)
    dx = enc["dropout_operand"]
    record("dropout", "eltwise_kernels.cu", "eltwise_pallas.py:103",
           KE.dropout, (dx, 7, 0.1), TOL_EXACT, dx.numel() * (2 + 2 + 1), 0,
           geo.peak_bf16_tflops,
           ms(lambda t: torch.nn.functional.dropout(t, 0.1, True), dx))

    # the tile configurations of the flash kernel, at the bench shape and at
    # the encoder block's (bh=96, s=512, hd=64), with the yardstick beside
    bq, bkT, bv = enc["block_operands"]
    for name, (q_, kT_, v_) in (("bench", (fq, fkT, fv)),
                                ("block", (bq, bkT, bv))):
        bh_, s_, hd_ = q_.shape
        for causal in (False, True):
            for cfg_ in KA.flash_configs(hd_):
                fn_ = KA.build_flash_attention(bh_, s_, hd_, q_.dtype,
                                               causal=causal,
                                               block_override=cfg_)
                print(f"  flash {name} {tuple(q_.shape)} causal={causal} "
                      f"tile={cfg_}: {ms(fn_, 0, q_, kT_, v_):.4f} ms")
            print(f"  sdpa {name} causal={causal}: "
                  f"{ms(sdpa, *sdpa_operands(q_, kT_, v_), causal):.4f} ms")

    # the launch configurations tune=True chooses among, at the headline
    for cfg_ in K.batched_gemm_configs(m):
        print(f"  batched_gemm (rows, threads)={cfg_}: "
              f"{ms(K.build_batched_gemm(desc, B, cfg_), a_u, b_u):.4f} ms")
    for rpt in K.packed_smm_configs(m):
        print(f"  packed_batched_gemm rows/thread={rpt}: "
              f"{ms(K.build_packed_batched_gemm(desc, G, rpt=rpt), ap, bp):.4f}"
              " ms")

    for r in rows:
        print(f"{r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms "
              f"by {r['bound_by']}; plain {r['plain_ms']:.4f} ms; library "
              f"{r['library_ms']:.4f} ms); max_abs_err {r['max_abs_err']:.3e}"
              f"; {r['launches']} main-path launches")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
