#!/usr/bin/env python3
"""Drive libxsmm_torch's main paths on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout; it needs one CUDA device and the CUDA
toolkit's nvcc, and imports nothing of JAX or libxsmm_tpu. In order:

1. prints the card's name and power limit (nvidia-smi);
2. builds the hand-written kernels from libxsmm_torch/kernels/csrc/ with
   nvcc for sm_90a (one nvcc per source, all started together) and prints
   the build time, the spills per source and the registers and spills of
   each pipelined kernel (the bf16 flash forward and backward, the BCSC
   SpMM, the k-union SpMM, the packed BRGEMM's wgmma and tma_fma kernels
   and twins, the batched SMM's ring kernel);
3. drives the small-GEMM main path through the public entry points, with
   every kernel's launch count set to 0 just before and read just after:
   - the headline: dispatch_gemm_batched_packed(GemmShape(32,32,32),
     BETA_0) on 16384 f32 problems (4096 lane-packed groups), then
     unpack_batched; then smaller runs in bf16->f32, i8->i32, with RELU and
     GELU epilogues, with beta=1, and with a group count and row count that
     leave ragged tiles;
   - dispatch_gemm_batched on 16384 x 32^3 f32 (it must take the bulk-copy
     route), then 4096 x (33, 31, 17) f32 (the cp.async route) and 4096 x
     32^3 bf16 -> bf16 with beta=1 (bulk);
   - dispatch_brgemm_packed at br=1024, m=n=256, k=64 bf16->f32, then
     dispatch_brgemm_ext_packed with RELU + bias and with beta=1 GELU, all
     three on the wgmma route; the same shape in f32, plain and with RELU +
     bias, on the tma_fma route (the per-route counts must show both);
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
     hd=128, bf16, the tensor-core kernel, asserted): plain, causal,
     dropout, bias per head and broadcast, and the LSE output; f32 (the FMA
     kernel) at (4, 1024, 64) and hd=256 at (2, 256, 256);
   - dispatch_meltw_unary(DROPOUT, BITMASK_2BYTEMULT) at the FFN shape
     4096 x 3072 in bf16, f32 and f16;
   then fails unless both kernels were launched and no backward kernel
   was, and times every phase;
6. drives the block's training path the same way, with every count set to
   0 just before:
   - three train_steps at BERT-base width, bf16, flash, dropout_p=0.1,
     batch 8 x seq 512, seeds 7, 8, 9 (lr 0.1), each launching the flash
     forward, dropout and both flash-backward kernels: finite loss and
     update, the same seed giving the same update, and the served loss on
     the batch lower after the steps than before;
   - one unseeded loss_and_grads at the same width, and in f32 causal at
     batch 2, held against the gradients of a float64 torch composition of
     the same block;
   - build_flash_attention_bwd at bench.py's serving shape (plain, causal,
     dropout, bias per head with bias_grad, broadcast bias; bf16, the
     tensor-core kernels, asserted) and in f32 at (4, 1024, 64) and hd=256
     at (2, 256, 256) (the FMA kernels, asserted), each against its plain
     version;
   - TPP-MLP splitSGD steps at MlpConfig()'s widths: the loss falls;
   then fails unless all four kernels were launched, times every phase,
   splits one train step into forward, backward and update, and traces
   three steps with torch.profiler (device busy share, kernel time by
   name);
7. drives the block-sparse (BCSC) path the same way, with the five sparse
   kernels' counts set to 0 just before: create_packed_spgemm_bcsc with
   every strategy name and "auto" (which times every lowering on the card)
   at bench.py's cases, uncut: bcsc20 and bcsc05 (m = k = n = 1024, 32 x
   32 blocks at density 0.2 and 0.05, bf16 -> f32), bcsc_cluster (m = 1024,
   k = 2048, n = 1024, bf16 -> bf16, the two-family pattern); a streaming
   case (m = 32768 rows of A through the bcsc20 and bcsc05 patterns), an
   f32 case (m = 4096) and a ragged one (m = 1000); each result against
   the float64 dense product; the bf16 cases' "pallas", "super" and union
   strategies must take the tensor-core kernels and the f32 case the FMA
   kernels (the path predicate, asserted); union, union2 and union3 must
   launch the RHS compactor and the union4 names and union5 must not (the
   counter read around each call); prints the auto picks, the clustering
   decision and both union depths; fails unless all five kernels were
   launched, then times every phase;
8. drives the fused GEMM-ext path the same way, with every count set to 0
   just before: the stochastic-round kernel alone at the BERT-base FFN
   shape (4096 x 3072 f32) into bf16, f16, bf8 and hf8, bit for bit against
   its plain version and each output one of x's two neighbours;
   dispatch_brgemm_ext at the FFN1 product (m 4096, n 3072, k 768 as
   STRIDE br 12 x k 64) f32 -> bf16 with the SR store and a bias (within
   one bf16 ulp of float64), and bf16 -> f32 with RELU + bias + bitmask;
   meltw STOCHASTIC_ROUND and quant.stochastic_convert_fp32_bf16/_bf8 at
   the same shape; meltw QUANT/DEQUANT with MXFP4X2, NVFP4X2 and MXBF8
   (bytes equal to the same call on CPU copies); the 24 packed, 47 ext and
   4 ext_packed classes of samples/xgemm.py against float64; TPP-CNN's
   conv2d_kernel with fused bias + relu at samples/cnn.py's layer (32 x 56
   x 56 x 64 -> 64, 3x3, stride 1) in f32 and bf16 against float64, and
   three SGD steps of the model at those widths (1000 classes); fails
   unless the SR kernel was launched, then times every phase, the tap
   stack's share of a conv, cuDNN's conv (a yardstick), a forward and a
   step;
9. drives the rest of the sparse layer the same way, with every count set
   to 0 just before (these entry points are torch ops, as the reference
   leaves them to XLA; the counts are printed): fsspmdm at bench.py's cases
   (125 x 75 at 30%, N = 4800; m = 32, k = 8192 at 1%, N = 4096 under hints
   dense, sparse and auto) and samples/pyfr.py's synthetic hex operators
   p = 1..4 at N = 4800, each against float64 within 1e-5, its kind,
   tuned_us and Gnnz/s printed, then the autotune twice through a
   temporary KV log (the second create must read the first's history); the
   CSR/CSC routings and create_spgemm_csr_areg at m = k = n = 1024 with 5%
   of the elements (csr sparse/dense/auto at packed width 1 and 8, csc,
   csr_bsparse, the csc_csparse SDDMM at k = 256, areg at its 65,536-nnz
   cap), f32 and bf16 -> f32, against float64; the packed SOA GEMM and its
   AC_RM/BC_RM variants at 32^3 x 16; the BCSC autotune's persisted pick;
   TPP-GCN at the published GCN widths (Kipf & Welling 2017, Cora: 2708
   nodes, 1433 features, hidden 16, 7 classes) on a seeded random graph
   with Cora's 5278 edges, the forward against float64 and three train
   steps lowering the loss; times every phase, a forward and a step;
10. runs the labs the same way, with the five twin and probe kernels'
    counts set to 0 just before: libxsmm_torch.scripts.brgemm_lab (the
    packed BRGEMM's four variants at br = 1024, 256 x 256 x 64 bf16, each
    against its streaming twin, t_sol / t_brg printed), the packed SMM's
    passthrough twin at the headline's (4096, 32, 128) f32 (bit for bit
    against a + b; t_passthrough / t_packed_smm, bench.py:869's fraction)
    and libxsmm_torch.scripts.bcsc_lab at densities 0.2 and 0.05 (the
    union kernel's probes beside the library's strategies, held against
    float64 and their plain versions, the lab's table printed); fails
    unless all five kernels were launched;
11. holds each kernel against its plain version once more at its main-path
    shape, and times kernel, plain version and one library call computing
    the same function (a yardstick the port never calls; none exists for
    stochastic rounding, the union RHS compactor and the BRGEMM's twin,
    whose rows carry the RNE cast's, an output clone's and the BRGEMM's
    time instead; the flash backward's, reached through autograd, by its
    device time from torch.profiler), and each launch configuration the
    kernel chooses among; the f32 packed BRGEMM gets a row of its own,
    with torch.mm in f32 (TF32 off) as its yardstick and its twin's
    t_sol / t_brg, by events, device time and CUDA-graph replay; the
    batched SMM's odd shape and bf16 case are held against their plain
    versions and timed beside torch.bmm; for the six tensor-core rows
    (flash forward, the
    flash backward's dK/dV and dQ, the scheduled, union and supertile
    SpMM) it asserts the path and prints the achieved TFLOP/s (of the
    kernel's own products and of the useful ones) and the kernel / library
    ratio;
12. prints one JSON line with the per-kernel numbers (nineteen rows) and,
    last, the result line {"ok": true, "device": {...}}.

Any failure raises and exits non-zero; nothing is caught. Without a CUDA
device it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import functools
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
TOL_BWD_F32 = 1e-4     # f32 flash backward against its plain version:
                       # dS = p * (dP - delta) cancels, so the order of the
                       # products' sums shows more than in the forward
TOL_GRAD_BF16 = 5e-2   # bf16 block gradients against float64: activations
                       # and dS rounded to bf16 on the way back too
TOL_GRAD_F32 = 1e-4    # f32 block gradients against float64

TOL_SPARSE_F32 = 1e-5  # f32 BCSC SpMM against the float64 dense product
TOL_SPARSE_BF16 = 1e-4  # bf16 in, f32 out: products exact, order differs

TOL_FSSPMDM = 1e-5     # f32 fsspmdm against float64: samples/pyfr.py's margin
TOL_GCN = 1e-5         # the f32 GCN forward against its float64 oracle

TOL_SR_BF16 = 2.0 ** -7  # the SR store against float64: within one bf16 ulp
TOL_CONV_F32 = 1e-5    # f32 conv against float64 (samples/cnn.py:52)
TOL_CONV_BF16 = 5e-3   # bf16 conv: exact products, the output rounded once
EXT_KERNELS = ("stochastic_round",)
# stochastic-rounding targets: (Datatype name, mantissa bits, least normal
# exponent)
SR_TARGETS = (("BF16", 7, -126), ("F16", 10, -14), ("BF8", 2, -14),
              ("HF8", 3, -6))
CNN_LR = 0.1           # the loss visibly lower after three SGD steps
# the GEMM-ext path's shapes: the BERT-base FFN (8 x 512 tokens, FFN 3072;
# Devlin et al. 2018) as m x n, FFN1's k 768 as br 12 x k 64; samples/
# cnn.py's default layer (N, H, W, C, K, R)
EXT_SHAPES = {"ffn": (8 * 512, 3072), "br_k": (12, 64),
              "cnn": (32, 56, 56, 64, 64, 3)}

MAIN_KERNELS = ("batched_gemm", "packed_batched_gemm", "packed_brgemm")
SERVE_KERNELS = ("flash_attention_fwd", "dropout")
BWD_KERNELS = ("flash_attention_bwd_dkv", "flash_attention_bwd_dq")
TRAIN_KERNELS = SERVE_KERNELS + BWD_KERNELS
TRAIN_LR = 0.1         # visible in bf16 weights after three steps
LAB_KERNELS = ("packed_brgemm_sol", "packed_smm_passthrough",
               "bcsc_lab_minimal", "bcsc_lab_chunk", "bcsc_lab_dspipe")
SPARSE_KERNELS = ("bcsc_spmm", "bcsc_spmm_union", "bcsc_densify",
                  "bcsc_spmm_super", "bcsc_union_compact")
# the kernels each BCSC strategy launches ("sparse" is torch ops alone);
# union, union2 and union3 compact the RHS first, the other union names
# assemble it in the union kernel
SPARSE_KERNEL_OF = {"pallas": ("bcsc_spmm",), "super": ("bcsc_spmm_super",),
                    "dense": ("bcsc_densify",), "sparse": ()}
COMPACTED = ("union", "union2", "union3")
# the pipelined Hopper kernels (tensor-core, TMA- and bulk-copy-fed):
# (source stem, kernel name in the ptxas report)
MMA_KERNELS = (("gemm_kernels", "brgemm_partial_wgmma_kernel"),
               ("gemm_kernels", "brgemm_partial_tma_fma_kernel"),
               ("gemm_kernels", "batched_gemm_ring_kernel"),
               ("spmm_kernels", "bcsc_spmm_mma_kernel"),
               ("spmm_kernels", "bcsc_union_mma_kernel"),
               ("attention_kernels", "flash_fwd_mma_kernel"),
               ("attention_bwd_kernels", "flash_bwd_dkv_mma_kernel"),
               ("attention_bwd_kernels", "flash_bwd_dq_mma_kernel"))


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
    for mod in _kernel_modules():
        if name in mod.launches:
            return mod.launches[name]
    raise KeyError(name)


def _counted(phases, name, kernels, fn, *fargs):
    """Run one phase of a counted path: fn(*fargs), then fail unless each
    of `kernels` was launched in it; the phase is kept for timing."""
    before = {k: _count(k) for k in kernels}
    out = fn(*fargs)
    torch.cuda.synchronize()
    for k in kernels:
        if _count(k) <= before[k]:
            raise AssertionError(f"{name}: {k} was not launched")
    phases.append((name, fn, fargs))
    return out


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
    run = functools.partial(_counted, phases)

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
    # bf16 takes the tensor-core kernel, f32 the FMA kernel
    for dt, want in ((bf16, "mma"), (f32, "fma")):
        if KA.flash_path(dt) != want:
            raise AssertionError(f"flash {dt}: path {KA.flash_path(dt)}, "
                                 f"expected {want}")
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
    missing = [k for k in SERVE_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the encoder path: "
                             f"{missing}")
    trained = [k for k in counts if k not in SERVE_KERNELS and counts[k]]
    if trained:
        raise AssertionError(f"the serving path launched {trained}")
    counts = {k: counts[k] for k in SERVE_KERNELS}
    # the block's attention shape: 8 x 12 heads, s=512, hd=64
    block_ops = (randn(96, 512, 64, dtype=bf16), randn(96, 64, 512, dtype=bf16),
                 randn(96, 512, 64, dtype=bf16))
    return {"phases": phases, "counts": counts,
            "flash_operands": (q, kT, v), "block_operands": block_ops,
            "dropout_operand": randn(m, n, dtype=bf16),
            "block": (block, x)}


def training_path(randn, dev):
    """The TPP-Attention block's training path, driven through the public
    entry points with every launch count set to 0 just before and read just
    after: three seeded BERT-base train steps, block gradients against
    float64, the backward kernels alone at bench.py's serving shape, and
    TPP-MLP splitSGD steps. Returns the phases (to time), the counts, and
    the operands the per-kernel rows reuse."""
    import dataclasses

    from libxsmm_torch.kernels import attention as KA
    from libxsmm_torch.kernels import eltwise as KE
    from libxsmm_torch.models import tpp_attention as TA
    from libxsmm_torch.models import tpp_mlp as TM

    bf16, f32 = torch.bfloat16, torch.float32
    phases = []
    run = functools.partial(_counted, phases)

    def finite(name, tensors):
        for k, v in tensors.items():
            if not bool(torch.isfinite(v.float()).all()):
                raise AssertionError(f"{name}: non-finite {k}")

    def grads64(params, x, y, cfg):
        """The gradients of the same block as a float64 torch composition
        (flash=False)."""
        cfg64 = dataclasses.replace(cfg, dtype="float64", flash=False)
        p64 = {k: v.double() for k, v in params.items()}
        return TA.loss_and_grads(p64, x.double(), y.double(), cfg64)

    def hold(name, want, got, tol):
        worst = max(_check(f"{name} {k}", want[k], got[k], tol,
                           tuple(want[k].shape)) for k in want)
        print(f"  {name}: worst gradient normf_rel vs float64 {worst:.3e}")

    KA.reset_launches()
    KE.reset_launches()
    t_path = time.perf_counter()
    # BERT-base widths (Devlin et al. 2018, BERT_BASE), bf16, flash, dropout
    # 0.1 on the probabilities and the FFN; batch 8 x seq 512
    cfg = TA.AttentionConfig(dim=768, heads=12, ffn_mult=4, dtype="bfloat16",
                             flash=True, dropout_p=0.1)
    params = TA.init_params(cfg, seed=0, device=dev)
    x, y = randn(8, 512, 768, dtype=bf16), randn(8, 512, 768, dtype=bf16)
    with torch.inference_mode():
        served0 = TA.loss_fn(params, x, y, cfg).item()
    p = params
    for sd in (7, 8, 9):
        new, loss = run(f"train step bert-base bf16 8x512 seed {sd}",
                        TRAIN_KERNELS, TA.train_step, p, x, y, cfg, TRAIN_LR,
                        sd)
        finite(f"train step seed {sd}", {"loss": loss, **new})
        if sd == 7:
            again, loss_again = TA.train_step(p, x, y, cfg, TRAIN_LR, 7)
            if not (torch.equal(loss, loss_again) and all(
                    torch.equal(new[k], again[k]) for k in new)):
                raise AssertionError("train step: the same seed gave "
                                     "another update")
        print(f"  train step seed {sd}: loss {loss.item():.6f}")
        p = new
    with torch.inference_mode():
        served1 = TA.loss_fn(p, x, y, cfg).item()
    print(f"  served loss before the steps {served0:.6f}, after "
          f"{served1:.6f}")
    if not served1 < served0:
        raise AssertionError("training did not lower the served loss")

    # one unseeded gradient of the same block against float64, bf16 at batch
    # 8 and f32 causal at batch 2
    _, g = run("loss_and_grads bert-base bf16 8x512",
               ("flash_attention_fwd",) + BWD_KERNELS, TA.loss_and_grads,
               params, x, y, cfg)
    finite("bf16 gradients", g)
    hold("block bf16 gradients", grads64(params, x, y, cfg)[1], g,
         TOL_GRAD_BF16)
    cfg32 = dataclasses.replace(cfg, dtype="float32", causal=True)
    params32 = TA.init_params(cfg32, seed=1, device=dev)
    x32, y32 = randn(2, 512, 768), randn(2, 512, 768)
    _, g32 = run("loss_and_grads bert-base f32 causal 2x512",
                 ("flash_attention_fwd",) + BWD_KERNELS, TA.loss_and_grads,
                 params32, x32, y32, cfg32)
    hold("block f32 causal gradients", grads64(params32, x32, y32, cfg32)[1],
         g32, TOL_GRAD_F32)

    # the backward kernels alone at bench.py's serving shape (bench.py:568),
    # then f32 at (4, 1024, 64) and hd=256; lse from the LSE forward, delta
    # = rowsum(dout * out) as the autograd node computes it
    def bwd_operands(bh, s, hd, dt, kw, bias):
        q, v = randn(bh, s, hd, dtype=dt), randn(bh, s, hd, dtype=dt)
        kT, dout = randn(bh, hd, s, dtype=dt), randn(bh, s, hd, dtype=dt)
        fwd = KA.build_flash_attention(bh, s, hd, dt, return_lse=True,
                                       **{k: v_ for k, v_ in kw.items()
                                          if k != "bias_grad"})
        out, lse = fwd(5, q, kT, v, bias)
        delta = (dout.float() * out.float()).sum(-1, keepdim=True).expand(
            bh, s, 128)
        return (5, q, kT, v, dout, lse, delta, bias)

    bh, s, hd = 16, 2048, 128
    cases = [("plain", {}, None), ("causal", {"causal": True}, None),
             ("dropout", {"dropout_p": 0.1}, None),
             ("bias per head + grad", {"bias_bh": bh, "bias_grad": True},
              randn(bh, s, s, scale=0.5)),
             ("bias broadcast", {"bias_bh": 1}, randn(1, s, s, scale=0.5))]
    bench_ops = None
    for name, kw, bias in cases:
        args = bwd_operands(bh, s, hd, bf16, kw, bias)
        fn = KA.build_flash_attention_bwd(bh, s, hd, bf16, **kw)
        if fn.path != "mma":
            raise AssertionError(f"flash bwd {name} bf16 took {fn.path}")
        got = run(f"flash bwd {name} bf16 {bh}x{s}x{hd}", BWD_KERNELS,
                  fn, *args)
        _check(f"flash bwd {name} vs plain", fn.plain(*args), got,
               TOL_BF16_OUT)
        bench_ops = bench_ops or args
    for fbh, fs, fhd in ((4, 1024, 64), (2, 256, 256)):
        for causal in (False, True):
            kw = {"causal": causal, "dropout_p": 0.1}
            args = bwd_operands(fbh, fs, fhd, f32, kw, None)
            fn = KA.build_flash_attention_bwd(fbh, fs, fhd, f32, **kw)
            if fn.path != "fma":
                raise AssertionError(f"flash bwd f32 took {fn.path}")
            got = run(f"flash bwd f32 {fbh}x{fs}x{fhd} causal={causal}",
                      BWD_KERNELS, fn, *args)
            _check(f"flash bwd f32 {fbh}x{fs}x{fhd} vs plain",
                   fn.plain(*args), got, TOL_BWD_F32)

    # TPP-MLP at MlpConfig()'s widths (256 -> 512 -> 512 -> 128): splitSGD
    # steps, bf16 forward and backward on the hi halves; no kernel of its own
    mcfg = TM.MlpConfig()
    sp = TM.split_params(TM.init_params(mcfg, seed=0, device=dev))
    mx, my = randn(512, 256), randn(512, 128, scale=0.1)
    losses = []
    for _ in range(10):
        sp, mloss = TM.split_sgd_train_step(sp, mx, my, mcfg, lr=5e-2)
        losses.append(mloss.item())
    print(f"  tpp_mlp splitSGD: loss {losses[0]:.6f} -> {losses[-1]:.6f} "
          f"in 10 steps")
    if not losses[-1] < losses[0]:
        raise AssertionError("tpp_mlp splitSGD did not lower the loss")

    torch.cuda.synchronize()
    counts = {**KA.launches, **KE.launches}
    print(f"training path: {len(phases)} phases in "
          f"{time.perf_counter() - t_path:.2f} s, kernel launches {counts}")
    missing = [k for k in TRAIN_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the training path: "
                             f"{missing}")
    return {"phases": phases, "counts": counts, "bwd_operands": bench_ops,
            "step": (params, x, y, cfg)}


def _bcsc_pattern(rng, k, n, bk, bn, density):
    """bench.py's BCSC pattern (make_bcsc_cases, bench.py:694-697): a
    standard-normal (k, n) whose (bk, bn) blocks are kept at `density`."""
    import numpy as np

    from libxsmm_torch.ops.sparse import BcscMatrix
    bmat = rng.standard_normal((k, n)).astype(np.float32)
    keep = rng.random((k // bk, n // bn)) < density
    bmat *= np.kron(keep, np.ones((bk, bn), np.float32))
    return BcscMatrix.from_dense(bmat, bk, bn)


def _cluster_pattern(rng, k, n, bk, bn):
    """bench.py's two-family pattern (make_bcsc_cluster_cases,
    bench.py:756-767): even block columns draw from block rows [0, kb/2-2),
    odd ones from [kb/2, kb-2), 64% of the family each."""
    import numpy as np
    kb, nb = k // bk, n // bn
    fam_a, fam_b = np.arange(0, kb // 2 - 2), np.arange(kb // 2, kb - 2)
    cols = []
    for j in range(nb):
        fam = fam_a if j % 2 == 0 else fam_b
        take = min(int(0.64 * len(fam)) + (j % 2), len(fam))
        cols.append(np.sort(rng.choice(fam, take, replace=False)))
    indptr = np.concatenate(
        [[0], np.cumsum([len(c) for c in cols])]).astype(np.int32)
    return indptr, np.concatenate(cols).astype(np.int32)


def sparse_path(randn, dev):
    """The block-sparse (BCSC) path, driven through
    create_packed_spgemm_bcsc with the four sparse kernels' launch counts
    set to 0 just before and read just after: every strategy name and
    "auto" at bench.py's bcsc20, bcsc05 and bcsc_cluster cases, a streaming
    case and an f32 case, each against the float64 dense product. Returns
    the phases (to time), the counts, and the streaming operands the
    per-kernel rows reuse."""
    import numpy as np

    import libxsmm_torch as xt
    from libxsmm_torch.descriptor import GemmFlags, GemmShape, SpgemmConfig
    from libxsmm_torch.dtypes import Datatype
    from libxsmm_torch.kernels import spmm as KS
    from libxsmm_torch.ops.sparse import STRATEGIES

    bf16, f32 = torch.bfloat16, torch.float32
    BF16, F32 = Datatype.BF16, Datatype.F32
    phases = []
    run = functools.partial(_counted, phases)

    def on_dev(x, dt):
        return torch.as_tensor(x, device=dev).to(dt)

    def drive(case, shape, cfg, indptr, indices, a, v, tol):
        """Every strategy name and auto on one case, each against the
        float64 product with the densified B (plain version: no launch)."""
        dense_b = KS.build_bcsc_densify(shape, cfg, indptr, indices,
                                        dev).plain(v)
        want = a.double() @ dense_b.double()
        # bf16 operands take the tensor-core kernels at the case's blocking
        # ("pallas" and the union strategies) and at the supertiles
        # ("super"); f32 the FMA kernels
        path = "mma" if a.dtype == bf16 else "fma"
        for bk_, bn_ in ((cfg.bk, cfg.bn), (KS.SUPER, KS.SUPER)):
            if KS.spmm_path(a.dtype, bk_, bn_) != path:
                raise AssertionError(f"bcsc {case}: {bk_}x{bn_} blocks take "
                                     f"{KS.spmm_path(a.dtype, bk_, bn_)}, "
                                     f"expected {path}")
        union_path = KS.build_bcsc_spmm_union(shape, cfg, indptr, indices,
                                              dev).path
        if union_path != path:
            raise AssertionError(f"bcsc {case}: the union takes "
                                 f"{union_path}, expected {path}")
        worst, pick = 0.0, None
        for s in STRATEGIES + ("auto",):
            kern = xt.create_packed_spgemm_bcsc(
                shape, GemmFlags.BETA_0, cfg, indptr, indices, strategy=s)
            tail = kern.name.split("_")[3]
            got = "super" if tail.startswith("super") else tail
            kernels = SPARSE_KERNEL_OF.get(got, ("bcsc_spmm_union",))
            if got in COMPACTED:
                kernels += ("bcsc_union_compact",)
            compactions = _count("bcsc_union_compact")
            out = run(f"bcsc {case} {s}", kernels, kern, a, v)
            if (got not in COMPACTED
                    and _count("bcsc_union_compact") != compactions):
                raise AssertionError(f"bcsc {case} {s}: the compactor ran "
                                     f"for {got}")
            worst = max(worst, _check(f"bcsc {case} {s} vs float64", want,
                                      out, tol, (shape.m, shape.n)))
            if s == "auto":
                pick = kern.name
        print(f"  bcsc {case} ({shape.m}x{shape.n}x{shape.k}, "
              f"{len(indices)} blocks of {cfg.bk}x{cfg.bn}): "
              f"{len(STRATEGIES) + 1} strategies, worst normf_rel vs "
              f"float64 {worst:.3e}; pallas/super path {path}; auto -> "
              f"{pick}")

    KS.reset_launches()
    t_path = time.perf_counter()
    # bench.py's bcsc20 and bcsc05 (bench.py:691-707), uncut: m = k = n =
    # 1024, 32 x 32 blocks, bf16 in, f32 out, pattern from default_rng(2)
    bk = bn = 32
    cfg = SpgemmConfig(1, bk, bn)
    m = k = n = 1024
    pats = {}
    for case, density in (("bcsc20", 0.2), ("bcsc05", 0.05)):
        rng = np.random.default_rng(2)
        bcsc = _bcsc_pattern(rng, k, n, bk, bn, density)
        v = on_dev(bcsc.data, bf16)
        a0 = on_dev(rng.standard_normal((m, k)), bf16)
        drive(case, GemmShape(m, n, k, BF16, BF16, F32), cfg, bcsc.indptr,
              bcsc.indices, a0, v, TOL_SPARSE_BF16)
        pats[density] = (bcsc, v)

    # bench.py's bcsc_cluster (bench.py:748-770): k = 2048, bf16 out
    rng = np.random.default_rng(7)
    ck = 2048
    indptr, indices = _cluster_pattern(rng, ck, n, bk, bn)
    cshape = GemmShape(m, n, ck, BF16, BF16, BF16)
    cv = on_dev(rng.standard_normal((len(indices), bk, bn)), bf16)
    ca = on_dev(rng.standard_normal((m, ck)), bf16)
    plans = {cl: KS.build_bcsc_spmm_union(cshape, cfg, indptr, indices, dev,
                                          cluster=cl) for cl in (True, False)}
    print(f"  bcsc_cluster: clustered {plans[True].clustered}; union depth "
          f"{plans[True].union_panels} panels with clustering, "
          f"{plans[False].union_panels} without")
    drive("bcsc_cluster", cshape, cfg, indptr, indices, ca, cv, TOL_BF16_OUT)

    # streaming: 32768 rows of A (64 MiB bf16; C 128 MiB f32) through the
    # bcsc20 and bcsc05 patterns
    ms_rows = 32768
    a_stream = randn(ms_rows, k, dtype=bf16)
    sshape = GemmShape(ms_rows, n, k, BF16, BF16, F32)
    for density in (0.2, 0.05):
        bcsc, v = pats[density]
        drive(f"stream{round(density * 100):02d}", sshape, cfg, bcsc.indptr,
              bcsc.indices, a_stream, v, TOL_SPARSE_BF16)

    # f32 in and out at m = 4096 on the bcsc20 pattern
    bcsc, _ = pats[0.2]
    drive("f32", GemmShape(4096, n, k), cfg, bcsc.indptr, bcsc.indices,
          randn(4096, k), on_dev(bcsc.data, f32), TOL_SPARSE_F32)

    # ragged: 1000 rows (the last 64-row tile cut) through bcsc05
    bcsc, v = pats[0.05]
    drive("ragged", GemmShape(1000, n, k, BF16, BF16, F32), cfg, bcsc.indptr,
          bcsc.indices, randn(1000, k, dtype=bf16), v, TOL_SPARSE_BF16)

    torch.cuda.synchronize()
    counts = dict(KS.launches)
    print(f"sparse path: {len(phases)} phases in "
          f"{time.perf_counter() - t_path:.2f} s, kernel launches {counts}")
    missing = [k_ for k_ in SPARSE_KERNELS if counts[k_] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the sparse path: "
                             f"{missing}")
    bcsc, v = pats[0.2]
    return {"phases": phases, "counts": counts,
            "stream": (sshape, cfg, bcsc, a_stream, v)}


def _kernel_modules():
    from libxsmm_torch.kernels import attention, eltwise, gemm, spmm, spmm_lab
    return gemm, attention, eltwise, spmm, spmm_lab


def _reset_all_launches():
    for mod in _kernel_modules():
        mod.reset_launches()


def _all_launches():
    return {k: v for mod in _kernel_modules() for k, v in mod.launches.items()}


def _sparse_rows(rng, m, k, density):
    """A (m, k) f32 matrix with each element kept at `density`; every row
    keeps at least one element."""
    import numpy as np
    a = rng.standard_normal((m, k)).astype(np.float32)
    a[rng.random((m, k)) > density] = 0.0
    for i in range(m):
        if not np.abs(a[i]).max():
            a[i, rng.integers(k)] = 1.0
    return a


def _fsspmdm(rng, dev, ms):
    """fsspmdm at bench.py's cases (bench.py:614-676) and samples/pyfr.py's
    synthetic hex operators, each against float64; then the autotune twice
    through a temporary KV log. Returns the handles' lines."""
    import os
    import tempfile

    import numpy as np

    import libxsmm_torch as xt
    from libxsmm_torch.config import CONFIG
    from libxsmm_torch.utils.testmats import (hex_derivative_operator,
                                              hex_interp_operator)

    def drive(name, a, n, hint=None):
        prior = os.environ.pop("XSMM_TPU_FSSPMDM_HINT", None)
        if hint is not None:
            os.environ["XSMM_TPU_FSSPMDM_HINT"] = hint
        try:
            h = xt.fsspmdm_create(n, a)
        finally:
            os.environ.pop("XSMM_TPU_FSSPMDM_HINT", None)
            if prior is not None:
                os.environ["XSMM_TPU_FSSPMDM_HINT"] = prior
        b = torch.as_tensor(rng.standard_normal((a.shape[1], n)),
                            dtype=torch.float32, device=dev)
        want = torch.as_tensor(a, dtype=torch.float64, device=dev) @ b.double()
        err = _check(f"fsspmdm {name} vs float64", want, h.execute(b),
                     TOL_FSSPMDM, (a.shape[0], n))
        t = ms(h.kernel.fn, b)
        tuned = {k_: (round(v_, 2) if isinstance(v_, float) else v_)
                 for k_, v_ in h.tuned_us.items()}
        print(f"  fsspmdm {name} {a.shape[0]}x{a.shape[1]} N={n} "
              f"nnz={h.nnz}: {h.kind}, {t:.4f} ms, "
              f"{h.nnz * n / (t * 1e-3) / 1e9:.1f} Gnnz/s, normf_rel "
              f"{err:.2e}; tuned_us {tuned}")
        return h

    # bench.py's PyFR-class case: 125 x 75 at 30%, N = 4800
    a = rng.standard_normal((125, 75)).astype(np.float32)
    a[rng.random((125, 75)) > 0.3] = 0.0
    drive("pyfr 30%", a, 4800)
    # the tall-sparse regime: m = 32, k = 8192, 1%, N = 4096
    at = _sparse_rows(rng, 32, 8192, 0.01)
    for hint, label in (("2", "dense"), ("1", "sparse"), (None, "auto")):
        drive(f"tall {label}", at, 4096, hint)
    # samples/pyfr.py's synthetic hex operators, p = 1..4, N = 4800
    for p in (1, 2, 3, 4):
        drive(f"p{p} hex deriv", hex_derivative_operator(p).astype(
            np.float32), 4800)
        drive(f"p{p} hex interp", hex_interp_operator(p).astype(np.float32),
              4800)
    # the autotune twice through one KV log: the second create reads the
    # first's ratio history
    prior = CONFIG.autotune_cache_path
    with tempfile.TemporaryDirectory() as tmp:
        CONFIG.autotune_cache_path = os.path.join(tmp, "autotune.xkv")
        try:
            h1 = drive("pyfr 30% tune 1", a, 4800)
            h2 = drive("pyfr 30% tune 2", a, 4800)
        finally:
            CONFIG.autotune_cache_path = prior
    if "cached" in h1.tuned_us or not h2.tuned_us.get("cached"):
        raise AssertionError("fsspmdm: the second create did not read the "
                             "first's history")
    if len(h2.tuned_us["ratio_history"]) != 2:
        raise AssertionError(f"fsspmdm: history {h2.tuned_us}")


def sparse_layer_path(randn, dev, ms):
    """The rest of the sparse layer, through its public entry points at the
    repo's own sizes, with every kernel's launch count set to 0 just before
    and read just after (these entry points are torch ops in the port, as
    the reference leaves them to XLA): fsspmdm (_fsspmdm), the CSR/CSC
    routings and create_spgemm_csr_areg at bench.py's bcsc05 scale but
    element-sparse, the packed SOA GEMM, the BCSC autotune's persisted
    pick, and TPP-GCN at the published GCN widths. Each result is held
    against float64. Returns the phases (to time) and the counts."""
    import os
    import tempfile

    import numpy as np

    import libxsmm_torch as xt
    from libxsmm_torch.config import CONFIG
    from libxsmm_torch.descriptor import GemmFlags, GemmShape, SpgemmConfig
    from libxsmm_torch.dtypes import Datatype
    from libxsmm_torch.models import tpp_gcn as TG
    from libxsmm_torch.ops.fsspmdm import _autotune_cache

    B0 = GemmFlags.BETA_0
    F32, BF16 = Datatype.F32, Datatype.BF16
    phases = []
    run = functools.partial(_counted, phases)
    rng = np.random.default_rng(11)
    _reset_all_launches()
    t_path = time.perf_counter()

    _fsspmdm(rng, dev, ms)

    # the CSR/CSC routings: m = k = n = 1024 at 5% element density
    m = k = n = 1024
    for dt, tol in ((F32, TOL_SPARSE_F32), (BF16, TOL_SPARSE_BF16)):
        tdt = xt.to_torch(dt)
        shape = GemmShape(m, n, k, dt, dt, F32)

        def operand(x):
            t_ = torch.as_tensor(x, device=dev).to(tdt)
            return t_, t_.double()

        apat = _sparse_rows(rng, m, k, 0.05)
        csr = xt.CsrMatrix.from_dense(apat)
        vals, vals64 = operand(csr.data)
        a64 = torch.zeros(m * k, dtype=torch.float64, device=dev)
        rows = np.repeat(np.arange(m), np.diff(csr.indptr))
        a64[torch.as_tensor(rows * k + csr.indices, device=dev)] = vals64
        a64 = a64.reshape(m, k)
        for p in (1, 8):
            b, b64 = operand(rng.standard_normal((k, n, p) if p > 1
                                                 else (k, n)))
            want = (a64 @ b64 if p == 1
                    else torch.einsum("mk,knp->mnp", a64, b64))
            for s in ("sparse", "dense", "auto"):
                kern = xt.create_packed_spgemm_csr(shape, B0, p, csr.indptr,
                                                   csr.indices, s)
                out = run(f"csr {dt.value} p{p} {s}", [], kern, vals, b)
                _check(f"csr {dt.value} p{p} {s} vs float64", want, out, tol,
                       tuple(want.shape))
        dense_a, dense_a64 = operand(rng.standard_normal((m, k)))
        bpat = _sparse_rows(rng, k, n, 0.05)
        csc = xt.CscMatrix.from_dense(bpat)
        bcsr = xt.CsrMatrix.from_dense(bpat)
        b64 = torch.as_tensor(bpat, device=dev).to(tdt).double()
        want = dense_a64 @ b64
        kern = xt.create_packed_spgemm_csc(shape, B0, 1, csc.indptr,
                                           csc.indices)
        _check(f"csc {dt.value} vs float64", want,
               run(f"csc {dt.value}", [], kern, dense_a,
                   operand(csc.data)[0]), tol, (m, n))
        for s in ("sparse", "dense"):
            kern = xt.create_packed_spgemm_csr_bsparse(
                shape, B0, 1, bcsr.indptr, bcsr.indices, s)
            _check(f"csr_bsparse {dt.value} {s} vs float64", want,
                   run(f"csr_bsparse {dt.value} {s}", [], kern, dense_a,
                       operand(bcsr.data)[0]), tol, (m, n))
        # the SDDMM: C 5% dense, k = 256
        kc = 256
        cpat = xt.CscMatrix.from_dense(_sparse_rows(rng, m, n, 0.05))
        ac, ac64 = operand(rng.standard_normal((m, kc)))
        bc, bc64 = operand(rng.standard_normal((kc, n)))
        ccols = np.repeat(np.arange(n), np.diff(cpat.indptr))
        want_c = (ac64 @ bc64)[torch.as_tensor(cpat.indices.astype(np.int64),
                                               device=dev),
                               torch.as_tensor(ccols, device=dev)]
        for s in ("gather", "dense"):
            kern = xt.create_packed_spgemm_csc_csparse(
                GemmShape(m, n, kc, dt, dt, F32), B0, 1, cpat.indptr,
                cpat.indices, s)
            _check(f"csc_csparse {dt.value} {s} vs float64", want_c,
                   run(f"csc_csparse {dt.value} {s}", [], kern, ac, bc), tol,
                   (cpat.nnz,))
    # create_spgemm_csr_areg at its cap: 64 of 1024 columns in each row
    areg = np.zeros((m, k), np.float32)
    for i in range(m):
        areg[i, rng.choice(k, 64, replace=False)] = rng.standard_normal(64)
    csr = xt.CsrMatrix.from_dense(areg)
    kern = xt.create_spgemm_csr_areg(GemmShape(m, n, k), B0, csr.indptr,
                                     csr.indices, csr.data)
    b = randn(k, n)
    _check("csr_areg 65536 nnz vs float64",
           torch.as_tensor(areg, dtype=torch.float64, device=dev) @ b.double(),
           run(f"csr_areg nnz {csr.nnz}", [], kern, b), TOL_SPARSE_F32,
           (m, n))
    print(f"  csr/csc routings (1024^3, 5% elements) and csr_areg "
          f"({csr.nnz} nnz): each against float64")

    # the packed SOA GEMM at 32^3, packed width 16
    pm = pw = 32
    p = 16
    ap, bp, cp = randn(pm, pm, p), randn(pm, pm, p), randn(pm, pm, p)
    a2, b2 = randn(pm, pm), randn(pm, pm)
    shp = GemmShape(pm, pm, pm)
    for name, kern, fargs, want in (
            ("packed", xt.create_packed_gemm(shp, B0, p), (ap, bp),
             torch.einsum("mkp,knp->mnp", ap.double(), bp.double())),
            ("packed beta=1", xt.create_packed_gemm(shp, GemmFlags.NONE, p),
             (ap, bp, cp), torch.einsum("mkp,knp->mnp", ap.double(),
                                        bp.double()) + cp.double()),
            ("packed ac_rm", xt.create_packed_gemm_ac_rm(shp, B0, p),
             (ap, b2), torch.einsum("mkp,kn->mnp", ap.double(), b2.double())),
            ("packed bc_rm", xt.create_packed_gemm_bc_rm(shp, B0, p),
             (a2, bp), torch.einsum("mk,knp->mnp", a2.double(),
                                    bp.double()))):
        _check(f"{name} vs float64", want, run(name, [], kern, *fargs),
               TOL_F32, (pm, pw, p))

    # the BCSC autotune's pick, persisted: bench.py's bcsc20 at m = 1024
    bcsc = _bcsc_pattern(np.random.default_rng(2), k, n, 32, 32, 0.2)
    bshape = GemmShape(m, n, k, BF16, BF16, F32)
    prior = CONFIG.autotune_cache_path
    with tempfile.TemporaryDirectory() as tmp:
        CONFIG.autotune_cache_path = os.path.join(tmp, "autotune.xkv")
        try:
            picks = [xt.create_packed_spgemm_bcsc(
                bshape, B0, SpgemmConfig(1, 32, 32), bcsc.indptr,
                bcsc.indices, strategy="auto").name for _ in range(2)]
            key = (f"bcsc2:{m}:{n}:{k}:32:32:bf16:"
                   f"{bcsc.fingerprint():x}").encode()
            stored = _autotune_cache().get(key)
        finally:
            CONFIG.autotune_cache_path = prior
    if not stored:
        raise AssertionError("bcsc auto: no pick persisted")
    print(f"  bcsc20 auto with a KV log: persisted {stored.decode()!r}; "
          f"creates -> {picks}")

    # TPP-GCN at the published GCN widths (Kipf & Welling 2017, Cora: 2708
    # nodes, 1433 features, hidden 16, 7 classes, two layers) on a seeded
    # random symmetric graph with Cora's 5278 undirected edges; synthetic
    # features and labels
    nodes, edges = 2708, 5278
    pairs = set()
    while len(pairs) < edges:
        i, j = (int(x) for x in rng.integers(0, nodes, 2))
        if i != j:
            pairs.add((min(i, j), max(i, j)))
    adj = np.zeros((nodes, nodes), np.float32)
    ij = np.asarray(sorted(pairs))
    adj[ij[:, 0], ij[:, 1]] = adj[ij[:, 1], ij[:, 0]] = 1.0
    bsr = TG.normalize_adjacency(adj, 4)
    plan = TG._bsr_plan(bsr, dev)
    nbr = nodes // 4
    cfg = TG.GcnConfig(in_dim=1433, hidden=(16,), out_dim=7)
    params = TG.init_params(cfg, seed=0, device=dev)
    h = torch.as_tensor(rng.standard_normal((nodes, 1433)),
                        dtype=torch.float32, device=dev)
    labels = torch.as_tensor(rng.integers(0, 7, nodes), device=dev)
    out = run("gcn forward", [], TG.forward, params, plan, nbr, h, cfg)
    ahat = torch.as_tensor(bsr.to_dense(), dtype=torch.float64, device=dev)
    x = h.double()
    for i, layer in enumerate(params):
        x = ahat @ (x @ layer["w"].double()) + layer["b"].double()[None, :]
        if i < len(params) - 1:
            x = x.clamp_min(0.0)
    err = _check("gcn forward vs float64", x, out, TOL_GCN, (nodes, 7))
    loss0 = float(TG.loss_fn(params, plan, nbr, h, labels, cfg))
    step_params = params
    for _ in range(3):
        step_params, _loss = run("gcn train_step", [], TG.train_step,
                                 step_params, plan, nbr, h, labels, cfg,
                                 1e-2)
    loss3 = float(TG.loss_fn(step_params, plan, nbr, h, labels, cfg))
    if not loss3 < loss0:
        raise AssertionError(f"gcn: loss {loss0} -> {loss3} after 3 steps")
    t_fwd = ms(TG.forward, params, plan, nbr, h, cfg)
    t_step = ms(TG.train_step, params, plan, nbr, h, labels, cfg, 1e-2)
    print(f"  tpp_gcn {nodes} nodes ({bsr.nblocks} 4x4 blocks) 1433-16-7: "
          f"forward normf_rel {err:.2e} vs float64, loss {loss0:.6f} -> "
          f"{loss3:.6f} in 3 steps (lr 1e-2); forward {t_fwd:.4f} ms, "
          f"train step {t_step:.4f} ms")

    torch.cuda.synchronize()
    counts = {k_: v_ for k_, v_ in _all_launches().items() if v_}
    print(f"sparse layer path: {len(phases)} phases in "
          f"{time.perf_counter() - t_path:.2f} s, kernel launches {counts}")
    return {"phases": phases}


def _bytes_equal(name, want, got):
    """Bit-exact comparison of two tensors of any type (f8 included)."""
    if want.dtype != got.dtype or want.shape != got.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} != "
                             f"{want.dtype} {tuple(want.shape)}")
    if not torch.equal(want.view(torch.uint8), got.view(torch.uint8)):
        raise AssertionError(f"{name}: the bytes differ")


def _sr_neighbours(name, x, y, mant, emin):
    """Each output is one of x's two neighbours in the target: representable
    (held by the bit-exact check against the plain version) and less than
    one target ulp away from x."""
    x64, y64 = x.double(), y.double()
    e = torch.floor(torch.log2(x64.abs().clamp_min(2.0 ** -200)))
    ulp = torch.exp2(torch.clamp_min(e, emin) - mant)
    if not bool(((y64 - x64).abs() < ulp).all()):
        raise AssertionError(f"{name}: an output is not a neighbour of x")


def gemm_ext_path(randn, dev):
    """The fused GEMM-ext path with stochastic rounding, driven through the
    public entry points with every launch count set to 0 just before and
    read just after: the stochastic-round kernel alone at the BERT-base FFN
    shape into every target; dispatch_brgemm_ext at the FFN1 product with
    the SR store and a bias, and with RELU + bias + bitmask; the other SR
    entry points; meltw QUANT/DEQUANT with the MX types; the packed, ext
    and ext_packed classes of samples/xgemm.py; TPP-CNN's conv2d_kernel at
    samples/cnn.py's layer and three SGD steps of the model. Returns the
    phases (to time), the counts, and the operands the per-kernel row and
    the CNN timings reuse."""
    import numpy as np

    import libxsmm_torch as xt
    from libxsmm_torch import quant as Q
    from libxsmm_torch import xgemm as X
    from libxsmm_torch.descriptor import (BatchReduceConfig, BatchReduceType,
                                          BinaryPostops, BinaryType,
                                          GemmFlags, GemmShape, UnaryArgops,
                                          UnaryFlags, UnaryType)
    from libxsmm_torch.dtypes import Datatype
    from libxsmm_torch.kernels import attention as KA
    from libxsmm_torch.kernels import eltwise as KE
    from libxsmm_torch.kernels import gemm as K
    from libxsmm_torch.kernels import spmm as KS
    from libxsmm_torch.models import tpp_cnn as TC

    bf16, f32 = torch.bfloat16, torch.float32
    phases = []
    run = functools.partial(_counted, phases)
    for mod in (K, KA, KE, KS):
        mod.reset_launches()
    t_path = time.perf_counter()

    # the stochastic-round kernel alone at the BERT-base FFN shape, f32 in
    m, n = EXT_SHAPES["ffn"]
    x = randn(m, n)
    for tname, mant, emin in SR_TARGETS:
        dt = Datatype[tname]
        y = run(f"sr f32->{tname.lower()} {m}x{n}", EXT_KERNELS,
                KE.stochastic_round, x, 7, dt)
        _bytes_equal(f"sr {tname} vs plain", KE.stochastic_round.plain(
            x, 7, dt), y)
        _sr_neighbours(f"sr {tname}", x, y, mant, emin)

    # dispatch_brgemm_ext at the BERT-base FFN1 product: m 4096, n 3072,
    # k 768 as STRIDE br 12 x k 64
    br, kk = EXT_SHAPES["br_k"]
    cfg = BatchReduceConfig(BatchReduceType.STRIDE, br)
    a32, b32 = randn(br, m, kk), randn(br, kk, n, scale=0.125)
    bias = randn(1, n)
    acc64 = torch.einsum("bmk,bkn->mn", a32.double(), b32.double()) \
        + bias.double()
    sr_kern = xt.dispatch_brgemm_ext(
        GemmShape(m, n, kk, out_type=Datatype.BF16), GemmFlags.BETA_0, cfg,
        argops=UnaryArgops(cp_type=UnaryType.STOCHASTIC_ROUND),
        postops=BinaryPostops(d_type=BinaryType.ADD))
    out = run(f"brgemm_ext f32->bf16 sr+bias {m}x{n}x{br * kk}", EXT_KERNELS,
              lambda a, b, d: sr_kern(a, b, d, seed=11), a32, b32, bias)
    e_sr = _check("brgemm_ext sr vs float64", acc64, out, TOL_SR_BF16,
                  (m, n))
    ulp = torch.exp2(torch.floor(torch.log2(acc64.abs().clamp_min(1e-30)))
                     - 7)
    # plus 1e-5 of the largest magnitude: the f32 accumulator's rounding
    if not bool(((out.double() - acc64).abs()
                 <= ulp + 1e-5 * acc64.abs().max()).all()):
        raise AssertionError("brgemm_ext sr: an output is more than one "
                             "bf16 ulp from the float64 accumulator")
    ab, bb = a32.to(bf16), b32.to(bf16)
    relu_kern = xt.dispatch_brgemm_ext(
        GemmShape(m, n, kk, a_in_type=Datatype.BF16, b_in_type=Datatype.BF16,
                  out_type=Datatype.F32), GemmFlags.BETA_0, cfg,
        argops=UnaryArgops(cp_type=UnaryType.RELU,
                           cp_flags=UnaryFlags.BITMASK_2BYTEMULT),
        postops=BinaryPostops(d_type=BinaryType.ADD))
    out_r, extra = run(f"brgemm_ext bf16->f32 relu+bias+mask {m}x{n}"
                       f"x{br * kk}", [], relu_kern, ab, bb, bias)
    acc_b = torch.einsum("bmk,bkn->mn", ab.double(), bb.double()) \
        + bias.double()
    e_relu = _check("brgemm_ext relu vs float64", acc_b.clamp_min(0.0),
                    out_r, TOL_BF16_IN, (m, n))
    if not torch.equal(xt.unpack_bitmask(extra["cp_bitmask"], m, n),
                       out_r > 0):
        raise AssertionError("brgemm_ext relu: the bitmask is not acc > 0")
    print(f"  brgemm_ext FFN1: sr+bias normf_rel vs float64 {e_sr:.3e}, "
          f"relu+bias {e_relu:.3e}")

    # the other SR entry points at the same shape
    sr_meltw = xt.dispatch_meltw_unary(UnaryType.STOCHASTIC_ROUND, m, n,
                                       out_type=Datatype.BF16)
    for name, fn, dt in (
            ("meltw stochastic_round bf16", lambda t: sr_meltw(t, 7),
             Datatype.BF16),
            ("stochastic_convert_fp32_bf16",
             lambda t: Q.stochastic_convert_fp32_bf16(t, 7), Datatype.BF16),
            ("stochastic_convert_fp32_bf8",
             lambda t: Q.stochastic_convert_fp32_bf8(t, 7), Datatype.BF8)):
        got = run(f"{name} {m}x{n}", EXT_KERNELS, fn, x)
        _bytes_equal(f"{name} vs plain", KE.stochastic_round.plain(
            x, 7, dt), got)

    # meltw QUANT/DEQUANT with the MX types: the bytes of the same call on
    # CPU copies
    xq, xq_cpu = x * 4.0, (x * 4.0).cpu()
    for tname in ("MXFP4X2", "NVFP4X2", "MXBF8"):
        dt = Datatype[tname]
        qk = xt.dispatch_meltw_unary(UnaryType.QUANT, m, n, out_type=dt)
        dk = xt.dispatch_meltw_unary(UnaryType.DEQUANT, m, n, in_type=dt)
        payload, scales = run(f"meltw quant {tname.lower()} {m}x{n}", [],
                              qk, xq)
        deq = run(f"meltw dequant {tname.lower()} {m}x{n}", [], dk, payload,
                  scales)
        p_cpu, s_cpu = qk(xq_cpu)
        _bytes_equal(f"quant {tname} payload vs cpu", p_cpu, payload.cpu())
        _bytes_equal(f"quant {tname} scales vs cpu", s_cpu, scales.cpu())
        _bytes_equal(f"dequant {tname} vs cpu", dk(p_cpu, s_cpu), deq.cpu())

    # the packed (24), ext (47) and ext_packed (4) classes of
    # samples/xgemm.py at its shapes and margins, against float64
    worst, nclass = {}, 0
    for i, cls in enumerate(X.build_class_list()):
        if cls["kind"] not in ("packed", "ext", "ext_packed"):
            continue
        ok, label, err = X.run_class(cls, np.random.default_rng(i), dev)
        if not ok:
            raise AssertionError(f"xgemm class {i} failed: {label} "
                                 f"normf_rel {err}")
        worst[cls["kind"]] = max(worst.get(cls["kind"], 0.0), err)
        nclass += 1
    torch.cuda.synchronize()
    print(f"  xgemm: {nclass} packed/ext/ext_packed classes passed on the "
          f"card; worst normf_rel " + ", ".join(
              f"{k} {v:.3e}" for k, v in worst.items()))

    # TPP-CNN: conv2d_kernel at samples/cnn.py's default layer (N=32,
    # 56x56x64 -> 64, 3x3, stride 1: a ResNet-50 conv2_x 3x3 layer, He et
    # al. 2016) with fused bias + relu, f32 and bf16, against float64
    cn, ch, cw, cc, ck, cr = EXT_SHAPES["cnn"]
    xc = randn(cn, ch, cw, cc)
    wc = randn(cr, cr, cc, ck, scale=(cr * cr * cc) ** -0.5)
    bc = randn(ck)
    convs = {}
    for dt, tol in ((f32, TOL_CONV_F32), (bf16, TOL_CONV_BF16)):
        fn = TC.conv2d_kernel(tuple(xc.shape), tuple(wc.shape), 1,
                              fused_bias=True, relu=True, dtype=dt)
        xd, wd, bd = xc.to(dt), wc.to(dt), bc.to(dt)
        got = run(f"conv2d_kernel {str(dt)[6:]} {cn}x{ch}x{cw}x{cc}->{ck}",
                  [], fn, xd, wd, bd)
        want = TC.conv2d_tpp(xd.double(), wd.double(), bd.double(), 1,
                             "relu")
        if dt == f32:
            err = float((got.double() - want).abs().max()
                        / want.abs().max())
            if not err < tol:
                raise AssertionError(f"conv2d_kernel f32: {err} vs float64")
        else:
            err = _check("conv2d_kernel bf16 vs float64", want, got, tol,
                         tuple(want.shape))
        print(f"  conv2d_kernel {dt}: error vs float64 {err:.3e}")
        convs[dt] = (fn, (xd, wd, bd))

    # the model at that layer's widths: two 3x3 convs (stride 1, 2), 1000
    # classes, batch 32; three SGD steps lower the loss on the batch
    ccfg = TC.CnnConfig(height=ch, width=cw, channels=cc,
                        filters=((cr, ck), (cr, ck)), strides=(1, 2),
                        classes=1000)
    cparams = TC.init_params(ccfg, seed=0, device=dev)
    labels = torch.randint(0, 1000, (cn,), device=dev)
    logits = run(f"tpp_cnn forward {cn}x{ch}x{cw}x{cc}", [], TC.forward,
                 cparams, xc, ccfg)
    if tuple(logits.shape) != (cn, 1000) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError("tpp_cnn forward: bad logits")
    p, losses = cparams, []
    for _ in range(3):
        p, loss = TC.train_step(p, xc, labels, ccfg, lr=CNN_LR)
        losses.append(loss.item())
    with torch.inference_mode():
        after = TC.loss_fn(p, xc, labels, ccfg).item()
    print(f"  tpp_cnn: loss {losses[0]:.6f} -> {after:.6f} after three SGD "
          f"steps (lr {CNN_LR})")
    if not after < losses[0]:
        raise AssertionError("tpp_cnn: three SGD steps did not lower the "
                             "loss")

    torch.cuda.synchronize()
    counts = {k: KE.launches[k] for k in EXT_KERNELS}
    launched = {k: v for mod in (K, KA, KS) for k, v in mod.launches.items()
                if v}
    launched.update({k: v for k, v in KE.launches.items()
                     if v and k not in EXT_KERNELS})
    print(f"gemm-ext path: {len(phases)} phases in "
          f"{time.perf_counter() - t_path:.2f} s, kernel launches {counts}; "
          f"other kernels {launched}")
    missing = [k for k in EXT_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the gemm-ext path: "
                             f"{missing}")
    return {"phases": phases, "counts": counts, "sr_operand": x,
            "convs": convs, "cnn": (cparams, xc, labels, ccfg)}


def cnn_breakdown(convs, cnn, ms):
    """Where the conv's time goes: the 9x tap stack alone beside the whole
    conv2d_kernel call, a forward and a train step, and cuDNN's
    convolution (no TF32) with bias and relu on the same values as the
    yardstick (the port never calls it)."""
    from libxsmm_torch.models import tpp_cnn as TC

    for dt, (fn, (x, w, b)) in convs.items():
        t_conv = ms(fn, x, w, b)
        r = w.shape[0]
        t_taps = ms(TC._tap_stack, x, r, r, 1)
        stack_mb = r * r * x.shape[0] * (x.shape[1] - r + 1) \
            * (x.shape[2] - r + 1) * x.shape[3] * x.element_size() / 1e6
        xn = x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        wn = w.permute(3, 2, 0, 1).contiguous()
        t_cudnn = ms(lambda a, k, c: torch.relu(
            torch.nn.functional.conv2d(a, k, c)), xn, wn, b)
        print(f"  conv {dt}: conv2d_kernel {t_conv:.4f} ms, of it the tap "
              f"stack alone {t_taps:.4f} ms ({stack_mb:.1f} MB, "
              f"{100 * t_taps / t_conv:.1f}%); cudnn conv2d+bias+relu "
              f"{t_cudnn:.4f} ms")
    params, x, labels, cfg = cnn
    t_fwd = ms(TC.forward, params, x, cfg)
    t_step = ms(lambda p, xx, yy: TC.train_step(p, xx, yy, cfg, CNN_LR),
                params, x, labels)
    print(f"  tpp_cnn {'x'.join(map(str, x.shape))}: forward {t_fwd:.4f} ms,"
          f" train step {t_step:.4f} ms")


def device_split(fn, reps=20):
    """Device time per call of fn() by kernel name, in ms: each CUDA
    kernel's summed time over `reps` calls, from torch.profiler, after one
    call to warm up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            split[e.name] = (split.get(e.name, 0.0)
                             + e.time_range.elapsed_us() / reps / 1e3)
    return split


def graph_ms(fn, reps=20, rounds=5):
    """Milliseconds per call of fn() replayed from a CUDA graph of `reps`
    captured calls, the best of `rounds` replays timed with CUDA events:
    the card's time per call with the launches back to back, no host cost
    between them (the device stays busy, as under a loaded caller). Two
    calls warm up on a side stream first, as capture asks."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    best = float("inf")
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def device_ms(fn, reps=20):
    """Device time per call of fn(): the CUDA kernels' summed time over
    `reps` calls, from torch.profiler, after one call to warm up."""
    total = sum(device_split(fn, reps).values())
    if not total:
        raise AssertionError("device_ms: the profiler recorded no kernel")
    return total


def mma_rate(row, flops, useful):
    """Print a tensor-core kernel's achieved rate (its own products and the
    useful ones, over its time in this run) and its ratio to the library
    call timed beside it; keep the rate in the row."""
    row["tflops"] = flops / row["ms"] / 1e9
    print(f"  {row['name']}: {row['tflops']:.1f} TFLOP/s of its own "
          f"products, {useful / row['ms'] / 1e9:.1f} TFLOP/s useful; "
          f"kernel / library {row['ms'] / row['library_ms']:.3f}")


def sparse_rows(record, rows, stream, ms, geo):
    """The five sparse kernels at the streaming case, each against its
    plain version. Bound: A, the kernel's value operand and C each moved
    once, and the useful products 2 * nblocks * bk * bn * m at the bf16
    tensor cores' peak. Yardstick for the SpMM kernels: torch.mm on the
    densified B with an f32 output; for densify: PyTorch's BSC tensor
    to_dense. The union row carries the compacted form's time (compactor,
    then the kernel over its RHS) as "compact_ms"; the compactor's row
    moves the value store once and writes the compacted RHS once, and since
    no PyTorch call computes the compaction its library time is null and a
    clone of the compacted RHS (the same bytes written) stands beside it as
    "clone_ms"."""
    from libxsmm_torch.kernels import spmm as KS
    from libxsmm_torch.ops.sparse import assemble_supertiles, supertile_plan

    shape, cfg, bcsc, a, v = stream
    dev = a.device
    m, n, k = shape.m, shape.n, shape.k
    indptr, indices = bcsc.indptr, bcsc.indices
    useful = 2 * bcsc.nblocks * cfg.bk * cfg.bn * m
    io = 2 * m * k + 4 * m * n               # A bf16 in, C f32 out
    densify = KS.build_bcsc_densify(shape, cfg, indptr, indices, dev)
    dense_b = densify.plain(v)
    lib_mm = ms(lambda x, y: torch.mm(x, y, out_dtype=torch.float32), a,
                dense_b)
    src = "spmm_kernels.cu"
    peak = geo.peak_bf16_tflops
    sched = KS.build_bcsc_spmm(shape, cfg, indptr, indices, dev)
    if sched.path != "mma":
        raise AssertionError(f"bcsc_spmm at the streaming case took "
                             f"{sched.path}")
    record("bcsc_spmm", src, "libxsmm_tpu/kernels/spmm_pallas.py:88",
           sched, (a, v), TOL_SPARSE_BF16, io + 2 * v.numel(), useful, peak,
           lib_mm)
    mma_rate(rows[-1], useful, useful)
    union = KS.build_bcsc_spmm_union(shape, cfg, indptr, indices, dev)
    union_c = KS.build_bcsc_spmm_union(shape, cfg, indptr, indices, dev,
                                       compact=True)
    if (union.path, union_c.path) != ("mma", "mma"):
        raise AssertionError(f"bcsc_spmm_union at the streaming case took "
                             f"{union.path} / {union_c.path}")
    _check("bcsc_spmm_union compacted form vs fused form", union(a, v),
           union_c(a, v), TOL_SPARSE_BF16)
    record("bcsc_spmm_union", src, "libxsmm_tpu/kernels/spmm_pallas.py:258",
           union, (a, v), TOL_SPARSE_BF16, io + 2 * v.numel(), useful, peak,
           lib_mm, compact_ms=ms(union_c, a, v))
    # its own products: every live union slot of every group, bk deep and
    # 128 wide (the pad slots are skipped)
    live = (union.gmap.view(union.nsg, union.U, union.W)
            != union.nblocks).any(-1).sum().item()
    own = 2 * m * live * cfg.bk * KS.GROUP
    mma_rate(rows[-1], own, useful)
    t_c = rows[-1]["compact_ms"]
    print(f"  bcsc_spmm_union compacted form (compactor included): "
          f"{t_c:.4f} ms, {own / t_c / 1e9:.1f} TFLOP/s of its own products,"
          f" {useful / t_c / 1e9:.1f} TFLOP/s useful; kernel / library "
          f"{t_c / lib_mm:.3f}; {live} live slots of {union.nsg * union.U}")
    rhs = union_c.compactor(v)
    record("bcsc_union_compact", src, "libxsmm_tpu/kernels/spmm_pallas.py:885",
           union_c.compactor, (v,), TOL_EXACT,
           v.numel() * v.element_size() + rhs.numel() * rhs.element_size(),
           0, peak, None, clone_ms=ms(torch.clone, rhs))
    s_indptr, s_indices, sgmap = supertile_plan(shape, cfg, indptr, indices)
    sup = assemble_supertiles(v, torch.as_tensor(sgmap, device=dev),
                              torch.bfloat16)
    sfn = KS.build_bcsc_spmm_super(shape, s_indptr, s_indices, dev)
    if sfn.path != "mma":
        raise AssertionError(f"bcsc_spmm_super took {sfn.path}")
    record("bcsc_spmm_super", src, "libxsmm_tpu/kernels/spmm_pallas.py:942",
           sfn, (a, sup), TOL_SPARSE_BF16, io + 2 * sup.numel(), useful, peak,
           lib_mm)
    # its own products: every occupied supertile in full
    mma_rate(rows[-1], 2 * m * KS.SUPER * KS.SUPER * len(s_indices), useful)
    ccol = torch.as_tensor(indptr.astype("int64"), device=dev)
    rows = torch.as_tensor(indices.astype("int64"), device=dev)
    record("bcsc_densify", src, "libxsmm_tpu/kernels/spmm_pallas.py:800",
           densify, (v,), TOL_EXACT, 2 * v.numel() + 2 * k * n, 0, peak,
           ms(lambda vv: torch.sparse_bsc_tensor(ccol, rows, vv,
                                                 (k, n)).to_dense(), v))


def labs_path(randn, headline):
    """The labs, with the five twin and probe kernels' launch counts set to
    0 just before and read just after: the BRGEMM lab (its four variants at
    br = 1024, 256 x 256 x 64 bf16, each twin held against its plain
    version inside the lab), the packed SMM's passthrough twin at the
    headline's (4096, 32, 128) f32, bit for bit against a + b and timed
    interleaved with the headline kernel (bench.py:869's fraction), and the
    BCSC lab at densities 0.2 and 0.05 (its probes held against the float64
    product and their plain versions inside the lab). Returns the counts
    and the passthrough's operands."""
    import numpy as np

    from libxsmm_torch.kernels import gemm as K
    from libxsmm_torch.kernels import spmm_lab as KL
    from libxsmm_torch.scripts import bcsc_lab, brgemm_lab
    from libxsmm_torch.utils.timer import bench_chain_interleaved

    smm, (ap, bp) = headline
    G, m = ap.shape[0], ap.shape[1]
    pa, pb = randn(G, m, 128), randn(G, m, 128, scale=0.1)
    K.launches.update(packed_brgemm_sol=0, packed_smm_passthrough=0)
    KL.reset_launches()
    t_path = time.perf_counter()

    for r in brgemm_lab.main(["--rounds", "3"]):
        print(f"  brgemm lab {r['variant']}: t_sol / t_brg {r['sol_frac']:.4f}"
              f" (brgemm {r['brg_us']:.1f} us, sol {r['sol_us']:.1f} us; "
              f"sol vs plain normf_rel {r['sol_normf_rel']:.2e})")

    pt = K.build_packed_smm_passthrough(G, m)
    _check("passthrough vs a + b", pa + pb, pt(pa, pb), TOL_EXACT,
           (G, m, 128))
    (t_smm, t_pt), rounds = bench_chain_interleaved(
        [(smm, (ap, bp)), (pt, (pa, pb))], rounds=5, per_round=True)
    paired = float(np.median([p_ / s_ for s_, p_ in zip(*rounds)]))
    print(f"  headline fraction t_passthrough / t_packed_smm "
          f"{G}x{m}x128 f32: {t_pt / t_smm:.4f} over the best windows, "
          f"{paired:.4f} paired median (packed SMM {t_smm * 1e3:.4f} ms, "
          f"passthrough {t_pt * 1e3:.4f} ms)")

    for density in (0.2, 0.05):
        bcsc_lab.main(["--density", str(density), "--rounds", "3"])

    torch.cuda.synchronize()
    counts = {k: _count(k) for k in LAB_KERNELS}
    print(f"labs: {time.perf_counter() - t_path:.2f} s, kernel launches "
          f"{counts}")
    missing = [k for k in LAB_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched in the labs: {missing}")
    return {"counts": counts, "passthrough": (pt, pa, pb)}


def lab_rows(record, ms, geo, dev, passthrough, brgemm):
    """The two twins and the three BCSC probes, each against its plain
    version. The BRGEMM twin is bound by the packed BRGEMM row's bytes, so
    the two rows compare like with like; no PyTorch call computes it
    (library_ms null) and the BRGEMM's time stands beside it as
    "brgemm_ms". The passthrough moves 3 * G * m * 128 * 4 bytes; its
    yardstick is torch.add. The probes at the BCSC lab's shape (m = k = n =
    1024, density 0.2) are bound by the larger of their bytes (A, the
    values or minimal's constant RHS, and C, each once) and the union's
    2 * m * U * 32 * n products at the bf16 tensor cores' peak; their
    yardstick is torch.mm(out_dtype=f32) on the densified B, for minimal on
    its own panel and RHS. chunk2 and chunk4 stand beside the chunk1 row."""
    import numpy as np

    from libxsmm_torch.descriptor import GemmShape, SpgemmConfig
    from libxsmm_torch.dtypes import Datatype
    from libxsmm_torch.kernels.spmm import build_bcsc_densify
    from libxsmm_torch.scripts import bcsc_lab

    sol, br_args, br_bytes, br_ms = brgemm
    row = record("packed_brgemm_sol", "gemm_kernels.cu",
                 "libxsmm_tpu/kernels/gemm_pallas.py:334", sol, br_args,
                 TOL_F32, br_bytes, 0, geo.peak_bf16_tflops, None,
                 brgemm_ms=br_ms, path=sol.path)
    print(f"  packed_brgemm_sol on the {sol.path} route: {row['ms']:.4f} ms,"
          f" t_sol / t_brg {row['ms'] / br_ms:.4f}")
    pt, pa, pb = passthrough
    record("packed_smm_passthrough", "gemm_kernels.cu", "bench.py:441", pt,
           (pa, pb), TOL_EXACT, 3 * pa.numel() * 4, 0, geo.peak_f32_tflops,
           ms(torch.add, pa, pb))

    m = k = n = 1024
    bcsc, rng = bcsc_lab.build_pattern(0.2)
    a = torch.as_tensor(rng.standard_normal((m, k)),
                        device=dev).to(torch.bfloat16)
    v = torch.as_tensor(bcsc.data, device=dev).to(torch.bfloat16)
    probes = bcsc_lab.make_variants((m, n, k), bcsc, 0.2, dev)
    U = probes["dspipe"].U
    union_ops = 2 * m * U * 32 * n
    out_bytes = 4 * m * n
    shape = GemmShape(m, n, k, Datatype.BF16, Datatype.BF16, Datatype.F32)
    dense_b = build_bcsc_densify(shape, SpgemmConfig(1, 32, 32),
                                 bcsc.indptr, bcsc.indices, dev).plain(v)

    def mm_f32(x, y):
        return torch.mm(x, y, out_dtype=torch.float32)

    lib_mm = ms(mm_f32, a, dense_b)
    fused_bytes = 2 * a.numel() + 2 * v.numel() + out_bytes
    src, lab = "spmm_lab_kernels.cu", "scripts/bcsc_lab.py"
    record("bcsc_lab_chunk", src, f"{lab}:173", probes["chunk1"], (a, v),
           TOL_SPARSE_BF16, fused_bytes, union_ops, geo.peak_bf16_tflops,
           lib_mm, chunk2_ms=ms(probes["chunk2"], a, v),
           chunk4_ms=ms(probes["chunk4"], a, v))
    record("bcsc_lab_dspipe", src, f"{lab}:236", probes["dspipe"], (a, v),
           TOL_SPARSE_BF16, fused_bytes, union_ops, geo.peak_bf16_tflops,
           lib_mm)
    minimal = probes["minimal"]
    rhs = minimal.rhs
    panel = a[:, :U * 32].contiguous()
    rhs_cat = rhs.permute(1, 0, 2).reshape(U * 32, n).contiguous()
    record("bcsc_lab_minimal", src, f"{lab}:100", minimal, (a, v),
           TOL_SPARSE_BF16, 2 * panel.numel() + 2 * rhs.numel() + out_bytes,
           union_ops, geo.peak_bf16_tflops, ms(mm_f32, panel, rhs_cat))
    print(f"  bcsc lab probes at 1024^3, density 0.2: U = {U}, "
          f"{int(np.asarray(bcsc.indices).size)} blocks")


def step_breakdown(params, x, y, cfg, reps=5):
    """One seeded train step at the path's shape, split into the forward
    (loss with its graph), the backward (autograd) and the SGD update:
    host clock around each part, closed by a device sync; mean of `reps`
    after one warm-up."""
    from libxsmm_torch.models import tpp_attention as TA

    names = list(params)
    parts = {"forward": 0.0, "backward": 0.0, "update": 0.0}
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        leaves = {n: params[n].detach().requires_grad_(True) for n in names}
        loss = TA.loss_fn(leaves, x, y, cfg, seed=7)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        TA.sgd_update(params, dict(zip(names, grads)), TRAIN_LR)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if i:
            for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
                parts[k] += dt * 1e3 / reps
    total = sum(parts.values())
    print(f"  train step bf16 8x512 (ms per step, mean of {reps}): "
          + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
          + f"; total {total:.4f}")
    return parts


def step_trace(params, x, y, cfg, steps=3):
    """Device time of seeded train steps by kernel, from torch.profiler's
    CUDA kernel events, beside the steps' wall time (host clock, closed by
    a device sync) with and without the profiler: the device's busy share
    is read against the wall time without it, since the profiler's own
    host cost idles the device. Prints "not measured" when the profiler
    records no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from libxsmm_torch.models import tpp_attention as TA

    def run_steps():
        t0 = time.perf_counter()
        for i in range(steps):
            TA.train_step(params, x, y, cfg, TRAIN_LR, 7 + i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    run_steps()
    wall = run_steps()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof = run_steps()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / steps)
    busy = sum(by_name.values())
    walls = (f"wall {wall:.4f} ms per step ({wall_prof:.4f} under the "
             "profiler)")
    if not busy:
        print(f"  train step trace: {walls}; device time not measured "
              "(the profiler recorded no kernel)")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"  train step trace: {walls}, device busy {busy:.4f} ms "
          f"({100 * busy / wall:.1f}% of the wall, idle "
          f"{100 * (1 - busy / wall):.1f}%), {len(by_name)} kernel names; "
          "top: " + "; ".join(f"{n[:60]} {v:.4f}" for n, v in top))
    # the busy split: the port's flash kernels against everything else
    flash = {n: v for n, v in by_name.items() if "flash" in n}
    print("  train step busy split: " + "; ".join(
        f"{n.split('(')[0]} {v:.4f} ms "
        f"({100 * v / busy:.1f}%)" for n, v in sorted(flash.items()))
        + f"; the rest {busy - sum(flash.values()):.4f} ms")


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
    # the pipelined kernels, one line per instantiation
    for stem, needle in MMA_KERNELS:
        for name, regs, st, ld in _build.kernel_resources(stem, needle):
            print(f"  {stem} {name}: {regs} registers, spill stores {st} "
                  f"B, spill loads {ld} B")

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
    if K.path_launches["batched_gemm"] != {"bulk": 1, "cp_async": 0}:
        raise AssertionError("the batched SMM at 32^3 f32 left the bulk-copy "
                             f"route: {K.path_launches['batched_gemm']}")
    # off the aligned path: odd k and n take the cp.async route; and bf16 in
    # and out, with beta = 1, on the bulk route
    for (bm, bn, bk), dt, flags, tol in (
            ((33, 31, 17), torch.float32, B0, TOL_F32),
            ((32, 32, 32), torch.bfloat16, GemmFlags.NONE, TOL_BF16_OUT)):
        xd = xt.from_torch(dt)
        sh = GemmShape(bm, bn, bk, a_in_type=xd, b_in_type=xd, out_type=xd)
        xa, xb = randn(Bs * 4, bm, bk, dtype=dt), randn(Bs * 4, bk, bn,
                                                        dtype=dt)
        xargs, ref = (xa, xb), bmm64(xa, xb)
        if flags != B0:
            xc = randn(Bs * 4, bm, bn, dtype=dt)
            xargs, ref = (xa, xb, xc), ref + xc.double()
        phase(f"batched {xd.value} {bm}x{bn}x{bk}", "batched_gemm",
              xt.dispatch_gemm_batched(sh, flags), xargs, ident, ref,
              K.build_batched_gemm(GemmDescriptor(sh, flags), Bs * 4).plain,
              tol, (Bs * 4, bm, bn))

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

    # f32 on the TMA-fed FMA route: plain, and RELU + bias
    shape_f32 = GemmShape(M, N, KK)
    ap_br32, b_br32 = ap_br.float(), b_br.float()

    def br32_plain(cp="NONE", bias=False):
        return K.build_packed_brgemm(GemmDescriptor(shape_f32, B0, cfg), br,
                                     cp_type=cp, with_bias=bias).plain

    phase("brgemm packed f32", "packed_brgemm",
          xt.dispatch_brgemm_packed(shape_f32, B0, cfg), (ap_br32, b_br32),
          ident, ref_br, br32_plain(), TOL_F32, (M, N))
    kx32 = xt.dispatch_brgemm_ext_packed(
        shape_f32, B0, cfg, argops=UnaryArgops(cp_type=UnaryType.RELU),
        postops=BinaryPostops(d_type=BinaryType.ADD))
    relu32_plain = br32_plain("RELU", True)
    phase("brgemm ext f32 relu+bias", "packed_brgemm",
          lambda a, b: kx32(a, b, d_op=bias), (ap_br32, b_br32), ident,
          (ref_br + bias.double()).clamp_min(0.0),
          lambda a, b: relu32_plain(a, b, None, bias_mn), TOL_F32, (M, N))

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
    counts = {k: K.launches[k] for k in MAIN_KERNELS}
    by_route = {k: dict(K.path_launches[k])
                for k in ("packed_brgemm", "batched_gemm")}
    print(f"main path: {len(phases)} phases in "
          f"{time.perf_counter() - t_path:.2f} s, kernel launches {counts}, "
          f"by route {by_route}")
    # bf16 with n % 8 == 0 takes the tensor-core kernel and f32 with n % 4
    # == 0 the TMA-fed FMA kernel, every time; the batched SMM's odd shape
    # the cp.async route, the others the bulk copies
    if by_route["packed_brgemm"] != {"wgmma": 3, "tma_fma": 2, "fma": 0}:
        raise AssertionError("the BRGEMM left its routes: "
                             f"{by_route['packed_brgemm']}")
    if by_route["batched_gemm"] != {"bulk": 2, "cp_async": 1}:
        raise AssertionError("the batched SMM left its routes: "
                             f"{by_route['batched_gemm']}")
    counts["packed_brgemm_f32"] = by_route["packed_brgemm"]["tma_fma"]

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

    # 6. the encoder block's training path, counted on its own
    tr = training_path(randn, dev)
    for name, fn, fargs in tr["phases"]:
        print(f"  phase {name}: {ms(fn, *fargs):.4f} ms per call")
    counts.update({k: tr["counts"][k] for k in BWD_KERNELS})
    step_breakdown(*tr["step"])
    step_trace(*tr["step"])

    # 7. the block-sparse path, counted on its own
    sp = sparse_path(randn, dev)
    for name, fn, fargs in sp["phases"]:
        print(f"  phase {name}: {ms(fn, *fargs):.4f} ms per call")
    counts.update(sp["counts"])

    # 8. the fused GEMM-ext path with stochastic rounding, counted on its own
    ext = gemm_ext_path(randn, dev)
    for name, fn, fargs in ext["phases"]:
        print(f"  phase {name}: {ms(fn, *fargs):.4f} ms per call")
    counts.update(ext["counts"])
    cnn_breakdown(ext["convs"], ext["cnn"], ms)

    # 9. the rest of the sparse layer, counted on its own
    layer = sparse_layer_path(randn, dev, ms)
    for name, fn, fargs in layer["phases"]:
        print(f"  phase {name}: {ms(fn, *fargs):.4f} ms per call")

    # 10. the labs, counted on their own
    labs = labs_path(randn, (K.build_packed_batched_gemm(GemmDescriptor(
        smm, B0), G), (ap, bp)))
    counts.update(labs["counts"])

    # 11. each kernel against its plain version, and timed
    rows = []

    def record(name, source, replaces, fn, fargs, ref_tol, nbytes, flops,
               peak, lib, **more):
        got, want = fn(*fargs), fn.plain(*fargs)
        torch.cuda.synchronize()
        _check(f"{name} kernel vs plain", want, got, ref_tol)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"libxsmm_torch/kernels/csrc/{source}",
            "replaces": replaces,
            "launches": counts[name],
            "max_abs_err": _max_abs(want, got),
            "ms": ms(fn, *fargs), "plain_ms": ms(fn.plain, *fargs),
            "bound_ms": geo.bound_ms(nbytes, flops, peak),
            "bound_by": geo.bound_by(nbytes, flops, peak),
            "library_ms": lib, **more,
        })
        return rows[-1]

    gemm_src = "gemm_kernels.cu"
    desc = GemmDescriptor(smm, B0)
    smm_bytes, smm_flops = 3 * B * m * n * 4, 2 * B * m * n * k
    record("packed_batched_gemm", gemm_src,
           "libxsmm_tpu/kernels/gemm_pallas.py:467",
           K.build_packed_batched_gemm(desc, G), (ap, bp), TOL_F32,
           smm_bytes, smm_flops, geo.peak_f32_tflops,
           ms(torch.bmm, a_u, b_u))
    bgm = K.build_batched_gemm(desc, B)
    record("batched_gemm", gemm_src, "libxsmm_tpu/kernels/gemm_pallas.py:67",
           bgm, (a_u, b_u), TOL_F32, smm_bytes, smm_flops,
           geo.peak_f32_tflops, ms(torch.bmm, a_u, b_u), path=bgm.route)
    # the batched SMM off the aligned path (odd k and n: cp.async) and in
    # bf16 in and out, each against its plain version and torch.bmm
    for (bm, bn, bk), dt, tol in (((33, 31, 17), torch.float32, TOL_F32),
                                  ((32, 32, 32), torch.bfloat16,
                                   TOL_BF16_OUT)):
        xd = xt.from_torch(dt)
        sh = GemmShape(bm, bn, bk, a_in_type=xd, b_in_type=xd, out_type=xd)
        nb = 4096
        fn_ = K.build_batched_gemm(GemmDescriptor(sh, B0), nb)
        xa, xb = randn(nb, bm, bk, dtype=dt), randn(nb, bk, bn, dtype=dt)
        err = _check(f"batched {xd.value} {bm}x{bn}x{bk} kernel vs plain",
                     fn_.plain(xa, xb), fn_(xa, xb), tol)
        isz = xa.element_size()
        bound = geo.bound_ms(nb * (bm * bk + bk * bn + bm * bn) * isz,
                             2 * nb * bm * bn * bk, geo.peak_f32_tflops)
        t_k = ms(fn_, xa, xb)
        print(f"  batched_gemm {nb} x {bm}x{bn}x{bk} {xd.value} on the "
              f"{fn_.route} route, plan {fn_.config}: {t_k:.4f} ms (bound "
              f"{bound:.4f} ms, {t_k / bound:.2f}x; plain "
              f"{ms(fn_.plain, xa, xb):.4f} ms; torch.bmm "
              f"{ms(torch.bmm, xa, xb):.4f} ms); normf_rel {err:.2e}")
    desc_br = GemmDescriptor(shape_br, B0, cfg)
    # the library yardstick: one bf16 matmul with an f32 output over the
    # whole (m, br*k) x (br*k, n) contraction
    a_lib = ap_br.permute(1, 0, 2).reshape(M, br * KK).contiguous()
    b_lib = b_br.reshape(br * KK, N)

    def mm_f32(x, y):
        return torch.mm(x, y, out_dtype=torch.float32)

    br_bytes = 2 * br * KK * (M + N) + 4 * M * N
    br_flops = 2 * M * N * KK * br
    brg = K.build_packed_brgemm(desc_br, br)
    if brg.path != "wgmma":
        raise AssertionError(f"packed_brgemm at br={br} took {brg.path}")
    record("packed_brgemm", gemm_src,
           "libxsmm_tpu/kernels/gemm_pallas.py:163", brg,
           (ap_br, b_br), TOL_BF16_IN, br_bytes, br_flops,
           geo.peak_bf16_tflops, ms(mm_f32, a_lib, b_lib), path=brg.path)
    mma_rate(rows[-1], br_flops, br_flops)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"  packed_brgemm splits {brg.splits(sms)} on the "
          f"{brg.path} route: {rows[-1]['ms']:.4f} ms bf16, "
          f"{rows[-1]['ms'] / rows[-1]['bound_ms']:.2f}x its bound")
    # where a call's device time goes (the partial-tile kernel, the
    # reduce), beside the event-timed row, which holds the host's cost too
    row_br = rows[-1]
    sol_br = K.build_packed_brgemm_sol(desc_br, br)
    dev_ms, rep_ms = {}, {}
    for name_, fn_ in (("packed_brgemm", brg), ("packed_brgemm_sol", sol_br)):
        split = device_split(lambda f=fn_: f(ap_br, b_br))
        dev_ms[name_] = sum(split.values())
        rep_ms[name_] = graph_ms(lambda f=fn_: f(ap_br, b_br))
        print(f"  {name_} device time by kernel: " + "; ".join(
            f"{k_[:48]} {v_:.4f} ms" for k_, v_ in sorted(split.items()))
            + f"; replayed from a CUDA graph {rep_ms[name_]:.4f} ms a call")
    lib_dev = device_ms(lambda: mm_f32(a_lib, b_lib))
    lib_rep = graph_ms(lambda: mm_f32(a_lib, b_lib))
    row_br.update(device_ms=dev_ms["packed_brgemm"], library_device_ms=lib_dev,
                  graph_ms=rep_ms["packed_brgemm"], library_graph_ms=lib_rep)
    for how, t_b, t_s, t_l in (
            ("device time", dev_ms["packed_brgemm"],
             dev_ms["packed_brgemm_sol"], lib_dev),
            ("graph replay", rep_ms["packed_brgemm"],
             rep_ms["packed_brgemm_sol"], lib_rep)):
        print(f"  packed_brgemm by {how}: {t_b:.4f} ms "
              f"({br_flops / t_b / 1e9:.1f} TFLOP/s, "
              f"{t_b / row_br['bound_ms']:.2f}x its bound), torch.mm "
              f"{t_l:.4f} ms, kernel / library {t_b / t_l:.3f}; t_sol / "
              f"t_brg {t_s / t_b:.4f}")
    # the f32 packed BRGEMM, a row of its own, on the TMA-fed FMA route: f32
    # operands read once and the f32 output written once, its products on
    # the CUDA cores (no TF32). The yardstick is torch.mm in f32 with TF32
    # off on the same contraction; kernel, twin and yardstick event-timed,
    # by device time and replayed from a CUDA graph
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: f32 means f32")
    desc_f32 = GemmDescriptor(shape_f32, B0, cfg)
    brg_f32 = K.build_packed_brgemm(desc_f32, br)
    sol_f32 = K.build_packed_brgemm_sol(desc_f32, br)
    if (brg_f32.path, sol_f32.path) != ("tma_fma", "tma_fma"):
        raise AssertionError(f"the f32 BRGEMM took {brg_f32.path}, its twin "
                             f"{sol_f32.path}")
    br32_args = (ap_br32, b_br32)
    a_lib32, b_lib32 = a_lib.float(), b_lib.float()
    row32 = record("packed_brgemm_f32", gemm_src,
                   "libxsmm_tpu/kernels/gemm_pallas.py:163", brg_f32,
                   br32_args, TOL_F32, 4 * br * KK * (M + N) + 4 * M * N,
                   br_flops, geo.peak_f32_tflops,
                   ms(torch.mm, a_lib32, b_lib32), path=brg_f32.path)
    _check("packed_brgemm_sol f32 kernel vs plain", sol_f32.plain(*br32_args),
           sol_f32(*br32_args), TOL_F32)
    t32 = {}
    for name_, call in (("brgemm", lambda: brg_f32(*br32_args)),
                        ("sol", lambda: sol_f32(*br32_args)),
                        ("torch.mm", lambda: torch.mm(a_lib32, b_lib32))):
        split = device_split(call)
        t32[name_] = (sum(split.values()), graph_ms(call))
        print(f"  f32 {name_} device time by kernel: " + "; ".join(
            f"{k_[:48]} {v_:.4f} ms" for k_, v_ in sorted(split.items()))
            + f"; replayed from a CUDA graph {t32[name_][1]:.4f} ms a call")
    row32.update(
        tflops=br_flops / row32["ms"] / 1e9, device_ms=t32["brgemm"][0],
        library_device_ms=t32["torch.mm"][0], graph_ms=t32["brgemm"][1],
        library_graph_ms=t32["torch.mm"][1], sol_ms=ms(sol_f32, *br32_args),
        sol_device_ms=t32["sol"][0], sol_graph_ms=t32["sol"][1])
    for how, i_, t_e in (("events", None, row32["ms"]),
                         ("device time", 0, None), ("graph replay", 1, None)):
        t_b = t_e if i_ is None else t32["brgemm"][i_]
        t_l = row32["library_ms"] if i_ is None else t32["torch.mm"][i_]
        t_s = row32["sol_ms"] if i_ is None else t32["sol"][i_]
        print(f"  packed_brgemm_f32 by {how}: {t_b:.4f} ms "
              f"({br_flops / t_b / 1e9:.1f} TFLOP/s, "
              f"{t_b / row32['bound_ms']:.2f}x its bound), torch.mm f32 "
              f"{t_l:.4f} ms, kernel / library {t_b / t_l:.3f}; t_sol / "
              f"t_brg {t_s / t_b:.4f}; splits {brg_f32.splits(sms)}")
    # the lab's variants replayed from CUDA graphs (the lab's own
    # event-timed windows hold the host's cost): blocks, kernel, twin
    from libxsmm_torch.scripts.brgemm_lab import VARIANTS
    tiles = -(-M // 128) * -(-N // 128)
    for mult, sg in dict.fromkeys((v[0], v[1]) for v in VARIANTS):
        qv = q * mult
        apv = xt.pack_batched(a_br, qv)
        kv = K.build_packed_brgemm(desc_br, br, sg, pack_q=qv)
        sv = K.build_packed_brgemm_sol(desc_br, br, sg, pack_q=qv)
        tb = graph_ms(lambda: kv(apv, b_br))
        ts = graph_ms(lambda: sv(apv, b_br))
        print(f"  brgemm lab q{qv}_sg{sg} replayed ({kv.path}, "
              f"{tiles * kv.splits(sms)[1]} blocks): brgemm {tb:.4f} ms, "
              f"sol {ts:.4f} ms, t_sol / t_brg {ts / tb:.4f}")
    lab_rows(record, ms, geo, dev, labs["passthrough"],
             (sol_br, (ap_br, b_br), br_bytes, row_br["ms"]))
    next(r for r in rows if r["name"] == "packed_brgemm_sol").update(
        device_ms=dev_ms["packed_brgemm_sol"],
        graph_ms=rep_ms["packed_brgemm_sol"])

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

    if flash.path != "mma":
        raise AssertionError(f"flash forward bf16 took {flash.path}")
    flash_ops = 4 * fbh * fs * fs * fhd
    record("flash_attention_fwd", "attention_kernels.cu",
           "libxsmm_tpu/kernels/attention_pallas.py:159", flash,
           (0, fq, fkT, fv), TOL_BF16_OUT,
           4 * fbh * fs * fhd * 2, flash_ops,
           geo.peak_bf16_tflops, ms(sdpa, *sdpa_operands(fq, fkT, fv)))
    mma_rate(rows[-1], flash_ops, flash_ops)
    # dropout at the FFN shape: x read once, out and the byte mask written
    # once; the yardstick is torch's dropout (its own random bits)
    dx = enc["dropout_operand"]
    record("dropout", "eltwise_kernels.cu",
           "libxsmm_tpu/kernels/eltwise_pallas.py:103", KE.dropout,
           (dx, 7, 0.1), TOL_EXACT, dx.numel() * (2 + 2 + 1), 0,
           geo.peak_bf16_tflops,
           ms(lambda t: torch.nn.functional.dropout(t, 0.1, True), dx))

    # the flash backward at the same shape, one kernel per row: dK/dV runs
    # four (s, s, hd) products, dQ three (the reference's CostEstimate
    # counts 6 and 4 * bh * s^2 * hd); q, kT, v, dout and one column each of
    # lse and delta read once, the kernel's outputs written once. The
    # yardstick is the backward of PyTorch's fused attention on the same
    # q, k, v and dout, which computes dq, dk and dv together: it stands
    # beside both rows. It is reached through autograd, whose host cost
    # sets a CUDA-event time of back-to-back calls (0.19-0.44 ms at the
    # bench shape across runs), so its device time is taken instead.
    def sdpa_bwd(q_, kT_, v_, dout_, causal=False):
        """The backward of PyTorch's fused attention alone, as a call."""
        leaves = tuple(t_.detach().requires_grad_(True)
                       for t_ in sdpa_operands(q_, kT_, v_))
        out_ = sdpa(*leaves, causal)
        return lambda: torch.autograd.grad(out_, leaves, dout_[None],
                                           retain_graph=True)

    def sdpa_bwd_ms(*operands, causal=False):
        return device_ms(sdpa_bwd(*operands, causal))

    bargs = tr["bwd_operands"]
    bwd = KA.build_flash_attention_bwd(fbh, fs, fhd, torch.bfloat16)
    if bwd.path != "mma":
        raise AssertionError(f"flash backward bf16 took {bwd.path}")
    lib_bwd = sdpa_bwd_ms(*bargs[1:5])
    ops_in = 4 * fbh * fs * fhd * 2 + 2 * fbh * fs * 4
    for name, part, plain, nout, nmm in (
            ("flash_attention_bwd_dkv", bwd.dkv, bwd.dkv_plain, 2, 8),
            ("flash_attention_bwd_dq", bwd.dq, bwd.dq_plain, 1, 6)):
        fn_ = functools.partial(part)
        fn_.plain = plain
        useful_ = nmm * fbh * fs * fs * fhd
        record(name, "attention_bwd_kernels.cu",
               "libxsmm_tpu/kernels/attention_pallas.py:387" if nmm == 8
               else "libxsmm_tpu/kernels/attention_pallas.py:485", fn_,
               bargs, TOL_BF16_OUT,
               ops_in + nout * fbh * fs * fhd * 2,
               useful_, geo.peak_bf16_tflops, lib_bwd)
        # its own products, hd padded to its bucket; at 32-column K tiles
        # the dK/dV kernel's two warps of a key group both form S^T and dP^T
        hdp = KA._mma_hdp(fhd)
        redo = 64 // bwd.block_k if nmm == 8 else 1
        mma_rate(rows[-1], (4 * redo + nmm - 4) * fbh * fs * fs * hdp,
                 useful_)
    t_pair = rows[-2]["ms"] + rows[-1]["ms"]
    print(f"  flash backward dkv + dq {t_pair:.4f} ms; kernels / sdpa "
          f"backward {t_pair / lib_bwd:.3f}")

    sparse_rows(record, rows, sp["stream"], ms, geo)

    # stochastic rounding at the FFN shape, f32 -> bf16: x read once, out
    # written once. No PyTorch call computes stochastic rounding
    # (library_ms null); the RNE cast x.to(bf16) moves the same bytes and is
    # printed beside it as "rne_cast_ms"
    sx = ext["sr_operand"]
    record("stochastic_round", "eltwise_kernels.cu",
           "libxsmm_tpu/kernels/eltwise_pallas.py:50", KE.stochastic_round,
           (sx, 7, Datatype.BF16), TOL_EXACT, sx.numel() * (4 + 2), 0,
           geo.peak_bf16_tflops, None, rne_cast_ms=ms(lambda t: t.to(torch.bfloat16), sx))
    for tname in ("F16", "BF8", "HF8"):
        print(f"  stochastic_round f32->{tname.lower()} {tuple(sx.shape)}: "
              f"{ms(KE.stochastic_round, sx, 7, Datatype[tname]):.4f} ms")

    # the tile configurations of the flash kernel, at the bench shape and at
    # the encoder block's (bh=96, s=512, hd=64), with the yardstick beside
    bq, bkT, bv = enc["block_operands"]
    for name, (q_, kT_, v_) in (("bench", (fq, fkT, fv)),
                                ("block", (bq, bkT, bv))):
        bh_, s_, hd_ = q_.shape
        for causal in (False, True):
            t_lib = ms(sdpa, *sdpa_operands(q_, kT_, v_), causal)
            for cfg_ in KA.flash_configs(hd_, q_.dtype):
                fn_ = KA.build_flash_attention(bh_, s_, hd_, q_.dtype,
                                               causal=causal,
                                               block_override=cfg_)
                t_ = ms(fn_, 0, q_, kT_, v_)
                ops_ = 4 * bh_ * s_ * s_ * hd_ / (2 if causal else 1)
                print(f"  flash {name} {tuple(q_.shape)} causal={causal} "
                      f"tile={cfg_} path={fn_.path}: {t_:.4f} ms, "
                      f"{ops_ / t_ / 1e9:.1f} TFLOP/s, kernel / sdpa "
                      f"{t_ / t_lib:.3f}")
            print(f"  sdpa {name} causal={causal}: {t_lib:.4f} ms")

    # the tile configurations of the backward kernels, at the bench shape
    # and at the encoder block's, with PyTorch's fused backward beside
    for name, (q_, kT_, v_) in (("bench", (fq, fkT, fv)),
                                ("block", (bq, bkT, bv))):
        bh_, s_, hd_ = q_.shape
        dout_ = randn(bh_, s_, hd_, dtype=q_.dtype)
        for causal in (False, True):
            o_, lse_ = KA.build_flash_attention(
                bh_, s_, hd_, q_.dtype, causal=causal,
                return_lse=True)(0, q_, kT_, v_)
            delta_ = (dout_.float() * o_.float()).sum(-1, keepdim=True) \
                .expand(bh_, s_, 128)
            bargs_ = (0, q_, kT_, v_, dout_, lse_, delta_)
            for cfg_ in KA.bwd_configs(hd_, "dkv", q_.dtype):
                fn_ = KA.build_flash_attention_bwd(bh_, s_, hd_, q_.dtype,
                                                   causal=causal,
                                                   block_override=cfg_)
                print(f"  flash bwd {name} {tuple(q_.shape)} causal={causal}"
                      f" tile={cfg_} path={fn_.path}: dkv "
                      f"{ms(fn_.dkv, *bargs_):.4f} ms, dq "
                      f"{ms(fn_.dq, *bargs_):.4f} ms")
            print(f"  sdpa backward {name} causal={causal}: "
                  f"{sdpa_bwd_ms(q_, kT_, v_, dout_, causal=causal):.4f} "
                  "ms (device time)")
    # the yardstick of the backward rows once more, by device time and by
    # CUDA events around back-to-back calls (host cost included)
    call_ = sdpa_bwd(*bargs[1:5])
    print(f"  sdpa backward on the backward rows' operands: device "
          f"{sdpa_bwd_ms(*bargs[1:5]):.4f} ms per call (in the rows "
          f"{lib_bwd:.4f}); CUDA events "
          f"{ms(lambda _q: call_(), bargs[1]):.4f} ms per call")

    # the launch configurations tune=True chooses among, at the headline
    for cfg_ in K.batched_gemm_configs(m, n, k):
        print(f"  batched_gemm (rows, stages, blocks per SM)={cfg_}: "
              f"{ms(K.build_batched_gemm(desc, B, cfg_), a_u, b_u):.4f} ms")
    for rpt in K.packed_smm_configs(m):
        print(f"  packed_batched_gemm rows/thread={rpt}: "
              f"{ms(K.build_packed_batched_gemm(desc, G, rpt=rpt), ap, bp):.4f}"
              " ms")

    for r in rows:
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        cast = "".join(f"; {label} {r[key]:.4f} ms" for key, label in (
            ("rne_cast_ms", "rne cast"), ("compact_ms", "compacted form"),
            ("clone_ms", "clone of the output"),
            ("brgemm_ms", "the packed BRGEMM"), ("chunk2_ms", "chunk2"),
            ("chunk4_ms", "chunk4"), ("device_ms", "device time"),
            ("library_device_ms", "library device time"),
            ("graph_ms", "replayed from a CUDA graph"),
            ("library_graph_ms", "library replayed"), ("sol_ms", "its twin"),
            ("sol_device_ms", "twin device time"),
            ("sol_graph_ms", "twin replayed")) if key in r)
        path = f" [{r['path']}]" if "path" in r else ""
        print(f"{r['name']}{path}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms "
              f"by {r['bound_by']}; plain {r['plain_ms']:.4f} ms; library "
              f"{lib}{cast}); max_abs_err {r['max_abs_err']:.3e}"
              f"; {r['launches']} main-path launches")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
