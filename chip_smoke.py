#!/usr/bin/env python3
"""Drive libxsmm_torch's main paths on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout; it needs one CUDA device and the CUDA
toolkit's nvcc, and imports nothing of JAX or libxsmm_tpu. In order:

1. prints the card's name and power limit (nvidia-smi);
2. builds the hand-written kernels from libxsmm_torch/kernels/csrc/ with
   nvcc for sm_90a (one nvcc per source, all started together) and prints
   the build time, the spills per source and the registers and spills of
   each pipelined kernel (the bf16 flash forward and backward on wgmma,
   the BCSC scheduled and k-union SpMMs on wgmma at every instantiation,
   both SpMMs on tma_fma (f32), the packed BRGEMM's wgmma and tma_fma
   kernels and twins, the batched SMM's ring kernel, the BCSC lab's chunkN and
   dspipe probes, the BCSC densifier's two routes);
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
   - the same widths in f32, causal, batch 2; and in f32 (the config's
     default dtype) at 8 x 512, non-causal, its flash on the tma_fma route
     (route counts asserted), against float64;
   - the bf16 block seeded (dropout_p=0.1, seed=7): finite, repeatable,
     the FFN keep rate within 4 sigma of 0.9;
   - dispatch_flash_attention at bench.py's serving shape (bh=16, s=2048,
     hd=128, bf16, the wgmma kernel, asserted by launches): plain, causal,
     dropout with and without a head map, bias per head and broadcast, and
     the LSE output, one call lowered (lower_text names the wgmma entry);
     the same forms at the encoder block's (96, 512, 64) and past hd 128
     at (2, 256, 192) and (16, 1024, 256), on wgmma's 64-key tiles there
     (each route asserted by launches; one call lowered at the bench's
     shape, the block's and (16, 1024, 256)); f32 at
     (4, 1024, 64) and hd=256 at (2, 256, 256) on the tma_fma route
     (asserted by route count): through the entry point, then plain,
     causal, dropout with a head map, bias per head and broadcast, causal
     with the LSE, each against its plain version;
   - dispatch_meltw_unary(DROPOUT, BITMASK_2BYTEMULT) at the FFN shape
     4096 x 3072 and at 1000 x 1001 with x off 16-byte alignment, in
     bf16, f32 and f16, the kernel's packed mask against pack_bitmask of
     the plain mask bit for bit; without the flag (no mask) at 4096 x 3072;
   then fails unless both kernels were launched and no backward kernel
   was, and times every phase;
6. drives the block's training path the same way, with every count set to
   0 just before:
   - three train_steps at BERT-base width, bf16, flash, dropout_p=0.1,
     batch 8 x seq 512, seeds 7, 8, 9 (lr 0.1), each launching the flash
     forward, dropout and both flash-backward kernels: finite loss and
     update, the same seed giving the same update, and the served loss on
     the batch lower after the steps than before;
   - one unseeded loss_and_grads at the same width, in f32 causal at batch
     2 and in f32 at 8 x 512 (the tma_fma route, asserted), held against
     the gradients of a float64 torch composition of the same block, and
     an f32 train step at 8 x 512;
   - build_flash_attention_bwd at bench.py's serving shape and the
     encoder block's (plain, causal, dropout, bias per head with
     bias_grad, broadcast bias, dropout with a head map; bf16, the wgmma
     kernels, asserted by launches), at hd 192 and 256 ((2, 256, 192),
     (16, 1024, 256), the same forms on the wide wgmma kernels, asserted
     by launches by route and by kernel), and in f32 at (4, 1024, 64) and
     hd=256
     at (2, 256, 256) (the tma_fma kernels, asserted: dropout causal and
     not, dropout with a head map, bias per head with dbias, broadcast
     bias), each against its plain version;
   - TPP-MLP splitSGD steps at MlpConfig()'s widths: the loss falls;
   then fails unless all four kernels were launched, times every phase,
   splits one train step into forward, backward and update, and traces
   three steps with torch.profiler (device busy share, kernel time by
   name), for the bf16 block and for the f32 block at 8 x 512;
7. drives the block-sparse (BCSC) path the same way, with the five sparse
   kernels' counts set to 0 just before: create_packed_spgemm_bcsc with
   every strategy name and "auto" (which times every lowering on the card)
   at bench.py's cases, uncut: bcsc20 and bcsc05 (m = k = n = 1024, 32 x
   32 blocks at density 0.2 and 0.05, bf16 -> f32), bcsc_cluster (m = 1024,
   k = 2048, n = 1024, bf16 -> bf16, the two-family pattern); a streaming
   case (m = 32768 rows of A through the bcsc20 and bcsc05 patterns), an
   f32 case (m = 4096), the f32 streaming case at full width (m = 32768,
   the bcsc20 pattern, f32 in and out) and a ragged one (m = 1000); each
   result against the float64 dense product; the bf16 cases' "pallas",
   "super" and union strategies must take the wgmma kernels, and the f32
   cases the TMA-fed FMA kernels (the path predicate and every call's
   launch by route, asserted); "pallas", "union4" and "union" at the
   narrow bf16 blockings 16 x 64, 16 x 8 and 48 x 32 the wgmma kernels'
   16-deep slices and narrow boxes (asserted by launches, against float64
   and against the plain versions); union, union2 and union3 must
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
10. drives matrix equations through the public entry points (meqn_create,
    meqn_push_back_*, dispatch_meqn), with every count set to 0 just before
    and read just after (the trees run on torch ops: no count may change):
    the reference samples' trees at BERT-base widths, each against a
    float64 torch composition on the card: simple (a + b) * c, relu(x +
    bias) and layernorm at 4096 x 768 in f32 and bf16; relu(A @ B + bias)
    at 4096 x 768 x 3072 in f32 and bf16 -> f32; softmax at 49152 x 512
    (8 x 12 heads x 512 rows); splitSGD by UNZIP/ZIP on a 768 x 3072 f32
    weight, bit for bit against the plain update's bits; a GATHER of 4096
    rows from a 30522 x 768 table with negative and out-of-range indices
    (jnp.take's fill); a BRGEMM node over tensor sets, br 12 x (4096 x 64)
    x (64 x 3072) bf16 -> f32; an f64 tree. For each it prints the time per
    call (events), the host's time per call and the torch operators one
    call dispatches;
11. drives TPP-MoE at Switch-Base-8's widths (Fedus, Zoph and Shazeer 2021,
    google/switch-base-8: d 768, FFN 3072, 8 experts, ReLU), capacity
    factor 1.25, 8 x 512 tokens, the same way (torch ops: no count may
    change): served top-1 and top-2 in bf16 and top-1 in f32 at 2 x 512,
    each against a float64 forward with the run's own dispatch and
    combine, the routing checked on the host (each seated token's expert
    the top of its f32 gates, seats in arrival order, first choices before
    second); f32 at a capacity covering the draw against
    reference_forward; three bf16 train_steps (finite losses, the weights
    changed, the first step's gradients against float64); prints the time
    per forward and per step and the device's busy share over three steps;
12. drives the parallel layer (libxsmm_torch.parallel) at full width,
    twice. (a) In a one-rank NCCL world in this process, with every launch
    count set to 0 just before and read just after: ring and Ulysses
    attention at the flash shape (bh 16, s 2048, hd 128) in bf16 and f32,
    causal and not, forwards and gradients; DistributedBsrSpmm at bcsc20
    (m = k = 1024, 32 x 32 blocks, density 0.2, n = 1024, f32) with ring,
    ring2 and allgather, and the two-level form; the GPipe pipeline at d
    768, 8 microbatches of 512 rows, bf16 and f32, GELU: a forward, the
    gradients and three train steps that lower the loss. (b) The same
    cases in four ranks over gloo on the card (run_ranks; the pipeline's
    pp x dp and the two-level SpMM at 2 x 2, collectives staged through
    host memory). Every rank holds its outputs against the plain
    single-device composition (bf16 1e-2, f32 1e-5, gradients 1e-4 in f32
    and 5e-2 in bf16 against float64), its logged collective bytes against
    the comm models, and requires the flash forward and both backward
    kernels to have launched in it. Prints NCCL's init time, (a)'s time
    per call beside flash alone at the same shape, the overlap reports and
    (b)'s times, labelled as staged and no scaling figure; (a)'s flash
    launches join the flash rows' counts. Then, in the same two worlds,
    phase 13, the sharded models (make_sharded_train_step of each model
    on libxsmm_torch.parallel), each rank's loss and parameter blocks held
    against the single-device train step on the card from the same seed
    (bf16 1e-2 and updates 5e-2, f32 1e-5 and updates 1e-4): the TPP
    encoder block at BERT-base widths (d 768, 12 heads, FFN 3072), 8 x 512
    bf16, flash, dropout 0.1, on dp 2 x tp 2 ((a): 1 x 1), with the flash
    forward, dK/dV, dQ and dropout counts set to 0 just before its step and
    required to have moved just after, and its logged bytes equal to
    encoder_comm_bytes_per_device; TPP-MLP at MlpConfig()'s widths in f32
    and bf16 (dp 2 x tp 2), TPP-CNN at the GEMM-ext path's model (dp 4),
    TPP-GCN at Cora's widths (sp 4), TPP-MoE at Switch-Base-8 in bf16
    (einsum on dp 2 x ep 2; a2a on ep 4 against its single-device
    emulation, its all-to-all bytes against moe_a2a_comm_bytes_per_device;
    pick_moe_variant's pick), all on torch ops (no launch count may move);
    in (a) also the kernels in a block: the dropout's four dp 2 x tp 2
    blocks of the FFN's (4096, 3072) bf16 layer bit for bit against its
    plain version and together the whole mask, flash forward and backward
    with a head map against their plain versions and, bit for bit, the
    whole tensor's kernels cut to the block. Prints each step's time by
    CUDA events, (a)'s beside the single-device step, (b)'s labelled
    staged, not scaling; the encoder's flash and dropout launches join
    their rows' counts;
13. runs the labs the same way, with the five twin and probe kernels'
    counts set to 0 just before: libxsmm_torch.scripts.brgemm_lab (the
    packed BRGEMM's four variants at br = 1024, 256 x 256 x 64 bf16, each
    against its streaming twin, t_sol / t_brg printed), the packed SMM's
    passthrough twin at the headline's (4096, 32, 128) f32 (bit for bit
    against a + b; t_passthrough / t_packed_smm, bench.py:869's fraction)
    and libxsmm_torch.scripts.bcsc_lab at densities 0.2 and 0.05 (the
    union kernel's probes beside the library's strategies, held against
    float64 and their plain versions, the lab's table printed); fails
    unless all five kernels were launched;
14. holds each kernel against its plain version once more at its main-path
    shape, and times kernel, plain version and one library call computing
    the same function (a yardstick the port never calls; none exists for
    stochastic rounding, the union RHS compactor and the BRGEMM's twin,
    whose rows carry the RNE cast's, an output clone's and the BRGEMM's
    time instead; the flash backward's, reached through autograd, by its
    device time from torch.profiler), and each launch configuration the
    kernel chooses among; the passthrough's row and torch.add, the
    compactor's (with its route) and the clone of its output, and
    densify's (with its route, which must be "vector" at the streaming
    case) carry CUDA-graph replay and the host's own time per call
    beside their events; the union kernel's compacted form (compactor and
    product from one host call) is timed beside its fused form at the
    m = 1024 cases (bcsc20, bcsc05, ragged) by events, replay and host; the f32 packed BRGEMM gets a row of its own,
    with torch.mm in f32 (TF32 off) as its yardstick and its twin's
    t_sol / t_brg, by events, device time and CUDA-graph replay; the
    batched SMM's odd shape and bf16 case are held against their plain
    versions and timed beside torch.bmm; the BCSC lab's chunkN and dspipe
    probes must take the tensor cores (mma.sync) and minimal wgmma, and
    their rows carry the path, the kernel / library ratio by events,
    device time and CUDA-graph replay (minimal's library: torch.mm on its
    own panel and RHS), the staging plan and the lab's paired t /
    t(union4); the dropout row carries its byte, packed and mask-less
    forms and F.dropout, each by events, replay and the host's own time per
    call (minimal's row and its torch.mm that too), and its form on a block
    of a global tensor (block_ms); the flash rows their forms with dropout
    0.1 without and with a head map (drop_ms, head_map_ms); minimal's and
    the dropout's rows leave out the profiler's device time, which read
    minimal at under half its replayed time and the dropout below its
    bytes bound; for the six
    tensor-core rows
    (flash forward, the
    flash backward's dK/dV and dQ, the scheduled, union and supertile
    SpMM) it asserts the path and prints the achieved TFLOP/s (of the
    kernel's own products and of the useful ones) and the kernel / library
    ratio; the bf16 forward's wgmma kernel past hd 128 and the backward's
    wide wgmma kernels get rows of their own at (16, 1024, 256), the
    scheduled and union SpMMs' narrow wgmma plan at 16 x 64 blocks
    (bcsc_spmm_16x64, bcsc_spmm_union_16x64, with ptxas' registers, the
    instantiation each form launched held to wgmma_plan on a line of its
    own); the wgmma rows (flash forward, scheduled, union and supertile SpMM) carry
    device time and CUDA-graph replay beside their events, and
    the flash wgmma kernels' forms at both flash shapes, causal and not,
    come from scripts/flash_bwd_time.fwd_rows_at and rows_at beside SDPA's
    bf16 backends;
15. drives the tooling at full width: Kernel.lower_text of
    dispatch_gemm_batched_packed at the headline (16384 x 32^3 f32) and of
    dispatch_gemm_batched at the same shape (each text must name its one
    launch, its route and each entry's registers and non-empty SASS, and
    be the same twice), generator_packed_spgemm_bcsc_kernel at bcsc20
    (1024^3, 32 x 32 blocks, density 0.2, bf16 -> f32, strategy "dense":
    the densifier's launch and SASS), dump into a temporary directory, the
    manifest CLI (libxsmm_torch.utils.cli) with --bench on one batched
    gemm and the bcsc20 matrix, and the AOT warm start: the headline packed
    SMM exported into a temporary KV log (libxsmm_torch.aot), then loaded
    in a child process in a copy of the package without kernels/build/,
    with no nvcc on PATH and no toolkit under CUDA_HOME
    (libxsmm_torch.scripts.aot_warm), its result within 1e-5 of the plain
    version; prints lower_text's host time per call and the cold nvcc
    build time beside the child's time to its first result;
16. runs the samples (libxsmm_torch.samples) at their samples/
    defaults on the card, each main in this process (spmm_scaling's worlds
    and encoder's restoring process are processes of their own), with
    every launch count set to 0 just before and read just after; each must
    return 0, and the kernels each reaches must have launched: eltwise the
    dropout (its DROPOUT_INV takes the mask as a numpy array), xgemm
    --full the packed BRGEMM and stochastic rounding, smmbench the packed
    SMM, spmm (and spmm --bench) the BCSC SpMM, supertile, union,
    compactor and densifier, probe_bcsc the densifier, union and
    compactor; hello, equation, xgemm's draw, dispatch_bench, utilities,
    cnn, pyfr, spmm_scaling and encoder run to exit code 0. Prints each
    sample's wall time and its figure lines with the card's name and
    power limit; then the process-parallel runner
    (libxsmm_torch.scripts.pexec) on three commands, one passing, one
    failing and one past its 3 s timeout: exit code 2, three logs and the
    summary;
    The f32 routes get rows of their own: flash forward, dK/dV and dQ on
    tma_fma beside the plain versions and SDPA's efficient
    and math backends on f32 operands (TF32 off; each backend's normf_rel
    against float64; one past TOL_F32 / TOL_BWD_F32 is not the yardstick),
    at bench.py's serving shape and the encoder block's (96, 512, 64),
    causal and not (f32_flash_rows); the f32 scheduled, supertile and
    union SpMMs (the union in both forms) at the streaming case (m 32768)
    on tma_fma, their own products' time at the FMA peak and torch.mm in
    f32 on the densified B, and auto's f32 pick (f32_spmm_rows); the FMA
    kernels at blockings the route rule sends to them, against their
    plain versions (fma_route_checks);
17. prints one JSON line with the per-kernel numbers (twenty-five rows) and,
    last, the result line {"ok": true, "device": {...}}.

Any failure raises and exits non-zero; nothing is caught but an SDPA
backend's refusal of f32 operands ("No available kernel"), which its row
records. Without a CUDA
device it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import sys
import time

import torch

from libxsmm_torch.scripts.timing import (card, device_ms, device_split,
                                          graph_ms, host_ms)

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
TOL_MEQN_BF16 = 1e-2   # a bf16 equation tree against float64: every node
                       # rounds to bf16 (at most four roundings a tree)
TOL_F64 = 1e-12        # an f64 equation tree against its float64 composition
TOL_MOE_BF16 = 2e-2    # the bf16 MoE forward against float64 with the run's
                       # routing: hidden and expert outputs rounded to bf16
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
FLASH_KERNELS = ("flash_attention_fwd",) + BWD_KERNELS
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
# bf16 blockings of the wgmma route that are not whole 32-wide pieces, on
# the sparse path at m = 1024 (16 x 64 also at the streaming case's rows)
NARROW_BLOCKINGS = ((16, 64), (16, 8), (48, 32))
# the pipelined Hopper kernels (tensor-core, TMA- and bulk-copy-fed) and
# the densifier's two routes:
# (source stem, kernel name in the ptxas report)
MMA_KERNELS = (("gemm_kernels", "brgemm_partial_wgmma_kernel"),
               ("gemm_kernels", "brgemm_partial_tma_fma_kernel"),
               ("gemm_kernels", "batched_gemm_ring_kernel"),
               ("spmm_kernels", "bcsc_spmm_wgmma_kernel"),
               ("spmm_kernels", "bcsc_union_wgmma_kernel"),
               ("spmm_kernels", "bcsc_spmm_tma_fma_kernel"),
               ("spmm_kernels", "bcsc_union_tma_fma_kernel"),
               ("attention_kernels", "flash_fwd_wgmma_kernel"),
               ("attention_bwd_kernels", "flash_bwd_dkv_wgmma_kernel"),
               ("attention_bwd_kernels", "flash_bwd_dq_wgmma_kernel"),
               ("attention_bwd_kernels", "flash_bwd_dkv_wgmma_wide_kernel"),
               ("attention_bwd_kernels", "flash_bwd_dq_wgmma_wide_kernel"),
               ("attention_kernels", "flash_fwd_tma_fma_kernel"),
               ("attention_bwd_kernels", "flash_bwd_dkv_tma_fma_kernel"),
               ("attention_bwd_kernels", "flash_bwd_dq_tma_fma_kernel"),
               ("spmm_lab_kernels", "bcsc_lab_chunk_kernel"),
               ("spmm_lab_kernels", "bcsc_lab_dspipe_kernel"),
               ("spmm_lab_kernels", "bcsc_lab_minimal_wgmma_kernel"),
               ("eltwise_kernels", "dropout"),
               ("spmm_kernels", "bcsc_densify_kernel"))


# outputs past this many elements are held on the card (_check)
_ON_CARD = 1 << 22


def _check(name, ref, out, margin, shape=None):
    """Hold `out` (a tensor or a tuple of them) against `ref`: shape,
    finiteness, then matdiff within `margin` (0: bit-exact). Returns the
    largest normf_rel. Past _ON_CARD elements of a CUDA output, matdiff's
    verdict is computed on the card in float64 (its normf_rel, the
    Frobenius norm of the difference, equal pairs 0, over the reference's,
    and its linf_abs; check's rule: either within the margin): matdiff
    copies both operands to the host and takes seconds there at the
    streaming SpMM's 32768 x 1024."""
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
    if not (out.is_cuda and out.numel() > _ON_CARD):
        return check(ref, out, margin=margin).normf_rel
    r = torch.as_tensor(ref, device=out.device).double()
    t_ = out.double()
    if tuple(r.shape) != tuple(t_.shape):
        raise AssertionError(f"{name}: shape {tuple(t_.shape)} against the "
                             f"reference's {tuple(r.shape)}")
    if not bool(torch.isfinite(r).all()):
        raise AssertionError(f"{name}: non-finite values in the reference")
    diff = torch.where(t_ == r, 0.0, t_ - r)
    fro_ref = float(torch.linalg.vector_norm(r))
    fro_diff = float(torch.linalg.vector_norm(diff))
    normf = fro_diff / fro_ref if fro_ref > 0 else fro_diff
    linf = float(diff.abs().max())
    if not (normf <= margin or linf <= margin):
        raise AssertionError(f"{name}: normf_rel={normf:.3e} linf_abs="
                             f"{linf:.3e} (margin {margin:.1e}), on the card")
    return normf


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


def _f32_flash_forms(bh, bias):
    """The f32 flash forms held against their plain versions on the
    tma_fma route: (name, factory keywords, bias operand)."""
    return [("plain", {}, None), ("causal", {"causal": True}, None),
            ("dropout head map", {"dropout_p": 0.1,
                                  "head_map": (1, 1, bh, bh + 2)}, None),
            ("bias per head", {"bias_bh": bh}, bias),
            ("bias broadcast", {"bias_bh": 1}, bias[:1]),
            ("causal lse", {"causal": True, "return_lse": True}, None)]


def _routes(mod=None):
    """A kernel module's launch counts by route (a copy); the flash
    kernels' unless `mod` is given."""
    if mod is None:
        from libxsmm_torch.kernels import attention as mod
    return {k: dict(v) for k, v in mod.path_launches.items()}


def _bwd_kernel_counts():
    """The flash backward's launch counts by CUDA kernel (a copy)."""
    from libxsmm_torch.kernels import attention as KA
    return dict(KA.kernel_launches)


def _took_route(name, before, kernels, route, mod=None):
    """Fail unless each of `kernels` launched on `route`, and on no other
    route, since the snapshot `before` (of `mod`'s counts)."""
    now = _routes(mod)
    for k in kernels:
        moved = {r: now[k][r] - before[k][r] for r in now[k]
                 if now[k][r] != before[k][r]}
        if set(moved) != {route}:
            raise AssertionError(f"{name}: {k} launched by route {moved}, "
                                 f"expected {route} alone")


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

        # the f32 block at full width: BERT-base, 8 x 512, AttentionConfig's
        # default dtype (f32), non-causal; its flash on the tma_fma route
        cfg_f32 = TA.AttentionConfig(dim=768, heads=12, flash=True)
        block_f32 = TA.EncoderBlock(cfg_f32, init_seed=2, device=dev)
        x_f32 = randn(8, 512, 768)
        routes0 = _routes()
        y_f32 = run("block bert-base f32 serve 8x512",
                    ["flash_attention_fwd"], block_f32, x_f32)
        _took_route("block f32 8x512", routes0, ("flash_attention_fwd",),
                    "tma_fma")
        e64 = _check("block f32 8x512 vs float64", block64(block_f32, x_f32),
                     y_f32, TOL_BLOCK_F32, (8, 512, 768))
        print(f"  block f32 8x512 (tma_fma): normf_rel vs float64 {e64:.3e}")

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
    # bf16 takes the wgmma kernel at every hd, aligned f32 the TMA-fed FMA
    # kernel, by dtype alone
    for dt, hd_, want in ((bf16, hd, "wgmma"), (bf16, 64, "wgmma"),
                          (bf16, 192, "wgmma"), (bf16, 256, "wgmma"),
                          (f32, hd, "tma_fma")):
        if KA.flash_path(dt, hd_) != want:
            raise AssertionError(f"flash {dt} hd {hd_}: path "
                                 f"{KA.flash_path(dt, hd_)}, expected {want}")
    # the bench's shape through the entry point; then every form at the
    # block's (96, 512, 64) and past hd 128 (64-key tiles: buckets 192 and
    # 256), each against its plain version, its route asserted by
    # launches
    for name, kw, call in (
            ("plain", {}, {}), ("causal", {"causal": True}, {}),
            ("dropout", {"dropout_p": 0.1}, {"seed": 5}),
            ("dropout head map", {"dropout_p": 0.1,
                                  "head_map": (1, 1, bh, bh + 2)},
             {"seed": 5}),
            ("bias per head", {"bias_bh": bh}, {"bias": bias_h}),
            ("bias broadcast", {"bias_bh": 1}, {"bias": bias_1})):
        kern = xt.dispatch_flash_attention(bh, s, hd, Datatype.BF16, **kw)
        routes0 = _routes()
        out = run(f"flash {name} bf16 {bh}x{s}x{hd}", ["flash_attention_fwd"],
                  lambda a, b, c, kern=kern, call=call: kern(a, b, c, **call),
                  q, kT, v)
        _took_route(f"flash {name} bf16 {bh}x{s}x{hd}", routes0,
                    ("flash_attention_fwd",), "wgmma")
        plain = KA.build_flash_attention(bh, s, hd, bf16, **kw).plain(
            call.get("seed", 0), q, kT, v, call.get("bias"))
        _check(f"flash {name} vs plain", plain, out, TOL_BF16_OUT,
               (bh, s, hd))
    _lowered_flash(KA.build_flash_attention(bh, s, hd, bf16), (5, q, kT, v),
                   ("flash_attention_fwd",))
    lse_fn = KA.build_flash_attention(bh, s, hd, bf16, return_lse=True)
    routes0 = _routes()
    got = run(f"flash lse bf16 {bh}x{s}x{hd}", ["flash_attention_fwd"],
              lse_fn, 0, q, kT, v)
    _took_route(f"flash lse bf16 {bh}x{s}x{hd}", routes0,
                ("flash_attention_fwd",), "wgmma")
    want = lse_fn.plain(0, q, kT, v)
    _check("flash lse: out vs plain", want[0], got[0], TOL_BF16_OUT)
    _check("flash lse: lse vs plain", want[1], got[1], TOL_F32,
           (bh, s, 128))
    for fbh, fs, fhd, route in ((96, 512, 64, "wgmma"),
                                (2, 256, 192, "wgmma"),
                                (16, 1024, 256, "wgmma")):
        fq = randn(fbh, fs, fhd, dtype=bf16)
        fkT, fv = randn(fbh, fhd, fs, dtype=bf16), randn(fbh, fs, fhd,
                                                           dtype=bf16)
        fb = randn(fbh, fs, fs, scale=0.5)
        forms = [("plain", {}, None), ("causal", {"causal": True}, None),
                 ("dropout", {"dropout_p": 0.1}, None)]
        forms += _f32_flash_forms(fbh, fb)[2:]
        for name, kw, fbias in forms:
            fn = KA.build_flash_attention(fbh, fs, fhd, bf16, **kw)
            tag = f"flash {name} bf16 {fbh}x{fs}x{fhd}"
            if fn.path != route:
                raise AssertionError(f"{tag} took {fn.path}")
            routes0 = _routes()
            got = run(tag, ["flash_attention_fwd"],
                      lambda a, b_, c, fn=fn, fbias=fbias: fn(5, a, b_, c,
                                                              fbias),
                      fq, fkT, fv)
            _took_route(tag, routes0, ("flash_attention_fwd",), route)
            _check(f"{tag} vs plain", fn.plain(5, fq, fkT, fv, fbias), got,
                   TOL_BF16_OUT)
            if name == "plain" and fhd != 192:   # hd 64 and 256 lowered
                _lowered_flash(fn, (5, fq, fkT, fv), ("flash_attention_fwd",))
    # f32 on the tma_fma route (asserted by route count): through the entry
    # point, then every form against the plain version, hd up to 256
    for fbh, fs, fhd in ((4, 1024, 64), (2, 256, 256)):
        fq, fv = randn(fbh, fs, fhd), randn(fbh, fs, fhd)
        fkT = randn(fbh, fhd, fs)
        kern = xt.dispatch_flash_attention(fbh, fs, fhd, Datatype.F32)
        routes0 = _routes()
        out = run(f"flash f32 {fbh}x{fs}x{fhd}", ["flash_attention_fwd"],
                  kern, fq, fkT, fv)
        _took_route(f"flash f32 {fbh}x{fs}x{fhd}", routes0,
                    ("flash_attention_fwd",), "tma_fma")
        _check(f"flash f32 {fbh}x{fs}x{fhd} vs plain",
               KA.build_flash_attention(fbh, fs, fhd, f32).plain(
                   0, fq, fkT, fv), out, TOL_F32, (fbh, fs, fhd))
        fb = randn(fbh, fs, fs, scale=0.5)
        for name, kw, bias in _f32_flash_forms(fbh, fb):
            fn = KA.build_flash_attention(fbh, fs, fhd, f32, **kw)
            got = run(f"flash f32 {name} {fbh}x{fs}x{fhd}",
                      ["flash_attention_fwd"],
                      lambda a, b_, c, fn=fn, bias=bias: fn(5, a, b_, c,
                                                            bias),
                      fq, fkT, fv)
            if fn.path != "tma_fma":
                raise AssertionError(f"flash f32 {name} took {fn.path}")
            _check(f"flash f32 {name} {fbh}x{fs}x{fhd} vs plain",
                   fn.plain(5, fq, fkT, fv, bias), got, TOL_F32)

    # dispatch_meltw_unary(DROPOUT) with the packed bitmask, which the
    # kernel writes, at the FFN shape, then at a ragged n (not a multiple of
    # 16) with x off 16-byte alignment; without the flag, out alone. Each
    # phase's time per call through the entry point is printed with the
    # path's phases
    m, n = 8 * 512, 3072
    for dt, dtn in ((bf16, "BF16"), (f32, "F32"), (torch.float16, "F16")):
        for rows, cols, off in ((m, n, 0), (1000, 1001, 1)):
            kern = xt.dispatch_meltw_unary(
                UnaryType.DROPOUT, rows, cols, UnaryFlags.BITMASK_2BYTEMULT,
                in_type=Datatype[dtn], extra=(0.1,))
            xd = randn(rows * cols + off, dtype=dt)[off:].view(rows, cols)
            if bool(xd.data_ptr() % 16) != bool(off):
                raise AssertionError("meltw dropout: operand alignment")
            tag = f"{dtn.lower()} {rows}x{cols}" + (" unaligned" if off
                                                   else "")
            out, packed = run(f"meltw dropout {tag}", ["dropout"], kern, xd,
                              7)
            want_out, want_mask = KE.dropout.plain(xd, 7, 0.1)
            _check(f"meltw dropout {tag}: out vs plain", want_out, out,
                   TOL_EXACT, (rows, cols))
            _check(f"meltw dropout {tag}: packed mask vs "
                   f"pack_bitmask(plain)", xt.pack_bitmask(want_mask != 0),
                   packed, TOL_EXACT, (rows, (cols + 15) // 16 * 2))
        bare = xt.dispatch_meltw_unary(UnaryType.DROPOUT, m, n,
                                       in_type=Datatype[dtn], extra=(0.1,))
        xd = randn(m, n, dtype=dt)
        out = run(f"meltw dropout {dtn.lower()} {m}x{n} no mask",
                  ["dropout"], bare, xd, 7)
        _check(f"meltw dropout {dtn} no mask: out vs plain",
               KE.dropout.plain(xd, 7, 0.1)[0], out, TOL_EXACT, (m, n))

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
    return {"phases": phases, "counts": counts, "routes": _routes(),
            "kernels": _bwd_kernel_counts(),
            "flash_operands": (q, kT, v), "block_operands": block_ops,
            "dropout_operand": randn(m, n, dtype=bf16),
            "block": (block, x),
            "block_f32": (block_f32, x_f32,
                          tuple(randn(*sh) for sh in ((96, 512, 64),
                                                      (96, 64, 512),
                                                      (96, 512, 64))))}


def _lowered_flash(fn, args, counters=BWD_KERNELS):
    """lower_text of one flash call (the forward, or the backward's two
    kernels) on the card: each counter launched once on the route the
    object names, and under each exactly one entry, an instantiation of
    that route's kernel."""
    import re
    import types

    from libxsmm_torch import lowering

    class Lowered:   # what lower_text reads of a kernel
        name, descriptor = fn.name, None
        info = types.SimpleNamespace(kind="flash_attention_bwd"
                                     if counters == BWD_KERNELS
                                     else counters[0])

        def __call__(self, *a):
            return fn(*a)

    text = lowering.lower_text(Lowered(), args)
    launches = re.findall(r"^// launch (\w+) x(\d+): route cuda (\w+) x1,",
                          text, re.M)
    want = [(k, "1", fn.path) for k in counters]
    entries = [lowering.kernel_of(e) for e in
               re.findall(r"^// entry (\S+) x1:", text, re.M)]
    names = [fn.kernels[k.rsplit('_', 1)[1]] if k in BWD_KERNELS
             else f"flash_fwd_{fn.path}_kernel" for k in counters]
    if sorted(launches) != want or sorted(entries) != sorted(names):
        raise AssertionError(f"lower_text of {fn.name}: launches {launches}"
                             f", entries {entries}; want {want}, {names}")
    print(f"  lower_text {fn.name}: {', '.join(entries)}")


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
    # the f32 block at full width (BERT-base, 8 x 512, the default f32,
    # non-causal, no dropout): gradients against float64 and one train
    # step, its flash kernels on the tma_fma route
    cfg_f32 = TA.AttentionConfig(dim=768, heads=12, flash=True)
    params_f32 = TA.init_params(cfg_f32, seed=2, device=dev)
    xf, yf = randn(8, 512, 768), randn(8, 512, 768)
    routes0 = _routes()
    _, gf = run("loss_and_grads bert-base f32 8x512",
                ("flash_attention_fwd",) + BWD_KERNELS, TA.loss_and_grads,
                params_f32, xf, yf, cfg_f32)
    _took_route("f32 8x512 gradients", routes0, FLASH_KERNELS, "tma_fma")
    finite("f32 gradients", gf)
    hold("block f32 8x512 gradients", grads64(params_f32, xf, yf,
                                              cfg_f32)[1], gf, TOL_GRAD_F32)
    new_f32, loss_f32 = run("train step bert-base f32 8x512", FLASH_KERNELS,
                            TA.train_step, params_f32, xf, yf, cfg_f32,
                            TRAIN_LR, 7)
    finite("f32 train step", {"loss": loss_f32, **new_f32})
    if all(torch.equal(new_f32[k], params_f32[k]) for k in new_f32):
        raise AssertionError("f32 train step: no parameter changed")
    print(f"  train step bert-base f32 8x512: loss {loss_f32.item():.6f}")

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

    # bf16 at the bench's shape and the encoder block's (96, 512, 64), and
    # at hd 192 and 256 (the wide kernels), every form on the wgmma route
    # (the launches counted by route and by kernel); one call of each shape
    # lowered: lower_text names the entries of the kernels that ran
    ops, route = {}, "wgmma"
    for bh, s, hd in ((16, 2048, 128), (96, 512, 64), (2, 256, 192),
                      (16, 1024, 256)):
        cases = [("plain", {}, None), ("causal", {"causal": True}, None),
                 ("dropout", {"dropout_p": 0.1}, None),
                 ("bias per head + grad", {"bias_bh": bh, "bias_grad": True},
                  randn(bh, s, s, scale=0.5)),
                 ("bias broadcast", {"bias_bh": 1},
                  randn(1, s, s, scale=0.5)),
                 ("dropout head map", {"dropout_p": 0.1,
                                       "head_map": (1, 1, bh, bh + 2)},
                  None)]
        for name, kw, bias in cases:
            args = bwd_operands(bh, s, hd, bf16, kw, bias)
            fn = KA.build_flash_attention_bwd(bh, s, hd, bf16, **kw)
            if fn.path != route:
                raise AssertionError(f"flash bwd {name} bf16 {bh}x{s}x{hd} "
                                     f"took {fn.path}")
            routes0 = _routes()
            kern0 = _bwd_kernel_counts()
            got = run(f"flash bwd {name} bf16 {bh}x{s}x{hd}", BWD_KERNELS,
                      fn, *args)
            _took_route(f"flash bwd {name} bf16 {bh}x{s}x{hd}", routes0,
                        BWD_KERNELS, route)
            moved = {k: n - kern0[k] for k, n in KA.kernel_launches.items()
                     if n != kern0[k]}
            if moved != {fn.kernels["dkv"]: 1, fn.kernels["dq"]: 1}:
                raise AssertionError(f"flash bwd {name} bf16 {bh}x{s}x{hd}"
                                     f" launched {moved}, expected "
                                     f"{fn.kernels}")
            _check(f"flash bwd {name} {bh}x{s}x{hd} vs plain",
                   fn.plain(*args), got, TOL_BF16_OUT)
            if name == "plain":
                _lowered_flash(fn, args)
            # the rows' operands: the bench shape's, the hd-256 shape's
            if name == "plain":
                ops[hd] = args
    for fbh, fs, fhd in ((4, 1024, 64), (2, 256, 256)):
        fb = randn(fbh, fs, fs, scale=0.5)
        forms = [(f"causal={c} dropout", {"causal": c, "dropout_p": 0.1},
                  None) for c in (False, True)]
        forms += [(name, dict(kw, bias_grad=kw.get("bias_bh") == fbh), bias)
                  for name, kw, bias in _f32_flash_forms(fbh, fb)
                  if "return_lse" not in kw]
        for name, kw, bias in forms:
            args = bwd_operands(fbh, fs, fhd, f32, kw, bias)
            fn = KA.build_flash_attention_bwd(fbh, fs, fhd, f32, **kw)
            got = run(f"flash bwd f32 {name} {fbh}x{fs}x{fhd}", BWD_KERNELS,
                      fn, *args)
            if fn.path != "tma_fma":
                raise AssertionError(f"flash bwd f32 {name} took {fn.path}")
            _check(f"flash bwd f32 {name} {fbh}x{fs}x{fhd} vs plain",
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
    return {"phases": phases, "counts": counts, "routes": _routes(),
            "kernels": _bwd_kernel_counts(),
            "bwd_operands": ops[128], "bwd_operands_wide": ops[256],
            "step": (params, x, y, cfg),
            "step_f32": (params_f32, xf, yf, cfg_f32)}


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
    case, an f32 case at m 4096 and the f32 streaming case at full width
    (m 32768), each against the float64 dense product, each SpMM call held
    to its route (bf16 at 32 x 32: wgmma; f32: tma_fma), and the scheduled
    and union kernels at the narrow bf16 blockings (NARROW_BLOCKINGS: the
    wgmma route's 16-deep slices and narrow value boxes, the union in both
    forms). Returns the phases (to time), the counts, the launches by route
    (all, and the f32 cases'), the narrow blockings' launches, auto's picks
    and the streaming operands the per-kernel rows reuse."""
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
        float64 product with the densified B (plain version: no launch),
        each SpMM kernel's launch on the route its operands take. Returns
        auto's pick."""
        dense_b = KS.build_bcsc_densify(shape, cfg, indptr, indices,
                                        dev).plain(v)
        want = a.double() @ dense_b.double()
        # bf16 operands at 32 x 32 blocks take the wgmma kernels for the
        # scheduled ("pallas"), supertile ("super") and union strategies;
        # f32 the TMA-fed FMA kernels
        bf = a.dtype == bf16
        path = dict.fromkeys(("bcsc_spmm", "bcsc_spmm_super",
                              "bcsc_spmm_union"),
                             "wgmma" if bf else "tma_fma")
        for counter, bk_, bn_, union in (
                ("bcsc_spmm", cfg.bk, cfg.bn, False),
                ("bcsc_spmm_super", KS.SUPER, KS.SUPER, False),
                ("bcsc_spmm_union", cfg.bk, cfg.bn, True)):
            if KS.spmm_path(a.dtype, bk_, bn_, union) != path[counter]:
                raise AssertionError(
                    f"bcsc {case}: {bk_}x{bn_} blocks take "
                    f"{KS.spmm_path(a.dtype, bk_, bn_, union)}"
                    f"{' in the union' if union else ''}, expected "
                    f"{path[counter]}")
        union_path = KS.build_bcsc_spmm_union(shape, cfg, indptr, indices,
                                              dev).path
        if union_path != path["bcsc_spmm_union"]:
            raise AssertionError(f"bcsc {case}: the union takes "
                                 f"{union_path}, expected "
                                 f"{path['bcsc_spmm_union']}")
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
            routes = _routes(KS)
            out = run(f"bcsc {case} {s}", kernels, kern, a, v)
            if (got not in COMPACTED
                    and _count("bcsc_union_compact") != compactions):
                raise AssertionError(f"bcsc {case} {s}: the compactor ran "
                                     f"for {got}")
            for k_ in kernels:
                if k_ in KS.path_launches:
                    _took_route(f"bcsc {case} {s}", routes, [k_], path[k_],
                                KS)
            worst = max(worst, _check(f"bcsc {case} {s} vs float64", want,
                                      out, tol, (shape.m, shape.n)))
            if s == "auto":
                pick = kern.name
        print(f"  bcsc {case} ({shape.m}x{shape.n}x{shape.k}, "
              f"{len(indices)} blocks of {cfg.bk}x{cfg.bn}): "
              f"{len(STRATEGIES) + 1} strategies, worst normf_rel vs "
              f"float64 {worst:.3e}; pallas/super/union paths "
              f"{'/'.join(path.values())}; auto -> {pick}")
        return pick

    KS.reset_launches()
    t_path = time.perf_counter()
    # bench.py's bcsc20 and bcsc05 (bench.py:691-707), uncut: m = k = n =
    # 1024, 32 x 32 blocks, bf16 in, f32 out, pattern from default_rng(2)
    bk = bn = 32
    cfg = SpgemmConfig(1, bk, bn)
    m = k = n = 1024
    pats = {}
    small = {}    # the m ~ 1024 cases the union's two forms are timed at
    for case, density in (("bcsc20", 0.2), ("bcsc05", 0.05)):
        rng = np.random.default_rng(2)
        bcsc = _bcsc_pattern(rng, k, n, bk, bn, density)
        v = on_dev(bcsc.data, bf16)
        a0 = on_dev(rng.standard_normal((m, k)), bf16)
        shape = GemmShape(m, n, k, BF16, BF16, F32)
        drive(case, shape, cfg, bcsc.indptr, bcsc.indices, a0, v,
              TOL_SPARSE_BF16)
        pats[density] = (bcsc, v)
        small[case] = (shape, bcsc, a0, v)

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

    # f32 in and out at m = 4096 on the bcsc20 pattern, then at full width:
    # stream20 (m 32768, k = n = 1024, 32 x 32 blocks at density 0.2, the
    # pattern from default_rng(2)) in f32, A 128 MiB
    bcsc, _ = pats[0.2]
    f32_counts, picks = {}, {}
    for case, rows_ in (("f32", 4096), ("f32 stream20", ms_rows)):
        before = _routes(KS)
        picks[case] = drive(case, GemmShape(rows_, n, k), cfg, bcsc.indptr,
                            bcsc.indices, randn(rows_, k),
                            on_dev(bcsc.data, f32), TOL_SPARSE_F32)
        now = _routes(KS)
        f32_counts[rows_] = {k_: {r: now[k_][r] - before[k_][r]
                                  for r in now[k_]} for k_ in now}

    # bf16 at the narrow blockings, the bcsc20 pattern's density from
    # default_rng(2): 16 x 64, 16 x 8 and 48 x 32 blocks (k 1008 at bk 48),
    # the scheduled and union SpMMs (both forms) on the wgmma route's
    # 16-deep slices, held against float64 and against their plain
    # versions, the route asserted by launches; their launches by blocking
    narrow = {}
    for nbk, nbn in NARROW_BLOCKINGS:
        tag = f"bcsc {nbk}x{nbn}"
        nk = k - k % nbk
        rng = np.random.default_rng(2)
        bnar = _bcsc_pattern(rng, nk, n, nbk, nbn, 0.2)
        anar = on_dev(rng.standard_normal((m, nk)), bf16)
        vnar = on_dev(bnar.data, bf16)
        snar = GemmShape(m, n, nk, BF16, BF16, F32)
        cfgn = SpgemmConfig(1, nbk, nbn)
        for union in (False, True):
            if KS.spmm_path(bf16, nbk, nbn, union) != "wgmma":
                raise AssertionError(
                    f"{tag}: the {'union' if union else 'scheduled'} SpMM "
                    f"takes {KS.spmm_path(bf16, nbk, nbn, union)}")
        dnar = KS.build_bcsc_densify(snar, cfgn, bnar.indptr, bnar.indices,
                                     dev).plain(vnar)
        want = anar.double() @ dnar.double()
        before = {c: _count(c) for c in ("bcsc_spmm", "bcsc_spmm_union")}
        for strat in ("pallas", "union4", "union"):
            kern = xt.create_packed_spgemm_bcsc(
                snar, GemmFlags.BETA_0, cfgn, bnar.indptr, bnar.indices,
                strategy=strat)
            if kern.name.split("_")[3] != strat:
                raise AssertionError(f"{tag} {strat}: built {kern.name}")
            counter = "bcsc_spmm" if strat == "pallas" else "bcsc_spmm_union"
            kernels = (counter,) + (
                ("bcsc_union_compact",) if strat in COMPACTED else ())
            routes = _routes(KS)
            got = run(f"{tag} {strat}", kernels, kern, anar, vnar)
            _took_route(f"{tag} {strat}", routes, [counter], "wgmma", KS)
            err = _check(f"{tag} {strat} vs float64", want, got,
                         TOL_SPARSE_BF16, (m, n))
            plain = (KS.build_bcsc_spmm(snar, cfgn, bnar.indptr,
                                        bnar.indices, dev)
                     if strat == "pallas" else
                     KS.build_bcsc_spmm_union(snar, cfgn, bnar.indptr,
                                              bnar.indices, dev,
                                              compact=strat == "union"))
            perr = _check(f"{tag} {strat} vs plain", plain.plain(anar, vnar),
                          got, TOL_SPARSE_BF16, (m, n))
            print(f"  {tag} ({m}x{n}x{nk}, {bnar.nblocks} blocks) {strat} "
                  f"[wgmma]: normf_rel vs float64 {err:.3e}, vs plain "
                  f"{perr:.3e}")
        narrow[(nbk, nbn)] = {c: _count(c) - before[c] for c in before}

    # ragged: 1000 rows (the last 64-row tile cut) through bcsc05
    bcsc, v = pats[0.05]
    rshape, ra = GemmShape(1000, n, k, BF16, BF16, F32), randn(1000, k,
                                                               dtype=bf16)
    drive("ragged", rshape, cfg, bcsc.indptr, bcsc.indices, ra, v,
          TOL_SPARSE_BF16)
    small["ragged"] = (rshape, bcsc, ra, v)

    torch.cuda.synchronize()
    counts = dict(KS.launches)
    print(f"sparse path: {len(phases)} phases in "
          f"{time.perf_counter() - t_path:.2f} s, kernel launches {counts}")
    missing = [k_ for k_ in SPARSE_KERNELS if counts[k_] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the sparse path: "
                             f"{missing}")
    bcsc, v = pats[0.2]
    return {"phases": phases, "counts": counts, "f32_counts": f32_counts,
            "routes": _routes(KS), "auto": picks, "narrow": narrow,
            "stream": (sshape, cfg, bcsc, a_stream, v), "small": small}


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
    nodes, edges = CORA
    adj = _cora_adjacency(rng)
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


CORA = (2708, 5278)     # Cora's nodes and undirected edges


def _cora_adjacency(rng):
    """A seeded random symmetric graph with Cora's nodes and edges (Kipf
    & Welling 2017), dense f32."""
    import numpy as np
    nodes, edges = CORA
    pairs = set()
    while len(pairs) < edges:
        i, j = (int(x) for x in rng.integers(0, nodes, 2))
        if i != j:
            pairs.add((min(i, j), max(i, j)))
    adj = np.zeros((nodes, nodes), np.float32)
    ij = np.asarray(sorted(pairs))
    adj[ij[:, 0], ij[:, 1]] = adj[ij[:, 1], ij[:, 0]] = 1.0
    return adj


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


def _regs(kernel, args):
    """[registers, spill store bytes, spill load bytes] of the one
    instantiation of spmm_kernels.cu's `kernel` whose mangled template
    arguments hold `args`, from this process's build (None when the
    library was built before it)."""
    from libxsmm_torch.kernels import _build
    found = [list(r[1:]) for r in _build.kernel_resources("spmm_kernels",
                                                           kernel)
             if args in r[0]]
    return found[0] if len(found) == 1 else None


def _launched_plan(label, fn, args, bk, bn, union=False, compact=False):
    """Call `fn` once between two reads of the libraries' launch logs and
    hold the wgmma instantiation it launched to kernels.spmm.wgmma_plan's
    tile at the blocking (the scheduled kernel's TN and KC; the union's
    KC, box and pair width, and its form); print the plan and the entry
    on a line of their own. Raises unless exactly that one instantiation
    ran."""
    from libxsmm_torch import lowering
    from libxsmm_torch.kernels import _build
    from libxsmm_torch.kernels import spmm as KS
    plan = KS.wgmma_plan(bk, bn, union=union, compact=compact)
    torch.cuda.synchronize()
    before = _build.launch_log()
    fn(*args)
    torch.cuda.synchronize()
    ran = [e for e in lowering.launched_entries(
        before, _build.launch_log()).get("spmm_kernels", {}) if "wgmma" in e]
    if union:
        want = (f"bcsc_union_wgmma_kernelIfLi{plan['kc']}ELi{plan['box']}E"
                f"Li{32 if bn % 32 == 0 else 8}ELb{int(compact)}E")
    else:
        want = f"bcsc_spmm_wgmma_kernelIfLi{plan['tn']}ELi{plan['kc']}E"
    if len(ran) != 1 or want not in ran[0]:
        raise AssertionError(f"{label}: launched {ran}, the plan names "
                             f"{want}")
    print(f"  {label} wgmma plan {json.dumps(plan)}, launched {ran[0]}")


def mma_rate(row, flops, useful):
    """Print a tensor-core kernel's achieved rate (its own products and the
    useful ones, over its time in this run) and its ratio to the library
    call timed beside it; keep the rate in the row."""
    row["tflops"] = flops / row["ms"] / 1e9
    print(f"  {row['name']}: {row['tflops']:.1f} TFLOP/s of its own "
          f"products, {useful / row['ms'] / 1e9:.1f} TFLOP/s useful; "
          f"kernel / library {row['ms'] / row['library_ms']:.3f}")


def sparse_rows(record, rows, stream, small, ms, geo, routes, narrow):
    """The five sparse kernels at the streaming case, each against its
    plain version; the scheduled, supertile and union SpMMs on their wgmma
    route (device time and CUDA-graph replay beside events, launches: the
    path's on that route) and the scheduled and union SpMMs once more at
    16 x 64 blocks, the wgmma route's narrow plan ("bcsc_spmm_16x64",
    "bcsc_spmm_union_16x64", the union's compacted form as compact_ms;
    launches: the path's 16 x 64 cases; `regs`: ptxas' registers and spill
    bytes of the instantiation that ran, from this process's build; the
    instantiation each 16 x 64 form launches, read from the launch log,
    held to kernels.spmm.wgmma_plan and printed with it). Bound:
    A, the kernel's value operand and C each moved once, and the useful
    products 2 * nblocks * bk * bn * m at the bf16 tensor cores' peak.
    Yardstick for the SpMM kernels: torch.mm on the densified B with an
    f32 output; for densify: PyTorch's BSC tensor
    to_dense. The union row carries the compacted form's time (compactor,
    then the kernel over its RHS) as "compact_ms"; the compactor's row
    moves the value store once and writes the compacted RHS once, and since
    no PyTorch call computes the compaction its library time is null and a
    clone of the compacted RHS (the same bytes written) stands beside it as
    "clone_ms". The compactor's row, its clone and densify's row carry
    CUDA-graph replay and the host's own time a call beside their events;
    the compactor's and densify's rows their routes (bulk and vector at
    this case, or it fails). At the m ~ 1024 cases (`small`:
    bcsc20, bcsc05, ragged) the compacted form is held against the fused
    form and both are timed by events, replay and host."""
    import numpy as np

    from libxsmm_torch.descriptor import SpgemmConfig
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
    if sched.path != "wgmma":
        raise AssertionError(f"bcsc_spmm at the streaming case took "
                             f"{sched.path}")
    record("bcsc_spmm", src, "libxsmm_tpu/kernels/spmm_pallas.py:88",
           sched, (a, v), TOL_SPARSE_BF16, io + 2 * v.numel(), useful, peak,
           lib_mm, path=sched.path, graph_ms=graph_ms(lambda: sched(a, v)),
           device_ms=device_ms(lambda: sched(a, v)),
           launches=routes["bcsc_spmm"]["wgmma"])
    mma_rate(rows[-1], useful, useful)
    # the scheduled kernel's narrow plan, at 16 x 64 blocks of the same
    # density through the same A (its pattern from default_rng(2)), beside
    # torch.mm on its densified B; launches: the path's 16 x 64 case
    b16 = _bcsc_pattern(np.random.default_rng(2), k, n, 16, 64, 0.2)
    cfg16 = SpgemmConfig(1, 16, 64)
    v16 = torch.as_tensor(b16.data, device=dev).to(torch.bfloat16)
    s16 = KS.build_bcsc_spmm(shape, cfg16, b16.indptr, b16.indices, dev)
    if s16.path != "wgmma":
        raise AssertionError(f"bcsc_spmm at 16 x 64 took {s16.path}")
    d16 = KS.build_bcsc_densify(shape, cfg16, b16.indptr, b16.indices,
                                dev).plain(v16)
    useful16 = 2 * b16.nblocks * 16 * 64 * m
    lib16 = ms(lambda x, y: torch.mm(x, y, out_dtype=torch.float32), a, d16)
    record("bcsc_spmm", src, "libxsmm_tpu/kernels/spmm_pallas.py:88", s16,
           (a, v16), TOL_SPARSE_BF16, io + 2 * v16.numel(), useful16, peak,
           lib16, path=s16.path, shape=[m, n, k, 16, 64],
           regs=_regs("bcsc_spmm_wgmma_kernel", "IfLi64ELi16E"),
           device_ms=device_ms(lambda: s16(a, v16)))
    rows[-1].update(name="bcsc_spmm_16x64",
                    launches=narrow[(16, 64)]["bcsc_spmm"])
    _launched_plan("bcsc_spmm_16x64", s16, (a, v16), 16, 64)
    mma_rate(rows[-1], useful16, useful16)
    union = KS.build_bcsc_spmm_union(shape, cfg, indptr, indices, dev)
    union_c = KS.build_bcsc_spmm_union(shape, cfg, indptr, indices, dev,
                                       compact=True)
    if (union.path, union_c.path) != ("wgmma", "wgmma"):
        raise AssertionError(f"bcsc_spmm_union at the streaming case took "
                             f"{union.path} / {union_c.path}")
    _check("bcsc_spmm_union compacted form vs fused form", union(a, v),
           union_c(a, v), TOL_SPARSE_BF16)
    record("bcsc_spmm_union", src, "libxsmm_tpu/kernels/spmm_pallas.py:258",
           union, (a, v), TOL_SPARSE_BF16, io + 2 * v.numel(), useful, peak,
           lib_mm, path=union.path, compact_ms=ms(union_c, a, v),
           compact_graph_ms=graph_ms(lambda: union_c(a, v)),
           device_ms=device_ms(lambda: union(a, v)),
           launches=routes["bcsc_spmm_union"]["wgmma"])
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
    # the union's narrow plan at the 16 x 64 blocks above, the fused form
    # timed (ms) and the compacted one (compact_ms, the compactor
    # included), each held against its plain version, beside torch.mm on
    # their densified B; launches: the path's 16 x 64 unions
    u16 = KS.build_bcsc_spmm_union(shape, cfg16, b16.indptr, b16.indices,
                                   dev)
    u16c = KS.build_bcsc_spmm_union(shape, cfg16, b16.indptr, b16.indices,
                                    dev, compact=True)
    if (u16.path, u16c.path) != ("wgmma", "wgmma"):
        raise AssertionError(f"bcsc_spmm_union at 16 x 64 took {u16.path} "
                             f"/ {u16c.path}")
    _check("bcsc_spmm_union 16x64 compacted form vs plain",
           u16c.plain(a, v16), u16c(a, v16), TOL_SPARSE_BF16)
    record("bcsc_spmm_union", src, "libxsmm_tpu/kernels/spmm_pallas.py:258",
           u16, (a, v16), TOL_SPARSE_BF16, io + 2 * v16.numel(), useful16,
           peak, lib16, path=u16.path, shape=[m, n, k, 16, 64],
           compact_ms=ms(u16c, a, v16),
           regs=_regs("bcsc_union_wgmma_kernel", "IfLi16ELi64ELi32ELb0E"),
           compact_regs=_regs("bcsc_union_wgmma_kernel",
                              "IfLi16ELi64ELi32ELb1E"),
           device_ms=device_ms(lambda: u16(a, v16)))
    rows[-1].update(name="bcsc_spmm_union_16x64",
                    launches=narrow[(16, 64)]["bcsc_spmm_union"])
    for form, fn_ in (("fused", u16), ("compacted", u16c)):
        _launched_plan(f"bcsc_spmm_union_16x64 {form}", fn_, (a, v16), 16,
                       64, union=True, compact=fn_ is u16c)
    live16 = (u16.gmap.view(u16.nsg, u16.U, u16.W)
              != u16.nblocks).any(-1).sum().item()
    mma_rate(rows[-1], 2 * m * live16 * 16 * KS.GROUP, useful16)
    t_c = rows[-1]["compact_ms"]
    print(f"  bcsc_spmm_union_16x64 compacted form (compactor included): "
          f"{t_c:.4f} ms, kernel / library {t_c / lib16:.3f}; {live16} live "
          f"slots of {u16.nsg * u16.U}; registers {rows[-1]['regs']} fused, "
          f"{rows[-1]['compact_regs']} compacted")
    comp = union_c.compactor
    rhs = comp(v)
    route = comp.route(v, rhs)[0]
    if route != "bulk":
        raise AssertionError(f"the compactor at the streaming case took "
                             f"the {route} route")
    record("bcsc_union_compact", src, "libxsmm_tpu/kernels/spmm_pallas.py:885",
           comp, (v,), TOL_EXACT,
           v.numel() * v.element_size() + rhs.numel() * rhs.element_size(),
           0, peak, None, path=route, clone_ms=ms(torch.clone, rhs),
           graph_ms=graph_ms(lambda: comp(v)), host_ms=host_ms(lambda: comp(v)),
           clone_graph_ms=graph_ms(lambda: torch.clone(rhs)),
           clone_host_ms=host_ms(lambda: torch.clone(rhs)))
    for case, (shape_, pat, a_, v_) in small.items():
        forms = {nm: KS.build_bcsc_spmm_union(shape_, cfg, pat.indptr,
                                              pat.indices, dev, compact=c)
                 for nm, c in (("compacted", True), ("fused", False))}
        _check(f"bcsc_spmm_union {case} compacted form vs fused form",
               forms["fused"](a_, v_), forms["compacted"](a_, v_),
               TOL_SPARSE_BF16)
        t = {nm: (ms(fn, a_, v_), graph_ms(lambda fn=fn: fn(a_, v_)),
                  host_ms(lambda fn=fn: fn(a_, v_)))
             for nm, fn in forms.items()}
        print(f"  bcsc_spmm_union {case} (m {shape_.m}, U "
              f"{forms['fused'].U}): compacted form (compact_ms) "
              f"{t['compacted'][0]:.4f} ms, replayed {t['compacted'][1]:.4f},"
              f" host {t['compacted'][2]:.4f} a call; fused form "
              f"{t['fused'][0]:.4f} ms, replayed {t['fused'][1]:.4f}, host "
              f"{t['fused'][2]:.4f}")
    s_indptr, s_indices, sgmap = supertile_plan(shape, cfg, indptr, indices)
    sup = assemble_supertiles(v, torch.as_tensor(sgmap, device=dev),
                              torch.bfloat16)
    sfn = KS.build_bcsc_spmm_super(shape, s_indptr, s_indices, dev)
    if sfn.path != "wgmma":
        raise AssertionError(f"bcsc_spmm_super took {sfn.path}")
    record("bcsc_spmm_super", src, "libxsmm_tpu/kernels/spmm_pallas.py:942",
           sfn, (a, sup), TOL_SPARSE_BF16, io + 2 * sup.numel(), useful, peak,
           lib_mm, path=sfn.path, graph_ms=graph_ms(lambda: sfn(a, sup)),
           device_ms=device_ms(lambda: sfn(a, sup)),
           launches=routes["bcsc_spmm_super"]["wgmma"])
    # its own products: every occupied supertile in full
    mma_rate(rows[-1], 2 * m * KS.SUPER * KS.SUPER * len(s_indices), useful)
    ccol = torch.as_tensor(indptr.astype("int64"), device=dev)
    rows = torch.as_tensor(indices.astype("int64"), device=dev)
    d_route = densify.route(v, densify(v))
    if d_route != "vector":
        raise AssertionError(f"densify at the streaming case took the "
                             f"{d_route} route")
    record("bcsc_densify", src, "libxsmm_tpu/kernels/spmm_pallas.py:800",
           densify, (v,), TOL_EXACT, 2 * v.numel() + 2 * k * n, 0, peak,
           ms(lambda vv: torch.sparse_bsc_tensor(ccol, rows, vv,
                                                 (k, n)).to_dense(), v),
           path=d_route, graph_ms=graph_ms(lambda: densify(v)),
           host_ms=host_ms(lambda: densify(v)))


# the f32 routes' rows: flash at bench.py:568's shape and at the BERT-base
# encoder block's (8 x 12 heads, s 512, hd 64), non-causal and causal; the
# f32 SpMM forms at stream20's pattern
F32_FLASH_SHAPES = {"bench": (16, 2048, 128), "encoder": (96, 512, 64)}
SDPA_BACKENDS = ("EFFICIENT_ATTENTION", "MATH")


def _normf_rel(ref, got):
    """matdiff's normf_rel of `got` against `ref` (no margin)."""
    from libxsmm_torch.matdiff import matdiff
    return float(matdiff(ref, got).normf_rel)


def _attention64(q, kT, v, scale, causal):
    """Attention as a float64 torch composition (the references' oracle)."""
    sc = torch.matmul(q, kT) * scale
    if causal:
        s = sc.shape[-1]
        upper = torch.ones(s, s, dtype=torch.bool, device=sc.device).triu(1)
        sc = sc.masked_fill(upper, float("-inf"))
    return torch.matmul(torch.softmax(sc, -1), v)


def f32_flash_rows(randn, ms, geo):
    """The f32 flash forward, dK/dV and dQ on the route flash_path and
    flash_bwd_path name for f32, at both shapes of F32_FLASH_SHAPES,
    non-causal and causal: each call's route asserted and its output held
    against the plain version (TOL_F32,
    TOL_BWD_F32), its error against float64, its time by CUDA events beside
    the plain version's and the bound (operations at the f32 FMA peak:
    4 (fwd), 8 (dK/dV) and 6 (dQ) x hd per (query, key) pair the data
    needs, causal pairs only where causal; bytes each input once, each
    output once). The library call is F.scaled_dot_product_attention on
    the same f32 operands (TF32 off) under each backend of SDPA_BACKENDS
    that takes them, forward by events and backward by device time
    (torch.profiler; it runs through autograd), each with its normf_rel
    against float64; a backend past TOL_F32 (forward) or TOL_BWD_F32
    (backward, the margin the f32 backward kernels are held to) is printed
    but is not the yardstick (`yardstick_fwd`, `yardstick_bwd`); a backend
    that refuses f32 at the shape ("No available kernel") is recorded as
    unavailable, and any other error raises. It reads only entry points
    every tree of the port has had (build_flash_attention and its backward,
    their plain versions), so with an older checkout first on sys.path it
    times that tree's f32 kernels. Returns {(shape, causal): row}, the
    kernel's figures under row["kernel"] and its route under row["route"]."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from libxsmm_torch.kernels import attention as KA

    F = torch.nn.functional
    f32 = torch.float32
    route = KA.flash_path(f32)
    out = {}
    for shape_name, (bh, s, hd) in F32_FLASH_SHAPES.items():
        q, v, dout = randn(bh, s, hd), randn(bh, s, hd), randn(bh, s, hd)
        kT = randn(bh, hd, s)
        q4, k4, v4 = q[None], kT.transpose(-1, -2).contiguous()[None], v[None]
        for causal in (False, True):
            pairs = bh * (s * (s + 1) // 2 if causal else s * s)
            io = 4 * bh * s * hd * 4
            work = {"fwd": (io, 4 * pairs * hd),
                    "dkv": (io + 2 * bh * s * 4 + 2 * bh * s * hd * 4,
                            8 * pairs * hd),
                    "dq": (io + 2 * bh * s * 4, 6 * pairs * hd)}
            bound = {k: geo.bound_ms(*w, geo.peak_f32_tflops)
                     for k, w in work.items()}
            bound_by = {k: geo.bound_by(*w, geo.peak_f32_tflops)
                        for k, w in work.items()}
            leaves = [t.double().requires_grad_(True) for t in (q, kT, v)]
            o64 = _attention64(*leaves, hd ** -0.5, causal)
            g64 = torch.autograd.grad(o64, leaves, dout.double())
            o64 = o64.detach()
            del leaves
            row = {"shape": (bh, s, hd), "causal": causal, "bound": bound,
                   "bound_by": bound_by, "route": route}
            fn = KA.build_flash_attention(bh, s, hd, f32, causal=causal,
                                          return_lse=True)
            bwd = KA.build_flash_attention_bwd(bh, s, hd, f32, causal=causal)
            o, lse = fn(0, q, kT, v)
            delta = (dout * o).sum(-1, keepdim=True).expand(bh, s, 128)
            bargs = (0, q, kT, v, dout, lse, delta)
            grads = bwd(*bargs)
            torch.cuda.synchronize()
            if (fn.path, bwd.path) != (route, KA.flash_bwd_path(f32)):
                raise AssertionError(f"f32 flash {shape_name}: took "
                                     f"{fn.path} / {bwd.path}, expected "
                                     f"{route}")
            tag = f"f32 flash {shape_name} causal={causal} {route}"
            want, bwant = fn.plain(0, q, kT, v), bwd.plain(*bargs)
            _check(f"{tag} fwd vs plain", want, (o, lse), TOL_F32)
            _check(f"{tag} bwd vs plain", bwant, grads, TOL_BWD_F32)
            row["kernel"] = {
                "fwd_ms": ms(fn, 0, q, kT, v),
                "dkv_ms": ms(bwd.dkv, *bargs),
                "dq_ms": ms(bwd.dq, *bargs),
                "max_abs_err": {"fwd": _max_abs(want, (o, lse)),
                                "dq": _max_abs(bwant[0], grads[0]),
                                "dkv": _max_abs(bwant[1:], grads[1:])},
                "fwd_err64": _normf_rel(o64, o),
                "bwd_err64": max(_normf_rel(w, g)
                                 for w, g in zip(g64, grads))}
            row["plain"] = {"fwd_ms": ms(fn.plain, 0, q, kT, v),
                            "dkv_ms": ms(bwd.dkv_plain, *bargs),
                            "dq_ms": ms(bwd.dq_plain, *bargs)}
            for name in SDPA_BACKENDS:
                backend = getattr(SDPBackend, name)

                def call(a, b, c, backend=backend):
                    with sdpa_kernel(backend):
                        return F.scaled_dot_product_attention(
                            a, b, c, is_causal=causal)

                try:
                    o_lib = call(q4, k4, v4)
                except RuntimeError as e:
                    # the backend's own refusal of these operands; any other
                    # fault (out of memory, a failed launch) raises
                    if "No available kernel" not in str(e):
                        raise
                    row[name] = {"unavailable": str(e).splitlines()[0][:160]}
                    continue
                lv = tuple(t_.detach().requires_grad_(True)
                           for t_ in (q4, k4, v4))
                with sdpa_kernel(backend):
                    o_ = F.scaled_dot_product_attention(*lv,
                                                        is_causal=causal)
                g_ = torch.autograd.grad(o_, lv, dout[None],
                                         retain_graph=True)
                row[name] = {
                    "fwd_ms": ms(call, q4, k4, v4),
                    "bwd_device_ms": device_ms(
                        lambda o_=o_, lv=lv: torch.autograd.grad(
                            o_, lv, dout[None], retain_graph=True)),
                    "fwd_err64": _normf_rel(o64, o_lib[0]),
                    "bwd_err64": max(
                        _normf_rel(g64[0], g_[0][0]),
                        _normf_rel(g64[1], g_[1][0].transpose(-1, -2)),
                        _normf_rel(g64[2], g_[2][0]))}
                del o_, g_, lv
            # the yardsticks: the fastest backend within the f32 kernels'
            # own margins against float64, forward and backward apart
            for part, key, tol in (("fwd", "fwd_ms", TOL_F32),
                                   ("bwd", "bwd_device_ms", TOL_BWD_F32)):
                fit = [n for n in SDPA_BACKENDS if key in row[n]
                       and row[n][f"{part}_err64"] <= tol]
                row[f"yardstick_{part}"] = min(
                    fit, key=lambda n: row[n][key], default=None)
            out[(shape_name, causal)] = row
            _print_f32_flash(shape_name, row)
            del o64, g64
    return out


def _print_f32_flash(shape_name, row):
    bh, s, hd = row["shape"]
    b = row["bound"]
    head = (f"  f32 flash {shape_name} ({bh}, {s}, {hd}) causal="
            f"{row['causal']}: bound fwd {b['fwd']:.4f} / dkv "
            f"{b['dkv']:.4f} / dq {b['dq']:.4f} ms")
    print(head)
    for key, label in (("kernel", row["route"]), ("plain", "plain")):
        x = row[key]
        errs = (f"; normf_rel vs float64 fwd {x['fwd_err64']:.2e} bwd "
                f"{x['bwd_err64']:.2e}" if "fwd_err64" in x else "")
        print(f"    {label}: fwd {x['fwd_ms']:.4f} ms "
              f"({b['fwd'] / x['fwd_ms']:.3f} of its bound), dkv {x['dkv_ms']:.4f} ms "
              f"({b['dkv'] / x['dkv_ms']:.3f}), dq {x['dq_ms']:.4f} ms "
              f"({b['dq'] / x['dq_ms']:.3f}){errs}")
    for n in SDPA_BACKENDS:
        x = row[n]
        if "unavailable" in x:
            print(f"    sdpa {n}: unavailable ({x['unavailable']})")
            continue
        marks = [f"not the {p} yardstick" for p in ("fwd", "bwd")
                 if row[f"yardstick_{p}"] != n]
        print(f"    sdpa {n}: fwd {x['fwd_ms']:.4f} ms, backward device "
              f"{x['bwd_device_ms']:.4f} ms; normf_rel vs float64 fwd "
              f"{x['fwd_err64']:.2e} bwd {x['bwd_err64']:.2e}"
              + (f" ({', '.join(marks)})" if marks else ""))


def bf16_flash_bwd_rows():
    """The bf16 flash dK/dV and dQ at both shapes of F32_FLASH_SHAPES,
    non-causal and causal, measured by scripts/flash_bwd_time.rows_at: each
    kernel held against its plain version (normf_rel within TOL_BF16_OUT),
    timed by CUDA events, CUDA-graph replay and device time beside its
    bound (operations at the bf16 tensor-core peak: 8 (dK/dV) and 6 (dQ) x
    hd per (query, key) pair the data needs, causal pairs only where
    causal; bytes each input once, each output once), and the backward of
    F.scaled_dot_product_attention on the same operands under each bf16
    backend by device time, the fastest that takes them the yardstick.
    In this long process the profiler has read about half of the events
    time, for these kernels and SDPA alike, so the kernels' TFLOP/s and
    share of the bound are taken from replay ("replay_tflops",
    "replay_of_bound"), and device times are compared only with device
    times. Every call takes the route flash_bwd_path names (wgmma),
    asserted by its launches. Returns {(shape, form): {"dkv": row, "dq":
    row, "sdpa": {backend: ms or its refusal}, "yardstick": backend}}."""
    from libxsmm_torch.kernels import attention as KA
    from libxsmm_torch.scripts import flash_bwd_time as FT

    out = {}
    for shape, (bh, s, hd) in F32_FLASH_SHAPES.items():
        if FT.SHAPES[shape] != (bh, s, hd) or FT.TOL != TOL_BF16_OUT:
            raise AssertionError("flash_bwd_time measures other shapes or "
                                 "holds another margin")
        for form in ("plain", "causal"):
            tag = f"bf16 flash bwd {shape} {form}"
            route = KA.flash_bwd_path(torch.bfloat16, hd)
            routes0 = _routes()
            dkv, dq = FT.rows_at(shape, form, seed=0)
            if route != "wgmma" or {dkv["route"], dq["route"]} != {route}:
                raise AssertionError(f"{tag}: took {dkv['route']}")
            _took_route(tag, routes0, BWD_KERNELS, route)
            sdpa = dq.pop("sdpa_ms")
            took = {n: t_ for n, t_ in sdpa.items() if isinstance(t_, float)}
            x = {"dkv": dkv, "dq": dq, "sdpa": sdpa,
                 "yardstick": min(took, key=took.get, default=None)}
            pairs = bh * (s * (s + 1) // 2 if form == "causal" else s * s)
            for part, nmm in (("dkv", 8), ("dq", 6)):
                r = x[part]
                if not r["device_ms"]:
                    raise AssertionError(f"{tag} {part}: the profiler "
                                         "recorded no kernel")
                r["replay_tflops"] = nmm * pairs * hd / r["graph_ms"] / 1e9
                r["replay_of_bound"] = r["bound_ms"] / r["graph_ms"]
                print(f"  {tag} ({bh}, {s}, {hd}) {part} [{route}]: "
                      f"events {r['ms']:.4f} ms, replay {r['graph_ms']:.4f} "
                      f"ms ({r['replay_tflops']:.1f} TFLOP/s, "
                      f"{r['replay_of_bound']:.3f} of its bound "
                      f"{r['bound_ms']:.4f} ms), device {r['device_ms']:.4f}"
                      f" ms; max_abs_err {r['max_abs_err']:.3e}")
            pair = dkv["device_ms"] + dq["device_ms"]
            print(f"    sdpa backward device: " + "; ".join(
                f"{n} {t_:.4f} ms (dkv + dq device / sdpa {pair / t_:.3f})"
                if isinstance(t_, float) else f"{n} refused ({t_})"
                for n, t_ in sdpa.items())
                + f"; yardstick {x['yardstick']}")
            out[(shape, form)] = x
    return out


def bf16_flash_fwd_rows():
    """The bf16 flash forward at both shapes of F32_FLASH_SHAPES,
    non-causal and causal, measured by scripts/flash_bwd_time.fwd_rows_at:
    held against its plain version (normf_rel within TOL_BF16_OUT), timed
    by CUDA events, CUDA-graph replay and device time beside its bound (4
    x hd operations per (query, key) pair the data needs at the bf16
    tensor-core peak, causal pairs only where causal; bytes q, kT, v once
    and out once), and F.scaled_dot_product_attention's forward on the
    same operands under each bf16 backend by CUDA events, the fastest that
    takes them the yardstick: in this long run the profiler recorded no
    kernel of SDPA's forward in three sessions running (its device times
    come from the script's short process). As for the backward, the
    kernel's TFLOP/s and share of the bound come from replay. Every call
    takes the route flash_path names (wgmma), asserted by its launches.
    Returns {"shape form": row with "sdpa" and "yardstick"}."""
    from libxsmm_torch.kernels import attention as KA
    from libxsmm_torch.scripts import flash_bwd_time as FT
    from libxsmm_torch.scripts import timing

    out = {}
    for shape, (bh, s, hd) in F32_FLASH_SHAPES.items():
        if FT.SHAPES[shape] != (bh, s, hd) or FT.TOL != TOL_BF16_OUT:
            raise AssertionError("flash_bwd_time measures other shapes or "
                                 "holds another margin")
        for form in ("plain", "causal"):
            tag = f"bf16 flash fwd {shape} {form}"
            routes0 = _routes()
            (r,) = FT.fwd_rows_at(shape, form, seed=0,
                                  sdpa_timer=timing.events_ms)
            if r["route"] != "wgmma" or KA.flash_path(torch.bfloat16,
                                                       hd) != "wgmma":
                raise AssertionError(f"{tag}: took {r['route']}")
            _took_route(tag, routes0, ("flash_attention_fwd",), "wgmma")
            if not r["device_ms"]:
                raise AssertionError(f"{tag}: the profiler recorded no "
                                     "kernel")
            sdpa = r.pop("sdpa_ms")
            took = {n: t_ for n, t_ in sdpa.items() if isinstance(t_, float)}
            pairs = bh * (s * (s + 1) // 2 if form == "causal" else s * s)
            r["replay_tflops"] = 4 * pairs * hd / r["graph_ms"] / 1e9
            r["replay_of_bound"] = r["bound_ms"] / r["graph_ms"]
            r["sdpa"] = sdpa
            r["yardstick"] = min(took, key=took.get, default=None)
            print(f"  {tag} ({bh}, {s}, {hd}) [wgmma]: events {r['ms']:.4f}"
                  f" ms, replay {r['graph_ms']:.4f} ms "
                  f"({r['replay_tflops']:.1f} TFLOP/s, "
                  f"{r['replay_of_bound']:.3f} of its bound "
                  f"{r['bound_ms']:.4f} ms), device {r['device_ms']:.4f} ms;"
                  f" max_abs_err {r['max_abs_err']:.3e}")
            print("    sdpa forward by events: " + "; ".join(
                f"{n} {t_:.4f} ms (kernel events / sdpa "
                f"{r['ms'] / t_:.3f})" if isinstance(t_, float)
                else f"{n} refused ({t_})" for n, t_ in sdpa.items())
                + f"; yardstick {r['yardstick']}")
            out[f"{shape} {form}"] = r
    return out


def f32_spmm_rows(randn, ms, geo, auto_pick):
    """The f32 forms of the scheduled ("pallas"), supertile and k-union
    BCSC SpMMs at stream20's pattern (m 32768, k = n = 1024, 32 x 32
    blocks at density 0.2, bench.py's pattern from default_rng(2)) in f32,
    on the planner's route (tma_fma, asserted): each against its plain
    version (TOL_SPARSE_F32), timed beside the plain version, the bound
    (A, the values and C moved once; the useful products 2 nblocks bk bn m
    at the f32 FMA peak), its own products at that peak ("own_ms": every
    schedule step, live union slot or occupied supertile in full) and
    torch.mm in f32 (TF32 off) on the densified B. The union row carries
    the compacted form's time (compactor included) and auto's pick at the
    sparse path's full-width f32 case (`auto_pick`). Then the FMA kernels
    at f32 and bf16 blockings the rule sends to them, each against its
    plain version (fma_route_checks). Returns {name: row}."""
    import numpy as np

    from libxsmm_torch.descriptor import GemmShape, SpgemmConfig
    from libxsmm_torch.kernels import spmm as KS
    from libxsmm_torch.ops.sparse import assemble_supertiles, supertile_plan

    m, k, n, bk = 32768, 1024, 1024, 32
    cfg = SpgemmConfig(1, bk, bk)
    bcsc = _bcsc_pattern(np.random.default_rng(2), k, n, bk, bk, 0.2)
    a = randn(m, k)
    dev = a.device
    v = torch.as_tensor(bcsc.data, device=dev).float()
    shape = GemmShape(m, n, k)
    dense_b = KS.build_bcsc_densify(shape, cfg, bcsc.indptr, bcsc.indices,
                                    dev).plain(v)
    lib = ms(torch.mm, a, dense_b)
    useful = 2 * bcsc.nblocks * bk * bk * m
    io = 4 * (m * k + m * n)
    s_indptr, s_indices, sgmap = supertile_plan(shape, cfg, bcsc.indptr,
                                                bcsc.indices)
    sup = assemble_supertiles(v, torch.as_tensor(sgmap, device=dev),
                              torch.float32)
    kernels = {
        "bcsc_spmm": (KS.build_bcsc_spmm(shape, cfg, bcsc.indptr,
                                         bcsc.indices, dev), v),
        "bcsc_spmm_super": (KS.build_bcsc_spmm_super(shape, s_indptr,
                                                     s_indices, dev), sup),
        "bcsc_spmm_union": (KS.build_bcsc_spmm_union(
            shape, cfg, bcsc.indptr, bcsc.indices, dev), v)}

    def own(fn):
        """2 m x the products of every block the kernel multiplies."""
        if isinstance(fn, KS.BcscSpmmUnion):
            live = (fn.gmap.view(fn.nsg, fn.U, fn.W)
                    != fn.nblocks).any(-1).sum().item()
            return 2 * m * live * fn.bk * KS.GROUP
        return 2 * m * fn.rows.numel() * fn.bk * fn.bn

    out = {}
    for name, (fn, vals) in kernels.items():
        if fn.path != "tma_fma":
            raise AssertionError(f"{name} f32 took {fn.path}")
        got, want = fn(a, vals), fn.plain(a, vals)
        torch.cuda.synchronize()
        _check(f"{name} f32 stream20 kernel vs plain", want, got,
               TOL_SPARSE_F32)
        products = own(fn)
        nbytes = io + 4 * vals.numel()
        r = out[name] = {
            "ms": ms(fn, a, vals), "plain_ms": ms(fn.plain, a, vals),
            "bound_ms": geo.bound_ms(nbytes, useful, geo.peak_f32_tflops),
            "bound_by": geo.bound_by(nbytes, useful, geo.peak_f32_tflops),
            "own_gflop": products / 1e9,
            "own_ms": products / (geo.peak_f32_tflops * 1e9),
            "library_ms": lib, "max_abs_err": _max_abs(want, got),
            "path": fn.path}
        r["tflops"] = products / r["ms"] / 1e9
        extra = ""
        if name == "bcsc_spmm_union":
            comp = KS.build_bcsc_spmm_union(shape, cfg, bcsc.indptr,
                                            bcsc.indices, dev, compact=True)
            _check("bcsc_spmm_union f32 stream20 compacted vs fused",
                   got, comp(a, v), TOL_SPARSE_F32)
            r["compact_ms"] = ms(comp, a, v)
            r["auto"] = auto_pick
            extra = (f"; compacted form {r['compact_ms']:.4f} ms (k/l "
                     f"{r['compact_ms'] / lib:.3f}); auto -> {auto_pick}")
        print(f"  {name} f32 stream20 ({m}x{n}x{k}, {bcsc.nblocks} blocks "
              f"of 32x32) on tma_fma: {r['ms']:.4f} ms; bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}, "
              f"{r['bound_ms'] / r['ms']:.3f} of it; own products "
              f"{r['own_gflop']:.2f} GFLOP, {r['own_ms']:.4f} ms at the FMA "
              f"peak, {r['tflops']:.1f} TFLOP/s; plain {r['plain_ms']:.4f} "
              f"ms; torch.mm f32 on the densified B {lib:.4f} ms, kernel / "
              f"library {r['ms'] / lib:.3f}{extra}")
    fma_route_checks(randn, dev)
    return out


def fma_route_checks(randn, dev):
    """The FMA kernels (route "fma") at blockings the rule sends to them:
    f32 blocks whose depth is not whole 16-byte units (6 x 32), bf16 blocks
    that are not whole k16 steps (8 x 8, 4 x 48), and f32 unions of more
    than four value blocks a group (16 x 8, fused and compacted); m 4096,
    each against its plain version, the launch on "fma" asserted."""
    import numpy as np

    from libxsmm_torch.descriptor import GemmShape, SpgemmConfig
    from libxsmm_torch.dtypes import Datatype
    from libxsmm_torch.kernels import spmm as KS

    m, k = 4096, 1152
    for dt, bk, bn, form in ((torch.float32, 6, 32, "scheduled"),
                             (torch.bfloat16, 8, 8, "scheduled"),
                             (torch.bfloat16, 4, 48, "scheduled"),
                             (torch.float32, 16, 8, "fused"),
                             (torch.float32, 16, 8, "compacted")):
        n = 1152 if bn == 48 else 1024
        bcsc = _bcsc_pattern(np.random.default_rng(3), k, n, bk, bn, 0.2)
        dtype = Datatype.F32 if dt == torch.float32 else Datatype.BF16
        shape = GemmShape(m, n, k, dtype, dtype, Datatype.F32)
        cfg = SpgemmConfig(1, bk, bn)
        if form == "scheduled":
            fn, name = KS.build_bcsc_spmm(shape, cfg, bcsc.indptr,
                                          bcsc.indices, dev), "bcsc_spmm"
        else:
            fn, name = KS.build_bcsc_spmm_union(
                shape, cfg, bcsc.indptr, bcsc.indices, dev,
                compact=form == "compacted"), "bcsc_spmm_union"
        tag = f"{name} {form} {str(dt)[6:]} {bk}x{bn}"
        if fn.path != "fma":
            raise AssertionError(f"{tag} took {fn.path}, expected fma")
        a = randn(m, k, dtype=dt)
        v = torch.as_tensor(bcsc.data, device=dev).to(dt)
        routes = _routes(KS)
        got = fn(a, v)
        _took_route(tag, routes, (name,), "fma", KS)
        want = fn.plain(a, v)
        torch.cuda.synchronize()
        err = _check(f"{tag} kernel (fma) vs plain", want, got,
                     TOL_SPARSE_F32 if dt == torch.float32
                     else TOL_SPARSE_BF16)
        print(f"  {tag} on fma: normf_rel vs plain {err:.3e}, max |diff| "
              f"{_max_abs(want, got):.3e}")


def f32_kernel_rows(flash, spmm, routes, spmm_counts):
    """The kernels-line rows of the f32 routes: the flash forward, dK/dV
    and dQ on tma_fma at bench.py:568's shape (the other shape and causal
    forms and SDPA's backends beside), launches their tma_fma launches on
    the serving and training paths; the f32 SpMM forms at stream20,
    launches their tma_fma launches on the sparse path's two f32 cases (m
    4096 and 32768, each also by m)."""
    rows = []
    b = flash[("bench", False)]
    for part, counter, src, line in (
            ("fwd", "flash_attention_fwd", "attention_kernels.cu", 159),
            ("dkv", "flash_attention_bwd_dkv", "attention_bwd_kernels.cu",
             387),
            ("dq", "flash_attention_bwd_dq", "attention_bwd_kernels.cu",
             485)):
        yard = b["yardstick_fwd" if part == "fwd" else "yardstick_bwd"]
        key = "fwd_ms" if part == "fwd" else "bwd_device_ms"
        forms = {}
        for (shape, causal), row in flash.items():
            forms[f"{shape} causal={causal}"] = {
                "ms": row["kernel"][f"{part}_ms"],
                "plain_ms": row["plain"][f"{part}_ms"],
                "bound_ms": row["bound"][part],
                "sdpa": {n: row[n] for n in SDPA_BACKENDS},
                "yardstick": row["yardstick_fwd" if part == "fwd"
                                 else "yardstick_bwd"]}
        rows.append({
            "name": f"{counter}_f32", "route": "cuda",
            "source": f"libxsmm_torch/kernels/csrc/{src}",
            "replaces": f"libxsmm_tpu/kernels/attention_pallas.py:{line}",
            "launches": routes[counter]["tma_fma"],
            "max_abs_err": b["kernel"]["max_abs_err"][part],
            "ms": b["kernel"][f"{part}_ms"],
            "plain_ms": b["plain"][f"{part}_ms"],
            "bound_ms": b["bound"][part], "bound_by": b["bound_by"][part],
            "library_ms": None if yard is None else b[yard][key],
            "path": b["route"],
            "library": yard, "forms": forms})
    for name, line in (("bcsc_spmm", 88), ("bcsc_spmm_super", 942),
                       ("bcsc_spmm_union", 258)):
        r = spmm[name]
        by_case = {rows_: counts[name]["tma_fma"]
                   for rows_, counts in spmm_counts.items()}
        rows.append({
            "name": f"{name}_f32", "route": "cuda",
            "source": "libxsmm_torch/kernels/csrc/spmm_kernels.cu",
            "replaces": f"libxsmm_tpu/kernels/spmm_pallas.py:{line}",
            "launches": sum(by_case.values()),
            "launches_by_m": by_case, **r})
    return rows


def _aten_ops(fn, *fargs):
    """The torch operators (aten ops, views included) that one call of
    fn(*fargs) dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn(*fargs)
    torch.cuda.synchronize()
    return Count.n


def _no_launches(path):
    """Fail unless no kernel of the port was launched since the counts were
    set to 0: the path runs on torch ops alone."""
    torch.cuda.synchronize()
    launched = {k: v for k, v in _all_launches().items() if v}
    if launched:
        raise AssertionError(f"{path}: kernel launches changed: {launched}")


def equation_path(randn, dev, ms):
    """Matrix equations through the public entry points (meqn_create, the
    meqn_push_back_* builders, dispatch_meqn), the reference samples' trees
    at BERT-base widths (Devlin et al. 2018: 8 x 512 tokens, d 768, FFN
    3072, 12 heads, vocabulary 30522), each held against a float64 torch
    composition on the card, with every kernel's launch count set to 0 just
    before and read just after (the trees run on torch ops: none may
    change). Prints each tree's time per call (events), the host's time per
    call and the torch operators one call dispatches."""
    import libxsmm_torch as xt
    from libxsmm_torch.descriptor import (BinaryType as B, TernaryFlags as TF,
                                          TernaryType as T, UnaryFlags as UF,
                                          UnaryType as U)
    from libxsmm_torch.dtypes import Datatype as D

    phases = []
    _reset_all_launches()
    t_path = time.perf_counter()
    tokens, d, ffn = 8 * 512, 768, 3072
    f64 = torch.float64

    def tree(name, build, out, args, check):
        idx = xt.meqn_create()
        build(idx)
        kern = xt.dispatch_meqn(idx, *out)
        got = kern(*args)
        torch.cuda.synchronize()
        err = check(got)
        t = ms(kern, *args)
        host = host_ms(lambda: kern(*args))
        nops = _aten_ops(kern, *args)
        nf = xt.get_kernel_info(kern).nflops
        print(f"  meqn {name}: {t:.4f} ms per call (events), host "
              f"{host:.4f} ms a call, {nops} torch ops a call, nflops {nf}, "
              f"{err}")
        phases.append((f"meqn {name}", kern, args))
        xt.meqn_destroy(idx)

    def against(ref, tol, shape):
        def check(got):
            e = _check("meqn vs float64", ref, got, tol, shape)
            return f"normf_rel {e:.2e} vs float64"
        return check

    def push_args(idx, shapes, dt):
        for p, (m_, n_) in enumerate(shapes):
            xt.meqn_push_back_arg(idx, m_, n_, in_pos=p, dtype=dt)

    for dt, tdt, tol in ((D.F32, torch.float32, TOL_F32),
                         (D.BF16, torch.bfloat16, TOL_MEQN_BF16)):
        tag = dt.value
        a, b, c = (randn(tokens, d, dtype=tdt) for _ in range(3))
        A, Bv, C = (v.to(f64) for v in (a, b, c))

        def simple(idx, dt=dt):
            xt.meqn_push_back_binary_op(idx, B.MUL, dtype=dt)
            xt.meqn_push_back_binary_op(idx, B.ADD, dtype=dt)
            push_args(idx, [(tokens, d)] * 3, dt)

        tree(f"simple (a + b) * c {tokens}x{d} {tag}", simple,
             (tokens, d, dt), (a, b, c), against((A + Bv) * C, tol,
                                                 (tokens, d)))
        bias = randn(1, d, dtype=tdt)

        def relu(idx, dt=dt):
            xt.meqn_push_back_unary_op(idx, U.RELU, dtype=dt)
            xt.meqn_push_back_binary_op(idx, B.ADD, dtype=dt)
            push_args(idx, [(tokens, d), (1, d)], dt)

        tree(f"relu(x + bias) {tokens}x{d} {tag}", relu, (tokens, d, dt),
             (a, bias), against((A + bias.to(f64)).clamp_min(0), tol,
                                (tokens, d)))
        # layernorm, the equation_layernorm tree: statistics in f32 first
        mean = a.float().mean(dim=1, keepdim=True)
        rstd = torch.rsqrt(a.float().var(dim=1, unbiased=False,
                                         keepdim=True) + 1e-5)
        gamma, beta = randn(1, d, dtype=tdt), randn(1, d, dtype=tdt)
        ln_args = (a, mean.to(tdt), rstd.to(tdt), gamma, beta)

        def layernorm(idx, dt=dt):
            xt.meqn_push_back_ternary_op(idx, T.MULADD, dtype=dt)
            xt.meqn_push_back_binary_op(idx, B.MUL, dtype=dt)
            xt.meqn_push_back_binary_op(idx, B.SUB, dtype=dt)
            push_args(idx, [(tokens, d), (tokens, 1), (tokens, 1), (1, d),
                            (1, d)], dt)

        X, Mn, Rs, G, Be = (v.to(f64) for v in ln_args)
        tree(f"layernorm {tokens}x{d} {tag}", layernorm, (tokens, d, dt),
             ln_args, against((X - Mn) * Rs * G + Be, tol, (tokens, d)))

    # relu(A @ B + bias) at the FFN1 product: f32, and bf16 in with the
    # product and the node in f32
    for dt, tdt, tol in ((D.F32, torch.float32, TOL_F32),
                         (D.BF16, torch.bfloat16, TOL_BF16_IN)):
        a_, b_ = randn(tokens, d, dtype=tdt), randn(d, ffn, dtype=tdt)
        bias = randn(1, ffn)

        def relu_mm(idx, dt=dt):
            xt.meqn_push_back_unary_op(idx, U.RELU)
            xt.meqn_push_back_binary_op(idx, B.ADD)
            xt.meqn_push_back_binary_op(idx, B.MATMUL)
            xt.meqn_push_back_arg(idx, tokens, d, in_pos=0, dtype=dt)
            xt.meqn_push_back_arg(idx, d, ffn, in_pos=1, dtype=dt)
            xt.meqn_push_back_arg(idx, 1, ffn, in_pos=2)

        ref = (a_.to(f64) @ b_.to(f64) + bias.to(f64)).clamp_min(0)
        tree(f"relu(A @ B + bias) {tokens}x{d}x{ffn} {dt.value} -> f32",
             relu_mm, (tokens, ffn, D.F32), (a_, b_, bias),
             against(ref, tol, (tokens, ffn)))

    # softmax over 8 x 12 heads x 512 rows of 512 scores (equation_softmax)
    rows = 8 * 12 * 512
    s = randn(rows, 512)
    mx = s.amax(dim=1, keepdim=True)
    den = torch.exp(s - mx).sum(dim=1, keepdim=True)

    def softmax(idx):
        xt.meqn_push_back_binary_op(idx, B.DIV)
        xt.meqn_push_back_unary_op(idx, U.EXP)
        xt.meqn_push_back_binary_op(idx, B.SUB)
        push_args(idx, [(rows, 512), (rows, 1), (rows, 1)], D.F32)

    S64 = s.to(f64)
    tree(f"softmax {rows}x512 f32", softmax, (rows, 512, D.F32),
         (s, mx, den), against(torch.exp(S64 - mx.to(f64)) / den.to(f64),
                               TOL_F32, (rows, 512)))

    # splitSGD by UNZIP(NMULADD(lr, g, ZIP(lo, hi))) on a 768 x 3072 f32
    # weight (equation_splitSGD), bit for bit against the plain update's
    # bits
    w, g = randn(d, ffn), randn(d, ffn)
    lr = torch.full((1, 1), 0.01, device=dev)
    bits = w.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    lo, hi = (bits & 0xFFFF).to(torch.uint16), (bits >> 16).to(torch.uint16)

    def split_sgd(idx):
        xt.meqn_push_back_unary_op(idx, U.UNZIP)
        xt.meqn_push_back_ternary_op(idx, T.NMULADD,
                                     flags=TF.BCAST_SCALAR_IN_0)
        xt.meqn_push_back_arg(idx, 1, 1, in_pos=0)
        xt.meqn_push_back_arg(idx, d, ffn, in_pos=1)
        xt.meqn_push_back_binary_op(idx, B.ZIP)
        xt.meqn_push_back_arg(idx, d, ffn, in_pos=2, dtype=D.U16)
        xt.meqn_push_back_arg(idx, d, ffn, in_pos=3, dtype=D.U16)

    new_bits = ((w - lr * g).view(torch.int32).to(torch.int64)
                & 0xFFFFFFFF)

    def bit_for_bit(got):
        for half, want in zip(got, (new_bits & 0xFFFF, new_bits >> 16)):
            if half.dtype != torch.uint16 or not torch.equal(
                    half.to(torch.int64), want):
                raise AssertionError("meqn splitSGD: bits differ from the "
                                     "plain update's")
        return "bit for bit against w - lr * g"

    tree(f"splitSGD UNZIP/ZIP {d}x{ffn} f32", split_sgd, (d, ffn, D.U16),
         (lr, g, lo, hi), bit_for_bit)

    # GATHER of 4096 rows from BERT's 30522 x 768 embedding table: indices
    # from the seed, with negative ones (counted from the end) and ones out
    # of range (NaN rows), as jnp.take's fill mode gives them
    vocab = 30522
    table = randn(vocab, d)
    ids = torch.randint(0, vocab, (tokens,), device=dev, dtype=torch.int32)
    ids[5], ids[17], ids[100], ids[200] = -1, -vocab, vocab, -vocab - 1

    def gather(idx):
        xt.meqn_push_back_unary_op(idx, U.GATHER, flags=UF.GS_ROWS,
                                   op_arg_pos=1)
        xt.meqn_push_back_arg(idx, vocab, d, in_pos=0)

    wrapped = torch.where(ids < 0, ids + vocab, ids).long()
    valid = (wrapped >= 0) & (wrapped < vocab)
    want = torch.where(valid[:, None], table[wrapped.clamp(0, vocab - 1)],
                       torch.nan)

    def gathered(got):
        nan = torch.isnan(got)
        if (tuple(got.shape) != (tokens, d)
                or not torch.equal(nan, torch.isnan(want))
                or not torch.equal(got[~nan], want[~nan])):
            raise AssertionError("meqn gather differs from jnp.take's fill")
        return (f"bit for bit, {int((~valid).sum())} rows filled, "
                f"{int(((ids < 0) & valid).sum())} counted from the end")

    tree(f"gather {tokens} of {vocab}x{d} f32", gather, (tokens, d, D.F32),
         (table, ids), gathered)

    # a BRGEMM node over tensor sets: br 12 x (4096 x 64) x (64 x 3072),
    # bf16 in, f32 node (FFN1's k 768 as 12 x 64)
    br, kb = 12, 64
    attr = xt.create_matrix_arg_attributes(arg_type=1, set_type=3,
                                           set_cardinality_hint=br)
    sa = randn(br, tokens, kb, dtype=torch.bfloat16)
    sb = randn(br, kb, ffn, dtype=torch.bfloat16)

    def brgemm_set(idx):
        xt.meqn_push_back_binary_op(idx, B.BRGEMM)
        xt.meqn_push_back_arg(xt.create_meqn_arg_metadata(idx, 0),
                              xt.create_meqn_arg_shape(tokens, kb, kb,
                                                       D.BF16), attr)
        xt.meqn_push_back_arg(xt.create_meqn_arg_metadata(idx, 1),
                              xt.create_meqn_arg_shape(kb, ffn, ffn,
                                                       D.BF16), attr)

    tree(f"BRGEMM set br {br} x {tokens}x{kb}x{ffn} bf16 -> f32",
         brgemm_set, (tokens, ffn, D.F32), (sa, sb),
         against(torch.einsum("bmk,bkn->mn", sa.to(f64), sb.to(f64)),
                 TOL_BF16_IN, (tokens, ffn)))

    # an f64 tree: (x - mean) * rstd at 4096 x 768
    x64 = randn(tokens, d).to(f64) * 1e3
    m64 = x64.mean(dim=1, keepdim=True)
    r64 = torch.rsqrt(x64.var(dim=1, unbiased=False, keepdim=True) + 1e-12)

    def norm64(idx):
        xt.meqn_push_back_binary_op(idx, B.MUL, dtype=D.F64)
        xt.meqn_push_back_binary_op(idx, B.SUB, dtype=D.F64)
        push_args(idx, [(tokens, d), (tokens, 1), (tokens, 1)], D.F64)

    tree(f"(x - mean) * rstd {tokens}x{d} f64", norm64, (tokens, d, D.F64),
         (x64, m64, r64), against((x64 - m64) * r64, TOL_F64, (tokens, d)))

    _no_launches("equation path")
    print(f"equation path: {len(phases)} trees in "
          f"{time.perf_counter() - t_path:.2f} s, no kernel launch")


def _moe_reference(params, x, dispatch, combine):
    """The MoE forward in float64 with the run's own dispatch and combine
    tensors (a near-tie decided the other way in float64 does not count):
    panels, the ReLU expert FFN, the combine."""
    f64 = torch.float64
    xe = torch.einsum("sec,sd->ecd", dispatch.to(f64), x.to(f64))
    h = torch.matmul(xe, params["w1"].to(f64)) + params["b1"].to(f64)[:, None]
    ye = (torch.matmul(h.clamp_min(0), params["w2"].to(f64))
          + params["b2"].to(f64)[:, None])
    return torch.einsum("sec,ecd->sd", combine.to(f64), ye)


def _moe_seating(gates, top_k, cap, dispatch, combine):
    """The routing, checked on the host: each token's experts are the top of
    its f32 gates (the lower index first among ties), and each expert seats
    its tokens in arrival order (every first choice before any second
    choice) until its capacity is full; the combine weight is the seated
    gate (renormalized over the top two for top-2). Returns the tokens
    dropped (choices not seated)."""
    import numpy as np

    g = gates.cpu().numpy()
    order = np.argsort(-g, axis=-1, kind="stable")[:, :top_k]
    vals = np.take_along_axis(g, order, axis=-1)
    if top_k > 1:
        vals = vals / vals.sum(axis=-1, keepdims=True)
    s, e = g.shape
    want_d = np.zeros((s, e, cap), np.float32)
    want_c = np.zeros((s, e, cap), np.float32)
    fill = np.zeros(e, np.int64)
    dropped = 0
    for r in range(top_k):
        for t in range(s):
            ex = order[t, r]
            if fill[ex] < cap:
                want_d[t, ex, fill[ex]] = 1.0
                want_c[t, ex, fill[ex]] = vals[t, r]
                fill[ex] += 1
            else:
                dropped += 1
    if not np.array_equal(dispatch.cpu().numpy(), want_d):
        raise AssertionError("moe: the dispatch left the gates' top choices "
                             "or the arrival order")
    if np.abs(combine.cpu().numpy() - want_c).max() > 1e-6:
        raise AssertionError("moe: combine weights differ from the gates")
    return dropped


def moe_path(randn, dev, ms):
    """TPP-MoE at Switch-Base-8's widths (Fedus, Zoph and Shazeer 2021,
    google/switch-base-8: d_model 768, d_ff 3072, 8 experts, ReLU FFN),
    capacity factor 1.25, 8 x 512 tokens, with every kernel's launch count
    set to 0 just before and read just after (the model runs on torch ops:
    none may change): served top-1 (Switch) in bf16, top-2 (GShard) at the
    same widths, f32 at 2 x 512, each against a float64 forward with the
    run's own dispatch and combine; the routing checked on the host; f32 at
    a capacity that covers the draw against reference_forward; three bf16
    train_steps (finite losses, the parameters changed, the first step's
    gradients against float64's). Prints the time per forward and per
    step and the device's busy share over three steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from libxsmm_torch.descriptor import UnaryType
    from libxsmm_torch.models import tpp_moe as MOE

    phases = []
    _reset_all_launches()
    t_path = time.perf_counter()
    d, ffn, experts = 768, 3072, 8
    base = dict(dim=d, hidden=ffn, n_experts=experts, capacity_factor=1.25,
                activation=UnaryType.RELU)

    def route(params, x, cfg):
        logits = torch.matmul(x.float(), params["wg"].float())
        gates = torch.softmax(logits, dim=-1)
        cap = MOE.capacity(cfg, x.shape[0])
        return gates, cap, MOE._route(logits, experts, cap, cfg.top_k)

    def serve(name, cfg, tokens, tol):
        params = MOE.init_params(cfg, seed=0, device=dev)
        x = randn(tokens, d, dtype=getattr(torch, cfg.dtype))
        y, aux = MOE.forward(params, x, cfg)
        torch.cuda.synchronize()
        gates, cap, (dsp, cmb, aux2) = route(params, x, cfg)
        if not torch.equal(aux, aux2):
            raise AssertionError(f"moe {name}: aux loss not repeatable")
        dropped = _moe_seating(gates, cfg.top_k, cap, dsp, cmb)
        err = _check(f"moe {name} vs float64", _moe_reference(
            params, x, dsp, cmb), y, tol, (tokens, d))
        t = ms(MOE.forward, params, x, cfg)
        print(f"  moe {name}: {t:.4f} ms per forward, normf_rel {err:.2e} "
              f"vs float64 (the run's routing), capacity {cap}, "
              f"{dropped} of {cfg.top_k * tokens} choices dropped, aux "
              f"{float(aux):.4f}")
        phases.append((f"moe {name}", MOE.forward, (params, x, cfg)))
        return params, x

    tokens = 8 * 512
    top1 = MOE.MoeConfig(**base, top_k=1, dtype="bfloat16")
    params, x = serve(f"top-1 bf16 {tokens} tokens", top1, tokens,
                      TOL_MOE_BF16)
    # where a forward's device time goes, by kernel (torch.profiler)
    split = device_split(lambda: MOE.forward(params, x, top1), reps=5)
    busy = sum(split.values())
    top = sorted(split.items(), key=lambda kv: -kv[1])[:6]
    print(f"  moe top-1 bf16 forward by kernel: {busy:.4f} ms of device "
          f"time in {len(split)} kernel names; top: " + "; ".join(
              f"{n[:50]} {v:.4f} ({100 * v / busy:.1f}%)" for n, v in top)
          if busy else "  moe top-1 bf16 forward by kernel: not measured "
          "(the profiler recorded no kernel)")
    serve(f"top-2 bf16 {tokens} tokens", MOE.MoeConfig(
        **base, top_k=2, dtype="bfloat16"), tokens, TOL_MOE_BF16)
    serve("top-1 f32 1024 tokens", MOE.MoeConfig(**base, top_k=1), 1024,
          TOL_F32)

    # capacity covering the draw (C = S): the per-token oracle
    wide = MOE.MoeConfig(**{**base, "capacity_factor": float(experts)},
                         top_k=1)
    wp = MOE.init_params(wide, seed=1, device=dev)
    wx = randn(1024, d)
    wy, _ = MOE.forward(wp, wx, wide)
    want = torch.as_tensor(MOE.reference_forward(wp, wx, wide), device=dev)
    err = _check("moe f32 vs reference_forward", want, wy, TOL_F32,
                 (1024, d))
    print(f"  moe f32 1024 tokens, capacity {MOE.capacity(wide, 1024)} (no "
          f"drop): normf_rel {err:.2e} vs reference_forward")

    # three bf16 train steps (Switch top-1): the first step's gradients
    # against a float64 loss with the run's routing, then the steps
    y = randn(tokens, d, dtype=torch.bfloat16)
    loss0, grads = MOE.loss_and_grads(params, x, y, top1)
    gates, cap, (dsp, _, _) = route(params, x, top1)
    leaves = {k: v.detach().to(torch.float64).requires_grad_(True)
              for k, v in params.items()}
    with torch.enable_grad():
        g64 = torch.softmax(x.to(torch.float64) @ leaves["wg"], dim=-1)
        pred = _moe_reference(leaves, x, dsp, dsp * g64[:, :, None])
        first = torch.nn.functional.one_hot(
            MOE._top_k(gates, 1)[1][:, 0], experts).to(torch.float64)
        aux64 = experts * torch.sum(first.mean(dim=0) * g64.mean(dim=0))
        loss64 = (torch.mean((pred - y.to(torch.float64)) ** 2)
                  + top1.aux_loss_weight * aux64)
        want = torch.autograd.grad(loss64, [leaves[k] for k in grads])
    errs = {k: _check(f"moe grad {k} vs float64", w_, grads[k],
                      TOL_GRAD_BF16) for k, w_ in zip(grads, want)}
    loss64 = loss64.detach()
    if abs(float(loss0) - float(loss64)) > 1e-2 * abs(float(loss64)):
        raise AssertionError(f"moe: loss {float(loss0)} vs float64 "
                             f"{float(loss64)}")
    step_params, losses = params, []
    for _ in range(3):
        new, loss = MOE.train_step(step_params, x, y, top1, 1e-1)
        if not bool(torch.isfinite(loss)):
            raise AssertionError("moe train_step: non-finite loss")
        if any(torch.equal(new[k], step_params[k]) for k in ("wg", "w1",
                                                              "w2")):
            raise AssertionError("moe train_step: a weight did not change")
        step_params = new
        losses.append(float(loss))
    phases.append(("moe train_step bf16", MOE.train_step,
                   (params, x, y, top1, 1e-1)))
    t_step = ms(MOE.train_step, params, x, y, top1, 1e-1)

    def steps(n=3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = params
        for _ in range(n):
            p, _ = MOE.train_step(p, x, y, top1, 1e-1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    steps()
    wall = steps()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps()
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3 / 3
    share = (f"device busy {busy:.4f} ms a step, {100 * busy / wall:.1f}% "
             "of the wall" if busy else "device busy not measured (the "
             "profiler recorded no kernel)")
    print(f"  moe train_step bf16 {tokens} tokens: losses "
          + ", ".join(f"{v:.6f}" for v in losses)
          + f"; grads vs float64 normf_rel "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f"; {t_step:.4f} ms per step (events), wall {wall:.4f} ms a "
          f"step over 3, {share}")

    _no_launches("moe path")
    print(f"moe path: {len(phases)} phases in "
          f"{time.perf_counter() - t_path:.2f} s, no kernel launch")


# the parallel layer's full-width cases: bench.py:558's flash shape (bh,
# s, hd); bench.py:691's bcsc20 (m = k, block, density) with n = 1024;
# the pipeline at BERT-base's width, 8 microbatches of 512 rows
PAR_ATTN = (16, 2048, 128)
PAR_SPMM = (1024, 32, 0.2, 1024)
PAR_PIPE = (768, 8, 512)
PIPE_LR = 10.0        # the loss visibly lower after three steps in bf16
PAR_WORLD = 4         # the gloo world on the one card


def _par_check(res, name, ref, out, margin):
    res["err"][name] = _check(name, ref, out, margin)


def _par_attention(res, randn, world, dev):
    """Ring and Ulysses attention: bf16 and f32 forwards (causal and not)
    and gradients (bf16 causal, f32 not), each rank's block against the
    float64 composition on the full inputs; the logged bytes of every
    forward against its comm model. Returns the timed calls."""
    from libxsmm_torch.kernels import attention as KA
    from libxsmm_torch.ops.attention import _naive
    from libxsmm_torch.parallel import collectives as C
    from libxsmm_torch.parallel.mesh import make_mesh
    from libxsmm_torch.parallel.ring_attention import (
        make_ring_attention, ring_comm_bytes_per_device)
    from libxsmm_torch.parallel.ulysses import (
        make_ulysses_attention, ulysses_comm_bytes_per_device)

    bh, s, hd = PAR_ATTN
    mesh = make_mesh([("sp", world)])
    idx, s_loc = mesh.index("sp"), s // world
    seq = slice(idx * s_loc, (idx + 1) * s_loc)
    full = [randn(bh, s, hd), randn(bh, hd, s), randn(bh, s, hd)]
    dout = randn(bh, s, hd)
    # the gradients' blocks: q and v split on the sequence, kT on its last
    blocks = ((slice(None), seq), (slice(None), slice(None), seq),
              (slice(None), seq))
    calls = []
    for dt, tol, tol_g, grad_causal in (
            (torch.bfloat16, TOL_BF16_OUT, TOL_GRAD_BF16, True),
            (torch.float32, TOL_F32, TOL_GRAD_F32, False)):
        ops = [t.to(dt) for t in full]
        for causal in (False, True):
            leaves = [t.double().requires_grad_(causal == grad_causal)
                      for t in ops]
            ref = _naive(*leaves, hd ** -0.5, causal)
            if causal == grad_causal:
                rgrads = torch.autograd.grad((ref * dout.double()).sum(),
                                             leaves)
            ref = ref.detach()
            for name, make, model in (
                    ("ring", make_ring_attention,
                     ring_comm_bytes_per_device),
                    ("ulysses", make_ulysses_attention,
                     ulysses_comm_bytes_per_device)):
                tag = f"{name} {str(dt)[6:]} causal={causal}"
                fn, _ = make(mesh, "sp", bh, s, hd, dt, causal=causal)
                C.reset_log()
                routes0 = _routes()
                out = fn(*ops).to_local()
                torch.cuda.synchronize()
                _took_route(tag, routes0, ("flash_attention_fwd",),
                            KA.flash_path(dt, hd))
                want = model(bh, s, hd, world, dt)
                if C.logged_bytes() != want:
                    raise AssertionError(f"{tag}: logged "
                                         f"{C.logged_bytes()} B, model "
                                         f"{want} B")
                _par_check(res, tag, ref[:, seq], out, tol)
                calls.append((f"{tag} forward", fn, ops))
                if causal != grad_causal:
                    continue
                gl = [t.clone().requires_grad_(True) for t in ops]
                routes0 = _routes()
                o = fn(*gl).to_local()
                grads = torch.autograd.grad(
                    (o.float() * dout[:, seq]).sum(), gl)
                torch.cuda.synchronize()
                _took_route(f"{tag} backward", routes0, BWD_KERNELS,
                            KA.flash_bwd_path(dt, hd))
                for i, (g, r, blk) in enumerate(zip(grads, rgrads, blocks)):
                    _par_check(res, f"{tag} grad[{i}]", r[blk], g[blk],
                               tol_g)
                calls.append((f"{tag} forward+backward", _fwd_bwd(fn, dout,
                                                                   seq), ops))
    return calls


def _fwd_bwd(fn, dout, seq):
    def call(*ops):
        gl = [t.detach().requires_grad_(True) for t in ops]
        o = fn(*gl).to_local()
        return torch.autograd.grad((o.float() * dout[:, seq]).sum(), gl)
    return call


def _par_spmm(res, world, dev, seed):
    """DistributedBsrSpmm at bcsc20 (ring, ring2, allgather) and the
    two-level form, each rank's rows against the float64 product, the
    logged bytes against comm_bytes_per_device; prints rank 0's overlap
    reports. Returns the timed calls."""
    import numpy as np

    from libxsmm_torch.ops.sparse import BsrMatrix
    from libxsmm_torch.parallel import collectives as C
    from libxsmm_torch.parallel import spmm_dist as SD
    from libxsmm_torch.parallel.mesh import make_mesh

    m, blk, density, n = PAR_SPMM
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, m)).astype(np.float32)
    keep = rng.random((m // blk, m // blk)) < density
    a *= np.kron(keep, np.ones((blk, blk), np.float32))
    bsr = BsrMatrix.from_dense(a, blk, blk)
    x = torch.as_tensor(rng.standard_normal((m, n)).astype(np.float32),
                        device=dev)
    ref = torch.as_tensor(a, device=dev).double() @ x.double()
    flat = make_mesh([("x", world)])
    two = make_mesh([("dcn", max(world // 2, 1)), ("ici", min(world, 2))])
    calls = []
    for name, spmm, band in (
            [(f"spmm {c}", SD.DistributedBsrSpmm(bsr, n, flat, comm=c),
              flat.index("x")) for c in ("ring", "ring2", "allgather")]
            + [(f"spmm 2-level {c}",
                SD.DistributedBsrSpmm2Level(bsr, n, two, comm=c),
                two.index("dcn") * two.shape["ici"] + two.index("ici"))
               for c in ("ring2", "ring")]):
        C.reset_log()
        out = spmm(x).to_local()
        torch.cuda.synchronize()
        if C.logged_bytes() != spmm.comm_bytes_per_device():
            raise AssertionError(f"{name}: logged {C.logged_bytes()} B, "
                                 f"model {spmm.comm_bytes_per_device()} B")
        rows = m // spmm.num_devices
        _par_check(res, name, ref[band * rows:(band + 1) * rows], out,
                   TOL_SPARSE_F32)
        res["reports"][name] = spmm.overlap_report(x)
        calls.append((name, spmm, (x,)))
    res["nnz"] = bsr.nnz
    return calls


def _pipe_reference(params, xs, ys, cfg):
    """The plain single-device composition in float64: (loss, the
    gradients of w and b)."""
    from libxsmm_torch.descriptor import UnaryFlags
    from libxsmm_torch.ops.eltwise import apply_unary_op
    w, b = (params[k].double().requires_grad_(True) for k in ("w", "b"))
    x = xs.double()
    for p in range(cfg.n_stages):
        x = apply_unary_op(cfg.activation, UnaryFlags.NONE, x @ w[p] + b[p])
    loss = torch.mean((x - ys.double()) ** 2)
    return (loss.detach(),) + torch.autograd.grad(loss, (w, b))


def _par_pipeline(res, randn, world, dev, seed):
    """The GPipe pipeline at BERT-base's width in bf16 and f32: a forward
    on P stages (P = the world) and, on pp x dp (2 x 2 in a world of 4),
    a forward, the gradients against float64 and three train steps that
    lower the loss. Returns the timed calls."""
    from libxsmm_torch.parallel import collectives as C
    from libxsmm_torch.parallel import pipeline as PP
    from libxsmm_torch.parallel.mesh import make_mesh

    d, micro, rows = PAR_PIPE
    meshes = [([("pp", world)], None)]
    if world == 4:
        meshes.append(([("pp", 2), ("dp", 2)], "dp"))
    calls = []
    for shape, dp in meshes:
        mesh = make_mesh(shape)
        pn = mesh.shape["pp"]
        ndp = mesh.shape[dp] if dp else 1
        didx = mesh.index(dp) if dp else 0
        last = mesh.index("pp") == pn - 1
        rsl = slice(didx * rows // ndp, (didx + 1) * rows // ndp)
        for dtype, tol, tol_g in (("bfloat16", TOL_BF16_OUT, TOL_GRAD_BF16),
                                  ("float32", TOL_F32, TOL_GRAD_F32)):
            cfg = PP.PipelineConfig(dim=d, n_stages=pn, n_micro=micro,
                                    micro_batch=rows, dtype=dtype)
            dt = getattr(torch, dtype)
            params = PP.init_params(cfg, seed=seed, device=dev)
            xs, ys = randn(micro, rows, d).to(dt), randn(micro, rows, d).to(dt)
            tag = f"pipeline {'x'.join(str(s_) for _, s_ in shape)} {dtype}"
            fwd = PP.make_pipeline_forward(cfg, mesh, dp_axis=dp)
            sharded = PP.shard_params(params, mesh)
            C.reset_log()
            out = fwd(sharded, xs).to_local()
            torch.cuda.synchronize()
            model = PP.pipeline_comm_bytes_per_device(cfg, ndp)
            if C.logged_bytes() != model:
                raise AssertionError(f"{tag}: logged {C.logged_bytes()} B, "
                                     f"model {model} B")
            want = (PP.reference_forward(params, xs, cfg)[:, rsl] if last
                    else torch.zeros_like(out))
            _par_check(res, f"{tag} forward", want, out,
                       tol if last else TOL_EXACT)
            calls.append((f"{tag} forward", fwd, (sharded, xs)))
            if dp is None and world > 1:
                continue
            vg = PP.make_pipeline_value_and_grad(cfg, mesh, dp_axis=dp)
            loss, grads = vg(sharded, xs, ys)
            rloss, rgw, rgb = _pipe_reference(params, xs, ys, cfg)
            st = mesh.index("pp")
            _par_check(res, f"{tag} loss", rloss.reshape(1),
                       loss.reshape(1), tol)
            _par_check(res, f"{tag} grad w", rgw[st], grads["w"][0], tol_g)
            _par_check(res, f"{tag} grad b", rgb[st], grads["b"][0], tol_g)
            step, _ = PP.make_pipeline_train_step(cfg, mesh, dp_axis=dp,
                                                  lr=PIPE_LR)
            # three steps, then the loss at the stepped parameters
            p, losses = sharded, []
            for _ in range(3):
                p, loss = step(p, xs, ys)
                losses.append(float(loss))
            losses.append(float(vg(p, xs, ys)[0]))
            if not all(b_ < a_ for a_, b_ in zip(losses, losses[1:])):
                raise AssertionError(f"{tag}: losses {losses} do not fall")
            res["losses"][tag] = losses
            calls.append((f"{tag} train step", step, (sharded, xs, ys)))
    return calls


def parallel_cases(seed, reps=20, rounds=3):
    """The parallel layer at full width in this process's world (a one-rank
    NCCL world, or a rank of the gloo world on the card): ring and Ulysses
    attention, the distributed SpMM (flat and two-level) and the pipeline,
    each rank's outputs held against the plain single-device composition,
    its logged collective bytes against the comm models, and the flash
    forward and backward kernels' launch counts (set to 0 just before)
    required to have moved. Then times every call (CUDA events, the best of
    `rounds` windows of `reps` calls; every rank makes the same calls, so
    their collectives match). Any failure raises."""
    import torch.distributed as dist

    from libxsmm_torch.kernels import attention as KA
    from libxsmm_torch.scripts.timing import events_ms

    world = dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    res = {"rank": dist.get_rank(), "world": world,
           "backend": dist.get_backend(), "err": {}, "reports": {},
           "losses": {}, "ms": {}}
    _reset_all_launches()
    calls = _par_attention(res, randn, world, dev)
    res["counts"] = {k: KA.launches[k] for k in KA.launches}
    missing = [k for k, c in res["counts"].items() if c == 0]
    if missing:
        raise AssertionError(f"rank {res['rank']}: {missing} not launched "
                             f"in the ring and Ulysses")
    calls += _par_spmm(res, world, dev, seed)
    calls += _par_pipeline(res, randn, world, dev, seed)
    torch.cuda.synchronize()
    # the SpMM and the pipeline run on torch ops: no kernel count moved
    after = {k: v for k, v in _all_launches().items() if v}
    if after != {k: v for k, v in res["counts"].items() if v}:
        raise AssertionError(f"launch counts moved past the attention: "
                             f"{after}")
    for name, fn, fargs in calls:
        res["ms"][name] = events_ms(lambda: fn(*fargs), reps, rounds)
    return res


# phase 13, the sharded models at full width, each against the port's
# single-device step on the same card from the same seed: the TPP paper's
# encoder block at BERT-base widths (Devlin et al. 2018: d 768, 12 heads of
# 64, FFN 3072), 8 x 512 tokens, bf16, flash, dropout 0.1; TPP-MLP at
# MlpConfig()'s widths (batch 512) in f32 and bf16; TPP-CNN at the GEMM-ext
# path's model (EXT_SHAPES["cnn"]: batch 32, 56 x 56 x 64, two 3x3 convs);
# TPP-GCN at Cora's widths (1433-16-7) on the seeded graph, 1 x 1 blocks so
# its 2708 rows split over 4; TPP-MoE at Switch-Base-8 (d 768, FFN 3072, 8
# experts, capacity 1.25, ReLU), 8 x 512 tokens, bf16
SH_ENC = (768, 12, 4, 8, 512)   # dim, heads, ffn_mult, batch, seq
SH_LR = 0.1                     # updates visible in bf16 weights
SH_MLP_BATCH = 512
SH_MOE = (768, 3072, 8, 1.25, 8 * 512)
SHARD_KERNELS = FLASH_KERNELS + ("dropout",)
TOL_SHARD_F32 = 1e-5   # f32 sharded step against the single-device step:
                       # the tp and dp sums add f32 partials in another order
TOL_SHARD_UPD = 1e-4   # f32 updates (new - old) against the single-device
                       # step's, relative over all blocks: the gradients
                       # differ by the sums' order alone


def _sh_hold(res, tag, mesh, specs, new, loss, want_new, want_loss, old,
             tol, tol_upd):
    """Hold a sharded step against the single-device one: the loss and
    each parameter block within `tol` (matdiff), and the update (new -
    old) over all blocks together within `tol_upd` of the single-device
    step's, as ||got - want|| / ||want||, with no absolute escape (an
    update is small beside its weight). tol_upd None records the update's
    error and holds it to nothing: a bf16 weight rounds its update to a
    few ulps, and a partial sum's order moves some by one."""
    from libxsmm_torch.parallel import spmd
    shards = spmd.shardings(mesh, specs)
    got = spmd._items(spmd.local_tree(new, shards))
    want = dict(spmd._items(spmd.local_tree(want_new, shards)))
    before = dict(spmd._items(spmd.local_tree(old, shards)))
    res["err"][f"{tag} loss"] = _check(f"{tag} loss", want_loss.reshape(1),
                                       loss.reshape(1), tol)
    worst, diff, norm = 0.0, 0.0, 0.0
    for path, g in got:
        name = f"{tag} {'.'.join(map(str, path))}"
        worst = max(worst, _check(name, want[path], g, tol))
        upd_w = want[path].double() - before[path].double()
        upd_g = g.double() - before[path].double()
        diff += float(((upd_g - upd_w) ** 2).sum())
        norm += float((upd_w ** 2).sum())
    rel = (diff / norm) ** 0.5 if norm else 0.0
    if tol_upd is not None and not rel <= tol_upd:
        raise AssertionError(f"{tag}: the update differs from the "
                             f"single-device step's by {rel:.3e} (> "
                             f"{tol_upd})")
    res["err"][f"{tag} params"] = worst
    res["err"][f"{tag} updates"] = rel


def _sh_encoder(res, randn, world, dev, seed):
    """The encoder block's sharded step (dp 2 x tp 2 in a world of 4, dp 1
    x tp 1 in one): the launch counts of the flash kernels and the dropout
    set to 0 just before it and read just after; the loss and this rank's
    parameter blocks against the single-device train_step; the logged
    bytes against encoder_comm_bytes_per_device. Returns the timed calls."""
    from libxsmm_torch.models import tpp_attention as TA
    from libxsmm_torch.parallel import collectives as C
    from libxsmm_torch.parallel.mesh import make_mesh

    d, nh, mult, b, s = SH_ENC
    dp, tp = (2, 2) if world == 4 else (1, 1)
    mesh = make_mesh([("dp", dp), ("tp", tp)])
    cfg = TA.AttentionConfig(dim=d, heads=nh, ffn_mult=mult, dropout_p=0.1,
                             dtype="bfloat16", flash=True)
    params = TA.init_params(cfg, seed=seed, device=dev)
    x = randn(b, s, d).to(torch.bfloat16)
    y = randn(b, s, d, scale=0.1).to(torch.bfloat16)
    step, _ = TA.make_sharded_train_step(cfg, mesh, lr=SH_LR, seed=seed)
    sharded = TA.shard_params(params, mesh)
    _reset_all_launches()
    C.reset_log()
    new, loss = step(sharded, x, y)
    torch.cuda.synchronize()
    res["counts"] = {k: _count(k) for k in SHARD_KERNELS}
    missing = [k for k, c in res["counts"].items() if c == 0]
    if missing:
        raise AssertionError(f"rank {res['rank']}: {missing} not launched "
                             f"in the sharded encoder step")
    model = TA.encoder_comm_bytes_per_device(cfg, b, s, dp, tp)
    if C.logged_bytes() != model:
        raise AssertionError(f"encoder dp {dp} x tp {tp}: logged "
                             f"{C.logged_bytes()} B, model {model} B")
    res["bytes"]["encoder"] = model
    want_new, want_loss = TA.train_step(params, x, y, cfg, lr=SH_LR,
                                        seed=seed)
    tag = f"encoder dp {dp} x tp {tp}"
    _sh_hold(res, tag, mesh, TA._PARAM_SPECS, new, loss, want_new,
             want_loss, params, TOL_BF16_OUT, None)
    res["losses"][tag] = (float(loss), float(want_loss))
    calls = [(f"{tag} step", step, (sharded, x, y)),
             ("encoder single-device step",
              lambda *a: TA.train_step(*a, cfg, lr=SH_LR, seed=seed),
              (params, x, y))]
    # the same step in f32 (the f32 flash kernels), where the update is
    # held to the single-device step's: bf16 weights round it away
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = TA.init_params(cfg32, seed=seed, device=dev)
    x32, y32 = x.float(), y.float()
    step32, _ = TA.make_sharded_train_step(cfg32, mesh, lr=SH_LR, seed=seed)
    new, loss = step32(TA.shard_params(p32, mesh), x32, y32)
    want_new, want_loss = TA.train_step(p32, x32, y32, cfg32, lr=SH_LR,
                                        seed=seed)
    _sh_hold(res, f"{tag} f32", mesh, TA._PARAM_SPECS, new, loss, want_new,
             want_loss, p32, TOL_SHARD_F32, TOL_SHARD_UPD)
    return calls


def _sh_models(res, randn, world, dev, seed):
    """TPP-MLP (dp 2 x tp 2), TPP-CNN (dp 4) and TPP-GCN (sp 4), or one
    rank of each: each sharded step against its single-device step.
    Returns the timed calls."""
    import numpy as np

    from libxsmm_torch.models import tpp_cnn as TC
    from libxsmm_torch.models import tpp_gcn as TG
    from libxsmm_torch.models import tpp_mlp as TM
    from libxsmm_torch.parallel.mesh import P, make_mesh

    calls = []
    two = 2 if world == 4 else 1
    mesh = make_mesh([("dp", two), ("tp", two)])
    for dtype, tol, tol_u in (("float32", TOL_SHARD_F32, TOL_SHARD_UPD),
                              ("bfloat16", TOL_BF16_OUT, None)):
        cfg = TM.MlpConfig(dtype=dtype)
        dt = getattr(torch, dtype)
        params = TM.init_params(cfg, seed=seed, device=dev)
        x = randn(SH_MLP_BATCH, cfg.in_dim).to(dt)
        y = randn(SH_MLP_BATCH, cfg.out_dim, scale=0.1).to(dt)
        step, _ = TM.make_sharded_train_step(cfg, mesh, lr=SH_LR)
        sharded = TM.shard_params(params, mesh)
        new, loss = step(sharded, x, y)
        want_new, want_loss = TM.train_step(params, x, y, cfg, lr=SH_LR)
        tag = f"mlp {dtype} dp {two} x tp {two}"
        _sh_hold(res, tag, mesh, TM._specs(len(params)), new, loss,
                 want_new, want_loss, params, tol, tol_u)
        calls.append((f"{tag} step", step, (sharded, x, y)))

    n, h, w, c, k, r = EXT_SHAPES["cnn"]
    cfg = TC.CnnConfig(height=h, width=w, channels=c,
                       filters=((r, k), (r, k)), strides=(1, 2),
                       classes=1000)
    mesh = make_mesh([("dp", world)])
    params = TC.init_params(cfg, seed=seed, device=dev)
    x = randn(n, h, w, c)
    labels = torch.randint(0, 1000, (n,), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               seed))
    step, _ = TC.make_sharded_train_step(cfg, mesh, lr=CNN_LR)
    new, loss = step(params, x, labels)
    want_new, want_loss = TC.train_step(params, x, labels, cfg, lr=CNN_LR)
    tag = f"cnn dp {world}"
    specs = [{"w": P(None), "b": P(None)} for _ in params]
    _sh_hold(res, tag, mesh, specs, new, loss, want_new, want_loss, params,
             TOL_SHARD_F32, TOL_SHARD_UPD)
    calls.append((f"{tag} step", step, (params, x, labels)))

    rng = np.random.default_rng(seed)
    nodes = CORA[0]
    bsr = TG.normalize_adjacency(_cora_adjacency(rng), 1)
    plan = TG._bsr_plan(bsr, dev)
    cfg = TG.GcnConfig(in_dim=1433, hidden=(16,), out_dim=7)
    mesh = make_mesh([("sp", world)])
    params = TG.init_params(cfg, seed=seed, device=dev)
    hx = randn(nodes, 1433)
    labels = torch.as_tensor(rng.integers(0, 7, nodes), device=dev)
    step, _, _ = TG.make_sharded_train_step(cfg, mesh, plan, nodes, 1e-2)
    new, loss = step(params, hx, labels)
    want_new, want_loss = TG.train_step(params, plan, nodes, hx, labels, cfg,
                                        1e-2)
    tag = f"gcn sp {world}"
    specs = [{"w": P(None), "b": P(None)} for _ in params]
    _sh_hold(res, tag, mesh, specs, new, loss, want_new, want_loss, params,
             TOL_SHARD_F32, TOL_SHARD_UPD)
    calls.append((f"{tag} step", step, (params, hx, labels)))
    return calls


def _a2a_emulated_step(MOE, params, x, y, cfg, shards, lr):
    """The a2a step's semantics on one device: each of `shards` token
    blocks routed alone (its local capacity, MOE.forward on its tokens),
    the squared error over the global batch plus the mean of the blocks'
    aux, one SGD step."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        mse, aux = 0.0, 0.0
        for xs, ys in zip(x.chunk(shards), y.chunk(shards)):
            pred, a = MOE.forward(leaves, xs, cfg)
            mse = mse + torch.sum((pred.float() - ys.float()) ** 2)
            aux = aux + a
        loss = mse / (x.shape[0] * cfg.dim) + cfg.aux_loss_weight * aux \
            / shards
        grads = torch.autograd.grad(loss, list(leaves.values()))
    with torch.no_grad():
        new = {k: (params[k] - lr * g).to(params[k].dtype)
               for k, g in zip(leaves, grads)}
    return new, loss.detach()


def _sh_moe(res, randn, world, dev, seed):
    """TPP-MoE at Switch-Base-8 in bf16: the einsum variant on dp 2 x ep 2
    against the unsharded train_step, the a2a variant on ep 4 (forward
    against the unsharded forward on each rank's tokens, the step against
    its single-device emulation), and pick_moe_variant's pick (or one rank
    of each). Returns the timed calls."""
    from libxsmm_torch.descriptor import UnaryType
    from libxsmm_torch.models import tpp_moe as MOE
    from libxsmm_torch.parallel import collectives as C
    from libxsmm_torch.parallel.mesh import make_mesh

    d, ffn, experts, cf, tokens = SH_MOE
    cfg = MOE.MoeConfig(dim=d, hidden=ffn, n_experts=experts,
                        capacity_factor=cf, activation=UnaryType.RELU,
                        dtype="bfloat16")
    params = MOE.init_params(cfg, seed=seed, device=dev)
    x = randn(tokens, d).to(torch.bfloat16)
    y = randn(tokens, d, scale=0.1).to(torch.bfloat16)
    calls = []
    two = 2 if world == 4 else 1
    mesh = make_mesh([("dp", two), ("ep", two)])
    step, _ = MOE.make_sharded_train_step(cfg, mesh, lr=SH_LR)
    sharded = MOE.shard_params(params, mesh)
    new, loss = step(sharded, x, y)
    want_new, want_loss = MOE.train_step(params, x, y, cfg, lr=SH_LR)
    tag = f"moe einsum dp {two} x ep {two}"
    _sh_hold(res, tag, mesh, MOE._param_specs("ep"), new, loss, want_new,
             want_loss, params, TOL_BF16_OUT, None)
    calls.append((f"{tag} step", step, (sharded, x, y)))

    mesh = make_mesh([("ep", world)])
    sharded = MOE.shard_params(params, mesh)
    C.reset_log()
    ya2a, aux = MOE.forward_a2a(sharded, x, cfg, mesh)
    idx = mesh.index("ep")
    mine = x.chunk(world)[idx]
    want_y, _ = MOE.forward(params, mine, cfg)
    tag = f"moe a2a ep {world}"
    res["err"][f"{tag} forward"] = _check(f"{tag} forward", want_y,
                                          ya2a.to_local(), TOL_BF16_OUT)
    model = MOE.moe_a2a_comm_bytes_per_device(cfg, tokens // world, world)
    got = C.logged_bytes("all_to_all")
    if got != model:
        raise AssertionError(f"{tag}: logged {got} B of all-to-alls, model "
                             f"{model} B")
    res["bytes"]["moe a2a"] = model
    step, _ = MOE.make_sharded_train_step(cfg, mesh, dp_axis=None,
                                          lr=SH_LR, variant="a2a")
    new, loss = step(sharded, x, y)
    want_new, want_loss = _a2a_emulated_step(MOE, params, x, y, cfg, world,
                                             SH_LR)
    _sh_hold(res, tag, mesh, MOE._param_specs("ep"), new, loss, want_new,
             want_loss, params, TOL_BF16_OUT, None)
    calls.append((f"{tag} step", step, (sharded, x, y)))
    calls.append(("moe single-device step",
                  lambda *a: MOE.train_step(*a, cfg, lr=SH_LR),
                  (params, x, y)))
    pick = MOE.pick_moe_variant(cfg, make_mesh([("dp", two), ("ep", two)]),
                                tokens)
    res["pick"] = pick
    return calls


def sharded_cases(seed, reps=5, rounds=2):
    """Phase 13 in this process's world (a one-rank NCCL world, or a rank
    of the gloo world on the card): the encoder block's sharded step, with
    the flash forward, dK/dV, dQ and dropout launch counts set to 0 just
    before and read just after, then TPP-MLP, TPP-CNN, TPP-GCN and TPP-MoE
    (torch ops: no launch count may move), each rank's loss and parameter
    blocks held against the single-device step on the card, logged bytes
    against their analytic counts; then each step timed (CUDA events, the
    best of `rounds` windows of `reps` calls; every rank makes the same
    calls). Any failure raises."""
    import torch.distributed as dist

    from libxsmm_torch.scripts.timing import events_ms

    world = dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    res = {"rank": dist.get_rank(), "world": world, "err": {}, "bytes": {},
           "losses": {}, "ms": {}}
    calls = _sh_encoder(res, randn, world, dev, seed)
    _reset_all_launches()
    calls += _sh_models(res, randn, world, dev, seed)
    calls += _sh_moe(res, randn, world, dev, seed)
    torch.cuda.synchronize()
    moved = {k: v for k, v in _all_launches().items() if v}
    if moved:
        raise AssertionError(f"launch counts moved in the torch-op models: "
                             f"{moved}")
    for name, fn, fargs in calls:
        res["ms"][name] = events_ms(lambda: fn(*fargs), reps, rounds)
    return res


def sharded_kernels(seed, smi):
    """The kernels of phase 13 in a block, on the card: the dropout on each
    of the four (dp 2 x tp 2) blocks of the FFN's (8 * 512, 3072) bf16
    hidden layer, bit for bit against its plain version, the four masks put
    together against the whole tensor's; flash forward and backward with
    the head map of rank (dp 1, tp 1)'s block of 8 x 12 heads at s 512, hd
    64, dropout 0.1, against their plain versions and, bit for bit, the
    whole tensor's kernels cut to the block's heads."""
    from libxsmm_torch.kernels import attention as KA
    from libxsmm_torch.kernels import eltwise as KE

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    d, nh, mult, b, s = SH_ENC
    rows, cols = b * s, mult * d
    full = randn(rows, cols).to(torch.bfloat16)
    _, whole = KE.dropout(full, 8, 0.1)
    grid = []
    for i in range(2):
        for j in range(2):
            off = (i * rows // 2, j * cols // 2)
            blk = full[off[0]:off[0] + rows // 2,
                       off[1]:off[1] + cols // 2].contiguous()
            block = ((rows, cols), off)
            got = KE.dropout(blk, 8, 0.1, block=block)
            _check(f"dropout block {off} kernel vs plain",
                   KE.dropout.plain(blk, 8, 0.1, block=block), got,
                   TOL_EXACT)
            grid.append(got[1])
    together = torch.cat([torch.cat(grid[:2], 1), torch.cat(grid[2:], 1)])
    if not torch.equal(together, whole):
        raise AssertionError("the four blocks' masks are not the whole mask")
    hd = d // nh
    q, kT, v, dout = (randn(*sh).to(torch.bfloat16) for sh in (
        (b * nh, s, hd), (b * nh, hd, s), (b * nh, s, hd), (b * nh, s, hd)))
    bl, nhl = b // 2, nh // 2
    idx = torch.tensor([(bl + i) * nh + nhl + h for i in range(bl)
                        for h in range(nhl)], device=q.device)
    hm = (bl, nhl, nhl, nh)
    kw = dict(dropout_p=0.1)
    fwd = KA.build_flash_attention(bl * nhl, s, hd, torch.bfloat16,
                                   return_lse=True, head_map=hm, **kw)
    ops = [t[idx].contiguous() for t in (q, kT, v)]
    out, lse = fwd(9, *ops)
    _check("flash head map vs plain", fwd.plain(9, *ops), (out, lse),
           TOL_BF16_OUT)
    whole_fwd = KA.build_flash_attention(b * nh, s, hd, torch.bfloat16,
                                         return_lse=True, **kw)
    w_out, w_lse = whole_fwd(9, q, kT, v)
    if not (torch.equal(out, w_out[idx]) and torch.equal(lse, w_lse[idx])):
        raise AssertionError("flash with a head map is not the whole "
                             "tensor's flash cut to the block")
    dl = dout[idx].contiguous()
    delta = (dl.float() * out.float()).sum(-1, keepdim=True).expand(
        bl * nhl, s, 128)
    bwd = KA.build_flash_attention_bwd(bl * nhl, s, hd, torch.bfloat16,
                                       head_map=hm, **kw)
    got = bwd(9, *ops, dl, lse, delta)
    _check("flash bwd head map vs plain", bwd.plain(9, *ops, dl, lse, delta),
           got, TOL_BF16_OUT)
    w_delta = (dout.float() * w_out.float()).sum(-1, keepdim=True).expand(
        b * nh, s, 128)
    w_bwd = KA.build_flash_attention_bwd(b * nh, s, hd, torch.bfloat16, **kw)
    for g, w in zip(got, w_bwd(9, q, kT, v, dout, w_lse, w_delta)):
        if not torch.equal(g, w[idx]):
            raise AssertionError("the flash backward with a head map is not "
                                 "the whole tensor's cut to the block")
    print(f"  sharded kernels: the dropout's four (dp 2 x tp 2) blocks of "
          f"({rows}, {cols}) bf16 bit-exact against their plain version and "
          f"together the whole mask; flash forward and backward with head "
          f"map {hm} at bh {bl * nhl}, s {s}, hd {hd}, dropout 0.1, within "
          f"{TOL_BF16_OUT} of their plain versions and bit for bit the "
          f"whole tensor's kernels cut to the block [{smi}]")


def global_position_forms(rows, ms, KA, KE, fq, fkT, fv, bargs, dx):
    """The dropout's and the flash kernels' rows beside their forms that
    hash global positions (phase 13's): the dropout on the same (4096,
    3072) bf16 x as the lower block of an (8192, 3072) tensor (block_ms,
    replayed block_graph_ms, block_host_ms); flash forward, dK/dV and dQ at
    the row's shape with dropout 0.1, without a head map (drop_ms) and
    with the head map (1, 4, 8, 16) (head_map_ms). Each form is held
    against its plain version first."""
    row = {r["name"]: r for r in rows}
    block = ((2 * dx.shape[0], dx.shape[1]), (dx.shape[0], 0))

    def blocked(t):
        return KE.dropout(t, 7, 0.1, block=block)

    _check("dropout block kernel vs plain",
           KE.dropout.plain(dx, 7, 0.1, block=block), blocked(dx), TOL_EXACT)
    row["dropout"].update(block_ms=ms(blocked, dx),
                          block_graph_ms=graph_ms(lambda: blocked(dx)),
                          block_host_ms=host_ms(lambda: blocked(dx)))
    bh, s, hd = fq.shape
    hm = (1, 4, 8, 16)
    for key, head_map in (("drop_ms", None), ("head_map_ms", hm)):
        fwd = KA.build_flash_attention(bh, s, hd, torch.bfloat16,
                                       dropout_p=0.1, head_map=head_map)
        _check(f"flash {key} kernel vs plain", fwd.plain(3, fq, fkT, fv),
               fwd(3, fq, fkT, fv), TOL_BF16_OUT)
        row["flash_attention_fwd"][key] = ms(fwd, 3, fq, fkT, fv)
        bwd = KA.build_flash_attention_bwd(bh, s, hd, torch.bfloat16,
                                           dropout_p=0.1, head_map=head_map)
        ops = (3,) + tuple(bargs[1:])
        _check(f"flash bwd {key} kernel vs plain", bwd.plain(*ops),
               bwd(*ops), TOL_BF16_OUT)
        row["flash_attention_bwd_dkv"][key] = ms(bwd.dkv, *ops)
        row["flash_attention_bwd_dq"][key] = ms(bwd.dq, *ops)
    r = row["dropout"]
    print(f"  global-position forms: dropout block {r['block_ms']:.4f} / "
          f"{r['block_graph_ms']:.4f} / {r['block_host_ms']:.4f} ms (events "
          f"/ replayed / host) beside bytes {r['ms']:.4f} / "
          f"{r['graph_ms']:.4f} / {r['host_ms']:.4f}; flash at dropout 0.1 "
          f"without / with head map {hm}: " + "; ".join(
              f"{n} {row[n]['drop_ms']:.4f} / {row[n]['head_map_ms']:.4f}"
              for n in FLASH_KERNELS))


def _sh_print(res, label):
    """Print phase 13's checks, bytes and times for one world."""
    print(f"  sharded ({label}) checks (normf_rel): " + "; ".join(
        f"{k} {v:.2e}" for k, v in res["err"].items()))
    print(f"  sharded ({label}) logged bytes a rank: {res['bytes']}; "
          f"losses (sharded, single device): {res['losses']}; "
          f"pick_moe_variant: {res['pick']}")


def parallel_rank(seed):
    """One rank of the gloo world on the card (run by run_ranks): phase
    12's cases, then phase 13's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = parallel_cases(seed, reps=5, rounds=2)
    res["sharded"] = sharded_cases(seed, reps=3, rounds=2)
    return res


def parallel_path(seed, smi):
    """The parallel layer twice: (a) a one-rank NCCL world in this process,
    with every kernel's launch count set to 0 just before and read just
    after; (b) four ranks over gloo on the card (the pipeline's pp x dp at
    2 x 2, the two-level SpMM at 2 x 2), each rank checking its outputs,
    bytes and launch counts. Prints NCCL's init time, (a)'s times beside
    flash alone at the same shape, and (b)'s times, which carry host
    staging and are no scaling figure. Returns (a)'s launch counts."""
    import torch.distributed as dist

    from libxsmm_torch.kernels import attention as KA
    from libxsmm_torch.parallel.mesh import distributed_init
    from libxsmm_torch.scripts.ranks import run_ranks
    from libxsmm_torch.scripts.timing import events_ms

    t_path = time.perf_counter()
    t0 = time.perf_counter()
    distributed_init(backend="nccl", device_type="cuda")
    one = torch.ones(1, device="cuda")
    dist.all_reduce(one)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    print(f"  parallel (a): NCCL one-rank world up in {t_init:.3f} s "
          f"(init_process_group and a first all-reduce) [{smi}]")
    res = parallel_cases(seed)
    # what the port's one-rank collectives leave out: NCCL's own one-rank
    # all-to-all of a Ulysses operand (8 MB bf16), called directly on the
    # world's group and on a mesh axis's group
    from libxsmm_torch.parallel.mesh import make_mesh
    x8 = torch.zeros(PAR_ATTN, dtype=torch.bfloat16, device="cuda")
    y8 = torch.empty_like(x8)
    for label, group in (("the world's group", None),
                         ("a mesh axis's group",
                          make_mesh([("sp", 1)]).group("sp"))):
        t_a2a = events_ms(lambda: dist.all_to_all_single(y8, x8,
                                                         group=group))
        print(f"  parallel (a): NCCL's one-rank all_to_all_single of 8 MB "
              f"on {label}, called directly (the port issues none on one "
              f"rank): {t_a2a:.4f} ms per call")
    # phase 13 in the same one-rank world
    t_sh = time.perf_counter()
    sh = sharded_cases(seed)
    dist.destroy_process_group()
    print(f"  parallel (a) launches in the ring and Ulysses: "
          f"{res['counts']}")
    print("  parallel (a) checks (normf_rel): " + "; ".join(
        f"{k} {v:.2e}" for k, v in res["err"].items()))
    for name, rep in res["reports"].items():
        print(f"  parallel (a) {name} overlap_report: {rep}")
    for name, losses in res["losses"].items():
        print(f"  parallel (a) {name} losses: "
              + ", ".join(f"{v:.6f}" for v in losses))
    bh, s, hd = PAR_ATTN
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ops = [torch.randn(*sh, generator=gen, device="cuda").to(torch.bfloat16)
           for sh in ((bh, s, hd), (bh, hd, s), (bh, s, hd))]
    alone = {}
    for causal in (False, True):
        k = KA.build_flash_attention(bh, s, hd, torch.bfloat16,
                                     causal=causal)
        alone[causal] = events_ms(lambda: k(0, *ops))
        print(f"  flash alone bf16 {PAR_ATTN} causal={causal}: "
              f"{alone[causal]:.4f} ms per call")
    for name, t in res["ms"].items():
        beside = ""
        for causal in (False, True):
            if (name.endswith(f"bfloat16 causal={causal} forward")):
                beside = (f" ({t / alone[causal]:.2f}x flash alone, "
                          f"{t - alone[causal]:.4f} ms of ring machinery)")
        print(f"  parallel (a) {name}: {t:.4f} ms per call{beside}")

    t0 = time.perf_counter()
    ranks = run_ranks(parallel_rank, PAR_WORLD, (seed,), device_type="cuda",
                      backend="gloo", timeout=600.0)
    print(f"  parallel (b): {PAR_WORLD} gloo ranks on one card in "
          f"{time.perf_counter() - t0:.2f} s; launches by rank "
          + "; ".join(f"{r['rank']}: {r['counts']}" for r in ranks))
    print("  parallel (b) worst check by case (normf_rel over the ranks): "
          + "; ".join(f"{k} {max(r['err'][k] for r in ranks):.2e}"
                      for k in ranks[0]["err"]))
    for name, rep in ranks[0]["reports"].items():
        print(f"  parallel (b) rank 0 {name} overlap_report: {rep}")
    for name, losses in ranks[0]["losses"].items():
        print(f"  parallel (b) {name} losses: "
              + ", ".join(f"{v:.6f}" for v in losses))
    for name in ranks[0]["ms"]:
        print(f"  parallel (b) {name}: "
              f"{max(r['ms'][name] for r in ranks):.4f} ms per call, the "
              f"slowest rank (gloo, staged, not scaling)")
    print(f"parallel path: {time.perf_counter() - t_path:.2f} s [{smi}]")

    # phase 13: the sharded models, (a) in the one-rank NCCL world above,
    # (b) in the four gloo ranks
    print(f"sharded models (a), one-rank NCCL world: launches in the "
          f"encoder's sharded step {sh['counts']} [{smi}]")
    _sh_print(sh, "a")
    single = {"encoder": sh["ms"]["encoder single-device step"],
              "moe": sh["ms"]["moe single-device step"]}
    for name, t in sh["ms"].items():
        if "single-device" in name:
            continue
        base = single["moe" if name.startswith("moe") else "encoder"]
        beside = (f" ({t / base:.2f}x the single-device step's "
                  f"{base:.4f} ms)" if name.startswith(("encoder", "moe"))
                  else "")
        print(f"  sharded (a) {name}: {t:.4f} ms per step{beside}")
    print(f"  sharded (a) single-device steps: encoder {single['encoder']:.4f}"
          f" ms, moe {single['moe']:.4f} ms")
    sharded_kernels(seed, smi)
    print(f"  sharded (a): {time.perf_counter() - t_sh:.2f} s")
    sb = [r["sharded"] for r in ranks]
    print("sharded models (b), 4 gloo ranks on one card: launches in the "
          "encoder's sharded step by rank " + "; ".join(
              f"{r['rank']}: {r['counts']}" for r in sb))
    print("  sharded (b) worst check by case (normf_rel over the ranks): "
          + "; ".join(f"{k} {max(r['err'][k] for r in sb):.2e}"
                      for k in sb[0]["err"]))
    _sh_print(sb[0], "b, rank 0")
    for name in sb[0]["ms"]:
        print(f"  sharded (b) {name}: "
              f"{max(r['ms'][name] for r in sb):.4f} ms per step, the "
              f"slowest rank (gloo, staged, not scaling)")
    counts = dict(res["counts"])
    for k, v in sh["counts"].items():
        counts[k] = counts.get(k, 0) + v
    return counts


def labs_path(randn, headline):
    """The labs, with the five twin and probe kernels' launch counts set to
    0 just before and read just after: the BRGEMM lab (its four variants at
    br = 1024, 256 x 256 x 64 bf16, each twin held against its plain
    version inside the lab), the packed SMM's passthrough twin at the
    headline's (4096, 32, 128) f32, bit for bit against a + b and timed
    interleaved with the headline kernel (bench.py:869's fraction), and the
    BCSC lab at densities 0.2 and 0.05 (its probes held against the float64
    product and their plain versions inside the lab). Returns the counts,
    the passthrough's operands and the BCSC lab's rows by density."""
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

    bcsc_rows = {density: bcsc_lab.main(["--density", str(density),
                                          "--rounds", "3"])
                 for density in (0.2, 0.05)}

    torch.cuda.synchronize()
    counts = {k: _count(k) for k in LAB_KERNELS}
    print(f"labs: {time.perf_counter() - t_path:.2f} s, kernel launches "
          f"{counts}")
    missing = [k for k in LAB_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched in the labs: {missing}")
    return {"counts": counts, "passthrough": (pt, pa, pb),
            "bcsc_lab": bcsc_rows}


def lab_rows(record, ms, geo, dev, passthrough, brgemm, bcsc_lab_rows):
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
    its own panel and RHS. chunk2 and chunk4 stand beside the chunk1 row.
    Each probe's row carries its kernel's path (chunkN and dspipe must take
    the tensor cores), its kernel / library ratio ("kl") and the BCSC lab's
    paired t / t(union4) at density 0.2 (`bcsc_lab_rows`, labs_path's)."""
    import numpy as np

    from libxsmm_torch.descriptor import GemmShape, SpgemmConfig
    from libxsmm_torch.dtypes import Datatype
    from libxsmm_torch.kernels.spmm import build_bcsc_densify
    from libxsmm_torch.kernels.spmm_lab import minimal_plan
    from libxsmm_torch.scripts import bcsc_lab

    sol, br_args, br_bytes, br_ms = brgemm
    row = record("packed_brgemm_sol", "gemm_kernels.cu",
                 "libxsmm_tpu/kernels/gemm_pallas.py:334", sol, br_args,
                 TOL_F32, br_bytes, 0, geo.peak_bf16_tflops, None,
                 brgemm_ms=br_ms, path=sol.path)
    print(f"  packed_brgemm_sol on the {sol.path} route: {row['ms']:.4f} ms,"
          f" t_sol / t_brg {row['ms'] / br_ms:.4f}")
    pt, pa, pb = passthrough
    row = record("packed_smm_passthrough", "gemm_kernels.cu", "bench.py:441",
                 pt, (pa, pb), TOL_EXACT, 3 * pa.numel() * 4, 0,
                 geo.peak_f32_tflops, ms(torch.add, pa, pb),
                 graph_ms=graph_ms(lambda: pt(pa, pb)),
                 host_ms=host_ms(lambda: pt(pa, pb)),
                 library_graph_ms=graph_ms(lambda: torch.add(pa, pb)),
                 library_host_ms=host_ms(lambda: torch.add(pa, pb)))
    print(f"  packed_smm_passthrough: k/l {row['ms'] / row['library_ms']:.3f}"
          f" by events, {row['graph_ms'] / row['library_graph_ms']:.3f} "
          f"replayed; bound share {row['bound_ms'] / row['graph_ms']:.3f} "
          f"replayed")

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
    vs = {r["name"]: r["vs_union4"] for r in bcsc_lab_rows}
    for name in ("chunk1", "chunk2", "chunk4", "dspipe"):
        if probes[name].path != "mma":
            raise AssertionError(f"bcsc lab {name} took {probes[name].path}")
    if probes["minimal"].path != "wgmma":
        raise AssertionError(f"bcsc lab minimal took {probes['minimal'].path}")
    # events around back-to-back calls carry the host's cost of a call;
    # the profiler's device time and a CUDA graph's replay leave it out
    # (minimal's row takes replay alone: the profiler read its kernel at
    # under half its replayed time, a gap no trace explains yet)
    dev_t = {nm: device_ms(lambda f=fn: f(a, v))
             for nm, fn in probes.items() if nm != "minimal"}
    rep_t = {nm: graph_ms(lambda f=fn: f(a, v)) for nm, fn in probes.items()}
    lib_dev = device_ms(lambda: mm_f32(a, dense_b))
    lib_rep = graph_ms(lambda: mm_f32(a, dense_b))
    timing = {"library_device_ms": lib_dev, "library_graph_ms": lib_rep}
    more = {}
    for name in ("chunk2", "chunk4"):
        t = ms(probes[name], a, v)
        more.update({f"{name}_ms": t, f"{name}_kl": t / lib_mm,
                     f"{name}_vs_union4": vs[name],
                     f"{name}_device_ms": dev_t[name],
                     f"{name}_graph_ms": rep_t[name]})
    rows = [record("bcsc_lab_chunk", src, f"{lab}:173", probes["chunk1"],
                   (a, v), TOL_SPARSE_BF16, fused_bytes, union_ops,
                   geo.peak_bf16_tflops, lib_mm, path="mma",
                   vs_union4=vs["chunk1"],
                   stage=probes["chunk1"].stage._asdict(),
                   device_ms=dev_t["chunk1"], graph_ms=rep_t["chunk1"],
                   **timing, **more),
            record("bcsc_lab_dspipe", src, f"{lab}:236", probes["dspipe"],
                   (a, v), TOL_SPARSE_BF16, fused_bytes, union_ops,
                   geo.peak_bf16_tflops, lib_mm, path="mma",
                   vs_union4=vs["dspipe"],
                   stage=probes["dspipe"].stage._asdict(),
                   device_ms=dev_t["dspipe"], graph_ms=rep_t["dspipe"],
                   **timing)]
    # minimal's yardstick: torch.mm on its own panel and RHS, by events and
    # replay
    minimal = probes["minimal"]
    rhs = minimal.rhs
    panel = a[:, :U * 32].contiguous()
    rhs_cat = rhs.permute(1, 0, 2).reshape(U * 32, n).contiguous()
    min_lib = {"library_graph_ms": graph_ms(lambda: mm_f32(panel, rhs_cat)),
               "host_ms": host_ms(lambda: minimal(a, v)),
               "library_host_ms": host_ms(lambda: mm_f32(panel, rhs_cat))}
    rows.append(record("bcsc_lab_minimal", src, f"{lab}:100", minimal,
                       (a, v), TOL_SPARSE_BF16,
                       2 * panel.numel() + 2 * rhs.numel() + out_bytes,
                       union_ops, geo.peak_bf16_tflops,
                       ms(mm_f32, panel, rhs_cat), path=minimal.path,
                       vs_union4=vs["minimal"],
                       plan=minimal_plan(m, n, U)._asdict(),
                       graph_ms=rep_t["minimal"], **min_lib))
    for r in rows:
        r["kl"] = r["ms"] / r["library_ms"]
    r = rows[-1]
    print(f"  bcsc lab minimal [{minimal.path}]: {r['ms']:.4f} ms, "
          f"replayed {r['graph_ms']:.4f}; torch.mm on its panel "
          f"{r['library_ms']:.4f} ms, replayed {r['library_graph_ms']:.4f}; "
          f"k/l {r['kl']:.3f}, replayed "
          f"{r['graph_ms'] / r['library_graph_ms']:.3f}; host "
          f"{r['host_ms']:.4f} ms a call (torch.mm {r['library_host_ms']:.4f})"
          f"; t / t(union4) {vs['minimal']:.3f}; plan {r['plan']}")
    print(f"  bcsc lab probes at 1024^3, density 0.2: U = {U}, "
          f"{int(np.asarray(bcsc.indices).size)} blocks; torch.mm "
          f"{lib_mm:.4f} ms, device {lib_dev:.4f}, replayed {lib_rep:.4f}")
    events = {"chunk1": rows[0]["ms"], "dspipe": rows[1]["ms"],
              "chunk2": more["chunk2_ms"], "chunk4": more["chunk4_ms"]}
    for nm, t in events.items():
        print(f"  bcsc lab {nm} [{probes[nm].path}]: {t:.4f} ms, device "
              f"{dev_t[nm]:.4f}, replayed {rep_t[nm]:.4f}; k/l {t / lib_mm:.3f}"
              f", device {dev_t[nm] / lib_dev:.3f}, replayed "
              f"{rep_t[nm] / lib_rep:.3f}; t / t(union4) {vs[nm]:.3f}; "
              f"staging {probes[nm].stage._asdict()}")


def step_breakdown(params, x, y, cfg, reps=5, label="bf16 8x512"):
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
    print(f"  train step {label} (ms per step, mean of {reps}): "
          + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
          + f"; total {total:.4f}")
    return parts


def step_trace(params, x, y, cfg, steps=3, label="bf16 8x512"):
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
        print(f"  train step trace {label}: {walls}; device time not measured "
              "(the profiler recorded no kernel)")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"  train step trace {label}: {walls}, device busy {busy:.4f} ms "
          f"({100 * busy / wall:.1f}% of the wall, idle "
          f"{100 * (1 - busy / wall):.1f}%), {len(by_name)} kernel names; "
          "top: " + "; ".join(f"{n[:60]} {v:.4f}" for n, v in top))
    # the busy split: the port's flash kernels against everything else
    flash = {n: v for n, v in by_name.items() if "flash" in n}
    print(f"  train step busy split {label}: " + "; ".join(
        f"{n.split('(')[0]} {v:.4f} ms "
        f"({100 * v / busy:.1f}%)" for n, v in sorted(flash.items()))
        + f"; the rest {busy - sum(flash.values()):.4f} ms")


def block_breakdown(block, x, block_ops, ms, label="bf16 8x512"):
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
    print(f"  block breakdown {label} (ms, each stage alone; flash "
          f"{flash.path}): {parts}; sum "
          f"{sum(stages.values()):.4f}; whole forward {total:.4f}")


def _lowered(name, text, kernel):
    """Check a lower_text text on the card: exactly one launch of `kernel`,
    and under it exactly the one entry that ran (the library's launch log),
    with resources and non-empty SASS. Returns (its route, its entry and
    registers, SASS lines)."""
    import re
    launches = re.findall(r"^// launch (\w+) x(\d+): route (\w+)(.*?),",
                          text, re.M)
    if [(n, c) for n, c, _, _ in launches] != [(kernel, "1")]:
        raise AssertionError(f"{name}: launches {launches}, want one "
                             f"{kernel}")
    entries = re.findall(r"^// entry (\S+) x(\d+): registers (\d+)", text,
                         re.M)
    sass = [int(v) for v in re.findall(r"^// sass \S+: (\d+) lines", text,
                                       re.M)]
    if ([n for _, n, _ in entries] != ["1"] or len(sass) != 1
            or sass[0] == 0):
        raise AssertionError(f"{name}: entries {entries}, SASS lines {sass}")
    return ((launches[0][2] + launches[0][3]).strip(),
            (entries[0][0], entries[0][2]), sass[0])


def tooling_path(dev, built, smi):
    """The tooling at full width on the card (phase 15): lower_text of the
    headline packed SMM and the batched SMM, the generator at bcsc20, dump,
    the manifest CLI with --bench, and the AOT warm start in a child
    process without nvcc. Every check raises."""
    import contextlib
    import io
    import os
    import tempfile

    import numpy as np

    import libxsmm_torch as xt
    from libxsmm_torch import aot, native
    from libxsmm_torch.config import CONFIG
    from libxsmm_torch.descriptor import GemmFlags, GemmShape, SpgemmConfig
    from libxsmm_torch.dtypes import Datatype
    from libxsmm_torch.ops.sparse import BcscMatrix
    from libxsmm_torch.scripts.aot_warm import cold_start
    from libxsmm_torch.utils import cli
    from libxsmm_torch.utils.mtx import write_mtx

    t_path = time.perf_counter()
    B, m = 16384, 32
    G = B // 4
    smm = GemmShape(m, m, m)
    B0 = GemmFlags.BETA_0

    def meta(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device="meta")

    texts = {}
    for name, kern, args, counter in (
            ("packed SMM", xt.dispatch_gemm_batched_packed(smm, B0),
             (meta(G, m, 128),) * 2, "packed_batched_gemm"),
            ("batched SMM", xt.dispatch_gemm_batched(smm, B0),
             (meta(B, m, m),) * 2, "batched_gemm")):
        t0 = time.perf_counter()
        text = kern.lower_text(*args, device=dev)
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = kern.lower_text(*args, device=dev)
        t_again = time.perf_counter() - t0
        if again != text:
            raise AssertionError(f"lower_text of the {name} changed between "
                                 "two calls")
        route, (entry, regs), lines = _lowered(name, text, counter)
        texts[name] = (kern, args, text)
        print(f"  tooling lower_text {name} {kern.name}: {route}, entry "
              f"{entry} ({regs} registers), {lines} SASS lines, {len(text)} "
              f"characters; host time {t_first:.3f} s first, {t_again:.3f} "
              f"s again")
    if "route cuda bulk x1" not in texts["batched SMM"][2]:
        raise AssertionError("the batched SMM's text left the bulk route")

    # bcsc20 (bench.py:694-697): 1024^3, 32 x 32 blocks at density 0.2,
    # bf16 -> f32, the densify lowering
    rng = np.random.default_rng(2)
    k = n = 1024
    bmat = rng.standard_normal((k, n)).astype(np.float32)
    keep = rng.random((k // 32, n // 32)) < 0.2
    bmat *= np.kron(keep, np.ones((32, 32), np.float32))
    bcsc = BcscMatrix.from_dense(bmat, 32, 32)
    t0 = time.perf_counter()
    gen = xt.generator_packed_spgemm_bcsc_kernel(
        GemmShape(1024, n, k, a_in_type=Datatype.BF16,
                  b_in_type=Datatype.BF16, out_type=Datatype.F32), B0,
        SpgemmConfig(1, 32, 32), bcsc.indptr, bcsc.indices)
    t_gen = time.perf_counter() - t0
    route, (entry, regs), lines = _lowered("bcsc20 generator", gen.code,
                                           "bcsc_densify")
    if (gen.arch, gen.kind) != ("h100", "pspgemm_bcsc"):
        raise AssertionError(f"generator: arch {gen.arch}, kind {gen.kind}")
    print(f"  tooling generator_packed_spgemm_bcsc_kernel bcsc20 "
          f"{gen.routine_name}: {route}, entry {entry} ({regs} registers), "
          f"{lines} SASS lines, code_size {gen.code_size}; host time "
          f"{t_gen:.3f} s")

    with tempfile.TemporaryDirectory() as tmp:
        kern, args, text = texts["packed SMM"]
        prev = CONFIG.dump_dir
        CONFIG.dump_dir = os.path.join(tmp, "dump")
        try:
            path = kern.dump(*args, device=dev)
        finally:
            CONFIG.dump_dir = prev
        with open(path) as f:
            if f.read() != text:
                raise AssertionError("dump wrote another text than "
                                     "lower_text")
        print(f"  tooling dump: {os.path.basename(path)}, "
              f"{os.path.getsize(path)} bytes")

        # the manifest CLI: one batched gemm and bcsc20 from its .mtx
        mtx = os.path.join(tmp, "bcsc20.mtx")
        write_mtx(mtx, bmat)
        manifest = os.path.join(tmp, "manifest.json")
        with open(manifest, "w") as f:
            json.dump({"gemm": [{"m": m, "n": m, "k": m, "dtype": "f32",
                                 "beta": 0, "batch": B}],
                       "spgemm": [{"kind": "bcsc", "mtx": mtx, "m": 1024,
                                   "bk": 32, "bn": 32, "dtype": "bf16",
                                   "out_dtype": "f32",
                                   "strategy": "dense"}]}, f)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main([manifest, "--bench"])
        t_cli = time.perf_counter() - t0
        lines_ = out.getvalue().splitlines()
        if (rc != 0 or lines_[-1] != "xsmm-gen: 2 kernels compiled"
                or not lines_[0].endswith("GF/s")
                or not lines_[1].endswith("Gnnz/s")):
            raise AssertionError(f"the manifest CLI: rc {rc}, {lines_}")
        for line in lines_:
            print(f"  tooling cli: {line}")
        print(f"  tooling cli: {t_cli:.2f} s for the manifest")

        # AOT: export the headline packed SMM, load it in a child process
        # from a copy of the package without kernels/build/ and without
        # nvcc, and hold its result against the plain version
        store = native.PersistentKv(os.path.join(tmp, "aot.xkv"))
        gen_ = torch.Generator(device=dev).manual_seed(3)
        a = torch.randn(G, m, 128, generator=gen_, device=dev)
        key = aot.export_kernel(kern, (a, a), store)
        res = cold_start(os.path.join(tmp, "aot.xkv"), key, G,
                         os.path.join(tmp, "copy"))
    from libxsmm_torch.kernels import _build
    want = [_build.library_path("gemm_kernels").name]
    if (res["normf_rel"] > TOL_F32 or res["restored"] != want
            or res["build_log"]):
        raise AssertionError(f"AOT child: {res}")
    cold = built.get("gemm_kernels")
    print(f"  tooling aot ({smi}): cold build of gemm_kernels.cu by nvcc "
          + (f"{cold:.2f} s (in parallel with the other sources)"
             if cold is not None else "not run (the library was built)")
          + f"; the child's first result {res['first_result_s']:.3f} s "
          f"after load_kernel, {res['process_s']:.2f} s for the whole "
          f"process (interpreter and torch import included), no nvcc, "
          f"normf_rel {res['normf_rel']:.2e}")
    print(f"tooling path: {time.perf_counter() - t_path:.2f} s")


# phase 16, the samples at their samples/ defaults (libxsmm_torch.
# samples): (module, arguments, the kernels each must launch)
SAMPLE_RUNS = (
    ("hello", [], ()),
    ("eltwise", [], ("dropout",)),
    ("equation", [], ()),
    ("xgemm", [], ()),
    ("xgemm", ["--full"], ("packed_brgemm", "stochastic_round")),
    ("smmbench", [], ("packed_batched_gemm",)),
    ("dispatch_bench", [], ()),
    ("utilities", [], ()),
    ("spmm", [], ("bcsc_spmm", "bcsc_spmm_super", "bcsc_spmm_union",
                  "bcsc_union_compact", "bcsc_densify")),
    ("spmm", ["--bench"], ("bcsc_spmm", "bcsc_spmm_super",
                           "bcsc_spmm_union", "bcsc_union_compact",
                           "bcsc_densify")),
    ("probe_bcsc", [], ("bcsc_densify", "bcsc_spmm_union",
                        "bcsc_union_compact")),
    ("cnn", [], ()),
    ("pyfr", [], ()),
    ("spmm_scaling", [], ()),
    ("encoder", [], ()),
)
# a line of a sample's output that carries a figure
_FIGURE = ("GF/s", "GB/s", "Gflop/s", "GFLOP/s", "TF/s", "Gnnz/s", " us",
           " ns", " ms", "ratio", "passed", "ALL OK",
           "drivers OK", "checks:", "xgemm_full", "registry", "device:",
           "union U=", "density=", "build (", "operators", "NOTE", "times:",
           "devices=", "2-level")


def samples_path(smi):
    """Phase 16: each sample's main at its samples/ defaults on the
    card, in this process (spmm_scaling and encoder start their own), with
    every launch count set to 0 just before and the sample's kernels
    required to have launched just after; then the process-parallel runner
    on three commands (one passes, one fails, one outlives its timeout).
    Prints each sample's wall time and its figure lines, the card beside
    each."""
    import contextlib
    import importlib
    import io
    import pathlib
    import subprocess
    import tempfile

    t_phase = time.perf_counter()
    for name, args, kernels in SAMPLE_RUNS:
        mod = importlib.import_module(f"libxsmm_torch.samples.{name}")
        _reset_all_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = mod.main(list(args))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _all_launches()
        text = buf.getvalue()
        if rc != 0:
            raise AssertionError(f"sample {name} {args} returned {rc}:\n"
                                 f"{text[-4000:]}")
        missing = [k for k in kernels if counts[k] == 0]
        if missing:
            raise AssertionError(f"sample {name} {args}: {missing} were not "
                                 f"launched ({counts})")
        lines = text.splitlines()
        verdicts = sum(ln.startswith(("OK", "PASS")) for ln in lines)
        launched = {k: v for k, v in counts.items() if v}
        print(f"  sample {name} {' '.join(args)}: rc 0, {wall:.2f} s wall, "
              f"{verdicts} checks passed, launches {launched} [{smi}]")
        for ln in lines:
            if ln.strip() and any(u in ln for u in _FIGURE):
                print(f"    {ln.rstrip()} [{smi}]")

    # the runner: exit code = failed commands (the failure and the timeout)
    with tempfile.TemporaryDirectory(prefix="xsmm_pexec_") as tmp:
        lst = pathlib.Path(tmp) / "cmds.txt"
        lst.write_text("true\nfalse\nsleep 60\n")
        log = pathlib.Path(tmp) / "log"
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m",
                            "libxsmm_torch.scripts.pexec", str(lst),
                            "--log", str(log), "--timeout", "3"],
                           capture_output=True, text=True, timeout=120)
        wall = time.perf_counter() - t0
        logs = sorted(q.name for q in log.glob("*.log"))
        summary = (log / "summary.txt").read_text().splitlines()
    if (p.returncode != 2 or logs != ["false.log", "sleep_60.log",
                                      "true.log"]
            or summary[-1] != "1/3 passed, 2 failed"
            or "rc=timeout" not in summary[2]):
        raise AssertionError(f"pexec: rc {p.returncode}, logs {logs}, "
                             f"summary {summary}\n{p.stdout}{p.stderr}")
    print(f"  pexec: rc 2 (one failed, one timed out at 3 s), logs {logs}, "
          f"{wall:.2f} s wall [{smi}]")
    print(f"phase 16 (samples): {time.perf_counter() - t_phase:.1f} s "
          f"[{smi}]")


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
    smi = card()
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
    # the pipelined kernels and the densifier, one line per instantiation
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
    block_breakdown(*enc["block_f32"], ms, label="f32 8x512")

    # 6. the encoder block's training path, counted on its own
    tr = training_path(randn, dev)
    for name, fn, fargs in tr["phases"]:
        print(f"  phase {name}: {ms(fn, *fargs):.4f} ms per call")
    counts.update({k: tr["counts"][k] for k in BWD_KERNELS})
    # the flash launches of both paths by route (the f32 rows' launches)
    flash_routes = {k: {r: enc["routes"][k][r] + tr["routes"][k][r]
                        for r in v} for k, v in tr["routes"].items()}
    print(f"  flash launches by route (serve + train): {flash_routes}")
    # the backward's by CUDA kernel (the 128-key plan's, the wide ones)
    flash_kernels = {k: enc["kernels"][k] + tr["kernels"][k]
                     for k in tr["kernels"]}
    print(f"  flash backward launches by kernel (serve + train): "
          f"{flash_kernels}")
    step_breakdown(*tr["step"])
    step_trace(*tr["step"])
    step_breakdown(*tr["step_f32"], label="f32 8x512")
    step_trace(*tr["step_f32"], label="f32 8x512")

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

    # 10. matrix equations, counted on their own (torch ops: no launch)
    equation_path(randn, dev, ms)

    # 11. TPP-MoE at Switch-Base-8's widths, counted on its own
    moe_path(randn, dev, ms)

    # 12. the parallel layer and 13. the sharded models: a one-rank NCCL
    # world here, counted on their own (the flash kernels' and, from the
    # sharded encoder step, the dropout's launches join their rows), then
    # four gloo ranks on the card
    par = parallel_path(args.seed, smi)
    for name in SHARD_KERNELS:
        counts[name] += par.get(name, 0)

    # 13. the labs, counted on their own
    labs = labs_path(randn, (K.build_packed_batched_gemm(GemmDescriptor(
        smm, B0), G), (ap, bp)))
    counts.update(labs["counts"])

    # 14. each kernel against its plain version, and timed
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
             (sol_br, (ap_br, b_br), br_bytes, row_br["ms"]),
             labs["bcsc_lab"][0.2])
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

    if flash.path != "wgmma":
        raise AssertionError(f"flash forward bf16 took {flash.path}")
    flash_ops = 4 * fbh * fs * fs * fhd
    record("flash_attention_fwd", "attention_kernels.cu",
           "libxsmm_tpu/kernels/attention_pallas.py:159", flash,
           (0, fq, fkT, fv), TOL_BF16_OUT,
           4 * fbh * fs * fhd * 2, flash_ops,
           geo.peak_bf16_tflops, ms(sdpa, *sdpa_operands(fq, fkT, fv)),
           path=flash.path,
           launches=flash_routes["flash_attention_fwd"]["wgmma"])
    mma_rate(rows[-1], flash_ops, flash_ops)
    # the same kernel past hd 128 (64-key tiles) at the training path's
    # hd-256 shape; launches: the route's on the serving and training paths
    hq, hv = (randn(16, 1024, 256, dtype=torch.bfloat16) for _ in range(2))
    hkT = randn(16, 256, 1024, dtype=torch.bfloat16)
    wflash = KA.build_flash_attention(16, 1024, 256, torch.bfloat16)
    if (wflash.path, wflash.block_k) != ("wgmma", 64):
        raise AssertionError(f"flash forward bf16 hd 256 took {wflash.path}"
                             f" with {wflash.block_k}-key tiles")
    record("flash_attention_fwd", "attention_kernels.cu",
           "libxsmm_tpu/kernels/attention_pallas.py:159", wflash,
           (0, hq, hkT, hv), TOL_BF16_OUT, 4 * 16 * 1024 * 256 * 2,
           4 * 16 * 1024 * 1024 * 256, geo.peak_bf16_tflops,
           ms(sdpa, *sdpa_operands(hq, hkT, hv)), path=wflash.path,
           shape=[16, 1024, 256])
    rows[-1].update(name="flash_attention_fwd_hd256",
                    launches=flash_routes["flash_attention_fwd"]["wgmma"])
    # dropout at the FFN shape: x read once, out and the mask written once
    # (bytes: one a element; packed: the BITMASK_2BYTEMULT bits; none); the
    # yardstick is torch's dropout (its own random bits, no mask). The row
    # is the byte form's; the other forms stand beside it, each held
    # against the plain version bit for bit; events, replay and the host's
    # time a call split each call's time between the host and the card (the
    # profiler's kernel time is left out: it read the byte form below its
    # bytes bound)
    dx = enc["dropout_operand"]

    def f_dropout(t):
        return torch.nn.functional.dropout(t, 0.1, True)

    rowd = record("dropout", "eltwise_kernels.cu",
                  "libxsmm_tpu/kernels/eltwise_pallas.py:103", KE.dropout,
                  (dx, 7, 0.1), TOL_EXACT, dx.numel() * (2 + 2 + 1), 0,
                  geo.peak_bf16_tflops, ms(f_dropout, dx),
                  graph_ms=graph_ms(lambda: KE.dropout(dx, 7, 0.1)),
                  host_ms=host_ms(lambda: KE.dropout(dx, 7, 0.1)),
                  library_graph_ms=graph_ms(lambda: f_dropout(dx)),
                  library_host_ms=host_ms(lambda: f_dropout(dx)))
    mask_bytes = {"packed": dx.shape[0] * ((dx.shape[1] + 15) // 16 * 2),
                  "none": 0}
    for form, nb in mask_bytes.items():
        def call(t, form=form):
            return KE.dropout(t, 7, 0.1, mask=form)
        _check(f"dropout {form} kernel vs plain",
               KE.dropout.plain(dx, 7, 0.1, mask=form), call(dx), TOL_EXACT)
        rowd.update({f"{form}_ms": ms(call, dx),
                     f"{form}_graph_ms": graph_ms(lambda: call(dx)),
                     f"{form}_host_ms": host_ms(lambda: call(dx)),
                     f"{form}_bound_ms": geo.bound_ms(
                         dx.numel() * 4 + nb, 0, geo.peak_bf16_tflops)})
    print("  dropout 4096x3072 bf16 (ms; events / replayed / host a call / "
          "bound): " + "; ".join(
              f"{label} {rowd[k + 'ms']:.4f} / {rowd[k + 'graph_ms']:.4f} / {rowd[k + 'host_ms']:.4f} / "
              f"{rowd[k + 'bound_ms']:.4f}"
              for label, k in (("bytes", ""), ("packed", "packed_"),
                               ("none", "none_"))) +
          f"; F.dropout {rowd['library_ms']:.4f} / "
          f"{rowd['library_graph_ms']:.4f} / {rowd['library_host_ms']:.4f}")

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
    if bwd.path != "wgmma":
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
               useful_, geo.peak_bf16_tflops, lib_bwd, path=bwd.path)
        rows[-1]["launches"] = flash_kernels[bwd.kernels[name.rsplit("_",
                                                                     1)[1]]]
        # its own products, hd padded to its bucket (64 or 128)
        mma_rate(rows[-1], nmm * fbh * fs * fs * 64 * -(-fhd // 64), useful_)
    t_pair = rows[-2]["ms"] + rows[-1]["ms"]
    print(f"  flash backward dkv + dq {t_pair:.4f} ms; kernels / sdpa "
          f"backward {t_pair / lib_bwd:.3f}")
    # the wide wgmma kernels (bf16 past hd 128) at the training path's
    # hd-256 shape; launches: theirs on the serving and training paths
    margs = tr["bwd_operands_wide"]
    hbh, hs, hhd = margs[1].shape
    mbwd = KA.build_flash_attention_bwd(hbh, hs, hhd, torch.bfloat16)
    if mbwd.path != "wgmma" or "wide" not in mbwd.kernels["dq"]:
        raise AssertionError(f"flash backward bf16 hd {hhd} took "
                             f"{mbwd.path} {mbwd.kernels}")
    lib_wide = sdpa_bwd_ms(*margs[1:5])
    hin = 4 * hbh * hs * hhd * 2 + 2 * hbh * hs * 4
    hdp = 64 * -(-hhd // 64)
    for name, part, plain, nout, nmm, nown in (
            ("flash_attention_bwd_dkv", mbwd.dkv, mbwd.dkv_plain, 2, 8, 12),
            ("flash_attention_bwd_dq", mbwd.dq, mbwd.dq_plain, 1, 6, 6)):
        fn_ = functools.partial(part)
        fn_.plain = plain
        record(name, "attention_bwd_kernels.cu",
               "libxsmm_tpu/kernels/attention_pallas.py:387" if nmm == 8
               else "libxsmm_tpu/kernels/attention_pallas.py:485", fn_,
               margs, TOL_BF16_OUT, hin + nout * hbh * hs * hhd * 2,
               nmm * hbh * hs * hs * hhd, geo.peak_bf16_tflops, lib_wide,
               path=mbwd.path, shape=[hbh, hs, hhd],
               graph_ms=graph_ms(lambda: fn_(*margs)),
               device_ms=device_ms(lambda: fn_(*margs)))
        rows[-1].update(name=f"{name}_wide", launches=flash_kernels[
            mbwd.kernels[name.rsplit("_", 1)[1]]])
        # its own products: hd padded to its bucket, and in dK/dV S^T and
        # dP^T formed by both warpgroups (12 x hd a pair against 8)
        mma_rate(rows[-1], nown * hbh * hs * hs * hdp,
                 nmm * hbh * hs * hs * hhd)
    global_position_forms(rows, ms, KA, KE, fq, fkT, fv, bargs, dx)

    sparse_rows(record, rows, sp["stream"], sp["small"], ms, geo,
                sp["routes"], sp["narrow"])

    # the bf16 backward on wgmma at both shapes, causal and not, beside
    # SDPA's bf16 backends; its forms join the two backward rows
    bf16_bwd = bf16_flash_bwd_rows()
    for r in rows:
        if r["name"] in BWD_KERNELS:
            part = r["name"].rsplit("_", 1)[1]
            r["forms"] = {
                f"{sh} {form}": {
                    **{k: x[part][k] for k in (
                        "ms", "graph_ms", "device_ms", "bound_ms",
                        "replay_tflops", "max_abs_err")},
                    "sdpa": x["sdpa"], "yardstick": x["yardstick"]}
                for (sh, form), x in bf16_bwd.items()}

    # the f32 routes: flash on tma_fma beside SDPA's backends at both
    # shapes, the f32 SpMM forms at stream20
    f32_flash = f32_flash_rows(randn, ms, geo)
    f32_spmm = f32_spmm_rows(randn, ms, geo, sp["auto"]["f32 stream20"])
    rows.extend(f32_kernel_rows(f32_flash, f32_spmm, flash_routes,
                                sp["f32_counts"]))

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

    # the bf16 forward on wgmma at both shapes, causal and not, beside
    # SDPA's bf16 backends; its forms join the forward's row
    row = next(r for r in rows if r["name"] == "flash_attention_fwd")
    row["forms"] = bf16_flash_fwd_rows()

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

    # 15. the tooling, on its own
    tooling_path(dev, built, smi)

    # 16. the samples and the runner
    samples_path(smi)

    for r in rows:
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        cast = "".join(f"; {label} {r[key]:.4f} ms" for key, label in (
            ("rne_cast_ms", "rne cast"), ("compact_ms", "compacted form"),
            ("own_ms", "own products at peak"),
            ("clone_ms", "clone of the output"),
            ("clone_graph_ms", "clone replayed"),
            ("clone_host_ms", "clone host"),
            ("compact_graph_ms", "compacted form replayed"),
            ("brgemm_ms", "the packed BRGEMM"), ("chunk2_ms", "chunk2"),
            ("chunk4_ms", "chunk4"), ("device_ms", "device time"),
            ("library_device_ms", "library device time"),
            ("graph_ms", "replayed from a CUDA graph"),
            ("library_graph_ms", "library replayed"),
            ("host_ms", "host a call"), ("library_host_ms", "library host"),
            ("packed_ms", "packed mask"), ("none_ms", "no mask"),
            ("sol_ms", "its twin"),
            ("sol_device_ms", "twin device time"),
            ("sol_graph_ms", "twin replayed")) if key in r)
        path = f" [{r['path']}]" if "path" in r else ""
        print(f"{r['name']}{path}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms "
              f"by {r['bound_by']}; plain {r['plain_ms']:.4f} ms; library "
              f"{lib}{cast}); max_abs_err {r['max_abs_err']:.3e}"
              f"; {r['launches']} main-path launches")
    from libxsmm_torch.scripts import timing
    print(f"device_split: {timing.empty_sessions} profiler sessions recorded "
          "no CUDA kernel and were run again")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
