"""Fused scaled-dot-product attention: dispatch front-end.

The port of `libxsmm_tpu/ops/attention.py`. The attention composition is the
library's flagship fused workload (models/tpp_attention.py; the TPP paper's
BERT case, arXiv:2104.05755). Like every other op family it is
descriptor-keyed through the registry: dispatch once, invoke many.

Two lowerings, as the reference's:
  * the flash kernel (kernels/attention.py: hand-written CUDA on CUDA
    tensors, its plain torch version on CPU tensors) — the (s, s) score and
    probability panels never reach device memory; s % 128 == 0,
    hd % 8 == 0 <= 256, f32/bf16; fused additive bias, probability dropout
    (position-hash mask), causal masking;
  * the torch composition `_naive` for shapes outside that envelope and for
    f16/f64 (KernelInfo.is_reference_kernel=True), as the reference routes
    them to XLA. It evaluates the SAME position-hash dropout mask, so both
    routes drop the same probabilities.

The forward is a torch.autograd.Function; its backward (the two-kernel flash
backward, ROADMAP.md queue 2, item 8) is not ported yet and raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..dtypes import Datatype, to_torch
from ..kernels import attention as ka
from ..registry import Kernel, KernelInfo, get_registry


def _apply_mask_bias(scores, s, causal, bias):
    if bias is not None:
        scores = scores + bias.float()
    if causal:
        row = torch.arange(s, device=scores.device)[:, None]
        col = torch.arange(s, device=scores.device)[None, :]
        scores = torch.where((col <= row)[None], scores,
                             torch.full((), ka._NEG, device=scores.device))
    return scores


def _hash_keep(bh, s, seed, thr, device):
    """The kernel's position-hash dropout mask, evaluated by torch ops: keep
    iff hash(seed, b, row, col) >= thr (kernels/attention._rand_bits —
    shared code, shared bits)."""
    row = torch.arange(s, device=device)[None, :, None]
    col = torch.arange(s, device=device)[None, None, :]
    b = torch.arange(bh, device=device)[:, None, None]
    return ka._rand_bits(int(seed), b, row, col) >= thr


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The products' accumulation type: the reference asks for f32
    (preferred_element_type); f64 inputs keep f64."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _naive_probs(q, kT, scale, causal, bias=None):
    s = q.shape[1]
    acc = _acc_dtype(q.dtype)
    scores = torch.matmul(q.to(acc), kT.to(acc)).float() * scale
    scores = _apply_mask_bias(scores, s, causal, bias)
    mx = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - mx)
    return e / e.sum(dim=-1, keepdim=True)


def _naive(q, kT, v, scale, causal, bias=None, dropout_p=0.0, seed=None):
    """The reference composition: q(bh,s,hd) @ kT(bh,hd,s), +bias, mask,
    softmax, dropout, @ v — semantically the fused kernel (including the
    dropout mask bits)."""
    bh, s = q.shape[0], q.shape[1]
    probs = _naive_probs(q, kT, scale, causal, bias)
    if dropout_p > 0.0:
        keep = _hash_keep(bh, s, seed, ka._dropout_threshold(dropout_p),
                          q.device)
        probs = torch.where(keep, probs * (1.0 / (1.0 - dropout_p)),
                            torch.zeros((), device=q.device))
    acc = _acc_dtype(q.dtype)
    return torch.matmul(probs.to(q.dtype).to(acc), v.to(acc)).to(q.dtype)


class _FlashAttentionFn(torch.autograd.Function):
    """The forward (kernel or torch composition) as an autograd node. The
    reference differentiates it with the two-kernel flash backward, not
    ported yet."""

    @staticmethod
    def forward(ctx, forward, q, kT, v, bias):
        return forward(q, kT, v, bias)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the flash-attention backward is not ported yet (ROADMAP.md "
            "queue 2, item 8: dkv_kernel and dq_kernel, "
            "kernels/attention_pallas.py:387 and :485)")


def _build_attention(desc) -> Kernel:
    (_, bh, s, hd, a_dt, causal, scale, dropout_p, bias_bh,
     bias_requires_grad) = desc
    dtype = to_torch(a_dt)
    sc = float(scale) if scale is not None else float(hd) ** -0.5
    has_bias = bias_bh > 0
    has_seed = dropout_p > 0.0

    use_fused = ka.supported(s, hd, dtype) and not (
        bias_requires_grad and bias_bh == 1)
    fused = (ka.build_flash_attention(bh, s, hd, dtype, causal=causal,
                                      scale=sc, bias_bh=bias_bh,
                                      dropout_p=dropout_p)
             if use_fused else None)

    def attn(q, kT, v, bias=None, seed=None):
        if has_bias and bias is None:
            raise ValueError("this attention kernel was dispatched with a "
                             "bias operand; pass bias=")
        if bias is not None and not has_bias:
            raise ValueError("bias passed but kernel dispatched without "
                             "bias_bh; re-dispatch with bias_bh set")
        if has_seed and seed is None:
            raise ValueError("dropout_p > 0 requires seed=")
        seed = int(seed) if has_seed else 0

        def forward(q_, kT_, v_, bias_):
            if fused is not None:
                return fused(seed, q_, kT_, v_, bias_)
            return _naive(q_, kT_, v_, sc, causal, bias_, dropout_p, seed)

        return _FlashAttentionFn.apply(forward, q, kT, v, bias)

    # two (s,s,hd) matmuls; causal masking halves the useful work (exactly
    # s*(s+1)/2 live score pairs per triangle)
    nflops = (2 * bh * s * (s + 1) * hd if causal
              else 4 * bh * s * s * hd)
    info = KernelInfo(kind="flash_attention", nflops=nflops,
                      is_reference_kernel=not use_fused)
    name = (f"flash_attn_{bh}x{s}x{hd}_{a_dt.name.lower()}"
            f"{'_causal' if causal else ''}"
            f"{'_drop' if has_seed else ''}{'_bias' if has_bias else ''}")
    return Kernel(fn=attn, descriptor=desc, info=info, name=name)


def dispatch_flash_attention(bh: int, s: int, hd: int,
                             dtype: Datatype = Datatype.F32,
                             causal: bool = False,
                             scale: Optional[float] = None,
                             dropout_p: float = 0.0,
                             bias_bh: int = 0,
                             bias_requires_grad: bool = False) -> Kernel:
    """Fused attention kernel: kernel(q, kT, v[, bias=][, seed=]) -> out.

    q, v: (bh, s, hd); kT: (bh, hd, s) — K pre-transposed, as the
    reference's layout. bias: (bias_bh, s, s) additive attention bias with
    bias_bh in {0 (none), 1 (broadcast), bh}. dropout_p drops attention
    probabilities (inverted scale); it requires seed= at call time. Returns
    (bh, s, hd) in the input dtype. The backward raises until the flash
    backward is ported (ROADMAP.md queue 2, item 8); bias_requires_grad is
    kept in the descriptor and, as in the reference, routes a broadcast
    bias to the torch composition."""
    if bh <= 0 or s <= 0 or hd <= 0:
        raise ValueError(f"bad attention shape bh={bh} s={s} hd={hd}")
    if bias_bh not in (0, 1, bh):
        raise ValueError(f"bias_bh must be 0, 1 or bh={bh}; got {bias_bh}")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    dtype = Datatype(dtype)
    if dtype not in (Datatype.F32, Datatype.BF16, Datatype.F16,
                     Datatype.F64):
        raise ValueError(f"unsupported attention dtype {dtype}")
    desc = ("flash_attn", bh, s, hd, dtype, bool(causal),
            None if scale is None else float(scale), float(dropout_p),
            int(bias_bh), bool(bias_requires_grad))
    return get_registry().dispatch(desc, _build_attention)
