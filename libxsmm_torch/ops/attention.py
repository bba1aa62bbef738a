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

Differentiable, as the reference's custom_vjp: when a gradient is wanted
(grad mode on and an operand requiring grad) the call goes through a
torch.autograd.Function. On the fused route its forward also writes the
LSE, and its backward is the two-kernel flash backward
(kernels/attention.build_flash_attention_bwd: probabilities recomputed from
the LSE, the dropout mask replayed from the position hash); delta =
rowsum(dout * out) is computed in f32 by torch ops, as the reference leaves
it to XLA. On the composition route the backward is the reference's
analytic gradient, written out in torch ops. Served calls (inference mode,
or no operand requiring grad) run the forward without the LSE and build no
graph.

Bias gradients, as the reference's: exact for bias_bh == bh with
bias_requires_grad=True (the dK/dV kernel writes the dS blocks); a
broadcast (1, s, s) bias with bias_requires_grad=True takes the composition
route, which sums dS over the batch. With bias_requires_grad=False the bias
cotangent is zero.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..dtypes import Datatype, to_torch
from ..kernels import attention as ka
from ..registry import Kernel, KernelInfo, entry_point, get_registry


def _apply_mask_bias(scores, s, causal, bias):
    if bias is not None:
        scores = scores + bias.float()
    if causal:
        row = torch.arange(s, device=scores.device)[:, None]
        col = torch.arange(s, device=scores.device)[None, :]
        scores = torch.where((col <= row)[None], scores,
                             torch.full((), ka._NEG, device=scores.device))
    return scores


def _hash_keep(bh, s, seed, thr, device, head_map=None):
    """The kernel's position-hash dropout mask, evaluated by torch ops: keep
    iff hash(seed, b, row, col) >= thr (kernels/attention._rand_bits —
    shared code, shared bits), b under the head map."""
    row = torch.arange(s, device=device)[None, :, None]
    col = torch.arange(s, device=device)[None, None, :]
    b = ka.head_index(bh, head_map, device)
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


def _naive(q, kT, v, scale, causal, bias=None, dropout_p=0.0, seed=None,
           head_map=None):
    """The reference composition: q(bh,s,hd) @ kT(bh,hd,s), +bias, mask,
    softmax, dropout, @ v — semantically the fused kernel (including the
    dropout mask bits)."""
    bh, s = q.shape[0], q.shape[1]
    probs = _naive_probs(q, kT, scale, causal, bias)
    if dropout_p > 0.0:
        keep = _hash_keep(bh, s, seed, ka._dropout_threshold(dropout_p),
                          q.device, head_map)
        probs = torch.where(keep, probs * (1.0 / (1.0 - dropout_p)),
                            torch.zeros((), device=q.device))
    acc = _acc_dtype(q.dtype)
    return torch.matmul(probs.to(q.dtype).to(acc), v.to(acc)).to(q.dtype)


def _naive_bwd(q, kT, v, bias, out, g, scale, causal, dropout_p, seed,
               bias_grad, head_map=None):
    """The reference's analytic backward of `_naive` (ops/attention.py
    :183-212), probabilities recomputed: returns (dq, dkT, dv, dbias or
    None). The products take f32 operands (f64 for f64 inputs); dbias is
    dS, summed over the batch for a broadcast bias."""
    bh, s = q.shape[0], q.shape[1]
    acc = _acc_dtype(q.dtype)
    probs = _naive_probs(q, kT, scale, causal, bias).to(acc)
    gf = g.to(acc)
    zero = torch.zeros((), dtype=acc, device=q.device)
    if dropout_p > 0.0:
        keep = _hash_keep(bh, s, seed, ka._dropout_threshold(dropout_p),
                          q.device, head_map)
        r = 1.0 / (1.0 - dropout_p)
        probs_d = torch.where(keep, probs * r, zero)
    else:
        keep, probs_d = None, probs
    dv = torch.einsum("bqk,bqd->bkd", probs_d, gf)
    dp = torch.einsum("bqd,bkd->bqk", gf, v.to(acc))
    if keep is not None:
        dp = torch.where(keep, dp * r, zero)
    delta = (gf * out.to(acc)).sum(dim=-1, keepdim=True)
    ds = probs * (dp - delta)
    dq = torch.einsum("bqk,bdk->bqd", ds, kT.to(acc)) * scale
    dkT = torch.einsum("bqd,bqk->bdk", q.to(acc), ds) * scale
    dbias = None
    if bias is not None and bias_grad:
        dbias = ds if bias.shape[0] == bh else ds.sum(dim=0, keepdim=True)
        dbias = dbias.to(bias.dtype)
    return dq.to(q.dtype), dkT.to(kT.dtype), dv.to(v.dtype), dbias


class _FlashAttentionFn(torch.autograd.Function):
    """The attention core as an autograd node (the reference's custom_vjp):
    `core` holds the route's training forward and backward."""

    @staticmethod
    def forward(ctx, core, seed, q, kT, v, bias):
        out, lse = core.train_forward(seed, q, kT, v, bias)
        ctx.core, ctx.seed = core, seed
        ctx.save_for_backward(q, kT, v, bias, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, kT, v, bias, out, lse = ctx.saved_tensors
        dq, dkT, dv, dbias = ctx.core.backward(ctx.seed, g, q, kT, v, bias,
                                               out, lse)
        if bias is not None and dbias is None and ctx.needs_input_grad[5]:
            dbias = torch.zeros_like(bias)    # a constant bias
        # the seed gets no gradient
        return None, None, dq, dkT, dv, dbias


class _Core:
    """One dispatched attention: the fused kernels or the torch composition,
    for serving (no graph), the training forward and the backward."""

    def __init__(self, dtype, bh, s, hd, sc, causal, dropout_p, bias_bh,
                 bias_requires_grad, use_fused, head_map=None):
        self.dtype, self.sc, self.causal = dtype, sc, causal
        self.dropout_p = dropout_p
        self.head_map = head_map
        self.bias_grad = bias_requires_grad and bias_bh > 0
        kw = dict(causal=causal, scale=sc, bias_bh=bias_bh,
                  dropout_p=dropout_p, head_map=head_map)
        self.fwd = self.fwd_lse = self.bwd = None
        if use_fused:
            self.fwd = ka.build_flash_attention(bh, s, hd, dtype, **kw)
            self.fwd_lse = ka.build_flash_attention(bh, s, hd, dtype,
                                                    return_lse=True, **kw)
            self.bwd = ka.build_flash_attention_bwd(
                bh, s, hd, dtype, bias_grad=self.bias_grad, **kw)

    def serve(self, seed, q, kT, v, bias):
        if self.fwd is not None:
            return self.fwd(seed, q, kT, v, bias)
        return _naive(q, kT, v, self.sc, self.causal, bias, self.dropout_p,
                      seed, self.head_map)

    def train_forward(self, seed, q, kT, v, bias):
        """(out, lse): the LSE-writing forward on the fused route; lse is
        None on the composition route."""
        if self.fwd_lse is not None:
            return self.fwd_lse(seed, q, kT, v, bias)
        return self.serve(seed, q, kT, v, bias), None

    def backward(self, seed, g, q, kT, v, bias, out, lse):
        if self.bwd is None:
            return _naive_bwd(q, kT, v, bias, out, g, self.sc, self.causal,
                              self.dropout_p, seed, self.bias_grad,
                              self.head_map)
        # delta = rowsum(dout * out) in f32, lane-broadcast to the kernels'
        # (bh, s, 128) statistic layout (a view: the kernels read column 0)
        delta = (g.float() * out.float()).sum(dim=-1, keepdim=True)
        delta = delta.expand(*delta.shape[:-1], 128)
        outs = self.bwd(seed, q, kT, v, g.to(self.dtype), lse, delta, bias)
        if self.bias_grad:
            dq, dkT, dv, dbias = outs
            return dq, dkT, dv, dbias.to(bias.dtype)
        return outs + (None,)


def _build_attention(desc) -> Kernel:
    (_, bh, s, hd, a_dt, causal, scale, dropout_p, bias_bh,
     bias_requires_grad, head_map) = desc
    dtype = to_torch(a_dt)
    sc = float(scale) if scale is not None else float(hd) ** -0.5
    has_bias = bias_bh > 0
    has_seed = dropout_p > 0.0

    use_fused = ka.supported(s, hd, dtype) and not (
        bias_requires_grad and bias_bh == 1)
    core = _Core(dtype, bh, s, hd, sc, causal, dropout_p, bias_bh,
                 bias_requires_grad, use_fused, head_map)

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
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (q, kT, v, bias)):
            return _FlashAttentionFn.apply(core, seed, q, kT, v, bias)
        return core.serve(seed, q, kT, v, bias)

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


@entry_point
def dispatch_flash_attention(bh: int, s: int, hd: int,
                             dtype: Datatype = Datatype.F32,
                             causal: bool = False,
                             scale: Optional[float] = None,
                             dropout_p: float = 0.0,
                             bias_bh: int = 0,
                             bias_requires_grad: bool = False,
                             head_map=None) -> Kernel:
    """Fused attention kernel: kernel(q, kT, v[, bias=][, seed=]) -> out.

    q, v: (bh, s, hd); kT: (bh, hd, s) — K pre-transposed, as the
    reference's layout. bias: (bias_bh, s, s) additive attention bias with
    bias_bh in {0 (none), 1 (broadcast), bh}. dropout_p drops attention
    probabilities (inverted scale); it requires seed= at call time. Returns
    (bh, s, hd) in the input dtype. Differentiable: on the fused route the
    backward is the two-kernel flash backward.

    bias_requires_grad=True propagates exact bias gradients: directly for
    bias_bh == bh; for bias_bh == 1 the call takes the torch composition,
    which sums over the batch. Default False returns a zero bias cotangent
    (the bias is treated as a constant).

    head_map=(b0, h0, nh_local, nh_global): this attention's bh = batches
    x nh_local heads are a block of one over nh_global heads (a rank's
    share of a data- and head-sharded attention), and the dropout mask is
    drawn at each head's global batch-head index (b0 + i // nh_local) *
    nh_global + h0 + i % nh_local, forward and backward, on both routes
    (kernels/attention.check_head_map). None hashes the local index."""
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
    head_map = (None if head_map is None
                else ka.check_head_map(head_map, bh))
    desc = ("flash_attn", bh, s, hd, dtype, bool(causal),
            None if scale is None else float(scale), float(dropout_p),
            int(bias_bh), bool(bias_requires_grad), head_map)
    return get_registry().dispatch(desc, _build_attention)
