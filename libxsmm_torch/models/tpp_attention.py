"""TPP-Attention: a transformer encoder block built from library primitives.

The port of `libxsmm_tpu/models/tpp_attention.py`, serving path: the TPP
paper's flagship composition (arXiv:2104.05755) — QKV projections,
score/context products, softmax, bias+GELU, layernorm, dropout.

  * The plain products (QKV, output projection, FFN, and the non-flash
    score/context einsums) are torch.matmul on f32 operands: bf16 products
    are exact in f32 and accumulate in f32, f32 products run at full f32
    (no TF32), as the reference's preferred_element_type + precision policy
    computes them outside any Pallas kernel.
  * Softmax and layernorm are written as their equation trees
    (equation_softmax.c, equation_layernorm.c), with statistics in f32.
  * flash=True runs the attention core through dispatch_flash_attention,
    the hand-written CUDA flash kernel on CUDA tensors; dropout runs the
    hand-written CUDA dropout kernel (kernels/eltwise.py).

Parameters are a dict of tensors with the reference's names and layouts
(head-major fused QKV columns, (heads, 3, head_dim)); `EncoderBlock` wraps
them as an nn.Module. Seeds keep the reference's offsets: `seed` for the
attention-probability dropout, `seed + 1` for the FFN dropout, `seed + 2`
for the flash kernel's dropout.

Not ported yet: train_step (the training slice, with the flash backward,
ROADMAP.md queue 2, item 8) and the sharded step (ROADMAP.md queue 1,
item 13).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..descriptor import UnaryFlags, UnaryType
from ..device import resolve_device
from ..dtypes import Datatype, from_torch
from ..ops.eltwise import apply_unary_op

_NEG = float(np.finfo(np.float32).min)


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    dim: int = 256            # model width
    heads: int = 8            # attention heads
    ffn_mult: int = 4         # FFN hidden = ffn_mult * dim
    dropout_p: float = 0.0    # attention+FFN dropout (0 disables)
    dtype: str = "float32"    # activation/weight storage dtype
    flash: bool = False       # fused flash attention (scores stay on chip)
    causal: bool = False      # autoregressive masking

    @property
    def head_dim(self) -> int:
        if self.dim % self.heads:
            raise ValueError(f"dim {self.dim} is not a multiple of heads "
                             f"{self.heads}")
        return self.dim // self.heads


_PARAM_NAMES = ("wqkv", "bqkv", "wo", "bo", "w1", "b1", "w2", "b2",
                "ln1_g", "ln1_b", "ln2_g", "ln2_b")


def init_params(cfg: AttentionConfig, seed: int = 0,
                device=None) -> Dict[str, torch.Tensor]:
    """One encoder block: fused QKV, output proj, 2-layer FFN, 2 layernorms,
    drawn from numpy's default_rng(seed) in the reference's order. wqkv
    columns are laid out (heads, 3, head_dim), head-major. The f64 draws are
    rounded to cfg.dtype by torch; a bf16 weight may differ from the
    reference's by one rounding (parity tests carry the reference's weights
    with params_from_numpy instead)."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    rng = np.random.default_rng(seed)
    d, h = cfg.dim, cfg.ffn_mult * cfg.dim

    def mat(fan_in, *shape):
        w = rng.standard_normal(shape) / np.sqrt(fan_in)
        return torch.as_tensor(w).to(device=dev, dtype=dt)

    def const(value, n):
        return torch.full((n,), value, dtype=dt, device=dev)

    return {
        "wqkv": mat(d, d, 3 * d), "bqkv": const(0.0, 3 * d),
        "wo": mat(d, d, d), "bo": const(0.0, d),
        "w1": mat(d, d, h), "b1": const(0.0, h),
        "w2": mat(h, h, d), "b2": const(0.0, d),
        "ln1_g": const(1.0, d), "ln1_b": const(0.0, d),
        "ln2_g": const(1.0, d), "ln2_b": const(0.0, d),
    }


def params_from_numpy(params, device=None) -> Dict[str, torch.Tensor]:
    """The reference's init_params dict (as numpy arrays: np.asarray of each
    JAX array) as the port's params, bit for bit (bf16 included)."""
    from ..interop import tensor_from_numpy
    types = {"float32": Datatype.F32, "bfloat16": Datatype.BF16,
             "float16": Datatype.F16, "float64": Datatype.F64}
    out = {}
    for name in _PARAM_NAMES:
        arr = np.asarray(params[name])
        out[name] = tensor_from_numpy(arr, types[arr.dtype.name], device)
    return out


def _softmax_rows(s):
    """The equation_softmax.c tree: DIV(EXP(SUB(x, rowmax)), rowsum),
    reductions in f32."""
    s = s.float()
    mx = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - mx)
    return e / e.sum(dim=-1, keepdim=True)


def _layernorm(x, gamma, beta, eps: float = 1e-5):
    """The equation_layernorm.c tree: (x - mean) * rstd * gamma + beta, with
    the statistics in f32 whatever the storage dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd * gamma.float() + beta.float()
    return y.to(x.dtype)


class _Dropout(torch.autograd.Function):
    """Inverted-scale dropout through the dropout kernel; the backward
    replays the saved keep-mask (the reference's DROPOUT / DROPOUT_INV
    pairing, models/tpp_attention.py:108-136)."""

    @staticmethod
    def forward(ctx, flat, p, seed):
        from ..kernels.eltwise import dropout
        out, mask = dropout(flat, seed, p)
        ctx.save_for_backward(mask)
        ctx.p = p
        return out

    @staticmethod
    def backward(ctx, g):
        from ..kernels.eltwise import dropout_inv
        (mask,) = ctx.saved_tensors
        return dropout_inv(g, mask, ctx.p), None, None


def _dropout(x, p: float, seed):
    """Dropout over x viewed as (-1, last dim); identity when p <= 0."""
    if p <= 0.0:
        return x
    flat = x.reshape(-1, x.shape[-1])
    return _Dropout.apply(flat, p, int(seed)).reshape(x.shape).to(x.dtype)


def _linear(x, w, b):
    """The fused brgemm_ext pattern: matmul + bias, f32 accumulation."""
    return torch.matmul(x.float(), w.float()) + b.float()[None, :]


def attention(params, x, cfg: AttentionConfig, seed=None):
    """Multi-head self-attention over x: (batch, seq, dim)."""
    b, s, d = x.shape
    hd, nh = cfg.head_dim, cfg.heads

    qkv = _linear(x.reshape(b * s, d), params["wqkv"], params["bqkv"])
    # head-major fused-QKV column layout (nh, 3, hd)
    qkv = qkv.to(x.dtype).reshape(b, s, nh, 3, hd)
    q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]

    if cfg.flash:
        from ..ops.attention import dispatch_flash_attention

        p_drop = cfg.dropout_p if seed is not None else 0.0
        kern = dispatch_flash_attention(b * nh, s, hd, from_torch(x.dtype),
                                        causal=cfg.causal, dropout_p=p_drop)
        qb = q.permute(0, 2, 1, 3).reshape(b * nh, s, hd)
        kTb = k.permute(0, 2, 3, 1).reshape(b * nh, hd, s)
        vb = v.permute(0, 2, 1, 3).reshape(b * nh, s, hd)
        # seed + 2: decorrelated from the FFN/prob dropout streams
        ctxb = (kern(qb, kTb, vb, seed=seed + 2) if p_drop > 0.0
                else kern(qb, kTb, vb))
        ctx = ctxb.reshape(b, nh, s, hd).permute(0, 2, 1, 3)
    else:
        # score products per (b, head), f32 accumulation
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        if cfg.causal:
            row = torch.arange(s, device=x.device)[:, None]
            col = torch.arange(s, device=x.device)[None, :]
            scores = torch.where((col <= row)[None, None], scores,
                                 torch.full((), _NEG, device=x.device))
        probs = _softmax_rows(scores * float(1.0 / np.sqrt(hd))).to(x.dtype)
        if cfg.dropout_p > 0.0 and seed is not None:
            probs = _dropout(probs, cfg.dropout_p, seed)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                           v.float()).to(x.dtype)
    out = _linear(ctx.reshape(b * s, d), params["wo"], params["bo"])
    return out.to(x.dtype).reshape(b, s, d)


def forward(params, x, cfg: AttentionConfig, seed=None):
    """Pre-LN encoder block: x + MHA(LN(x)); then x + FFN(LN(x)). seed=None
    serves (no dropout)."""
    b, s, d = x.shape
    h = x + attention(params, _layernorm(x, params["ln1_g"], params["ln1_b"]),
                      cfg, seed=seed)
    y = _layernorm(h, params["ln2_g"], params["ln2_b"])
    y = _linear(y.reshape(b * s, d), params["w1"], params["b1"])
    y = apply_unary_op(UnaryType.GELU, UnaryFlags.NONE, y)
    if cfg.dropout_p > 0.0 and seed is not None:
        y = _dropout(y.to(x.dtype), cfg.dropout_p, seed + 1)
    y = _linear(y.to(x.dtype), params["w2"], params["b2"])
    return h + y.to(x.dtype).reshape(b, s, d)


def loss_fn(params, x, y, cfg: AttentionConfig, seed=None):
    pred = forward(params, x, cfg, seed=seed)
    return torch.mean((pred.float() - y.float()) ** 2)


class EncoderBlock(torch.nn.Module):
    """The encoder block as an nn.Module: parameters under the reference's
    names, forward(x, seed=None). seed=None serves; a seed turns on the
    configured dropout. Without `params` the weights are init_params(cfg,
    init_seed) on `device` (default: the GPU, raising without one)."""

    def __init__(self, cfg: AttentionConfig, init_seed: int = 0,
                 device=None, params: Optional[dict] = None):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = init_params(cfg, init_seed, device)
        for name in _PARAM_NAMES:
            self.register_parameter(name, torch.nn.Parameter(
                params[name], requires_grad=False))

    def params(self) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in _PARAM_NAMES}

    def forward(self, x, seed=None):
        return forward(self.params(), x, self.cfg, seed=seed)
