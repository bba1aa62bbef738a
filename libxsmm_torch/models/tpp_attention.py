"""TPP-Attention: a transformer encoder block built from library primitives.

The port of `libxsmm_tpu/models/tpp_attention.py`, serving and training:
the TPP paper's flagship composition (arXiv:2104.05755) — QKV projections,
score/context products, softmax, bias+GELU, layernorm, dropout.

  * The plain products (QKV, output projection, FFN, and the non-flash
    score/context einsums) are torch.matmul on f32 operands: bf16 products
    are exact in f32 and accumulate in f32, f32 products run at full f32
    (no TF32), as the reference's preferred_element_type + precision policy
    computes them outside any Pallas kernel.
  * Softmax and layernorm are written as their equation trees
    (equation_softmax.c, equation_layernorm.c), with statistics in f32.
  * flash=True runs the attention core through dispatch_flash_attention,
    the hand-written CUDA flash kernel on CUDA tensors, and its gradient
    through the two flash-backward kernels; dropout runs the hand-written
    CUDA dropout kernel (kernels/eltwise.py), and its backward replays the
    saved mask.
  * train_step is the reference's jax.value_and_grad + SGD: torch autograd
    over the parameter dict, then p - lr * g in the parameter dtype.

Parameters are a dict of tensors with the reference's names and layouts
(head-major fused QKV columns, (heads, 3, head_dim)); `EncoderBlock` wraps
them as an nn.Module. Seeds keep the reference's offsets: `seed` for the
attention-probability dropout, `seed + 1` for the FFN dropout, `seed + 2`
for the flash kernel's dropout.

Sharded (shard_params, make_sharded_train_step), over a (dp, tp) mesh of
the port's parallel layer: dp splits the batch; tp splits the heads of the
attention (QKV column-parallel over the head-major fused columns, the
output projection row-parallel) and the FFN's hidden features (column- then
row-parallel); layernorms are replicated. The collectives GSPMD derives in
the reference are written out (parallel/spmd.py), and the sharded step
draws the single-device step's dropout masks: the flash kernels hash each
local head's global batch-head index (a head map) and the dropouts hash
each element's global index (a block), so a rank's masks are its blocks of
the unsharded masks, bit for bit.
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
from ..parallel import spmd
from ..parallel.mesh import NamedSharding, P, local

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
    def forward(ctx, flat, p, seed, block):
        from ..kernels.eltwise import dropout
        out, mask = dropout(flat, seed, p, block=block)
        ctx.save_for_backward(mask)
        ctx.p = p
        return out

    @staticmethod
    def backward(ctx, g):
        from ..kernels.eltwise import dropout_inv
        (mask,) = ctx.saved_tensors
        return dropout_inv(g, mask, ctx.p), None, None, None


def _dropout(x, p: float, seed, block=None):
    """Dropout over x viewed as (-1, last dim); identity when p <= 0. With
    a block (global_shape, offset), x is that block of a global tensor of
    the same number of dimensions, and draws the global tensor's bits."""
    if p <= 0.0:
        return x
    flat = x if block is not None else x.reshape(-1, x.shape[-1])
    return _Dropout.apply(flat, p, int(seed), block).reshape(x.shape).to(
        x.dtype)


def _linear(x, w, b):
    """The fused brgemm_ext pattern: matmul + bias, f32 accumulation."""
    return torch.matmul(x.float(), w.float()) + b.float()[None, :]


@dataclasses.dataclass(frozen=True)
class _Shard:
    """Where a rank's block lies in the sharded block's tensors: the
    tensor-parallel group (None: no tp axis), the global batch and this
    rank's first batch row b0, its first head h0 and first FFN column f0."""
    group: object
    batch: int
    b0: int
    h0: int
    f0: int


def _linear_in(x, w, b, shard):
    """QKV and the FFN's first product: column-parallel when sharded."""
    if shard is None:
        return _linear(x, w, b)
    return spmd.column_linear(x, w, b, shard.group)


def _linear_out(x, w, b, shard):
    """The output projection and the FFN's second product: row-parallel
    when sharded."""
    if shard is None:
        return _linear(x, w, b)
    return spmd.row_linear(x, w, b, shard.group)


def attention(params, x, cfg: AttentionConfig, seed=None, shard=None):
    """Multi-head self-attention over x: (batch, seq, dim). Sharded
    (`shard`), x is this rank's batch rows and the weights its heads."""
    b, s, d = x.shape
    hd, nh = cfg.head_dim, cfg.heads
    nh_l = params["wqkv"].shape[1] // (3 * hd)          # this rank's heads

    qkv = _linear_in(x.reshape(b * s, d), params["wqkv"], params["bqkv"],
                     shard)
    # head-major fused-QKV column layout (nh, 3, hd)
    qkv = qkv.to(x.dtype).reshape(b, s, nh_l, 3, hd)
    q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]

    if cfg.flash:
        from ..ops.attention import dispatch_flash_attention

        p_drop = cfg.dropout_p if seed is not None else 0.0
        head_map = (None if shard is None
                    else (shard.b0, shard.h0, nh_l, nh))
        kern = dispatch_flash_attention(b * nh_l, s, hd, from_torch(x.dtype),
                                        causal=cfg.causal, dropout_p=p_drop,
                                        head_map=head_map)
        qb = q.permute(0, 2, 1, 3).reshape(b * nh_l, s, hd)
        kTb = k.permute(0, 2, 3, 1).reshape(b * nh_l, hd, s)
        vb = v.permute(0, 2, 1, 3).reshape(b * nh_l, s, hd)
        # seed + 2: decorrelated from the FFN/prob dropout streams
        ctxb = (kern(qb, kTb, vb, seed=seed + 2) if p_drop > 0.0
                else kern(qb, kTb, vb))
        ctx = ctxb.reshape(b, nh_l, s, hd).permute(0, 2, 1, 3)
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
            # sharded: (b, nh_l, s, s) is the block at (b0, h0) of the
            # global (batch, nh, s, s) probabilities
            block = (None if shard is None else
                     ((shard.batch, nh, s, s), (shard.b0, shard.h0, 0, 0)))
            probs = _dropout(probs, cfg.dropout_p, seed, block)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                           v.float()).to(x.dtype)
    out = _linear_out(ctx.reshape(b * s, nh_l * hd), params["wo"],
                      params["bo"], shard)
    return out.to(x.dtype).reshape(b, s, d)


def forward(params, x, cfg: AttentionConfig, seed=None, shard=None):
    """Pre-LN encoder block: x + MHA(LN(x)); then x + FFN(LN(x)). seed=None
    serves (no dropout). Sharded (`shard`), x is this rank's batch rows,
    replicated over tp, and so is the result."""
    b, s, d = x.shape
    h = x + attention(params, _layernorm(x, params["ln1_g"], params["ln1_b"]),
                      cfg, seed=seed, shard=shard)
    y = _layernorm(h, params["ln2_g"], params["ln2_b"])
    y = _linear_in(y.reshape(b * s, d), params["w1"], params["b1"], shard)
    y = apply_unary_op(UnaryType.GELU, UnaryFlags.NONE, y)
    if cfg.dropout_p > 0.0 and seed is not None:
        # sharded: (b * s, f_l) is the block at (b0 * s, f0) of the global
        # (batch * s, ffn) hidden layer
        block = (None if shard is None else
                 ((shard.batch * s, cfg.ffn_mult * d),
                  (shard.b0 * s, shard.f0)))
        y = _dropout(y.to(x.dtype), cfg.dropout_p, seed + 1, block)
    y = _linear_out(y.to(x.dtype), params["w2"], params["b2"], shard)
    return h + y.to(x.dtype).reshape(b, s, d)


def loss_fn(params, x, y, cfg: AttentionConfig, seed=None):
    pred = forward(params, x, cfg, seed=seed)
    return torch.mean((pred.float() - y.float()) ** 2)


def loss_and_grads(params, x, y, cfg: AttentionConfig, seed=None):
    """(loss, grads): loss_fn and its gradient over the parameter dict, as
    jax.value_and_grad(loss_fn) gives them; grads share the params' names
    and dtypes. The params themselves are left untouched."""
    leaves = {n: params[n].detach().requires_grad_(True)
              for n in _PARAM_NAMES}
    with torch.enable_grad():
        loss = loss_fn(leaves, x, y, cfg, seed=seed)
        grads = torch.autograd.grad(loss, [leaves[n] for n in _PARAM_NAMES])
    return loss.detach(), dict(zip(_PARAM_NAMES, grads))


def sgd_update(params, grads, lr: float):
    """p - lr * g for every parameter, in the parameter dtype (the
    reference's jax.tree.map over the pair)."""
    with torch.no_grad():
        return {n: (p - lr * grads[n]).to(p.dtype) for n, p in params.items()}


def train_step(params, x, y, cfg: AttentionConfig, lr: float = 1e-3,
               seed=None):
    """One SGD step: returns (new_params, loss). With cfg.dropout_p > 0 a
    seed is required: without one the step would silently train without
    dropout (seed=None is the serving path)."""
    if cfg.dropout_p > 0.0 and seed is None:
        raise ValueError("cfg.dropout_p > 0 requires a seed in train_step")
    loss, grads = loss_and_grads(params, x, y, cfg, seed)
    return sgd_update(params, grads, lr), loss


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


# ---------------------------------------------------------------------------
# sharding: dp = batch, tp = heads (attention) / hidden features (FFN)
# ---------------------------------------------------------------------------

_PARAM_SPECS = {
    # QKV column-parallel: the head-major fused columns split on head
    # boundaries over tp
    "wqkv": P(None, "tp"), "bqkv": P("tp"),
    # output projection row-parallel: its input features are the heads
    "wo": P("tp", None), "bo": P(None),
    "w1": P(None, "tp"), "b1": P("tp"),
    "w2": P("tp", None), "b2": P(None),
    "ln1_g": P(None), "ln1_b": P(None),
    "ln2_g": P(None), "ln2_b": P(None),
}


def shard_params(params: dict, mesh) -> dict:
    """The global parameters (init_params or params_from_numpy) placed on
    the mesh by _PARAM_SPECS, as DTensors (mesh.shard; no collective)."""
    return spmd.place(params, mesh, _PARAM_SPECS)


def encoder_comm_bytes_per_device(cfg: AttentionConfig, batch: int, s: int,
                                  dp: int, tp: int) -> int:
    """The bytes the sharded step logs on each rank (collectives.py's
    count): four all-reduces over tp of the f32 (batch / dp * s, dim)
    activations (the output projection's and the FFN's partial products
    forward, the gradients of the QKV and FFN inputs backward), the sum
    over dp of this rank's gradients, one buffer a parameter dtype, and
    the loss (one f32) over dp."""
    def ring(nbytes, n):
        return 2 * nbytes * (n - 1) // n

    d, f = cfg.dim, cfg.ffn_mult * cfg.dim
    isz = torch.tensor([], dtype=getattr(torch, cfg.dtype)).element_size()
    act = batch // dp * s * d * 4
    local = (d * 3 * d // tp + 3 * d // tp + d // tp * d + d
             + d * f // tp + f // tp + f // tp * d + d + 4 * d)
    return 4 * ring(act, tp) + ring(local * isz, dp) + ring(4, dp)


def make_sharded_train_step(cfg: AttentionConfig, mesh, lr: float = 1e-3,
                            seed=None):
    """The full train step over a (dp, tp) mesh: (step, xsharding).
    step(params, x, y) -> (new_params, loss) takes shard_params' params and
    x, y placed by xsharding (or global tensors, cut locally); the new
    parameters keep their shardings, the loss is on every rank. Local
    flash runs on batch / dp * heads / tp heads with the head map of this
    rank's block, the dropouts on their blocks of the global tensors (the
    same masks as train_step's), and every gradient is summed over dp,
    none over tp.

    `seed` feeds the dropouts when cfg.dropout_p > 0, and is required
    then: without one the step raises instead of training without
    dropout."""
    if cfg.dropout_p > 0.0 and seed is None:
        raise ValueError("cfg.dropout_p > 0 requires seed= in "
                         "make_sharded_train_step")
    xsharding = NamedSharding(mesh, P("dp", None, None))
    dp, tp = spmd.axis_size(mesh, "dp"), spmd.axis_size(mesh, "tp")
    nh_l = spmd.divide(cfg.heads, tp, "heads")
    f_l = spmd.divide(cfg.ffn_mult * cfg.dim, tp, "FFN width")
    shards = spmd.shardings(mesh, _PARAM_SPECS)

    def step(params, x, y):
        batch, s, d = x.shape
        b_l = spmd.divide(batch, dp, "batch")
        shard = _Shard(spmd.group(mesh, "tp"), batch,
                       spmd.axis_index(mesh, "dp") * b_l,
                       spmd.axis_index(mesh, "tp") * nh_l,
                       spmd.axis_index(mesh, "tp") * f_l)
        xl, yl = local(x, xsharding), local(y, xsharding)
        count = batch * s * d

        def local_loss(lp):
            pred = forward(lp, xl, cfg, seed=seed, shard=shard)
            term = torch.sum((pred.float() - yl.float()) ** 2) / count
            return term, term

        return spmd.sgd_step(params, shards, mesh, lr, local_loss, ("dp",),
                             ("dp",))

    return step, xsharding
