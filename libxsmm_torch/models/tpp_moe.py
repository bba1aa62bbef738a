"""TPP-MoE: a mixture-of-experts FFN, on one device.

The port of `libxsmm_tpu/models/tpp_moe.py`. An MoE layer's expert compute
is the workload LIBXSMM exists for: E independent small GEMMs over
(capacity, d) token panels (the packed/batched small-GEMM domain,
samples/magazine/magazine_batch.c), here one batched product over E
stacked panels.

  * Static shapes (the GShard/Switch capacity formulation): routing
    materializes a (S, E, C) one-hot dispatch tensor; tokens past an
    expert's capacity are dropped (zero dispatch and zero combine weight).
  * Dispatch and combine are products with those tensors; the top-k pick is
    the only non-differentiable piece, and gradients flow through the gate
    values. Among equal gates the lower expert index wins, on every device
    (jax.lax.top_k's order).
  * The products are torch.matmul on f32 operands, as the port's other
    models compute theirs: bf16 products exact in f32 and accumulated in
    f32, f32 at full f32 (no TF32); the combine at full f32 (the
    reference's c1dee14 policy). This model runs no kernel of its own.
  * Load-balance auxiliary loss (Switch: E * sum_e f_e * p_e) over first
    choices; it is part of the train objective.

Parameters are a dict of tensors with the reference's names and layouts;
init_params draws them from numpy's default_rng(seed) in the reference's
order. Not ported yet: shard_params, forward_a2a and the sharded step
(ROADMAP.md queue 1, item 13); a mesh argument raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..descriptor import UnaryFlags, UnaryType
from ..device import resolve_device
from ..ops.eltwise import apply_unary_op, load_operand

_PARAM_NAMES = ("wg", "w1", "b1", "w2", "b2")


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    dim: int = 64
    hidden: int = 128
    n_experts: int = 8
    top_k: int = 1                  # 1 = Switch routing, 2 = GShard
    capacity_factor: float = 1.25   # C = ceil(cf * k * S / E)
    aux_loss_weight: float = 1e-2
    activation: UnaryType = UnaryType.GELU
    dtype: str = "float32"


def capacity(cfg: MoeConfig, n_tokens: int) -> int:
    return max(1, int(np.ceil(cfg.capacity_factor * cfg.top_k * n_tokens
                              / cfg.n_experts)))


def init_params(cfg: MoeConfig, seed: int = 0,
                device=None) -> Dict[str, torch.Tensor]:
    """Router and experts from numpy's default_rng(seed) in the reference's
    order, scaled by 1/sqrt(fan_in), rounded to cfg.dtype by torch (a bf16
    weight may differ from the reference's by one rounding; parity tests
    carry the reference's weights with params_from_numpy); zero biases."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    rng = np.random.default_rng(seed)
    d, h, e = cfg.dim, cfg.hidden, cfg.n_experts

    def mat(fan_in, *shape):
        return torch.as_tensor(rng.standard_normal(shape)
                               / np.sqrt(fan_in)).to(device=dev, dtype=dt)

    return {
        "wg": mat(d, d, e),                  # router
        "w1": mat(d, e, d, h),
        "b1": torch.zeros((e, h), dtype=dt, device=dev),
        "w2": mat(h, e, h, d),
        "b2": torch.zeros((e, d), dtype=dt, device=dev),
    }


def params_from_numpy(params, device=None) -> Dict[str, torch.Tensor]:
    """The reference's parameter dict (numpy arrays: np.asarray of each JAX
    array) as the port's, bit for bit (bf16 included)."""
    # a writable copy each: np.asarray of a JAX array is read-only
    return {name: load_operand(np.array(params[name]), device)
            for name in _PARAM_NAMES}


def _top_k(gates: torch.Tensor, k: int):
    """(values, indices) of the k largest gates a row, the lower index
    first among equal gates (jax.lax.top_k's order; torch.topk promises no
    order among ties on the GPU)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _route(logits, n_experts: int, cap: int, top_k: int = 1):
    """Top-k capacity routing: (S, E) logits -> dispatch (S, E, C) one-hot,
    combine (S, E, C) gate-weighted, aux load-balance loss. top_k=1 is
    Switch (raw gate weight); top_k=2 is GShard (the k gate values are
    renormalized, and capacity slots queue RANK-MAJOR: every token's first
    choice is seated before any second choice)."""
    s, e = logits.shape
    gates = torch.softmax(logits.float(), dim=-1)
    vals, idx = _top_k(gates, top_k)                        # (S, k)
    if top_k > 1:
        vals = vals / torch.sum(vals, dim=-1, keepdim=True)
    onehot = torch.nn.functional.one_hot(idx, n_experts).float()  # (S, k, E)
    # rank-major arrival order: flatten to (k*S, E) with rank outermost
    oh_flat = onehot.transpose(0, 1).reshape(top_k * s, e)
    pos_flat = torch.cumsum(oh_flat, dim=0) - oh_flat
    pos = pos_flat.reshape(top_k, s, e).transpose(0, 1)    # (S, k, E)
    pos_tok = torch.sum(pos * onehot, dim=-1)               # (S, k)
    keep = (pos_tok < cap).float()
    # the slot one-hot; a position at or past `cap` gives an all-zero row
    # (jax.nn.one_hot's, where torch's one_hot raises)
    slots = torch.arange(cap, device=logits.device)
    slot = (pos_tok.long()[..., None] == slots).float()     # (S, k, C)
    dispatch = combine = None
    for r in range(top_k):     # the ranks pick distinct experts: exact sums
        seat = onehot[:, r, :, None] * slot[:, r, None, :]  # (S, E, C)
        d_r = seat * keep[:, r, None, None]
        c_r = seat * (vals[:, r] * keep[:, r])[:, None, None]
        dispatch = d_r if dispatch is None else dispatch + d_r
        combine = c_r if combine is None else combine + c_r
    # Switch aux loss over FIRST choices: E * sum_e (fraction_e * prob_e)
    frac = torch.mean(onehot[:, 0], dim=0)
    prob = torch.mean(gates, dim=0)
    aux = n_experts * torch.sum(frac * prob)
    return dispatch, combine, aux


def forward(params: dict, x: torch.Tensor, cfg: MoeConfig, mesh=None):
    """x (S, d) -> (y (S, d), aux_loss), on x's device."""
    if mesh is not None:
        raise NotImplementedError(
            "the sharded MoE (shard_params, forward_a2a, the sharded step) "
            "is not ported yet: ROADMAP.md queue 1, item 13")
    s, d = x.shape
    cap = capacity(cfg, s)
    logits = torch.matmul(x.float(), params["wg"].float())
    dispatch, combine, aux = _route(logits, cfg.n_experts, cap, cfg.top_k)
    e = cfg.n_experts
    # dispatch: the token panels, (E, C, S) @ (S, d); each slot holds one
    # token at most, so the panels are x's values exactly
    xe = torch.matmul(dispatch.permute(1, 2, 0), x.float()).to(x.dtype)
    # expert FFN: E stacked small GEMMs, the library's batched SMM shape
    h = torch.matmul(xe.float(), params["w1"].float())
    h = h + params["b1"].float()[:, None, :]
    h = apply_unary_op(cfg.activation, UnaryFlags.NONE, h).to(x.dtype)
    ye = torch.matmul(h.float(), params["w2"].float())
    ye = (ye + params["b2"].float()[:, None, :]).to(x.dtype)
    # combine at full f32: (S, E*C) @ (E*C, d)
    y = torch.matmul(combine.reshape(s, e * cap),
                     ye.float().reshape(e * cap, d))
    return y.to(x.dtype), aux


def reference_forward(params: dict, x, cfg: MoeConfig) -> np.ndarray:
    """Per-token numpy oracle (no capacity drops: capacity_factor must
    cover the draw) for parity checks. Takes tensors or arrays."""
    def f32(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().float().cpu().numpy()
        return np.asarray(v, np.float32)

    xf = f32(x)
    wg = f32(params["wg"])
    w1, b1 = f32(params["w1"]), f32(params["b1"])
    w2, b2 = f32(params["w2"]), f32(params["b2"])
    logits = xf @ wg
    e = np.exp(logits - logits.max(-1, keepdims=True))
    gates = e / e.sum(-1, keepdims=True)
    order = np.argsort(-gates, axis=-1)[:, :cfg.top_k]
    out = np.zeros_like(xf)
    for i in range(xf.shape[0]):
        picks = order[i]
        g = gates[i, picks]
        if cfg.top_k > 1:
            g = g / g.sum()
        for k, gk in zip(picks, g):
            h = xf[i] @ w1[k] + b1[k]
            h = apply_unary_op(cfg.activation, UnaryFlags.NONE,
                               torch.from_numpy(h)).numpy()
            y = h @ w2[k] + b2[k]
            out[i] += gk * y
    return out


def loss_fn(params, x, y, cfg: MoeConfig, mesh=None) -> torch.Tensor:
    pred, aux = forward(params, x, cfg, mesh)
    mse = torch.mean((pred.float() - y.float()) ** 2)
    return mse + cfg.aux_loss_weight * aux


def loss_and_grads(params, x, y, cfg: MoeConfig, mesh=None):
    """(loss, grads): loss_fn and its gradient over the parameter dict, as
    jax.value_and_grad(loss_fn) gives them; the params are left untouched."""
    leaves = {k: params[k].detach().requires_grad_(True)
              for k in _PARAM_NAMES}
    with torch.enable_grad():
        loss = loss_fn(leaves, x, y, cfg, mesh)
        grads = torch.autograd.grad(loss, [leaves[k] for k in _PARAM_NAMES])
    return loss.detach(), dict(zip(_PARAM_NAMES, grads))


def train_step(params, x, y, cfg: MoeConfig, lr: float = 1e-3, mesh=None):
    """One SGD step, p - lr * g in the parameter dtype: (new_params, loss)."""
    loss, grads = loss_and_grads(params, x, y, cfg, mesh)
    with torch.no_grad():
        new = {k: (params[k] - lr * grads[k]).to(params[k].dtype)
               for k in _PARAM_NAMES}
    return new, loss
