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
order.

Sharded, over a (dp, ep) mesh of the port's parallel layer, in the
reference's two flavours, with every collective written out and logged
(parallel/collectives.py):
  * einsum (forward / loss_fn / train_step with a mesh): tokens split over
    dp and replicated over ep, expert tensors split over ep. The routing is
    the unsharded routing: the capacity from the global token count, each
    slot position offset by the tokens of earlier dp ranks (an all-gather
    of the per-expert counts, rank-major for top-2), the Switch aux over
    global means. Each rank sums its dispatched panels of its own experts
    over dp, runs the E/ep expert FFNs, and all-gathers their outputs over
    ep for its local combine, where the reference lets GSPMD derive the
    token movement from a sharding constraint.
  * a2a (forward_a2a, loss_fn_a2a): tokens split over (dp, ep), each
    shard routed with its local capacity, the panels moved by two
    all-to-alls; aux is the mean of the shards' aux over (dp, ep).
moe_comm_report counts a step's collectives from the port's log, where the
reference parses lowered StableHLO; pick_moe_variant times the two on the
mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..descriptor import UnaryFlags, UnaryType
from ..device import resolve_device
from ..ops.eltwise import apply_unary_op, load_operand
from ..parallel import collectives as C
from ..parallel import spmd
from ..parallel.mesh import NamedSharding, P, device_put, local, wrap

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


def _route(logits, n_experts: int, cap: int, top_k: int = 1, dp=None):
    """Top-k capacity routing: (S, E) logits -> dispatch (S, E, C) one-hot,
    combine (S, E, C) gate-weighted, aux load-balance loss. top_k=1 is
    Switch (raw gate weight); top_k=2 is GShard (the k gate values are
    renormalized, and capacity slots queue RANK-MAJOR: every token's first
    choice is seated before any second choice).

    dp=(group, index, n_global): the S tokens are rank `index`'s share of
    n_global tokens split over `group` in rank order, and the routing is
    that of all n_global: each slot position is offset by the choices the
    global order seats first (every token's earlier choices, then this
    choice of earlier ranks' tokens; an all-gather of the per-expert
    counts), and the aux is over the global means (an all-reduce of the
    sums)."""
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
    if dp is not None:
        pos = pos + _seat_offsets(onehot, dp)[None]
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
    if dp is None:
        frac = torch.mean(onehot[:, 0], dim=0)
        prob = torch.mean(gates, dim=0)
    else:
        group, _, n_global = dp
        frac = C.all_reduce(torch.sum(onehot[:, 0], dim=0), group) / n_global
        prob = C.all_reduce(torch.sum(gates, dim=0), group) / n_global
    aux = n_experts * torch.sum(frac * prob)
    return dispatch, combine, aux


def _seat_offsets(onehot, dp):
    """(k, E) offsets of a dp rank's local slot positions (rank-major, local
    cumulative counts) to the global ones: for choice r, the global count
    of every token's choices before r, less the local count of those, plus
    choice r's count over the earlier dp ranks' tokens."""
    group, index, _ = dp
    counts = onehot.sum(dim=0)                               # (k, E)
    every = C.all_gather(counts[None], group, axis=0)        # (dp, k, E)
    total = every.sum(dim=0)
    earlier_choices = torch.cumsum(total, dim=0) - total
    local_earlier = torch.cumsum(counts, dim=0) - counts
    return earlier_choices - local_earlier + every[:index].sum(dim=0)


def forward(params: dict, x: torch.Tensor, cfg: MoeConfig, mesh=None,
            ep_axis: str = "ep", dp_axis: str = "dp"):
    """x (S, d) -> (y (S, d), aux_loss), on x's device. With a mesh, the
    einsum variant over it: x split over dp_axis (a DTensor placed by
    P(dp_axis, None), or the global tensor), the expert tensors over
    ep_axis (shard_params); y comes back as a DTensor split like x, aux
    on every rank. A mesh without dp_axis splits no tokens."""
    if mesh is not None:
        return _forward_einsum(params, x, cfg, mesh, ep_axis, dp_axis)
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
    """The mean squared error plus the weighted aux; with a mesh, the
    einsum variant's loss over the global batch, on every rank."""
    if mesh is not None:
        dp_axis = "dp"
        xs = _token_sharding(mesh, dp_axis, None)
        lp = _local_params(params, mesh, "ep")
        mse, aux = _einsum_terms(lp, local(x, xs), local(y, xs),
                                 x.shape[0], cfg, mesh, "ep", dp_axis)
        return spmd.total(mse, mesh, (dp_axis,)) + cfg.aux_loss_weight * aux
    pred, aux = forward(params, x, cfg)
    mse = torch.mean((pred.float() - y.float()) ** 2)
    return mse + cfg.aux_loss_weight * aux


def loss_and_grads(params, x, y, cfg: MoeConfig):
    """(loss, grads): loss_fn and its gradient over the parameter dict, as
    jax.value_and_grad(loss_fn) gives them; the params are left untouched."""
    leaves = {k: params[k].detach().requires_grad_(True)
              for k in _PARAM_NAMES}
    with torch.enable_grad():
        loss = loss_fn(leaves, x, y, cfg)
        grads = torch.autograd.grad(loss, [leaves[k] for k in _PARAM_NAMES])
    return loss.detach(), dict(zip(_PARAM_NAMES, grads))


def train_step(params, x, y, cfg: MoeConfig, lr: float = 1e-3, mesh=None):
    """One SGD step, p - lr * g in the parameter dtype: (new_params, loss).
    With a mesh, the einsum variant's sharded step over it
    (make_sharded_train_step)."""
    if mesh is not None:
        step, _ = make_sharded_train_step(cfg, mesh, lr=lr)
        return step(params, x, y)
    loss, grads = loss_and_grads(params, x, y, cfg)
    with torch.no_grad():
        new = {k: (params[k] - lr * grads[k]).to(params[k].dtype)
               for k in _PARAM_NAMES}
    return new, loss


# ---------------------------------------------------------------------------
# sharding: tokens over dp (einsum) or (dp, ep) (a2a), experts over ep
# ---------------------------------------------------------------------------

def _param_specs(ep_axis: str = "ep") -> dict:
    return {"wg": P(None, None),
            "w1": P(ep_axis, None, None), "b1": P(ep_axis, None),
            "w2": P(ep_axis, None, None), "b2": P(ep_axis, None)}


def shard_params(params: dict, mesh, ep_axis: str = "ep") -> dict:
    """Router replicated; every expert tensor split over ep on the expert
    dimension (never gathered: the tokens move, not the weights). The
    global parameters placed as DTensors (mesh.shard; no collective)."""
    spmd.divide(int(params["wg"].shape[1]), spmd.axis_size(mesh, ep_axis),
                "n_experts")
    return spmd.place(params, mesh, _param_specs(ep_axis))


def _token_sharding(mesh, dp_axis, ep_axis):
    """Tokens over dp (einsum: ep_axis None) or over (dp, ep) (a2a)."""
    axes = spmd.present(mesh, (dp_axis, ep_axis))
    entry = None if not axes else (axes[0] if len(axes) == 1 else axes)
    return NamedSharding(mesh, P(entry, None))


def _local_params(params, mesh, ep_axis):
    return spmd.local_tree(params, spmd.shardings(mesh,
                                                  _param_specs(ep_axis)))


def _ffn(xe, lp, cfg: MoeConfig, dtype):
    """The stacked expert FFN on (E_l, rows, d) panels, as forward's."""
    h = torch.matmul(xe.float(), lp["w1"].float())
    h = h + lp["b1"].float()[:, None, :]
    h = apply_unary_op(cfg.activation, UnaryFlags.NONE, h).to(dtype)
    ye = torch.matmul(h.float(), lp["w2"].float())
    return (ye + lp["b2"].float()[:, None, :]).to(dtype)


def _einsum_local(lp, x, n_global, cfg: MoeConfig, mesh, ep_axis, dp_axis):
    """The einsum variant on this rank: (y, aux) of its tokens x (its dp
    share of n_global), routed as the unsharded routing; lp its blocks."""
    s, d = x.shape
    e = cfg.n_experts
    ep = spmd.axis_size(mesh, ep_axis)
    e_l = spmd.divide(e, ep, "n_experts")
    e0 = spmd.axis_index(mesh, ep_axis) * e_l
    dp_group = spmd.group(mesh, dp_axis)
    cap = capacity(cfg, n_global)
    logits = torch.matmul(x.float(), lp["wg"].float())
    dp = (None if dp_group is None
          else (dp_group, spmd.axis_index(mesh, dp_axis), n_global))
    dispatch, combine, aux = _route(logits, e, cap, cfg.top_k, dp)
    # this rank's tokens in its own experts' slots, summed over dp: each
    # slot holds one token of one rank, so the panels are x's values
    xe = torch.matmul(dispatch[:, e0:e0 + e_l].permute(1, 2, 0), x.float())
    if dp_group is not None:
        xe = C.psum(xe, dp_group)
    ye = _ffn(xe.to(x.dtype), lp, cfg, x.dtype)               # (E_l, C, d)
    ep_group = spmd.group(mesh, ep_axis)
    if ep_group is not None:
        # every ep rank combines the same tokens: replicated over ep
        ye = C.all_gather(ye, ep_group, axis=0, replicated=True)
    y = torch.matmul(combine.reshape(s, e * cap),
                     ye.float().reshape(e * cap, d))
    return y.to(x.dtype), aux


def _einsum_terms(lp, x, y, n_global, cfg, mesh, ep_axis, dp_axis):
    """(this rank's share of the mean squared error, the global aux)."""
    pred, aux = _einsum_local(lp, x, n_global, cfg, mesh, ep_axis, dp_axis)
    mse = torch.sum((pred.float() - y.float()) ** 2) / (n_global * cfg.dim)
    return mse, aux


def _forward_einsum(params, x, cfg, mesh, ep_axis, dp_axis):
    xs = _token_sharding(mesh, dp_axis, None)
    y, aux = _einsum_local(_local_params(params, mesh, ep_axis),
                           local(x, xs), x.shape[0], cfg, mesh, ep_axis,
                           dp_axis)
    return wrap(y, xs, tuple(x.shape)), aux


# ------------------------------------------- explicit all-to-all dispatch

def moe_a2a_comm_bytes_per_device(cfg: MoeConfig, s_local: int, ndev: int,
                                  dtype=None) -> int:
    """Analytic per-device comm volume of forward_a2a: 2 all-to-alls
    (dispatched panels out, expert outputs back), each moving the
    (P-1)/P remote fraction of the local (E, C_loc, d) panel."""
    dt = dtype or cfg.dtype
    if not isinstance(dt, torch.dtype):
        dt = getattr(torch, dt if isinstance(dt, str) else np.dtype(dt).name)
    isz = dt.itemsize
    panel = cfg.n_experts * capacity(cfg, s_local) * cfg.dim * isz
    return 2 * panel * (ndev - 1) // ndev


def _a2a_local(lp, x, cfg: MoeConfig, mesh, dp_axis, ep_axis):
    """forward_a2a on this rank: (y, aux) of its tokens, routed with the
    local capacity; aux the mean over (dp, ep) of the shards' aux."""
    s_loc, d = x.shape
    e = cfg.n_experts
    ep = spmd.axis_size(mesh, ep_axis)
    e_l = spmd.divide(e, ep, "n_experts")
    cap = capacity(cfg, s_loc)
    logits = torch.matmul(x.float(), lp["wg"].float())
    dispatch, combine, aux = _route(logits, e, cap, cfg.top_k)
    xe = torch.matmul(dispatch.permute(1, 2, 0), x.float()).to(x.dtype)
    # (E, C, d) -> (P, E/P, C, d): block j goes to ep index j, which gets
    # its own experts' tokens from every source shard
    xe = xe.reshape(ep, e_l, cap, d)
    group = spmd.group(mesh, ep_axis)
    if group is not None:
        xe = C.all_to_all(xe, group, 0, 0)
    # (src, E/P, C, d) -> (E/P, src * C, d)
    xr = xe.permute(1, 0, 2, 3).reshape(e_l, ep * cap, d)
    ye = _ffn(xr, lp, cfg, x.dtype)
    ye = ye.reshape(e_l, ep, cap, d).permute(1, 0, 2, 3).contiguous()
    if group is not None:
        ye = C.all_to_all(ye, group, 0, 0)
    yr = ye.reshape(e, cap, d)
    y = torch.matmul(combine.reshape(s_loc, e * cap),
                     yr.float().reshape(e * cap, d))
    axes = (dp_axis, ep_axis)
    for axis in spmd.present(mesh, axes):
        aux = C.all_reduce(aux, mesh.group(axis))
    return y.to(x.dtype), aux / spmd.ranks(mesh, axes)


def forward_a2a(params: dict, x, cfg: MoeConfig, mesh, dp_axis: str = None,
                ep_axis: str = "ep"):
    """x (S, d) GLOBAL, split over (dp?, ep) on the token axis (a DTensor
    placed that way, or the global tensor) -> (y (S, d) split alike, aux).
    Explicit-collective MoE: per-shard top-k routing, one all_to_all out,
    E/P local expert FFNs, one all_to_all back, local combine. aux is the
    mean of the per-shard Switch losses over (dp, ep)."""
    spmd.divide(cfg.n_experts, spmd.axis_size(mesh, ep_axis), "n_experts")
    xs = _token_sharding(mesh, dp_axis, ep_axis)
    y, aux = _a2a_local(_local_params(params, mesh, ep_axis), local(x, xs),
                        cfg, mesh, dp_axis, ep_axis)
    return wrap(y, xs, tuple(x.shape)), aux


def loss_fn_a2a(params, x, y, cfg: MoeConfig, mesh, dp_axis=None,
                ep_axis="ep"):
    """The a2a variant's loss over the global batch, on every rank."""
    xs = _token_sharding(mesh, dp_axis, ep_axis)
    pred, aux = _a2a_local(_local_params(params, mesh, ep_axis),
                           local(x, xs), cfg, mesh, dp_axis, ep_axis)
    mse = torch.sum((pred.float() - local(y, xs).float()) ** 2) / (
        x.shape[0] * cfg.dim)
    return (spmd.total(mse, mesh, (dp_axis, ep_axis))
            + cfg.aux_loss_weight * aux)


_COLLECTIVES = ("all_to_all", "all_reduce", "all_gather",
                "collective_permute", "reduce_scatter",
                "collective_broadcast")


def hlo_collectives(txt: str) -> dict:
    """Count collective ops in a lowered module (the backend-independent
    comm evidence used to compare the einsum and a2a variants)."""
    import re
    t = txt.replace("-", "_")
    return {n: len(re.findall(rf'"stablehlo\.{n}"|stablehlo\.{n}\W', t))
            for n in _COLLECTIVES}


def _log_counts(entries) -> dict:
    """hlo_collectives' keys, counted from the port's collective log."""
    return {n: sum(1 for e in entries if e["kind"] == n)
            for n in _COLLECTIVES}


def moe_comm_report(cfg: MoeConfig, mesh, n_tokens: int,
                    dp_axis: str = "dp", ep_axis: str = "ep") -> dict:
    """Collective counts of one train step of each variant, under
    hlo_collectives' keys, from the port's collective log (where the
    reference counts its lowered StableHLO), and the a2a analytic bytes.
    Runs both steps once on zero tokens, on every rank of the mesh."""
    ndev = spmd.axis_size(mesh, ep_axis)
    dp = spmd.axis_size(mesh, dp_axis)
    s_local = n_tokens // (dp * ndev)
    params = shard_params(init_params(cfg, device=mesh.device), mesh,
                          ep_axis)
    x = torch.zeros((n_tokens, cfg.dim), dtype=getattr(torch, cfg.dtype),
                    device=mesh.device)
    out = {}
    for variant in ("einsum", "a2a"):
        step, _ = make_sharded_train_step(cfg, mesh, dp_axis, ep_axis,
                                          variant=variant)
        start = len(C.log)
        step(params, x, x)
        out[variant] = _log_counts(C.log[start:])
    out["a2a_bytes_per_device"] = moe_a2a_comm_bytes_per_device(
        cfg, s_local, ndev)
    return out


_VARIANT_PICKS: dict = {}


def pick_moe_variant(cfg: MoeConfig, mesh, n_tokens: int,
                     dp_axis: str = "dp", ep_axis: str = "ep") -> dict:
    """Create-time autotune between the einsum and the explicit-a2a
    dispatch: both forwards timed INTERLEAVED on the mesh (CUDA events on
    the card, the host clock on a CPU mesh; the same calls on every rank),
    the times summed over the mesh so every rank keeps the same winner.
    Cached per (cfg, mesh shape and device, tokens, dp_axis, ep_axis)."""
    key = (cfg, tuple(mesh.shape.items()), mesh.device_type, n_tokens,
           dp_axis, ep_axis)
    if key in _VARIANT_PICKS:
        return _VARIANT_PICKS[key]
    from ..utils.timer import bench_chain_interleaved, bench_host_interleaved

    params = shard_params(init_params(cfg, device=mesh.device), mesh,
                          ep_axis)
    x = torch.zeros((n_tokens, cfg.dim), dtype=getattr(torch, cfg.dtype),
                    device=mesh.device)
    x_ein = device_put(x, _token_sharding(mesh, dp_axis, None))
    x_a2a = device_put(x, _token_sharding(mesh, dp_axis, ep_axis))
    bench = (bench_chain_interleaved if mesh.device_type == "cuda"
             else bench_host_interleaved)
    t_ein, t_a2a = bench(
        [(lambda xx: forward(params, xx, cfg, mesh, ep_axis, dp_axis)[0],
          (x_ein,)),
         (lambda xx: forward_a2a(params, xx, cfg, mesh, dp_axis,
                                 ep_axis)[0], (x_a2a,))],
        reps=4, rounds=2)
    times = torch.tensor([t_ein, t_a2a], dtype=torch.float64)
    for axis in spmd.present(mesh, (dp_axis, ep_axis)):
        times = C.all_reduce(times, mesh.group(axis))
    t_ein, t_a2a = (float(v) / mesh.device_mesh.size() for v in times)
    out = {"einsum_s": t_ein, "a2a_s": t_a2a,
           "pick": "a2a" if t_a2a < t_ein else "einsum"}
    _VARIANT_PICKS[key] = out
    return out


def make_sharded_train_step(cfg: MoeConfig, mesh, dp_axis: str = "dp",
                            ep_axis: str = "ep", lr: float = 1e-3,
                            variant: str = "einsum", n_tokens: int = None):
    """The full train step over a (dp, ep) mesh: (step, xsharding).
    variant "einsum": tokens split over dp, experts over ep, the routing
    the unsharded one; "a2a": tokens split over (dp, ep), two explicit
    all-to-alls; "auto": pick_moe_variant's winner on this mesh (at
    n_tokens, default 16 per rank). step(params, x, y) -> (new_params,
    loss) takes shard_params' params and x, y placed by xsharding (or
    global tensors); the router's gradient is summed over every axis the
    tokens are split on, the experts' over dp only (never over ep, where
    each rank's experts are its own)."""
    if variant == "auto":
        variant = pick_moe_variant(cfg, mesh,
                                   n_tokens or 16 * mesh.device_mesh.size(),
                                   dp_axis, ep_axis)["pick"]
    if variant not in ("einsum", "a2a"):
        raise ValueError(f"variant must be einsum, a2a or auto, not "
                         f"{variant!r}")
    spmd.divide(cfg.n_experts, spmd.axis_size(mesh, ep_axis), "n_experts")
    a2a = variant == "a2a"
    xsharding = _token_sharding(mesh, dp_axis, ep_axis if a2a else None)
    shards = spmd.shardings(mesh, _param_specs(ep_axis))
    token_axes = (dp_axis, ep_axis) if a2a else (dp_axis,)
    grad_axes = {(k,): (token_axes if k == "wg" else (dp_axis,))
                 for k in _PARAM_NAMES}
    w = cfg.aux_loss_weight

    def step(params, x, y):
        xl, yl = local(x, xsharding), local(y, xsharding)
        n_global = x.shape[0]
        spmd.divide(n_global, spmd.ranks(mesh, token_axes), "tokens")

        def local_loss(lp):
            if a2a:
                pred, aux = _a2a_local(lp, xl, cfg, mesh, dp_axis, ep_axis)
                mse = torch.sum((pred.float() - yl.float()) ** 2) / (
                    n_global * cfg.dim)
            else:
                mse, aux = _einsum_terms(lp, xl, yl, n_global, cfg, mesh,
                                         ep_axis, dp_axis)
            # aux is whole on every rank: counted whole in the term (its
            # gradient reaches each rank's own share through the
            # all-reduce), once over the ranks in the share
            return (mse + w * aux,
                    mse + w * aux / spmd.ranks(mesh, token_axes))

        return spmd.sgd_step(params, shards, mesh, lr, local_loss,
                             grad_axes, token_axes)

    return step, xsharding

