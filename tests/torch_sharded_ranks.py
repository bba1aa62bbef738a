"""Rank functions of the sharded train steps' CPU tests, and the seeded
inputs they share with the JAX side.

Each `world_*` function runs on every rank of a gloo world of 4
(libxsmm_torch.scripts.ranks.run_ranks) and returns that rank's results:
its losses, the local blocks of the updated parameters and outputs, the
logged collectives, the dropout masks and hashed heads it drew, refusal
messages. The test files (tests/test_torch_sharded_*.py) hold them against
the JAX package's sharded steps on a mesh of the same size and against the
port's single-device steps, in the pytest process. This module imports
only numpy, torch and the port, so a spawned rank never loads JAX.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from libxsmm_torch.kernels import attention as KA
from libxsmm_torch.kernels import eltwise as KE
from libxsmm_torch.models import tpp_attention as TA
from libxsmm_torch.models import tpp_cnn as TC
from libxsmm_torch.models import tpp_gcn as TG
from libxsmm_torch.models import tpp_mlp as TM
from libxsmm_torch.models import tpp_moe as MOE
from libxsmm_torch.parallel import collectives as C
from libxsmm_torch.parallel.mesh import device_put, make_mesh

WORLD = 4

# ---------------------------------------------------------------- inputs

MLP_CFGS = {"three": TM.MlpConfig(in_dim=16, hidden=(32, 32), out_dim=8),
            "two": TM.MlpConfig(in_dim=16, hidden=(32,), out_dim=8)}
MLP_BATCH = 8
CNN_CFG = TC.CnnConfig(height=8, width=8, channels=3, filters=((3, 4),),
                       strides=(2,), classes=3)
GCN_CFG = TG.GcnConfig(in_dim=8, hidden=(16,), out_dim=3)
GCN_NODES, GCN_BLOCK = 64, 8
ATTN_CFG = dict(dim=32, heads=4, ffn_mult=2)
ATTN_X = (8, 128, 32)       # flash needs s % 128 == 0
ATTN_CASES = {              # name: (flash, causal, dropout_p)
    "flash": (True, False, 0.0),
    "flash_causal": (True, True, 0.0),
    "plain": (False, False, 0.0),
    "flash_drop": (True, False, 0.1),
    "plain_drop": (False, False, 0.1),
    "flash_causal_drop": (True, True, 0.1)}
DROP_SEED = 7
MOE_CFGS = {
    # the reference tests' configs (tests/test_pipeline_moe.py)
    "step": MOE.MoeConfig(dim=16, hidden=32, n_experts=4,
                          capacity_factor=4.0),
    "oracle2": MOE.MoeConfig(dim=16, hidden=32, n_experts=4,
                             capacity_factor=8.0, top_k=2),
    "a2a_dp": MOE.MoeConfig(dim=16, hidden=32, n_experts=4,
                            capacity_factor=8.0, aux_loss_weight=0.0),
    "aux": MOE.MoeConfig(dim=8, hidden=16, n_experts=4,
                         capacity_factor=8.0),
    "comm": MOE.MoeConfig(dim=16, hidden=32, n_experts=4),
    # capacity drops: a quarter of the slots the draw wants
    "drops": MOE.MoeConfig(dim=16, hidden=32, n_experts=4,
                           capacity_factor=0.5),
    "drops2": MOE.MoeConfig(dim=16, hidden=32, n_experts=4,
                            capacity_factor=0.5, top_k=2)}
MOE_SEEDS = {"step": 4, "oracle2": 8, "a2a_dp": 9, "aux": 10, "comm": 11,
             "drops": 12, "drops2": 13}
MOE_TOKENS = 32
LR = {"mlp": 1e-3, "cnn": 1e-2, "gcn": 1e-2, "attn": 1e-3, "moe": 1e-3,
      "a2a": 1e-2}


def normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def mlp_inputs(name):
    cfg = MLP_CFGS[name]
    return (normal(3, MLP_BATCH, cfg.in_dim),
            normal(4, MLP_BATCH, cfg.out_dim))


def cnn_inputs():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 8, 8, 3)).astype(np.float32)
    return x, rng.integers(0, 3, 8).astype(np.int32)


def ring_graph(n):
    a = np.zeros((n, n), np.float32)
    for i in range(n):
        a[i, (i + 1) % n] = a[(i + 1) % n, i] = 1.0
    return a


def gcn_inputs():
    rng = np.random.default_rng(6)
    return (rng.standard_normal((GCN_NODES, GCN_CFG.in_dim)).astype(
        np.float32), rng.integers(0, 3, GCN_NODES).astype(np.int32))


def attn_cfg(case):
    flash, causal, p = ATTN_CASES[case]
    return TA.AttentionConfig(flash=flash, causal=causal, dropout_p=p,
                              **ATTN_CFG)


def attn_inputs():
    return normal(3, *ATTN_X), normal(5, *ATTN_X, scale=0.1)


def moe_inputs(name):
    cfg = MOE_CFGS[name]
    seed = MOE_SEEDS[name]
    x = normal(seed + 100, MOE_TOKENS, cfg.dim)
    if name.startswith("drops"):
        # half the tokens one repeated row: they all want one expert
        x[::2] = x[0]
    return x, normal(seed + 200, MOE_TOKENS, cfg.dim)


def _t(x):
    return torch.as_tensor(x)


def _raises(fn, *args, **kw):
    """The message of the ValueError fn raises, or None."""
    try:
        fn(*args, **kw)
    except ValueError as e:
        return str(e)
    return None


def _locals(tree):
    """The local blocks of a tree of DTensors (a dict or a list of dicts)."""
    if isinstance(tree, dict):
        return {k: v.to_local() for k, v in tree.items()}
    return [{k: v.to_local() for k, v in layer.items()} for layer in tree]


def _full(tree):
    """The global tensors of a tree of DTensors (full_tensor)."""
    if isinstance(tree, dict):
        return {k: v.full_tensor() for k, v in tree.items()}
    return [{k: v.full_tensor() for k, v in layer.items()} for layer in tree]


def _log():
    return [(e["kind"], e["bytes"], e["shape"]) for e in C.log]

# ---------------------------------------------------------------- models


def labelled(rank, shape):
    """A labelled local block: rank * 1000 + position, f32."""
    return (rank * 1000 + np.arange(np.prod(shape))).reshape(shape).astype(
        np.float32)


def _differentiable_collectives(mesh):
    """The differentiable collectives over the world's 4 ranks on labelled
    data: each forward, and the gradient each backward hands back for a
    labelled cotangent (rank * 1000 + 500 + position)."""
    group, r = mesh.group("sp"), mesh.index("sp")
    x = _t(labelled(r, (8, 3)))

    def grad(fn, shape_out):
        xg = x.clone().requires_grad_(True)
        y = fn(xg)
        (y * _t(labelled(r, shape_out) + 500)).sum().backward()
        return y.detach(), xg.grad

    return {"reduce_scatter": grad(lambda v: C.reduce_scatter(v, group, 0),
                                   (2, 3)),
            "all_gather": grad(lambda v: C.all_gather(v, group, 1), (8, 12)),
            "all_gather_replicated": grad(
                lambda v: C.all_gather(v, group, 1, replicated=True),
                (8, 12)),
            "all_reduce": grad(lambda v: C.all_reduce(v, group), (8, 3)),
            "copy_to": grad(lambda v: C.copy_to(v, group), (8, 3)),
            "psum": grad(lambda v: C.psum(v, group), (8, 3)),
            "log": _log()}


def world_models():
    """The differentiable collectives; TPP-MLP on dp 2 x tp 2 (three and
    two layers), TPP-CNN on dp 4, TPP-GCN on sp 4: one train step each,
    from the global parameters; its loss, its updated parameters
    (full_tensor) and its logged collectives. Then the refusals of
    indivisible axes."""
    out = {"rank": dist.get_rank()}
    C.reset_log()
    out["collectives"] = _differentiable_collectives(
        make_mesh([("sp", 4)], device_type="cpu"))
    mesh = make_mesh([("dp", 2), ("tp", 2)], device_type="cpu")
    for name, cfg in MLP_CFGS.items():
        params = TM.shard_params(TM.init_params(cfg, seed=1, device="cpu"),
                                 mesh)
        step, xsh = TM.make_sharded_train_step(cfg, mesh, lr=LR["mlp"])
        x, y = mlp_inputs(name)
        C.reset_log()
        # x, y placed as the reference's test places them (no collective)
        new, loss = step(params, device_put(_t(x), xsh),
                         device_put(_t(y), xsh))
        out[f"mlp_{name}"] = {"loss": loss, "params": _full(new),
                              "log": _log(), "spec": xsh.spec}
    out["mlp_bad_tp"] = _raises(
        TM.make_sharded_train_step,
        TM.MlpConfig(in_dim=16, hidden=(33,), out_dim=8), mesh)

    mesh = make_mesh([("dp", 4)], device_type="cpu")
    step, xsh = TC.make_sharded_train_step(CNN_CFG, mesh)
    x, labels = cnn_inputs()
    C.reset_log()
    new, loss = step(TC.init_params(CNN_CFG, seed=1, device="cpu"), _t(x),
                     _t(labels))
    out["cnn"] = {"loss": loss, "params": _full(new), "log": _log()}
    out["cnn_bad_batch"] = _raises(step, new, _t(x[:6]), _t(labels[:6]))

    mesh = make_mesh([("sp", 4)], device_type="cpu")
    bsr = TG.normalize_adjacency(ring_graph(GCN_NODES), GCN_BLOCK)
    plan = TG._bsr_plan(bsr, device="cpu")
    step, hsh, lsh = TG.make_sharded_train_step(
        GCN_CFG, mesh, plan, GCN_NODES // GCN_BLOCK)
    h, labels = gcn_inputs()
    C.reset_log()
    new, loss = step(TG.init_params(GCN_CFG, seed=5, device="cpu"), _t(h),
                     _t(labels))
    out["gcn"] = {"loss": loss, "params": _full(new), "log": _log()}
    out["gcn_bad_nodes"] = _raises(TG.make_sharded_train_step, GCN_CFG,
                                   mesh, plan, 6)
    return out

# ---------------------------------------------------------------- encoder


class _Recorder:
    """Records the dropout kernel's masks and the flash kernels' hashed
    batch-head indices drawn while it is on."""

    def __init__(self):
        self.masks, self.heads = [], []
        self._drop, self._heads = KE.dropout, KA.head_index

    def __enter__(self):
        def dropout(x, seed, p, mask="bytes", block=None):
            res = self._drop(x, seed, p, mask, block)
            self.masks.append((int(seed), block, res[1].clone()))
            return res

        def head_index(bh, head_map, device):
            res = self._heads(bh, head_map, device)
            self.heads.append(res.flatten().clone())
            return res

        KE.dropout, KA.head_index = dropout, head_index
        return self

    def __exit__(self, *exc):
        KE.dropout, KA.head_index = self._drop, self._heads


def world_attention():
    """The encoder block on dp 2 x tp 2, every case of ATTN_CASES: one
    train step from the global parameters (init_params seed 3); the loss,
    the updated parameters (full_tensor), the logged bytes beside the
    analytic count, the dropout masks with their blocks and the flash
    kernels' hashed heads. Then the refusals."""
    out = {"rank": dist.get_rank()}
    mesh = make_mesh([("dp", 2), ("tp", 2)], device_type="cpu")
    out["index"] = (mesh.index("dp"), mesh.index("tp"))
    x, y = attn_inputs()
    for case in ATTN_CASES:
        cfg = attn_cfg(case)
        params = TA.shard_params(TA.init_params(cfg, seed=3, device="cpu"),
                                 mesh)
        seed = DROP_SEED if cfg.dropout_p > 0 else None
        step, xsh = TA.make_sharded_train_step(cfg, mesh, lr=LR["attn"],
                                               seed=seed)
        C.reset_log()
        with _Recorder() as rec:
            new, loss = step(params, _t(x), _t(y))
        out[case] = {"loss": loss, "params": _full(new),
                     "bytes": C.logged_bytes(),
                     "model": TA.encoder_comm_bytes_per_device(
                         cfg, ATTN_X[0], ATTN_X[1], 2, 2),
                     "kinds": sorted({e["kind"] for e in C.log}),
                     "masks": rec.masks, "heads": rec.heads}
    drop = attn_cfg("flash_drop")
    out["no_seed"] = _raises(TA.make_sharded_train_step, drop, mesh)
    out["bad_heads"] = _raises(
        TA.make_sharded_train_step,
        TA.AttentionConfig(dim=24, heads=3, ffn_mult=2), mesh)
    return out

# ---------------------------------------------------------------- MoE


def _moe_step(name, mesh, variant, lr, seed_params=None):
    cfg = MOE_CFGS[name]
    params = MOE.init_params(cfg, seed=MOE_SEEDS[name], device="cpu")
    step, xsh = MOE.make_sharded_train_step(cfg, mesh, lr=lr,
                                            variant=variant)
    x, y = moe_inputs(name)
    C.reset_log()
    new, loss = step(MOE.shard_params(params, mesh), _t(x), _t(y))
    return {"loss": loss, "params": _full(new), "log": _log(),
            "spec": xsh.spec}


def world_moe():
    """TPP-MoE over meshes of 4 ranks: the einsum step on dp 2 x ep 2 (with
    and without capacity drops, top-1 and top-2) and on ep 4; the a2a
    forward on ep 4 and dp 2 x ep 2, its step on dp 2 x ep 2, its aux; the
    comm report, the pick, the expert tensors' placement; refusals."""
    out = {"rank": dist.get_rank()}
    mesh = make_mesh([("dp", 2), ("ep", 2)], device_type="cpu")
    out["dp_ep_index"] = (mesh.index("dp"), mesh.index("ep"))
    for name in ("step", "drops", "drops2"):
        out[f"einsum_{name}"] = _moe_step(name, mesh, "einsum", LR["moe"])
    cfg = MOE_CFGS["step"]
    params = MOE.init_params(cfg, seed=MOE_SEEDS["step"], device="cpu")
    sp = MOE.shard_params(params, mesh)
    out["placement"] = {k: (tuple(v.shape), tuple(v.to_local().shape),
                            str(v.placements)) for k, v in sp.items()}
    x, _ = moe_inputs("step")
    y, aux = MOE.forward(sp, _t(x), cfg, mesh)
    out["einsum_forward"] = (y.full_tensor(), aux)
    out["a2a_step"] = _moe_step("a2a_dp", mesh, "a2a", LR["a2a"])
    cfg = MOE_CFGS["a2a_dp"]
    params = MOE.init_params(cfg, seed=MOE_SEEDS["a2a_dp"], device="cpu")
    x, _ = moe_inputs("a2a_dp")
    C.reset_log()
    y, aux = MOE.forward_a2a(MOE.shard_params(params, mesh), _t(x), cfg,
                             mesh, "dp", "ep")
    out["a2a_dp_forward"] = (y.full_tensor(), aux, _log())
    cfg = MOE_CFGS["comm"]
    out["report"] = MOE.moe_comm_report(cfg, mesh, n_tokens=MOE_TOKENS)
    out["pick"] = MOE.pick_moe_variant(cfg, mesh, n_tokens=MOE_TOKENS)
    out["pick_cached"] = MOE.pick_moe_variant(cfg, mesh,
                                              n_tokens=MOE_TOKENS)
    step, xsh = MOE.make_sharded_train_step(cfg, mesh, variant="auto",
                                            n_tokens=MOE_TOKENS)
    out["auto_spec"] = xsh.spec
    out["bad_variant"] = _raises(MOE.make_sharded_train_step, cfg, mesh,
                                 variant="nope")

    mesh = make_mesh([("ep", 4)], device_type="cpu")
    out["einsum_ep4"] = _moe_step("step", mesh, "einsum", LR["moe"])
    for name in ("oracle2", "aux"):
        cfg = MOE_CFGS[name]
        params = MOE.init_params(cfg, seed=MOE_SEEDS[name], device="cpu")
        x, _ = moe_inputs(name)
        C.reset_log()
        y, aux = MOE.forward_a2a(MOE.shard_params(params, mesh), _t(x), cfg,
                                 mesh, None, "ep")
        out[f"a2a_{name}"] = (y.full_tensor(), aux, _log())
    out["pick_ep4"] = MOE.pick_moe_variant(MOE_CFGS["comm"], mesh,
                                           n_tokens=MOE_TOKENS)
    out["bad_experts"] = _raises(
        MOE.shard_params,
        MOE.init_params(MOE.MoeConfig(dim=8, hidden=16, n_experts=6),
                        device="cpu"), mesh)
    return out


def world_moe_one():
    """A one-rank (dp 1 x ep 1) mesh: the einsum forward and step, which
    must equal the unsharded ones."""
    mesh = make_mesh([("dp", 1), ("ep", 1)], device_type="cpu")
    cfg = MOE_CFGS["step"]
    params = MOE.init_params(cfg, seed=MOE_SEEDS["step"], device="cpu")
    x, y = moe_inputs("step")
    fwd = MOE.forward(params, _t(x), cfg, mesh=mesh)
    new, loss = MOE.train_step(MOE.shard_params(params, mesh), _t(x), _t(y),
                               cfg, mesh=mesh)
    return {"y": fwd[0].to_local(), "aux": fwd[1], "loss": loss,
            "params": _locals(new)}
