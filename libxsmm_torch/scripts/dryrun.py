"""Single-device entry point and multi-device dry run of the port.

    python -m libxsmm_torch.scripts.dryrun [N]

The port's counterpart of the repo root's __graft_entry__.py, which stays
the JAX package's. `entry()` returns the TPP-MLP forward and its example
arguments at that file's widths. `dryrun_multichip(n)` runs every leg of
its dry run on `n` gloo ranks on the CPU (scripts/ranks.run_ranks, one
process a rank), at its sizes and bounds, each leg held against the
single-device computation on every rank:

  * dp x tp: one TPP-MLP train step (loss and updated weights);
  * sp: the distributed BSR SpMM ring (1e-3);
  * sp: one TPP-GCN train step with the nodes sharded;
  * dp: one TPP-CNN train step;
  * dp x tp: one TPP-Attention encoder train step;
  * sp: ring and Ulysses attention, causal, forward (1e-4) and backward;
  * pp (x dp): the GPipe forward (1e-4) and one train step;
  * dp x ep: TPP-MoE's einsum forward (1e-4) and step, then the explicit
    all-to-all forward (1e-4), step, comm report and variant pick.

Train steps are held to 1e-4 too (their loss and updated parameters). One
line a leg is printed, as the JAX package's dry run prints them. Its
weak-scaling leg projects efficiency from a model of TPU links; a world of
gloo processes on one host measures no scaling, so the port prints that
it claims no figure.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Tuple

import numpy as np

BOUND = 1e-4          # every leg but the SpMM
BOUND_SPMM = 1e-3


def entry(device=None):
    """(fn, example_args): the TPP-MLP forward at in_dim 256, hidden (512,
    512), out_dim 128 on a batch of 64 (f32), on `device` (the card by
    default)."""
    import torch

    from ..models.tpp_mlp import MlpConfig, forward, init_params

    cfg = MlpConfig(in_dim=256, hidden=(512, 512), out_dim=128)
    params = init_params(cfg, device=device)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (64, cfg.in_dim)), dtype=torch.float32,
        device=params[0]["w"].device)

    def fn(params, x):
        return forward(params, x, cfg)

    return fn, (params, x)


def _normal(seed, *shape):
    import torch
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        shape), dtype=torch.float32)


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _err(a, b) -> float:
    import torch
    return float((_full(a).double() - torch.as_tensor(_full(b)).double())
                 .abs().max())


def _tree_err(a, b) -> float:
    if isinstance(a, dict):
        return max(_tree_err(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return max(_tree_err(x, y) for x, y in zip(a, b))
    return _err(a, b)


def _mlp(n, leg):
    from ..models import tpp_mlp as TM
    from ..parallel.mesh import make_mesh
    tp = 2 if n % 2 == 0 else 1
    dp = n // tp
    mesh = make_mesh([("dp", dp), ("tp", tp)], device_type="cpu")
    cfg = TM.MlpConfig(in_dim=32, hidden=(64, 64), out_dim=16)
    x, y = _normal(1, 8 * dp, cfg.in_dim), _normal(2, 8 * dp, cfg.out_dim)
    step, _ = TM.make_sharded_train_step(cfg, mesh)
    new, loss = step(TM.shard_params(TM.init_params(cfg, device="cpu"),
                                     mesh), x, y)
    ref_new, ref_loss = TM.train_step(TM.init_params(cfg, device="cpu"), x,
                                      y, cfg)
    err = max(_err(loss, ref_loss), _tree_err(new, ref_new))
    leg(f"dryrun dp={dp} tp={tp}: train step OK, loss={float(loss):.4f}",
        err)


def _spmm(n, leg):
    import torch

    from ..ops.sparse import BsrMatrix
    from ..parallel.mesh import make_mesh
    from ..parallel.spmm_dist import DistributedBsrSpmm
    rng = np.random.default_rng(3)
    m = k = 16 * n
    a = rng.standard_normal((m, k)).astype(np.float32)
    a[rng.random((m, k)) > 0.3] = 0.0
    a += np.eye(m, k, dtype=np.float32)     # every block row has content
    bsr = BsrMatrix.from_dense(a, 4, 4)
    mesh = make_mesh([("x", n)], device_type="cpu")
    x = rng.standard_normal((k, 8)).astype(np.float32)
    c = DistributedBsrSpmm(bsr, 8, mesh)(torch.as_tensor(x))
    err = _err(c, bsr.to_dense() @ x)
    leg(f"dryrun sp={n}: BSR SpMM ring OK, max_err={err:.2e}", err,
        BOUND_SPMM)
    # the weak-scaling leg's comm models, at this matrix
    return {comm: DistributedBsrSpmm(bsr, 8, mesh,
                                     comm=comm).comm_bytes_per_device()
            for comm in ("ring", "ring2", "allgather")}


def _gcn(n, leg):
    import torch

    from ..models import tpp_gcn as TG
    from ..parallel.mesh import make_mesh
    ng = 16 * n
    adj = np.zeros((ng, ng), np.float32)
    for i in range(ng):
        adj[i, (i + 1) % ng] = adj[(i + 1) % ng, i] = 1.0
    bsr = TG.normalize_adjacency(adj, 8)
    cfg = TG.GcnConfig(in_dim=8, hidden=(16,), out_dim=4)
    plan = TG._bsr_plan(bsr, device="cpu")
    mesh = make_mesh([("sp", n)], device_type="cpu")
    step, _, _ = TG.make_sharded_train_step(cfg, mesh, plan, ng // 8)
    h = _normal(4, ng, cfg.in_dim)
    labels = torch.as_tensor(np.random.default_rng(5).integers(0, 4, ng),
                             dtype=torch.int32)
    new, loss = step(TG.init_params(cfg, device="cpu"), h, labels)
    ref_new, ref_loss = TG.train_step(TG.init_params(cfg, device="cpu"),
                                      plan, ng // 8, h, labels, cfg)
    err = max(_err(loss, ref_loss), _tree_err(new, ref_new))
    leg(f"dryrun gcn sp={n}: train step OK, loss={float(loss):.4f}", err)


def _cnn(n, leg):
    import torch

    from ..models import tpp_cnn as TC
    from ..parallel.mesh import make_mesh
    cfg = TC.CnnConfig(height=8, width=8, channels=3, filters=((3, 4),),
                       strides=(2,), classes=3)
    mesh = make_mesh([("dp", n)], device_type="cpu")
    step, _ = TC.make_sharded_train_step(cfg, mesh)
    x = _normal(6, 2 * n, 8, 8, 3)
    labels = torch.as_tensor(np.random.default_rng(7).integers(
        0, 3, 2 * n), dtype=torch.int32)
    new, loss = step(TC.init_params(cfg, device="cpu"), x, labels)
    ref_new, ref_loss = TC.train_step(TC.init_params(cfg, device="cpu"), x,
                                      labels, cfg)
    err = max(_err(loss, ref_loss), _tree_err(new, ref_new))
    leg(f"dryrun cnn dp={n}: train step OK, loss={float(loss):.4f}", err)


def _attention(n, leg):
    from ..models import tpp_attention as TA
    from ..parallel.mesh import make_mesh
    tp = 2 if n % 2 == 0 else 1
    dp = n // tp
    mesh = make_mesh([("dp", dp), ("tp", tp)], device_type="cpu")
    cfg = TA.AttentionConfig(dim=32, heads=4, ffn_mult=2)
    step, _ = TA.make_sharded_train_step(cfg, mesh)
    x, y = _normal(8, 2 * dp, 8, cfg.dim), _normal(9, 2 * dp, 8, cfg.dim)
    new, loss = step(TA.shard_params(TA.init_params(cfg, device="cpu"),
                                     mesh), x, y)
    ref_new, ref_loss = TA.train_step(TA.init_params(cfg, device="cpu"), x,
                                      y, cfg)
    err = max(_err(loss, ref_loss), _tree_err(new, ref_new))
    leg(f"dryrun attention dp={dp} tp={tp}: train step OK, "
        f"loss={float(loss):.4f}", err)


def _context_parallel(n, leg):
    import torch

    from ..ops.attention import _naive
    from ..parallel.mesh import make_mesh
    from ..parallel.ring_attention import (make_ring_attention,
                                           ring_comm_bytes_per_device)
    from ..parallel.ulysses import (make_ulysses_attention,
                                    recommend_cp_flavor,
                                    ulysses_comm_bytes_per_device)
    mesh = make_mesh([("sp", n)], device_type="cpu")
    s, hd, f32 = 128 * n, 16, torch.float32
    for name, bh, make in (("ring-attention", 2, make_ring_attention),
                           ("ulysses", n, make_ulysses_attention)):
        q, kT, v = (_normal(10 + i, *shape) for i, shape in enumerate(
            ((bh, s, hd), (bh, hd, s), (bh, s, hd))))
        fn, _ = make(mesh, "sp", bh, s, hd, f32, causal=True)
        err = _err(fn(q, kT, v), _naive(q, kT, v, hd ** -0.5, True))
        leaves = [t.clone().requires_grad_(True) for t in (q, kT, v)]
        grads = torch.autograd.grad(
            (fn(*leaves).to_local().float() ** 2).sum(), leaves)
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        if name == "ring-attention":
            note = (f"bwd ring OK, comm_bytes/dev="
                    f"{ring_comm_bytes_per_device(bh, s, hd, n, f32)}")
        else:
            note = (f"bwd OK, comm_bytes/dev="
                    f"{ulysses_comm_bytes_per_device(bh, s, hd, n, f32)} "
                    f"(flavor pick: "
                    f"{recommend_cp_flavor(bh, s, hd, n, f32)['pick']})")
        leg(f"dryrun {name} sp={n}: fwd max_err={err:.2e}, {note}",
            err if finite else float("inf"))


def _pipeline(n, leg):
    from ..parallel import pipeline as PP
    from ..parallel.mesh import make_mesh
    pdp = 2 if n % 2 == 0 and n >= 4 else 1
    ppp = n // pdp
    cfg = PP.PipelineConfig(dim=16, n_stages=ppp, n_micro=ppp + 2,
                            micro_batch=4)
    shape = [("pp", ppp), ("dp", pdp)] if pdp > 1 else [("pp", ppp)]
    mesh = make_mesh(shape, device_type="cpu")
    dax = "dp" if pdp > 1 else None
    xs = _normal(12, cfg.n_micro, cfg.micro_batch, cfg.dim)
    ys = _normal(13, *xs.shape)
    params = PP.init_params(cfg, device="cpu")
    ref = PP.reference_forward(params, xs, cfg)
    out = PP.make_pipeline_forward(cfg, mesh, dp_axis=dax)(
        PP.shard_params(params, mesh), xs)
    err = _err(out, ref)
    step, _ = PP.make_pipeline_train_step(cfg, mesh, dp_axis=dax, lr=1e-2)
    _, loss = step(PP.shard_params(params, mesh), xs, ys)
    err = max(err, _err(loss, ((ref.double() - ys.double()) ** 2).mean()))
    leg(f"dryrun pipeline pp={ppp} dp={pdp}: fwd max_err={err:.2e}, "
        f"train step OK, loss={float(loss):.4f}, comm_bytes/dev="
        f"{PP.pipeline_comm_bytes_per_device(cfg, pdp)}", err)


def _moe(n, leg):
    from ..models import tpp_moe as MOE
    from ..parallel.mesh import make_mesh
    edp = 2 if n % 2 == 0 else 1
    eep = n // edp
    mesh = make_mesh([("dp", edp), ("ep", eep)], device_type="cpu")

    def params(cfg):
        return MOE.init_params(cfg, device="cpu")

    cfg = MOE.MoeConfig(dim=16, hidden=32, n_experts=max(eep, 2),
                        capacity_factor=4.0)
    x, y = _normal(14, 16 * edp, cfg.dim), _normal(15, 16 * edp, cfg.dim)
    out, _ = MOE.forward(MOE.shard_params(params(cfg), mesh), x, cfg, mesh)
    err = _err(out, MOE.reference_forward(params(cfg), x.numpy(), cfg))
    step, _ = MOE.make_sharded_train_step(cfg, mesh)
    new, loss = step(MOE.shard_params(params(cfg), mesh), x, y)
    ref_new, ref_loss = MOE.train_step(params(cfg), x, y, cfg)
    err = max(err, _err(loss, ref_loss), _tree_err(new, ref_new))
    leg(f"dryrun moe dp={edp} ep={eep}: fwd max_err={err:.2e}, train step "
        f"OK, loss={float(loss):.4f}", err)

    cfg = MOE.MoeConfig(dim=16, hidden=32, n_experts=max(eep, 2),
                        capacity_factor=8.0)
    x = _normal(16, 16 * edp * eep, cfg.dim)
    y = _normal(17, *x.shape)
    out, _ = MOE.forward_a2a(MOE.shard_params(params(cfg), mesh), x, cfg,
                             mesh, "dp", "ep")
    err = _err(out, MOE.reference_forward(params(cfg), x.numpy(), cfg))
    step, _ = MOE.make_sharded_train_step(cfg, mesh, variant="a2a")
    new, loss = step(MOE.shard_params(params(cfg), mesh), x, y)
    ref_new, ref_loss = MOE.train_step(params(cfg), x, y, cfg)
    err = max(err, _err(loss, ref_loss), _tree_err(new, ref_new))
    rep = MOE.moe_comm_report(cfg, mesh, x.shape[0])
    pick = MOE.pick_moe_variant(cfg, mesh, x.shape[0])
    leg(f"dryrun moe-a2a dp={edp} ep={eep}: fwd max_err={err:.2e}, train "
        f"step OK, loss={float(loss):.4f}, a2a collectives="
        f"{rep['a2a'].get('all_to_all', 0)}, a2a_bytes/dev="
        f"{rep['a2a_bytes_per_device']}, variant pick={pick['pick']}", err)


def _rank() -> List[Tuple[str, float, float]]:
    """Every leg on this rank: (line, error, bound) in order."""
    import torch.distributed as dist
    n = dist.get_world_size()
    legs: List[Tuple[str, float, float]] = []

    def leg(line, err, bound=BOUND):
        legs.append((line, float(err), bound))

    _mlp(n, leg)
    comm = _spmm(n, leg)
    _gcn(n, leg)
    _cnn(n, leg)
    _attention(n, leg)
    _context_parallel(n, leg)
    _pipeline(n, leg)
    _moe(n, leg)
    legs.append((f"weak_scaling: not measured — a world of {n} gloo ranks "
                 "on one host's CPU gives no scaling figure and none is "
                 f"claimed; the SpMM's comm_bytes/dev models: {comm}", 0.0,
                 BOUND))
    return legs


def dryrun_multichip(n_devices: int, timeout: float = 300.0
                     ) -> Dict[str, float]:
    """Every leg on `n_devices` gloo ranks on the CPU; prints one line a
    leg (rank 0's) and raises AssertionError when a rank's leg misses its
    bound. Returns each leg's largest error over the ranks."""
    from .ranks import run_ranks
    ranks = run_ranks(_rank, n_devices, (), device_type="cpu",
                      timeout=timeout)
    worst: Dict[str, float] = {}
    bad = []
    for i, (line, _, bound) in enumerate(ranks[0]):
        err = max(r[i][1] for r in ranks)
        worst[line.split(":")[0]] = err
        print(line)
        if not err <= bound:
            bad.append(f"{line.split(':')[0]}: {err:.3e} > {bound:.0e}")
    if bad:
        raise AssertionError("dry run legs past their bounds: "
                             + "; ".join(bad))
    return worst


if __name__ == "__main__":
    # through the package's module, so that each rank imports _rank by its
    # package name (a __main__ copy cannot resolve its relative imports)
    from libxsmm_torch.scripts import dryrun
    dryrun.dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
