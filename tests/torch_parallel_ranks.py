"""Rank functions of the parallel layer's CPU tests, and the seeded inputs
they share with the JAX side.

Each `world_*` function runs on every rank of a gloo world
(libxsmm_torch.scripts.ranks.run_ranks) and returns that rank's results:
local blocks of the outputs, logged collective bytes, refusal messages. The
test files (tests/test_torch_parallel*.py, tests/test_torch_pipeline.py)
run the JAX package on a mesh of the same size in the pytest process and
hold these results against it. This module imports only numpy, torch and
the port, so a spawned rank never loads JAX.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from libxsmm_torch.ops.sparse import BsrMatrix
from libxsmm_torch.parallel import collectives as C
from libxsmm_torch.parallel import pipeline as PP
from libxsmm_torch.parallel import spmm_dist as SD
from libxsmm_torch.parallel.mesh import P, make_mesh, shard
from libxsmm_torch.parallel.ring_attention import make_ring_attention
from libxsmm_torch.parallel.ulysses import make_ulysses_attention

# ---------------------------------------------------------------- inputs


def block_sparse(seed, m, k, br, bc, density):
    """A block-sparse (m, k) f32 matrix with at least one block per block
    row (tests/test_parallel.py's _block_sparse, seeded)."""
    rng = np.random.default_rng(seed)
    mb, kb = m // br, k // bc
    mask = rng.random((mb, kb)) < density
    for i in range(mb):
        if not mask[i].any():
            mask[i, rng.integers(kb)] = True
    a = rng.standard_normal((m, k)).astype(np.float32)
    a *= np.kron(mask, np.ones((br, bc)))
    return a


def uneven(seed):
    """All blocks in the first block-row band (64 x 128, 4 x 8 blocks)."""
    rng = np.random.default_rng(seed)
    a = np.zeros((64, 128), np.float32)
    a[:4, :] = rng.standard_normal((4, 128))
    return a


def comm_matrix(seed, nd, k=256):
    """test_ring_comm_volume_model's operand at nd ranks."""
    rng = np.random.default_rng(seed)
    m = 32 * nd
    a = rng.standard_normal((m, k)).astype(np.float32)
    a[rng.random((m, k)) > 0.3] = 0.0
    a += np.eye(m, k, dtype=np.float32)
    return a


def dense_x(seed, k, n):
    return np.random.default_rng(seed).standard_normal((k, n)).astype(
        np.float32)


def attention_inputs(seed, bh, s, hd):
    """q (bh, s, hd), kT (bh, hd, s), v (bh, s, hd), dout, f32 numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bh, s, hd)).astype(np.float32),
            rng.standard_normal((bh, hd, s)).astype(np.float32),
            rng.standard_normal((bh, s, hd)).astype(np.float32))


def labels(rank, shape):
    """A labelled local block: rank * 10000 + position."""
    return (rank * 10000 + np.arange(np.prod(shape))).reshape(shape).astype(
        np.float32)


A2A_SHAPE = (4, 8, 12)
A2A_AXES = ((0, 1), (0, 2), (1, 0), (2, 0), (1, 2))

# (case, (m, k, br, bc, density, n, seed)) of the 1-D SpMM cases
SPMM_CASES = {
    "dense2": (64, 64, 8, 8, 0.3, 16, 11),
    "dense4": (128, 128, 8, 8, 0.3, 16, 12),
    "ring2": (64, 64, 4, 4, 0.3, 24, 13),
    "overlap": (64, 64, 4, 4, 0.3, 16, 14),
}
TWO_LEVEL = (128, 128, 8, 8, 0.25, 16, 15)   # dcn 2 x ici 2


def spmm_case(name):
    m, k, br, bc, dens, n, seed = SPMM_CASES[name]
    return (block_sparse(seed, m, k, br, bc, dens), br, bc,
            dense_x(seed + 100, k, n), n)


def _raises(fn, *args, **kw):
    """The message of the ValueError fn raises, or None."""
    try:
        fn(*args, **kw)
    except ValueError as e:
        return str(e)
    return None


def _t(x):
    return torch.as_tensor(x)

# ---------------------------------------------------------------- meshes,
# collectives and the distributed SpMM


def _collectives(mesh, axis):
    """Labelled all_to_all for each axis pair, all_gather, ppermute on the
    ring and on a partial permutation (index 0 receives nothing)."""
    group, r = mesh.group(axis), mesh.index(axis)
    n = mesh.shape[axis]
    x = _t(labels(r, A2A_SHAPE))
    out = {"a2a": {ax: C.all_to_all(x, group, *ax) for ax in A2A_AXES}}
    out["gather0"] = C.all_gather(x, group, axis=0)
    out["gather1"] = C.all_gather(x, group, axis=1)
    out["ring"] = C.ppermute(x, group, C.ring_perm(n))
    out["partial"] = C.ppermute(x, group, [(i, i + 1) for i in range(n - 1)])
    # the differentiable forms: ppermute's backward is the inverse
    # permutation, all_to_all's the reverse all-to-all
    xg = x.clone().requires_grad_(True)
    y = C.ppermute(xg, group, C.ring_perm(n))
    z = C.all_to_all(y, group, 0, 2)
    (z * _t(labels(r, z.shape))).sum().backward()
    out["grad"] = xg.grad
    out["axis_index"] = C.axis_index(group)
    out["sum"] = C.all_reduce(x, group)
    return out


def _spmm(mesh, name, comm="ring"):
    a, br, bc, x, n = spmm_case(name)
    spmm = SD.DistributedBsrSpmm(BsrMatrix.from_dense(a, br, bc), n, mesh,
                                 comm=comm)
    C.reset_log()
    c = spmm(_t(x)).to_local()
    return c, C.logged_bytes(), spmm.comm_bytes_per_device()


def _comm_volume(mesh, nd):
    """ring / allgather at test_ring_comm_volume_model's shape: outputs,
    logged bytes, models and the logged kinds and shapes."""
    a = comm_matrix(0, nd)
    x = dense_x(1, 256, 32)
    out = {}
    for comm in ("ring", "allgather"):
        spmm = SD.DistributedBsrSpmm(BsrMatrix.from_dense(a, 16, 16), 32,
                                     mesh, comm=comm)
        C.reset_log()
        c = spmm(_t(x)).to_local()
        out[comm] = {"c": c, "model": spmm.comm_bytes_per_device(),
                     "logged": C.logged_bytes(),
                     "log": [(e["kind"], e["shape"], e["dtype"])
                             for e in C.log]}
    return out


def world_spmm(p, ref):
    """The 1-D cases at P = p ranks ("x" axis); `ref` holds a reference
    BsrMatrix's fields (shape, br, bc, indptr, indices, data) for
    from_reference, with its RHS `x` and width `n`."""
    mesh = make_mesh([("x", p)], device_type="cpu")
    out = {"rank": dist.get_rank(), "index": mesh.index("x"),
           "collectives": _collectives(mesh, "x"),
           "comm_volume": _comm_volume(mesh, p)}
    out[f"dense{p}"] = _spmm(mesh, f"dense{p}")
    eye = BsrMatrix.from_dense(np.eye(32, dtype=np.float32), 4, 4)
    x = dense_x(2, 32, 8)
    out["identity"] = SD.DistributedBsrSpmm(eye, 8, mesh)(_t(x)).to_local()
    out["bad_comm"] = _raises(SD.DistributedBsrSpmm, eye, 4, mesh,
                              comm="nope")
    # a global tensor cut locally (no collective) and its placement
    g = labels(0, (8, 6, 4))
    C.reset_log()
    d = shard(g, mesh, P(None, None, "x"))
    out["shard"] = (d.to_local(), tuple(d.shape), C.log[:])
    out["too_big"] = _raises(make_mesh, [("x", 2 * p)], device_type="cpu")
    out["from_reference"] = SD.DistributedBsrSpmm.from_reference(
        ref, ref.n, mesh, comm="ring2")(_t(ref.x)).to_local()
    if p == 4:
        out.update(_spmm_world4(mesh))
    return out


def _spmm_world4(mesh):
    out = {}
    a = uneven(3)
    x = dense_x(4, 128, 8)
    out["uneven"] = SD.DistributedBsrSpmm(
        BsrMatrix.from_dense(a, 4, 8), 8, mesh)(_t(x)).to_local()
    for comm in ("ring", "ring2", "allgather"):
        out[f"dense4_{comm}"] = _spmm(mesh, "dense4", comm)
        out[f"r2_{comm}"] = _spmm(mesh, "ring2", comm)
    a, br, bc, x, n = spmm_case("overlap")
    for comm in ("ring", "ring2", "allgather"):
        spmm = SD.DistributedBsrSpmm(BsrMatrix.from_dense(a, br, bc), n,
                                     mesh, comm=comm)
        out[f"overlap_{comm}"] = spmm.overlap_report(_t(x))
    out["indivisible"] = _raises(
        SD.DistributedBsrSpmm,
        BsrMatrix.from_dense(np.eye(12, dtype=np.float32), 4, 4), 8, mesh)
    rng = np.random.default_rng(3)
    ok = BsrMatrix.from_dense(rng.standard_normal((128, 160)).astype(
        np.float32), 4, 4)
    out["allgather_ok"] = _raises(SD.DistributedBsrSpmm, ok, 16, mesh,
                                  comm="allgather")
    bad = BsrMatrix.from_dense(rng.standard_normal((128, 18)).astype(
        np.float32), 4, 2)
    out["allgather_k"] = _raises(SD.DistributedBsrSpmm, bad, 16, mesh,
                                 comm="allgather")
    return out


def world_one():
    """A one-rank world: every collective is local (no backend call), the
    log marks it "self"; the ring SpMM and Ulysses still run."""
    mesh = make_mesh([("x", 1)], device_type="cpu")
    g = mesh.group("x")
    x = _t(labels(0, A2A_SHAPE))
    C.reset_log()
    outs = [C.all_to_all(x, g, 0, 2), C.all_gather(x, g, 1),
            C.all_reduce(x, g), C.ppermute(x, g, C.ring_perm(1))]
    log = C.log[:]
    a, br, bc, xx, n = spmm_case("dense2")
    c = SD.DistributedBsrSpmm(BsrMatrix.from_dense(a, br, bc), n, mesh,
                              comm="ring2")(_t(xx)).to_local()
    return {"outs": outs, "log": log, "spmm": c}


def world_two_level():
    """The ("dcn", "ici") = (2, 2) cases."""
    mesh = make_mesh([("dcn", 2), ("ici", 2)], device_type="cpu")
    m, k, br, bc, dens, n, seed = TWO_LEVEL
    a = block_sparse(seed, m, k, br, bc, dens)
    x = dense_x(seed + 100, k, n)
    bsr = BsrMatrix.from_dense(a, br, bc)
    out = {"coords": (mesh.index("dcn"), mesh.index("ici"))}
    for comm in ("ring2", "ring"):
        spmm = SD.DistributedBsrSpmm2Level(bsr, n, mesh, comm=comm)
        C.reset_log()
        out[comm] = spmm(_t(x)).to_local()
        out[f"{comm}_bytes"] = (C.logged_bytes(),
                                spmm.comm_bytes_per_device(),
                                sorted({e["group_size"] for e in C.log}))
        out[f"{comm}_report"] = spmm.overlap_report(_t(x))
    out["ring_size"] = SD.DistributedBsrSpmm2Level(bsr, n, mesh).ring_size
    out["bad_comm"] = _raises(SD.DistributedBsrSpmm2Level, bsr, n, mesh,
                              comm="nope")
    g = labels(0, (8, 4))
    out["shard"] = shard(g, mesh, P(("dcn", "ici"), None)).to_local()
    out["shard_ici"] = shard(g, mesh, P("ici", None)).to_local()
    out["bad_order"] = _raises(shard, g, mesh, P(("ici", "dcn"), None))
    return out

# ---------------------------------------------------------------- ring and
# Ulysses attention

# (bh, s, hd) of each world's attention cases
ATTN = {2: (4, 256, 32), 4: (4, 512, 32)}


def _attention(mesh, make, causal, dtype, grads):
    bh, s, hd = ATTN[mesh.shape["sp"]]
    q, kT, v = (_t(t).to(dtype) for t in attention_inputs(7, bh, s, hd))
    fn, _ = make(mesh, "sp", bh, s, hd, dtype, causal=causal)
    if grads:
        q, kT, v = (t.requires_grad_(True) for t in (q, kT, v))
    C.reset_log()
    out = fn(q, kT, v).to_local()
    res = {"out": out.detach(), "bytes": C.logged_bytes(),
           "kinds": sorted({e["kind"] for e in C.log}),
           "shapes": sorted({e["shape"] for e in C.log})}
    if grads:
        (out.float() ** 2).sum().backward()
        # each rank's gradient is nonzero only on its own block
        res["grads"] = tuple(t.grad for t in (q, kT, v))
    return res


def world_attention(p):
    """Ring and Ulysses at P = p ranks ("sp" axis): f32 forward (causal
    and not), f32 gradients (causal), bf16 forward, refusals."""
    from libxsmm_torch.kernels import attention as ka
    mesh = make_mesh([("sp", p)], device_type="cpu")
    out = {"index": mesh.index("sp")}
    for name, make in (("ring", make_ring_attention),
                       ("ulysses", make_ulysses_attention)):
        for causal in (False, True):
            out[f"{name}_{causal}"] = _attention(mesh, make, causal,
                                                 torch.float32, False)
        ka.reset_launches()
        out[f"{name}_grads"] = _attention(mesh, make, True, torch.float32,
                                          True)
        out[f"{name}_grads"]["launches"] = dict(ka.launches)
        out[f"{name}_bf16"] = _attention(mesh, make, False, torch.bfloat16,
                                         False)
    bh, s, hd = ATTN[p]
    out["ring_indivisible"] = _raises(make_ring_attention, mesh, "sp", 2,
                                      1001, 32, torch.float32)
    out["ring_envelope"] = _raises(make_ring_attention, mesh, "sp", 2,
                                   250 * p, 32, torch.float32)
    out["uly_indivisible"] = _raises(make_ulysses_attention, mesh, "sp",
                                     8, 1001, 32, torch.float32)
    out["uly_heads"] = _raises(make_ulysses_attention, mesh, "sp", p + 1,
                               s, 32, torch.float32)
    return out

# ---------------------------------------------------------------- pipeline


def pp_inputs(n_micro, mb, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_micro, mb, d)).astype(np.float32),
            rng.standard_normal((n_micro, mb, d)).astype(np.float32))


def world_pipeline(shape, cases):
    """GPipe cases on a mesh of `shape` ((("pp", P),) or (("pp", P), ("dp",
    D))). Each case: (name, kind, cfg kwargs, params (numpy dict, f32
    values of cfg.dtype), seed, lr, steps) with kind "forward" or
    "train"."""
    mesh = make_mesh(list(shape), device_type="cpu")
    dp = "dp" if len(shape) > 1 else None
    out = {"pp": mesh.index("pp"), "dp": mesh.index(dp) if dp else 0}
    for name, kind, kw, params, seed, lr, steps in cases:
        cfg = PP.PipelineConfig(**kw)
        dt = getattr(torch, cfg.dtype)
        pt = {k: _t(v).to(dt) for k, v in params.items()}
        xs, ys = (_t(a).to(dt) for a in pp_inputs(cfg.n_micro,
                                                  cfg.micro_batch, cfg.dim,
                                                  seed))
        if kind == "forward":
            fwd = PP.make_pipeline_forward(cfg, mesh, dp_axis=dp)
            C.reset_log()
            y = fwd(PP.shard_params(pt, mesh), xs)
            out[name] = {"y": y.to_local(), "placements": str(y.placements),
                         "logged": C.logged_bytes(),
                         "model": PP.pipeline_comm_bytes_per_device(
                             cfg, mesh.shape[dp] if dp else 1),
                         "kinds": sorted({e["kind"] for e in C.log})}
        else:
            step, _ = PP.make_pipeline_train_step(cfg, mesh, dp_axis=dp,
                                                  lr=lr)
            p = PP.shard_params(pt, mesh)
            losses, firsts = [], None
            for _ in range(steps):
                p, loss = step(p, xs, ys)
                losses.append(float(loss))
                if firsts is None:
                    firsts = {k: v.to_local() for k, v in p.items()}
            out[name] = {"losses": losses, "params": firsts}
    out["refusals"] = [
        _raises(PP.make_pipeline_forward,
                PP.PipelineConfig(n_stages=mesh.shape["pp"] + 1), mesh),
        _raises(PP.make_pipeline_forward,
                PP.PipelineConfig(n_stages=mesh.shape["pp"], n_micro=1),
                mesh)]
    if dp:
        out["refusals"].append(_raises(
            PP.make_pipeline_forward,
            PP.PipelineConfig(n_stages=mesh.shape["pp"], micro_batch=3),
            mesh, dp_axis=dp))
    return out

# ---------------------------------------------------------------- launcher


def world_modules():
    """The modules a rank has loaded whose top package is JAX's."""
    import sys
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "libxsmm_tpu"))


def world_hang(seconds, pid_dir):
    """A rank that never returns in time; it leaves its process id in
    pid_dir first."""
    import os
    import time
    with open(os.path.join(pid_dir, f"{dist.get_rank()}.pid"), "w") as f:
        f.write(str(os.getpid()))
    time.sleep(seconds)
    return dist.get_rank()


def world_fail():
    """Rank 1 raises; rank 0 waits in a collective it never completes."""
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 gives up")
    dist.barrier()


def world_fail_in_order():
    """Rank 0 raises at once, rank 1 half a second later with a message of
    its own: the launcher sees rank 0's exit first, and must still report
    rank 1's."""
    import time
    if dist.get_rank() == 0:
        raise RuntimeError("rank 0 gives up first")
    time.sleep(0.5)
    raise RuntimeError("rank 1 gives up later")

# ---------------------------------------------------------------- the card


def world_card():
    """On the card, in a world of any size and backend: bf16 ring and
    Ulysses (causal) and their f32 gradients, the ring2 SpMM and a
    pipeline forward, each with the float64 (or plain) reference of this
    rank's block, the launch counts and each logged entry's staging."""
    from libxsmm_torch.kernels import attention as ka
    from libxsmm_torch.ops.attention import _naive
    world = dist.get_world_size()
    mesh = make_mesh([("sp", world)])
    dev = mesh.device
    bh, s, hd = 4, 1024, 64
    seq = slice(mesh.index("sp") * s // world,
                (mesh.index("sp") + 1) * s // world)
    full = [_t(t).to(dev) for t in attention_inputs(11, bh, s, hd)]
    out = {"backend": dist.get_backend()}
    ka.reset_launches()
    for name, make in (("ring", make_ring_attention),
                       ("ulysses", make_ulysses_attention)):
        ops = [t.to(torch.bfloat16) for t in full]
        fn, _ = make(mesh, "sp", bh, s, hd, torch.bfloat16, causal=True)
        C.reset_log()
        o = fn(*ops).to_local()
        ref = _naive(*(t.double() for t in ops), hd ** -0.5, True)
        out[name] = (o.float().cpu(), ref[:, seq].cpu(),
                     [e["staged"] for e in C.log])
        fn, _ = make(mesh, "sp", bh, s, hd, torch.float32, causal=False)
        leaves = [t.clone().requires_grad_(True) for t in full]
        grads = torch.autograd.grad((fn(*leaves).to_local() ** 2).sum(),
                                    leaves)
        # every rank's loss is its own block's; their sum is the full
        # output's, whose gradient this rank holds on its own blocks
        rl = [t.double().requires_grad_(True) for t in full]
        rg = torch.autograd.grad(
            (_naive(*rl, hd ** -0.5, False) ** 2).sum(), rl)
        blocks = ((slice(None), seq), (slice(None), slice(None), seq),
                  (slice(None), seq))
        out[f"{name}_grads"] = [(g[b].cpu(), r[b].cpu()) for g, r, b in
                                zip(grads, rg, blocks)]
    out["launches"] = dict(ka.launches)
    xm = make_mesh([("x", world)])
    a, br, bc, x, n = spmm_case("dense4")
    spmm = SD.DistributedBsrSpmm(BsrMatrix.from_dense(a, br, bc), n, xm,
                                 comm="ring2")
    C.reset_log()
    c = spmm(_t(x).to(dev)).to_local()
    rows = a.shape[0] // world
    i = xm.index("x")
    out["spmm"] = (c.cpu(), (a.astype(np.float64) @ x)[i * rows:
                                                        (i + 1) * rows],
                   C.logged_bytes(), spmm.comm_bytes_per_device())
    out["overlap"] = spmm.overlap_report(_t(x).to(dev))
    pm = make_mesh([("pp", world)])
    cfg = PP.PipelineConfig(dim=64, n_stages=world, n_micro=4,
                            micro_batch=8)
    params = PP.init_params(cfg, seed=3, device=dev)
    xs = _t(pp_inputs(4, 8, 64, 12)[0]).to(dev)
    y = PP.make_pipeline_forward(cfg, pm)(PP.shard_params(params, pm), xs)
    out["pipeline"] = (pm.index("pp") == world - 1, y.to_local().cpu(),
                       PP.reference_forward(params, xs, cfg).cpu())
    return out
