"""The sharded TPP-MoE (libxsmm_torch.models.tpp_moe: shard_params, forward
and train_step with a mesh, forward_a2a, loss_fn_a2a,
make_sharded_train_step in its einsum, a2a and auto variants,
moe_a2a_comm_bytes_per_device, hlo_collectives, moe_comm_report,
pick_moe_variant) in one gloo world of 4 ranks, against the JAX package
on a mesh of the same size (the first 4 of its 8 virtual CPU devices), its
per-token oracle and the port's unsharded step, from the same seeded
parameters and inputs. The rank functions are
tests/torch_sharded_ranks.py's. The cases mirror
tests/test_pipeline_moe.py:227-353 on meshes of 4 (dp 2 x ep 2, ep 4)
where the reference uses 8, plus capacity drops (top-1 and top-2), where
the einsum variant's routing must still be the unsharded routing.

Tolerances, the reference tests' own: losses within 1e-5, parameters
within 1e-5 (max abs), forwards against the per-token oracle within 1e-4,
the aux against the per-shard emulation within 1e-5. Logged bytes and
collective counts: exact.

Divergence, recorded in ROADMAP.md: the reference's
make_sharded_train_step(dp_axis="dp") raises on an ep-only mesh; the
port's takes the missing dp axis as one rank, so its ep 4 step is held
against the JAX package's unsharded step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharded_ranks as R
from libxsmm_torch.models import tpp_moe as PM
from libxsmm_torch.scripts.ranks import run_ranks
from libxsmm_tpu.models import tpp_moe as RMO
from libxsmm_tpu.parallel import mesh as RM

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    return run_ranks(R.world_moe, R.WORLD, timeout=300.0)


def _rcfg(name):
    cfg = R.MOE_CFGS[name]
    return RMO.MoeConfig(dim=cfg.dim, hidden=cfg.hidden,
                         n_experts=cfg.n_experts, top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor,
                         aux_loss_weight=cfg.aux_loss_weight)


def _params(name):
    return RMO.init_params(_rcfg(name), seed=R.MOE_SEEDS[name])


def _max_err(got, want):
    return max(float(np.abs(got[k].numpy() - np.asarray(want[k])).max())
               for k in want)


@pytest.mark.parametrize("name", ["step", "drops", "drops2"])
def test_einsum_step_matches_jax_and_unsharded(world, name):
    """tests/test_pipeline_moe.py:227 on dp 2 x ep 2: the port's sharded
    einsum step against the JAX package's sharded step and the port's
    unsharded step; with capacity drops too (a quarter of what the
    draw wants: the global capacity and the global slot order decide
    which tokens drop)."""
    cfg = _rcfg(name)
    x, y = R.moe_inputs(name)
    mesh = RM.make_mesh([("dp", 2), ("ep", 2)])
    step, xsh = RMO.make_sharded_train_step(cfg, mesh, lr=R.LR["moe"])
    want, want_loss = step(RMO.shard_params(_params(name), mesh),
                           jax.device_put(x, xsh), jax.device_put(y, xsh))
    pcfg = R.MOE_CFGS[name]
    single, single_loss = PM.train_step(
        PM.init_params(pcfg, seed=R.MOE_SEEDS[name], device="cpu"),
        torch.as_tensor(x), torch.as_tensor(y), pcfg, lr=R.LR["moe"])
    if name.startswith("drops"):
        logits = torch.as_tensor(x) @ PM.init_params(
            pcfg, seed=R.MOE_SEEDS[name], device="cpu")["wg"]
        dispatch, _, _ = PM._route(logits, pcfg.n_experts,
                                   PM.capacity(pcfg, len(x)), pcfg.top_k)
        assert int(dispatch.sum()) < len(x) * pcfg.top_k     # drops
    for r in world:
        got = r[f"einsum_{name}"]
        assert abs(float(got["loss"]) - float(want_loss)) < 1e-5
        assert abs(float(got["loss"]) - float(single_loss)) < 1e-5
        assert _max_err(got["params"], want) < 1e-5
        assert _max_err(got["params"], single) < 1e-5
        assert tuple(got["spec"]) == ("dp", None)
        kinds = [k for k, *_ in got["log"]]
        assert "all_to_all" not in kinds and kinds.count("all_gather") == 2


def test_einsum_on_ep4_matches_unsharded(world):
    """ep 4 alone: no token split; the expert outputs all-gathered over
    ep. The JAX package's step refuses this mesh (dp_axis="dp"), so the
    port's is held against the JAX package's unsharded step."""
    cfg = _rcfg("step")
    x, y = R.moe_inputs("step")
    want, want_loss = RMO.train_step(_params("step"), jnp.asarray(x),
                                     jnp.asarray(y), cfg, lr=R.LR["moe"])
    for r in world:
        got = r["einsum_ep4"]
        assert abs(float(got["loss"]) - float(want_loss)) < 1e-5
        assert _max_err(got["params"], want) < 1e-5


def test_einsum_forward_and_expert_placement(world):
    """forward with a mesh equals the unsharded forward; the expert
    tensors are split over ep on the expert dimension, the router
    replicated (where the reference checks its lowered text for the ep
    sharding)."""
    cfg = R.MOE_CFGS["step"]
    x, _ = R.moe_inputs("step")
    y1, aux1 = PM.forward(PM.init_params(cfg, seed=R.MOE_SEEDS["step"],
                                         device="cpu"),
                          torch.as_tensor(x), cfg)
    for r in world:
        y, aux = r["einsum_forward"]
        assert float((y - y1).abs().max()) < 1e-6
        assert abs(float(aux) - float(aux1)) < 1e-6
        pl = r["placement"]
        assert pl["wg"] == ((16, 4), (16, 4), "(Replicate(), Replicate())")
        for k, shape in (("w1", (4, 16, 32)), ("b1", (4, 32)),
                         ("w2", (4, 32, 16)), ("b2", (4, 16))):
            assert pl[k] == (shape, (2,) + shape[1:],
                             "(Replicate(), Shard(dim=0))")


@pytest.mark.parametrize("name", ["oracle2", "aux"])
def test_a2a_matches_per_token_oracle(world, name):
    """tests/test_pipeline_moe.py:262: the a2a forward on ep 4 equals the
    per-token oracle when capacity covers the draw, with two all-to-alls
    logged."""
    x, _ = R.moe_inputs(name)
    want = RMO.reference_forward(_params(name), x, _rcfg(name))
    for r in world:
        y, aux, log = r[f"a2a_{name}"]
        assert float(np.abs(y.numpy() - want).max()) < 1e-4
        assert float(aux) > 0.0
        assert [k for k, *_ in log].count("all_to_all") == 2


def test_a2a_aux_is_per_shard_mean(world):
    """tests/test_pipeline_moe.py:315: the aux is the mean of the
    per-shard Switch losses, against a numpy emulation over the same
    token partition through the JAX package's _route."""
    cfg = _rcfg("aux")
    params = _params("aux")
    x, _ = R.moe_inputs("aux")
    parts = []
    for sh in np.split(x, 4):
        logits = jnp.dot(jnp.asarray(sh), params["wg"])
        _, _, a = RMO._route(logits, cfg.n_experts,
                             RMO.capacity(cfg, sh.shape[0]), cfg.top_k)
        parts.append(float(a))
    for r in world:
        assert abs(float(r["a2a_aux"][1]) - np.mean(parts)) < 1e-5


def test_a2a_dp_composition_and_grads(world):
    """tests/test_pipeline_moe.py:280 on dp 2 x ep 2: the a2a forward
    equals the oracle, and its train step (aux weight 0) equals both the
    JAX package's a2a step and a single-device step of the same loss."""
    cfg = _rcfg("a2a_dp")
    params = _params("a2a_dp")
    x, y = R.moe_inputs("a2a_dp")
    mesh = RM.make_mesh([("dp", 2), ("ep", 2)])
    step, xsh = RMO.make_sharded_train_step(cfg, mesh, variant="a2a",
                                            lr=R.LR["a2a"])
    want, want_loss = step(RMO.shard_params(params, mesh),
                           jax.device_put(jnp.asarray(x), xsh),
                           jax.device_put(jnp.asarray(y), xsh))

    def ref_loss(p):
        pred, _ = RMO.forward(p, jnp.asarray(x), cfg)
        return jnp.mean((pred - jnp.asarray(y)) ** 2)
    loss_u, grads_u = jax.value_and_grad(ref_loss)(params)
    oracle = RMO.reference_forward(params, x, cfg)
    for r in world:
        got = r["a2a_step"]
        assert tuple(got["spec"]) == (("dp", "ep"), None)
        assert abs(float(got["loss"]) - float(want_loss)) < 1e-5
        assert abs(float(got["loss"]) - float(loss_u)) < 1e-5
        assert _max_err(got["params"], want) < 1e-5
        assert _max_err(got["params"], {k: params[k] - R.LR["a2a"]
                                        * grads_u[k] for k in params}) < 1e-5
        y_a2a, _, _ = r["a2a_dp_forward"]
        assert float(np.abs(y_a2a.numpy() - oracle).max()) < 1e-4


def test_a2a_comm_evidence(world):
    """tests/test_pipeline_moe.py:334: the a2a step logs at least 2
    all-to-alls, the einsum step none; the a2a forward's logged
    all-to-all bytes equal moe_a2a_comm_bytes_per_device, which equals
    the JAX package's."""
    cfg = R.MOE_CFGS["a2a_dp"]
    model = PM.moe_a2a_comm_bytes_per_device(cfg, 8, 2)
    assert model == RMO.moe_a2a_comm_bytes_per_device(_rcfg("a2a_dp"), 8, 2)
    for r in world:
        rep = r["report"]
        assert rep["a2a"]["all_to_all"] >= 2, rep
        assert rep["einsum"]["all_to_all"] == 0
        assert set(rep["einsum"]) == set(RMO.hlo_collectives(""))
        assert rep["a2a_bytes_per_device"] == \
            RMO.moe_a2a_comm_bytes_per_device(_rcfg("comm"), 8, 2) > 0
        log = r["a2a_dp_forward"][2]
        assert sum(b for k, b, _ in log if k == "all_to_all") == model


@pytest.mark.parametrize("name", ["step", "oracle2", "comm", "aux"])
@pytest.mark.parametrize("s_local,ndev", [(8, 2), (8, 4), (16, 4)])
def test_a2a_bytes_model_matches_reference(name, s_local, ndev):
    for dt, jdt in ((None, None), (torch.bfloat16, jnp.bfloat16)):
        assert PM.moe_a2a_comm_bytes_per_device(
            R.MOE_CFGS[name], s_local, ndev, dt) == \
            RMO.moe_a2a_comm_bytes_per_device(_rcfg(name), s_local, ndev,
                                              jdt)


def test_hlo_collectives_is_the_reference(world):
    txt = ('%0 = "stablehlo.all_to_all"(%a) stablehlo.all_reduce(%b) '
           'stablehlo.all-gather  "stablehlo.collective_permute"')
    assert PM.hlo_collectives(txt) == RMO.hlo_collectives(txt)


def test_pick_and_auto(world):
    """The create-time pick: both variants timed on the mesh, the same
    pick on every rank, cached; "auto" builds the winner's step."""
    picks = {r["pick"]["pick"] for r in world}
    assert len(picks) == 1 and picks <= {"einsum", "a2a"}
    for r in world:
        assert r["pick"]["einsum_s"] > 0 and r["pick"]["a2a_s"] > 0
        assert r["pick_cached"] == r["pick"]
        want = (("dp", "ep"), None) if r["pick"]["pick"] == "a2a" \
            else ("dp", None)
        assert tuple(r["auto_spec"]) == want
        assert r["pick_ep4"]["pick"] in ("einsum", "a2a")


def test_refusals(world):
    for r in world:
        assert r["bad_variant"] == ("variant must be einsum, a2a or auto, "
                                    "not 'nope'")
        assert r["bad_experts"] == "n_experts=6 does not divide over 4 ranks"
