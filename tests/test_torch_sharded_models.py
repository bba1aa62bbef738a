"""The sharded train steps of TPP-MLP, TPP-CNN and TPP-GCN
(libxsmm_torch.models: make_sharded_train_step, shard_params) in one gloo
world of 4 ranks, against the JAX package's sharded steps on a mesh of the
same size (the first 4 of its 8 virtual CPU devices) and against the
port's single-device train steps, from the same seeded parameters and
inputs. The rank functions are tests/torch_sharded_ranks.py's.

Meshes: MLP dp 2 x tp 2 (three layers, the last column-parallel and its
output feature-sharded up to the loss; and two layers), CNN dp 4, GCN sp 4
(the halo gather written as a differentiable all-gather of h @ W).

Tolerances, the reference tests' own (tests/test_models.py): the loss
within 1e-5 absolute; the updated parameters rtol 1e-4, atol 1e-5 (MLP,
GCN) and rtol = atol = 1e-5 (CNN), against the JAX sharded step and the
port's single-device step alike (the sharded sums add f32 partial
products in another order than one product does: rounding only).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

import torch_sharded_ranks as R
from libxsmm_torch.models import tpp_cnn as PC
from libxsmm_torch.models import tpp_gcn as PG
from libxsmm_torch.models import tpp_mlp as PM
from libxsmm_torch.scripts.ranks import run_ranks
from libxsmm_tpu.models import tpp_cnn as RC
from libxsmm_tpu.models import tpp_gcn as RG
from libxsmm_tpu.models import tpp_mlp as RMLP
from libxsmm_tpu.parallel import mesh as RM

torch.set_num_threads(1)

MARGINS = {"mlp": (1e-4, 1e-5), "cnn": (1e-5, 1e-5), "gcn": (1e-4, 1e-5)}


@pytest.fixture(scope="module")
def world():
    return run_ranks(R.world_models, R.WORLD, timeout=300.0)


def _np(tree):
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in tree]


def _close(got, want, model):
    rtol, atol = MARGINS[model]
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(np.asarray(g[k]), np.asarray(w[k]),
                                       rtol=rtol, atol=atol, err_msg=k)


def _jax_mlp(name):
    cfg = RMLP.MlpConfig(in_dim=16, hidden=R.MLP_CFGS[name].hidden,
                         out_dim=8)
    mesh = RM.make_mesh([("dp", 2), ("tp", 2)])
    step, xsh = RMLP.make_sharded_train_step(cfg, mesh, lr=R.LR["mlp"])
    x, y = R.mlp_inputs(name)
    params = RMLP.shard_params(RMLP.init_params(cfg, seed=1), mesh)
    ysh = NamedSharding(mesh, JP("dp", None))
    new, loss = step(params, jax.device_put(x, xsh), jax.device_put(y, ysh))
    return _np(new), float(loss)


@pytest.mark.parametrize("name", list(R.MLP_CFGS))
def test_mlp_sharded_step(world, name):
    """tests/test_models.py:76's step on dp 2 x tp 2, held against the JAX
    package's sharded step and the port's single-device step."""
    want, want_loss = _jax_mlp(name)
    cfg = R.MLP_CFGS[name]
    x, y = R.mlp_inputs(name)
    single, single_loss = PM.train_step(
        PM.init_params(cfg, seed=1, device="cpu"), torch.as_tensor(x),
        torch.as_tensor(y), cfg, lr=R.LR["mlp"])
    for r in world:
        got = r[f"mlp_{name}"]
        assert abs(float(got["loss"]) - want_loss) < 1e-5
        assert abs(float(got["loss"]) - float(single_loss)) < 1e-5
        _close(got["params"], want, "mlp")
        _close(got["params"], single, "mlp")
        assert {k for k, *_ in got["log"]} == {"all_reduce"}
        assert tuple(got["spec"]) == ("dp", None)


def test_mlp_shard_params_places_megatron_specs():
    """Column-parallel layers split their output features over tp, row
    layers their input features."""
    specs = PM._specs(3)
    assert [tuple(s["w"]) for s in specs] == [(None, "tp"), ("tp", None),
                                              (None, "tp")]
    assert [tuple(s["b"]) for s in specs] == [("tp",), (None,), ("tp",)]


def test_cnn_sharded_step(world):
    """tests/test_models.py:250's step on dp 4, against the JAX sharded
    step and the port's single-device step."""
    cfg = RC.CnnConfig(height=8, width=8, channels=3, filters=((3, 4),),
                       strides=(2,), classes=3)
    x, labels = R.cnn_inputs()
    mesh = RM.make_mesh([("dp", 4)])
    step, xsh = RC.make_sharded_train_step(cfg, mesh)
    want, want_loss = step(RC.init_params(cfg, seed=1),
                           jax.device_put(x, xsh),
                           jax.device_put(labels, NamedSharding(mesh,
                                                                JP("dp"))))
    single, single_loss = PC.train_step(
        PC.init_params(R.CNN_CFG, seed=1, device="cpu"), torch.as_tensor(x),
        torch.as_tensor(labels), R.CNN_CFG)
    for r in world:
        got = r["cnn"]
        assert abs(float(got["loss"]) - float(want_loss)) < 1e-5
        assert abs(float(got["loss"]) - float(single_loss)) < 1e-5
        _close(got["params"], _np(want), "cnn")
        _close(got["params"], single, "cnn")
        # one summed gradient buffer and the loss: all-reduces over dp
        assert [k for k, *_ in got["log"]] == ["all_reduce", "all_reduce"]


def test_gcn_sharded_step(world):
    """tests/test_models.py:147's step on sp 4 (H and labels node-sharded,
    weights replicated), against the JAX sharded step and the port's
    single-device step; each layer logs one all-gather of h @ W forward
    and, for every layer whose h @ W needs a gradient, one reduce-scatter
    backward."""
    cfg = RG.GcnConfig(in_dim=8, hidden=(16,), out_dim=3)
    n, block = R.GCN_NODES, R.GCN_BLOCK
    plan = RG._bsr_plan(RG.normalize_adjacency(R.ring_graph(n), block))
    h, labels = R.gcn_inputs()
    mesh = RM.make_mesh([("sp", 4)])
    step, hsh, lsh = RG.make_sharded_train_step(cfg, mesh, plan, n // block)
    want, want_loss = step(RG.init_params(cfg, seed=5),
                           jax.device_put(h, hsh),
                           jax.device_put(labels, lsh))
    pplan = PG._bsr_plan(PG.normalize_adjacency(R.ring_graph(n), block),
                         device="cpu")
    single, single_loss = PG.train_step(
        PG.init_params(R.GCN_CFG, seed=5, device="cpu"), pplan, n // block,
        torch.as_tensor(h), torch.as_tensor(labels), R.GCN_CFG)
    for r in world:
        got = r["gcn"]
        assert abs(float(got["loss"]) - float(want_loss)) < 1e-5
        assert abs(float(got["loss"]) - float(single_loss)) < 1e-5
        _close(got["params"], _np(want), "gcn")
        _close(got["params"], single, "gcn")
        kinds = [k for k, *_ in got["log"]]
        assert kinds.count("all_gather") == 2
        assert kinds.count("reduce_scatter") == 2
        # the all-gathers bring in 3 of the 4 (16, width) blocks of h @ W
        gathers = [(b, s) for k, b, s in got["log"] if k == "all_gather"]
        assert gathers == [(3 * 16 * 16 * 4, (16, 16)),
                           (3 * 16 * 3 * 4, (16, 3))]


def test_differentiable_collectives(world):
    """Forwards as jax.lax's (psum_scatter and all_gather tiled, psum) on
    labelled blocks, and the backward of each: reduce_scatter's an
    all-gather, all_gather's a reduce-scatter (or, replicated, this rank's
    own block), all_reduce's the identity, copy_to's a sum, psum's a sum.
    Exact: small integers in f32."""
    xs = [R.labelled(r, (8, 3)) for r in range(4)]
    gs = {n: [R.labelled(r, shape) + 500 for r in range(4)]
          for n, shape in (("rs", (2, 3)), ("ag", (8, 12)),
                           ("ar", (8, 3)))}
    total = sum(xs)
    for r, res in enumerate(w["collectives"] for w in world):
        y, g = res["reduce_scatter"]
        np.testing.assert_array_equal(y.numpy(), total[2 * r:2 * r + 2])
        np.testing.assert_array_equal(
            g.numpy(), np.concatenate(gs["rs"], axis=0))
        y, g = res["all_gather"]
        np.testing.assert_array_equal(y.numpy(), np.concatenate(xs, 1))
        np.testing.assert_array_equal(
            g.numpy(), sum(gs["ag"])[:, 3 * r:3 * r + 3])
        y, g = res["all_gather_replicated"]
        np.testing.assert_array_equal(g.numpy(), gs["ag"][r][:, 3 * r:
                                                             3 * r + 3])
        y, g = res["all_reduce"]
        np.testing.assert_array_equal(y.numpy(), total)
        np.testing.assert_array_equal(g.numpy(), gs["ar"][r])
        y, g = res["copy_to"]
        np.testing.assert_array_equal(y.numpy(), xs[r])
        np.testing.assert_array_equal(g.numpy(), sum(gs["ar"]))
        y, g = res["psum"]
        np.testing.assert_array_equal(y.numpy(), total)
        np.testing.assert_array_equal(g.numpy(), sum(gs["ar"]))
        # logged, forward then backward, each in collectives.py's count:
        # a reduce-scatter 3/4 of its (8, 3) f32 operand, an all-gather 3
        # blocks, an all-reduce 2 * 3/4 of its operand; the replicated
        # all-gather's and all_reduce's backwards issue nothing
        assert [(k, b) for k, b, _ in res["log"]] == [
            ("reduce_scatter", 72), ("all_gather", 72),
            ("all_gather", 288), ("reduce_scatter", 288),
            ("all_gather", 288), ("all_reduce", 144),
            ("all_reduce", 144), ("all_reduce", 144), ("all_reduce", 144)]


def test_refusals(world):
    """A mesh axis that does not divide the FFN width, the batch or the
    block rows raises."""
    for r in world:
        assert "layer 0 output features=33" in r["mlp_bad_tp"]
        assert r["cnn_bad_batch"] == "batch=6 does not divide over 4 ranks"
        assert "block rows" in r["gcn_bad_nodes"]
