"""The port's GPipe pipeline (libxsmm_torch.parallel.pipeline) in gloo
worlds of 2 and 4 stages and of pp 2 x dp 2, against the JAX package's
(libxsmm_tpu.parallel.pipeline) on a mesh of the same size, with the
reference's seeded parameters and the same numpy inputs. The cases mirror
the pipeline half of tests/test_pipeline_moe.py.

Tolerances: f32 forward outputs and one train step's parameters (lr = 1,
so the step's change is the gradient) within 1e-5 absolute, the reference
tests' own; the loss at lr = 0 within 1e-6; bf16 outputs 1e-2 (matdiff,
the activations rounded to bf16 at every stage).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from libxsmm_torch.matdiff import check
from libxsmm_torch.parallel import pipeline as PP
from libxsmm_torch.scripts.ranks import run_ranks
from libxsmm_tpu.parallel import mesh as RM
from libxsmm_tpu.parallel import pipeline as RP

torch.set_num_threads(1)

D, MB = 16, 4
# name -> (kind, cfg kwargs, data seed, lr, steps)
CASES = {
    2: {"fwd": ("forward", dict(n_micro=4), 1, 0.0, 0),
        "fwd_bf16": ("forward", dict(n_micro=4, dtype="bfloat16"), 2, 0.0,
                     0),
        "learn": ("train", dict(n_micro=4), 3, 1e-2, 5)},
    4: {"fwd": ("forward", dict(n_micro=6), 4, 0.0, 0),
        "step": ("train", dict(n_micro=5), 5, 1.0, 1)},
    (2, 2): {"fwd": ("forward", dict(n_micro=6), 6, 0.0, 0),
             "loss": ("train", dict(n_micro=6), 7, 0.0, 1),
             "step": ("train", dict(n_micro=6), 8, 1.0, 1)},
}


def _cfgs(stages, kw):
    kw = dict(dim=D, n_stages=stages, micro_batch=MB, **kw)
    return RP.PipelineConfig(**kw), PP.PipelineConfig(**kw)


def _shape(key):
    return ([("pp", key)] if isinstance(key, int)
            else [("pp", key[0]), ("dp", key[1])])


def _params(cfg_r):
    """The reference's seeded parameters, as f32 numpy (exact values of
    cfg.dtype)."""
    return {k: np.asarray(v, np.float32)
            for k, v in RP.init_params(cfg_r, seed=1).items()}


_WORLDS = {}
KEYS = [2, 4, (2, 2)]
IDS = ["pp2", "pp4", "pp2xdp2"]


def _world(key):
    """(stages, the ranks' results) of one mesh's world, run once for the
    module."""
    if key not in _WORLDS:
        stages = key if isinstance(key, int) else key[0]
        cases = []
        for name, (kind, kw, seed, lr, steps) in CASES[key].items():
            cfg_r, _ = _cfgs(stages, kw)
            cases.append((name, kind, dict(dim=D, n_stages=stages,
                                           micro_batch=MB, **kw),
                          _params(cfg_r), seed, lr, steps))
        size = stages * (1 if isinstance(key, int) else key[1])
        _WORLDS[key] = (stages, run_ranks(R.world_pipeline, size,
                                          (_shape(key), cases),
                                          timeout=240.0))
    return _WORLDS[key]


def _jax(key, name):
    """(cfg, mesh, dp axis, params, xs, ys) of a case on the JAX side."""
    stages = key if isinstance(key, int) else key[0]
    kind, kw, seed, lr, steps = CASES[key][name]
    cfg_r, _ = _cfgs(stages, kw)
    mesh = RM.make_mesh(_shape(key))
    dp = None if isinstance(key, int) else "dp"
    params = RP.init_params(cfg_r, seed=1)
    xs, ys = (jnp.asarray(a, cfg_r.dtype) for a in R.pp_inputs(
        cfg_r.n_micro, MB, D, seed))
    return cfg_r, mesh, dp, params, xs, ys


def _last(ranks, stages, name, field="y"):
    """The last stage's outputs, dp slices joined along the rows; every
    other stage holds zeros (the Partial placement)."""
    last = sorted((r for r in ranks if r["pp"] == stages - 1),
                  key=lambda r: r["dp"])
    for r in ranks:
        if r["pp"] != stages - 1:
            assert not r[name][field].any()
    return np.concatenate([r[name][field].float().numpy() for r in last],
                          axis=1)


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_forward_matches_jax_and_sequential(key):
    stages, ranks = _world(key)
    cfg, mesh, dp, params, xs, _ = _jax(key, "fwd")
    got = _last(ranks, stages, "fwd")
    fwd = jax.jit(RP.make_pipeline_forward(cfg, mesh, dp_axis=dp))
    want = np.asarray(fwd(RP.shard_params(params, mesh), xs))
    assert float(np.abs(got - want).max()) < 1e-5
    ref = np.asarray(RP.reference_forward(params, xs, cfg))
    assert float(np.abs(got - ref).max()) < 1e-5
    placement = ("(Partial(sum),)" if dp is None
                 else "(Partial(sum), Shard(dim=1))")
    for r in ranks:
        assert r["fwd"]["placements"] == placement


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_forward_logged_rotations_equal_the_model(key):
    """T = M + P - 1 rotations of one (mb/dp, d) activation: the log holds
    the model's bytes, in permutes only (outputs are not broadcast), and
    the JAX package's lowered program permutes too."""
    stages, ranks = _world(key)
    cfg, mesh, dp, *_ = _jax(key, "fwd")
    ndp = 1 if dp is None else mesh.shape[dp]
    model = RP.pipeline_comm_bytes_per_device(cfg, ndp)
    _, cfg_p = _cfgs(stages, CASES[key]["fwd"][1])
    assert PP.pipeline_comm_bytes_per_device(cfg_p, ndp) == model
    assert model == (cfg.n_micro + stages - 1) * (MB // ndp) * D * 4
    if dp is None:
        txt = RP.lowered_text(cfg, mesh)
        assert "collective_permute" in txt.replace("-", "_")
    for r in ranks:
        assert r["fwd"]["logged"] == r["fwd"]["model"] == model
        assert r["fwd"]["kinds"] == ["collective_permute"]


@pytest.mark.parametrize("key", [2], ids=["pp2"])
def test_bf16_forward_matches_jax(key):
    stages, ranks = _world(key)
    cfg, mesh, dp, params, xs, _ = _jax(key, "fwd_bf16")
    want = RP.make_pipeline_forward(cfg, mesh)(
        RP.shard_params(params, mesh), xs)
    check(np.asarray(want, np.float32), _last(ranks, stages, "fwd_bf16"),
          margin=1e-2)


def _jax_step(key, name):
    cfg, mesh, dp, params, xs, ys = _jax(key, name)
    lr = CASES[key][name][3]
    step, xsh = RP.make_pipeline_train_step(cfg, mesh, dp_axis=dp, lr=lr)
    new, loss = step(RP.shard_params(params, mesh), jax.device_put(xs, xsh),
                     jax.device_put(ys, xsh))
    return cfg, params, xs, ys, new, float(loss)


@pytest.mark.parametrize("key", [4, (2, 2)], ids=["pp4", "pp2xdp2"])
def test_train_step_matches_jax(key):
    """One step at lr = 1 (the parameters' change is the gradient through
    the schedule, summed over dp under pp x dp) against the JAX package's
    step and against jax.grad of the sequential oracle."""
    stages, ranks = _world(key)
    cfg, params, xs, ys, new, loss = _jax_step(key, "step")

    def loss_seq(p):
        return jnp.mean((RP.reference_forward(p, xs, cfg) - ys) ** 2)

    g_seq = jax.grad(loss_seq)(params)
    for r in ranks:
        assert abs(r["step"]["losses"][0] - loss) < 1e-6
        st = r["pp"]
        for k in ("w", "b"):
            got = r["step"]["params"][k][0].numpy()
            np.testing.assert_allclose(got, np.asarray(new[k][st]),
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(
                np.asarray(params[k][st]) - got, np.asarray(g_seq[k][st]),
                rtol=0, atol=1e-5)


@pytest.mark.parametrize("key", [2], ids=["pp2"])
def test_train_step_learns(key):
    stages, ranks = _world(key)
    cfg, params, xs, ys, new, loss = _jax_step(key, "learn")
    losses = ranks[0]["learn"]["losses"]
    assert abs(losses[0] - loss) < 1e-6
    assert losses[-1] < losses[0]
    for r in ranks:
        assert r["learn"]["losses"] == losses


@pytest.mark.parametrize("key", [(2, 2)], ids=["pp2xdp2"])
def test_dp_loss_matches_sequential(key):
    stages, ranks = _world(key)
    cfg, params, xs, ys, _, loss = _jax_step(key, "loss")
    want = float(jnp.mean((RP.reference_forward(params, xs, cfg) - ys) ** 2))
    for r in ranks:
        assert abs(r["loss"]["losses"][0] - want) < 1e-6
        assert abs(r["loss"]["losses"][0] - loss) < 1e-6


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_validates_geometry(key):
    stages, ranks = _world(key)
    for r in ranks:
        bad_stages, bubble = r["refusals"][:2]
        assert "must equal the pp mesh extent" in bad_stages
        assert "all bubble" in bubble
        if not isinstance(key, int):
            assert "must divide over dp=2" in r["refusals"][2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_match_reference_bit_for_bit(dtype):
    cfg_r, cfg_p = _cfgs(4, dict(n_micro=6, dtype=dtype))
    ref = RP.init_params(cfg_r, seed=3)
    mine = PP.init_params(cfg_p, seed=3, device="cpu")
    carried = PP.params_from_numpy({k: np.asarray(v) for k, v in
                                    ref.items()}, device="cpu")
    for k in ("w", "b"):
        want = np.asarray(ref[k], np.float32)
        np.testing.assert_array_equal(mine[k].float().numpy(), want)
        np.testing.assert_array_equal(carried[k].float().numpy(), want)
        assert mine[k].dtype == carried[k].dtype == getattr(torch, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_forward_matches_jax(dtype):
    """The sequential oracle itself, port against JAX package."""
    cfg_r, cfg_p = _cfgs(3, dict(n_micro=5, dtype=dtype))
    params = RP.init_params(cfg_r, seed=2)
    xs, _ = R.pp_inputs(5, MB, D, 9)
    want = np.asarray(RP.reference_forward(
        params, jnp.asarray(xs, cfg_r.dtype), cfg_r), np.float32)
    got = PP.reference_forward(
        PP.params_from_numpy({k: np.asarray(v) for k, v in params.items()},
                             device="cpu"),
        torch.as_tensor(xs).to(getattr(torch, dtype)), cfg_p)
    if dtype == "float32":
        assert float(np.abs(got.numpy() - want).max()) < 1e-5
    else:
        check(want, got.float().numpy(), margin=1e-2)
