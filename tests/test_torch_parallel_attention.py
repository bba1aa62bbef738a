"""Ring and Ulysses attention of the port (libxsmm_torch.parallel:
ring_attention, ulysses) in gloo worlds of 2 and 4 ranks, against the JAX
package's (libxsmm_tpu.parallel) on a mesh of the same size and against
the single-device composition, with the same seeded numpy inputs. The
cases mirror tests/test_parallel.py's.

On the CPU the port's flash kernels run their plain torch versions; the
same ring (rotations, LSE combine, the backward's second ring pass with the
global LSE and delta) runs around them as on the card. Tolerances, the
reference tests' own: f32 outputs rtol = atol = 2e-5, f32 gradients
rtol = atol = 1e-4; bf16 outputs 1e-2 (matdiff, one bf16 rounding of the
probabilities and of the output).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from libxsmm_torch.matdiff import check
from libxsmm_torch.parallel import ring_attention as PR
from libxsmm_torch.parallel import ulysses as PU
from libxsmm_torch.scripts.ranks import run_ranks
from libxsmm_tpu.ops.attention import _naive
from libxsmm_tpu.parallel import mesh as RM
from libxsmm_tpu.parallel import ring_attention as RR
from libxsmm_tpu.parallel import ulysses as RU

torch.set_num_threads(1)

MAKE = {"ring": RR.make_ring_attention, "ulysses": RU.make_ulysses_attention}


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def world(request):
    p = request.param
    return p, run_ranks(R.world_attention, p, (p,), timeout=240.0)


def _inputs(p, dtype=jnp.float32):
    bh, s, hd = R.ATTN[p]
    return (bh, s, hd), tuple(jnp.asarray(t, dtype)
                              for t in R.attention_inputs(7, bh, s, hd))


def _jax_out(name, p, causal, dtype=jnp.float32):
    (bh, s, hd), (q, kT, v) = _inputs(p, dtype)
    mesh = RM.make_mesh([("sp", p)])
    fn, sh = MAKE[name](mesh, "sp", bh, s, hd, dtype, causal=causal)
    return fn, sh, (q, kT, v)


def _seq(ranks, key, field="out"):
    """The global output: the ranks' sequence blocks in rank order."""
    return np.concatenate([r[key][field].float().numpy() for r in ranks],
                          axis=1)


@pytest.mark.parametrize("name", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_matches_jax_and_single_device(world, name, causal):
    p, ranks = world
    fn, sh, (q, kT, v) = _jax_out(name, p, causal)
    got = _seq(ranks, f"{name}_{causal}")
    want = np.asarray(fn(*(jax.device_put(t, sh[k]) for t, k in
                           ((q, "q"), (kT, "kT"), (v, "v")))))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    ref = np.asarray(_naive(q, kT, v, q.shape[-1] ** -0.5, causal))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", ["ring", "ulysses"])
def test_gradients_match_jax_and_single_device(world, name):
    """The ring's second ring pass (the flash backward fed the global LSE
    and delta, dK/dV accumulators riding home) and Ulysses' reverse
    all-to-alls around the flash backward, against jax.grad through the
    JAX package's and through the naive composition (causal)."""
    p, ranks = world
    fn, sh, (q, kT, v) = _jax_out(name, p, True)
    hd = q.shape[-1]
    gj = jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) ** 2),
                  argnums=(0, 1, 2))(q, kT, v)
    gn = jax.grad(lambda a, b, c: jnp.sum(_naive(a, b, c, hd ** -0.5,
                                                 True) ** 2),
                  argnums=(0, 1, 2))(q, kT, v)
    for i in range(3):
        # each rank's gradient holds its own block, zeros elsewhere
        got = sum(r[f"{name}_grads"]["grads"][i].numpy() for r in ranks)
        np.testing.assert_allclose(got, np.asarray(gj[i]), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got, np.asarray(gn[i]), rtol=1e-4,
                                   atol=1e-4)
    for r in ranks:
        # the CPU runs the plain versions: no kernel launches
        assert set(r[f"{name}_grads"]["launches"].values()) == {0}


@pytest.mark.parametrize("name", ["ring", "ulysses"])
def test_bf16_matches_jax(world, name):
    p, ranks = world
    fn, sh, (q, kT, v) = _jax_out(name, p, False, jnp.bfloat16)
    want = np.asarray(fn(q, kT, v), np.float32)
    check(want, _seq(ranks, f"{name}_bf16"), margin=1e-2)


def test_ring_logged_rotations_equal_the_model(world):
    """(P-1) rotations of one kT and one v segment a call: the log holds
    exactly the model's bytes and payloads, and the JAX package's lowered
    program permutes the same payloads."""
    p, ranks = world
    (bh, s, hd), _ = _inputs(p)
    s_loc = s // p
    model = PR.ring_comm_bytes_per_device(bh, s, hd, p, torch.float32)
    assert model == RR.ring_comm_bytes_per_device(bh, s, hd, p, jnp.float32)
    assert model == (p - 1) * 2 * bh * s_loc * hd * 4
    txt = RR.lowered_text(RM.make_mesh([("sp", p)]), "sp", bh, s, hd,
                          jnp.float32)
    assert f"tensor<{bh}x{hd}x{s_loc}xf32>" in txt
    assert f"tensor<{bh}x{s_loc}x{hd}xf32>" in txt
    for r in ranks:
        for causal in (False, True):
            res = r[f"ring_{causal}"]
            assert res["bytes"] == model
            assert res["kinds"] == ["collective_permute"]
            assert res["shapes"] == sorted([(bh, hd, s_loc),
                                            (bh, s_loc, hd)])
        bf16 = PR.ring_comm_bytes_per_device(bh, s, hd, p, torch.bfloat16)
        assert r["ring_bf16"]["bytes"] == bf16 == model // 2


def test_ulysses_logged_all_to_alls_equal_the_model(world):
    p, ranks = world
    (bh, s, hd), _ = _inputs(p)
    model = PU.ulysses_comm_bytes_per_device(bh, s, hd, p, torch.float32)
    assert model == RU.ulysses_comm_bytes_per_device(bh, s, hd, p,
                                                     jnp.float32)
    txt = RU.lowered_text(RM.make_mesh([("sp", p)]), "sp", bh, s, hd,
                          jnp.float32).replace("-", "_")
    assert "all_to_all" in txt and "collective_permute" not in txt
    for r in ranks:
        for causal in (False, True):
            assert r[f"ulysses_{causal}"]["bytes"] == model
            assert r[f"ulysses_{causal}"]["kinds"] == ["all_to_all"]


@pytest.mark.parametrize("nd", [1, 2, 4, 8])
@pytest.mark.parametrize("bh", [2, 8])
def test_comm_models_and_crossover_match_reference(nd, bh):
    s, hd = 1024, 32
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        assert PR.ring_comm_bytes_per_device(bh, s, hd, nd, dt) == \
            RR.ring_comm_bytes_per_device(bh, s, hd, nd, jdt)
        assert PU.ulysses_comm_bytes_per_device(bh, s, hd, nd, dt) == \
            RU.ulysses_comm_bytes_per_device(bh, s, hd, nd, jdt)
        assert PU.recommend_cp_flavor(bh, s, hd, nd, dt) == \
            RU.recommend_cp_flavor(bh, s, hd, nd, jdt)


def test_refusals(world):
    p, ranks = world
    for r in ranks:
        assert r["ring_indivisible"] == f"s=1001 must divide over {p} devices"
        assert "envelope" in r["ring_envelope"]
        assert "divide" in r["uly_indivisible"]
        assert "heads divisible" in r["uly_heads"]


def test_combine_matches_reference():
    """The LSE merge of two partial results, f32, against the reference's
    `_combine` (include=None) on the same numpy inputs."""
    rng = np.random.default_rng(3)
    out, o_t = (rng.standard_normal((2, 64, 16)).astype(np.float32)
                for _ in range(2))
    lse, lse_t = (rng.standard_normal((2, 64)).astype(np.float32) * 4
                  for _ in range(2))
    want = RR._combine(*(jnp.asarray(a) for a in (out, lse, o_t, lse_t)))
    got = PR._combine(*(torch.as_tensor(a) for a in (out, lse, o_t, lse_t)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
