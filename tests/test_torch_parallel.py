"""The port's mesh, collectives and distributed BSR SpMM
(libxsmm_torch.parallel: mesh, collectives, spmm_dist) in gloo worlds of 2,
4 and 2 x 2 ranks, against the JAX package on a mesh of the same size
(libxsmm_tpu.parallel, the first P of the 8 virtual CPU devices), with the
same seeded numpy inputs. The cases mirror tests/test_parallel.py's.

Each world runs once per module (run_ranks, one process a rank, a join
timeout) and returns every rank's results; the tests below read them.
The collectives' chunk order is held against jax.lax's (tiled) on
labelled data, exactly. Tolerances: the SpMM outputs 1e-4 (matdiff, the
reference tests' margin) against the dense product and against the JAX
package's; the identity 1e-6; ring, ring2 and allgather agree within 1e-6
relative (the same f32 products, summed in another order).
"""

import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import torch_parallel_ranks as R
from libxsmm_torch.matdiff import check
from libxsmm_torch.scripts.ranks import run_ranks
from libxsmm_tpu.ops.sparse import BsrMatrix as RBsr
from libxsmm_tpu.parallel import mesh as RM
from libxsmm_tpu.parallel import spmm_dist as RS

torch.set_num_threads(1)

TIMEOUT = 240.0


def _ref_fields(p):
    a = R.block_sparse(40 + p, 32 * p, 32 * p, 8, 8, 0.3)
    bsr = RBsr.from_dense(a, 8, 8)
    return a, types.SimpleNamespace(
        shape=bsr.shape, br=bsr.br, bc=bsr.bc, indptr=bsr.indptr,
        indices=bsr.indices, data=bsr.data, n=16,
        x=R.dense_x(50 + p, 32 * p, 16))


_WORLDS = {}


def _world(p):
    """The 1-D world of p ranks, run once for the module."""
    if p not in _WORLDS:
        a, ref = _ref_fields(p)
        _WORLDS[p] = (p, run_ranks(R.world_spmm, p, (p, ref),
                                   timeout=TIMEOUT), (a, ref))
    return _WORLDS[p]


@pytest.fixture(scope="module", params=[2, 4], ids=["P2", "P4"])
def world(request):
    return _world(request.param)


@pytest.fixture(scope="module")
def world4():
    return _world(4)[1]


@pytest.fixture(scope="module")
def world22():
    return run_ranks(R.world_two_level, 4, timeout=TIMEOUT)


def _rows(ranks, key):
    """The global result: the ranks' local blocks stacked in rank order."""
    return np.concatenate([np.asarray(r[key] if not isinstance(
        r[key], tuple) else r[key][0]) for r in ranks])


def _jax_spmm(a, br, bc, n, x, p, comm="ring"):
    mesh = RM.make_mesh([("x", p)])
    spmm = RS.DistributedBsrSpmm(RBsr.from_dense(a, br, bc), n, mesh,
                                 comm=comm)
    return spmm, np.asarray(spmm(x))


def _jax_local(fn, p, inputs):
    """Run `fn` under shard_map over the first p devices on the ranks'
    local blocks (stacked on axis 0); return each device's local result."""
    mesh = RM.make_mesh([("x", p)])
    f = jax.shard_map(fn, mesh=mesh, in_specs=JP("x"), out_specs=JP("x"))
    out = np.asarray(f(jnp.concatenate(inputs)))
    return np.split(out, p)

# ---------------------------------------------------------------- mesh


def test_mesh_one_rank_in_a_plain_script():
    """make_mesh([("sp", 1)]) in a script with no process group makes its
    own one-rank world (a FileStore in a temporary directory)."""
    code = ("from libxsmm_torch.parallel.mesh import make_mesh\n"
            "m = make_mesh([('sp', 1)], device_type='cpu')\n"
            "import torch.distributed as d\n"
            "print(m.shape, m.index('sp'), d.get_world_size(), "
            "d.get_backend())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["{'sp':", "1}", "0", "1", "gloo"]


def test_one_rank_collectives_are_local():
    """On a group of one rank the collectives issue no backend call: the
    all-to-all and all-gather return the operand, the all-reduce and the
    self-permute a copy; the log holds each with "peer": "self", the
    permute's payload and zero bytes for the others (the comm models at
    P = 1)."""
    (r,) = run_ranks(R.world_one, 1, timeout=TIMEOUT)
    x = R.labels(0, R.A2A_SHAPE)
    for out in r["outs"]:
        np.testing.assert_array_equal(out.numpy(), x)
    assert [(e["kind"], e["bytes"], e["peer"]) for e in r["log"]] == [
        ("all_to_all", 0, "self"), ("all_gather", 0, "self"),
        ("all_reduce", 0, "self"), ("collective_permute", x.nbytes, "self")]
    a, _, _, xx, _ = R.spmm_case("dense2")
    check(a @ xx, r["spmm"].numpy(), margin=1e-4)


def test_mesh_refuses_more_devices_than_ranks(world):
    p, ranks, _ = world
    for r in ranks:
        assert r["too_big"] == f"mesh wants {2 * p} devices, have {p}"
    assert [r["index"] for r in ranks] == list(range(p))


def test_shard_cuts_locally_without_collectives(world):
    p, ranks, _ = world
    g = R.labels(0, (8, 6, 4))
    for rank, r in enumerate(ranks):
        blk, shape, log = r["shard"]
        w = 4 // p
        np.testing.assert_array_equal(blk.numpy(),
                                      g[:, :, rank * w:(rank + 1) * w])
        assert shape == (8, 6, 4) and log == []


def test_shard_over_two_axes(world22):
    g = R.labels(0, (8, 4))
    for r in world22:
        dcn, ici = r["coords"]
        i = 2 * dcn + ici
        np.testing.assert_array_equal(r["shard"].numpy(), g[2 * i:2 * i + 2])
        np.testing.assert_array_equal(r["shard_ici"].numpy(),
                                      g[4 * ici:4 * ici + 4])
        assert "mesh's order" in r["bad_order"]

# ---------------------------------------------------------------- the
# collectives, against jax.lax on labelled data


@pytest.mark.parametrize("axes", R.A2A_AXES, ids=str)
def test_all_to_all_chunk_order_matches_jax(world, axes):
    p, ranks, _ = world
    inputs = [R.labels(r, R.A2A_SHAPE) for r in range(p)]
    want = _jax_local(lambda x: jax.lax.all_to_all(
        x, "x", axes[0], axes[1], tiled=True), p, inputs)
    for r, w in zip(ranks, want):
        np.testing.assert_array_equal(r["collectives"]["a2a"][axes].numpy(),
                                      w)


@pytest.mark.parametrize("axis", [0, 1])
def test_all_gather_matches_jax(world, axis):
    p, ranks, _ = world
    inputs = [R.labels(r, R.A2A_SHAPE) for r in range(p)]
    want = _jax_local(lambda x: jax.lax.all_gather(x, "x", axis=axis,
                                                   tiled=True), p, inputs)
    for r, w in zip(ranks, want):
        np.testing.assert_array_equal(
            r["collectives"][f"gather{axis}"].numpy(), w)


@pytest.mark.parametrize("which", ["ring", "partial"])
def test_ppermute_matches_jax(world, which):
    """The ring, and a permutation that sends nothing to index 0 (which
    receives zeros)."""
    p, ranks, _ = world
    perm = ([(i, (i + 1) % p) for i in range(p)] if which == "ring"
            else [(i, i + 1) for i in range(p - 1)])
    inputs = [R.labels(r, R.A2A_SHAPE) for r in range(p)]
    want = _jax_local(lambda x: jax.lax.ppermute(x, "x", perm), p, inputs)
    for r, w in zip(ranks, want):
        np.testing.assert_array_equal(r["collectives"][which].numpy(), w)


def test_collective_gradients_match_jax(world):
    """ppermute's backward (the inverse permutation) and all_to_all's (the
    reverse all-to-all) against jax.grad through the same composition."""
    p, ranks, _ = world
    mesh = RM.make_mesh([("x", p)])
    perm = [(i, (i + 1) % p) for i in range(p)]
    xs = jnp.concatenate([R.labels(r, R.A2A_SHAPE) for r in range(p)])
    zshape = list(R.A2A_SHAPE)
    zshape[0] //= p
    zshape[2] *= p
    ws = jnp.concatenate([R.labels(r, zshape) for r in range(p)])

    def body(x, w):
        z = jax.lax.all_to_all(jax.lax.ppermute(x, "x", perm), "x", 0, 2,
                               tiled=True)
        return z * w

    f = jax.shard_map(body, mesh=mesh, in_specs=(JP("x"), JP("x")),
                      out_specs=JP("x"))
    g = np.split(np.asarray(jax.grad(lambda x: jnp.sum(f(x, ws)))(xs)), p)
    for r, w in zip(ranks, g):
        np.testing.assert_array_equal(r["collectives"]["grad"].numpy(), w)


def test_all_reduce_and_axis_index(world):
    p, ranks, _ = world
    total = sum(R.labels(r, R.A2A_SHAPE) for r in range(p))
    for i, r in enumerate(ranks):
        assert r["collectives"]["axis_index"] == i
        np.testing.assert_array_equal(r["collectives"]["sum"].numpy(), total)

# ---------------------------------------------------------------- the
# distributed SpMM, against the JAX package and the dense product


def test_dist_spmm_matches_dense_and_jax(world):
    p, ranks, _ = world
    a, br, bc, x, n = R.spmm_case(f"dense{p}")
    got = _rows(ranks, f"dense{p}")
    check(a @ x, got, margin=1e-4)
    _, want = _jax_spmm(a, br, bc, n, x, p)
    check(want, got, margin=1e-4)


def test_dist_spmm_from_reference(world):
    """from_reference carries the JAX package's BsrMatrix across; the
    product matches the JAX package's on the same matrix."""
    p, ranks, (a, ref) = world
    got = _rows(ranks, "from_reference")
    check(a @ ref.x, got, margin=1e-4)
    _, want = _jax_spmm(a, 8, 8, ref.n, ref.x, p, comm="ring2")
    check(want, got, margin=1e-4)


def test_dist_spmm_identity(world):
    _, ranks, _ = world
    check(R.dense_x(2, 32, 8), _rows(ranks, "identity"), margin=1e-6)


def test_dist_spmm_bad_comm(world):
    for r in world[1]:
        assert r["bad_comm"] == "unknown comm strategy nope"


def test_dist_spmm_uneven_pattern(world4):
    a, x = R.uneven(3), R.dense_x(4, 128, 8)
    got = _rows(world4, "uneven")
    check(a @ x, got, margin=1e-4)
    check(_jax_spmm(a, 4, 8, 8, x, 4)[1], got, margin=1e-4)


@pytest.mark.parametrize("case", ["dense4", "r2"])
def test_dist_spmm_ring_ring2_allgather_agree(world4, case):
    a, br, bc, x, n = R.spmm_case("dense4" if case == "dense4" else "ring2")
    outs = {c: _rows(world4, f"{case}_{c}")
            for c in ("ring", "ring2", "allgather")}
    for comm, got in outs.items():
        check(a @ x, got, margin=1e-4)
        check(_jax_spmm(a, br, bc, n, x, 4, comm)[1], got, margin=1e-4)
    np.testing.assert_allclose(outs["ring2"], outs["ring"], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("comm", ["ring", "ring2", "allgather"])
def test_dist_spmm_logged_bytes_equal_the_model(world4, comm):
    a, br, bc, x, n = R.spmm_case("ring2")
    seg = (a.shape[1] // 4) * n * 4
    want = {"ring": 4 * seg, "ring2": 5 * seg, "allgather": 3 * seg}[comm]
    jspmm, _ = _jax_spmm(a, br, bc, n, x, 4, comm)
    assert jspmm.comm_bytes_per_device() == want
    for r in world4:
        _, logged, model = r[f"r2_{comm}"]
        assert logged == model == want


def test_ring_comm_volume_model(world):
    """The ring's log holds P permutes of one (k/P, n) f32 segment, the
    allgather's one all-gather; bytes equal the analytic model, and the
    JAX package's lowered program permutes the same payload."""
    p, ranks, _ = world
    k, n = 256, 32
    a = R.comm_matrix(0, p)
    x = R.dense_x(1, k, n)
    jring, want = _jax_spmm(a, 16, 16, n, x, p)
    txt = jring.lowered_text(x)
    assert f"tensor<{k // p}x{n}xf32>" in txt
    for r in ranks:
        ring, ag = r["comm_volume"]["ring"], r["comm_volume"]["allgather"]
        assert ring["logged"] == ring["model"] == p * (k // p) * n * 4
        assert ring["log"] == [("collective_permute", (k // p, n),
                                "float32")] * p
        assert ag["logged"] == ag["model"] == (p - 1) * (k // p) * n * 4
        assert [e[0] for e in ag["log"]] == ["all_gather"]
    for comm in ("ring", "allgather"):
        got = np.concatenate([r["comm_volume"][comm]["c"] for r in ranks])
        check(want, got, margin=1e-4)


@pytest.mark.parametrize("comm", ["ring", "ring2", "allgather"])
def test_dist_spmm_overlap_report(world4, comm):
    """The reference's keys and tri-state: on gloo overlap_verified is
    "backend-synchronous"; ring2 issues the next segment before the first
    multiply (as the JAX package's lowered order shows), the plain ring
    and allgather do not; ring2 starts its P + 1 rotations asynchronously."""
    a, br, bc, x, n = R.spmm_case("overlap")
    jspmm, _ = _jax_spmm(a, br, bc, n, x, 4, comm)
    jrep = jspmm.overlap_report(x)
    for r in world4:
        rep = r[f"overlap_{comm}"]
        assert set(rep) >= {"async_split", "overlap_verified", "n_start",
                            "prefetch_issue_order"}
        assert rep["overlap_verified"] == "backend-synchronous"
        assert rep["prefetch_issue_order"] is jrep["prefetch_issue_order"]
        assert rep["prefetch_issue_order"] is (comm == "ring2")
        assert rep["n_start"] == (5 if comm == "ring2" else 0)
        assert rep["async_split"] is (comm == "ring2")


def test_dist_spmm_refusals(world4):
    r = world4[0]
    assert "not divisible by 4 devices" in r["indivisible"]
    assert r["allgather_ok"] is None
    assert "divisible" in r["allgather_k"]
    for rr in world4[1:]:
        assert rr["allgather_k"] == r["allgather_k"]

# ---------------------------------------------------------------- the
# two-level (dcn x ici) SpMM


@pytest.mark.parametrize("comm", ["ring2", "ring"])
def test_dist_spmm_two_level(world22, comm):
    m, k, br, bc, dens, n, seed = R.TWO_LEVEL
    a = R.block_sparse(seed, m, k, br, bc, dens)
    x = R.dense_x(seed + 100, k, n)
    order = sorted(world22, key=lambda r: r["coords"])
    got = np.concatenate([r[comm] for r in order])
    check(a @ x, got, margin=1e-4)
    mesh = RM.make_mesh([("dcn", 2), ("ici", 2)])
    jspmm = RS.DistributedBsrSpmm2Level(RBsr.from_dense(a, br, bc), n, mesh,
                                        comm=comm)
    check(np.asarray(jspmm(x)), got, margin=1e-4)
    jrep = jspmm.overlap_report(x)
    seg = (k // 2) * n * 4
    for r in world22:
        logged, model, groups = r[f"{comm}_bytes"]
        assert logged == model == (3 if comm == "ring2" else 2) * seg
        assert groups == [2]          # the ring rides the ici axis alone
        rep = r[f"{comm}_report"]
        assert rep["overlap_verified"] == "backend-synchronous"
        assert rep["prefetch_issue_order"] is jrep["prefetch_issue_order"]
        assert rep["prefetch_issue_order"] is (comm == "ring2")
        assert r["ring_size"] == 2
        assert "comm" in r["bad_comm"]
    if comm == "ring":
        r2 = np.concatenate([r["ring2"] for r in order])
        np.testing.assert_allclose(r2, got, rtol=1e-6, atol=1e-6)

# ---------------------------------------------------------------- the
# projection


def test_projected_weak_scaling_is_the_reference_model_on_h100(monkeypatch):
    """The port's projection is the reference's formula on the H100's
    data-sheet parameters (HBM 3350 GB/s, 67 TFLOP/s f32, NVLink 450 GB/s
    one way): the reference's function, fed the same numbers, agrees."""
    from libxsmm_torch.device import GEOMETRY_TABLE
    from libxsmm_torch.parallel.spmm_dist import (
        projected_weak_scaling_params as port)
    from libxsmm_tpu.device import TpuGeometry
    g = GEOMETRY_TABLE["h100"]
    monkeypatch.setitem(
        __import__("libxsmm_tpu.device", fromlist=["x"]).GEOMETRY_TABLE,
        "h100", TpuGeometry("h100", hbm_gbps=g.hbm_gbps,
                            peak_f32_tflops=g.peak_f32_tflops,
                            ici_link_gbps=g.nvlink_gbps))
    rows, k, n, dens = 32768, 8192, 512, 0.1
    for comm in ("ring", "ring2", "allgather"):
        for nd in (1, 4, 8, 64):
            args = (rows * nd, k, n, int(rows * k * dens) * nd, nd, comm)
            mine = port(*args)
            ref = RS.projected_weak_scaling_params(*args, geom_name="h100")
            assert "PROJECTION" in mine["model"] and "h100" in mine["model"]
            mine.pop("model")
            ref.pop("model")
            assert mine == ref


def test_projected_weak_scaling_model():
    """The reference test's properties on the H100's parameters: P = 1
    has no comm and efficiency 1.0; ring2 >= ring >= allgather; the ring
    flavours are flat in P."""
    from libxsmm_torch.parallel.spmm_dist import (
        projected_weak_scaling_params as port)
    one = port(4096, 8192, 512, 100000, 1, "ring")
    assert one["projected_efficiency"] == 1.0 and one["t_comm_us"] == 0.0
    rows, k, n, dens = 32768, 8192, 512, 0.1
    effs = {comm: [port(rows * nd, k, n, int(rows * k * dens) * nd, nd,
                        comm)["projected_efficiency"] for nd in (8, 64, 256)]
            for comm in ("ring", "ring2", "allgather")}
    assert effs["ring2"][0] >= effs["ring"][0] >= effs["allgather"][0]
    assert effs["ring"] == [effs["ring"][0]] * 3
    assert effs["ring2"] == [effs["ring2"][0]] * 3
