"""The encoder block's sharded train step (libxsmm_torch.models.
tpp_attention: make_sharded_train_step, shard_params) in one gloo world of
4 ranks on a (dp 2, tp 2) mesh, against the JAX package's sharded step on
a mesh of the same size (the first 4 of its 8 virtual CPU devices) and
against the port's single-device train step, from the same seeded
parameters and inputs. The rank functions are
tests/torch_sharded_ranks.py's.

Cases: flash on (causal and not) and off, at dropout_p = 0 against the JAX
package (tests/test_models.py:362's comparison); and at dropout_p = 0.1,
flash on (causal and not) and off, against the port's single-device step,
with the dropout masks each rank drew held against the single-device
masks: the dropout kernel's byte masks (the FFN's and, flash off, the
probabilities') cut to each rank's block, and the flash kernels' hashed
batch-head indices, bit for bit. On the CPU the kernels run their plain
versions, which hash exactly what the kernels hash.

Tolerances: against the JAX package, the reference test's own (loss within
1e-5 absolute, parameters rtol 1e-4, atol 1e-5); against the port's
single-device step, the loss within 1e-6 relative and the parameters
rtol 1e-4, atol 1e-6 (the same masks, the same f32 arithmetic; the tp sums
add f32 partial products in another order: rounding only). Masks and
hashed indices: exact.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

import torch_sharded_ranks as R
from libxsmm_torch.models import tpp_attention as PA
from libxsmm_torch.scripts.ranks import run_ranks
from libxsmm_tpu.models import tpp_attention as RA
from libxsmm_tpu.parallel import mesh as RM

torch.set_num_threads(1)

NO_DROP = [c for c, (_, _, p) in R.ATTN_CASES.items() if p == 0.0]
DROP = [c for c, (_, _, p) in R.ATTN_CASES.items() if p > 0.0]
B, S, D = R.ATTN_X


@pytest.fixture(scope="module")
def world():
    return run_ranks(R.world_attention, R.WORLD, timeout=300.0)


def _single(case):
    """The port's single-device step, with the masks and hashed heads it
    drew."""
    cfg = R.attn_cfg(case)
    x, y = R.attn_inputs()
    seed = R.DROP_SEED if cfg.dropout_p > 0 else None
    with R._Recorder() as rec:
        new, loss = PA.train_step(PA.init_params(cfg, seed=3, device="cpu"),
                                  torch.as_tensor(x), torch.as_tensor(y),
                                  cfg, lr=R.LR["attn"], seed=seed)
    return new, float(loss), rec


@pytest.mark.parametrize("case", NO_DROP)
def test_matches_jax_sharded_step(world, case):
    flash, causal, _ = R.ATTN_CASES[case]
    cfg = RA.AttentionConfig(flash=flash, causal=causal, **R.ATTN_CFG)
    mesh = RM.make_mesh([("dp", 2), ("tp", 2)])
    step, xsh = RA.make_sharded_train_step(cfg, mesh, lr=R.LR["attn"])
    x, y = R.attn_inputs()
    ysh = NamedSharding(mesh, JP("dp", None, None))
    want, want_loss = step(RA.shard_params(RA.init_params(cfg, seed=3),
                                           mesh),
                           jax.device_put(x, xsh), jax.device_put(y, ysh))
    for r in world:
        got = r[case]
        assert abs(float(got["loss"]) - float(want_loss)) < 1e-5
        for k, v in want.items():
            np.testing.assert_allclose(got["params"][k].numpy(),
                                       np.asarray(v), rtol=1e-4, atol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("case", list(R.ATTN_CASES))
def test_matches_single_device_step(world, case):
    want, want_loss, _ = _single(case)
    for r in world:
        got = r[case]
        assert abs(float(got["loss"]) - want_loss) <= 1e-6 * abs(want_loss)
        for k, v in want.items():
            np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("case", DROP)
def test_masks_are_the_single_device_masks(world, case):
    """Each rank's dropout masks are its blocks of the single-device masks
    (and the blocks tile them: every element is covered once); each rank's
    flash kernels hash the global batch-head indices of its block."""
    flash, _, _ = R.ATTN_CASES[case]
    _, _, single = _single(case)
    cfg = R.attn_cfg(case)
    nh, f = cfg.heads, cfg.ffn_mult * cfg.dim
    # by seed: the probabilities' mask (flash off; the single device's is
    # (b * nh * s, s)) and the FFN's (b * s, f)
    want = {seed: m for seed, _, m in single.masks}
    assert sorted(want) == ([R.DROP_SEED + 1] if flash
                            else [R.DROP_SEED, R.DROP_SEED + 1])
    ffn = want[R.DROP_SEED + 1]
    cover = torch.zeros(ffn.shape, dtype=torch.int32)
    for r in world:
        got = {seed: (blk, m) for seed, blk, m in r[case]["masks"]}
        assert sorted(got) == sorted(want)
        d, t = r["index"]
        (gshape, off), m = got[R.DROP_SEED + 1]
        assert gshape == (B * S, f)
        assert off == (d * B // 2 * S, t * f // 2)
        rows = slice(off[0], off[0] + m.shape[0])
        cols = slice(off[1], off[1] + m.shape[1])
        assert torch.equal(m, ffn[rows, cols])
        cover[rows, cols] += 1
        if not flash:
            (gshape, off), m = got[R.DROP_SEED]
            assert gshape == (B, nh, S, S)
            assert off == (d * B // 2, t * nh // 2, 0, 0)
            probs = want[R.DROP_SEED].reshape(B, nh, S, S)
            assert torch.equal(m, probs[off[0]:off[0] + B // 2,
                                        off[1]:off[1] + nh // 2])
    assert bool((cover == 1).all())
    if flash:
        # forward, dK/dV and dQ: three hashes of the same heads
        everyone = torch.cat([r[case]["heads"][0] for r in world])
        assert sorted(everyone.tolist()) == list(range(B * nh))
        for r in world:
            d, t = r["index"]
            heads = r[case]["heads"]
            assert len(heads) == 3 and all(torch.equal(h, heads[0])
                                           for h in heads)
            want_heads = [(d * B // 2 + b) * nh + t * nh // 2 + h
                          for b in range(B // 2) for h in range(nh // 2)]
            assert heads[0].tolist() == want_heads
        assert [h.tolist() for h in single.heads] == [list(range(B * nh))] * 3


@pytest.mark.parametrize("case", list(R.ATTN_CASES))
def test_logged_bytes_equal_the_model(world, case):
    """Four tp all-reduces of the f32 (b / dp * s, d) activations, the dp
    sum of the gradients and the loss, and nothing else."""
    for r in world:
        got = r[case]
        assert got["kinds"] == ["all_reduce"]
        assert got["bytes"] == got["model"]
    cfg = R.attn_cfg(case)
    assert PA.encoder_comm_bytes_per_device(cfg, B, S, 1, 1) == 0
    act = B // 2 * S * D * 4
    assert world[0][case]["model"] > 4 * act


def test_refusals(world):
    for r in world:
        assert r["no_seed"] == ("cfg.dropout_p > 0 requires seed= in "
                                "make_sharded_train_step")
        assert r["bad_heads"] == "heads=3 does not divide over 2 ranks"
