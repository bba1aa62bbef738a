"""The port's multi-device dry run (libxsmm_torch.scripts.dryrun), the
counterpart of __graft_entry__.py's: dryrun_multichip(4) runs every leg on
four gloo ranks on the CPU (one world, a run_ranks timeout of its own), and
each leg holds its bound on every rank (1e-3 for the SpMM ring, 1e-4 for
the rest, against the single-device computation). entry() gives the JAX
package's forward on the same weights and input (f32, 1e-5).
"""

import numpy as np
import pytest
import torch

from libxsmm_torch.scripts import dryrun

LEGS = ["dryrun dp=2 tp=2", "dryrun sp=4", "dryrun gcn sp=4",
        "dryrun cnn dp=4", "dryrun attention dp=2 tp=2",
        "dryrun ring-attention sp=4", "dryrun ulysses sp=4",
        "dryrun pipeline pp=2 dp=2", "dryrun moe dp=2 ep=2",
        "dryrun moe-a2a dp=2 ep=2", "weak_scaling"]


@pytest.fixture(scope="module")
def world():
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        worst = dryrun.dryrun_multichip(4, timeout=240.0)
    return worst, out.getvalue().splitlines()


@pytest.mark.parametrize("leg", LEGS)
def test_dryrun_leg(world, leg):
    worst, lines = world
    assert list(worst) == LEGS
    bound = dryrun.BOUND_SPMM if leg == "dryrun sp=4" else dryrun.BOUND
    assert worst[leg] <= bound
    line = next(ln for ln in lines if ln.split(":")[0] == leg)
    if leg == "weak_scaling":
        assert "not measured" in line and "none is claimed" in line
    else:
        assert " OK" in line


def test_entry_matches_the_jax_package():
    import jax.numpy as jnp

    from libxsmm_tpu.models.tpp_mlp import MlpConfig, forward, init_params
    fn, (params, x) = dryrun.entry(device="cpu")
    assert tuple(x.shape) == (64, 256) and x.dtype == torch.float32
    cfg = MlpConfig(in_dim=256, hidden=(512, 512), out_dim=128)
    want = np.asarray(forward(init_params(cfg), jnp.asarray(x.numpy()), cfg))
    got = fn(params, x)
    from libxsmm_torch.matdiff import check
    check(want.astype(np.float64), got.double().numpy(), 1e-5)
