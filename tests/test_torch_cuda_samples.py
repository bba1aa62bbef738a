"""The samples (libxsmm_torch/samples/) and the bitmask helpers'
numpy operands on the card.

Every test here needs a CUDA device and skips without one. On the GPU
machine run:

    python -m pytest tests/test_torch_cuda_samples.py --noconftest -q

Each sample's main runs on the card at a reduced size and returns 0, with
the launch counts of the kernels it reaches set to 0 just before and risen
just after. DROPOUT_INV takes a numpy mask, which loads onto its gradient's
card, and launches no kernel the same call with the mask as a tensor does
not; pack_bitmask and unpack_bitmask load a numpy operand onto the card.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import libxsmm_torch as xp
from libxsmm_torch.kernels import eltwise as KE
from libxsmm_torch.kernels import gemm as KG
from libxsmm_torch.kernels import spmm as KS
from libxsmm_torch.samples import (cnn, dispatch_bench, eltwise, encoder,
                                   equation, hello, probe_bcsc, pyfr,
                                   smmbench, spmm, spmm_scaling, utilities,
                                   xgemm)

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def _reset():
    for mod in (KG, KE, KS):
        mod.reset_launches()


def _launches():
    return {**KG.launches, **KE.launches, **KS.launches}


def _run(main, args):
    _reset()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = main(args)
    torch.cuda.synchronize()
    return rc, _launches(), out.getvalue()


@pytest.mark.parametrize("name,args,kernels", [
    ("hello", [], ()),
    ("eltwise", [], ("dropout",)),
    ("equation", [], ()),
    ("smmbench", ["32", "1024"], ("packed_batched_gemm",)),
    ("dispatch_bench", ["200"], ()),
    ("utilities", ["512", "512"], ()),
    ("spmm", ["--size", "256", "--densities", "0.2"],
     ("bcsc_spmm", "bcsc_spmm_super", "bcsc_spmm_union",
      "bcsc_union_compact", "bcsc_densify")),
    ("probe_bcsc", ["0.2", "--size", "256"],
     ("bcsc_densify", "bcsc_spmm_union", "bcsc_union_compact")),
    ("cnn", ["4", "16", "16", "16", "32", "3", "1"], ()),
    ("pyfr", ["256", "--synthetic"], ()),
    ("encoder", [], ()),
    ("spmm_scaling", ["2", "--n", "64"], ()),
])
def test_sample_on_the_card(name, args, kernels, card):
    mod = {"hello": hello, "eltwise": eltwise, "equation": equation,
           "smmbench": smmbench, "dispatch_bench": dispatch_bench,
           "utilities": utilities, "spmm": spmm, "probe_bcsc": probe_bcsc,
           "cnn": cnn, "pyfr": pyfr, "encoder": encoder,
           "spmm_scaling": spmm_scaling}[name]
    rc, counts, out = _run(mod.main, args)
    assert rc == 0, out
    for k in kernels:
        assert counts[k] > 0, (k, counts)
    assert "host clock: not a card figure" not in out


def test_xgemm_packed_ext_and_sr_classes_on_the_card(card, monkeypatch):
    """--full over the lane-packed ext classes and the stochastic-round
    store class: the packed BRGEMM and the SR kernel launch."""
    from libxsmm_torch import xgemm as PX
    table = PX.build_class_list()
    picked = [c for c in table if c["kind"] == "ext_packed"
              or c.get("cp") == "STOCHASTIC_ROUND"]
    assert len(picked) == 5
    monkeypatch.setattr(PX, "build_class_list", lambda: picked)
    rc, counts, out = _run(xgemm.main, ["--full", "--bench"])
    assert rc == 0, out
    assert counts["packed_brgemm"] > 0 and counts["stochastic_round"] > 0
    assert '"classes": 5, "pass": 5' in out


def test_xgemm_draw_on_the_card(card):
    rc, _, out = _run(xgemm.main, ["10", "--bench"])
    assert rc == 0 and "10/10 passed" in out, out


def test_dropout_inv_takes_a_numpy_mask(card):
    m, n, p = 1000, 1001, 0.3
    g = torch.randn(m, n, device=card)
    fwd = xp.dispatch_meltw_unary(xp.UnaryType.DROPOUT, m, n,
                                  xp.UnaryFlags.BITMASK_2BYTEMULT,
                                  extra=(p,))
    inv = xp.dispatch_meltw_unary(xp.UnaryType.DROPOUT_INV, m, n,
                                  xp.UnaryFlags.BITMASK_2BYTEMULT,
                                  extra=(p,))
    _, pmask = fwd(g.abs() + 1.0, seed=5)
    _reset()
    want = inv(g, pmask)
    torch.cuda.synchronize()
    tensor_counts = _launches()
    _reset()
    got = inv(g, pmask.cpu().numpy())
    torch.cuda.synchronize()
    assert _launches() == tensor_counts
    assert got.device == card and torch.equal(got, want)


def test_bitmask_helpers_load_numpy_onto_the_card(card):
    mask = np.random.default_rng(3).random((7, 37)) < 0.5
    packed = xp.pack_bitmask(mask)
    assert packed.device.type == "cuda"
    assert torch.equal(packed.cpu(), xp.pack_bitmask(torch.from_numpy(mask)))
    back = xp.unpack_bitmask(packed.cpu().numpy(), 7, 37)
    assert back.device.type == "cuda"
    np.testing.assert_array_equal(back.cpu().numpy(), mask)
