"""The parallel layer on the card: a one-rank NCCL world and two ranks over
gloo on one card (collectives staged through host memory), each rank
running ring and Ulysses attention on the flash kernels, the ring2 SpMM
and a pipeline forward (tests/torch_parallel_ranks.world_card); with four
cards, also four NCCL ranks, one a card.

Every test here needs a CUDA device and skips without one (the four-rank
NCCL world without four cards). On the GPU machine run:

    python -m pytest tests/test_torch_cuda_parallel.py --noconftest -q

(`--noconftest`: the repo's tests/conftest.py sets JAX up for the JAX
package's tests, and this file imports nothing of JAX or libxsmm_tpu.)

Tolerances (matdiff normf_rel): bf16 attention 1e-2 against the float64
composition (the probabilities and the output rounded to bf16), f32
gradients 1e-4, the f32 SpMM 1e-5 against float64, the pipeline forward
1e-5 against its plain sequential version (the same f32 products).
"""

import pytest
import torch

import torch_parallel_ranks as R
from libxsmm_torch.matdiff import check
from libxsmm_torch.scripts.ranks import run_ranks

torch.set_num_threads(1)

_WORLDS = {}


@pytest.fixture(params=["nccl1", "gloo2", "nccl4"])
def world(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    key = request.param
    if key == "nccl4" and torch.cuda.device_count() < 4:
        pytest.skip("needs four cards: NCCL takes one rank a card")
    if key not in _WORLDS:
        size, backend = {"nccl1": (1, "nccl"), "gloo2": (2, "gloo"),
                         "nccl4": (4, "nccl")}[key]
        _WORLDS[key] = run_ranks(R.world_card, size, device_type="cuda",
                                 backend=backend, timeout=600.0)
    return key, _WORLDS[key]


@pytest.mark.parametrize("name", ["ring", "ulysses"])
def test_attention_on_the_card(world, name):
    key, ranks = world
    for r in ranks:
        got, want, staged = r[name]
        check(want, got, margin=1e-2)
        # gloo stages card tensors through host memory; NCCL never does
        assert all(staged) if key == "gloo2" else not any(staged)
        assert r["backend"] == key[:-1]


@pytest.mark.parametrize("name", ["ring", "ulysses"])
def test_attention_gradients_on_the_card(world, name):
    _, ranks = world
    for r in ranks:
        for got, want in r[f"{name}_grads"]:
            check(want, got, margin=1e-4)


def test_flash_kernels_launched_in_every_rank(world):
    _, ranks = world
    for r in ranks:
        assert min(r["launches"].values()) > 0, r["launches"]


def test_spmm_on_the_card(world):
    key, ranks = world
    for r in ranks:
        got, want, logged, model = r["spmm"]
        check(want, got, margin=1e-5)
        assert logged == model
        # the tri-state: gloo is "backend-synchronous", NCCL reads a
        # profiler trace of one call
        rep = r["overlap"]
        assert rep["prefetch_issue_order"] is True
        if key.startswith("nccl"):
            assert rep["overlap_verified"] in (True, False)
            assert rep["trace_available"] is True
        else:
            assert rep["overlap_verified"] == "backend-synchronous"


def test_pipeline_on_the_card(world):
    _, ranks = world
    for r in ranks:
        last, got, want = r["pipeline"]
        if last:
            check(want, got, margin=1e-5)
        else:
            assert not got.any()
