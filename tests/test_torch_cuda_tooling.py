"""The tooling on the card: Kernel.lower_text's launch list and SASS, and
the AOT warm start.

Every test here needs a CUDA device and skips without one. On the GPU
machine run:

    python -m pytest tests/test_torch_cuda_tooling.py --noconftest -q

(`--noconftest`: the repo's tests/conftest.py sets JAX up for the JAX
package's tests, and this file imports nothing of JAX or libxsmm_tpu.)

Each text's launches are held against the launch counters read around
the same call (kernels/{gemm,spmm}.py), each launch must list exactly the
one entry that ran (the library's launch log, csrc/xsmm_launches.cuh), as
often as the counter counts, with resources and non-empty SASS (cuobjdump
of the library kernels/_build.py loaded), and the same call gives the same
text twice. The AOT child (scripts/aot_warm.py) runs the exported packed
SMM in a copy of the package without kernels/build/, with nvcc out of
reach, within matdiff normf_rel 1e-5 of the plain version (f32).
"""

import re

import numpy as np
import pytest
import torch

import libxsmm_torch as xp
from libxsmm_torch import lowering

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _launches(text):
    """{counter: count} of a text's launch lines."""
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"^// launch (\w+) x(\d+):", text, re.M)}


def _hold(kern, args, card, want):
    """lower_text of kern on args: its launches against the counters, the
    one entry that ran for each, with SASS, and the same text twice."""
    before = lowering.launch_counts()
    text = kern.lower_text(*args, device=card)
    counted = {n: c for n, c, _ in lowering.launched(
        before, lowering.launch_counts())}
    assert _launches(text) == counted
    assert set(counted) == set(want)
    for name in want:
        block = text.split(f"// launch {name} x")[1].split("// launch ")[0]
        entries = re.findall(r"^// entry (\S+) x(\d+): registers (\d+)",
                             block, re.M)
        assert [int(n) for _, n, _ in entries] == [counted[name]], (
            f"{name}: entries {entries}")
        for entry, _, regs in entries:
            assert int(regs) > 0
            n = int(re.search(rf"^// sass {re.escape(entry)}: (\d+) lines",
                              block, re.M).group(1))
            assert n > 0
    assert f"// device: {card}  arch: h100" in text
    assert kern.lower_text(*args, device=card) == text
    return text


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_lower_text_packed_smm(card, dt):
    t = {"f32": xp.Datatype.F32, "bf16": xp.Datatype.BF16}[dt]
    td = xp.to_torch(t)
    kern = xp.dispatch_gemm_batched_packed(
        xp.GemmShape(32, 32, 32, a_in_type=t, b_in_type=t,
                     out_type=xp.Datatype.F32), xp.GemmFlags.BETA_0)
    text = _hold(kern, (_meta(64, 32, 128, dtype=td),) * 2, card,
                 ["packed_batched_gemm"])
    # the entry that ran instantiates the operand and result types
    token = {"f32": "packed_smm_kernelIfff", "bf16":
             "packed_smm_kernelI13__nv_bfloat16ff"}[dt]
    entries = re.findall(r"^// entry (\S+) x\d+:", text, re.M)
    assert len(entries) == 1 and token in entries[0], entries


def test_lower_text_batched_routes(card):
    kern = xp.dispatch_gemm_batched(xp.GemmShape(32, 32, 32),
                                    xp.GemmFlags.BETA_0)
    text = _hold(kern, (_meta(256, 32, 32),) * 2, card, ["batched_gemm"])
    assert "route cuda bulk x1" in text
    kern = xp.dispatch_gemm_batched(xp.GemmShape(33, 31, 17),
                                    xp.GemmFlags.BETA_0)
    text = _hold(kern, (_meta(256, 33, 17), _meta(256, 17, 31)), card,
                 ["batched_gemm"])
    assert "route cuda cp_async x1" in text
    # bf16 in and out: the second bf16 is the mangling's substitution
    bf = xp.Datatype.BF16
    kern = xp.dispatch_gemm_batched(xp.GemmShape(32, 32, 32, a_in_type=bf,
                                                 b_in_type=bf, out_type=bf),
                                    xp.GemmFlags.BETA_0)
    text = _hold(kern, (_meta(256, 32, 32, dtype=torch.bfloat16),) * 2,
                 card, ["batched_gemm"])
    entries = re.findall(r"^// entry (\S+) x\d+:", text, re.M)
    assert len(entries) == 1 and (
        "batched_gemm_ring_kernelI13__nv_bfloat16S0_" in entries[0]), entries


def test_generator_bcsc_densify(card):
    from libxsmm_torch.ops.sparse import BcscMatrix
    rng = np.random.default_rng(1)
    b = ((rng.random((256, 256)) < 0.2)
         * rng.standard_normal((256, 256))).astype(np.float32)
    bc = BcscMatrix.from_dense(b, 32, 32)
    g = xp.generator_packed_spgemm_bcsc_kernel(
        xp.GemmShape(128, 256, 256, a_in_type=xp.Datatype.BF16,
                     b_in_type=xp.Datatype.BF16), xp.GemmFlags.BETA_0,
        xp.SpgemmConfig(1, 32, 32), bc.indptr, bc.indices)
    assert g.arch == "h100" and g.kind == "pspgemm_bcsc"
    assert _launches(g.code) == {"bcsc_densify": 1}
    assert re.search(r"^// entry \S*19bcsc_densify_kernel", g.code, re.M)


def test_aot_warm_start_without_nvcc(card, tmp_path):
    from libxsmm_torch import aot, native
    from libxsmm_torch.kernels import _build
    from libxsmm_torch.scripts.aot_warm import cold_start
    kern = xp.dispatch_gemm_batched_packed(xp.GemmShape(32, 32, 32),
                                           xp.GemmFlags.BETA_0)
    a = torch.randn(64, 32, 128, device=card)
    store = native.PersistentKv(tmp_path / "aot.xkv")
    key = aot.export_kernel(kern, (a, a), store)
    res = cold_start(tmp_path / "aot.xkv", key, 64, tmp_path / "copy")
    assert res["normf_rel"] <= 1e-5
    assert res["restored"] == [_build.library_path("gemm_kernels").name]
    assert res["build_log"] == []
    assert (tmp_path / "copy" / "libxsmm_torch" / "kernels" / "build"
            / res["restored"][0]).read_bytes() == _build.library_path(
                "gemm_kernels").read_bytes()
