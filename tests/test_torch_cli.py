"""The port's xsmm-gen CLI (libxsmm_torch.utils.cli, --device cpu) against
the JAX package's (libxsmm_tpu.utils.cli): tests/test_cli.py's three tests,
each run through both with the same manifest or arguments. The kernel
counts, the kernel names, the return codes of the refusals and the routine
headers agree; the port appends the text of one call (lowering.py) where
the JAX package appends a StableHLO module.
"""

import json
import re

import numpy as np
import torch

from libxsmm_torch.utils import cli as pcli
from libxsmm_tpu.utils import cli as rcli
from libxsmm_tpu.utils.mtx import write_mtx

torch.set_num_threads(1)
CPU = ["--device", "cpu"]


def _both(argv, capsys):
    """(reference rc, its output lines, port rc, its output lines)."""
    rc_ref = rcli.main(list(argv))
    ref = capsys.readouterr().out.splitlines()
    rc_port = pcli.main(list(argv) + CPU)
    port = capsys.readouterr().out.splitlines()
    return rc_ref, ref, rc_port, port


def test_cli_manifest(tmp_path, capsys):
    manifest = {
        "gemm": [{"m": 8, "n": 8, "k": 8, "dtype": "f32", "beta": 0},
                 {"m": 8, "n": 8, "k": 8, "dtype": "f32", "beta": 1,
                  "br": 2},
                 {"m": 8, "n": 8, "k": 8, "dtype": "f32", "beta": 0,
                  "batch": 4}],
        "eltwise": [{"op": "RELU", "kind": "unary", "m": 8, "n": 8},
                    {"op": "ADD", "kind": "binary", "m": 8, "n": 8}],
    }
    p = tmp_path / "m.json"
    p.write_text(json.dumps(manifest))
    rc_ref, ref, rc_port, port = _both([str(p)], capsys)
    assert rc_ref == rc_port == 0
    assert port == ref                 # the same kernel names, in order
    assert "xsmm-gen: 5 kernels compiled" in port
    assert "gemm xsmm_gemm_f32f32f32_nn_8x8x8_beta0" in port
    # --bench on the CPU: the host clock
    assert pcli.main([str(p), "--bench"] + CPU) == 0
    out = capsys.readouterr().out
    assert len(re.findall(r" GF/s$", out, re.M)) == 3
    assert len(re.findall(r" GB/s$", out, re.M)) == 2


def test_cli_spgemm_mtx(tmp_path, capsys):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((24, 16)).astype(np.float32)
    a[rng.random((24, 16)) > 0.3] = 0.0
    mtx = tmp_path / "op.mtx"
    write_mtx(str(mtx), a)
    # bcsc needs block-aligned dims: a second 64x64 operand
    ab = rng.standard_normal((64, 64)).astype(np.float32)
    ab[rng.random((64, 64)) > 0.3] = 0.0
    mtxb = tmp_path / "opb.mtx"
    write_mtx(str(mtxb), ab)
    manifest = tmp_path / "m.json"
    manifest.write_text(json.dumps({"spgemm": [
        {"kind": "fsspmdm", "mtx": str(mtx), "n": 64},
        {"kind": "csr_areg", "mtx": str(mtx), "n": 64},
        {"kind": "csc", "mtx": str(mtx), "m": 16},
        {"kind": "bcsc", "mtx": str(mtxb), "m": 128, "bk": 32, "bn": 32},
    ]}))
    rc_ref, ref, rc_port, port = _both([str(manifest)], capsys)
    assert rc_ref == rc_port == 0
    assert "xsmm-gen: 4 kernels compiled" in port and ref[-1] == port[-1]
    # the same matrices: the same kinds, shapes and counts of nonzeros
    for want, got in zip(ref, port):
        assert got.split(" ")[0] == want.split(" ")[0]
        assert re.findall(r"nnz=\d+|nblocks=\d+|\d+x\d+x\d+", got) == \
            re.findall(r"nnz=\d+|nblocks=\d+|\d+x\d+x\d+", want)
    assert port[0].startswith("fsspmdm 24x64x16")
    assert pcli.main([str(manifest), "--bench"] + CPU) == 0
    assert len(re.findall(r" Gnnz/s$", capsys.readouterr().out, re.M)) == 4


def _headers(path):
    return re.findall(r"^(?://|;;) routine: \S+", open(path).read(), re.M)


def test_cli_driver_positional_form(tmp_path, capsys):
    """The reference generator driver's 17-positional-arg form: dense and
    dense_asm append labeled text; the sparse modes read .mtx; the
    alpha/beta and row-major ld contracts refuse with rc 1 in both."""
    rng = np.random.default_rng(9)
    a = ((rng.random((8, 12)) < 0.4)
         * rng.standard_normal((8, 12))).astype(np.float32)
    mtx = str(tmp_path / "a.mtx")
    write_mtx(mtx, a)
    b = ((rng.random((12, 16)) < 0.4)
         * rng.standard_normal((12, 16))).astype(np.float32)
    mtxb = str(tmp_path / "b.mtx")
    write_mtx(mtxb, b)
    for sub in ("ref", "port"):
        (tmp_path / sub).mkdir()

    def run(sub_args, files=()):
        """Both CLIs on the same arguments, each into its own directory;
        their return codes."""
        codes = []
        for sub, main, extra in (("ref", rcli.main, []),
                                 ("port", pcli.main, CPU)):
            argv = [str(tmp_path / sub / a_) if a_ in files else a_
                    for a_ in sub_args]
            codes.append(main(argv + extra))
        capsys.readouterr()
        assert codes[0] == codes[1]
        return codes[1]

    assert run(["dense", "drv.c", "g16", "16", "16", "16", "16", "16", "16",
                "1", "0", "0", "0", "noarch", "nopf", "SP"], {"drv.c"}) == 0
    text = open(tmp_path / "port" / "drv.c").read()
    assert "// routine: g16  arch: cpu  kind: gemm" in text
    assert "aten.mm.default(float32[16, 16], float32[16, 16])" in text
    assert run(["dense_asm", "drv.s", "g8", "8", "8", "8", "8", "8", "8",
                "1", "1", "0", "0", "noarch", "nopf", "SP"], {"drv.s"}) == 0
    assert open(tmp_path / "port" / "drv.s").read().startswith(
        ";; routine: g8")
    for mode in ("sparse", "sparse_csr", "sparse_csr_reg"):
        assert run([mode, "sp.c", f"k_{mode}", "8", "16", "12", "0", "12",
                    "16", "1", "0", "0", "0", "noarch", "nopf", "SP", mtx],
                   {"sp.c"}) == 0
    # B-sparse routing: ldb < 1 marks B as the sparse operand (k, n) mtx
    assert run(["sparse", "sp.c", "k_bsp", "8", "16", "12", "12", "0", "16",
                "1", "0", "0", "0", "noarch", "nopf", "SP", mtxb],
               {"sp.c"}) == 0
    assert _headers(tmp_path / "port" / "sp.c") == _headers(
        tmp_path / "ref" / "sp.c")
    assert len(_headers(tmp_path / "port" / "sp.c")) == 4
    # both lds < 1 is ambiguous
    assert run(["sparse", "sp.c", "k", "8", "16", "12", "0", "0", "16", "1",
                "0", "0", "0", "noarch", "nopf", "SP", mtxb], {"sp.c"}) == 1
    # contract violations exit 1 without writing
    for bad in (["dense", "bad.c", "g", "8", "8", "8", "8", "8", "8", "2",
                 "0", "0", "0", "noarch", "nopf", "SP"],
                ["dense", "bad.c", "g", "8", "8", "8", "9", "8", "8", "1",
                 "0", "0", "0", "noarch", "nopf", "SP"],
                ["sparse", "bad.c", "g", "8", "8", "8", "0", "8", "8", "1",
                 "0", "0", "0", "noarch", "nopf", "SP"],
                ["dense", "bad.c", "g", "8", "8", "8", "8", "8", "8", "1",
                 "0", "0", "0", "noarch", "nopf", "QP"],
                ["dense", "bad.c", "g"]):
        assert run(bad, {"bad.c"}) == 1
    assert not (tmp_path / "port" / "bad.c").exists()
    # ARCH: the port's names retarget, others print the notice and
    # auto-detect
    import libxsmm_torch as xp
    try:
        assert pcli.main(["dense", str(tmp_path / "h.c"), "h", "8", "8", "8",
                          "8", "8", "8", "1", "0", "0", "0", "h100", "nopf",
                          "SP"] + CPU) == 0
        assert "arch: h100" in open(tmp_path / "h.c").read()
    finally:
        xp.set_target(None)
    assert pcli.main(["dense", str(tmp_path / "x.c"), "x", "8", "8", "8",
                      "8", "8", "8", "1", "0", "0", "0", "skx", "nopf",
                      "SP"] + CPU) == 0
    err = capsys.readouterr().err
    assert "ARCH 'skx' is not a target of this port" in err
    assert "arch: cpu" in open(tmp_path / "x.c").read()
