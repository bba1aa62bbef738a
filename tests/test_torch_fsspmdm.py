"""fsspmdm: the port (`libxsmm_torch.ops.fsspmdm`) against the JAX package on
the same numpy inputs, on the CPU (device="cpu"): the reference tests of
tests/test_sparse.py:264-330, :439, :637, :672 and :775, the typed
wrappers, and the persisted ratio history read across the two packages.

Where a test pins the autotuner's decision it replaces `_bench_candidates`
with scripted measurements, as the reference's tests do; elsewhere each
package times its own candidates and the results are held against each
other and against float64, whichever candidate won.

Tolerances (matdiff normf_rel): 1e-12 for f64 handles (the reference's
1e-10 and 1e-9 against its numpy oracle, tightened: both sums run in
f64), 1e-5 for f32 (sums in another order).
"""

import numpy as np
import pytest
import torch

import libxsmm_torch as xp
from libxsmm_torch.config import CONFIG as PCONFIG
from libxsmm_torch.matdiff import check
from libxsmm_torch.ops import fsspmdm as pf
from libxsmm_tpu.config import CONFIG as RCONFIG
from libxsmm_tpu.dtypes import Datatype
from libxsmm_tpu.ops import fsspmdm as rf

torch.set_num_threads(1)


def sparse_dense(rng, m, k, density):
    a = rng.standard_normal((m, k)).astype(np.float32)
    a[rng.random((m, k)) >= density] = 0.0
    return a


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture
def no_hint(monkeypatch):
    monkeypatch.delenv("XSMM_TPU_FSSPMDM_HINT", raising=False)
    for cfg in (PCONFIG, RCONFIG):
        monkeypatch.setattr(cfg, "fsspmdm_hint", 0)
        monkeypatch.setattr(cfg, "fsspmdm_ntune", 25)


def test_auto_f64(no_hint):
    m, k, n = 25, 27, 96
    rng = np.random.default_rng(1)
    a = sparse_dense(rng, m, k, 0.2).astype(np.float64)
    b = rng.standard_normal((k, n))
    h = pf.fsspmdm_create(n, a, device="cpu")
    assert h.kind in ("dense", "sparse")
    assert h.nnz == np.count_nonzero(a) == rf.fsspmdm_create(n, a).nnz
    assert set(h.tuned_us) >= {"dense_us", "sparse_us", "ratio_history"}
    got = h.execute(t(b))
    assert got.dtype == torch.float64
    want = np.asarray(rf.fsspmdm_create(n, a).execute(b))
    check(want, got.numpy(), margin=1e-12)
    check(a @ b, got.numpy(), margin=1e-12)
    pf.fsspmdm_destroy(h)
    assert h.kernel is None


@pytest.mark.parametrize("hint", [1, 2])
def test_alpha_beta(monkeypatch, hint):
    monkeypatch.setenv("XSMM_TPU_FSSPMDM_HINT", str(hint))
    m, k, n = 10, 12, 32
    rng = np.random.default_rng(2)
    a = sparse_dense(rng, m, k, 0.3)
    b = rng.standard_normal((k, n)).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)
    h = pf.fsspmdm_create(n, a, alpha=-2.0, beta=1, device="cpu")
    r = rf.fsspmdm_create(n, a, alpha=-2.0, beta=1)
    assert h.kind == r.kind == ("sparse" if hint == 1 else "dense")
    got = pf.fsspmdm_execute(h, t(b), t(c))
    check(np.asarray(rf.fsspmdm_execute(r, b, c)), got.numpy(), margin=1e-5)
    check(-2.0 * (a.astype(np.float64) @ b) + c, got.numpy(), margin=1e-5)
    with pytest.raises(ValueError, match="beta=1"):
        h.execute(t(b))


def test_hint_override(monkeypatch):
    m, k, n = 8, 8, 16
    a = sparse_dense(np.random.default_rng(3), m, k, 0.3)
    monkeypatch.delenv("XSMM_TPU_FSSPMDM_HINT", raising=False)
    monkeypatch.setattr(PCONFIG, "fsspmdm_hint", 1)
    assert pf.fsspmdm_create(n, a, device="cpu").kind == "sparse"
    monkeypatch.setattr(PCONFIG, "fsspmdm_hint", 2)
    assert pf.fsspmdm_create(n, a, device="cpu").kind == "dense"
    # the env, read at create, wins over the import-time config
    monkeypatch.setenv("XSMM_TPU_FSSPMDM_HINT", "1")
    assert pf.fsspmdm_create(n, a, device="cpu").kind == "sparse"


def test_bad_beta_and_empty_operator():
    with pytest.raises(ValueError, match="beta"):
        pf.fsspmdm_create(8, np.ones((4, 4), np.float32), beta=2,
                          device="cpu")
    h = pf.fsspmdm_create(8, np.zeros((4, 5), np.float32), device="cpu")
    assert h.kind == "dense" and h.nnz == 0 and h.tuned_us == {}
    assert bool((h(torch.ones(5, 8)) == 0).all())


def test_autotune_cache(tmp_path, monkeypatch, no_hint):
    monkeypatch.setattr(PCONFIG, "autotune_cache_path",
                        str(tmp_path / "tune.xkv"))
    if pf._autotune_cache() is None:
        pytest.skip("native KV unavailable")
    m, k, n = 8, 8, 32
    rng = np.random.default_rng(4)
    a = sparse_dense(rng, m, k, 0.3)
    h1 = pf.fsspmdm_create(n, a, device="cpu")
    assert "cached" not in h1.tuned_us
    h2 = pf.fsspmdm_create(n, a, device="cpu")   # the same matrix: history
    assert h2.tuned_us.get("cached") is True
    assert len(h2.tuned_us["ratio_history"]) == 2
    b = rng.standard_normal((k, n)).astype(np.float32)
    check(a.astype(np.float64) @ b, h2.execute(t(b)).numpy(), margin=1e-5)


@pytest.mark.parametrize("p", [2, 3])
def test_spectral_element_operators(p, no_hint):
    """The north-star workload on the synthetic PyFR-class operators (the
    port's copy of testmats equals the reference's)."""
    from libxsmm_torch.utils import testmats as pt
    from libxsmm_tpu.utils import testmats as rt
    n = 192
    rng = np.random.default_rng(p)
    for op, rop in ((pt.hex_derivative_operator(p, axis=1),
                     rt.hex_derivative_operator(p, axis=1)),
                    (pt.hex_interp_operator(p), rt.hex_interp_operator(p))):
        np.testing.assert_array_equal(op, rop)
        assert np.count_nonzero(op) / op.size < 0.6
        b = rng.standard_normal((op.shape[1], n))
        got = pf.fsspmdm_create(n, op, device="cpu").execute(t(b)).numpy()
        want = np.asarray(rf.fsspmdm_create(n, op).execute(b))
        check(want, got, margin=1e-12)
        check(op @ b, got, margin=1e-12)
    assert not pt.have_reference_pyfr_mats()
    assert not pt.have_reference_edge_mats()


def fake_bencher(mod, monkeypatch, script):
    """Replace mod._bench_candidates with scripted (dense_us, sparse_us)
    measurements; returns the candidate counts of the calls made."""
    calls = []

    def fake_bench(cands, reps, rounds=3, **kw):
        calls.append(len(cands))
        times = script.pop(0)
        return times, times[0] / times[1]

    monkeypatch.setattr(mod, "_bench_candidates", fake_bench)
    return calls


@pytest.fixture
def tune_log(tmp_path, monkeypatch, no_hint):
    path = str(tmp_path / "autotune.kv")
    for cfg in (PCONFIG, RCONFIG):
        monkeypatch.setattr(cfg, "autotune_cache_path", path)
    if pf._autotune_cache() is None or rf._autotune_cache() is None:
        pytest.skip("native KV unavailable")
    return path


def test_autotune_history_recovers(tune_log, monkeypatch):
    """tests/test_sparse.py:637: a distorted first measurement is outvoted
    as honest ones accumulate in the persisted history."""
    calls = fake_bencher(pf, monkeypatch, [[100.0, 1000.0], [100.0, 50.0],
                                           [100.0, 50.0]])
    a = sparse_dense(np.random.default_rng(5), 16, 12, 0.3)
    h1 = pf.fsspmdm_create(8, a, device="cpu")
    assert h1.kind == "dense"
    h2 = pf.fsspmdm_create(8, a, device="cpu")
    assert h2.tuned_us.get("cached") and h2.kind == "sparse"
    h3 = pf.fsspmdm_create(8, a, device="cpu")
    assert h3.kind == "sparse"
    assert h3.tuned_us["ratio_history"] == [0.1, 2.0, 2.0]
    assert calls == [2, 2, 2]


def test_autotune_drought_replay(tune_log, monkeypatch):
    """tests/test_sparse.py:672: one drought draw does not flip a persisted
    sparse pick; a genuine regime change does, through the capped
    history's median."""
    fake_bencher(pf, monkeypatch, [[130.0, 100.0]] * 3 + [[80.0, 100.0]]
                 + [[130.0, 100.0]])
    a = sparse_dense(np.random.default_rng(6), 16, 12, 0.3)
    kinds = [pf.fsspmdm_create(8, a, device="cpu").kind for _ in range(5)]
    assert kinds == ["sparse"] * 5
    fake_bencher(pf, monkeypatch, [[80.0, 100.0]] * 4)
    kinds2 = [pf.fsspmdm_create(8, a, device="cpu").kind for _ in range(4)]
    assert kinds2[-1] == "dense"


def test_history_cap(tune_log, monkeypatch):
    fake_bencher(pf, monkeypatch, [[130.0, 100.0]] * 12)
    a = sparse_dense(np.random.default_rng(7), 12, 10, 0.3)
    for _ in range(12):
        h = pf.fsspmdm_create(8, a, device="cpu")
    assert len(h.tuned_us["ratio_history"]) == 9


@pytest.mark.parametrize("first", ["reference", "port"])
def test_history_shared_across_packages(tune_log, monkeypatch, first):
    """One key and one value format: a history written by one package's
    create is read and extended by the other's."""
    a = sparse_dense(np.random.default_rng(8), 16, 12, 0.3)
    mods = (rf, pf) if first == "reference" else (pf, rf)
    fake_bencher(mods[0], monkeypatch, [[100.0, 1000.0]])
    fake_bencher(mods[1], monkeypatch, [[100.0, 50.0]])
    kw = [{}, {"device": "cpu"}]
    if first == "port":
        kw.reverse()
    h1 = mods[0].fsspmdm_create(8, a, **kw[0])
    h2 = mods[1].fsspmdm_create(8, a, **kw[1])
    assert "cached" not in h1.tuned_us and h1.kind == "dense"
    assert h2.tuned_us.get("cached") is True
    assert h2.tuned_us["ratio_history"] == [0.1, 2.0]
    assert h2.kind == "sparse"


def test_declared_dtype_applied():
    """tests/test_sparse.py:775: an explicit dtype governs the stored A."""
    m, k, n = 12, 16, 32
    rng = np.random.default_rng(9)
    a32 = sparse_dense(rng, m, k, 0.3)
    b = rng.standard_normal((k, n))
    for hint in ("1", "2"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("XSMM_TPU_FSSPMDM_HINT", hint)
            h = pf.fsspmdm_create(n, a32, dtype=xp.Datatype.F64, device="cpu")
            out = h.execute(t(b))
            assert out.dtype == torch.float64
            check(a32.astype(np.float64) @ b, out.numpy(), margin=1e-12)
            h2 = pf.fsspmdm_create(n, a32.astype(np.float64),
                                   dtype=xp.Datatype.F32, device="cpu")
            out2 = h2.execute(t(b.astype(np.float32)))
            assert out2.dtype == torch.float32
            r2 = rf.fsspmdm_create(n, a32.astype(np.float64),
                                   dtype=Datatype.F32)
            check(np.asarray(r2.execute(b.astype(np.float32))),
                  out2.numpy(), margin=1e-5)


def test_typed_wrappers(monkeypatch):
    monkeypatch.setenv("XSMM_TPU_FSSPMDM_HINT", "1")
    m, k, n = 6, 9, 16
    rng = np.random.default_rng(10)
    a = sparse_dense(rng, m, k, 0.4)
    b = rng.standard_normal((k, n))
    c = rng.standard_normal((m, n))
    hd = xp.dfsspmdm_create(n, a, beta=1, device="cpu")
    got = xp.dfsspmdm_execute(hd, t(b), t(c))
    assert got.dtype == torch.float64
    check(np.asarray(rf.dfsspmdm_execute(rf.dfsspmdm_create(n, a, beta=1),
                                         b, c)), got.numpy(), margin=1e-12)
    hs = xp.sfsspmdm_create(n, a, device="cpu")
    got_s = xp.sfsspmdm_execute(hs, t(b))        # a f64 tensor, cast to f32
    assert got_s.dtype == torch.float32
    check(a.astype(np.float64) @ b, got_s.numpy(), margin=1e-5)
    xp.dfsspmdm_destroy(hd)
    xp.sfsspmdm_destroy(hs)
    assert hd.kernel is None and hs.kernel is None


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xp.fsspmdm_create(8, np.eye(4, dtype=np.float32))
