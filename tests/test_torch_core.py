"""Parity of libxsmm_torch's core modules with libxsmm_tpu's, on the CPU:
dtypes, descriptors (names, hashes, constructors), the registry (hits,
builds, LRU eviction, stats, the user KV registry), matdiff, config,
device, tracing, timing and interop.
"""

import dataclasses
import importlib
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import libxsmm_torch as xp
import libxsmm_tpu as xt
from libxsmm_torch import config as p_config
from libxsmm_torch import descriptor as pd
from libxsmm_torch import device as p_device
from libxsmm_torch import interop
from libxsmm_torch import registry as p_reg
from libxsmm_tpu import config as r_config
from libxsmm_tpu import descriptor as rd
from libxsmm_tpu import device as r_device
from libxsmm_tpu import dtypes as r_dtypes
from libxsmm_tpu import registry as r_reg

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RNG = np.random.default_rng(77)

# the packages export a function named matdiff, which shadows the module
p_md = importlib.import_module("libxsmm_torch.matdiff")
r_md = importlib.import_module("libxsmm_tpu.matdiff")


def port(obj):
    return interop.descriptor_from_fields(interop.descriptor_fields(obj))


# ---------------------------------------------------------------------------
# dtypes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("member", list(r_dtypes.Datatype),
                         ids=lambda d: d.value)
def test_datatype_parity(member):
    pm = xp.Datatype[member.name]
    assert pm.value == member.value and repr(pm) == repr(member)
    assert xp.get_typename(pm) == xt.get_typename(member)
    if member in r_dtypes._BITS:
        from libxsmm_torch.dtypes import bits, itemsize, typesize
        assert bits(pm) == r_dtypes.bits(member)
        assert itemsize(pm) == r_dtypes.itemsize(member)
        assert typesize(pm) == r_dtypes.typesize(member)
    if r_dtypes.is_native(member):
        tdt = xp.to_torch(pm)
        assert tdt.itemsize == np.dtype(r_dtypes.to_jnp(member)).itemsize
        name = np.dtype(r_dtypes.to_jnp(member)).name
        assert str(tdt) == f"torch.{name}"
        if member != r_dtypes.Datatype.BF32:
            assert xp.from_torch(tdt) == pm
    else:
        with pytest.raises(ValueError):
            r_dtypes.to_jnp(member)
        with pytest.raises(ValueError):
            xp.to_torch(pm)


# ---------------------------------------------------------------------------
# descriptors
# ---------------------------------------------------------------------------

def _ref_descriptors():
    D = rd
    shapes = [D.GemmShape(13, 5, 7),
              D.GemmShape(32, 32, 32, r_dtypes.Datatype.BF16,
                          r_dtypes.Datatype.BF16, r_dtypes.Datatype.F32),
              D.GemmShape(8, 8, 8, r_dtypes.Datatype.F64,
                          r_dtypes.Datatype.F64, r_dtypes.Datatype.F64),
              D.GemmShape(16, 16, 64, r_dtypes.Datatype.I8,
                          r_dtypes.Datatype.I8, r_dtypes.Datatype.I32,
                          comp_type=r_dtypes.Datatype.F32)]
    flags = [D.GemmFlags.NONE, D.GemmFlags.BETA_0,
             D.GemmFlags.BETA_0 | D.GemmFlags.TRANS_A,
             D.GemmFlags.TRANS_AB | D.GemmFlags.VNNI_A | D.GemmFlags.VNNI_C,
             D.GemmFlags.ALIGN_C_NTS_HINT]
    brs = [D.BatchReduceConfig(),
           D.BatchReduceConfig(D.BatchReduceType.STRIDE, 16),
           D.BatchReduceConfig(D.BatchReduceType.ADDRESS, 3),
           D.BatchReduceConfig(D.BatchReduceType.OFFSET)]
    out = []
    for i, s in enumerate(shapes):
        for j, f in enumerate(flags):
            out.append(D.GemmDescriptor(s, f, brs[(i + j) % len(brs)]))
    out.append(D.GemmExtDescriptor(
        out[1], D.UnaryArgops(cp_type=D.UnaryType.GELU,
                              cp_flags=D.UnaryFlags.BITMASK_2BYTEMULT),
        D.BinaryPostops(d_type=D.BinaryType.ADD,
                        d_flags=D.BinaryFlags.BCAST_ROW_IN_1)))
    out.append(D.meltw_descriptor_init2(
        r_dtypes.Datatype.F32, None, None, r_dtypes.Datatype.F32,
        r_dtypes.Datatype.BF16, 8, 16, flags=2,
        op_type=D.UnaryType.RELU))
    out.append(D.meltw_descriptor_init2(
        r_dtypes.Datatype.F32, r_dtypes.Datatype.F32, None,
        r_dtypes.Datatype.F32, r_dtypes.Datatype.F32, 4, 4, flags=1,
        op_type=D.BinaryType.ADD, operation="binary"))
    return out


REF_DESCS = _ref_descriptors()


@pytest.mark.parametrize("i", range(len(REF_DESCS)))
def test_descriptor_name_hash_parity(i):
    ref = REF_DESCS[i]
    got = port(ref)
    assert type(got).__name__ == type(ref).__name__
    assert got.name() == ref.name()
    assert hash(got) == hash(ref)                 # same fields, same hash
    assert got == port(ref) and hash(got) == hash(port(ref))
    assert interop.descriptor_fields(got) == interop.descriptor_fields(ref)
    if isinstance(ref, rd.GemmDescriptor):
        assert (got.beta, got.trans_a, got.trans_b) == (
            ref.beta, ref.trans_a, ref.trans_b)
        assert got.shape.nflops(3) == ref.shape.nflops(3)


def test_enum_parity():
    for name in ("GemmFlags", "BatchReduceType", "UnaryFlags", "UnaryType",
                 "BinaryFlags", "BinaryType", "TernaryFlags", "TernaryType"):
        r, p = getattr(rd, name), getattr(pd, name)
        assert [(m.name, m.value) for m in r] == [(m.name, m.value) for m in p]
        assert ({k: v.value for k, v in r.__members__.items()}
                == {k: v.value for k, v in p.__members__.items()})


@pytest.mark.parametrize("call", [
    ("create_gemm_shape", (16, 8, 4), {}),
    ("create_gemm_shape", (16, 8, 4, 4, 8, 8), {}),
    ("create_gemm_shape", (16, 8, 4, 16), {}),            # lda=m: rejected
    ("create_gemm_shape", (16, 8, 4), {"out_type": "bf16", "comp_type": "f32"}),
    ("create_gemm_batch_reduce_config", (4, 0, 0, 8), {}),
    ("create_gemm_ext_unary_argops", (), {"cp_unary_type": 5,
                                          "store_cp": True}),
    ("create_gemm_ext_binary_postops", (), {"d_binary_type": 1,
                                            "d_binary_flags": 2}),
    ("create_meltw_unary_shape", (8, 16, 16, 8), {}),
    ("create_meltw_unary_shape", (8, 16, 3), {}),         # ldi: rejected
    ("create_meltw_binary_shape", (8, 16), {"in1_type": "bf16"}),
    ("create_meltw_ternary_shape", (8, 16), {"ldo": 1}),
    ("gemm_descriptor_init", ("f32", "f32", "f32", "f32", 8, 8, 8),
     {"flags": 4}),
    ("meltw_descriptor_init", ("f32", "f32", 8, 8), {"op_type": None}),
    ("meqn_descriptor_init", ("f32", 4, 4), {"eqn_idx": 3}),
])
def test_constructor_parity(call):
    name, args, kw = call

    def run(mod):
        conv = {}
        for key, v in kw.items():
            conv[key] = v
        try:
            return getattr(mod, name)(*args, **conv), None
        except ValueError as e:
            return None, str(e)

    rv, re_ = run(rd)
    pv, pe = run(pd)
    assert re_ == pe
    if rv is None:
        return
    if dataclasses.is_dataclass(rv):
        assert port(rv) == pv
        if hasattr(rv, "name"):
            assert rv.name() == pv.name()
    else:
        assert tuple(x.value if hasattr(x, "value") else x for x in rv) == \
            tuple(x.value if hasattr(x, "value") else x for x in pv)


def test_descriptor_init_family_parity():
    s = rd.GemmShape(8, 4, 2)
    cfg = rd.BatchReduceConfig(rd.BatchReduceType.STRIDE, 2)
    pairs = [
        (rd.gemm_descriptor_init_gemm(s, rd.GemmFlags.BETA_0),
         pd.gemm_descriptor_init_gemm(port(s), pd.GemmFlags.BETA_0)),
        (rd.gemm_descriptor_init_brgemm(s, rd.GemmFlags.NONE, cfg),
         pd.gemm_descriptor_init_brgemm(port(s), pd.GemmFlags.NONE,
                                        port(cfg))),
        (rd.gemm_descriptor_init_brgemm_ext(s, rd.GemmFlags.NONE, cfg),
         pd.gemm_descriptor_init_brgemm_ext(port(s), pd.GemmFlags.NONE,
                                            port(cfg))),
    ]
    for r, p in pairs:
        assert port(r) == p and r.name() == p.name() and hash(r) == hash(p)
    with pytest.raises(ValueError):
        pd.meltw_descriptor_init2("f32", None, None, "f32", "f32", 4, 4)
    with pytest.raises(ValueError):
        pd.meltw_descriptor_init2("f32", None, None, "f32", "f32", 4, 4,
                                  op_type=pd.UnaryType.RELU,
                                  operation="quaternary")


def test_sparse_pattern_fingerprint_parity():
    idx = np.arange(12, dtype=np.int32)
    vals = RNG.standard_normal(12).astype(np.float32)
    assert (pd.SparsePattern.fingerprint_of(idx, values=vals)
            == rd.SparsePattern.fingerprint_of(idx, values=vals))
    ref = rd.SparsePattern("bcsc", 64, 64, 12, 99, (8, 8))
    assert port(ref) == pd.SparsePattern("bcsc", 64, 64, 12, 99, (8, 8))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _drive_registry(mod, desc_mod, evict, capacity):
    """One sequence of registry operations; returns what it observed."""
    cfg = mod.CONFIG
    saved = (cfg.registry_evict, cfg.registry_capacity, cfg.cache_enabled)
    cfg.registry_evict, cfg.registry_capacity = evict, capacity
    cfg.cache_enabled = True
    try:
        reg = mod.Registry()

        def build(d):
            return mod.Kernel(fn=lambda: d.name(), descriptor=d,
                              info=mod.KernelInfo(kind="gemm",
                                                  nflops=d.shape.nflops(),
                                                  is_reference_kernel=(
                                                      d.shape.m == 5)),
                              name=d.name())

        seen = []
        descs = [desc_mod.GemmDescriptor(desc_mod.GemmShape(m, m, m))
                 for m in (4, 5, 30, 4, 70, 5, 30)]
        for d in descs:
            k = reg.dispatch(d, build)
            seen.append((k.name, k() == d.name()))
        reg.release(descs[0])
        seen.append(reg.dispatch(descs[0], build).name)
        # memo_dispatch: repeat keys hit the per-thread memo
        for _ in range(3):
            mod.memo_dispatch(reg, ("memo", 9), lambda: desc_mod.GemmDescriptor(
                desc_mod.GemmShape(9, 9, 9)), build)
        reg.xregister(b"key-a", 1)
        reg.xregister(b"key-b", {"x": 2})
        with pytest.raises(KeyError):
            reg.xregister(b"key-a", 3)
        with pytest.raises(TypeError):
            reg.xregister("not-bytes", 3)
        it = reg.items()
        walked = []
        entry = next(it, None)
        while entry is not None:
            walked.append(entry)
            entry = next(it, None)
        reg.xrelease(b"key-a")
        info = reg.get_registry_info()
        buckets = sorted((kind, str(dt), b) + (c,) for (kind, dt, b), c in
                         reg._stats.by_bucket.items())
        return seen, walked, reg.xdispatch(b"key-b"), info, buckets
    finally:
        (cfg.registry_evict, cfg.registry_capacity,
         cfg.cache_enabled) = saved


@pytest.mark.parametrize("evict,capacity", [(False, 131072), (True, 2),
                                            (False, 2)])
def test_registry_parity(evict, capacity):
    ref = _drive_registry(r_reg, rd, evict, capacity)
    got = _drive_registry(p_reg, pd, evict, capacity)
    assert got == ref
    if evict:
        assert got[3]["evictions"] > 0
    assert got[3]["hits"] > 0 and got[3]["fallbacks"] > 0


def test_registry_module_functions(capsys):
    for mod in (r_reg, p_reg):
        mod.finalize()
        reg = mod.init()
        assert mod.get_registry() is reg is mod.init()
        reg.xregister(b"k", 7)
        it = mod.get_registry_begin()
        assert mod.get_registry_next(it) == (b"k", 7)
        assert mod.get_registry_next(it) is None
        reg.print_statistic()
        reg.clear()
        assert reg.get_registry_info()["nuser"] == 0
        mod.finalize()
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace("libxsmm_tpu", "libxsmm_torch") == out[1]
    k = xp.dispatch_gemm(xp.GemmShape(8, 8, 8), xp.GemmFlags.BETA_0)
    assert xp.get_kernel_info(k).nflops == 2 * 8 ** 3
    assert xp.get_mmkernel_info(k).kind == "gemm"
    with pytest.raises(ValueError):
        xp.get_meltwkernel_info(k)
    xp.xregister(b"port-key", 1)
    assert xp.xdispatch(b"port-key") == 1
    xp.xclear()
    assert xp.xdispatch(b"port-key") is None
    xp.release_kernel(k)
    assert xp.dispatch_gemm(xp.GemmShape(8, 8, 8),
                            xp.GemmFlags.BETA_0) is not k


# ---------------------------------------------------------------------------
# matdiff
# ---------------------------------------------------------------------------

def _md_cases():
    a = RNG.standard_normal((7, 5))
    b = a + 1e-3 * RNG.standard_normal((7, 5))
    nan_t = b.copy()
    nan_t[2, 3] = np.nan
    inf_r = a.copy()
    inf_r[1, 1] = np.inf
    inf_both = inf_r.copy()
    return [(a, b), (a, a), (a, nan_t), (inf_r, b), (inf_r, inf_both),
            (np.zeros((3, 3)), np.ones((3, 3))), (a[0], b[0]),
            (np.float64(2.0), np.float64(2.5)), (a.reshape(5, 7, 1), b.reshape(
                5, 7, 1))]


def _fields(info):
    return [(f.name, getattr(info, f.name))
            for f in dataclasses.fields(info)]


def _same_fields(ref, got):
    for (name, rv), (_, gv) in zip(_fields(ref), _fields(got)):
        if isinstance(rv, float) and math.isnan(rv):
            assert math.isnan(gv), name
        else:
            assert rv == gv, name


@pytest.mark.parametrize("i", range(len(_md_cases())))
def test_matdiff_parity(i):
    ref_in, tst_in = _md_cases()[i]
    r, g = r_md.matdiff(ref_in, tst_in), p_md.matdiff(ref_in, tst_in)
    _same_fields(r, g)
    assert r.epsilon() == g.epsilon() or (math.isnan(r.epsilon())
                                          and math.isnan(g.epsilon()))
    assert r_md.matdiff_epsilon(r) == p_md.matdiff_epsilon(g) or math.isnan(
        r.epsilon())
    for margin in (None, 1e-6, 1e-2):
        ok_r = ok_g = True
        try:
            r_md.check(ref_in, tst_in, margin=margin)
        except AssertionError:
            ok_r = False
        try:
            p_md.check(ref_in, tst_in, margin=margin)
        except AssertionError:
            ok_g = False
        assert ok_r == ok_g


def test_matdiff_reduce_clear_and_tensors():
    r_acc, g_acc = r_md.matdiff_clear(), p_md.matdiff_clear()
    _same_fields(r_acc, g_acc)
    for ref_in, tst_in in _md_cases()[:4]:
        r_md.matdiff_reduce(r_acc, r_md.matdiff(ref_in, tst_in))
        p_md.matdiff_reduce(g_acc, p_md.matdiff(ref_in, tst_in))
        _same_fields(r_acc, g_acc)
    assert p_md.DEFAULT_MARGINS == r_md.DEFAULT_MARGINS
    # torch tensors of any dtype are read through host float64
    a = RNG.standard_normal((4, 6)).astype(np.float32)
    t = torch.from_numpy(a).to(torch.bfloat16)
    _same_fields(r_md.matdiff(a, np.asarray(jnp.asarray(a, jnp.bfloat16),
                                             np.float64)),
                 p_md.matdiff(torch.from_numpy(a), t))
    with pytest.raises(ValueError):
        p_md.matdiff(np.zeros(3), np.zeros(4))


# ---------------------------------------------------------------------------
# config, device, tracing, timing
# ---------------------------------------------------------------------------

def test_config_env_parity(monkeypatch):
    env = {"XSMM_TPU_VERBOSE": "2", "XSMM_TPU_CACHE": "0",
           "XSMM_TPU_FALLBACK": "0", "XSMM_TPU_FSSPMDM_HINT": "2",
           "XSMM_TPU_FSSPMDM_DENSE_BIAS": "0.5", "XSMM_TPU_FSSPMDM_NTUNE": "x",
           "XSMM_TPU_DUMP": "/tmp/d", "XSMM_TPU_AUTOTUNE_CACHE": "kv.log",
           "XSMM_TPU_REGISTRY_CAPACITY": "64", "XSMM_TPU_REGISTRY_EVICT": "1",
           "XSMM_TPU_TARGET": "cpu"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    r, p = r_config.Config.from_env(), p_config.Config.from_env()
    shared = {f.name for f in dataclasses.fields(p)}
    assert shared == {f.name for f in dataclasses.fields(r)} - {
        "interpret", "compilation_cache_dir"}
    for name in shared:
        assert getattr(p, name) == getattr(r, name), name
    prev = xp.set_verbosity(3)
    assert xp.get_verbosity() == 3
    xp.set_verbosity(prev)


def test_device_geometry_and_ids():
    h = p_device.GEOMETRY_TABLE["h100"]
    assert (h.num_sms, h.smem_per_block, h.l2_bytes) == (132, 232448,
                                                         50 * 2 ** 20)
    assert (h.hbm_gbps, h.peak_bf16_tflops, h.peak_f32_tflops) == (
        3350.0, 989.0, 67.0)
    # 201 MB at 3.35 TB/s bounds the 16384 x 32^3 f32 headline by bytes
    nbytes, flops = 3 * 16384 * 32 * 32 * 4, 2 * 16384 * 32 ** 3
    assert h.bound_by(nbytes, flops, h.peak_f32_tflops) == "bytes"
    assert abs(h.bound_ms(nbytes, flops, h.peak_f32_tflops)
               - nbytes / 3.35e12 * 1e3) < 1e-12
    if not torch.cuda.is_available():
        assert xp.get_geometry().name == "cpu"
        assert not xp.on_gpu()
    for name, archid in p_device.ARCHIDS.items():
        assert xp.cpuid_name(archid) == name and xp.cpuid_id(name) == archid
    assert xp.cpuid_id("v5e") == 0
    with pytest.raises(ValueError):
        xp.cpuid_name(1234)
    xp.set_target_archid(9000)
    assert xp.get_target_archid() == 9000 and xp.cpuid() == "h100"
    xp.set_target_archid(None)
    xp.set_target_arch("cpu")
    assert xp.get_target_arch() == "cpu"
    xp.set_target_arch(None)
    with pytest.raises(ValueError):
        xp.set_target_archid(77)
    p_config.set_target("v5e")           # a TPU name is unknown here
    with pytest.raises(ValueError):
        xp.get_geometry()
    p_config.set_target(None)
    assert xp.cpuid_x86() == xp.cpuid_arm() == xp.cpuid_rv64() == 0
    assert xp.cpuid_vlen32() == 32


@pytest.mark.parametrize("arg", [4, 2, 1, "f32", "bf16", "i8", "f64"])
def test_cpuid_dot_pack_factor_parity(arg):
    if isinstance(arg, str):
        r_arg, p_arg = r_dtypes.Datatype(arg), xp.Datatype(arg)
        assert (xp.cpuid_dot_pack_factor(xp.to_torch(p_arg))
                == xt.cpuid_dot_pack_factor(r_dtypes.to_jnp(r_arg)))
    else:
        r_arg = p_arg = arg
    assert xp.cpuid_dot_pack_factor(p_arg) == xt.cpuid_dot_pack_factor(r_arg)


def test_trace_event_and_annotate(tmp_path, monkeypatch):
    from libxsmm_torch.utils import trace
    log = tmp_path / "trace.log"
    monkeypatch.setattr(trace, "_TRACE_SINK", None)
    monkeypatch.setenv("XSMM_TPU_TRACE", str(log))
    trace.trace_event("dispatch_build", "k", build_ms=1.5)
    trace._TRACE_SINK.close()
    line = log.read_text().strip().split()
    assert line[0] == "xsmm_trace" and line[3:] == ["dispatch_build", "k",
                                                    "build_ms=1.5"]
    monkeypatch.setattr(trace, "_TRACE_SINK", False)
    trace.trace_event("dispatch_hit", "k")       # disabled: a no-op
    with trace.annotate("region"):
        pass


def test_bench_chain_refuses_cpu():
    from libxsmm_torch.utils.timer import bench_chain
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_chain(torch.add, (torch.ones(2), torch.ones(2)))


def test_tensor_from_numpy_bits():
    x = RNG.standard_normal((3, 5)).astype(np.float32) * 4
    for r_dt, p_dt in ((jnp.bfloat16, torch.bfloat16),
                       (jnp.float8_e5m2, torch.float8_e5m2),
                       (jnp.float8_e4m3fn, torch.float8_e4m3fn)):
        xj = np.asarray(jnp.asarray(x, r_dt))
        t = interop.tensor_from_numpy(xj, xp.from_torch(p_dt), device="cpu")
        assert t.dtype == p_dt
        np.testing.assert_array_equal(t.float().numpy(),
                                      xj.astype(np.float32))
        # from f32 numpy the conversion rounds to nearest even, like JAX
        t2 = interop.tensor_from_numpy(x, xp.from_torch(p_dt), device="cpu")
        np.testing.assert_array_equal(t2.float().numpy(),
                                      xj.astype(np.float32))
    with pytest.raises(ValueError, match="no descriptor class"):
        interop.descriptor_from_fields({"bogus": 1})
