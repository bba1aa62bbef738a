"""The GEMM acceptance matrix of samples/xgemm.py, run through the port.

`samples/xgemm.py` is the reference's universal GEMM tester
(samples/xgemm/gemm_kernel.c): every dtype combo x BR mode x beta, the
transposes, the VNNI layout contracts, the MX/sub-byte packed operands, the
BRGEMM-ext fusion matrix (argops, postops, bitmask, stochastic-round
store) and the lane-packed fused path. This module keeps the port's own
copy of its class table (`build_class_list`, the same 225 classes in the
same order) and of its per-class runner (`run_class`), on torch tensors on
any device; each class runs at xgemm's random shapes against a float64
oracle with xgemm's margins (samples/xgemm.py:436-444):

  * integer outputs ("exact"): bit-exact;
  * MX classes ("mx4"/"mx6"): normf_rel <= 1e-5 * max(1, sqrt(k)) (the
    decoded products are exact, only the order of the sum differs);
  * the others: normf_rel or linf_abs within matdiff.DEFAULT_MARGINS[tol]
    * max(1, sqrt(k * br)); the stochastic-round store within one bf16
    ulp's margin.

The oracle is built from the operands as the device holds them, so it does
not depend on how a float64 draw rounds to the storage type.
"""

from __future__ import annotations

import numpy as np
import torch

from . import quant as q_
from .descriptor import (BatchReduceConfig, BatchReduceType, BinaryPostops,
                         BinaryType, GemmFlags, GemmShape, UnaryArgops,
                         UnaryFlags, UnaryType)
from .dtypes import Datatype, bits, to_torch
from .matdiff import DEFAULT_MARGINS, matdiff
from .ops import gemm as G
from .ops.eltwise import unpack_bitmask

D = Datatype

# (a_type, b_type, out_type, tolerance class): samples/xgemm.py:42-70
BASE_COMBOS = [
    (D.F64, D.F64, D.F64, "f64"),
    (D.F32, D.F32, D.F32, "f32"),
    (D.BF16, D.BF16, D.F32, "bf16"),
    (D.BF16, D.BF16, D.BF16, "bf16"),
    (D.F16, D.F16, D.F32, "f16"),
    (D.F16, D.F16, D.F16, "f16"),
    (D.BF8, D.BF8, D.F32, "bf8"),
    (D.BF8, D.BF8, D.BF16, "bf8"),
    (D.HF8, D.HF8, D.F32, "hf8"),
    (D.I8, D.I8, D.I32, "exact"),
    (D.U8, D.U8, D.I32, "exact"),
]

PACKED_COMBOS = [
    (D.MXFP4X2, D.BF16, D.F32, "mx4"),
    (D.MXFP4X2, D.MXFP4X2, D.F32, "mx4"),
    (D.NVFP4X2, D.BF16, D.F32, "mx4"),
    (D.MXBF8, D.BF16, D.F32, "bf8"),
    (D.MXBF8, D.MXBF8, D.F32, "bf8"),
    (D.MXBF6, D.BF16, D.F32, "mx6"),
    (D.MXHF6, D.BF16, D.F32, "mx6"),
    (D.I4X2, D.I8, D.I32, "exact"),
    (D.U4X2, D.U8, D.I32, "exact"),
    (D.I2X4, D.I8, D.I32, "exact"),
    (D.I1X8, D.I8, D.I32, "exact"),
    (D.I4X2, D.F16, D.F32, "f16"),
]

BR_MODES = ("none", "stride", "offset", "address")

_INT_TYPES = (D.I8, D.U8, D.I32)


def _vnni_factor(dt: Datatype) -> int:
    return max(1, 32 // bits(dt))


def build_class_list():
    """The acceptance matrix as descriptor-class dicts, in xgemm's order."""
    classes = []
    # 1. base dtype combos x BR mode x beta
    for combo in BASE_COMBOS:
        for br_mode in BR_MODES:
            for beta in (0, 1):
                classes.append(dict(kind="gemm", combo=combo,
                                    br_mode=br_mode, beta=beta))
    # 2. transposes (natural-layout dtypes)
    for combo in BASE_COMBOS[:3]:
        for ta, tb in ((1, 0), (0, 1), (1, 1)):
            for beta in (0, 1):
                classes.append(dict(kind="gemm", combo=combo, br_mode="none",
                                    beta=beta, ta=ta, tb=tb))
    # 3. VNNI layout contracts per 16/8-bit dtype (VNNI_C needs a narrow
    #    output type)
    for combo in BASE_COMBOS[2:10]:
        for vnni in ("A", "B", "C", "AC"):
            if vnni in ("C", "AC") and combo[2] in (D.F32, D.I32):
                continue
            for br_mode in ("none", "stride"):
                classes.append(dict(kind="gemm", combo=combo,
                                    br_mode=br_mode, beta=0, vnni=vnni))
    # 4. packed MX / sub-byte operands (gemm + BRGEMM stride)
    for combo in PACKED_COMBOS:
        for br_mode in ("none", "stride"):
            classes.append(dict(kind="packed", combo=combo, br_mode=br_mode,
                                beta=0))
    # 5. brgemm_ext fusion matrix on f32 and bf16
    for combo in BASE_COMBOS[1:3]:
        for cp in ("RELU", "GELU", "TANH", "SIGMOID", "X2"):
            for dpost in (False, True):
                for beta in (0, 1):
                    classes.append(dict(kind="ext", combo=combo, cp=cp,
                                        bias=dpost, beta=beta))
        classes.append(dict(kind="ext", combo=combo, cp="RELU", bias=False,
                            beta=0, bitmask=True))
        classes.append(dict(kind="ext", combo=combo, cp="NONE", bias=True,
                            beta=0, argop_a="X2"))
        classes.append(dict(kind="ext", combo=combo, cp="NONE", bias=False,
                            beta=0, store_cp=True))
    classes.append(dict(kind="ext", combo=(D.F32, D.F32, D.BF16, "bf16"),
                        cp="STOCHASTIC_ROUND", bias=False, beta=0))
    # 6. lane-packed fast-path ext (the fused-epilogue kernel)
    for cp in ("RELU", "GELU"):
        for dpost in (False, True):
            classes.append(dict(kind="ext_packed", cp=cp, bias=dpost,
                                beta=0))
    return classes


def rand_mk(rng, cls):
    """Shape sampling honouring each class's divisibility constraints."""
    combo = cls.get("combo", (D.F32,) * 3 + ("f32",))
    adt = combo[0]
    if cls["kind"] == "packed":
        # payloads pack along k; MX needs 32 | k (16 for NVFP4)
        return (int(rng.integers(1, 9)) * 8, int(rng.integers(1, 9)) * 8,
                int(rng.integers(1, 5)) * 64)
    if cls["kind"] == "ext_packed":
        return 16 * int(rng.integers(1, 5)), 32, 64
    f = _vnni_factor(adt)
    vnni = cls.get("vnni", "")
    m, n, k = (int(rng.integers(1, 101)) for _ in range(3))
    if "A" in vnni:
        m = max(f, (m // f) * f)
    if "B" in vnni:
        k = max(f, (k // f) * f)
    if "C" in vnni:
        fo = _vnni_factor(combo[2])
        m = max(fo * f, (m // (fo * f)) * fo * f)
    return m, n, k


def _f64(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu").double().numpy()


def make_operand(rng, dt, shape, device):
    """Random operand in its storage type: (tensor, float64 oracle)."""
    if dt in _INT_TYPES:
        lo, hi = (0, 128) if dt == D.U8 else (-100, 100)
        v = rng.integers(lo, hi, shape)
        return torch.as_tensor(v, device=device).to(to_torch(dt)), \
            v.astype(np.float64)
    x = torch.as_tensor(rng.standard_normal(shape), device=device)
    dev = x.to(torch.float32).to(to_torch(dt)) if dt != D.F64 else x
    return dev, _f64(dev)


def _quantizers(dt):
    return {D.MXFP4X2: (q_.mxfp4_quantize_blocks, q_.mxfp4_dequantize_blocks),
            D.NVFP4X2: (q_.nvfp4_quantize_blocks, q_.nvfp4_dequantize_blocks),
            D.MXBF8: (q_.mxbf8_quantize_blocks, q_.mxbf8_dequantize_blocks),
            D.MXBF6: (lambda v: q_.mxfp6_quantize_blocks(v, "e3m2"),
                      lambda p, s: q_.mxfp6_dequantize_blocks(p, s, "e3m2")),
            D.MXHF6: (lambda v: q_.mxfp6_quantize_blocks(v, "e2m3"),
                      lambda p, s: q_.mxfp6_dequantize_blocks(p, s, "e2m3")),
            }[dt]


def packed_values(rng, dt, shp):
    """The float32 (MX) or integer (sub-byte) values a packed operand of
    shape `shp` (k last) is made from, as xgemm draws them: MX blocks are
    scaled so their amax is a power of two (the MXBF8 e5m2 payload
    overflows to Inf for block mantissas above 1.875)."""
    if dt in (D.I4X2, D.U4X2, D.I2X4, D.I1X8):
        if dt == D.I4X2:
            return rng.integers(-8, 8, shp)
        if dt == D.U4X2:
            return rng.integers(0, 16, shp)
        if dt == D.I2X4:
            return rng.integers(-1, 2, shp)
        return rng.choice([-1, 1], shp)
    x = (rng.standard_normal(shp) * 2).astype(np.float32)
    xb = x.reshape(*shp[:-1], shp[-1] // 32, 32).astype(np.float64)
    amax = np.maximum(np.abs(xb).max(-1, keepdims=True), 1e-9)
    return (xb * (np.exp2(np.floor(np.log2(amax))) / amax)).reshape(
        shp).astype(np.float32)


def pack_values(dt, vals, device):
    """Packed operand from packed_values(): (payload or (payload, scales),
    float64 oracle of the decoded values)."""
    if dt in (D.I4X2, D.U4X2, D.I2X4, D.I1X8):
        packed = q_.pack_subbyte_gemm(dt, torch.as_tensor(
            vals.astype(np.int32), device=device))
        return packed, vals.astype(np.float64)
    quant, deq = _quantizers(dt)
    p, s = quant(torch.as_tensor(vals, device=device))
    return (p, s), _f64(deq(p, s))


def _vnni_pack(x: torch.Tensor, f: int) -> torch.Tensor:
    *lead, r, c = x.shape
    return (x.reshape(*lead, r // f, f, c).transpose(-1, -2)
            .reshape(*lead, r // f, c * f)).contiguous()


def _label(kind, adt, bdt, odt, m, n, k, br, br_mode, ta, tb, vnni, beta):
    return (f"{kind} {adt.value}x{bdt.value}->{odt.value} {m}x{n}x{k}"
            f"{' br=' + br_mode if br else ''}{' tA' if ta else ''}"
            f"{' tB' if tb else ''}{' vnni' + vnni if vnni else ''}"
            f" beta={beta}")


def run_class(cls, rng, device, verbose=False, keep=None):
    """Run one class through the port's entry points on `device` against
    its float64 oracle. Returns (ok, label, normf_rel). A dict `keep`
    receives the GEMM/BRGEMM classes' kernel and operands ("kern", "args",
    "extra": whether BR index arrays ride along), so a caller can time the
    kernel after the check."""
    kind = cls["kind"]
    adt, bdt, odt, tol = cls.get("combo", (D.F32, D.F32, D.F32, "f32"))
    m, n, k = rand_mk(rng, cls)
    beta = cls.get("beta", 0)
    br_mode = cls.get("br_mode", "none")
    br = int(rng.integers(2, 7)) if br_mode != "none" else 0
    ta, tb = cls.get("ta", 0), cls.get("tb", 0)
    vnni = cls.get("vnni", "")

    flags = GemmFlags.NONE
    for on, f in ((beta == 0, GemmFlags.BETA_0), (ta, GemmFlags.TRANS_A),
                  (tb, GemmFlags.TRANS_B), ("A" in vnni, GemmFlags.VNNI_A),
                  ("B" in vnni, GemmFlags.VNNI_B),
                  ("C" in vnni, GemmFlags.VNNI_C)):
        if on:
            flags |= f
    shape = GemmShape(m, n, k, a_in_type=adt, b_in_type=bdt, out_type=odt)
    label = _label(kind, adt, bdt, odt, m, n, k, br, br_mode, ta, tb, vnni,
                   beta)

    # ---- operands + oracle --------------------------------------------
    a_shape = (k, m) if ta else (m, k)
    b_shape = (n, k) if tb else (k, n)
    if br:
        pool = br + 3 if br_mode == "address" else br
        a_shape, b_shape = (pool, *a_shape), (pool, *b_shape)
    extra_args = ()
    lead = (br,) if br else ()
    if kind == "packed":
        a, a64 = pack_values(adt, packed_values(rng, adt, lead + (m, k)),
                             device)
        if bdt in (D.MXFP4X2, D.MXBF8):
            # quantized along k on the (.., n, k) view, then the trailing
            # dims swapped into the (.., k/pack, n) B contract
            (bp, bs), b64t = pack_values(
                bdt, packed_values(rng, bdt, lead + (n, k)), device)
            b = (bp.transpose(-1, -2), bs.transpose(-1, -2))
            b64 = np.swapaxes(b64t, -1, -2)
        else:
            b, b64 = make_operand(rng, bdt, b_shape, device)
        flags |= GemmFlags.VNNI_A
    else:
        a, a64 = make_operand(rng, adt, a_shape, device)
        b, b64 = make_operand(rng, bdt, b_shape, device)
        if "A" in vnni:
            a = _vnni_pack(a, _vnni_factor(adt))
        if "B" in vnni:
            b = _vnni_pack(b, _vnni_factor(bdt))

    am = np.swapaxes(a64, -1, -2) if ta else a64
    bm = np.swapaxes(b64, -1, -2) if tb else b64
    if br_mode == "address":
        idx_a = rng.integers(0, a_shape[0], br).astype(np.int32)
        idx_b = rng.integers(0, b_shape[0], br).astype(np.int32)
        am, bm = am[idx_a], bm[idx_b]
        extra_args = (idx_a, idx_b)
    elif br_mode == "offset":
        extra_args = (np.arange(br, dtype=np.int32),) * 2
    extra_args = tuple(torch.as_tensor(i, device=device) for i in extra_args)
    ref = np.einsum("bmk,bkn->mn", am, bm) if br else am @ bm

    c = None
    if beta == 1:
        c64 = rng.standard_normal((m, n))
        if odt in _INT_TYPES:
            c64 = np.round(c64 * 10)
        c = torch.as_tensor(c64, device=device).to(to_torch(odt))
        ref = ref + _f64(c)

    # ---- dispatch + run -----------------------------------------------
    br_cfg = (BatchReduceConfig(getattr(BatchReduceType, br_mode.upper()),
                                br) if br else None)
    if kind in ("gemm", "packed"):
        kern = (G.dispatch_brgemm(shape, flags, br_cfg) if br
                else G.dispatch_gemm(shape, flags))
        args = (a, b, *((c,) if c is not None else ()), *extra_args)
        out = kern(*args)
        if keep is not None:
            keep.update(kern=kern, args=args, extra=bool(extra_args))
    elif kind == "ext":
        cp = cls["cp"]
        argops = UnaryArgops(
            ap_type=getattr(UnaryType, cls.get("argop_a", "NONE")),
            cp_type=getattr(UnaryType, cp),
            cp_flags=(UnaryFlags.BITMASK_2BYTEMULT if cls.get("bitmask")
                      else UnaryFlags.NONE),
            store_cp=bool(cls.get("store_cp")))
        postops = (BinaryPostops(d_type=BinaryType.ADD) if cls.get("bias")
                   else BinaryPostops())
        if not br:
            br = 3
            a, a64 = make_operand(rng, adt, (br, m, k), device)
            b, b64 = make_operand(rng, bdt, (br, k, n), device)
            ref = np.einsum("bmk,bkn->mn", a64, b64)
            if c is not None:
                ref = ref + _f64(c)
        kern = G.dispatch_brgemm_ext(
            shape, flags, BatchReduceConfig(BatchReduceType.STRIDE, br),
            argops=argops, postops=postops)
        args = [a, b] + ([c] if beta == 1 else [])
        d64 = None
        if cls.get("bias"):
            d = torch.as_tensor(rng.standard_normal((m, n)),
                                device=device).to(to_torch(adt))
            args.append(d)
            d64 = _f64(d)
        if cls.get("argop_a") == "X2":
            ref = np.einsum("bmk,bkn->mn", a64 * a64, b64)
        if d64 is not None:
            ref = ref + d64
        out = kern(*args, seed=7)
        if cls.get("store_cp") or cls.get("bitmask"):
            out, extra = out
            if cls.get("bitmask"):
                mask = unpack_bitmask(extra["cp_bitmask"], m, n)
                if not bool((mask.cpu().numpy() == (ref > 0)).all()):
                    return False, label + " (bitmask mismatch)", float("nan")
        ref = _cp_ref(cp, ref)
        if cp == "STOCHASTIC_ROUND":
            tol = "bf16"   # the SR store: within one bf16 ulp
        label += f" cp={cp.lower()}{' +bias' if cls.get('bias') else ''}"
    elif kind == "ext_packed":
        cp = cls["cp"]
        br, q = 8, 2
        a2 = rng.standard_normal((br, m, k)).astype(np.float32)
        b2 = rng.standard_normal((br, k, n)).astype(np.float32)
        kern = G.dispatch_brgemm_ext_packed(
            GemmShape(m, n, k), GemmFlags.BETA_0,
            BatchReduceConfig(BatchReduceType.STRIDE, br),
            argops=UnaryArgops(cp_type=getattr(UnaryType, cp)),
            postops=(BinaryPostops(d_type=BinaryType.ADD)
                     if cls.get("bias") else BinaryPostops()))
        ap = G.pack_batched(torch.as_tensor(a2, device=device), q)
        bt = torch.as_tensor(b2, device=device)
        ref = np.einsum("bmk,bkn->mn", a2, b2).astype(np.float64)
        if cls.get("bias"):
            d64 = rng.standard_normal((1, n))
            out = kern(ap, bt, d_op=torch.as_tensor(d64, device=device).to(
                torch.float32))
            ref = ref + d64
        else:
            out = kern(ap, bt)
        ref = _cp_ref(cp, ref)
        label += f" cp={cp.lower()}{' +bias' if cls.get('bias') else ''}"
        tol = "f32"
    else:
        raise ValueError(kind)

    # ---- compare ------------------------------------------------------
    out_np = _f64(out)
    if "C" in vnni:
        fo = _vnni_factor(odt)
        r, cdim = out_np.shape
        out_np = (out_np.reshape(r, cdim // fo, fo).swapaxes(-1, -2)
                  .reshape(r * fo, cdim // fo))
    info = matdiff(ref, out_np)
    if tol == "exact":
        ok = info.linf_abs == 0.0
    elif tol in ("mx4", "mx6"):
        ok = info.normf_rel <= 1e-5 * max(1.0, np.sqrt(k))
    else:
        margin = DEFAULT_MARGINS[tol] * max(1.0, np.sqrt(k * max(1, br)))
        ok = info.normf_rel <= margin or info.linf_abs <= margin
    if verbose or not ok:
        print(f"{'OK  ' if ok else 'FAIL'} {label:64s} "
              f"normf_rel={info.normf_rel:.2e}")
    return ok, label, info.normf_rel


def _cp_ref(cp: str, ref: np.ndarray) -> np.ndarray:
    if cp == "RELU":
        return np.maximum(ref, 0)
    if cp == "GELU":
        erf = torch.erf(torch.from_numpy(ref / np.sqrt(2))).numpy()
        return 0.5 * ref * (1 + erf)
    if cp == "TANH":
        return np.tanh(ref)
    if cp == "SIGMOID":
        return 1 / (1 + np.exp(-ref))
    if cp == "X2":
        return ref * ref
    return ref
