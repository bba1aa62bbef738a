"""eltwise: the random unary/binary/ternary TPP sweep (samples/eltwise.py)
on the port.

    python -m libxsmm_torch.samples.eltwise [ncases] [--device cpu]

Draws `ncases` (default 30) random (M, N) cases from the sample's seed,
each of one kind (unary, binary, ternary, reduce, transform, grad, dropout,
gather, quant), and holds each against its numpy oracle with the sample's
rules: matdiff normf_rel or linf_abs within 1e-4; gather/scatter and i8
QUANT exact; the dropout's kept elements scaled by 1/(1-p) and the others
zero, through its own packed mask, forward and DROPOUT_INV. The dropout's
mask is unpacked with unpack_bitmask, and DROPOUT_INV takes it as a numpy
array, as the sample passes it. Returns 0 when every case passes, else 1.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import _common


def _erf(x):
    return torch.erf(torch.from_numpy(np.asarray(x, np.float64))).numpy()


def _oracles():
    from libxsmm_torch.descriptor import BinaryType, UnaryType
    unary = {
        UnaryType.IDENTITY: lambda x: x,
        UnaryType.X2: lambda x: x * x,
        UnaryType.RELU: lambda x: np.maximum(x, 0),
        UnaryType.TANH: np.tanh,
        UnaryType.SIGMOID: lambda x: 1 / (1 + np.exp(-x)),
        UnaryType.GELU: lambda x: 0.5 * x * (1 + _erf(x / np.sqrt(2))),
        UnaryType.NEGATE: lambda x: -x,
        UnaryType.EXP: np.exp,
        UnaryType.SQRT: lambda x: np.sqrt(np.abs(x)),
    }
    binary = {
        BinaryType.ADD: np.add,
        BinaryType.MUL: np.multiply,
        BinaryType.SUB: np.subtract,
        BinaryType.MAX: np.maximum,
        BinaryType.MIN: np.minimum,
    }
    return unary, binary


def _np(t):
    return t.detach().cpu().numpy()


def run_case(rng, dev: torch.device):
    """One case, drawing from `rng` exactly as samples/eltwise.py's
    run_case does. Returns (label, (m, n), ok, output as numpy); the
    dropout's output is the pair (forward, DROPOUT_INV)."""
    import libxsmm_torch as xp
    from libxsmm_torch.descriptor import TernaryType, UnaryFlags, UnaryType
    from libxsmm_torch.dtypes import Datatype
    from libxsmm_torch.matdiff import matdiff

    def t(a):
        return torch.as_tensor(a, device=dev)

    unary_ops, binary_ops = _oracles()
    m = int(rng.integers(1, 130))
    n = int(rng.integers(1, 130))
    kind = rng.choice(["unary", "binary", "ternary", "reduce", "transform",
                       "grad", "dropout", "gather", "quant"])
    x = rng.standard_normal((m, n)).astype(np.float32)
    if kind == "dropout":
        # forward emits the packed bitmask, DROPOUT_INV consumes it
        p = float(rng.uniform(0.1, 0.6))
        xp_ = np.abs(x) + 1.0
        fwd = xp.dispatch_meltw_unary(UnaryType.DROPOUT, m, n,
                                      UnaryFlags.BITMASK_2BYTEMULT,
                                      extra=(p,))
        out, pmask = fwd(t(xp_), seed=int(rng.integers(1 << 30)))
        out = _np(out)
        mask = _np(xp.unpack_bitmask(pmask, m, n))
        ok = (np.allclose(out[mask], xp_[mask] / (1 - p), rtol=1e-5)
              and np.all(out[~mask] == 0))
        inv = xp.dispatch_meltw_unary(UnaryType.DROPOUT_INV, m, n,
                                      UnaryFlags.BITMASK_2BYTEMULT,
                                      extra=(p,))
        g = rng.standard_normal((m, n)).astype(np.float32)
        giv = _np(inv(t(g), _np(pmask)))          # a numpy mask
        ok = bool(ok and np.allclose(giv[mask], g[mask] / (1 - p), rtol=1e-5)
                  and np.all(giv[~mask] == 0))
        label = "dropout p=%.2f" % p
        print(f"{'OK  ' if ok else 'FAIL'} {label:28s} {m:4d}x{n:<4d} "
              f"keep={mask.mean():.2f}")
        return label, (m, n), ok, (out, giv)
    if kind == "gather":
        # gather, then scatter back
        cols = bool(rng.integers(2))
        axis_len = n if cols else m
        nidx = int(rng.integers(1, axis_len + 1))
        idx = rng.choice(axis_len, nidx, replace=False).astype(np.int32)
        flags = UnaryFlags.GS_COLS if cols else UnaryFlags.GS_ROWS
        gat = xp.dispatch_meltw_unary(UnaryType.GATHER, m, n, flags)
        out = _np(gat(t(x), t(idx)))
        ref = x[:, idx] if cols else x[idx, :]
        ok = np.array_equal(out, ref)
        sca = xp.dispatch_meltw_unary(UnaryType.SCATTER, m, n, flags)
        base = np.zeros_like(x)
        back = _np(sca(t(out), t(idx), t(base)))
        ref2 = base.copy()
        if cols:
            ref2[:, idx] = ref
        else:
            ref2[idx, :] = ref
        ok = bool(ok and np.array_equal(back, ref2))
        label = f"gather/scatter {'cols' if cols else 'rows'}"
        print(f"{'OK  ' if ok else 'FAIL'} {label:28s} {m:4d}x{n:<4d} "
              f"nidx={nidx}")
        return label, (m, n), ok, out
    if kind == "quant":
        # i8 QUANT (sign-saturating), then DEQUANT
        scale = float(rng.uniform(4.0, 64.0))
        q = xp.dispatch_meltw_unary(UnaryType.QUANT, m, n,
                                    UnaryFlags.SIGN_SAT_QUANT,
                                    out_type=Datatype.I8)
        dq = xp.dispatch_meltw_unary(UnaryType.DEQUANT, m, n,
                                     in_type=Datatype.I8)
        qx = q(t(x), scale)
        ref_q = np.clip(np.round(x * scale), -128, 127).astype(np.int8)
        back = _np(dq(qx, 1.0 / scale))     # DEQUANT multiplies by scf
        qx = _np(qx)
        ok = bool(np.array_equal(qx, ref_q)
                  and np.allclose(back, ref_q.astype(np.float32) / scale,
                                  rtol=1e-6))
        label = "quant i8 s=%.1f" % scale
        print(f"{'OK  ' if ok else 'FAIL'} {label:28s} {m:4d}x{n:<4d} "
              f"linf={np.abs(back - x).max():.3f}")
        return label, (m, n), ok, qx
    if kind == "grad":
        # forward emits the packed bitmask, the backward consumes it with a
        # run-time alpha
        alpha = float(rng.uniform(0.05, 0.9))
        fwd_op = [UnaryType.RELU, UnaryType.LEAKY_RELU][rng.integers(2)]
        fwd = xp.dispatch_meltw_unary(fwd_op, m, n,
                                      UnaryFlags.BITMASK_2BYTEMULT)
        _, pmask = fwd(t(x), alpha=alpha)
        g = rng.standard_normal((m, n)).astype(np.float32)
        inv_op = (UnaryType.RELU_INV if fwd_op == UnaryType.RELU
                  else UnaryType.LEAKY_RELU_INV)
        inv = xp.dispatch_meltw_unary(inv_op, m, n,
                                      UnaryFlags.BITMASK_2BYTEMULT)
        out = _np(inv(t(g), pmask, alpha=alpha))
        ref = np.where(x > 0, g,
                       0.0 if fwd_op == UnaryType.RELU else alpha * g)
        label = f"grad {inv_op.name} a={alpha:.2f}"
    elif kind == "unary":
        op = list(unary_ops)[rng.integers(len(unary_ops))]
        if op == UnaryType.SQRT:
            x = np.abs(x) + 0.1
        kern = xp.dispatch_meltw_unary(op, m, n)
        ref, out = unary_ops[op](x), _np(kern(t(x)))
        label = f"unary {op.name}"
    elif kind == "binary":
        op = list(binary_ops)[rng.integers(len(binary_ops))]
        y = rng.standard_normal((m, n)).astype(np.float32)
        kern = xp.dispatch_meltw_binary(op, m, n)
        ref, out = binary_ops[op](x, y), _np(kern(t(x), t(y)))
        label = f"binary {op.name}"
    elif kind == "ternary":
        y = rng.standard_normal((m, n)).astype(np.float32)
        z = rng.standard_normal((m, n)).astype(np.float32)
        kern = xp.dispatch_meltw_ternary(TernaryType.MULADD, m, n)
        ref, out = x * y + z, _np(kern(t(x), t(y), t(z)))
        label = "ternary MULADD"
    elif kind == "reduce":
        rows = bool(rng.integers(2))
        flags = UnaryFlags.REDUCE_ROWS if rows else UnaryFlags.REDUCE_COLS
        kern = xp.dispatch_meltw_unary(UnaryType.REDUCE_X_OP_ADD, m, n, flags)
        ref = x.sum(axis=1 if rows else 0, keepdims=True)
        out = _np(kern(t(x)))
        label = f"reduce add {'rows' if rows else 'cols'}"
    else:
        kern = xp.dispatch_meltw_unary(UnaryType.TRANSFORM_NORM_TO_NORMT,
                                       m, n)
        ref, out = x.T, _np(kern(t(x)))
        label = "transform NORMT"

    info = matdiff(ref, out)
    ok = bool(info.normf_rel <= 1e-4 or info.linf_abs <= 1e-4)
    print(f"{'OK  ' if ok else 'FAIL'} {label:28s} {m:4d}x{n:<4d} "
          f"normf_rel={info.normf_rel:.2e}")
    return label, (m, n), ok, out


def main(argv=None) -> int:
    ap = _common.add_device(argparse.ArgumentParser(
        description="the random meltw sweep"))
    ap.add_argument("ncases", nargs="?", type=int, default=30)
    args = ap.parse_args(argv)
    dev = _common.device(args.device)
    rng = np.random.default_rng(20260816)
    results = [run_case(rng, dev)[2] for _ in range(args.ncases)]
    print(f"\n{sum(results)}/{len(results)} passed")
    return 0 if all(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
