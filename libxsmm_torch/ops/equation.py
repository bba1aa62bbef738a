"""Matrix-equation front-end: expression trees evaluated as one kernel.

The port of `libxsmm_tpu/ops/equation.py`, the reference's matrix-equation
IR + JIT (src/libxsmm_matrixeqn.{c,h} — builder API include/libxsmm.h:
148-162): the user pushes ops and args in PREFIX (depth-first) order, then
dispatches a single kernel evaluating the whole tree.

The JAX package traces the tree into one jitted function and leaves fusion
to XLA; it reaches no Pallas kernel. Here the tree runs eagerly on torch
ops, node by node, on the device of its arguments: no fused kernel yet (a
later, measured step). The IR is kept as a real data structure for
validation, pretty-printing (libxsmm_meqn_tree_print) and introspection.

Builder contract (as the reference's):
  eqn = meqn_create()
  meqn_push_back_binary_op(eqn, BinaryType.ADD, ...)    # prefix order
  meqn_push_back_arg(eqn, m, n, in_pos=0, ...)
  meqn_push_back_arg(eqn, m, n, in_pos=1, ...)
  fn = dispatch_meqn(eqn, out_m, out_n, out_type)
  out = fn(arg0, arg1)       # args by in_pos order

Arguments: a tensor stays on its device; numpy data loads onto the default
device (the GPU, raising without one); arguments on different devices
raise. Each node computes at its own dtype; F64 runs natively.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..descriptor import (BinaryFlags, BinaryType, TernaryFlags, TernaryType,
                          UnaryFlags, UnaryType)
from ..dtypes import Datatype, to_torch
from ..registry import Kernel, KernelInfo, get_registry
from .eltwise import (_i32_from_u32, apply_binary_op, apply_matmul_node,
                      apply_ternary_op, apply_unary_op, load_operand)

_ARITY = {"unary": 1, "binary": 2, "ternary": 3}


@dataclasses.dataclass
class EqnNode:
    kind: str                    # "arg" | "unary" | "binary" | "ternary"
    op: Optional[object] = None  # UnaryType | BinaryType | TernaryType
    flags: int = 0
    dtype: Datatype = Datatype.F32
    m: int = 0
    n: int = 0
    in_pos: int = -1
    # secondary-operand argument slot (reference: op_metadata.op_arg_pos):
    # GATHER / REDUCE_COLS_IDX nodes read their index vector from the
    # kernel argument at this position
    op_arg_pos: int = -1
    # MATRIX_ARG_TYPE_SET cardinality hint (>0: this arg is a stacked
    # (count, m, n) tensor set; 0: singular), checked at call time
    set_card: int = 0
    children: List["EqnNode"] = dataclasses.field(default_factory=list)

    def is_complete(self) -> bool:
        if self.kind == "arg":
            return True
        return len(self.children) == _ARITY[self.kind]

    def pretty(self, depth: int = 0) -> str:
        pad = "  " * depth
        if self.kind == "arg":
            return f"{pad}ARG[{self.in_pos}] {self.m}x{self.n} {self.dtype.value}"
        lines = [f"{pad}{self.kind.upper()} {self.op.name} "
                 f"(flags={int(self.flags)}, {self.dtype.value})"]
        lines += [c.pretty(depth + 1) for c in self.children]
        return "\n".join(lines)


@dataclasses.dataclass
class Equation:
    idx: int
    root: Optional[EqnNode] = None
    _stack: List[EqnNode] = dataclasses.field(default_factory=list)
    nargs: int = 0

    def _attach(self, node: EqnNode) -> None:
        if self.root is None:
            self.root = node
        else:
            if not self._stack:
                raise ValueError("equation already complete; cannot push")
            self._stack[-1].children.append(node)
        if node.kind != "arg":
            self._stack.append(node)
        # pop completed operators
        while self._stack and self._stack[-1].is_complete():
            self._stack.pop()

    def is_complete(self) -> bool:
        return self.root is not None and not self._stack


# ---------------------------------------------------------------------------
# Struct-based builder metadata (reference v2 equation API,
# include/libxsmm.h:150-162, constructors src/libxsmm_matrixeqn.c:1322-1362)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeqnArgShape:
    """libxsmm_meqn_arg_shape (include/libxsmm_typedefs.h:586-591)."""
    m: int
    n: int
    ld: int
    type: Datatype = Datatype.F32


@dataclasses.dataclass(frozen=True)
class MatrixArgAttributes:
    """libxsmm_matrix_arg_attributes (include/libxsmm_typedefs.h:641-646).
    `arg_type` 0 = SINGULAR, 1 = SET; set_type follows
    libxsmm_matrix_arg_set_type (NONE/ABS_ADDRESS/OFFSET_BASE/STRIDE_BASE)."""
    arg_type: int = 0
    set_type: int = 0
    set_cardinality_hint: int = 0
    set_stride_hint: int = 0


@dataclasses.dataclass(frozen=True)
class MeqnArgMetadata:
    """libxsmm_meqn_arg_metadata (constructor src/libxsmm_matrixeqn.c:1345)."""
    eqn_idx: int
    in_arg_pos: int


@dataclasses.dataclass(frozen=True)
class MeqnOpMetadata:
    """libxsmm_meqn_op_metadata (constructor src/libxsmm_matrixeqn.c:1354)."""
    eqn_idx: int
    op_arg_pos: int = -1


@dataclasses.dataclass(frozen=True)
class MeqnDescriptor:
    """libxsmm_meqn_descriptor (src/libxsmm_main.h:412-419): output shape +
    dtype + the equation handle."""
    m: int
    n: int
    ldo: int
    datatype: Datatype
    eqn_idx: int


def create_meqn_arg_shape(m: int, n: int, ld: int,
                          dtype: Datatype = Datatype.F32) -> MeqnArgShape:
    """libxsmm_create_meqn_arg_shape (include/libxsmm.h:150)."""
    return MeqnArgShape(m=m, n=n, ld=ld, type=Datatype(dtype))


def create_matrix_arg_attributes(arg_type: int = 0, set_type: int = 0,
                                 set_cardinality_hint: int = 0,
                                 set_stride_hint: int = 0
                                 ) -> MatrixArgAttributes:
    """libxsmm_create_matrix_arg_attributes (include/libxsmm.h:151)."""
    return MatrixArgAttributes(arg_type, set_type, set_cardinality_hint,
                               set_stride_hint)


def create_meqn_arg_metadata(eqn_idx: int, in_arg_pos: int) -> MeqnArgMetadata:
    """libxsmm_create_meqn_arg_metadata (include/libxsmm.h:152)."""
    return MeqnArgMetadata(eqn_idx=eqn_idx, in_arg_pos=in_arg_pos)


def create_meqn_op_metadata(eqn_idx: int, op_arg_pos: int = -1
                            ) -> MeqnOpMetadata:
    """libxsmm_create_meqn_op_metadata (include/libxsmm.h:153)."""
    return MeqnOpMetadata(eqn_idx=eqn_idx, op_arg_pos=op_arg_pos)


_equations: Dict[int, Equation] = {}
_eqn_lock = threading.Lock()
_next_idx = [0]


def meqn_create() -> int:
    """libxsmm_meqn_create analogue: returns an equation handle index."""
    with _eqn_lock:
        idx = _next_idx[0]
        _next_idx[0] += 1
        _equations[idx] = Equation(idx=idx)
        return idx


def _eqn(idx: int) -> Equation:
    try:
        return _equations[idx]
    except KeyError:
        raise ValueError(f"unknown equation index {idx}") from None


def meqn_push_back_arg(idx, m=None, n=None, in_pos=None,
                       dtype: Datatype = Datatype.F32,
                       arg_attr: "MatrixArgAttributes" = None) -> None:
    """libxsmm_meqn_push_back_arg analogue; in_pos = position of this arg in
    the dispatch-time argument list.

    Two call forms, matching both reference generations:
      meqn_push_back_arg(idx, m, n, in_pos, dtype)            # flattened
      meqn_push_back_arg(arg_metadata, arg_shape[, arg_attr]) # struct v2
    (include/libxsmm.h:154 takes metadata + shape + attributes)."""
    if isinstance(idx, MeqnArgMetadata):
        meta, shape = idx, m
        if not isinstance(shape, MeqnArgShape):
            raise TypeError("struct form needs a MeqnArgShape second arg")
        if isinstance(n, MatrixArgAttributes):
            arg_attr = n
        idx, m, n, in_pos, dtype = (meta.eqn_idx, shape.m, shape.n,
                                    meta.in_arg_pos, shape.type)
    if in_pos is None or int(in_pos) < 0:
        # a negative in_pos would alias args[-1] at call time; an omitted
        # one would fail later with an opaque TypeError
        raise ValueError(f"in_pos must be a non-negative argument "
                         f"position, got {in_pos!r}")
    in_pos = int(in_pos)
    set_card = 0
    if arg_attr is not None and arg_attr.arg_type != 0:
        # MATRIX_ARG_TYPE_SET: the reference's three addressing modes
        # (ABS_ADDRESS / OFFSET_BASE / STRIDE_BASE) are one contract here,
        # a stacked (count, m, n) tensor whose leading axis a BRGEMM node
        # reduces; the cardinality hint is checked at call time
        if arg_attr.set_type not in (0, 1, 2, 3):
            raise ValueError(f"unknown set_type {arg_attr.set_type}")
        set_card = max(0, int(arg_attr.set_cardinality_hint))
    eqn = _eqn(idx)
    eqn._attach(EqnNode(kind="arg", m=m, n=n, in_pos=in_pos, dtype=dtype,
                        set_card=set_card))
    eqn.nargs = max(eqn.nargs, in_pos + 1)


def _meta_idx(idx) -> int:
    return idx.eqn_idx if isinstance(idx, MeqnOpMetadata) else idx


_IDX_OPS = (UnaryType.GATHER, UnaryType.REDUCE_COLS_IDX_OP_ADD,
            UnaryType.REDUCE_COLS_IDX_OP_MAX,
            UnaryType.REDUCE_COLS_IDX_OP_MIN)


def _needs_idx(op) -> bool:
    return op in _IDX_OPS


def meqn_push_back_unary_op(idx, op: UnaryType,
                            dtype: Datatype = Datatype.F32,
                            flags: UnaryFlags = UnaryFlags.NONE,
                            op_arg_pos: int = -1) -> None:
    """Accepts an int handle or a MeqnOpMetadata (reference v2 form).

    Index-consuming ops (GATHER, REDUCE_COLS_IDX_*) read their index vector
    from the kernel argument at `op_arg_pos` (the reference's
    op_metadata.op_arg_pos / exec-time arg.secondary,
    samples/equation/equation_gather_reduce.c:151,165)."""
    if isinstance(idx, MeqnOpMetadata) and op_arg_pos < 0:
        op_arg_pos = idx.op_arg_pos
    if _needs_idx(op) and op_arg_pos < 0:
        raise ValueError(f"{op.name} equation node needs op_arg_pos (the "
                         "argument slot carrying the index vector)")
    eqn = _eqn(_meta_idx(idx))
    eqn._attach(EqnNode(kind="unary", op=op, flags=UnaryFlags(flags),
                        dtype=dtype, op_arg_pos=op_arg_pos))
    if op_arg_pos >= 0:
        eqn.nargs = max(eqn.nargs, op_arg_pos + 1)


def meqn_push_back_binary_op(idx, op: BinaryType,
                             dtype: Datatype = Datatype.F32,
                             flags: BinaryFlags = BinaryFlags.NONE) -> None:
    _eqn(_meta_idx(idx))._attach(
        EqnNode(kind="binary", op=op, flags=BinaryFlags(flags), dtype=dtype))


def meqn_push_back_ternary_op(idx, op: TernaryType,
                              dtype: Datatype = Datatype.F32,
                              flags: TernaryFlags = TernaryFlags.NONE) -> None:
    _eqn(_meta_idx(idx))._attach(
        EqnNode(kind="ternary", op=op, flags=TernaryFlags(flags),
                dtype=dtype))


def meqn_tree_print(idx: int) -> str:
    """libxsmm_meqn_tree_print analogue (returns and prints)."""
    s = _eqn(idx).root.pretty() if _eqn(idx).root else "<empty>"
    print(s)
    return s


def meqn_rpn_print(idx: int) -> str:
    """libxsmm_meqn_rpn_print analogue: post-order (RPN) op listing."""
    out = []

    def visit(node: EqnNode):
        for c in node.children:
            visit(c)
        if node.kind == "arg":
            out.append(f"ARG{node.in_pos}")
        else:
            out.append(node.op.name)

    root = _eqn(idx).root
    if root is not None:
        visit(root)
    s = " ".join(out) if out else "<empty>"
    print(s)
    return s


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def _u32_value(v: torch.Tensor) -> torch.Tensor:
    """v converted by value to u32 (the reference's astype(uint32): integers
    wrap, floats truncate and saturate at 0 and 2^32 - 1), held in int64."""
    if v.is_floating_point():
        v = torch.nan_to_num(v.double(), nan=0.0).clamp(0.0, 4294967295.0)
    return v.to(torch.int64) & 0xFFFFFFFF


def _fill_value(dtype: torch.dtype):
    """jnp.take's fill for an out-of-range index: NaN for floating types,
    the most negative value for signed integers, the largest for unsigned,
    True for bool."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


def _take(x: torch.Tensor, idx: torch.Tensor, axis: int) -> torch.Tensor:
    """jnp.take(x, idx, axis) in its default "fill" mode: an index in
    [-n, 0) counts from the end, one outside [-n, n) gives a filled slice."""
    n = x.shape[axis]
    i = idx.reshape(-1).to(device=x.device, dtype=torch.long)
    i = torch.where(i < 0, i + n, i)
    ok = (i >= 0) & (i < n)
    out = torch.index_select(x, axis, torch.where(ok, i, 0))
    # filled unconditionally: asking whether any index is out of range
    # would wait for the device
    keep = ok.reshape((-1, 1) if axis == 0 else (1, -1))
    return torch.where(keep, out, _fill_value(x.dtype))


def _cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x in `dtype`, without a call into torch where it already is."""
    return x if x.dtype == dtype else x.to(dtype)


def _eval(node: EqnNode, args: tuple, memo: dict, sig_cache: dict):
    """Per-node-dtype tree evaluation with shared-subtree memoization.

    Each operator node computes at ITS OWN dtype (the reference's node
    dtype field, src/libxsmm_matrixeqn.c:323-744): children are cast at
    node boundaries, so an F64 tree runs f64 end to end and a bf16 node's
    math runs in bf16 storage precision. Structurally identical subtrees
    (same ops/flags/dtypes/arg positions) are evaluated ONCE per call;
    `sig_cache` names each node's signature (`_signatures`)."""
    sig = sig_cache[id(node)]
    hit = memo.get(sig)
    if hit is not None:
        return hit
    comp = to_torch(node.dtype)
    if node.kind == "arg":
        a = args[node.in_pos]
        if node.set_card and (a.ndim != 3 or a.shape[0] != node.set_card):
            raise ValueError(
                f"arg {node.in_pos} is a tensor set of cardinality "
                f"{node.set_card}: expected shape ({node.set_card}, "
                f"{node.m}, {node.n}), got {tuple(a.shape)}")
        res = _cast(a, comp)
        memo[sig] = res
        return res
    kids = [_eval(c, args, memo, sig_cache) for c in node.children]
    for k in kids:
        if isinstance(k, tuple):
            raise ValueError("UNZIP nodes are root-only in equation trees "
                             "(multi-output, like the reference's DUMP)")
    if node.kind == "unary" and node.op == UnaryType.UNZIP:
        # raw-bit split (splitSGD family, equation_splitSGD.c:180): NO comp
        # cast; the child's f32 bit pattern in int64 (no u16/u32 shifts
        # on every device)
        bits = (kids[0].float().contiguous().view(torch.int32)
                .to(torch.int64) & 0xFFFFFFFF)
        res = ((bits & 0xFFFF).to(torch.uint16),
               (bits >> 16).to(torch.uint16))
        memo[sig] = res
        return res
    if node.kind == "binary" and node.op == BinaryType.ZIP:
        # raw-bit merge of (lo16, hi16) operands back into f32
        word = (_u32_value(kids[1]) << 16 | _u32_value(kids[0])) & 0xFFFFFFFF
        res = _i32_from_u32(word).view(torch.float32)
        memo[sig] = res
        return res
    if node.kind == "unary" and _needs_idx(node.op):
        # index-consuming nodes: the index vector rides on its own kernel
        # argument (reference arg.secondary, op_arg_pos metadata)
        idx_arr = args[node.op_arg_pos]
        x = _cast(kids[0], comp)
        if node.op == UnaryType.GATHER:
            axis = 1 if UnaryFlags(node.flags) & UnaryFlags.GS_COLS else 0
            res = _take(x, idx_arr, axis)
        else:
            rows = _take(x, idx_arr, 0)
            red = {UnaryType.REDUCE_COLS_IDX_OP_ADD: torch.sum,
                   UnaryType.REDUCE_COLS_IDX_OP_MAX: torch.amax,
                   UnaryType.REDUCE_COLS_IDX_OP_MIN: torch.amin}[node.op]
            res = red(rows, dim=0, keepdim=True)
    elif node.kind == "unary":
        # BCAST_* flags are resolved by broadcasting at the consumer op
        res = apply_unary_op(node.op, UnaryFlags(node.flags),
                             _cast(kids[0], comp))
    elif node.kind in ("binary", "ternary") and node.op.name.startswith(
            ("MATMUL", "BRGEMM")):
        # the product accumulates at the wider of the operands' and the
        # node's type (the reference's preferred_element_type), then rounds
        # once to the node's
        a, b = kids[:2]
        acc = torch.promote_types(torch.promote_types(a.dtype, b.dtype),
                                  comp)
        if not acc.is_floating_point:
            acc = comp
        res = _cast(apply_matmul_node(node.op, a, b, node.children[0].dtype,
                                      acc), comp)
        if node.kind == "ternary":
            res = res + _cast(kids[2], comp)
    elif node.kind == "binary":
        res = apply_binary_op(node.op, BinaryFlags(node.flags),
                              *(_cast(k, comp) for k in kids))
    elif node.kind == "ternary":
        res = apply_ternary_op(node.op, TernaryFlags(node.flags),
                               *(_cast(k, comp) for k in kids))
    else:
        raise ValueError(node.kind)
    memo[sig] = res
    return res


def _tree_signature(node: EqnNode):
    if node.kind == "arg":
        return ("arg", node.m, node.n, node.in_pos, node.dtype,
                node.set_card)
    return (node.kind, node.op, int(node.flags), node.dtype,
            node.op_arg_pos,
            tuple(_tree_signature(c) for c in node.children))


def _signatures(node: EqnNode, out: dict, canon: dict) -> dict:
    """id(node) -> a small int naming _tree_signature(node), for every node
    of the tree: equal subtrees share one, and a memo keyed by it hashes an
    int on every call instead of a nested tuple."""
    out[id(node)] = canon.setdefault(_tree_signature(node), len(canon))
    for c in node.children:
        _signatures(c, out, canon)
    return out


# nflops: 2*m*n*k per matmul node, m*n per eltwise op node — the
# introspection contract of libxsmm_get_kernel_info (kernel nflops,
# main.c:3004). Each node is costed at its OWN shape, propagated bottom-up
# from the arg nodes, not the root's.

def _matmul_dims(node, idx_lens):
    """(m, n, k) of a MATMUL/BRGEMM node after transpose flags."""
    (am, an) = _node_shape(node.children[0], idx_lens)
    (bm, bn) = _node_shape(node.children[1], idx_lens)
    name = node.op.name
    if "A_TRANS" in name or "A_VNNI_TRANS" in name:
        am, an = an, am
    if "B_TRANS" in name:
        bm, bn = bn, bm
    return am, bn, an


def _is_matmul(node) -> bool:
    return (node.kind in ("binary", "ternary")
            and node.op.name.startswith(("MATMUL", "BRGEMM")))


def _node_shape(node, idx_lens):
    if node.kind == "arg":
        return node.m, node.n
    name = node.op.name
    if _is_matmul(node):
        m_, n_, _k = _matmul_dims(node, idx_lens)
        return m_, n_
    if "REDUCE_TO_SCALAR" in name:
        return 1, 1
    if node.kind == "unary" and _needs_idx(node.op):
        # index-consuming nodes shrink the tensor: cost them (and everything
        # above) at the post-gather dims. GATHER's count is the index
        # vector's length, known from the call's arguments (idx_lens); the
        # reduce variants are (1, child_n)
        cm, cn = _node_shape(node.children[0], idx_lens)
        if node.op != UnaryType.GATHER:
            return 1, cn
        g = idx_lens.get(node.op_arg_pos) if idx_lens else None
        if UnaryFlags(node.flags) & UnaryFlags.GS_COLS:
            return cm, (g if g is not None else cn)
        return (g if g is not None else cm), cn
    shapes = [_node_shape(c, idx_lens) for c in node.children]
    return (max(s[0] for s in shapes),   # eltwise broadcast
            max(s[1] for s in shapes))


def _nflops(node, idx_lens=None):
    total = sum(_nflops(c, idx_lens) for c in node.children)
    if node.kind == "arg":
        return 0
    if _is_matmul(node):
        m_, n_, k_ = _matmul_dims(node, idx_lens)
        # a tensor-set operand multiplies the node's work by its
        # cardinality: BRGEMM reduces `card` matmuls
        card = max([c.set_card for c in node.children
                    if c.kind == "arg"] + [1])
        return total + 2 * m_ * n_ * max(1, k_) * card
    if node.kind == "unary" and _needs_idx(node.op) \
            and node.op != UnaryType.GATHER:
        # idx-reduce reads len(idx) gathered rows of the child: cost the
        # input work, not the (1, n) output
        _cm, cn = _node_shape(node.children[0], idx_lens)
        g = (idx_lens or {}).get(node.op_arg_pos)
        return total + (g if g is not None else _cm) * cn
    m_, n_ = _node_shape(node, idx_lens)
    return total + m_ * n_


def _gather_positions(node, out):
    if node.kind == "unary" and _needs_idx(node.op) and node.op_arg_pos >= 0:
        out.add(node.op_arg_pos)
    for c in node.children:
        _gather_positions(c, out)
    return out


def _load_args(args) -> tuple:
    """Every argument as a tensor: a tensor stays on its device, numpy data
    loads onto the default device (the GPU, raising without one); arguments
    on different devices raise."""
    loaded = tuple(load_operand(a) for a in args)
    devices = {a.device for a in loaded}
    if len(devices) > 1:
        raise ValueError("equation arguments lie on different devices: "
                         f"{sorted(str(d) for d in devices)}")
    return loaded


def dispatch_meqn(idx: int, out_m=None, out_n: int = None,
                  out_type: Datatype = Datatype.F32) -> Kernel:
    """libxsmm_dispatch_meqn analogue: the tree as one kernel.

    The returned kernel takes the args in in_pos order: kernel(arg0, arg1,
    ...). The second arg may be a MeqnArgShape (the reference v2 signature,
    include/libxsmm.h:162) instead of out_m/out_n/out_type.
    """
    if isinstance(out_m, MeqnArgShape):
        out_m, out_n, out_type = out_m.m, out_m.n, out_m.type
    eqn = _eqn(idx)
    if not eqn.is_complete():
        raise ValueError(f"equation {idx} is incomplete")
    desc = ("meqn", _tree_signature(eqn.root), out_m, out_n, out_type)

    def _build(_key):
        out_dt = to_torch(out_type)
        root = eqn.root
        if root.kind == "unary" and root.op == UnaryType.UNZIP \
                and out_type not in (Datatype.U16, Datatype.I16):
            # UNZIP emits raw uint16 bit halves; a value cast to any float
            # type would destroy the bit-split contract
            raise ValueError("UNZIP-rooted equations produce raw 16-bit "
                             "halves: out_type must be U16 or I16 "
                             f"(got {out_type})")
        # the tree is complete, so its signatures are fixed: computed once
        sigs = _signatures(root, {}, {})
        info = KernelInfo(kind="meqn", nflops=max(out_m * out_n,
                                                  _nflops(root)))
        gpos = _gather_positions(root, set())
        # nflops is refined from the index-vector lengths and re-checked on
        # every call: the registry caches this kernel for the tree's
        # lifetime, and a caller may pass index vectors of another length
        last_lens = {}

        def fn(*args):
            args = _load_args(args)
            if gpos:
                lens = {p: int(np.prod(tuple(args[p].shape))) for p in gpos}
                if lens != last_lens:
                    info.nflops = max(out_m * out_n, _nflops(root, lens))
                    last_lens.clear()
                    last_lens.update(lens)
            res = _eval(root, args, {}, sigs)
            if isinstance(res, tuple):
                return tuple(_cast(r, out_dt) for r in res)
            return _cast(res, out_dt)

        return Kernel(fn=fn, descriptor=desc, info=info,
                      name=f"meqn_{out_m}x{out_n}")

    return get_registry().dispatch(desc, _build)


def dispatch_meqn_desc(descriptor: MeqnDescriptor) -> Kernel:
    """libxsmm_dispatch_meqn_desc analogue (include/libxsmm.h:161): dispatch
    from a pre-built equation descriptor. Row-major contract: ldo is part of
    the descriptor for parity, and must equal n (or 0)."""
    if descriptor.ldo not in (0, descriptor.n):
        raise ValueError("row-major contract: ldo must equal n (or 0)")
    return dispatch_meqn(descriptor.eqn_idx, descriptor.m, descriptor.n,
                         descriptor.datatype)


def meqn_destroy(idx: int) -> None:
    with _eqn_lock:
        _equations.pop(idx, None)
