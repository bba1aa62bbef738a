"""Kernel descriptors — the universal dispatch currency.

The reference packs every kernel request into a hashable byte descriptor
(`libxsmm_gemm_descriptor` src/libxsmm_main.h:246-289,
`libxsmm_meltw_descriptor` :292-302, `libxsmm_meqn_descriptor` :412-419) and
dispatches by hash+memcmp. Here: frozen dataclasses whose structural hash
keys a cache of built callables (registry.py). The port of
`libxsmm_tpu/descriptor.py`: the same classes, fields and `name()` strings,
so one descriptor can be built in both packages.

Shape/flag semantics follow the reference's typed dispatch structs
(`libxsmm_gemm_shape` include/libxsmm_typedefs.h:747-758,
`libxsmm_gemm_batch_reduce_config` :760-765, gemm_ext argops/postops
:771-788) with one deliberate deviation: arrays are row-major contiguous tensors, so
there are no leading-dimension or pointer fields.
Alpha is fixed to 1 and beta restricted to {0,1} exactly like the reference
(README.md "limited to Alpha:=1").
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

from .dtypes import Datatype


def _hashcache(cls):
    """Cache each instance's structural hash after the first computation.

    Descriptors are the dispatch-cache key: every cache-hit dispatch hashes
    the descriptor, and the dataclass-generated __hash__ recursively re-hashes
    nested shapes/configs and enum members on every call, a large share of
    a cache-hit dispatch. Shape/config objects are long-lived and
    reused across dispatches, so memoizing the hash per instance recovers the
    reference's cheap hot path (crc32 once + memcmp,
    src/libxsmm_main.c:2750-2762). Safe because instances are
    frozen: fields can never change after construction.
    """
    base_hash = cls.__hash__

    def __hash__(self):
        h = self.__dict__.get("_xhash")
        if h is None:
            h = base_hash(self)
            object.__setattr__(self, "_xhash", h)
        return h

    cls.__hash__ = __hash__
    return cls


# ---------------------------------------------------------------------------
# GEMM
# ---------------------------------------------------------------------------

class GemmFlags(enum.IntFlag):
    """Mirrors libxsmm_gemm_flags (include/libxsmm_typedefs.h:468-530).

    Alignment/NTS/tileconfig flags are accepted for API parity but are
    no-ops (the tensor library owns layout and store policy). VNNI flags
    are layout contracts honoured by ops.gemm's dense paths, and the VNNI
    transform ops in eltwise.py exist for data-compat round-trips.
    """

    NONE = 0
    TRANS_A = 1
    TRANS_B = 2
    TRANS_AB = 3
    BETA_0 = 4
    ALIGN_A = 8
    ALIGN_C = 16
    ALIGN_C_NTS_HINT = 32 | 16
    NO_RESET_TILECONFIG = 64
    NO_SETUP_TILECONFIG = 128
    VNNI_A = 256
    VNNI_B = 512
    VNNI_C = 1024
    BATCH_REDUCE_ADDRESS = 8192
    BATCH_REDUCE_OFFSET = 16384
    BATCH_REDUCE_STRIDE = 32768


class BatchReduceType(enum.Enum):
    """libxsmm_gemm_batch_reduce_type (include/libxsmm_typedefs.h:562-567)."""

    NONE = 0
    ADDRESS = 1   # gather A_i/B_i by per-call index arrays
    OFFSET = 2    # gather by element offsets into flat A/B
    STRIDE = 4    # dense leading batch dimension


@_hashcache
@dataclasses.dataclass(frozen=True)
class GemmShape:
    """libxsmm_gemm_shape analogue (include/libxsmm_typedefs.h:747-758).

    C[m,n] += A[m,k] @ B[k,n] in row-major; comp_type is the accumulation
    precision (defaults to F32 for all sub-f32 inputs, F64 for F64).
    """

    m: int
    n: int
    k: int
    a_in_type: Datatype = Datatype.F32
    b_in_type: Datatype = Datatype.F32
    out_type: Datatype = Datatype.F32
    comp_type: Optional[Datatype] = None

    def __post_init__(self):
        if self.comp_type is None:
            comp = Datatype.F64 if self.a_in_type == Datatype.F64 else Datatype.F32
            object.__setattr__(self, "comp_type", comp)

    def nflops(self, br_count: int = 1) -> int:
        return 2 * self.m * self.n * self.k * max(1, br_count)


@_hashcache
@dataclasses.dataclass(frozen=True)
class BatchReduceConfig:
    """libxsmm_gemm_batch_reduce_config analogue."""

    br_type: BatchReduceType = BatchReduceType.NONE
    br_count_hint: int = 0   # static batch count (br_unroll_hint analogue);
                             # 0 = taken from the operand's leading dim


class UnaryFlags(enum.IntFlag):
    """libxsmm_meltw_unary_flags (include/libxsmm_typedefs.h:256-276)."""

    NONE = 0
    BITMASK_2BYTEMULT = 1
    BCAST_ROW = 2
    BCAST_COL = 4
    BCAST_SCALAR = 8
    REDUCE_COLS = 16
    REDUCE_ROWS = 32
    REDUCE_INIT_ACC = 64
    IDX_SIZE_4BYTES = 128
    IDX_SIZE_8BYTES = 256
    REDUCE_INF_ACC = 512
    REDUCE_NO_PREFETCH = 1024
    REDUCE_RECORD_ARGOP = 2048
    STOCHASTIC_ROUND = 4096
    GS_OFFS = 8192
    NTS_HINT = 16384
    # aliases, as in the reference
    GS_ROWS = REDUCE_COLS
    GS_COLS = REDUCE_ROWS
    NO_SCF_QUANT = REDUCE_NO_PREFETCH
    SIGN_SAT_QUANT = REDUCE_COLS


class UnaryType(enum.Enum):
    """libxsmm_meltw_unary_type (include/libxsmm_typedefs.h:278-357)."""

    NONE = 0
    IDENTITY = 1
    XOR = 2            # zero-fill
    X2 = 3
    SQRT = 4
    RELU = 5
    RELU_INV = 6
    TANH = 7
    TANH_INV = 8
    SIGMOID = 9
    SIGMOID_INV = 10
    GELU = 11
    GELU_INV = 12
    NEGATE = 13
    INC = 14
    RECIPROCAL = 15
    RECIPROCAL_SQRT = 16
    EXP = 17
    REDUCE_X_OP_ADD = 18
    REDUCE_X2_OP_ADD = 19
    REDUCE_X_X2_OP_ADD = 20
    REDUCE_X_OP_MAX = 21
    REDUCE_X_OP_MUL = 22
    REDUCE_X_OP_ADD_NCNC_FORMAT = 23
    REDUCE_TO_SCALAR_OP_ADD = 24
    DROPOUT = 25
    DROPOUT_INV = 26
    REPLICATE_COL_VAR = 27
    TRANSFORM_NORM_TO_VNNI2 = 28
    TRANSFORM_NORM_TO_NORMT = 29
    TRANSFORM_VNNI2_TO_VNNI2T = 30
    TRANSFORM_NORM_TO_VNNI2T = 31
    TRANSFORM_NORM_TO_VNNI2_PAD = 32
    UNZIP = 33
    LEAKY_RELU = 34
    LEAKY_RELU_INV = 35
    ELU = 36
    ELU_INV = 37
    STOCHASTIC_ROUND = 38
    TRANSFORM_PADM_MOD2 = 39
    TRANSFORM_PADN_MOD2 = 40
    TRANSFORM_PADNM_MOD2 = 41
    QUANT = 42
    DEQUANT = 43
    REDUCE_COLS_IDX_OP_ADD = 44
    DECOMPRESS_SPARSE_FACTOR_1 = 45
    DECOMPRESS_SPARSE_FACTOR_2 = 46
    DECOMPRESS_SPARSE_FACTOR_4 = 47
    DECOMPRESS_SPARSE_FACTOR_8 = 48
    DECOMPRESS_SPARSE_FACTOR_16 = 49
    DECOMPRESS_SPARSE_FACTOR_32 = 50
    GATHER = 51
    SCATTER = 52
    REDUCE_COLS_IDX_OP_MAX = 53
    TRANSFORM_NORM_TO_VNNI4 = 54
    TRANSFORM_VNNI4_TO_VNNI4T = 55
    TRANSFORM_NORM_TO_VNNI4T = 56
    TRANSFORM_NORM_TO_VNNI4_PAD = 57
    TRANSFORM_PADM_MOD4 = 58
    TRANSFORM_PADN_MOD4 = 59
    TRANSFORM_PADNM_MOD4 = 60
    TRANSFORM_VNNI4_TO_NORM = 61
    TRANSFORM_VNNI4_TO_VNNI2 = 62
    DUMP = 63
    DECOMP_FP32_TO_BF16X2 = 64
    DECOMP_FP32_TO_BF16X3 = 65
    TRANSFORM_VNNI4T_TO_NORM = 66
    TRANSFORM_VNNI2T_TO_NORM = 67
    REDUCE_COLS_IDX_OP_MIN = 68
    REDUCE_X_OP_MIN = 69
    REDUCE_X_OP_ABSMAX = 70
    TRANSFORM_NORM_TO_VNNI8 = 71
    TRANSFORM_VNNI8_TO_VNNI8T = 72
    TRANSFORM_NORM_TO_VNNI8T = 73
    TRANSFORM_NORM_TO_VNNI8_PAD = 74
    TRANSFORM_VNNI8T_TO_NORM = 75
    TRANSFORM_VNNI8_TO_NORM = 76


class BinaryFlags(enum.IntFlag):
    """libxsmm_meltw_binary_flags (include/libxsmm_typedefs.h:369-380)."""

    NONE = 0
    BCAST_ROW_IN_0 = 1
    BCAST_ROW_IN_1 = 2
    BCAST_COL_IN_0 = 4
    BCAST_COL_IN_1 = 8
    BCAST_SCALAR_IN_0 = 16
    BCAST_SCALAR_IN_1 = 32
    STOCHASTIC_ROUND = 64
    BITMASK_2BYTEMULT = 128
    NTS_HINT = 256


class BinaryType(enum.Enum):
    """libxsmm_meltw_binary_type (include/libxsmm_typedefs.h:382-415)."""

    NONE = 0
    ADD = 1
    MUL = 2
    SUB = 3
    DIV = 4
    MULADD = 5        # out = out + in0*in1 (reads previous out)
    MATMUL = 6
    MUL_AND_REDUCE_TO_SCALAR_OP_ADD = 7
    PACK = 8
    MAX = 9
    MIN = 10
    BRGEMM = 11
    BRGEMM_B_TRANS = 12
    BRGEMM_A_TRANS = 13
    BRGEMM_A_TRANS_B_TRANS = 14
    BRGEMM_A_VNNI = 15
    BRGEMM_A_VNNI_B_TRANS = 16
    BRGEMM_A_VNNI_TRANS = 17
    BRGEMM_A_VNNI_TRANS_B_TRANS = 18
    MATMUL_B_TRANS = 19
    MATMUL_A_TRANS = 20
    MATMUL_A_TRANS_B_TRANS = 21
    MATMUL_A_VNNI = 22
    MATMUL_A_VNNI_B_TRANS = 23
    MATMUL_A_VNNI_TRANS = 24
    MATMUL_A_VNNI_TRANS_B_TRANS = 25
    ZIP = 26
    CMP_OP_GT = 27
    CMP_OP_GE = 28
    CMP_OP_LT = 29
    CMP_OP_LE = 30
    CMP_OP_EQ = 31
    CMP_OP_NE = 32


class TernaryFlags(enum.IntFlag):
    """libxsmm_meltw_ternary_flags (include/libxsmm_typedefs.h:417-431)."""

    NONE = 0
    BCAST_ROW_IN_0 = 1
    BCAST_ROW_IN_1 = 2
    BCAST_ROW_IN_2 = 4
    BCAST_COL_IN_0 = 8
    BCAST_COL_IN_1 = 16
    BCAST_COL_IN_2 = 32
    BCAST_SCALAR_IN_0 = 64
    BCAST_SCALAR_IN_1 = 128
    BCAST_SCALAR_IN_2 = 256
    REUSE_IN_2_AS_OUT = 512
    BITMASK_2BYTEMULT = 1024
    STOCHASTIC_ROUND = 2048


class TernaryType(enum.Enum):
    """libxsmm_meltw_ternary_type (include/libxsmm_typedefs.h:433-453)."""

    NONE = 0
    MULADD = 1     # out = in0*in1 + in2
    MATMUL = 2
    SELECT = 3     # out = in2(bitmask) ? in0 : in1
    NMULADD = 4    # out = -(in0*in1) + in2
    BRGEMM = 5
    BRGEMM_B_TRANS = 6
    BRGEMM_A_TRANS = 7
    BRGEMM_A_TRANS_B_TRANS = 8
    BRGEMM_A_VNNI = 9
    BRGEMM_A_VNNI_B_TRANS = 10
    BRGEMM_A_VNNI_TRANS = 11
    BRGEMM_A_VNNI_TRANS_B_TRANS = 12
    MATMUL_B_TRANS = 13
    MATMUL_A_TRANS = 14
    MATMUL_A_TRANS_B_TRANS = 15
    MATMUL_A_VNNI = 16
    MATMUL_A_VNNI_B_TRANS = 17
    MATMUL_A_VNNI_TRANS = 18
    MATMUL_A_VNNI_TRANS_B_TRANS = 19


# ---------------------------------------------------------------------------
# Descriptors (== cache keys)
# ---------------------------------------------------------------------------

@_hashcache
@dataclasses.dataclass(frozen=True)
class GemmDescriptor:
    shape: GemmShape
    flags: GemmFlags = GemmFlags.NONE
    br: BatchReduceConfig = BatchReduceConfig()

    @property
    def beta(self) -> int:
        return 0 if self.flags & GemmFlags.BETA_0 else 1

    @property
    def trans_a(self) -> bool:
        return bool(self.flags & GemmFlags.TRANS_A)

    @property
    def trans_b(self) -> bool:
        return bool(self.flags & GemmFlags.TRANS_B)

    def name(self) -> str:
        """Descriptor-encoded kernel name for profilers.

        Mirrors the reference's jit_name scheme
        (src/libxsmm_main.c:2287-2344), visible in profiler traces via
        torch.profiler.record_function.
        """
        s = self.shape
        t = f"{'t' if self.trans_a else 'n'}{'t' if self.trans_b else 'n'}"
        br = ("" if self.br.br_type == BatchReduceType.NONE
              else f"_br{self.br.br_type.name.lower()}{self.br.br_count_hint}")
        return (f"xsmm_gemm_{s.a_in_type.value}{s.b_in_type.value}"
                f"{s.out_type.value}_{t}_{s.m}x{s.n}x{s.k}"
                f"_beta{self.beta}{br}")


@_hashcache
@dataclasses.dataclass(frozen=True)
class UnaryArgops:
    """libxsmm_gemm_ext_unary_argops analogue (typedefs.h:771-783).

    Optional unary ops applied to A/B before the GEMM and to C after
    accumulation; store_* requests the transformed operand as an extra
    output (functionally returned, not stored in place).
    """

    ap_type: UnaryType = UnaryType.NONE
    ap_flags: UnaryFlags = UnaryFlags.NONE
    store_ap: bool = False
    bp_type: UnaryType = UnaryType.NONE
    bp_flags: UnaryFlags = UnaryFlags.NONE
    store_bp: bool = False
    cp_type: UnaryType = UnaryType.NONE
    cp_flags: UnaryFlags = UnaryFlags.NONE
    store_cp: bool = False


@_hashcache
@dataclasses.dataclass(frozen=True)
class BinaryPostops:
    """libxsmm_gemm_ext_binary_postops analogue (typedefs.h:785-789).

    C = binary(C, D) applied after accumulation, before cp unary; D may be
    broadcast row/col/scalar via the binary flags.
    """

    d_type: BinaryType = BinaryType.NONE
    d_flags: BinaryFlags = BinaryFlags.NONE
    d_in_type: Datatype = Datatype.F32


@_hashcache
@dataclasses.dataclass(frozen=True)
class GemmExtDescriptor:
    base: GemmDescriptor
    argops: UnaryArgops = UnaryArgops()
    postops: BinaryPostops = BinaryPostops()

    def name(self) -> str:
        return self.base.name() + "_ext"


@_hashcache
@dataclasses.dataclass(frozen=True)
class MeltwDescriptor:
    """libxsmm_meltw_descriptor analogue (src/libxsmm_main.h:292-302)."""

    operation: str              # "unary" | "binary" | "ternary"
    op_type: enum.Enum          # UnaryType | BinaryType | TernaryType
    flags: enum.IntFlag
    m: int
    n: int
    in_type: Datatype = Datatype.F32
    out_type: Datatype = Datatype.F32
    comp_type: Datatype = Datatype.F32
    in1_type: Optional[Datatype] = None
    in2_type: Optional[Datatype] = None
    # op-specific static extras (e.g. pad sizes); must stay hashable
    extra: Tuple = ()

    def name(self) -> str:
        return (f"xsmm_{self.operation}_{self.op_type.name.lower()}"
                f"_{self.in_type.value}{self.out_type.value}"
                f"_{self.m}x{self.n}_f{int(self.flags)}")


@_hashcache
@dataclasses.dataclass(frozen=True)
class SpgemmConfig:
    """libxsmm_spgemm_config analogue (include/libxsmm_typedefs.h:740-744)."""

    packed_width: int = 1
    bk: int = 1
    bn: int = 1


@_hashcache
@dataclasses.dataclass(frozen=True)
class SparsePattern:
    """Trace-time fingerprint of a sparsity pattern.

    The analogue of baking the pattern into JIT code
    (generator_spgemm_csr_asparse_reg.c); the fingerprint keys the kernel
    cache so identical patterns share one compiled kernel (SURVEY.md §7.3:
    cheap hash of indptr/indices, no recompile storms).
    """

    format: str                 # "csr" | "csc" | "bcsc" | "bsr"
    rows: int
    cols: int
    nnz: int
    fingerprint: int            # hash of index structure (+ values if baked)
    block: Tuple[int, int] = (1, 1)

    @staticmethod
    def fingerprint_of(*index_arrays, values=None) -> int:
        import hashlib
        import numpy as np

        h = hashlib.blake2b(digest_size=8)
        for arr in index_arrays:
            h.update(np.asarray(arr).tobytes())
        if values is not None:
            h.update(np.asarray(values).tobytes())
        return int.from_bytes(h.digest(), "little")


# ---------------------------------------------------------------------------
# Shape/config constructor functions (reference libxsmm_create_* family,
# src/libxsmm_generator.c:323-455). Row-major contract: leading-dimension
# arguments are accepted for signature parity but must be 0/None or equal
# to the packed row-major stride (the tensor library owns layout).
# ---------------------------------------------------------------------------

def _check_ld(name: str, ld, *packed: int) -> None:
    """Leading dims are signature-parity only (row-major, contiguous tensors):
    accept 0/None or any PACKED width the op family can legally produce —
    the shape constructors cannot know the op/flags yet, so e.g. a unary
    ldo may be the eltwise width n, the transpose output width m, or the
    reduce width 1, and a gemm lda may be k or (TRANS_A) m. Anything else
    is a strided-layout port this library rejects."""
    if ld not in (None, 0, *packed):
        ok = "/".join(str(x) for x in dict.fromkeys(packed))
        raise ValueError(
            f"row-major contract: {name} must be 0/None or packed "
            f"({ok}), got {ld}")


def create_gemm_shape(m: int, n: int, k: int, lda=None, ldb=None, ldc=None,
                      a_in_type: Datatype = Datatype.F32,
                      b_in_type: Datatype = Datatype.F32,
                      out_type: Datatype = Datatype.F32,
                      comp_type: Datatype = None) -> GemmShape:
    """libxsmm_create_gemm_shape (src/libxsmm_generator.c:323-341).

    The reference is column-major (lda >= m); here arrays are row-major so
    the packed leading dims are k/n/n for A/B/C."""
    # STRICT natural dims for GEMM (unlike meltw ldo, where the output
    # shape is genuinely op-dependent): accepting the column-major
    # canonical lda=m / ldb=k here would silently validate exactly the
    # most likely porting mistake; a transposed-operand port passes
    # 0/None
    _check_ld("lda", lda, k)
    _check_ld("ldb", ldb, n)
    _check_ld("ldc", ldc, n)
    return GemmShape(m=m, n=n, k=k, a_in_type=Datatype(a_in_type),
                     b_in_type=Datatype(b_in_type),
                     out_type=Datatype(out_type),
                     comp_type=None if comp_type is None
                     else Datatype(comp_type))


def create_gemm_batch_reduce_config(br_type: BatchReduceType,
                                    br_stride_a_hint: int = 0,
                                    br_stride_b_hint: int = 0,
                                    br_unroll_hint: int = 0
                                    ) -> BatchReduceConfig:
    """libxsmm_create_gemm_batch_reduce_config (src/libxsmm_generator.c:344).

    Byte-stride hints are advisory in the reference; here BRGEMM operands
    are stacked row-major arrays whose strides the tensor library derives, so the hints are
    accepted for signature parity and not used. br_unroll_hint maps to the
    static batch-count hint."""
    return BatchReduceConfig(br_type=BatchReduceType(br_type),
                             br_count_hint=int(br_unroll_hint))


def create_gemm_ext_unary_argops(ldap=None, ap_unary_type=UnaryType.NONE,
                                 ap_unary_flags=UnaryFlags.NONE,
                                 store_ap: bool = False,
                                 ldbp=None, bp_unary_type=UnaryType.NONE,
                                 bp_unary_flags=UnaryFlags.NONE,
                                 store_bp: bool = False,
                                 ldcp=None, cp_unary_type=UnaryType.NONE,
                                 cp_unary_flags=UnaryFlags.NONE,
                                 store_cp: bool = False) -> UnaryArgops:
    """libxsmm_create_gemm_ext_unary_argops (src/libxsmm_generator.c:359-379).
    ld* args accepted for parity (row-major contiguous layout)."""
    return UnaryArgops(ap_type=UnaryType(ap_unary_type),
                       ap_flags=UnaryFlags(ap_unary_flags),
                       store_ap=bool(store_ap),
                       bp_type=UnaryType(bp_unary_type),
                       bp_flags=UnaryFlags(bp_unary_flags),
                       store_bp=bool(store_bp),
                       cp_type=UnaryType(cp_unary_type),
                       cp_flags=UnaryFlags(cp_unary_flags),
                       store_cp=bool(store_cp))


def create_gemm_ext_binary_postops(ldd=None,
                                   d_in_type: Datatype = Datatype.F32,
                                   d_binary_type=BinaryType.NONE,
                                   d_binary_flags=BinaryFlags.NONE
                                   ) -> BinaryPostops:
    """libxsmm_create_gemm_ext_binary_postops (src/libxsmm_generator.c:382)."""
    return BinaryPostops(d_type=BinaryType(d_binary_type),
                         d_flags=BinaryFlags(d_binary_flags),
                         d_in_type=Datatype(d_in_type))


@_hashcache
@dataclasses.dataclass(frozen=True)
class MeltwUnaryShape:
    """libxsmm_meltw_unary_shape (include/libxsmm_typedefs.h:593-601)."""
    m: int
    n: int
    ldi: Optional[int] = None
    ldo: Optional[int] = None
    in0_type: Datatype = Datatype.F32
    out_type: Datatype = Datatype.IMPLICIT
    comp_type: Datatype = Datatype.F32


@_hashcache
@dataclasses.dataclass(frozen=True)
class MeltwBinaryShape:
    """libxsmm_meltw_binary_shape (include/libxsmm_typedefs.h:603-613)."""
    m: int
    n: int
    ldi: Optional[int] = None
    ldi2: Optional[int] = None
    ldo: Optional[int] = None
    in0_type: Datatype = Datatype.F32
    in1_type: Datatype = Datatype.F32
    out_type: Datatype = Datatype.IMPLICIT
    comp_type: Datatype = Datatype.F32


@_hashcache
@dataclasses.dataclass(frozen=True)
class MeltwTernaryShape:
    """libxsmm_meltw_ternary_shape (include/libxsmm_typedefs.h:615-627)."""
    m: int
    n: int
    ldi: Optional[int] = None
    ldi2: Optional[int] = None
    ldi3: Optional[int] = None
    ldo: Optional[int] = None
    in0_type: Datatype = Datatype.F32
    in1_type: Datatype = Datatype.F32
    in2_type: Datatype = Datatype.F32
    out_type: Datatype = Datatype.IMPLICIT
    comp_type: Datatype = Datatype.F32


def create_meltw_unary_shape(m: int, n: int, ldi=None, ldo=None,
                             in0_type: Datatype = Datatype.F32,
                             out_type: Datatype = Datatype.IMPLICIT,
                             comp_type: Datatype = Datatype.F32
                             ) -> MeltwUnaryShape:
    """libxsmm_create_meltw_unary_shape (src/libxsmm_generator.c:395)."""
    _check_ld("ldi", ldi, n)
    _check_ld("ldo", ldo, n, m, 1)
    return MeltwUnaryShape(m, n, ldi, ldo, Datatype(in0_type),
                           Datatype(out_type), Datatype(comp_type))


def create_meltw_binary_shape(m: int, n: int, ldi=None, ldi2=None, ldo=None,
                              in0_type: Datatype = Datatype.F32,
                              in1_type: Datatype = Datatype.F32,
                              out_type: Datatype = Datatype.IMPLICIT,
                              comp_type: Datatype = Datatype.F32
                              ) -> MeltwBinaryShape:
    """libxsmm_create_meltw_binary_shape (src/libxsmm_generator.c:413)."""
    for nm, ld in (("ldi", ldi), ("ldi2", ldi2)):
        _check_ld(nm, ld, n)
    _check_ld("ldo", ldo, n, m, 1)
    return MeltwBinaryShape(m, n, ldi, ldi2, ldo, Datatype(in0_type),
                            Datatype(in1_type), Datatype(out_type),
                            Datatype(comp_type))


def create_meltw_ternary_shape(m: int, n: int, ldi=None, ldi2=None, ldi3=None,
                               ldo=None,
                               in0_type: Datatype = Datatype.F32,
                               in1_type: Datatype = Datatype.F32,
                               in2_type: Datatype = Datatype.F32,
                               out_type: Datatype = Datatype.IMPLICIT,
                               comp_type: Datatype = Datatype.F32
                               ) -> MeltwTernaryShape:
    """libxsmm_create_meltw_ternary_shape (src/libxsmm_generator.c:433)."""
    for nm, ld in (("ldi", ldi), ("ldi2", ldi2), ("ldi3", ldi3)):
        _check_ld(nm, ld, n)
    _check_ld("ldo", ldo, n, m, 1)
    return MeltwTernaryShape(m, n, ldi, ldi2, ldi3, ldo, Datatype(in0_type),
                             Datatype(in1_type), Datatype(in2_type),
                             Datatype(out_type), Datatype(comp_type))


# ---------------------------------------------------------------------------
# Descriptor constructor functions (reference libxsmm_*_descriptor_init
# family, include/libxsmm_generator.h:40-75). The reference writes into a
# caller-provided descriptor blob; here descriptors are immutable values,
# so each init returns the descriptor directly. No prefetch argument: the
# kernels own prefetching (the reference's prefetch strategies are JIT knobs).
# ---------------------------------------------------------------------------

def gemm_descriptor_init(a_type: Datatype, b_type: Datatype,
                         comp_type: Datatype, c_type: Datatype,
                         m: int, n: int, k: int,
                         lda=None, ldb=None, ldc=None,
                         flags: GemmFlags = GemmFlags.NONE) -> GemmDescriptor:
    """libxsmm_gemm_descriptor_init (include/libxsmm_generator.h:42):
    generic dtype-explicit constructor."""
    shape = create_gemm_shape(m, n, k, lda, ldb, ldc, a_type, b_type,
                              c_type, comp_type)
    return GemmDescriptor(shape, GemmFlags(flags))


def gemm_descriptor_init_gemm(shape: GemmShape,
                              flags: GemmFlags = GemmFlags.NONE
                              ) -> GemmDescriptor:
    """libxsmm_gemm_descriptor_init_gemm (include/libxsmm_generator.h:65)."""
    return GemmDescriptor(shape, GemmFlags(flags))


def gemm_descriptor_init_brgemm(shape: GemmShape, flags: GemmFlags,
                                brgemm_config: BatchReduceConfig
                                ) -> GemmDescriptor:
    """libxsmm_gemm_descriptor_init_brgemm (libxsmm_generator.h:67)."""
    return GemmDescriptor(shape, GemmFlags(flags), brgemm_config)


def gemm_descriptor_init_brgemm_ext(shape: GemmShape, flags: GemmFlags,
                                    brgemm_config: BatchReduceConfig,
                                    unary_argops: "UnaryArgops" = None,
                                    binary_postops: "BinaryPostops" = None
                                    ) -> GemmExtDescriptor:
    """libxsmm_gemm_descriptor_init_brgemm_ext (libxsmm_generator.h:70)."""
    return GemmExtDescriptor(
        GemmDescriptor(shape, GemmFlags(flags), brgemm_config),
        unary_argops or UnaryArgops(), binary_postops or BinaryPostops())


def meltw_descriptor_init(in_type: Datatype, out_type: Datatype,
                          m: int, n: int, ldo=None, ldi=None,
                          flags=0, op_type=None, operation: str = "unary"
                          ) -> MeltwDescriptor:
    """libxsmm_meltw_descriptor_init (include/libxsmm_generator.h:48). The
    reference's numeric `param` is the op enum; pass the typed enum member
    as op_type."""
    return meltw_descriptor_init2(in_type, None, None, Datatype.F32,
                                  out_type, m, n, ldi, ldo, None, None,
                                  flags, op_type, operation)


def meltw_descriptor_init2(in0_type: Datatype, in1_type, in2_type,
                           comp_type: Datatype, out_type: Datatype,
                           m: int, n: int, ldi=None, ldo=None,
                           ldi2=None, ldi3=None,
                           flags=0, op_type=None, operation: str = "unary"
                           ) -> MeltwDescriptor:
    """libxsmm_meltw_descriptor_init2 (include/libxsmm_generator.h:53)."""
    if op_type is None:
        raise ValueError("op_type (the reference's `param`) is required")
    for nm, ld in (("ldi", ldi), ("ldi2", ldi2), ("ldi3", ldi3)):
        _check_ld(nm, ld, n)
    _check_ld("ldo", ldo, n, m, 1)
    default_flags = {"unary": UnaryFlags, "binary": BinaryFlags,
                     "ternary": TernaryFlags}
    if operation not in default_flags:
        raise ValueError(f"operation must be one of {list(default_flags)}")
    return MeltwDescriptor(
        operation=operation, op_type=op_type,
        flags=default_flags[operation](flags), m=m, n=n,
        in_type=Datatype(in0_type), out_type=Datatype(out_type),
        comp_type=Datatype(comp_type),
        in1_type=None if in1_type is None else Datatype(in1_type),
        in2_type=None if in2_type is None else Datatype(in2_type))


def meqn_descriptor_init(out_type: Datatype, m: int, n: int, ldo=None,
                         eqn_idx: int = 0):
    """libxsmm_meqn_descriptor_init (include/libxsmm_generator.h:60):
    (eqn_idx, out shape/type) pair consumed by dispatch_meqn_desc."""
    _check_ld("ldo", ldo, n)
    return (int(eqn_idx), m, n, Datatype(out_type))
