"""libxsmm_torch — the PyTorch/CUDA port of libxsmm_tpu for NVIDIA Hopper.

The port keeps the JAX package's contract: `dispatch_*` is expensive and
cached (descriptor-keyed registry, the analogue of the reference's JIT code
registry, src/libxsmm_main.c:2730-2969); the returned kernel is a bare
callable over torch tensors. Module and public names match
`libxsmm_tpu`'s, so each module's counterpart is found by name.

Ported so far:
  * the dense small-GEMM main path: descriptors, registry, GEMM/BRGEMM
    dispatch, and the batched, lane-packed batched and lane-packed
    batch-reduce GEMMs (kernels/csrc/gemm_kernels.cu);
  * the element-wise TPPs (ops/eltwise.py, dispatch_meltw*), with the
    dropout kernel (kernels/csrc/eltwise_kernels.cu);
  * dispatch_flash_attention with the flash-attention forward kernel
    (kernels/csrc/attention_kernels.cu) and its two backward kernels
    (kernels/csrc/attention_bwd_kernels.cu), behind torch autograd;
  * the TPP-Attention encoder block, served and trained
    (models/tpp_attention.py), and the TPP-MLP with SGD and splitSGD
    (models/tpp_mlp.py);
  * the host sparse containers and the block-sparse packed SpGEMM,
    create_packed_spgemm_bcsc with every strategy (ops/sparse.py), with the
    scheduled, k-union, supertile and densify kernels
    (kernels/csrc/spmm_kernels.cu).
The kernels are hand-written CUDA for sm_90a. A kernel follows the device of
its tensors: CUDA tensors launch the CUDA kernel, CPU tensors run its plain
torch version. libxsmm_torch never imports jax or libxsmm_tpu.
"""

from .config import get_config, set_target, set_verbosity
from .descriptor import (BatchReduceConfig, BatchReduceType, BinaryFlags,
                         BinaryPostops, BinaryType, GemmDescriptor, GemmFlags,
                         GemmShape, MeltwBinaryShape, MeltwDescriptor,
                         MeltwTernaryShape, MeltwUnaryShape, SparsePattern,
                         SpgemmConfig, TernaryFlags, TernaryType, UnaryArgops,
                         UnaryFlags, UnaryType, create_gemm_batch_reduce_config,
                         create_gemm_ext_binary_postops,
                         create_gemm_ext_unary_argops, create_gemm_shape,
                         create_meltw_binary_shape, create_meltw_ternary_shape,
                         create_meltw_unary_shape)
from .descriptor import (gemm_descriptor_init, gemm_descriptor_init_brgemm,
                         gemm_descriptor_init_brgemm_ext,
                         gemm_descriptor_init_gemm, meltw_descriptor_init,
                         meltw_descriptor_init2, meqn_descriptor_init)
from .device import (cpuid_arm, cpuid_dot_pack_factor, cpuid_id, cpuid_name,
                     cpuid_rv64, cpuid_vlen32, cpuid_x86, default_device,
                     get_geometry, get_target_archid, on_gpu,
                     set_target_archid)
from .dtypes import (Datatype, from_torch, get_typename, to_torch, typesize)
from .matdiff import (MatdiffInfo, matdiff, matdiff_clear, matdiff_epsilon,
                      matdiff_reduce)
from .registry import (Kernel, KernelInfo, finalize, get_kernel_info,
                       get_meltwkernel_info, get_mmkernel_info,
                       get_registry, get_registry_begin, get_registry_next,
                       init)
from .ops.gemm import (brgemm_pack_factor, dgemm, xmmdispatch,
                       dispatch_brgemm,
                       dispatch_brgemm_ext, dispatch_brgemm_ext_packed,
                       dispatch_brgemm_packed,
                       dispatch_gemm, dispatch_gemm_batched,
                       dispatch_gemm_batched_packed, dispatch_tilecfg_gemm,
                       gemm, pack_batched, sgemm, smm_pack_factor,
                       unpack_batched)
from .ops.eltwise import (bitmask_ld, dispatch_meltw_binary,
                          dispatch_meltw_ternary, dispatch_meltw_unary,
                          pack_bitmask, unpack_bitmask)
from .ops.attention import dispatch_flash_attention
from .ops.sparse import (BcscMatrix, BsrMatrix, CscMatrix, CsrMatrix,
                         create_packed_spgemm_bcsc,
                         create_tilecfg_packed_spgemm_bcsc)

__version__ = "0.1.0"


def dispatch_meltw(descriptor: MeltwDescriptor) -> Kernel:
    """libxsmm_dispatch_meltw analogue (src/libxsmm_main.c:3449): generic
    dispatch from a MeltwDescriptor (meltw_descriptor_init/2), routing on
    the descriptor's operation arity like the reference routes on
    descriptor->operation."""
    d = descriptor
    if d.operation == "unary":
        return dispatch_meltw_unary(
            d.op_type, d.m, d.n, d.flags, d.in_type, d.out_type,
            d.comp_type, d.extra)
    if d.operation == "binary":
        shape = MeltwBinaryShape(
            d.m, d.n, in0_type=d.in_type,
            in1_type=d.in1_type if d.in1_type is not None else d.in_type,
            out_type=d.out_type, comp_type=d.comp_type)
        return dispatch_meltw_binary(d.op_type, shape, int(d.flags))
    if d.operation == "ternary":
        shape = MeltwTernaryShape(
            d.m, d.n, in0_type=d.in_type,
            in1_type=d.in1_type if d.in1_type is not None else d.in_type,
            in2_type=d.in2_type if d.in2_type is not None else d.in_type,
            out_type=d.out_type, comp_type=d.comp_type)
        return dispatch_meltw_ternary(d.op_type, shape, int(d.flags))
    raise ValueError(f"unknown meltw operation {d.operation!r}")


def get_verbosity() -> int:
    """libxsmm_get_verbosity analogue."""
    from .config import CONFIG
    return CONFIG.verbose


def get_registry_info():
    """libxsmm_get_registry_info analogue."""
    return get_registry().get_registry_info()


def xregister(key: bytes, value):
    """libxsmm_xregister analogue (user key-value registry)."""
    return get_registry().xregister(key, value)


def xdispatch(key: bytes):
    return get_registry().xdispatch(key)


def xrelease(key: bytes):
    return get_registry().xrelease(key)


def release_kernel(kernel_or_descriptor):
    """libxsmm_release_kernel analogue."""
    desc = getattr(kernel_or_descriptor, "descriptor", kernel_or_descriptor)
    get_registry().release(desc)


def xclear():
    """libxsmm_xclear analogue: release every user key-value entry."""
    reg = get_registry()
    for key, _ in list(reg.items()):
        reg.xrelease(key)


def cpuid():
    """libxsmm_cpuid analogue: the detected device name (see
    device.GpuGeometry for the per-device knobs)."""
    return get_geometry().name


def get_target_arch() -> str:
    """libxsmm_get_target_arch analogue."""
    return get_geometry().name


def set_target_arch(target) -> None:
    """libxsmm_set_target_arch analogue (None restores auto-detect)."""
    set_target(target)
