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
  * the sparse layer (ops/sparse.py): the host containers, the CSR/CSC
    packed SpGEMM routings, create_spgemm_csr_areg and the block-sparse
    create_packed_spgemm_bcsc with every strategy, its autotuned pick
    persisted in the native KV log (native.py); the scheduled, k-union,
    union RHS compactor, supertile and densify kernels
    (kernels/csrc/spmm_kernels.cu); fsspmdm (ops/fsspmdm.py) and the packed
    SOA GEMM (ops/packed.py);
  * the fused GEMM-ext (dispatch_brgemm_ext, ops/gemm.py), the quant, MX
    and sub-byte operands (quant.py, the MX/sub-byte GEMM decoders), the
    rng module, and stochastic rounding with its kernel
    (kernels/csrc/eltwise_kernels.cu);
  * the TPP-CNN model (models/tpp_cnn.py), its conv as the BRGEMM-ext,
    and the TPP-GCN model on one device (models/tpp_gcn.py);
  * the timer (utils/timer.py), the streaming twins of the packed BRGEMM
    and the packed SMM (kernels/gemm.py), and the two labs
    (scripts/brgemm_lab.py, scripts/bcsc_lab.py, with the BCSC probe
    kernels of kernels/csrc/spmm_lab_kernels.cu);
  * matrix equations (ops/equation.py, dispatch_meqn: the tree evaluated
    on torch ops), the TPP-MoE model (models/tpp_moe.py), and the host
    utilities utils/{mathx,sync,memutil,mtx}.py;
  * the parallel layer on torch.distributed (parallel/), and the sharded
    train steps of the five models on it (parallel/spmd.py, each model's
    shard_params / make_sharded_train_step);
  * the tooling: Kernel.lower_text / dump (lowering.py: one call's aten
    operators and, on the card, its CUDA launches with their resources and
    SASS), the generator entry points (generator.py), AOT export of built
    kernels into the KV log (aot.py), the xsmm-gen CLI (utils/cli.py), the
    native registry bindings (native.py), the reference-oracle loader
    (utils/refimpl.py) and the multi-device dry run (scripts/dryrun.py).
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
from .rng import (RngState, create_extstate as rng_create_extstate,
                  destroy_extstate as rng_destroy_extstate,
                  f32_seq as rng_f32_seq,
                  get_extstate_size as rng_get_extstate_size,
                  lsfr_i32, rand_u32 as rng_u32, rand_u64 as rng_u64,
                  rng_f64, rng_seq, set_seed as rng_set_seed)
from .quant import (convert_bf16_f32, convert_bf16_fp32, convert_bf8_f32,
                    convert_bf8_fp32, convert_bf16_to_f32, convert_bf8_to_f32,
                    convert_f16_to_f32, convert_hf8_to_f32,
                    convert_f16_to_hf8_rne, convert_f32_to_bf16_rnaz,
                    convert_f32_to_bf16_rne, convert_f32_to_bf16_truncate,
                    convert_f32_to_bf8_rne, convert_f32_to_bf8_stochastic,
                    convert_f32_to_f16, convert_f32_to_hf8_rne,
                    convert_f16_f32, convert_f16_fp32,
                    convert_fp32_f16, convert_hf8_f32, convert_hf8_fp32,
                    dequantize_i16, quantize_i16, rnaz_convert_fp32_bf16,
                    rne_convert_f16_hf8, rne_convert_fp32_bf16,
                    rne_convert_fp32_bf8, rne_convert_fp32_f16,
                    rne_convert_fp32_hf8, stochastic_convert_fp32_bf16,
                    stochastic_convert_fp32_bf8, truncate_convert_f32_bf16,
                    truncate_convert_fp32_bf16)
from .utils.mathx import (coprime, coprime2, dsqrt, gcd, icbrt_u32,
                          icbrt_u64, isqrt2_u32, isqrt_u32, isqrt_u64,
                          kahan_sum, lcm, nearbyint, nearbyintf, primes_u32,
                          product_limit, remainder, sexp2, sexp2_i8,
                          sexp2_i8i, sexp2_u8, ssqrt, stanh_pade78,
                          widen_u32i64, widen_u32u64)
from .utils.sync import (Barrier, barrier_create, barrier_destroy,
                         barrier_init, barrier_wait, get_pid, get_tid,
                         stdio_acquire, stdio_release)
from .utils.memutil import (aligned, aligned_malloc, diff, diff_n, free,
                            get_malloc_info, hash, hash8, hash16, hash32,
                            hash_string, memcmp, offset, realloc, strimatch,
                            stristr, stristrn)
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
from .ops.equation import (MatrixArgAttributes, MeqnArgMetadata,
                           MeqnArgShape, MeqnDescriptor, MeqnOpMetadata,
                           create_matrix_arg_attributes,
                           create_meqn_arg_metadata, create_meqn_arg_shape,
                           create_meqn_op_metadata, dispatch_meqn,
                           dispatch_meqn_desc, meqn_create, meqn_destroy,
                           meqn_push_back_arg, meqn_push_back_binary_op,
                           meqn_push_back_ternary_op, meqn_push_back_unary_op,
                           meqn_rpn_print, meqn_tree_print)
from .ops.fsspmdm import (Fsspmdm, dfsspmdm_create, dfsspmdm_destroy,
                          dfsspmdm_execute, fsspmdm_create, fsspmdm_destroy,
                          fsspmdm_execute, sfsspmdm_create, sfsspmdm_destroy,
                          sfsspmdm_execute)
from .ops.sparse import (BcscMatrix, BsrMatrix, CscMatrix, CsrMatrix,
                         create_packed_spgemm_bcsc, create_packed_spgemm_csc,
                         create_packed_spgemm_csc_csparse,
                         create_packed_spgemm_csr_bsparse,
                         create_tilecfg_packed_spgemm_bcsc,
                         create_packed_spgemm_csr, create_spgemm_csr_areg)
from .ops.packed import (create_packed_gemm, create_packed_gemm_ac_rm,
                         create_packed_gemm_bc_rm)
from .generator import (GeneratedCode, XsmmGeneratorError,
                        generator_gemm_directasm, generator_gemm_inlineasm,
                        generator_gemm_kernel,
                        generator_gemm_reference_kernel,
                        generator_mateltwise_kernel,
                        generator_mateltwise_reference_kernel,
                        generator_matequation_kernel,
                        generator_matequation_reference_kernel,
                        generator_packed_gemm, generator_packed_gemm_ac_rm,
                        generator_packed_gemm_bc_rm,
                        generator_packed_spgemm_bcsc_kernel,
                        generator_packed_spgemm_csc_kernel,
                        generator_packed_spgemm_csr_kernel,
                        generator_spgemm, generator_spgemm_csc_kernel,
                        generator_spgemm_csr_kernel,
                        generator_spgemm_csr_reg_kernel, strerror)
from .utils.timer import (TimerInfo, get_timer_info,
                          tick as timer_tick, duration as timer_duration,
                          tickint as timer_tickint,
                          ncycles as timer_ncycles)

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


def malloc(size: int):
    """libxsmm_malloc analogue (include/libxsmm_malloc.h:17): default-
    aligned host buffer; pair with free()."""
    return aligned_malloc(size)


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
