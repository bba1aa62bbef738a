// Hopper (sm_90a) building blocks of the warp-specialised kernels: mbarrier
// init/arrive/expect_tx/try_wait, the 2-D and 3-D cp.async.bulk.tensor
// (TMA) loads and the 1-D bulk copy that complete on an mbarrier, 4- and
// 16-byte cp.async whose completion arrives on an mbarrier, the
// programmatic dependent launch's wait and trigger, the wgmma
// fence/commit/wait, the shared-memory matrix descriptors of 128-, 64- and
// 32-byte swizzled tiles and of unswizzled core matrices, wgmma.m64n128k16
// with bf16 operands and f32 accumulators and the Wg<N> wrappers of
// wgmma.m64nNk16 (N = 8, 16, 32, 64, 128; N = 64 and 128 also with A from
// registers); on the host,
// encode_map (cuTensorMapEncodeTiled) for the TMA maps of every source that
// includes it (gemm_kernels.cu, spmm_kernels.cu, spmm_lab_kernels.cu, and
// through xsmm_flash_fma.cuh the two attention sources). kernels/_build.py
// hashes this header into the name of every library it builds, so an edit
// here rebuilds them all.
//
// Layouts (PTX ISA, "Matrix Descriptor" and "Shared Memory Matrix Layout"):
// a TMA box whose inner extent is 128 bytes, loaded with
// CU_TENSOR_MAP_SWIZZLE_128B into a 1024-byte aligned buffer, stores row r
// at byte r * 128 with its 16-byte chunk c at chunk c ^ (r % 8). wgmma reads
// such a tile through a descriptor with layout type 1 (128-byte swizzle):
//   K-major (A: rows of M, 64 bf16 of K in each 128-byte row): the stride
//     between 8-row groups (SBO) is 1024 bytes, the leading offset unused;
//     the k16 step j starts 32 * j bytes into the row;
//   MN-major (B: rows of K, 64 bf16 of N in each 128-byte row, fed with the
//     transpose bit): SBO is the stride between 8-row groups of K (1024
//     bytes), LBO the stride between 64-column boxes of N; the k16 step j
//     starts 16 * 128 * j bytes in.
// Accumulator fragment of m64nNk16 (f32), thread t of the warpgroup, warp
// w = t / 32, lane l: d[4 j + i] holds row 16 w + l / 4 + 8 (i / 2), column
// 8 j + 2 (l % 4) + (i % 2).

#pragma once

#include <cuda.h>   // CUtensorMap (encode_map looks its encoder up)
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t wg_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(wg_smem(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   wg_smem(bar))
               : "memory");
}

// one arrival that also expects `bytes` of TMA transactions in this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          wg_smem(bar)),
      "r"(bytes)
      : "memory");
}

// spin until the phase of parity `parity` has completed (a fresh barrier
// counts its phase before the first as completed, parity 1)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = wg_smem(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ---------------------------------------------------------------------------
// TMA loads: global (through a tensor map in the kernel's parameter space)
// -> shared, completing `bytes` on the barrier. Coordinates innermost first,
// in elements; out-of-bounds elements are filled with zeros and still count
// as transaction bytes.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(wg_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(wg_smem(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(wg_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(wg_smem(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// a 1-D bulk copy of `bytes` contiguous bytes, global -> shared, completing
// on the barrier; dst, src and bytes are multiples of 16
__device__ __forceinline__ void bulk_load_1d(void* dst, const void* src,
                                             uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(wg_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(wg_smem(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// 4- and 16-byte cp.async paced by an mbarrier (for runs that are not whole
// 16-byte units): the copies of this thread so far arrive on the barrier
// once they have landed (one of the barrier's expected arrivals: .noinc)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   wg_smem(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16_cg(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   wg_smem(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   wg_smem(bar))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Programmatic dependent launch: a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start while the
// kernel before it on the stream still runs, once every block of that one
// has triggered (or exited); pdl_wait then blocks until that kernel has
// completed and its writes are visible. Both are no-ops in a kernel
// launched the usual way.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// a descriptor of the tile at `p`: start address, leading and stride byte
// offsets, layout type (0 none, 1 128-byte, 2 64-byte, 3 32-byte swizzle)
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo, uint32_t type) {
  uint64_t d = (uint64_t)((wg_smem(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)type << 62;
  return d;
}

// a descriptor of a 128-byte swizzled tile at `p` (byte offsets as above)
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* p,
                                                     uint32_t lbo,
                                                     uint32_t sbo) {
  return wgmma_desc(p, lbo, sbo, 1);
}

// a descriptor of a 64-byte swizzled tile at `p` (layout type 2): a TMA box
// whose inner extent is 64 bytes, loaded with CU_TENSOR_MAP_SWIZZLE_64B into
// a 512-byte aligned buffer, stores row r at byte r * 64 with its 16-byte
// chunk c at chunk c ^ ((r / 2) % 4). K-major (rows of M, 32 bf16 of K in
// each row): SBO 512 bytes (8 rows), the k16 step j at 32 * j bytes into the
// row; MN-major (rows of K, 32 bf16 of N in each row, the transpose bit):
// SBO 512 bytes between 8-row groups of K, LBO between 32-column boxes of N,
// the k16 step at 16 * 64 bytes
__device__ __forceinline__ uint64_t wgmma_desc_sw64(const void* p,
                                                    uint32_t lbo,
                                                    uint32_t sbo) {
  return wgmma_desc(p, lbo, sbo, 2);
}

// a descriptor of a 32-byte swizzled tile at `p` (layout type 3): a TMA box
// whose inner extent is 32 bytes, loaded with CU_TENSOR_MAP_SWIZZLE_32B into
// a 256-byte aligned buffer, stores row r at byte r * 32 with its 16-byte
// chunk c at chunk c ^ ((r / 4) % 2). K-major (rows of M, 16 bf16 of K in
// each row: one k16 step): SBO 256 bytes (8 rows); MN-major (rows of K, 16
// bf16 of N in each row, the transpose bit): SBO 256 bytes between 8-row
// groups of K, LBO between 16-column boxes of N, the k16 step at 16 * 32
// bytes
__device__ __forceinline__ uint64_t wgmma_desc_sw32(const void* p,
                                                    uint32_t lbo,
                                                    uint32_t sbo) {
  return wgmma_desc(p, lbo, sbo, 3);
}

// a descriptor of unswizzled core matrices at `p` (layout type 0): a core
// matrix is 8 rows of 16 bytes, 128 contiguous bytes, as a TMA box whose
// inner extent is 16 bytes lands them (CU_TENSOR_MAP_SWIZZLE_NONE into a
// 128-byte aligned buffer: row r at byte r * 16). MN-major (rows of K, 8
// bf16 of N in each row, the transpose bit): LBO the stride between core
// matrices along K (the next 8 rows, 128 bytes in such a box), SBO between
// 8-column groups of N; the k16 step at 16 * 16 bytes
__device__ __forceinline__ uint64_t wgmma_desc_plain(const void* p,
                                                     uint32_t lbo,
                                                     uint32_t sbo) {
  return wgmma_desc(p, lbo, sbo, 0);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of the accumulators across
// a wgmma fence or wait (the asynchronous product owns them in between)
template <int N>
__device__ __forceinline__ void wgmma_fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) += A (64 x 16, K-major) . B (16 x 128, MN-major: the
// transpose bit), bf16 products exact in f32
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64],
                                                      uint64_t desc_a,
                                                      uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// ---------------------------------------------------------------------------
// wgmma.m64nNk16 (N = 8, 16, 32, 64, 128), bf16 x bf16 -> f32 (the Wg<N>
// wrappers of the warp-specialised kernels). d[4 j + i] of thread t (warp w = t /
// 32 of the warpgroup, lane l) is row 16 w + l / 4 + 8 (i / 2), column 8 j +
// 2 (l % 4) + (i % 2). SS: TA / TB are the transpose bits (0: K-major, 1:
// MN-major). RS: a[0..3] is the warp's 16 x 16 slice of A at rows 16 w..,
// the fragment of mma.m16n8k16: a[0] (row l / 4, columns 2 (l % 4) + {0,
// 1}), a[1] (row + 8), a[2] (columns + 8), a[3] (both), the lower column in
// the low half. So the accumulators d[8 k + 0..7] of a product with N >= 16,
// packed to bf16 pairs in order, are the A fragment of the k16 step k of
// the next product: a[2 (j & 1) + h] = {d[4 j + 2 h], d[4 j + 2 h + 1]},
// j = 2 k, 2 k + 1. scale_d = 0 ignores d's values (the first k16 step).
// ---------------------------------------------------------------------------

#define WG_ACC4(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])

#define WG_ACC8(d)                                                         \
  WG_ACC4(d), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])

#define WG_ACC16(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

#define WG_ACC32(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

#define WG_ACC64(d)                                                        \
  WG_ACC32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),         \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),     \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),     \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),     \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),     \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),     \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define WG_REGS4 "{%0, %1, %2, %3}"

#define WG_REGS8 "{%0, %1, %2, %3, %4, %5, %6, %7}"

#define WG_REGS16                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

#define WG_REGS32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"

#define WG_REGS64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63}"

template <int N>
struct Wg;

template <>
struct Wg<8> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[4], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 " WG_REGS4
        ", %4, %5, p, 1, 1, %7, %8;\n"
        "}\n"
        : WG_ACC4(d)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <>
struct Wg<16> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " WG_REGS8
        ", %8, %9, p, 1, 1, %11, %12;\n"
        "}\n"
        : WG_ACC8(d)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <>
struct Wg<32> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WG_REGS16
        ", %16, %17, p, 1, 1, %19, %20;\n"
        "}\n"
        : WG_ACC16(d)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <>
struct Wg<64> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
        ", %32, %33, p, 1, 1, %35, %36;\n"
        "}\n"
        : WG_ACC32(d)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
        "}\n"
        : WG_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
          "n"(TB));
  }
};

template <>
struct Wg<128> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS64
        ", %64, %65, p, 1, 1, %67, %68;\n"
        "}\n"
        : WG_ACC64(d)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
        "}\n"
        : WG_ACC64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
          "n"(TB));
  }
};

#undef WG_ACC4
#undef WG_ACC8
#undef WG_ACC16
#undef WG_ACC32
#undef WG_ACC64
#undef WG_REGS4
#undef WG_REGS8
#undef WG_REGS16
#undef WG_REGS32
#undef WG_REGS64

// ---------------------------------------------------------------------------
// Host: cuTensorMapEncodeTiled, looked up at run time through the CUDA
// runtime (cudaGetDriverEntryPoint), so that no library links to libcuda
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a bf16 or f32 tensor map with zero fill out of bounds and, unless told
// otherwise, 128-byte swizzle (CU_TENSOR_MAP_SWIZZLE_NONE lands a box as
// dense rows of its inner extent, up to 256 elements)
static bool encode_map(
    CUtensorMap* map, CUtensorMapDataType type, const void* base, int rank,
    const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, type, rank, const_cast<void*>(base), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
