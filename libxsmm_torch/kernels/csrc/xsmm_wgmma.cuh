// Hopper (sm_90a) building blocks of the warp-specialised kernels: mbarrier
// init/arrive/expect_tx/try_wait, the 2-D and 3-D cp.async.bulk.tensor
// (TMA) loads and the 1-D bulk copy that complete on an mbarrier, 4- and
// 16-byte cp.async whose completion arrives on an mbarrier, the wgmma
// fence/commit/wait, the shared-memory matrix descriptor of a 128-byte
// swizzled tile and wgmma.m64n128k16 with bf16 operands and f32
// accumulators. kernels/_build.py hashes this header into the name of every
// library it builds, so an edit here rebuilds them all.
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

#include <cuda.h>   // CUtensorMap (a type only: the map is encoded on the host)
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
// wgmma
// ---------------------------------------------------------------------------

// a descriptor of a 128-byte swizzled tile at `p` (byte offsets as above)
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* p,
                                                     uint32_t lbo,
                                                     uint32_t sbo) {
  uint64_t d = (uint64_t)((wg_smem(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;   // layout type 1: 128-byte swizzle
  return d;
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
