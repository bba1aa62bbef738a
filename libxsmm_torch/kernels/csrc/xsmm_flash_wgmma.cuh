// Building blocks of the bf16 flash-attention backward on wgmma (route
// "wgmma": flash_bwd_dkv_wgmma_kernel and flash_bwd_dq_wgmma_kernel in
// attention_bwd_kernels.cu): the tile plans, the shared-memory budgets, a
// warpgroup's own barrier, and wgmma m64nNk16 (N = 64, 128) with bf16
// operands and f32 accumulators in both forms: A and B from shared memory
// (SS), each K-major or MN-major (the transpose bits), and A from registers
// (RS), B K-major or MN-major. kernels/_build.py hashes this header into the
// name of every library it builds.
//
// Every block is one producer warpgroup, whose first lane keeps TMA copies in
// flight into a ring of stages (full and empty mbarriers), and two consumer
// warpgroups, each owning 64 rows of the block's output tile. The producer
// gives its registers back (setmaxnreg, xsmm_flash_fma.cuh: 24 a thread) so
// that each consumer thread may hold 240; at a padded hd of 128 a consumer
// thread holds 192 accumulator registers (dK/dV: S^T and dP^T 32 each, dV
// and dK 64 each; dQ: S and dP 64 each, dQ 64).
//
// Every tile is a set of 128-byte swizzled TMA boxes whose inner extent is
// 64 bf16 (xsmm_wgmma.cuh's layouts): a row-major (rows, hd) operand (Q,
// dO, V) lands as hd / 64 boxes of (rows x 64), a K^T tile as 64-key boxes
// of (hd rows x 64 keys). The same landed tile serves as a K-major operand
// (the reduction along its 128-byte rows) and as an MN-major one (the
// reduction down its rows), so no tile is transposed in shared memory.
// Columns and rows past hd arrive as TMA's zero fill.

#pragma once

#include "xsmm_flash_fma.cuh"   // TF_* thread counts, setmaxnreg budgets

constexpr int FW_BQ = 64;          // dK/dV: query rows a ring stage
constexpr int FW_BKV = 128;        // dK/dV: keys a block, 64 a warpgroup
constexpr int FW_DQ_BQ = 128;      // dQ: query rows a block, 64 a warpgroup
constexpr int FW_DQ_BK = 128;      // dQ: keys a ring stage
constexpr int FW_DKV_STAGES = 3;   // the dK/dV ring
constexpr int FW_DQ_STAGES = 2;    // the dQ ring
constexpr int FW_BOX = 8192;       // a 64 x 64 bf16 box: 64 rows of 128 B
constexpr int FW_HDP_MAX = 128;    // the largest padded hd the route takes

static_assert(FW_DQ_BQ == FW_DQ_BK,
              "causal dQ: the K tiles up to the diagonal are qi + 1");

// shared memory a block asks for, hd padded to 64 or 128: the alignment
// slack, the tiles, the ring and the barriers
__host__ __device__ constexpr int fw_dkv_smem(int hdp) {
  // K^T (hdp x 128 keys) and V (128 keys x hdp) once; a stage: Q and dO
  // (64 x hdp each), the stage's lse and delta rows (64 f32 each);
  // full/empty + the K/V barrier
  return TF_ALIGN + 2 * FW_BKV * hdp * 2 +
         FW_DKV_STAGES * (2 * FW_BQ * hdp * 2 + 2 * FW_BQ * 4) +
         (2 * FW_DKV_STAGES + 1) * 8;
}

__host__ __device__ constexpr int fw_dq_smem(int hdp) {
  // Q and dO (128 x hdp each) once; a stage: K^T (hdp x 128 keys) and V
  // (128 keys x hdp); full/empty + the Q/dO barrier
  return TF_ALIGN + 2 * FW_DQ_BQ * hdp * 2 +
         FW_DQ_STAGES * 2 * FW_DQ_BK * hdp * 2 + (2 * FW_DQ_STAGES + 1) * 8;
}

static_assert(fw_dkv_smem(FW_HDP_MAX) <= TF_SMEM_MAX &&
                  fw_dq_smem(FW_HDP_MAX) <= TF_SMEM_MAX,
              "a block's tiles and ring fit 227 KB");

// one consumer warpgroup's own barrier (ids 3 and 4; xsmm_flash_fma.cuh
// holds 1 and 2)
__device__ __forceinline__ void fw_wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
}

// ---------------------------------------------------------------------------
// wgmma.m64nNk16, bf16 x bf16 -> f32. d[4 j + i] of thread t (warp w = t /
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

#define FW_ACC32(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

#define FW_ACC64(d)                                                        \
  FW_ACC32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),         \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),     \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),     \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),     \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),     \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),     \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define FW_REGS32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"

#define FW_REGS64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63}"

template <int N>
struct Wg;

template <>
struct Wg<64> {
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FW_REGS32
        ", %32, %33, p, 1, 1, %35, %36;\n"
        "}\n"
        : FW_ACC32(d)
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
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FW_REGS32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
        "}\n"
        : FW_ACC32(d)
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
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FW_REGS64
        ", %64, %65, p, 1, 1, %67, %68;\n"
        "}\n"
        : FW_ACC64(d)
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
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FW_REGS64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
        "}\n"
        : FW_ACC64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
          "n"(TB));
  }
};

#undef FW_ACC32
#undef FW_ACC64
#undef FW_REGS32
#undef FW_REGS64

// the descriptor of a 128-byte swizzled operand at p (xsmm_wgmma.cuh):
// K-major, the k16 step at +32 bytes within a box (the leading offset
// unused); MN-major, the k16 step at +2048 bytes (16 rows) and `box` bytes
// between the 64-wide boxes of M or N
__device__ __forceinline__ uint64_t fw_kmajor(const void* p) {
  return wgmma_desc_sw128(p, 16, 1024);
}

__device__ __forceinline__ uint64_t fw_mnmajor(const void* p, uint32_t box) {
  return wgmma_desc_sw128(p, box, 1024);
}
