// Building blocks of the bf16 flash attention on wgmma (route "wgmma":
// flash_fwd_wgmma_kernel in attention_kernels.cu, flash_bwd_dkv_wgmma_kernel
// and flash_bwd_dq_wgmma_kernel in attention_bwd_kernels.cu): the tile plans,
// the shared-memory budgets, a warpgroup's own barrier, exp2 by the SFU and the
// hold that orders a tile's second half after its first half's products. The
// backward has two plans: up to a padded hd of 128 a dK/dV block owns 128 keys
// and a dQ block streams 128-key tiles; past it (the "wide" kernels, hd padded
// to 192 or 256) a dK/dV block owns 64 keys, its two warpgroups splitting hd's
// columns of dK and dV, and a dQ block streams 64-key K^T and V tiles as
// separate ring units. The products are xsmm_wgmma.cuh's Wg<N> (wgmma m64nNk16,
// bf16 operands, f32 accumulators, A from shared memory or from registers).
// kernels/_build.py hashes this header into the name of every library it
// builds.
//
// Every block is one producer warpgroup, whose first lane keeps TMA copies in
// flight into a ring of stages (full and empty mbarriers), and two consumer
// warpgroups, each owning 64 rows of the block's output tile. The producer
// gives its registers back (setmaxnreg, xsmm_flash_fma.cuh: 24 a thread) so
// that each consumer thread may hold 240; at a padded hd of 128 a consumer
// thread holds 192 accumulator registers in the backward (dK/dV: S^T and
// dP^T 32 each, dV and dK 64 each; dQ: S and dP 64 each, dQ 64) and 160 in
// the forward (S 64, O 64, P as 32 bf16 pairs); past hd 128 the forward's
// 64-key tiles hold it to 176 at hd 256 (S 32, O 128, P 16), and the wide
// backward's plans to 224 (dK/dV: S^T and dP^T 32 each, dV and dK 64 each
// over half of hd, p~ and dS 16 bf16 pairs each) and 208 (dQ: S and dP 32
// each, dQ 128, dS 16 pairs).
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
constexpr int FW_HDP_MAX = 128;    // the largest padded hd of the backward's
                                   // 128-key plan; past it the wide plan's
constexpr int FW_WIDE_BKV = 64;    // wide dK/dV: keys a block, both groups
constexpr int FW_DKV_WIDE_STAGES = 2;   // wide dK/dV: its ring
constexpr int FW_WIDE_BK = 64;     // wide dQ: keys a ring unit
constexpr int FW_FWD_HDP_MAX = 256;   // every hd the entries take

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

// past hd 128 (hd padded to 192 or 256), the wide dK/dV kernel: K^T
// (hdp x 64 keys) and V (64 keys x hdp) once; a stage: Q and dO 256
// columns wide at either bucket (each warpgroup's 128 columns of dV and dK
// read whole boxes; at 192 the last box is TMA's zero fill), the stage's
// lse and delta rows (64 f32 each); full/empty + the K/V barrier. Two
// stages: three would not fit
__host__ __device__ constexpr int fw_dkv_wide_smem(int hdp) {
  return TF_ALIGN + 2 * FW_WIDE_BKV * hdp * 2 +
         FW_DKV_WIDE_STAGES * (2 * FW_BQ * 256 * 2 + 2 * FW_BQ * 4) +
         (2 * FW_DKV_WIDE_STAGES + 1) * 8;
}

// the wide dQ kernel's ring units (a 64-key K^T or V tile each): four at
// 192, three at 256
__host__ __device__ constexpr int fw_dq_wide_units(int hdp) {
  return hdp <= 192 ? 4 : 3;
}

// Q and dO (128 x hdp each) once; the units; full/empty + the Q/dO barrier
__host__ __device__ constexpr int fw_dq_wide_smem(int hdp) {
  return TF_ALIGN + 2 * FW_DQ_BQ * hdp * 2 +
         fw_dq_wide_units(hdp) * FW_WIDE_BK * hdp * 2 +
         (2 * fw_dq_wide_units(hdp) + 1) * 8;
}

// the forward's K tile, hd padded to 64, 128, 192 or 256: 128 keys up to hd
// 128 (dQ's tiles), 64 past it, where O (64 x hdp f32 a warpgroup) takes up
// to 128 registers a consumer thread and S and P must shrink beside it
__host__ __device__ constexpr int fw_fwd_bk(int hdp) {
  return hdp <= 128 ? 128 : 64;
}

// the forward's ring: three stages, two at hd 256 (three would not fit)
__host__ __device__ constexpr int fw_fwd_stages(int hdp) {
  return hdp <= 192 ? 3 : 2;
}

// the forward: Q (128 x hdp) once; a stage: K^T (hdp x bk keys) and V (bk
// keys x hdp); full/empty + the Q barrier
__host__ __device__ constexpr int fw_fwd_smem(int hdp) {
  return TF_ALIGN + FW_DQ_BQ * hdp * 2 +
         fw_fwd_stages(hdp) * 2 * fw_fwd_bk(hdp) * hdp * 2 +
         (2 * fw_fwd_stages(hdp) + 1) * 8;
}

static_assert(fw_dkv_smem(FW_HDP_MAX) <= TF_SMEM_MAX &&
                  fw_dq_smem(FW_HDP_MAX) <= TF_SMEM_MAX &&
                  fw_fwd_smem(128) <= TF_SMEM_MAX &&
                  fw_fwd_smem(192) <= TF_SMEM_MAX &&
                  fw_fwd_smem(FW_FWD_HDP_MAX) <= TF_SMEM_MAX &&
                  fw_dkv_wide_smem(192) <= TF_SMEM_MAX &&
                  fw_dkv_wide_smem(256) <= TF_SMEM_MAX &&
                  fw_dq_wide_smem(192) <= TF_SMEM_MAX &&
                  fw_dq_wide_smem(256) <= TF_SMEM_MAX,
              "a block's tiles and ring fit 227 KB");

// one consumer warpgroup's own barrier (ids 3 and 4; xsmm_flash_fma.cuh
// holds 1 and 2, the forward's ping-pong 5 and 6)
__device__ __forceinline__ void fw_wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
}

// 2^x by the SFU, denormal results flushed to zero
__device__ __forceinline__ float fw_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// keeps the compiler from moving the reads of d[LO..HI) above this point:
// the second half of a tile's scores is converted after the first half's
// products are issued, so that the tensor cores run them meanwhile
template <int LO, int HI, int N>
__device__ __forceinline__ void fw_hold(float (&d)[N]) {
#pragma unroll
  for (int i = LO; i < HI; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

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
