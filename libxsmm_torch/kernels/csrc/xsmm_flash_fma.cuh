// Building blocks of the f32 flash-attention kernels on TMA-fed FMA tiles
// (route "tma_fma": flash_fwd_tma_fma_kernel in attention_kernels.cu,
// flash_bwd_dkv_tma_fma_kernel and flash_bwd_dq_tma_fma_kernel in
// attention_bwd_kernels.cu): the tile plans, the shared-memory budgets, the
// consumers' own barrier, the swizzle of the tiles the consumers write and
// their 8 x 8 micro-tile loads. Static assertions hold every plan to its
// thread counts, its stages and 227 KB of shared memory; kernels/_build.py
// hashes this header into the name of every library it builds.
//
// Every block is one producer warpgroup, whose first lane keeps TMA copies in
// flight into a ring of stages (full and empty mbarriers), and two consumer
// warpgroups (eight warps). The producer gives its registers back (setmaxnreg:
// 24 a thread) so that each consumer thread holds 240: three warpgroups start
// at 168 (65,536 over 384 threads), and a block of eight consumer warps and
// one producer warp would be held to 168 too (an SM sub-partition holds three
// of its nine warps). Each consumer thread owns an 8 x 8 micro-tile of every
// product it takes part in and, per step of the reduction, reads eight floats
// of each operand in two 16-byte loads: 16 floats for 64 FMAs, four FMAs a
// float. One operand of every product is read the same by the eight lanes of a
// quarter warp (a broadcast: its rows are the lanes' common rows), the other
// in eight consecutive 16-byte units, so no load meets a bank conflict. An
// operand whose rows must run along the reduction is transposed once in shared
// memory (tsw below); a tile the hardware lands (TMA, no swizzle) is read as
// it lies.

#pragma once

#include "xsmm_wgmma.cuh"

constexpr int TF_CONSUMERS = 256;               // two consumer warpgroups
constexpr int TF_THREADS = TF_CONSUMERS + 128;  // + the producer warpgroup
constexpr int TF_PRODUCER_REGS = 24;            // registers a thread after
constexpr int TF_CONSUMER_REGS = 240;           // setmaxnreg
constexpr int TF_ALIGN = 1024;                  // slack to align the tiles
constexpr int TF_FWD_STAGES = 4;                // the forward's ring
constexpr int TF_FWD_STAGE = 16384;             // bytes of one of its stages
constexpr int TF_BWD_STAGES = 2;                // the backward kernels' rings
constexpr int TF_BWD_STAGE = 32768;

constexpr int TF_SMEM_MAX = 232448;             // a block's on sm_90: 227 KB

// hd padded to a bucket: 64, 128 or 256 (the C entries pick it)
//
// Forward, one block per (b, BQ query rows): S = Q K^T on (row group a,
// column group b) micro-tiles, rows 4a..4a+3 and BQ/2 + 4a.., columns 4b..
// and BK/2 + 4b..; O = P V on the same rows and the columns 4o.. and
// HDP/2 + 4o.. of hd, o = b % OC. BQ BK = 16384 (S: 256 threads x 64).
// Where BQ HDP is smaller (hd bucket 64: BQ = BK = 128, so that the
// encoder's 96 x 512 rows fill the card in whole waves), KS = 2 halves of
// the threads take the two halves of each K tile's keys in P V, each
// holding a partial O tile, added once at the end. A stage is one 16 KB
// slice: DK rows of K^T (all BK columns), or DV rows of V (all HDP
// columns) as KS boxes, one from each half of the keys.
template <int HDP>
struct TfFwd {
  static constexpr int BK = (HDP < 128) ? 128 : HDP;   // keys a tile
  static constexpr int BQ = 16384 / BK;    // query rows a block
  static constexpr int GB = BK / 8;        // column groups (lanes of a row)
  static constexpr int OC = HDP / 8;       // O's column groups
  static constexpr int KS = GB / OC;       // key halves of P V
  static constexpr int DK = 4096 / BK;     // K^T rows (hd) a stage
  static constexpr int DV = 4096 / HDP;    // V rows (keys) a stage
  static_assert((BQ / 8) * (BK / 8) == TF_CONSUMERS &&
                    (BQ / 8) * OC * KS == TF_CONSUMERS,
                "S and O: one 8 x 8 micro-tile a consumer thread");
  static_assert(DK * BK * 4 == TF_FWD_STAGE && DV * HDP * 4 == TF_FWD_STAGE &&
                    BK % DV == 0 && DV % KS == 0,
                "a stage is one slice of K^T or of V");
};

// dQ, one block per (b, BQ query rows): groups A (threads 0-127) and B
// (128-255) form S^T = K Q^T and dP^T = V dO^T on (key set, query chunk)
// micro-tiles, their exchange through dS^T gives dS; all 256 threads then
// accumulate dQ^T = K^T-rows x dS^T on (hd set, query chunk) micro-tiles:
// BQ BK = 8192 (S^T: 128 x 64), BQ HDP = 16384 (dQ: 256 x 64), or at hd
// bucket 64 (BQ = 128, as the forward's) KS = 2 halves of the threads
// over the two halves of each phase-2 stage's keys, their partial dQ
// tiles added once at the end. A phase-1 stage is DK rows of K^T and the
// same DK columns of V; a phase-2 stage JS columns of K^T (every hd row).
template <int HDP>
struct TfDq {
  static constexpr int BQ = (HDP < 128) ? 128 : 16384 / HDP;
  static constexpr int BK = 8192 / BQ;
  static constexpr int GI = BQ / 8;        // query-chunk groups (lanes)
  static constexpr int KS = 2048 / (BQ * HDP / 8);   // key halves of dQ
  static constexpr int DK = (4096 / BK < HDP) ? 4096 / BK : HDP;
  static constexpr int JS = (8192 / HDP < BK) ? 8192 / HDP : BK;
  static_assert((BQ / 8) * (BK / 8) == TF_CONSUMERS / 2 &&
                    (BQ / 8) * (HDP / 8) * KS == TF_CONSUMERS,
                "S^T, dP^T by a group, dQ^T by both: 8 x 8 a thread");
  static_assert(2 * DK * BK * 4 <= TF_BWD_STAGE &&
                    HDP * JS * 4 <= TF_BWD_STAGE && BK % JS == 0,
                "a stage holds its slices");
};

// dK/dV, one block per (b, BK keys): groups A and B form S = Q K^T and
// dP = dO V^T on (query set, key chunk) micro-tiles; A then accumulates dV
// = P~^T dO and B dK = dS^T Q on (key set, hd chunk) micro-tiles: BK HDP =
// 8192 (128 x 64 each), BQ BK = 8192. A phase-1 stage is DS columns (hd) of
// the Q and dO tiles, a phase-2 stage IS rows of both.
template <int HDP>
struct TfDkv {
  static constexpr int BK = 8192 / HDP;
  static constexpr int BQ = HDP;
  static constexpr int GJ = BK / 8;        // key-chunk groups (lanes)
  static constexpr int GC = HDP / 8;       // hd-chunk groups (lanes)
  static constexpr int DS = 4096 / HDP;    // hd columns a phase-1 stage
  static constexpr int IS = 4096 / HDP;    // query rows a phase-2 stage
  static_assert((BQ / 8) * (BK / 8) == TF_CONSUMERS / 2 &&
                    (BK / 8) * (HDP / 8) == TF_CONSUMERS / 2,
                "S, dP, dV, dK by a group: 8 x 8 a thread");
  static_assert(2 * BQ * DS * 4 == TF_BWD_STAGE &&
                    2 * IS * HDP * 4 == TF_BWD_STAGE && BQ % IS == 0,
                "a stage is one slice of Q and of dO");
};

// shared memory a block asks for: the alignment slack, the tiles, the
// ring, the barriers (and the dK/dV kernel's lse and delta rows); the same
// at every hd bucket but the dK/dV kernel's, all under 227 KB
__host__ __device__ constexpr int tf_fwd_smem() {
  // Q^T and P^T (up to 16384 floats each; the partial O tiles' sum at the
  // end), the ring, full/empty + the Q barrier
  return TF_ALIGN + 2 * 16384 * 4 + TF_FWD_STAGES * TF_FWD_STAGE +
         (2 * TF_FWD_STAGES + 1) * 8;
}

__host__ __device__ constexpr int tf_dq_smem() {
  // Q^T (the partial dQ tiles' sum at the end), dO^T (up to 16384 floats
  // each), dS^T (BQ BK = 8192 floats), the ring, full/empty + the Q and dO
  // barriers
  return TF_ALIGN + (2 * 16384 + 8192) * 4 + TF_BWD_STAGES * TF_BWD_STAGE +
         (2 * TF_BWD_STAGES + 2) * 8;
}

__host__ __device__ constexpr int tf_dkv_smem(int hdp) {
  // K^T, V^T, P~, dS (8192 floats each), the ring, lse and delta rows for
  // two Q tiles (4 hdp floats), full/empty + the K/V barrier
  return TF_ALIGN + 4 * 8192 * 4 + TF_BWD_STAGES * TF_BWD_STAGE +
         4 * hdp * 4 + (2 * TF_BWD_STAGES + 1) * 8;
}

static_assert(tf_fwd_smem() <= TF_SMEM_MAX && tf_dq_smem() <= TF_SMEM_MAX &&
                  tf_dkv_smem(256) <= TF_SMEM_MAX,
              "a block's tiles and ring fit 227 KB");

// the consumer warps' own barrier (the producer warpgroup never joins)
__device__ __forceinline__ void tf_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(TF_CONSUMERS) : "memory");
}

// the consumers and the producer warpgroup's first warp together
__device__ __forceinline__ void tf_sync_all() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(TF_CONSUMERS + 32) : "memory");
}

// the warpgroups' register budgets (all 128 threads of a warpgroup)
__device__ __forceinline__ void tf_producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
      TF_PRODUCER_REGS));
}

__device__ __forceinline__ void tf_consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      TF_CONSUMER_REGS));
}

// A tile the consumers write row by row (Q^T, dO^T, V^T transposed from
// the landed tile; P^T): its 16-byte unit u of row r lies at unit
// u ^ ((r >> 2) & 7). Writers that hold four consecutive rows per lane
// group then hit eight distinct units; readers of one row are unaffected.
__device__ __forceinline__ int tsw(int row, int unit) {
  return unit ^ ((row >> 2) & 7);
}

// a micro-tile's index e (0..7) -> its row or column in a tile of `width`:
// 4 g + e, then width / 2 + 4 g + e - 4 (group g's two 16-byte units)
__device__ __forceinline__ int tf_at(int g, int e, int width) {
  return e < 4 ? 4 * g + e : width / 2 + 4 * g + e - 4;
}

__device__ __forceinline__ float4 ld4s(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// the eight floats of a micro-tile's operand in one row: units u0 and u1
// (16 bytes each) of `row`
__device__ __forceinline__ void ld8(float (&x)[8], const float* row, int u0,
                                    int u1) {
  const float4 a = ld4s(row + 4 * u0), b = ld4s(row + 4 * u1);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void st4s(float* p, float a, float b, float c,
                                     float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// src (R x C, row-major, as TMA lands it) -> dst (C x R, tsw): the lanes of
// a warp take eight consecutive units of four source rows, so both the
// 16-byte reads and the scalar writes are free of bank conflicts
template <int R, int C>
__device__ __forceinline__ void transpose_tsw(float* dst, const float* src,
                                              int tid) {
  static_assert(R % 32 == 0 && C % 32 == 0, "transpose tile");
  constexpr int CG = C / 32;   // groups of eight units in a source row
  for (int idx = tid; idx < R * C / 4; idx += TF_CONSUMERS) {
    const int l8 = idx & 7, q = (idx >> 3) & 3, rest = idx >> 5;
    const int c4 = (rest % CG) * 8 + l8, r = (rest / CG) * 4 + q;
    const float4 x = ld4s(src + r * C + 4 * c4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * c4 + e;
      dst[d * R + 4 * tsw(d, r >> 2) + (r & 3)] = comp(x, e);
    }
  }
}
