// Hand-written Hopper (sm_90a) kernels of the block-sparse (BCSC) SpMM path
// of libxsmm_torch. They replace five Pallas TPU kernels of
// libxsmm_tpu/kernels/spmm_pallas.py:
//   xsmm_bcsc_spmm         build_bcsc_spmm         (:88,  strategy "pallas")
//   xsmm_bcsc_spmm_union   build_bcsc_spmm_union   (:258, union ... union5)
//     and xsmm_bcsc_spmm_union_compacted, the compactor and its form over
//     the compacted RHS from one call
//   xsmm_bcsc_densify      build_bcsc_densify      (:800, strategy "dense")
//   xsmm_bcsc_union_compact  build_union_compact_rhs (:885, union/2/3's RHS)
//   xsmm_bcsc_spmm_super   build_bcsc_spmm_super   (:942, strategy "super")
//
// Plain C interface, no torch headers (see kernels/_build.py); the wrappers
// in kernels/spmm.py allocate the outputs and hold the create-time schedule
// arrays on the device. Each entry point launches on the caller's stream and
// returns cudaGetLastError().
//
// Operands: A (m, k) row-major; the BCSC values (nblocks, bk, bn), each block
// row-major; C (m, n) row-major. A value index equal to `nzero` (= nblocks)
// names the reference's appended zero block: it reads as zeros and is never
// loaded. The output is rounded once to its type on the store. One block
// owns each output tile and writes it once: no atomics, so results repeat
// bit for bit from run to run.
//
// Three kernels serve the scheduled and supertile strategies, and three the
// union strategies; spmm_entry and union_entry take the one spmm_route
// names (kernels/spmm.py spmm_path mirrors the rule):
// - bcsc_spmm_wgmma_kernel and bcsc_union_wgmma_kernel, route "wgmma", for
//   bf16 operands wherever bk % 16 == 0 and bn % 8 == 0 (32 x 32, 16 x 64,
//   16 x 8, 48 x 32, 32 x 16, 64 x 128, 128 x 128 and the supertiles):
//   TMA-fed swizzled tiles, products by wgmma (see their sections below);
// - bcsc_spmm_tma_fma_kernel and bcsc_union_tma_fma_kernel, route
//   "tma_fma", for f32 operands wherever bk % 4 == 0 and bn % 4 == 0 (the
//   union: also bn >= 32): f32 tiles fed by TMA into the CUDA cores' FMAs
//   (f32 means f32: no TF32), the f32 BRGEMM's design;
// - bcsc_spmm_kernel and bcsc_union_kernel, route "fma", for every other
//   case (bf16 blockings such as 8 x 8 or 4 x 48, f32 blocks that are not
//   whole 16-byte units, f32 unions of blocks under 32 columns): bf16
//   widened exactly to f32 on load, every product and sum an f32 FMA.
//
// Bound, at the bench's streaming shape (m = 32768, k = n = 1024, bk = bn =
// 32, block density 0.2, bf16 in, f32 out): device memory, 201 MB of A and C
// (0.060 ms at 3.35 TB/s) against 13.8 GFLOP of useful products (0.014 ms on
// the bf16 tensor cores, 0.21 ms on the f32 FMA units). The supertile
// strategy multiplies whole occupied 128 x 128 supertiles: at that density
// 97% of them, 67 GFLOP (0.068 ms on the tensor cores).
// The wgmma and TMA-fed FMA kernels: see their sections below. The FMA
// kernel keeps a 64 x 32 f32 tile in registers (4 x 4 per thread) and
// stages 32-deep slices of A's panel and of the value block, widened, in
// shared memory by plain loads between two barriers; the FMA union kernel
// keeps a 64 x 128 tile (4 x 8 per thread) and assembles each slot's RHS the
// same way, element by element. A is re-read from L2 for every block of a
// column; the FMA kernels are bound by their shared-memory traffic, not by
// device memory. The compactor moves bytes only (values read once, the
// compacted RHS written once) on the bulk-copy engine where the blocks'
// rows are whole 16-byte units.

#include <cuda_runtime.h>

#include "xsmm_common.cuh"
#include "xsmm_mma.cuh"   // store_pair
#include "xsmm_wgmma.cuh"
#include "xsmm_launches.cuh"

enum { T_F32 = 0, T_BF16 = 1 };

constexpr int TM = 64;   // output rows per block
constexpr int KC = 32;   // depth of one staged slice
constexpr int TN = 32;   // output columns per block (scheduled kernels)
constexpr int GW = 128;  // output columns per union group

// ---------------------------------------------------------------------------
// Scheduled SpMM (build_bcsc_spmm; the supertile kernel runs it at 128 x 128)
//
// Block (x, y): block column jb = x / nchunk, columns [c0, c0 + 32) of it
// with c0 = (x % nchunk) * 32, rows [64 y, 64 y + 64). It walks the column's
// schedule steps [ptr[jb], ptr[jb + 1]): step s multiplies A's panel at
// block row rows[s] by the value block vidx[s]. An empty block column has one
// step with the zero block (_pad_empty_columns), so it writes zeros and a
// non-finite A in block row 0 turns them into NaN, as in the reference.
// ---------------------------------------------------------------------------

template <typename TI, typename TO>
__global__ void __launch_bounds__(128) bcsc_spmm_kernel(
    const TI* __restrict__ a, const TI* __restrict__ vals,
    const int* __restrict__ ptr, const int* __restrict__ rows,
    const int* __restrict__ vidx, TO* __restrict__ out, int m, int k, int n,
    int bk, int bn, int nzero, int nchunk) {
  __shared__ float As[TM][KC + 1];
  __shared__ __align__(16) float Vs[KC][TN];
  const int jb = blockIdx.x / nchunk;
  const int c0 = (blockIdx.x % nchunk) * TN;
  const int row0 = blockIdx.y * TM;
  const int width = min(TN, bn - c0);
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const int s_end = ptr[jb + 1];
  for (int s = ptr[jb]; s < s_end; ++s) {
    const TI* ap = a + (long long)rows[s] * bk;
    const int v = vidx[s];
    const TI* vp = v == nzero ? nullptr : vals + (long long)v * bk * bn + c0;
    for (int k0 = 0; k0 < bk; k0 += KC) {
      const int kc = min(KC, bk - k0);
      for (int i = tid; i < TM * KC; i += 128) {
        const int r = i / KC, kk = i % KC, gr = row0 + r;
        As[r][kk] = (gr < m && kk < kc)
                        ? to_f32(ap[(long long)gr * k + k0 + kk]) : 0.0f;
      }
      for (int i = tid; i < KC * TN; i += 128) {
        const int kk = i / TN, cc = i % TN;
        Vs[kk][cc] = (vp != nullptr && kk < kc && cc < width)
                         ? to_f32(vp[(long long)(k0 + kk) * bn + cc]) : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kc; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[ty * 4 + i][kk];
        VecF<4>::load(&Vs[kk][tx * 4], bv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
  TO* op = out + (long long)jb * bn + c0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty * 4 + i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = tx * 4 + j;
      if (cc < width) store_as(acc[i][j], op + (long long)gr * n + cc);
    }
  }
}

// ---------------------------------------------------------------------------
// K-union SpMM (build_bcsc_spmm_union, every union strategy)
//
// Block (x, y): column group g = x (W = 128 / bn block columns), rows
// [64 y, 64 y + 64). For each union slot u < U it stages A's panel at block
// row krows[g U + u] and the slot's (bk x 128) right-hand side, and
// accumulates the 64 x 128 tile. Fused form (COMPACT false): block w of the
// slot's RHS is the value block gmap[(g U + u) W + w] (nzero: zeros), found
// per element. Compacted form (COMPACT true): `vals` is the compacted RHS
// (n/128, U*bk, 128) and the slot's rows are (g U + u) bk + [0, bk),
// contiguous. In both forms a slot whose W map entries are all the zero
// block is padding (u_align, or a union smaller than U) and is skipped.
// Group position w holds the caller's block column ocol[g W + w]: the
// clustering's column restore is folded into the store.
// ---------------------------------------------------------------------------

template <typename TI, typename TO, bool COMPACT>
__global__ void __launch_bounds__(256) bcsc_union_kernel(
    const TI* __restrict__ a, const TI* __restrict__ vals,
    const int* __restrict__ krows, const int* __restrict__ gmap,
    const int* __restrict__ ocol, TO* __restrict__ out, int m, int k, int n,
    int bk, int bn, int U, int nzero) {
  __shared__ float As[TM][KC + 1];
  __shared__ __align__(16) float Rs[KC][GW];
  const int g = blockIdx.x;
  const int row0 = blockIdx.y * TM;
  const int W = GW / bn;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // this thread's columns: tx*4 .. +3 and 64 + tx*4 .. +3 (each half of a
  // warp reads 256 contiguous bytes of Rs: no bank conflicts)
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  if constexpr (COMPACT) pdl_wait();   // as the wgmma kernel's
  for (int u = 0; u < U; ++u) {
    const long long slot = (long long)g * U + u;
    const int* gm = gmap + slot * W;
    bool live = false;
    for (int w = 0; w < W; ++w) live |= gm[w] != nzero;
    if (!live) continue;   // block-uniform: every thread reads the same map
    const TI* ap = a + (long long)krows[slot] * bk;
    for (int k0 = 0; k0 < bk; k0 += KC) {
      const int kc = min(KC, bk - k0);
      for (int i = tid; i < TM * KC; i += 256) {
        const int r = i / KC, kk = i % KC, gr = row0 + r;
        As[r][kk] = (gr < m && kk < kc)
                        ? to_f32(ap[(long long)gr * k + k0 + kk]) : 0.0f;
      }
      for (int i = tid; i < KC * GW; i += 256) {
        const int kk = i / GW, c = i % GW;
        float x = 0.0f;
        if (kk < kc) {
          if constexpr (COMPACT) {
            x = to_f32(vals[(slot * bk + k0 + kk) * GW + c]);
          } else {
            const int v = gm[c / bn];
            if (v != nzero)
              x = to_f32(vals[((long long)v * bk + k0 + kk) * bn + c % bn]);
          }
        }
        Rs[kk][c] = x;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kc; ++kk) {
        float av[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[ty * 4 + i][kk];
        VecF<4>::load(&Rs[kk][tx * 4], bv);
        VecF<4>::load(&Rs[kk][64 + tx * 4], bv + 4);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
    const long long col = (long long)ocol[g * W + c / bn] * bn + c % bn;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gr = row0 + ty * 4 + i;
      if (gr < m) store_as(acc[i][j], out + (long long)gr * n + col);
    }
  }
}

// ---------------------------------------------------------------------------
// The scheduled, supertile and k-union SpMMs in f32 on TMA-fed FMA tiles
// (route "tma_fma", kernels/spmm.py spmm_path: f32 operands whose blocks are
// whole 16-byte units deep and wide, bk % 4 == 0 and bn % 4 == 0; the union
// also at most SF_UNION_BOXES value blocks a group, bn >= 32). f32 means
// f32: no TF32 and no bf16 split, every product and sum an f32 FMA, summed
// in schedule order, rounded once on the store.
//
// Bound: at the streaming case in f32 (m = 32768, k = n = 1024, 199 blocks
// of 32 x 32) the useful products are 13.35 GFLOP, 0.199 ms at the CUDA
// cores' 67 TFLOP/s, against 0.08 ms for A, the values and C at 3.35 TB/s:
// the operations bound the function. The union and supertile forms compute
// 3.4x and 5.0x those products (the reference's algorithm). The kernels
// take the f32 BRGEMM's design (gemm_kernels.cu, section 3c): one producer
// warp keeps a ring of 32-deep slices in flight with TMA, paced by full and
// empty mbarriers, so no consumer waits on a plain load; 256 consumer
// threads each keep an 8 x 8 block of f32 accumulators, rows ty + TY i and
// columns 4 tx + (TN / 2) h + (0..3), and per four k read one 16-byte unit
// of A per row and two of the right-hand side per k: 16 shared loads for
// 256 FMAs, four FMAs a float. A's slice lands 128-byte swizzled (unit c of
// row r at c ^ (r % 8)), so the eight rows a warp reads at once fall in
// distinct banks; the lanes that share a row read it as a broadcast. The
// right-hand side lands unswizzled (dense rows of its box) and a warp reads
// consecutive 16-byte units of one row. A slice past the end of a block
// (bk % 32 != 0) or of A is zero-filled by TMA and its extra rows and
// columns are never multiplied; the zero block (an empty block column's
// step, a dead entry of a union slot) is loaded from rows past the value
// map's extent, so TMA fills it with zeros and still counts its bytes:
// nothing is read from the value store, and a non-finite A in the block row
// still turns the column into NaN, as in the reference.
//
// Scheduled and supertile (bcsc_spmm_tma_fma_kernel): one block per output
// tile of TM = 16384 / TN rows and TN columns (TN = 32, 64 or 128 by bn; a
// wider block column is cut into TN-column chunks) walks its column's
// schedule to the end, one writer per tile, no atomics. The grid's x runs
// over the block columns, so the blocks that share A's row panel run
// together and read it from L2 (A is 128 MB at the streaming case in f32).
// At 32 x 32 blocks the tile is 512 x 32: a quarter warp's four column
// threads read 64 contiguous bytes of the value slice, its two row groups
// A's rows as broadcasts.
//
// K-union (bcsc_union_tma_fma_kernel): one block per 128 x 128 tile, one
// row tile of one 128-column group, over the flattened list of (live slot,
// 32-deep slice) of the group, found block-uniformly from the map as the
// wgmma kernel does (dead slots are skipped). A stage holds A's 128 x
// 32 slice at column krows[slot] * bk + k0 and the slot's 32 x 128
// right-hand side: in the fused form (union4, union4a, union4d, union5) W =
// 128 / bn boxes of the value map, one per gather-map entry; in the
// compacted form (union, union2, union3) one box of the compactor's RHS,
// read after a programmatic launch's wait. The column restore through ocol
// is folded into the store.
// ---------------------------------------------------------------------------

constexpr int SF_KC = 32;                       // depth of one slice
constexpr int SF_CONSUMERS = 256;               // eight consumer warps
constexpr int SF_THREADS = SF_CONSUMERS + 32;   // + the producer warp
constexpr int SF_OUTS = 16384;                  // a tile: 8 x 8 a consumer
constexpr int SF_BOX = 256;                     // TMA's largest box edge
constexpr int SF_ALIGN = 1024;                  // slack to align the ring
constexpr int SF_UNION_BOXES = 4;               // value blocks a group, at most
constexpr int SF_SMEM_MAX = 232448;             // a block's on sm_90: 227 KB

// the tile of TN output columns: TM rows, TX column threads, TY row threads
// (consumer t: tx = t % TX, ty = t / TX), the stage's A slice and
// right-hand side, the ring
template <int TN>
struct SfTile {
  static constexpr int TM = SF_OUTS / TN;
  static constexpr int TX = TN / 8;
  static constexpr int TY = SF_CONSUMERS / TX;
  static constexpr int A_BOX = TM < SF_BOX ? TM : SF_BOX;   // rows a box
  static constexpr int A_BYTES = TM * SF_KC * 4;
  static constexpr int B_BYTES = SF_KC * TN * 4;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = TN == 32 ? 3 : 4;
  static constexpr int SMEM = SF_ALIGN + STAGES * STAGE + 2 * STAGES * 8;
  static_assert(TY * 8 == TM && TM % A_BOX == 0, "8 x 8 a consumer thread");
  static_assert(SMEM <= SF_SMEM_MAX, "the ring fits 227 KB");
};

__device__ __forceinline__ float4 sf_ld(const unsigned char* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float sf_comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// k = 4c .. 4c + 3 of a slice into an 8 x 8 micro-tile: A's rows at `as`
// + TY * 128 i (128-byte swizzled, phase sw), the right-hand side's two
// column units at byte offsets b0 and b1 of each row of `bs` (row stride
// ldb bytes)
template <int TY>
__device__ __forceinline__ void sf_chunk(float (&acc)[8][8],
                                         const unsigned char* as,
                                         const unsigned char* bs, int c,
                                         int sw, int b0, int b1, int ldb) {
  float4 av[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) av[i] = sf_ld(as + i * TY * 128 + 16 * (c ^ sw));
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned char* br = bs + (4 * c + j) * ldb;
    const float4 x = sf_ld(br + b0), y = sf_ld(br + b1);
    const float bv[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a_ = sf_comp(av[i], j);
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[i][q] = fmaf(a_, bv[q], acc[i][q]);
    }
  }
}

// one slice, kc deep (kc % 4 == 0): the whole 32 unrolled, a shorter last
// slice of a block in a loop
template <int TY>
__device__ __forceinline__ void sf_slice(float (&acc)[8][8],
                                         const unsigned char* as,
                                         const unsigned char* bs, int kc,
                                         int sw, int b0, int b1, int ldb) {
  if (kc == SF_KC) {
#pragma unroll
    for (int c = 0; c < SF_KC / 4; ++c)
      sf_chunk<TY>(acc, as, bs, c, sw, b0, b1, ldb);
  } else {
#pragma unroll 1
    for (int c = 0; c < kc / 4; ++c)
      sf_chunk<TY>(acc, as, bs, c, sw, b0, b1, ldb);
  }
}

// four consecutive outputs, rounded once to the output type
__device__ __forceinline__ void store_quad(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_quad(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// the ring in dynamic shared memory, 1024-byte aligned (the swizzle is a
// function of the shared address); its full and empty barriers after it
__device__ __forceinline__ unsigned char* sf_ring(unsigned char* raw) {
  return raw + ((SF_ALIGN - (wg_smem(raw) & (SF_ALIGN - 1))) & (SF_ALIGN - 1));
}

__device__ __forceinline__ void sf_init(uint64_t* full, uint64_t* empty,
                                        int stages) {
  for (int s = 0; s < stages; ++s) {
    mbar_init(&full[s], 1);                      // the producer's arrival
    mbar_init(&empty[s], SF_CONSUMERS / 32);     // one per consumer warp
  }
  mbar_fence_init();
}

// Block (x, y): block column jb = x / nchunk, columns [c0, c0 + TN) of it
// with c0 = (x % nchunk) TN, rows [TM y, TM y + TM). Iteration i covers
// schedule step ptr[jb] + i / nsl, depth [32 (i % nsl), + 32) of its blocks.
// amap: A over (k, m), boxes of 32 x A_BOX, 128-byte swizzle; vmap: the
// values over (bn, nblocks bk), boxes of TN x 32, no swizzle; vzero: a row
// of vmap past its extent (the zero block).
template <typename TO, int TN>
__global__ void __launch_bounds__(SF_THREADS, 1) bcsc_spmm_tma_fma_kernel(
    const __grid_constant__ CUtensorMap amap,
    const __grid_constant__ CUtensorMap vmap, const int* __restrict__ ptr,
    const int* __restrict__ rows, const int* __restrict__ vidx,
    TO* __restrict__ out, int m, int n, int bk, int bn, int nzero,
    int nchunk, int vzero) {
  using T = SfTile<TN>;
  extern __shared__ __align__(16) unsigned char sf_smem[];
  unsigned char* ring = sf_ring(sf_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T::STAGES * T::STAGE);
  uint64_t* empty = full + T::STAGES;

  const int tid = threadIdx.x;
  const int jb = blockIdx.x / nchunk;
  const int c0 = (blockIdx.x % nchunk) * TN;
  const int row0 = blockIdx.y * T::TM;
  const int s0 = ptr[jb];
  const int nsl = (bk + SF_KC - 1) / SF_KC;
  const int total = (ptr[jb + 1] - s0) * nsl;

  if (tid == 0) sf_init(full, empty, T::STAGES);
  __syncthreads();

  if (tid >= SF_CONSUMERS) {   // the producer warp: one thread starts TMA
    if (tid == SF_CONSUMERS) {
      for (int it = 0; it < total; ++it) {
        const int st = it % T::STAGES;
        if (it >= T::STAGES) mbar_wait(&empty[st], ((it / T::STAGES) - 1) & 1);
        const int s = s0 + it / nsl, k0 = (it % nsl) * SF_KC;
        const int v = vidx[s];
        unsigned char* sp = ring + st * T::STAGE;
        mbar_arrive_expect_tx(&full[st], T::STAGE);
        const int ak = rows[s] * bk + k0;
#pragma unroll
        for (int b = 0; b < T::TM; b += T::A_BOX)
          tma_load_2d(sp + b * 128, &amap, &full[st], ak, row0 + b);
        tma_load_2d(sp + T::A_BYTES, &vmap, &full[st], c0,
                    v == nzero ? vzero : v * bk + k0);
      }
    }
    return;
  }

  const int lane = tid & 31;
  const int tx = tid % T::TX, ty = tid / T::TX;
  const int sw = ty & 7;   // the swizzle phase of every row ty + TY i
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int it = 0; it < total; ++it) {
    const int st = it % T::STAGES;
    mbar_wait(&full[st], (it / T::STAGES) & 1);
    const int kc = min(SF_KC, bk - (it % nsl) * SF_KC);
    const unsigned char* sp = ring + st * T::STAGE;
    sf_slice<T::TY>(acc, sp + ty * 128, sp + T::A_BYTES, kc, sw, 16 * tx,
                    16 * tx + 2 * TN, TN * 4);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // bn % 4 == 0: a four-column unit is whole or past the block column
  const int width = min(TN, bn - c0);
  TO* op = out + (long long)jb * bn + c0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + ty + T::TY * i;
    if (gr >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 4 * tx + (TN / 2) * h;
      if (c < width) store_quad(op + (long long)gr * n + c, &acc[i][4 * h]);
    }
  }
}

// Block (x, y): column group grp = x, rows [128 y, 128 y + 128). amap as
// above (128-row boxes); rmap: the fused form's values over (bn, nblocks
// bk), boxes of bn x 32, or the compacted RHS over (128, n/128 U bk), boxes
// of 128 x 32, no swizzle; vzero as above.
template <typename TO, bool COMPACT>
__global__ void __launch_bounds__(SF_THREADS, 1) bcsc_union_tma_fma_kernel(
    const __grid_constant__ CUtensorMap amap,
    const __grid_constant__ CUtensorMap rmap, const int* __restrict__ krows,
    const int* __restrict__ gmap, const int* __restrict__ ocol,
    TO* __restrict__ out, int m, int n, int bk, int bn, int U, int nzero,
    int vzero) {
  using T = SfTile<GW>;
  extern __shared__ __align__(16) unsigned char sf_smem[];
  unsigned char* ring = sf_ring(sf_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T::STAGES * T::STAGE);
  uint64_t* empty = full + T::STAGES;

  const int tid = threadIdx.x;
  const int grp = blockIdx.x;
  const int row0 = blockIdx.y * T::TM;
  const int W = GW / bn;
  const int nsl = (bk + SF_KC - 1) / SF_KC;
  const long long slot0 = (long long)grp * U;
  const int* gm = gmap + slot0 * W;
  // a slot whose W map entries are all the zero block is padding
  auto live = [&](int u) {
    for (int w = 0; w < W; ++w)
      if (gm[u * W + w] != nzero) return true;
    return false;
  };
  int nlive = 0;   // the threads test the slots in parallel
  for (int u0 = 0; u0 < U; u0 += SF_THREADS)
    nlive += __syncthreads_count(u0 + tid < U && live(u0 + tid));
  const int total = nlive * nsl;

  if (tid == 0) sf_init(full, empty, T::STAGES);
  __syncthreads();
  // the compacted RHS is the compactor's output: with a programmatic
  // launch this block may start before the compactor ends
  if constexpr (COMPACT) pdl_wait();

  if (tid >= SF_CONSUMERS) {   // the producer warp: one thread starts TMA
    if (tid == SF_CONSUMERS) {
      int pu = 0, pk = 0;      // the next slice: pk of live slot pu
      while (pu < U && !live(pu)) ++pu;
      for (int it = 0; it < total; ++it) {
        const int st = it % T::STAGES;
        if (it >= T::STAGES) mbar_wait(&empty[st], ((it / T::STAGES) - 1) & 1);
        const long long slot = slot0 + pu;
        const int k0 = pk * SF_KC;
        unsigned char* sp = ring + st * T::STAGE;
        mbar_arrive_expect_tx(&full[st], T::STAGE);
        tma_load_2d(sp, &amap, &full[st], krows[slot] * bk + k0, row0);
        if constexpr (COMPACT) {
          tma_load_2d(sp + T::A_BYTES, &rmap, &full[st], 0,
                      (int)(slot * bk) + k0);
        } else {
          for (int w = 0; w < W; ++w) {
            const int v = gm[pu * W + w];
            tma_load_2d(sp + T::A_BYTES + w * bn * 128, &rmap, &full[st], 0,
                        v == nzero ? vzero : v * bk + k0);
          }
        }
        if (++pk == nsl) {
          pk = 0;
          do ++pu; while (pu < U && !live(pu));
        }
      }
    }
    return;
  }

  const int lane = tid & 31;
  const int tx = tid % T::TX, ty = tid / T::TX;
  const int sw = ty & 7;
  // group column c lies in box c / lw at byte (c / lw) lw 128 + (c % lw) 4
  // of a row; the RHS's rows are lw floats apart
  const int lw = COMPACT ? GW : bn;
  const int c0 = 4 * tx, c1 = 4 * tx + GW / 2;
  const int b0 = (c0 / lw) * lw * 128 + (c0 % lw) * 4;
  const int b1 = (c1 / lw) * lw * 128 + (c1 % lw) * 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int it = 0; it < total; ++it) {
    const int st = it % T::STAGES;
    mbar_wait(&full[st], (it / T::STAGES) & 1);
    const int kc = min(SF_KC, bk - (it % nsl) * SF_KC);
    const unsigned char* sp = ring + st * T::STAGE;
    sf_slice<T::TY>(acc, sp + ty * 128, sp + T::A_BYTES, kc, sw, b0, b1,
                    lw * 4);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // group column c holds the caller's column ocol[grp W + c / bn] bn + c %
  // bn; bn % 4 == 0, so a four-column unit never straddles two block columns
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = h ? c1 : c0;
    const long long col = (long long)ocol[grp * W + c / bn] * bn + c % bn;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int gr = row0 + ty + T::TY * i;
      if (gr < m) store_quad(out + (long long)gr * n + col, &acc[i][4 * h]);
    }
  }
}

// ---------------------------------------------------------------------------
// The scheduled and supertile SpMMs in bf16 on wgmma with TMA-fed tiles
// (route "wgmma", kernels/spmm.py spmm_path: bf16 operands whose blocks are
// whole k16 steps deep and whole 16-byte rows wide, bk % 16 == 0 and bn % 8
// == 0: stream20's 32 x 32, 16 x 64, 16 x 8, 48 x 32, 32 x 16, 64 x 128, the
// 128 x 128 supertiles; the k-union has its own kernel below). Each step's
// product is summed in schedule order in f32 registers and rounded once on
// the store, one writer per output tile, no atomics.
//
// Bound: at the streaming case (m = 32768, k = n = 1024, 32 x 32 blocks at
// density 0.2, bf16 in, f32 out) device memory, 0.060 ms for A and C at
// 3.35 TB/s; A is re-read from L2 once per block column (about 430 MB at
// 32 x 32, half of it at 16 x 64), and each product is small (m64nTNk16),
// so TMA and L2 set the pace, not the tensor cores. At the supertiles (128
// x 128, 97% of them occupied) its own products are 67.65 GFLOP, 0.068 ms at
// the bf16 peak.
//
// Design: the f32 tma_fma kernel's producer with the bf16 BRGEMM's wgmma
// consumers. One block per output tile of 128 rows and TN columns of one
// block column, TN the least of 8, 16, 32, 64, 128 that covers bn (a wider
// block column is cut into 128-column chunks; columns past bn arrive as
// TMA's zero fill and are not stored). One producer warp keeps a ring of
// KC-deep slices in flight, KC the deepest of 64, 32, 16 that divides bk
// (sw_kc), paced by full and empty mbarriers: A's 128 x KC slice from a 2-D
// map over A (m, k), at column rows[s] * bk + k0, and the value block's KC x
// TN slice from a 3-D map over the value store (bn, bk, nblocks), one box of
// up to 64 columns at a time. The zero block (an empty column's step) is
// loaded at block index nblocks (or 1 for an empty store), past the map's
// extent: TMA fills it with zeros and still counts its bytes, nothing is
// read from the value store, and a non-finite A in block row 0 still turns
// the column into NaN, as in the reference. Every box lands in the swizzle
// of its rows' width: 128-byte for rows of 64 bf16, 64-byte for 32, 32-byte
// for 16 (A's slice at KC = 16, value boxes 16 wide), none for 8 (value
// boxes 8 wide: 16-byte rows, wgmma's unswizzled core matrices);
// xsmm_wgmma.cuh's layouts. Two consumer warpgroups each own 64 rows of the
// tile and run wgmma.m64nTNk16 per k16 step, A K-major, the row-major value
// slice MN-major (the transpose bit), one slice's products in flight while
// the next slice is issued. The grid's x runs over the block columns, so
// the blocks that share A's row panel run together and read it from L2.
// ---------------------------------------------------------------------------

constexpr int SW_CONSUMERS = 256;               // two consumer warpgroups
constexpr int SW_THREADS = SW_CONSUMERS + 32;   // + the producer warp
constexpr int SW_TM = 128;                      // output rows a block

// the depth of one slice: the deepest of 64, 32, 16 that divides bk, so a
// slice never straddles two value blocks
__host__ __device__ constexpr int sw_kc(int bk) {
  return bk % 64 == 0 ? 64 : bk % 32 == 0 ? 32 : 16;
}

// the tile of TN columns and KC-deep slices: A's slice, the value slice as
// NB boxes of BOX columns (at most 64: a 128-byte swizzled row), the ring.
// A stage holds A's slice, then the boxes, and is padded to 1024 bytes (the
// longest swizzle repeat); eight stages at KC = 16 keep as many bytes in
// flight as four at KC = 32
template <int TN, int KC, int BOX = (TN < 64 ? TN : 64)>
struct SwTile {
  static constexpr int A_BYTES = SW_TM * KC * 2;
  static constexpr int BOX_N = BOX;
  static constexpr int NB = TN / BOX_N;
  static constexpr int V_BOX = KC * BOX_N * 2;
  static constexpr int LOAD = A_BYTES + NB * V_BOX;   // bytes TMA lands
  static constexpr int STAGE = (LOAD + 1023) / 1024 * 1024;
  static constexpr int STAGES = KC == 64 ? 3 : KC == 32 ? 4 : 8;
  static constexpr int SMEM = SF_ALIGN + STAGES * STAGE + 2 * STAGES * 8;
  static_assert(A_BYTES % 1024 == 0 && V_BOX % (16 * BOX_N) == 0,
                "every box starts on its swizzle's repeat");
  static_assert(2 * SMEM <= SF_SMEM_MAX, "two blocks an SM");
};

// the descriptors of k16 step j: A's (K-major) at `as`, the value slice's
// (MN-major, boxes of BOX columns V_BOX bytes apart) at `vs`, each in its
// slice's swizzle
template <int KC>
__device__ __forceinline__ uint64_t sw_adesc(const unsigned char* as, int j) {
  return KC == 64   ? wgmma_desc_sw128(as + 32 * j, 16, 1024)
         : KC == 32 ? wgmma_desc_sw64(as + 32 * j, 16, 512)
                    : wgmma_desc_sw32(as, 16, 256);
}

template <int KC, int BOX>
__device__ __forceinline__ uint64_t sw_vdesc(const unsigned char* vs, int j) {
  constexpr int V_BOX = KC * BOX * 2;
  return BOX == 64   ? wgmma_desc_sw128(vs + 2048 * j, V_BOX, 1024)
         : BOX == 32 ? wgmma_desc_sw64(vs + 1024 * j, V_BOX, 512)
         : BOX == 16 ? wgmma_desc_sw32(vs + 512 * j, V_BOX, 256)
                     : wgmma_desc_plain(vs + 256 * j, 128, V_BOX);
}

// the consumer warpgroups' loop of the wgmma SpMM kernels over `total`
// slices of the ring T: warpgroup wg's 64 x TN tile in acc (zeroed here),
// each slice's products issued while the last slice's run, whose stage
// then goes back to the producer
template <typename T, int TN, int KC>
__device__ __forceinline__ void sw_consume(float (&acc)[TN / 2],
                                           const unsigned char* ring,
                                           uint64_t* full, uint64_t* empty,
                                           int total, int wg, int lane) {
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < total; ++it) {
    const int st = it % T::STAGES;
    mbar_wait(&full[st], (it / T::STAGES) & 1);
    const unsigned char* sp = ring + st * T::STAGE;
    const unsigned char* as = sp + wg * (T::A_BYTES / 2);
    wgmma_fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KC / 16; ++j)
      Wg<TN>::template ss<0, 1>(acc, sw_adesc<KC>(as, j),
                                sw_vdesc<KC, T::BOX_N>(sp + T::A_BYTES, j), 1);
    wgmma_commit();
    // the slice before this one is done: its stage goes back to the
    // producer while this slice's products run
    wgmma_wait<1>();
    wgmma_fence_operands(acc);
    if (it > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(it - 1) % T::STAGES]);
    }
  }
  wgmma_wait<0>();
  wgmma_fence_operands(acc);
}

// Block (x, y): block column jb = x / nchunk, columns [c0, c0 + TN) of it
// with c0 = (x % nchunk) TN, rows [128 y, 128 y + 128). Iteration i covers
// schedule step ptr[jb] + i / nsl, depth [KC (i % nsl), + KC) of its
// blocks. vzero: the value map's block extent (the zero block's index).
template <typename TO, int TN, int KC>
__global__ void __launch_bounds__(SW_THREADS, 2) bcsc_spmm_wgmma_kernel(
    const __grid_constant__ CUtensorMap amap,
    const __grid_constant__ CUtensorMap vmap, const int* __restrict__ ptr,
    const int* __restrict__ rows, const int* __restrict__ vidx,
    TO* __restrict__ out, int m, int n, int bk, int bn, int nzero,
    int nchunk, int vzero) {
  using T = SwTile<TN, KC>;
  extern __shared__ __align__(16) unsigned char sw_raw[];
  unsigned char* ring = sf_ring(sw_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T::STAGES * T::STAGE);
  uint64_t* empty = full + T::STAGES;

  const int tid = threadIdx.x;
  const int jb = blockIdx.x / nchunk;
  const int c0 = (blockIdx.x % nchunk) * TN;
  const int row0 = blockIdx.y * SW_TM;
  const int s0 = ptr[jb];
  const int nsl = bk / KC;
  const int total = (ptr[jb + 1] - s0) * nsl;

  if (tid == 0) sf_init(full, empty, T::STAGES);
  __syncthreads();

  if (tid >= SW_CONSUMERS) {   // the producer warp: one thread starts TMA
    if (tid == SW_CONSUMERS) {
      for (int it = 0; it < total; ++it) {
        const int st = it % T::STAGES;
        if (it >= T::STAGES) mbar_wait(&empty[st], ((it / T::STAGES) - 1) & 1);
        const int s = s0 + it / nsl, k0 = (it % nsl) * KC;
        const int v = vidx[s];
        unsigned char* sp = ring + st * T::STAGE;
        mbar_arrive_expect_tx(&full[st], T::LOAD);
        tma_load_2d(sp, &amap, &full[st], rows[s] * bk + k0, row0);
#pragma unroll
        for (int h = 0; h < T::NB; ++h)
          tma_load_3d(sp + T::A_BYTES + h * T::V_BOX, &vmap, &full[st],
                      c0 + h * T::BOX_N, k0, v == nzero ? vzero : v);
      }
    }
    return;
  }

  const int wg = tid >> 7, lane = tid & 31;
  float acc[TN / 2];
  sw_consume<T, TN, KC>(acc, ring, full, empty, total, wg, lane);

  // fragment rows and column pairs as in xsmm_wgmma.cuh; bn % 8 == 0: a
  // pair is whole or past the block column
  const int width = min(TN, bn - c0);
  TO* op = out + (long long)jb * bn + c0;
  const int r0 = row0 + wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    if (col >= width) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = r0 + 8 * h;
      if (gr < m)
        store_pair(op + (long long)gr * n + col, acc[4 * j + 2 * h],
                   acc[4 * j + 2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// The k-union in bf16 on wgmma (route "wgmma" for the union too: bf16
// operands, bk % 16 == 0 and bn % 8 == 0, in both forms). Per 128-column
// group and 128-row tile, the live union slots' products (A's rows x bk
// panel at block row krows[slot] times the slot's bk x 128 right-hand side)
// are summed in slot order in f32 registers and rounded once on the store,
// group column c stored at the caller's column ocol[grp W + c / bn] bn + c %
// bn, one writer per tile, no atomics.
//
// Bound: at the streaming case (U = 21 slots a group) its own products are
// 45 GFLOP, 0.046 ms at the bf16 peak, against 0.060 ms for A and C at 3.35
// TB/s.
//
// Design: bcsc_spmm_wgmma_kernel's plan at TN = 128 with the union's
// schedule (bcsc_union_tma_fma_kernel's producer). The live slots are found
// block-uniformly from the map (a slot whose W entries are all the zero
// block is padding and is skipped); the producer walks (live slot, KC-deep
// slice) and stages A's 128 x KC slice at column krows[slot] bk + k0 and
// the slot's KC x 128 right-hand side as 128 / BOX boxes of BOX columns:
// in the compacted form (union, union2, union3) two 64-column boxes of the
// compactor's (n/128, U bk, 128) output, after the programmatic launch's
// wait; in the fused form (union4, union4a, union4d, union5) bn / BOX
// boxes of each of the W value blocks the gather map names, BOX = min(bn,
// 64), from the 3-D value map. There lane w of the producer warp issues
// block w's boxes, the W lanes side by side (one thread issuing 17 boxes a
// stage at 16 x 8 set the pace), and a dead entry, the zero block, is
// loaded at the map's extent (vzero), where TMA fills zeros and still
// counts its bytes, unless its place in the stage already holds that zero
// fill from the stage's last use (most places of a slot are dead at 16 x 8
// and 32 x 16). Each box lands in the swizzle of its rows' width, as in the
// scheduled kernel, the boxes V_BOX bytes apart, which is the MN-major
// descriptor's stride between column groups (sw_vdesc), so the consumers
// take either form's layout. Two consumer warpgroups each own 64 rows and
// run wgmma.m64n128k16 per k16 step, one slice's products in flight while
// the next slice is issued. The grid's x runs over the groups, so the
// blocks that share A's row tile read it from L2 together.
// ---------------------------------------------------------------------------

// Block (x, y): column group grp = x, rows [128 y, 128 y + 128). amap: A
// over (k, m) in boxes of KC x 128; rmap: the fused form's values over (bn,
// bk, nblocks) or the compacted RHS over (128, U bk, n / 128), in boxes of
// BOX x KC x 1; vzero: the value map's block extent (the zero block's
// index). PW: the columns of a piece of the store, 32 where bn % 32 == 0,
// else 8.
template <typename TO, int KC, int BOX, int PW, bool COMPACT>
__global__ void __launch_bounds__(SW_THREADS, 2) bcsc_union_wgmma_kernel(
    const __grid_constant__ CUtensorMap amap,
    const __grid_constant__ CUtensorMap rmap, const int* __restrict__ krows,
    const int* __restrict__ gmap, const int* __restrict__ ocol,
    TO* __restrict__ out, int m, int n, int bk, int bn, int U, int nzero,
    int vzero) {
  using T = SwTile<GW, KC, BOX>;
  extern __shared__ __align__(16) unsigned char sw_raw[];
  unsigned char* ring = sf_ring(sw_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + T::STAGES * T::STAGE);
  uint64_t* empty = full + T::STAGES;

  const int tid = threadIdx.x;
  const int grp = blockIdx.x;
  const int row0 = blockIdx.y * SW_TM;
  const int W = GW / bn;
  const int nsl = bk / KC;
  const long long slot0 = (long long)grp * U;
  const int* gm = gmap + slot0 * W;
  // a slot whose W map entries are all the zero block is padding
  auto live = [&](int u) {
    for (int w = 0; w < W; ++w)
      if (gm[u * W + w] != nzero) return true;
    return false;
  };
  int nlive = 0;   // the threads test the slots in parallel
  for (int u0 = 0; u0 < U; u0 += SW_THREADS)
    nlive += __syncthreads_count(u0 + tid < U && live(u0 + tid));
  const int total = nlive * nsl;

  if (tid == 0) sf_init(full, empty, T::STAGES);
  __syncthreads();
  // the compacted RHS is the compactor's output: with a programmatic
  // launch this block may start before the compactor ends
  if constexpr (COMPACT) pdl_wait();

  if (tid >= SW_CONSUMERS) {   // the producer warp
    const int lane = tid & 31;
    if (COMPACT && lane != 0) return;   // one thread starts TMA
    // the fused form: lane w < W loads the slot's w-th value block, bit s
    // of zst set while its place in stage s holds TMA's zero fill
    const int blk = KC * bn * 2;        // a value block's bytes a slice
    unsigned zst = 0;
    int pu = 0, pk = 0;                 // the next slice: pk of live slot pu
    while (pu < U && !live(pu)) ++pu;
    for (int it = 0; it < total; ++it) {
      const int st = it % T::STAGES;
      if (it >= T::STAGES) mbar_wait(&empty[st], ((it / T::STAGES) - 1) & 1);
      const int k0 = pk * KC;
      const int ak = krows[slot0 + pu] * bk + k0;
      unsigned char* sp = ring + st * T::STAGE;
      unsigned char* rs = sp + T::A_BYTES;
      if constexpr (COMPACT) {
        mbar_arrive_expect_tx(&full[st], T::LOAD);
        tma_load_2d(sp, &amap, &full[st], ak, row0);
#pragma unroll
        for (int h = 0; h < T::NB; ++h)
          tma_load_3d(rs + h * T::V_BOX, &rmap, &full[st], h * BOX,
                      pu * bk + k0, grp);
      } else {
        // a dead entry (the zero block) loads from the map's extent, where
        // TMA fills zeros, unless its place already holds them; the lanes
        // issue their boxes side by side
        const int v = lane < W ? gm[pu * W + lane] : nzero;
        const bool load = lane < W && (v != nzero || !((zst >> st) & 1));
        const int nload = __popc(__ballot_sync(~0u, load));
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[st], T::A_BYTES + nload * blk);
          tma_load_2d(sp, &amap, &full[st], ak, row0);
        }
        __syncwarp();
        if (load)
          for (int h = 0; h < bn / BOX; ++h)
            tma_load_3d(rs + lane * blk + h * T::V_BOX, &rmap, &full[st],
                        h * BOX, k0, v == nzero ? vzero : v);
        zst = v == nzero ? zst | 1u << st : zst & ~(1u << st);
      }
      if (++pk == nsl) {
        pk = 0;
        do ++pu; while (pu < U && !live(pu));
      }
    }
    return;
  }

  const int wg = tid >> 7, lane = tid & 31;
  float acc[GW / 2];
  sw_consume<T, GW, KC>(acc, ring, full, empty, total, wg, lane);

  // fragment rows and column pairs as in xsmm_wgmma.cuh; group column c
  // holds the caller's column ocol[grp W + c / bn] bn + c % bn. Each
  // PW-column piece q of the group lies in one block column (PW divides
  // bn) and starts at the caller's column cq[q]: a fragment's pieces are
  // known at compile time, and 128 / PW loads serve the store
  constexpr int QJ = PW / 8;   // a piece's 8-column fragments
  const int r0 = row0 + wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  int cq[GW / PW];
#pragma unroll
  for (int q = 0; q < GW / PW; ++q)
    cq[q] = ocol[grp * W + PW * q / bn] * bn + (PW * q) % bn;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r0 + 8 * h >= m) continue;
    TO* orow = out + (long long)(r0 + 8 * h) * n + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < GW / 8; ++j)
      store_pair(orow + cq[j / QJ] + 8 * (j % QJ), acc[4 * j + 2 * h],
                 acc[4 * j + 2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// Union RHS compactor (build_union_compact_rhs): out (n/128, U*bk, 128) from
// the gather map (n/128, U, W) of value indices, out[g, u bk + r, w bn + c]
// = vals[gmap[g, u, w], r, c] (nzero: zeros, so pad slots hold zeros and
// never stale memory). Bound: latency, not bytes (at the streaming case 168
// slots of 8 KB, 1.8 MB of traffic: 0.5 us at 3.35 TB/s against a round
// trip to device memory per dependent step). Two routes, chosen by shape
// and alignment alone (kernels/spmm.py compact_route); neither falls back
// to the other:
// - CP_BULK, where a block row of a value block is whole 16-byte units (bn
//   * itemsize % 16 == 0) and vals and out start on 16-byte boundaries: a
//   tile is rb rows of one slot (all bk where the stage holds them). A
//   grid of at most CP_BLOCKS blocks an SM walks the tiles t = blockIdx.x,
//   + gridDim.x, ... through two stages of shared memory: lane w < W reads
//   the tile's w-th map entry and issues one 1-D bulk copy of that value
//   block (rb contiguous rows of it), all W completing on the stage's
//   mbarrier; a pad entry is loaded not at all and stored as zeros (the W
//   lanes issuing side by side replayed faster on an H100 than one thread
//   issuing all W copies, or than 16-byte loads straight into registers:
//   PERF.md, section 6). The block's threads then write the tile's rows to
//   `out` as coalesced 16-byte stores (the index math is shifts: bn and the
//   row's units are powers of two) while the next tile's copies are in
//   flight. The W pieces
//   of a stage sit ps bytes apart, ps = rb * bn * itemsize plus a pad that
//   puts the eight 16-byte reads of a quarter warp in distinct banks.
// - CP_ELEM otherwise: one block per slot copies its W blocks as raw units V
//   of 1-16 bytes (V divides a block row's bn * itemsize bytes and both
//   base addresses), so it serves any element type and address; `cpr` is
//   the units per block row.
// Both are programmatic dependent launches themselves: a block reads its
// map entries (fixed when the plan is made) while the kernel before it on
// the stream ends, and waits for that kernel before it reads the values or
// writes `out`. Both trigger, as they start, the programmatic launch of the
// union kernel that reads their output (xsmm_bcsc_spmm_union_compacted):
// its blocks launch and read their plan while the copies run, and wait for
// them before the first read of the RHS.
// ---------------------------------------------------------------------------

constexpr int CP_THREADS = 256;
constexpr int CP_BLOCKS = 4;        // blocks an SM of the bulk route's grid
constexpr int CP_STAGE = 16384;     // bytes of one stage, pads included
enum { CP_BULK = 0, CP_ELEM = 1 };

// rows of a slot in one bulk tile: all bk where a stage holds them, with a
// pad of under 128 bytes for each of the W pieces
__host__ __device__ inline int cp_rows(int bk, int bn, int esz) {
  const int W = GW / bn, row = GW * esz;
  const int fit = (CP_STAGE - W * 128) / row;
  return bk < fit ? bk : fit;
}

// bytes between two pieces of a stage: rb rows of cpr 16-byte units, padded
// so that it is cpr * 16 bytes past a multiple of 128
__host__ __device__ inline int cp_piece(int rb, int cpr) {
  return rb * cpr * 16 + (((cpr * 16 * (1 - rb)) % 128) + 128) % 128;
}

// the bulk route's dynamic shared memory: two mbarriers, the two stages'
// W map entries, then the two stages, 128-byte aligned
__host__ __device__ inline int cp_head(int W) {
  return (16 + 8 * W + 127) / 128 * 128;
}

__global__ void __launch_bounds__(CP_THREADS) bcsc_union_compact_bulk_kernel(
    const unsigned char* __restrict__ vals, const int* __restrict__ gmap,
    uint4* __restrict__ out, long long tiles, int tps, int W, int bk, int rb,
    int lg_cpr, int lg_upr, int ps, int nzero) {
  extern __shared__ __align__(128) unsigned char cp_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(cp_smem);
  int* gms = reinterpret_cast<int*>(cp_smem + 16);   // stage s: gms[s W + w]
  unsigned char* stages = cp_smem + cp_head(W);
  const int tid = threadIdx.x;
  const int cpr = 1 << lg_cpr, upr = 1 << lg_upr;
  const int piece_row = cpr * 16;                     // bytes of a block row
  const long long block_bytes = (long long)bk * piece_row;
  const long long step = gridDim.x;
  pdl_trigger();
  auto slot_of = [&](long long t) { return tps == 1 ? t : t / tps; };

  // lane w < W: piece w of stage s <- rows [r0, r0 + rows) of value block
  // v, tile t's w-th map entry (nzero: nothing loaded, zeros stored); each
  // lane's arrival expects its own bytes
  auto load = [&](long long t, int s, int v) {
    const int r0 = (int)(t - slot_of(t) * tps) * rb;
    const uint32_t bytes = (uint32_t)min(rb, bk - r0) * piece_row;
    gms[s * W + tid] = v;
    mbar_arrive_expect_tx(&full[s], v != nzero ? bytes : 0);
    if (v != nzero)
      bulk_load_1d(stages + (long long)s * W * ps + tid * ps,
                   vals + v * block_bytes + r0 * piece_row, bytes, &full[s]);
  };

  // the map is fixed when the plan is made, so the first two tiles' entries
  // are read, and the barriers set up, before the wait: with a programmatic
  // launch they overlap the kernel before, whose output the values may be
  // and whose inputs `out` may reuse
  long long t = blockIdx.x;
  int v0 = nzero, v1 = nzero;
  if (tid < W) {
    if (t < tiles) v0 = gmap[slot_of(t) * W + tid];
    if (t + step < tiles) v1 = gmap[slot_of(t + step) * W + tid];
  }
  if (tid == 0) {
    mbar_init(&full[0], W);
    mbar_init(&full[1], W);
    mbar_fence_init();
  }
  __syncthreads();
  pdl_wait();
  if (tid < W) {
    if (t < tiles) load(t, 0, v0);
    if (t + step < tiles) load(t + step, 1, v1);
  }
  for (int i = 0; t < tiles; t += step, ++i) {
    const int s = i & 1;
    mbar_wait(&full[s], (i >> 1) & 1);
    const long long slot = slot_of(t);
    const int r0 = (int)(t - slot * tps) * rb;
    const int units = min(rb, bk - r0) << lg_upr;
    const unsigned char* st = stages + (long long)s * W * ps;
    uint4* op = out + (slot * bk + r0) * upr;
    for (int u = tid; u < units; u += CP_THREADS) {
      const int r = u >> lg_upr, cu = u & (upr - 1);
      const int w = cu >> lg_cpr, c = cu & (cpr - 1);
      uint4 x = make_uint4(0, 0, 0, 0);
      if (gms[s * W + w] != nzero)
        x = *reinterpret_cast<const uint4*>(st + w * ps + (r * cpr + c) * 16);
      op[u] = x;
    }
    __syncthreads();   // stage s and its map entries are read out
    const long long tn = t + 2 * step;
    if (tid < W && tn < tiles) load(tn, s, gmap[slot_of(tn) * W + tid]);
  }
}

template <typename V>
__global__ void __launch_bounds__(CP_THREADS) bcsc_union_compact_kernel(
    const V* __restrict__ vals, const int* __restrict__ gmap,
    V* __restrict__ out, int W, int bk, int cpr, int nzero) {
  __shared__ int gm[GW];
  pdl_trigger();
  const long long slot = blockIdx.x;
  for (int w = threadIdx.x; w < W; w += blockDim.x) gm[w] = gmap[slot * W + w];
  pdl_wait();   // as the bulk route's: the map before, the values after
  __syncthreads();
  const int row_units = W * cpr;       // units per 128-column output row
  const int total = bk * row_units;
  V* op = out + slot * total;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / row_units, cu = i - r * row_units;
    const int w = cu / cpr, c = cu - w * cpr;
    const int v = gm[w];
    V x{};
    if (v != nzero) x = vals[((long long)v * bk + r) * cpr + c];
    op[i] = x;
  }
}

// ---------------------------------------------------------------------------
// Densify (build_bcsc_densify): out (k, n) from the gather map (kb, nb) of
// value indices, out[i bk + r, j bn + c] = vals[gmap[i, j], r, c], zeros
// where the map says nzero. It copies raw units V of whole elements, so it
// serves every element type; a zero tile is all-zero bits. Bound: bytes
// (the live value blocks read once, out written once: 2.5 MB at the
// streaming case, 0.7 us at 3.35 TB/s); at that size a launch's latency
// and one round trip to device memory set its time. The reference writes
// one (bk, n) row panel a grid step from a value store held whole in VMEM:
// only kb steps (32 at the streaming case, fewer than the 132 SMs). Here
// the work is a gather of whole tiles: an output tile is bk rows of cpr
// units at the output's row stride, its source one contiguous value block
// or nothing. Two routes, chosen by shape and alignment alone
// (kernels/spmm.py BcscDensify.route, by compact_route's test); neither
// falls back to the other:
// - DN_VECTOR where a tile row is whole 16-byte units (bn * esz % 16 == 0)
//   and vals and out start on 16-byte boundaries: V = uint4, cpr = bn *
//   esz / 16;
// - DN_ELEM otherwise: V the element's own type, cpr = bn.
// Block b owns a run of tb whole tiles of one block row (i = b / runs,
// tiles j0 .. j0 + tb - 1, the row's last run shorter) and reads their map
// entries once, into shared memory. Thread (q, r0) = (tid % qb, tid / qb)
// owns unit columns q, q + qb, ... of the run (tile cq / cpr, unit cq %
// cpr: one division a column, never one a unit) and copies rows r0, r0 +
// rs, ... of each: a zero tile is stores of zeros with no read of the
// value store; a live tile is loads from its value block, DN_ROWS rows'
// loads issued before their stores (the plan gives a thread DN_ROWS rows
// where the block has threads for it). The grid is one-shot (every run at once, tb
// halved on the host until the runs cover the SMs: kernels/spmm.py
// densify_plan). A programmatic dependent launch: the map entries (fixed
// when the plan is made) are read while the kernel before it ends, the
// values and `out` after the wait.
// ---------------------------------------------------------------------------

constexpr int DN_THREADS = 256;     // threads of a block, at most
constexpr int DN_ROWS = 4;          // rows' loads a thread issues at once
enum { DN_VECTOR = 0, DN_ELEM = 1 };

template <typename V>
__global__ void __launch_bounds__(DN_THREADS) bcsc_densify_kernel(
    const V* __restrict__ vals, const int* __restrict__ gmap,
    V* __restrict__ out, int nb, int bk, int cpr, int tb, int qb, int rs,
    int nzero) {
  __shared__ int gm[DN_THREADS];
  pdl_trigger();
  const int runs = (nb + tb - 1) / tb;
  const long long b = blockIdx.x, i = b / runs;
  const int j0 = (int)(b - i * runs) * tb;
  const int nt = min(tb, nb - j0);
  for (int t = threadIdx.x; t < nt; t += blockDim.x)
    gm[t] = gmap[i * nb + j0 + t];
  __syncthreads();
  pdl_wait();
  const long long orow = (long long)nb * cpr;   // units of an output row
  V* panel = out + i * bk * orow + (long long)j0 * cpr;
  const int q = threadIdx.x % qb, r0 = threadIdx.x / qb;
  for (int cq = q; cq < nt * cpr; cq += qb) {
    const int t = cq / cpr, c = cq - t * cpr;
    const int v = gm[t];
    V* op = panel + cq;
    if (v == nzero) {
      for (int r = r0; r < bk; r += rs) op[r * orow] = V{};
      continue;
    }
    const V* sp = vals + (long long)v * bk * cpr + c;
    for (int r = r0; r < bk; r += DN_ROWS * rs) {
      V x[DN_ROWS];
#pragma unroll
      for (int u = 0; u < DN_ROWS; ++u)
        if (r + u * rs < bk) x[u] = sp[(r + u * rs) * cpr];
#pragma unroll
      for (int u = 0; u < DN_ROWS; ++u)
        if (r + u * rs < bk) op[(r + u * rs) * orow] = x[u];
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename TI, typename TO>
static int launch_spmm(const void* a, const void* vals, const int* ptr,
                       const int* rows, const int* vidx, void* out, int m,
                       int k, int n, int bk, int bn, int nzero,
                       cudaStream_t st) {
  const int nchunk = (bn + TN - 1) / TN;
  const long long gx = (long long)(n / bn) * nchunk;
  const long long gy = (m + TM - 1) / TM;
  if (gx > 2147483647LL || gy > 65535) return cudaErrorInvalidConfiguration;
  note_launch(bcsc_spmm_kernel<TI, TO>);
  bcsc_spmm_kernel<TI, TO><<<dim3((unsigned)gx, (unsigned)gy), 128, 0, st>>>(
      static_cast<const TI*>(a), static_cast<const TI*>(vals), ptr, rows,
      vidx, static_cast<TO*>(out), m, k, n, bk, bn, nzero, nchunk);
  return cudaGetLastError();
}

// a launch on `st`; with `pdl` a programmatic dependent launch, which may
// begin while the kernel before it on the stream still runs (the kernel
// calls pdl_wait before it reads that kernel's output)
template <typename... Exp, typename... Act>
static int launch_pdl(void (*kern)(Exp...), dim3 grid, int threads, int smem,
                      cudaStream_t st, bool pdl, Act... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = pdl ? 1 : 0;
  note_launch(kern);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

template <typename TI, typename TO>
static int launch_union(const void* a, const void* vals, const int* krows,
                        const int* gmap, const int* ocol, void* out, int m,
                        int k, int n, int bk, int bn, int U, int nzero,
                        bool compact, cudaStream_t st) {
  const long long gy = (m + TM - 1) / TM;
  if (gy > 65535) return cudaErrorInvalidConfiguration;
  auto kern = compact ? bcsc_union_kernel<TI, TO, true>
                      : bcsc_union_kernel<TI, TO, false>;
  return launch_pdl(kern, dim3(n / GW, (unsigned)gy), 256, 0, st, compact,
                    static_cast<const TI*>(a), static_cast<const TI*>(vals),
                    krows, gmap, ocol, static_cast<TO*>(out), m, k, n, bk, bn,
                    U, nzero);
}

// the ring's maps: A (m, k) f32 in boxes of 32 columns x `rows` rows,
// 128-byte swizzled; a (rows, cols) f32 right-hand side in boxes of `bw`
// columns x 32 rows, unswizzled (dense rows of the box)
static bool sf_amap(CUtensorMap* map, const void* a, int m, int k, int rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)m};
  const cuuint64_t strides[1] = {(cuuint64_t)k * 4};
  const cuuint32_t box[2] = {SF_KC, (cuuint32_t)rows};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a, 2, dims,
                    strides, box);
}

static bool sf_rmap(CUtensorMap* map, const void* base, long long rows,
                    int cols, int bw) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)bw, SF_KC};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, 2, dims,
                    strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// rows of the value map: the store's nzero blocks of bk rows (an empty
// store: one row of A's memory, never read in bounds); the zero block is
// loaded at this row, past the extent
static long long sf_value_rows(int nzero, int bk) {
  return nzero > 0 ? (long long)nzero * bk : 1;
}

// the TMA-fed FMA kernel at one column width TN (32, 64 or 128); a, vals
// 16-byte aligned, k % 4 == 0 and bn % 4 == 0
template <typename TO, int TN>
static int launch_spmm_tma_fma_tn(const void* a, const void* vals,
                                  const int* ptr, const int* rows,
                                  const int* vidx, void* out, int m, int k,
                                  int n, int bk, int bn, int nzero,
                                  cudaStream_t st) {
  using T = SfTile<TN>;
  const int nchunk = (bn + TN - 1) / TN;
  const long long gx = (long long)(n / bn) * nchunk;
  const long long gy = (m + T::TM - 1) / T::TM;
  const long long vrows = sf_value_rows(nzero, bk);
  if (gx > 2147483647LL || gy > 65535 || vrows > 2147483647LL - SF_KC)
    return cudaErrorInvalidConfiguration;
  CUtensorMap amap, vmap;
  if (!sf_amap(&amap, a, m, k, T::A_BOX) ||
      !sf_rmap(&vmap, nzero > 0 ? vals : a, vrows, bn, TN))
    return cudaErrorInvalidValue;
  auto kern = bcsc_spmm_tma_fma_kernel<TO, TN>;
  // above 48 KB only as dynamic shared memory, after the opt-in
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  note_launch(kern);
  kern<<<dim3((unsigned)gx, (unsigned)gy), SF_THREADS, T::SMEM, st>>>(
      amap, vmap, ptr, rows, vidx, static_cast<TO*>(out), m, n, bk, bn,
      nzero, nchunk, (int)vrows);
  return cudaGetLastError();
}

template <typename TO>
static int launch_spmm_tma_fma(const void* a, const void* vals,
                               const int* ptr, const int* rows,
                               const int* vidx, void* out, int m, int k,
                               int n, int bk, int bn, int nzero,
                               cudaStream_t st) {
  if (bn <= 32)
    return launch_spmm_tma_fma_tn<TO, 32>(a, vals, ptr, rows, vidx, out, m,
                                          k, n, bk, bn, nzero, st);
  if (bn <= 64)
    return launch_spmm_tma_fma_tn<TO, 64>(a, vals, ptr, rows, vidx, out, m,
                                          k, n, bk, bn, nzero, st);
  return launch_spmm_tma_fma_tn<TO, 128>(a, vals, ptr, rows, vidx, out, m, k,
                                         n, bk, bn, nzero, st);
}

// the TMA-fed FMA union kernel; its compacted form runs right after the
// compactor and is launched programmatically, its RHS map over the
// compactor's (n/128, U*bk, 128) output
template <typename TO>
static int launch_union_tma_fma(const void* a, const void* vals,
                                const int* krows, const int* gmap,
                                const int* ocol, void* out, int m, int k,
                                int n, int bk, int bn, int U, int nzero,
                                bool compact, cudaStream_t st) {
  using T = SfTile<GW>;
  const long long gy = (m + T::TM - 1) / T::TM;
  const long long vrows = compact ? (long long)(n / GW) * U * bk
                                  : sf_value_rows(nzero, bk);
  if (gy > 65535 || vrows > 2147483647LL - SF_KC)
    return cudaErrorInvalidConfiguration;
  CUtensorMap amap, rmap;
  const int lw = compact ? GW : bn;
  if (!sf_amap(&amap, a, m, k, T::TM) ||
      !sf_rmap(&rmap, compact || nzero > 0 ? vals : a, vrows, lw, lw))
    return cudaErrorInvalidValue;
  auto kern = compact ? bcsc_union_tma_fma_kernel<TO, true>
                      : bcsc_union_tma_fma_kernel<TO, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  return launch_pdl(kern, dim3(n / GW, (unsigned)gy), SF_THREADS, T::SMEM,
                    st, compact, amap, rmap, krows, gmap, ocol,
                    static_cast<TO*>(out), m, n, bk, bn, U, nzero,
                    (int)vrows);
}

// the TMA swizzle of a box whose rows are `bytes` wide (SwTile's layouts:
// 16-byte rows unswizzled)
static CUtensorMapSwizzle sw_swizzle(int bytes) {
  return bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
         : bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                       : CU_TENSOR_MAP_SWIZZLE_NONE;
}

// A (m, k) bf16 in boxes of KC columns x 128 rows, in the swizzle of KC
// bf16
template <int KC>
static bool sw_amap(CUtensorMap* map, const void* a, int m, int k) {
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)m};
  const cuuint64_t strides[1] = {(cuuint64_t)k * 2};
  const cuuint32_t box[2] = {KC, SW_TM};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, 2, dims,
                    strides, box, sw_swizzle(KC * 2));
}

// the wgmma kernel at one column width TN (8, 16, 32, 64 or 128) and slice
// depth KC (64, 32 or 16); a, vals bf16 and 16-byte aligned, bk % KC == 0,
// bn % 8 == 0. A's map: sw_amap; the values' map: (bn, bk, nblocks) in
// boxes of BOX_N x KC x 1 (an empty store: one block of A's memory, never
// read in bounds), the zero block at block index vzero, the extent
template <typename TO, int TN, int KC>
static int launch_spmm_wgmma_tn(const void* a, const void* vals,
                                const int* ptr, const int* rows,
                                const int* vidx, void* out, int m, int k,
                                int n, int bk, int bn, int nzero,
                                cudaStream_t st) {
  using T = SwTile<TN, KC>;
  const int nchunk = (bn + TN - 1) / TN;
  const long long gx = (long long)(n / bn) * nchunk;
  const long long gy = (m + SW_TM - 1) / SW_TM;
  const int vzero = nzero > 0 ? nzero : 1;
  if (gx > 2147483647LL || gy > 65535) return cudaErrorInvalidConfiguration;
  const cuuint64_t vdims[3] = {(cuuint64_t)bn, (cuuint64_t)bk,
                               (cuuint64_t)vzero};
  const cuuint64_t vstr[2] = {(cuuint64_t)bn * 2, (cuuint64_t)bk * bn * 2};
  const cuuint32_t vbox[3] = {T::BOX_N, KC, 1};
  CUtensorMap amap, vmap;
  if (!sw_amap<KC>(&amap, a, m, k) ||
      !encode_map(&vmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  nzero > 0 ? vals : a, 3, vdims, vstr, vbox,
                  sw_swizzle(T::BOX_N * 2)))
    return cudaErrorInvalidValue;
  auto kern = bcsc_spmm_wgmma_kernel<TO, TN, KC>;
  // above 48 KB only as dynamic shared memory, after the opt-in
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  note_launch(kern);
  kern<<<dim3((unsigned)gx, (unsigned)gy), SW_THREADS, T::SMEM, st>>>(
      amap, vmap, ptr, rows, vidx, static_cast<TO*>(out), m, n, bk, bn,
      nzero, nchunk, vzero);
  return cudaGetLastError();
}

// TN: the least of 8, 16, 32, 64, 128 that covers bn
template <typename TO, int KC>
static int launch_spmm_wgmma_kc(const void* a, const void* vals,
                                const int* ptr, const int* rows,
                                const int* vidx, void* out, int m, int k,
                                int n, int bk, int bn, int nzero,
                                cudaStream_t st) {
  if (bn <= 8)
    return launch_spmm_wgmma_tn<TO, 8, KC>(a, vals, ptr, rows, vidx, out, m,
                                           k, n, bk, bn, nzero, st);
  if (bn <= 16)
    return launch_spmm_wgmma_tn<TO, 16, KC>(a, vals, ptr, rows, vidx, out, m,
                                            k, n, bk, bn, nzero, st);
  if (bn <= 32)
    return launch_spmm_wgmma_tn<TO, 32, KC>(a, vals, ptr, rows, vidx, out, m,
                                            k, n, bk, bn, nzero, st);
  if (bn <= 64)
    return launch_spmm_wgmma_tn<TO, 64, KC>(a, vals, ptr, rows, vidx, out, m,
                                            k, n, bk, bn, nzero, st);
  return launch_spmm_wgmma_tn<TO, 128, KC>(a, vals, ptr, rows, vidx, out, m,
                                           k, n, bk, bn, nzero, st);
}

template <typename TO>
static int launch_spmm_wgmma(const void* a, const void* vals, const int* ptr,
                             const int* rows, const int* vidx, void* out,
                             int m, int k, int n, int bk, int bn, int nzero,
                             cudaStream_t st) {
  switch (sw_kc(bk)) {
    case 64:
      return launch_spmm_wgmma_kc<TO, 64>(a, vals, ptr, rows, vidx, out, m, k,
                                          n, bk, bn, nzero, st);
    case 32:
      return launch_spmm_wgmma_kc<TO, 32>(a, vals, ptr, rows, vidx, out, m, k,
                                          n, bk, bn, nzero, st);
  }
  return launch_spmm_wgmma_kc<TO, 16>(a, vals, ptr, rows, vidx, out, m, k, n,
                                      bk, bn, nzero, st);
}

// the wgmma union kernel at slice depth KC, box width BOX and store piece
// PW, in one form; a, vals bf16 and 16-byte aligned, bk % KC == 0, bn % 8
// == 0. A's map: sw_amap; the right-hand side's: the fused form's values
// over (bn, bk, nblocks) (an empty store: one block of A's memory, never
// read in bounds; the zero block at block index vzero, the extent), the
// compacted form's RHS over (128, U bk, n / 128), in boxes of BOX x KC x 1.
// The compacted form runs right after the compactor and is launched
// programmatically.
template <typename TO, int KC, int BOX, int PW, bool COMPACT>
static int launch_union_wgmma_at(const void* a, const void* vals,
                                 const int* krows, const int* gmap,
                                 const int* ocol, void* out, int m, int k,
                                 int n, int bk, int bn, int U, int nzero,
                                 cudaStream_t st) {
  using T = SwTile<GW, KC, BOX>;
  const long long gy = (m + SW_TM - 1) / SW_TM;
  const int vzero = nzero > 0 ? nzero : 1;
  if (gy > 65535 || (long long)U * bk > 2147483647LL)
    return cudaErrorInvalidConfiguration;
  const cuuint64_t rdims[3] = {
      (cuuint64_t)(COMPACT ? GW : bn), (cuuint64_t)(COMPACT ? U * bk : bk),
      (cuuint64_t)(COMPACT ? n / GW : vzero)};
  const cuuint64_t rstr[2] = {(cuuint64_t)rdims[0] * 2,
                              (cuuint64_t)rdims[0] * rdims[1] * 2};
  const cuuint32_t rbox[3] = {BOX, KC, 1};
  CUtensorMap amap, rmap;
  if (!sw_amap<KC>(&amap, a, m, k) ||
      !encode_map(&rmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  COMPACT || nzero > 0 ? vals : a, 3, rdims, rstr, rbox,
                  sw_swizzle(BOX * 2)))
    return cudaErrorInvalidValue;
  auto kern = bcsc_union_wgmma_kernel<TO, KC, BOX, PW, COMPACT>;
  // above 48 KB only as dynamic shared memory, after the opt-in
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  return launch_pdl(kern, dim3(n / GW, (unsigned)gy), SW_THREADS, T::SMEM,
                    st, COMPACT, amap, rmap, krows, gmap, ocol,
                    static_cast<TO*>(out), m, n, bk, bn, U, nzero, vzero);
}

// the compacted RHS in 64-column boxes, the fused form's in boxes of
// min(bn, 64); the store in pieces of 32 columns where bn % 32 == 0, else 8
template <typename TO, int KC>
static int launch_union_wgmma_kc(const void* a, const void* vals,
                                 const int* krows, const int* gmap,
                                 const int* ocol, void* out, int m, int k,
                                 int n, int bk, int bn, int U, int nzero,
                                 bool compact, cudaStream_t st) {
  if (compact && bn % 32 == 0)
    return launch_union_wgmma_at<TO, KC, 64, 32, true>(
        a, vals, krows, gmap, ocol, out, m, k, n, bk, bn, U, nzero, st);
  if (compact)
    return launch_union_wgmma_at<TO, KC, 64, 8, true>(
        a, vals, krows, gmap, ocol, out, m, k, n, bk, bn, U, nzero, st);
  if (bn == 8)
    return launch_union_wgmma_at<TO, KC, 8, 8, false>(
        a, vals, krows, gmap, ocol, out, m, k, n, bk, bn, U, nzero, st);
  if (bn == 16)
    return launch_union_wgmma_at<TO, KC, 16, 8, false>(
        a, vals, krows, gmap, ocol, out, m, k, n, bk, bn, U, nzero, st);
  if (bn == 32)
    return launch_union_wgmma_at<TO, KC, 32, 32, false>(
        a, vals, krows, gmap, ocol, out, m, k, n, bk, bn, U, nzero, st);
  return launch_union_wgmma_at<TO, KC, 64, 32, false>(
      a, vals, krows, gmap, ocol, out, m, k, n, bk, bn, U, nzero, st);
}

template <typename TO>
static int launch_union_wgmma(const void* a, const void* vals,
                              const int* krows, const int* gmap,
                              const int* ocol, void* out, int m, int k, int n,
                              int bk, int bn, int U, int nzero, bool compact,
                              cudaStream_t st) {
  switch (sw_kc(bk)) {
    case 64:
      return launch_union_wgmma_kc<TO, 64>(a, vals, krows, gmap, ocol, out, m,
                                           k, n, bk, bn, U, nzero, compact,
                                           st);
    case 32:
      return launch_union_wgmma_kc<TO, 32>(a, vals, krows, gmap, ocol, out, m,
                                           k, n, bk, bn, U, nzero, compact,
                                           st);
  }
  return launch_union_wgmma_kc<TO, 16>(a, vals, krows, gmap, ocol, out, m, k,
                                       n, bk, bn, U, nzero, compact, st);
}

static int ilog2(int x) { return 31 - __builtin_clz((unsigned)x); }

// the compactor's route (kernels/spmm.py compact_route mirrors it)
static int compact_route(int bn, int esz, const void* vals, const void* out) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(vals) |
                         reinterpret_cast<uintptr_t>(out);
  const bool sized = esz == 1 || esz == 2 || esz == 4 || esz == 8;
  return sized && (bn * esz) % 16 == 0 && addr % 16 == 0 ? CP_BULK : CP_ELEM;
}

template <typename V>
static int launch_compact(const void* vals, const int* gmap, void* out,
                          long long slots, int W, int bk, int cpr, int nzero,
                          cudaStream_t st) {
  if (slots > 2147483647LL) return cudaErrorInvalidConfiguration;
  return launch_pdl(bcsc_union_compact_kernel<V>, dim3((unsigned)slots),
                    CP_THREADS, 0, st, true, static_cast<const V*>(vals), gmap,
                    static_cast<V*>(out), W, bk, cpr, nzero);
}

// route as the wrapper chose it (compact_route): CP_BULK only where
// compact_route allows it, CP_ELEM on any input (the wrapper takes it only
// where bulk copies cannot serve; scripts/stream_time.py times it on
// aligned values too); grid: the bulk route's, from the wrapper's plan
// (kernels/spmm.py compact_plan)
static int compact_entry(const void* vals, const int* gmap, void* out,
                         int nsg, int U, int bk, int bn, int nzero, int esz,
                         int route, int grid, cudaStream_t st) {
  if (nsg < 0 || U <= 0 || bk <= 0 || bn <= 0 || GW % bn || esz <= 0 ||
      (route != CP_BULK && route != CP_ELEM) ||
      (route == CP_BULK && compact_route(bn, esz, vals, out) != CP_BULK))
    return cudaErrorInvalidValue;
  if (nsg == 0) return cudaSuccess;
  const int W = GW / bn;
  const long long slots = (long long)nsg * U;
  if (route == CP_BULK) {
    if (grid <= 0) return cudaErrorInvalidValue;
    const int cpr = bn * esz / 16, rb = cp_rows(bk, bn, esz);
    const int tps = (bk + rb - 1) / rb, ps = cp_piece(rb, cpr);
    return launch_pdl(bcsc_union_compact_bulk_kernel, dim3(grid), CP_THREADS,
                      cp_head(W) + 2 * W * ps, st, true,
                      static_cast<const unsigned char*>(vals), gmap,
                      static_cast<uint4*>(out), slots * tps, tps, W, bk, rb,
                      ilog2(cpr), ilog2(GW * esz / 16), ps, nzero);
  }
  const int row_bytes = bn * esz;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(vals) |
                         reinterpret_cast<uintptr_t>(out);
  for (int unit = 16; unit >= 1; unit /= 2) {
    if (row_bytes % unit || addr % unit) continue;
    const int cpr = row_bytes / unit;
    switch (unit) {
      case 16:
        return launch_compact<uint4>(vals, gmap, out, slots, W, bk, cpr,
                                     nzero, st);
      case 8:
        return launch_compact<uint2>(vals, gmap, out, slots, W, bk, cpr,
                                     nzero, st);
      case 4:
        return launch_compact<uint32_t>(vals, gmap, out, slots, W, bk, cpr,
                                        nzero, st);
      case 2:
        return launch_compact<uint16_t>(vals, gmap, out, slots, W, bk, cpr,
                                        nzero, st);
      default:
        return launch_compact<uint8_t>(vals, gmap, out, slots, W, bk, cpr,
                                       nzero, st);
    }
  }
  return cudaErrorInvalidValue;
}

// tb tiles a block and rs row threads as the wrapper planned them
// (kernels/spmm.py densify_plan); qb = min(tb * cpr, DN_THREADS) column
// threads
template <typename V>
static int launch_densify(const void* vals, const int* gmap, void* out,
                          int kb, int nb, int bk, int cpr, int tb, int rs,
                          int nzero, cudaStream_t st) {
  const long long cols = (long long)tb * cpr;
  const long long qb = cols < DN_THREADS ? cols : DN_THREADS;
  const long long grid = (long long)kb * ((nb + tb - 1) / tb);
  if (qb * rs > DN_THREADS) return cudaErrorInvalidValue;
  if (grid > 2147483647LL) return cudaErrorInvalidConfiguration;
  return launch_pdl(bcsc_densify_kernel<V>, dim3((unsigned)grid),
                    (int)(qb * rs), 0, st, true, static_cast<const V*>(vals),
                    gmap, static_cast<V*>(out), nb, bk, cpr, tb, (int)qb, rs,
                    nzero);
}

// the (in, out) type combinations of the two SpMM kernels
#define XSMM_SPMM_DISPATCH(LAUNCH, ...)                                   \
  if (in_type == T_F32 && out_type == T_F32)                              \
    return LAUNCH<float, float>(__VA_ARGS__);                             \
  if (in_type == T_F32 && out_type == T_BF16)                             \
    return LAUNCH<float, __nv_bfloat16>(__VA_ARGS__);                     \
  if (in_type == T_BF16 && out_type == T_F32)                             \
    return LAUNCH<__nv_bfloat16, float>(__VA_ARGS__);                     \
  if (in_type == T_BF16 && out_type == T_BF16)                            \
    return LAUNCH<__nv_bfloat16, __nv_bfloat16>(__VA_ARGS__);             \
  return cudaErrorInvalidValue;

// the routes of the three SpMM entries
enum { SP_FMA, SP_TMA_FMA, SP_WGMMA };

// the kernel a call takes (kernels/spmm.py spmm_path mirrors it): the wgmma
// kernels for bf16 calls whose blocks are whole k16 steps deep and whose
// rows are whole 16-byte units (scheduled, supertile and k-union alike);
// the TMA-fed FMA kernel for f32 blocks whose rows and depth are whole
// 16-byte units (TMA's strides), in the union at most SF_UNION_BOXES value
// blocks a group; the FMA kernel for the rest
static int spmm_route(int in_type, int bk, int bn, bool uni) {
  if (in_type == T_BF16 && bk % 16 == 0 && bn % 8 == 0) return SP_WGMMA;
  if (in_type == T_F32 && bk % 4 == 0 && bn % 4 == 0 &&
      (!uni || GW / bn <= SF_UNION_BOXES))
    return SP_TMA_FMA;
  return SP_FMA;
}

static int spmm_entry(const void* a, const void* vals, const int* ptr,
                      const int* rows, const int* vidx, void* out, int m,
                      int k, int n, int bk, int bn, int nzero, int in_type,
                      int out_type, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m < 0 || k <= 0 || n < 0 || bk <= 0 || bn <= 0 || k % bk || n % bn)
    return cudaErrorInvalidValue;
  if (m == 0 || n == 0) return cudaSuccess;
  const int route = spmm_route(in_type, bk, bn, false);
  if (route == SP_WGMMA) {
    if (out_type == T_F32)
      return launch_spmm_wgmma<float>(a, vals, ptr, rows, vidx, out, m, k, n,
                                      bk, bn, nzero, st);
    if (out_type == T_BF16)
      return launch_spmm_wgmma<__nv_bfloat16>(a, vals, ptr, rows, vidx, out,
                                              m, k, n, bk, bn, nzero, st);
    return cudaErrorInvalidValue;
  }
  if (route == SP_TMA_FMA) {
    if (out_type == T_F32)
      return launch_spmm_tma_fma<float>(a, vals, ptr, rows, vidx, out, m, k,
                                        n, bk, bn, nzero, st);
    if (out_type == T_BF16)
      return launch_spmm_tma_fma<__nv_bfloat16>(a, vals, ptr, rows, vidx,
                                                out, m, k, n, bk, bn, nzero,
                                                st);
    return cudaErrorInvalidValue;
  }
  XSMM_SPMM_DISPATCH(launch_spmm, a, vals, ptr, rows, vidx, out, m, k, n, bk,
                     bn, nzero, st)
}

extern "C" {

const char* xsmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// ptr (n/bn + 1) per-column step pointers; rows, vidx: the padded schedule
// (kernels/spmm.py _block_schedule).
int xsmm_bcsc_spmm(const void* a, const void* vals, const int* ptr,
                   const int* rows, const int* vidx, void* out, int m, int k,
                   int n, int bk, int bn, int nzero, int in_type, int out_type,
                   void* stream) {
  return spmm_entry(a, vals, ptr, rows, vidx, out, m, k, n, bk, bn, nzero,
                    in_type, out_type, stream);
}

// the same schedule over 128 x 128 supertiles: sup (ns, 128, 128)
int xsmm_bcsc_spmm_super(const void* a, const void* sup, const int* ptr,
                         const int* rows, const int* vidx, void* out, int m,
                         int k, int n, int nzero, int in_type, int out_type,
                         void* stream) {
  return spmm_entry(a, sup, ptr, rows, vidx, out, m, k, n, 128, 128, nzero,
                    in_type, out_type, stream);
}

static bool union_args_ok(int m, int k, int n, int bk, int bn, int U,
                          int in_type, int out_type) {
  return m >= 0 && k > 0 && bk > 0 && bn > 0 && U > 0 && k % bk == 0 &&
         GW % bn == 0 && n > 0 && n % GW == 0 &&
         (in_type == T_F32 || in_type == T_BF16) &&
         (out_type == T_F32 || out_type == T_BF16);
}

static int union_entry(const void* a, const void* vals, const int* krows,
                       const int* gmap, const int* ocol, void* out, int m,
                       int k, int n, int bk, int bn, int U, int nzero,
                       int in_type, int out_type, bool compact,
                       cudaStream_t st) {
  if (!union_args_ok(m, k, n, bk, bn, U, in_type, out_type))
    return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  // the route by spmm_entry's rule (kernels/spmm.py spmm_path)
  const int route = spmm_route(in_type, bk, bn, true);
  if (route == SP_WGMMA) {
    if (out_type == T_F32)
      return launch_union_wgmma<float>(a, vals, krows, gmap, ocol, out, m, k,
                                       n, bk, bn, U, nzero, compact, st);
    return launch_union_wgmma<__nv_bfloat16>(a, vals, krows, gmap, ocol, out,
                                             m, k, n, bk, bn, U, nzero,
                                             compact, st);
  }
  if (route == SP_TMA_FMA) {
    if (out_type == T_F32)
      return launch_union_tma_fma<float>(a, vals, krows, gmap, ocol, out, m,
                                         k, n, bk, bn, U, nzero, compact, st);
    return launch_union_tma_fma<__nv_bfloat16>(a, vals, krows, gmap, ocol,
                                               out, m, k, n, bk, bn, U, nzero,
                                               compact, st);
  }
  XSMM_SPMM_DISPATCH(launch_union, a, vals, krows, gmap, ocol, out, m, k, n,
                     bk, bn, U, nzero, compact, st)
}

// krows (n/128 * U); gmap (n/128 * U * 128/bn); ocol (n/bn)
int xsmm_bcsc_spmm_union(const void* a, const void* vals, const int* krows,
                         const int* gmap, const int* ocol, void* out, int m,
                         int k, int n, int bk, int bn, int U, int nzero,
                         int in_type, int out_type, void* stream) {
  return union_entry(a, vals, krows, gmap, ocol, out, m, k, n, bk, bn, U,
                     nzero, in_type, out_type, false,
                     static_cast<cudaStream_t>(stream));
}

// the compacted form (union, union2, union3) from one call: the compactor
// writes the RHS into the workspace rhs (n/128, U*bk, 128), then the union
// kernel reads it, launched programmatically so that its launch and plan
// overlap the compactor's tail; gmap still marks the dead slots. route and
// grid: the compactor's (xsmm_bcsc_union_compact)
int xsmm_bcsc_spmm_union_compacted(const void* a, const void* vals,
                                   const int* krows, const int* gmap,
                                   const int* ocol, void* rhs, void* out,
                                   int m, int k, int n, int bk, int bn, int U,
                                   int nzero, int in_type, int out_type,
                                   int route, int grid, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!union_args_ok(m, k, n, bk, bn, U, in_type, out_type))
    return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const int e = compact_entry(vals, gmap, rhs, n / GW, U, bk, bn, nzero,
                              in_type == T_F32 ? 4 : 2, route, grid, st);
  if (e != cudaSuccess) return e;
  return union_entry(a, rhs, krows, gmap, ocol, out, m, k, n, bk, bn, U,
                     nzero, in_type, out_type, true, st);
}

// vals (nblocks, bk, bn); gmap (nsg * U * 128/bn); out (nsg, U*bk, 128);
// elem_size: bytes per element of vals and out; route (0 bulk, 1 element
// units) as compact_entry takes it, grid the bulk route's (kernels/spmm.py
// compact_plan)
int xsmm_bcsc_union_compact(const void* vals, const int* gmap, void* out,
                            int nsg, int U, int bk, int bn, int nzero,
                            int elem_size, int route, int grid,
                            void* stream) {
  return compact_entry(vals, gmap, out, nsg, U, bk, bn, nzero, elem_size,
                       route, grid, static_cast<cudaStream_t>(stream));
}

// gmap (k/bk * n/bn); elem_size: bytes per element of vals and out; route
// (0 vector, 1 element units) as the wrapper chose it (BcscDensify.route):
// DN_VECTOR only where compact_route allows it, DN_ELEM on any input
// (scripts/stream_time.py times it on aligned values too); tb, rs: the
// wrapper's plan (kernels/spmm.py densify_plan)
int xsmm_bcsc_densify(const void* vals, const int* gmap, void* out, int k,
                      int n, int bk, int bn, int nzero, int elem_size,
                      int route, int tb, int rs, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k < 0 || n < 0 || bk <= 0 || bn <= 0 || k % bk || n % bn ||
      tb <= 0 || tb > DN_THREADS || rs <= 0 ||
      (route != DN_VECTOR && route != DN_ELEM) ||
      (route == DN_VECTOR &&
       compact_route(bn, elem_size, vals, out) != CP_BULK))
    return cudaErrorInvalidValue;
  if (k == 0 || n == 0) return cudaSuccess;
  const int kb = k / bk, nb = n / bn;
  if (route == DN_VECTOR)
    return launch_densify<uint4>(vals, gmap, out, kb, nb, bk,
                                 bn * elem_size / 16, tb, rs, nzero, st);
  switch (elem_size) {
    case 1:
      return launch_densify<uint8_t>(vals, gmap, out, kb, nb, bk, bn, tb, rs,
                                     nzero, st);
    case 2:
      return launch_densify<uint16_t>(vals, gmap, out, kb, nb, bk, bn, tb,
                                      rs, nzero, st);
    case 4:
      return launch_densify<uint32_t>(vals, gmap, out, kb, nb, bk, bn, tb,
                                      rs, nzero, st);
    case 8:
      return launch_densify<unsigned long long>(vals, gmap, out, kb, nb, bk,
                                                bn, tb, rs, nzero, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
