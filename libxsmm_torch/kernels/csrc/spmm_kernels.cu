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
// Four kernels serve the scheduled and supertile strategies, and four the
// union strategies; spmm_entry and union_entry take the one spmm_route
// names (kernels/spmm.py spmm_path mirrors the rule):
// - bcsc_spmm_wgmma_kernel and bcsc_union_wgmma_kernel, route "wgmma", for
//   bf16 operands wherever bk % 32 == 0 and bn % 32 == 0 (32 x 32, 64 x
//   128, 128 x 128 and the supertiles): TMA-fed swizzled tiles, products
//   by wgmma (see their sections below);
// - bcsc_spmm_mma_kernel and bcsc_union_mma_kernel, route "mma", for bf16
//   operands wherever bk % 16 == 0 and bn % 8 == 0 and the wgmma kernels
//   do not serve (16 x 64, 48 x 24, 16 x 8, 48 x 32, 32 x 16): bf16 tiles
//   staged unwidened by cp.async in a 3-slice ring, products on the tensor
//   cores (mma.sync m16n8k16, f32 accumulator in registers);
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
// Design of the mma.sync kernel: one 256-thread block owns a 128-row tile
// of one block column (32, 64 or 128 columns wide; a wider block column is
// cut into 128-column chunks) and walks the column's schedule in slices of
// 16-64 rows of depth. Slices of A's panel (128 x kc) and of the value block
// (kc x bn) are in flight two slices ahead of the one being multiplied;
// rows past m, columns past bn and the zero block arrive as cp.async's zero
// fill. Eight warps each keep a 32 x (width/2) f32 tile in
// registers; A's fragments come from ldmatrix, the row-major value block's
// from ldmatrix.trans. Rows are padded by 16 bytes in shared memory so the
// ldmatrix rows fall in distinct banks. The grid's x runs over the block
// columns, so the blocks that share a row panel of A run together and read
// it from L2 (A is 64 MB at the streaming case, more than the 50 MB L2).
// The tensor-core union kernel runs the same pipeline over a 128 x 128
// tile (one row tile of one 128-column group): its schedule is the
// flattened (live union slot, depth slice) list of the group, so a slice
// never straddles two slots. Its fused form (union4, union4a, union4d,
// union5) assembles each slice of the slot's right-hand side in the ring
// from the W = 128 / bn value blocks of the slot's gather map, one 16-byte
// cp.async per bn-wide row piece (the zero block arrives as zero fill); its
// compacted form (union, union2, union3) copies contiguous rows of the
// (n/128, U*bk, 128) RHS that the compactor writes just before, on the same
// stream and from the same host call, as the reference splits the work; it
// is a programmatic dependent launch that waits for the compactor only
// before its first read of that RHS. At the streaming case
// (U = 21) the union products are 45 GFLOP, 0.046 ms at the tensor cores'
// peak, so the kernel is bound by the rate of its mma.sync steps and the
// shared-memory reads that feed them, not by device memory.
// The TMA-fed FMA kernels: see their section below. The FMA kernel keeps a
// 64 x 32 f32 tile in registers (4 x 4 per thread) and stages 32-deep
// slices of A's panel and of the value block, widened, in shared memory by
// plain loads between two barriers; the FMA union kernel keeps a 64 x 128
// tile (4 x 8 per thread) and assembles each slot's RHS the same way,
// element by element. A is re-read from L2 for every block of a column; the
// FMA kernels are bound by their shared-memory traffic, not by device
// memory. The compactor
// moves bytes only (values read once, the compacted RHS written once) on
// the bulk-copy engine where the blocks' rows are whole 16-byte units.

#include <cuda_runtime.h>

#include "xsmm_common.cuh"
#include "xsmm_mma.cuh"
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
// The same schedule on the bf16 tensor cores by mma.sync (bk % 16 == 0,
// bn % 8 == 0, where the wgmma kernel below does not serve: bk or bn not a
// multiple of 32)
//
// Block (x, y): block column jb = x / nchunk, columns [c0, c0 + TN) of it
// with c0 = (x % nchunk) * TN, rows [128 y, 128 y + 128). Iteration i of the
// block covers schedule step ptr[jb] + i / nsl, depth [k0, k0 + kc) of its
// blocks with k0 = (i % nsl) kc. Warp w multiplies rows 32 (w / 2) .. +32
// by columns (TN / 2) (w % 2) .. + TN / 2.
// ---------------------------------------------------------------------------

constexpr int MM_TM = 128;     // output rows per block
constexpr int MM_THREADS = 256;
constexpr int MM_STAGES = 3;   // slices in the shared-memory ring

__host__ __device__ constexpr int mm_stage_elems(int kc, int tn) {
  return MM_TM * (kc + 8) + kc * (tn + 8);    // rows padded by 16 bytes
}

// one kc-deep slice of a 128 x TN tile: warp (wm, wn) adds A's rows
// 32 wm .. +32 (as: 128 x kc at row stride kc + 8) times the RHS's columns
// (TN / 2) wn .. + TN / 2 (vs: kc x TN at row stride TN + 8) into acc
template <int TN>
__device__ __forceinline__ void mma_slice(float (&acc)[2][TN / 16][4],
                                          const __nv_bfloat16* as,
                                          const __nv_bfloat16* vs, int kc,
                                          int wm, int wn, int lane) {
  constexpr int WN = TN / 2, NT = WN / 8, ldv = TN + 8;
  const int lda = kc + 8;
  for (int kk = 0; kk < kc; kk += 16) {
    uint32_t af[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ldsm_x4(af[i], as + (wm * 32 + i * 16 + (lane & 15)) * lda + kk +
                         (lane >> 4) * 8);
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, vs + (kk + (lane & 7) + (lane & 8)) * ldv + wn * WN +
                            p * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_bf16(acc[i][2 * p], af[i], bf[0], bf[1]);
        mma_bf16(acc[i][2 * p + 1], af[i], bf[2], bf[3]);
      }
    }
  }
}

// depth of one staged slice: the largest of 64, 32, 16 that divides bk, so
// a slice never straddles two value blocks
__host__ __device__ constexpr int mm_kc(int bk) {
  return bk % 64 == 0 ? 64 : bk % 32 == 0 ? 32 : 16;
}

template <typename TO, int TN>
__global__ void __launch_bounds__(MM_THREADS, 2) bcsc_spmm_mma_kernel(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ vals,
    const int* __restrict__ ptr, const int* __restrict__ rows,
    const int* __restrict__ vidx, TO* __restrict__ out, int m, int k, int n,
    int bk, int bn, int nzero, int nchunk, int kc) {
  constexpr int WN = TN / 2;     // columns per warp
  constexpr int NT = WN / 8;     // its n8 tiles
  constexpr int MT = 2;          // its m16 tiles: 32 rows
  extern __shared__ __align__(16) unsigned char mm_smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(mm_smem);
  const int lda = kc + 8, ldv = TN + 8;
  const int a_elems = MM_TM * lda;
  const int st_elems = mm_stage_elems(kc, TN);

  const int jb = blockIdx.x / nchunk;
  const int c0 = (blockIdx.x % nchunk) * TN;
  const int row0 = blockIdx.y * MM_TM;
  const int width = min(TN, bn - c0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int s0 = ptr[jb];
  const int nsl = bk / kc;
  const int total = (ptr[jb + 1] - s0) * nsl;

  // stage iteration `it` into its ring slot; always commits a group, empty
  // past the end, so the wait below counts groups uniformly
  auto stage = [&](int it) {
    if (it < total) {
      __nv_bfloat16* as = ring + (it % MM_STAGES) * st_elems;
      __nv_bfloat16* vs = as + a_elems;
      const int s = s0 + it / nsl, k0 = (it % nsl) * kc;
      const __nv_bfloat16* ap = a + (long long)rows[s] * bk + k0;
      const int v = vidx[s];
      const int cpr = kc / 8;                 // 16-byte units per A row
      for (int i = tid; i < MM_TM * cpr; i += MM_THREADS) {
        const int r = i / cpr, c = (i - r * cpr) * 8, gr = row0 + r;
        const bool ok = gr < m;
        cp_async16(as + r * lda + c, ok ? ap + (long long)gr * k + c : a, ok);
      }
      constexpr int vpr = TN / 8;             // 16-byte units per value row
      for (int i = tid; i < kc * vpr; i += MM_THREADS) {
        const int r = i / vpr, c = (i - r * vpr) * 8;
        const bool ok = v != nzero && c < width;
        cp_async16(vs + r * ldv + c,
                   ok ? vals + ((long long)v * bk + k0 + r) * bn + c0 + c : a,
                   ok);
      }
    }
    cp_async_commit();
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int i = 0; i < MM_STAGES - 1; ++i) stage(i);
  for (int it = 0; it < total; ++it) {
    cp_async_wait<MM_STAGES - 2>();   // slice `it` has landed ...
    __syncthreads();                  // ... for every thread, and slot
                                      // it - 1 is free
    stage(it + MM_STAGES - 1);
    const __nv_bfloat16* as = ring + (it % MM_STAGES) * st_elems;
    mma_slice<TN>(acc, as, as + a_elems, kc, wm, wn, lane);
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t4 = lane & 3;
  TO* op = out + (long long)jb * bn + c0;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = wn * WN + j * 8 + t4 * 2;   // width % 8 == 0: the pair
    if (col >= width) continue;                 // is all in or all out
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gr = row0 + wm * 32 + i * 16 + g + h * 8;
        if (gr < m)
          store_pair(op + (long long)gr * n + col, acc[i][j][2 * h],
                     acc[i][j][2 * h + 1]);
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

  if constexpr (COMPACT) pdl_wait();   // as the tensor-core kernel's
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
// The k-union on the bf16 tensor cores (bk % 16 == 0, bn % 8 == 0)
//
// Block (x, y): column group grp = x, rows [128 y, 128 y + 128). Its
// schedule is the flattened list of (live slot u, depth slice) of the
// group, nsl = bk / kc slices per slot; iteration i stages A's 128 x kc
// slice at block row krows[grp U + u] and the slot's kc x 128 RHS slice
// into ring slot i % 3, two iterations ahead of the one multiplied. Every
// thread reads the same map to find the live slots, so the schedule (and
// the ring's cp.async group count) is block-uniform. Warp w multiplies
// rows 32 (w / 2) .. +32 by group columns 64 (w % 2) .. +64.
// ---------------------------------------------------------------------------

template <typename TO, bool COMPACT>
__global__ void __launch_bounds__(MM_THREADS, 2) bcsc_union_mma_kernel(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ vals,
    const int* __restrict__ krows, const int* __restrict__ gmap,
    const int* __restrict__ ocol, TO* __restrict__ out, int m, int k, int n,
    int bk, int bn, int U, int nzero, int kc) {
  constexpr int TN = GW;
  constexpr int WN = TN / 2, NT = WN / 8, MT = 2;
  extern __shared__ __align__(16) unsigned char mm_smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(mm_smem);
  const int lda = kc + 8, ldv = TN + 8;
  const int a_elems = MM_TM * lda;
  const int st_elems = mm_stage_elems(kc, TN);

  const int grp = blockIdx.x;
  const int row0 = blockIdx.y * MM_TM;
  const int W = GW / bn;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int nsl = bk / kc;
  const long long slot0 = (long long)grp * U;
  const int* gm = gmap + slot0 * W;
  // a slot whose W map entries are all the zero block is padding
  auto live = [&](int u) {
    for (int w = 0; w < W; ++w)
      if (gm[u * W + w] != nzero) return true;
    return false;
  };
  int nlive = 0;   // the threads test the slots in parallel
  for (int u0 = 0; u0 < U; u0 += MM_THREADS)
    nlive += __syncthreads_count(u0 + tid < U && live(u0 + tid));
  const int total = nlive * nsl;

  // the next iteration to stage: slice pk of slot pu
  int pu = 0, pk = 0;
  while (pu < U && !live(pu)) ++pu;
  // this thread's RHS units all lie in one 16-byte column c of the group
  // (256 threads, 16 units per row), so in one value block w = c / bn
  const int rc = (tid & 15) * 8;
  auto stage = [&](int it) {
    if (it < total) {
      __nv_bfloat16* as = ring + (it % MM_STAGES) * st_elems;
      __nv_bfloat16* vs = as + a_elems;
      const long long slot = slot0 + pu;
      const int k0 = pk * kc;
      const __nv_bfloat16* ap = a + (long long)krows[slot] * bk + k0;
      const int cpr = kc / 8;                 // 16-byte units per A row
      for (int i = tid; i < MM_TM * cpr; i += MM_THREADS) {
        const int r = i / cpr, c = (i - r * cpr) * 8, gr = row0 + r;
        const bool ok = gr < m;
        cp_async16(as + r * lda + c, ok ? ap + (long long)gr * k + c : a, ok);
      }
      if constexpr (COMPACT) {
        const __nv_bfloat16* rp = vals + (slot * bk + k0) * GW + rc;
        for (int r = tid >> 4; r < kc; r += MM_THREADS / 16)
          cp_async16(vs + r * ldv + rc, rp + (long long)r * GW, true);
      } else {
        const int v = gm[pu * W + rc / bn];
        const bool ok = v != nzero;
        const __nv_bfloat16* rp =
            ok ? vals + ((long long)v * bk + k0) * bn + rc % bn : a;
        for (int r = tid >> 4; r < kc; r += MM_THREADS / 16)
          cp_async16(vs + r * ldv + rc, ok ? rp + (long long)r * bn : a, ok);
      }
      if (++pk == nsl) {
        pk = 0;
        do ++pu; while (pu < U && !live(pu));
      }
    }
    cp_async_commit();
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // the compacted RHS is the compactor's output: with a programmatic
  // launch this block may start before the compactor ends
  if constexpr (COMPACT) pdl_wait();
#pragma unroll
  for (int i = 0; i < MM_STAGES - 1; ++i) stage(i);
  for (int it = 0; it < total; ++it) {
    cp_async_wait<MM_STAGES - 2>();   // slice `it` has landed ...
    __syncthreads();                  // ... for every thread, and slot
                                      // it - 1 is free
    stage(it + MM_STAGES - 1);
    const __nv_bfloat16* as = ring + (it % MM_STAGES) * st_elems;
    mma_slice<TN>(acc, as, as + a_elems, kc, wm, wn, lane);
  }
  cp_async_wait<0>();

  // group column c holds the caller's column ocol[grp W + c / bn] * bn +
  // c % bn; bn % 8 == 0, so a pair never straddles two block columns
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = wn * WN + j * 8 + t4 * 2;
    const long long col = (long long)ocol[grp * W + c / bn] * bn + c % bn;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gr = row0 + wm * 32 + i * 16 + g + h * 8;
        if (gr < m)
          store_pair(out + (long long)gr * n + col, acc[i][j][2 * h],
                     acc[i][j][2 * h + 1]);
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
// tensor-core kernel does (dead slots are skipped). A stage holds A's 128 x
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
// whole 32-deep and 32-wide pieces, bk % 32 == 0 and bn % 32 == 0:
// stream20's 32 x 32, 64 x 128, the 128 x 128 supertiles; the k-union has
// its own kernel below). It computes what bcsc_spmm_mma_kernel computes: each
// step's product summed in schedule order in f32 registers, rounded once on
// the store, one writer per output tile, no atomics.
//
// Bound: at the streaming case (m = 32768, k = n = 1024, 32 x 32 blocks at
// density 0.2, bf16 in, f32 out) device memory, 0.060 ms for A and C at
// 3.35 TB/s; A is re-read from L2 once per block column (about 430 MB), and
// each product is small (m64n32k16), so TMA and L2 set the pace, not the
// tensor cores. At the supertiles (128 x 128, 97% of them occupied) its own
// products are 67.65 GFLOP, 0.068 ms at the bf16 peak.
//
// Design: the f32 tma_fma kernel's producer with the bf16 BRGEMM's wgmma
// consumers. One block per output tile of 128 rows and TN = 32, 64 or 128
// columns of one block column (a wider block column is cut into TN-column
// chunks; columns past bn arrive as TMA's zero fill and are not stored). One
// producer warp keeps a ring of KC-deep slices in flight, KC = 64 where bk
// allows it, else 32, paced by full and empty mbarriers: A's 128 x KC slice
// from a 2-D map over A (m, k), at column rows[s] * bk + k0, and the value
// block's KC x TN slice from a 3-D map over the value store (bn, bk,
// nblocks), one box of up to 64 columns at a time. The zero block (an empty
// column's step) is loaded at block index nblocks (or 1 for an empty
// store), past the map's extent: TMA fills it with zeros and still counts
// its bytes, nothing is read from the value store, and a non-finite A in
// block row 0 still turns the column into NaN, as in the reference. Both
// slices land swizzled, 128-byte where their rows are 64 bf16 (KC = 64,
// value boxes 64 wide) and 64-byte where they are 32 (KC = 32, TN = 32):
// xsmm_wgmma.cuh's layouts. Two consumer warpgroups each own 64 rows of the
// tile and run wgmma.m64nTNk16 per k16 step, A K-major, the row-major value
// slice MN-major (the transpose bit), one slice's products in flight while
// the next slice is issued. The grid's x runs over the block columns, so
// the blocks that share A's row panel run together and read it from L2.
// ---------------------------------------------------------------------------

constexpr int SW_CONSUMERS = 256;               // two consumer warpgroups
constexpr int SW_THREADS = SW_CONSUMERS + 32;   // + the producer warp
constexpr int SW_TM = 128;                      // output rows a block

// the tile of TN columns and KC-deep slices: A's slice, the value slice as
// NB boxes of BOX_N columns (at most 64: a 128-byte swizzled row), the ring
template <int TN, int KC, int BOX = (TN < 64 ? TN : 64)>
struct SwTile {
  static constexpr int A_BYTES = SW_TM * KC * 2;
  static constexpr int BOX_N = BOX;
  static constexpr int NB = TN / BOX_N;
  static constexpr int V_BOX = KC * BOX_N * 2;
  static constexpr int STAGE = A_BYTES + NB * V_BOX;
  static constexpr int STAGES = KC == 64 ? 3 : 4;
  static constexpr int SMEM = SF_ALIGN + STAGES * STAGE + 2 * STAGES * 8;
  static_assert(STAGE % 1024 == 0 && V_BOX % 512 == 0,
                "every box starts on its swizzle's alignment");
  static_assert(2 * SMEM <= SF_SMEM_MAX, "two blocks an SM");
};

// the descriptors of k16 step j: A's (K-major) at `as`, the value slice's
// (MN-major) at `vs`, each in its slice's swizzle
template <int KC>
__device__ __forceinline__ uint64_t sw_adesc(const unsigned char* as, int j) {
  return KC == 64 ? wgmma_desc_sw128(as + 32 * j, 16, 1024)
                  : wgmma_desc_sw64(as + 32 * j, 16, 512);
}

template <int TN, int KC, int BOX = (TN < 64 ? TN : 64)>
__device__ __forceinline__ uint64_t sw_vdesc(const unsigned char* vs, int j) {
  using T = SwTile<TN, KC, BOX>;
  return T::BOX_N == 64 ? wgmma_desc_sw128(vs + 2048 * j, T::V_BOX, 1024)
                        : wgmma_desc_sw64(vs + 1024 * j, T::V_BOX, 512);
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
      Wg<TN>::template ss<0, 1>(
          acc, sw_adesc<KC>(as, j),
          sw_vdesc<TN, KC, T::BOX_N>(sp + T::A_BYTES, j), 1);
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
        mbar_arrive_expect_tx(&full[st], T::STAGE);
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

  // fragment rows and column pairs as in xsmm_wgmma.cuh; bn % 32 == 0: a
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
// operands, bk % 32 == 0 and bn % 32 == 0, so stream20's 32 x 32, 64 x 128
// and 128 x 128, in both forms). It computes what bcsc_union_mma_kernel
// computes: per 128-column group and 128-row tile, the live union slots'
// products (A's rows x bk panel at block row krows[slot] times the slot's
// bk x 128 right-hand side) summed in slot order in f32 registers, rounded
// once on the store, group column c stored at the caller's column
// ocol[grp W + c / bn] bn + c % bn, one writer per tile, no atomics.
//
// Bound: at the streaming case (U = 21 slots a group) its own products are
// 45 GFLOP, 0.046 ms at the bf16 peak, against 0.060 ms for A and C at 3.35
// TB/s; the mma.sync kernel ran them at a fifth of the peak, held by its
// mma.sync steps and the shared-memory reads that fed them.
//
// Design: bcsc_spmm_wgmma_kernel's plan at TN = 128 with the union's
// schedule (bcsc_union_tma_fma_kernel's producer). The live slots are found
// block-uniformly from the map (a slot whose W entries are all the zero
// block is padding and is skipped); the producer walks (live slot, KC-deep
// slice) and stages A's 128 x KC slice at column krows[slot] bk + k0 and
// the slot's KC x 128 right-hand side as 128 / BOX boxes of BOX columns:
// in the fused form (union4, union4a, union4d, union5) bn / BOX boxes of
// each of the W value blocks the gather map names, from the 3-D value map,
// the zero block loaded at the map's extent (vzero) so that TMA fills it
// with zeros and still counts its bytes; in the compacted form (union,
// union2, union3) two 64-column boxes of the compactor's (n/128, U bk,
// 128) output, after the programmatic launch's wait. Both forms land the
// same layout (BOX = 32: 64-byte swizzled rows, the fused form at bn = 32;
// else 128-byte), the boxes V_BOX bytes apart, which is the MN-major
// descriptor's leading offset (sw_vdesc), so the consumers do not depend
// on the form. Two consumer warpgroups each own 64 rows and run
// wgmma.m64n128k16 per k16 step, one slice's products in flight while the
// next slice is issued. The grid's x runs over the groups, so the blocks
// that share A's row tile read it from L2 together.
// ---------------------------------------------------------------------------

// Block (x, y): column group grp = x, rows [128 y, 128 y + 128). amap: A
// over (k, m) in boxes of KC x 128; rmap: the fused form's values over (bn,
// bk, nblocks) or the compacted RHS over (128, U bk, n / 128), in boxes of
// BOX x KC x 1; vzero: the value map's block extent (the zero block's
// index).
template <typename TO, int KC, int BOX, bool COMPACT>
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

  if (tid >= SW_CONSUMERS) {   // the producer warp: one thread starts TMA
    if (tid == SW_CONSUMERS) {
      int pu = 0, pk = 0;      // the next slice: pk of live slot pu
      while (pu < U && !live(pu)) ++pu;
      for (int it = 0; it < total; ++it) {
        const int st = it % T::STAGES;
        if (it >= T::STAGES) mbar_wait(&empty[st], ((it / T::STAGES) - 1) & 1);
        const int k0 = pk * KC;
        unsigned char* sp = ring + st * T::STAGE;
        unsigned char* rs = sp + T::A_BYTES;
        mbar_arrive_expect_tx(&full[st], T::STAGE);
        tma_load_2d(sp, &amap, &full[st], krows[slot0 + pu] * bk + k0, row0);
        if constexpr (COMPACT) {
#pragma unroll
          for (int h = 0; h < T::NB; ++h)
            tma_load_3d(rs + h * T::V_BOX, &rmap, &full[st], h * BOX,
                        pu * bk + k0, grp);
        } else {
          const int nbox = bn / BOX;   // boxes a value block
          for (int w = 0; w < W; ++w) {
            const int v = gm[pu * W + w];
            for (int h = 0; h < nbox; ++h)
              tma_load_3d(rs + (w * nbox + h) * T::V_BOX, &rmap, &full[st],
                          h * BOX, k0, v == nzero ? vzero : v);
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

  const int wg = tid >> 7, lane = tid & 31;
  float acc[GW / 2];
  sw_consume<T, GW, KC>(acc, ring, full, empty, total, wg, lane);

  // fragment rows and column pairs as in xsmm_wgmma.cuh; group column c
  // holds the caller's column ocol[grp W + c / bn] bn + c % bn. bn % 32 ==
  // 0, so each 32-column piece q of the group lies in one block column,
  // and starts at the caller's column cq[q]: a fragment's pieces are known
  // at compile time, and four loads serve the store
  const int r0 = row0 + wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  int cq[GW / 32];
#pragma unroll
  for (int q = 0; q < GW / 32; ++q)
    cq[q] = ocol[grp * W + 32 * q / bn] * bn + (32 * q) % bn;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r0 + 8 * h >= m) continue;
    TO* orow = out + (long long)(r0 + 8 * h) * n + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < GW / 8; ++j)
      store_pair(orow + cq[j / 4] + 8 * (j % 4), acc[4 * j + 2 * h],
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

// the tensor-core kernel at one column width TN (32, 64 or 128)
template <typename TO, int TN>
static int launch_spmm_mma_tn(const void* a, const void* vals, const int* ptr,
                              const int* rows, const int* vidx, void* out,
                              int m, int k, int n, int bk, int bn, int nzero,
                              cudaStream_t st) {
  const int nchunk = (bn + TN - 1) / TN;
  const int kc = mm_kc(bk);
  const long long gx = (long long)(n / bn) * nchunk;
  const long long gy = (m + MM_TM - 1) / MM_TM;
  if (gx > 2147483647LL || gy > 65535) return cudaErrorInvalidConfiguration;
  const int smem = MM_STAGES * mm_stage_elems(kc, TN) * 2;
  auto kern = bcsc_spmm_mma_kernel<TO, TN>;
  // above 48 KB only as dynamic shared memory, after the opt-in; set on
  // every launch, since the attribute is held per device
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  note_launch(kern);
  kern<<<dim3((unsigned)gx, (unsigned)gy), MM_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(vals), ptr, rows, vidx,
      static_cast<TO*>(out), m, k, n, bk, bn, nzero, nchunk, kc);
  return cudaGetLastError();
}

template <typename TO>
static int launch_spmm_mma(const void* a, const void* vals, const int* ptr,
                           const int* rows, const int* vidx, void* out, int m,
                           int k, int n, int bk, int bn, int nzero,
                           cudaStream_t st) {
  if (bn <= 32)
    return launch_spmm_mma_tn<TO, 32>(a, vals, ptr, rows, vidx, out, m, k, n,
                                      bk, bn, nzero, st);
  if (bn <= 64)
    return launch_spmm_mma_tn<TO, 64>(a, vals, ptr, rows, vidx, out, m, k, n,
                                      bk, bn, nzero, st);
  return launch_spmm_mma_tn<TO, 128>(a, vals, ptr, rows, vidx, out, m, k, n,
                                     bk, bn, nzero, st);
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

// the tensor-core union kernel; its compacted form runs right after the
// compactor and is launched programmatically
template <typename TO>
static int launch_union_mma(const void* a, const void* vals, const int* krows,
                            const int* gmap, const int* ocol, void* out, int m,
                            int k, int n, int bk, int bn, int U, int nzero,
                            bool compact, cudaStream_t st) {
  const long long gy = (m + MM_TM - 1) / MM_TM;
  if (gy > 65535) return cudaErrorInvalidConfiguration;
  const int kc = mm_kc(bk);
  const int smem = MM_STAGES * mm_stage_elems(kc, GW) * 2;
  auto kern = compact ? bcsc_union_mma_kernel<TO, true>
                      : bcsc_union_mma_kernel<TO, false>;
  // above 48 KB only as dynamic shared memory, after the opt-in
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return launch_pdl(kern, dim3(n / GW, (unsigned)gy), MM_THREADS, smem, st,
                    compact, static_cast<const __nv_bfloat16*>(a),
                    static_cast<const __nv_bfloat16*>(vals), krows, gmap,
                    ocol, static_cast<TO*>(out), m, k, n, bk, bn, U, nzero,
                    kc);
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

// the wgmma kernel at one column width TN (32, 64 or 128) and slice depth
// KC (64 or 32); a, vals bf16 and 16-byte aligned, bk % 32 == 0, bn % 32 ==
// 0. A's map: (k, m) in boxes of KC x 128; the values' map: (bn, bk,
// nblocks) in boxes of BOX_N x KC x 1 (an empty store: one block of A's
// memory, never read in bounds), the zero block at block index vzero, the
// extent
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
  const CUtensorMapDataType B = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t adims[2] = {(cuuint64_t)k, (cuuint64_t)m};
  const cuuint64_t astr[1] = {(cuuint64_t)k * 2};
  const cuuint32_t abox[2] = {KC, SW_TM};
  const cuuint64_t vdims[3] = {(cuuint64_t)bn, (cuuint64_t)bk,
                               (cuuint64_t)vzero};
  const cuuint64_t vstr[2] = {(cuuint64_t)bn * 2, (cuuint64_t)bk * bn * 2};
  const cuuint32_t vbox[3] = {T::BOX_N, KC, 1};
  CUtensorMap amap, vmap;
  if (!encode_map(&amap, B, a, 2, adims, astr, abox,
                  KC == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_64B) ||
      !encode_map(&vmap, B, nzero > 0 ? vals : a, 3, vdims, vstr, vbox,
                  T::BOX_N == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : CU_TENSOR_MAP_SWIZZLE_64B))
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

template <typename TO, int KC>
static int launch_spmm_wgmma_kc(const void* a, const void* vals,
                                const int* ptr, const int* rows,
                                const int* vidx, void* out, int m, int k,
                                int n, int bk, int bn, int nzero,
                                cudaStream_t st) {
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
  if (bk % 64 == 0)
    return launch_spmm_wgmma_kc<TO, 64>(a, vals, ptr, rows, vidx, out, m, k,
                                        n, bk, bn, nzero, st);
  return launch_spmm_wgmma_kc<TO, 32>(a, vals, ptr, rows, vidx, out, m, k, n,
                                      bk, bn, nzero, st);
}

// the wgmma union kernel at slice depth KC and box width BOX, in one form;
// a, vals bf16 and 16-byte aligned, bk % 32 == 0, bn % 32 == 0. A's map as
// the scheduled kernel's; the right-hand side's: the fused form's values
// over (bn, bk, nblocks) (an empty store: one block of A's memory, never
// read in bounds; the zero block at block index vzero, the extent), the
// compacted form's RHS over (128, U bk, n / 128), in boxes of BOX x KC x 1.
// The compacted form runs right after the compactor and is launched
// programmatically.
template <typename TO, int KC, int BOX, bool COMPACT>
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
  const CUtensorMapDataType B = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t adims[2] = {(cuuint64_t)k, (cuuint64_t)m};
  const cuuint64_t astr[1] = {(cuuint64_t)k * 2};
  const cuuint32_t abox[2] = {KC, SW_TM};
  const cuuint64_t rdims[3] = {
      (cuuint64_t)(COMPACT ? GW : bn), (cuuint64_t)(COMPACT ? U * bk : bk),
      (cuuint64_t)(COMPACT ? n / GW : vzero)};
  const cuuint64_t rstr[2] = {(cuuint64_t)rdims[0] * 2,
                              (cuuint64_t)rdims[0] * rdims[1] * 2};
  const cuuint32_t rbox[3] = {BOX, KC, 1};
  CUtensorMap amap, rmap;
  if (!encode_map(&amap, B, a, 2, adims, astr, abox,
                  KC == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_64B) ||
      !encode_map(&rmap, B, COMPACT || nzero > 0 ? vals : a, 3, rdims, rstr,
                  rbox,
                  BOX == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;
  auto kern = bcsc_union_wgmma_kernel<TO, KC, BOX, COMPACT>;
  // above 48 KB only as dynamic shared memory, after the opt-in
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  return launch_pdl(kern, dim3(n / GW, (unsigned)gy), SW_THREADS, T::SMEM,
                    st, COMPACT, amap, rmap, krows, gmap, ocol,
                    static_cast<TO*>(out), m, n, bk, bn, U, nzero, vzero);
}

// KC = 64 where bk allows it, else 32; the compacted RHS in 64-column
// boxes, the fused form's in boxes of min(bn, 64)
template <typename TO, int KC>
static int launch_union_wgmma_kc(const void* a, const void* vals,
                                 const int* krows, const int* gmap,
                                 const int* ocol, void* out, int m, int k,
                                 int n, int bk, int bn, int U, int nzero,
                                 bool compact, cudaStream_t st) {
  if (compact)
    return launch_union_wgmma_at<TO, KC, 64, true>(
        a, vals, krows, gmap, ocol, out, m, k, n, bk, bn, U, nzero, st);
  if (bn == 32)
    return launch_union_wgmma_at<TO, KC, 32, false>(
        a, vals, krows, gmap, ocol, out, m, k, n, bk, bn, U, nzero, st);
  return launch_union_wgmma_at<TO, KC, 64, false>(
      a, vals, krows, gmap, ocol, out, m, k, n, bk, bn, U, nzero, st);
}

template <typename TO>
static int launch_union_wgmma(const void* a, const void* vals,
                              const int* krows, const int* gmap,
                              const int* ocol, void* out, int m, int k, int n,
                              int bk, int bn, int U, int nzero, bool compact,
                              cudaStream_t st) {
  if (bk % 64 == 0)
    return launch_union_wgmma_kc<TO, 64>(a, vals, krows, gmap, ocol, out, m,
                                         k, n, bk, bn, U, nzero, compact, st);
  return launch_union_wgmma_kc<TO, 32>(a, vals, krows, gmap, ocol, out, m, k,
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
enum { SP_FMA, SP_MMA, SP_TMA_FMA, SP_WGMMA };

// the kernel a call takes (kernels/spmm.py spmm_path mirrors it): the wgmma
// kernels for bf16 calls whose blocks are whole 32-deep, 32-wide pieces
// (scheduled, supertile and k-union alike); the mma.sync kernels for the
// other bf16 tiles whose depth is whole k16 steps and whose rows are whole
// 16-byte units; the TMA-fed FMA kernel for f32 blocks whose
// rows and depth are whole 16-byte units (TMA's strides), in the union at
// most SF_UNION_BOXES value blocks a group; the FMA kernel for the rest
static int spmm_route(int in_type, int bk, int bn, bool uni) {
  if (in_type == T_BF16 && bk % 32 == 0 && bn % 32 == 0) return SP_WGMMA;
  if (in_type == T_BF16 && bk % 16 == 0 && bn % 8 == 0) return SP_MMA;
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
  if (route == SP_MMA) {
    if (out_type == T_F32)
      return launch_spmm_mma<float>(a, vals, ptr, rows, vidx, out, m, k, n,
                                    bk, bn, nzero, st);
    if (out_type == T_BF16)
      return launch_spmm_mma<__nv_bfloat16>(a, vals, ptr, rows, vidx, out, m,
                                            k, n, bk, bn, nzero, st);
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
  if (route == SP_MMA) {
    if (out_type == T_F32)
      return launch_union_mma<float>(a, vals, krows, gmap, ocol, out, m, k, n,
                                     bk, bn, U, nzero, compact, st);
    return launch_union_mma<__nv_bfloat16>(a, vals, krows, gmap, ocol, out, m,
                                           k, n, bk, bn, U, nzero, compact,
                                           st);
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
