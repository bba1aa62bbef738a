// Hand-written Hopper (sm_90a) kernels of the block-sparse (BCSC) SpMM path
// of libxsmm_torch. They replace five Pallas TPU kernels of
// libxsmm_tpu/kernels/spmm_pallas.py:
//   xsmm_bcsc_spmm         build_bcsc_spmm         (:88,  strategy "pallas")
//   xsmm_bcsc_spmm_union   build_bcsc_spmm_union   (:258, union ... union5)
//     and xsmm_bcsc_spmm_union_compact, its form over a compacted RHS
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
// Two kernels serve the scheduled and supertile strategies; spmm_entry picks
// one (kernels/spmm.py spmm_path mirrors the choice):
// - bcsc_spmm_mma_kernel, for bf16 operands wherever bk % 16 == 0 and
//   bn % 8 == 0 (32 x 32, 16 x 64, the 128 x 128 supertiles): bf16 tiles
//   staged unwidened by cp.async in a 3-slice ring, products on the tensor
//   cores (mma.sync m16n8k16, f32 accumulator in registers);
// - bcsc_spmm_kernel for every other case (f32 operands: f32 means f32, no
//   TF32; blockings such as 8 x 8 or 4 x 48): bf16 widened exactly to f32
//   on load, every product and sum an f32 FMA.
//
// Bound, at the bench's streaming shape (m = 32768, k = n = 1024, bk = bn =
// 32, block density 0.2, bf16 in, f32 out): device memory, 201 MB of A and C
// (0.060 ms at 3.35 TB/s) against 13.8 GFLOP of useful products (0.014 ms on
// the bf16 tensor cores, 0.21 ms on the f32 FMA units). The supertile
// strategy multiplies whole occupied 128 x 128 supertiles: at that density
// 97% of them, 67 GFLOP (0.068 ms on the tensor cores).
// Design of the tensor-core kernel: one 256-thread block owns a 128-row tile
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
// The FMA kernel keeps a 64 x 32 f32 tile in registers (4 x 4 per thread)
// and stages 32-deep slices of A's panel and of the value block, widened, in
// shared memory; the union kernel keeps a 64 x 128 tile (4 x 8 per
// thread). Its fused form (union4, union4a, union4d, union5)
// assembles each slot's right-hand side in shared memory from the value
// store through the gather map; its compacted form (union, union2, union3)
// reads contiguous rows of the (n/128, U*bk, 128) RHS that the compactor
// wrote just before, on the same stream, as the reference splits the work.
// A is re-read from L2 for every block of a column; the kernels are bound by
// their shared-memory traffic, not by device memory. The compactor moves
// bytes only (values read once, the compacted RHS written once).

#include <cuda_runtime.h>

#include "xsmm_common.cuh"
#include "xsmm_mma.cuh"

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
// The same schedule on the bf16 tensor cores (bk % 16 == 0, bn % 8 == 0)
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
    const __nv_bfloat16* vs = as + a_elems;
    for (int kk = 0; kk < kc; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(af[i], as + (wm * 32 + i * 16 + (lane & 15)) * lda + kk +
                           (lane >> 4) * 8);
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, vs + (kk + (lane & 7) + (lane & 8)) * ldv + wn * WN +
                              p * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][2 * p], af[i], bf[0], bf[1]);
          mma_bf16(acc[i][2 * p + 1], af[i], bf[2], bf[3]);
        }
      }
    }
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
// Union RHS compactor (build_union_compact_rhs): out (n/128, U*bk, 128) from
// the gather map (n/128, U, W) of value indices, out[g, u bk + r, w bn + c]
// = vals[gmap[g, u, w], r, c] (nzero: zeros, so pad slots hold zeros and
// never stale memory). Block x owns slot x = g U + u and copies its W
// (bk x bn) blocks as raw units V of 1-16 bytes (V divides a block row's
// bn * itemsize bytes and both base addresses), so it serves any element
// type; `cpr` is the units per block row.
// ---------------------------------------------------------------------------

template <typename V>
__global__ void __launch_bounds__(256) bcsc_union_compact_kernel(
    const V* __restrict__ vals, const int* __restrict__ gmap,
    V* __restrict__ out, int W, int bk, int cpr, int nzero) {
  __shared__ int gm[GW];
  const long long slot = blockIdx.x;
  for (int w = threadIdx.x; w < W; w += blockDim.x) gm[w] = gmap[slot * W + w];
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
// value indices. It copies elements as raw bytes of their size, so it serves
// every element type; the zero block reads as all-zero bits.
// ---------------------------------------------------------------------------

template <typename E>
__global__ void __launch_bounds__(256) bcsc_densify_kernel(
    const E* __restrict__ vals, const int* __restrict__ gmap,
    E* __restrict__ out, int k, int n, int bk, int bn, int nzero) {
  const int c = blockIdx.x * 256 + threadIdx.x;
  if (c >= n) return;
  const int nb = n / bn, jb = c / bn, cc = c % bn;
  for (int r = blockIdx.y; r < k; r += gridDim.y) {
    const int v = gmap[(r / bk) * nb + jb];
    out[(long long)r * n + c] =
        v == nzero ? E(0) : vals[((long long)v * bk + r % bk) * bn + cc];
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
  const int kc = bk % 64 == 0 ? 64 : bk % 32 == 0 ? 32 : 16;
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

template <typename TI, typename TO>
static int launch_union(const void* a, const void* vals, const int* krows,
                        const int* gmap, const int* ocol, void* out, int m,
                        int k, int n, int bk, int bn, int U, int nzero,
                        bool compact, cudaStream_t st) {
  const long long gy = (m + TM - 1) / TM;
  if (gy > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(n / GW, (unsigned)gy);
  if (compact)
    bcsc_union_kernel<TI, TO, true><<<grid, 256, 0, st>>>(
        static_cast<const TI*>(a), static_cast<const TI*>(vals), krows, gmap,
        ocol, static_cast<TO*>(out), m, k, n, bk, bn, U, nzero);
  else
    bcsc_union_kernel<TI, TO, false><<<grid, 256, 0, st>>>(
        static_cast<const TI*>(a), static_cast<const TI*>(vals), krows, gmap,
        ocol, static_cast<TO*>(out), m, k, n, bk, bn, U, nzero);
  return cudaGetLastError();
}

template <typename V>
static int launch_compact(const void* vals, const int* gmap, void* out,
                          long long slots, int W, int bk, int cpr, int nzero,
                          cudaStream_t st) {
  if (slots > 2147483647LL) return cudaErrorInvalidConfiguration;
  bcsc_union_compact_kernel<V><<<(unsigned)slots, 256, 0, st>>>(
      static_cast<const V*>(vals), gmap, static_cast<V*>(out), W, bk, cpr,
      nzero);
  return cudaGetLastError();
}

template <typename E>
static int launch_densify(const void* vals, const int* gmap, void* out, int k,
                          int n, int bk, int bn, int nzero, cudaStream_t st) {
  const int gy = k < 65535 ? k : 65535;
  bcsc_densify_kernel<E><<<dim3((n + 255) / 256, gy), 256, 0, st>>>(
      static_cast<const E*>(vals), gmap, static_cast<E*>(out), k, n, bk, bn,
      nzero);
  return cudaGetLastError();
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

static int spmm_entry(const void* a, const void* vals, const int* ptr,
                      const int* rows, const int* vidx, void* out, int m,
                      int k, int n, int bk, int bn, int nzero, int in_type,
                      int out_type, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m < 0 || k <= 0 || n < 0 || bk <= 0 || bn <= 0 || k % bk || n % bn)
    return cudaErrorInvalidValue;
  if (m == 0 || n == 0) return cudaSuccess;
  // the tensor-core kernel for bf16 tiles whose depth is whole k16 steps and
  // whose rows are whole 16-byte units (kernels/spmm.py spmm_path)
  if (in_type == T_BF16 && bk % 16 == 0 && bn % 8 == 0) {
    if (out_type == T_F32)
      return launch_spmm_mma<float>(a, vals, ptr, rows, vidx, out, m, k, n,
                                    bk, bn, nzero, st);
    if (out_type == T_BF16)
      return launch_spmm_mma<__nv_bfloat16>(a, vals, ptr, rows, vidx, out, m,
                                            k, n, bk, bn, nzero, st);
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

static int union_entry(const void* a, const void* vals, const int* krows,
                       const int* gmap, const int* ocol, void* out, int m,
                       int k, int n, int bk, int bn, int U, int nzero,
                       int in_type, int out_type, bool compact, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m < 0 || k <= 0 || bk <= 0 || bn <= 0 || U <= 0 || k % bk ||
      GW % bn || n <= 0 || n % GW)
    return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  XSMM_SPMM_DISPATCH(launch_union, a, vals, krows, gmap, ocol, out, m, k, n,
                     bk, bn, U, nzero, compact, st)
}

// krows (n/128 * U); gmap (n/128 * U * 128/bn); ocol (n/bn)
int xsmm_bcsc_spmm_union(const void* a, const void* vals, const int* krows,
                         const int* gmap, const int* ocol, void* out, int m,
                         int k, int n, int bk, int bn, int U, int nzero,
                         int in_type, int out_type, void* stream) {
  return union_entry(a, vals, krows, gmap, ocol, out, m, k, n, bk, bn, U,
                     nzero, in_type, out_type, false, stream);
}

// the same over the compacted RHS rhs (n/128, U*bk, 128) of
// xsmm_bcsc_union_compact; gmap still marks the dead slots
int xsmm_bcsc_spmm_union_compact(const void* a, const void* rhs,
                                 const int* krows, const int* gmap,
                                 const int* ocol, void* out, int m, int k,
                                 int n, int bk, int bn, int U, int nzero,
                                 int in_type, int out_type, void* stream) {
  return union_entry(a, rhs, krows, gmap, ocol, out, m, k, n, bk, bn, U,
                     nzero, in_type, out_type, true, stream);
}

// vals (nblocks, bk, bn); gmap (nsg * U * 128/bn); out (nsg, U*bk, 128);
// elem_size: bytes per element of vals and out
int xsmm_bcsc_union_compact(const void* vals, const int* gmap, void* out,
                            int nsg, int U, int bk, int bn, int nzero,
                            int elem_size, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nsg < 0 || U <= 0 || bk <= 0 || bn <= 0 || GW % bn || elem_size <= 0)
    return cudaErrorInvalidValue;
  if (nsg == 0) return cudaSuccess;
  const int W = GW / bn;
  const long long slots = (long long)nsg * U;
  const int row_bytes = bn * elem_size;
  const unsigned long long addr =
      reinterpret_cast<unsigned long long>(vals) |
      reinterpret_cast<unsigned long long>(out);
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

// gmap (k/bk * n/bn); elem_size: bytes per element of vals and out
int xsmm_bcsc_densify(const void* vals, const int* gmap, void* out, int k,
                      int n, int bk, int bn, int nzero, int elem_size,
                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k < 0 || n < 0 || bk <= 0 || bn <= 0 || k % bk || n % bn)
    return cudaErrorInvalidValue;
  if (k == 0 || n == 0) return cudaSuccess;
  switch (elem_size) {
    case 1: return launch_densify<uint8_t>(vals, gmap, out, k, n, bk, bn, nzero, st);
    case 2: return launch_densify<uint16_t>(vals, gmap, out, k, n, bk, bn, nzero, st);
    case 4: return launch_densify<uint32_t>(vals, gmap, out, k, n, bk, bn, nzero, st);
    case 8: return launch_densify<unsigned long long>(vals, gmap, out, k, n, bk, bn, nzero, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
