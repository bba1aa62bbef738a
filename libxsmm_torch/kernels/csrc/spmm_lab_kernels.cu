// Hand-written Hopper (sm_90a) kernels of libxsmm_torch's BCSC lab (the
// port's scripts/bcsc_lab.py): probes of the k-union SpMM kernel
// (spmm_kernels.cu bcsc_union_wgmma_kernel), each keeping one property of a
// candidate schedule so the lab can time it against the union kernel. They
// replace the Pallas probes of scripts/bcsc_lab.py make_variants (:67):
//   xsmm_bcsc_lab_minimal  `minimal` (:100): the dot floor over a constant,
//                          already compacted RHS; no gather, no slot skip
//                          (xsmm_bcsc_lab_minimal_rhs_map encodes that
//                          RHS's TMA map once)
//   xsmm_bcsc_lab_chunk    `chunkN` (:125-186): the fused gather, with the U
//                          union slots cut into N chunks and the fill of
//                          chunk c + 1 issued before the math of chunk c
//   xsmm_bcsc_lab_dspipe   `dspipe` (:193-247): the fill of the next
//                          group's union issued before this group's math
//
// Plain C interface, no torch headers (see kernels/_build.py); the wrappers
// are kernels/spmm_lab.py. Each entry point launches on the caller's stream
// and returns cudaGetLastError().
//
// Operands, as the lab's: A (m, k) bf16 row-major; the BCSC values
// (nblocks, 32, 32) bf16, 32 x 32 blocks; out (m, n) f32. The union plan is
// the union kernel's without clustering: krows (n/128, U) block rows of A,
// gmap (n/128, U, 4) value indices, nblocks naming the zero block (zeros,
// never loaded; pad slots are multiplied, not skipped). Each block writes
// its output tile once, with no atomics: a repeat is bit for bit.
//
// Math. All three run on the bf16 tensor cores, as the library's union
// kernel does (on wgmma). chunkN and dspipe: mma.sync m16n8k16
// with an f32 accumulator on fragments that ldmatrix loads from the staged
// bf16 tiles (xsmm_mma.cuh); consumer warps own (16 MT) x 16 strips of the
// tile (MT m16 tiles, two n8 tiles): two warps down a tile of 32 rows or
// more, one for every 16 of its columns. minimal, whose operands are
// contiguous, takes Hopper's own path (xsmm_wgmma.cuh): TMA loads into
// 128-byte swizzled stages and wgmma.m64n128k16 by whole warpgroups, so it
// is a floor of the tensor-core union kernel's loop.
//
// Bound, at the lab's shape (m = k = n = 1024, density 0.2: U = 21 union
// slots of 32 rows, about 200 blocks): A (2.1 MB bf16), the values (0.4
// MB) and the f32 out (4.2 MB), each moved once, 6.7 MB: 2.0 us at 3.35
// TB/s, above the union's 2 * m * U * 32 * n = 1.41 GFLOP at the bf16
// tensor cores' peak (1.4 us). On the tensor cores the math shrinks about
// tenfold from the f32 FMAs' 21 us, and what bounds the probes is their
// staging: every tile fetches its own panels of A and its own RHS from L2,
// 44 MB for chunkN's 64 x 64 tiles and 88 MB for dspipe's 32 x 32 (the
// tile that two whole unions leave room for), and one or two blocks an SM
// is all the staging leaves. So the staging is warp-specialised:
// producer warps (CHUNK_PRODUCERS, DSPIPE_PRODUCERS threads) only issue
// cp.async, enough of them to keep the SM's copies in flight; each
// producer's copies of a step arrive on an mbarrier as they land, so the
// consumers start on step c while step c + 1 is still on its way.
//
// Shared memory. The TPU stages the whole union of A (all m rows) and of
// the RHS in VMEM, dspipe twice; here one union's RHS alone (672 x 128 bf16,
// 172 KB at U = 21) nearly fills the 227 KB a block may have. So the fused
// probes stage bf16 (16-byte cp.async, zeros for the zero block and rows
// past m; every row padded by 16 bytes, so ldmatrix's eight row addresses
// fall on eight bank groups) at a smaller grain:
//   chunkN  a TM x 64 tile (half a group): per chunk of ceil(U/N) slots,
//           TM * 64 + 4608 bytes a slot, two buffers when N > 1. TM is the
//           first of 64, 32, 16 whose staging fits (chunk1 at U = 21: 64
//           rows, 183 KB, one block an SM; chunk2: 2 x 97 KB; chunk4: 2 x
//           53 KB, two blocks an SM);
//   dspipe  a TM x 32 tile (one block column of a group), both buffers
//           holding a whole union, TM * 64 + 2560 bytes a slot each; TM is
//           32 up to U = 25 (194 KB at U = 21), 16 up to U = 32.
// kernels/spmm_lab.py chunk_plan and dspipe_plan are the same planner. A
// staging that does not fit even at 16 rows returns cudaErrorInvalidValue.
// minimal stages no union: its ring holds 64-deep slices of a 64 x 128
// tile, 24 KB a stage, at most MIN_STAGES deep (kernels/spmm_lab.py
// minimal_plan is its planner). At the lab's shape its
// blocks fetch 33 MB from L2 (A's panel and rhs[g] once per 64 x 128
// tile), which with the ramp of its one wave sets its time; the math (1.4
// us at peak) and device memory (2.1 us) do not. Every probe takes A and
// its RHS or values 16-byte aligned (the wrappers copy an operand that is
// not).

#include <cuda_runtime.h>
#include <string.h>

#include "xsmm_common.cuh"
#include "xsmm_mma.cuh"
#include "xsmm_wgmma.cuh"
#include "xsmm_launches.cuh"

namespace {

constexpr int BK = 32;   // block rows (the lab's bk)
constexpr int BN = 32;   // block columns (the lab's bn)
constexpr int GW = 128;  // output columns per union group
constexpr int W = GW / BN;
constexpr int SMEM_MAX = 232448;  // bytes of shared memory a block may use

typedef __nv_bfloat16 bf16;

// a kernel's dynamic shared memory, refused past SMEM_MAX
template <typename K>
cudaError_t set_smem(K kern, size_t bytes) {
  if (bytes > SMEM_MAX) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ---------------------------------------------------------------------------
// minimal: out[:, 128 g : 128 g + 128] = A[:, :32 U] @ rhs[g], rhs (n/128,
// 32 U, 128). Block (y, g) owns rows [64 y, 64 y + 64) of group g and
// walks the 32 U deep panel in 64-deep slices through a ring of `stages`
// TMA stages: A's 64 x 64 box (a 2-D map over A's first 32 U columns,
// row stride k: columns past 32 U and rows past m are filled with zeros)
// and rhs[g]'s 64 x 128 slice as two 64 x 64 boxes of a 3-D map over
// (128, 32 U, n/128) (rows past 32 U zero-filled), all 128-byte swizzled.
// One producer thread issues the loads; one consumer warpgroup owns the 64
// x 128 tile's f32 accumulators and runs four wgmma.m64n128k16 per
// slice (A K-major, B MN-major), as the packed BRGEMM's tensor-core kernel
// (gemm_kernels.cu 3b), keeping one slice's products in flight while the
// next stage is awaited (measured faster than waiting for them). Full and
// empty mbarriers pace the ring; each block writes its tile once. A cluster
// of two row tiles multicasting rhs[g] (a third less L2 traffic) measured
// slower at every shape tried (PERF.md) and is not used.
// ---------------------------------------------------------------------------

constexpr int MIN_BK = 64;                   // K of a ring stage
constexpr int MIN_B_BOX = MIN_BK * 64 * 2;   // 8 KB: 64 K rows x 64 columns
constexpr int MIN_STAGES = 4;                // the ring's depth, at most
constexpr int MIN_ROWS = 64;                 // rows of a block's tile
constexpr int MIN_A_BOX = MIN_ROWS * MIN_BK * 2;   // 8 KB: A's 64 x 64 box
// bytes of one ring stage: A's box and the RHS's two boxes, bf16
constexpr int MIN_STAGE = MIN_A_BOX + 2 * MIN_B_BOX;

// the block's dynamic shared memory: 1024 bytes of alignment slack, the
// stages, then a full and an empty mbarrier per stage
__host__ __device__ constexpr size_t min_smem_bytes(int stages) {
  return 1024 + (size_t)stages * MIN_STAGE + 2 * stages * 8;
}

// one consumer warpgroup and one producer warp
__global__ void __launch_bounds__(128 + 32, 1)
    bcsc_lab_minimal_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                                  const __grid_constant__ CUtensorMap rmap,
                                  float* __restrict__ out, int m, int n,
                                  int U, int stages) {
  constexpr int CONSUMERS = 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle is a function of the shared address: 1024-byte aligned ring
  unsigned char* smem =
      smem_raw + ((1024 - (wg_smem(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * MIN_STAGE);
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * MIN_ROWS, g = blockIdx.y;
  const int slices = (U * BK + MIN_BK - 1) / MIN_BK;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);                  // the producer's arrival
      mbar_init(&empty[s], CONSUMERS / 32);    // one per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {   // the producer warp: one thread starts TMA
    if (tid == CONSUMERS) {
      for (int it = 0; it < slices; ++it) {
        const int s = it % stages;
        if (it >= stages) mbar_wait(&empty[s], ((it / stages) - 1) & 1);
        unsigned char* st = smem + s * MIN_STAGE;
        mbar_arrive_expect_tx(&full[s], MIN_STAGE);
        tma_load_2d(st, &amap, &full[s], it * MIN_BK, row0);
        tma_load_3d(st + MIN_A_BOX, &rmap, &full[s], 0, it * MIN_BK, g);
        tma_load_3d(st + MIN_A_BOX + MIN_B_BOX, &rmap, &full[s], 64,
                    it * MIN_BK, g);
      }
    }
    return;
  }

  const int lane = tid & 31;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // one slice's products stay in flight while the next stage is awaited;
  // a stage is freed once the products after it are issued (so a ring of
  // more than one slice needs two stages: minimal_plan gives them)
  for (int it = 0; it < slices; ++it) {
    const int s = it % stages;
    mbar_wait(&full[s], (it / stages) & 1);
    const unsigned char* st = smem + s * MIN_STAGE;
    wgmma_fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < MIN_BK / 16; ++j) {
      const uint64_t da = wgmma_desc_sw128(st + 32 * j, 16, 1024);
      const uint64_t db = wgmma_desc_sw128(st + MIN_A_BOX + 2048 * j,
                                           MIN_B_BOX, 1024);
      wgmma_m64n128k16_bf16(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();
    wgmma_fence_operands(acc);
    __syncwarp();
    if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % stages]);
  }
  wgmma_wait<0>();
  wgmma_fence_operands(acc);
  // the tile: fragment rows and column pairs as in xsmm_wgmma.cuh
  const int w = tid >> 5;
  const int r0 = row0 + w * 16 + (lane >> 2);
  float* og = out + (long long)g * GW + 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<float2*>(og + (long long)row * n + 8 * j) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// minimal's ring (kernels/spmm_lab.py minimal_plan): min(MIN_STAGES,
// slices) stages; a block per 64-row tile and group (at the lab's 1024^3,
// 16 x 8 = 128 blocks, one wave on 132 SMs)
int minimal_stages(int U) {
  const int slices = (U * BK + MIN_BK - 1) / MIN_BK;
  return slices < MIN_STAGES ? slices : MIN_STAGES;
}

cudaError_t launch_minimal(const CUtensorMap& amap, const CUtensorMap& rmap,
                           float* out, int m, int n, int U, cudaStream_t st) {
  const int stages = minimal_stages(U);
  const size_t smem = min_smem_bytes(stages);
  const cudaError_t e = set_smem(bcsc_lab_minimal_wgmma_kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((m + MIN_ROWS - 1) / MIN_ROWS, n / GW);
  note_launch(bcsc_lab_minimal_wgmma_kernel);
  bcsc_lab_minimal_wgmma_kernel<<<grid, 128 + 32, smem, st>>>(
      amap, rmap, out, m, n, U, stages);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the fused probes' staging plan and tensor-core tile
// ---------------------------------------------------------------------------

constexpr int CHUNK_CW = 64;   // chunkN's tile columns (half a group)
constexpr int DSPIPE_CW = 32;  // dspipe's tile columns (one block column)

constexpr int BAR_BYTES = 16;  // the ring's two mbarriers, before its buffers

// bytes of shared memory of a staging plan: the ring's barriers and
// `buffers` buffers, each `slots` union slots deep for a rows x cw tile: A
// (rows x 32 slots) and the RHS (32 slots x cw), every row padded by 8
// elements (16 bytes)
__host__ __device__ constexpr size_t stage_bytes(int rows, int cw, int slots,
                                                 int buffers) {
  return BAR_BYTES + (size_t)buffers * sizeof(bf16) *
         ((size_t)rows * (slots * BK + 8) + (size_t)slots * BK * (cw + 8));
}

// The warps of a TM x CW tile. Consumers (NC threads, warps 0 ..): two
// down its rows (one for a 16-row tile), one for every 16 of its columns,
// each owning MT m16 tiles by two n8 tiles. Producers (NP threads, the
// warps after them): the cp.async staging alone.
constexpr int CHUNK_PRODUCERS = 256;
constexpr int DSPIPE_PRODUCERS = 384;

template <int TM, int CW, int PRODUCERS>
struct Tile {
  static constexpr int WARPS_M = TM >= 32 ? 2 : 1;
  static constexpr int WARPS_N = CW / 16;
  static constexpr int NC = 32 * WARPS_M * WARPS_N;
  static constexpr int MT = TM / (16 * WARPS_M);
  static constexpr int NP = PRODUCERS;
  static constexpr int THREADS = NC + NP;
};
template <int TM>
using ChunkTile = Tile<TM, CHUNK_CW, CHUNK_PRODUCERS>;
template <int TM>
using DspipeTile = Tile<TM, DSPIPE_CW, DSPIPE_PRODUCERS>;

// The two-buffer ring. Step c lives in buffer c & 1. Each producer thread's
// copies of a step arrive on that buffer's mbarrier (`full`, NP arrivals a
// phase) once they have landed, so the consumers start on a step as soon
// as it is in, while the producers already issue the next one; the
// consumers hand a buffer back through named barrier EMPTY + b (0 is
// __syncthreads') when a later step refills it.
constexpr int BAR_EMPTY = 1;

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// the producers' side over `count` steps, THREADS threads in the block:
// stage(c) issues step c into buffer c & 1 once the consumers have released
// step c - 2 from it
template <int THREADS, typename Stage>
__device__ __forceinline__ void produce(uint64_t* full, int count,
                                        Stage stage) {
  for (int c = 0; c < count; ++c) {
    if (c >= 2) bar_sync(BAR_EMPTY + (c & 1), THREADS);
    stage(c);
    cp_async_mbar_arrive(&full[c & 1]);
  }
  cp_async_wait_all();
}

// the consumers' side: use(c) once step c has landed, then release its
// buffer if a later step refills it
template <int THREADS, typename Use>
__device__ __forceinline__ void consume(uint64_t* full, int count, Use use) {
  for (int c = 0; c < count; ++c) {
    mbar_wait(&full[c & 1], (c >> 1) & 1);
    use(c);
    if (c + 2 < count) bar_arrive(BAR_EMPTY + (c & 1), THREADS);
  }
}

// the ring's barriers at the head of dynamic shared memory, initialised for
// NP producer arrivals a phase; returns the first buffer
template <int NP>
__device__ __forceinline__ bf16* ring_init(unsigned char* smem,
                                           uint64_t*& full) {
  full = reinterpret_cast<uint64_t*>(smem);
  if (threadIdx.x == 0) {
    mbar_init(&full[0], NP);
    mbar_init(&full[1], NP);
    mbar_fence_init();
  }
  __syncthreads();
  return reinterpret_cast<bf16*>(smem + BAR_BYTES);
}

// Stage union slots [u0, u1) of group g for the tile at (row0, column c0 of
// the group), CW columns wide: A's rows at the slots' block rows into sA
// (TM x (u1-u0)*32, row stride AS) and the slots' right-hand side into sR
// ((u1-u0)*32 x CW, row stride RS), every 64-byte block row in four 16-byte
// units, by NT producer threads (this one is tid). Slots past the range
// cost nothing: an empty range issues nothing.
template <int TM, int CW, int NT>
__device__ __forceinline__ void stage_slots(
    int tid, bf16* sA, int AS, bf16* sR, int RS, const bf16* __restrict__ a,
    const bf16* __restrict__ vals, const int* __restrict__ krows,
    const int* __restrict__ gmap, int g, int U, int u0, int u1, int row0,
    int c0, int m, int k, int nzero) {
  constexpr int upr = 4;           // units per 64-byte block row
  constexpr int ue = 8;            // elements per unit
  constexpr int NB = CW / BN;      // value blocks across the tile
  constexpr int AU = TM * upr;     // A units a slot: unit e of row r
  constexpr int RU = BK * NB * upr;  // RHS units a slot: unit e of row rr
                                     // of value block w
  const int cu = u1 - u0;
  const long long slot0 = (long long)g * U + u0;
  for (int i = tid; i < cu * AU; i += NT) {
    const int s = i / AU, r = i % AU / upr, e = i % upr;
    const bool ok = row0 + r < m;
    const bf16* src = a + (long long)(row0 + r) * k + krows[slot0 + s] * BK
                      + e * ue;
    cp_async16(sA + r * AS + s * BK + e * ue, ok ? src : a, ok);
  }
  for (int i = tid; i < cu * RU; i += NT) {
    const int s = i / RU, rr = i % RU / (NB * upr), w = i / upr % NB,
              e = i % upr;
    const int v = gmap[(slot0 + s) * W + c0 / BN + w];
    const bool ok = v != nzero;
    const bf16* src = vals + ((long long)v * BK + rr) * BN + e * ue;
    cp_async16(sR + (s * BK + rr) * RS + w * BN + e * ue, ok ? src : vals,
               ok);
  }
}

template <int MT>
__device__ __forceinline__ void zero(float (&acc)[MT][2][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
}

// acc += sA[the warp's rows, :depth] @ sR[:depth, the warp's 16 columns]
// on the tensor cores: warp (wm, wn) owns rows 16 MT wm .. +16 MT and
// columns 16 wn .. +16, one k16 step at a time (depth % 32 == 0), four
// steps unrolled so the fragment loads of one overlap the products of
// another
template <int MT>
__device__ __forceinline__ void mma_slots(float (&acc)[MT][2][4],
                                          const bf16* sA, int AS,
                                          const bf16* sR, int RS, int depth,
                                          int wm, int wn, int lane) {
#pragma unroll 4
  for (int kk = 0; kk < depth; kk += 16) {
    uint32_t af[MT][4], bf[4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      ldsm_x4(af[i], sA + ((wm * MT + i) * 16 + (lane & 15)) * AS + kk +
                         (lane >> 4) * 8);
    ldsm_x4_trans(bf, sR + (kk + (lane & 7) + (lane & 8)) * RS + wn * 16 +
                          (lane >> 4) * 8);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      mma_bf16(acc[i][0], af[i], bf[0], bf[1]);
      mma_bf16(acc[i][1], af[i], bf[2], bf[3]);
    }
  }
}

// the warp's strip of the tile at (row0, col0) of out, rows past m masked
template <int MT>
__device__ __forceinline__ void store_tile(const float (&acc)[MT][2][4],
                                           float* __restrict__ out, int row0,
                                           int col0, int m, int n, int wm,
                                           int wn, int lane) {
  const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = row0 + (wm * MT + i) * 16 + gq + h * 8;
      if (gr >= m) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        store_pair(out + (long long)gr * n + col0 + wn * 16 + j * 8 + t4 * 2,
                   acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    }
}

// ---------------------------------------------------------------------------
// chunkN: block (2 g + h, y) owns rows [TM y, TM y + TM) and columns
// [64 h, 64 h + 64) of group g. The U slots are cut into N chunks of
// ceil(U/N); chunk c + 1 is staged (cp.async) into the other buffer while
// the consumers multiply chunk c. One code path: the buffer is the chunk's
// parity, as in the TPU kernel's static parity.
// ---------------------------------------------------------------------------

template <int N, int TM>
__global__ void __launch_bounds__(ChunkTile<TM>::THREADS)
    bcsc_lab_chunk_kernel(const bf16* __restrict__ a,
                          const bf16* __restrict__ vals,
                          const int* __restrict__ krows,
                          const int* __restrict__ gmap,
                          float* __restrict__ out, int m, int k, int n, int U,
                          int nzero) {
  using T = ChunkTile<TM>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* full;
  bf16* base = ring_init<T::NP>(smem_raw, full);
  const int csl = (U + N - 1) / N;
  const int AS = csl * BK + 8, RS = CHUNK_CW + 8;
  const int abuf = TM * AS;
  const int buf = abuf + csl * BK * RS;
  const int g = blockIdx.x / (GW / CHUNK_CW);
  const int c0 = (blockIdx.x % (GW / CHUNK_CW)) * CHUNK_CW;
  const int row0 = blockIdx.y * TM;
  if (threadIdx.x >= T::NC) {
    produce<T::THREADS>(full, N, [&](int c) {
      bf16* b = base + (c & 1) * buf;
      stage_slots<TM, CHUNK_CW, T::NP>(
          threadIdx.x - T::NC, b, AS, b + abuf, RS, a, vals, krows, gmap, g,
          U, min(U, c * csl), min(U, (c + 1) * csl), row0, c0, m, k, nzero);
    });
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  float acc[T::MT][2][4];
  zero(acc);
  consume<T::THREADS>(full, N, [&](int c) {
    const bf16* b = base + (c & 1) * buf;
    const int depth = (min(U, (c + 1) * csl) - min(U, c * csl)) * BK;
    mma_slots<T::MT>(acc, b, AS, b + abuf, RS, depth, wm, wn, lane);
  });
  store_tile<T::MT>(acc, out, row0, g * GW + c0, m, n, wm, wn, lane);
}

// ---------------------------------------------------------------------------
// dspipe: block (h, y) owns rows [TM y, TM y + TM) and columns [32 h,
// 32 h + 32) of every group, and walks the groups in order: the whole union
// of group g + 1 is staged into the other buffer while the consumers
// multiply group g, the double buffering the TPU's sequential grid does
// across grid steps (Hopper blocks run in no order, so the loop over groups
// lives inside the block). One code path, as chunkN's.
// ---------------------------------------------------------------------------

template <int TM>
__global__ void __launch_bounds__(DspipeTile<TM>::THREADS)
    bcsc_lab_dspipe_kernel(const bf16* __restrict__ a,
                           const bf16* __restrict__ vals,
                           const int* __restrict__ krows,
                           const int* __restrict__ gmap,
                           float* __restrict__ out, int m, int k, int n,
                           int U, int nzero) {
  using T = DspipeTile<TM>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* full;
  bf16* base = ring_init<T::NP>(smem_raw, full);
  const int nsg = n / GW;
  const int AS = U * BK + 8, RS = DSPIPE_CW + 8;
  const int abuf = TM * AS;
  const int buf = abuf + U * BK * RS;
  const int c0 = blockIdx.x * DSPIPE_CW;
  const int row0 = blockIdx.y * TM;
  if (threadIdx.x >= T::NC) {
    produce<T::THREADS>(full, nsg, [&](int g) {
      bf16* b = base + (g & 1) * buf;
      stage_slots<TM, DSPIPE_CW, T::NP>(threadIdx.x - T::NC, b, AS, b + abuf,
                                        RS, a, vals, krows, gmap, g, U, 0, U,
                                        row0, c0, m, k, nzero);
    });
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  consume<T::THREADS>(full, nsg, [&](int g) {
    const bf16* b = base + (g & 1) * buf;
    float acc[T::MT][2][4];
    zero(acc);
    mma_slots<T::MT>(acc, b, AS, b + abuf, RS, U * BK, wm, wn, lane);
    store_tile<T::MT>(acc, out, row0, g * GW + c0, m, n, wm, wn, lane);
  });
}

bool bad_shape(int m, int k, int n, int U) {
  return m < 0 || k <= 0 || n <= 0 || U <= 0 || k % BK || n % GW ||
         (m + 15) / 16 > 65535;
}

bool misaligned(const void* a, const void* vals, const void* out) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(vals) |
           reinterpret_cast<uintptr_t>(out)) & 15) != 0;
}

struct Args {
  const bf16* a;
  const bf16* vals;
  const int* krows;
  const int* gmap;
  float* out;
  int m, k, n, U, nzero;
  cudaStream_t st;
};

// launch `kern` over `x` block columns and the row tiles of a TM x CW
// tile T, with `smem` bytes of staging (refused past SMEM_MAX)
template <int TM, typename T, typename K>
int launch(K kern, const Args& p, int x, size_t smem) {
  const cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(x, (p.m + TM - 1) / TM);
  note_launch(kern);
  kern<<<grid, T::THREADS, smem, p.st>>>(
      p.a, p.vals, p.krows, p.gmap, p.out, p.m, p.k, p.n, p.U, p.nzero);
  return cudaGetLastError();
}

// chunkN's plan: the first of 64, 32, 16 rows whose staging fits
// (kernels/spmm_lab.py chunk_plan)
template <int N>
int launch_chunk(const Args& p) {
  const int csl = (p.U + N - 1) / N, nbuf = N > 1 ? 2 : 1;
  const int x = (p.n / GW) * (GW / CHUNK_CW);
  const size_t s64 = stage_bytes(64, CHUNK_CW, csl, nbuf);
  const size_t s32 = stage_bytes(32, CHUNK_CW, csl, nbuf);
  if (s64 <= SMEM_MAX)
    return launch<64, ChunkTile<64>>(bcsc_lab_chunk_kernel<N, 64>, p, x, s64);
  if (s32 <= SMEM_MAX)
    return launch<32, ChunkTile<32>>(bcsc_lab_chunk_kernel<N, 32>, p, x, s32);
  return launch<16, ChunkTile<16>>(bcsc_lab_chunk_kernel<N, 16>, p, x,
                                   stage_bytes(16, CHUNK_CW, csl, nbuf));
}

// dspipe's plan: 32 rows if two whole unions fit, else 16
// (kernels/spmm_lab.py dspipe_plan)
int launch_dspipe(const Args& p) {
  const int x = GW / DSPIPE_CW;
  const size_t s32 = stage_bytes(32, DSPIPE_CW, p.U, 2);
  if (s32 <= SMEM_MAX)
    return launch<32, DspipeTile<32>>(bcsc_lab_dspipe_kernel<32>, p, x, s32);
  return launch<16, DspipeTile<16>>(bcsc_lab_dspipe_kernel<16>, p, x,
                                    stage_bytes(16, DSPIPE_CW, p.U, 2));
}

}  // namespace

extern "C" {

const char* xsmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// rhs (n/128, 32 U, 128) bf16, 16-byte aligned: its TMA map (64 x 64
// boxes), written to `map`, sizeof(CUtensorMap) = 128 bytes of host memory.
// The probe's RHS is constant, so the wrapper encodes it once.
int xsmm_bcsc_lab_minimal_rhs_map(const void* rhs, int n, int U, void* map) {
  if (n <= 0 || n % GW || U <= 0 || misaligned(rhs, rhs, rhs))
    return cudaErrorInvalidValue;
  CUtensorMap t;
  const cuuint64_t dims[3] = {(cuuint64_t)GW, (cuuint64_t)U * BK,
                              (cuuint64_t)(n / GW)};
  const cuuint64_t strides[2] = {(cuuint64_t)GW * 2,
                                 (cuuint64_t)U * BK * GW * 2};
  const cuuint32_t box[3] = {64, MIN_BK, 1};
  if (!encode_map(&t, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rhs, 3, dims,
                  strides, box))
    return cudaErrorInvalidValue;
  memcpy(map, &t, sizeof t);
  return cudaSuccess;
}

// a (m, k) bf16, 16-byte aligned; rhs_map from xsmm_bcsc_lab_minimal_rhs_map;
// out (m, n) f32, 8-byte aligned
int xsmm_bcsc_lab_minimal(const void* a, const void* rhs_map, void* out,
                          int m, int k, int n, int U, void* stream) {
  if (bad_shape(m, k, n, U) || U * BK > k ||
      misaligned(a, a, a) || reinterpret_cast<uintptr_t>(out) % 8)
    return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  CUtensorMap amap, rmap;
  memcpy(&rmap, rhs_map, sizeof rmap);
  const cuuint64_t dims[2] = {(cuuint64_t)U * BK, (cuuint64_t)m};
  const cuuint64_t strides[1] = {(cuuint64_t)k * 2};
  const cuuint32_t box[2] = {MIN_BK, MIN_ROWS};
  if (!encode_map(&amap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, 2, dims,
                  strides, box))
    return cudaErrorInvalidValue;
  return launch_minimal(amap, rmap, static_cast<float*>(out), m, n, U,
                        static_cast<cudaStream_t>(stream));
}

// a (m, k) bf16; vals (nblocks, 32, 32) bf16; krows (n/128 * U); gmap
// (n/128 * U * 4), nzero = nblocks; out (m, n) f32; a, vals and out 16-byte
// aligned
int xsmm_bcsc_lab_chunk(const void* a, const void* vals, const int* krows,
                        const int* gmap, void* out, int m, int k, int n,
                        int U, int nzero, int nchunks, void* stream) {
  if (bad_shape(m, k, n, U) || misaligned(a, vals, out))
    return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const Args p{static_cast<const bf16*>(a), static_cast<const bf16*>(vals),
               krows, gmap, static_cast<float*>(out), m, k, n, U, nzero,
               static_cast<cudaStream_t>(stream)};
  switch (nchunks) {
    case 1: return launch_chunk<1>(p);
    case 2: return launch_chunk<2>(p);
    case 4: return launch_chunk<4>(p);
    default: return cudaErrorInvalidValue;
  }
}

// the operands of xsmm_bcsc_lab_chunk
int xsmm_bcsc_lab_dspipe(const void* a, const void* vals, const int* krows,
                         const int* gmap, void* out, int m, int k, int n,
                         int U, int nzero, void* stream) {
  if (bad_shape(m, k, n, U) || misaligned(a, vals, out))
    return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  return launch_dspipe(Args{static_cast<const bf16*>(a),
                            static_cast<const bf16*>(vals), krows, gmap,
                            static_cast<float*>(out), m, k, n, U, nzero,
                            static_cast<cudaStream_t>(stream)});
}

}  // extern "C"
