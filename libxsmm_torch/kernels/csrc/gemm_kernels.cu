// Hand-written Hopper (sm_90a) kernels for libxsmm_torch's dense small-GEMM
// main path: the lane-packed batched SMM, the unpacked batched SMM and the
// lane-packed batch-reduce GEMM (BRGEMM). They replace the three Pallas TPU
// kernels of libxsmm_tpu/kernels/gemm_pallas.py. Beside them stand the two
// streaming twins the JAX package times its kernels against: the BRGEMM's
// (gemm_pallas.py:334 build_packed_brgemm_sol) and the packed SMM's
// passthrough (bench.py:438-448).
//
// Plain C interface, no torch headers: kernels/_build.py compiles this file
// with nvcc into a shared library and kernels/gemm.py calls it through
// ctypes. Every entry point launches on the caller's stream, allocates
// nothing (the wrapper passes outputs and scratch from torch.empty), does
// not synchronise, and returns cudaGetLastError() so the wrapper raises on a
// refused launch.
//
// Arithmetic: f32 operands multiply and add in f32 on the CUDA cores (no
// TF32, no bf16 split); bf16 operands are widened to f32 as they are read
// and accumulate in f32,
// except the BRGEMM's tensor-core route (section 3b), where the tensor cores
// multiply bf16 exactly and accumulate in f32; int8 operands accumulate in
// int32. Sums run in a fixed order, so a result does not change from run to
// run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "xsmm_wgmma.cuh"

enum { T_F32 = 0, T_BF16 = 1, T_I8 = 2, T_I32 = 3 };
enum { EPI_NONE = 0, EPI_RELU = 1, EPI_X2 = 2, EPI_TANH = 3, EPI_SIGMOID = 4,
       EPI_GELU = 5 };

// ---------------------------------------------------------------------------
// element conversions and the fused epilogues
// ---------------------------------------------------------------------------

__device__ __forceinline__ float load_cvt(float x) { return x; }
__device__ __forceinline__ float load_cvt(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ int load_cvt(int8_t x) { return (int)x; }

__device__ __forceinline__ void store_cvt(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_cvt(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);   // round to nearest even, as astype(bf16)
}
__device__ __forceinline__ void store_cvt(int v, int* p) { *p = v; }

// erf by Abramowitz-Stegun 7.1.26 (|err| <= 1.5e-7): the same approximation
// as the reference's _erf_approx (libxsmm_tpu/kernels/gemm_pallas.py:443),
// so GELU agrees with it to rounding
__device__ __forceinline__ float erf_approx(float x) {
  const float sign = x < 0.f ? -1.f : 1.f;
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * ax);
  const float poly = t * (0.254829592f + t * (-0.284496736f + t * (
      1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return sign * (1.0f - poly * expf(-ax * ax));
}

__device__ __forceinline__ float apply_epi(float x, int epi) {
  switch (epi) {
    case EPI_RELU: return x < 0.f ? 0.f : x;   // NaN passes, as jnp.maximum
    case EPI_X2: return x * x;
    case EPI_TANH: return tanhf(x);
    case EPI_SIGMOID: return 1.0f / (1.0f + expf(-x));
    case EPI_GELU: return 0.5f * x * (1.0f + erf_approx(x * 0.7071067811865476f));
    default: return x;
  }
}

// int32 accumulators wrap on overflow as the reference's int32 arithmetic
// does; signed overflow is undefined in C++, so square and add in uint32
__device__ __forceinline__ int apply_epi(int x, int epi) {
  if (epi == EPI_RELU) return x < 0 ? 0 : x;
  if (epi == EPI_X2) {
    const uint32_t u = (uint32_t)x;
    return (int)(u * u);
  }
  return x;
}

__device__ __forceinline__ float add_wrap(float a, float b) { return a + b; }
__device__ __forceinline__ int add_wrap(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

template <typename Acc> struct Vec4;
template <> struct Vec4<float> { typedef float4 type; };
template <> struct Vec4<int> { typedef int4 type; };

// one 16-byte load of TIn elements, widened into Acc elements
template <typename TIn, typename Acc>
__device__ __forceinline__ void load16_cvt(const TIn* src, Acc* dst) {
  constexpr int V = 16 / sizeof(TIn);
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const TIn* e = reinterpret_cast<const TIn*>(&raw);
#pragma unroll
  for (int i = 0; i < V; ++i) dst[i] = load_cvt(e[i]);
}

// raise a kernel's dynamic shared memory limit when it needs more than the
// default 48 KB; set on every such launch, since the attribute is held per
// device and a process may launch on several
template <typename K>
static cudaError_t ensure_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ---------------------------------------------------------------------------
// 1. Lane-packed batched SMM. Replaces build_packed_batched_gemm
//    (libxsmm_tpu/kernels/gemm_pallas.py:467).
//
// a (G, m, 128) = [A_0 | .. | A_{P-1}], b (G, k, 128) = [B_0 | .. | B_{P-1}],
// c (G, m, 128) -> out (G, m, 128) with lane slot p = epi(A_p B_p [+ C_p]),
// P = 128 / n, k == n. The TPU kernel builds a block-diagonal (128, 128)
// RHS to fill its matrix unit; here each thread runs its slot's k-long dot
// directly on the packed layout, so no zero block is read or multiplied.
//
// Bound: device memory. At 16384 x 32^3 f32 the stream is 201 MB against
// 1.07 GFLOP (5.3 FLOP/byte), 60 us at 3.35 TB/s. Design: one block per
// (group, 2*RPT-row tile); every row is 128 contiguous elements, so A's
// tile and all of B_g are staged into shared memory with 16-byte coalesced
// loads (widened to the accumulator type); thread (col, half) then keeps RPT
// accumulators of column `col` in registers and reads A four lanes at a time
// (one 16-byte shared load per four FMAs). Warps share their rows, so A's
// shared reads are broadcasts; B's are one bank per lane.
// ---------------------------------------------------------------------------

template <typename TIn, typename Acc, typename TOut, int RPT>
__global__ void __launch_bounds__(256)
packed_smm_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
                  const Acc* __restrict__ c, TOut* __restrict__ out,
                  int m, int k, int epi) {
  constexpr int W = 128;        // packed row width: P*k == P*n == 128
  constexpr int MT = 2 * RPT;   // rows per block
  constexpr int V = 16 / sizeof(TIn);
  typedef typename Vec4<Acc>::type V4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* As = reinterpret_cast<Acc*>(smem_raw);   // MT x W
  Acc* Bs = As + MT * W;                         // k x W

  const long g = blockIdx.x;
  const int row0 = blockIdx.y * MT;
  const int tid = threadIdx.x;
  const TIn* ag = a + (g * m + row0) * (long)W;
  const TIn* bg = b + g * (long)k * W;

  for (int i = tid; i < MT * W / V; i += 256) {
    const int e = i * V;
    if (row0 + e / W < m) {
      load16_cvt(ag + e, As + e);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) As[e + j] = Acc(0);
    }
  }
  for (int i = tid; i < k * W / V; i += 256) load16_cvt(bg + i * V, Bs + i * V);
  __syncthreads();

  const int col = tid & (W - 1);
  const int half = tid >> 7;
  const int aoff = col - col % k;   // slot p = col / n starts at lane p*k
  const Acc* Ar = As + half * RPT * W + aoff;
  Acc acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = Acc(0);

  if ((k & 3) == 0) {
    for (int l = 0; l < k; l += 4) {
      const Acc b0 = Bs[(l + 0) * W + col], b1 = Bs[(l + 1) * W + col];
      const Acc b2 = Bs[(l + 2) * W + col], b3 = Bs[(l + 3) * W + col];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const V4 av = *reinterpret_cast<const V4*>(Ar + r * W + l);
        acc[r] += av.x * b0;
        acc[r] += av.y * b1;
        acc[r] += av.z * b2;
        acc[r] += av.w * b3;
      }
    }
  } else {   // k in {1, 2}: no 16-byte A reads
    for (int l = 0; l < k; ++l) {
      const Acc bv = Bs[l * W + col];
#pragma unroll
      for (int r = 0; r < RPT; ++r) acc[r] += Ar[r * W + l] * bv;
    }
  }

  const long base = (g * m + row0) * (long)W;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = half * RPT + r;
    if (row0 + row < m) {
      const long o = base + (long)row * W + col;
      Acc v = acc[r];
      if (c != nullptr) v = add_wrap(v, c[o]);
      store_cvt(apply_epi(v, epi), out + o);
    }
  }
}

template <typename TIn, typename Acc, typename TOut, int RPT>
static cudaError_t launch_packed_smm(const void* a, const void* b,
                                     const void* c, void* out, int G, int m,
                                     int k, int epi, cudaStream_t s) {
  constexpr int MT = 2 * RPT;
  const size_t smem = (size_t)(MT + k) * 128 * sizeof(Acc);
  auto kern = packed_smm_kernel<TIn, Acc, TOut, RPT>;
  const cudaError_t e = ensure_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(G, (m + MT - 1) / MT);
  kern<<<grid, 256, smem, s>>>(static_cast<const TIn*>(a),
                               static_cast<const TIn*>(b),
                               static_cast<const Acc*>(c),
                               static_cast<TOut*>(out), m, k, epi);
  return cudaGetLastError();
}

template <typename TIn, typename Acc, typename TOut>
static cudaError_t packed_smm_rpt(int rpt, const void* a, const void* b,
                                  const void* c, void* out, int G, int m,
                                  int k, int epi, cudaStream_t s) {
  switch (rpt) {
    case 4: return launch_packed_smm<TIn, Acc, TOut, 4>(a, b, c, out, G, m, k, epi, s);
    case 8: return launch_packed_smm<TIn, Acc, TOut, 8>(a, b, c, out, G, m, k, epi, s);
    case 16: return launch_packed_smm<TIn, Acc, TOut, 16>(a, b, c, out, G, m, k, epi, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// 2. Unpacked batched SMM. Replaces build_batched_gemm
//    (libxsmm_tpu/kernels/gemm_pallas.py:67).
//
// a (B, m, k), b (B, k, n), c (B, m, n) f32 -> out (B, m, n); m <= 256,
// n, k <= 128, f32/bf16 in and out. The TPU kernel moves gg problems (about
// 0.75 MB) per grid step through VMEM.
//
// Bound: device memory. At 16384 x 32^3 f32 the stream is 201 MB against
// 1.07 GFLOP (5.3 FLOP/byte): 60 us at 3.35 TB/s. So the design keeps bytes
// in flight and touches each byte once. A unit of work is one problem's
// mt-row tile of A with the whole B_i (mt = m where it fits); up to four
// blocks per SM walk the units u, u + gridDim.x, ... through a ring of
// `stages` shared-memory stages. One producer warp fills the ring, paced by
// full and empty mbarriers: where a problem's A and B runs are whole
// 16-byte units (m*k and k*n bytes multiples of 16, bases aligned: route
// BG_BULK) one thread issues two 1-D bulk copies per unit (two 4 KB copies
// at 32^3 f32); otherwise (odd k or n: BG_CPASYNC) the warp copies each run
// with 16-byte cp.async over its aligned interior, 4-byte cp.async at its
// ends and a plain load for a 2-byte bf16 head or tail, and each lane's
// copies arrive on the full barrier when they land. The route follows the
// shape alone (kernels/gemm.py batched_plan mirrors bg_route and
// bg_stage_bytes); no route falls back to the other. Four consumer warps
// each keep an RM x 4 strip of f32 accumulators per thread (RM the least of
// 1, 2, 4 that covers the tile in one pass, else 4 and more passes; 2 at
// 32^3); small blocks, many per SM, keep several units in compute at once,
// and the unit's indices step without a division. bf16 is widened as it is
// read from shared memory; A is read as broadcasts (four k at a time where
// k % 4 == 0) and B as four-column vectors; C0 is read and the output
// stored as 16-byte (bf16: 8-byte) accesses where n % 4 == 0. The sum runs
// in a fixed order, so a result does not change from run to run.
// ---------------------------------------------------------------------------

constexpr int BG_CONSUMERS = 128;                  // four consumer warps
constexpr int BG_THREADS = BG_CONSUMERS + 32;      // + the producer warp
constexpr int BG_SMEM_MAX = 232448;   // a block's dynamic shared memory
constexpr int BG_SMEM_SM = 233472;    // an SM's, 1 KB of it kept per block
constexpr int BG_MAX_BLOCKS = 4;      // blocks per SM: the launch bounds'
enum { BG_BULK = 0, BG_CPASYNC = 1 };

static inline long bg_align16(long x) { return (x + 15) / 16 * 16; }

// the route of a shape: 1-D bulk copies where every A and B run is whole
// 16-byte units, cp.async otherwise
static inline int bg_route(int m, int n, int k, int sz) {
  return ((long)m * k * sz) % 16 == 0 && ((long)k * n * sz) % 16 == 0
             ? BG_BULK : BG_CPASYNC;
}

// bytes of A's region of a stage (an mt-row tile), and of a whole stage;
// the cp.async route keeps 16 spare bytes per run: it places each run at
// its global address mod 16
static inline long bg_a_region(int route, int mt, int k, int sz) {
  return bg_align16((long)mt * k * sz) + (route == BG_CPASYNC ? 16 : 0);
}
static inline long bg_stage_bytes(int route, int mt, int n, int k, int sz) {
  return bg_a_region(route, mt, k, sz) + bg_align16((long)k * n * sz) +
         (route == BG_CPASYNC ? 16 : 0);
}

// the run [src, src + bytes) into dst + (src % 16), over the lanes of the
// producer warp: its 16-byte aligned interior in 16-byte cp.async units,
// the rest in 4-byte units, and a 2-byte head or tail (bf16 runs that start
// or end off 4 bytes) by a plain load and store
__device__ __forceinline__ void bg_copy_run(unsigned char* dst,
                                            const unsigned char* src,
                                            int bytes, int lane) {
  const int off = (int)(reinterpret_cast<uintptr_t>(src) & 15);
  unsigned char* d = dst + off;
  const int h4 = (4 - (off & 3)) & 3;             // 0 or 2
  const int e4 = h4 + ((bytes - h4) & ~3);        // end of the 4-byte units
  int h16 = (16 - off) & 15;                      // 16-byte interior
  if (h16 > e4) h16 = e4;
  const int e16 = h16 + ((e4 - h16) & ~15);
  if (h4 && lane == 0)
    *reinterpret_cast<uint16_t*>(d) =
        __ldg(reinterpret_cast<const unsigned short*>(src));
  if (e4 < bytes && lane == 31)
    *reinterpret_cast<uint16_t*>(d + e4) =
        __ldg(reinterpret_cast<const unsigned short*>(src + e4));
  for (int i = h16 + 16 * lane; i < e16; i += 512) cp_async16_cg(d + i, src + i);
  const int i4 = h4 + 4 * lane;                   // at most 3 + 3 units
  if (i4 < h16) cp_async4(d + i4, src + i4);
  if (e16 + 4 * lane < e4) cp_async4(d + e16 + 4 * lane, src + e16 + 4 * lane);
}

// four consecutive elements at p, widened to f32 (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ void bg_load4(const float* p, float* d) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
}
__device__ __forceinline__ void bg_load4(const __nv_bfloat16* p, float* d) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  d[0] = __low2float(lo); d[1] = __high2float(lo);
  d[2] = __low2float(hi); d[3] = __high2float(hi);
}

__device__ __forceinline__ void bg_store4(const float* v, float* p) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void bg_store4(const float* v, __nv_bfloat16* p) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 w;
  w.x = *reinterpret_cast<uint32_t*>(&lo);
  w.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = w;
}

// the units a block walks, u = blockIdx.x, + gridDim.x, ...: problem p and
// tile t of u, stepped without a division per unit
struct BgCursor {
  long p;
  int t, tiles, dp, dt;
  __device__ BgCursor(int tiles_) : tiles(tiles_) {
    p = blockIdx.x / tiles;
    t = blockIdx.x - (int)p * tiles;
    dp = gridDim.x / tiles;
    dt = gridDim.x - dp * tiles;
  }
  __device__ void next() {
    p += dp;
    t += dt;
    if (t >= tiles) { t -= tiles; ++p; }
  }
};

// VEC: the bulk route with k % 4 == 0 and n % 4 == 0 (vector reads of A and
// B, vector C0 and output); otherwise element reads with clamped indices
template <typename TIn, typename TOut, int RM, bool VEC>
__global__ void __launch_bounds__(BG_THREADS, BG_MAX_BLOCKS)
batched_gemm_ring_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
                         const float* __restrict__ c, TOut* __restrict__ out,
                         int B, int m, int n, int k, int mt, int stages,
                         int route, int stage_bytes, int a_region) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (long)stages * stage_bytes);
  uint64_t* empty = full + stages;
  const int tiles = (m + mt - 1) / mt;
  const int tid = threadIdx.x;
  constexpr int SZ = sizeof(TIn);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      // bulk: the producer's one arrival; cp.async: each lane's copies and
      // each lane's own arrival after its plain stores
      mbar_init(&full[s], route == BG_BULK ? 1 : 64);
      mbar_init(&empty[s], BG_CONSUMERS / 32);   // one per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  BgCursor cur(tiles);
  int s = 0;
  uint32_t phase = 0;   // parity of the ring's current pass
  if (tid >= BG_CONSUMERS) {   // the producer warp
    const int lane = tid - BG_CONSUMERS;
    if (route == BG_BULK && lane != 0) return;   // one thread issues
    for (int it = 0; cur.p < B; cur.next(), ++it) {
      if (it >= stages) mbar_wait(&empty[s], phase ^ 1);
      const int row0 = cur.t * mt;
      const int rows = min(mt, m - row0);
      const unsigned char* ga = reinterpret_cast<const unsigned char*>(
          a + (cur.p * m + row0) * (long)k);
      const unsigned char* gb =
          reinterpret_cast<const unsigned char*>(b + cur.p * k * (long)n);
      unsigned char* st = smem + (long)s * stage_bytes;
      const int abytes = rows * k * SZ, bbytes = k * n * SZ;
      if (route == BG_BULK) {
        mbar_arrive_expect_tx(&full[s], abytes + bbytes);
        bulk_load_1d(st, ga, abytes, &full[s]);
        bulk_load_1d(st + a_region, gb, bbytes, &full[s]);
      } else {
        bg_copy_run(st, ga, abytes, lane);
        bg_copy_run(st + a_region, gb, bbytes, lane);
        cp_async_mbar_arrive(&full[s]);
        mbar_arrive(&full[s]);   // releases this lane's plain stores
      }
      if (++s == stages) { s = 0; phase ^= 1; }
    }
    if (route == BG_CPASYNC) cp_async_wait_all();
    return;
  }

  const int lane = tid & 31;
  const int nq = (n + 3) / 4;   // four-column quads of the output
  const int rs0 = tid / nq, cq0 = tid - rs0 * nq;   // this thread's first item
  for (; cur.p < B; cur.next()) {
    mbar_wait(&full[s], phase);
    const int row0 = cur.t * mt;
    const int rows = min(mt, m - row0);
    const TIn* ag = a + (cur.p * m + row0) * (long)k;
    const TIn* bg = b + cur.p * k * (long)n;
    const unsigned char* st = smem + (long)s * stage_bytes;
    // the producer's placement: each run at its global address mod 16
    const TIn* As = reinterpret_cast<const TIn*>(
        st + (reinterpret_cast<uintptr_t>(ag) & 15));
    const TIn* Bs = reinterpret_cast<const TIn*>(
        st + a_region + (reinterpret_cast<uintptr_t>(bg) & 15));
    const long obase = (cur.p * m + row0) * (long)n;
    const int items = (rows + RM - 1) / RM * nq;
    int rs = rs0, cq = cq0;
    for (int w = tid; w < items; w += BG_CONSUMERS) {
      if (w != tid) { rs = w / nq; cq = w - rs * nq; }
      const int r0 = rs * RM, c0 = cq * 4;
      float acc[RM][4];
      int ar[RM];   // A's row offsets; rows past the tile clamped, not stored
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        ar[i] = min(r0 + i, rows - 1) * k;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      }
      if constexpr (VEC) {
        const TIn* bp = Bs + c0;
#pragma unroll 2
        for (int l = 0; l < k; l += 4, bp += 4 * n) {
          float bv[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) bg_load4(bp + j * n, bv[j]);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            float av[4];
            bg_load4(As + ar[i] + l, av);
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[i][q] += av[j] * bv[j][q];
          }
        }
      } else {
        int cc[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) cc[q] = min(c0 + q, n - 1);
        for (int l = 0; l < k; ++l) {
          float bv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) bv[q] = load_cvt(Bs[l * n + cc[q]]);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float av = load_cvt(As[ar[i] + l]);
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][q] += av * bv[q];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        if (r0 + i >= rows) break;
        const long o = obase + (long)(r0 + i) * n + c0;
        if constexpr (VEC) {
          if (c != nullptr) {
            float cv[4];
            bg_load4(c + o, cv);
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][q] += cv[q];
          }
          bg_store4(acc[i], out + o);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (c0 + q < n) {
              float v = acc[i][q];
              if (c != nullptr) v += c[o + q];
              store_cvt(v, out + o + q);
            }
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (++s == stages) { s = 0; phase ^= 1; }
  }
}

template <typename TIn, typename TOut, int RM>
static cudaError_t launch_batched_rm(bool vec, const void* a, const void* b,
                                     const void* c, void* out, int B, int m,
                                     int n, int k, int mt, int stages,
                                     int route, int grid, long stage_bytes,
                                     long a_region, size_t smem,
                                     cudaStream_t s) {
  auto kern = vec ? batched_gemm_ring_kernel<TIn, TOut, RM, true>
                  : batched_gemm_ring_kernel<TIn, TOut, RM, false>;
  const cudaError_t e = ensure_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, BG_THREADS, smem, s>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(b),
      static_cast<const float*>(c), static_cast<TOut*>(out), B, m, n, k, mt,
      stages, route, (int)stage_bytes, (int)a_region);
  return cudaGetLastError();
}

// the wrapper's plan (route, mt, stages, grid); a route other than the
// shape's, a stage that does not fit or an operand off the alignment its
// route reads returns cudaErrorInvalidValue
template <typename TIn, typename TOut>
static cudaError_t launch_batched_gemm(const void* a, const void* b,
                                       const void* c, void* out, int B,
                                       int m, int n, int k, int route,
                                       int mt, int stages, int grid,
                                       cudaStream_t s) {
  constexpr int SZ = sizeof(TIn);
  const uintptr_t ab = reinterpret_cast<uintptr_t>(a) |
                       reinterpret_cast<uintptr_t>(b);
  if (route != bg_route(m, n, k, SZ) || mt <= 0 || mt > m || stages < 2 ||
      grid <= 0 || (route == BG_BULK && (ab % 16 || ((long)mt * k * SZ) % 16)) ||
      ab % SZ)
    return cudaErrorInvalidValue;
  const bool vec = route == BG_BULK && k % 4 == 0 && n % 4 == 0;
  if (vec && reinterpret_cast<uintptr_t>(c) % 16) return cudaErrorInvalidValue;
  const long stage_bytes = bg_stage_bytes(route, mt, n, k, SZ);
  const size_t smem = (size_t)stages * (stage_bytes + 16);   // + barriers
  if (smem > (size_t)BG_SMEM_MAX) return cudaErrorInvalidValue;
  const long a_region = bg_a_region(route, mt, k, SZ);
  const int nq = (n + 3) / 4;
  int rm = 1;
  while (rm < 4 && (mt + rm - 1) / rm * nq > BG_CONSUMERS) rm *= 2;
  switch (rm) {
#define BG_RM(R)                                                              \
  case R:                                                                     \
    return launch_batched_rm<TIn, TOut, R>(vec, a, b, c, out, B, m, n, k, mt, \
                                           stages, route, grid, stage_bytes,  \
                                           a_region, smem, s);
    BG_RM(1) BG_RM(2) BG_RM(4)
#undef BG_RM
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// 3. Lane-packed BRGEMM. Replaces build_packed_brgemm
//    (libxsmm_tpu/kernels/gemm_pallas.py:163). Three routes
//    (kernels/gemm.py brgemm_path), none falling back to another: bf16
//    with n % 8 == 0 on the tensor cores (3b), f32 with n % 4 == 0 on
//    TMA-fed FMA tiles (3c), and the rest (f32 with n % 4 != 0, bf16 with
//    n % 8 != 0: B's rows are not whole 16-byte units, TMA's global stride)
//    on the FMA kernel below.
//
// C = epi(sum_i A_i B_i + C0 + D) -> (m, n), with a (G, m, Q*k) packed and
// b (G*Q, k, n). Contraction index K = g*Q*k + j runs over a[g, :, j] and
// row K of b viewed as (G*Q*k, n), so the whole product is one (m, K) x
// (K, n) GEMM.
//
// Bound: at br=1024, m=n=256, k=64 bf16 it reads 67 MB (20 us at 3.35 TB/s)
// for 8.6 GFLOP; on the CUDA cores (67 TFLOP/s f32) the operations bound
// it, at 128 us. The TPU's sequential grid carries one accumulator across
// steps, but Hopper blocks run in no order and m=n=256 gives only 16
// output tiles for 132 SMs. So the K range is split over gridDim.z blocks:
// each writes its 64x64 partial tile (4x4 per thread, 16-byte shared reads)
// to an f32 workspace, and a second pass adds the partials in a fixed order
// (seeded with C0, then + D, epilogue, one cast). No atomics: the epilogue
// sees the full sum and the result is the same every run. The last chunk
// is ragged; its K bound masks it.
//
// SOL = true is the streaming twin (build_packed_brgemm_sol,
// gemm_pallas.py:334): out = rowsum(A)[:, None] + colsum(B)[None, :] over
// the whole contraction, f32. It keeps this kernel's grid, K split, shared
// memory loads and K-bound mask (the TPU twin's ragged-step select), then
// the same fixed-order reduce with no C0, no D and no epilogue; only the 16
// FMAs of the outer product per k become 4 + 4 adds into running row and
// column sums. The BRGEMM runs on the CUDA cores' FMAs, so one add per
// product would cost what the math costs and the twin would time the math,
// not the stream. Bound: the BRGEMM's bytes (20 us at the shape above).
// ---------------------------------------------------------------------------

constexpr int BR_BM = 64, BR_BN = 64, BR_BK = 16;

template <typename TIn, bool SOL>
__global__ void __launch_bounds__(256)
brgemm_partial_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
                      float* __restrict__ ws, int m, int n, int qk, long K,
                      long kchunk) {
  __shared__ __align__(16) float As[BR_BK][BR_BM];
  __shared__ __align__(16) float Bs[BR_BK][BR_BN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * BR_BN, m0 = blockIdx.y * BR_BM;
  const long kb0 = (long)blockIdx.z * kchunk;
  const long kb1 = kb0 + kchunk < K ? kb0 + kchunk : K;
  const int la_row = tid >> 2, la_k = (tid & 3) * 4;     // A: 64 rows x 16
  const int lb_k = tid >> 4, lb_col = (tid & 15) * 4;    // B: 16 x 64 cols
  float acc[4][4];
  float sa[4], sb[4];   // SOL: running sums of this thread's rows and columns
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sa[i] = sb[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (long kb = kb0; kb < kb1; kb += BR_BK) {
    // a BK slice never crosses a group: Q*k is a multiple of 128
    const long g = kb / qk;
    const int kk0 = (int)(kb - g * qk);
    const int row = m0 + la_row;
    const TIn* ap = a + ((g * m + row) * (long)qk + kk0 + la_k);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = row < m && kb + la_k + e < kb1;
      As[la_k + e][la_row] = ok ? load_cvt(ap[e]) : 0.f;
    }
    const long kr = kb + lb_k;
    const TIn* bp = b + kr * (long)n + n0 + lb_col;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = n0 + lb_col + e < n && kr < kb1;
      Bs[lb_k][lb_col + e] = ok ? load_cvt(bp[e]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BR_BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float bc[4] = {bv.x, bv.y, bv.z, bv.w};
      if constexpr (SOL) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sa[i] += ar[i];
          sb[i] += bc[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += ar[i] * bc[j];
      }
    }
    __syncthreads();
  }

  float* wz = ws + (long)blockIdx.z * m * n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < n) wz[(long)row * n + col] = SOL ? sa[i] + sb[j] : acc[i][j];
    }
  }
}

template <typename TOut>
__global__ void brgemm_reduce_kernel(const float* __restrict__ ws,
                                     const float* __restrict__ c0,
                                     const float* __restrict__ d,
                                     TOut* __restrict__ out, long mn,
                                     int splits, int epi) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = c0 != nullptr ? c0[i] : 0.f;   // beta=1 seeds the sum
  for (int z = 0; z < splits; ++z) s += ws[z * mn + i];
  if (d != nullptr) s += d[i];
  store_cvt(apply_epi(s, epi), out + i);
}

// the second pass of both routes: the partials of `splits` K ranges in z
// order, then D, the epilogue and one cast
template <typename TOut>
static cudaError_t launch_brgemm_reduce(const void* ws, const void* c0,
                                        const void* d, void* out, long mn,
                                        int splits, int epi, cudaStream_t s) {
  brgemm_reduce_kernel<TOut><<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<const float*>(c0),
      static_cast<const float*>(d), static_cast<TOut*>(out), mn, splits, epi);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 3b. Lane-packed BRGEMM on the bf16 tensor cores, for bf16 operands with
//     n % 8 == 0 (kernels/gemm.py brgemm_path "wgmma"; f32 runs 3c or the
//     FMA kernel above, bf16 with another n the latter). Replaces build_packed_brgemm
//     (libxsmm_tpu/kernels/gemm_pallas.py:163) on that route; SOL = true is
//     its streaming twin (gemm_pallas.py:334).
//
// Bound: the shape above reads 67 MB (20 us at 3.35 TB/s); its 8.6 GFLOP
// take 8.7 us at the bf16 tensor cores' 989 TFLOP/s, so the stream bounds
// it, and reaching that bound needs about 430 TFLOP/s of products: wgmma's
// rate, not mma.sync's. Design: one block per (128 x 128 output tile, K
// split) and about one block per SM (the wrapper's planner: 4 tiles x 32
// splits at 256^2). One producer warp keeps a ring of TC_STAGES 64-deep
// slices in flight with TMA: A's 128 x 64 slice from a 3-D map over (Q*k,
// m, G) (a slice never crosses a group: Q*k is a multiple of 128) and B's
// 64 x 128 slice as two 64 x 64 boxes of a 2-D map over (n, K), both with
// the 128-byte swizzle, out-of-bounds rows and columns filled with zeros.
// Two consumer warpgroups each own 64 rows x 128 columns of f32
// accumulators in registers and run four wgmma.m64n128k16 per slice (A
// K-major, B MN-major). Full and empty mbarriers pace the ring. Each block
// writes its partial tile to the f32 workspace and brgemm_reduce_kernel adds
// the partials in z order, as on the FMA route: no atomics, one result.
//
// The twin keeps the grid, split, maps, ring and barriers; its consumers
// read each slice through the swizzle (eight 16-byte shared loads a thread
// per slice) into running row sums of A and column sums of B, then write
// rowsum + colsum of their K range to the workspace.
// ---------------------------------------------------------------------------

constexpr int TC_BM = 128, TC_BN = 128, TC_BK = 64, TC_STAGES = 4;
constexpr int TC_A_BYTES = TC_BM * TC_BK * 2;             // 16 KB
constexpr int TC_B_BOX = TC_BK * 64 * 2;                   // 8 KB, 64 columns
constexpr int TC_STAGE_BYTES = TC_A_BYTES + 2 * TC_B_BOX;  // 32 KB
constexpr int TC_CONSUMERS = 256;                          // two warpgroups
constexpr int TC_THREADS = TC_CONSUMERS + 32;              // + the producer
// the twin's reduction scratch: 16 partial column sums per column, the
// row sums and the column sums of the tile
constexpr int TC_SOL_FLOATS = 16 * TC_BN + TC_BM + TC_BN;

constexpr size_t tc_smem_bytes(bool sol) {
  return 1024 + (size_t)TC_STAGES * TC_STAGE_BYTES + 2 * TC_STAGES * 8 +
         (sol ? TC_SOL_FLOATS * sizeof(float) : 0);
}

// the consumer warpgroups' own barrier (the producer warp never joins)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(TC_CONSUMERS) : "memory");
}

template <bool SOL>
__global__ void __launch_bounds__(TC_THREADS, 1)
brgemm_partial_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                            const __grid_constant__ CUtensorMap bmap,
                            float* __restrict__ ws, int m, int n, int qk,
                            long K, long kchunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle is a function of the shared address: 1024-byte aligned ring
  unsigned char* smem = smem_raw + ((1024 - (wg_smem(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + TC_STAGES * TC_STAGE_BYTES);
  uint64_t* empty = full + TC_STAGES;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * TC_BN, m0 = blockIdx.y * TC_BM;
  const long kb0 = (long)blockIdx.z * kchunk;
  const long kb1 = kb0 + kchunk < K ? kb0 + kchunk : K;
  const int slices = (int)((kb1 - kb0) / TC_BK);   // whole 64-deep slices

  if (tid == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(&full[s], 1);                       // the producer's arrival
      mbar_init(&empty[s], TC_CONSUMERS / 32);      // one per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= TC_CONSUMERS) {   // the producer warp: one thread starts TMA
    if (tid == TC_CONSUMERS) {
      for (int it = 0; it < slices; ++it) {
        const int s = it % TC_STAGES;
        if (it >= TC_STAGES) mbar_wait(&empty[s], ((it / TC_STAGES) - 1) & 1);
        const long kb = kb0 + (long)it * TC_BK;
        const int g = (int)(kb / qk);
        const int kk = (int)(kb - (long)g * qk);
        unsigned char* st = smem + s * TC_STAGE_BYTES;
        mbar_arrive_expect_tx(&full[s], TC_STAGE_BYTES);
        tma_load_3d(st, &amap, &full[s], kk, m0, g);
        tma_load_2d(st + TC_A_BYTES, &bmap, &full[s], n0, (int)kb);
        tma_load_2d(st + TC_A_BYTES + TC_B_BOX, &bmap, &full[s], n0 + 64,
                    (int)kb);
      }
    }
    return;
  }

  const int wg = tid >> 7;          // this warpgroup's 64 rows of the tile
  const int lane = tid & 31;
  float* wz = ws + (long)blockIdx.z * m * n;

  if constexpr (!SOL) {
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int it = 0; it < slices; ++it) {
      const int s = it % TC_STAGES;
      mbar_wait(&full[s], (it / TC_STAGES) & 1);
      const unsigned char* st = smem + s * TC_STAGE_BYTES;
      wgmma_fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < TC_BK / 16; ++j) {
        const uint64_t da = wgmma_desc_sw128(st + wg * (TC_A_BYTES / 2) + 32 * j,
                                             16, 1024);
        const uint64_t db = wgmma_desc_sw128(st + TC_A_BYTES + 2048 * j,
                                             TC_B_BOX, 1024);
        wgmma_m64n128k16_bf16(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_operands(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // the partial tile: fragment rows and column pairs as in xsmm_wgmma.cuh
    const int w = (tid >> 5) & 3;
    const int r0 = m0 + wg * 64 + w * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
      if (col >= n) continue;   // n % 8 == 0: a pair is whole or out
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (row < m)
          *reinterpret_cast<float2*>(wz + (long)row * n + col) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  } else {
    // A: thread t sums half (32 columns) of row t / 2; B: thread t sums the
    // 8 columns of chunk t % 16 over rows 4 (t / 16) .. + 3
    const int ar = tid >> 1, ah = tid & 1;
    const int bc = tid & 15, bk = tid >> 4;
    float sa = 0.f, sb[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) sb[e] = 0.f;
    for (int it = 0; it < slices; ++it) {
      const int s = it % TC_STAGES;
      mbar_wait(&full[s], (it / TC_STAGES) & 1);
      const unsigned char* st = smem + s * TC_STAGE_BYTES;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int chunk = (ah * 4 + c) ^ (ar & 7);
        const uint4 raw = *reinterpret_cast<const uint4*>(st + ar * 128 + chunk * 16);
        const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e) sa += __bfloat162float(e8[e]);
      }
      const unsigned char* sbx = st + TC_A_BYTES + (bc >> 3) * TC_B_BOX;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kr = bk * 4 + r;
        const int chunk = (bc & 7) ^ (kr & 7);
        const uint4 raw = *reinterpret_cast<const uint4*>(sbx + kr * 128 + chunk * 16);
        const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e) sb[e] += __bfloat162float(e8[e]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    float* part = reinterpret_cast<float*>(empty + TC_STAGES);   // 16 x 128
    float* rows = part + 16 * TC_BN;
    float* cols = rows + TC_BM;
    sa += __shfl_xor_sync(0xffffffffu, sa, 1);
    if (ah == 0) rows[ar] = sa;
#pragma unroll
    for (int e = 0; e < 8; ++e) part[bk * TC_BN + bc * 8 + e] = sb[e];
    consumers_sync();
    if (tid < TC_BN) {
      float c = 0.f;
      for (int g = 0; g < 16; ++g) c += part[g * TC_BN + tid];   // fixed order
      cols[tid] = c;
    }
    consumers_sync();
    for (int i = tid; i < TC_BM * TC_BN; i += TC_CONSUMERS) {
      const int r = i / TC_BN, c = i % TC_BN;
      if (m0 + r < m && n0 + c < n)
        wz[(long)(m0 + r) * n + n0 + c] = rows[r] + cols[c];
    }
  }
}

// ---------------------------------------------------------------------------
// 3c. Lane-packed BRGEMM in f32 on TMA-fed tiles, for f32 operands with n %
//     4 == 0 (kernels/gemm.py brgemm_path "tma_fma"; other n keep the FMA
//     kernel of section 3). Replaces the f32 instantiation of
//     build_packed_brgemm (libxsmm_tpu/kernels/gemm_pallas.py:163); SOL =
//     true is its streaming twin (gemm_pallas.py:334).
//
// Bound: at br=1024, m=n=256, k=64 f32 it reads 134 MB (40 us at 3.35
// TB/s) for 8.6 GFLOP: 128 us on the CUDA cores' 67 TFLOP/s, so the
// operations bound it. f32 means f32: no TF32 and no bf16 split, so the
// products run on the FMAs, and the kernel has to keep them fed. It takes
// section 3b's pipeline, not its math: one block per (128 x 128 output
// tile, K split), tiles x splits at or under the SM count; one producer
// warp keeps a ring of TF_STAGES 32-deep slices in flight with TMA (A's 128
// x 32 slice from the 3-D map over (Q*k, m, G), B's 32 x 128 slice as four
// 32 x 32 boxes of the 2-D map over (n, K), f32, 128-byte swizzle, zero
// fill out of bounds); full and empty mbarriers pace the ring. 256 consumer
// threads each keep an 8 x 8 block of f32 accumulators: rows ty + 16 i and
// columns 4 tx + 64 h + (0..3), so that the rows a warp reads fall in
// distinct swizzle phases and its columns in one box. Per four k a thread
// reads one 16-byte A chunk per row (k 4c..4c+3, chunk c at c ^ (r % 8))
// and two 16-byte B chunks per k, 16 shared loads for 256 FMAs. Partials
// go to the f32 workspace and brgemm_reduce_kernel adds them in z order.
//
// The twin keeps grid, split, maps, ring and barriers; its consumers read
// each slice through the swizzle (four 16-byte loads of A and four of B a
// thread) into running row sums of A and column sums of B, then write
// rowsum + colsum of their K range to the workspace.
// ---------------------------------------------------------------------------

constexpr int TF_BM = 128, TF_BN = 128, TF_BK = 32, TF_STAGES = 4;
constexpr int TF_A_BYTES = TF_BM * TF_BK * 4;              // 16 KB
constexpr int TF_B_BOX = TF_BK * 32 * 4;                    // 4 KB, 32 columns
constexpr int TF_STAGE_BYTES = TF_A_BYTES + 4 * TF_B_BOX;   // 32 KB
constexpr int TF_CONSUMERS = 256;
constexpr int TF_THREADS = TF_CONSUMERS + 32;               // + the producer
// the twin's scratch: 8 partial column sums per column, row and column sums
constexpr int TF_SOL_FLOATS = 8 * TF_BN + TF_BM + TF_BN;

constexpr size_t tf_smem_bytes(bool sol) {
  return 1024 + (size_t)TF_STAGES * TF_STAGE_BYTES + 2 * TF_STAGES * 8 +
         (sol ? TF_SOL_FLOATS * sizeof(float) : 0);
}

__device__ __forceinline__ float4 lds128(const unsigned char* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <bool SOL>
__global__ void __launch_bounds__(TF_THREADS, 1)
brgemm_partial_tma_fma_kernel(const __grid_constant__ CUtensorMap amap,
                              const __grid_constant__ CUtensorMap bmap,
                              float* __restrict__ ws, int m, int n, int qk,
                              long K, long kchunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle is a function of the shared address: 1024-byte aligned ring
  unsigned char* smem = smem_raw + ((1024 - (wg_smem(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + TF_STAGES * TF_STAGE_BYTES);
  uint64_t* empty = full + TF_STAGES;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * TF_BN, m0 = blockIdx.y * TF_BM;
  const long kb0 = (long)blockIdx.z * kchunk;
  const long kb1 = kb0 + kchunk < K ? kb0 + kchunk : K;
  const int slices = (int)((kb1 - kb0) / TF_BK);   // whole 32-deep slices

  if (tid == 0) {
    for (int s = 0; s < TF_STAGES; ++s) {
      mbar_init(&full[s], 1);                       // the producer's arrival
      mbar_init(&empty[s], TF_CONSUMERS / 32);      // one per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= TF_CONSUMERS) {   // the producer warp: one thread starts TMA
    if (tid == TF_CONSUMERS) {
      for (int it = 0; it < slices; ++it) {
        const int s = it % TF_STAGES;
        if (it >= TF_STAGES) mbar_wait(&empty[s], ((it / TF_STAGES) - 1) & 1);
        const long kb = kb0 + (long)it * TF_BK;
        const int g = (int)(kb / qk);
        const int kk = (int)(kb - (long)g * qk);
        unsigned char* st = smem + s * TF_STAGE_BYTES;
        mbar_arrive_expect_tx(&full[s], TF_STAGE_BYTES);
        tma_load_3d(st, &amap, &full[s], kk, m0, g);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          tma_load_2d(st + TF_A_BYTES + j * TF_B_BOX, &bmap, &full[s],
                      n0 + 32 * j, (int)kb);
      }
    }
    return;
  }

  const int lane = tid & 31, warp = tid >> 5;
  float* wz = ws + (long)blockIdx.z * m * n;

  if constexpr (!SOL) {
    // warp w: rows ty in 4 (w / 2) .. + 3, columns tx in 8 (w % 2) .. + 7
    const int ty = (warp >> 1) * 4 + (lane >> 3);
    const int tx = (warp & 1) * 8 + (lane & 7);
    const int sw = ty & 7;        // the swizzle phase of every row ty + 16 i
    const int bx = tx & 7;        // B's chunk inside its 32-column box
    const int bbox = (tx >> 3) * TF_B_BOX;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int it = 0; it < slices; ++it) {
      const int s = it % TF_STAGES;
      mbar_wait(&full[s], (it / TF_STAGES) & 1);
      const unsigned char* As = smem + s * TF_STAGE_BYTES + ty * 128;
      const unsigned char* Bs = smem + s * TF_STAGE_BYTES + TF_A_BYTES + bbox;
#pragma unroll
      for (int c = 0; c < TF_BK / 4; ++c) {
        float4 av[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          av[i] = lds128(As + i * 16 * 128 + 16 * (c ^ sw));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kr = 4 * c + j;
          const unsigned char* br = Bs + kr * 128 + 16 * (bx ^ (kr & 7));
          const float4 b0 = lds128(br), b1 = lds128(br + 2 * TF_B_BOX);
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float a_ = j == 0 ? av[i].x : j == 1 ? av[i].y
                             : j == 2 ? av[i].z : av[i].w;
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[i][q] = fmaf(a_, bv[q], acc[i][q]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // the partial tile: n % 4 == 0, so a four-column chunk is whole or out
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = m0 + ty + 16 * i;
      if (row >= m) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + 64 * h + 4 * tx;
        if (col < n)
          *reinterpret_cast<float4*>(wz + (long)row * n + col) = make_float4(
              acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
              acc[i][4 * h + 3]);
      }
    }
  } else {
    // A: thread t sums half (16 k) of row t / 2, chunks 4 (t % 2) .. + 3;
    // B: thread t sums the four columns of chunk t % 32 (box t % 32 / 8)
    // over k rows 4 (t / 32) .. + 3
    const int ar = tid >> 1, ah = tid & 1;
    const int bc = tid & 31, bk = tid >> 5;
    float sa = 0.f, sb[4] = {0.f, 0.f, 0.f, 0.f};
    for (int it = 0; it < slices; ++it) {
      const int s = it % TF_STAGES;
      mbar_wait(&full[s], (it / TF_STAGES) & 1);
      const unsigned char* st = smem + s * TF_STAGE_BYTES;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 v = lds128(st + ar * 128 + 16 * ((ah * 4 + c) ^ (ar & 7)));
        sa += v.x + v.y + v.z + v.w;
      }
      const unsigned char* sbx = st + TF_A_BYTES + (bc >> 3) * TF_B_BOX;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kr = bk * 4 + r;
        const float4 v = lds128(sbx + kr * 128 + 16 * ((bc & 7) ^ (kr & 7)));
        sb[0] += v.x; sb[1] += v.y; sb[2] += v.z; sb[3] += v.w;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    float* part = reinterpret_cast<float*>(empty + TF_STAGES);   // 8 x 128
    float* rows = part + 8 * TF_BN;
    float* cols = rows + TF_BM;
    sa += __shfl_xor_sync(0xffffffffu, sa, 1);
    if (ah == 0) rows[ar] = sa;
#pragma unroll
    for (int e = 0; e < 4; ++e) part[bk * TF_BN + bc * 4 + e] = sb[e];
    consumers_sync();
    if (tid < TF_BN) {
      float c = 0.f;
      for (int g = 0; g < 8; ++g) c += part[g * TF_BN + tid];   // fixed order
      cols[tid] = c;
    }
    consumers_sync();
    for (int i = tid; i < TF_BM * TF_BN; i += TF_CONSUMERS) {
      const int r = i / TF_BN, c = i % TF_BN;
      if (m0 + r < m && n0 + c < n)
        wz[(long)(m0 + r) * n + n0 + c] = rows[r] + cols[c];
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime
// (cudaGetDriverEntryPoint), so that the library needs no link to libcuda
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

// a bf16 or f32 tensor map with 128-byte swizzle and zero fill out of bounds
static bool encode_map(CUtensorMap* map, CUtensorMapDataType type,
                       const void* base, int rank, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, type, rank, const_cast<void*>(base), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a (G, m, qk) bf16 packed, b (G*qk, n) bf16, both 16-byte aligned; n % 8
// == 0, qk and kchunk multiples of 64. A refused map or launch returns its
// error; the wrapper raises.
template <typename TOut, bool SOL = false>
static cudaError_t launch_packed_brgemm_wgmma(const void* a, const void* b,
                                              void* ws, const void* c0,
                                              const void* d, void* out, int G,
                                              int m, int n, int qk,
                                              long kchunk, int splits,
                                              int epi, cudaStream_t s) {
  if (n % 8 || qk % TC_BK || kchunk % TC_BK || kchunk <= 0 ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16)
    return cudaErrorInvalidValue;
  const long K = (long)G * qk;
  CUtensorMap amap, bmap;
  const cuuint64_t adims[3] = {(cuuint64_t)qk, (cuuint64_t)m, (cuuint64_t)G};
  const cuuint64_t astrides[2] = {(cuuint64_t)qk * 2, (cuuint64_t)m * qk * 2};
  const cuuint32_t abox[3] = {TC_BK, TC_BM, 1};
  const cuuint64_t bdims[2] = {(cuuint64_t)n, (cuuint64_t)K};
  const cuuint64_t bstrides[1] = {(cuuint64_t)n * 2};
  const cuuint32_t bbox[2] = {64, TC_BK};
  if (!encode_map(&amap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, 3, adims,
                  astrides, abox) ||
      !encode_map(&bmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, b, 2, bdims,
                  bstrides, bbox))
    return cudaErrorInvalidValue;
  const size_t smem = tc_smem_bytes(SOL);
  auto kern = brgemm_partial_wgmma_kernel<SOL>;
  cudaError_t e = ensure_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + TC_BN - 1) / TC_BN, (m + TC_BM - 1) / TC_BM, splits);
  kern<<<grid, TC_THREADS, smem, s>>>(amap, bmap, static_cast<float*>(ws), m,
                                      n, qk, K, kchunk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_brgemm_reduce<TOut>(ws, c0, d, out, (long)m * n, splits, epi,
                                    s);
}

// a (G, m, qk) f32 packed, b (G*qk, n) f32, both 16-byte aligned; n % 4 ==
// 0, qk and kchunk multiples of 32. A refused map or launch returns its
// error; the wrapper raises.
template <bool SOL = false>
static cudaError_t launch_packed_brgemm_tma_fma(const void* a, const void* b,
                                                void* ws, int G, int m, int n,
                                                int qk, long kchunk,
                                                int splits, cudaStream_t s) {
  if (n % 4 || qk % TF_BK || kchunk % TF_BK || kchunk <= 0 ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16)
    return cudaErrorInvalidValue;
  const long K = (long)G * qk;
  CUtensorMap amap, bmap;
  const cuuint64_t adims[3] = {(cuuint64_t)qk, (cuuint64_t)m, (cuuint64_t)G};
  const cuuint64_t astrides[2] = {(cuuint64_t)qk * 4, (cuuint64_t)m * qk * 4};
  const cuuint32_t abox[3] = {TF_BK, TF_BM, 1};
  const cuuint64_t bdims[2] = {(cuuint64_t)n, (cuuint64_t)K};
  const cuuint64_t bstrides[1] = {(cuuint64_t)n * 4};
  const cuuint32_t bbox[2] = {32, TF_BK};
  if (!encode_map(&amap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a, 3, adims,
                  astrides, abox) ||
      !encode_map(&bmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, b, 2, bdims,
                  bstrides, bbox))
    return cudaErrorInvalidValue;
  const size_t smem = tf_smem_bytes(SOL);
  auto kern = brgemm_partial_tma_fma_kernel<SOL>;
  const cudaError_t e = ensure_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + TF_BN - 1) / TF_BN, (m + TF_BM - 1) / TF_BM, splits);
  kern<<<grid, TF_THREADS, smem, s>>>(amap, bmap, static_cast<float*>(ws), m,
                                      n, qk, K, kchunk);
  return cudaGetLastError();
}

template <typename TIn, typename TOut, bool SOL = false>
static cudaError_t launch_packed_brgemm(const void* a, const void* b,
                                        void* ws, const void* c0,
                                        const void* d, void* out, int G,
                                        int m, int n, int qk, long kchunk,
                                        int splits, int epi, cudaStream_t s) {
  const long K = (long)G * qk;
  const dim3 grid((n + BR_BN - 1) / BR_BN, (m + BR_BM - 1) / BR_BM, splits);
  brgemm_partial_kernel<TIn, SOL><<<grid, 256, 0, s>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(b),
      static_cast<float*>(ws), m, n, qk, K, kchunk);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_brgemm_reduce<TOut>(ws, c0, d, out, (long)m * n, splits, epi,
                                    s);
}

// ---------------------------------------------------------------------------
// 4. Passthrough twin of the lane-packed batched SMM. Replaces the Pallas
//    passthrough of bench.py:438-448 (`make`, kernel `pkern`), the
//    denominator of the headline fraction (bench.py:869).
//
// out = a + b over (G, m, 128) f32, bit for bit as torch's a + b. It keeps
// packed_smm_kernel's grid (one block of 256 threads per (group, 2*RPT-row
// tile)) and its 16-byte coalesced loads, and computes nothing, so it moves
// the headline kernel's bytes (3 * G * m * 128 * 4; 201 MB at 4096 x 32 x
// 128, 60 us at 3.35 TB/s) with the headline kernel's access pattern. The
// TPU twin's block-group count S has no counterpart: one block always takes
// one group.
// ---------------------------------------------------------------------------

template <int RPT>
__global__ void __launch_bounds__(256)
packed_smm_passthrough_kernel(const float* __restrict__ a,
                              const float* __restrict__ b,
                              float* __restrict__ out, int m) {
  constexpr int W = 128;        // packed row width, as packed_smm_kernel
  constexpr int MT = 2 * RPT;   // rows per block
  const long g = blockIdx.x;
  const int row0 = blockIdx.y * MT;
  const int rows = min(MT, m - row0);
  const long base = (g * m + row0) * (long)W / 4;
  const float4* a4 = reinterpret_cast<const float4*>(a) + base;
  const float4* b4 = reinterpret_cast<const float4*>(b) + base;
  float4* o4 = reinterpret_cast<float4*>(out) + base;
  for (int i = threadIdx.x; i < rows * W / 4; i += 256) {
    const float4 x = a4[i], y = b4[i];
    o4[i] = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
  }
}

template <int RPT>
static cudaError_t launch_passthrough(const void* a, const void* b,
                                      void* out, int G, int m,
                                      cudaStream_t s) {
  constexpr int MT = 2 * RPT;
  const dim3 grid(G, (m + MT - 1) / MT);
  packed_smm_passthrough_kernel<RPT><<<grid, 256, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), m);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// C interface (ctypes). Type codes: 0 f32, 1 bf16, 2 i8, 3 i32. A
// combination without an instantiation returns cudaErrorInvalidValue.
// ---------------------------------------------------------------------------

extern "C" {

const char* xsmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int xsmm_packed_smm(const void* a, const void* b, const void* c, void* out,
                    int G, int m, int k, int in_t, int out_t, int epi,
                    int rpt, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_t == T_F32 && out_t == T_F32)
    return packed_smm_rpt<float, float, float>(rpt, a, b, c, out, G, m, k, epi, s);
  if (in_t == T_F32 && out_t == T_BF16)
    return packed_smm_rpt<float, float, __nv_bfloat16>(rpt, a, b, c, out, G, m, k, epi, s);
  if (in_t == T_BF16 && out_t == T_F32)
    return packed_smm_rpt<__nv_bfloat16, float, float>(rpt, a, b, c, out, G, m, k, epi, s);
  if (in_t == T_BF16 && out_t == T_BF16)
    return packed_smm_rpt<__nv_bfloat16, float, __nv_bfloat16>(rpt, a, b, c, out, G, m, k, epi, s);
  if (in_t == T_I8 && out_t == T_I32)
    return packed_smm_rpt<int8_t, int, int>(rpt, a, b, c, out, G, m, k, epi, s);
  return cudaErrorInvalidValue;
}

// route (0 bulk, 1 cp.async), mt rows per stage, stages and grid from the
// wrapper's plan (kernels/gemm.py batched_plan)
int xsmm_batched_gemm(const void* a, const void* b, const void* c, void* out,
                      int B, int m, int n, int k, int in_t, int out_t,
                      int route, int mt, int stages, int grid, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_t == T_F32 && out_t == T_F32)
    return launch_batched_gemm<float, float>(a, b, c, out, B, m, n, k, route, mt, stages, grid, s);
  if (in_t == T_F32 && out_t == T_BF16)
    return launch_batched_gemm<float, __nv_bfloat16>(a, b, c, out, B, m, n, k, route, mt, stages, grid, s);
  if (in_t == T_BF16 && out_t == T_F32)
    return launch_batched_gemm<__nv_bfloat16, float>(a, b, c, out, B, m, n, k, route, mt, stages, grid, s);
  if (in_t == T_BF16 && out_t == T_BF16)
    return launch_batched_gemm<__nv_bfloat16, __nv_bfloat16>(a, b, c, out, B, m, n, k, route, mt, stages, grid, s);
  return cudaErrorInvalidValue;
}

int xsmm_packed_brgemm(const void* a, const void* b, void* ws, const void* c0,
                       const void* d, void* out, int G, int m, int n, int qk,
                       long long kchunk, int splits, int in_t, int out_t,
                       int epi, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_t == T_F32 && out_t == T_F32)
    return launch_packed_brgemm<float, float>(a, b, ws, c0, d, out, G, m, n, qk, kchunk, splits, epi, s);
  if (in_t == T_F32 && out_t == T_BF16)
    return launch_packed_brgemm<float, __nv_bfloat16>(a, b, ws, c0, d, out, G, m, n, qk, kchunk, splits, epi, s);
  if (in_t == T_BF16 && out_t == T_F32)
    return launch_packed_brgemm<__nv_bfloat16, float>(a, b, ws, c0, d, out, G, m, n, qk, kchunk, splits, epi, s);
  if (in_t == T_BF16 && out_t == T_BF16)
    return launch_packed_brgemm<__nv_bfloat16, __nv_bfloat16>(a, b, ws, c0, d, out, G, m, n, qk, kchunk, splits, epi, s);
  return cudaErrorInvalidValue;
}

// the BRGEMM's streaming twin: f32 out, no C0, D or epilogue
int xsmm_packed_brgemm_sol(const void* a, const void* b, void* ws, void* out,
                           int G, int m, int n, int qk, long long kchunk,
                           int splits, int in_t, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_t == T_F32)
    return launch_packed_brgemm<float, float, true>(a, b, ws, nullptr, nullptr, out, G, m, n, qk, kchunk, splits, EPI_NONE, s);
  if (in_t == T_BF16)
    return launch_packed_brgemm<__nv_bfloat16, float, true>(a, b, ws, nullptr, nullptr, out, G, m, n, qk, kchunk, splits, EPI_NONE, s);
  return cudaErrorInvalidValue;
}

// the tensor-core route (kernels/gemm.py brgemm_path): arguments as
// xsmm_packed_brgemm's, bf16 a and b only, n % 8 == 0; out f32 or bf16
int xsmm_packed_brgemm_wgmma(const void* a, const void* b, void* ws,
                             const void* c0, const void* d, void* out, int G,
                             int m, int n, int qk, long long kchunk,
                             int splits, int in_t, int out_t, int epi,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_t == T_BF16 && out_t == T_F32)
    return launch_packed_brgemm_wgmma<float>(a, b, ws, c0, d, out, G, m, n, qk, kchunk, splits, epi, s);
  if (in_t == T_BF16 && out_t == T_BF16)
    return launch_packed_brgemm_wgmma<__nv_bfloat16>(a, b, ws, c0, d, out, G, m, n, qk, kchunk, splits, epi, s);
  return cudaErrorInvalidValue;
}

// the twin on the tensor-core route: arguments as xsmm_packed_brgemm_sol's,
// bf16 a and b only, n % 8 == 0; f32 out
int xsmm_packed_brgemm_sol_wgmma(const void* a, const void* b, void* ws,
                                 void* out, int G, int m, int n, int qk,
                                 long long kchunk, int splits, int in_t,
                                 void* stream) {
  if (in_t != T_BF16) return cudaErrorInvalidValue;
  return launch_packed_brgemm_wgmma<float, true>(
      a, b, ws, nullptr, nullptr, out, G, m, n, qk, kchunk, splits, EPI_NONE,
      static_cast<cudaStream_t>(stream));
}

// the f32 route on TMA-fed FMA tiles (kernels/gemm.py brgemm_path
// "tma_fma"): arguments as xsmm_packed_brgemm's, f32 a and b only, n % 4 ==
// 0; out f32 or bf16
int xsmm_packed_brgemm_tma_fma(const void* a, const void* b, void* ws,
                               const void* c0, const void* d, void* out,
                               int G, int m, int n, int qk,
                               long long kchunk, int splits, int in_t,
                               int out_t, int epi, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_t != T_F32 || (out_t != T_F32 && out_t != T_BF16))
    return cudaErrorInvalidValue;
  const cudaError_t e =
      launch_packed_brgemm_tma_fma(a, b, ws, G, m, n, qk, kchunk, splits, s);
  if (e != cudaSuccess) return e;
  const long mn = (long)m * n;
  return out_t == T_F32
             ? launch_brgemm_reduce<float>(ws, c0, d, out, mn, splits, epi, s)
             : launch_brgemm_reduce<__nv_bfloat16>(ws, c0, d, out, mn, splits,
                                                   epi, s);
}

// the twin on that route: arguments as xsmm_packed_brgemm_sol's, f32 a and
// b only, n % 4 == 0; f32 out
int xsmm_packed_brgemm_sol_tma_fma(const void* a, const void* b, void* ws,
                                   void* out, int G, int m, int n, int qk,
                                   long long kchunk, int splits, int in_t,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_t != T_F32) return cudaErrorInvalidValue;
  const cudaError_t e = launch_packed_brgemm_tma_fma<true>(
      a, b, ws, G, m, n, qk, kchunk, splits, s);
  if (e != cudaSuccess) return e;
  return launch_brgemm_reduce<float>(ws, nullptr, nullptr, out, (long)m * n,
                                     splits, EPI_NONE, s);
}

// a, b, out (G, m, 128) f32, 16-byte aligned; rpt as xsmm_packed_smm's
int xsmm_packed_smm_passthrough(const void* a, const void* b, void* out,
                                int G, int m, int rpt, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rpt) {
    case 4: return launch_passthrough<4>(a, b, out, G, m, s);
    case 8: return launch_passthrough<8>(a, b, out, G, m, s);
    case 16: return launch_passthrough<16>(a, b, out, G, m, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
