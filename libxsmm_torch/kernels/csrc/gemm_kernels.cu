// Hand-written Hopper (sm_90a) kernels for libxsmm_torch's dense small-GEMM
// main path: the lane-packed batched SMM, the unpacked batched SMM and the
// lane-packed batch-reduce GEMM (BRGEMM). They replace the three Pallas TPU
// kernels of libxsmm_tpu/kernels/gemm_pallas.py.
//
// Plain C interface, no torch headers: kernels/_build.py compiles this file
// with nvcc into a shared library and kernels/gemm.py calls it through
// ctypes. Every entry point launches on the caller's stream, allocates
// nothing (the wrapper passes outputs and scratch from torch.empty), does
// not synchronise, and returns cudaGetLastError() so the wrapper raises on a
// refused launch.
//
// Arithmetic: f32 operands multiply and add in f32 on the CUDA cores (no
// TF32); bf16 operands are widened to f32 on load and accumulate in f32;
// int8 operands accumulate in int32. Sums run in a fixed order, so a result
// does not change from run to run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
// n, k <= 128, f32/bf16 in and out.
//
// Bound: device memory for the small shapes it takes (32^3 f32 is 5.3
// FLOP/byte). Design: one block per (problem, mt-row tile); the tile of A
// (padded to an odd row stride, so rows that share a warp fall in distinct
// banks) and all of B_i are staged in shared memory as f32; thread
// (col, row group) keeps eight accumulators of column `col` in registers.
// Rows past the tile are clamped, not branched on, and never stored.
// ---------------------------------------------------------------------------

template <typename TIn, typename TOut>
__global__ void batched_gemm_kernel(const TIn* __restrict__ a,
                                    const TIn* __restrict__ b,
                                    const float* __restrict__ c,
                                    TOut* __restrict__ out,
                                    int m, int n, int k, int mt) {
  constexpr int R = 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ka = k + 1;
  float* As = reinterpret_cast<float*>(smem_raw);   // mt x ka
  float* Bs = As + mt * ka;                          // k x n

  const long p = blockIdx.x;
  const int row0 = blockIdx.y * mt;
  const int rows = min(mt, m - row0);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const TIn* ap = a + (p * m + row0) * (long)k;
  const TIn* bp = b + p * (long)k * n;
  for (int i = tid; i < rows * k; i += nthr) As[(i / k) * ka + i % k] = load_cvt(ap[i]);
  for (int i = tid; i < k * n; i += nthr) Bs[i] = load_cvt(bp[i]);
  __syncthreads();

  const int groups = nthr / n;   // n <= 128 <= blockDim.x
  const int col = tid % n, rg = tid / n;
  if (rg >= groups) return;
  for (int rb = rg; rb < rows; rb += R * groups) {
    float acc[R];
    int rr[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      acc[j] = 0.f;
      rr[j] = min(rb + j * groups, rows - 1) * ka;
    }
    for (int l = 0; l < k; ++l) {
      const float bv = Bs[l * n + col];
#pragma unroll
      for (int j = 0; j < R; ++j) acc[j] += As[rr[j] + l] * bv;
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int row = rb + j * groups;
      if (row < rows) {
        const long o = (p * m + row0 + row) * (long)n + col;
        float v = acc[j];
        if (c != nullptr) v += c[o];
        store_cvt(v, out + o);
      }
    }
  }
}

template <typename TIn, typename TOut>
static cudaError_t launch_batched_gemm(const void* a, const void* b,
                                       const void* c, void* out, int B,
                                       int m, int n, int k, int mt,
                                       int threads, cudaStream_t s) {
  const size_t smem = ((size_t)mt * (k + 1) + (size_t)k * n) * sizeof(float);
  auto kern = batched_gemm_kernel<TIn, TOut>;
  const cudaError_t e = ensure_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B, (m + mt - 1) / mt);
  kern<<<grid, threads, smem, s>>>(static_cast<const TIn*>(a),
                                   static_cast<const TIn*>(b),
                                   static_cast<const float*>(c),
                                   static_cast<TOut*>(out), m, n, k, mt);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 3. Lane-packed BRGEMM. Replaces build_packed_brgemm
//    (libxsmm_tpu/kernels/gemm_pallas.py:163).
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
// ---------------------------------------------------------------------------

constexpr int BR_BM = 64, BR_BN = 64, BR_BK = 16;

template <typename TIn>
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
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

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
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += ar[i] * bc[j];
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
      if (col < n) wz[(long)row * n + col] = acc[i][j];
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

template <typename TIn, typename TOut>
static cudaError_t launch_packed_brgemm(const void* a, const void* b,
                                        void* ws, const void* c0,
                                        const void* d, void* out, int G,
                                        int m, int n, int qk, long kchunk,
                                        int splits, int epi, cudaStream_t s) {
  const long K = (long)G * qk;
  const dim3 grid((n + BR_BN - 1) / BR_BN, (m + BR_BM - 1) / BR_BM, splits);
  brgemm_partial_kernel<TIn><<<grid, 256, 0, s>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(b),
      static_cast<float*>(ws), m, n, qk, K, kchunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long mn = (long)m * n;
  brgemm_reduce_kernel<TOut><<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<const float*>(c0),
      static_cast<const float*>(d), static_cast<TOut*>(out), mn, splits, epi);
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

int xsmm_batched_gemm(const void* a, const void* b, const void* c, void* out,
                      int B, int m, int n, int k, int in_t, int out_t,
                      int mt, int threads, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_t == T_F32 && out_t == T_F32)
    return launch_batched_gemm<float, float>(a, b, c, out, B, m, n, k, mt, threads, s);
  if (in_t == T_F32 && out_t == T_BF16)
    return launch_batched_gemm<float, __nv_bfloat16>(a, b, c, out, B, m, n, k, mt, threads, s);
  if (in_t == T_BF16 && out_t == T_F32)
    return launch_batched_gemm<__nv_bfloat16, float>(a, b, c, out, B, m, n, k, mt, threads, s);
  if (in_t == T_BF16 && out_t == T_BF16)
    return launch_batched_gemm<__nv_bfloat16, __nv_bfloat16>(a, b, c, out, B, m, n, k, mt, threads, s);
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

}  // extern "C"
