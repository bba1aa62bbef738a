// Hand-written Hopper (sm_90a) kernels of libxsmm_torch's BCSC lab (the
// port's scripts/bcsc_lab.py): probes of the k-union SpMM kernel
// (spmm_kernels.cu bcsc_union_kernel), each keeping one property of a
// candidate schedule so the lab can time it against the union kernel. They
// replace the Pallas probes of scripts/bcsc_lab.py make_variants (:67):
//   xsmm_bcsc_lab_minimal  `minimal` (:100): the dot floor over a constant,
//                          already compacted RHS; no gather, no slot skip
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
// never loaded). Every product and sum is an f32 FMA, as in the union
// kernel; each block writes its output tile once.
//
// Bound, at the lab's shape (m = k = n = 1024, density 0.2: U = 21 union
// slots of 32 rows, 199 blocks): the union's 2 * m * U * 32 * n = 1.41
// GFLOP at the bf16 tensor cores' peak (1.4 us) against 4.6 MB moved (1.4
// us); on the f32 FMAs these probes use, the operations bound them (21 us
// at 67 TFLOP/s).
//
// Shared memory. The TPU stages the whole union of A (all m rows) and of
// the RHS in VMEM, dspipe twice; here one union's RHS alone (672 x 128 bf16,
// 172 KB at U = 21) nearly fills the 227 KB a block may have. So the fused
// probes stage bf16 (16-byte cp.async, zeros for the zero block and rows
// past m) at a smaller grain:
//   chunkN  a 32-row x 64-column tile (half a group): per chunk of
//           ceil(U/N) slots, 6.5 KB a slot, two buffers when N > 1
//           (chunk1 at U = 21: 137 KB; chunk2: 2 x 72 KB; chunk4: 2 x 39 KB);
//   dspipe  a 32-row x 32-column tile (one block column of a group), both
//           buffers holding a whole union, 4.5 KB a slot each (189 KB at
//           U = 21); past 25 slots the tile drops to 16 rows (3.5 KB).
// A staging that does not fit returns cudaErrorInvalidValue. minimal keeps
// the union kernel's own tile (64 x 128, 32-deep f32 slices, synchronous).
// The fused probes take A and the values 16-byte aligned (the wrappers copy
// an operand that is not).

#include <cuda_runtime.h>

#include "xsmm_common.cuh"

namespace {

constexpr int BK = 32;   // block rows (the lab's bk)
constexpr int BN = 32;   // block columns (the lab's bn)
constexpr int GW = 128;  // output columns per union group
constexpr int W = GW / BN;
constexpr int SMEM_MAX = 232448;  // bytes of shared memory a block may use

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// minimal: out[:, 128 g : 128 g + 128] = A[:, :32 U] @ rhs[g], rhs (n/128,
// 32 U, 128). Block (g, y) owns rows [64 y, 64 y + 64) of group g and walks
// all U slots: the union kernel's loop with contiguous A columns and RHS
// rows in place of the gather.
// ---------------------------------------------------------------------------

constexpr int MTM = 64;

__global__ void __launch_bounds__(256) bcsc_lab_minimal_kernel(
    const bf16* __restrict__ a, const bf16* __restrict__ rhs,
    float* __restrict__ out, int m, int k, int n, int U) {
  __shared__ float As[MTM][BK + 1];
  __shared__ __align__(16) float Rs[BK][GW];
  const int g = blockIdx.x;
  const int row0 = blockIdx.y * MTM;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const bf16* rg = rhs + (long long)g * U * BK * GW;
  for (int u = 0; u < U; ++u) {
    for (int i = tid; i < MTM * BK; i += 256) {
      const int r = i / BK, kk = i % BK, gr = row0 + r;
      As[r][kk] = gr < m ? to_f32(a[(long long)gr * k + u * BK + kk]) : 0.0f;
    }
    const bf16* ru = rg + (long long)u * BK * GW;
    for (int i = tid; i < BK * GW; i += 256) Rs[i / GW][i % GW] = to_f32(ru[i]);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
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
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = g * GW + (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gr = row0 + ty * 4 + i;
      if (gr < m) out[(long long)gr * n + c] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// staging helpers of the fused probes
// ---------------------------------------------------------------------------

// one 16-byte unit from global to shared memory (cp.async, which does not
// block the thread); a unit that is not valid is written as zeros (cp.async
// with no source bytes)
__device__ __forceinline__ void stage_unit(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void stage_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void stage_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Stage union slots [u0, u1) of group g for the tile at (row0, column c0 of
// the group), CW columns wide: A's rows at the slots' block rows into sA
// (TM x (u1-u0)*32, row stride AS) and the slots' right-hand side into sR
// ((u1-u0)*32 x CW, row stride RS), every 64-byte block row in four 16-byte
// units. Slots past the range cost nothing: an empty range issues nothing.
template <int TM, int CW, int NT>
__device__ __forceinline__ void stage_slots(
    bf16* sA, int AS, bf16* sR, int RS, const bf16* __restrict__ a,
    const bf16* __restrict__ vals, const int* __restrict__ krows,
    const int* __restrict__ gmap, int g, int U, int u0, int u1, int row0,
    int c0, int m, int k, int nzero) {
  constexpr int upr = 4;         // units per 64-byte block row
  constexpr int ue = 8;          // elements per unit
  const int cu = u1 - u0;
  const long long slot0 = (long long)g * U + u0;
  const int na = TM * cu * upr;
  for (int i = threadIdx.x; i < na; i += NT) {
    const int e = i % upr, t = i / upr, s = t % cu, r = t / cu;
    const bool ok = row0 + r < m;
    const bf16* src = a + (long long)(row0 + r) * k + krows[slot0 + s] * BK
                      + e * ue;
    stage_unit(sA + r * AS + s * BK + e * ue, ok ? src : a, ok);
  }
  constexpr int NB = CW / BN;    // value blocks across the tile
  const int nr = cu * BK * NB * upr;
  for (int i = threadIdx.x; i < nr; i += NT) {
    int t = i / upr;
    const int e = i % upr, w = t % NB;
    t /= NB;
    const int rr = t % BK, s = t / BK;
    const int v = gmap[(slot0 + s) * W + c0 / BN + w];
    const bool ok = v != nzero;
    const bf16* src = vals + ((long long)v * BK + rr) * BN + e * ue;
    stage_unit(sR + (s * BK + rr) * RS + w * BN + e * ue, ok ? src : vals,
               ok);
  }
}

// acc += sA[thread's RM rows, :depth] @ sR[:depth, thread's 4 columns]:
// thread (tx, ty) owns rows ty*RM .. +RM-1 and columns tx*4 .. +3, and reads
// two k steps of A per 4-byte load and four columns of B per 8-byte load
template <int RM>
__device__ __forceinline__ void fma_slots(float (&acc)[RM][4], const bf16* sA,
                                          int AS, const bf16* sR, int RS,
                                          int depth, int tx, int ty) {
  for (int kk = 0; kk < depth; kk += 2) {
    float2 av[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      av[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          sA + (ty * RM + i) * AS + kk));
    float b0[4], b1[4];
    const __nv_bfloat162* r0 =
        reinterpret_cast<const __nv_bfloat162*>(sR + kk * RS + tx * 4);
    const __nv_bfloat162* r1 =
        reinterpret_cast<const __nv_bfloat162*>(sR + (kk + 1) * RS + tx * 4);
    const float2 x0 = __bfloat1622float2(r0[0]), x1 = __bfloat1622float2(r0[1]);
    const float2 y0 = __bfloat1622float2(r1[0]), y1 = __bfloat1622float2(r1[1]);
    b0[0] = x0.x; b0[1] = x0.y; b0[2] = x1.x; b0[3] = x1.y;
    b1[0] = y0.x; b1[1] = y0.y; b1[2] = y1.x; b1[3] = y1.y;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(av[i].x, b0[j], acc[i][j]);
        acc[i][j] = fmaf(av[i].y, b1[j], acc[i][j]);
      }
  }
}

template <int RM>
__device__ __forceinline__ void store_tile(const float (&acc)[RM][4],
                                           float* __restrict__ out, int row0,
                                           int col0, int m, int n, int tx,
                                           int ty) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gr = row0 + ty * RM + i;
    if (gr < m)
      *reinterpret_cast<float4*>(out + (long long)gr * n + col0 + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// elements of one staging buffer, `slots` deep: TM rows of A, and the RHS
// CW columns wide (rows padded by 8 elements: 16 bytes, off the banks of
// the row above)
template <int TM>
__host__ __device__ constexpr int stage_elems_a(int slots) {
  return TM * (slots * BK + 8);
}
template <int CW>
__host__ __device__ constexpr int stage_elems_r(int slots) {
  return slots * BK * (CW + 8);
}

// ---------------------------------------------------------------------------
// chunkN: block (2 g + h, y) owns rows [32 y, 32 y + 32) and columns
// [64 h, 64 h + 64) of group g. The U slots are cut into N chunks of
// ceil(U/N); chunk c + 1 is staged (cp.async) into the other buffer before
// the math of chunk c. One code path: the buffer is an offset of the chunk's
// parity, the last chunk's "next" stage is an empty range, and every
// iteration commits a group and waits for all but the newest.
// ---------------------------------------------------------------------------

constexpr int CTM = 32, CCW = 64, CNT = 256;

template <int N>
__global__ void __launch_bounds__(CNT) bcsc_lab_chunk_kernel(
    const bf16* __restrict__ a, const bf16* __restrict__ vals,
    const int* __restrict__ krows, const int* __restrict__ gmap,
    float* __restrict__ out, int m, int k, int n, int U, int nzero) {
  constexpr int TX = CCW / 4, RM = CTM / (CNT / TX);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* base = reinterpret_cast<bf16*>(smem_raw);
  const int csl = (U + N - 1) / N;
  const int AS = csl * BK + 8, RS = CCW + 8;
  const int abuf = stage_elems_a<CTM>(csl);
  const int buf = abuf + stage_elems_r<CCW>(csl);
  const int g = blockIdx.x / (GW / CCW);
  const int c0 = (blockIdx.x % (GW / CCW)) * CCW;
  const int row0 = blockIdx.y * CTM;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  stage_slots<CTM, CCW, CNT>(base, AS, base + abuf, RS, a, vals, krows, gmap,
                             g, U, 0, min(U, csl), row0, c0, m, k, nzero);
  stage_commit();
  for (int c = 0; c < N; ++c) {
    bf16* nb = base + ((c + 1) & 1) * buf;
    stage_slots<CTM, CCW, CNT>(nb, AS, nb + abuf, RS, a, vals, krows, gmap, g,
                               U, min(U, (c + 1) * csl),
                               min(U, (c + 2) * csl), row0, c0, m, k, nzero);
    stage_commit();
    stage_wait_all_but_one();
    __syncthreads();
    const bf16* cb = base + (c & 1) * buf;
    const int depth = (min(U, (c + 1) * csl) - min(U, c * csl)) * BK;
    fma_slots<RM>(acc, cb, AS, cb + abuf, RS, depth, tx, ty);
    __syncthreads();
  }
  store_tile<RM>(acc, out, row0, g * GW + c0, m, n, tx, ty);
}

// ---------------------------------------------------------------------------
// dspipe: block (h, y) owns rows [TM y, TM y + TM) and columns [32 h,
// 32 h + 32) of every group, and walks the groups in order: the whole union
// of group g + 1 is staged into the other buffer before the math of group
// g, the double buffering the TPU's sequential grid does across grid steps
// (Hopper blocks run in no order, so the loop over groups lives inside the
// block). One code path, as chunkN's.
// ---------------------------------------------------------------------------

constexpr int DCW = 32;

template <int TM, int NT>
__global__ void __launch_bounds__(NT) bcsc_lab_dspipe_kernel(
    const bf16* __restrict__ a, const bf16* __restrict__ vals,
    const int* __restrict__ krows, const int* __restrict__ gmap,
    float* __restrict__ out, int m, int k, int n, int U, int nzero) {
  constexpr int TX = DCW / 4, RM = TM / (NT / TX);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* base = reinterpret_cast<bf16*>(smem_raw);
  const int nsg = n / GW;
  const int AS = U * BK + 8, RS = DCW + 8;
  const int abuf = stage_elems_a<TM>(U);
  const int buf = abuf + stage_elems_r<DCW>(U);
  const int c0 = blockIdx.x * DCW;
  const int row0 = blockIdx.y * TM;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;

  stage_slots<TM, DCW, NT>(base, AS, base + abuf, RS, a, vals, krows, gmap,
                           0, U, 0, U, row0, c0, m, k, nzero);
  stage_commit();
  for (int g = 0; g < nsg; ++g) {
    bf16* nb = base + ((g + 1) & 1) * buf;
    const int gn = min(g + 1, nsg - 1);
    stage_slots<TM, DCW, NT>(nb, AS, nb + abuf, RS, a, vals, krows, gmap, gn,
                             U, 0, g + 1 < nsg ? U : 0, row0, c0, m, k,
                             nzero);
    stage_commit();
    stage_wait_all_but_one();
    __syncthreads();
    float acc[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    const bf16* cb = base + (g & 1) * buf;
    fma_slots<RM>(acc, cb, AS, cb + abuf, RS, U * BK, tx, ty);
    store_tile<RM>(acc, out, row0, g * GW + c0, m, n, tx, ty);
    __syncthreads();
  }
}

template <typename K>
cudaError_t set_smem(K kern, size_t bytes) {
  if (bytes > SMEM_MAX) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool bad_shape(int m, int k, int n, int U) {
  return m < 0 || k <= 0 || n <= 0 || U <= 0 || k % BK || n % GW ||
         (m + 15) / 16 > 65535;
}

bool misaligned(const void* a, const void* vals, const void* out) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(vals) |
           reinterpret_cast<uintptr_t>(out)) & 15) != 0;
}

template <int N>
int launch_chunk(const bf16* a, const bf16* vals, const int* krows,
                 const int* gmap, float* out, int m, int k, int n, int U,
                 int nzero, cudaStream_t st) {
  const int csl = (U + N - 1) / N;
  const size_t smem = (N > 1 ? 2 : 1) * sizeof(bf16) *
      (size_t)(stage_elems_a<CTM>(csl) + stage_elems_r<CCW>(csl));
  auto kern = bcsc_lab_chunk_kernel<N>;
  const cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n / GW) * (GW / CCW), (m + CTM - 1) / CTM);
  kern<<<grid, CNT, smem, st>>>(a, vals, krows, gmap, out, m, k, n, U, nzero);
  return cudaGetLastError();
}

template <int TM>
size_t dspipe_smem(int U) {
  return 2 * sizeof(bf16) *
         (size_t)(stage_elems_a<TM>(U) + stage_elems_r<DCW>(U));
}

template <int TM, int NT>
int launch_dspipe(const bf16* a, const bf16* vals, const int* krows,
                  const int* gmap, float* out, int m, int k, int n, int U,
                  int nzero, cudaStream_t st) {
  const size_t smem = dspipe_smem<TM>(U);
  auto kern = bcsc_lab_dspipe_kernel<TM, NT>;
  const cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(GW / DCW, (m + TM - 1) / TM);
  kern<<<grid, NT, smem, st>>>(a, vals, krows, gmap, out, m, k, n, U, nzero);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* xsmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// a (m, k) bf16; rhs (n/128, 32 U, 128) bf16; out (m, n) f32
int xsmm_bcsc_lab_minimal(const void* a, const void* rhs, void* out, int m,
                          int k, int n, int U, void* stream) {
  if (bad_shape(m, k, n, U) || U * BK > k) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const dim3 grid(n / GW, (m + MTM - 1) / MTM);
  bcsc_lab_minimal_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(rhs),
      static_cast<float*>(out), m, k, n, U);
  return cudaGetLastError();
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* pa = static_cast<const bf16*>(a);
  const bf16* pv = static_cast<const bf16*>(vals);
  float* po = static_cast<float*>(out);
  switch (nchunks) {
    case 1: return launch_chunk<1>(pa, pv, krows, gmap, po, m, k, n, U, nzero, st);
    case 2: return launch_chunk<2>(pa, pv, krows, gmap, po, m, k, n, U, nzero, st);
    case 4: return launch_chunk<4>(pa, pv, krows, gmap, po, m, k, n, U, nzero, st);
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* pa = static_cast<const bf16*>(a);
  const bf16* pv = static_cast<const bf16*>(vals);
  float* po = static_cast<float*>(out);
  if (dspipe_smem<32>(U) <= SMEM_MAX)
    return launch_dspipe<32, 128>(pa, pv, krows, gmap, po, m, k, n, U, nzero, st);
  return launch_dspipe<16, 64>(pa, pv, krows, gmap, po, m, k, n, U, nzero, st);
}

}  // extern "C"
