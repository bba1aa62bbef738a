// The two other designs of the packed SMM's passthrough twin (out = a + b
// over (G, m, 128) f32, bit for bit as torch's a + b), timed against the
// port's kernel (kernels/csrc/gemm_kernels.cu packed_smm_passthrough_kernel:
// one float4 pair a thread, a one-shot grid of 1024-thread blocks) by
// scripts/stream_time.py --rows designs. Nothing in the port runs them.
//
// - pt_persistent: a persistent grid (`grid` blocks of 256 threads, a few
//   an SM) walking chunks of 256 * U float4 units; each thread issues its U
//   pairs of 16-byte loads (unrolled, compile-time U) before its U stores.
//   hint 0: default caching (ld.global.nc, st.global); 1: streaming loads
//   and stores (ld.global.cs, st.global.cs); 2: loads that skip L1
//   (ld.global.nc.L1::no_allocate) and streaming stores. The last chunk is
//   masked.
// - pt_ring: a ring of `stages` shared-memory stages a block, each holding
//   CH bytes of a and of b; one elected thread issues both 1-D bulk copies
//   (cp.async.bulk) of a chunk onto the stage's mbarrier, the block adds in
//   shared memory, and the elected thread writes the sum back with one bulk
//   store, refilling the stage once that store has read it. Chunks are
//   dealt round robin over a persistent grid.
//
//   nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -I ../kernels/csrc passthrough_designs.cu

#include <cuda_runtime.h>
#include <stdint.h>

#include "xsmm_wgmma.cuh"

namespace {

__device__ __forceinline__ float4 add4(float4 x, float4 y) {
  return make_float4(__fadd_rn(x.x, y.x), __fadd_rn(x.y, y.y),
                     __fadd_rn(x.z, y.z), __fadd_rn(x.w, y.w));
}

__device__ __forceinline__ float4 ld_na(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}

template <int HINT>
__device__ __forceinline__ float4 load(const float4* p) {
  if (HINT == 0) return __ldg(p);
  if (HINT == 1) return __ldcs(p);
  return ld_na(p);
}

template <int HINT>
__device__ __forceinline__ void store(float4* p, float4 v) {
  if (HINT == 0) *p = v;
  else __stcs(p, v);
}

constexpr int PERSIST_THREADS = 256;

template <int U, int HINT>
__global__ void __launch_bounds__(PERSIST_THREADS)
pt_persistent_kernel(const float4* __restrict__ a,
                     const float4* __restrict__ b, float4* __restrict__ out,
                     long long units) {
  constexpr int CH = PERSIST_THREADS * U;
  const long long chunks = (units + CH - 1) / CH;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    const long long i0 = c * CH + threadIdx.x;
    if ((c + 1) * CH <= units) {
      float4 x[U], y[U];
#pragma unroll
      for (int j = 0; j < U; ++j) {
        x[j] = load<HINT>(a + i0 + j * PERSIST_THREADS);
        y[j] = load<HINT>(b + i0 + j * PERSIST_THREADS);
      }
#pragma unroll
      for (int j = 0; j < U; ++j)
        store<HINT>(out + i0 + j * PERSIST_THREADS, add4(x[j], y[j]));
    } else {
      for (int j = 0; j < U; ++j) {
        const long long i = i0 + (long long)j * PERSIST_THREADS;
        if (i < units) store<HINT>(out + i, add4(a[i], b[i]));
      }
    }
  }
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      :: "l"(reinterpret_cast<uint64_t>(dst)), "r"(wg_smem(src)),
         "r"(bytes) : "memory");
}

constexpr int RING_THREADS = 128;
constexpr int RING_HEAD = 128;   // the stages' mbarriers, before the stages

template <int CH>
__global__ void __launch_bounds__(RING_THREADS)
pt_ring_kernel(const unsigned char* __restrict__ a,
               const unsigned char* __restrict__ b,
               unsigned char* __restrict__ out, long long total, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  const long long chunks = (total + CH - 1) / CH, step = gridDim.x;
  const int tid = threadIdx.x;
  auto stage = [&](int s) { return smem + RING_HEAD + (long)s * 2 * CH; };
  auto issue = [&](long long c, int s) {
    const uint32_t bytes = (uint32_t)min((long long)CH, total - c * CH);
    mbar_arrive_expect_tx(&full[s], 2 * bytes);
    bulk_load_1d(stage(s), a + c * CH, bytes, &full[s]);
    bulk_load_1d(stage(s) + CH, b + c * CH, bytes, &full[s]);
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < stages; ++s)
      if (blockIdx.x + s * step < chunks) issue(blockIdx.x + s * step, s);
  int i = 0;
  for (long long c = blockIdx.x; c < chunks; c += step, ++i) {
    const int s = i % stages;
    mbar_wait(&full[s], (i / stages) & 1);
    const int n4 = (int)(min((long long)CH, total - c * CH) / 16);
    float4* x = reinterpret_cast<float4*>(stage(s));
    const float4* y = reinterpret_cast<const float4*>(stage(s) + CH);
    for (int u = tid; u < n4; u += RING_THREADS) x[u] = add4(x[u], y[u]);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      bulk_store(out + c * CH, stage(s), n4 * 16);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      if (i >= 1) {   // the stage stored one chunk ago is free once read
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        const long long next = c - step + stages * step;
        if (next < chunks) issue(next, (i - 1) % stages);
      }
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int CH>
int launch_ring(const void* a, const void* b, void* out, long long total,
                int grid, int stages, cudaStream_t s) {
  const int smem = RING_HEAD + stages * 2 * CH;
  const cudaError_t e = cudaFuncSetAttribute(
      pt_ring_kernel<CH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  pt_ring_kernel<CH><<<grid, RING_THREADS, smem, s>>>(
      static_cast<const unsigned char*>(a),
      static_cast<const unsigned char*>(b), static_cast<unsigned char*>(out),
      total, stages);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a, b, out: `units` float4 units, 16-byte aligned; unroll 2, 4 or 8; hint
// 0, 1 or 2 (above)
int pt_persistent(const void* a, const void* b, void* out, long long units,
                  int grid, int unroll, int hint, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* A = static_cast<const float4*>(a);
  const float4* B = static_cast<const float4*>(b);
  float4* O = static_cast<float4*>(out);
#define PT_CASE(U, H)                                                       \
  if (unroll == U && hint == H) {                                           \
    pt_persistent_kernel<U, H><<<grid, PERSIST_THREADS, 0, s>>>(A, B, O,    \
                                                                units);     \
    return cudaGetLastError();                                              \
  }
  PT_CASE(2, 0) PT_CASE(2, 1) PT_CASE(2, 2)
  PT_CASE(4, 0) PT_CASE(4, 1) PT_CASE(4, 2)
  PT_CASE(8, 0) PT_CASE(8, 1) PT_CASE(8, 2)
#undef PT_CASE
  return cudaErrorInvalidValue;
}

// a, b, out: `total` bytes (a multiple of 16), 16-byte aligned; chunk 4096,
// 8192 or 16384 bytes an operand a stage
int pt_ring(const void* a, const void* b, void* out, long long total,
            int grid, int chunk, int stages, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 4096: return launch_ring<4096>(a, b, out, total, grid, stages, s);
    case 8192: return launch_ring<8192>(a, b, out, total, grid, stages, s);
    case 16384: return launch_ring<16384>(a, b, out, total, grid, stages, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
