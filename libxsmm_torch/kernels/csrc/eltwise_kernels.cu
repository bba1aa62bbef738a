// Hand-written Hopper (sm_90a) dropout kernel for libxsmm_torch. Replaces
// the Pallas TPU kernel _dropout_tpu (libxsmm_tpu/kernels/eltwise_pallas.py:
// 103).
//
// Plain C interface, no torch headers (see kernels/_build.py); the wrapper in
// kernels/eltwise.py allocates the outputs, and the entry point launches on
// the caller's stream and returns cudaGetLastError().
//
// What it computes, for every element i of x (flat, row-major):
//   bits = rand_bits(seed, 0, i mod 2^32, i div 2^32)   (a stateless counter
//          hash: the flash kernel's avalanche with the flat index as the
//          counter, xsmm_common.cuh)
//   u    = float((bits >> 9) | 0x3F800000) - 1          (the reference's
//          mantissa fill, eltwise_pallas.py:121-122: u in [0, 1))
//   keep = u >= p;  out = keep ? float(x) * scale : 0, cast to x's type;
//   mask = keep (one byte per element).
// p and scale = 1/(1-p) (computed in f32 by the wrapper) are runtime
// arguments. f16 and bf16 are widened to f32 and the product is rounded
// once, which is what the reference's f32 view of f16 input gives.
// The TPU's per-core PRNG cannot be reproduced here, and the reference does
// not promise the same bits across backends (eltwise_pallas.py:12-14); the
// plain torch version in kernels/eltwise.py computes the same hash, so
// kernel and plain agree bit for bit.
//
// Bound: device memory. At the encoder block's FFN shape (4096 x 3072 bf16)
// the pass reads 25.2 MB and writes 25.2 MB + 12.6 MB of mask: 62.9 MB,
// 0.0188 ms at 3.35 TB/s; the hash is about 12 integer operations per
// element. Design: each thread takes 16 bytes of x (4 f32 or 8 16-bit
// elements) per step of a grid-stride loop, with one 16-byte load, one
// 16-byte store of out and one 4- or 8-byte store of the mask; a ragged tail,
// or an x that is not 16-byte aligned, takes the element-wise path.

#include <cuda_runtime.h>

#include "xsmm_common.cuh"

enum { T_F32 = 0, T_BF16 = 1, T_F16 = 2 };

template <typename T>
__device__ __forceinline__ uint8_t drop_one(const T& x, T* o, long long i,
                                            uint32_t seed, float p,
                                            float scale) {
  const uint32_t bits = rand_bits(seed, 0u, (uint32_t)i,
                                  (uint32_t)((unsigned long long)i >> 32));
  const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  const bool keep = u >= p;
  store_as(keep ? to_f32(x) * scale : 0.0f, o);
  return keep ? 1 : 0;
}

template <int E> struct MaskVec;
template <> struct MaskVec<4> {
  static __device__ __forceinline__ void store(uint8_t* p, const uint8_t* m) {
    *reinterpret_cast<uint32_t*>(p) = (uint32_t)m[0] | ((uint32_t)m[1] << 8) |
                                      ((uint32_t)m[2] << 16) |
                                      ((uint32_t)m[3] << 24);
  }
};
template <> struct MaskVec<8> {
  static __device__ __forceinline__ void store(uint8_t* p, const uint8_t* m) {
    uint2 w;
    w.x = (uint32_t)m[0] | ((uint32_t)m[1] << 8) | ((uint32_t)m[2] << 16) |
          ((uint32_t)m[3] << 24);
    w.y = (uint32_t)m[4] | ((uint32_t)m[5] << 8) | ((uint32_t)m[6] << 16) |
          ((uint32_t)m[7] << 24);
    *reinterpret_cast<uint2*>(p) = w;
  }
};

template <typename T>
__global__ void __launch_bounds__(256) dropout_kernel(
    const T* __restrict__ x, T* __restrict__ out, uint8_t* __restrict__ mask,
    long long n, float p, float scale, uint32_t seed, int aligned) {
  constexpr int E = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * blockDim.x * E;
  for (long long i0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * E;
       i0 < n; i0 += stride) {
    if (aligned && i0 + E <= n) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + i0);
      const T* xe = reinterpret_cast<const T*>(&raw);
      uint4 res;
      T* oe = reinterpret_cast<T*>(&res);
      uint8_t m[E];
#pragma unroll
      for (int e = 0; e < E; ++e)
        m[e] = drop_one(xe[e], oe + e, i0 + e, seed, p, scale);
      *reinterpret_cast<uint4*>(out + i0) = res;
      MaskVec<E>::store(mask + i0, m);
    } else {
      for (long long i = i0; i < i0 + E && i < n; ++i)
        mask[i] = drop_one(x[i], out + i, i, seed, p, scale);
    }
  }
}

template <typename T>
static int launch_dropout(const void* x, void* out, void* mask, long long n,
                          float p, float scale, uint32_t seed, int aligned,
                          int num_sms, cudaStream_t st) {
  constexpr int E = 16 / sizeof(T);
  const long long groups = (n + E - 1) / E;
  long long blocks = (groups + 255) / 256;
  const long long cap = (long long)num_sms * 16;   // grid-stride beyond
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  dropout_kernel<T><<<(unsigned)blocks, 256, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<uint8_t*>(mask), n, p, scale, seed, aligned);
  return cudaGetLastError();
}

extern "C" {

const char* xsmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, out: n elements of `type`; mask: n bytes. out and mask 16-byte aligned
// (fresh allocations); `aligned` says x is too.
int xsmm_dropout(const void* x, void* out, void* mask, long long n, int type,
                 float p, float scale, unsigned seed, int aligned, int num_sms,
                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  if (type == T_F32)
    return launch_dropout<float>(x, out, mask, n, p, scale, seed, aligned, num_sms, st);
  if (type == T_BF16)
    return launch_dropout<__nv_bfloat16>(x, out, mask, n, p, scale, seed, aligned, num_sms, st);
  if (type == T_F16)
    return launch_dropout<__half>(x, out, mask, n, p, scale, seed, aligned, num_sms, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
