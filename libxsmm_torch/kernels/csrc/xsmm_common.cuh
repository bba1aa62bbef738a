// Device helpers shared by the attention and eltwise kernels: element
// conversions, rounding, vector loads from shared memory and the position
// hash of the reference's _rand_bits
// (libxsmm_tpu/kernels/attention_pallas.py:144). kernels/_build.py hashes
// this header into the name of every library it builds, so an edit here
// rebuilds them all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// round to nearest even, as astype
__device__ __forceinline__ void store_as(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_as(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store_as(float v, __half* p) {
  *p = __float2half_rn(v);
}

// v rounded to the input type T and widened back: the reference's
// astype(dtype) of an f32 value
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// N consecutive floats of shared memory in one vector load
template <int N> struct VecF;
template <> struct VecF<2> {
  static __device__ __forceinline__ void load(const float* p, float* d) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    d[0] = v.x; d[1] = v.y;
  }
};
template <> struct VecF<4> {
  static __device__ __forceinline__ void load(const float* p, float* d) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  }
};

// A splitmix32-style avalanche of (seed, batch, row, col) in u32
// arithmetic: stateless, so any tiling recomputes the same bits.
__device__ __forceinline__ uint32_t rand_bits(uint32_t seed, uint32_t b,
                                              uint32_t row, uint32_t col) {
  uint32_t h = (row * 0x9E3779B1u) ^ (col * 0x85EBCA77u);
  h ^= seed + b * 0xC2B2AE3Du;
  h = (h ^ (h >> 15)) * 0x2C1B3C6Du;
  h = (h ^ (h >> 12)) * 0x297A2D39u;
  return h ^ (h >> 15);
}

// The batch-head index the dropout hash reads for local batch-head b of an
// attention whose (batch, heads) are a block of a larger tensor: a rank
// holding heads [h0, h0 + nhl) of nhg, for batches from b0 on, hashes
// global batch-head (b0 + b / nhl) * nhg + h0 + b % nhl. The default
// {0, 0, 1, 1} gives b itself. Worked out once a block.
struct HeadMap {
  uint32_t b0, h0, nhl, nhg;
  __device__ __forceinline__ uint32_t operator()(int b) const {
    const uint32_t u = (uint32_t)b;
    return (b0 + u / nhl) * nhg + h0 + u % nhl;
  }
};
