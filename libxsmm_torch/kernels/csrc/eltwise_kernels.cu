// Hand-written Hopper (sm_90a) element-wise kernels for libxsmm_torch:
// dropout, which replaces the Pallas TPU kernel _dropout_tpu
// (libxsmm_tpu/kernels/eltwise_pallas.py:103), and stochastic rounding,
// which replaces _sr_tpu (eltwise_pallas.py:50); the second is described
// above its kernel below.
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
//   mask = keep, in one of three forms (`form`):
//     bytes   one byte per element (what the encoder block's _Dropout
//             saves for its backward);
//     packed  x viewed as (rows, cols): the reference's BITMASK_2BYTEMULT
//             layout (ops/eltwise.py bitmask_ld / pack_bitmask):
//             the bit of (r, c) is bit c % 8 of byte c / 8 + r * ld / 8,
//             ld = ceil(cols / 16) * 16 bits, pad bits 0;
//     none    no mask (the meltw DROPOUT without the flag).
// p and scale = 1/(1-p) (computed in f32 by the wrapper) are runtime
// arguments. f16 and bf16 are widened to f32 and the product is rounded
// once, which is what the reference's f32 view of f16 input gives.
// The TPU's per-core PRNG cannot be reproduced here, and the reference does
// not promise the same bits across backends (eltwise_pallas.py:12-14); the
// plain torch version in kernels/eltwise.py computes the same hash, so
// kernel and plain agree bit for bit.
//
// Bound: device memory. At the encoder block's FFN shape (4096 x 3072 bf16)
// the pass reads 25.2 MB and writes 25.2 MB of out, plus 12.6 MB of byte
// mask (62.9 MB, 0.0188 ms at 3.35 TB/s), 1.6 MB of packed mask (51.9 MB,
// 0.0155 ms) or none (50.3 MB, 0.0150 ms); the hash is about 12 integer
// operations per element. Design, bytes and none: each thread takes 16
// bytes of x (4 f32 or 8 16-bit elements) per step of a grid-stride loop,
// with one 16-byte load, one 16-byte store of out and one 4- or 8-byte
// store of the mask; a ragged tail, or an x that is not 16-byte aligned,
// takes the element-wise path. Packed: a thread owns 16 consecutive
// columns of one row and writes their bits as one aligned 16-bit word, so
// the mask costs no pass of its own (the reference packs it with jnp ops
// that XLA fuses); x goes by 16-byte vectors where its address and row
// stride allow, element by element otherwise (and in a ragged last word).
//
// A block (xsmm_dropout_block): x is a block of a global tensor of up to 4
// dimensions (a rank's shard), and element i hashes its global row-major
// flat index instead of i, so the ranks' masks put together are the mask
// of the unsharded tensor bit for bit. The global index of a local row's
// first element is worked out once a row (DropBlock::row_base: three
// divisions; once a 16-column word in the packed form), the row's elements
// add their column. Bytes and none go to
// dropout_block_kernel, where a group of threads (a power of two, enough
// for one pass over a row's 16-byte units) owns a row; packed is the
// packed kernel with the row base hashed. Without a block xsmm_dropout
// runs the kernels above unchanged.

#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include "xsmm_common.cuh"
#include "xsmm_launches.cuh"

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

enum { MASK_BYTES = 0, MASK_PACKED = 1, MASK_NONE = 2 };

// A block of a global row-major tensor of up to 4 dimensions (leading
// dimensions padded with extent 1 and offset 0): x is the block, of shape
// lshape at offset off in the global tensor, and each of its elements
// hashes its GLOBAL flat index, so the blocks of a sharded tensor draw,
// together, the bits of the whole tensor. row_base(r) is the global index
// of the first element of local row r (x viewed as (rows, lshape[3])),
// worked out once a row.
struct DropBlock {
  long long lshape[4], off[4], gstride[4];
  __device__ __forceinline__ long long row_base(long long r) const {
    const long long i2 = r % lshape[2];
    r /= lshape[2];
    const long long i1 = r % lshape[1], i0 = r / lshape[1];
    return (off[0] + i0) * gstride[0] + (off[1] + i1) * gstride[1] +
           (off[2] + i2) * gstride[2] + off[3];
  }
};

// bytes and none (mask == nullptr)
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
      if (mask) MaskVec<E>::store(mask + i0, m);
    } else {
      for (long long i = i0; i < i0 + E && i < n; ++i) {
        const uint8_t k = drop_one(x[i], out + i, i, seed, p, scale);
        if (mask) mask[i] = k;
      }
    }
  }
}

// packed: x viewed as (rows, cols); step t of the grid-stride loop owns
// columns [16 w, 16 w + 16) of row r, t = r * W + w, W = ceil(cols / 16),
// and stores their keep bits as the 16-bit word t of the mask (bit e is
// column 16 w + e: little-endian, so byte 2 t + e / 8, bit e % 8). `vec`:
// x and its row stride are 16-byte aligned.
template <typename T, bool BLOCK>
__global__ void __launch_bounds__(256) dropout_packed_kernel(
    const T* __restrict__ x, T* __restrict__ out,
    uint16_t* __restrict__ mask, long long rows, int cols, float p,
    float scale, uint32_t seed, int vec, DropBlock blk) {
  constexpr int E = 16 / sizeof(T);
  const int W = (cols + 15) / 16;
  const long long units = rows * W;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < units; t += stride) {
    const long long r = t / W;
    const int c0 = (int)(t - r * W) * 16;
    const long long i0 = r * cols + c0;
    const long long h0 = BLOCK ? blk.row_base(r) + c0 : i0;   // hashed
    uint32_t word = 0;
    if (vec && c0 + 16 <= cols) {
#pragma unroll
      for (int v = 0; v < 16 / E; ++v) {
        const uint4 raw = *reinterpret_cast<const uint4*>(x + i0 + v * E);
        const T* xe = reinterpret_cast<const T*>(&raw);
        uint4 res;
        T* oe = reinterpret_cast<T*>(&res);
#pragma unroll
        for (int e = 0; e < E; ++e)
          word |= (uint32_t)drop_one(xe[e], oe + e, h0 + v * E + e, seed, p,
                                     scale) << (v * E + e);
        *reinterpret_cast<uint4*>(out + i0 + v * E) = res;
      }
    } else {
      const int ce = cols - c0 < 16 ? cols - c0 : 16;
      for (int e = 0; e < ce; ++e)
        word |= (uint32_t)drop_one(x[i0 + e], out + i0 + e, h0 + e, seed, p,
                                   scale) << e;
    }
    mask[t] = (uint16_t)word;
  }
}

// bytes and none (mask == nullptr) of a block (DropBlock): x viewed as
// (rows, cols), cols = lshape[3]. A row goes to a group of 2^tpr_log2
// threads, which works out its global row base once and walks the row in
// 16-byte units (E elements) at a stride of the group's width; groups take
// rows at a grid stride. `vec`: x and its row stride are 16-byte aligned,
// so every full unit goes by one 16-byte load and store (and one 4- or
// 8-byte store of the mask); a ragged last unit goes element by element.
template <typename T>
__global__ void __launch_bounds__(256) dropout_block_kernel(
    const T* __restrict__ x, T* __restrict__ out, uint8_t* __restrict__ mask,
    long long rows, long long cols, float p, float scale, uint32_t seed,
    int vec, int tpr_log2, DropBlock blk) {
  constexpr int E = 16 / sizeof(T);
  const int lane = threadIdx.x & ((1 << tpr_log2) - 1);
  const long long groups = 256 >> tpr_log2;
  const long long step = (long long)E << tpr_log2;
  for (long long r = (long long)blockIdx.x * groups +
                     (threadIdx.x >> tpr_log2);
       r < rows; r += (long long)gridDim.x * groups) {
    const long long base = blk.row_base(r);
    const long long m0 = r * cols;
    for (long long c0 = (long long)lane * E; c0 < cols; c0 += step) {
      if (vec && c0 + E <= cols) {
        const uint4 raw = *reinterpret_cast<const uint4*>(x + m0 + c0);
        const T* xe = reinterpret_cast<const T*>(&raw);
        uint4 res;
        T* oe = reinterpret_cast<T*>(&res);
        uint8_t m[E];
#pragma unroll
        for (int e = 0; e < E; ++e)
          m[e] = drop_one(xe[e], oe + e, base + c0 + e, seed, p, scale);
        *reinterpret_cast<uint4*>(out + m0 + c0) = res;
        if (mask) MaskVec<E>::store(mask + m0 + c0, m);
      } else {
        for (long long c = c0; c < c0 + E && c < cols; ++c) {
          const uint8_t k = drop_one(x[m0 + c], out + m0 + c, base + c, seed,
                                     p, scale);
          if (mask) mask[m0 + c] = k;
        }
      }
    }
  }
}

template <typename T>
static int launch_dropout(const void* x, void* out, void* mask, long long n,
                          int cols, int form, float p, float scale,
                          uint32_t seed, int aligned, int num_sms,
                          cudaStream_t st) {
  constexpr int E = 16 / sizeof(T);
  // a thread's units: 16-byte groups of x, or 16-column words when packed
  const long long units = form == MASK_PACKED
                              ? (n / cols) * ((cols + 15) / 16)
                              : (n + E - 1) / E;
  long long blocks = (units + 255) / 256;
  const long long cap = (long long)num_sms * 16;   // grid-stride beyond
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  if (form == MASK_PACKED) {
    note_launch(dropout_packed_kernel<T, false>);
    dropout_packed_kernel<T, false><<<(unsigned)blocks, 256, 0, st>>>(
        static_cast<const T*>(x), static_cast<T*>(out),
        static_cast<uint16_t*>(mask), n / cols, cols, p, scale, seed,
        aligned && (cols * sizeof(T)) % 16 == 0, DropBlock{});
  } else {
    note_launch(dropout_kernel<T>);
    dropout_kernel<T><<<(unsigned)blocks, 256, 0, st>>>(
        static_cast<const T*>(x), static_cast<T*>(out),
        form == MASK_BYTES ? static_cast<uint8_t*>(mask) : nullptr, n, p,
        scale, seed, aligned);
  }
  return cudaGetLastError();
}


// a block (DropBlock): packed as launch_dropout's packed form, with the
// global index hashed; bytes and none by dropout_block_kernel
template <typename T>
static int launch_dropout_block(const void* x, void* out, void* mask,
                                long long n, long long cols, int form,
                                float p, float scale, uint32_t seed,
                                int aligned, const DropBlock& blk,
                                int num_sms, cudaStream_t st) {
  constexpr int E = 16 / sizeof(T);
  const long long rows = n / cols;
  const long long cap = (long long)num_sms * 16;   // grid-stride beyond
  const int vec = aligned && (cols * (long long)sizeof(T)) % 16 == 0;
  long long blocks;
  if (form == MASK_PACKED) {
    blocks = (rows * ((cols + 15) / 16) + 255) / 256;
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;
    note_launch(dropout_packed_kernel<T, true>);
    dropout_packed_kernel<T, true><<<(unsigned)blocks, 256, 0, st>>>(
        static_cast<const T*>(x), static_cast<T*>(out),
        static_cast<uint16_t*>(mask), rows, (int)cols, p, scale, seed, vec,
        blk);
    return cudaGetLastError();
  }
  // the fewest threads a row (a power of two, at most a block) that cover
  // its 16-byte units in one pass
  const long long units = (cols + E - 1) / E;
  int tpr_log2 = 0;
  while (tpr_log2 < 8 && (1ll << tpr_log2) < units) ++tpr_log2;
  blocks = (rows + (256 >> tpr_log2) - 1) / (256 >> tpr_log2);
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  note_launch(dropout_block_kernel<T>);
  dropout_block_kernel<T><<<(unsigned)blocks, 256, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      form == MASK_BYTES ? static_cast<uint8_t*>(mask) : nullptr, rows, cols,
      p, scale, seed, vec, tpr_log2, blk);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Stochastic rounding (replaces _sr_tpu, eltwise_pallas.py:50)
//
// The TPU kernel seeds the core's PRNG and calls the hardware's exact
// stochastic round. Here, for every element i of x (f32, bf16 or f16,
// widened to f32):
//   r    = rand_bits(seed, 0, i mod 2^32, i div 2^32)  (dropout's hash)
//   |x| is rounded onto the target (bf16, f16, e5m2 or e4m3fn) by adding
//   the bits of r below the target's ulp to |x|'s f32 bits and cutting them
//   off: the upper neighbour is taken with probability (|x| - lower) / ulp.
//   Above the target's least normal exponent the ulp is 2^-M of x's binade
//   (M mantissa bits): add r's low 23-M bits, mask them off (a carry moves
//   into the next binade). Below it (the target's subnormals) the ulp is
//   fixed at 2^(emin - M): the 24-bit significand is shifted right by
//   d = 23 - M + (emin_b - e) bits with d bits of r added first (past 32
//   bits, the significand's lowest bits are cut before the add).
//   NaN stays NaN (the target's quiet NaN with x's sign); an f8 value past
//   the largest finite takes the round-to-nearest-even cast (e5m2: 57344
//   below 61440, Inf from there; e4m3fn: 448 up to 464, NaN above).
// For bf16 this is the reference's add-16-random-bits-and-truncate
// (eltwise_pallas.py:41-47). The plain torch version in kernels/eltwise.py
// runs the same integer arithmetic on the same bits, so the two agree bit
// for bit.
//
// Bound: device memory. At the FFN shape (4096 x 3072 f32 -> bf16) the pass
// reads 50.3 MB and writes 25.2 MB: 0.0225 ms at 3.35 TB/s (0.0188 ms with
// an f8 output); the hash and the rounding are about 25 integer operations
// per element. Design: as dropout, a grid-stride loop in which each thread
// takes 16 bytes of x per step in one load and stores its E results in one
// 4-, 8- or 16-byte store; a ragged tail, or an x that is not 16-byte
// aligned, takes the element-wise path.
// ---------------------------------------------------------------------------

enum { SR_BF16 = 0, SR_F16 = 1, SR_E5M2 = 2, SR_E4M3 = 3 };

template <int TGT> struct SrTarget;
template <> struct SrTarget<SR_BF16> {
  typedef uint16_t bits_t;
  static constexpr int M = 7, EMIN = -126;
};
template <> struct SrTarget<SR_F16> {
  typedef uint16_t bits_t;
  static constexpr int M = 10, EMIN = -14;
};
template <> struct SrTarget<SR_E5M2> {
  typedef uint8_t bits_t;
  static constexpr int M = 2, EMIN = -14;
};
template <> struct SrTarget<SR_E4M3> {
  typedef uint8_t bits_t;
  static constexpr int M = 3, EMIN = -6;
};

// the f32 bits of 2^e (a subnormal below 2^-126)
__host__ __device__ constexpr uint32_t pow2_bits(int e) {
  return e >= -126 ? (uint32_t)(e + 127) << 23 : 1u << (e + 149);
}

// |x| (f32 bits a, sign cleared) rounded stochastically onto the target,
// returned as f32 bits
template <int TGT>
__device__ __forceinline__ uint32_t sr_magnitude(uint32_t a, uint32_t r) {
  constexpr int M = SrTarget<TGT>::M;
  constexpr int DROP = 23 - M;
  constexpr int EMIN_B = SrTarget<TGT>::EMIN + 127;
  const int e = (int)(a >> 23);
  if (e >= EMIN_B) {
    constexpr uint32_t mask = (1u << DROP) - 1u;
    return (a + (r & mask)) & ~mask;
  }
  const int e_eff = e > 0 ? e : 1;
  const int d = DROP + (EMIN_B - e_eff);
  const uint64_t m24 = (a & 0x7FFFFFu) | (e > 0 ? 0x800000u : 0u);
  const int d_lo = d < 32 ? d : 32;
  const int cut = d - 32 < 0 ? 0 : (d - 32 > 31 ? 31 : d - 32);
  const uint64_t rr = (uint64_t)r & ((1ull << d_lo) - 1ull);
  const uint64_t q = ((m24 >> cut) + rr) >> d_lo;
  // q target ulps of 2^(EMIN - M): exact in f32 (q <= 2^(M+1))
  constexpr uint32_t ulp = pow2_bits(SrTarget<TGT>::EMIN - M);
  return __float_as_uint((float)q * __uint_as_float(ulp));
}

template <int TGT>
__device__ __forceinline__ typename SrTarget<TGT>::bits_t sr_one(
    float x, long long i, uint32_t seed) {
  const uint32_t r = rand_bits(seed, 0u, (uint32_t)i,
                               (uint32_t)((unsigned long long)i >> 32));
  const uint32_t bits = __float_as_uint(x);
  const uint32_t sign = bits & 0x80000000u;
  const uint32_t a = bits & 0x7FFFFFFFu;
  const bool nan = a > 0x7F800000u;
  const float v = __uint_as_float(sr_magnitude<TGT>(a, r) | sign);
  if constexpr (TGT == SR_BF16) {
    return (uint16_t)(nan ? 0x7FC0u | (sign >> 16) : __float_as_uint(v) >> 16);
  } else if constexpr (TGT == SR_F16) {
    return nan ? (uint16_t)(0x7E00u | (sign >> 16))
               : __half_as_ushort(__float2half_rn(v));
  } else if constexpr (TGT == SR_E5M2) {
    if (nan) return (uint8_t)(0x7Fu | (sign >> 24));
    if (a > 0x47600000u)        // past 57344: RNE, Inf from 61440
      return (uint8_t)((a >= 0x47700000u ? 0x7Cu : 0x7Bu) | (sign >> 24));
    return (uint8_t)__nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E5M2);
  } else {
    if (nan) return (uint8_t)(0x7Fu | (sign >> 24));
    if (a > 0x43E00000u)        // past 448: RNE, NaN above 464
      return (uint8_t)((a > 0x43E80000u ? 0x7Fu : 0x7Eu) | (sign >> 24));
    return (uint8_t)__nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
  }
}

template <int BYTES> struct VecBytes;
template <> struct VecBytes<4> { typedef uint32_t type; };
template <> struct VecBytes<8> { typedef uint2 type; };
template <> struct VecBytes<16> { typedef uint4 type; };

template <typename T, int TGT>
__global__ void __launch_bounds__(256) sr_kernel(
    const T* __restrict__ x, typename SrTarget<TGT>::bits_t* __restrict__ out,
    long long n, uint32_t seed, int aligned) {
  typedef typename SrTarget<TGT>::bits_t O;
  constexpr int E = 16 / sizeof(T);
  typedef typename VecBytes<E * sizeof(O)>::type V;
  const long long stride = (long long)gridDim.x * blockDim.x * E;
  for (long long i0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * E;
       i0 < n; i0 += stride) {
    if (aligned && i0 + E <= n) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + i0);
      const T* xe = reinterpret_cast<const T*>(&raw);
      V res;
      O* oe = reinterpret_cast<O*>(&res);
#pragma unroll
      for (int e = 0; e < E; ++e) oe[e] = sr_one<TGT>(to_f32(xe[e]), i0 + e, seed);
      *reinterpret_cast<V*>(out + i0) = res;
    } else {
      for (long long i = i0; i < i0 + E && i < n; ++i)
        out[i] = sr_one<TGT>(to_f32(x[i]), i, seed);
    }
  }
}

template <typename T, int TGT>
static int launch_sr(const void* x, void* out, long long n, uint32_t seed,
                     int aligned, int num_sms, cudaStream_t st) {
  constexpr int E = 16 / sizeof(T);
  const long long groups = (n + E - 1) / E;
  long long blocks = (groups + 255) / 256;
  const long long cap = (long long)num_sms * 16;   // grid-stride beyond
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  note_launch(sr_kernel<T, TGT>);
  sr_kernel<T, TGT><<<(unsigned)blocks, 256, 0, st>>>(
      static_cast<const T*>(x),
      static_cast<typename SrTarget<TGT>::bits_t*>(out), n, seed, aligned);
  return cudaGetLastError();
}

template <typename T>
static int launch_sr_to(int target, const void* x, void* out, long long n,
                        uint32_t seed, int aligned, int num_sms,
                        cudaStream_t st) {
  if (target == SR_BF16)
    return launch_sr<T, SR_BF16>(x, out, n, seed, aligned, num_sms, st);
  if (target == SR_F16)
    return launch_sr<T, SR_F16>(x, out, n, seed, aligned, num_sms, st);
  if (target == SR_E5M2)
    return launch_sr<T, SR_E5M2>(x, out, n, seed, aligned, num_sms, st);
  if (target == SR_E4M3)
    return launch_sr<T, SR_E4M3>(x, out, n, seed, aligned, num_sms, st);
  return cudaErrorInvalidValue;
}

extern "C" {

const char* xsmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, out: n elements of `type`, out 16-byte aligned (a fresh allocation);
// `aligned` says x is too. The mask by `form`: MASK_BYTES n bytes, 16-byte
// aligned; MASK_PACKED (n / cols) x ceil(cols / 16) 16-bit words, x viewed
// as (n / cols, cols); MASK_NONE none (mask unused).
int xsmm_dropout(const void* x, void* out, void* mask, long long n, int cols,
                 int type, int form, float p, float scale, unsigned seed,
                 int aligned, int num_sms, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || form < MASK_BYTES || form > MASK_NONE ||
      (form == MASK_PACKED && (cols <= 0 || n % cols)))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  if (type == T_F32)
    return launch_dropout<float>(x, out, mask, n, cols, form, p, scale, seed, aligned, num_sms, st);
  if (type == T_BF16)
    return launch_dropout<__nv_bfloat16>(x, out, mask, n, cols, form, p, scale, seed, aligned, num_sms, st);
  if (type == T_F16)
    return launch_dropout<__half>(x, out, mask, n, cols, form, p, scale, seed, aligned, num_sms, st);
  return cudaErrorInvalidValue;
}

// dropout of a block (DropBlock) of a global tensor of nd <= 4 dimensions:
// x is the block, of shape lshape[0..nd) at offset off[0..nd) in the
// global shape gshape[0..nd); n and cols are its element count and last
// extent (the packed form views x as (n / cols, cols)). The other
// arguments as xsmm_dropout's; each element hashes its global row-major
// flat index.
int xsmm_dropout_block(const void* x, void* out, void* mask, long long n,
                       int type, int form, float p, float scale,
                       unsigned seed, int aligned, int nd,
                       const long long* lshape, const long long* gshape,
                       const long long* off, int num_sms, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nd < 1 || nd > 4 || n < 0 || form < MASK_BYTES || form > MASK_NONE)
    return cudaErrorInvalidValue;
  DropBlock blk;
  long long count = 1, stride = 1;
  for (int k = 3; k >= 0; --k) {
    const int d = k - (4 - nd);     // the caller's dimension, or < 0
    const long long ls = d >= 0 ? lshape[d] : 1;
    const long long gs = d >= 0 ? gshape[d] : 1;
    const long long of = d >= 0 ? off[d] : 0;
    if (ls < 0 || of < 0 || of + ls > gs) return cudaErrorInvalidValue;
    blk.lshape[k] = ls;
    blk.off[k] = of;
    blk.gstride[k] = stride;
    stride *= gs;
    count *= ls;
  }
  const long long cols = blk.lshape[3];
  if (count != n || (form == MASK_PACKED && nd != 2))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  if (type == T_F32)
    return launch_dropout_block<float>(x, out, mask, n, cols, form, p, scale, seed, aligned, blk, num_sms, st);
  if (type == T_BF16)
    return launch_dropout_block<__nv_bfloat16>(x, out, mask, n, cols, form, p, scale, seed, aligned, blk, num_sms, st);
  if (type == T_F16)
    return launch_dropout_block<__half>(x, out, mask, n, cols, form, p, scale, seed, aligned, blk, num_sms, st);
  return cudaErrorInvalidValue;
}

// x: n elements of `type`; out: n elements of `target` (16-byte aligned, a
// fresh allocation); `aligned` says x is 16-byte aligned too.
int xsmm_stochastic_round(const void* x, void* out, long long n, int type,
                          int target, unsigned seed, int aligned, int num_sms,
                          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  if (type == T_F32)
    return launch_sr_to<float>(target, x, out, n, seed, aligned, num_sms, st);
  if (type == T_BF16)
    return launch_sr_to<__nv_bfloat16>(target, x, out, n, seed, aligned,
                                       num_sms, st);
  if (type == T_F16)
    return launch_sr_to<__half>(target, x, out, n, seed, aligned, num_sms,
                                st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
