// Hand-written Hopper (sm_90a) flash-attention forward for libxsmm_torch.
// Replaces the Pallas TPU kernel build_flash_attention
// (libxsmm_tpu/kernels/attention_pallas.py:159).
//
// Plain C interface, no torch headers: kernels/_build.py compiles this file
// with nvcc into a shared library and kernels/attention.py calls it through
// ctypes. The entry point launches on the caller's stream, allocates nothing
// (the wrapper passes the outputs from torch.empty), does not synchronise,
// and returns cudaGetLastError() so the wrapper raises on a refused launch.
//
// What it computes, per (batch-head b, query row r), as the reference does
// (attention_pallas.py:215-268):
//   scores = (q . kT) * scale  [+ bias (f32)]  [causal: col > row -> f32 min]
//   online softmax over K tiles: running max m, denominator l of the
//   UNDROPPED exponentials, f32 accumulator acc = sum e_use . v, where
//   e_use = e, or e * 1/(1-p) where keep(rand_bits(seed, b, row, col) >= thr)
//   and 0 elsewhere; e_use is rounded to the input type before the product;
//   out = acc / l cast once; lse = m + log(l), written to all 128 columns of
//   the (bh, s, 128) f32 output when asked for.
//
// Bound. At bench.py's serving shape (bh=16, s=2048, hd=128, bf16) the two
// products are 34.4 GFLOP against 33.5 MB of operands: far above the card's
// balance point, so operations bound it (0.035 ms on the bf16 tensor
// cores). This first version runs f32 FMAs on the CUDA cores (67 TFLOP/s,
// a 0.51 ms floor there): every product is an f32 FMA, so f32 inputs get
// full f32 (no TF32) and bf16 inputs are widened exactly on load. The
// tensor-core version (mma / wgmma on bf16 tiles) is later work.
//
// Design. The TPU kernel's (bq, 128) lane-broadcast scratch and its VMEM
// budget have no meaning here. One block of 256 threads takes one
// (b, 64-row Q tile) and loops over K tiles of BK columns, bounded at the
// diagonal when causal (the reference visits every step and masks). The Q
// tile is staged once, transposed, in shared memory; each K^T tile
// (hd rows of BK contiguous columns of kT) and V tile (BK rows of hd) is
// staged per step, widened to f32. Thread (ty, tx) of a 16 x 16 grid owns
// score rows 4ty..4ty+3 and columns tx*CPT.., reading four Q rows and CPT
// K columns with one vector load each per step of the hd loop; the row
// statistics reduce over the 16 lanes of a half-warp with shuffles. The
// exponentials go through shared memory (P^T) to the P.V product, where the
// same thread owns the same four rows of the f32 accumulator, kept in
// registers with m and l. Nothing of the (s, s) panels reaches device
// memory.

#include <cuda_runtime.h>
#include <float.h>

#include "xsmm_common.cuh"

enum { T_F32 = 0, T_BF16 = 1 };

constexpr int BQ = 64;        // query rows per block
constexpr int NT = 256;       // threads per block: a 16 x 16 grid
constexpr int QS = BQ + 4;    // row stride of Q^T and P^T in shared memory

// v rounded to T and widened back: the reference's e_use.astype(dtype)
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

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

template <typename T, int HDP, int BK>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ kT,
    const T* __restrict__ v, const float* __restrict__ bias,
    long long bias_stride, T* __restrict__ out, float* __restrict__ lse,
    int s, int hd, float scale, int causal, int dropout, uint32_t seed,
    uint32_t thr, float inv_keep) {
  constexpr int CPT = BK / 16;    // score columns per thread
  constexpr int DG = HDP / 64;    // 4-column output groups per thread
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // [HDP][QS]  Q^T
  float* kt = qt + HDP * QS;                     // [HDP][BK]  K^T tile
  float* vs = kt + HDP * BK;                     // [BK][HDP]  V tile
  float* pt = vs + BK * HDP;                     // [BK][QS]   P^T tile

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int nq = s / BQ;
  // causal: the tiles nearest the bottom have the most K steps; start them
  // first so the short ones fill in behind
  const int qi = causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int b = blockIdx.x;
  const int q0 = qi * BQ;
  const size_t head = (size_t)b * s * hd;
  const T* qh = q + head;
  const T* kh = kT + head;
  const T* vh = v + head;
  const float* bias_h = bias ? bias + (size_t)b * bias_stride : nullptr;

  for (int i = tid; i < BQ * hd; i += NT) {
    const int r = i / hd, d = i - r * hd;
    qt[d * QS + r] = to_f32(qh[(size_t)(q0 + r) * hd + d]);
  }

  float m_i[4], l_i[4], acc[4][DG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -FLT_MAX;
    l_i[i] = 0.f;
#pragma unroll
    for (int g = 0; g < DG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][g][c] = 0.f;
  }

  // a K tile is visited iff its first column is <= the tile's last row
  const int kend = causal ? q0 + BQ : s;
  const int ntiles = (kend + BK - 1) / BK;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();   // the previous step is done with kt, vs and pt
    for (int i = tid; i < hd * BK; i += NT) {
      const int d = i / BK, c = i - d * BK;
      kt[d * BK + c] = to_f32(kh[(size_t)d * s + k0 + c]);
    }
    for (int i = tid; i < BK * HDP; i += NT) {
      const int c = i / HDP, d = i - c * HDP;
      vs[c * HDP + d] = d < hd ? to_f32(vh[(size_t)(k0 + c) * hd + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][CPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * QS + ty * 4);
      float kc[CPT];
      VecF<CPT>::load(kt + d * BK + tx * CPT, kc);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) sc[i][j] = fmaf(av[i], kc[j], sc[i][j]);
    }

    const int col0 = k0 + tx * CPT;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -FLT_MAX;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        float x = sc[i][j] * scale;
        if (bias_h) x += bias_h[(size_t)row * s + col0 + j];
        if (causal && col0 + j > row) x = -FLT_MAX;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float e = expf(sc[i][j] - m_new);
        rs += e;
        float e_use = e;
        if (dropout) {
          const uint32_t bits = rand_bits(seed, (uint32_t)b, (uint32_t)row,
                                          (uint32_t)(col0 + j));
          e_use = bits >= thr ? e * inv_keep : 0.f;
        }
        sc[i][j] = round_as(e_use, q);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int g = 0; g < DG; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][g][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      *reinterpret_cast<float4*>(pt + (tx * CPT + j) * QS + ty * 4) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 p4 = *reinterpret_cast<const float4*>(pt + c * QS + ty * 4);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int g = 0; g < DG; ++g) {
        const float4 w = *reinterpret_cast<const float4*>(
            vs + c * HDP + g * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][g][0] = fmaf(pv[i], w.x, acc[i][g][0]);
          acc[i][g][1] = fmaf(pv[i], w.y, acc[i][g][1]);
          acc[i][g][2] = fmaf(pv[i], w.z, acc[i][g][2]);
          acc[i][g][3] = fmaf(pv[i], w.w, acc[i][g][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    T* orow = out + head + (size_t)row * hd;
#pragma unroll
    for (int g = 0; g < DG; ++g) {
      const int d = g * 64 + tx * 4;
      if (d < hd) {   // hd % 8 == 0: a 4-column group is all in or all out
#pragma unroll
        for (int c = 0; c < 4; ++c) store_as(acc[i][g][c] / l_i[i], orow + d + c);
      }
    }
    if (lse) {
      const float val = m_i[i] + logf(l_i[i]);
      float4* lrow = reinterpret_cast<float4*>(
          lse + ((size_t)b * s + row) * 128 + tx * 8);
      lrow[0] = make_float4(val, val, val, val);
      lrow[1] = make_float4(val, val, val, val);
    }
  }
}

template <typename T, int HDP, int BK>
static int launch_flash(const void* q, const void* kT, const void* v,
                        const void* bias, long long bias_stride, void* out,
                        void* lse, int bh, int s, int hd, float scale,
                        int causal, int dropout, uint32_t seed, uint32_t thr,
                        float inv_keep, cudaStream_t stream) {
  const size_t smem = (size_t)(HDP * QS + 2 * HDP * BK + BK * QS) * sizeof(float);
  auto kern = flash_fwd_kernel<T, HDP, BK>;
  if (smem > 48 * 1024) {
    // above 48 KB only as dynamic shared memory, after the opt-in; set on
    // every launch, since the attribute is held per device
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(bh, s / BQ);   // x runs fastest: every head's tile qi, then qi+1
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kT),
      static_cast<const T*>(v), static_cast<const float*>(bias), bias_stride,
      static_cast<T*>(out), static_cast<float*>(lse), s, hd, scale, causal,
      dropout, seed, thr, inv_keep);
  return cudaGetLastError();
}

template <typename T, int BK>
static int launch_hd(int hdp, const void* q, const void* kT, const void* v,
                     const void* bias, long long bias_stride, void* out,
                     void* lse, int bh, int s, int hd, float scale, int causal,
                     int dropout, uint32_t seed, uint32_t thr, float inv_keep,
                     cudaStream_t st) {
  switch (hdp) {
    case 64: return launch_flash<T, 64, BK>(q, kT, v, bias, bias_stride, out, lse, bh, s, hd, scale, causal, dropout, seed, thr, inv_keep, st);
    case 128: return launch_flash<T, 128, BK>(q, kT, v, bias, bias_stride, out, lse, bh, s, hd, scale, causal, dropout, seed, thr, inv_keep, st);
    case 192: return launch_flash<T, 192, BK>(q, kT, v, bias, bias_stride, out, lse, bh, s, hd, scale, causal, dropout, seed, thr, inv_keep, st);
    case 256: return launch_flash<T, 256, BK>(q, kT, v, bias, bias_stride, out, lse, bh, s, hd, scale, causal, dropout, seed, thr, inv_keep, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" {

const char* xsmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, v: (bh, s, hd); kT: (bh, hd, s); bias: f32 (s, s) per head at
// bias + b * bias_stride, or null; out: (bh, s, hd); lse: (bh, s, 128) f32
// or null. s % 64 == 0, hd % 8 == 0, hd <= 256; bk in {32, 64}.
int xsmm_flash_fwd(const void* q, const void* kT, const void* v,
                   const void* bias, long long bias_stride, void* out,
                   void* lse, int bh, int s, int hd, int type, int bk,
                   float scale, int causal, int dropout, unsigned seed,
                   unsigned thr, float inv_keep, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s <= 0 || s % BQ || s / BQ > 65535 || hd <= 0 || hd % 8 || hd > 256 ||
      bh <= 0)
    return cudaErrorInvalidValue;
  const int hdp = (hd + 63) / 64 * 64;
  if (type == T_F32 && bk == 64)
    return launch_hd<float, 64>(hdp, q, kT, v, bias, bias_stride, out, lse, bh, s, hd, scale, causal, dropout, seed, thr, inv_keep, st);
  if (type == T_F32 && bk == 32)
    return launch_hd<float, 32>(hdp, q, kT, v, bias, bias_stride, out, lse, bh, s, hd, scale, causal, dropout, seed, thr, inv_keep, st);
  if (type == T_BF16 && bk == 64)
    return launch_hd<__nv_bfloat16, 64>(hdp, q, kT, v, bias, bias_stride, out, lse, bh, s, hd, scale, causal, dropout, seed, thr, inv_keep, st);
  if (type == T_BF16 && bk == 32)
    return launch_hd<__nv_bfloat16, 32>(hdp, q, kT, v, bias, bias_stride, out, lse, bh, s, hd, scale, causal, dropout, seed, thr, inv_keep, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
