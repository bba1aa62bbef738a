// Hand-written Hopper (sm_90a) flash-attention backward for libxsmm_torch:
// two kernels, as the reference splits it. Replaces the Pallas TPU kernels
// of build_flash_attention_bwd (libxsmm_tpu/kernels/attention_pallas.py:322):
//   flash_bwd_dkv_kernel  <- dkv_kernel (:387): dK^T, dV (+ dbias)
//   flash_bwd_dq_kernel   <- dq_kernel  (:485): dQ
//
// Plain C interface, no torch headers: kernels/_build.py compiles this file
// with nvcc into its own shared library (beside the forward's, built in
// parallel) and kernels/attention.py calls it through ctypes. Each entry
// point launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().
//
// What they compute, per (batch-head b, query row i, key column j), in the
// reference's order (attention_pallas.py:356-384):
//   s    = (q_i . k_j) * scale [+ bias_ij (f32)]   [causal: j > i -> masked]
//   p    = exp(s - lse_i)          (masked: 0, as exp(f32 min - lse) is)
//   dp   = dout_i . v_j
//   dropout: keep = rand_bits(seed, b, i, j) >= thr; p~ = keep ? p/(1-p_drop)
//            : 0 and dp = keep ? dp/(1-p_drop) : 0; without dropout p~ = p
//   ds   = p * (dp - delta_i)      (the UNDROPPED p)
//   dV_j  += round(p~_ij) dout_i       dK_j += round(ds_ij) q_i
//   dQ_i  += round(ds_ij) k_j          round(): to the input type
//   dK^T and dQ are scaled by `scale` once, at the end, and cast once; dV is
//   cast once; dbias_ij = ds_ij in f32 (zeros in the causally skipped tiles).
// lse and delta are f32 (bh, s): the wrapper passes one column of the
// reference's lane-broadcast (bh, s, 128) operands.
//
// Bound. Four products in the dK/dV kernel (S, dP, dV, dK) and three in the
// dQ kernel (S, dP, dQ): 8 and 6 * bh * s^2 * hd flops (the reference's
// CostEstimate counts 6 and 4). At bench.py's serving shape (bh=16, s=2048,
// hd=128, bf16) that is 68.7 and 51.5 GFLOP against about 42 MB of
// operands, so operations bound both (0.069 and 0.052 ms on the bf16 tensor
// cores). This first version runs f32 FMAs on the CUDA cores (67 TFLOP/s:
// floors of 1.03 and 0.77 ms): f32 inputs get full f32 (no TF32), bf16
// inputs are widened exactly on load. Tensor cores and TMA are later work.
//
// Design. Hopper blocks run in no order, so the TPU's sequential inner grid
// axis becomes a loop inside the block, and each output tile has exactly
// one writer: no atomics, results identical run to run.
//   dK/dV: one block of 256 threads owns one (b, BK-column K tile). K and V
//   stay in shared memory; the block walks the 64-row Q tiles (from the
//   first that reaches the diagonal when causal), staging Q and dO, and
//   keeps both BK x hd accumulators in registers.
//   dQ: one block owns one (b, 64-row Q tile); Q and dO stay in shared
//   memory; the block walks the K tiles up to the diagonal when causal.
// Every tile is staged row-major in f32 at a row stride of hd + 4 floats.
// In the S and dP products thread (ty, tx) of a 16 x 16 grid owns score rows
// 4ty..4ty+3 and columns tx + 16c, and reads four consecutive hd entries of
// each operand row with one 16-byte load (a quarter warp covers all 32
// banks). The p~ and dS tiles go through shared memory to the accumulating
// products, where each thread owns a few output rows and four consecutive
// columns in each 64-wide group of hd. Nothing of the (s, s) panels reaches
// device memory except dbias when it is asked for.

#include <cuda_runtime.h>

#include "xsmm_common.cuh"

enum { T_F32 = 0, T_BF16 = 1 };

constexpr int BQ = 64;        // query rows per tile
constexpr int NT = 256;       // threads per block: a 16 x 16 grid
constexpr int QS = BQ + 4;    // row stride of the dS^T tile (dQ kernel)

struct BwdArgs {
  const void* q;        // (bh, s, hd)
  const void* kT;       // (bh, hd, s)
  const void* v;        // (bh, s, hd)
  const void* dout;     // (bh, s, hd)
  const float* lse;     // (bh, s)
  const float* delta;   // (bh, s)
  const float* bias;    // (s, s) per head at bias + b * bias_stride, or null
  long long bias_stride;
  void* dq;             // (bh, s, hd)
  void* dkT;            // (bh, hd, s)
  void* dv;             // (bh, s, hd)
  float* dbias;         // (bh, s, s) or null
  int s, hd;
  float scale;
  int causal, dropout;
  uint32_t seed, thr;
  float inv_keep;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows [0, ROWS) of a row-major (., hd) array into dst[ROWS][HDP + 4] in
// f32; columns hd..HDP-1 are zero
template <typename T, int HDP, int ROWS>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int hd) {
  constexpr int LD = HDP + 4;
  for (int i = threadIdx.x; i < ROWS * HDP; i += NT) {
    const int r = i / HDP, d = i - r * HDP;
    dst[r * LD + d] = d < hd ? to_f32(src[(size_t)r * hd + d]) : 0.f;
  }
}

// columns [0, COLS) of a (hd, s) array (kT, pre-offset to the tile) into
// dst[COLS][HDP + 4], transposed: dst[j][d] = src[d][j]
template <typename T, int HDP, int COLS>
__device__ __forceinline__ void stage_cols(float* dst, const T* src, int hd,
                                           int s) {
  constexpr int LD = HDP + 4;
  for (int i = threadIdx.x; i < HDP * COLS; i += NT) {
    const int d = i / COLS, j = i - d * COLS;
    dst[j * LD + d] = d < hd ? to_f32(src[(size_t)d * s + j]) : 0.f;
  }
}

// s0[r][c] = A0[4ty+r] . B0[tx+16c] and s1[r][c] = A1[4ty+r] . B1[tx+16c]
// over hd, for row-major tiles at stride HDP + 4: S = Q K^T and dP = dO V^T
template <int HDP, int CPT>
__device__ __forceinline__ void two_products(
    const float* a0, const float* b0, const float* a1, const float* b1,
    int hd, int ty, int tx, float (&s0)[4][CPT], float (&s1)[4][CPT]) {
  constexpr int LD = HDP + 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) s0[r][c] = s1[r][c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < hd; d += 4) {
    float4 x0[4], x1[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0[r] = ld4(a0 + (ty * 4 + r) * LD + d);
      x1[r] = ld4(a1 + (ty * 4 + r) * LD + d);
    }
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const float4 y0 = ld4(b0 + (tx + 16 * c) * LD + d);
      const float4 y1 = ld4(b1 + (tx + 16 * c) * LD + d);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float u = s0[r][c], w = s1[r][c];
        u = fmaf(x0[r].x, y0.x, u); w = fmaf(x1[r].x, y1.x, w);
        u = fmaf(x0[r].y, y0.y, u); w = fmaf(x1[r].y, y1.y, w);
        u = fmaf(x0[r].z, y0.z, u); w = fmaf(x1[r].z, y1.z, w);
        u = fmaf(x0[r].w, y0.w, u); w = fmaf(x1[r].w, y1.w, w);
        s0[r][c] = u; s1[r][c] = w;
      }
    }
  }
}

// p, the dropped p~ and ds of one score element (attention_pallas.py:356-384)
struct Grad { float p_drop, ds; };
__device__ __forceinline__ Grad score_grad(const BwdArgs& a, const float* bias_h,
                                           int b, int row, int col, float sc,
                                           float dp, float lse, float delta) {
  float x = sc * a.scale;
  if (bias_h) x += bias_h[(size_t)row * a.s + col];
  const float p = (a.causal && col > row) ? 0.f : expf(x - lse);
  float p_drop = p;
  if (a.dropout) {
    const bool keep = rand_bits(a.seed, (uint32_t)b, (uint32_t)row,
                                (uint32_t)col) >= a.thr;
    p_drop = keep ? p * a.inv_keep : 0.f;
    dp = keep ? dp * a.inv_keep : 0.f;
  }
  return {p_drop, p * (dp - delta)};
}

// ---------------------------------------------------------------------------
// dK^T, dV (+ dbias): one block per (b, K tile), looping over the Q tiles
// ---------------------------------------------------------------------------

template <typename T, int HDP, int BK>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(const BwdArgs a) {
  constexpr int LD = HDP + 4;
  constexpr int PS = BK + 4;     // row stride of the p~ and dS tiles
  constexpr int KTS = BK + 1;    // row stride of the dK^T staging tile
  constexpr int CPT = BK / 16;   // score columns per thread
  constexpr int R = BK / 16;     // dK/dV rows per thread
  constexpr int DG = HDP / 64;   // 4-column groups of hd per thread
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [BQ][LD]  Q tile
  float* o_s = q_s + BQ * LD;                     // [BQ][LD]  dO tile
  float* k_s = o_s + BQ * LD;                     // [BK][LD]  K tile
  float* v_s = k_s + BK * LD;                     // [BK][LD]  V tile
  float* p_s = v_s + BK * LD;                     // [BQ][PS]  p~ (rounded)
  float* d_s = p_s + BQ * PS;                     // [BQ][PS]  dS (rounded)

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int s = a.s, hd = a.hd;
  const int b = blockIdx.x;
  const int k0 = blockIdx.y * BK;   // causal: the first tiles have most work
  const size_t head = (size_t)b * s * hd;
  const T* qh = static_cast<const T*>(a.q) + head;
  const T* oh = static_cast<const T*>(a.dout) + head;
  const T* kh = static_cast<const T*>(a.kT) + head;
  const T* vh = static_cast<const T*>(a.v) + head;
  const float* bias_h = a.bias ? a.bias + (size_t)b * a.bias_stride : nullptr;
  float* dbias_h = a.dbias ? a.dbias + (size_t)b * s * s : nullptr;

  stage_cols<T, HDP, BK>(k_s, kh + k0, hd, s);
  stage_rows<T, HDP, BK>(v_s, vh + (size_t)k0 * hd, hd);

  float dk[R][DG][4], dv[R][DG][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int g = 0; g < DG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) dk[r][g][c] = dv[r][g][c] = 0.f;

  // Q tiles entirely above this K tile's diagonal contribute nothing; their
  // dbias blocks are zero (attention_pallas.py:425-432)
  const int qstart = a.causal ? k0 / BQ : 0;
  if (dbias_h) {
    for (int i = tid; i < qstart * BQ * BK; i += NT) {
      const int r = i / BK, c = i - r * BK;
      dbias_h[(size_t)r * s + k0 + c] = 0.f;
    }
  }

  const T* tag = nullptr;   // selects round_as for T
  for (int qi = qstart; qi < s / BQ; ++qi) {
    const int q0 = qi * BQ;
    __syncthreads();   // the previous step is done with q_s, o_s, p_s, d_s
    stage_rows<T, HDP, BQ>(q_s, qh + (size_t)q0 * hd, hd);
    stage_rows<T, HDP, BQ>(o_s, oh + (size_t)q0 * hd, hd);
    float lse_r[4], del_r[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      lse_r[r] = a.lse[(size_t)b * s + q0 + ty * 4 + r];
      del_r[r] = a.delta[(size_t)b * s + q0 + ty * 4 + r];
    }
    __syncthreads();

    float sc[4][CPT], dp[4][CPT];
    two_products<HDP, CPT>(q_s, k_s, o_s, v_s, hd, ty, tx, sc, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty * 4 + r;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = k0 + tx + 16 * c;
        const Grad gr = score_grad(a, bias_h, b, row, col, sc[r][c],
                                   dp[r][c], lse_r[r], del_r[r]);
        if (dbias_h) dbias_h[(size_t)row * s + col] = gr.ds;
        p_s[(ty * 4 + r) * PS + tx + 16 * c] = round_as(gr.p_drop, tag);
        d_s[(ty * 4 + r) * PS + tx + 16 * c] = round_as(gr.ds, tag);
      }
    }
    __syncthreads();

    // dV_j += p~_ij dO_i and dK_j += dS_ij Q_i over the tile's rows i
#pragma unroll 2
    for (int i = 0; i < BQ; ++i) {
      float pv[R], sv[R];
      VecF<R>::load(p_s + i * PS + ty * R, pv);
      VecF<R>::load(d_s + i * PS + ty * R, sv);
#pragma unroll
      for (int g = 0; g < DG; ++g) {
        const float4 ov = ld4(o_s + i * LD + g * 64 + tx * 4);
        const float4 qv = ld4(q_s + i * LD + g * 64 + tx * 4);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          dv[r][g][0] = fmaf(pv[r], ov.x, dv[r][g][0]);
          dv[r][g][1] = fmaf(pv[r], ov.y, dv[r][g][1]);
          dv[r][g][2] = fmaf(pv[r], ov.z, dv[r][g][2]);
          dv[r][g][3] = fmaf(pv[r], ov.w, dv[r][g][3]);
          dk[r][g][0] = fmaf(sv[r], qv.x, dk[r][g][0]);
          dk[r][g][1] = fmaf(sv[r], qv.y, dk[r][g][1]);
          dk[r][g][2] = fmaf(sv[r], qv.z, dk[r][g][2]);
          dk[r][g][3] = fmaf(sv[r], qv.w, dk[r][g][3]);
        }
      }
    }
  }

  // dV rows straight out; dK^T through a transposed staging tile, so its
  // (hd, s) rows are written along s
  T* dvh = static_cast<T*>(a.dv) + head;
  T* dkh = static_cast<T*>(a.dkT) + head;
  __syncthreads();   // everyone is done with q_s: it becomes the staging tile
  float* kt_s = q_s;   // [HDP][KTS]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = ty * R + r;
#pragma unroll
    for (int g = 0; g < DG; ++g) {
      const int d = g * 64 + tx * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) kt_s[(d + c) * KTS + j] = dk[r][g][c] * a.scale;
      if (d < hd) {   // hd % 8 == 0: a 4-column group is all in or all out
#pragma unroll
        for (int c = 0; c < 4; ++c)
          store_as(dv[r][g][c], dvh + (size_t)(k0 + j) * hd + d + c);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < hd * BK; i += NT) {
    const int d = i / BK, j = i - d * BK;
    store_as(kt_s[d * KTS + j], dkh + (size_t)d * s + k0 + j);
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (b, Q tile), looping over the K tiles
// ---------------------------------------------------------------------------

template <typename T, int HDP, int BK>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(const BwdArgs a) {
  constexpr int LD = HDP + 4;
  constexpr int CPT = BK / 16;   // score columns per thread
  constexpr int DG = HDP / 64;   // 4-column groups of hd per thread
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [BQ][LD]  Q tile
  float* o_s = q_s + BQ * LD;                     // [BQ][LD]  dO tile
  float* k_s = o_s + BQ * LD;                     // [BK][LD]  K tile
  float* v_s = k_s + BK * LD;                     // [BK][LD]  V tile
  float* st_s = v_s + BK * LD;                    // [BK][QS]  dS^T (rounded)

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int s = a.s, hd = a.hd;
  const int nq = s / BQ;
  // causal: the bottom tiles have the most K steps; start them first
  const int qi = a.causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int b = blockIdx.x;
  const int q0 = qi * BQ;
  const size_t head = (size_t)b * s * hd;
  const T* kh = static_cast<const T*>(a.kT) + head;
  const T* vh = static_cast<const T*>(a.v) + head;
  const float* bias_h = a.bias ? a.bias + (size_t)b * a.bias_stride : nullptr;

  stage_rows<T, HDP, BQ>(q_s, static_cast<const T*>(a.q) + head +
                                  (size_t)q0 * hd, hd);
  stage_rows<T, HDP, BQ>(o_s, static_cast<const T*>(a.dout) + head +
                                  (size_t)q0 * hd, hd);
  float lse_r[4], del_r[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    lse_r[r] = a.lse[(size_t)b * s + q0 + ty * 4 + r];
    del_r[r] = a.delta[(size_t)b * s + q0 + ty * 4 + r];
  }

  float acc[4][DG][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int g = 0; g < DG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][g][c] = 0.f;

  const T* tag = nullptr;
  // a K tile is visited iff its first column is <= the tile's last row
  const int kend = a.causal ? q0 + BQ : s;
  const int ntiles = (kend + BK - 1) / BK;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();   // the previous step is done with k_s, v_s, st_s
    stage_cols<T, HDP, BK>(k_s, kh + k0, hd, s);
    stage_rows<T, HDP, BK>(v_s, vh + (size_t)k0 * hd, hd);
    __syncthreads();

    float sc[4][CPT], dp[4][CPT];
    two_products<HDP, CPT>(q_s, k_s, o_s, v_s, hd, ty, tx, sc, dp);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = k0 + tx + 16 * c;
      float ds[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = q0 + ty * 4 + r;
        ds[r] = round_as(score_grad(a, bias_h, b, row, col, sc[r][c],
                                    dp[r][c], lse_r[r], del_r[r]).ds, tag);
      }
      *reinterpret_cast<float4*>(st_s + (tx + 16 * c) * QS + ty * 4) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

    // dQ_i += dS_ij K_j over the tile's columns j
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      const float4 s4 = ld4(st_s + j * QS + ty * 4);
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int g = 0; g < DG; ++g) {
        const float4 kv = ld4(k_s + j * LD + g * 64 + tx * 4);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][g][0] = fmaf(sv[r], kv.x, acc[r][g][0]);
          acc[r][g][1] = fmaf(sv[r], kv.y, acc[r][g][1]);
          acc[r][g][2] = fmaf(sv[r], kv.z, acc[r][g][2]);
          acc[r][g][3] = fmaf(sv[r], kv.w, acc[r][g][3]);
        }
      }
    }
  }

  T* dqh = static_cast<T*>(a.dq) + head;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty * 4 + r;
#pragma unroll
    for (int g = 0; g < DG; ++g) {
      const int d = g * 64 + tx * 4;
      if (d < hd) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          store_as(acc[r][g][c] * a.scale, dqh + (size_t)row * hd + d + c);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int HDP, int BK>
constexpr size_t dkv_smem() {
  return (size_t)(2 * BQ * (HDP + 4) + 2 * BK * (HDP + 4) + 2 * BQ * (BK + 4)) *
         sizeof(float);
}

template <int HDP, int BK>
constexpr size_t dq_smem() {
  return (size_t)(2 * BQ * (HDP + 4) + 2 * BK * (HDP + 4) + BK * QS) *
         sizeof(float);
}

template <typename K>
static int launch(K kern, size_t smem, dim3 grid, const BwdArgs& a,
                  cudaStream_t stream) {
  if (smem > 48 * 1024) {
    // above 48 KB only as dynamic shared memory, after the opt-in; set on
    // every launch, since the attribute is held per device
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int HDP, int BK>
static int launch_pair(int which, int bh, const BwdArgs& a, cudaStream_t st) {
  if (which == 0)
    return launch(flash_bwd_dkv_kernel<T, HDP, BK>, dkv_smem<HDP, BK>(),
                  dim3(bh, a.s / BK), a, st);
  return launch(flash_bwd_dq_kernel<T, HDP, BK>, dq_smem<HDP, BK>(),
                dim3(bh, a.s / BQ), a, st);
}

// 64-column K tiles fit shared memory up to hd = 128; 32 columns serve
// every hd up to 256 (kernels/attention.bwd_configs mirrors this)
template <typename T>
static int launch_hd(int which, int hdp, int bk, int bh, const BwdArgs& a,
                     cudaStream_t st) {
  if (bk == 64) {
    switch (hdp) {
      case 64: return launch_pair<T, 64, 64>(which, bh, a, st);
      case 128: return launch_pair<T, 128, 64>(which, bh, a, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (bk == 32) {
    switch (hdp) {
      case 64: return launch_pair<T, 64, 32>(which, bh, a, st);
      case 128: return launch_pair<T, 128, 32>(which, bh, a, st);
      case 192: return launch_pair<T, 192, 32>(which, bh, a, st);
      case 256: return launch_pair<T, 256, 32>(which, bh, a, st);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

static int run(int which, BwdArgs& a, int bh, int type, int bk,
               void* stream) {
  const int s = a.s, hd = a.hd;
  if (bk <= 0 || s <= 0 || s % BQ || s % bk || s / bk > 65535 || hd <= 0 ||
      hd % 8 || hd > 256 || bh <= 0)
    return cudaErrorInvalidValue;
  const int hdp = (hd + 63) / 64 * 64;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (type == T_F32) return launch_hd<float>(which, hdp, bk, bh, a, st);
  if (type == T_BF16)
    return launch_hd<__nv_bfloat16>(which, hdp, bk, bh, a, st);
  return cudaErrorInvalidValue;
}

extern "C" {

const char* xsmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, v, dout: (bh, s, hd); kT: (bh, hd, s); lse, delta: f32 (bh, s); bias:
// f32 (s, s) per head at bias + b * bias_stride, or null; dkT: (bh, hd, s);
// dv: (bh, s, hd); dbias: f32 (bh, s, s) or null. s % 64 == 0, s % bk == 0,
// hd % 8 == 0, hd <= 256; bk in {32, 64} (64 only for hd <= 128).
int xsmm_flash_bwd_dkv(const void* q, const void* kT, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       const float* bias, long long bias_stride, void* dkT,
                       void* dv, float* dbias, int bh, int s, int hd, int type,
                       int bk, float scale, int causal, int dropout,
                       unsigned seed, unsigned thr, float inv_keep,
                       void* stream) {
  BwdArgs a{q, kT, v, dout, lse, delta, bias, bias_stride, nullptr, dkT, dv,
            dbias, s, hd, scale, causal, dropout, seed, thr, inv_keep};
  return run(0, a, bh, type, bk, stream);
}

// the same operands; dq: (bh, s, hd)
int xsmm_flash_bwd_dq(const void* q, const void* kT, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const float* bias, long long bias_stride, void* dq,
                      int bh, int s, int hd, int type, int bk, float scale,
                      int causal, int dropout, unsigned seed, unsigned thr,
                      float inv_keep, void* stream) {
  BwdArgs a{q, kT, v, dout, lse, delta, bias, bias_stride, dq, nullptr,
            nullptr, nullptr, s, hd, scale, causal, dropout, seed, thr,
            inv_keep};
  return run(1, a, bh, type, bk, stream);
}

}  // extern "C"
