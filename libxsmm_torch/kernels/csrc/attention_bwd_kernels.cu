// Hand-written Hopper (sm_90a) flash-attention backward for libxsmm_torch:
// two kernels, as the reference splits it, each in two forms by operand
// type (kernels/attention.py flash_bwd_path). Replaces the Pallas TPU
// kernels of build_flash_attention_bwd
// (libxsmm_tpu/kernels/attention_pallas.py:322):
//   dK^T, dV (+ dbias) <- dkv_kernel (:387): flash_bwd_dkv_mma_kernel (bf16),
//                                            flash_bwd_dkv_kernel (f32)
//   dQ                 <- dq_kernel  (:485): flash_bwd_dq_mma_kernel (bf16),
//                                            flash_bwd_dq_kernel (f32)
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
//   dropout: keep = rand_bits(seed, hb, i, j) >= thr, hb = b under the
//            head map (HeadMap); p~ = keep ? p/(1-p_drop) : 0 and
//            dp = keep ? dp/(1-p_drop) : 0; without dropout p~ = p
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
// cores).
//
// Design. Hopper blocks run in no order, so the TPU's sequential inner grid
// axis becomes a loop inside the block, and each output tile has exactly
// one writer: no atomics, results identical run to run.
//   dK/dV: one block owns one (b, BK-column K tile). K and V stay in shared
//   memory; the block walks the 64-row Q tiles (from the first that reaches
//   the diagonal when causal), and keeps both BK x hd accumulators in
//   registers.
//   dQ: one block owns one (b, 64-row Q tile); Q and dO stay in shared
//   memory; the block walks the K tiles up to the diagonal when causal.
//
// bf16, on the tensor cores (the FlashAttention-2 backward on mma.sync
// m16n8k16, f32 accumulators; kernels/csrc/xsmm_mma.cuh). Four warps a
// block; hd is zero-padded to the forward's buckets (32 ... 256, exact);
// tiles arrive in bf16 through a two-stage cp.async ring, every row padded
// by 16 bytes so ldmatrix's rows fall in distinct banks; the softmax is
// taken in log2 units (one exp2 per element), as the forward's.
//   dK/dV computes the transposed scores directly: warp w owns 16 keys and,
//   when BK = 32, half of hd's columns of dK and dV (the two warps of a key
//   group recompute the same scores; past hd = 128 that keeps the two
//   accumulators within the register file). S^T = K Q^T takes K from the
//   (hd x keys) K^T tile by ldmatrix.trans and Q^T from row-major Q by
//   ldmatrix; dP^T = V dO^T likewise. P~^T and dS^T are born as C fragments
//   (row: key, column: query, so the dropout hash takes (column, row)),
//   rounded by RNE to bf16 in registers and fed as A fragments to
//   dV += P~^T dO and dK += dS^T Q, with dO and Q read by ldmatrix.trans:
//   no shared-memory round trip. dK^T goes out through shared memory, so
//   its (hd, s) rows are written in 16-byte units.
//   dQ: warp w owns 16 query rows. S = Q K (K^T tiles by ldmatrix.trans),
//   dP = dO V^T (V by ldmatrix), dS = P (dP - delta) as A fragments, and
//   dQ += dS K with K read from the K^T tile by a plain ldmatrix.
//
// f32, on the CUDA cores' FMAs (67 TFLOP/s: floors of 1.03 and 0.77 ms at
// the bench shape; f32 means f32, no TF32). Every tile is staged row-major
// in f32 at a row stride of hd + 4 floats. In the S and dP products thread
// (ty, tx) of a 16 x 16 grid owns score rows 4ty..4ty+3 and columns
// tx + 16c, and reads four consecutive hd entries of each operand row with
// one 16-byte load (a quarter warp covers all 32 banks). The p~ and dS
// tiles go through shared memory to the accumulating products, where each
// thread owns a few output rows and four consecutive columns in each
// 64-wide group of hd. Nothing of the (s, s) panels reaches device memory
// except dbias when it is asked for.

#include <cuda_runtime.h>

#include "xsmm_common.cuh"
#include "xsmm_mma.cuh"
#include "xsmm_launches.cuh"

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
  HeadMap hm;           // the hash's head map (xsmm_common.cuh)
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows [0, ROWS) of a row-major (., hd) array into dst[ROWS][HDP + 4];
// columns hd..HDP-1 are zero
template <int HDP, int ROWS>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int hd) {
  constexpr int LD = HDP + 4;
  for (int i = threadIdx.x; i < ROWS * HDP; i += NT) {
    const int r = i / HDP, d = i - r * HDP;
    dst[r * LD + d] = d < hd ? src[(size_t)r * hd + d] : 0.f;
  }
}

// columns [0, COLS) of a (hd, s) array (kT, pre-offset to the tile) into
// dst[COLS][HDP + 4], transposed: dst[j][d] = src[d][j]
template <int HDP, int COLS>
__device__ __forceinline__ void stage_cols(float* dst, const float* src,
                                           int hd, int s) {
  constexpr int LD = HDP + 4;
  for (int i = threadIdx.x; i < HDP * COLS; i += NT) {
    const int d = i / COLS, j = i - d * COLS;
    dst[j * LD + d] = d < hd ? src[(size_t)d * s + j] : 0.f;
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
                                           uint32_t hb, int row, int col,
                                           float sc, float dp, float lse,
                                           float delta) {
  float x = sc * a.scale;
  if (bias_h) x += bias_h[(size_t)row * a.s + col];
  const float p = (a.causal && col > row) ? 0.f : expf(x - lse);
  float p_drop = p;
  if (a.dropout) {
    const bool keep = rand_bits(a.seed, hb, (uint32_t)row,
                                (uint32_t)col) >= a.thr;
    p_drop = keep ? p * a.inv_keep : 0.f;
    dp = keep ? dp * a.inv_keep : 0.f;
  }
  return {p_drop, p * (dp - delta)};
}

// ---------------------------------------------------------------------------
// dK^T, dV (+ dbias): one block per (b, K tile), looping over the Q tiles
// ---------------------------------------------------------------------------

template <int HDP, int BK>
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
  float* p_s = v_s + BK * LD;                     // [BQ][PS]  p~
  float* d_s = p_s + BQ * PS;                     // [BQ][PS]  dS

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int s = a.s, hd = a.hd;
  const int b = blockIdx.x;
  const uint32_t hb = a.hm(b);    // the hash's batch-head
  const int k0 = blockIdx.y * BK;   // causal: the first tiles have most work
  const size_t head = (size_t)b * s * hd;
  const float* qh = static_cast<const float*>(a.q) + head;
  const float* oh = static_cast<const float*>(a.dout) + head;
  const float* kh = static_cast<const float*>(a.kT) + head;
  const float* vh = static_cast<const float*>(a.v) + head;
  const float* bias_h = a.bias ? a.bias + (size_t)b * a.bias_stride : nullptr;
  float* dbias_h = a.dbias ? a.dbias + (size_t)b * s * s : nullptr;

  stage_cols<HDP, BK>(k_s, kh + k0, hd, s);
  stage_rows<HDP, BK>(v_s, vh + (size_t)k0 * hd, hd);

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

  for (int qi = qstart; qi < s / BQ; ++qi) {
    const int q0 = qi * BQ;
    __syncthreads();   // the previous step is done with q_s, o_s, p_s, d_s
    stage_rows<HDP, BQ>(q_s, qh + (size_t)q0 * hd, hd);
    stage_rows<HDP, BQ>(o_s, oh + (size_t)q0 * hd, hd);
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
        const Grad gr = score_grad(a, bias_h, hb, row, col, sc[r][c],
                                   dp[r][c], lse_r[r], del_r[r]);
        if (dbias_h) dbias_h[(size_t)row * s + col] = gr.ds;
        p_s[(ty * 4 + r) * PS + tx + 16 * c] = gr.p_drop;
        d_s[(ty * 4 + r) * PS + tx + 16 * c] = gr.ds;
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
  float* dvh = static_cast<float*>(a.dv) + head;
  float* dkh = static_cast<float*>(a.dkT) + head;
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

template <int HDP, int BK>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(const BwdArgs a) {
  constexpr int LD = HDP + 4;
  constexpr int CPT = BK / 16;   // score columns per thread
  constexpr int DG = HDP / 64;   // 4-column groups of hd per thread
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [BQ][LD]  Q tile
  float* o_s = q_s + BQ * LD;                     // [BQ][LD]  dO tile
  float* k_s = o_s + BQ * LD;                     // [BK][LD]  K tile
  float* v_s = k_s + BK * LD;                     // [BK][LD]  V tile
  float* st_s = v_s + BK * LD;                    // [BK][QS]  dS^T

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int s = a.s, hd = a.hd;
  const int nq = s / BQ;
  // causal: the bottom tiles have the most K steps; start them first
  const int qi = a.causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int b = blockIdx.x;
  const uint32_t hb = a.hm(b);    // the hash's batch-head
  const int q0 = qi * BQ;
  const size_t head = (size_t)b * s * hd;
  const float* kh = static_cast<const float*>(a.kT) + head;
  const float* vh = static_cast<const float*>(a.v) + head;
  const float* bias_h = a.bias ? a.bias + (size_t)b * a.bias_stride : nullptr;

  stage_rows<HDP, BQ>(q_s, static_cast<const float*>(a.q) + head +
                               (size_t)q0 * hd, hd);
  stage_rows<HDP, BQ>(o_s, static_cast<const float*>(a.dout) + head +
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

  // a K tile is visited iff its first column is <= the tile's last row
  const int kend = a.causal ? q0 + BQ : s;
  const int ntiles = (kend + BK - 1) / BK;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();   // the previous step is done with k_s, v_s, st_s
    stage_cols<HDP, BK>(k_s, kh + k0, hd, s);
    stage_rows<HDP, BK>(v_s, vh + (size_t)k0 * hd, hd);
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
        ds[r] = score_grad(a, bias_h, hb, row, col, sc[r][c], dp[r][c],
                           lse_r[r], del_r[r]).ds;
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

  float* dqh = static_cast<float*>(a.dq) + head;
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
// bf16 on the tensor cores. HDP: hd padded to a multiple of 16 (a bucket of
// kernels/attention.py _MMA_HDP); BK: key columns per K tile.
// ---------------------------------------------------------------------------

constexpr int MB_THREADS = 128;   // four warps
constexpr float LOG2E = 1.4426950408889634f;

// shared memory of the dK/dV kernel: the K^T tile (hdp x bk) and the V tile
// (bk x hdp) once, two Q and two dO tiles (BQ x hdp), bf16, every row
// padded by 16 bytes; two lse and two delta rows (BQ) in f32
__host__ __device__ constexpr int dkv_mma_smem(int hdp, int bk) {
  return (hdp * (bk + 8) + bk * (hdp + 8) + 4 * BQ * (hdp + 8)) * 2 +
         4 * BQ * 4;
}

// shared memory of the dQ kernel: the Q and dO tiles (BQ x hdp) once, two
// K^T tiles (hdp x bk) and two V tiles (bk x hdp), bf16, rows padded
__host__ __device__ constexpr int dq_mma_smem(int hdp, int bk) {
  return (2 * BQ * (hdp + 8) + 2 * hdp * (bk + 8) + 2 * bk * (hdp + 8)) * 2;
}

// ROWS rows of a row-major (., hd) bf16 array into dst[ROWS][HDP + 8];
// columns hd..HDP-1 arrive as zero fill
template <int HDP, int ROWS>
__device__ __forceinline__ void cp_rows(__nv_bfloat16* dst,
                                        const __nv_bfloat16* src, int hd) {
  constexpr int DU = HDP / 8, LD = HDP + 8;
  for (int i = threadIdx.x; i < ROWS * DU; i += MB_THREADS) {
    const int r = i / DU, d = (i - r * DU) * 8;
    const bool ok = d < hd;
    cp_async16(dst + r * LD + d, ok ? src + (size_t)r * hd + d : src, ok);
  }
}

// columns [0, COLS) of the (hd, s) array kT (pre-offset to the tile) into
// dst[HDP][COLS + 8], as they lie; rows hd..HDP-1 arrive as zero fill
template <int HDP, int COLS>
__device__ __forceinline__ void cp_kt(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, int hd,
                                      int s) {
  constexpr int KU = COLS / 8, LD = COLS + 8;
  for (int i = threadIdx.x; i < HDP * KU; i += MB_THREADS) {
    const int d = i / KU, c = (i - d * KU) * 8;
    const bool ok = d < hd;
    cp_async16(dst + d * LD + c, ok ? src + (size_t)d * s + c : src, ok);
  }
}

// ldmatrix lane addresses, lane = l (PTX ISA fragment layouts):
//   A (16 x 16) from a row-major [m][k] tile:   (m0 + (l & 15), k0 + (l >> 4) 8)
//   A from a [k][m] tile, .trans:               (k0 + (l & 7) + (l & 16) / 2, m0 + (l & 8))
//   B, two n8 tiles, from an [n][k] tile:       (n0 + (l & 7) + (l & 16) / 2, k0 + (l & 8))
//   B, two n8 tiles, from a [k][n] tile, .trans: (k0 + (l & 7) + (l & 8), n0 + (l >> 4) 8)
__device__ __forceinline__ int a_row(int l) { return l & 15; }
__device__ __forceinline__ int a_col(int l) { return (l >> 4) * 8; }
__device__ __forceinline__ int nk_row(int l) { return (l & 7) + ((l & 16) >> 1); }
__device__ __forceinline__ int nk_col(int l) { return l & 8; }
__device__ __forceinline__ int kn_row(int l) { return (l & 7) + (l & 8); }
__device__ __forceinline__ int kn_col(int l) { return (l >> 4) * 8; }

// p~ and ds of one score element from its raw dot products (sc = q . k,
// dp = dout . v), in log2 units: lse2 = lse_i log2(e)
__device__ __forceinline__ void grad_mma(const BwdArgs& a, const float* bias_h,
                                         uint32_t hb, int row, int col,
                                         float sc, float dp, float lse2,
                                         float delta, float& p_drop,
                                         float& ds) {
  const float x = bias_h ? (sc * a.scale + bias_h[(size_t)row * a.s + col]) *
                               LOG2E
                         : sc * (a.scale * LOG2E);
  const float p = (a.causal && col > row) ? 0.f : exp2f(x - lse2);
  p_drop = p;
  if (a.dropout) {
    const bool keep = rand_bits(a.seed, hb, (uint32_t)row,
                                (uint32_t)col) >= a.thr;
    p_drop = keep ? p * a.inv_keep : 0.f;
    dp = keep ? dp * a.inv_keep : 0.f;
  }
  ds = p * (dp - delta);
}

// ---------------------------------------------------------------------------
// dK^T, dV (+ dbias) on the tensor cores: one block per (b, K tile)
//
// Warp w owns keys k0 + 16 (w % KG) .. +16 and dK/dV columns DW (w / KG) ..
// + DW. Each Q tile is taken in sub-tiles of QW queries, so the S^T and
// dP^T fragments of a sub-tile (QW / 2 registers each) sit beside the
// accumulators (DW registers in all).
// ---------------------------------------------------------------------------

template <int HDP, int BK>
__global__ void __launch_bounds__(MB_THREADS) flash_bwd_dkv_mma_kernel(
    const BwdArgs a) {
  constexpr int LDH = HDP + 8, LDK = BK + 8;
  constexpr int KG = BK / 16;          // key groups of 16
  constexpr int DW = HDP * KG / 4;     // dK/dV columns per warp
  constexpr int DT = DW / 8;           // their n8 tiles
  constexpr int QW = DW >= 128 ? 32 : 64;   // queries per sub-tile
  constexpr int QT = QW / 8;           // n8 tiles of S^T
  static_assert(4 % KG == 0 && DW % 16 == 0 && BQ % QW == 0, "tiling");
  extern __shared__ __align__(16) unsigned char mb_smem[];
  __nv_bfloat16* kts = reinterpret_cast<__nv_bfloat16*>(mb_smem);  // [HDP][LDK]
  __nv_bfloat16* vs = kts + HDP * LDK;                             // [BK][LDH]
  __nv_bfloat16* qs = vs + BK * LDH;                               // [2][BQ][LDH]
  __nv_bfloat16* os = qs + 2 * BQ * LDH;                           // [2][BQ][LDH]
  float* ls = reinterpret_cast<float*>(os + 2 * BQ * LDH);         // [2][BQ]
  float* dls = ls + 2 * BQ;                                        // [2][BQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int kw = (warp % KG) * 16;     // this warp's first key in the tile
  const int cw = (warp / KG) * DW;     // and its first dK/dV column
  const int s = a.s, hd = a.hd;
  const int b = blockIdx.x;
  const uint32_t hb = a.hm(b);    // the hash's batch-head
  const int k0 = blockIdx.y * BK;      // causal: the first tiles have most work
  const size_t head = (size_t)b * s * hd;
  const __nv_bfloat16* qh = static_cast<const __nv_bfloat16*>(a.q) + head;
  const __nv_bfloat16* oh = static_cast<const __nv_bfloat16*>(a.dout) + head;
  const __nv_bfloat16* kh = static_cast<const __nv_bfloat16*>(a.kT) + head;
  const __nv_bfloat16* vh = static_cast<const __nv_bfloat16*>(a.v) + head;
  const float* lse_h = a.lse + (size_t)b * s;
  const float* del_h = a.delta + (size_t)b * s;
  const float* bias_h = a.bias ? a.bias + (size_t)b * a.bias_stride : nullptr;
  float* dbias_h = a.dbias ? a.dbias + (size_t)b * s * s : nullptr;

  // Q tiles entirely above this K tile's diagonal contribute nothing; their
  // dbias blocks are zero (attention_pallas.py:425-432)
  const int nq = s / BQ;
  const int qstart = a.causal ? k0 / BQ : 0;
  if (dbias_h) {
    for (int i = tid; i < qstart * BQ * BK; i += MB_THREADS) {
      const int r = i / BK, c = i - r * BK;
      dbias_h[(size_t)r * s + k0 + c] = 0.f;
    }
  }

  auto stage_q = [&](int qi) {
    const int q0 = qi * BQ, buf = qi & 1;
    cp_rows<HDP, BQ>(qs + buf * BQ * LDH, qh + (size_t)q0 * hd, hd);
    cp_rows<HDP, BQ>(os + buf * BQ * LDH, oh + (size_t)q0 * hd, hd);
    for (int i = tid; i < BQ / 2; i += MB_THREADS) {   // 4 floats a unit
      const int c = (i % (BQ / 4)) * 4;
      if (i < BQ / 4)
        cp_async16(ls + buf * BQ + c, lse_h + q0 + c, true);
      else
        cp_async16(dls + buf * BQ + c, del_h + q0 + c, true);
    }
  };
  // group 0: K^T, V and the first Q tile
  cp_kt<HDP, BK>(kts, kh + k0, hd, s);
  cp_rows<HDP, BK>(vs, vh + (size_t)k0 * hd, hd);
  if (qstart < nq) stage_q(qstart);
  cp_async_commit();

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int qi = qstart; qi < nq; ++qi) {
    cp_async_wait<0>();    // tile qi has landed ...
    __syncthreads();       // ... for every thread, and tile qi - 1's
                           // buffers are free
    if (qi + 1 < nq) stage_q(qi + 1);
    cp_async_commit();
    const int buf = qi & 1;
    const __nv_bfloat16* qb = qs + buf * BQ * LDH;
    const __nv_bfloat16* ob = os + buf * BQ * LDH;
    const float* lb = ls + buf * BQ;
    const float* db = dls + buf * BQ;

#pragma unroll 1
    for (int q1 = 0; q1 < BQ; q1 += QW) {
      const int q0 = qi * BQ;
      // a sub-tile wholly above this warp's diagonal adds nothing (its
      // dbias, when asked for, is written as the zeros it computes)
      if (a.causal && !dbias_h && q0 + q1 + QW - 1 < k0 + kw) continue;
      // S^T = K Q^T and dP^T = V dO^T over hd: 16 keys x QW queries
      float st[QT][4], dpt[QT][4];
#pragma unroll
      for (int j = 0; j < QT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HDP; kk += 16) {
        uint32_t ka[4], va[4];
        ldsm_x4_trans(ka, kts + (kk + nk_row(lane)) * LDK + kw + nk_col(lane));
        ldsm_x4(va, vs + (kw + a_row(lane)) * LDH + kk + a_col(lane));
#pragma unroll
        for (int p = 0; p < QT / 2; ++p) {
          uint32_t qf[4], of[4];
          const int off = (q1 + p * 16 + nk_row(lane)) * LDH + kk + nk_col(lane);
          ldsm_x4(qf, qb + off);
          ldsm_x4(of, ob + off);
          mma_bf16(st[2 * p], ka, qf[0], qf[1]);
          mma_bf16(st[2 * p + 1], ka, qf[2], qf[3]);
          mma_bf16(dpt[2 * p], va, of[0], of[1]);
          mma_bf16(dpt[2 * p + 1], va, of[2], of[3]);
        }
      }

      // p~^T and dS^T: element (key row, query column), packed to bf16
      // pairs as the A fragments of the accumulating products
      uint32_t pf[QT][2], sf[QT][2];
#pragma unroll
      for (int j = 0; j < QT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int key = k0 + kw + g + h * 8;
          float pd[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qc = q1 + j * 8 + t4 * 2 + e;   // query in the tile
            grad_mma(a, bias_h, hb, q0 + qc, key, st[j][2 * h + e],
                     dpt[j][2 * h + e], lb[qc] * LOG2E, db[qc], pd[e], ds[e]);
            if (dbias_h) dbias_h[(size_t)(q0 + qc) * s + key] = ds[e];
          }
          pf[j][h] = pack_bf16x2(pd[0], pd[1]);
          sf[j][h] = pack_bf16x2(ds[0], ds[1]);
        }

      // dV += p~^T dO and dK += dS^T Q over the sub-tile's queries
#pragma unroll
      for (int kk = 0; kk < QW / 16; ++kk) {
        const uint32_t pa[4] = {pf[2 * kk][0], pf[2 * kk][1],
                                pf[2 * kk + 1][0], pf[2 * kk + 1][1]};
        const uint32_t sa[4] = {sf[2 * kk][0], sf[2 * kk][1],
                                sf[2 * kk + 1][0], sf[2 * kk + 1][1]};
#pragma unroll
        for (int p = 0; p < DT / 2; ++p) {
          uint32_t of[4], qf[4];
          const int off = (q1 + kk * 16 + kn_row(lane)) * LDH + cw + p * 16 +
                          kn_col(lane);
          ldsm_x4_trans(of, ob + off);
          ldsm_x4_trans(qf, qb + off);
          mma_bf16(dv[2 * p], pa, of[0], of[1]);
          mma_bf16(dv[2 * p + 1], pa, of[2], of[3]);
          mma_bf16(dk[2 * p], sa, qf[0], qf[1]);
          mma_bf16(dk[2 * p + 1], sa, qf[2], qf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the Q ring: it becomes the
                     // dK^T staging tile [HDP][LDK]

  // dV rows straight out; dK^T scaled and rounded once into shared memory,
  // then written along s in 16-byte units
  __nv_bfloat16* dvh = static_cast<__nv_bfloat16*>(a.dv) + head;
  __nv_bfloat16* dkh = static_cast<__nv_bfloat16*>(a.dkT) + head;
  __nv_bfloat16* kst = qs;
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kl = kw + g + h * 8;
      const int d = cw + j * 8 + t4 * 2;
      if (d < hd)   // hd % 8 == 0: the pair is all in or all out
        store_pair(dvh + (size_t)(k0 + kl) * hd + d, dv[j][2 * h],
                   dv[j][2 * h + 1]);
      kst[d * LDK + kl] = __float2bfloat16(dk[j][2 * h] * a.scale);
      kst[(d + 1) * LDK + kl] = __float2bfloat16(dk[j][2 * h + 1] * a.scale);
    }
  __syncthreads();
  constexpr int KU = BK / 8;
  for (int i = tid; i < hd * KU; i += MB_THREADS) {
    const int d = i / KU, c = (i - d * KU) * 8;
    *reinterpret_cast<uint4*>(dkh + (size_t)d * s + k0 + c) =
        *reinterpret_cast<const uint4*>(kst + d * LDK + c);
  }
}

// ---------------------------------------------------------------------------
// dQ on the tensor cores: one block per (b, Q tile); warp w owns query rows
// q0 + 16 w .. +16
// ---------------------------------------------------------------------------

template <int HDP, int BK>
__global__ void __launch_bounds__(MB_THREADS) flash_bwd_dq_mma_kernel(
    const BwdArgs a) {
  constexpr int LDH = HDP + 8, LDK = BK + 8;
  constexpr int KT = BK / 8;           // n8 tiles of S (keys)
  constexpr int DT = HDP / 8;          // n8 tiles of dQ
  extern __shared__ __align__(16) unsigned char mb_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(mb_smem);  // [BQ][LDH]
  __nv_bfloat16* os = qs + BQ * LDH;                               // [BQ][LDH]
  __nv_bfloat16* kts = os + BQ * LDH;                              // [2][HDP][LDK]
  __nv_bfloat16* vs = kts + 2 * HDP * LDK;                         // [2][BK][LDH]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int s = a.s, hd = a.hd;
  const int nq = s / BQ;
  // causal: the bottom tiles have the most K steps; start them first
  const int qi = a.causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int b = blockIdx.x;
  const uint32_t hb = a.hm(b);    // the hash's batch-head
  const int q0 = qi * BQ;
  const int wrow = q0 + warp * 16;     // this warp's first row
  const size_t head = (size_t)b * s * hd;
  const __nv_bfloat16* kh = static_cast<const __nv_bfloat16*>(a.kT) + head;
  const __nv_bfloat16* vh = static_cast<const __nv_bfloat16*>(a.v) + head;
  const float* bias_h = a.bias ? a.bias + (size_t)b * a.bias_stride : nullptr;

  auto stage_kv = [&](int t) {
    const int k0 = t * BK, buf = t & 1;
    cp_kt<HDP, BK>(kts + buf * HDP * LDK, kh + k0, hd, s);
    cp_rows<HDP, BK>(vs + buf * BK * LDH, vh + (size_t)k0 * hd, hd);
  };
  // group 0: Q, dO and K/V tile 0
  cp_rows<HDP, BQ>(qs, static_cast<const __nv_bfloat16*>(a.q) + head +
                           (size_t)q0 * hd, hd);
  cp_rows<HDP, BQ>(os, static_cast<const __nv_bfloat16*>(a.dout) + head +
                           (size_t)q0 * hd, hd);
  stage_kv(0);
  cp_async_commit();

  float lse2[2], del[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse2[h] = a.lse[(size_t)b * s + wrow + g + h * 8] * LOG2E;
    del[h] = a.delta[(size_t)b * s + wrow + g + h * 8];
  }
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // a K tile is visited iff its first column is <= the tile's last row
  const int ntiles = a.causal ? (q0 + BQ) / BK : s / BK;
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();    // tile t has landed ...
    __syncthreads();       // ... for every thread, and tile t - 1's buffers
                           // are free
    if (t + 1 < ntiles) stage_kv(t + 1);
    cp_async_commit();
    const int k0 = t * BK;
    if (a.causal && k0 > wrow + 15) continue;   // above this warp's diagonal
    const __nv_bfloat16* kb = kts + (t & 1) * HDP * LDK;
    const __nv_bfloat16* vb = vs + (t & 1) * BK * LDH;

    // S = Q K^T and dP = dO V^T over hd: 16 rows x BK keys
    float sc[KT][4], dp[KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HDP; kk += 16) {
      uint32_t qa[4], oa[4];
      const int aoff = (warp * 16 + a_row(lane)) * LDH + kk + a_col(lane);
      ldsm_x4(qa, qs + aoff);
      ldsm_x4(oa, os + aoff);
#pragma unroll
      for (int p = 0; p < KT / 2; ++p) {
        uint32_t kf[4], vf[4];
        ldsm_x4_trans(kf, kb + (kk + kn_row(lane)) * LDK + p * 16 +
                              kn_col(lane));
        ldsm_x4(vf, vb + (p * 16 + nk_row(lane)) * LDH + kk + nk_col(lane));
        mma_bf16(sc[2 * p], qa, kf[0], kf[1]);
        mma_bf16(sc[2 * p + 1], qa, kf[2], kf[3]);
        mma_bf16(dp[2 * p], oa, vf[0], vf[1]);
        mma_bf16(dp[2 * p + 1], oa, vf[2], vf[3]);
      }
    }

    // dS, packed to bf16 pairs as the A fragments of dQ += dS K
    uint32_t sf[KT][2];
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wrow + g + h * 8;
        float pd[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          grad_mma(a, bias_h, hb, row, k0 + j * 8 + t4 * 2 + e,
                   sc[j][2 * h + e], dp[j][2 * h + e], lse2[h], del[h],
                   pd[e], ds[e]);
        sf[j][h] = pack_bf16x2(ds[0], ds[1]);
      }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t sa[4] = {sf[2 * kk][0], sf[2 * kk][1],
                              sf[2 * kk + 1][0], sf[2 * kk + 1][1]};
#pragma unroll
      for (int p = 0; p < DT / 2; ++p) {
        uint32_t kf[4];
        ldsm_x4(kf, kb + (p * 16 + nk_row(lane)) * LDK + kk * 16 +
                        nk_col(lane));
        mma_bf16(acc[2 * p], sa, kf[0], kf[1]);
        mma_bf16(acc[2 * p + 1], sa, kf[2], kf[3]);
      }
    }
  }
  cp_async_wait<0>();

  __nv_bfloat16* dqh = static_cast<__nv_bfloat16*>(a.dq) + head;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wrow + g + h * 8;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int d = j * 8 + t4 * 2;   // hd % 8 == 0: the pair is all in or
      if (d < hd)                     // all out
        store_pair(dqh + (size_t)row * hd + d, acc[j][2 * h] * a.scale,
                   acc[j][2 * h + 1] * a.scale);
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
static int launch(K kern, size_t smem, dim3 grid, int threads,
                  const BwdArgs& a, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    // above 48 KB only as dynamic shared memory, after the opt-in; set on
    // every launch, since the attribute is held per device
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  note_launch(kern);
  kern<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HDP, int BK>
static int launch_pair(int which, int bh, const BwdArgs& a, cudaStream_t st) {
  if (which == 0)
    return launch(flash_bwd_dkv_kernel<HDP, BK>, dkv_smem<HDP, BK>(),
                  dim3(bh, a.s / BK), NT, a, st);
  return launch(flash_bwd_dq_kernel<HDP, BK>, dq_smem<HDP, BK>(),
                dim3(bh, a.s / BQ), NT, a, st);
}

// f32: 64-column K tiles fit shared memory up to hd = 128; 32 columns serve
// every hd up to 256 (kernels/attention.bwd_configs mirrors this)
static int launch_hd(int which, int hdp, int bk, int bh, const BwdArgs& a,
                     cudaStream_t st) {
  if (bk == 64) {
    switch (hdp) {
      case 64: return launch_pair<64, 64>(which, bh, a, st);
      case 128: return launch_pair<128, 64>(which, bh, a, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (bk == 32) {
    switch (hdp) {
      case 64: return launch_pair<64, 32>(which, bh, a, st);
      case 128: return launch_pair<128, 32>(which, bh, a, st);
      case 192: return launch_pair<192, 32>(which, bh, a, st);
      case 256: return launch_pair<256, 32>(which, bh, a, st);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

template <int HDP, int BK>
static int launch_mma_pair(int which, int bh, const BwdArgs& a,
                           cudaStream_t st) {
  if (which == 0)
    return launch(flash_bwd_dkv_mma_kernel<HDP, BK>, dkv_mma_smem(HDP, BK),
                  dim3(bh, a.s / BK), MB_THREADS, a, st);
  return launch(flash_bwd_dq_mma_kernel<HDP, BK>, dq_mma_smem(HDP, BK),
                dim3(bh, a.s / BQ), MB_THREADS, a, st);
}

// bf16: hd padded to the forward's buckets (kernels/attention.py _MMA_HDP);
// 64- and 32-column K tiles up to a padded 128, 32 past it, where the dK/dV
// kernel splits each key group's columns over two warps
// (kernels/attention.bwd_configs mirrors this)
static int launch_mma_hd(int which, int hd, int bk, int bh, const BwdArgs& a,
                         cudaStream_t st) {
  if (bk == 64) {
    if (hd <= 32) return launch_mma_pair<32, 64>(which, bh, a, st);
    if (hd <= 64) return launch_mma_pair<64, 64>(which, bh, a, st);
    if (hd <= 96) return launch_mma_pair<96, 64>(which, bh, a, st);
    if (hd <= 128) return launch_mma_pair<128, 64>(which, bh, a, st);
    return cudaErrorInvalidValue;
  }
  if (bk == 32) {
    if (hd <= 32) return launch_mma_pair<32, 32>(which, bh, a, st);
    if (hd <= 64) return launch_mma_pair<64, 32>(which, bh, a, st);
    if (hd <= 96) return launch_mma_pair<96, 32>(which, bh, a, st);
    if (hd <= 128) return launch_mma_pair<128, 32>(which, bh, a, st);
    if (hd <= 192) return launch_mma_pair<192, 32>(which, bh, a, st);
    return launch_mma_pair<256, 32>(which, bh, a, st);
  }
  return cudaErrorInvalidValue;
}

static int run(int which, BwdArgs& a, int bh, int type, int bk,
               void* stream) {
  const int s = a.s, hd = a.hd;
  if (bk <= 0 || s <= 0 || s % BQ || s % bk || s / bk > 65535 || hd <= 0 ||
      hd % 8 || hd > 256 || bh <= 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (type == T_F32)
    return launch_hd(which, (hd + 63) / 64 * 64, bk, bh, a, st);
  if (type == T_BF16) return launch_mma_hd(which, hd, bk, bh, a, st);
  return cudaErrorInvalidValue;
}

extern "C" {

const char* xsmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, v, dout: (bh, s, hd); kT: (bh, hd, s); lse, delta: f32 (bh, s); bias:
// f32 (s, s) per head at bias + b * bias_stride, or null; dkT: (bh, hd, s);
// dv: (bh, s, hd); dbias: f32 (bh, s, s) or null. s % 64 == 0, s % bk == 0,
// hd % 8 == 0, hd <= 256; bk in {32, 64} (64 only for hd <= 128). bf16 runs
// the tensor-core kernels (q, kT, v, dout, lse and delta 16-byte aligned),
// f32 the FMA ones. (b0, h0, nhl, nhg): the dropout hash's head map
// (HeadMap, xsmm_common.cuh); 0, 0, 1, 1 hashes the local batch-head.
int xsmm_flash_bwd_dkv(const void* q, const void* kT, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       const float* bias, long long bias_stride, void* dkT,
                       void* dv, float* dbias, int bh, int s, int hd, int type,
                       int bk, float scale, int causal, int dropout,
                       unsigned seed, unsigned thr, float inv_keep,
                       unsigned b0, unsigned h0, unsigned nhl, unsigned nhg,
                       void* stream) {
  if (nhl == 0 || nhg == 0) return cudaErrorInvalidValue;
  BwdArgs a{q, kT, v, dout, lse, delta, bias, bias_stride, nullptr, dkT, dv,
            dbias, s, hd, scale, causal, dropout, seed, thr, inv_keep,
            HeadMap{b0, h0, nhl, nhg}};
  return run(0, a, bh, type, bk, stream);
}

// the same operands; dq: (bh, s, hd)
int xsmm_flash_bwd_dq(const void* q, const void* kT, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const float* bias, long long bias_stride, void* dq,
                      int bh, int s, int hd, int type, int bk, float scale,
                      int causal, int dropout, unsigned seed, unsigned thr,
                      float inv_keep, unsigned b0, unsigned h0, unsigned nhl,
                      unsigned nhg, void* stream) {
  if (nhl == 0 || nhg == 0) return cudaErrorInvalidValue;
  BwdArgs a{q, kT, v, dout, lse, delta, bias, bias_stride, dq, nullptr,
            nullptr, nullptr, s, hd, scale, causal, dropout, seed, thr,
            inv_keep, HeadMap{b0, h0, nhl, nhg}};
  return run(1, a, bh, type, bk, stream);
}

}  // extern "C"
