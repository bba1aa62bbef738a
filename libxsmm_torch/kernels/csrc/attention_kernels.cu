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
// cores). Two kernels, by operand type (kernels/attention.py flash_path):
//
// flash_fwd_mma_kernel, bf16 (the FlashAttention-2 shape). One block of
// four warps takes one (b, 64-row Q tile); each warp owns 16 query rows. Q
// is staged once; K^T tiles (hd rows of BK contiguous key columns of kT)
// and V tiles (BK rows of hd) arrive in bf16 through a 2-stage cp.async
// ring, tile t+1's copies in flight while tile t is multiplied. S = Q K^T
// runs on the tensor cores (mma.sync m16n8k16, Q's fragments by ldmatrix,
// kept in registers up to hd = 128, K^T's by ldmatrix.trans) into f32
// register fragments; the online softmax works on those fragments in log2
// units (scores times log2(e): one exp2 per exponential), the row
// max and sum by shuffles within the quad of lanes that shares a row, m, l
// and the f32 O accumulator in registers. The dropped, rescaled
// exponentials are rounded to bf16 in registers (the reference's astype)
// and feed P V as the A operand with no trip through shared memory; V's
// fragments by ldmatrix.trans. hd is padded with zeros to a multiple of 16
// (exact); rows in shared memory are padded by 16 bytes so ldmatrix's rows
// fall in distinct banks.
//
// flash_fwd_kernel, f32: f32 FMAs on the CUDA cores (67 TFLOP/s, a 0.51 ms
// floor at the bench shape), so f32 inputs get full f32 (no TF32). The
// TPU kernel's (bq, 128) lane-broadcast scratch and its VMEM budget have no
// meaning here. One block of 256 threads takes one (b, 64-row Q tile) and
// loops over K tiles of BK columns, bounded at the diagonal when causal
// (both kernels; the reference visits every step and masks). The Q tile is
// staged once, transposed, in shared memory; each K^T tile and V tile is
// staged per step. Thread (ty, tx) of a 16 x 16 grid owns
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
#include "xsmm_mma.cuh"

enum { T_F32 = 0, T_BF16 = 1 };

constexpr int BQ = 64;        // query rows per block
constexpr int NT = 256;       // threads per block: a 16 x 16 grid
constexpr int QS = BQ + 4;    // row stride of Q^T and P^T in shared memory

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores. HDP: hd padded to a multiple of 16 (a bucket of
// kernels/attention.py _mma_hdp); BK: key columns per tile.
// ---------------------------------------------------------------------------

constexpr int MQ_THREADS = 128;   // four warps of 16 query rows: BQ rows
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__host__ __device__ constexpr int mma_smem_bytes(int hdp, int bk) {
  // Q (BQ x hdp), two K^T tiles (hdp x bk), two V tiles (bk x hdp), bf16,
  // every row padded by 16 bytes
  return (BQ * (hdp + 8) + 2 * hdp * (bk + 8) + 2 * bk * (hdp + 8)) * 2;
}

template <int HDP, int BK>
__global__ void __launch_bounds__(MQ_THREADS) flash_fwd_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kT,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    long long bias_stride, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int s, int hd, float scale, int causal,
    int dropout, uint32_t seed, uint32_t thr, float inv_keep) {
  constexpr int LDQ = HDP + 8, LDK = BK + 8;  // LDQ is also V's row stride
  constexpr int DT = HDP / 8;                 // n8 tiles of O
  constexpr int KT = BK / 8;                  // n8 tiles of S
  constexpr int DU = HDP / 8, KU = BK / 8;    // 16-byte units per row
  constexpr bool QREG = HDP <= 128;           // Q's fragments in registers
  extern __shared__ __align__(16) unsigned char mq_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(mq_smem);
  __nv_bfloat16* ks = qs + BQ * LDQ;          // [2][HDP][LDK]
  __nv_bfloat16* vs = ks + 2 * HDP * LDK;     // [2][BK][LDQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int nq = s / BQ;
  // causal: the tiles nearest the bottom have the most K steps; start them
  // first so the short ones fill in behind
  const int qi = causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int b = blockIdx.x;
  const int q0 = qi * BQ;
  const int wrow = q0 + warp * 16;            // this warp's first row
  const size_t head = (size_t)b * s * hd;
  const __nv_bfloat16* qh = q + head;
  const __nv_bfloat16* kh = kT + head;
  const __nv_bfloat16* vh = v + head;
  const float* bias_h = bias ? bias + (size_t)b * bias_stride : nullptr;

  // group 0: Q, K^T tile 0, V tile 0; columns of hd's padding read zeros
  for (int i = tid; i < BQ * DU; i += MQ_THREADS) {
    const int r = i / DU, d = (i - r * DU) * 8;
    const bool ok = d < hd;
    cp_async16(qs + r * LDQ + d, ok ? qh + (size_t)(q0 + r) * hd + d : qh,
               ok);
  }
  auto stage_kv = [&](int t) {
    const int k0 = t * BK;
    __nv_bfloat16* kd = ks + (t & 1) * HDP * LDK;
    __nv_bfloat16* vd = vs + (t & 1) * BK * LDQ;
    for (int i = tid; i < HDP * KU; i += MQ_THREADS) {
      const int d = i / KU, c = (i - d * KU) * 8;
      const bool ok = d < hd;
      cp_async16(kd + d * LDK + c, ok ? kh + (size_t)d * s + k0 + c : kh, ok);
    }
    for (int i = tid; i < BK * DU; i += MQ_THREADS) {
      const int r = i / DU, d = (i - r * DU) * 8;
      const bool ok = d < hd;
      cp_async16(vd + r * LDQ + d, ok ? vh + (size_t)(k0 + r) * hd + d : vh,
                 ok);
    }
  };
  stage_kv(0);
  cp_async_commit();

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  const float scale_l2 = scale * LOG2E;
  float m_r[2] = {-FLT_MAX, -FLT_MAX};   // rows g and g + 8, log2 units
  float l_r[2] = {0.f, 0.f};             // this lane's share of the sums
  uint32_t qf[QREG ? HDP / 16 : 1][4];

  // a K tile is visited iff its first column is <= the tile's last row
  const int ntiles = causal ? (q0 + BQ) / BK : s / BK;
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();    // tile t has landed ...
    __syncthreads();       // ... for every thread, and tile t - 1's buffers
                           // are free
    if (t + 1 < ntiles) stage_kv(t + 1);
    cp_async_commit();
    if (QREG && t == 0) {
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk)
        ldsm_x4(qf[QREG ? kk : 0],
                qs + (warp * 16 + (lane & 15)) * LDQ + kk * 16 +
                    (lane >> 4) * 8);
    }
    const int k0 = t * BK;
    if (causal && k0 > wrow + 15) continue;   // above this warp's diagonal
    const __nv_bfloat16* kb = ks + (t & 1) * HDP * LDK;
    const __nv_bfloat16* vb = vs + (t & 1) * BK * LDQ;

    // S = Q K^T
    float sc[KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      uint32_t qa[4];
      if (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[QREG ? kk : 0][e];
      } else {
        ldsm_x4(qa, qs + (warp * 16 + (lane & 15)) * LDQ + kk * 16 +
                        (lane >> 4) * 8);
      }
#pragma unroll
      for (int p = 0; p < KT / 2; ++p) {
        uint32_t kf[4];
        ldsm_x4_trans(kf, kb + (kk * 16 + (lane & 7) + (lane & 8)) * LDK +
                              p * 16 + (lane >> 4) * 8);
        mma_bf16(sc[2 * p], qa, kf[0], kf[1]);
        mma_bf16(sc[2 * p + 1], qa, kf[2], kf[3]);
      }
    }

    // scale, bias, causal mask, in log2 units (x log2(e), so exp2 is one
    // instruction); the row max over the quad
    const bool masked = causal && k0 + BK - 1 > wrow;
    float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = wrow + g + (e >> 1) * 8;
        const int col = k0 + j * 8 + t4 * 2 + (e & 1);
        float x = bias_h ? (sc[j][e] * scale + bias_h[(size_t)row * s + col])
                             * LOG2E
                         : sc[j][e] * scale_l2;
        if (masked && col > row) x = -FLT_MAX;
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], m_new[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      m_new[h] = fmaxf(m_r[h], mx[h]);
      alpha[h] = exp2f(m_r[h] - m_new[h]);
      m_r[h] = m_new[h];
    }

    // exponentials: l sums the undropped ones; P (dropped, rescaled,
    // rounded to bf16) is packed as the A operand of P V
    uint32_t pf[KT][2];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float e0 = exp2f(sc[j][2 * h] - m_new[h]);
        float e1 = exp2f(sc[j][2 * h + 1] - m_new[h]);
        rs[h] += e0 + e1;
        if (dropout) {
          const uint32_t row = (uint32_t)(wrow + g + h * 8);
          const uint32_t col = (uint32_t)(k0 + j * 8 + t4 * 2);
          e0 = rand_bits(seed, (uint32_t)b, row, col) >= thr ? e0 * inv_keep
                                                              : 0.f;
          e1 = rand_bits(seed, (uint32_t)b, row, col + 1) >= thr
                   ? e1 * inv_keep : 0.f;
        }
        pf[j][h] = pack_bf16x2(e0, e1);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_r[h] = l_r[h] * alpha[h] + rs[h];
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pf[2 * kk][0], pf[2 * kk][1], pf[2 * kk + 1][0],
                              pf[2 * kk + 1][1]};
#pragma unroll
      for (int p = 0; p < DT / 2; ++p) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, vb + (kk * 16 + (lane & 7) + (lane & 8)) * LDQ +
                              p * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * p], pa, vf[0], vf[1]);
        mma_bf16(o[2 * p + 1], pa, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = wrow + g + h * 8;
    __nv_bfloat16* orow = out + head + (size_t)row * hd;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int d = j * 8 + t4 * 2;   // hd % 8 == 0: the pair is all in or
      if (d < hd)                     // all out
        store_pair(orow + d, o[j][2 * h] / l, o[j][2 * h + 1] / l);
    }
    if (lse) {   // the quad's four lanes write the row's 128 columns
      const float val = m_r[h] * LN2 + logf(l);   // m back in natural units
      float4* lrow = reinterpret_cast<float4*>(
          lse + ((size_t)b * s + row) * 128 + t4 * 32);
#pragma unroll
      for (int c = 0; c < 8; ++c) lrow[c] = make_float4(val, val, val, val);
    }
  }
}

template <int HDP, int BK>
static int launch_flash_mma(const void* q, const void* kT, const void* v,
                            const void* bias, long long bias_stride,
                            void* out, void* lse, int bh, int s, int hd,
                            float scale, int causal, int dropout,
                            uint32_t seed, uint32_t thr, float inv_keep,
                            cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes(HDP, BK);
  auto kern = flash_fwd_mma_kernel<HDP, BK>;
  // above 48 KB only as dynamic shared memory, after the opt-in; set on
  // every launch, since the attribute is held per device
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, s / BQ);   // x runs fastest: every head's tile qi, then qi+1
  kern<<<grid, MQ_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kT),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      bias_stride, static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), s, hd, scale, causal, dropout, seed, thr,
      inv_keep);
  return cudaGetLastError();
}

template <int BK>
static int launch_mma_hd(int hd, const void* q, const void* kT, const void* v,
                         const void* bias, long long bias_stride, void* out,
                         void* lse, int bh, int s, float scale, int causal,
                         int dropout, uint32_t seed, uint32_t thr,
                         float inv_keep, cudaStream_t st) {
  // the buckets of kernels/attention.py _MMA_HDP
  if (hd <= 32) return launch_flash_mma<32, BK>(q, kT, v, bias, bias_stride, out, lse, bh, s, hd, scale, causal, dropout, seed, thr, inv_keep, st);
  if (hd <= 64) return launch_flash_mma<64, BK>(q, kT, v, bias, bias_stride, out, lse, bh, s, hd, scale, causal, dropout, seed, thr, inv_keep, st);
  if (hd <= 96) return launch_flash_mma<96, BK>(q, kT, v, bias, bias_stride, out, lse, bh, s, hd, scale, causal, dropout, seed, thr, inv_keep, st);
  if (hd <= 128) return launch_flash_mma<128, BK>(q, kT, v, bias, bias_stride, out, lse, bh, s, hd, scale, causal, dropout, seed, thr, inv_keep, st);
  if (hd <= 192) return launch_flash_mma<192, BK>(q, kT, v, bias, bias_stride, out, lse, bh, s, hd, scale, causal, dropout, seed, thr, inv_keep, st);
  return launch_flash_mma<256, BK>(q, kT, v, bias, bias_stride, out, lse, bh, s, hd, scale, causal, dropout, seed, thr, inv_keep, st);
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
// or null. s % 64 == 0, hd % 8 == 0, hd <= 256; bk in {32, 64}. bf16 runs
// the tensor-core kernel (its operands 16-byte aligned), f32 the FMA one.
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
    return launch_mma_hd<64>(hd, q, kT, v, bias, bias_stride, out, lse, bh, s, scale, causal, dropout, seed, thr, inv_keep, st);
  if (type == T_BF16 && bk == 32)
    return launch_mma_hd<32>(hd, q, kT, v, bias, bias_stride, out, lse, bh, s, scale, causal, dropout, seed, thr, inv_keep, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
