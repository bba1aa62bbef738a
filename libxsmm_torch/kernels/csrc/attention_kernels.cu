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
//   e_use = e, or e * 1/(1-p) where keep(rand_bits(seed, hb, row, col) >= thr)
//   and hb = b, or b's global batch-head under a head map (HeadMap,
//   xsmm_common.cuh: a rank's block of a sharded attention hashes the
//   positions the unsharded attention hashes)
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
// flash_fwd_tma_fma_kernel, f32 (route "tma_fma"): f32 FMAs on the CUDA
// cores (67 TFLOP/s, a 0.51 ms floor at the bench shape; f32
// means f32, no TF32), fed by TMA (xsmm_flash_fma.cuh). One block of two
// consumer warpgroups and a producer warpgroup takes one (b, BQ-row Q tile),
// BQ = 128, 128, 64 rows at hd buckets 64, 128, 256, and walks K tiles of
// BK = 128, 128, 256 columns, bounded at the diagonal when causal. The
// producer lands the Q tile once by TMA and keeps a ring of four 16 KB
// stages in flight: per K tile, slices of DK rows of K^T (all BK columns)
// and of DV rows of V (all HDP columns), full and empty mbarriers pacing
// it, so no consumer ever waits on a plain load. The consumers transpose Q
// once into Q^T; thread (a, b) owns the 8 x 8 micro-tile of S at rows
// 4a.., BQ/2 + 4a.. and columns 4b.., BK/2 + 4b.. and reads per hd step
// two 16-byte units of Q^T (the same for the eight lanes of a quarter warp)
// and two of K^T (consecutive across them): four FMAs a float, where 4 x 4
// tiles give two. The online softmax stays in
// registers in log2 units (the row max and sum by shuffles over the BK/8
// lanes of a row), P goes through shared memory as P^T (its units
// swizzled, tsw, so the lanes' stores of four-row groups fall in distinct
// banks), and O += P V runs on the same rows and eight columns of hd: 64
// accumulators a thread beside S's 64 (at bucket 64 the two halves of the
// threads take the two halves of each tile's keys, and their partial O
// tiles are added once at the end). hd is padded
// to its bucket by the TMA boxes' zero fill; the K^T slices past hd are
// not loaded. Rows and columns past s (a Q tile or a K tile wider than
// the rest of s) arrive as zeros; their columns are masked, their rows not
// stored.
//
// Both kernels bound causal tiles at the diagonal (the reference visits
// every step and masks); the TPU kernel's (bq, 128) lane-broadcast scratch
// and its VMEM budget have no meaning here. Nothing of the (s, s) panels
// reaches device memory.

#include <cuda_runtime.h>
#include <float.h>

#include "xsmm_common.cuh"
#include "xsmm_mma.cuh"
#include "xsmm_flash_fma.cuh"
#include "xsmm_launches.cuh"

enum { T_F32 = 0, T_BF16 = 1 };

constexpr int BQ = 64;        // query rows per block (the bf16 kernel)

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
    int dropout, uint32_t seed, HeadMap hm, uint32_t thr,
    float inv_keep) {
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
  const uint32_t hb = hm(b);      // the hash's batch-head
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
          e0 = rand_bits(seed, hb, row, col) >= thr ? e0 * inv_keep
                                                              : 0.f;
          e1 = rand_bits(seed, hb, row, col + 1) >= thr
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
                            uint32_t seed, HeadMap hm, uint32_t thr,
                            float inv_keep,
                            cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes(HDP, BK);
  auto kern = flash_fwd_mma_kernel<HDP, BK>;
  // above 48 KB only as dynamic shared memory, after the opt-in; set on
  // every launch, since the attribute is held per device
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, s / BQ);   // x runs fastest: every head's tile qi, then qi+1
  note_launch(kern);
  kern<<<grid, MQ_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kT),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      bias_stride, static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), s, hd, scale, causal, dropout, seed, hm, thr,
      inv_keep);
  return cudaGetLastError();
}

template <int BK>
static int launch_mma_hd(int hd, const void* q, const void* kT, const void* v,
                         const void* bias, long long bias_stride, void* out,
                         void* lse, int bh, int s, float scale, int causal,
                         int dropout, uint32_t seed, HeadMap hm, uint32_t thr,
                         float inv_keep, cudaStream_t st) {
  // the buckets of kernels/attention.py _MMA_HDP
  if (hd <= 32) return launch_flash_mma<32, BK>(q, kT, v, bias, bias_stride, out, lse, bh, s, hd, scale, causal, dropout, seed, hm, thr, inv_keep, st);
  if (hd <= 64) return launch_flash_mma<64, BK>(q, kT, v, bias, bias_stride, out, lse, bh, s, hd, scale, causal, dropout, seed, hm, thr, inv_keep, st);
  if (hd <= 96) return launch_flash_mma<96, BK>(q, kT, v, bias, bias_stride, out, lse, bh, s, hd, scale, causal, dropout, seed, hm, thr, inv_keep, st);
  if (hd <= 128) return launch_flash_mma<128, BK>(q, kT, v, bias, bias_stride, out, lse, bh, s, hd, scale, causal, dropout, seed, hm, thr, inv_keep, st);
  if (hd <= 192) return launch_flash_mma<192, BK>(q, kT, v, bias, bias_stride, out, lse, bh, s, hd, scale, causal, dropout, seed, hm, thr, inv_keep, st);
  return launch_flash_mma<256, BK>(q, kT, v, bias, bias_stride, out, lse, bh, s, hd, scale, causal, dropout, seed, hm, thr, inv_keep, st);
}

// ---------------------------------------------------------------------------
// f32 on TMA-fed FMA tiles (route "tma_fma"). HDP: hd's bucket (64, 128,
// 256); the tile plan is TfFwd<HDP> (xsmm_flash_fma.cuh).
// ---------------------------------------------------------------------------

template <int HDP>
__global__ void __launch_bounds__(TF_THREADS, 1) flash_fwd_tma_fma_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const float* __restrict__ bias,
    long long bias_stride, float* __restrict__ out, float* __restrict__ lse,
    int s, int hd, float scale, int causal, int dropout, uint32_t seed,
    HeadMap hm, uint32_t thr, float inv_keep) {
  using P = TfFwd<HDP>;
  constexpr int BQ = P::BQ, BK = P::BK, GB = P::GB, OC = P::OC, KS = P::KS,
                DK = P::DK, DV = P::DV;
  constexpr int NVS = BK / DV;                 // V stages a K tile
  constexpr int DH = DV / KS;                  // a stage's V rows a half
  extern __shared__ __align__(16) unsigned char tf_raw[];
  unsigned char* base =
      tf_raw + ((TF_ALIGN - (wg_smem(tf_raw) & (TF_ALIGN - 1))) &
                (TF_ALIGN - 1));
  float* qt = reinterpret_cast<float*>(base);  // [HDP][BQ] Q^T (tsw)
  float* pt = qt + HDP * BQ;                   // [BK][BQ] P^T (tsw); the
                                               // landed Q tile first
  unsigned char* ring = reinterpret_cast<unsigned char*>(pt + BK * BQ);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring +
                                               TF_FWD_STAGES * TF_FWD_STAGE);
  uint64_t* empty = full + TF_FWD_STAGES;
  uint64_t* qbar = empty + TF_FWD_STAGES;

  const int tid = threadIdx.x;
  const int nq = (s + BQ - 1) / BQ;
  // causal: the tiles nearest the bottom have the most K steps; start them
  // first so the short ones fill in behind
  const int qi = causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int b = blockIdx.x;
  const int q0 = qi * BQ;
  // a K tile is visited iff its first column is <= the tile's last row
  const int kend = causal ? min(s, q0 + BQ) : s;
  const int ntiles = (kend + BK - 1) / BK;
  const int nks = (hd + DK - 1) / DK;          // K^T stages a K tile

  if (tid == 0) {
    for (int i = 0; i < TF_FWD_STAGES; ++i) {
      mbar_init(&full[i], 1);                     // the producer's arrival
      mbar_init(&empty[i], TF_CONSUMERS / 32);    // one per consumer warp
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= TF_CONSUMERS) {   // the producer: one thread starts TMA
    tf_producer_regs();
    if (tid == TF_CONSUMERS) {
      mbar_arrive_expect_tx(qbar, BQ * HDP * 4);
      tma_load_3d(pt, &qmap, qbar, 0, q0, b);
      int it = 0;
      for (int t = 0; t < ntiles; ++t) {
        const int k0 = t * BK;
        for (int j = 0; j < nks + NVS; ++j, ++it) {
          const int st = it % TF_FWD_STAGES;
          if (it >= TF_FWD_STAGES)
            mbar_wait(&empty[st], ((it / TF_FWD_STAGES) - 1) & 1);
          unsigned char* dst = ring + st * TF_FWD_STAGE;
          mbar_arrive_expect_tx(&full[st], TF_FWD_STAGE);
          if (j < nks) {
            tma_load_3d(dst, &kmap, &full[st], k0, j * DK, b);
          } else {   // DH rows from each half of the tile's keys
#pragma unroll
            for (int h = 0; h < KS; ++h)
              tma_load_3d(dst + h * DH * HDP * 4, &vmap, &full[st], 0,
                          k0 + h * (BK / KS) + (j - nks) * DH, b);
          }
        }
      }
    }
    return;
  }

  tf_consumer_regs();
  const int lane = tid & 31;
  const int bq = tid % GB, aq = tid / GB;   // column group (lanes), row group
  const int oq = bq % OC, kh = bq / OC;     // O's column group, key half
  const uint32_t hb = hm(b);                // the hash's batch-head
  const float* bias_h = bias ? bias + (size_t)b * bias_stride : nullptr;
  const float scale_l2 = scale * LOG2E;

  mbar_wait(qbar, 0);
  transpose_tsw<BQ, HDP>(qt, pt, tid);
  tf_sync();

  float acc[8][8], m_r[8], l_r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_r[i] = -FLT_MAX;
    l_r[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  int it = 0;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    // S = Q K^T over hd, one K^T slice a stage
    float sc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
    for (int js = 0; js < nks; ++js, ++it) {
      const int st = it % TF_FWD_STAGES;
      mbar_wait(&full[st], (it / TF_FWD_STAGES) & 1);
      const float* kt =
          reinterpret_cast<const float*>(ring + st * TF_FWD_STAGE);
      const int d0 = js * DK;
      const int dn = min(DK, hd - d0);   // a multiple of 8
      for (int d8 = 0; d8 < dn; d8 += 8) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int dd = d8 + e, d = d0 + dd;
          float a[8], w[8];
          ld8(a, qt + d * BQ, tsw(d, aq), tsw(d, aq + BQ / 8));
          ld8(w, kt + dd * BK, bq, bq + BK / 8);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(a[i], w[j], sc[i][j]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    // scale, bias, masks in log2 units; the row max and the sum over the
    // GB lanes that share the row; l sums the undropped exponentials
    const bool edge = (causal && k0 + BK - 1 > q0) || k0 + BK > s;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + tf_at(aq, i, BQ);
      float mx = -FLT_MAX;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + tf_at(bq, j, BK);
        float x = sc[i][j] * scale_l2;
        if (bias_h && row < s && col < s)
          x = (sc[i][j] * scale + bias_h[(size_t)row * s + col]) * LOG2E;
        if (edge && ((causal && col > row) || col >= s)) x = -FLT_MAX;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = GB / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_r[i], mx);
      const float alpha = exp2f(m_r[i] - m_new);
      m_r[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float e = exp2f(sc[i][j] - m_new);
        rs += e;
        float e_use = e;
        if (dropout) {
          const int col = k0 + tf_at(bq, j, BK);
          e_use = rand_bits(seed, hb, (uint32_t)row, (uint32_t)col) >= thr
                      ? e * inv_keep : 0.f;
        }
        sc[i][j] = e_use;
      }
#pragma unroll
      for (int off = GB / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_r[i] = l_r[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
    }

    // P^T into shared memory: every thread is done with the last tile's
    tf_sync();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tf_at(bq, j, BK);
      float* prow = pt + c * BQ;
      st4s(prow + 4 * tsw(c, aq), sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
      st4s(prow + 4 * tsw(c, aq + BQ / 8), sc[4][j], sc[5][j], sc[6][j],
           sc[7][j]);
    }
    tf_sync();

    // O += P V, one V slice a stage: this thread's half of its keys
    for (int vs = 0; vs < NVS; ++vs, ++it) {
      const int st = it % TF_FWD_STAGES;
      mbar_wait(&full[st], (it / TF_FWD_STAGES) & 1);
      const float* vt =
          reinterpret_cast<const float*>(ring + st * TF_FWD_STAGE) +
          kh * DH * HDP;
#pragma unroll 8
      for (int kk = 0; kk < DH; ++kk) {
        const int kr = kh * (BK / KS) + vs * DH + kk;
        float a[8], w[8];
        ld8(a, pt + kr * BQ, tsw(kr, aq), tsw(kr, aq + BQ / 8));
        ld8(w, vt + kk * HDP, oq, oq + HDP / 8);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a[i], w[c], acc[i][c]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
  }

  if (KS > 1) {   // the second half's partial O tile onto the first's
    float* red = pt;   // [BQ][HDP], every thread done with P^T
    tf_sync();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* rrow = red + tf_at(aq, i, BQ) * HDP;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (kh == 1)
          st4s(rrow + h * (HDP / 2) + 4 * oq, acc[i][4 * h],
               acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
    }
    tf_sync();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float* rrow = red + tf_at(aq, i, BQ) * HDP;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 x = ld4s(rrow + h * (HDP / 2) + 4 * oq);
        acc[i][4 * h] += x.x;
        acc[i][4 * h + 1] += x.y;
        acc[i][4 * h + 2] += x.z;
        acc[i][4 * h + 3] += x.w;
      }
    }
  }

  // out = acc / l, cast once (f32: stored as is); lse = m + log(l) in every
  // one of the row's 128 columns, 128 / GB of them a lane
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + tf_at(aq, i, BQ);
    if (row >= s) continue;
    const float l = l_r[i];
    float* orow = out + ((size_t)b * s + row) * hd;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = h * (HDP / 2) + 4 * oq;
      if (kh == 0 && c < hd)   // hd % 8 == 0: a 4-column group is all in
        st4s(orow + c, acc[i][4 * h] / l, acc[i][4 * h + 1] / l,   // or out
             acc[i][4 * h + 2] / l, acc[i][4 * h + 3] / l);
    }
    if (lse) {
      const float val = m_r[i] * LN2 + logf(l);   // m back in natural units
      float* lrow = lse + ((size_t)b * s + row) * 128 + bq * (128 / GB);
#pragma unroll
      for (int c = 0; c < 128 / GB; c += 4) st4s(lrow + c, val, val, val, val);
    }
  }
}

// q, kT, v f32 and 16-byte aligned: the three TMA maps (no swizzle: each
// box lands as dense rows), then the launch
template <int HDP>
static int launch_flash_tma_fma(const void* q, const void* kT, const void* v,
                                const void* bias, long long bias_stride,
                                void* out, void* lse, int bh, int s, int hd,
                                float scale, int causal, int dropout,
                                uint32_t seed, HeadMap hm, uint32_t thr,
                                float inv_keep, cudaStream_t stream) {
  using P = TfFwd<HDP>;
  const cuuint64_t S = (cuuint64_t)s, H = (cuuint64_t)hd;
  const cuuint64_t rows[3] = {H, S, (cuuint64_t)bh};     // q, v: (bh, s, hd)
  const cuuint64_t rstr[2] = {H * 4, S * H * 4};
  const cuuint64_t cols[3] = {S, H, (cuuint64_t)bh};     // kT: (bh, hd, s)
  const cuuint64_t cstr[2] = {S * 4, H * S * 4};
  const cuuint32_t qbox[3] = {HDP, P::BQ, 1};
  const cuuint32_t kbox[3] = {P::BK, P::DK, 1};
  const cuuint32_t vbox[3] = {HDP, P::DV / P::KS, 1};
  CUtensorMap qmap, kmap, vmap;
  const CUtensorMapDataType F = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapSwizzle NS = CU_TENSOR_MAP_SWIZZLE_NONE;
  if (!encode_map(&qmap, F, q, 3, rows, rstr, qbox, NS) ||
      !encode_map(&kmap, F, kT, 3, cols, cstr, kbox, NS) ||
      !encode_map(&vmap, F, v, 3, rows, rstr, vbox, NS))
    return cudaErrorInvalidValue;
  constexpr int smem = tf_fwd_smem();
  auto kern = flash_fwd_tma_fma_kernel<HDP>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (s + P::BQ - 1) / P::BQ);
  note_launch(kern);
  kern<<<grid, TF_THREADS, smem, stream>>>(
      qmap, kmap, vmap, static_cast<const float*>(bias), bias_stride,
      static_cast<float*>(out), static_cast<float*>(lse), s, hd, scale,
      causal, dropout, seed, hm, thr, inv_keep);
  return cudaGetLastError();
}

extern "C" {

const char* xsmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, v: (bh, s, hd); kT: (bh, hd, s); bias: f32 (s, s) per head at
// bias + b * bias_stride, or null; out: (bh, s, hd); lse: (bh, s, 128) f32
// or null. s % 64 == 0, hd % 8 == 0, hd <= 256; q, kT and v 16-byte
// aligned. The type picks the kernel: bf16 the tensor-core kernel with
// bk-column K tiles (bk in {32, 64}), f32 the TMA-fed FMA kernel (one tile
// per hd bucket; bk unused). (b0, h0, nhl, nhg): the dropout hash's head
// map (HeadMap); 0, 0, 1, 1 hashes the local batch-head index. A refused
// map or launch returns its error; the wrapper raises.
int xsmm_flash_fwd(const void* q, const void* kT, const void* v,
                   const void* bias, long long bias_stride, void* out,
                   void* lse, int bh, int s, int hd, int type, int bk,
                   float scale, int causal, int dropout, unsigned seed,
                   unsigned thr, float inv_keep, unsigned b0, unsigned h0,
                   unsigned nhl, unsigned nhg, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s <= 0 || s % BQ || s / BQ > 65535 || hd <= 0 || hd % 8 || hd > 256 ||
      bh <= 0 || nhl == 0 || nhg == 0 ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(kT) |
       reinterpret_cast<uintptr_t>(v)) % 16)
    return cudaErrorInvalidValue;
  const HeadMap hm{b0, h0, nhl, nhg};
  if (type == T_F32) {
    if (hd <= 64)
      return launch_flash_tma_fma<64>(q, kT, v, bias, bias_stride, out, lse, bh, s, hd, scale, causal, dropout, seed, hm, thr, inv_keep, st);
    if (hd <= 128)
      return launch_flash_tma_fma<128>(q, kT, v, bias, bias_stride, out, lse, bh, s, hd, scale, causal, dropout, seed, hm, thr, inv_keep, st);
    return launch_flash_tma_fma<256>(q, kT, v, bias, bias_stride, out, lse, bh, s, hd, scale, causal, dropout, seed, hm, thr, inv_keep, st);
  }
  if (type == T_BF16 && bk == 64)
    return launch_mma_hd<64>(hd, q, kT, v, bias, bias_stride, out, lse, bh, s, scale, causal, dropout, seed, hm, thr, inv_keep, st);
  if (type == T_BF16 && bk == 32)
    return launch_mma_hd<32>(hd, q, kT, v, bias, bias_stride, out, lse, bh, s, scale, causal, dropout, seed, hm, thr, inv_keep, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
