// Hand-written Hopper (sm_90a) flash-attention backward for libxsmm_torch:
// two kernels, as the reference splits it, each in a form chosen by operand
// type and hd (kernels/attention.py flash_bwd_path).
// Replaces the Pallas TPU kernels of build_flash_attention_bwd
// (libxsmm_tpu/kernels/attention_pallas.py:322):
//   dK^T, dV (+ dbias) <- dkv_kernel (:387): flash_bwd_dkv_wgmma_kernel
//                                            (bf16, hd <= 128),
//                                            flash_bwd_dkv_wgmma_wide_kernel
//                                            (bf16, hd > 128),
//                                            flash_bwd_dkv_tma_fma_kernel (f32)
//   dQ                 <- dq_kernel  (:485): flash_bwd_dq_wgmma_kernel,
//                                            flash_bwd_dq_wgmma_wide_kernel,
//                                            flash_bwd_dq_tma_fma_kernel, alike
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
// bf16 on wgmma (route "wgmma", kernels/csrc/xsmm_flash_wgmma.cuh), for every
// bf16 call; up to hd 128 as follows, past it the wide plan (its section
// below). A producer warpgroup keeps TMA loads of 128-byte swizzled boxes in
// flight into a ring (full and empty mbarriers) and hands its registers back
// (setmaxnreg); two consumer warpgroups each own 64 rows of the block's output
// and run wgmma with f32 accumulators in registers.
//   dK/dV: one block owns (b, 128 keys); K^T and V land once; the ring
//   streams 64-row Q and dO tiles with their lse and delta rows (from the
//   first that reaches the diagonal when causal). Each group forms S^T = K
//   Q^T (K^T through the transpose bit) and dP^T = V dO^T for its 64 keys,
//   p~^T and dS^T in registers (rows are keys, so the hash takes (column,
//   row)), and their bf16 pairs are the register A fragments of dV += p~^T
//   dO and dK += dS^T Q (dO and Q MN-major through the transpose bit): no
//   trip through shared memory. dK^T goes out through the group's K^T box,
//   its (hd, s) rows in 16-byte units.
//   dQ: one block owns (b, 128 query rows); Q and dO land once; the ring
//   streams 128-key K^T and V tiles (up to the diagonal when causal).
//   S = Q K^T (K^T MN-major), dP = dO V^T, dS in registers, and dQ += dS K
//   with dS as register A and the K^T tile read K-major (its rows are hd).
//   At a padded hd of 128 a consumer thread holds 192 accumulator
//   registers under a budget of 240.
// The per-element code between the products, not the products, set these
// kernels' time, so it is lean: one instantiation per form (bias or not,
// dropout or not), exp2 by ex2.approx.ftz, the causal test only on the
// tiles that cross the diagonal, and each tile's scores converted in two
// halves, the second while the tensor cores run the first half's
// products.
//
// f32 on TMA-fed FMA tiles (route "tma_fma"), on the CUDA cores' FMAs (67
// TFLOP/s: floors of 1.03 and 0.77 ms at the bench shape; f32 means f32,
// no TF32), the forward's design
// (xsmm_flash_fma.cuh): one producer warpgroup keeps two 32 KB TMA stages
// in flight (full and empty mbarriers), eight consumer warps compute on 8 x 8
// micro-tiles, four FMAs per float read from shared memory, every read
// either a quarter warp's broadcast or eight consecutive 16-byte units.
// Consumer warps 0-3 (group A) and 4-7 (group B) split each step's score
// products and hand p over through shared memory; B recomputes the
// dropout hash for dP.
//   dK/dV (TfDkv): one block owns BK = 8192 / HDP keys; K^T lands once as
//   it lies and V once, transposed into V^T. Per Q tile of BQ = HDP rows
//   the ring brings DS-column slices of Q and dO (and the tile's lse and
//   delta rows): A forms S = Q K^T, B dP = dO V^T on (query set, key
//   chunk) micro-tiles, Q and dO read four hd entries a row at a time (the
//   lanes' common rows). A writes p~ and p, B turns p into dS in place
//   (and writes dbias). Then IS-row slices of dO and Q: A accumulates
//   dV += p~^T dO, B dK += dS^T Q on (key set, hd chunk) micro-tiles, both
//   in registers across all Q tiles; the reference's order of products,
//   dK^T scaled once at the end.
//   dQ (TfDq): one block owns BQ = 128, 128, 64 query rows (hd buckets
//   64, 128, 256); Q and dO land once and are transposed into Q^T and
//   dO^T. Per K tile of BK = 8192 / BQ keys the ring brings DK-row slices
//   of K^T with the same DK columns of V: A forms S^T = K Q^T, B dP^T =
//   V dO^T on (key set, query chunk) micro-tiles; p and then dS pass
//   through dS^T; then JS-column slices of K^T: all eight warps accumulate
//   dQ^T += K^T-rows dS^T on (hd set, query chunk) micro-tiles (at bucket
//   64 over two halves of the keys, added once at the end), scaled once at
//   the end.
// Tiles wider than the rest of s arrive zero-filled and contribute nothing.
//
// Nothing of the (s, s) panels reaches device memory except dbias when it
// is asked for.

#include <cuda_runtime.h>

#include "xsmm_common.cuh"
#include "xsmm_mma.cuh"
#include "xsmm_flash_fma.cuh"
#include "xsmm_flash_wgmma.cuh"
#include "xsmm_launches.cuh"

enum { T_F32 = 0, T_BF16 = 1 };

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

constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16 on wgmma (route "wgmma"), hd padded to HDP = 64 or 128; the plan,
// budgets and instructions are xsmm_flash_wgmma.cuh's. Threads 0-255 are
// the consumer warpgroups (wg = tid / 128), 256-383 the producer.
// ---------------------------------------------------------------------------

// grad_mma's p~ and ds for the wgmma kernels: the causal test only where
// `mask` (a tile that crosses the diagonal), the bias (brow: the bias row of
// `row`) only in the BIAS instantiations, the dropout hash only in the DROP
// ones
template <bool BIAS, bool DROP>
__device__ __forceinline__ void fw_grad(const BwdArgs& a, const float* brow,
                                        uint32_t hb, int row, int col,
                                        bool mask, float sc, float dp,
                                        float lse2, float delta,
                                        float& p_drop, float& ds) {
  const float x = BIAS ? (sc * a.scale + brow[col]) * LOG2E
                       : sc * (a.scale * LOG2E);
  float p = fw_exp2(x - lse2);
  if (mask && col > row) p = 0.f;
  p_drop = p;
  if (DROP) {
    const bool keep = rand_bits(a.seed, hb, (uint32_t)row, (uint32_t)col) >=
                      a.thr;
    p_drop = keep ? p * a.inv_keep : 0.f;
    dp = keep ? dp * a.inv_keep : 0.f;
  }
  ds = p * (dp - delta);
}

// dK^T, dV (+ dbias): one block per (b, 128 keys); warpgroup wg owns keys
// kw = k0 + 64 wg .. + 64, and both of their accumulators (dV and dK, 64 x
// HDP each). Per 64-row Q tile it forms S^T = K Q^T (A: its K^T box, MN-major;
// B: the Q tile, K-major) and dP^T = V dO^T (A: its V rows, K-major; B: dO,
// K-major), turns them into p~^T and dS^T in registers, and accumulates
// dV += p~^T dO and dK += dS^T Q with those as register A fragments and dO
// and Q as MN-major B, in two halves of 32 queries: the second half is
// converted while the first half's products run.
template <int HDP, bool BIAS, bool DROP>
__global__ void __launch_bounds__(TF_THREADS, 1) flash_bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap kmap,   // kT: 64 keys x HDP rows
    const __grid_constant__ CUtensorMap vmap,   // v: 64 x 64 boxes
    const __grid_constant__ CUtensorMap qmap,   // q: 64 x 64 boxes
    const __grid_constant__ CUtensorMap omap,   // dout: 64 x 64 boxes
    const __grid_constant__ CUtensorMap lmap,   // lse (bh, s): 64 rows
    const __grid_constant__ CUtensorMap dmap,   // delta (bh, s): 64 rows
    const BwdArgs a) {
  constexpr int NC = HDP / 64;          // 64-column boxes of hd
  constexpr int KT_BOX = HDP * 128;     // a warpgroup's K^T: HDP rows x 64 keys
  constexpr int TILE = NC * FW_BOX;     // 64 rows x HDP of Q, dO or V
  constexpr int STAGE = 2 * TILE;       // a stage: Q and dO
  constexpr int ST = FW_DKV_STAGES;
  extern __shared__ __align__(16) unsigned char fw_raw[];
  // the swizzle is a function of the shared address: 1024-byte aligned
  unsigned char* base =
      fw_raw + ((TF_ALIGN - (wg_smem(fw_raw) & (TF_ALIGN - 1))) &
                (TF_ALIGN - 1));
  unsigned char* kt = base;                  // [2][HDP][64 keys]
  unsigned char* vs = kt + 2 * KT_BOX;       // [2][NC][64 keys][64]
  unsigned char* ring = vs + 2 * TILE;       // [ST] {Q, dO}: [NC][64][64]
  float* ls = reinterpret_cast<float*>(ring + ST * STAGE);   // [ST][64]
  float* dls = ls + ST * FW_BQ;                              // [ST][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(dls + ST * FW_BQ);
  uint64_t* empty = full + ST;
  uint64_t* kvbar = empty + ST;

  const int tid = threadIdx.x;
  const int s = a.s, hd = a.hd;
  const int b = blockIdx.x;
  const int k0 = blockIdx.y * FW_BKV;   // causal: the first have most work
  const int nq = s / FW_BQ;
  // Q tiles entirely above this K tile's diagonal contribute nothing; their
  // dbias blocks are zero (attention_pallas.py:425-432)
  const int qstart = a.causal ? k0 / FW_BQ : 0;

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], TF_CONSUMERS / 32);
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= TF_CONSUMERS) {   // the producer: one thread starts TMA
    tf_producer_regs();
    if (tid == TF_CONSUMERS) {
      mbar_arrive_expect_tx(kvbar, 2 * KT_BOX + 2 * TILE);
      for (int w = 0; w < 2; ++w) {
        tma_load_3d(kt + w * KT_BOX, &kmap, kvbar, k0 + 64 * w, 0, b);
        for (int c = 0; c < NC; ++c)
          tma_load_3d(vs + (w * NC + c) * FW_BOX, &vmap, kvbar, 64 * c,
                      k0 + 64 * w, b);
      }
      for (int qi = qstart, it = 0; qi < nq; ++qi, ++it) {
        const int st = it % ST;
        if (it >= ST) mbar_wait(&empty[st], ((it / ST) - 1) & 1);
        unsigned char* dst = ring + st * STAGE;
        const int q0 = qi * FW_BQ;
        mbar_arrive_expect_tx(&full[st], STAGE + 2 * FW_BQ * 4);
        for (int c = 0; c < NC; ++c) {
          tma_load_3d(dst + c * FW_BOX, &qmap, &full[st], 64 * c, q0, b);
          tma_load_3d(dst + TILE + c * FW_BOX, &omap, &full[st], 64 * c, q0,
                      b);
        }
        tma_load_2d(ls + st * FW_BQ, &lmap, &full[st], q0, b);
        tma_load_2d(dls + st * FW_BQ, &dmap, &full[st], q0, b);
      }
    }
    return;
  }

  tf_consumer_regs();
  const int wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kw = k0 + 64 * wg;          // this warpgroup's first key
  const int keyl = 16 * warp + g;       // fragment rows keyl, keyl + 8
  const uint32_t hb = a.hm(b);          // the hash's batch-head
  const float* bias_h = a.bias ? a.bias + (size_t)b * a.bias_stride : nullptr;
  float* dbias_h = a.dbias ? a.dbias + (size_t)b * s * s : nullptr;

  if (BIAS && dbias_h) {   // the skipped Q tiles' dbias: this group's keys
    for (int i = t; i < qstart * FW_BQ * 16; i += 128) {
      const int r = i >> 4, c = (i & 15) * 4;
      st4s(dbias_h + (size_t)r * s + kw + c, 0.f, 0.f, 0.f, 0.f);
    }
  }

  float dv[HDP / 2], dk[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) dv[i] = dk[i] = 0.f;
  const unsigned char* ktw = kt + wg * KT_BOX;
  const unsigned char* vw = vs + wg * TILE;
  mbar_wait(kvbar, 0);

  for (int qi = qstart, it = 0; qi < nq; ++qi, ++it) {
    const int st = it % ST;
    mbar_wait(&full[st], (it / ST) & 1);
    const unsigned char* qt = ring + st * STAGE;
    const unsigned char* ot = qt + TILE;
    // S^T = K Q^T and dP^T = V dO^T over hd: 64 keys x 64 queries
    float sT[32], dpT[32];
    wgmma_fence_operands(sT);
    wgmma_fence_operands(dpT);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < HDP / 16; ++j) {
      const int kb = (j >> 2) * FW_BOX + 32 * (j & 3);
      Wg<64>::ss<1, 0>(sT, fw_mnmajor(ktw + 2048 * j, FW_BOX),
                       fw_kmajor(qt + kb), j > 0);
      Wg<64>::ss<0, 0>(dpT, fw_kmajor(vw + kb), fw_kmajor(ot + kb), j > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operands(sT);
    wgmma_fence_operands(dpT);

    // p~^T and dS^T: element (key row, query column), packed to bf16 pairs
    // as the A fragments of the accumulating products
    const int q0 = qi * FW_BQ;
    const bool mask = a.causal && kw + 63 > q0;   // crosses the diagonal
    const float* lrow = ls + st * FW_BQ;
    const float* drow = dls + st * FW_BQ;
    uint32_t pa[4][4], sa[4][4];
    wgmma_fence_operands(dv);
    wgmma_fence_operands(dk);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int j = 4 * half; j < 4 * half + 4; ++j) {
      const int qc = 8 * j + 2 * t4;    // query columns qc, qc + 1
      const float2 l2 = *reinterpret_cast<const float2*>(lrow + qc);
      const float2 dl = *reinterpret_cast<const float2*>(drow + qc);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = kw + keyl + 8 * h;
        float pd[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          fw_grad<BIAS, DROP>(
              a, BIAS ? bias_h + (size_t)(q0 + qc + e) * s : nullptr, hb,
              q0 + qc + e, key, mask, sT[4 * j + 2 * h + e],
              dpT[4 * j + 2 * h + e], (e ? l2.y : l2.x) * LOG2E,
              e ? dl.y : dl.x, pd[e], ds[e]);
          if (BIAS && dbias_h)
            dbias_h[(size_t)(q0 + qc + e) * s + key] = ds[e];
        }
        pa[j >> 1][2 * (j & 1) + h] = pack_bf16x2(pd[0], pd[1]);
        sa[j >> 1][2 * (j & 1) + h] = pack_bf16x2(ds[0], ds[1]);
      }
    }

    // dV += p~^T dO and dK += dS^T Q over the half's 32 queries
    wgmma_fence();
#pragma unroll
    for (int kk = 2 * half; kk < 2 * half + 2; ++kk) {
      Wg<HDP>::template rs<1>(dv, pa[kk], fw_mnmajor(ot + 2048 * kk, FW_BOX),
                              1);
      Wg<HDP>::template rs<1>(dk, sa[kk], fw_mnmajor(qt + 2048 * kk, FW_BOX),
                              1);
    }
    wgmma_commit();
    fw_hold<16, 32>(sT);
    fw_hold<16, 32>(dpT);
    }
    wgmma_wait<0>();
    wgmma_fence_operands(dv);
    wgmma_fence_operands(dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // dV rows straight out, cast once
  __nv_bfloat16* dvh = static_cast<__nv_bfloat16*>(a.dv) + (size_t)b * s * hd;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = 8 * j + 2 * t4;
      if (d < hd)   // hd % 8 == 0: the pair is all in or all out
        store_pair(dvh + (size_t)(kw + keyl + 8 * h) * hd + d,
                   dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
    }
  // dK^T scaled and rounded once into this group's K^T box (plain [d][64]),
  // then written along s in 16-byte units
  fw_wg_sync(wg);   // every warp of the group is done with its K^T box
  __nv_bfloat16* kst = reinterpret_cast<__nv_bfloat16*>(kt + wg * KT_BOX);
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        kst[(8 * j + 2 * t4 + e) * 64 + keyl + 8 * h] =
            __float2bfloat16(dk[4 * j + 2 * h + e] * a.scale);
  fw_wg_sync(wg);
  __nv_bfloat16* dkh = static_cast<__nv_bfloat16*>(a.dkT) + (size_t)b * hd * s;
  for (int i = t; i < hd * 8; i += 128) {
    const int d = i >> 3, u = (i & 7) * 8;
    *reinterpret_cast<uint4*>(dkh + (size_t)d * s + kw + u) =
        *reinterpret_cast<const uint4*>(kst + d * 64 + u);
  }
}

// dQ: one block per (b, 128 query rows); warpgroup wg owns rows q0 + 64 wg ..
// + 64 and their dQ accumulator (64 x HDP). Per 128-key tile it forms S = Q
// K^T (A: its Q rows, K-major; B: the K^T tile, MN-major) and dP = dO V^T
// (A: its dO rows; B: the V tile, K-major), turns them into dS in
// registers, and accumulates dQ += dS K with dS as register A fragments and
// the K^T tile as K-major B (its rows are hd, its 128-byte rows keys), in
// two halves of 64 keys: the second half is converted while the first
// half's products run.
template <int HDP, bool BIAS, bool DROP>
__global__ void __launch_bounds__(TF_THREADS, 1) flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap,   // q: 64 x 64 boxes
    const __grid_constant__ CUtensorMap omap,   // dout: 64 x 64 boxes
    const __grid_constant__ CUtensorMap kmap,   // kT: 64 keys x HDP rows
    const __grid_constant__ CUtensorMap vmap,   // v: 64 hd x 128 keys boxes
    const BwdArgs a) {
  constexpr int NC = HDP / 64;
  constexpr int TILE = NC * FW_BOX;          // 64 rows x HDP of Q or dO
  constexpr int KT_BOX = HDP * 128;          // K^T: HDP rows x 64 keys
  constexpr int V_BOX = FW_DQ_BK * 128;      // V: 128 keys x 64 hd
  constexpr int STAGE = 2 * KT_BOX + NC * V_BOX;   // K^T and V
  constexpr int ST = FW_DQ_STAGES;
  extern __shared__ __align__(16) unsigned char fw_raw[];
  unsigned char* base =
      fw_raw + ((TF_ALIGN - (wg_smem(fw_raw) & (TF_ALIGN - 1))) &
                (TF_ALIGN - 1));
  unsigned char* qs = base;               // [2][NC][64 rows][64]
  unsigned char* os = qs + 2 * TILE;      // [2][NC][64 rows][64]
  unsigned char* ring = os + 2 * TILE;    // [ST] {K^T, V [NC][128][64]}
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * STAGE);
  uint64_t* empty = full + ST;
  uint64_t* qbar = empty + ST;

  const int tid = threadIdx.x;
  const int s = a.s, hd = a.hd;
  const int nq = s / FW_DQ_BQ;
  // causal: the bottom tiles have the most K steps; start them first
  const int qi = a.causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int b = blockIdx.x;
  const int q0 = qi * FW_DQ_BQ;
  // a K tile is visited iff its first column is <= the tile's last row
  const int ntiles = a.causal ? qi + 1 : s / FW_DQ_BK;

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], TF_CONSUMERS / 32);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= TF_CONSUMERS) {   // the producer
    tf_producer_regs();
    if (tid == TF_CONSUMERS) {
      mbar_arrive_expect_tx(qbar, 4 * TILE);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < NC; ++c) {
          tma_load_3d(qs + (w * NC + c) * FW_BOX, &qmap, qbar, 64 * c,
                      q0 + 64 * w, b);
          tma_load_3d(os + (w * NC + c) * FW_BOX, &omap, qbar, 64 * c,
                      q0 + 64 * w, b);
        }
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % ST;
        if (t >= ST) mbar_wait(&empty[st], ((t / ST) - 1) & 1);
        unsigned char* d = ring + st * STAGE;
        const int k0 = t * FW_DQ_BK;
        mbar_arrive_expect_tx(&full[st], STAGE);
        for (int h = 0; h < 2; ++h)
          tma_load_3d(d + h * KT_BOX, &kmap, &full[st], k0 + 64 * h, 0, b);
        for (int c = 0; c < NC; ++c)
          tma_load_3d(d + 2 * KT_BOX + c * V_BOX, &vmap, &full[st], 64 * c,
                      k0, b);
      }
    }
    return;
  }

  tf_consumer_regs();
  const int wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = q0 + 64 * wg + 16 * warp + g;   // fragment rows r0, r0 + 8
  const uint32_t hb = a.hm(b);                   // the hash's batch-head
  const float* bias_h = a.bias ? a.bias + (size_t)b * a.bias_stride : nullptr;
  float lse2[2], del[2];
  const float* brow[2];   // the bias rows of rows r0 and r0 + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse2[h] = a.lse[(size_t)b * s + r0 + 8 * h] * LOG2E;
    del[h] = a.delta[(size_t)b * s + r0 + 8 * h];
    brow[h] = BIAS ? bias_h + (size_t)(r0 + 8 * h) * s : nullptr;
  }
  float dq[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) dq[i] = 0.f;
  const unsigned char* qw = qs + wg * TILE;
  const unsigned char* ow = os + wg * TILE;
  mbar_wait(qbar, 0);

  for (int kt = 0; kt < ntiles; ++kt) {
    const int st = kt % ST;
    mbar_wait(&full[st], (kt / ST) & 1);
    const unsigned char* kst = ring + st * STAGE;
    const unsigned char* vst = kst + 2 * KT_BOX;
    // S = Q K^T and dP = dO V^T over hd: 64 rows x 128 keys
    float sc[64], dp[64];
    wgmma_fence_operands(sc);
    wgmma_fence_operands(dp);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < HDP / 16; ++j) {
      const int ab = (j >> 2) * FW_BOX + 32 * (j & 3);
      Wg<128>::ss<0, 1>(sc, fw_kmajor(qw + ab),
                        fw_mnmajor(kst + 2048 * j, KT_BOX), j > 0);
      Wg<128>::ss<0, 0>(dp, fw_kmajor(ow + ab),
                        fw_kmajor(vst + (j >> 2) * V_BOX + 32 * (j & 3)),
                        j > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operands(sc);
    wgmma_fence_operands(dp);

    // dS, packed to bf16 pairs as the A fragments of dQ += dS K
    const int k0 = kt * FW_DQ_BK;
    // the tile crosses this group's diagonal
    const bool mask = a.causal && k0 + FW_DQ_BK - 1 > q0 + 64 * wg;
    uint32_t sa[8][4];
    wgmma_fence_operands(dq);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int j = 8 * half; j < 8 * half + 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float pd[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          fw_grad<BIAS, DROP>(a, brow[h], hb, r0 + 8 * h,
                              k0 + 8 * j + 2 * t4 + e, mask,
                              sc[4 * j + 2 * h + e], dp[4 * j + 2 * h + e],
                              lse2[h], del[h], pd[e], ds[e]);
        sa[j >> 1][2 * (j & 1) + h] = pack_bf16x2(ds[0], ds[1]);
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 4 * half; kk < 4 * half + 4; ++kk)
      Wg<HDP>::template rs<0>(
          dq, sa[kk], fw_kmajor(kst + (kk >> 2) * KT_BOX + 32 * (kk & 3)), 1);
    wgmma_commit();
    fw_hold<32, 64>(sc);
    fw_hold<32, 64>(dp);
    }
    wgmma_wait<0>();
    wgmma_fence_operands(dq);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  __nv_bfloat16* dqh = static_cast<__nv_bfloat16*>(a.dq) + (size_t)b * s * hd;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = 8 * j + 2 * t4;   // hd % 8 == 0: the pair is all in or
      if (d < hd)                     // all out
        store_pair(dqh + (size_t)(r0 + 8 * h) * hd + d,
                   dq[4 * j + 2 * h] * a.scale,
                   dq[4 * j + 2 * h + 1] * a.scale);
    }
}

// ---------------------------------------------------------------------------
// bf16 on wgmma past hd 128 (route "wgmma"), hd padded to HDP = 192 or
// 256; the plan and budgets are xsmm_flash_wgmma.cuh's (fw_dkv_wide_smem,
// fw_dq_wide_smem). At HDP 256 the hd <= 128 plan's accumulators (dK and dV,
// or dQ, 64 x HDP f32 a warpgroup) would take 256 registers a consumer
// thread, and its tiles more than 227 KB, so:
//   dK/dV: a block owns 64 keys; K^T and V land once (64 KB at HDP 256).
//   Both warpgroups form S^T and dP^T for the 64 keys against each 64-row
//   Q tile (a third of the block's products repeat, which keeps the two
//   accumulators within the register file), and warpgroup wg accumulates
//   dV and dK over hd's columns 128 wg .. + 128 (at HDP 192 the last 64
//   are zeros, never stored). A consumer thread holds S^T and dP^T (32
//   each), dV and dK (64 each) and the 32 bf16 A fragments: the hd <= 128
//   kernel's count.
//   dQ: a block owns 128 query rows, 64 a warpgroup, with Q and dO landed
//   once (128 KB at HDP 256); the ring streams 64-key K^T and V tiles as
//   separate units, V before K^T: V's unit goes back to the producer as
//   soon as dP is formed, K^T's after dQ += dS K, so the next tile's units
//   land while this tile's dQ products run. A consumer thread holds dQ (two
//   accumulators of 128 and HDP - 128 columns: 128 registers at HDP 256),
//   S and dP (32 each) and dS's 16 A fragments.
// ---------------------------------------------------------------------------

// dK^T, dV (+ dbias) past hd 128: one block per (b, 64 keys k0 .. + 64);
// warpgroup wg owns the dV and dK columns c0 = 128 wg .. + 128. Per Q tile
// both groups form S^T = K Q^T (A: the K^T tile, MN-major; B: the Q tile,
// K-major) and dP^T = V dO^T over hd, turn them into p~^T and dS^T in
// registers, and accumulate dV += p~^T dO and dK += dS^T Q over their
// columns (dO and Q MN-major, from the box of column c0), in two halves of
// 32 queries. The ring's Q and dO tiles are 256 columns wide at either
// bucket: at HDP 192 their fourth box lies past hd, so TMA fills it with
// zeros (no bytes read) and the second group's last 64 columns accumulate
// zeros, never stored. Each group writes dbias for its half of the queries
// (both form the same dS).
template <int HDP, bool BIAS, bool DROP>
__global__ void __launch_bounds__(TF_THREADS, 1)
    flash_bwd_dkv_wgmma_wide_kernel(
        const __grid_constant__ CUtensorMap kmap,   // kT: 64 keys x HDP rows
        const __grid_constant__ CUtensorMap vmap,   // v: 64 x 64 boxes
        const __grid_constant__ CUtensorMap qmap,   // q: 64 x 64 boxes
        const __grid_constant__ CUtensorMap omap,   // dout: 64 x 64 boxes
        const __grid_constant__ CUtensorMap lmap,   // lse (bh, s): 64 rows
        const __grid_constant__ CUtensorMap dmap,   // delta (bh, s): 64 rows
        const BwdArgs a) {
  constexpr int NC = HDP / 64;          // 64-column boxes of hd
  constexpr int KT = HDP * 128;         // K^T: HDP rows x 64 keys
  constexpr int TILE = 4 * FW_BOX;      // 64 rows x 256 of Q or dO
  constexpr int STAGE = 2 * TILE;       // a stage: Q and dO
  constexpr int ST = FW_DKV_WIDE_STAGES;
  extern __shared__ __align__(16) unsigned char fw_raw[];
  // the swizzle is a function of the shared address: 1024-byte aligned
  unsigned char* base =
      fw_raw + ((TF_ALIGN - (wg_smem(fw_raw) & (TF_ALIGN - 1))) &
                (TF_ALIGN - 1));
  unsigned char* kt = base;                 // [HDP][64 keys]
  unsigned char* vs = kt + KT;              // [NC][64 keys][64]
  unsigned char* ring = vs + NC * FW_BOX;   // [ST] {Q, dO}: [4][64][64]
  float* ls = reinterpret_cast<float*>(ring + ST * STAGE);   // [ST][64]
  float* dls = ls + ST * FW_BQ;                              // [ST][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(dls + ST * FW_BQ);
  uint64_t* empty = full + ST;
  uint64_t* kvbar = empty + ST;

  const int tid = threadIdx.x;
  const int s = a.s, hd = a.hd;
  const int b = blockIdx.x;
  const int k0 = blockIdx.y * FW_WIDE_BKV;   // causal: the first have most
  const int nq = s / FW_BQ;
  // Q tiles entirely above this K tile's diagonal contribute nothing; their
  // dbias blocks are zero (attention_pallas.py:425-432)
  const int qstart = a.causal ? k0 / FW_BQ : 0;

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], TF_CONSUMERS / 32);
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= TF_CONSUMERS) {   // the producer: one thread starts TMA
    tf_producer_regs();
    if (tid == TF_CONSUMERS) {
      mbar_arrive_expect_tx(kvbar, KT + NC * FW_BOX);
      tma_load_3d(kt, &kmap, kvbar, k0, 0, b);
      for (int c = 0; c < NC; ++c)
        tma_load_3d(vs + c * FW_BOX, &vmap, kvbar, 64 * c, k0, b);
      for (int qi = qstart, it = 0; qi < nq; ++qi, ++it) {
        const int st = it % ST;
        if (it >= ST) mbar_wait(&empty[st], ((it / ST) - 1) & 1);
        unsigned char* dst = ring + st * STAGE;
        const int q0 = qi * FW_BQ;
        mbar_arrive_expect_tx(&full[st], STAGE + 2 * FW_BQ * 4);
        for (int c = 0; c < 4; ++c) {
          tma_load_3d(dst + c * FW_BOX, &qmap, &full[st], 64 * c, q0, b);
          tma_load_3d(dst + TILE + c * FW_BOX, &omap, &full[st], 64 * c, q0,
                      b);
        }
        tma_load_2d(ls + st * FW_BQ, &lmap, &full[st], q0, b);
        tma_load_2d(dls + st * FW_BQ, &dmap, &full[st], q0, b);
      }
    }
    return;
  }

  tf_consumer_regs();
  const int wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int c0 = 128 * wg;              // this group's columns of hd
  const int cb = 2 * wg * FW_BOX;       // and their box in a tile
  const int keyl = 16 * warp + g;       // fragment rows keyl, keyl + 8
  const uint32_t hb = a.hm(b);          // the hash's batch-head
  const float* bias_h = a.bias ? a.bias + (size_t)b * a.bias_stride : nullptr;
  float* dbias_h = a.dbias ? a.dbias + (size_t)b * s * s : nullptr;

  if (BIAS && dbias_h) {   // the skipped Q tiles' dbias, over both groups
    for (int i = tid; i < qstart * FW_BQ * 16; i += TF_CONSUMERS) {
      const int r = i >> 4, c = (i & 15) * 4;
      st4s(dbias_h + (size_t)r * s + k0 + c, 0.f, 0.f, 0.f, 0.f);
    }
  }

  float dv[64], dk[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dv[i] = dk[i] = 0.f;
  mbar_wait(kvbar, 0);

  for (int qi = qstart, it = 0; qi < nq; ++qi, ++it) {
    const int st = it % ST;
    mbar_wait(&full[st], (it / ST) & 1);
    const unsigned char* qt = ring + st * STAGE;
    const unsigned char* ot = qt + TILE;
    // S^T = K Q^T and dP^T = V dO^T over hd: 64 keys x 64 queries
    float sT[32], dpT[32];
    wgmma_fence_operands(sT);
    wgmma_fence_operands(dpT);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < HDP / 16; ++j) {
      const int kb = (j >> 2) * FW_BOX + 32 * (j & 3);
      Wg<64>::ss<1, 0>(sT, fw_mnmajor(kt + 2048 * j, FW_BOX),
                       fw_kmajor(qt + kb), j > 0);
      Wg<64>::ss<0, 0>(dpT, fw_kmajor(vs + kb), fw_kmajor(ot + kb), j > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operands(sT);
    wgmma_fence_operands(dpT);

    // p~^T and dS^T: element (key row, query column), packed to bf16 pairs
    // as the A fragments of the accumulating products
    const int q0 = qi * FW_BQ;
    const bool mask = a.causal && k0 + 63 > q0;   // crosses the diagonal
    const float* lrow = ls + st * FW_BQ;
    const float* drow = dls + st * FW_BQ;
    uint32_t pa[4][4], sa[4][4];
    wgmma_fence_operands(dv);
    wgmma_fence_operands(dk);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int j = 4 * half; j < 4 * half + 4; ++j) {
        const int qc = 8 * j + 2 * t4;    // query columns qc, qc + 1
        const float2 l2 = *reinterpret_cast<const float2*>(lrow + qc);
        const float2 dl = *reinterpret_cast<const float2*>(drow + qc);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int key = k0 + keyl + 8 * h;
          float pd[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            fw_grad<BIAS, DROP>(
                a, BIAS ? bias_h + (size_t)(q0 + qc + e) * s : nullptr, hb,
                q0 + qc + e, key, mask, sT[4 * j + 2 * h + e],
                dpT[4 * j + 2 * h + e], (e ? l2.y : l2.x) * LOG2E,
                e ? dl.y : dl.x, pd[e], ds[e]);
            if (BIAS && dbias_h && half == wg)
              dbias_h[(size_t)(q0 + qc + e) * s + key] = ds[e];
          }
          pa[j >> 1][2 * (j & 1) + h] = pack_bf16x2(pd[0], pd[1]);
          sa[j >> 1][2 * (j & 1) + h] = pack_bf16x2(ds[0], ds[1]);
        }
      }

      // dV += p~^T dO and dK += dS^T Q over the half's 32 queries
      wgmma_fence();
#pragma unroll
      for (int kk = 2 * half; kk < 2 * half + 2; ++kk) {
        Wg<128>::rs<1>(dv, pa[kk], fw_mnmajor(ot + cb + 2048 * kk, FW_BOX),
                       1);
        Wg<128>::rs<1>(dk, sa[kk], fw_mnmajor(qt + cb + 2048 * kk, FW_BOX),
                       1);
      }
      wgmma_commit();
      fw_hold<16, 32>(sT);
      fw_hold<16, 32>(dpT);
    }
    wgmma_wait<0>();
    wgmma_fence_operands(dv);
    wgmma_fence_operands(dk);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // dV rows straight out, cast once
  __nv_bfloat16* dvh = static_cast<__nv_bfloat16*>(a.dv) + (size_t)b * s * hd;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = c0 + 8 * j + 2 * t4;
      if (d < hd)   // hd % 8 == 0: the pair is all in or all out
        store_pair(dvh + (size_t)(k0 + keyl + 8 * h) * hd + d,
                   dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
    }
  // dK^T scaled and rounded once into the K^T tile's rows c0 .. (plain
  // [d][64], rows under hd), once both groups are done reading it, then
  // written along s in 16-byte units
  tf_sync();
  __nv_bfloat16* kst = reinterpret_cast<__nv_bfloat16*>(kt);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = c0 + 8 * j + 2 * t4 + e;
      if (d < hd)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          kst[d * 64 + keyl + 8 * h] =
              __float2bfloat16(dk[4 * j + 2 * h + e] * a.scale);
    }
  fw_wg_sync(wg);
  __nv_bfloat16* dkh = static_cast<__nv_bfloat16*>(a.dkT) + (size_t)b * hd * s;
  for (int i = t; i < 128 * 8; i += 128) {
    const int d = c0 + (i >> 3), u = (i & 7) * 8;
    if (d < hd)
      *reinterpret_cast<uint4*>(dkh + (size_t)d * s + k0 + u) =
          *reinterpret_cast<const uint4*>(kst + d * 64 + u);
  }
}

// dQ past hd 128: one block per (b, 128 query rows); warpgroup wg owns rows
// q0 + 64 wg .. + 64 and their dQ (columns 0-127 in dq0, 128 .. HDP in dq1).
// Per 64-key tile it forms S = Q K^T (A: its Q rows, K-major; B: the K^T
// unit, MN-major) and dP = dO V^T (B: the V unit, K-major), hands V's unit
// back, turns S and dP into dS in registers, and accumulates dQ += dS K
// with dS as register A fragments and the K^T unit as K-major B (its rows
// are hd, its 128-byte rows keys), in two halves of 32 keys.
template <int HDP, bool BIAS, bool DROP>
__global__ void __launch_bounds__(TF_THREADS, 1)
    flash_bwd_dq_wgmma_wide_kernel(
        const __grid_constant__ CUtensorMap qmap,   // q: 64 x 64 boxes
        const __grid_constant__ CUtensorMap omap,   // dout: 64 x 64 boxes
        const __grid_constant__ CUtensorMap kmap,   // kT: 64 keys x HDP rows
        const __grid_constant__ CUtensorMap vmap,   // v: 64 x 64 boxes
        const BwdArgs a) {
  constexpr int NC = HDP / 64;
  constexpr int TILE = NC * FW_BOX;   // 64 rows x HDP of Q or dO; a unit:
                                      // K^T (HDP rows x 64 keys) or V
  constexpr int ST = fw_dq_wide_units(HDP);
  constexpr int N1 = HDP - 128;       // dq1's columns
  extern __shared__ __align__(16) unsigned char fw_raw[];
  unsigned char* base =
      fw_raw + ((TF_ALIGN - (wg_smem(fw_raw) & (TF_ALIGN - 1))) &
                (TF_ALIGN - 1));
  unsigned char* qs = base;               // [2][NC][64 rows][64]
  unsigned char* os = qs + 2 * TILE;      // [2][NC][64 rows][64]
  unsigned char* ring = os + 2 * TILE;    // [ST] units
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * TILE);
  uint64_t* empty = full + ST;
  uint64_t* qbar = empty + ST;

  const int tid = threadIdx.x;
  const int s = a.s, hd = a.hd;
  const int nq = s / FW_DQ_BQ;
  // causal: the bottom tiles have the most K steps; start them first
  const int qi = a.causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int b = blockIdx.x;
  const int q0 = qi * FW_DQ_BQ;
  // a K tile is visited iff its first column is <= the block's last row
  const int ntiles = a.causal ? (q0 + FW_DQ_BQ) / FW_WIDE_BK
                              : s / FW_WIDE_BK;

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], TF_CONSUMERS / 32);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= TF_CONSUMERS) {   // the producer
    tf_producer_regs();
    if (tid == TF_CONSUMERS) {
      mbar_arrive_expect_tx(qbar, 4 * TILE);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < NC; ++c) {
          tma_load_3d(qs + (w * NC + c) * FW_BOX, &qmap, qbar, 64 * c,
                      q0 + 64 * w, b);
          tma_load_3d(os + (w * NC + c) * FW_BOX, &omap, qbar, 64 * c,
                      q0 + 64 * w, b);
        }
      // unit 2 t: V of K tile t; unit 2 t + 1: its K^T
      for (int u = 0; u < 2 * ntiles; ++u) {
        const int st = u % ST;
        if (u >= ST) mbar_wait(&empty[st], ((u / ST) - 1) & 1);
        unsigned char* d = ring + st * TILE;
        const int k0 = (u >> 1) * FW_WIDE_BK;
        mbar_arrive_expect_tx(&full[st], TILE);
        if (u & 1) {
          tma_load_3d(d, &kmap, &full[st], k0, 0, b);
        } else {
          for (int c = 0; c < NC; ++c)
            tma_load_3d(d + c * FW_BOX, &vmap, &full[st], 64 * c, k0, b);
        }
      }
    }
    return;
  }

  tf_consumer_regs();
  const int wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = q0 + 64 * wg + 16 * warp + g;   // fragment rows r0, r0 + 8
  const uint32_t hb = a.hm(b);                   // the hash's batch-head
  const float* bias_h = a.bias ? a.bias + (size_t)b * a.bias_stride : nullptr;
  float lse2[2], del[2];
  const float* brow[2];   // the bias rows of rows r0 and r0 + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse2[h] = a.lse[(size_t)b * s + r0 + 8 * h] * LOG2E;
    del[h] = a.delta[(size_t)b * s + r0 + 8 * h];
    brow[h] = BIAS ? bias_h + (size_t)(r0 + 8 * h) * s : nullptr;
  }
  float dq0[64], dq1[N1 / 2];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < N1 / 2; ++i) dq1[i] = 0.f;
  const unsigned char* qw = qs + wg * TILE;
  const unsigned char* ow = os + wg * TILE;
  mbar_wait(qbar, 0);

  for (int kt = 0; kt < ntiles; ++kt) {
    const int sv = (2 * kt) % ST, sk = (2 * kt + 1) % ST;
    mbar_wait(&full[sv], ((2 * kt) / ST) & 1);
    mbar_wait(&full[sk], ((2 * kt + 1) / ST) & 1);
    const unsigned char* vst = ring + sv * TILE;
    const unsigned char* kst = ring + sk * TILE;
    // S = Q K^T and dP = dO V^T over hd: 64 rows x 64 keys
    float sc[32], dp[32];
    wgmma_fence_operands(sc);
    wgmma_fence_operands(dp);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < HDP / 16; ++j) {
      const int ab = (j >> 2) * FW_BOX + 32 * (j & 3);
      Wg<64>::ss<0, 1>(sc, fw_kmajor(qw + ab),
                       fw_mnmajor(kst + 2048 * j, FW_BOX), j > 0);
      Wg<64>::ss<0, 0>(dp, fw_kmajor(ow + ab), fw_kmajor(vst + ab), j > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_fence_operands(sc);
    wgmma_fence_operands(dp);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[sv]);   // V's unit is free

    // dS, packed to bf16 pairs as the A fragments of dQ += dS K
    const int k0 = kt * FW_WIDE_BK;
    // the tile crosses this group's diagonal
    const bool mask = a.causal && k0 + FW_WIDE_BK - 1 > q0 + 64 * wg;
    uint32_t sa[4][4];
    wgmma_fence_operands(dq0);
    wgmma_fence_operands(dq1);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int j = 4 * half; j < 4 * half + 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float pd[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            fw_grad<BIAS, DROP>(a, brow[h], hb, r0 + 8 * h,
                                k0 + 8 * j + 2 * t4 + e, mask,
                                sc[4 * j + 2 * h + e], dp[4 * j + 2 * h + e],
                                lse2[h], del[h], pd[e], ds[e]);
          sa[j >> 1][2 * (j & 1) + h] = pack_bf16x2(ds[0], ds[1]);
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 2 * half; kk < 2 * half + 2; ++kk) {
        Wg<128>::rs<0>(dq0, sa[kk], fw_kmajor(kst + 32 * kk), 1);
        Wg<N1>::template rs<0>(dq1, sa[kk],
                               fw_kmajor(kst + 128 * 128 + 32 * kk), 1);
      }
      wgmma_commit();
      fw_hold<16, 32>(sc);
      fw_hold<16, 32>(dp);
    }
    wgmma_wait<0>();
    wgmma_fence_operands(dq0);
    wgmma_fence_operands(dq1);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[sk]);   // K^T's unit is free
  }

  __nv_bfloat16* dqh = static_cast<__nv_bfloat16*>(a.dq) + (size_t)b * s * hd;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    __nv_bfloat16* row = dqh + (size_t)(r0 + 8 * h) * hd;
    // hd % 8 == 0: a pair is all in or all out
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int d = 8 * j + 2 * t4;
      if (d < hd)
        store_pair(row + d, dq0[4 * j + 2 * h] * a.scale,
                   dq0[4 * j + 2 * h + 1] * a.scale);
    }
#pragma unroll
    for (int j = 0; j < N1 / 8; ++j) {
      const int d = 128 + 8 * j + 2 * t4;
      if (d < hd)
        store_pair(row + d, dq1[4 * j + 2 * h] * a.scale,
                   dq1[4 * j + 2 * h + 1] * a.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// f32 on TMA-fed FMA tiles (route "tma_fma"). HDP: hd's bucket (64, 128,
// 256); the tile plans are TfDkv<HDP> and TfDq<HDP> (xsmm_flash_fma.cuh).
// ---------------------------------------------------------------------------

template <int HDP>
__global__ void __launch_bounds__(TF_THREADS, 1) flash_bwd_dkv_tma_fma_kernel(
    const __grid_constant__ CUtensorMap kmap,    // kT: the K tile, whole
    const __grid_constant__ CUtensorMap vmap,    // v: the K tile, whole
    const __grid_constant__ CUtensorMap qdmap,   // q: DS-column slices
    const __grid_constant__ CUtensorMap odmap,   // dout: DS-column slices
    const __grid_constant__ CUtensorMap qimap,   // q: IS-row slices
    const __grid_constant__ CUtensorMap oimap,   // dout: IS-row slices
    const __grid_constant__ CUtensorMap lmap,    // lse (bh, s): BQ rows
    const __grid_constant__ CUtensorMap dmap,    // delta (bh, s): BQ rows
    const BwdArgs a) {
  using P = TfDkv<HDP>;
  constexpr int BK = P::BK, BQ = P::BQ, GJ = P::GJ, GC = P::GC, DS = P::DS,
                IS = P::IS;
  constexpr int NIS = BQ / IS;                 // phase-2 stages a Q tile
  extern __shared__ __align__(16) unsigned char tf_raw[];
  unsigned char* base =
      tf_raw + ((TF_ALIGN - (wg_smem(tf_raw) & (TF_ALIGN - 1))) &
                (TF_ALIGN - 1));
  float* kt = reinterpret_cast<float*>(base);  // [HDP][BK] K^T as it lies
  float* vt = kt + HDP * BK;                   // [HDP][BK] V^T (tsw)
  float* pd = vt + HDP * BK;                   // [BQ][BK] p~; V lands here
  float* dsd = pd + BQ * BK;                   // [BQ][BK] p, then dS
  unsigned char* ring = reinterpret_cast<unsigned char*>(dsd + BQ * BK);
  float* ls = reinterpret_cast<float*>(ring + TF_BWD_STAGES * TF_BWD_STAGE);
  float* dls = ls + 2 * BQ;                    // [2][BQ] lse and delta
  uint64_t* full = reinterpret_cast<uint64_t*>(dls + 2 * BQ);
  uint64_t* empty = full + TF_BWD_STAGES;
  uint64_t* kvbar = empty + TF_BWD_STAGES;

  const int tid = threadIdx.x;
  const int s = a.s, hd = a.hd;
  const int b = blockIdx.x;
  const int k0 = blockIdx.y * BK;   // causal: the first tiles have most work
  const int nqt = (s + BQ - 1) / BQ;
  // Q tiles entirely above this K tile's diagonal contribute nothing
  const int qstart = a.causal ? k0 / BQ : 0;
  const int nds = (hd + DS - 1) / DS;          // phase-1 stages a Q tile

  if (tid == 0) {
    for (int i = 0; i < TF_BWD_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], TF_CONSUMERS / 32);
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= TF_CONSUMERS) {   // the producer: one thread starts TMA
    tf_producer_regs();
    if (tid == TF_CONSUMERS) {
      mbar_arrive_expect_tx(kvbar, 2 * HDP * BK * 4);
      tma_load_3d(kt, &kmap, kvbar, k0, 0, b);
      tma_load_3d(pd, &vmap, kvbar, 0, k0, b);
      int it = 0;
      for (int qs = qstart; qs < nqt; ++qs) {
        const int q0 = qs * BQ, buf = (qs - qstart) & 1;
        for (int j = 0; j < nds + NIS; ++j, ++it) {
          const int st = it % TF_BWD_STAGES;
          if (it >= TF_BWD_STAGES)
            mbar_wait(&empty[st], ((it / TF_BWD_STAGES) - 1) & 1);
          unsigned char* dst = ring + st * TF_BWD_STAGE;
          if (j < nds) {
            mbar_arrive_expect_tx(&full[st], 2 * BQ * DS * 4 +
                                                 (j == 0 ? 2 * BQ * 4 : 0));
            tma_load_3d(dst, &qdmap, &full[st], j * DS, q0, b);
            tma_load_3d(dst + BQ * DS * 4, &odmap, &full[st], j * DS, q0, b);
            if (j == 0) {
              tma_load_2d(ls + buf * BQ, &lmap, &full[st], q0, b);
              tma_load_2d(dls + buf * BQ, &dmap, &full[st], q0, b);
            }
          } else {
            const int r0 = q0 + (j - nds) * IS;
            mbar_arrive_expect_tx(&full[st], 2 * IS * HDP * 4);
            tma_load_3d(dst, &oimap, &full[st], 0, r0, b);
            tma_load_3d(dst + IS * HDP * 4, &qimap, &full[st], 0, r0, b);
          }
        }
      }
    }
    return;
  }

  tf_consumer_regs();
  const int lane = tid & 31;
  const bool ga = tid < TF_CONSUMERS / 2;      // S and dV; B: dP and dK
  const int tp = tid & (TF_CONSUMERS / 2 - 1);
  const int jq = tp % GJ, iq = tp / GJ;        // key chunk (lanes), queries
  const int wc = tp % GC, zk = tp / GC;        // hd chunk (lanes), keys
  const uint32_t hb = a.hm(b);                 // the hash's batch-head
  const float* bias_h = a.bias ? a.bias + (size_t)b * a.bias_stride : nullptr;
  float* dbias_h = a.dbias ? a.dbias + (size_t)b * s * s : nullptr;
  const float scale_l2 = a.scale * LOG2E;

  mbar_wait(kvbar, 0);
  transpose_tsw<BK, HDP>(vt, pd, tid);
  if (dbias_h) {   // the skipped Q tiles' dbias blocks are zero
    const int rows = min(s, qstart * BQ);
    for (int i = tid; i < rows * BK / 4; i += TF_CONSUMERS) {
      const int r = i / (BK / 4), c = (i - r * (BK / 4)) * 4;
      st4s(dbias_h + (size_t)r * s + k0 + c, 0.f, 0.f, 0.f, 0.f);
    }
  }
  tf_sync();

  float acc[8][8];   // A: dV, B: dK; [key][hd]
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[j][c] = 0.f;

  int it = 0;
  for (int qs = qstart; qs < nqt; ++qs) {
    const int q0 = qs * BQ, buf = (qs - qstart) & 1;
    // S = Q K^T (A), dP = dO V^T (B) over hd: [query][key]
    float sc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
    for (int js = 0; js < nds; ++js, ++it) {
      const int st = it % TF_BWD_STAGES;
      mbar_wait(&full[st], (it / TF_BWD_STAGES) & 1);
      const float* src = reinterpret_cast<const float*>(
          ring + st * TF_BWD_STAGE) + (ga ? 0 : BQ * DS);
      const int d0 = js * DS;
      const int dn = min(DS, hd - d0);   // a multiple of 8
#pragma unroll 2
      for (int dd = 0; dd < dn; dd += 4) {
        float4 ar[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          ar[i] = ld4s(src + tf_at(iq, i, BQ) * DS + dd);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = d0 + dd + e;
          float w[8];
          if (ga)
            ld8(w, kt + d * BK, jq, jq + BK / 8);
          else
            ld8(w, vt + d * BK, tsw(d, jq), tsw(d, jq + BK / 8));
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float x = comp(ar[i], e);
#pragma unroll
            for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(x, w[j], sc[i][j]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    // every thread is done with the last tile's p~ and dS
    tf_sync();
    if (ga) {   // p from the LSE (undropped, into dS's slot) and p~
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = tf_at(iq, i, BQ), row = q0 + r;
        const float l2 = ls[buf * BQ + r] * LOG2E;
        float p[8], pdrop[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = k0 + tf_at(jq, j, BK);
          float x = sc[i][j] * scale_l2;
          if (bias_h && row < s)
            x = (sc[i][j] * a.scale + bias_h[(size_t)row * s + col]) *
                LOG2E;
          p[j] = (a.causal && col > row) ? 0.f : exp2f(x - l2);
          pdrop[j] = p[j];
          if (a.dropout)
            pdrop[j] = rand_bits(a.seed, hb, (uint32_t)row, (uint32_t)col) >=
                               a.thr
                           ? p[j] * a.inv_keep : 0.f;
        }
        float* prow = pd + r * BK;
        float* drow = dsd + r * BK;
        st4s(prow + 4 * jq, pdrop[0], pdrop[1], pdrop[2], pdrop[3]);
        st4s(prow + BK / 2 + 4 * jq, pdrop[4], pdrop[5], pdrop[6], pdrop[7]);
        st4s(drow + 4 * jq, p[0], p[1], p[2], p[3]);
        st4s(drow + BK / 2 + 4 * jq, p[4], p[5], p[6], p[7]);
      }
    }
    tf_sync();
    if (!ga) {  // dS = p (dP~ - delta), dP~ the replayed mask's; dbias = dS
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = tf_at(iq, i, BQ), row = q0 + r;
        const float del = dls[buf * BQ + r];
        float* drow = dsd + r * BK;
        float p[8];
        ld8(p, drow, jq, jq + BK / 8);
        float ds[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float dp = sc[i][j];
          if (a.dropout) {
            const int col = k0 + tf_at(jq, j, BK);
            dp = rand_bits(a.seed, hb, (uint32_t)row, (uint32_t)col) >= a.thr
                     ? dp * a.inv_keep : 0.f;
          }
          ds[j] = p[j] * (dp - del);
        }
        st4s(drow + 4 * jq, ds[0], ds[1], ds[2], ds[3]);
        st4s(drow + BK / 2 + 4 * jq, ds[4], ds[5], ds[6], ds[7]);
        if (dbias_h && row < s) {
          float* brow = dbias_h + (size_t)row * s + k0;
          st4s(brow + 4 * jq, ds[0], ds[1], ds[2], ds[3]);
          st4s(brow + BK / 2 + 4 * jq, ds[4], ds[5], ds[6], ds[7]);
        }
      }
    }
    tf_sync();

    // dV += p~^T dO (A), dK += dS^T Q (B) over the tile's rows
    const float* at = ga ? pd : dsd;
    for (int r = 0; r < NIS; ++r, ++it) {
      const int st = it % TF_BWD_STAGES;
      mbar_wait(&full[st], (it / TF_BWD_STAGES) & 1);
      const float* bt = reinterpret_cast<const float*>(
          ring + st * TF_BWD_STAGE) + (ga ? 0 : IS * HDP);
#pragma unroll 8
      for (int ii = 0; ii < IS; ++ii) {
        float x[8], w[8];
        ld8(x, at + (r * IS + ii) * BK, zk, zk + BK / 8);
        ld8(w, bt + ii * HDP, wc, wc + HDP / 8);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[j][c] = fmaf(x[j], w[c], acc[j][c]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
  }

  if (ga) {   // dV rows, cast once (f32: as they are)
    float* dvh = static_cast<float*>(a.dv) + (size_t)b * s * hd;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* vrow = dvh + (size_t)(k0 + tf_at(zk, j, BK)) * hd;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = h * (HDP / 2) + 4 * wc;
        if (c < hd)   // hd % 8 == 0: a 4-column group is all in or all out
          st4s(vrow + c, acc[j][4 * h], acc[j][4 * h + 1], acc[j][4 * h + 2],
               acc[j][4 * h + 3]);
      }
    }
  } else {    // dK^T rows (hd, s), scaled once
    float* dkh = static_cast<float*>(a.dkT) + (size_t)b * hd * s;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int d = tf_at(wc, c, HDP);
      if (d >= hd) continue;
      float* krow = dkh + (size_t)d * s + k0;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        st4s(krow + h * (BK / 2) + 4 * zk, acc[4 * h][c] * a.scale,
             acc[4 * h + 1][c] * a.scale, acc[4 * h + 2][c] * a.scale,
             acc[4 * h + 3][c] * a.scale);
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(TF_THREADS, 1) flash_bwd_dq_tma_fma_kernel(
    const __grid_constant__ CUtensorMap qmap,    // q: the Q tile, whole
    const __grid_constant__ CUtensorMap omap,    // dout: the dO tile, whole
    const __grid_constant__ CUtensorMap kdmap,   // kT: DK-row slices
    const __grid_constant__ CUtensorMap vdmap,   // v: DK-column slices
    const __grid_constant__ CUtensorMap kjmap,   // kT: JS-column slices
    const BwdArgs a) {
  using P = TfDq<HDP>;
  constexpr int BQ = P::BQ, BK = P::BK, GI = P::GI, KS = P::KS, DK = P::DK,
                JS = P::JS;
  constexpr int NJS = BK / JS;                 // phase-2 stages a K tile
  constexpr int JH = JS / KS;                  // a stage's keys a half
  extern __shared__ __align__(16) unsigned char tf_raw[];
  unsigned char* base =
      tf_raw + ((TF_ALIGN - (wg_smem(tf_raw) & (TF_ALIGN - 1))) &
                (TF_ALIGN - 1));
  float* qt = reinterpret_cast<float*>(base);  // [HDP][BQ] Q^T (tsw)
  float* ot = qt + HDP * BQ;                   // [HDP][BQ] dO^T (tsw); the
                                               // landed Q tile first
  float* dst = ot + HDP * BQ;                  // [BK][BQ] p, then dS^T
  unsigned char* ring = reinterpret_cast<unsigned char*>(dst + BK * BQ);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring +
                                               TF_BWD_STAGES * TF_BWD_STAGE);
  uint64_t* empty = full + TF_BWD_STAGES;
  uint64_t* qbar = empty + TF_BWD_STAGES;
  uint64_t* obar = qbar + 1;

  const int tid = threadIdx.x;
  const int s = a.s, hd = a.hd;
  const int nq = (s + BQ - 1) / BQ;
  // causal: the bottom tiles have the most K steps; start them first
  const int qi = a.causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int b = blockIdx.x;
  const int q0 = qi * BQ;
  // a K tile is visited iff its first column is <= the tile's last row
  const int kend = a.causal ? min(s, q0 + BQ) : s;
  const int ntiles = (kend + BK - 1) / BK;
  const int nds = (hd + DK - 1) / DK;          // phase-1 stages a K tile

  if (tid == 0) {
    for (int i = 0; i < TF_BWD_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], TF_CONSUMERS / 32);
    }
    mbar_init(qbar, 1);
    mbar_init(obar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= TF_CONSUMERS) {   // the producer
    tf_producer_regs();
    if (tid >= TF_CONSUMERS + 32) return;
    if (tid == TF_CONSUMERS) {   // Q into dO^T's place, dO into the ring
      mbar_arrive_expect_tx(qbar, BQ * HDP * 4);
      tma_load_3d(ot, &qmap, qbar, 0, q0, b);
      mbar_arrive_expect_tx(obar, BQ * HDP * 4);
      tma_load_3d(ring, &omap, obar, 0, q0, b);
    }
    tf_sync_all();   // the consumers are done with the landed tiles
    if (tid == TF_CONSUMERS) {
      int it = 0;
      for (int t = 0; t < ntiles; ++t) {
        const int k0 = t * BK;
        for (int j = 0; j < nds + NJS; ++j, ++it) {
          const int st = it % TF_BWD_STAGES;
          if (it >= TF_BWD_STAGES)
            mbar_wait(&empty[st], ((it / TF_BWD_STAGES) - 1) & 1);
          unsigned char* d = ring + st * TF_BWD_STAGE;
          if (j < nds) {
            mbar_arrive_expect_tx(&full[st], 2 * DK * BK * 4);
            tma_load_3d(d, &kdmap, &full[st], k0, j * DK, b);
            tma_load_3d(d + DK * BK * 4, &vdmap, &full[st], j * DK, k0, b);
          } else {
            mbar_arrive_expect_tx(&full[st], HDP * JS * 4);
            tma_load_3d(d, &kjmap, &full[st], k0 + (j - nds) * JS, 0, b);
          }
        }
      }
    }
    return;
  }

  tf_consumer_regs();
  const int lane = tid & 31;
  const bool ga = tid < TF_CONSUMERS / 2;      // S^T; B: dP^T
  const int tp = tid & (TF_CONSUMERS / 2 - 1);
  const int u = tid % GI;                      // query chunk (lanes)
  const int v = tp / GI;                       // key set (S^T, dP^T)
  const int cv = (tid / GI) % (HDP / 8);       // hd set (dQ^T)
  const int kh = tid / (GI * (HDP / 8));       // its half of the keys
  const uint32_t hb = a.hm(b);                 // the hash's batch-head
  const float* bias_h = a.bias ? a.bias + (size_t)b * a.bias_stride : nullptr;
  const float scale_l2 = a.scale * LOG2E;

  mbar_wait(qbar, 0);
  transpose_tsw<BQ, HDP>(qt, ot, tid);
  tf_sync();                                   // the landed Q is read
  mbar_wait(obar, 0);
  transpose_tsw<BQ, HDP>(ot, reinterpret_cast<const float*>(ring), tid);
  tf_sync_all();

  // A: lse (log2 units), B: delta, of the thread's eight query rows
  float stat[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + tf_at(u, i, BQ);
    stat[i] = row >= s ? 0.f
              : ga     ? a.lse[(size_t)b * s + row] * LOG2E
                       : a.delta[(size_t)b * s + row];
  }

  float acc[8][8];   // dQ^T: [hd][query]
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[c][i] = 0.f;

  int it = 0;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    // S^T = K Q^T (A), dP^T = V dO^T (B) over hd: [key][query]
    float sc[8][8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) sc[j][i] = 0.f;
    for (int js = 0; js < nds; ++js, ++it) {
      const int st = it % TF_BWD_STAGES;
      mbar_wait(&full[st], (it / TF_BWD_STAGES) & 1);
      const float* kd =
          reinterpret_cast<const float*>(ring + st * TF_BWD_STAGE);
      const float* vd = kd + DK * BK;          // [BK][DK]
      const int d0 = js * DK;
      const int dn = min(DK, hd - d0);   // a multiple of 8
      if (ga) {
        for (int d8 = 0; d8 < dn; d8 += 8) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int dd = d8 + e, d = d0 + dd;
            float w[8], x[8];
            ld8(w, kd + dd * BK, v, v + BK / 8);
            ld8(x, qt + d * BQ, tsw(d, u), tsw(d, u + BQ / 8));
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int i = 0; i < 8; ++i)
                sc[j][i] = fmaf(w[j], x[i], sc[j][i]);
          }
        }
      } else {
#pragma unroll 2
        for (int dd = 0; dd < dn; dd += 4) {
          float4 vr[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            vr[j] = ld4s(vd + tf_at(v, j, BK) * DK + dd);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = d0 + dd + e;
            float x[8];
            ld8(x, ot + d * BQ, tsw(d, u), tsw(d, u + BQ / 8));
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float w = comp(vr[j], e);
#pragma unroll
              for (int i = 0; i < 8; ++i) sc[j][i] = fmaf(w, x[i], sc[j][i]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    // every thread is done with the last tile's dS^T
    tf_sync();
    if (ga) {   // p from the LSE, undropped
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kc = tf_at(v, j, BK), col = k0 + kc;
        float p[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = q0 + tf_at(u, i, BQ);
          float x = sc[j][i] * scale_l2;
          if (bias_h && row < s)
            x = (sc[j][i] * a.scale + bias_h[(size_t)row * s + col]) *
                LOG2E;
          p[i] = (a.causal && col > row) ? 0.f : exp2f(x - stat[i]);
        }
        float* drow = dst + kc * BQ;
        st4s(drow + 4 * u, p[0], p[1], p[2], p[3]);
        st4s(drow + BQ / 2 + 4 * u, p[4], p[5], p[6], p[7]);
      }
    }
    tf_sync();
    if (!ga) {  // dS = p (dP~ - delta), dP~ the replayed mask's
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kc = tf_at(v, j, BK), col = k0 + kc;
        float* drow = dst + kc * BQ;
        float p[8];
        ld8(p, drow, u, u + BQ / 8);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float dp = sc[j][i];
          if (a.dropout) {
            const int row = q0 + tf_at(u, i, BQ);
            dp = rand_bits(a.seed, hb, (uint32_t)row, (uint32_t)col) >= a.thr
                     ? dp * a.inv_keep : 0.f;
          }
          p[i] = p[i] * (dp - stat[i]);
        }
        st4s(drow + 4 * u, p[0], p[1], p[2], p[3]);
        st4s(drow + BQ / 2 + 4 * u, p[4], p[5], p[6], p[7]);
      }
    }
    tf_sync();

    // dQ^T += K^T-rows dS^T over the tile's keys
    for (int js = 0; js < NJS; ++js, ++it) {
      const int st = it % TF_BWD_STAGES;
      mbar_wait(&full[st], (it / TF_BWD_STAGES) & 1);
      const float* kj =
          reinterpret_cast<const float*>(ring + st * TF_BWD_STAGE) + kh * JH;
#pragma unroll 2
      for (int jj = 0; jj < JH; jj += 4) {
        float4 kr[8];
#pragma unroll
        for (int c = 0; c < 8; ++c)
          kr[c] = ld4s(kj + tf_at(cv, c, HDP) * JS + jj);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x[8];
          ld8(x, dst + (js * JS + kh * JH + jj + e) * BQ, u, u + BQ / 8);
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const float w = comp(kr[c], e);
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[c][i] = fmaf(w, x[i], acc[c][i]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
  }

  if (KS > 1) {   // the second half's partial dQ^T onto the first's
    float* red = qt;   // [HDP][BQ], every thread done with Q^T
    tf_sync();
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (kh == 1) {
        float* rrow = red + tf_at(cv, c, HDP) * BQ;
        st4s(rrow + 4 * u, acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
        st4s(rrow + BQ / 2 + 4 * u, acc[c][4], acc[c][5], acc[c][6],
             acc[c][7]);
      }
    tf_sync();
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float x[8];
      ld8(x, red + tf_at(cv, c, HDP) * BQ, u, u + BQ / 8);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[c][i] += x[i];
    }
  }

  // dQ = dQ^T's transpose, scaled once
  float* dqh = static_cast<float*>(a.dq) + (size_t)b * s * hd;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + tf_at(u, i, BQ);
    if (row >= s) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = h * (HDP / 2) + 4 * cv;
      if (kh == 0 && c < hd)
        st4s(dqh + (size_t)row * hd + c, acc[4 * h][i] * a.scale,
             acc[4 * h + 1][i] * a.scale, acc[4 * h + 2][i] * a.scale,
             acc[4 * h + 3][i] * a.scale);
    }
  }
}

// the TMA maps (f32, no swizzle) and the launches; q, kT, v, dout, lse and
// delta 16-byte aligned
struct TfMaps {
  cuuint64_t rows[3], rstr[2], cols[3], cstr[2], stat[2], sstr[1];
  TfMaps(int bh, int s, int hd) {
    const cuuint64_t S = (cuuint64_t)s, H = (cuuint64_t)hd;
    rows[0] = H; rows[1] = S; rows[2] = (cuuint64_t)bh;   // (bh, s, hd)
    rstr[0] = H * 4; rstr[1] = S * H * 4;
    cols[0] = S; cols[1] = H; cols[2] = (cuuint64_t)bh;   // (bh, hd, s)
    cstr[0] = S * 4; cstr[1] = H * S * 4;
    stat[0] = S; stat[1] = (cuuint64_t)bh;                // (bh, s)
    sstr[0] = S * 4;
  }
  bool rowmap(CUtensorMap* m, const void* p, cuuint32_t w, cuuint32_t h) {
    const cuuint32_t box[3] = {w, h, 1};
    return encode_map(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p, 3, rows, rstr,
                      box, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  bool colmap(CUtensorMap* m, const void* p, cuuint32_t w, cuuint32_t h) {
    const cuuint32_t box[3] = {w, h, 1};
    return encode_map(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p, 3, cols, cstr,
                      box, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  bool statmap(CUtensorMap* m, const void* p, cuuint32_t w) {
    const cuuint32_t box[2] = {w, 1};
    return encode_map(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p, 2, stat, sstr,
                      box, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
};

template <int HDP>
static int launch_dkv_tma_fma(int bh, const BwdArgs& a, cudaStream_t st) {
  using P = TfDkv<HDP>;
  TfMaps m(bh, a.s, a.hd);
  CUtensorMap km, vm, qd, od, qi, oi, lm, dm;
  if (!m.colmap(&km, a.kT, P::BK, HDP) || !m.rowmap(&vm, a.v, HDP, P::BK) ||
      !m.rowmap(&qd, a.q, P::DS, P::BQ) ||
      !m.rowmap(&od, a.dout, P::DS, P::BQ) ||
      !m.rowmap(&qi, a.q, HDP, P::IS) || !m.rowmap(&oi, a.dout, HDP, P::IS) ||
      !m.statmap(&lm, a.lse, P::BQ) || !m.statmap(&dm, a.delta, P::BQ))
    return cudaErrorInvalidValue;
  constexpr int smem = tf_dkv_smem(HDP);
  auto kern = flash_bwd_dkv_tma_fma_kernel<HDP>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  note_launch(kern);
  kern<<<dim3(bh, a.s / P::BK), TF_THREADS, smem, st>>>(km, vm, qd, od, qi,
                                                        oi, lm, dm, a);
  return cudaGetLastError();
}

template <int HDP>
static int launch_dq_tma_fma(int bh, const BwdArgs& a, cudaStream_t st) {
  using P = TfDq<HDP>;
  TfMaps m(bh, a.s, a.hd);
  CUtensorMap qm, om, kd, vd, kj;
  if (!m.rowmap(&qm, a.q, HDP, P::BQ) || !m.rowmap(&om, a.dout, HDP, P::BQ) ||
      !m.colmap(&kd, a.kT, P::BK, P::DK) ||
      !m.rowmap(&vd, a.v, P::DK, P::BK) || !m.colmap(&kj, a.kT, P::JS, HDP))
    return cudaErrorInvalidValue;
  constexpr int smem = tf_dq_smem();
  auto kern = flash_bwd_dq_tma_fma_kernel<HDP>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  note_launch(kern);
  kern<<<dim3(bh, (a.s + P::BQ - 1) / P::BQ), TF_THREADS, smem, st>>>(
      qm, om, kd, vd, kj, a);
  return cudaGetLastError();
}

static int run_tma_fma(int which, const BwdArgs& a, int bh, void* stream) {
  const int s = a.s, hd = a.hd;
  if (s <= 0 || s % 128 || hd <= 0 || hd % 8 || hd > 256 || bh <= 0 ||
      (reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.kT) |
       reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout) |
       reinterpret_cast<uintptr_t>(a.lse) |
       reinterpret_cast<uintptr_t>(a.delta)) % 16)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (which == 0) {
    if (hd <= 64) return launch_dkv_tma_fma<64>(bh, a, st);
    if (hd <= 128) return launch_dkv_tma_fma<128>(bh, a, st);
    return launch_dkv_tma_fma<256>(bh, a, st);
  }
  if (hd <= 64) return launch_dq_tma_fma<64>(bh, a, st);
  if (hd <= 128) return launch_dq_tma_fma<128>(bh, a, st);
  return launch_dq_tma_fma<256>(bh, a, st);
}

// the bf16 TMA maps (128-byte swizzle, boxes 64 wide) and the launches; q,
// kT, v, dout, lse and delta 16-byte aligned
struct FwMaps {
  cuuint64_t rows[3], rstr[2], cols[3], cstr[2];
  FwMaps(int bh, int s, int hd) {
    const cuuint64_t S = (cuuint64_t)s, H = (cuuint64_t)hd;
    rows[0] = H; rows[1] = S; rows[2] = (cuuint64_t)bh;   // (bh, s, hd)
    rstr[0] = H * 2; rstr[1] = S * H * 2;
    cols[0] = S; cols[1] = H; cols[2] = (cuuint64_t)bh;   // (bh, hd, s)
    cstr[0] = S * 2; cstr[1] = H * S * 2;
  }
  // boxes of 64 columns (hd) x h rows
  bool rowmap(CUtensorMap* m, const void* p, cuuint32_t h) {
    const cuuint32_t box[3] = {64, h, 1};
    return encode_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, 3, rows, rstr,
                      box);
  }
  // boxes of 64 columns (s) x h rows (hd)
  bool colmap(CUtensorMap* m, const void* p, cuuint32_t h) {
    const cuuint32_t box[3] = {64, h, 1};
    return encode_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, 3, cols, cstr,
                      box);
  }
};

// a kernel of the wgmma route with its maps, on TF_THREADS threads
template <typename K, typename... Maps>
static int launch_fw(K kern, int smem, dim3 grid, cudaStream_t st,
                     const BwdArgs& a, const Maps&... maps) {
  // above 48 KB only as dynamic shared memory, after the opt-in
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  note_launch(kern);
  kern<<<grid, TF_THREADS, smem, st>>>(maps..., a);
  return cudaGetLastError();
}

// dK/dV: the 128-key plan up to a padded hd of 128, the wide (64-key) plan
// past it
template <int HDP, bool BIAS, bool DROP>
static int launch_dkv_wgmma(int bh, const BwdArgs& a, cudaStream_t st) {
  FwMaps f(bh, a.s, a.hd);
  TfMaps m(bh, a.s, a.hd);
  CUtensorMap km, vm, qm, om, lm, dm;
  if (!f.colmap(&km, a.kT, HDP) || !f.rowmap(&vm, a.v, 64) ||
      !f.rowmap(&qm, a.q, 64) || !f.rowmap(&om, a.dout, 64) ||
      !m.statmap(&lm, a.lse, FW_BQ) || !m.statmap(&dm, a.delta, FW_BQ))
    return cudaErrorInvalidValue;
  if constexpr (HDP > FW_HDP_MAX)
    return launch_fw(flash_bwd_dkv_wgmma_wide_kernel<HDP, BIAS, DROP>,
                     fw_dkv_wide_smem(HDP), dim3(bh, a.s / FW_WIDE_BKV), st,
                     a, km, vm, qm, om, lm, dm);
  else
    return launch_fw(flash_bwd_dkv_wgmma_kernel<HDP, BIAS, DROP>,
                     fw_dkv_smem(HDP), dim3(bh, a.s / FW_BKV), st, a, km, vm,
                     qm, om, lm, dm);
}

// dQ: 128-key tiles up to a padded hd of 128, 64-key units past it
template <int HDP, bool BIAS, bool DROP>
static int launch_dq_wgmma(int bh, const BwdArgs& a, cudaStream_t st) {
  constexpr bool wide = HDP > FW_HDP_MAX;
  FwMaps f(bh, a.s, a.hd);
  CUtensorMap qm, om, km, vm;
  if (!f.rowmap(&qm, a.q, 64) || !f.rowmap(&om, a.dout, 64) ||
      !f.colmap(&km, a.kT, HDP) ||
      !f.rowmap(&vm, a.v, wide ? FW_WIDE_BK : FW_DQ_BK))
    return cudaErrorInvalidValue;
  if constexpr (wide)
    return launch_fw(flash_bwd_dq_wgmma_wide_kernel<HDP, BIAS, DROP>,
                     fw_dq_wide_smem(HDP), dim3(bh, a.s / FW_DQ_BQ), st, a,
                     qm, om, km, vm);
  else
    return launch_fw(flash_bwd_dq_wgmma_kernel<HDP, BIAS, DROP>,
                     fw_dq_smem(HDP), dim3(bh, a.s / FW_DQ_BQ), st, a, qm,
                     om, km, vm);
}

// bf16 at every hd the entries take (<= 256): the wgmma kernels, hd padded
// to 64, 128, 192 or 256 (kernels/attention.py flash_bwd_path names the
// route, bwd_configs the tile)
static int run_wgmma(int which, const BwdArgs& a, int bh, void* stream) {
  const int s = a.s, hd = a.hd;
  if (s <= 0 || s % FW_BKV || s / FW_WIDE_BKV > 65535 || hd <= 0 ||
      hd % 8 || hd > FW_FWD_HDP_MAX || bh <= 0 || (a.dbias && !a.bias) ||
      (reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.kT) |
       reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dout) |
       reinterpret_cast<uintptr_t>(a.lse) |
       reinterpret_cast<uintptr_t>(a.delta)) % 16)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the instantiation: hd's bucket, a bias (or dbias), dropout
  const int bucket = hd <= 64 ? 0 : hd <= 128 ? 1 : hd <= 192 ? 2 : 3;
  const int k = bucket * 4 + (a.bias != nullptr) * 2 + (a.dropout != 0);
  using Launch = int (*)(int, const BwdArgs&, cudaStream_t);
#define XSMM_FW_BUCKET(L, HDP)                                   \
  L<HDP, false, false>, L<HDP, false, true>, L<HDP, true, false>, \
      L<HDP, true, true>
  if (which == 0) {
    constexpr Launch dkv[16] = {XSMM_FW_BUCKET(launch_dkv_wgmma, 64),
                                XSMM_FW_BUCKET(launch_dkv_wgmma, 128),
                                XSMM_FW_BUCKET(launch_dkv_wgmma, 192),
                                XSMM_FW_BUCKET(launch_dkv_wgmma, 256)};
    return dkv[k](bh, a, st);
  }
  constexpr Launch dq[16] = {XSMM_FW_BUCKET(launch_dq_wgmma, 64),
                             XSMM_FW_BUCKET(launch_dq_wgmma, 128),
                             XSMM_FW_BUCKET(launch_dq_wgmma, 192),
                             XSMM_FW_BUCKET(launch_dq_wgmma, 256)};
#undef XSMM_FW_BUCKET
  return dq[k](bh, a, st);
}

// the type picks the kernels (kernels/attention.py flash_bwd_path): f32 the
// TMA-fed FMA ones (one tile per hd bucket), bf16 the wgmma ones (one plan
// up to a padded hd of 128, the wide one past it)
static int run(int which, BwdArgs& a, int bh, int type, void* stream) {
  if (type == T_F32) return run_tma_fma(which, a, bh, stream);
  if (type != T_BF16) return cudaErrorInvalidValue;
  return run_wgmma(which, a, bh, stream);
}

extern "C" {

const char* xsmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, v, dout: (bh, s, hd); kT: (bh, hd, s); lse, delta: f32 (bh, s); bias:
// f32 (s, s) per head at bias + b * bias_stride, or null; dkT: (bh, hd, s);
// dv: (bh, s, hd); dbias: f32 (bh, s, s) or null; q, kT, v, dout, lse and
// delta 16-byte aligned. hd % 8 == 0, hd <= 256, s % 128 == 0. bf16 runs
// the wgmma kernels (the wide ones past hd 128), f32 the TMA-fed FMA ones.
// (b0, h0, nhl, nhg): the dropout hash's head map (HeadMap,
// xsmm_common.cuh); 0, 0, 1, 1 hashes the local batch-head. A refused map or
// launch returns its error; the wrapper raises.
int xsmm_flash_bwd_dkv(const void* q, const void* kT, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       const float* bias, long long bias_stride, void* dkT,
                       void* dv, float* dbias, int bh, int s, int hd, int type,
                       float scale, int causal, int dropout,
                       unsigned seed, unsigned thr, float inv_keep,
                       unsigned b0, unsigned h0, unsigned nhl, unsigned nhg,
                       void* stream) {
  if (nhl == 0 || nhg == 0) return cudaErrorInvalidValue;
  BwdArgs a{q, kT, v, dout, lse, delta, bias, bias_stride, nullptr, dkT, dv,
            dbias, s, hd, scale, causal, dropout, seed, thr, inv_keep,
            HeadMap{b0, h0, nhl, nhg}};
  return run(0, a, bh, type, stream);
}

// the same operands; dq: (bh, s, hd)
int xsmm_flash_bwd_dq(const void* q, const void* kT, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const float* bias, long long bias_stride, void* dq,
                      int bh, int s, int hd, int type, float scale,
                      int causal, int dropout, unsigned seed, unsigned thr,
                      float inv_keep, unsigned b0, unsigned h0, unsigned nhl,
                      unsigned nhg, void* stream) {
  if (nhl == 0 || nhg == 0) return cudaErrorInvalidValue;
  BwdArgs a{q, kT, v, dout, lse, delta, bias, bias_stride, dq, nullptr,
            nullptr, nullptr, s, hd, scale, causal, dropout, seed, thr,
            inv_keep, HeadMap{b0, h0, nhl, nhg}};
  return run(1, a, bh, type, stream);
}

}  // extern "C"
