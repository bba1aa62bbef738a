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
// flash_fwd_wgmma_kernel, bf16 (route "wgmma"; its section below, the plan
// in xsmm_flash_wgmma.cuh). One block of one producer warpgroup (TMA into a
// ring of K^T and V tiles, 128 keys up to hd 128 and 64 past it, full and
// empty mbarriers, registers handed back by setmaxnreg) and two consumer
// warpgroups of 64 query rows each takes one (b, 128-row Q tile): S = Q K^T
// and O += P V by wgmma, S, O and P in registers (160 a thread at hd 128),
// the softmax on S's accumulator fragments, P fed from registers as A;
// each group's softmax runs while its last tile's P V and the other
// group's products do.
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
#include "xsmm_flash_wgmma.cuh"
#include "xsmm_launches.cuh"

enum { T_F32 = 0, T_BF16 = 1 };

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// bf16 on wgmma (route "wgmma"), hd padded to HDP = 64, 128, 192 or 256;
// the plan, budgets and instructions are xsmm_flash_wgmma.cuh's (up to hd
// 128 the tiles of the backward's dQ kernel; past it 64-key tiles,
// fw_fwd_bk). Threads 0-255 are the consumer warpgroups (wg = tid / 128),
// 256-383 the producer.
//
// One block per (b, 128 query rows); warpgroup wg owns rows q0 + 64 wg ..
// + 64: their running max m and denominator l (log2 units) and their O
// accumulator (64 x HDP f32) in registers. Per BK-key tile it forms S = Q
// K^T (A: its Q rows, K-major; B: the K^T tile, MN-major), scales, biases
// and masks S on its accumulator fragments (the causal test only on the
// tiles that cross the group's diagonal), takes the row max over the quad
// of lanes that shares a row (two shuffles), rescales O and l by the change
// of the max, and accumulates O += P V with P (the dropped, rescaled
// exponentials rounded to bf16) as register A fragments and the V tile as
// MN-major B. The exponentials, not the products, would set the time (the
// backward's finding), so they run while the tensor cores work: each group
// issues tile kt's S with tile kt - 1's P V and takes tile kt's softmax
// while both run, and the two groups take turns issuing (ping-pong on two
// named barriers), so one group's softmax overlaps the other's products.
// A consumer thread holds S (BK / 2), O (HDP / 2) and P (BK / 4 bf16
// pairs): 160 registers at hd 128, 176 at hd 256. Past hd 128, O += P V runs
// in chunks of 128 columns of hd (and one of 64 at hd 192).
// ---------------------------------------------------------------------------

template <int HDP, bool BIAS, bool DROP>
__global__ void __launch_bounds__(TF_THREADS, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap,   // q: 64 x 64 boxes
    const __grid_constant__ CUtensorMap kmap,   // kT: 64 keys x HDP rows
    const __grid_constant__ CUtensorMap vmap,   // v: 64 hd x BK keys boxes
    const float* __restrict__ bias, long long bias_stride,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int s, int hd,
    float scale, int causal, uint32_t seed, HeadMap hm, uint32_t thr,
    float inv_keep) {
  constexpr int BK = fw_fwd_bk(HDP);         // keys a tile
  constexpr int NC = HDP / 64;               // 64-column boxes of hd
  constexpr int TILE = NC * FW_BOX;          // 64 rows x HDP of Q
  constexpr int KT_BOX = HDP * 128;          // K^T: HDP rows x 64 keys
  constexpr int V_BOX = BK * 128;            // V: BK keys x 64 hd
  constexpr int STAGE = BK / 64 * KT_BOX + NC * V_BOX;   // K^T and V
  constexpr int ST = fw_fwd_stages(HDP);
  constexpr int SN = BK / 2;                 // S's accumulators a thread
  constexpr int KS = BK / 16;                // P V's k16 steps
  extern __shared__ __align__(16) unsigned char fw_raw[];
  // the swizzle is a function of the shared address: 1024-byte aligned
  unsigned char* base =
      fw_raw + ((TF_ALIGN - (wg_smem(fw_raw) & (TF_ALIGN - 1))) &
                (TF_ALIGN - 1));
  unsigned char* qs = base;               // [2][NC][64 rows][64]
  unsigned char* ring = qs + 2 * TILE;    // [ST] {K^T, V [NC][BK][64]}
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ST * STAGE);
  uint64_t* empty = full + ST;
  uint64_t* qbar = empty + ST;

  const int tid = threadIdx.x;
  const int nq = s / FW_DQ_BQ;
  // causal: the tiles nearest the bottom have the most K steps; start them
  // first so the short ones fill in behind
  const int qi = causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int b = blockIdx.x;
  const int q0 = qi * FW_DQ_BQ;
  // a K tile is visited iff its first column is <= the tile's last row
  const int ntiles = causal ? (q0 + FW_DQ_BQ) / BK : s / BK;

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], TF_CONSUMERS / 32);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= TF_CONSUMERS) {   // the producer: one thread starts TMA
    tf_producer_regs();
    if (tid == TF_CONSUMERS) {
      mbar_arrive_expect_tx(qbar, 2 * TILE);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < NC; ++c)
          tma_load_3d(qs + (w * NC + c) * FW_BOX, &qmap, qbar, 64 * c,
                      q0 + 64 * w, b);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % ST;
        if (t >= ST) mbar_wait(&empty[st], ((t / ST) - 1) & 1);
        unsigned char* d = ring + st * STAGE;
        const int k0 = t * BK;
        mbar_arrive_expect_tx(&full[st], STAGE);
        for (int h = 0; h < BK / 64; ++h)
          tma_load_3d(d + h * KT_BOX, &kmap, &full[st], k0 + 64 * h, 0, b);
        for (int c = 0; c < NC; ++c)
          tma_load_3d(d + BK / 64 * KT_BOX + c * V_BOX, &vmap, &full[st],
                      64 * c, k0, b);
      }
    }
    return;
  }

  tf_consumer_regs();
  const int wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = q0 + 64 * wg + 16 * warp + g;   // fragment rows r0, r0 + 8
  const uint32_t hb = hm(b);                     // the hash's batch-head
  const float* brow[2];   // the bias rows of rows r0 and r0 + 8
#pragma unroll
  for (int h = 0; h < 2; ++h)
    brow[h] = BIAS ? bias + (size_t)b * bias_stride + (size_t)(r0 + 8 * h) * s
                   : nullptr;
  const float scale_l2 = scale * LOG2E;
  float o[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
  float m_r[2] = {-FLT_MAX, -FLT_MAX};   // rows r0, r0 + 8, log2 units
  float l_r[2] = {0.f, 0.f};             // this lane's share of the sums
  const unsigned char* qw = qs + wg * TILE;
  mbar_wait(qbar, 0);

  // the pieces of a tile: S's product (async); the softmax on S's
  // fragments (scale, bias and causal mask in log2 units, the row max over
  // the quad, l updated with the undropped exponentials, the exponentials
  // then dropped and rescaled in place, O's rescale returned in alpha); P
  // packed to bf16 pairs (the A fragments of P V); O's rescale and O += P
  // V (async)
  auto s_product = [&](float (&sc)[SN], const unsigned char* kst) {
    wgmma_fence_operands(sc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < HDP / 16; ++j)
      Wg<BK>::template ss<0, 1>(
          sc, fw_kmajor(qw + (j >> 2) * FW_BOX + 32 * (j & 3)),
          fw_mnmajor(kst + 2048 * j, KT_BOX), j > 0);
    wgmma_commit();
  };
  auto softmax = [&](float (&sc)[SN], int kt, float (&alpha)[2]) {
    const int k0 = kt * BK;
    const bool mask = causal && k0 + BK - 1 > q0 + 64 * wg;
    float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = k0 + 8 * j + 2 * t4;
        float2 x = make_float2(sc[4 * j + 2 * h] * scale_l2,
                               sc[4 * j + 2 * h + 1] * scale_l2);
        if (BIAS) {
          const float2 bv = *reinterpret_cast<const float2*>(brow[h] + col);
          x.x = (sc[4 * j + 2 * h] * scale + bv.x) * LOG2E;
          x.y = (sc[4 * j + 2 * h + 1] * scale + bv.y) * LOG2E;
        }
        if (mask) {
          const int row = r0 + 8 * h;
          if (col > row) x.x = -FLT_MAX;
          if (col + 1 > row) x.y = -FLT_MAX;
        }
        sc[4 * j + 2 * h] = x.x;
        sc[4 * j + 2 * h + 1] = x.y;
        mx[h] = fmaxf(mx[h], fmaxf(x.x, x.y));
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h]);
      alpha[h] = fw_exp2(m_r[h] - m_new);
      m_r[h] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        sc[4 * j + 2 * h] = fw_exp2(sc[4 * j + 2 * h] - m_new);
        sc[4 * j + 2 * h + 1] = fw_exp2(sc[4 * j + 2 * h + 1] - m_new);
        rs += sc[4 * j + 2 * h] + sc[4 * j + 2 * h + 1];
      }
      l_r[h] = l_r[h] * alpha[h] + rs;
      if (DROP) {   // e_use: dropped and rescaled, after l's sum
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const uint32_t row = (uint32_t)(r0 + 8 * h);
          const uint32_t col = (uint32_t)(k0 + 8 * j + 2 * t4);
          sc[4 * j + 2 * h] = rand_bits(seed, hb, row, col) >= thr
                                  ? sc[4 * j + 2 * h] * inv_keep : 0.f;
          sc[4 * j + 2 * h + 1] = rand_bits(seed, hb, row, col + 1) >= thr
                                      ? sc[4 * j + 2 * h + 1] * inv_keep
                                      : 0.f;
        }
      }
    }
  };
  auto pack = [&](const float (&sc)[SN], uint32_t (&pa)[KS][4]) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        pa[j >> 1][2 * (j & 1) + h] =
            pack_bf16x2(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]);
  };
  // O's columns 128 c .. in o[64 c ..]: a chunk of 128 columns is two
  // boxes of V (the leading offset V_BOX between them), a last chunk of 64
  // one box
  auto pv = [&](const float (&alpha)[2], uint32_t (&pa)[KS][4],
                const unsigned char* vst) {
    wgmma_fence_operands(o);
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[4 * j + i] *= alpha[i >> 1];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int c = 0; c < HDP / 128; ++c)
        Wg<128>::template rs<1>(
            *reinterpret_cast<float(*)[64]>(o + 64 * c), pa[kk],
            fw_mnmajor(vst + 2 * c * V_BOX + 2048 * kk, V_BOX), 1);
      if constexpr (HDP % 128 != 0)
        Wg<64>::template rs<1>(
            *reinterpret_cast<float(*)[32]>(o + HDP / 2 - 32), pa[kk],
            fw_mnmajor(vst + (NC - 1) * V_BOX + 2048 * kk, V_BOX), 1);
    }
    wgmma_commit();
  };
  // ping-pong: a warpgroup issues its products only on its turn (named
  // barrier 5 + wg, which the other group's pass() completes), so one
  // group's softmax runs while the other's products do
  auto turn = [&]() {
    asm volatile("bar.sync %0, 256;\n" ::"r"(5 + wg) : "memory");
  };
  auto pass = [&]() {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(6 - wg) : "memory");
  };
  auto stage_of = [&](int kt) { return ring + (kt % ST) * STAGE; };

  // S of tile kt is issued with O += P V of tile kt - 1, and tile kt's
  // softmax runs while the latter's products do
  float sc[SN], alpha[2];
  uint32_t pa[KS][4];
  if (wg == 1) pass();   // warpgroup 0 takes the first turn
  mbar_wait(&full[0], 0);
  turn();
  s_product(sc, stage_of(0));
  pass();
  wgmma_wait<0>();
  wgmma_fence_operands(sc);
  softmax(sc, 0, alpha);
  pack(sc, pa);
  for (int kt = 1; kt < ntiles; ++kt) {
    const int st = kt % ST;
    mbar_wait(&full[st], (kt / ST) & 1);
    turn();
    s_product(sc, stage_of(kt));
    pv(alpha, pa, stage_of(kt - 1) + BK / 64 * KT_BOX);
    pass();
    wgmma_wait<1>();   // S of tile kt
    wgmma_fence_operands(sc);
    softmax(sc, kt, alpha);
    wgmma_wait<0>();   // P V of tile kt - 1: its stage goes back
    wgmma_fence_operands(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(kt - 1) % ST]);
    pack(sc, pa);
  }
  turn();
  pv(alpha, pa, stage_of(ntiles - 1) + BK / 64 * KT_BOX);
  pass();
  wgmma_wait<0>();
  wgmma_fence_operands(o);
  if (wg == 0) turn();   // warpgroup 1's first pass()

  // out = O / l, cast once; lse = m + log(l) in all 128 columns of the row,
  // 32 a lane of the quad
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = r0 + 8 * h;
    __nv_bfloat16* orow = out + ((size_t)b * s + row) * hd;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int d = 8 * j + 2 * t4;   // hd % 8 == 0: the pair is all in or
      if (d < hd)                     // all out
        store_pair(orow + d, o[4 * j + 2 * h] / l, o[4 * j + 2 * h + 1] / l);
    }
    if (lse) {
      const float val = m_r[h] * LN2 + logf(l);   // m back in natural units
      float4* lrow = reinterpret_cast<float4*>(
          lse + ((size_t)b * s + row) * 128 + t4 * 32);
#pragma unroll
      for (int c = 0; c < 8; ++c) lrow[c] = make_float4(val, val, val, val);
    }
  }
}

// q, kT, v bf16 and 16-byte aligned: the three TMA maps (128-byte swizzle,
// boxes 64 wide: q in 64 x 64 boxes, kT in boxes of 64 keys x HDP rows, v in
// boxes of 64 hd x BK keys), then the launch
template <int HDP, bool BIAS, bool DROP>
static int launch_flash_wgmma(const void* q, const void* kT, const void* v,
                              const void* bias, long long bias_stride,
                              void* out, void* lse, int bh, int s, int hd,
                              float scale, int causal, uint32_t seed,
                              HeadMap hm, uint32_t thr, float inv_keep,
                              cudaStream_t stream) {
  const cuuint64_t S = (cuuint64_t)s, H = (cuuint64_t)hd;
  const cuuint64_t rows[3] = {H, S, (cuuint64_t)bh};     // q, v: (bh, s, hd)
  const cuuint64_t rstr[2] = {H * 2, S * H * 2};
  const cuuint64_t cols[3] = {S, H, (cuuint64_t)bh};     // kT: (bh, hd, s)
  const cuuint64_t cstr[2] = {S * 2, H * S * 2};
  const cuuint32_t qbox[3] = {64, 64, 1};
  const cuuint32_t kbox[3] = {64, HDP, 1};
  const cuuint32_t vbox[3] = {64, fw_fwd_bk(HDP), 1};
  CUtensorMap qmap, kmap, vmap;
  const CUtensorMapDataType B = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!encode_map(&qmap, B, q, 3, rows, rstr, qbox) ||
      !encode_map(&kmap, B, kT, 3, cols, cstr, kbox) ||
      !encode_map(&vmap, B, v, 3, rows, rstr, vbox))
    return cudaErrorInvalidValue;
  constexpr int smem = fw_fwd_smem(HDP);
  auto kern = flash_fwd_wgmma_kernel<HDP, BIAS, DROP>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, s / FW_DQ_BQ);
  note_launch(kern);
  kern<<<grid, TF_THREADS, smem, stream>>>(
      qmap, kmap, vmap, static_cast<const float*>(bias), bias_stride,
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), s, hd,
      scale, causal, seed, hm, thr, inv_keep);
  return cudaGetLastError();
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
// aligned. The type picks the kernel (kernels/attention.py flash_path): f32
// the TMA-fed FMA kernel, bf16 the wgmma kernel (s % 128 == 0), one tile
// per hd bucket each. (b0, h0, nhl, nhg): the dropout hash's head map
// (HeadMap); 0, 0, 1, 1 hashes the local batch-head index. A refused map or
// launch returns its error; the wrapper raises.
int xsmm_flash_fwd(const void* q, const void* kT, const void* v,
                   const void* bias, long long bias_stride, void* out,
                   void* lse, int bh, int s, int hd, int type, float scale,
                   int causal, int dropout, unsigned seed, unsigned thr,
                   float inv_keep, unsigned b0, unsigned h0, unsigned nhl,
                   unsigned nhg, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s <= 0 || s % 64 || s / 64 > 65535 || hd <= 0 || hd % 8 || hd > 256 ||
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
  if (type != T_BF16 || s % FW_DQ_BQ) return cudaErrorInvalidValue;
  // the instantiation: hd's bucket (64, 128, 192, 256), a bias, dropout
  const int k = ((hd - 1) / 64) * 4 + (bias != nullptr) * 2 + (dropout != 0);
  using Launch = int (*)(const void*, const void*, const void*, const void*,
                         long long, void*, void*, int, int, int, float, int,
                         uint32_t, HeadMap, uint32_t, float, cudaStream_t);
  constexpr Launch fwd[16] = {
      launch_flash_wgmma<64, false, false>,
      launch_flash_wgmma<64, false, true>,
      launch_flash_wgmma<64, true, false>,
      launch_flash_wgmma<64, true, true>,
      launch_flash_wgmma<128, false, false>,
      launch_flash_wgmma<128, false, true>,
      launch_flash_wgmma<128, true, false>,
      launch_flash_wgmma<128, true, true>,
      launch_flash_wgmma<192, false, false>,
      launch_flash_wgmma<192, false, true>,
      launch_flash_wgmma<192, true, false>,
      launch_flash_wgmma<192, true, true>,
      launch_flash_wgmma<256, false, false>,
      launch_flash_wgmma<256, false, true>,
      launch_flash_wgmma<256, true, false>,
      launch_flash_wgmma<256, true, true>};
  return fwd[k](q, kT, v, bias, bias_stride, out, lse, bh, s, hd, scale,
                causal, seed, hm, thr, inv_keep, st);
}

}  // extern "C"
