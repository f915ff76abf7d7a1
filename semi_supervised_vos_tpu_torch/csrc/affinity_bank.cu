// Bank-direct label propagation for Hopper (sm_90a).
//
// Replaces two TPU kernels of semi_supervised_vos_tpu/ops/affinity_pallas.py:
// affinity_from_bank_batched (body _bank_kernel) and, launched on a gathered
// reference set seen as a one-video bank with slots 0..K-1,
// affinity_propagate_pallas (body _kernel; ops/affinity.py::
// affinity_propagate_fused folds its temperature into the bank). Per target
// pixel q of video b it streams the K sampled slots straight from the ring
// memory bank by slot index (no gather) and computes, with an online softmax,
//
//   s    = ref . (T tgt) + pad_bias + slot_bias        (-1e30 biases)
//   m'   = max(m, max_rows s);  e = exp(s - m')
//   l    = l exp(m - m') + sum_rows e                   (unweighted)
//   w    = exp(-dy^2 invsigma2_slot) exp(-dx^2 invsigma2_slot)
//          (dy = (r - q) / wd, a fractional row; dx = r mod wd - q mod wd)
//   acc  = acc exp(m - m') + labels^T (hi + lo)   (e w split into two bf16
//                                                   terms, hi = bf16(e w),
//                                                   lo = bf16(e w - hi))
//   out  = acc / l          (or the raw m, l, acc in stats mode)
//
// What bounds it on the H100: at 480p (K 9, P 6420, C 256) the similarity
// product is 2 K P^2 C = 190 GFLOP (0.19 ms at the 989 TFLOP/s bf16 rate),
// and the K P^2 = 371 M softmax exps take 0.09 ms on the MUFU pipe (16 a
// clock per SM). HBM is no limit (the sampled bank is ~32 MB), but the
// traffic from L2 into the SMs is: every block streams the whole sampled
// bank, 9 x 6420 x (256 + 24) x 2 B = 32.4 MB, so a block that owns TQ
// target rows moves ceil(P / TQ) x 32.4 MB per frame. The first port had
// TQ = 32 (6.5 GB a frame); this design takes TQ = 128, which gives
// 51 x 32.4 MB = 1.65 GB a frame.
//
// Design:
// - One block of 8 warps (two warpgroups) owns TQ = 128 target rows of one
//   video; each warp holds its 16 rows' A fragments (C / 16 k-steps) in
//   registers for the whole sweep.
// - Bank tiles of TM = 64 rows arrive by TMA into a 4-stage ring in shared
//   memory, one thread issuing, an mbarrier per stage counting the bytes:
//   the features through a 3-D tensor map whose box lands in the wgmma
//   core-matrix layout, the labels (up to 64 columns) as a dense tile.
// - S = tgt . ref^T: per warpgroup, C / 16 wgmma m64n64k16 (bf16 in, f32
//   accumulators in registers; A from registers, B from shared memory).
//   The online softmax runs on those registers (row max by quad shuffles,
//   exp2 of (s - m) log2 e, m and l kept per thread); e w is split into
//   bf16 hi and lo in registers and used directly as the A operand of the
//   label product (mma.sync m16n8k16, B by ldmatrix.trans from the label
//   tile); acc stays in registers. No fragment goes through shared memory.
// - One exp per pair: the prior factors into a row factor exp(-dy^2 s),
//   which takes TM + TQ - 1 values per (bank tile, target tile), and a
//   column factor exp(-dx^2 s), which takes 2 wd - 1 values; both are
//   tabulated in shared memory (double-buffered, built one tile ahead), so
//   the MUFU pipe runs only e's exp per pair. With the prior off
//   (invsigma2 0) the tables are skipped.
// - Split over the bank (flash-decoding): the (slot, bank tile) sweep of a
//   target tile is cut into `splits` contiguous ranges, one block each, so
//   that the grid fills the 132 SMs (480p, B 1: 51 target tiles x 5
//   splits); each block writes partial (m, l, acc), and a second kernel
//   combines them as bank shards combine: m* = max m, out = sum acc
//   e^(m - m*) / sum l e^(m - m*). The split count comes from a small wave
//   model (affinity_bank_plan).
// - A (bank tile, target tile) pair whose minimum row gap gives w <=
//   exp(-36) skips its label product (the TPU kernel's far-tile skip, same
//   threshold).
// - Shared memory at C 256 and wd 107: ring 4 x 40,960 B (a 64 x 256
//   feature tile, a 64 x 64 label tile) + prior tables + barriers = 167,712
//   B; the target tile (128 x 264 x 2 B) is staged in the first two stages.
// What still holds it back: one block per SM (233 registers a thread) and
// a barrier per tile keep both warpgroups in step, so the tensor cores idle
// while the softmax, the prior tables and the label product (mma.sync, N =
// D_pad) run.
//
// Numerics traps handled: the running max starts at -1e30, never -inf, so an
// all-invalid first tile cannot give inf - inf; rows past the bank's end get
// -inf (they never enter the max, which is >= -1e30); rows >= P get the
// -1e30 padding bias; label classes past d_pad are never loaded, so padded
// classes stay exactly 0; a split whose slots are all invalid has m =
// -1e30 and weighs e^(-1e30 - m*) = 0 in the combine unless every split is
// invalid, where it gives the unsplit result (every weight 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bank_split.cuh"
#include "hopper_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int TM = 64;                // bank rows per tile
constexpr int TQ = 128;               // target rows per block (8 warps x 16)
constexpr int kThreads = 256;
constexpr int kStages = 4;            // cp.async ring depth
constexpr int kMaxCK = 16;            // C / 16 <= 16: C <= 256
constexpr int kMaxND = 8;             // label columns per launch <= 64
constexpr int kMaxSplits = 64;
constexpr int kFyLen = TM + TQ - 1;
constexpr float kNegInf = -1e30f;
constexpr float kTileSkipThresh = 36.0f;
constexpr float kLog2e = 1.4426950408889634f;

// The bank (cap, B, P_loc, C) features and (cap, B, P_loc, D_pad) labels
// arrive through TMA tensor maps (kernel parameters of their own).
struct Params {
  const bf16* target;       // (B, P, C), temperature folded in
  const int* table;  // (3, K): slot, bits of inv_sigma2, bits of the slot bias
  float* pm;         // (splits, B, P) partial running max
  float* pl;         // (splits, B, P) partial denominators
  float* pacc;       // (splits, B, D_pad, P) partial numerators
  int batch, p_loc, c, d_pad, d_off, dw, p, wd, row_base, k;
  int tiles_per_slot, n_iter, iters_per_split;
};

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

struct Smem {
  size_t feat, stage, fy, fx, rx, bars, total;
};

// Ring of kStages stages, each filled by two TMA loads: a feature tile
// stored as wgmma core matrices (16-byte chunk kc of bank row n at
// kc x TM x 16 + n x 16 bytes, the box order of the 3-D tensor map), then
// a dense TM x dw label tile. The target tile (rows padded to C + 8) is
// staged through the first two stages before the sweep starts.
__host__ __device__ inline Smem smem_layout(int c, int wd) {
  Smem o;
  o.feat = align128(size_t(TM) * c * 2);
  o.stage = align128(o.feat + size_t(TM) * kMaxND * 8 * 2);
  o.fy = kStages * o.stage;
  o.fx = align128(o.fy + 2 * kFyLen * 4);
  o.rx = align128(o.fx + size_t(2) * (2 * wd - 1) * 4);
  o.bars = align128(o.rx + 2 * TM * 4);
  o.total = align128(o.bars + kStages * 8);
  return o;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <bool kC256>
__global__ void __launch_bounds__(kThreads, 1)
    affinity_bank_kernel(const __grid_constant__ CUtensorMap feat_map, const __grid_constant__ CUtensorMap lab_map,
                         Params prm) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = kC256 ? 256 : prm.c;
  const int CK = C / 16, LDF = C + 8, vpr = C / 8;
  const Smem lay = smem_layout(C, prm.wd);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * TQ, split = blockIdx.y, b = blockIdx.z;
  const int it_begin = split * prm.iters_per_split;
  const int it_end = min(prm.n_iter, it_begin + prm.iters_per_split);
  const int nd = prm.dw / 8;
  const int wd = prm.wd;
  const float wdf = float(wd);
  float* fy_s = reinterpret_cast<float*>(smem + lay.fy);
  float* fx_s = reinterpret_cast<float*>(smem + lay.fx);
  int* rx_s = reinterpret_cast<int*>(smem + lay.rx);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);  // one per stage
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + s, 1);
    fence_mbar_init();
  }

  // ---- the target tile, through shared memory into A fragments ----------
  uint32_t qa[kMaxCK][4];
  {
    bf16* tgt_s = reinterpret_cast<bf16*>(smem);
    for (int v = tid; v < TQ * vpr; v += kThreads) {
      const int n = v / vpr, cv = v - n * vpr;
      const bool ok = q0 + n < prm.p;
      cp_async16(tgt_s + n * LDF + cv * 8,
                 prm.target + (size_t(b) * prm.p + (ok ? q0 + n : 0)) * C + cv * 8, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kMaxCK; ++kk)
      if (kk < CK) ldmatrix_x4(qa[kk], tgt_s + (warp * 16 + (lane & 15)) * LDF + kk * 16 + (lane >> 4) * 8);
    fence_proxy_async();  // these reads come before the TMA writes below
    __syncthreads();      // the region becomes the ring
  }
  const uint32_t stage_bytes = uint32_t(TM) * (C + prm.dw) * 2;

  // thread 0 only: the TMA loads of iteration `it` into its ring stage.
  // Rows past the slot's end are loaded too (the next slot's, or zeros past
  // the bank) and masked to -inf below.
  auto issue = [&](int it) {
    if (it >= it_end) return;
    const int ks = it / prm.tiles_per_slot;
    const int lrow0 = (it - ks * prm.tiles_per_slot) * TM;
    const int row = (__ldg(prm.table + ks) * prm.batch + b) * prm.p_loc + lrow0;
    const int s = (it - it_begin) % kStages;
    unsigned char* st = smem + size_t(s) * lay.stage;
    mbar_expect_tx(full + s, stage_bytes);
    tma_load_3d(st, &feat_map, full + s, 0, row, 0);
    tma_load_2d(st + lay.feat, &lab_map, full + s, prm.d_off, row);
  };

  // prior tables of iteration `it` into buffer `buf`
  auto build = [&](int it, int buf) {
    if (it >= it_end) return;
    const int ks = it / prm.tiles_per_slot;
    const float inv_s = __int_as_float(__ldg(prm.table + prm.k + ks));
    if (inv_s == 0.f) return;
    const int r0 = prm.row_base + (it - ks * prm.tiles_per_slot) * TM;
    float* fy = fy_s + buf * kFyLen;
    float* fx = fx_s + buf * (2 * wd - 1);
    int* rx = rx_s + buf * TM;
    for (int j = tid; j < kFyLen; j += kThreads) {
      const float dy = float(r0 + j - (TQ - 1) - q0) / wdf;
      fy[j] = expf(-dy * dy * inv_s);
    }
    for (int j = tid; j < 2 * wd - 1; j += kThreads) {
      const float dx = float(j - (wd - 1));
      fx[j] = expf(-dx * dx * inv_s);
    }
    for (int j = tid; j < TM; j += kThreads) rx[j] = (r0 + j) % wd;
  };

  float acc[kMaxND][4];
#pragma unroll
  for (int i = 0; i < kMaxND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  const int qloc = warp * 16 + g;  // this thread's rows: qloc and qloc + 8
  const int qx[2] = {(q0 + qloc) % wd, (q0 + qloc + 8) % wd};

  if (tid == 0)
    for (int s = 0; s < kStages - 1; ++s) issue(it_begin + s);
  build(it_begin, 0);

  for (int it = it_begin; it < it_end; ++it) {
    const int i = it - it_begin;
    __syncthreads();  // iteration i - 1 is done with its stage and tables
    if (tid == 0) issue(it + kStages - 1);
    mbar_wait(full + i % kStages, (i / kStages) & 1);
    const unsigned char* st = smem + size_t(i % kStages) * lay.stage;
    const bf16* fs = reinterpret_cast<const bf16*>(st);
    const bf16* ls = reinterpret_cast<const bf16*>(st + lay.feat);
    const int ks = it / prm.tiles_per_slot;
    const int lrow0 = (it - ks * prm.tiles_per_slot) * TM;
    const float inv_s = __int_as_float(__ldg(prm.table + prm.k + ks));
    const float slot_bias = __int_as_float(__ldg(prm.table + 2 * prm.k + ks));
    const int r0 = prm.row_base + lrow0;

    // ---- S = tgt . ref^T: 64 target rows x 64 bank rows per warpgroup ---
    float sc[8][4];
    fence_operands(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kMaxCK; ++kk)
      if (kk < CK) wgmma_m64n64k16(sc, qa[kk], smem_desc(fs + 2 * kk * TM * 8, TM * 16, 128), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);

    // ---- biases, online softmax -----------------------------------------
    const bool ragged = (lrow0 + TM > prm.p_loc) || (r0 + TM > prm.p);
    float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sc[n][e] + slot_bias;
        if (ragged) {
          const int c = n * 8 + 2 * t + (e & 1);
          if (lrow0 + c >= prm.p_loc)
            s = __int_as_float(0xff800000);  // -inf
          else if (r0 + c >= prm.p)
            s += kNegInf;
        }
        sc[n][e] = s;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
      const float m_new = fmaxf(m_r[h], tmax[h]);
      alpha[h] = fast_exp2((m_r[h] - m_new) * kLog2e);
      m_r[h] = m_new;
      l_r[h] *= alpha[h];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // (s - m) first: with s = m = -1e30 an FFMA s log2e - m log2e
        // would leave m's rounding error (~1e23) in the exponent
        const float ev = fast_exp2((sc[n][e] - m_r[e >> 1]) * kLog2e);
        l_r[e >> 1] += ev;
        sc[n][e] = ev;
      }
#pragma unroll
    for (int d = 0; d < kMaxND; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    // ---- far-tile test: uniform over the block ---------------------------
    const float ry_lo = float(r0) / wdf, ry_hi = float(r0 + TM - 1) / wdf;
    const float ty_lo = float(q0) / wdf, ty_hi = float(q0 + TQ - 1) / wdf;
    const float dy_gap = fmaxf(fmaxf(ty_lo - ry_hi, ry_lo - ty_hi), 0.f);
    if (dy_gap * dy_gap * inv_s < kTileSkipThresh) {
      // ---- e w (two table reads, no exp) ---------------------------------
      if (inv_s != 0.f) {
        const float* fy = fy_s + (i & 1) * kFyLen;
        const float* fx = fx_s + (i & 1) * (2 * wd - 1);
        const int* rx = rx_s + (i & 1) * TM;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = n * 8 + 2 * t + j;
            const int rxc = rx[c] + wd - 1;
            sc[n][j] *= fy[c - qloc + TQ - 1] * fx[rxc - qx[0]];
            sc[n][j + 2] *= fy[c - qloc - 8 + TQ - 1] * fx[rxc - qx[1]];
          }
      }
      // ---- acc += (e w)_hi . labels + (e w)_lo . labels ------------------
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float v0 = sc[2 * j + (h >> 1)][2 * (h & 1)], v1 = sc[2 * j + (h >> 1)][2 * (h & 1) + 1];
          ahi[h] = pack_bf16(v0, v1);
          alo[h] = pack_bf16(v0 - bf16_lo(ahi[h]), v1 - bf16_hi(ahi[h]));
        }
        const bf16* lrow = ls + (16 * j + (lane & 15)) * prm.dw;
#pragma unroll
        for (int d = 0; d < kMaxND; d += 2) {
          if (d + 1 < nd) {
            uint32_t bl[4];
            ldmatrix_x4_trans(bl, lrow + (d + (lane >> 4)) * 8);
            mma_bf16(acc[d], ahi, bl[0], bl[1]);
            mma_bf16(acc[d], alo, bl[0], bl[1]);
            mma_bf16(acc[d + 1], ahi, bl[2], bl[3]);
            mma_bf16(acc[d + 1], alo, bl[2], bl[3]);
          } else if (d < nd) {
            uint32_t bl[2];
            ldmatrix_x2_trans(bl, lrow + d * 8);
            mma_bf16(acc[d], ahi, bl[0], bl[1]);
            mma_bf16(acc[d], alo, bl[0], bl[1]);
          }
        }
      }
    }
    build(it + 1, (i + 1) & 1);
  }

  // ---- partial (m, l, acc) of this split ---------------------------------
  const size_t sb = size_t(split) * prm.batch + b;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int q = q0 + qloc + 8 * h;
    if (q >= prm.p) continue;
    if (t == 0) {
      prm.pm[sb * prm.p + q] = m_r[h];
      prm.pl[sb * prm.p + q] = l;
    }
#pragma unroll
    for (int d = 0; d < kMaxND; ++d) {
      if (d < nd) {
        const int col = prm.d_off + d * 8 + 2 * t;
        prm.pacc[(sb * prm.d_pad + col) * prm.p + q] = acc[d][2 * h];
        prm.pacc[(sb * prm.d_pad + col + 1) * prm.p + q] = acc[d][2 * h + 1];
      }
    }
  }
}

// out = sum_s acc_s e^(m_s - m*) / sum_s l_s e^(m_s - m*), m* = max_s m_s;
// in stats mode (m*, the denominator, the numerator).
__global__ void affinity_combine_kernel(const float* __restrict__ pm, const float* __restrict__ pl,
                                        const float* __restrict__ pacc, float* __restrict__ out,
                                        float* __restrict__ m_out, float* __restrict__ l_out, int splits,
                                        int batch, int p, int d_pad, int return_stats) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= batch * p) return;
  const int b = idx / p, q = idx - b * p;
  float ms = pm[size_t(b) * p + q];
  for (int s = 1; s < splits; ++s) ms = fmaxf(ms, pm[(size_t(s) * batch + b) * p + q]);
  float l = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t o = (size_t(s) * batch + b) * p + q;
    l += pl[o] * expf(pm[o] - ms);
  }
  const float inv_l = 1.f / fmaxf(l, 1e-30f);
  for (int d = 0; d < d_pad; ++d) {
    float a = 0.f;
    for (int s = 0; s < splits; ++s) {
      const size_t sb = size_t(s) * batch + b;
      a += pacc[(sb * d_pad + d) * p + q] * expf(pm[sb * p + q] - ms);
    }
    out[(size_t(b) * d_pad + d) * p + q] = return_stats ? a : a * inv_l;
  }
  if (return_stats) {
    m_out[size_t(b) * p + q] = ms;
    l_out[size_t(b) * p + q] = l;
  }
}

// Tensor maps of one sweep: the features as a 3-D tensor (8 channels,
// rows, C / 8 chunks) whose (8, TM, C / 8) box lands chunk-major (the
// core-matrix layout), and the labels as (D_pad, rows) with a (dw, TM) box.
// Boxes past the bank's last row fill with zeros.
cudaError_t make_maps(const void* feats, const void* labels, long long rows, int c, int d_pad, int dw,
                      CUtensorMap* feat_map, CUtensorMap* lab_map) {
  EncodeTiled encode = encode_tiled();  // hopper_mma.cuh
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t fdim[3] = {8, cuuint64_t(rows), cuuint64_t(c / 8)};
  const cuuint64_t fstride[2] = {cuuint64_t(c) * 2, 16};
  const cuuint32_t fbox[3] = {8, TM, cuuint32_t(c / 8)};
  const cuuint32_t ones[3] = {1, 1, 1};
  CUresult r = encode(feat_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(feats), fdim, fstride, fbox,
                      ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  const cuuint64_t ldim[2] = {cuuint64_t(d_pad), cuuint64_t(rows)};
  const cuuint64_t lstride[1] = {cuuint64_t(d_pad) * 2};
  const cuuint32_t lbox[2] = {cuuint32_t(dw), TM};
  r = encode(lab_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(labels), ldim, lstride, lbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool kC256>
cudaError_t prepare(int c, int wd, size_t* smem) {
  *smem = smem_layout(c, wd).total;
  return cudaFuncSetAttribute(affinity_bank_kernel<kC256>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(*smem));
}

}  // namespace

// How the sweep is cut: `splits` blocks per target tile, each over
// `iters_per_split` (slot, bank tile) iterations, by the wave model of
// bank_split.cuh on this device's SMs at this kernel's occupancy. Returns a
// cudaError_t.
extern "C" int affinity_bank_plan(int k, int batch, int p_loc, int c, int p, int wd, int* splits,
                                  int* iters_per_split) {
  if (k < 1 || c % 16 != 0 || c < 16 || c > 16 * kMaxCK || p < 1 || wd < 1 || batch < 1 || p_loc < 1)
    return int(cudaErrorInvalidValue);
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  size_t smem = 0;
  if (err == cudaSuccess) err = c == 256 ? prepare<true>(c, wd, &smem) : prepare<false>(c, wd, &smem);
  if (err == cudaSuccess)
    err = c == 256 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, affinity_bank_kernel<true>, kThreads, smem)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, affinity_bank_kernel<false>, kThreads, smem);
  if (err != cudaSuccess) return int(err);
  if (occ < 1) return int(cudaErrorInvalidConfiguration);
  const long long n_iter = (long long)k * ((p_loc + TM - 1) / TM);
  const long long tiles = (long long)((p + TQ - 1) / TQ) * batch;
  bank_split::choose(n_iter, tiles, (long long)sms * occ, kMaxSplits, splits, iters_per_split);
  return 0;
}

// Launches the sweep on `stream` for label columns [d_off, d_off + dw) of
// d_pad (dw a multiple of 8, at most 64), writing the partials; returns a
// cudaError_t (0 on success). `table` is a device array of 3 k int32: the
// k slots, then the bits of the k inv_sigma2 and of the k slot biases.
extern "C" int affinity_bank_launch(const void* bank_feats, const void* bank_labels, const void* target,
                                    void* pm, void* pl, void* pacc, const void* table, int k, int cap,
                                    int batch, int p_loc, int c, int d_pad, int d_off, int dw, int p, int wd,
                                    int row_base, int splits, int iters_per_split, void* stream) {
  if (k < 1 || cap < 1 || c % 16 != 0 || c < 16 || c > 16 * kMaxCK || d_pad % 8 != 0 || dw % 8 != 0 || dw < 8 ||
      dw > 8 * kMaxND || d_off % 8 != 0 || d_off + dw > d_pad || p < 1 || wd < 1 || batch < 1 ||
      p_loc < 1 || splits < 1 || splits > kMaxSplits || iters_per_split < 1)
    return int(cudaErrorInvalidValue);
  const long long rows = (long long)cap * batch * p_loc;
  if (rows > 0x7fffffffll) return int(cudaErrorInvalidValue);  // TMA coordinates are int32
  CUtensorMap feat_map, lab_map;
  cudaError_t err = make_maps(bank_feats, bank_labels, rows, c, d_pad, dw, &feat_map, &lab_map);
  if (err != cudaSuccess) return int(err);
  Params prm;
  prm.target = static_cast<const bf16*>(target);
  prm.table = static_cast<const int*>(table);
  prm.pm = static_cast<float*>(pm);
  prm.pl = static_cast<float*>(pl);
  prm.pacc = static_cast<float*>(pacc);
  prm.batch = batch;
  prm.p_loc = p_loc;
  prm.c = c;
  prm.d_pad = d_pad;
  prm.d_off = d_off;
  prm.dw = dw;
  prm.p = p;
  prm.wd = wd;
  prm.row_base = row_base;
  prm.k = k;
  prm.tiles_per_slot = (p_loc + TM - 1) / TM;
  prm.n_iter = k * prm.tiles_per_slot;
  prm.iters_per_split = iters_per_split;
  size_t smem = 0;
  err = c == 256 ? prepare<true>(c, wd, &smem) : prepare<false>(c, wd, &smem);
  if (err != cudaSuccess) return int(err);
  dim3 grid((p + TQ - 1) / TQ, splits, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 256)
    affinity_bank_kernel<true><<<grid, kThreads, smem, s>>>(feat_map, lab_map, prm);
  else
    affinity_bank_kernel<false><<<grid, kThreads, smem, s>>>(feat_map, lab_map, prm);
  return int(cudaGetLastError());
}

// Combines the partials into out (B, D_pad, P): acc / l, or in stats mode
// the combined numerator, with m_out and l_out (B, P).
extern "C" int affinity_combine_launch(const void* pm, const void* pl, const void* pacc, void* out, void* m_out,
                                       void* l_out, int splits, int batch, int p, int d_pad, int return_stats,
                                       void* stream) {
  if (splits < 1 || batch < 1 || p < 1 || d_pad < 1) return int(cudaErrorInvalidValue);
  const int n = batch * p, threads = 256;
  affinity_combine_kernel<<<(n + threads - 1) / threads, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pm), static_cast<const float*>(pl), static_cast<const float*>(pacc),
      static_cast<float*>(out), static_cast<float*>(m_out), static_cast<float*>(l_out), splits, batch, p, d_pad,
      return_stats);
  return int(cudaGetLastError());
}
