// Bank-direct label propagation for Hopper (sm_90a), float32 features.
//
// Replaces the TPU kernel semi_supervised_vos_tpu/ops/affinity_pallas.py
// affinity_from_bank_batched (body _bank_kernel) when the bank is float32
// (SVOS_INFER_DTYPE=float32): the similarity is a float32 x float32 product
// there (affinity_pallas.py:437-442, :274), which the bf16 kernel of
// csrc/affinity_bank.cu cannot compute. Same function, per target pixel q of
// video b, over the K sampled slots read straight from the ring bank:
//
//   s    = ref . (T tgt) + pad_bias + slot_bias        (-1e30 biases)
//   m'   = max(m, max_rows s);  e = exp(s - m')
//   l    = l exp(m - m') + sum_rows e                   (unweighted)
//   w    = exp(-dy^2 invsigma2_slot) exp(-dx^2 invsigma2_slot)
//   acc  = acc exp(m - m') + labels^T (hi + lo)   (labels bf16; e w split
//                                                   into hi = bf16(e w) and
//                                                   lo = bf16(e w - hi))
//   out  = acc / l          (or the raw m, l, acc in stats mode)
//
// The target, the bank and s stay float32 end to end: no TF32 and no bf16
// split of the features.
//
// What bounds it on the H100: the similarity, 2 K P^2 C flops (190 GFLOP at
// 480p: K 9, P 6420, C 256), at the float32 rate outside the tensor cores
// (2 x 128 FFMA lanes x 132 SMs x 1980 MHz = 67 TFLOP/s): 2.8 ms. The K P^2
// exps (0.09 ms on the MUFU pipe) and the label product (2 x 24 flops a
// pair) are small beside it; the sampled bank (59 MB) streams from L2.
//
// Design (simple first; 3xTF32 on wgmma is later work):
// - One block of 256 threads owns TQ = 64 target rows of one video, held in
//   shared memory for the whole sweep; bank tiles of TM = 64 rows x C and
//   their label columns arrive by cp.async into a two-stage ring, the next
//   tile loading while this one computes.
// - Each thread computes a 4 x 4 block of the 64 x 64 similarity tile
//   (target rows ty + 16 i, bank rows tx + 16 j) by FFMA from float4 reads
//   of both tiles (rows padded to C + 4 floats: conflict-free).
// - The online softmax runs on those registers (row max over the 16 threads
//   of a row group by shuffles, exp2 of (s - m) log2 e); e w is split into
//   bf16 hi and lo as the bf16 kernel does, and hi + lo (exact in float32)
//   multiplies the bf16 label rows into per-thread float32 accumulators,
//   summed over the row group once at the end.
// - The prior is factored as in the bf16 kernel: a row table exp(-dy^2 s)
//   of TM + TQ - 1 values and a column table exp(-dx^2 s) of 2 wd - 1 per
//   tile, so no exp runs per pair for it; a (bank tile, target tile) pair
//   whose row gap gives w <= exp(-36) skips the label product.
// - The sweep is split over blocks by the plan of bank_split.cuh and the
//   partials are combined by affinity_combine_kernel of csrc/affinity_bank.cu.
// - Label columns: up to 24 per sweep (one sweep at the 22-class budget).
// Shared memory at C 256, wd 240: target 66,560 B + ring 2 x (66,560 +
// 3,072) B + tables = 208 KB: one block per SM.
//
// Numerics traps handled as in the bf16 kernel: the running max starts at
// -1e30; rows past the slot's end are zero-filled and get -inf; rows >= P
// get the -1e30 padding bias; classes past d_pad are never loaded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bank_split.cuh"
#include "hopper_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int TM = 64;          // bank rows per tile
constexpr int TQ = 64;          // target rows per block
constexpr int kThreads = 256;   // 16 x 16: ty picks target rows, tx bank rows
constexpr int kMaxC = 256;
constexpr int kLabCols = 24;    // label columns per sweep (smem row of 48 B)
constexpr int kMaxSplits = 64;
constexpr int kFyLen = TM + TQ - 1;
constexpr float kNegInf = -1e30f;
constexpr float kTileSkipThresh = 36.0f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const float* bank;    // (cap, B, P_loc, C)
  const bf16* labels;   // (cap, B, P_loc, D_pad)
  const float* target;  // (B, P, C), temperature folded in
  const int* table;     // (3, K): slot, bits of inv_sigma2, bits of the slot bias
  float* pm;            // (splits, B, P) partial running max
  float* pl;            // (splits, B, P) partial denominators
  float* pacc;          // (splits, B, D_pad, P) partial numerators
  int batch, p_loc, c, d_pad, d_off, dw, p, wd, row_base, k;
  int tiles_per_slot, n_iter, iters_per_split;
};

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

struct Smem {
  size_t ref, ref_stage, lab, lab_stage, fy, fx, rx, total;
};

// target tile (TQ rows of C + 4 floats), then two ring stages of a bank
// tile (TM rows of C + 4 floats) and two of its label rows (TM x 24 bf16),
// then the prior tables of the current tile.
__host__ __device__ inline Smem smem_layout(int c, int wd) {
  const size_t ld = size_t(c) + 4;
  Smem o;
  o.ref = align16(TQ * ld * 4);
  o.ref_stage = align16(TM * ld * 4);
  o.lab = o.ref + 2 * o.ref_stage;
  o.lab_stage = align16(size_t(TM) * kLabCols * 2);
  o.fy = o.lab + 2 * o.lab_stage;
  o.fx = o.fy + align16(kFyLen * 4);
  o.rx = o.fx + align16(size_t(2 * wd - 1) * 4);
  o.total = o.rx + align16(TM * 4);
  return o;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// sum / max over the 16 threads of a row group (lanes differing in bits 0-3)
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ND: label columns of this sweep (8, 16 or 24)
template <int ND>
__global__ void __launch_bounds__(kThreads, 1) affinity_bank_f32_kernel(Params prm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = prm.c, LD = C + 4, CV = C / 4;
  const Smem lay = smem_layout(C, prm.wd);
  float* tgt_s = reinterpret_cast<float*>(smem);
  float* fy_s = reinterpret_cast<float*>(smem + lay.fy);
  float* fx_s = reinterpret_cast<float*>(smem + lay.fx);
  int* rx_s = reinterpret_cast<int*>(smem + lay.rx);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * TQ, split = blockIdx.y, b = blockIdx.z;
  const int it_begin = split * prm.iters_per_split;
  const int it_end = min(prm.n_iter, it_begin + prm.iters_per_split);
  const int wd = prm.wd;
  const float wdf = float(wd);

  // ---- the target tile (rows past P are zeros) ---------------------------
  for (int v = tid; v < TQ * CV; v += kThreads) {
    const int n = v / CV, cv = v - n * CV;
    const bool ok = q0 + n < prm.p;
    cp_async16(tgt_s + n * LD + cv * 4, prm.target + (size_t(b) * prm.p + (ok ? q0 + n : 0)) * C + cv * 4, ok);
  }

  // cp.async loads of iteration `it` (a bank tile and its label columns)
  // into ring stage (it - it_begin) & 1, one commit group per call; rows
  // past the slot's end are zero-filled (and masked to -inf below)
  auto issue = [&](int it) {
    if (it < it_end) {
      const int ks = it / prm.tiles_per_slot;
      const int lrow0 = (it - ks * prm.tiles_per_slot) * TM;
      const size_t row0 = (size_t(__ldg(prm.table + ks)) * prm.batch + b) * prm.p_loc;
      const int s = (it - it_begin) & 1;
      float* ref_s = reinterpret_cast<float*>(smem + lay.ref + s * lay.ref_stage);
      bf16* lab_s = reinterpret_cast<bf16*>(smem + lay.lab + s * lay.lab_stage);
      for (int v = tid; v < TM * CV; v += kThreads) {
        const int n = v / CV, cv = v - n * CV;
        const bool ok = lrow0 + n < prm.p_loc;
        cp_async16(ref_s + n * LD + cv * 4, prm.bank + (row0 + (ok ? lrow0 + n : 0)) * C + cv * 4, ok);
      }
      for (int v = tid; v < TM * (ND / 8); v += kThreads) {
        const int n = v / (ND / 8), cv = v - n * (ND / 8);
        const bool ok = lrow0 + n < prm.p_loc;
        cp_async16(lab_s + n * kLabCols + cv * 8,
                   prm.labels + (row0 + (ok ? lrow0 + n : 0)) * prm.d_pad + prm.d_off + cv * 8, ok);
      }
    }
    cp_async_commit();
  };

  float acc[4][ND];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int d = 0; d < ND; ++d) acc[i][d] = 0.f;
  float m_r[4], l_r[4];
  int qx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
    qx[i] = (q0 + ty + 16 * i) % wd;
  }

  issue(it_begin);  // one group with the target tile
  for (int it = it_begin; it < it_end; ++it) {
    const int i_loc = it - it_begin;
    __syncthreads();  // iteration it - 1 is done with its stage and the tables
    issue(it + 1);
    const int ks = it / prm.tiles_per_slot;
    const int lrow0 = (it - ks * prm.tiles_per_slot) * TM;
    const float inv_s = __int_as_float(__ldg(prm.table + prm.k + ks));
    const float slot_bias = __int_as_float(__ldg(prm.table + 2 * prm.k + ks));
    const int r0 = prm.row_base + lrow0;
    if (inv_s != 0.f) {
      for (int j = tid; j < kFyLen; j += kThreads) {
        const float dy = float(r0 + j - (TQ - 1) - q0) / wdf;
        fy_s[j] = expf(-dy * dy * inv_s);
      }
      for (int j = tid; j < 2 * wd - 1; j += kThreads) {
        const float dx = float(j - (wd - 1));
        fx_s[j] = expf(-dx * dx * inv_s);
      }
      for (int j = tid; j < TM; j += kThreads) rx_s[j] = (r0 + j) % wd;
    }
    cp_async_wait<1>();  // this thread's copies of iteration it have landed
    __syncthreads();     // everyone's, and the tables
    const float* ref_s = reinterpret_cast<const float*>(smem + lay.ref + (i_loc & 1) * lay.ref_stage);
    const bf16* lab_s = reinterpret_cast<const bf16*>(smem + lay.lab + (i_loc & 1) * lay.lab_stage);

    // ---- s = tgt . ref^T: rows ty + 16 i of the target, tx + 16 j of the bank
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int cv = 0; cv < CV; ++cv) {
      float4 a[4], r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(tgt_s + (ty + 16 * i) * LD + cv * 4);
#pragma unroll
      for (int j = 0; j < 4; ++j) r[j] = *reinterpret_cast<const float4*>(ref_s + (tx + 16 * j) * LD + cv * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, r[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, r[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, r[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, r[j].w, s[i][j]);
        }
    }

    // ---- biases, online softmax -------------------------------------------
    float tmax[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = tx + 16 * j;
      const bool dead = lrow0 + r >= prm.p_loc;
      const float pad = r0 + r >= prm.p ? kNegInf : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v = s[i][j] + slot_bias + pad;
        if (dead) v = __int_as_float(0xff800000);  // -inf
        s[i][j] = v;
        tmax[i] = fmaxf(tmax[i], v);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float m_new = fmaxf(m_r[i], group_max(tmax[i]));
      const float alpha = fast_exp2((m_r[i] - m_new) * kLog2e);
      m_r[i] = m_new;
      l_r[i] *= alpha;
#pragma unroll
      for (int d = 0; d < ND; ++d) acc[i][d] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // (s - m) first: see csrc/affinity_bank.cu
        const float e = fast_exp2((s[i][j] - m_new) * kLog2e);
        l_r[i] += e;
        s[i][j] = e;
      }
    }

    // ---- far-tile test: uniform over the block ------------------------------
    const float ry_lo = float(r0) / wdf, ry_hi = float(r0 + TM - 1) / wdf;
    const float ty_lo = float(q0) / wdf, ty_hi = float(q0 + TQ - 1) / wdf;
    const float dy_gap = fmaxf(fmaxf(ty_lo - ry_hi, ry_lo - ty_hi), 0.f);
    if (dy_gap * dy_gap * inv_s < kTileSkipThresh) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        float lab[ND];
#pragma unroll
        for (int d8 = 0; d8 < ND / 8; ++d8) {
          const uint4 raw = *reinterpret_cast<const uint4*>(lab_s + r * kLabCols + d8 * 8);
          const uint32_t w4[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            lab[d8 * 8 + 2 * h] = __uint_as_float(w4[h] << 16);
            lab[d8 * 8 + 2 * h + 1] = __uint_as_float(w4[h] & 0xffff0000u);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float ew = s[i][j];
          if (inv_s != 0.f) {
            const int q = ty + 16 * i;
            ew *= fy_s[r - q + TQ - 1] * fx_s[rx_s[r] + wd - 1 - qx[i]];
          }
          const float hi = __bfloat162float(__float2bfloat16_rn(ew));
          const float v = hi + __bfloat162float(__float2bfloat16_rn(ew - hi));
#pragma unroll
          for (int d = 0; d < ND; ++d) acc[i][d] = fmaf(v, lab[d], acc[i][d]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // ---- partial (m, l, acc) of this split -----------------------------------
  const size_t sb = size_t(split) * prm.batch + b;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty + 16 * i;
    const float l = group_sum(l_r[i]);
    float mine[(ND + 15) / 16];  // this thread's columns: tx and tx + 16
#pragma unroll
    for (int u = 0; u < (ND + 15) / 16; ++u) mine[u] = 0.f;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const float a = group_sum(acc[i][d]);
      if ((d & 15) == tx) mine[d >> 4] = a;
    }
    if (q >= prm.p) continue;
    if (tx == 0) {
      prm.pm[sb * prm.p + q] = m_r[i];
      prm.pl[sb * prm.p + q] = l;
    }
#pragma unroll
    for (int u = 0; u < (ND + 15) / 16; ++u) {
      const int d = tx + 16 * u;
      if (d < ND && d < prm.dw) prm.pacc[(sb * prm.d_pad + prm.d_off + d) * prm.p + q] = mine[u];
    }
  }
}

template <int ND>
cudaError_t prepare(int c, int wd, size_t* smem) {
  *smem = smem_layout(c, wd).total;
  return cudaFuncSetAttribute(affinity_bank_f32_kernel<ND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(*smem));
}

bool shape_ok(int k, int batch, int p_loc, int c, int p, int wd) {
  return k >= 1 && c % 16 == 0 && c >= 16 && c <= kMaxC && p >= 1 && wd >= 1 && batch >= 1 && p_loc >= 1;
}

}  // namespace

// How the sweep is cut: `splits` blocks per target tile, each over
// `iters_per_split` (slot, bank tile) iterations, by the wave model of
// bank_split.cuh at this kernel's occupancy. Returns a cudaError_t.
extern "C" int affinity_bank_f32_plan(int k, int batch, int p_loc, int c, int p, int wd, int* splits,
                                      int* iters_per_split) {
  if (!shape_ok(k, batch, p_loc, c, p, wd)) return int(cudaErrorInvalidValue);
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  size_t smem = 0;
  if (err == cudaSuccess) err = prepare<24>(c, wd, &smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, affinity_bank_f32_kernel<24>, kThreads, smem);
  if (err != cudaSuccess) return int(err);
  if (occ < 1) return int(cudaErrorInvalidConfiguration);
  const long long n_iter = (long long)k * ((p_loc + TM - 1) / TM);
  const long long tiles = (long long)((p + TQ - 1) / TQ) * batch;
  bank_split::choose(n_iter, tiles, (long long)sms * occ, kMaxSplits, splits, iters_per_split);
  return 0;
}

// Launches the sweep on `stream` for label columns [d_off, d_off + dw) of
// d_pad (dw 8, 16 or 24), writing the partials; returns a cudaError_t (0 on
// success). Arguments as affinity_bank_launch of csrc/affinity_bank.cu, with
// a float32 bank and target.
extern "C" int affinity_bank_f32_launch(const void* bank_feats, const void* bank_labels, const void* target,
                                        void* pm, void* pl, void* pacc, const void* table, int k, int cap,
                                        int batch, int p_loc, int c, int d_pad, int d_off, int dw, int p, int wd,
                                        int row_base, int splits, int iters_per_split, void* stream) {
  if (!shape_ok(k, batch, p_loc, c, p, wd) || cap < 1 || d_pad % 8 != 0 || dw % 8 != 0 || dw < 8 ||
      dw > kLabCols || d_off % 8 != 0 || d_off + dw > d_pad || splits < 1 || splits > kMaxSplits ||
      iters_per_split < 1)
    return int(cudaErrorInvalidValue);
  Params prm;
  prm.bank = static_cast<const float*>(bank_feats);
  prm.labels = static_cast<const bf16*>(bank_labels);
  prm.target = static_cast<const float*>(target);
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
  dim3 grid((p + TQ - 1) / TQ, splits, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t smem = 0;
  cudaError_t err;
  if (dw <= 8) {
    err = prepare<8>(c, wd, &smem);
    if (err == cudaSuccess) affinity_bank_f32_kernel<8><<<grid, kThreads, smem, s>>>(prm);
  } else if (dw <= 16) {
    err = prepare<16>(c, wd, &smem);
    if (err == cudaSuccess) affinity_bank_f32_kernel<16><<<grid, kThreads, smem, s>>>(prm);
  } else {
    err = prepare<24>(c, wd, &smem);
    if (err == cudaSuccess) affinity_bank_f32_kernel<24><<<grid, kThreads, smem, s>>>(prm);
  }
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}
