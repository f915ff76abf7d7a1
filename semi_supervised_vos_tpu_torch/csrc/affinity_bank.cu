// Bank-direct label propagation for Hopper (sm_90a).
//
// Replaces two TPU kernels of semi_supervised_vos_tpu/ops/affinity_pallas.py:
// affinity_from_bank_batched (body _bank_kernel) and, launched on a gathered
// reference set seen as a one-video bank with slots 0..K-1,
// affinity_propagate_pallas (body _kernel; ops/affinity.py::
// affinity_propagate_fused folds its temperature into the bank). Per target pixel q of
// video b it streams the K sampled slots straight from the ring memory bank
// by slot index (no gather) and computes, with an online softmax,
//
//   s    = ref . (T tgt) + pad_bias + slot_bias        (-1e30 biases)
//   m'   = max(m, max_rows s);  e = exp(s - m')
//   l    = l exp(m - m') + sum_rows e                   (unweighted)
//   w    = exp(-((yr-yq)^2 + (xr-xq)^2) invsigma2_slot)  (y = idx / wd, a
//                                                         fractional row)
//   acc  = acc exp(m - m') + labels^T (hi + lo)   (e w split into two bf16
//                                                   terms, hi = bf16(e w),
//                                                   lo = bf16(e w - hi))
//   out  = acc / l          (or the raw m, l, acc in stats mode)
//
// What bounds it on the H100: the similarity product, 2 K P P C flops per
// frame (190 GFLOP at 480p: K 9, P 6420, C 256), plus K P P exps for e and
// again for w; the sampled bank is only ~32 MB, so bytes do not bound it.
// Design: one block owns TN target columns of one video and loops over the
// K slots and the bank-row tiles of each slot (the loop replaces the TPU's
// sequential grid axis). Its target tile stays in shared memory for the
// whole sweep; each bank tile is loaded once per block. Both products run
// on the tensor cores in bf16 with f32 accumulation (WMMA); the softmax
// statistics and the accumulator live in shared memory. The slot indices,
// validity biases and 1/sigma^2 arrive as a (3, K) int32 table in device
// memory (the floats as their bits), so K has no fixed limit; every thread
// of a block reads the same entry, once per bank tile. A (bank tile,
// target tile) pair whose minimum row gap gives w <= exp(-36) skips its
// numerator product (the far-tile skip of the TPU kernel, same threshold).
// The TPU kernel rounds e w to bf16 once; here it is split into a bf16 hi
// and lo part and the (cheap, D-wide) label product runs twice, so the
// numerator keeps ~16 mantissa bits: one-hot labels are exact in bf16, and
// a single rounding flipped near-tied argmaxes against the float32 version.
//
// Numerics traps handled: the running max starts at -1e30, never -inf, so an
// all-invalid first tile cannot give inf - inf; rows past the bank's end get
// -inf (they never enter the max, which is >= -1e30); rows >= P get the
// -1e30 padding bias; label classes >= D_pad are zero in shared memory, so
// padded classes stay exactly 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TM = 64;        // bank rows per tile
constexpr int TN = 32;        // target columns per block
constexpr int kThreads = 256; // 8 warps
constexpr float kNegInf = -1e30f;
constexpr float kTileSkipThresh = 36.0f;

struct Params {
  const __nv_bfloat16* bank_feats;   // (cap, B, P_loc, C)
  const __nv_bfloat16* bank_labels;  // (cap, B, P_loc, D_pad)
  const __nv_bfloat16* target;       // (B, P, C), temperature folded in
  const int* table;  // (3, K): slot, bits of inv_sigma2, bits of the slot bias
  float* out;    // (B, D_pad, P): acc / l, or raw acc in stats mode
  float* m_out;  // (B, P), stats mode only
  float* l_out;  // (B, P), stats mode only
  int batch, p_loc, c, d_pad, dw, p, wd, row_base, k, return_stats;
};

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

struct Smem {
  size_t tgt, ref, lab, s, ew, ewlo, acc, m, l, total;
};

__host__ __device__ inline Smem smem_layout(int c, int dw) {
  const int ldc = c + 16;
  Smem o;
  size_t off = 0;
  o.tgt = off; off = align128(off + size_t(TN) * ldc * 2);
  o.ref = off; off = align128(off + size_t(TM) * ldc * 2);
  o.lab = off; off = align128(off + size_t(TM) * dw * 2);
  o.s = off;   off = align128(off + size_t(TM) * TN * 4);
  o.ew = off;  off = align128(off + size_t(TM) * TN * 2);
  o.ewlo = off; off = align128(off + size_t(TM) * TN * 2);
  o.acc = off; off = align128(off + size_t(dw) * TN * 4);
  o.m = off;   off = align128(off + TN * 4);
  o.l = off;   off = align128(off + TN * 4);
  o.total = off;
  return o;
}

__global__ void __launch_bounds__(kThreads)
affinity_bank_kernel(Params prm) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = prm.c, DW = prm.dw, LDC = C + 16;
  const Smem lay = smem_layout(C, DW);
  __nv_bfloat16* tgt_s = reinterpret_cast<__nv_bfloat16*>(smem + lay.tgt);
  __nv_bfloat16* ref_s = reinterpret_cast<__nv_bfloat16*>(smem + lay.ref);
  __nv_bfloat16* lab_s = reinterpret_cast<__nv_bfloat16*>(smem + lay.lab);
  float* s_s = reinterpret_cast<float*>(smem + lay.s);
  __nv_bfloat16* ew_s = reinterpret_cast<__nv_bfloat16*>(smem + lay.ew);
  __nv_bfloat16* ewlo_s = reinterpret_cast<__nv_bfloat16*>(smem + lay.ewlo);
  float* acc_s = reinterpret_cast<float*>(smem + lay.acc);
  float* m_s = reinterpret_cast<float*>(smem + lay.m);
  float* l_s = reinterpret_cast<float*>(smem + lay.l);

  const int b = blockIdx.y;
  const int n0 = blockIdx.x * TN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int vpr = C / 8;       // 16-byte vectors per feature row
  const int lvpr = DW / 8;     // 16-byte vectors per shared label row
  const int dvec = prm.d_pad / 8;

  // target tile, resident for the whole sweep (zero past P)
  for (int v = tid; v < TN * vpr; v += kThreads) {
    const int n = v / vpr, cv = v - n * vpr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (n0 + n < prm.p)
      val = *reinterpret_cast<const uint4*>(prm.target + (size_t(b) * prm.p + n0 + n) * C + cv * 8);
    *reinterpret_cast<uint4*>(tgt_s + n * LDC + cv * 8) = val;
  }
  for (int i = tid; i < TN; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  for (int i = tid; i < DW * TN; i += kThreads) acc_s[i] = 0.f;
  __syncthreads();

  // softmax mapping: 8 consecutive lanes own one target column
  const int col = tid >> 3, part = tid & 7;
  const int cidx = n0 + col;
  const float wdf = float(prm.wd);
  const float ty = float(cidx) / wdf;
  const float tx = float(cidx % prm.wd);

  const int tiles_per_slot = (prm.p_loc + TM - 1) / TM;
  const int n_iter = prm.k * tiles_per_slot;
  for (int it = 0; it < n_iter; ++it) {
    const int ks = it / tiles_per_slot;
    const int lrow0 = (it - ks * tiles_per_slot) * TM;
    const int slot = __ldg(prm.table + ks);
    const float inv_sigma2 = __int_as_float(__ldg(prm.table + prm.k + ks));
    const float slot_bias = __int_as_float(__ldg(prm.table + 2 * prm.k + ks));
    const size_t slot_row0 = (size_t(slot) * prm.batch + b) * prm.p_loc;
    const __nv_bfloat16* fbase = prm.bank_feats + slot_row0 * C;
    const __nv_bfloat16* lbase = prm.bank_labels + slot_row0 * prm.d_pad;

    for (int v = tid; v < TM * vpr; v += kThreads) {
      const int r = v / vpr, cv = v - r * vpr;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (lrow0 + r < prm.p_loc)
        val = *reinterpret_cast<const uint4*>(fbase + size_t(lrow0 + r) * C + cv * 8);
      *reinterpret_cast<uint4*>(ref_s + r * LDC + cv * 8) = val;
    }
    for (int v = tid; v < TM * lvpr; v += kThreads) {
      const int r = v / lvpr, dv = v - r * lvpr;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (lrow0 + r < prm.p_loc && dv < dvec)
        val = *reinterpret_cast<const uint4*>(lbase + size_t(lrow0 + r) * prm.d_pad + dv * 8);
      *reinterpret_cast<uint4*>(lab_s + r * DW + dv * 8) = val;
    }
    __syncthreads();

    // similarity tile (TM x TN): one 16x16 fragment per warp
    {
      const int mt = warp >> 1, nt = warp & 1;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf;
      wmma::fill_fragment(cf, 0.f);
      for (int c0 = 0; c0 < C; c0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
        wmma::load_matrix_sync(af, ref_s + mt * 16 * LDC + c0, LDC);
        wmma::load_matrix_sync(bf, tgt_s + nt * 16 * LDC + c0, LDC);
        wmma::mma_sync(cf, af, bf, cf);
      }
      wmma::store_matrix_sync(s_s + mt * 16 * TN + nt * 16, cf, TN, wmma::mem_row_major);
    }
    __syncthreads();

    // far-tile test: uniform over the block
    const int rbase = prm.row_base + lrow0;
    const float row0f = float(rbase);
    const float ry_lo = row0f / wdf, ry_hi = (row0f + float(TM - 1)) / wdf;
    const float c0f = float(n0);
    const float ty_lo = c0f / wdf, ty_hi = (c0f + float(TN - 1)) / wdf;
    const float dy_gap = fmaxf(fmaxf(ty_lo - ry_hi, ry_lo - ty_hi), 0.f);
    const bool near = dy_gap * dy_gap * inv_sigma2 < kTileSkipThresh;

    // online softmax update of column `col`
    float sv[TM / 8];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < TM / 8; ++j) {
      const int r = part + 8 * j;
      float s;
      if (lrow0 + r >= prm.p_loc) {
        s = __int_as_float(0xff800000);  // -inf
      } else {
        const float pad_bias = (rbase + r < prm.p) ? 0.f : kNegInf;
        s = s_s[r * TN + col] + pad_bias + slot_bias;
      }
      sv[j] = s;
      tmax = fmaxf(tmax, s);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 4));
    const float m_old = m_s[col];
    const float m_new = fmaxf(m_old, tmax);
    const float scale = expf(m_old - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < TM / 8; ++j) {
      const int r = part + 8 * j;
      const float e = expf(sv[j] - m_new);
      psum += e;
      if (near) {
        const int ridx = rbase + r;
        const float dy = float(ridx) / wdf - ty;
        const float dx = float(ridx % prm.wd) - tx;
        const float w = expf(-(dy * dy + dx * dx) * inv_sigma2);
        const float ew = e * w;
        const __nv_bfloat16 hi = __float2bfloat16(ew);
        ew_s[r * TN + col] = hi;
        ewlo_s[r * TN + col] = __float2bfloat16(ew - __bfloat162float(hi));
      }
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    psum += __shfl_xor_sync(0xffffffffu, psum, 4);
    __syncwarp();
    if (part == 0) {
      m_s[col] = m_new;
      l_s[col] = l_s[col] * scale + psum;
    }
    for (int d = part; d < DW; d += 8) acc_s[d * TN + col] *= scale;
    __syncthreads();

    // numerator: acc (DW x TN) += labels^T (DW x TM) . ew (TM x TN)
    if (near) {
      const int n_frag = (DW / 16) * (TN / 16);
      for (int f = warp; f < n_frag; f += kThreads / 32) {
        const int dt = f / (TN / 16), nt = f - dt * (TN / 16);
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> cf;
        wmma::load_matrix_sync(cf, acc_s + dt * 16 * TN + nt * 16, TN, wmma::mem_row_major);
        for (int m0 = 0; m0 < TM; m0 += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> af;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
          wmma::load_matrix_sync(af, lab_s + m0 * DW + dt * 16, DW);
          wmma::load_matrix_sync(bf, ew_s + m0 * TN + nt * 16, TN);
          wmma::mma_sync(cf, af, bf, cf);
          wmma::load_matrix_sync(bf, ewlo_s + m0 * TN + nt * 16, TN);
          wmma::mma_sync(cf, af, bf, cf);
        }
        wmma::store_matrix_sync(acc_s + dt * 16 * TN + nt * 16, cf, TN, wmma::mem_row_major);
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < prm.d_pad * TN; i += kThreads) {
    const int d = i / TN, n = i - d * TN;
    if (n0 + n >= prm.p) continue;
    const size_t o = (size_t(b) * prm.d_pad + d) * prm.p + n0 + n;
    prm.out[o] = prm.return_stats ? acc_s[d * TN + n] : acc_s[d * TN + n] / fmaxf(l_s[n], 1e-30f);
  }
  if (prm.return_stats) {
    for (int n = tid; n < TN; n += kThreads) {
      if (n0 + n >= prm.p) continue;
      prm.m_out[size_t(b) * prm.p + n0 + n] = m_s[n];
      prm.l_out[size_t(b) * prm.p + n0 + n] = l_s[n];
    }
  }
}

}  // namespace

// Launches the kernel on `stream`; returns a cudaError_t (0 on success).
// `table` is a device array of 3 k int32: the k slots, then the bits of the
// k inv_sigma2 and of the k slot biases (float32).
extern "C" int affinity_bank_launch(
    const void* bank_feats, const void* bank_labels, const void* target,
    void* out, void* m_out, void* l_out, const void* table, int k,
    int batch, int p_loc, int c, int d_pad, int p, int wd, int row_base,
    int return_stats, void* stream) {
  if (k < 1 || c % 16 != 0 || d_pad % 8 != 0 || d_pad < 8 ||
      p < 1 || wd < 1 || batch < 1 || p_loc < 1)
    return int(cudaErrorInvalidValue);
  Params prm;
  prm.bank_feats = static_cast<const __nv_bfloat16*>(bank_feats);
  prm.bank_labels = static_cast<const __nv_bfloat16*>(bank_labels);
  prm.target = static_cast<const __nv_bfloat16*>(target);
  prm.table = static_cast<const int*>(table);
  prm.out = static_cast<float*>(out);
  prm.m_out = static_cast<float*>(m_out);
  prm.l_out = static_cast<float*>(l_out);
  prm.batch = batch;
  prm.p_loc = p_loc;
  prm.c = c;
  prm.d_pad = d_pad;
  prm.dw = (d_pad + 15) / 16 * 16;
  prm.p = p;
  prm.wd = wd;
  prm.row_base = row_base;
  prm.k = k;
  prm.return_stats = return_stats;
  const size_t smem = smem_layout(c, prm.dw).total;
  cudaError_t err = cudaFuncSetAttribute(
      affinity_bank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((p + TN - 1) / TN, batch);
  affinity_bank_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(prm);
  return int(cudaGetLastError());
}
