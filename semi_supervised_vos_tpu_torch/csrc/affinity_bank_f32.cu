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
// The similarity is float32-accurate on the tf32 tensor cores (3xTF32,
// hopper_mma.cuh): target and bank values are each split into tf32 big +
// small (both rounded to nearest), and s = small . big' + big . small' +
// big . big' accumulates in float32 (~2^-22 relative per term; at the main
// path's statistics one tf32 product leaves ~300x the output error of
// three, tests/test_torch_tf32x3.py). Until this design the kernel ran on
// FFMA, 2.8x its FFMA bound of 3.07 ms at 480p.
//
// What bounds it on the H100: the similarity, 2 K P^2 C flops (190 GFLOP at
// 480p: K 9, P 6420, C 256), three times over at the dense tf32 rate
// (495 TFLOP/s): 1.15 ms (FFMA at 67 TFLOP/s would take 2.8). The hi / lo
// label product on bf16 tensor cores (0.04 ms), the K P^2 exps on the MUFU
// pipe (0.09 ms) and HBM (the sampled bank is ~59 MB) are small beside it.
// Inside the SM, shared memory is not: per 8 KB chunk of bank features the
// products read 64 KB of operands (B twice per k-step, A's small plane
// once) and the split reads 8 KB and writes 16 KB, ~127 B a clock at the
// tensor cores' peak, all of the SM's shared-memory rate.
//
// Design:
// - One block owns TQ = 128 target rows of one video: two consumer
//   warpgroups of 64 rows, and a producer warpgroup. setmaxnreg moves the
//   registers: 40 a producer thread, 232 a consumer thread.
// - Each consumer warp keeps the tf32 big plane of its 16 rows' A fragments
//   in registers for the whole sweep (C / 8 k-steps x 4 = 128 registers at
//   C 256); the small plane sits in shared memory as wgmma core matrices
//   (128 x 256 x 4 B = 128 KB), written once at the start.
// - Bank tiles of TM = 64 rows stream in K-chunks of 32 channels (8 KB).
//   The producer's fourth warp issues the TMA loads into a 5-stage ring as
//   stages come free, and with a tile's first chunk the tile's label rows
//   (up to 24 columns) into a double buffer of their own. A 2-D tensor
//   map's box lands each chunk as 64 rows of 128 bytes, 128-byte swizzled:
//   wgmma's K-major SW128 layout, which tf32 wgmma needs (it has no
//   transpose for 32-bit types), read by TMA a whole 128-byte row at a time
//   (boxes of 16-byte rows, the unswizzled core-matrix layout, read a
//   32-byte sector for every 16 bytes). The bank's (P, C) rows are K-major
//   as they lie, so its layout and dtype stay as the engines write them.
// - The producer's other three warps split the landed chunks, each warp a
//   whole chunk in turn (one chunk's split is latency-bound): big over the
//   raw values, small into one of 5 small-plane buffers, then
//   fence.proxy.async and an mbarrier arrival.
// - Each consumer warpgroup issues, per chunk, 4 k-steps x 3 wgmma m64n64k8
//   (small . big from shared memory, big . small and big . big with A from
//   registers), leaves the group in flight (wait 1) and frees the chunk's
//   stage and small buffer when the group before is done. No register of
//   the accumulators is touched between the chunks of a tile, and every
//   chunk of a tile runs even past C (zeros): either would make ptxas wait
//   for, or serialise, the wgmmas in flight.
// - After a tile's last chunk the online softmax runs on the accumulator
//   registers (row max by quad shuffles, exp2 of (s - m) log2 e), e w is
//   split into bf16 hi and lo in registers and multiplies the bf16 label
//   tile on the tensor cores (mma.sync m16n8k16, B by ldmatrix.trans), as
//   in the bf16 kernel; acc stays in registers.
// - The prior is factored as in the bf16 kernel: a row table of TM + TQ - 1
//   values and a column table per tile, double-buffered and built by both
//   warpgroups under the next tile's products, so no exp runs per pair for
//   it; a (bank tile, target tile) pair whose row gap gives w <= exp(-36)
//   skips the label product.
// - The column table's room does not grow with the frame: it holds the
//   offsets |dx| <= half, half = min(wd - 1, the first |dx| whose factor
//   expf(-dx^2 invsigma2) is exactly 0), and a farther offset reads that
//   stored 0 at the table's end, so any width gives the bits of a full
//   2 wd - 1 table (at 480p, wd 107, the dense slots' sigma 8 gives half
//   89, so their far offsets are clamped; sigma 21 gives wd - 1). A prior
//   too wide for the table's kFxLen entries (sigma above
//   ~61 feature pixels on a frame wider than that) takes the factor from
//   expf per pair instead, the same expression and bits.
// - The sweep is split over blocks by the plan of bank_split.cuh and the
//   partials are combined by affinity_combine_kernel of csrc/affinity_bank.cu.
// Shared memory at C 256, any wd: A small 131,072 B + ring 5 x 8,192 +
// small planes 5 x 8,192 + labels 2 x 3,072 + tables + barriers = 232,192
// B of the 232,448 a block may use.
// What still holds it back: the two warpgroups consume the same chunks, so
// their softmax, prior and label products fall together and the tensor
// cores idle meanwhile; n = 64 is a narrow wgmma; and shared memory runs
// near its rate (above).
//
// Numerics traps handled as in the bf16 kernel: the running max starts at
// -1e30; rows past the slot's end get -inf; rows >= P get the -1e30
// padding bias; classes past d_pad are never loaded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bank_split.cuh"
#include "hopper_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int TM = 64;           // bank rows per tile
constexpr int TQ = 128;          // target rows per block (8 warps x 16)
constexpr int KC = 32;           // channels per ring chunk
constexpr int kConsumerWarps = 8;  // two consumer warpgroups
constexpr int kThreads = 384;      // and one producer warpgroup
constexpr int kSplitWarps = 3;     // of the producer warpgroup; its fourth warp issues the TMA loads
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // setmaxnreg: 40 + 2 x 232 = 3 x 168
constexpr int kStages = 5;      // raw chunks (TMA ring)
constexpr int kSmall = 5;       // split chunks' small planes
constexpr int kMaxC = 256;
constexpr int kMaxKC = kMaxC / KC;  // chunks per bank tile
constexpr int kLabCols = 24;     // label columns per sweep
constexpr int kMaxSplits = 64;
constexpr int kFyLen = TM + TQ - 1;
constexpr int kFxHalfMax = 671;  // column-table offsets |dx| <= 671: the room left at C 256
constexpr int kFxLen = 2 * kFxHalfMax + 1;
// expf(-x) is exactly 0.0f for x above ~104 (the smallest float32 denormal
// is e^-103.3); the table's end sits where x >= 120, well past that
constexpr float kPriorZero = 120.0f;
constexpr float kNegInf = -1e30f;
constexpr float kTileSkipThresh = 36.0f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kChunkBytes = TM * KC * 4;

// The bank (cap, B, P_loc, C) features and (cap, B, P_loc, D_pad) labels
// arrive through TMA tensor maps (kernel parameters of their own).
struct Params {
  const float* target;  // (B, P, C), temperature folded in
  const int* table;     // (3, K): slot, bits of inv_sigma2, bits of the slot bias
  float* pm;            // (splits, B, P) partial running max
  float* pl;            // (splits, B, P) partial denominators
  float* pacc;          // (splits, B, D_pad, P) partial numerators
  int batch, p_loc, c, d_pad, d_off, dw, p, wd, row_base, k;
  int tiles_per_slot, n_iter, iters_per_split;
};

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

struct Smem {
  size_t stage, small, lab, lab_bytes, fy, fx, rx, bars, total;
};

// The target's small plane (per warpgroup: 16-byte chunk j of row r at j x
// 1024 + r x 16, the unswizzled core-matrix layout), then kStages ring
// stages of a feature chunk (bank row n's 32 channels at n x 128 bytes,
// swizzled as TMA wrote them), its small plane in the same layout and a
// dense TM x dw label tile, then the prior tables and the barriers.
__host__ __device__ inline Smem smem_layout(int c) {
  (void)c;  // every width takes the room of kMaxC
  Smem o;
  o.stage = size_t(2) * kMaxKC * (KC / 4) * 1024;
  o.small = o.stage + kStages * size_t(kChunkBytes);
  o.lab = o.small + kSmall * size_t(kChunkBytes);
  o.lab_bytes = size_t(TM) * kLabCols * 2;
  o.fy = o.lab + 2 * o.lab_bytes;  // two buffers of each table
  o.fx = align128(o.fy + 2 * kFyLen * 4);
  o.rx = align128(o.fx + size_t(2) * kFxLen * 4);
  o.bars = align128(o.rx + 2 * TM * 4);
  o.total = align128(o.bars + (2 * kStages + 2 * kSmall + 4) * 8);
  return o;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The column table's half-width for a slot of inverse sigma^2 inv_s > 0 on
// a frame of width wd: wd - 1 (every offset), or the first offset past
// which expf(-dx^2 inv_s) is 0 (one more than ceil(sqrt(kPriorZero /
// inv_s)), against the sqrt's rounding), if that is smaller. Above
// kFxHalfMax the table does not fit and the factor is computed per pair.
__device__ __forceinline__ int fx_half(float inv_s, int wd) {
  const float reach = fminf(ceilf(sqrtf(kPriorZero / inv_s)), 1e9f) + 1.f;
  return reach < float(wd - 1) ? int(reach) : wd - 1;
}

// ND: label columns of this sweep (8, 16 or 24)
template <int ND>
__global__ void __launch_bounds__(kThreads, 1)
    affinity_bank_f32_kernel(const __grid_constant__ CUtensorMap feat_map, const __grid_constant__ CUtensorMap lab_map,
                             Params prm) {
  constexpr int NT = ND / 8;  // label n-tiles
  extern __shared__ __align__(1024) unsigned char smem[];
  const int C = prm.c;
  const Smem lay = smem_layout(C);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wi = warp & 3;  // consumer warpgroup (0, 1; 2 is the producer)
  const int q0 = blockIdx.x * TQ, split = blockIdx.y, b = blockIdx.z;
  const int it_begin = split * prm.iters_per_split;
  const int it_end = min(prm.n_iter, it_begin + prm.iters_per_split);
  const int n_chunks = max(it_end - it_begin, 0) * kMaxKC;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);  // a chunk's TMA landed
  uint64_t* empty = full + kStages;         // the 8 consumer warps are done with it
  uint64_t* ready = empty + kStages;        // a chunk is split (per small buffer)
  uint64_t* small_free = ready + kSmall;    // the consumers are done with a small buffer
  uint64_t* lab_full = small_free + kSmall; // a tile's label rows landed (two buffers)
  uint64_t* lab_empty = lab_full + 2;       // and are read
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    for (int s = 0; s < kSmall; ++s) {
      mbar_init(ready + s, 1);
      mbar_init(small_free + s, kConsumerWarps);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(lab_full + s, 1);
      mbar_init(lab_empty + s, kConsumerWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();

  auto stage_of = [&](int gc) { return smem + lay.stage + size_t(gc % kStages) * kChunkBytes; };
  auto small_of = [&](int gc) { return smem + lay.small + size_t(gc % kSmall) * kChunkBytes; };

  if (warp >= kConsumerWarps) {
    // ---- producer warpgroup: TMA loads (its fourth warp) and splits -------
    auto issue = [&](int c) {  // chunk c, and with a tile's first chunk its label rows
      const int i = c / kMaxKC, kc = c - i * kMaxKC, it = it_begin + i;
      const int ks = it / prm.tiles_per_slot;
      const int lrow0 = (it - ks * prm.tiles_per_slot) * TM;
      const int row = (__ldg(prm.table + ks) * prm.batch + b) * prm.p_loc + lrow0;
      mbar_expect_tx(full + c % kStages, kChunkBytes);
      tma_load_2d(stage_of(c), &feat_map, full + c % kStages, kc * KC, row);
      if (kc == 0) {
        if (i >= 2) mbar_wait(lab_empty + (i & 1), ((i >> 1) - 1) & 1);
        mbar_expect_tx(lab_full + (i & 1), uint32_t(TM) * prm.dw * 2);
        tma_load_2d(smem + lay.lab + (i & 1) * lay.lab_bytes, &lab_map, lab_full + (i & 1), prm.d_off, row);
      }
    };
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps + kSplitWarps) {
      if (lane == 0)  // loads as far ahead as the stages allow
        for (int c = 0; c < n_chunks; ++c) {
          if (c >= kStages) mbar_wait(empty + c % kStages, ((c / kStages) - 1) & 1);
          issue(c);
        }
      return;
    }
    // splitter warp w takes chunks w, w + 3, ...: each chunk's split is
    // latency-bound, so three run at once
    for (int gc = warp - kConsumerWarps; gc < n_chunks; gc += kSplitWarps) {
      if (gc >= kSmall) mbar_wait(small_free + gc % kSmall, ((gc / kSmall) - 1) & 1);
      mbar_wait(full + gc % kStages, (gc / kStages) & 1);
      float4* raw = reinterpret_cast<float4*>(stage_of(gc));
      float4* sm = reinterpret_cast<float4*>(small_of(gc));
#pragma unroll 4
      for (int v = lane; v < int(kChunkBytes / 16); v += 32) {
        const float4 r = raw[v];
        uint32_t bx, by, bz, bw, sx, sy, sz, sw;
        tf32_split(r.x, bx, sx);
        tf32_split(r.y, by, sy);
        tf32_split(r.z, bz, sz);
        tf32_split(r.w, bw, sw);
        raw[v] = make_float4(__uint_as_float(bx), __uint_as_float(by), __uint_as_float(bz), __uint_as_float(bw));
        sm[v] = make_float4(__uint_as_float(sx), __uint_as_float(sy), __uint_as_float(sz), __uint_as_float(sw));
      }
      fence_proxy_async();  // the split planes are read by wgmma
      __syncwarp();
      if (lane == 0) mbar_arrive(ready + gc % kSmall);
    }
    return;
  }

  // ---- consumers: warpgroup wg owns target rows 64 wg.. of the tile ------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wd = prm.wd;
  const float wdf = float(wd);
  float* fy_s = reinterpret_cast<float*>(smem + lay.fy);
  float* fx_s = reinterpret_cast<float*>(smem + lay.fx);
  int* rx_s = reinterpret_cast<int*>(smem + lay.rx);
  unsigned char* asmall = smem + size_t(wg) * kMaxKC * (KC / 4) * 1024;  // this warpgroup's small plane

  // the target rows: big plane into registers, small into shared memory.
  // Rows 16 warp + g (+ 8) of the tile; a[e] of k-step kk is row g + 8 (e &
  // 1), channel 8 kk + t + 4 (e >> 1)
  uint32_t qa[kMaxKC * 4][4];
  {
    const int r0 = 16 * warp + g;
    const float* trow[2] = {prm.target + (size_t(b) * prm.p + min(q0 + r0, prm.p - 1)) * C,
                            prm.target + (size_t(b) * prm.p + min(q0 + r0 + 8, prm.p - 1)) * C};
    const bool ok[2] = {q0 + r0 < prm.p, q0 + r0 + 8 < prm.p};
#pragma unroll
    for (int kk = 0; kk < kMaxKC * 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ch = 8 * kk + t + 4 * (e >> 1);
        const float v = ok[e & 1] && ch < C ? __ldg(trow[e & 1] + ch) : 0.f;
        uint32_t small;
        tf32_split(v, qa[kk][e], small);
        *reinterpret_cast<uint32_t*>(asmall + (2 * kk + (e >> 1)) * 1024 + (16 * wi + g + 8 * (e & 1)) * 16 + t * 4) =
            small;
      }
    }
    fence_proxy_async();                     // the small plane is read by wgmma
    named_barrier(1, 32 * kConsumerWarps);  // of every consumer warp
  }

  // prior tables of iteration `it` into buffer `buf`, by both warpgroups
  auto build = [&](int it, int buf) {
    if (it >= it_end) return;
    const int ks = it / prm.tiles_per_slot;
    const float inv_s = __int_as_float(__ldg(prm.table + prm.k + ks));
    if (inv_s == 0.f) return;
    const int r0 = prm.row_base + (it - ks * prm.tiles_per_slot) * TM;
    float* fy = fy_s + buf * kFyLen;
    float* fx = fx_s + buf * kFxLen;  // fx[j]: offset dx = j - half
    int* rx = rx_s + buf * TM;
    for (int j = tid; j < kFyLen; j += 32 * kConsumerWarps) {
      const float dy = float(r0 + j - (TQ - 1) - q0) / wdf;
      fy[j] = expf(-dy * dy * inv_s);
    }
    const int half = fx_half(inv_s, wd);
    if (half <= kFxHalfMax)
      for (int j = tid; j < 2 * half + 1; j += 32 * kConsumerWarps) {
        const float dx = float(j - half);
        fx[j] = expf(-dx * dx * inv_s);
      }
    for (int j = tid; j < TM; j += 32 * kConsumerWarps) rx[j] = (r0 + j) % wd;
  };

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  const int qloc = warp * 16 + g;  // this thread's rows: qloc and qloc + 8
  const int qx[2] = {(q0 + qloc) % wd, (q0 + qloc + 8) % wd};
  build(it_begin, 0);

  for (int it = it_begin; it < it_end; ++it) {
    const int i = it - it_begin;
    float sc[8][4];
    // every consumer warp is done with tile it - 1's tail (the tables of
    // tile it + 1 go where tile it - 1's were) and has built tile it's
    named_barrier(1, 32 * kConsumerWarps);

    // ---- S = tgt . ref^T, 3xTF32: 64 target rows x 64 bank rows, chunk by
    // chunk; each chunk's stage is released once its products are done -----
#pragma unroll
    for (int kc = 0; kc < kMaxKC; ++kc) {
      const int gc = i * kMaxKC + kc;
      const unsigned char* st = stage_of(gc);
      mbar_wait(ready + gc % kSmall, (gc / kSmall) & 1);
      // no access to sc between the chunks of a tile: one would make ptxas
      // wait for the group in flight, and the groups would never overlap
      if (kc == 0) wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KC / 8; ++ks) {
        const int kk = kc * (KC / 8) + ks;
        const uint64_t bbig = smem_desc_swizzled(st + ks * 32, 8 * KC * 4, 1);
        const uint64_t bsmall = smem_desc_swizzled(small_of(gc) + ks * 32, 8 * KC * 4, 1);
        wgmma_m64n64k8_tf32_ss(sc, smem_desc(asmall + 2 * kk * 1024, 1024, 128), bbig, kk > 0);
        wgmma_m64n64k8_tf32(sc, qa[kk], bsmall, true);
        wgmma_m64n64k8_tf32(sc, qa[kk], bbig, true);
      }
      wgmma_commit();
      if (kc == 0) build(it + 1, (i + 1) & 1);  // the next tile's prior tables, under the products
      if (kc == kMaxKC - 1) {
        wgmma_wait<0>();
        fence_operands(sc);
      } else {
        wgmma_wait<1>();
      }
      if (lane == 0) {  // chunk gc - 1 is done (and after the last, chunk gc)
        if (kc > 0) {
          mbar_arrive(empty + (gc - 1) % kStages);
          mbar_arrive(small_free + (gc - 1) % kSmall);
        }
        if (kc == kMaxKC - 1) {
          mbar_arrive(empty + gc % kStages);
          mbar_arrive(small_free + gc % kSmall);
        }
      }
    }

    const bf16* ls = reinterpret_cast<const bf16*>(smem + lay.lab + (i & 1) * lay.lab_bytes);
    const int ks = it / prm.tiles_per_slot;
    const int lrow0 = (it - ks * prm.tiles_per_slot) * TM;
    const float inv_s = __int_as_float(__ldg(prm.table + prm.k + ks));
    const float slot_bias = __int_as_float(__ldg(prm.table + 2 * prm.k + ks));
    const int r0 = prm.row_base + lrow0;
    mbar_wait(lab_full + (i & 1), (i >> 1) & 1);

    // ---- biases, online softmax -------------------------------------------
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
        // (s - m) first: see csrc/affinity_bank.cu
        const float ev = fast_exp2((sc[n][e] - m_r[e >> 1]) * kLog2e);
        l_r[e >> 1] += ev;
        sc[n][e] = ev;
      }
#pragma unroll
    for (int d = 0; d < NT; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    // ---- far-tile test: uniform over the block ------------------------------
    const float ry_lo = float(r0) / wdf, ry_hi = float(r0 + TM - 1) / wdf;
    const float ty_lo = float(q0) / wdf, ty_hi = float(q0 + TQ - 1) / wdf;
    const float dy_gap = fmaxf(fmaxf(ty_lo - ry_hi, ry_lo - ty_hi), 0.f);
    if (dy_gap * dy_gap * inv_s < kTileSkipThresh) {
      // ---- e w (two table reads, no exp) ---------------------------------
      if (inv_s != 0.f) {
        const float* fy = fy_s + (i & 1) * kFyLen;
        const int half = fx_half(inv_s, wd);  // uniform over the block
        const float* fx = fx_s + (i & 1) * kFxLen + half;  // fx[dx], |dx| <= half
        const int* rx = rx_s + (i & 1) * TM;
        if (half <= kFxHalfMax) {  // offsets past half read the stored 0 at an end
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int c = n * 8 + 2 * t + j;
              sc[n][j] *= fy[c - qloc + TQ - 1] * fx[min(max(rx[c] - qx[0], -half), half)];
              sc[n][j + 2] *= fy[c - qloc - 8 + TQ - 1] * fx[min(max(rx[c] - qx[1], -half), half)];
            }
        } else {  // a prior too wide for the table: the same factor per pair
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int c = n * 8 + 2 * t + j;
              const float dx0 = float(rx[c] - qx[0]), dx1 = float(rx[c] - qx[1]);
              sc[n][j] *= fy[c - qloc + TQ - 1] * expf(-dx0 * dx0 * inv_s);
              sc[n][j + 2] *= fy[c - qloc - 8 + TQ - 1] * expf(-dx1 * dx1 * inv_s);
            }
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
        const bf16* lrow = ls + (16 * j + (lane & 15)) * ND;
#pragma unroll
        for (int d = 0; d < NT; d += 2) {
          if (d + 1 < NT) {
            uint32_t bl[4];
            ldmatrix_x4_trans(bl, lrow + (d + (lane >> 4)) * 8);
            mma_bf16(acc[d], ahi, bl[0], bl[1]);
            mma_bf16(acc[d], alo, bl[0], bl[1]);
            mma_bf16(acc[d + 1], ahi, bl[2], bl[3]);
            mma_bf16(acc[d + 1], alo, bl[2], bl[3]);
          } else {
            uint32_t bl[2];
            ldmatrix_x2_trans(bl, lrow + d * 8);
            mma_bf16(acc[d], ahi, bl[0], bl[1]);
            mma_bf16(acc[d], alo, bl[0], bl[1]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(lab_empty + (i & 1));  // the label rows are read
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
    for (int d = 0; d < NT; ++d) {
      const int col = prm.d_off + d * 8 + 2 * t;
      prm.pacc[(sb * prm.d_pad + col) * prm.p + q] = acc[d][2 * h];
      prm.pacc[(sb * prm.d_pad + col + 1) * prm.p + q] = acc[d][2 * h + 1];
    }
  }
}

// Tensor maps of one sweep: the features as (C, rows) with a (KC, TM) box
// of 128-byte rows, 128-byte swizzled (wgmma's K-major SW128 layout), and
// the labels as (D_pad, rows) with a (dw, TM) box. Boxes past the bank's
// last row or past C fill with zeros.
cudaError_t make_maps(const void* feats, const void* labels, long long rows, int c, int d_pad, int dw,
                      CUtensorMap* feat_map, CUtensorMap* lab_map) {
  EncodeTiled encode = encode_tiled();  // hopper_mma.cuh
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t fdim[2] = {cuuint64_t(c), cuuint64_t(rows)};
  const cuuint64_t fstride[1] = {cuuint64_t(c) * 4};
  const cuuint32_t fbox[2] = {KC, TM};
  const cuuint32_t ones[2] = {1, 1};
  CUresult r = encode(feat_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(feats), fdim, fstride, fbox,
                      ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
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

template <int ND>
cudaError_t prepare(int c, size_t* smem) {
  *smem = smem_layout(c).total;
  return cudaFuncSetAttribute(affinity_bank_f32_kernel<ND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(*smem));
}

bool shape_ok(int k, int batch, int p_loc, int c, int p, int wd) {
  return k >= 1 && c % 16 == 0 && c >= 16 && c <= kMaxC && p >= 1 && wd >= 1 && batch >= 1 && p_loc >= 1;
}

}  // namespace

// How the sweep is cut: `splits` blocks per target tile, each over
// `iters_per_split` (slot, bank tile) iterations, by the wave model of
// bank_split.cuh at this kernel's occupancy and shared memory. Returns a
// cudaError_t.
extern "C" int affinity_bank_f32_plan(int k, int batch, int p_loc, int c, int p, int wd, int* splits,
                                      int* iters_per_split) {
  if (!shape_ok(k, batch, p_loc, c, p, wd)) return int(cudaErrorInvalidValue);
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  size_t smem = 0;
  if (err == cudaSuccess) err = prepare<24>(c, &smem);
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
  const long long rows = (long long)cap * batch * p_loc;
  if (rows > 0x7fffffffll) return int(cudaErrorInvalidValue);  // TMA coordinates are int32
  CUtensorMap feat_map, lab_map;
  cudaError_t err = make_maps(bank_feats, bank_labels, rows, c, d_pad, dw, &feat_map, &lab_map);
  if (err != cudaSuccess) return int(err);
  Params prm;
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
  if (dw == 8) {
    err = prepare<8>(c, &smem);
    if (err == cudaSuccess) affinity_bank_f32_kernel<8><<<grid, kThreads, smem, s>>>(feat_map, lab_map, prm);
  } else if (dw == 16) {
    err = prepare<16>(c, &smem);
    if (err == cudaSuccess) affinity_bank_f32_kernel<16><<<grid, kThreads, smem, s>>>(feat_map, lab_map, prm);
  } else {
    err = prepare<24>(c, &smem);
    if (err == cudaSuccess) affinity_bank_f32_kernel<24><<<grid, kThreads, smem, s>>>(feat_map, lab_map, prm);
  }
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}
