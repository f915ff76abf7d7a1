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
// The softmax runs in log2 units (s log2 e, exp2), and m is stored back in
// natural units.
//
// What bounds it on the H100: at 480p (K 9, P 6420, C 256) the similarity
// product is 2 K P^2 C = 190 GFLOP (0.19 ms at the 989 TFLOP/s bf16 rate),
// and the K P^2 = 371 M softmax exps take 0.09 ms on the MUFU pipe (16 a
// clock per SM). The unique bytes are few (the sampled bank, 32.4 MB a lane
// at 480p and 163 MB at 1080p, 135 x 240), but every block streams the whole
// sampled bank from L2, K P (C + 24) x 2 B, so a block that owns TQ target
// rows moves ceil(P / TQ) banks a frame: with TQ = 192, 34 x 32.4 MB = 1.10
// GB at 480p and 169 x 163 MB = 27.6 GB a lane at 1080p (TQ = 128 before:
// 1.65 and 41.5 GB). Inside the SM the per-pair epilogue bounds it, not the
// tensor cores: the softmax, the prior's two table reads and products, the
// hi / lo split and the label product are ~800 instructions a warp per
// tile (32 pairs a thread), against 16 wgmma.
//
// Design:
// - One block owns TQ = 192 target rows of one video: three consumer
//   warpgroups of 64 rows and a producer warpgroup (512 threads, one block
//   an SM). setmaxnreg moves the registers: 32 a producer thread, 160 a
//   consumer thread (ptxas: 128 at launch, no spills at C 256).
// - The producer's first thread loads the target tile by TMA (a 3-D map of
//   the (B, P, C) target, rows past P zero) and then, as stages come free,
//   each bank tile of TM = 64 rows into a ring of up to 4 stages: the
//   features in boxes of 64 channels x 64 rows (128-byte rows, 128-byte
//   swizzled: wgmma's K-major SW128 layout; boxes of 16-byte rows made TMA
//   read a 32-byte sector per 16 bytes, which bounded the old sweep at 35
//   ms of its 54 at 1080p), and the labels (up to 64 columns) as a dense
//   tile. Each stage has a full mbarrier (the TMA bytes and the producer's
//   four warps) and an empty one (the twelve consumer warps), so no barrier
//   spans the block after the start.
// - Meanwhile the producer's 128 threads write the tile's row table (fy:
//   exp(-dy^2 invsigma2) for the TM + TQ - 1 row offsets of the pair), its
//   column indices r mod wd and its TileInfo (the slot's biases and column
//   table, the ragged and far-tile tests), so the consumers run no integer
//   division, no float division and no table lookup in global memory per
//   tile. The column factor exp(-dx^2 invsigma2) depends only on the slot's
//   inverse sigma^2, which takes at most two values: its two tables (2 wd -
//   1 values each) are built once per block, before the sweep.
// - Each consumer warp loads its 16 target rows once as the A fragments of
//   all C / 16 k-steps (ldmatrix from the swizzled tile; 64 registers). Per
//   tile, S = tgt . ref^T is C / 16 wgmma m64n64k16 (A from registers, B
//   from the stage, float32 accumulators), then the online softmax on those
//   registers (row max by partial maxima and quad shuffles, exp2), e w from
//   the two tables, e w split into bf16 hi and lo in registers and used as
//   the A operand of the label product (mma.sync m16n8k16, B by
//   ldmatrix.trans from the label tile; acc stays in registers). The three
//   warpgroups run unsynchronised, so one's wgmma runs under the others'
//   epilogues (three warps a scheduler). Measured at 1080p B = 2 on the
//   card, one product kept in flight inside each warpgroup (two accumulator
//   sets, the next tile's wgmma issued before this tile's softmax) tied this
//   with A in shared memory (31.3 against 31.3 ms) and lost by 4 % to A in
//   registers; with two consumer warpgroups it gained 46.0 against 50.5 ms,
//   and turns between the two (named barriers) 47.2. A per-pair table of fy
//   fx built by the producer (one read a pair instead of two) gained
//   nothing, and four consumer warpgroups 3 % with spills.
// - A (bank tile, target tile) pair whose minimum row gap gives w <=
//   exp(-36) skips its label product (the TPU kernel's far-tile skip, same
//   threshold); its similarity and exps still run (the denominator spans
//   every bank pixel). With the prior off (invsigma2 0) no table is built.
// - Split over the bank (flash-decoding): the (slot, bank tile) sweep of a
//   target tile is cut into `splits` contiguous ranges, one block each, so
//   that the grid fills the 132 SMs; each block writes partial (m, l, acc),
//   and a second kernel combines them as bank shards combine: m* = max m,
//   out = sum acc e^(m - m*) / sum l e^(m - m*). The split count comes from
//   the wave model of bank_split.cuh (affinity_bank_plan).
// Shared memory at C 256 and 24 label columns: target 98,304 B + ring 3 x
// 36,864 + per stage 255 + 64 + 8 table words + column tables 2 x (2 wd - 1)
// x 4 + barriers = 211,712 B at 480p (wd 107), 213,760 at 1080p (wd 240) of
// the 232,448 a block may use. The ring takes 4 stages where they fit and
// 2 at least; a frame too wide for the column tables (wd above ~3,080 at 64
// label columns) drops them and takes the column factor's exp per pair
// instead, so any width runs.
// What still holds it back: the epilogue's issue rate. The sweep runs at
// about a third of its roofline (1080p B = 2: 29.5 ms against 9.8 of
// tensor time; with the epilogue removed, a probe at two consumer
// warpgroups, the products and the stream took 12.6 ms); the consumer
// warps stall on the chain of each tile (products, row max and shuffles,
// exps, table reads, hi / lo, the label product's mma.sync), and the exp
// pipe is not the limit (an FMUL in its place saved 2 of 45 ms).
//
// Numerics traps handled: the running max starts at -1e30 (times log2 e),
// never -inf, so an all-invalid first tile cannot give inf - inf; rows past
// the bank's end get -inf (they never enter the max, which is >= -1e30);
// rows >= P get the -1e30 padding bias; label classes past d_pad are never
// loaded, so padded classes stay exactly 0; a split whose slots are all
// invalid has m = -1e30 and weighs e^(-1e30 - m*) = 0 in the combine unless
// every split is invalid, where it gives the unsplit result (every weight
// 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bank_split.cuh"
#include "hopper_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int TM = 64;                // bank rows per tile
constexpr int kWG = 3;                // consumer warpgroups of 64 target rows each
constexpr int TQ = 64 * kWG;          // target rows per block
constexpr int kConsumerWarps = 4 * kWG;
constexpr int kThreads = 128 * (kWG + 1);  // and one producer warpgroup
constexpr int kProducerRegs = 32, kConsumerRegs = 160;  // setmaxnreg: 32 + 3 x 160 = 4 x 128
constexpr int kMaxStages = 4;         // ring depth where it fits (2 at least)
constexpr int kMaxCK = 16;            // C / 16 <= 16: C <= 256
constexpr int kMaxND = 8;             // label columns per launch <= 64
constexpr int kMaxSplits = 64;
constexpr int KB = 64;                // channels per box: 128-byte rows
constexpr uint32_t kBoxBytes = 64 * KB * 2;  // a box of 64 rows (a bank tile's, or a warpgroup's target rows)
constexpr int kFyLen = TM + TQ - 1;   // row offsets r - q of a (bank tile, target tile) pair
constexpr int kMaxSmem = 232448;      // dynamic shared memory a block may use
constexpr float kNegInf = -1e30f;
constexpr float kTileSkipThresh = 36.0f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf2 = kNegInf * kLog2e;  // -1e30 in the sweep's log2 units

// The bank (cap, B, P_loc, C) features and (cap, B, P_loc, D_pad) labels,
// and the (B, P, C) target (temperature folded in), arrive through TMA
// tensor maps (kernel parameters of their own).
struct Params {
  const int* table;  // (4, K): slot, bits of inv_sigma2, bits of the slot bias, column table (0 or 1)
  float* pm;         // (splits, B, P) partial running max
  float* pl;         // (splits, B, P) partial denominators
  float* pacc;       // (splits, B, D_pad, P) partial numerators
  int batch, p_loc, c, d_pad, d_off, dw, p, wd, row_base, k;
  int tiles_per_slot, n_iter, iters_per_split, stages, fx_table;
};

// A tile's parameters, written by the producer beside the tile's stage.
struct TileInfo {
  float inv_s;  // the slot's inverse sigma^2 (0: prior off)
  float bias2;  // the slot's bias in log2 units (0, or -1e30 log2 e for an invalid slot)
  int cls;      // the slot's column table
  int lrow0;    // the tile's first row in the slot
  int r0;       // and its global row
  int label;    // the prior reaches the target tile (above exp(-36)): run the label product
  int ragged;   // rows past the slot's end or past P
  int pad;     // to 32 bytes: two 16-byte loads
};

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }
__host__ __device__ constexpr size_t align1024(size_t x) { return (x + 1023) & ~size_t(1023); }

struct Smem {
  size_t ring, lab, stage, fy, rx, info, fx, bars, total;
};

// The target tile (each consumer warpgroup's 64 rows as ceil(C / 64) boxes
// of 64 rows x 128 bytes, 128-byte swizzled: wgmma's K-major SW128 layout),
// then a ring of `stages` stages, each a bank tile's features in boxes of
// the same layout and a dense TM x dw label tile. Then per stage the tile's
// row table (kFyLen floats), column indices (TM ints) and TileInfo, the
// two column tables (2 wd - 1 floats each, one per inverse sigma^2; none on
// a frame too wide for them) and the barriers.
__host__ __device__ inline Smem smem_layout(int c, int wd, int dw, int stages, bool fx_table) {
  Smem o;
  o.lab = size_t((c + KB - 1) / KB) * kBoxBytes;
  o.ring = kWG * o.lab;
  o.stage = align1024(o.lab + size_t(TM) * dw * 2);
  o.fy = o.ring + size_t(stages) * o.stage;
  o.rx = align128(o.fy + size_t(stages) * kFyLen * 4);
  o.info = align128(o.rx + size_t(stages) * TM * 4);
  o.fx = align128(o.info + size_t(stages) * sizeof(TileInfo));
  o.bars = align128(o.fx + (fx_table ? size_t(2) * (2 * wd - 1) * 4 : 0));
  o.total = align128(o.bars + (2 * kMaxStages + 1) * 8);
  return o;
}

// The deepest ring that fits in a block's shared memory, with the column
// tables if they fit (*fx_table); 0 if no ring does.
int ring_stages(int c, int wd, int dw, int* fx_table) {
  for (int table = 1; table >= 0; --table)
    for (int s = kMaxStages; s >= 2; --s)
      if (smem_layout(c, wd, dw, s, table).total <= size_t(kMaxSmem)) {
        *fx_table = table;
        return s;
      }
  return 0;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// s = tgt . ref^T for one bank tile: 64 target rows (A fragments in
// registers) x 64 bank rows (stage `st`, K-major SW128: a k16 step is 32
// bytes along a box's 128-byte rows), C / 16 wgmma, one commit group.
template <bool kC256>
__device__ __forceinline__ void similarity(float (&s)[8][4], const uint32_t (&qa)[kMaxCK][4],
                                           const unsigned char* st, int ck) {
  fence_operands(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kMaxCK; ++kk)
    if (kC256 || kk < ck)
      wgmma_m64n64k16(s, qa[kk], smem_desc_swizzled(st + (kk >> 2) * kBoxBytes + (kk & 3) * 32, 8 * KB * 2, 1),
                      kk > 0);
  wgmma_commit();
}

// ---- per-tile work of both sweeps (kRows: a block's target rows) ----------

// fx[j] = exp(-(j - (wd - 1))^2 inv_s), once per inverse sigma^2 that this
// block's slots use (a slot's column table is row 3 of the table); run by the
// producer warpgroup's 128 threads, ptid a thread's index among them.
__device__ __forceinline__ void column_tables(float* fx_s, const Params& prm, int it_begin, int it_end, int wd,
                                              int ptid) {
  const int ks_lo = it_begin / prm.tiles_per_slot, ks_hi = (it_end - 1) / prm.tiles_per_slot;
  for (int cls = 0; cls < 2; ++cls) {
    float inv_s = 0.f;
    for (int ks = ks_lo; ks <= ks_hi && inv_s == 0.f; ++ks)
      if (__ldg(prm.table + 3 * prm.k + ks) == cls) inv_s = __int_as_float(__ldg(prm.table + prm.k + ks));
    if (inv_s == 0.f) continue;
    float* fx = fx_s + cls * (2 * wd - 1);
    for (int j = ptid; j < 2 * wd - 1; j += 128) {
      const float dx = float(j - (wd - 1));
      fx[j] = expf(-dx * dx * inv_s);
    }
  }
}

// A tile's TileInfo (written by the producer's first thread): its slot's
// biases and column table, the far-tile test against the block's target rows
// q0 .. q0 + kRows - 1 and the ragged test.
template <int kRows>
__device__ __forceinline__ TileInfo tile_info(const Params& prm, int ks, int lrow0, int r0, int q0, float inv_s,
                                              float wdf) {
  const float ry_lo = float(r0) / wdf, ry_hi = float(r0 + TM - 1) / wdf;
  const float ty_lo = float(q0) / wdf, ty_hi = float(q0 + kRows - 1) / wdf;
  const float dy_gap = fmaxf(fmaxf(ty_lo - ry_hi, ry_lo - ty_hi), 0.f);
  TileInfo ti;
  ti.inv_s = inv_s;
  ti.bias2 = __int_as_float(__ldg(prm.table + 2 * prm.k + ks)) * kLog2e;
  ti.cls = __ldg(prm.table + 3 * prm.k + ks);
  ti.lrow0 = lrow0;
  ti.r0 = r0;
  ti.label = dy_gap * dy_gap * inv_s < kTileSkipThresh;
  ti.ragged = (lrow0 + TM > prm.p_loc) || (r0 + TM > prm.p);
  ti.pad = 0;
  return ti;
}

// A tile's row table fy (exp(-dy^2 inv_s) for the TM + kRows - 1 row offsets
// r - q of the pair) and its column indices r mod wd, into stage `stage`; the
// producer warpgroup's 128 threads.
template <int kRows>
__device__ __forceinline__ void row_table(float* fy_s, int* rx_s, int stage, int r0, int q0, float inv_s, float wdf,
                                          int wd, int ptid) {
  float* fy = fy_s + stage * (TM + kRows - 1);
  for (int j = ptid; j < TM + kRows - 1; j += 128) {
    const float dy = float(r0 + j - (kRows - 1) - q0) / wdf;
    fy[j] = expf(-dy * dy * inv_s);
  }
  if (ptid < TM) rx_s[stage * TM + ptid] = (r0 + ptid) % wd;
}

// One tile's epilogue on its scores s (this thread's target rows qloc and
// qloc + 8 against the tile's 64 bank rows), from stage `stage`'s TileInfo
// ti, labels ls and row table: the online softmax in log2 units, then, unless
// the tile is far, e w and acc += (e w)_hi . labels + (e w)_lo . labels.
template <int kNT, int kRows>
__device__ __forceinline__ void tile_epilogue(float (&s)[8][4], float (&acc)[kNT][4], float (&m_r)[2],
                                              float (&l_r)[2], const TileInfo& ti, const Params& prm, const bf16* ls,
                                              const float* fy_s, const int* rx_s, const float* fx_s, int stage, int wd,
                                              int qloc, int qx0, int qx1, int lane, int t, int nd) {
  // ---- biases, online softmax in log2 units ------------------------------
  float tm[2][4];  // four partial maxima a row: short dependency chains
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j) tm[h][j] = m_r[h];
  if (!ti.ragged) {
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nn][e] = fmaf(s[nn][e], kLog2e, ti.bias2);
        tm[e >> 1][(nn & 1) * 2 + (e & 1)] = fmaxf(tm[e >> 1][(nn & 1) * 2 + (e & 1)], s[nn][e]);
      }
  } else {  // a slot's last tile: rows past its end -inf, rows past P -1e30 more
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nn * 8 + 2 * t + (e & 1);
        float v = fmaf(s[nn][e], kLog2e, ti.bias2);
        if (ti.lrow0 + c >= prm.p_loc)
          v = __int_as_float(0xff800000);  // -inf
        else if (ti.r0 + c >= prm.p)
          v += kNegInf2;
        s[nn][e] = v;
        tm[e >> 1][(nn & 1) * 2 + (e & 1)] = fmaxf(tm[e >> 1][(nn & 1) * 2 + (e & 1)], v);
      }
  }
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = fmaxf(fmaxf(tm[h][0], tm[h][1]), fmaxf(tm[h][2], tm[h][3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    alpha[h] = fast_exp2(m_r[h] - mx);
    m_r[h] = mx;
    l_r[h] *= alpha[h];
  }
  float ls2[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // two partial sums a row
#pragma unroll
  for (int nn = 0; nn < 8; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float ev = fast_exp2(s[nn][e] - m_r[e >> 1]);
      ls2[e >> 1][e & 1] += ev;
      s[nn][e] = ev;
    }
  l_r[0] += ls2[0][0] + ls2[0][1];
  l_r[1] += ls2[1][0] + ls2[1][1];
#pragma unroll
  for (int d = 0; d < kNT; ++d) {
    acc[d][0] *= alpha[0];
    acc[d][1] *= alpha[0];
    acc[d][2] *= alpha[1];
    acc[d][3] *= alpha[1];
  }

  // ---- far tiles (the producer's test) skip the prior and labels -------
  if (ti.label) {
    // ---- e w: two table reads, no exp (with no column table, the column
    // factor's exp) -----------------------------------------------------
    if (ti.inv_s != 0.f) {
      const float* fy = fy_s + stage * (TM + kRows - 1) + (kRows - 1 - qloc);
      const int* rx = rx_s + stage * TM;
      if (prm.fx_table) {
        const float* fx = fx_s + ti.cls * (2 * wd - 1) + (wd - 1);
        const float* fx0 = fx - qx0;
        const float* fx1 = fx - qx1;
#pragma unroll
        for (int nn = 0; nn < 8; ++nn) {
          const int2 rxp = *reinterpret_cast<const int2*>(rx + nn * 8 + 2 * t);  // columns c, c + 1
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = nn * 8 + 2 * t + j;
            const int rxc = j ? rxp.y : rxp.x;
            s[nn][j] *= fy[c] * fx0[rxc];
            s[nn][j + 2] *= fy[c - 8] * fx1[rxc];
          }
        }
      } else {  // a frame too wide for the column tables
#pragma unroll
        for (int nn = 0; nn < 8; ++nn)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = nn * 8 + 2 * t + j;
            const float dx0 = float(rx[c] - qx0), dx1 = float(rx[c] - qx1);
            s[nn][j] *= fy[c] * expf(-dx0 * dx0 * ti.inv_s);
            s[nn][j + 2] *= fy[c - 8] * expf(-dx1 * dx1 * ti.inv_s);
          }
      }
    }
    // ---- acc += (e w)_hi . labels + (e w)_lo . labels --------------------
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float v0 = s[2 * j + (h >> 1)][2 * (h & 1)], v1 = s[2 * j + (h >> 1)][2 * (h & 1) + 1];
        ahi[h] = pack_bf16(v0, v1);
        alo[h] = pack_bf16(v0 - bf16_lo(ahi[h]), v1 - bf16_hi(ahi[h]));
      }
      const bf16* lrow = ls + (16 * j + (lane & 15)) * prm.dw;
#pragma unroll
      for (int d = 0; d < kNT; d += 2) {
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
}

// This split's partial (m, l, acc), m in natural units.
template <int kNT>
__device__ __forceinline__ void write_partials(const Params& prm, int split, int b, int q0, int qloc, int t, int nd,
                                               const float (&m_r)[2], const float (&l_r)[2],
                                               const float (&acc)[kNT][4]) {
  const size_t sb = size_t(split) * prm.batch + b;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int q = q0 + qloc + 8 * h;
    if (q >= prm.p) continue;
    if (t == 0) {
      prm.pm[sb * prm.p + q] = m_r[h] * kLn2;
      prm.pl[sb * prm.p + q] = l;
    }
#pragma unroll
    for (int d = 0; d < kNT; ++d) {
      if (d < nd) {
        const int col = prm.d_off + d * 8 + 2 * t;
        prm.pacc[(sb * prm.d_pad + col) * prm.p + q] = acc[d][2 * h];
        prm.pacc[(sb * prm.d_pad + col + 1) * prm.p + q] = acc[d][2 * h + 1];
      }
    }
  }
}

// kNT: label n-tiles the registers hold (3: dw <= 24, 8: dw <= 64).
template <bool kC256, int kNT>
__global__ void __launch_bounds__(kThreads, 1)
    affinity_bank_kernel(const __grid_constant__ CUtensorMap feat_map, const __grid_constant__ CUtensorMap lab_map,
                         const __grid_constant__ CUtensorMap tgt_map, Params prm) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int C = kC256 ? 256 : prm.c;
  const int CK = C / 16, boxes = (C + KB - 1) / KB;
  const int stages = prm.stages, wd = prm.wd;
  const Smem lay = smem_layout(C, wd, prm.dw, stages, prm.fx_table);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * TQ, split = blockIdx.y, b = blockIdx.z;
  const int it_begin = split * prm.iters_per_split;
  const int it_end = min(prm.n_iter, it_begin + prm.iters_per_split);
  const float wdf = float(wd);
  float* fy_s = reinterpret_cast<float*>(smem + lay.fy);
  int* rx_s = reinterpret_cast<int*>(smem + lay.rx);
  TileInfo* info_s = reinterpret_cast<TileInfo*>(smem + lay.info);
  float* fx_s = reinterpret_cast<float*>(smem + lay.fx);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);  // a stage's tiles and tables are in
  uint64_t* empty = full + kMaxStages;                             // the consumer warps are done with it
  uint64_t* tgt_full = empty + kMaxStages;                         // the target tile is in
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1 + 4);  // the TMA bytes' arrival, then each producer warp's
      mbar_init(empty + s, kConsumerWarps);
    }
    mbar_init(tgt_full, 1);
    fence_mbar_init();
  }
  if (warp >= kConsumerWarps && prm.fx_table)
    column_tables(fx_s, prm, it_begin, it_end, wd, tid - 32 * kConsumerWarps);
  __syncthreads();  // the column tables are built, the barriers initialised

  if (warp >= kConsumerWarps) {
    // ---- producer warpgroup: one thread issues the target's and each
    // tile's TMA loads as stages come free and writes the tile's TileInfo;
    // all 128 write its row table and column indices meanwhile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int ptid = tid - 32 * kConsumerWarps;
    if (ptid == 0) {  // the target tile: rows past P fill with zeros
      mbar_expect_tx(tgt_full, kWG * boxes * kBoxBytes);
      for (int w = 0; w < kWG; ++w)
        for (int kb = 0; kb < boxes; ++kb)
          tma_load_3d(smem + (w * boxes + kb) * kBoxBytes, &tgt_map, tgt_full, kb * KB, q0 + w * 64, b);
    }
    const uint32_t stage_bytes = boxes * kBoxBytes + uint32_t(TM) * prm.dw * 2;
    int stage = 0;
    uint32_t phase = 0;
    for (int it = it_begin; it < it_end; ++it) {
      mbar_wait(empty + stage, phase ^ 1);  // passes at once on the ring's first round
      const int ks = it / prm.tiles_per_slot;
      const int lrow0 = (it - ks * prm.tiles_per_slot) * TM;
      const float inv_s = __int_as_float(__ldg(prm.table + prm.k + ks));
      const int r0 = prm.row_base + lrow0;
      if (ptid == 0) {
        // rows past the slot's end are loaded too (the next slot's, or
        // zeros past the bank) and masked to -inf by the consumers
        const int row = (__ldg(prm.table + ks) * prm.batch + b) * prm.p_loc + lrow0;
        unsigned char* st = smem + lay.ring + size_t(stage) * lay.stage;
        mbar_expect_tx(full + stage, stage_bytes);
        for (int kb = 0; kb < boxes; ++kb) tma_load_2d(st + kb * kBoxBytes, &feat_map, full + stage, kb * KB, row);
        tma_load_2d(st + lay.lab, &lab_map, full + stage, prm.d_off, row);
        info_s[stage] = tile_info<TQ>(prm, ks, lrow0, r0, q0, inv_s, wdf);
      }
      if (inv_s != 0.f) row_table<TQ>(fy_s, rx_s, stage, r0, q0, inv_s, wdf, wd, ptid);
      __syncwarp();
      if (lane == 0) mbar_arrive(full + stage);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // ---- consumers: warpgroup cwg owns target rows 64 cwg.. of the tile -----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int g = lane >> 2, t = lane & 3, cwg = warp >> 2;
  const int nd = prm.dw / 8;
  float acc[kNT][4];
#pragma unroll
  for (int i = 0; i < kNT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  // running max (log2 units: scores times log2 e) and denominator per row
  float m_r[2] = {kNegInf2, kNegInf2}, l_r[2] = {0.f, 0.f};
  const int qloc = warp * 16 + g;  // this thread's rows: qloc and qloc + 8
  const int qx0 = (q0 + qloc) % wd, qx1 = (q0 + qloc + 8) % wd;
  // this warp's 16 target rows, A fragments for the whole sweep, from the
  // swizzled tile: 16-byte chunk j of row r sits at chunk j ^ (r & 7)
  uint32_t qa[kMaxCK][4];
  mbar_wait(tgt_full, 0);
  {
    const unsigned char* tgt = smem + cwg * boxes * kBoxBytes;
    const int r = (warp & 3) * 16 + (lane & 15);
#pragma unroll
    for (int kk = 0; kk < kMaxCK; ++kk)
      if (kC256 || kk < CK) {
        const int j = (kk & 3) * 2 + (lane >> 4);
        ldmatrix_x4(qa[kk], tgt + (kk >> 2) * kBoxBytes + r * 128 + ((j ^ (r & 7)) << 4));
      }
  }

  int stage = 0;
  uint32_t phase = 0;
  for (int it = it_begin; it < it_end; ++it) {
    // ---- S = tgt . ref^T; the other warpgroups' softmax runs meanwhile ----
    mbar_wait(full + stage, phase);
    const unsigned char* st = smem + lay.ring + size_t(stage) * lay.stage;
    float s[8][4];
    similarity<kC256>(s, qa, st, CK);
    wgmma_wait<0>();
    fence_operands(s);
    const bf16* ls = reinterpret_cast<const bf16*>(st + lay.lab);
    const TileInfo ti = info_s[stage];
    tile_epilogue<kNT, TQ>(s, acc, m_r, l_r, ti, prm, ls, fy_s, rx_s, fx_s, stage, wd, qloc, qx0, qx1, lane, t, nd);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + stage);  // this warp is done with the stage
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }

  write_partials<kNT>(prm, split, b, q0, qloc, t, nd, m_r, l_r, acc);
}

// ---- the wide sweep: 256 < C <= 768 -----------------------------------------
//
// At C = 768 (DINO ViT-B/8) the design above does not fit: a 192-row target
// tile is 294,912 B of the 232,448 a block may use, a 64-row bank tile
// 98,304 B, and the A fragments 192 registers a thread against the 160 that
// setmaxnreg gives. The wide variant keeps the same producer / consumer
// split and runs the same per-tile code (column_tables, tile_info, row_table,
// tile_epilogue and write_partials above, at kRows = TQW), and moves the rest:
// - Target rows: TQW = 128 a block, two consumer warpgroups of 64 and the
//   producer warpgroup (384 threads). The target tile stays in shared memory
//   (C / 64 boxes of 64 rows x 128 bytes a warpgroup, SW128, 196,608 B at C
//   768) and is the A operand of wgmma from shared memory (SS), so no
//   fragments live in registers: a consumer thread holds its 32 scores, 12
//   label accumulators and the softmax state (no setmaxnreg; at most 168
//   registers a thread at 384 threads).
// - The bank streams in 64-channel boxes (8,192 B: 64 rows x 128 bytes,
//   SW128, the boxes the TMA ring above uses) through a ring of box stages,
//   as deep as fits: 3 at 480p and C 768 (6 at C 512), 2 at 1080p. A tile's
//   similarity is C / 64 boxes of 4 wgmma m64n64k16 each; each warpgroup
//   keeps one box's products in flight and frees the box before it.
// - A tile's labels (at most 24 columns: one sweep at the 22-class budget),
//   its row table fy (TM + TQW - 1 floats), column indices and TileInfo sit
//   in a ring of two tile stages of their own, filled while the boxes of
//   the tile before stream; the column tables are as above.
// - Shared memory at C 768, 24 label columns: target 196,608 + 3 boxes
//   24,576 + 2 x (labels 3,072 + fy 764 + columns 256 + info 32) + column
//   tables 2 x (2 wd - 1) x 4 + barriers = 231,464 B at 480p (wd 107); at
//   1080p (wd 240) the ring takes 2 boxes.
// The two warpgroups read the same boxes, so they run nearly in step: the
// tensor cores wait during the tile's epilogue, which the narrow sweep hides
// under the other warpgroups' products. A block streams the sampled bank
// ceil(P / 128) times a frame from L2 (51 x 88.7 MB a lane at 480p).
struct Wide {};  // the width class of the wide sweep's instantiation

constexpr int kNarrowMaxC = 16 * kMaxCK;  // 256
constexpr int kWideWG = 2;                // consumer warpgroups of 64 target rows each
constexpr int TQW = 64 * kWideWG;         // target rows per block
constexpr int kWideConsumerWarps = 4 * kWideWG;
constexpr int kWideThreads = 128 * (kWideWG + 1);
constexpr int kWideMaxC = 768;
constexpr int kWideNT = 3;                // label n-tiles a thread holds
constexpr int kWideMaxDw = 8 * kWideNT;   // label columns per launch: 24
constexpr int kWideMaxBoxStages = 8;
constexpr int kWideTileStages = 2;
constexpr int kFyLenW = TM + TQW - 1;

struct SmemWide {
  size_t ring, lab, lab_stage, fy, rx, info, fx, bars, total;
};

// The target tile (each consumer warpgroup's 64 rows as C / 64 boxes), the
// ring of `box_stages` bank boxes, then two tile stages of labels, row
// tables, column indices and TileInfo, the column tables and the barriers.
__host__ __device__ inline SmemWide smem_layout_wide(int c, int wd, int dw, int box_stages, bool fx_table) {
  SmemWide o;
  o.ring = size_t(kWideWG) * (c / KB) * kBoxBytes;
  o.lab = o.ring + size_t(box_stages) * kBoxBytes;
  o.lab_stage = align128(size_t(TM) * dw * 2);
  o.fy = o.lab + kWideTileStages * o.lab_stage;
  o.rx = align128(o.fy + size_t(kWideTileStages) * kFyLenW * 4);
  o.info = align128(o.rx + size_t(kWideTileStages) * TM * 4);
  o.fx = align128(o.info + size_t(kWideTileStages) * sizeof(TileInfo));
  o.bars = align128(o.fx + (fx_table ? size_t(2) * (2 * wd - 1) * 4 : 0));
  o.total = align128(o.bars + (2 * kWideMaxBoxStages + 2 * kWideTileStages + 1) * 8);
  return o;
}

// The deepest box ring that fits, with the column tables if they fit.
int ring_stages_wide(int c, int wd, int dw, int* fx_table) {
  for (int table = 1; table >= 0; --table)
    for (int s = kWideMaxBoxStages; s >= 2; --s)
      if (smem_layout_wide(c, wd, dw, s, table).total <= size_t(kMaxSmem)) {
        *fx_table = table;
        return s;
      }
  return 0;
}

template <typename W, int kNT>
__global__ void __launch_bounds__(kWideThreads, 1)
    affinity_bank_kernel(const __grid_constant__ CUtensorMap feat_map, const __grid_constant__ CUtensorMap lab_map,
                         const __grid_constant__ CUtensorMap tgt_map, Params prm) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int boxes = prm.c / KB;
  const int box_stages = prm.stages, wd = prm.wd;
  const SmemWide lay = smem_layout_wide(prm.c, wd, prm.dw, box_stages, prm.fx_table);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * TQW, split = blockIdx.y, b = blockIdx.z;
  const int it_begin = split * prm.iters_per_split;
  const int it_end = min(prm.n_iter, it_begin + prm.iters_per_split);
  const float wdf = float(wd);
  float* fy_s = reinterpret_cast<float*>(smem + lay.fy);
  int* rx_s = reinterpret_cast<int*>(smem + lay.rx);
  TileInfo* info_s = reinterpret_cast<TileInfo*>(smem + lay.info);
  float* fx_s = reinterpret_cast<float*>(smem + lay.fx);
  uint64_t* box_full = reinterpret_cast<uint64_t*>(smem + lay.bars);  // a bank box is in
  uint64_t* box_empty = box_full + kWideMaxBoxStages;                  // the consumer warps are done with it
  uint64_t* tile_full = box_empty + kWideMaxBoxStages;                 // a tile's labels and tables are in
  uint64_t* tile_empty = tile_full + kWideTileStages;                  // the consumer warps are done with them
  uint64_t* tgt_full = tile_empty + kWideTileStages;                   // the target tile is in
  if (tid == 0) {
    for (int s = 0; s < box_stages; ++s) {
      mbar_init(box_full + s, 1);
      mbar_init(box_empty + s, kWideConsumerWarps);
    }
    for (int s = 0; s < kWideTileStages; ++s) {
      mbar_init(tile_full + s, 1 + 4);  // the labels' bytes, then each producer warp's tables
      mbar_init(tile_empty + s, kWideConsumerWarps);
    }
    mbar_init(tgt_full, 1);
    fence_mbar_init();
  }
  if (warp >= kWideConsumerWarps && prm.fx_table)
    column_tables(fx_s, prm, it_begin, it_end, wd, tid - 32 * kWideConsumerWarps);
  __syncthreads();  // the column tables are built, the barriers initialised

  if (warp >= kWideConsumerWarps) {
    // ---- producer warpgroup: the target tile once, then per tile its labels
    // and tables into a tile stage and its C / 64 feature boxes into the ring
    const int ptid = tid - 32 * kWideConsumerWarps;
    if (ptid == 0) {  // rows past P fill with zeros
      mbar_expect_tx(tgt_full, kWideWG * boxes * kBoxBytes);
      for (int w = 0; w < kWideWG; ++w)
        for (int kb = 0; kb < boxes; ++kb)
          tma_load_3d(smem + (w * boxes + kb) * kBoxBytes, &tgt_map, tgt_full, kb * KB, q0 + w * 64, b);
    }
    int bstage = 0, tstage = 0;
    uint32_t bphase = 0, tphase = 0;
    for (int it = it_begin; it < it_end; ++it) {
      mbar_wait(tile_empty + tstage, tphase ^ 1);  // passes at once on the first round
      const int ks = it / prm.tiles_per_slot;
      const int lrow0 = (it - ks * prm.tiles_per_slot) * TM;
      const float inv_s = __int_as_float(__ldg(prm.table + prm.k + ks));
      const int r0 = prm.row_base + lrow0;
      // rows past the slot's end are loaded too and masked by the consumers
      const int row = (__ldg(prm.table + ks) * prm.batch + b) * prm.p_loc + lrow0;
      if (ptid == 0) {
        mbar_expect_tx(tile_full + tstage, uint32_t(TM) * prm.dw * 2);
        tma_load_2d(smem + lay.lab + tstage * lay.lab_stage, &lab_map, tile_full + tstage, prm.d_off, row);
        info_s[tstage] = tile_info<TQW>(prm, ks, lrow0, r0, q0, inv_s, wdf);
      }
      if (inv_s != 0.f) row_table<TQW>(fy_s, rx_s, tstage, r0, q0, inv_s, wdf, wd, ptid);
      __syncwarp();
      if (lane == 0) mbar_arrive(tile_full + tstage);
      if (++tstage == kWideTileStages) {
        tstage = 0;
        tphase ^= 1;
      }
      if (ptid == 0) {
        for (int kb = 0; kb < boxes; ++kb) {
          mbar_wait(box_empty + bstage, bphase ^ 1);
          mbar_expect_tx(box_full + bstage, kBoxBytes);
          tma_load_2d(smem + lay.ring + size_t(bstage) * kBoxBytes, &feat_map, box_full + bstage, kb * KB, row);
          if (++bstage == box_stages) {
            bstage = 0;
            bphase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cwg owns target rows 64 cwg.. of the tile -----
  const int g = lane >> 2, t = lane & 3, cwg = warp >> 2;
  const int nd = prm.dw / 8;
  float acc[kNT][4];
#pragma unroll
  for (int i = 0; i < kNT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m_r[2] = {kNegInf2, kNegInf2}, l_r[2] = {0.f, 0.f};
  const int qloc = warp * 16 + g;  // this thread's rows: qloc and qloc + 8
  const int qx0 = (q0 + qloc) % wd, qx1 = (q0 + qloc + 8) % wd;
  const unsigned char* tgt = smem + cwg * boxes * kBoxBytes;
  mbar_wait(tgt_full, 0);

  int bstage = 0, tstage = 0;
  uint32_t bphase = 0, tphase = 0;
  for (int it = it_begin; it < it_end; ++it) {
    // ---- S = tgt . ref^T box by box, one box's products in flight --------
    float s[8][4];
    int prev = -1;
    for (int kb = 0; kb < boxes; ++kb) {
      mbar_wait(box_full + bstage, bphase);
      const unsigned char* bx = smem + lay.ring + size_t(bstage) * kBoxBytes;
      const unsigned char* ax = tgt + kb * kBoxBytes;
      fence_operands(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_ss(s, smem_desc_swizzled(ax + kk * 32, 8 * KB * 2, 1),
                           smem_desc_swizzled(bx + kk * 32, 8 * KB * 2, 1), kb > 0 || kk > 0);
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();  // the box before is read: free it
        __syncwarp();
        if (lane == 0) mbar_arrive(box_empty + prev);
      }
      prev = bstage;
      if (++bstage == box_stages) {
        bstage = 0;
        bphase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_operands(s);
    __syncwarp();
    if (lane == 0) mbar_arrive(box_empty + prev);
    mbar_wait(tile_full + tstage, tphase);
    const bf16* ls = reinterpret_cast<const bf16*>(smem + lay.lab + tstage * lay.lab_stage);
    const TileInfo ti = info_s[tstage];
    tile_epilogue<kNT, TQW>(s, acc, m_r, l_r, ti, prm, ls, fy_s, rx_s, fx_s, tstage, wd, qloc, qx0, qx1, lane, t,
                            nd);
    __syncwarp();
    if (lane == 0) mbar_arrive(tile_empty + tstage);  // this warp is done with the tile stage
    if (++tstage == kWideTileStages) {
      tstage = 0;
      tphase ^= 1;
    }
  }
  write_partials<kNT>(prm, split, b, q0, qloc, t, nd, m_r, l_r, acc);
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

// Tensor maps of one sweep: the features as (C, rows) with a (64, TM) box
// of 128-byte rows, 128-byte swizzled (wgmma's K-major SW128 layout), the
// labels as (D_pad, rows) with a (dw, TM) box, and the target as (C, P, B)
// with a (64, 64, 1) box laid out as the features'. Boxes past the bank's
// last row, past P or past C fill with zeros.
cudaError_t make_maps(const void* feats, const void* labels, const void* target, long long rows, int c, int d_pad,
                      int dw, int p, int batch, CUtensorMap* feat_map, CUtensorMap* lab_map, CUtensorMap* tgt_map) {
  EncodeTiled encode = encode_tiled();  // hopper_mma.cuh
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t fdim[2] = {cuuint64_t(c), cuuint64_t(rows)};
  const cuuint64_t fstride[1] = {cuuint64_t(c) * 2};
  const cuuint32_t fbox[2] = {KB, TM};
  const cuuint32_t ones[2] = {1, 1};
  CUresult r = encode(feat_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(feats), fdim, fstride, fbox,
                      ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  const cuuint64_t ldim[2] = {cuuint64_t(d_pad), cuuint64_t(rows)};
  const cuuint64_t lstride[1] = {cuuint64_t(d_pad) * 2};
  const cuuint32_t lbox[2] = {cuuint32_t(dw), TM};
  r = encode(lab_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(labels), ldim, lstride, lbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  const cuuint64_t tdim[3] = {cuuint64_t(c), cuuint64_t(p), cuuint64_t(batch)};
  const cuuint64_t tstride[2] = {cuuint64_t(c) * 2, cuuint64_t(p) * c * 2};
  const cuuint32_t tbox[3] = {KB, 64, 1};
  const cuuint32_t ones3[3] = {1, 1, 1};
  r = encode(tgt_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(target), tdim, tstride, tbox, ones3,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool kC256, int kNT>
cudaError_t launch_sweep(dim3 grid, size_t smem, cudaStream_t s, const CUtensorMap* maps, const Params& prm) {
  cudaError_t err = cudaFuncSetAttribute(affinity_bank_kernel<kC256, kNT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  affinity_bank_kernel<kC256, kNT><<<grid, kThreads, smem, s>>>(maps[0], maps[1], maps[2], prm);
  return cudaGetLastError();
}

cudaError_t launch_sweep_wide(dim3 grid, size_t smem, cudaStream_t s, const CUtensorMap* maps, const Params& prm) {
  cudaError_t err = cudaFuncSetAttribute(affinity_bank_kernel<Wide, kWideNT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  affinity_bank_kernel<Wide, kWideNT><<<grid, kWideThreads, smem, s>>>(maps[0], maps[1], maps[2], prm);
  return cudaGetLastError();
}

// C up to 256 (a multiple of 16) on the narrow sweep, and 256 < C <= 768 (a
// multiple of 64) on the wide one.
bool shape_ok(int k, int batch, int p_loc, int c, int p, int wd) {
  return k >= 1 && c % 16 == 0 && c >= 16 && (c <= kNarrowMaxC || (c % KB == 0 && c <= kWideMaxC)) && p >= 1 &&
         wd >= 1 && batch >= 1 && p_loc >= 1;
}

}  // namespace

// How the sweep is cut: `splits` blocks per target tile, each over
// `iters_per_split` (slot, bank tile) iterations, by the wave model of
// bank_split.cuh on this device's SMs at the occupancy of the sweep this
// width runs, over its target tiles (192 rows, or 128 on the wide sweep).
// Returns a cudaError_t.
extern "C" int affinity_bank_plan(int k, int batch, int p_loc, int c, int p, int wd, int* splits,
                                  int* iters_per_split) {
  if (!shape_ok(k, batch, p_loc, c, p, wd)) return int(cudaErrorInvalidValue);
  const bool wide = c > kNarrowMaxC;
  int fx_table = 0;
  const int stages = wide ? ring_stages_wide(c, wd, kWideMaxDw, &fx_table) : ring_stages(c, wd, 8 * kMaxND, &fx_table);
  if (stages == 0) return int(cudaErrorInvalidValue);
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (wide) {  // the wide sweep's own blocks: its shared memory, 384 threads, 128 target rows
    const size_t smem = smem_layout_wide(c, wd, kWideMaxDw, stages, fx_table).total;
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(affinity_bank_kernel<Wide, kWideNT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 int(smem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, affinity_bank_kernel<Wide, kWideNT>, kWideThreads,
                                                          smem);
  } else {
    const size_t smem = smem_layout(c, wd, 8 * kMaxND, stages, fx_table).total;
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(affinity_bank_kernel<true, kMaxND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 int(smem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, affinity_bank_kernel<true, kMaxND>, kThreads, smem);
  }
  if (err != cudaSuccess) return int(err);
  if (occ < 1) return int(cudaErrorInvalidConfiguration);
  const long long n_iter = (long long)k * ((p_loc + TM - 1) / TM);
  const long long tiles = (long long)((p + (wide ? TQW : TQ) - 1) / (wide ? TQW : TQ)) * batch;
  bank_split::choose(n_iter, tiles, (long long)sms * occ, kMaxSplits, splits, iters_per_split);
  return 0;
}

// Launches the sweep on `stream` for label columns [d_off, d_off + dw) of
// d_pad (dw a multiple of 8, at most 64; at most 24 on the wide sweep, C
// above 256), writing the partials; returns a
// cudaError_t (0 on success). `table` is a device array of 4 k int32: the
// k slots, the bits of the k inv_sigma2 and of the k slot biases, and each
// slot's column table (0 or 1: the slots share at most two nonzero
// inv_sigma2, one table each).
extern "C" int affinity_bank_launch(const void* bank_feats, const void* bank_labels, const void* target,
                                    void* pm, void* pl, void* pacc, const void* table, int k, int cap,
                                    int batch, int p_loc, int c, int d_pad, int d_off, int dw, int p, int wd,
                                    int row_base, int splits, int iters_per_split, void* stream) {
  if (!shape_ok(k, batch, p_loc, c, p, wd) || cap < 1 || d_pad % 8 != 0 || dw % 8 != 0 || dw < 8 ||
      dw > 8 * kMaxND || d_off % 8 != 0 || d_off + dw > d_pad || splits < 1 || splits > kMaxSplits ||
      iters_per_split < 1)
    return int(cudaErrorInvalidValue);
  const bool wide = c > kNarrowMaxC;
  if (wide && dw > kWideMaxDw) return int(cudaErrorInvalidValue);
  const long long rows = (long long)cap * batch * p_loc;
  if (rows > 0x7fffffffll) return int(cudaErrorInvalidValue);  // TMA coordinates are int32
  int fx_table = 0;
  const int stages = wide ? ring_stages_wide(c, wd, dw, &fx_table) : ring_stages(c, wd, dw, &fx_table);
  if (stages == 0) return int(cudaErrorInvalidValue);
  CUtensorMap maps[3];  // features, labels, target
  cudaError_t err = make_maps(bank_feats, bank_labels, target, rows, c, d_pad, dw, p, batch, maps, maps + 1, maps + 2);
  if (err != cudaSuccess) return int(err);
  Params prm;
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
  prm.stages = stages;
  prm.fx_table = fx_table;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    const size_t smem = smem_layout_wide(c, wd, dw, stages, fx_table).total;
    return int(launch_sweep_wide(dim3((p + TQW - 1) / TQW, splits, batch), smem, s, maps, prm));
  }
  const size_t smem = smem_layout(c, wd, dw, stages, fx_table).total;
  const dim3 grid((p + TQ - 1) / TQ, splits, batch);
  if (c == 256)
    err = dw <= 24 ? launch_sweep<true, 3>(grid, smem, s, maps, prm) : launch_sweep<true, kMaxND>(grid, smem, s, maps, prm);
  else
    err = dw <= 24 ? launch_sweep<false, 3>(grid, smem, s, maps, prm)
                   : launch_sweep<false, kMaxND>(grid, smem, s, maps, prm);
  return int(err);
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
