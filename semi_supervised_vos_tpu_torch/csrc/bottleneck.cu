// Fused BN-folded ResNet bottleneck block for Hopper (sm_90a), NHWC bf16.
//
// Replaces the TPU kernel semi_supervised_vos_tpu/ops/bottleneck_pallas.py
// (bottleneck_block, body _block_kernel):
//
//   y1  = bf16(relu(x . W1 + b1))                 1x1, C -> C4
//   y2  = bf16(relu(conv3x3(y1) + b2))             3x3, C4 -> C4, zero padding
//   out = bf16(relu(y2 . W3 + b3 + x))             1x1, C4 -> C, residual
//
// with f32 accumulation and the JAX kernel's rounding points (y1 and y2 are
// rounded to bf16).
//
// What bounds it on the H100: at the 480p shapes (60 x 107 pixels, C/C4 =
// 1024/256 or 512/128, N = 8) the three products are 2 N H W (C C4 + 9 C4^2
// + C4 C) flops, ~114 GFLOP for a C = 1024 block, against ~212 MB of x, out
// and weights: operations bound it. The first port lost to the traffic
// around the products instead: every block of 4 x 16 pixels read all the
// weights (2.2 MB at C 1024) through L2 by fragment loads, 840 blocks a
// launch, and staged every accumulator through shared memory.
//
// Design:
// - Output tiles of TH x TW = 8 x 16 pixels: the first 1x1 runs over the
//   10 x 18 halo, 1.41x the tile (4 x 16 had 1.69x), and each weight byte
//   serves twice the pixels. A persistent grid (one block per SM) walks the
//   tiles (N 8, 60 x 107: 448 tiles).
// - Every operand streams by TMA through one 4-stage ring in shared memory
//   in K-chunks of 32 channels, used by both warpgroups; one thread issues,
//   an mbarrier per stage counts the bytes. x chunks come through a 4-D
//   (C, W, H, N) tensor map whose 10 x 18 box fills the out-of-image halo
//   with zeros, 64-byte swizzled against ldmatrix bank conflicts; W1 (in
//   passes of 128 output channels), the nine taps of W2 and W3 (in passes
//   of 256 output channels) through 3-D maps whose boxes land in wgmma's
//   MN-major core-matrix layout. The ring runs on across phases and tiles,
//   so the next tile's first chunks load under this tile's last products.
// - Shared memory at C4 256: ring 4 x 20,480 B (a 192 x 32 x chunk and a
//   32 x 128 W1 chunk, or a 32 x 256 W2 / W3 chunk) + y 192 x 264 x 2 =
//   101,376 B + the barriers: 183,328 B of the 232,448 a block may use. y1
//   (halo) and y2 (tile) share the one buffer: y2 is written after a
//   barrier that follows the last read of y1.
// - Products on wgmma m64n64k16 (bf16 in, f32 accumulators in registers):
//   A (pixels) from registers by ldmatrix, which takes the 3x3's tap-shifted
//   halo rows (stride 18 pixels) directly; B (weights) from shared memory by
//   descriptor. Each epilogue applies bias, relu and the bf16 rounding (and
//   for the third product the residual) straight from the accumulator
//   registers into y1 / y2 in shared memory or into `out`; nothing is
//   staged. The 3x3's zero padding is y1 = 0 outside the image.
// What still holds it back: a barrier and a wgmma wait per 32-channel
// chunk keep the two warpgroups in step, so loads, products and epilogues
// overlap only across the ring.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int TH = 8;                  // output rows per tile
constexpr int TW = 16;                 // output columns per tile (one m16 tile)
constexpr int HC = TW + 2;             // halo columns
constexpr int M1 = (TH + 2) * HC;      // halo pixels (180)
constexpr int M1P = 192;               // padded: 4 warps x 3 m16 tiles
constexpr int KC = 32;                 // channels per ring chunk
constexpr int N1 = 128;                // first 1x1: output channels per pass
constexpr int N3 = 256;                // third 1x1: output channels per pass
constexpr int kThreads = 256;
constexpr int kStages = 4;

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }
__host__ __device__ constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

__host__ __device__ constexpr size_t align1024(size_t x) { return (x + 1023) & ~size_t(1023); }

// A ring stage holds an x chunk (the 10 x 18 halo pixels x 32 channels, 64 B
// a pixel, 64-byte swizzled, padded to 192 rows) and a W1 chunk, or a W2 /
// W3 chunk; then come y1 / y2 and one mbarrier per stage.
template <int C4>
struct Layout {
  static constexpr int LDY = C4 + 8;   // y1 / y2 row stride
  static constexpr size_t x_bytes = align1024(size_t(M1P) * KC * 2);
  static constexpr size_t stage = align1024(cmax(x_bytes + size_t(KC) * N1 * 2, size_t(KC) * cmax(C4, N3) * 2));
  static constexpr size_t y = kStages * stage;
  static constexpr size_t bars = y + align128(size_t(M1P) * LDY * 2);
  static constexpr size_t total = bars + kStages * 8;
};

// The halo pixel `px`'s 16-byte channel chunk `cc` in an x chunk: TMA's
// 64-byte swizzle XORs byte-offset bits 4-5 with bits 7-8.
__device__ __forceinline__ int x_offset(int px, int cc) { return px * KC + ((cc ^ ((px >> 1) & 3)) << 3); }

// Tensor maps of one launch: x as (C, W, H, N) with a (32, 18, 10, 1) box
// (out-of-image halo pixels fill with zeros), and each weight matrix as
// (8 columns, rows, column chunks) with an (8, 32, n / 8) box, which lands
// in the MN-major core-matrix layout of load order chunk, row, column.
struct Maps {
  CUtensorMap x, w1, w2, w3;
};

struct Args {
  const bf16* x;
  const bf16* w1;
  const float* b1;
  const bf16* w2;
  const float* b2;
  const bf16* w3;
  const float* b3;
  bf16* out;
  int n, h, w, c, tiles_h, tiles_w, n_tiles;
};

__device__ __forceinline__ void zero(float (&d)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[n][e] = 0.f;
}

// B descriptor of the 16 x 64 slice (k-step ks, columns 64 nb..) of a
// weight chunk (the 16 B of columns 8 j.. of row k at j x KC x 16 + k x 16
// bytes): core matrices 128 B apart along K, KC x 16 B apart along N.
__device__ __forceinline__ uint64_t weight_desc(const bf16* chunk, int ks, int nb) {
  return smem_desc(chunk + (nb * 8 * KC + ks * 16) * 8, 128, KC * 16);
}

template <int C4>
__global__ void __launch_bounds__(kThreads, 1) bottleneck_kernel(const __grid_constant__ Maps maps, Args a) {
  using L = Layout<C4>;
  constexpr int NB2 = C4 / 64;  // 3x3: 64-column blocks per warpgroup
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* ys = reinterpret_cast<bf16*>(smem + L::y);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wi = warp & 3;  // warpgroup, warp within it
  const int C = a.c, H = a.h, W = a.w;
  const int k1 = C / KC, k2 = C4 / KC;          // chunks per K sweep
  const int n3 = (C + N3 - 1) / N3;             // third 1x1 passes
  const int n1 = (C4 / N1) * k1, n2 = 9 * k2;
  const int per_tile = n1 + n2 + n3 * k2;

  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);  // one per stage
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + s, 1);
    fence_mbar_init();
  }
  __syncthreads();

  // ---- producer (thread 0): chunk `gc` of this block's stream by TMA ------
  auto load = [&](int gc) {
    const int ti = gc / per_tile, j = gc - ti * per_tile;
    const int tile = blockIdx.x + ti * gridDim.x;
    if (tile >= a.n_tiles) return;
    unsigned char* st = smem + size_t(gc % kStages) * L::stage;
    uint64_t* bar = full + gc % kStages;
    if (j < n1) {
      const int pass = j / k1, k0 = (j - pass * k1) * KC;
      const int img = tile / (a.tiles_h * a.tiles_w), rem = tile - img * a.tiles_h * a.tiles_w;
      const int h0 = (rem / a.tiles_w) * TH, w0 = (rem % a.tiles_w) * TW;
      mbar_expect_tx(bar, (M1 + N1) * KC * 2);
      tma_load_4d(st, &maps.x, bar, k0, w0 - 1, h0 - 1, img);
      tma_load_3d(st + L::x_bytes, &maps.w1, bar, 0, k0, pass * (N1 / 8));
    } else if (j < n1 + n2) {
      const int jj = j - n1, tap = jj / k2, k0 = (jj - tap * k2) * KC;
      mbar_expect_tx(bar, KC * C4 * 2);
      tma_load_3d(st, &maps.w2, bar, 0, tap * C4 + k0, 0);
    } else {
      const int jj = j - n1 - n2, nc = jj / k2, k0 = (jj - nc * k2) * KC;
      mbar_expect_tx(bar, KC * N3 * 2);  // columns past C arrive as zeros
      tma_load_3d(st, &maps.w3, bar, 0, k0, nc * (N3 / 8));
    }
  };

  int gc = 0;  // chunks consumed
  if (tid == 0)
    for (int s = 0; s < kStages - 1; ++s) load(s);
  // ---- consumer: the next chunk's stage, once it has landed ---------------
  auto next = [&]() {
    __syncthreads();  // every thread is done with chunk gc - 1: its stage is free
    if (tid == 0) load(gc + kStages - 1);
    mbar_wait(full + gc % kStages, (gc / kStages) & 1);
    const unsigned char* st = smem + size_t(gc % kStages) * L::stage;
    ++gc;
    return st;
  };

  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int img = tile / (a.tiles_h * a.tiles_w), rem = tile - img * a.tiles_h * a.tiles_w;
    const int h0 = (rem / a.tiles_w) * TH, w0 = (rem % a.tiles_w) * TW;

    // ---- 1x1 reduce over the halo: y1 = relu(x W1 + b1) ------------------
    // warpgroup wg: the 192 (padded) halo pixels as three m64 tiles x the 64
    // columns 64 wg.. of this pass; warp wi gives rows 16 wi.. of each tile
    for (int pass = 0; pass < C4 / N1; ++pass) {
      float acc[3][8][4];
#pragma unroll
      for (int mi = 0; mi < 3; ++mi) zero(acc[mi]);
      for (int kc = 0; kc < k1; ++kc) {
        const unsigned char* st = next();
        const bf16* xs = reinterpret_cast<const bf16*>(st);
        const bf16* ws = reinterpret_cast<const bf16*>(st + L::x_bytes);
        uint32_t af[KC / 16][3][4];
#pragma unroll
        for (int ks = 0; ks < KC / 16; ++ks)
#pragma unroll
          for (int mi = 0; mi < 3; ++mi)
            ldmatrix_x4(af[ks][mi], xs + x_offset(64 * mi + 16 * wi + (lane & 15), 2 * ks + (lane >> 4)));
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KC / 16; ++ks)
#pragma unroll
          for (int mi = 0; mi < 3; ++mi) wgmma_m64n64k16<1>(acc[mi], af[ks][mi], weight_desc(ws, ks, wg), true);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int mi = 0; mi < 3; ++mi) fence_operands(acc[mi]);
      }
#pragma unroll
      for (int mi = 0; mi < 3; ++mi)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int px = 64 * mi + 16 * wi + g + 8 * hf;
          if (px >= M1) continue;
          const int hh = h0 - 1 + px / HC, ww = w0 - 1 + px % HC;
          const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W;  // else the 3x3's zero padding
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) {
            const int ch = pass * N1 + 64 * wg + 8 * ni + 2 * t;
            const float v0 = in ? fmaxf(acc[mi][ni][2 * hf] + __ldg(a.b1 + ch), 0.f) : 0.f;
            const float v1 = in ? fmaxf(acc[mi][ni][2 * hf + 1] + __ldg(a.b1 + ch + 1), 0.f) : 0.f;
            *reinterpret_cast<uint32_t*>(ys + px * L::LDY + ch) = pack_bf16(v0, v1);
          }
        }
    }

    // ---- 3x3 as nine shifted products: y2 = relu(conv3x3(y1) + b2) -------
    // warpgroup wg: output rows 4 wg.. (64 pixels) x all C4 columns; warp wi
    // gives output row 4 wg + wi
    const int r = 4 * wg + wi;
    {
      float acc[NB2][8][4];
#pragma unroll
      for (int nb = 0; nb < NB2; ++nb) zero(acc[nb]);
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap - 3 * (tap / 3);
        const bf16* arow = ys + ((r + dy) * HC + (lane & 15) + dx) * L::LDY + (lane >> 4) * 8;
        for (int kc = 0; kc < k2; ++kc) {
          const bf16* ws = reinterpret_cast<const bf16*>(next());
          uint32_t af[KC / 16][4];
#pragma unroll
          for (int ks = 0; ks < KC / 16; ++ks) ldmatrix_x4(af[ks], arow + kc * KC + ks * 16);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < KC / 16; ++ks)
#pragma unroll
            for (int nb = 0; nb < NB2; ++nb) wgmma_m64n64k16<1>(acc[nb], af[ks], weight_desc(ws, ks, nb), true);
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int nb = 0; nb < NB2; ++nb) fence_operands(acc[nb]);
        }
      }
      __syncthreads();  // every warp is done reading y1: y2 takes its place
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int px = r * TW + g + 8 * hf;
#pragma unroll
        for (int nb = 0; nb < NB2; ++nb)
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) {
            const int ch = nb * 64 + 8 * ni + 2 * t;
            const float v0 = fmaxf(acc[nb][ni][2 * hf] + __ldg(a.b2 + ch), 0.f);
            const float v1 = fmaxf(acc[nb][ni][2 * hf + 1] + __ldg(a.b2 + ch + 1), 0.f);
            *reinterpret_cast<uint32_t*>(ys + px * L::LDY + ch) = pack_bf16(v0, v1);
          }
      }
    }

    // ---- 1x1 expand + residual: out = relu(y2 W3 + b3 + x) ---------------
    // warpgroup wg: output rows 4 wg.. x up to 256 columns per pass
    {
      const bf16* arow = ys + (r * TW + (lane & 15)) * L::LDY + (lane >> 4) * 8;
      for (int nc = 0; nc < n3; ++nc) {
        const int c0 = nc * N3, nbs = min(N3, C - c0) / 64;
        float acc[N3 / 64][8][4];
#pragma unroll
        for (int nb = 0; nb < N3 / 64; ++nb) zero(acc[nb]);
        for (int kc = 0; kc < k2; ++kc) {
          const bf16* ws = reinterpret_cast<const bf16*>(next());
          uint32_t af[KC / 16][4];
#pragma unroll
          for (int ks = 0; ks < KC / 16; ++ks) ldmatrix_x4(af[ks], arow + kc * KC + ks * 16);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < KC / 16; ++ks)
#pragma unroll
            for (int nb = 0; nb < N3 / 64; ++nb) wgmma_m64n64k16<1>(acc[nb], af[ks], weight_desc(ws, ks, nb), true);
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int nb = 0; nb < N3 / 64; ++nb) fence_operands(acc[nb]);
        }
        const int hh = h0 + r;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int ww = w0 + g + 8 * hf;
          if (hh >= H || ww >= W) continue;
          const size_t pix = (size_t(img) * H + hh) * W + ww;
#pragma unroll
          for (int nb = 0; nb < N3 / 64; ++nb) {
            if (nb >= nbs) continue;
#pragma unroll
            for (int ni = 0; ni < 8; ++ni) {
              const int ch = c0 + nb * 64 + 8 * ni + 2 * t;
              const uint32_t xr = __ldg(reinterpret_cast<const unsigned int*>(a.x + pix * C + ch));
              const float v0 = acc[nb][ni][2 * hf] + __ldg(a.b3 + ch) + bf16_lo(xr);
              const float v1 = acc[nb][ni][2 * hf + 1] + __ldg(a.b3 + ch + 1) + bf16_hi(xr);
              *reinterpret_cast<uint32_t*>(a.out + pix * C + ch) = pack_bf16(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
            }
          }
        }
      }
    }
  }
}

// A row-major (rows, cols) bf16 weight matrix as (8, rows, cols / 8) with an
// (8, KC, box_cols / 8) box: the MN-major core-matrix layout.
bool weight_map(CUtensorMap* map, const void* w, int rows, int cols, int box_cols) {
  const cuuint64_t dim[3] = {8, cuuint64_t(rows), cuuint64_t(cols / 8)};
  const cuuint64_t stride[2] = {cuuint64_t(cols) * 2, 16};
  const cuuint32_t box[3] = {8, KC, cuuint32_t(box_cols / 8)};
  const cuuint32_t ones[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dim, stride, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int C4>
int launch(const Args& a, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return int(cudaErrorNotSupported);
  Maps maps;
  const cuuint64_t xdim[4] = {cuuint64_t(a.c), cuuint64_t(a.w), cuuint64_t(a.h), cuuint64_t(a.n)};
  const cuuint64_t xstride[3] = {cuuint64_t(a.c) * 2, cuuint64_t(a.w) * a.c * 2, cuuint64_t(a.h) * a.w * a.c * 2};
  const cuuint32_t xbox[4] = {KC, HC, TH + 2, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  if (encode_tiled()(&maps.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(a.x), xdim, xstride, xbox, ones,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      !weight_map(&maps.w1, a.w1, a.c, C4, N1) || !weight_map(&maps.w2, a.w2, 9 * C4, C4, C4) ||
      !weight_map(&maps.w3, a.w3, C4, a.c, N3))
    return int(cudaErrorInvalidValue);
  const size_t smem = Layout<C4>::total;
  cudaError_t err = cudaFuncSetAttribute(bottleneck_kernel<C4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  int dev = 0, sms = 0, occ = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, bottleneck_kernel<C4>, kThreads, smem);
  if (err != cudaSuccess) return int(err);
  if (occ < 1) return int(cudaErrorInvalidConfiguration);
  const int grid = a.n_tiles < sms * occ ? a.n_tiles : sms * occ;
  bottleneck_kernel<C4><<<grid, kThreads, smem, stream>>>(maps, a);
  return int(cudaGetLastError());
}

}  // namespace

// Launches one fused block on `stream`; returns a cudaError_t (0 on
// success). Supports C4 in {128, 256} and C a multiple of 64.
extern "C" int bottleneck_launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                                 const void* w3, const void* b3, void* out, int n, int h, int w, int c, int c4,
                                 void* stream) {
  if (n < 1 || h < 1 || w < 1 || c % 64 != 0 || c < 64) return int(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.w1 = static_cast<const bf16*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const bf16*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.w3 = static_cast<const bf16*>(w3);
  a.b3 = static_cast<const float*>(b3);
  a.out = static_cast<bf16*>(out);
  a.n = n;
  a.h = h;
  a.w = w;
  a.c = c;
  a.tiles_h = (h + TH - 1) / TH;
  a.tiles_w = (w + TW - 1) / TW;
  const long long tiles = (long long)n * a.tiles_h * a.tiles_w;
  if (tiles > 0x7fffffff) return int(cudaErrorInvalidValue);
  a.n_tiles = int(tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c4 == 128) return launch<128>(a, s);
  if (c4 == 256) return launch<256>(a, s);
  return int(cudaErrorInvalidValue);
}
