// Fused BN-folded ResNet bottleneck block for Hopper (sm_90a), NHWC float32.
//
// Replaces the TPU kernel semi_supervised_vos_tpu/ops/bottleneck_pallas.py
// (bottleneck_block, body _block_kernel) when the activations are float32
// (SVOS_INFER_DTYPE=float32): there the weights are cast to x's dtype and
// the accumulator is x's dtype (bottleneck_pallas.py:157,178-186), which
// the bf16 kernel of csrc/bottleneck.cu cannot compute:
//
//   y1  = relu(x . W1 + b1)                 1x1, C -> C4
//   y2  = relu(conv3x3(y1) + b2)            3x3, C4 -> C4, zero padding
//   out = relu(y2 . W3 + b3 + x)            1x1, C4 -> C, residual
//
// in float32, y1 and y2 kept on chip. Every product is 3xTF32 on wgmma
// (hopper_mma.cuh): each operand a = big + small, both rounded to tf32, and
// a . b ~ small . big' + big . small' + big . big', float32 accuracy
// (~2^-22 relative per term) from the tf32 tensor cores; one tf32 product
// would miss the float32 gate of 1e-4 of the largest output three- to
// fourfold (tests/test_torch_tf32x3.py).
//
// What bounds it on the H100: the three products are 2 N H W (C C4 + 9 C4^2
// + C4 C) flops (114 GFLOP for an 8-frame 480p block at C 1024), three
// times over at the dense tf32 rate (495 TFLOP/s): 0.69 ms a block, 6.05 ms
// for the 11 blocks of an 8-frame resnet50 encode (FFMA at 67 TFLOP/s
// would take 14.9). x and out are ~420 MB a call (0.13 ms at HBM rate). The
// weights are not: every 8 x 8 tile streams both planes of all three
// (8.9 MB at C 1024) from L2, ~8 GB a block, so L2's rate may set the pace
// before the tensor cores do.
//
// Design:
// - A persistent grid (one block of two warpgroups per SM) walks output
//   tiles of 8 x 8 pixels (N 8, 60 x 107: 896 tiles). y1 over the 10 x 10
//   halo (100 pixels, rows of C4 + 4 floats: ldmatrix without bank
//   conflicts) stays in shared memory; y2 (64 pixels) takes its place after
//   the barrier that follows the 3x3's last read of y1.
// - The weights come pre-split (tf32_split_weights in ops/bottleneck.py,
//   done once per folded table): K-major, since tf32 wgmma has no
//   transpose, big plane then small plane, w1 (2, C4, C), w2 (2, 9, C4,
//   C4) as (plane, tap, out, in), w3 (2, C, C4).
// - Every operand streams by TMA through one ring in shared memory in
//   K-chunks of 16 channels, used by both warpgroups; thread 0 issues, an
//   mbarrier per stage counts the bytes. x chunks come through a 4-D (C, W,
//   H, N) tensor map whose 10 x 10 box zero-fills the out-of-image halo,
//   64-byte swizzled against ldmatrix bank conflicts; each weight plane
//   through a 2-D (K, rows) map whose box of 64-byte rows, 64-byte
//   swizzled, is wgmma's K-major SW64 layout (a first design's boxes of
//   16-byte rows, the unswizzled core-matrix layout, fetched a 32-byte
//   sector for every 16 bytes). The ring runs on across phases and tiles.
// - A (pixels) comes from registers: ldmatrix of a 16 x 8 float32 block
//   is exactly the tf32 A fragment (row g / g + 8, k t / t + 4), split into
//   big and small there; B (both weight planes) from shared memory by
//   descriptor. The first 1x1 gives each warpgroup 64 halo rows (the halo
//   padded to 128) x 128 channels a pass; the 3x3 and the last 1x1 give
//   each warpgroup half the output channels of the tile's 64 pixels (n 128,
//   or n 64 for the 3x3 at C4 128). Accumulators stay at n <= 128 per
//   warpgroup (64 registers a thread).
// - Epilogues apply bias, relu (and for the last product the residual x)
//   straight from the accumulators into y1 / y2 or `out`. y1 = 0 outside
//   the image is the 3x3's zero padding.
// Shared memory at C4 256: ring 3 x 32,768 B (an x chunk of 128 x 16
// floats and a 2 x 16 x 128 W1 chunk, or a 2 x 16 x 256 W2 / W3 chunk) +
// y 100 x 260 x 4 = 104,000 B + the barriers: 202,392 B of the 232,448 a
// block may use; at C4 128 five stages and 52,800 B of y.
// What still holds it back: the weights' traffic from L2 (weight bytes per
// pixel are 4x the bf16 kernel's: two float32 planes over a tile of half
// the pixels; a split in shared memory of one raw plane would halve it; TMA
// multicast of each weight chunk to a cluster of two blocks halves it too,
// but a trial of it ran slower: the pair waits on each other's stages);
// and a barrier and a wgmma wait per 16-channel chunk keep the two
// warpgroups in step, so the A splits, the loads and the products overlap
// only across the ring, three stages deep at C4 256.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

using namespace hopper;

constexpr int TH = 8, TW = 8;            // output tile
constexpr int HW = TW + 2;               // halo columns
constexpr int M1 = (TH + 2) * HW;        // halo pixels (100)
constexpr int KC = 16;                   // channels per ring chunk (64-byte rows)
constexpr int N1 = 128;                  // first 1x1: output channels per pass
constexpr int N3 = 256;                  // last 1x1: output channels per pass (128 a warpgroup)
constexpr int kThreads = 256;

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }
__host__ __device__ constexpr size_t align1024(size_t x) { return (x + 1023) & ~size_t(1023); }
__host__ __device__ constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

// A ring stage holds an x chunk (the 10 x 10 halo pixels x 16 channels,
// 64 B a pixel, swizzled, room for 128 rows) and both planes of a W1
// chunk, or both planes of a W2 / W3 chunk; then come y1 / y2 and one
// mbarrier per stage.
template <int C4>
struct Layout {
  static constexpr int LDY = C4 + 4;  // y1 / y2 row stride (floats)
  static constexpr size_t x_bytes = size_t(128) * KC * 4;
  static constexpr size_t stage = align1024(cmax(x_bytes + 2 * size_t(KC) * N1 * 4, 2 * size_t(KC) * cmax(C4, N3) * 4));
  static constexpr int kStages = C4 == 256 ? 3 : 5;
  static constexpr size_t y = kStages * stage;
  static constexpr size_t bars = y + align128(size_t(M1) * LDY * 4);
  static constexpr size_t total = bars + kStages * 8;
};

// Float offset of halo pixel `px`'s 16-byte channel chunk `cc` in an x
// chunk: TMA's 64-byte swizzle XORs byte-offset bits 4-5 with bits 7-8.
__device__ __forceinline__ int x_offset(int px, int cc) { return px * KC + ((cc ^ ((px >> 1) & 3)) << 2); }

struct Maps {
  CUtensorMap x, w1, w2, w3;
};

struct Args {
  const float* x;
  const float* b1;
  const float* b2;
  const float* b3;
  float* out;
  int n, h, w, c, tiles_h, tiles_w, n_tiles;
};

template <int NT>
__device__ __forceinline__ void zero(float (&d)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[n][e] = 0.f;
}

// B descriptor of k-step ks, columns n0.. of a weight plane chunk (row n's
// 16 channels at n x 64 bytes, 64-byte swizzled as TMA wrote them).
__device__ __forceinline__ uint64_t weight_desc(const unsigned char* plane, int ks, int n0) {
  return smem_desc_swizzled(plane + n0 * KC * 4 + ks * 32, 8 * KC * 4, 2);
}

template <int NT>
__device__ __forceinline__ void mma_tf32(float (&d)[NT][4], const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (NT == 16)
    wgmma_m64n128k8_tf32(d, a, desc_b, true);
  else
    wgmma_m64n64k8_tf32(d, a, desc_b, true);
}

// d += A . W over one 16-channel chunk, 3xTF32: A's two k-steps from the
// raw float32 fragments `ar`, W's planes at `big` / `big + plane_bytes`.
template <int NT>
__device__ __forceinline__ void chunk_products(float (&d)[NT][4], const uint32_t (&ar)[KC / 8][4],
                                               const unsigned char* big, int plane_bytes, int n0) {
  uint32_t ab[KC / 8][4], as[KC / 8][4];
#pragma unroll
  for (int ks = 0; ks < KC / 8; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) tf32_split(__uint_as_float(ar[ks][e]), ab[ks][e], as[ks][e]);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KC / 8; ++ks) {
    const uint64_t wb = weight_desc(big, ks, n0), ws = weight_desc(big + plane_bytes, ks, n0);
    mma_tf32(d, as[ks], wb);  // the two small terms first
    mma_tf32(d, ab[ks], ws);
    mma_tf32(d, ab[ks], wb);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(d);
}

template <int C4>
__global__ void __launch_bounds__(kThreads, 1) bottleneck_f32_kernel(const __grid_constant__ Maps maps, Args a) {
  using L = Layout<C4>;
  constexpr int S = L::kStages;
  constexpr int NT2 = C4 / 2 / 8;  // 3x3: n-tiles per warpgroup (half of C4)
  extern __shared__ __align__(1024) unsigned char smem[];
  float* ys = reinterpret_cast<float*>(smem + L::y);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wi = warp & 3;  // warpgroup, warp within it
  const int C = a.c, H = a.h, W = a.w;
  const int k1 = C / KC, k2 = C4 / KC;  // chunks per K sweep
  const int n3 = (C + N3 - 1) / N3;     // last 1x1 passes
  const int n1 = (C4 / N1) * k1, n2 = 9 * k2;
  const int per_tile = n1 + n2 + n3 * k2;

  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);  // one per stage
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(full + s, 1);
    fence_mbar_init();
  }
  __syncthreads();

  // ---- producer (thread 0): chunk `gc` of this block's stream by TMA ------
  auto load = [&](int gc) {
    const int ti = gc / per_tile, j = gc - ti * per_tile;
    const int tile = blockIdx.x + ti * gridDim.x;
    if (tile >= a.n_tiles) return;
    unsigned char* st = smem + size_t(gc % S) * L::stage;
    uint64_t* bar = full + gc % S;
    if (j < n1) {
      const int pass = j / k1, k0 = (j - pass * k1) * KC;
      const int img = tile / (a.tiles_h * a.tiles_w), rem = tile - img * a.tiles_h * a.tiles_w;
      const int h0 = (rem / a.tiles_w) * TH, w0 = (rem % a.tiles_w) * TW;
      mbar_expect_tx(bar, (M1 + 2 * N1) * KC * 4);
      tma_load_4d(st, &maps.x, bar, k0, w0 - 1, h0 - 1, img);
      tma_load_2d(st + L::x_bytes, &maps.w1, bar, k0, pass * N1);
      tma_load_2d(st + L::x_bytes + N1 * KC * 4, &maps.w1, bar, k0, C4 + pass * N1);
    } else if (j < n1 + n2) {
      const int jj = j - n1, tap = jj / k2, k0 = (jj - tap * k2) * KC;
      mbar_expect_tx(bar, 2 * C4 * KC * 4);
      tma_load_2d(st, &maps.w2, bar, k0, tap * C4);
      tma_load_2d(st + C4 * KC * 4, &maps.w2, bar, k0, (9 + tap) * C4);
    } else {
      const int jj = j - n1 - n2, nc = jj / k2, k0 = (jj - nc * k2) * KC;
      mbar_expect_tx(bar, 2 * N3 * KC * 4);  // rows past the plane's end arrive as zeros or are not used
      tma_load_2d(st, &maps.w3, bar, k0, nc * N3);
      tma_load_2d(st + N3 * KC * 4, &maps.w3, bar, k0, C + nc * N3);
    }
  };

  int gc = 0;  // chunks consumed
  if (tid == 0)
    for (int s = 0; s < S - 1; ++s) load(s);
  // ---- consumer: the next chunk's stage, once it has landed ---------------
  auto next = [&]() {
    __syncthreads();  // every thread is done with chunk gc - 1: its stage is free
    if (tid == 0) load(gc + S - 1);
    mbar_wait(full + gc % S, (gc / S) & 1);
    const unsigned char* st = smem + size_t(gc % S) * L::stage;
    ++gc;
    return st;
  };

  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int img = tile / (a.tiles_h * a.tiles_w), rem = tile - img * a.tiles_h * a.tiles_w;
    const int h0 = (rem / a.tiles_w) * TH, w0 = (rem % a.tiles_w) * TW;

    // ---- 1x1 reduce over the halo: y1 = relu(x W1 + b1) ------------------
    // warpgroup wg: halo rows 64 wg.. (padded to 128) x the 128 columns of
    // this pass; warp wi gives rows 16 wi.. of them
    for (int pass = 0; pass < C4 / N1; ++pass) {
      float acc[16][4];
      zero(acc);
      const int hrow = 64 * wg + 16 * wi + (lane & 15);
      for (int kc = 0; kc < k1; ++kc) {
        const unsigned char* st = next();
        const float* xs = reinterpret_cast<const float*>(st);
        uint32_t ar[KC / 8][4];
#pragma unroll
        for (int ks = 0; ks < KC / 8; ++ks) ldmatrix_x4(ar[ks], xs + x_offset(hrow, 2 * ks + (lane >> 4)));
        chunk_products(acc, ar, st + L::x_bytes, N1 * KC * 4, 0);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int px = 64 * wg + 16 * wi + g + 8 * hf;
        if (px >= M1) continue;
        const int hh = h0 - 1 + px / HW, ww = w0 - 1 + px % HW;
        const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W;  // else the 3x3's zero padding
#pragma unroll
        for (int ni = 0; ni < 16; ++ni) {
          const int ch = pass * N1 + 8 * ni + 2 * t;
          const float2 bias = __ldg(reinterpret_cast<const float2*>(a.b1 + ch));
          float2 v;
          v.x = in ? fmaxf(acc[ni][2 * hf] + bias.x, 0.f) : 0.f;
          v.y = in ? fmaxf(acc[ni][2 * hf + 1] + bias.y, 0.f) : 0.f;
          *reinterpret_cast<float2*>(ys + px * L::LDY + ch) = v;
        }
      }
    }

    // ---- 3x3 as nine shifted products: y2 = relu(conv3x3(y1) + b2) -------
    // both warpgroups: the 64 tile pixels (warp wi: pixels 16 wi..) x the
    // C4 / 2 columns C4 / 2 wg..
    const int p = 16 * wi + (lane & 15);  // this lane's A row (tile pixel)
    {
      float acc[NT2][4];
      zero(acc);
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap - 3 * (tap / 3);
        const float* arow = ys + ((p / TW + dy) * HW + p % TW + dx) * L::LDY + (lane >> 4) * 4;
        for (int kc = 0; kc < k2; ++kc) {
          const unsigned char* st = next();
          uint32_t ar[KC / 8][4];
#pragma unroll
          for (int ks = 0; ks < KC / 8; ++ks) ldmatrix_x4(ar[ks], arow + kc * KC + ks * 8);
          chunk_products(acc, ar, st, C4 * KC * 4, wg * (C4 / 2));
        }
      }
      __syncthreads();  // every warp is done reading y1: y2 takes its place
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int px = 16 * wi + g + 8 * hf;
#pragma unroll
        for (int ni = 0; ni < NT2; ++ni) {
          const int ch = wg * (C4 / 2) + 8 * ni + 2 * t;
          const float2 bias = __ldg(reinterpret_cast<const float2*>(a.b2 + ch));
          float2 v;
          v.x = fmaxf(acc[ni][2 * hf] + bias.x, 0.f);
          v.y = fmaxf(acc[ni][2 * hf + 1] + bias.y, 0.f);
          *reinterpret_cast<float2*>(ys + px * L::LDY + ch) = v;
        }
      }
    }

    // ---- 1x1 expand + residual: out = relu(y2 W3 + b3 + x) ---------------
    // both warpgroups: the 64 tile pixels x 128 columns of each 256-column
    // pass (warpgroup wg: columns 128 wg.. of it)
    {
      const float* arow = ys + p * L::LDY + (lane >> 4) * 4;
      for (int nc = 0; nc < n3; ++nc) {
        float acc[16][4];
        zero(acc);
        for (int kc = 0; kc < k2; ++kc) {
          const unsigned char* st = next();
          uint32_t ar[KC / 8][4];
#pragma unroll
          for (int ks = 0; ks < KC / 8; ++ks) ldmatrix_x4(ar[ks], arow + kc * KC + ks * 8);
          chunk_products(acc, ar, st, N3 * KC * 4, 128 * wg);
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int px = 16 * wi + g + 8 * hf;
          const int hh = h0 + px / TW, ww = w0 + px % TW;
          if (hh >= H || ww >= W) continue;
          const size_t pix = (size_t(img) * H + hh) * W + ww;
#pragma unroll
          for (int ni = 0; ni < 16; ++ni) {
            const int ch = nc * N3 + 128 * wg + 8 * ni + 2 * t;
            if (ch >= C) continue;
            const float2 bias = __ldg(reinterpret_cast<const float2*>(a.b3 + ch));
            const float2 res = __ldg(reinterpret_cast<const float2*>(a.x + pix * C + ch));
            float2 v;
            v.x = fmaxf(acc[ni][2 * hf] + bias.x + res.x, 0.f);
            v.y = fmaxf(acc[ni][2 * hf + 1] + bias.y + res.y, 0.f);
            *reinterpret_cast<float2*>(a.out + pix * C + ch) = v;
          }
        }
      }
    }
  }
}

// A K-major (2 x rows, k) float32 weight tensor (both planes) as a 2-D
// (k, 2 rows) map with a (KC, box_rows) box of 64-byte rows, 64-byte
// swizzled: wgmma's K-major SW64 layout.
bool weight_map(CUtensorMap* map, const void* w, int rows, int k, int box_rows) {
  const cuuint64_t dim[2] = {cuuint64_t(k), cuuint64_t(2) * rows};
  const cuuint64_t stride[1] = {cuuint64_t(k) * 4};
  const cuuint32_t box[2] = {KC, cuuint32_t(box_rows)};
  const cuuint32_t ones[2] = {1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(w), dim, stride, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int C4>
int launch(const Args& a, const void* w1, const void* w2, const void* w3, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return int(cudaErrorNotSupported);
  Maps maps;
  const cuuint64_t xdim[4] = {cuuint64_t(a.c), cuuint64_t(a.w), cuuint64_t(a.h), cuuint64_t(a.n)};
  const cuuint64_t xstride[3] = {cuuint64_t(a.c) * 4, cuuint64_t(a.w) * a.c * 4, cuuint64_t(a.h) * a.w * a.c * 4};
  const cuuint32_t xbox[4] = {KC, HW, TH + 2, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  if (encode_tiled()(&maps.x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(a.x), xdim, xstride, xbox, ones,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      !weight_map(&maps.w1, w1, C4, a.c, N1) || !weight_map(&maps.w2, w2, 9 * C4, C4, C4) ||
      !weight_map(&maps.w3, w3, a.c, C4, N3))
    return int(cudaErrorInvalidValue);
  const size_t smem = Layout<C4>::total;
  cudaError_t err =
      cudaFuncSetAttribute(bottleneck_f32_kernel<C4>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  int dev = 0, sms = 0, occ = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, bottleneck_f32_kernel<C4>, kThreads, smem);
  if (err != cudaSuccess) return int(err);
  if (occ < 1) return int(cudaErrorInvalidConfiguration);
  const int grid = a.n_tiles < sms * occ ? a.n_tiles : sms * occ;
  bottleneck_f32_kernel<C4><<<grid, kThreads, smem, stream>>>(maps, a);
  return int(cudaGetLastError());
}

}  // namespace

// Launches the block on `stream`: x and out (N, H, W, C) float32; w1, w2,
// w3 the pre-split K-major weight planes (2, C4, C), (2, 9, C4, C4) and
// (2, C, C4) of tf32_split_weights (ops/bottleneck.py); float32 biases; all
// 16-byte aligned. C4 128 or 256, C a multiple of 128. Returns a
// cudaError_t (0 on success).
extern "C" int bottleneck_f32_launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                                     const void* w3, const void* b3, void* out, int n, int h, int w, int c, int c4,
                                     void* stream) {
  if (n < 1 || h < 1 || w < 1 || (c4 != 128 && c4 != 256) || c < 128 || c % 128 != 0)
    return int(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const float*>(x);
  a.b1 = static_cast<const float*>(b1);
  a.b2 = static_cast<const float*>(b2);
  a.b3 = static_cast<const float*>(b3);
  a.out = static_cast<float*>(out);
  a.n = n;
  a.h = h;
  a.w = w;
  a.c = c;
  a.tiles_h = (h + TH - 1) / TH;
  a.tiles_w = (w + TW - 1) / TW;
  const long long tiles = (long long)n * a.tiles_h * a.tiles_w;
  if (tiles > 0x7fffffffll) return int(cudaErrorInvalidValue);
  a.n_tiles = int(tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c4 == 128) return launch<128>(a, w1, w2, w3, s);
  return launch<256>(a, w1, w2, w3, s);
}
