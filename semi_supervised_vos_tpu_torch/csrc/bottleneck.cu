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
// and weights: operations bound it. Design: one block owns a TH x TW tile of
// output pixels. It computes y1 over the tile plus a one-pixel halo
// ((TH+2) x (TW+2) pixels, the 3x3's zero padding written as zeros) and
// keeps it in shared memory, runs the 3x3 as nine shifted tensor-core
// products straight out of that buffer, keeps y2 in shared memory, and
// finishes with the 1x1 expansion, bias, residual and relu in the epilogue.
// The C4-wide intermediates never reach device memory; x is read once for
// the tile (plus its halo) and out written once. All products are bf16 WMMA
// with f32 accumulators; weights are read through L2 by the fragment loads.
// The halo costs (TH+2)(TW+2) / (TH TW) = 1.7x on the first 1x1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TH = 4;                 // output rows per block
constexpr int TW = 16;                // output columns per block (one WMMA M-tile)
constexpr int HC = TW + 2;            // halo columns
constexpr int M1 = (TH + 2) * HC;     // halo pixels (108)
constexpr int M1P = (M1 + 15) / 16 * 16;  // padded to WMMA tiles (112)
constexpr int MT1 = M1P / 16;         // conv1 M-tiles (7)
constexpr int KC = 64;                // conv1 input-channel chunk
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

template <int C4>
struct Layout {
  static constexpr int LDX = KC + 16;   // bf16 row strides keep 32-byte alignment
  static constexpr int LDY = C4 + 16;
  static constexpr size_t xs = 0;
  static constexpr size_t y1 = align128(xs + size_t(M1P) * LDX * 2);
  static constexpr size_t y2 = align128(y1 + size_t(M1P) * LDY * 2);
  static constexpr size_t stage = align128(y2 + size_t(TH * TW) * LDY * 2);
  static constexpr size_t total = align128(stage + size_t(kWarps) * 256 * 4);
};

template <int C4>
__global__ void __launch_bounds__(kThreads)
bottleneck_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ w1, const float* __restrict__ b1,
                  const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
                  const __nv_bfloat16* __restrict__ w3, const float* __restrict__ b3,
                  __nv_bfloat16* __restrict__ out, int H, int W, int C) {
  using L = Layout<C4>;
  constexpr int NT = C4 / 16;      // C4 column tiles
  constexpr int NTW = NT / kWarps; // per warp
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + L::xs);
  __nv_bfloat16* y1s = reinterpret_cast<__nv_bfloat16*>(smem + L::y1);
  __nv_bfloat16* y2s = reinterpret_cast<__nv_bfloat16*>(smem + L::y2);
  float* stage = reinterpret_cast<float*>(smem + L::stage) + (threadIdx.x >> 5) * 256;

  const int n = blockIdx.z, h0 = blockIdx.y * TH, w0 = blockIdx.x * TW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t img = size_t(n) * H * W;

  // ---- 1x1 reduce over the halo tile: y1 = relu(x W1 + b1) -------------
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> a1[MT1][NTW];
#pragma unroll
  for (int mt = 0; mt < MT1; ++mt)
#pragma unroll
    for (int j = 0; j < NTW; ++j) wmma::fill_fragment(a1[mt][j], 0.f);

  for (int k0 = 0; k0 < C; k0 += KC) {
    for (int v = tid; v < M1P * (KC / 8); v += kThreads) {
      const int pix = v / (KC / 8), cv = v - pix * (KC / 8);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (pix < M1) {
        const int hh = h0 - 1 + pix / HC, ww = w0 - 1 + pix % HC;
        if (hh >= 0 && hh < H && ww >= 0 && ww < W)
          val = *reinterpret_cast<const uint4*>(x + (img + size_t(hh) * W + ww) * C + k0 + cv * 8);
      }
      *reinterpret_cast<uint4*>(xs + pix * L::LDX + cv * 8) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[NTW];
#pragma unroll
      for (int j = 0; j < NTW; ++j)
        wmma::load_matrix_sync(bf[j], w1 + size_t(k0 + kk) * C4 + (warp + j * kWarps) * 16, C4);
#pragma unroll
      for (int mt = 0; mt < MT1; ++mt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::load_matrix_sync(af, xs + mt * 16 * L::LDX + kk, L::LDX);
#pragma unroll
        for (int j = 0; j < NTW; ++j) wmma::mma_sync(a1[mt][j], af, bf[j], a1[mt][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < MT1; ++mt) {
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      wmma::store_matrix_sync(stage, a1[mt][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int ch0 = (warp + j * kWarps) * 16;
      for (int e = lane; e < 256; e += 32) {
        const int pix = mt * 16 + (e >> 4), ch = ch0 + (e & 15);
        float v = 0.f;  // the 3x3's zero padding outside the image
        if (pix < M1) {
          const int hh = h0 - 1 + pix / HC, ww = w0 - 1 + pix % HC;
          if (hh >= 0 && hh < H && ww >= 0 && ww < W) v = fmaxf(stage[e] + b1[ch], 0.f);
        }
        y1s[pix * L::LDY + ch] = __float2bfloat16(v);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- 3x3 as nine shifted products: y2 = relu(conv3x3(y1) + b2) --------
  // M-tile r = output row r of the tile; its 16 rows are the TW columns.
  {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> a2[TH][NTW];
#pragma unroll
    for (int r = 0; r < TH; ++r)
#pragma unroll
      for (int j = 0; j < NTW; ++j) wmma::fill_fragment(a2[r][j], 0.f);
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - dy * 3;
      for (int k0 = 0; k0 < C4; k0 += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[NTW];
#pragma unroll
        for (int j = 0; j < NTW; ++j)
          wmma::load_matrix_sync(
              bf[j], w2 + (size_t(tap) * C4 + k0) * C4 + (warp + j * kWarps) * 16, C4);
#pragma unroll
        for (int r = 0; r < TH; ++r) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
          wmma::load_matrix_sync(af, y1s + ((r + dy) * HC + dx) * L::LDY + k0, L::LDY);
#pragma unroll
          for (int j = 0; j < NTW; ++j) wmma::mma_sync(a2[r][j], af, bf[j], a2[r][j]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < TH; ++r) {
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        wmma::store_matrix_sync(stage, a2[r][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int ch0 = (warp + j * kWarps) * 16;
        for (int e = lane; e < 256; e += 32) {
          const int ch = ch0 + (e & 15);
          y2s[(r * TW + (e >> 4)) * L::LDY + ch] = __float2bfloat16(fmaxf(stage[e] + b2[ch], 0.f));
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // ---- 1x1 expand + residual: out = relu(y2 W3 + b3 + x) ----------------
  for (int nt = warp; nt < C / 16; nt += kWarps) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> a3[TH];
#pragma unroll
    for (int r = 0; r < TH; ++r) wmma::fill_fragment(a3[r], 0.f);
    for (int k0 = 0; k0 < C4; k0 += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
      wmma::load_matrix_sync(bf, w3 + size_t(k0) * C + nt * 16, C);
#pragma unroll
      for (int r = 0; r < TH; ++r) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::load_matrix_sync(af, y2s + r * TW * L::LDY + k0, L::LDY);
        wmma::mma_sync(a3[r], af, bf, a3[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < TH; ++r) {
      wmma::store_matrix_sync(stage, a3[r], 16, wmma::mem_row_major);
      __syncwarp();
      const int hh = h0 + r;
      for (int e = lane; e < 256; e += 32) {
        const int ww = w0 + (e >> 4), ch = nt * 16 + (e & 15);
        if (hh < H && ww < W) {
          const size_t o = (img + size_t(hh) * W + ww) * C + ch;
          const float v = stage[e] + b3[ch] + __bfloat162float(x[o]);
          out[o] = __float2bfloat16(fmaxf(v, 0.f));
        }
      }
      __syncwarp();
    }
  }
}

template <int C4>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           const void* w3, const void* b3, void* out, int n, int h, int w, int c,
           cudaStream_t stream) {
  const size_t smem = Layout<C4>::total;
  cudaError_t err = cudaFuncSetAttribute(
      bottleneck_kernel<C4>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  bottleneck_kernel<C4><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<const __nv_bfloat16*>(w3),
      static_cast<const float*>(b3), static_cast<__nv_bfloat16*>(out), h, w, c);
  return int(cudaGetLastError());
}

}  // namespace

// Launches one fused block on `stream`; returns a cudaError_t (0 on
// success). Supports C4 in {128, 256} and C a multiple of 64.
extern "C" int bottleneck_launch(const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, const void* w3,
                                 const void* b3, void* out, int n, int h, int w, int c,
                                 int c4, void* stream) {
  if (n < 1 || h < 1 || w < 1 || c % KC != 0 || c < KC) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c4 == 128) return launch<128>(x, w1, b1, w2, b2, w3, b3, out, n, h, w, c, s);
  if (c4 == 256) return launch<256>(x, w1, b1, w2, b2, w3, b3, out, n, h, w, c, s);
  return int(cudaErrorInvalidValue);
}
