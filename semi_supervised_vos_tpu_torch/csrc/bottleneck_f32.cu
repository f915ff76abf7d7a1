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
// all in float32 (FFMA: no TF32, no bf16 split), y1 and y2 kept on chip.
//
// What bounds it on the H100: the three products, 2 N H W (C C4 + 9 C4^2 +
// C4 C) flops (114 GFLOP for an 8-frame 480p block at C 1024), at the
// float32 rate outside the tensor cores (67 TFLOP/s): 1.7 ms a block,
// about 15 ms for the 11 blocks of an 8-frame resnet50 encode. The ~420 MB
// of x, out and weights take a tenth of that.
//
// Design (simple first; 3xTF32 on wgmma is later work):
// - One block of 256 threads per output tile of 8 x 8 pixels. y1 over the
//   10 x 10 halo (C4 + 4 floats a pixel) and y2 over the tile stay in
//   shared memory: 104,000 + 66,560 B at C4 256.
// - Each product runs in panels of 64 rows (pixels) x 128 output channels:
//   a thread owns 4 rows (ty + 16 i) x 8 channels (4 at tx x 4, 4 at 64 +
//   tx x 4), accumulating by FFMA over K in chunks of 16. The weight chunk
//   (16 x 128) and, for the first 1x1, the x chunk of the halo rows (64 x
//   16, out-of-image pixels zero-filled) arrive by cp.async into a
//   two-stage ring; the next chunk loads while this one computes. The 3x3
//   reads its nine tap-shifted rows of y1 straight from shared memory.
// - Each epilogue adds the bias (and for the last product the residual x
//   from device memory), applies the ReLU and stores from the accumulators:
//   y1 (0 outside the image: the 3x3's zero padding), y2, or `out`.
// Shared memory at C4 256: y1 + y2 + ring 2 x (8,192 + 5,120) B = 197,184
// B: one block per SM. The halo's first 1x1 computes 128 rows for 100.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

using namespace hopper;

constexpr int TH = 8, TW = 8;          // output tile
constexpr int HH = TH + 2, HW = TW + 2;  // halo
constexpr int M1 = HH * HW;            // halo pixels (100)
constexpr int KC = 16;                 // K per ring chunk
constexpr int NP = 128;                // output channels per panel
constexpr int LDA = KC + 4;            // x chunk row stride (floats)
constexpr int kThreads = 256;

struct Args {
  const float* x;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  const float* w3;
  const float* b3;
  float* out;
  int n, h, w, c, c4, tiles_h, tiles_w;
};

struct Smem {
  size_t y2, bstage, astage, total;
};

// y1 (M1 rows of C4 + 4 floats), y2 (64 rows of C4 + 4 floats), two weight
// chunk stages (KC x NP floats), two x chunk stages (64 x LDA floats).
__host__ __device__ inline Smem smem_layout(int c4) {
  Smem o;
  const size_t ldy = size_t(c4) + 4;
  o.y2 = M1 * ldy * 4;
  o.bstage = o.y2 + 64 * ldy * 4;
  o.astage = o.bstage + 2 * KC * NP * 4;
  o.total = o.astage + 2 * 64 * LDA * 4;
  return o;
}

// acc (this thread's 4 rows x 8 channels of a 64 x 128 panel) = A (64 rows
// x K) . B[:, n0 : n0 + 128], B (K, ldb) row-major in device memory.
// PH 1: A is the x of halo rows 64 rp.. (from device memory, staged);
// PH 2: A is y1 read at the nine taps of the tile pixels; PH 3: A is y2.
template <int PH>
__device__ __forceinline__ void panel(const Args& a, unsigned char* smem, const Smem& lay, int img, int y0, int x0,
                                      int rp, int n0, float (&acc)[4][8]) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int C4 = a.c4, LDY = C4 + 4;
  const int K = PH == 1 ? a.c : PH == 2 ? 9 * C4 : C4;
  const int ldb = PH == 3 ? a.c : C4;
  const float* B = PH == 1 ? a.w1 : PH == 2 ? a.w2 : a.w3;
  const float* y1 = reinterpret_cast<const float*>(smem);
  const float* y2 = reinterpret_cast<const float*>(smem + lay.y2);
  float* bs = reinterpret_cast<float*>(smem + lay.bstage);
  float* as = reinterpret_cast<float*>(smem + lay.astage);
  const int nch = K / KC;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  auto issue = [&](int ch) {
    const int s = ch & 1, k0 = ch * KC;
    for (int v = tid; v < KC * (NP / 4); v += kThreads) {
      const int r = v / (NP / 4), cv = v - r * (NP / 4);
      cp_async16(bs + s * KC * NP + r * NP + cv * 4, B + size_t(k0 + r) * ldb + n0 + cv * 4);
    }
    if (PH == 1) {
      const int r = tid >> 2, cv = tid & 3;  // 64 rows x 4 float4s
      const int hp = rp * 64 + r;
      const int iy = y0 + hp / HW - 1, ix = x0 + hp % HW - 1;
      const bool ok = hp < M1 && iy >= 0 && iy < a.h && ix >= 0 && ix < a.w;
      const float* src = ok ? a.x + ((size_t(img) * a.h + iy) * a.w + ix) * a.c + k0 + cv * 4 : a.x;
      cp_async16(as + s * 64 * LDA + r * LDA + cv * 4, src, ok);
    }
    cp_async_commit();
  };

  __syncthreads();  // the previous panel is done with both stages
  issue(0);
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<0>();
    __syncthreads();  // chunk ch has landed everywhere; chunk ch - 1 is consumed
    if (ch + 1 < nch) issue(ch + 1);
    const float* bsc = bs + (ch & 1) * KC * NP;
    const float* arow[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      if (PH == 1) {
        arow[i] = as + (ch & 1) * 64 * LDA + r * LDA;
      } else if (PH == 2) {
        const int tap = (ch * KC) / C4, k0 = ch * KC - tap * C4;
        const int dy = tap / 3, dx = tap - 3 * dy;
        arow[i] = y1 + ((r / TW + dy) * HW + r % TW + dx) * LDY + k0;
      } else {
        arow[i] = y2 + r * LDY + ch * KC;
      }
    }
#pragma unroll
    for (int kk = 0; kk < KC; kk += 4) {
      float4 av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(arow[i] + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b0 = *reinterpret_cast<const float4*>(bsc + (kk + q) * NP + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(bsc + (kk + q) * NP + 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ai = q == 0 ? av[i].x : q == 1 ? av[i].y : q == 2 ? av[i].z : av[i].w;
          acc[i][0] = fmaf(ai, b0.x, acc[i][0]);
          acc[i][1] = fmaf(ai, b0.y, acc[i][1]);
          acc[i][2] = fmaf(ai, b0.z, acc[i][2]);
          acc[i][3] = fmaf(ai, b0.w, acc[i][3]);
          acc[i][4] = fmaf(ai, b1.x, acc[i][4]);
          acc[i][5] = fmaf(ai, b1.y, acc[i][5]);
          acc[i][6] = fmaf(ai, b1.z, acc[i][6]);
          acc[i][7] = fmaf(ai, b1.w, acc[i][7]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) bottleneck_f32_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem lay = smem_layout(a.c4);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int C = a.c, C4 = a.c4, LDY = C4 + 4;
  const int tiles = a.tiles_h * a.tiles_w;
  const int img = blockIdx.x / tiles, t = blockIdx.x - img * tiles;
  const int y0 = (t / a.tiles_w) * TH, x0 = (t % a.tiles_w) * TW;
  float* y1 = reinterpret_cast<float*>(smem);
  float* y2 = reinterpret_cast<float*>(smem + lay.y2);
  float acc[4][8];

  // ---- y1 = relu(x . W1 + b1) over the halo, 0 outside the image --------
  for (int rp = 0; rp < 2; ++rp)
    for (int n0 = 0; n0 < C4; n0 += NP) {
      panel<1>(a, smem, lay, img, y0, x0, rp, n0, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int hp = rp * 64 + ty + 16 * i;
        if (hp >= M1) continue;
        const int iy = y0 + hp / HW - 1, ix = x0 + hp % HW - 1;
        const bool in = iy >= 0 && iy < a.h && ix >= 0 && ix < a.w;
#pragma unroll
        for (int hcol = 0; hcol < 2; ++hcol) {
          const int col = n0 + 64 * hcol + tx * 4;
          float4 v;
          v.x = in ? fmaxf(acc[i][4 * hcol + 0] + a.b1[col + 0], 0.f) : 0.f;
          v.y = in ? fmaxf(acc[i][4 * hcol + 1] + a.b1[col + 1], 0.f) : 0.f;
          v.z = in ? fmaxf(acc[i][4 * hcol + 2] + a.b1[col + 2], 0.f) : 0.f;
          v.w = in ? fmaxf(acc[i][4 * hcol + 3] + a.b1[col + 3], 0.f) : 0.f;
          *reinterpret_cast<float4*>(y1 + hp * LDY + col) = v;
        }
      }
    }

  // ---- y2 = relu(conv3x3(y1) + b2) over the tile -------------------------
  for (int n0 = 0; n0 < C4; n0 += NP) {
    panel<2>(a, smem, lay, img, y0, x0, 0, n0, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int hcol = 0; hcol < 2; ++hcol) {
        const int col = n0 + 64 * hcol + tx * 4;
        float4 v;
        v.x = fmaxf(acc[i][4 * hcol + 0] + a.b2[col + 0], 0.f);
        v.y = fmaxf(acc[i][4 * hcol + 1] + a.b2[col + 1], 0.f);
        v.z = fmaxf(acc[i][4 * hcol + 2] + a.b2[col + 2], 0.f);
        v.w = fmaxf(acc[i][4 * hcol + 3] + a.b2[col + 3], 0.f);
        *reinterpret_cast<float4*>(y2 + r * LDY + col) = v;
      }
    }
  }

  // ---- out = relu(y2 . W3 + b3 + x) ---------------------------------------
  for (int n0 = 0; n0 < C; n0 += NP) {
    panel<3>(a, smem, lay, img, y0, x0, 0, n0, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int iy = y0 + r / TW, ix = x0 + r % TW;
      if (iy >= a.h || ix >= a.w) continue;
      const size_t pix = (size_t(img) * a.h + iy) * a.w + ix;
#pragma unroll
      for (int hcol = 0; hcol < 2; ++hcol) {
        const int col = n0 + 64 * hcol + tx * 4;
        const float4 res = *reinterpret_cast<const float4*>(a.x + pix * C + col);
        float4 v;
        v.x = fmaxf(acc[i][4 * hcol + 0] + a.b3[col + 0] + res.x, 0.f);
        v.y = fmaxf(acc[i][4 * hcol + 1] + a.b3[col + 1] + res.y, 0.f);
        v.z = fmaxf(acc[i][4 * hcol + 2] + a.b3[col + 2] + res.z, 0.f);
        v.w = fmaxf(acc[i][4 * hcol + 3] + a.b3[col + 3] + res.w, 0.f);
        *reinterpret_cast<float4*>(a.out + pix * C + col) = v;
      }
    }
  }
  cp_async_wait<0>();
}

}  // namespace

// Launches the block on `stream`: x and out (N, H, W, C), w1 (C, C4), w2
// (3, 3, C4, C4) HWIO, w3 (C4, C), biases, all float32 and 16-byte aligned;
// C4 128 or 256, C a multiple of 128. Returns a cudaError_t (0 on success).
extern "C" int bottleneck_f32_launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                                     const void* w3, const void* b3, void* out, int n, int h, int w, int c, int c4,
                                     void* stream) {
  if (n < 1 || h < 1 || w < 1 || (c4 != 128 && c4 != 256) || c < 128 || c % NP != 0)
    return int(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const float*>(x);
  a.w1 = static_cast<const float*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const float*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.w3 = static_cast<const float*>(w3);
  a.b3 = static_cast<const float*>(b3);
  a.out = static_cast<float*>(out);
  a.n = n;
  a.h = h;
  a.w = w;
  a.c = c;
  a.c4 = c4;
  a.tiles_h = (h + TH - 1) / TH;
  a.tiles_w = (w + TW - 1) / TW;
  const long long blocks = (long long)n * a.tiles_h * a.tiles_w;
  if (blocks > 0x7fffffffll) return int(cudaErrorInvalidValue);
  const size_t smem = smem_layout(c4).total;
  cudaError_t err =
      cudaFuncSetAttribute(bottleneck_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  bottleneck_f32_kernel<<<unsigned(blocks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}
