// Direct 3x3 convolution for narrow output widths, channels-last, fp32.
//
// Replaces the TPU kernel mri_superresolution_tpu/experiments/conv_pallas.py
// (conv3x3_packed_fwd) for fp32: a 3x3 conv, stride 1, zero padding 1, no
// bias, on (B, H, W, Ci) with the weights as (Co, 3, 3, Ci), fp32
// throughout. bf16, the unet's serving type, runs on the tensor cores
// (conv3x3_mma.cu); fp32 stays on the CUDA cores here, since TF32 would
// change the numbers.
//
// Bound on the H100: the fp32 FMA rate (67 TFLOP/s outside the tensor
// cores): at Co = 16 a pixel is 9 * Ci * 16 MACs against (Ci + 16) * 4
// bytes. Each block stages an 8 x 16 output tile's input, with a one-pixel
// halo, and all of its taps' weights in shared memory, 16 input channels at
// a time (any Ci), and each thread accumulates one output pixel's Co values
// in registers. Ragged edges are masked, so any H and W work.

#include "common.cuh"

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 16;
constexpr int kCiChunk = 16;
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
// +1 float per pixel: neighbouring pixels fall in different banks
constexpr int kPixStride = kCiChunk + 1;

template <int CO>
__global__ void __launch_bounds__(kTileH * kTileW)
    conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ y, int h, int wd, int ci) {
  __shared__ float tile[kHaloH * kHaloW * kPixStride];
  __shared__ __align__(16) float wsm[9 * kCiChunk * CO];

  const int t = threadIdx.x;
  const int tx = t % kTileW;
  const int ty = t / kTileW;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int b = blockIdx.z;
  const float* xb = x + static_cast<long long>(b) * h * wd * ci;

  float acc[CO];
#pragma unroll
  for (int co = 0; co < CO; ++co) acc[co] = 0.f;

  for (int c0 = 0; c0 < ci; c0 += kCiChunk) {
    // input tile with halo; zeros outside the image and past Ci
    for (int i = t; i < kHaloH * kHaloW * kCiChunk; i += blockDim.x) {
      const int cl = i % kCiChunk;
      const int pix = i / kCiChunk;
      const int gy = y0 - 1 + pix / kHaloW;
      const int gx = x0 - 1 + pix % kHaloW;
      float v = 0.f;
      if (gy >= 0 && gy < h && gx >= 0 && gx < wd && c0 + cl < ci)
        v = xb[(static_cast<long long>(gy) * wd + gx) * ci + c0 + cl];
      tile[pix * kPixStride + cl] = v;
    }
    // weights of this channel chunk: wsm[(tap * kCiChunk + cl) * CO + co]
    for (int i = t; i < 9 * kCiChunk * CO; i += blockDim.x) {
      const int co = i % CO;
      const int cl = (i / CO) % kCiChunk;
      const int tap = i / (CO * kCiChunk);
      float v = 0.f;
      if (c0 + cl < ci)
        v = w[(static_cast<long long>(co) * 9 + tap) * ci + c0 + cl];
      wsm[i] = v;
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float* src =
          tile + ((ty + tap / 3) * kHaloW + tx + tap % 3) * kPixStride;
#pragma unroll 4
      for (int cl = 0; cl < kCiChunk; ++cl) {
        const float xv = src[cl];
        const float4* wr =
            reinterpret_cast<const float4*>(wsm + (tap * kCiChunk + cl) * CO);
#pragma unroll
        for (int j = 0; j < CO / 4; ++j) {
          const float4 wv = wr[j];
          acc[4 * j] += xv * wv.x;
          acc[4 * j + 1] += xv * wv.y;
          acc[4 * j + 2] += xv * wv.z;
          acc[4 * j + 3] += xv * wv.w;
        }
      }
    }
    __syncthreads();
  }

  const int oy = y0 + ty;
  const int ox = x0 + tx;
  if (oy < h && ox < wd) {
    float4* out = reinterpret_cast<float4*>(
        y + ((static_cast<long long>(b) * h + oy) * wd + ox) * CO);
#pragma unroll
    for (int j = 0; j < CO / 4; ++j)
      out[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                           acc[4 * j + 3]);
  }
}

template <int CO>
int launch(const void* x, const void* w, void* y, int b, int h, int wd, int ci,
           cudaStream_t stream) {
  const dim3 grid((wd + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, b);
  conv3x3_kernel<CO><<<grid, kTileH * kTileW, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(y), h, wd, ci);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, H, W, Ci), w: (Co, 3, 3, Ci), y: (B, H, W, Co), all contiguous fp32.
// Co is a multiple of 8, <= 64.
extern "C" int msr_conv3x3_f32(const void* x, const void* w, void* y, int b,
                               int h, int wd, int ci, int co, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (co) {
    case 8: return launch<8>(x, w, y, b, h, wd, ci, s);
    case 16: return launch<16>(x, w, y, b, h, wd, ci, s);
    case 24: return launch<24>(x, w, y, b, h, wd, ci, s);
    case 32: return launch<32>(x, w, y, b, h, wd, ci, s);
    case 40: return launch<40>(x, w, y, b, h, wd, ci, s);
    case 48: return launch<48>(x, w, y, b, h, wd, ci, s);
    case 56: return launch<56>(x, w, y, b, h, wd, ci, s);
    case 64: return launch<64>(x, w, y, b, h, wd, ci, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
