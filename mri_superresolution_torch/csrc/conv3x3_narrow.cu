// Direct 3x3 convolution for narrow output widths, channels-last.
//
// Replaces the TPU kernel mri_superresolution_tpu/experiments/conv_pallas.py
// (conv3x3_packed_fwd, body _kernel_body, weights pack_weights): a 3x3 conv,
// stride 1, zero padding 1, no bias, on (B, H, W, Ci) with a (3, 3, Ci, Co)
// kernel; inputs bf16 or fp32, fp32 accumulation, one cast of the result.
// In the unet it runs final_up_conv (32 -> 16) and final_conv1 (16 -> 16),
// both at 2H x 2W.
//
// Bound on the H100: bytes, by the card's rates. At Co = 16 a pixel is
// 9 * Ci * 16 MACs against Ci + 16 elements moved, about 96 flops a byte at
// Ci = 32 in bf16, under the ~295 the tensor cores need. The TPU kernel packed
// output columns into the 128-lane matrix unit's width; that trick is for
// the TPU and is not used. This kernel is the simple first version: each
// block stages an 8 x 16 output tile's input, with a one-pixel halo, and
// all of its taps' weights in shared memory as fp32, 16 input channels at a
// time (any Ci), and each thread accumulates one output pixel's Co values
// in registers with CUDA-core FMAs. Its FMA rate, not the memory, limits it
// for now; the tensor-core version (wgmma) is later work. Ragged edges are
// masked, so any H and W work (the TPU kernel needed W % 8 == 0 and
// H % h_tile == 0).

#include "common.cuh"

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 16;
constexpr int kCiChunk = 16;
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
// +1 float per pixel: neighbouring pixels fall in different banks
constexpr int kPixStride = kCiChunk + 1;

template <typename T, int CO>
__global__ void __launch_bounds__(kTileH * kTileW)
    conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ y, int h, int wd, int ci) {
  __shared__ float tile[kHaloH * kHaloW * kPixStride];
  __shared__ __align__(16) float wsm[9 * kCiChunk * CO];

  const int t = threadIdx.x;
  const int tx = t % kTileW;
  const int ty = t / kTileW;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int b = blockIdx.z;
  const T* xb = x + static_cast<long long>(b) * h * wd * ci;

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
        v = msr::to_float(
            xb[(static_cast<long long>(gy) * wd + gx) * ci + c0 + cl]);
      tile[pix * kPixStride + cl] = v;
    }
    // weights of this channel chunk: wsm[(tap * kCiChunk + cl) * CO + co]
    for (int i = t; i < 9 * kCiChunk * CO; i += blockDim.x) {
      const int co = i % CO;
      const int cl = (i / CO) % kCiChunk;
      const int tap = i / (CO * kCiChunk);
      float v = 0.f;
      if (c0 + cl < ci)
        v = msr::to_float(w[(static_cast<long long>(tap) * ci + c0 + cl) * CO + co]);
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
    constexpr int VO = 16 / sizeof(T);  // CO is a multiple of 8 >= VO
    msr::Vec<T, VO>* out = reinterpret_cast<msr::Vec<T, VO>*>(
        y + ((static_cast<long long>(b) * h + oy) * wd + ox) * CO);
#pragma unroll
    for (int j = 0; j < CO / VO; ++j) {
      msr::Vec<T, VO> o;
#pragma unroll
      for (int k = 0; k < VO; ++k) o.v[k] = msr::from_float<T>(acc[j * VO + k]);
      out[j] = o;
    }
  }
}

template <typename T, int CO>
int launch(const void* x, const void* w, void* y, int b, int h, int wd, int ci,
           cudaStream_t stream) {
  const dim3 grid((wd + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, b);
  conv3x3_kernel<T, CO><<<grid, kTileH * kTileW, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      h, wd, ci);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* w, void* y, int b, int h, int wd,
             int ci, int co, cudaStream_t s) {
  switch (co) {
    case 8: return launch<T, 8>(x, w, y, b, h, wd, ci, s);
    case 16: return launch<T, 16>(x, w, y, b, h, wd, ci, s);
    case 24: return launch<T, 24>(x, w, y, b, h, wd, ci, s);
    case 32: return launch<T, 32>(x, w, y, b, h, wd, ci, s);
    case 40: return launch<T, 40>(x, w, y, b, h, wd, ci, s);
    case 48: return launch<T, 48>(x, w, y, b, h, wd, ci, s);
    case 56: return launch<T, 56>(x, w, y, b, h, wd, ci, s);
    case 64: return launch<T, 64>(x, w, y, b, h, wd, ci, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: (B, H, W, Ci), w: (3, 3, Ci, Co), y: (B, H, W, Co), all contiguous and
// of one type (bf16 when is_bf16, else fp32). Co is a multiple of 8, <= 64.
extern "C" int msr_conv3x3_fwd(const void* x, const void* w, void* y, int b,
                               int h, int wd, int ci, int co, int is_bf16,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch<__nv_bfloat16>(x, w, y, b, h, wd, ci, co, s);
  return dispatch<float>(x, w, y, b, h, wd, ci, co, s);
}
