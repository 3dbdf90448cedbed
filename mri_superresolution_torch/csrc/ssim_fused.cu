// Fused per-image SSIM of single-channel fp32 images.
//
// Replaces the TPU kernel mri_superresolution_tpu/experiments/
// ssim_pallas.py (ssim_fused_per_sample, body _make_kernel): for each image
// the five maps x1, x2, x1^2, x2^2, x1*x2 are blurred with a zero-padded
// separable Gaussian window (11 taps, sigma 1.5 by default), the SSIM map is
// formed with C1 = (0.01 L)^2 and C2 = (0.03 L)^2, and its mean is the
// image's result.
//
// Bound on the H100: bytes (one read of each image; about 2 x 11 x 5 FMAs
// per pixel is far under the card's flops per byte). The TPU kernel held a
// whole image and its padding in VMEM; a 512 x 512 fp32 pair does not fit in
// a block's 227 KB of shared memory. So each block takes a 32 x 32 output
// tile, stages the two inputs with a halo of window/2 pixels (zeros outside
// the image), blurs the five maps along rows and then along columns in
// shared memory, and reduces its tile's map with a fixed-order tree. A
// second kernel sums each image's tile partials in a fixed order, so the
// (B,) result is the same from run to run. No intermediate map reaches
// device memory.

#include "common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kMaxHalo = 7;  // windows up to 15 taps
constexpr int kMaxIn = kTile + 2 * kMaxHalo;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    ssim_tile_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                     const float* __restrict__ win, float* __restrict__ partial,
                     int h, int w, int ws, float c1, float c2) {
  __shared__ float in1[kMaxIn * kMaxIn];
  __shared__ float in2[kMaxIn * kMaxIn];
  __shared__ float hb[5][kMaxIn * kTile];  // row-blurred maps
  __shared__ float red[kThreads];
  __shared__ float g[2 * kMaxHalo + 1];

  const int t = threadIdx.x;
  const int halo = ws / 2;
  const int nin = kTile + 2 * halo;
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const int b = blockIdx.z;
  const long long img = static_cast<long long>(b) * h * w;

  if (t < ws) g[t] = win[t];
  for (int i = t; i < nin * nin; i += kThreads) {
    const int gy = y0 - halo + i / nin;
    const int gx = x0 - halo + i % nin;
    float a = 0.f, c = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      a = x1[img + static_cast<long long>(gy) * w + gx];
      c = x2[img + static_cast<long long>(gy) * w + gx];
    }
    in1[i] = a;
    in2[i] = c;
  }
  __syncthreads();

  // blur along rows (W): rows 0..nin-1 of the staged tile, kTile columns
  for (int i = t; i < nin * kTile; i += kThreads) {
    const int r = i / kTile;
    const int c = i % kTile;
    float s1 = 0.f, s2 = 0.f, s11 = 0.f, s22 = 0.f, s12 = 0.f;
    for (int k = 0; k < ws; ++k) {
      const float a = in1[r * nin + c + k];
      const float d = in2[r * nin + c + k];
      const float gk = g[k];
      s1 += gk * a;
      s2 += gk * d;
      s11 += gk * (a * a);
      s22 += gk * (d * d);
      s12 += gk * (a * d);
    }
    hb[0][i] = s1;
    hb[1][i] = s2;
    hb[2][i] = s11;
    hb[3][i] = s22;
    hb[4][i] = s12;
  }
  __syncthreads();

  // blur along columns (H) and form the map; sum the pixels in the image
  float acc = 0.f;
  for (int i = t; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile;
    const int c = i % kTile;
    if (y0 + r >= h || x0 + c >= w) continue;
    float m1 = 0.f, m2 = 0.f, e11 = 0.f, e22 = 0.f, e12 = 0.f;
    for (int k = 0; k < ws; ++k) {
      const int j = (r + k) * kTile + c;
      const float gk = g[k];
      m1 += gk * hb[0][j];
      m2 += gk * hb[1][j];
      e11 += gk * hb[2][j];
      e22 += gk * hb[3][j];
      e12 += gk * hb[4][j];
    }
    const float mu1_sq = m1 * m1;
    const float mu2_sq = m2 * m2;
    const float mu1_mu2 = m1 * m2;
    const float s1 = e11 - mu1_sq;
    const float s2 = e22 - mu2_sq;
    const float s12 = e12 - mu1_mu2;
    acc += ((2.f * mu1_mu2 + c1) * (2.f * s12 + c2)) /
           ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2));
  }
  red[t] = acc;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride /= 2) {
    if (t < stride) red[t] += red[t + stride];
    __syncthreads();
  }
  if (t == 0) {
    const int tiles = gridDim.x * gridDim.y;
    partial[static_cast<long long>(b) * tiles + blockIdx.y * gridDim.x +
            blockIdx.x] = red[0];
  }
}

// one block per image: out[b] = sum(partial[b, :]) / (h * w), fixed order
__global__ void __launch_bounds__(kThreads)
    ssim_mean_kernel(const float* __restrict__ partial, float* __restrict__ out,
                     int tiles, int h, int w) {
  __shared__ double red[kThreads];
  const int t = threadIdx.x;
  const float* pb = partial + static_cast<long long>(blockIdx.x) * tiles;
  double s = 0.0;
  for (int i = t; i < tiles; i += kThreads) s += pb[i];
  red[t] = s;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride /= 2) {
    if (t < stride) red[t] += red[t + stride];
    __syncthreads();
  }
  if (t == 0)
    out[blockIdx.x] = static_cast<float>(red[0] / (static_cast<double>(h) * w));
}

}  // namespace

// x1, x2: (B, H, W) fp32 contiguous; win: (ws,) fp32, ws odd <= 15;
// partial: (B, tiles) fp32 scratch with tiles = ceil(H/32) * ceil(W/32);
// out: (B,) fp32.
extern "C" int msr_ssim_fwd(const float* x1, const float* x2, const float* win,
                            float* partial, float* out, int b, int h, int w,
                            int ws, float c1, float c2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, b);
  ssim_tile_kernel<<<grid, kThreads, 0, s>>>(x1, x2, win, partial, h, w, ws,
                                             c1, c2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssim_mean_kernel<<<b, kThreads, 0, s>>>(partial, out, grid.x * grid.y, h, w);
  return static_cast<int>(cudaGetLastError());
}
