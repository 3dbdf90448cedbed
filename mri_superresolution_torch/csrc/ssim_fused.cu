// Fused per-image SSIM of single-channel fp32 images: kernel B2.
//
// Replaces the TPU kernel mri_superresolution_tpu/experiments/
// ssim_pallas.py (ssim_fused_per_sample, body _make_kernel): for each image
// the maps x1, x2, x1^2, x2^2, x1*x2 are blurred with a zero-padded
// separable Gaussian window (odd, up to 15 taps; 11 taps, sigma 1.5 by
// default), the SSIM map is formed with C1 = (0.01 L)^2 and C2 = (0.03 L)^2,
// and its mean is the image's result.
//
// Bound on the H100: operations. A pixel costs two blurs of 16 * window
// flops each against 8 bytes read, far above the card's fp32 flops per
// byte, so the FMA pipe is the limit and every design choice below cuts
// instructions or keeps the FMA pipe fed:
//   - Four maps, not five: the map only needs sigma1^2 + sigma2^2, and the
//     blur is linear, so x1^2 + x2^2 is blurred once (one FMUL and one FFMA
//     a pixel). That is 4 * window FFMAs a pass and a pixel.
//   - Columns first, in registers. A block owns a strip of up to 144
//     output columns and walks down a band of rows; each of its 160
//     threads owns one input column of the strip with its halo, loads its
//     own pixel of each row straight from global memory (a warp reads 128
//     contiguous bytes a row), forms the products once per input pixel,
//     and keeps the last window - 1 rows of the four maps in registers.
//     The ring is unrolled by the window (a template parameter), so every
//     index is static and no shared memory is read in this pass. Rows come
//     8 at a time, two groups a trip of the loop (so most of the ring and
//     the raw rows need no copies); the next 8 are loaded through a
//     pointer stepped a row at a time while these are blurred, with the
//     row test only where the image ends, and the vertical halo is loaded
//     once per band.
//   - Rows second, from shared memory. The column-blurred 8 rows of the
//     four maps go to shared memory (double-buffered: one barrier a group);
//     each of 8 * strip / 8 threads then blurs 8 adjacent outputs of one
//     row from one register copy of its 8 + window - 1 inputs, read as
//     16-byte vectors: 5-6 LDS.128 per map for 8 * window FFMAs. The row
//     stride is 4 (mod 32) words and the 8 threads of a quarter warp take
//     the 8 rows of one chunk, so those loads are free of bank conflicts.
//   - A cheap division. The host scales the maps by s, the power of two
//     nearest 1 / val_range, through the column pass's taps: exact, so the
//     map is what it was, but its denominator stays near 1, where
//     __fdividef (MUFU.RCP and an FMUL) is within 2 ulp, and the IEEE
//     division's refinement and slow path drop out.
//   - One launch. The SSIM map is summed per thread, then per block in a
//     fixed order (warp shuffles, then the 5 warps in order, in double).
//     Each block writes its partial and arrives on its image's counter
//     (release); the last block of the image to arrive (acquire) sums the
//     image's partials in a fixed order in double, writes the mean and
//     resets the counter to zero, so the next launch or CUDA graph replay
//     finds it clean. Results are the same bits from run to run.
// The window's taps come by value in the kernel's parameters, so each FFMA
// reads its tap from the constant bank. The host plans the strips and
// bands (kernels/ssim.py, ssim_plan).

#include "common.cuh"

namespace {

constexpr int kThreads = 160;   // input columns of a strip (5 warps)
constexpr int kRows = 8;        // rows a group
constexpr int kOut = 8;         // adjacent outputs a row-pass thread
constexpr int kMaxWindow = 15;
constexpr int kMaxStrip = (kThreads - kMaxWindow + 1) / kOut * kOut;  // 144
constexpr int kStride = 164;    // row stride in words, 4 (mod 32)
constexpr int kMaps = 4;        // x1, x2, x1^2 + x2^2, x1 * x2
constexpr int kMapStride = kRows * kStride;
constexpr int kBuf = kMaps * kMapStride;
static_assert(kStride % 32 == 4 && kStride >= kThreads, "row stride");
static_assert(kRows * kMaxStrip / kOut <= kThreads, "row-pass threads");

// the taps, and for the column pass the taps times s and s^2, where s is
// the power of two nearest 1 / val_range: the maps come out s (or s^2)
// times the unscaled ones, bit for bit (c1, c2 come scaled by s^2 too)
struct Window {
  float g[16];
  float g1[16];   // g * s: x1, x2
  float g2[16];   // g * s^2: x1^2 + x2^2, x1 * x2
};

__device__ __forceinline__ float ssim_px(float m1, float m2, float q, float p,
                                         float c1, float c2) {
  const float mu1_sq = m1 * m1;
  const float mu2_sq = m2 * m2;
  const float mu1_mu2 = m1 * m2;
  const float s_sum = (q - mu1_sq) - mu2_sq;  // sigma1^2 + sigma2^2
  const float s12 = p - mu1_mu2;
  const float num = (2.f * mu1_mu2 + c1) * (2.f * s12 + c2);
  const float den = (mu1_sq + mu2_sq + c1) * (s_sum + c2);
  return __fdividef(num, den);
}

// grid (strips, bands, images); block (strip, band, image) owns output
// columns [strip * sw, strip * sw + sw) and rows [band * rows, band * rows
// + rows) of its image, both cut at the image's edge.
template <int WS>
__global__ void __launch_bounds__(kThreads, (WS <= 11) ? 3 : 2)
    ssim_band_kernel(const float* __restrict__ x1,
                     const float* __restrict__ x2, const Window win,
                     double* __restrict__ partial, unsigned* __restrict__ cnt,
                     float* __restrict__ out, int h, int w, int sw, int rows,
                     float c1, float c2) {
  constexpr int kHalo = WS / 2;
  constexpr int kCarry = WS - 1;                   // ring of past rows
  constexpr int kRing = kCarry > 0 ? kCarry : 1;
  constexpr int kLoad = (kOut + WS - 1 + 3) / 4;   // 16-byte loads a map
  __shared__ __align__(16) float vb[2 * kBuf];
  __shared__ double red[kThreads / 32];
  __shared__ bool last;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * sw;
  const int y0 = blockIdx.y * rows;
  const int gx = x0 - kHalo + t;                   // this thread's column
  const bool col_in = gx >= 0 && gx < w;
  const long long img =
      static_cast<long long>(b) * h * w + min(max(gx, 0), w - 1);
  const float* p1 = x1 + img;
  const float* p2 = x2 + img;

  // row y of this thread's column, zero where ok is false (an image holds
  // fewer than 2^31 pixels: the host checks)
  auto load = [&](int y, bool ok, float& a, float& c) {
    a = 0.f;
    c = 0.f;
    if (ok) {
      a = __ldg(p1 + y * w);
      c = __ldg(p2 + y * w);
    }
  };

  // the ring: input rows y0 - halo .. y0 + halo - 1 of the four maps
  float ring[kMaps][kRing];
#pragma unroll
  for (int i = 0; i < kCarry; ++i) {
    float a, c;
    const int y = y0 - kHalo + i;
    load(y, col_in && y >= 0 && y < h, a, c);
    ring[0][i] = a;
    ring[1][i] = c;
    ring[2][i] = fmaf(c, c, a * a);
    ring[3][i] = a * c;
  }
  // the raw rows of the first group
  float ra[kRows], rc[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j)
    load(y0 + kHalo + j, col_in && y0 + kHalo + j < h, ra[j], rc[j]);

  const int tasks = kRows * (sw / kOut);
  const int groups = rows / kRows;
  float sum = 0.f;
  // two groups a trip, so that the buffer, the raw rows and most of the
  // ring need no copies
#pragma unroll 2
  for (int gi = 0; gi < groups; ++gi) {
    const int yg = y0 + gi * kRows;
    float* vbb = vb + (gi & 1) * kBuf;
    // the next group's raw rows fly while this group is blurred; the row
    // test only where the image ends
    float na[kRows], nc[kRows];
    if (yg + 2 * kRows + kHalo <= h) {
      const float* q1 = p1 + (yg + kRows + kHalo) * w;
      const float* q2 = p2 + (yg + kRows + kHalo) * w;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        na[j] = col_in ? __ldg(q1) : 0.f;
        nc[j] = col_in ? __ldg(q2) : 0.f;
        q1 += w;
        q2 += w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int y = yg + kRows + kHalo + j;
        load(y, col_in && y < h, na[j], nc[j]);
      }
    }

    float nw[kMaps][kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      nw[0][j] = ra[j];
      nw[1][j] = rc[j];
      nw[2][j] = fmaf(rc[j], rc[j], ra[j] * ra[j]);
      nw[3][j] = ra[j] * rc[j];
    }
    // column blur of rows yg .. yg + 7: input row yg - halo + i is
    // ring[i] for i < window - 1, else nw[i - (window - 1)]
#pragma unroll
    for (int m = 0; m < kMaps; ++m) {
#pragma unroll
      for (int o = 0; o < kRows; ++o) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < WS; ++k) {
          const int i = o + k;
          const float v = i < kCarry ? ring[m][i] : nw[m][i - kCarry];
          const float gk = m < 2 ? win.g1[k] : win.g2[k];
          acc = k == 0 ? gk * v : fmaf(gk, v, acc);
        }
        vbb[m * kMapStride + o * kStride + t] = acc;
      }
#pragma unroll
      for (int i = 0; i < kCarry; ++i) {
        const int s = i + kRows;
        ring[m][i] = s < kCarry ? ring[m][s] : nw[m][s - kCarry];
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      ra[j] = na[j];
      rc[j] = nc[j];
    }
    __syncthreads();

    // row blur and the map: thread (r, ch) takes outputs x0 + 8 ch ..
    // + 7 of row yg + r
    if (t < tasks) {
      const int r = t % kRows;
      const int ch = t / kRows;
      const float* base = vbb + r * kStride + ch * kOut;
      float res[kMaps][kOut];
#pragma unroll
      for (int m = 0; m < kMaps; ++m) {
        float v[4 * kLoad];
#pragma unroll
        for (int q = 0; q < kLoad; ++q) {
          const float4 f =
              *reinterpret_cast<const float4*>(base + m * kMapStride + 4 * q);
          v[4 * q] = f.x;
          v[4 * q + 1] = f.y;
          v[4 * q + 2] = f.z;
          v[4 * q + 3] = f.w;
        }
#pragma unroll
        for (int o = 0; o < kOut; ++o) {
          float acc = win.g[0] * v[o];
#pragma unroll
          for (int k = 1; k < WS; ++k) acc = fmaf(win.g[k], v[o + k], acc);
          res[m][o] = acc;
        }
      }
      const int nvalid = min(kOut, w - (x0 + ch * kOut));
      if (yg + r < h) {
#pragma unroll
        for (int o = 0; o < kOut; ++o) {
          const float v =
              ssim_px(res[0][o], res[1][o], res[2][o], res[3][o], c1, c2);
          sum += o < nvalid ? v : 0.f;
        }
      }
    }
  }

  // the block's partial, in a fixed order
  double s = sum;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) red[t / 32] = s;
  __syncthreads();
  const int nper = gridDim.x * gridDim.y;
  if (t == 0) {
    double tot = 0.0;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) tot += red[i];
    partial[static_cast<long long>(b) * nper + blockIdx.y * gridDim.x +
            blockIdx.x] = tot;
    __threadfence();
    last = atomicAdd(cnt + b, 1u) == static_cast<unsigned>(nper - 1);
  }
  __syncthreads();
  // the image's last block: its mean, in a fixed order, in double
  if (last && t < 32) {
    __threadfence();
    const double* pb = partial + static_cast<long long>(b) * nper;
    double a = 0.0;
    for (int j = t; j < nper; j += 32) a += __ldcg(pb + j);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      a += __shfl_down_sync(0xffffffffu, a, off);
    if (t == 0) {
      out[b] = static_cast<float>(a / (static_cast<double>(h) * w));
      cnt[b] = 0u;
    }
  }
}

template <int WS>
int launch(const float* x1, const float* x2, const Window& win,
           double* partial, unsigned* cnt, float* out, int b, int h, int w,
           int sw, int strips, int rows, int bands, float c1, float c2,
           cudaStream_t s) {
  const dim3 grid(strips, bands, b);
  ssim_band_kernel<WS><<<grid, kThreads, 0, s>>>(x1, x2, win, partial, cnt,
                                                 out, h, w, sw, rows, c1, c2);
  return static_cast<int>(cudaGetLastError());
}

template <int WS>
int occupancy(int* per_sm) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, ssim_band_kernel<WS>, kThreads, 0));
}

}  // namespace

// Co-resident blocks a SM of the kernel for window ws, and the SM count of
// the current device: the host plan's wave model (kernels/ssim.py).
extern "C" int msr_ssim_capacity(int ws, int* per_sm, int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (ws) {
    case 1: return occupancy<1>(per_sm);
    case 3: return occupancy<3>(per_sm);
    case 5: return occupancy<5>(per_sm);
    case 7: return occupancy<7>(per_sm);
    case 9: return occupancy<9>(per_sm);
    case 11: return occupancy<11>(per_sm);
    case 13: return occupancy<13>(per_sm);
    case 15: return occupancy<15>(per_sm);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x1, x2: (B, H, W) fp32 contiguous on the device; win: the ws taps in
// host memory (passed by value to the kernel); partial: (B, strips *
// bands) fp64 scratch; cnt: (>= B,) u32 counters, zero between launches;
// out: (B,) fp32; c1 = (0.01 L s)^2, c2 = (0.03 L s)^2 with `scale` s the
// power of two nearest 1 / L (L = val_range). The plan: strips of sw
// output columns (a multiple of 8, at most kMaxStrip), bands of `rows` rows
// (a multiple of 8); refused unless it covers the image with no empty
// strip or band.
extern "C" int msr_ssim_fwd(const float* x1, const float* x2, const float* win,
                            double* partial, unsigned* cnt, float* out, int b,
                            int h, int w, int ws, int sw, int strips, int rows,
                            int bands, float c1, float c2, float scale,
                            void* stream) {
  if (b <= 0 || b > 65535 || h <= 0 || w <= 0 || ws < 1 || ws % 2 == 0 ||
      ws > kMaxWindow || sw % kOut || sw < kOut || sw > kMaxStrip ||
      sw + ws - 1 > kThreads || rows % kRows || rows < kRows ||
      bands > 65535 || strips <= 0 || bands <= 0 ||
      static_cast<long long>(sw) * strips < w ||
      static_cast<long long>(sw) * (strips - 1) >= w ||
      static_cast<long long>(rows) * bands < h ||
      static_cast<long long>(rows) * (bands - 1) >= h ||
      static_cast<long long>(h) * w >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  int e = 0;
  if (!(scale > 0.f) || frexpf(scale, &e) != 0.5f)
    return static_cast<int>(cudaErrorInvalidValue);
  Window g{};
  for (int k = 0; k < ws; ++k) {
    g.g[k] = win[k];
    g.g1[k] = win[k] * scale;
    g.g2[k] = win[k] * scale * scale;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ws) {
#define MSR_SSIM_CASE(N)                                                    \
  case N:                                                                   \
    return launch<N>(x1, x2, g, partial, cnt, out, b, h, w, sw, strips,     \
                     rows, bands, c1, c2, s);
    MSR_SSIM_CASE(1)
    MSR_SSIM_CASE(3)
    MSR_SSIM_CASE(5)
    MSR_SSIM_CASE(7)
    MSR_SSIM_CASE(9)
    MSR_SSIM_CASE(11)
    MSR_SSIM_CASE(13)
    MSR_SSIM_CASE(15)
#undef MSR_SSIM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
