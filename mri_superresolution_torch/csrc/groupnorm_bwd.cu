// Backward of fused GroupNorm + LeakyReLU on channels-last activations: the
// gradient of kernel B1.
//
// Replaces the backward of the TPU kernel mri_superresolution_tpu/
// experiments/groupnorm_pallas.py (`_backward`, the custom_vjp of
// fused_group_norm_leaky, which the JAX package computes in jnp outside
// Pallas). Given x, gamma, beta and the output's gradient g, all in fp32:
//   mean, rstd per (image, group), recomputed from x (E[x^2] - mean^2);
//   xhat = (x - mean) * rstd;  z = xhat * gamma + beta;
//   dz = g * (z >= 0 ? 1 : slope);
//   dgamma_c = sum over (B, H, W) of dz * xhat;  dbeta_c = sum of dz;
//   dx = rstd * (dz * gamma - m1 - xhat * m2), with m1 and m2 the
//   (image, group) means of dz * gamma and dz * gamma * xhat.
// The mask comes from z recomputed in fp32, never from the stored output:
// at a residual site y's sign is not z's.
//
// Bound on the H100: bytes. The function reads x and g once and writes dx
// once, with about 20 flops an element. This first version takes four
// passes, each a grid of (pixel chunk, image) blocks as in the forward's
// two-pass kernel (csrc/groupnorm_leaky.cu), since a block cannot hold an
// image and blocks run in no order:
//   1. gnb_stats: partial (sum, sum of squares) of x per group and chunk;
//   2. gnb_partial: per chunk and channel, partial sums of dz and dz * xhat;
//   3. gnb_reduce: one block an image sums its chunks into per-channel
//      sums and the group means m1, m2;
//   4. gnb_apply: dx, and (block (0, 0)) dgamma, dbeta summed over images.
// x is read three times and g twice: about twice the bound's bytes. On an
// NVIDIA H100 80GB HBM3 at 700 W the 20 training sites of the unet take
// about 0.9 ms against their 0.113 ms bound, and a site of 0.5 M elements
// still takes ~30 µs: the four launches' fixed costs dominate (PERF.md).
// Striding the chunk sums over a warp's lanes was tried and was slower.
//
// Bits. Every sum runs in a fixed order with no atomics, so two calls give
// the same bits. The statistics are summed in double, and mean and rstd
// rounded to fp32 once, the way the plain version computes them
// (kernels/groupnorm.group_norm_leaky_backward_plain); xhat and z are
// rounded op by op (__fmul_rn, __fadd_rn: no FMA contraction). So z, and
// with it the LeakyReLU mask, has the plain version's bits; a mask that
// flipped at z ~ 0 would change that element's dx by 80%.

#include "common.cuh"

namespace {

// The (mean, rstd) of every group of image b into stats[2 * g], from the
// chunk partials in a fixed order. Called by every thread of the block.
__device__ void image_stats(const double* __restrict__ ws_stats, int b,
                            int nchunks, int g, long long hw, int cg,
                            float eps, float* stats) {
  for (int t = threadIdx.x; t < g; t += blockDim.x) {
    double s = 0.0, q = 0.0;
    const double* wb = ws_stats + static_cast<long long>(b) * nchunks * g * 2;
    for (int k = 0; k < nchunks; ++k) {
      s += wb[(k * g + t) * 2];
      q += wb[(k * g + t) * 2 + 1];
    }
    const double n = static_cast<double>(hw) * cg;
    const float mean = static_cast<float>(s / n);
    const float var = __fsub_rn(static_cast<float>(q / n),
                                __fmul_rn(mean, mean));
    stats[2 * t] = mean;
    stats[2 * t + 1] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  }
  __syncthreads();
}

// Thread layout of passes 1, 2 and 4: a pixel's C channels are C / V
// vectors; thread t owns vector t % vpp of pixels r0, r0 + rows, ... of
// its chunk (r0 = t / vpp), so its channels are fixed for the block.
template <typename T, int V>
__global__ void gnb_stats(const T* __restrict__ x, double* __restrict__ ws,
                          long long hw, int c, int g, int chunk_px,
                          int nchunks, int rows) {
  extern __shared__ double dpart[];  // [2][blockDim.x * V]
  const int vpp = c / V;
  const int t = threadIdx.x;
  const int cvec = t % vpp;
  const int r0 = t / vpp;
  const int b = blockIdx.y;
  const long long p_begin = static_cast<long long>(blockIdx.x) * chunk_px;
  const long long p_end = min(p_begin + chunk_px, hw);
  const T* xb = x + static_cast<long long>(b) * hw * c + cvec * V;

  double s[V], q[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    s[k] = 0.0;
    q[k] = 0.0;
  }
  for (long long p = p_begin + r0; p < p_end; p += rows) {
    const msr::Vec<T, V> v =
        *reinterpret_cast<const msr::Vec<T, V>*>(xb + p * c);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const double f = msr::to_float(v.v[k]);
      s[k] += f;
      q[k] += f * f;
    }
  }
  const int n = blockDim.x * V;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    dpart[t * V + k] = s[k];
    dpart[n + t * V + k] = q[k];
  }
  __syncthreads();
  // tree over the `rows` threads that share a channel vector; afterwards
  // dpart[ch] (ch < c) holds channel ch's sum and dpart[n + ch] its squares
  for (int stride = rows / 2; stride > 0; stride /= 2) {
    if (r0 < stride) {
      const int o = stride * vpp * V;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        dpart[t * V + k] += dpart[t * V + k + o];
        dpart[n + t * V + k] += dpart[n + t * V + k + o];
      }
    }
    __syncthreads();
  }
  const int cg = c / g;
  for (int gi = t; gi < g; gi += blockDim.x) {
    double gs = 0.0, gq = 0.0;
    for (int j = 0; j < cg; ++j) {
      gs += dpart[gi * cg + j];
      gq += dpart[n + gi * cg + j];
    }
    double* out =
        ws + ((static_cast<long long>(b) * nchunks + blockIdx.x) * g + gi) * 2;
    out[0] = gs;
    out[1] = gq;
  }
}

// The per-thread constants of passes 2 and 4: mean, rstd, gamma and beta
// of the thread's V channels.
template <int V>
__device__ __forceinline__ void channel_consts(const float* stats,
                                               const float* __restrict__ gamma,
                                               const float* __restrict__ beta,
                                               int ch0, int cg, float* m,
                                               float* r, float* ga,
                                               float* be) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int gi = (ch0 + k) / cg;
    m[k] = stats[2 * gi];
    r[k] = stats[2 * gi + 1];
    ga[k] = gamma[ch0 + k];
    be[k] = beta[ch0 + k];
  }
}

// xhat and dz of one element, rounded op by op as the plain version.
__device__ __forceinline__ void xhat_dz(float xv, float gv, float m, float r,
                                        float ga, float be, float slope,
                                        float* xhat, float* dz) {
  const float xh = __fmul_rn(__fsub_rn(xv, m), r);
  const float z = __fadd_rn(__fmul_rn(xh, ga), be);
  *xhat = xh;
  *dz = z >= 0.f ? gv : __fmul_rn(gv, slope);
}

template <typename T, int V>
__global__ void gnb_partial(const T* __restrict__ x, const T* __restrict__ gy,
                            const float* __restrict__ gamma,
                            const float* __restrict__ beta,
                            const double* __restrict__ ws_stats,
                            float* __restrict__ ws_part, long long hw, int c,
                            int g, int chunk_px, int nchunks, int rows,
                            float eps, float slope) {
  extern __shared__ float sh[];  // stats[2 * g], part[2][blockDim.x * V]
  float* stats = sh;
  float* part = sh + 2 * g;
  const int vpp = c / V;
  const int t = threadIdx.x;
  const int cvec = t % vpp;
  const int r0 = t / vpp;
  const int b = blockIdx.y;
  const int cg = c / g;
  image_stats(ws_stats, b, nchunks, g, hw, cg, eps, stats);

  float m[V], r[V], ga[V], be[V], sa[V], sb[V];
  channel_consts<V>(stats, gamma, beta, cvec * V, cg, m, r, ga, be);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    sa[k] = 0.f;
    sb[k] = 0.f;
  }
  const long long p_begin = static_cast<long long>(blockIdx.x) * chunk_px;
  const long long p_end = min(p_begin + chunk_px, hw);
  const long long base = static_cast<long long>(b) * hw * c + cvec * V;
  for (long long p = p_begin + r0; p < p_end; p += rows) {
    const long long off = base + p * c;
    const msr::Vec<T, V> xv = *reinterpret_cast<const msr::Vec<T, V>*>(x + off);
    const msr::Vec<T, V> gv =
        *reinterpret_cast<const msr::Vec<T, V>*>(gy + off);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float xh, dz;
      xhat_dz(msr::to_float(xv.v[k]), msr::to_float(gv.v[k]), m[k], r[k],
              ga[k], be[k], slope, &xh, &dz);
      sa[k] += dz;
      sb[k] += dz * xh;
    }
  }
  const int n = blockDim.x * V;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    part[t * V + k] = sa[k];
    part[n + t * V + k] = sb[k];
  }
  __syncthreads();
  for (int stride = rows / 2; stride > 0; stride /= 2) {
    if (r0 < stride) {
      const int o = stride * vpp * V;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        part[t * V + k] += part[t * V + k + o];
        part[n + t * V + k] += part[n + t * V + k + o];
      }
    }
    __syncthreads();
  }
  float* out = ws_part + (static_cast<long long>(b) * nchunks + blockIdx.x) *
                             c * 2;
  for (int ch = t; ch < c; ch += blockDim.x) {
    out[2 * ch] = part[ch];
    out[2 * ch + 1] = part[n + ch];
  }
}

// One block an image: per-channel sums of dz and dz * xhat over the
// image's chunks (ws_img, for dgamma and dbeta), and each group's m1, m2.
__global__ void gnb_reduce(const float* __restrict__ gamma,
                           const float* __restrict__ ws_part,
                           float* __restrict__ ws_img, float* __restrict__ ws_m,
                           long long hw, int c, int g, int nchunks) {
  extern __shared__ double gsum[];  // [2][c]: gamma * sums
  const int b = blockIdx.x;
  const float* wb = ws_part + static_cast<long long>(b) * nchunks * c * 2;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    double sa = 0.0, sb = 0.0;
    for (int k = 0; k < nchunks; ++k) {
      sa += wb[(static_cast<long long>(k) * c + ch) * 2];
      sb += wb[(static_cast<long long>(k) * c + ch) * 2 + 1];
    }
    float* o = ws_img + (static_cast<long long>(b) * c + ch) * 2;
    o[0] = static_cast<float>(sa);
    o[1] = static_cast<float>(sb);
    gsum[ch] = static_cast<double>(gamma[ch]) * sa;
    gsum[c + ch] = static_cast<double>(gamma[ch]) * sb;
  }
  __syncthreads();
  const int cg = c / g;
  const double n = static_cast<double>(hw) * cg;
  for (int gi = threadIdx.x; gi < g; gi += blockDim.x) {
    double m1 = 0.0, m2 = 0.0;
    for (int j = 0; j < cg; ++j) {
      m1 += gsum[gi * cg + j];
      m2 += gsum[c + gi * cg + j];
    }
    ws_m[(b * g + gi) * 2] = static_cast<float>(m1 / n);
    ws_m[(b * g + gi) * 2 + 1] = static_cast<float>(m2 / n);
  }
}

template <typename T, int V>
__global__ void gnb_apply(const T* __restrict__ x, const T* __restrict__ gy,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta,
                          const double* __restrict__ ws_stats,
                          const float* __restrict__ ws_m,
                          const float* __restrict__ ws_img,
                          T* __restrict__ dx, float* __restrict__ dgamma,
                          float* __restrict__ dbeta, int nb, long long hw,
                          int c, int g, int chunk_px, int nchunks, int rows,
                          float eps, float slope) {
  extern __shared__ float sh[];  // stats[2 * g]
  const int vpp = c / V;
  const int t = threadIdx.x;
  const int cvec = t % vpp;
  const int r0 = t / vpp;
  const int b = blockIdx.y;
  const int cg = c / g;
  image_stats(ws_stats, b, nchunks, g, hw, cg, eps, sh);

  if (blockIdx.x == 0 && blockIdx.y == 0) {
    for (int ch = t; ch < c; ch += blockDim.x) {
      double sa = 0.0, sb = 0.0;
      for (int i = 0; i < nb; ++i) {
        sa += ws_img[(static_cast<long long>(i) * c + ch) * 2];
        sb += ws_img[(static_cast<long long>(i) * c + ch) * 2 + 1];
      }
      dbeta[ch] = static_cast<float>(sa);
      dgamma[ch] = static_cast<float>(sb);
    }
  }

  float m[V], r[V], ga[V], be[V], m1[V], m2[V];
  channel_consts<V>(sh, gamma, beta, cvec * V, cg, m, r, ga, be);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int gi = (cvec * V + k) / cg;
    m1[k] = ws_m[(b * g + gi) * 2];
    m2[k] = ws_m[(b * g + gi) * 2 + 1];
  }
  const long long p_begin = static_cast<long long>(blockIdx.x) * chunk_px;
  const long long p_end = min(p_begin + chunk_px, hw);
  const long long base = static_cast<long long>(b) * hw * c + cvec * V;
  for (long long p = p_begin + r0; p < p_end; p += rows) {
    const long long off = base + p * c;
    const msr::Vec<T, V> xv = *reinterpret_cast<const msr::Vec<T, V>*>(x + off);
    const msr::Vec<T, V> gv =
        *reinterpret_cast<const msr::Vec<T, V>*>(gy + off);
    msr::Vec<T, V> o;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float xh, dz;
      xhat_dz(msr::to_float(xv.v[k]), msr::to_float(gv.v[k]), m[k], r[k],
              ga[k], be[k], slope, &xh, &dz);
      o.v[k] = msr::from_float<T>(r[k] * (dz * ga[k] - m1[k] - xh * m2[k]));
    }
    *reinterpret_cast<msr::Vec<T, V>*>(dx + off) = o;
  }
}

template <typename T, int V>
int launch(const void* x, const void* gy, const float* gamma,
           const float* beta, void* dx, float* dgamma, float* dbeta,
           double* ws_stats, float* ws_part, float* ws_img, float* ws_m, int b,
           long long hw, int c, int g, int chunk_px, int nchunks, int rows,
           float eps, float slope, cudaStream_t stream) {
  const int threads = (c / V) * rows;
  const dim3 grid(nchunks, b);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(gy);
  gnb_stats<T, V><<<grid, threads, 2 * sizeof(double) * threads * V,
                    stream>>>(xt, ws_stats, hw, c, g, chunk_px, nchunks, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gnb_partial<T, V><<<grid, threads,
                      sizeof(float) * (2 * g + 2 * threads * V), stream>>>(
      xt, gt, gamma, beta, ws_stats, ws_part, hw, c, g, chunk_px, nchunks,
      rows, eps, slope);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gnb_reduce<<<b, 256, 2 * sizeof(double) * c, stream>>>(
      gamma, ws_part, ws_img, ws_m, hw, c, g, nchunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gnb_apply<T, V><<<grid, threads, sizeof(float) * 2 * g, stream>>>(
      xt, gt, gamma, beta, ws_stats, ws_m, ws_img, static_cast<T*>(dx),
      dgamma, dbeta, b, hw, c, g, chunk_px, nchunks, rows, eps, slope);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, gy, dx: (B, HW, C) channels-last, bf16 (is_bf16) or fp32. gamma, beta,
// dgamma, dbeta: (C,) fp32. Scratch: ws_stats (B, nchunks, G, 2) double,
// ws_part (B, nchunks, C, 2), ws_img (B, C, 2), ws_m (B, G, 2) fp32.
// vec: elements per vector load (1, or 16 bytes' worth: 4 fp32 / 8 bf16);
// rows, chunk_px, nchunks: the launch geometry of the forward's two-pass
// kernel (kernels/groupnorm._launch_geometry).
extern "C" int msr_gn_leaky_bwd(const void* x, const void* gy,
                                const float* gamma, const float* beta,
                                void* dx, float* dgamma, float* dbeta,
                                double* ws_stats, float* ws_part,
                                float* ws_img, float* ws_m, int b,
                                long long hw, int c, int g, int chunk_px,
                                int nchunks, int rows, int vec, int is_bf16,
                                float eps, float slope, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MSR_GNB(T, V)                                                        \
  return launch<T, V>(x, gy, gamma, beta, dx, dgamma, dbeta, ws_stats,       \
                      ws_part, ws_img, ws_m, b, hw, c, g, chunk_px, nchunks, \
                      rows, eps, slope, s)
  if (is_bf16) {
    if (vec == 8) MSR_GNB(__nv_bfloat16, 8);
    MSR_GNB(__nv_bfloat16, 1);
  }
  if (vec == 4) MSR_GNB(float, 4);
  MSR_GNB(float, 1);
#undef MSR_GNB
}
