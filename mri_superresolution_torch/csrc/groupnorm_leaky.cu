// Fused GroupNorm + LeakyReLU (+ residual) on channels-last activations.
//
// Replaces the TPU kernel mri_superresolution_tpu/experiments/
// groupnorm_pallas.py (_pallas_forward / _make_kernel, API
// fused_group_norm_leaky): y = leaky(GN_G(x) * gamma + beta) [+ res], fp32
// statistics (mean, then E[x^2] - mean^2), eps added to the variance, fp32
// affine and activation, one cast back to x's type.
//
// Bound on the H100: bytes. The work is a few flops per element, far below
// the card's ~295 flops per byte, and the bound is one read of x (and of
// the residual) and one write of y. The TPU kernel carried a group's sums
// across sequential grid steps and held the whole image in VMEM; neither
// exists here, and at batch 1 an image has only G = 8 groups, far too few
// blocks for 132 SMs. So each (image, pixel chunk) is its own block:
//   pass 1 (gn_stats_kernel) writes fp32 partial (sum, sum of squares) per
//     group for its chunk into a workspace the wrapper allocates;
//   pass 2 (gn_apply_kernel) sums the partials of its image in a fixed
//     order, forms each channel's mean, gamma*rstd and beta, and streams
//     its chunk through the affine, the LeakyReLU and the optional residual.
// x is read twice (a third pass over the bound). Reductions run in a fixed
// order, so results do not change from run to run. Loads and stores move V
// elements (16 bytes) a thread where the channel count allows it.
//
// Thread layout: a pixel's C channels are C / V vectors; thread t always
// owns vector t % vpp of a pixel and walks pixels r0, r0 + rows, ... of its
// chunk, so its channels and their group indices are fixed for the whole
// block. blockDim.x == vpp * rows, with rows a power of two.

#include "common.cuh"

namespace {

template <typename T, int V>
__global__ void gn_stats_kernel(const T* __restrict__ x, float* __restrict__ ws,
                                long long hw, int c, int g, int chunk_px,
                                int nchunks, int rows) {
  extern __shared__ float part[];  // [2][blockDim.x * V]
  const int vpp = c / V;
  const int t = threadIdx.x;
  const int cvec = t % vpp;
  const int r0 = t / vpp;
  const int b = blockIdx.y;
  const int chunk = blockIdx.x;
  const long long p_begin = static_cast<long long>(chunk) * chunk_px;
  const long long p_end = min(p_begin + chunk_px, hw);
  const T* xb = x + static_cast<long long>(b) * hw * c + cvec * V;

  float s[V], q[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    s[k] = 0.f;
    q[k] = 0.f;
  }
  for (long long p = p_begin + r0; p < p_end; p += rows) {
    const msr::Vec<T, V> v =
        *reinterpret_cast<const msr::Vec<T, V>*>(xb + p * c);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float f = msr::to_float(v.v[k]);
      s[k] += f;
      q[k] += f * f;
    }
  }
  const int n = blockDim.x * V;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    part[t * V + k] = s[k];
    part[n + t * V + k] = q[k];
  }
  __syncthreads();
  // tree over the `rows` threads that share a channel vector; afterwards
  // part[ch] (ch < c) holds channel ch's sum and part[n + ch] its squares
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
  if (t < g) {
    const int cg = c / g;
    float gs = 0.f, gq = 0.f;
    for (int j = 0; j < cg; ++j) {
      gs += part[t * cg + j];
      gq += part[n + t * cg + j];
    }
    float* out = ws + ((static_cast<long long>(b) * nchunks + chunk) * g + t) * 2;
    out[0] = gs;
    out[1] = gq;
  }
}

template <typename T, int V, bool kRes>
__global__ void gn_apply_kernel(const T* __restrict__ x,
                                const T* __restrict__ res,
                                const float* __restrict__ gamma,
                                const float* __restrict__ beta,
                                const float* __restrict__ ws,
                                T* __restrict__ y, long long hw, int c, int g,
                                int chunk_px, int nchunks, int rows, float eps,
                                float slope) {
  extern __shared__ float sh[];  // mean[c], a[c], beta[c], stats[2 * g]
  float* mean_c = sh;
  float* a_c = sh + c;
  float* beta_c = sh + 2 * c;
  float* stats = sh + 3 * c;
  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int cg = c / g;

  if (t < g) {
    // fixed-order sum of this image's chunk partials (double, then the
    // fp32 formula of the reference)
    double s = 0.0, q = 0.0;
    const float* wb = ws + static_cast<long long>(b) * nchunks * g * 2;
    for (int k = 0; k < nchunks; ++k) {
      s += wb[(k * g + t) * 2];
      q += wb[(k * g + t) * 2 + 1];
    }
    const double n = static_cast<double>(hw) * cg;
    const float mean = static_cast<float>(s / n);
    const float var = static_cast<float>(q / n) - mean * mean;
    stats[2 * t] = mean;
    stats[2 * t + 1] = rsqrtf(var + eps);
  }
  __syncthreads();
  for (int ch = t; ch < c; ch += blockDim.x) {
    const int gi = ch / cg;
    mean_c[ch] = stats[2 * gi];
    a_c[ch] = stats[2 * gi + 1] * gamma[ch];
    beta_c[ch] = beta[ch];
  }
  __syncthreads();

  const int vpp = c / V;
  const int cvec = t % vpp;
  const int r0 = t / vpp;
  float m[V], a[V], be[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    m[k] = mean_c[cvec * V + k];
    a[k] = a_c[cvec * V + k];
    be[k] = beta_c[cvec * V + k];
  }
  const long long p_begin = static_cast<long long>(blockIdx.x) * chunk_px;
  const long long p_end = min(p_begin + chunk_px, hw);
  const long long base = static_cast<long long>(b) * hw * c + cvec * V;
  for (long long p = p_begin + r0; p < p_end; p += rows) {
    const long long off = base + p * c;
    const msr::Vec<T, V> v =
        *reinterpret_cast<const msr::Vec<T, V>*>(x + off);
    msr::Vec<T, V> r;
    if (kRes) r = *reinterpret_cast<const msr::Vec<T, V>*>(res + off);
    msr::Vec<T, V> o;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float z = (msr::to_float(v.v[k]) - m[k]) * a[k] + be[k];
      z = z >= 0.f ? z : slope * z;
      if (kRes) z += msr::to_float(r.v[k]);
      o.v[k] = msr::from_float<T>(z);
    }
    *reinterpret_cast<msr::Vec<T, V>*>(y + off) = o;
  }
}

template <typename T, int V>
int launch(const void* x, const void* res, const float* gamma,
           const float* beta, void* y, float* ws, int b, long long hw, int c,
           int g, int chunk_px, int nchunks, int rows, float eps, float slope,
           cudaStream_t stream) {
  const int threads = (c / V) * rows;
  const dim3 grid(nchunks, b);
  const size_t stats_smem = 2 * sizeof(float) * threads * V;
  gn_stats_kernel<T, V><<<grid, threads, stats_smem, stream>>>(
      static_cast<const T*>(x), ws, hw, c, g, chunk_px, nchunks, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t apply_smem = sizeof(float) * (3 * c + 2 * g);
  if (res != nullptr) {
    gn_apply_kernel<T, V, true><<<grid, threads, apply_smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(res), gamma, beta, ws,
        static_cast<T*>(y), hw, c, g, chunk_px, nchunks, rows, eps, slope);
  } else {
    gn_apply_kernel<T, V, false><<<grid, threads, apply_smem, stream>>>(
        static_cast<const T*>(x), nullptr, gamma, beta, ws,
        static_cast<T*>(y), hw, c, g, chunk_px, nchunks, rows, eps, slope);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, res, y: (B, HW, C) channels-last, bf16 (is_bf16) or fp32; res may be
// null. gamma, beta: (C,) fp32. ws: (B, nchunks, G, 2) fp32 scratch.
// vec: elements per vector load (1, or 16 bytes' worth: 4 fp32 / 8 bf16).
extern "C" int msr_gn_leaky_fwd(const void* x, const void* res,
                                const float* gamma, const float* beta, void* y,
                                float* ws, int b, long long hw, int c, int g,
                                int chunk_px, int nchunks, int rows, int vec,
                                int is_bf16, float eps, float slope,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (vec == 8)
      return launch<__nv_bfloat16, 8>(x, res, gamma, beta, y, ws, b, hw, c, g,
                                      chunk_px, nchunks, rows, eps, slope, s);
    return launch<__nv_bfloat16, 1>(x, res, gamma, beta, y, ws, b, hw, c, g,
                                    chunk_px, nchunks, rows, eps, slope, s);
  }
  if (vec == 4)
    return launch<float, 4>(x, res, gamma, beta, y, ws, b, hw, c, g, chunk_px,
                            nchunks, rows, eps, slope, s);
  return launch<float, 1>(x, res, gamma, beta, y, ws, b, hw, c, g, chunk_px,
                          nchunks, rows, eps, slope, s);
}
