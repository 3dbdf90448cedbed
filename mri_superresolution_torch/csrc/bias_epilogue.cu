// A conv's pointwise tail in one pass over its channels-last output: bias,
// ReLU, a scale and a residual add.
//
// Replaces no TPU kernel. On the TPU, XLA fuses a conv's bias, activation
// and residual add into the conv's output. On the card the port's convs are
// cuDNN's (F.conv2d), and PyTorch adds the conv's bias in a pass of its own:
// a broadcast of a (1, C, 1, 1) tensor over the channels-last output, which
// takes its generic, unvectorized elementwise kernel. EDSR's served trunk
// then ran ReLU, the multiply by res_scale and the residual add as further
// passes, up to four a conv. This kernel does that tail once:
//
//   out = [residual +] scale * act(y + bias[c])
//
// in fp32, each operation rounded as fp32 arithmetic rounds it (no FMA
// contraction: __fadd_rn, __fmul_rn), rounded once to the storage type. The
// plain version (kernels/bias_epilogue.py) is the same formula in PyTorch,
// and the kernel equals it bit for bit.
//
// Bound on the H100: by bytes. An element moves 4 bytes in bf16 (y read,
// out written) or 6 with a residual, against a handful of FP32 instructions,
// far below the SM's issue rate. So the design only keeps HBM busy: every
// thread moves 16-byte vectors (8 bf16 / 4 fp32 channels) and keeps kUnroll
// of them (and their residual vectors) in flight; a persistent, grid-stride
// grid of the blocks the card holds at once, with no scratch buffer and no
// synchronisation. The grid's step is a multiple of the C / V vectors of a
// pixel, so a thread's channels never change: its bias values sit in
// registers, loaded once. out may be y (in place): each element is read and
// then written by the same thread.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <typename T, int V, bool kRelu, bool kResidual>
__global__ void __launch_bounds__(kThreads)
    bias_epilogue_kernel(const T* y, const float* __restrict__ bias,
                         const T* residual, T* out, long long n_vec, int cv,
                         float scale) {
  using Vec = msr::Vec<T, V>;
  const long long i0 = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  // the thread's first channel, the same at every step (step % cv == 0)
  const int c0 = static_cast<int>(i0 % cv) * V;
  float b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) b[k] = __ldg(bias + c0 + k);
  const Vec* yv = reinterpret_cast<const Vec*>(y);
  const Vec* rv = reinterpret_cast<const Vec*>(residual);
  Vec* ov = reinterpret_cast<Vec*>(out);
  for (long long i = i0; i < n_vec; i += kUnroll * step) {
    Vec a[kUnroll], r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + u * step;
      if (j < n_vec) {
        a[u] = yv[j];
        if (kResidual) r[u] = rv[j];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + u * step;
      if (j < n_vec) {
        Vec o;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          float t = __fadd_rn(msr::to_float(a[u].v[k]), b[k]);
          if (kRelu) t = t < 0.f ? 0.f : t;  // NaN stays NaN, as torch.relu
          t = __fmul_rn(scale, t);
          if (kResidual) t = __fadd_rn(msr::to_float(r[u].v[k]), t);
          o.v[k] = msr::from_float<T>(t);
        }
        ov[j] = o;
      }
    }
  }
}

long long gcd_ll(long long a, long long b) {
  while (b) {
    const long long t = a % b;
    a = b;
    b = t;
  }
  return a;
}

template <typename T, bool kRelu, bool kResidual>
int launch(const void* y, const float* bias, const void* residual, void* out,
           long long n, int c, float scale, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  auto kernel = bias_epilogue_kernel<T, V, kRelu, kResidual>;
  // resident blocks of this instance on the current device, asked once
  static int resident[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[dev] = per_sm * sms;
  }
  const long long n_vec = n / V;
  const int cv = c / V;
  // blocks a multiple of m, so that the grid's step is a multiple of cv
  const long long m = cv / gcd_ll(cv, kThreads);
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > resident[dev]) blocks = resident[dev];
  blocks = blocks < m ? m : blocks / m * m;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(y), bias, static_cast<const T*>(residual),
      static_cast<T*>(out), n_vec, cv, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* y, const float* bias, const void* residual,
             void* out, long long n, int c, int relu, float scale,
             cudaStream_t s) {
  if (residual != nullptr) {
    if (relu) return launch<T, true, true>(y, bias, residual, out, n, c,
                                           scale, s);
    return launch<T, false, true>(y, bias, residual, out, n, c, scale, s);
  }
  if (relu) return launch<T, true, false>(y, bias, residual, out, n, c,
                                          scale, s);
  return launch<T, false, false>(y, bias, residual, out, n, c, scale, s);
}

}  // namespace

// y, out (and residual, if not null): n elements, channels-last (channel =
// index % c), bf16 (is_bf16) or fp32, 16-byte aligned; out may be y. bias:
// (c,) fp32. Refuses c not a multiple of 8, n not a multiple of c, or a
// pointer not 16-byte aligned.
extern "C" int msr_bias_epilogue(const void* y, const float* bias,
                                 const void* residual, void* out, long long n,
                                 int c, int is_bf16, int relu, float scale,
                                 void* stream) {
  if (c < 8 || c % 8 || n % c || reinterpret_cast<uintptr_t>(y) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(residual) % 16)
    return cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(y, bias, residual, out, n, c, relu, scale,
                                   s);
  return dispatch<float>(y, bias, residual, out, n, c, relu, scale, s);
}
