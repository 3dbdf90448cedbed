// Fused LeakyReLU + per-channel symmetric int8 quantize, channels-last.
//
// Replaces the TPU kernel tools/bench_int8_probe4.py (leaky_quantize_pallas,
// body _kernel): q = clip(round(leaky(x, slope) / s[c]), -127, 127) as s8,
// on (N, H, W, C) activations with a (C,) fp32 scale. In the port's int8
// unet it is the quantize of every int8 conv site, 20 per forward: slope
// 0.2 where it also applies the LeakyReLU a GroupNorm left owing (the
// DoubleConv conv2 sites), slope 1.0 (a plain quantize) elsewhere.
//
// Per element, in this order, so that the result equals the plain version
// code for code: x * slope rounded to x's type where x < 0 (LeakyReLU on a
// bf16 tensor), an IEEE division by s[c] in fp32 (__fdiv_rn; the build has
// no fast-math), round half to even (rintf), clamp to +-127, cast.
//
// Bound on the H100: bytes. A few flops per element against 3 bytes moved
// (2 read, 1 written) for bf16. The TPU kernel viewed the tensor as
// (H, W*C) rows with the scale pre-tiled to a (W*C,) row to fill the
// 128-lane vector unit; that is a TPU layout trick and is not kept. Here the
// tensor is one flat stream: each thread loads one 16-byte vector of x
// (8 bf16 / 4 fp32) where the size and pointers allow it, else one element,
// takes the channel of its first element as (index % C) from the (C,)
// scale (through the read-only cache) and steps it along, and stores its
// int8 codes in one store.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ int8_t quantize_one(T v, float slope, float s) {
  float f = msr::to_float(v);
  if (f < 0.f) f = msr::to_float(msr::from_float<T>(f * slope));
  const float q = fminf(fmaxf(rintf(__fdiv_rn(f, s)), -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(q));
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    leaky_quantize_kernel(const T* __restrict__ x,
                          const float* __restrict__ scale,
                          int8_t* __restrict__ y, long long n_vec, int c,
                          float slope) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n_vec) return;
  const long long e0 = i * V;
  int ch = static_cast<int>(e0 % c);
  const msr::Vec<T, V> v = *reinterpret_cast<const msr::Vec<T, V>*>(x + e0);
  msr::Vec<int8_t, V> o;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    o.v[k] = quantize_one(v.v[k], slope, __ldg(scale + ch));
    if (++ch == c) ch = 0;
  }
  *reinterpret_cast<msr::Vec<int8_t, V>*>(y + e0) = o;
}

template <typename T, int V>
int launch(const void* x, const float* scale, void* y, long long n, int c,
           float slope, cudaStream_t stream) {
  const long long n_vec = n / V;
  const long long blocks = (n_vec + kThreads - 1) / kThreads;
  leaky_quantize_kernel<T, V><<<static_cast<unsigned>(blocks), kThreads, 0,
                                stream>>>(static_cast<const T*>(x), scale,
                                          static_cast<int8_t*>(y), n_vec, c,
                                          slope);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: n elements, channels-last (channel = index % c), bf16 (is_bf16) or
// fp32; scale: (c,) fp32; y: n int8. vec: elements per thread, 1 or one
// 16-byte vector's worth (8 bf16 / 4 fp32); with vec > 1 the wrapper
// guarantees n % vec == 0, x 16-byte and y vec-byte aligned.
extern "C" int msr_leaky_quantize(const void* x, const float* scale, void* y,
                                  long long n, int c, int vec, int is_bf16,
                                  float slope, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (is_bf16) {
    if (vec == 8)
      return launch<__nv_bfloat16, 8>(x, scale, y, n, c, slope, s);
    return launch<__nv_bfloat16, 1>(x, scale, y, n, c, slope, s);
  }
  if (vec == 4) return launch<float, 4>(x, scale, y, n, c, slope, s);
  return launch<float, 1>(x, scale, y, n, c, slope, s);
}
