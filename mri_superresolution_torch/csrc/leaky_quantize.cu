// Fused LeakyReLU + per-channel symmetric int8 quantize, channels-last:
// kernel B4, two routes in this file.
//
// Replaces the TPU kernel tools/bench_int8_probe4.py (leaky_quantize_pallas,
// body _kernel): q = clip(round(leaky(x, slope) / s[c]), -127, 127) as s8,
// on (N, H, W, C) activations with a (C,) fp32 scale. In the port's int8
// unet it quantizes the input of 13 of the 20 int8 conv sites with slope
// 1.0; at the seven DoubleConv conv2 sites the same arithmetic runs as the
// int8 output of B1's one-pass kernel (groupnorm_onepass.cu, slope 0.2).
// The result equals the plain version code for code.
//
// Bound on the H100: by bytes only if the SMs can issue the work per
// element fast enough. An element moves 3 bytes (2 read, 1 written), so at
// the 3.35 TB/s bound each SM must retire about 4.3 elements a clock, and
// at the 2.53 TB/s a cold copy reaches, about 3.3. The pipes that run MUFU,
// conversions (F2I, F2F) and FRND issue 16 lanes a clock an SM: 3.7-5 such
// instructions an element at those rates. The element kernel below spends
// 4.4 (in its SASS for 8 bf16: the MUFU.RCP inside __fdiv_rn, rintf's
// FRND, the float-to-int cast, the bf16 round trip of x * slope even at
// slope 1.0, and the 64-bit index % C), among 38.5 instructions an element
// against the SM's 128 issue slots a clock: it is bound by issue, not by
// bytes.
//
// The stream kernel (leaky_quantize_stream_kernel) spends none of them per
// element (the arithmetic is quantize.cuh's quant_code): a reciprocal per
// channel and one FMA correction in place of the division, a clamp and one
// FADD of 1.5 * 2^23 in place of rintf and the cast, byte permutes to pack
// the codes, and no LeakyReLU work at all at slope 1.0. A persistent,
// grid-stride grid sized from the occupancy the card reports; each thread
// loads 16 consecutive bf16 as two 16-byte loads (32 bytes in flight) and
// writes one 16-byte store of codes. The grid's step is a multiple of C
// (a power of two up to the kStreamThreads * 16 elements a block covers in
// one step), so a thread's 16 channels never change: their scales and
// reciprocals sit in registers, and no division or scale load happens per
// element. The wrapper (kernels/leaky_quantize.py, _route) sends it bf16 x
// with such a C, 16-byte aligned x and y and n % 16 == 0.
//
// The element kernel (leaky_quantize_kernel) takes every other shape and
// fp32 x: each thread loads one 16-byte vector of x (8 bf16 / 4 fp32) where
// the size and pointers allow it, else one element, takes the channel of
// its first element as (index % C) from the (C,) scale (through the
// read-only cache) and steps it along, and stores its int8 codes in one
// store. Per element, in this order: x * slope rounded to x's type where
// x < 0, an IEEE division by s[c] in fp32 (__fdiv_rn; the build has no
// fast-math), round half to even (rintf), clamp to +-127, cast.

#include "common.cuh"
#include "quantize.cuh"

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

constexpr int kStreamThreads = 256;

// 16 bf16 (two 16-byte loads) -> 16 codes (one 16-byte word)
template <bool kLeaky, bool kFast>
__device__ __forceinline__ uint4 quantize16(uint4 a, uint4 b, float slope,
                                            const float (&s)[16],
                                            const float (&r)[16]) {
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t q[16];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    q[2 * k] = msr::quant_code<kLeaky, kFast>(__uint_as_float(w[k] << 16),
                                              slope, s[2 * k], r[2 * k]);
    q[2 * k + 1] = msr::quant_code<kLeaky, kFast>(
        __uint_as_float(w[k] & 0xFFFF0000u), slope, s[2 * k + 1],
        r[2 * k + 1]);
  }
  return make_uint4(msr::pack_codes(q[0], q[1], q[2], q[3]),
                    msr::pack_codes(q[4], q[5], q[6], q[7]),
                    msr::pack_codes(q[8], q[9], q[10], q[11]),
                    msr::pack_codes(q[12], q[13], q[14], q[15]));
}

template <bool kLeaky, bool kFast>
__device__ __forceinline__ void stream_loop(const uint4* __restrict__ x,
                                            uint4* __restrict__ y,
                                            long long n16, long long i,
                                            long long step, float slope,
                                            const float (&s)[16],
                                            const float (&r)[16]) {
  for (; i < n16; i += step) {
    const uint4 a = __ldg(x + 2 * i);
    const uint4 b = __ldg(x + 2 * i + 1);
    y[i] = quantize16<kLeaky, kFast>(a, b, slope, s, r);
  }
}

// x: n16 * 16 bf16, y: n16 * 16 codes, both 16-byte aligned; c a power of
// two dividing kStreamThreads * 16
template <bool kLeaky>
__global__ void __launch_bounds__(kStreamThreads)
    leaky_quantize_stream_kernel(const uint4* __restrict__ x,
                                 const float* __restrict__ scale,
                                 uint4* __restrict__ y, long long n16, int c,
                                 float slope) {
  const long long i0 = static_cast<long long>(blockIdx.x) * kStreamThreads +
                       threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * kStreamThreads;
  // the channel of the thread's first element, the same at every step
  const int c0 = static_cast<int>((i0 * 16) & (c - 1));
  float s[16], r[16];
  bool fast = true;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    s[k] = __ldg(scale + ((c0 + k) & (c - 1)));
    r[k] = __frcp_rn(s[k]);
    fast = fast && msr::quant_fast_ok(s[k]);
  }
  if (fast)
    stream_loop<kLeaky, true>(x, y, n16, i0, step, slope, s, r);
  else
    stream_loop<kLeaky, false>(x, y, n16, i0, step, slope, s, r);
}

template <bool kLeaky>
int launch_stream(const void* x, const float* scale, void* y, long long n,
                  int c, float slope, cudaStream_t stream) {
  // resident blocks of this instance on the current device, asked once
  static int resident[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, leaky_quantize_stream_kernel<kLeaky>, kStreamThreads, 0);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[dev] = per_sm * sms;
  }
  const long long n16 = n / 16;
  long long blocks = (n16 + kStreamThreads - 1) / kStreamThreads;
  if (blocks > resident[dev]) blocks = resident[dev];
  leaky_quantize_stream_kernel<kLeaky>
      <<<static_cast<unsigned>(blocks), kStreamThreads, 0, stream>>>(
          static_cast<const uint4*>(x), scale, static_cast<uint4*>(y), n16, c,
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

// The stream route. x: n bf16, channels-last (channel = index % c); scale:
// (c,) fp32; y: n int8. Refuses what the stream kernel does not take: n not
// a multiple of 16, x or y not 16-byte aligned, c not a power of two
// dividing 16 * kStreamThreads.
extern "C" int msr_leaky_quantize_stream(const void* x, const float* scale,
                                         void* y, long long n, int c,
                                         float slope, void* stream) {
  const bool c_ok = c >= 1 && (16 * kStreamThreads) % c == 0;
  if (n % 16 || !c_ok || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slope == 1.0f) return launch_stream<false>(x, scale, y, n, c, slope, s);
  return launch_stream<true>(x, scale, y, n, c, slope, s);
}
