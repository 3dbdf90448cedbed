// LayerNorm over the first C channels of rows of Cp >= C bf16 channels,
// written back as rows of Cp with channels C .. Cp - 1 set to zero.
//
// Replaces no TPU kernel: the JAX package has no LayerNorm. SwinIR's served
// forward (models/swinir.py) keeps its C-wide token stream in rows of Cp,
// C rounded up to 8 (180 -> 184 at the published widths), so that every
// row is a whole number of 16-byte vectors and cuBLAS and cuDNN take their
// aligned Hopper kernels. PyTorch's F.layer_norm normalises over the whole
// last axis and cannot leave the pad out, so each LayerNorm of that stream
// (2 a Swin block, the patch norm and the final norm: 74 a forward) is this
// kernel:
//
//   out[c] = (x[c] - mean) * rstd * gamma[c] + beta[c]   for c < C
//   out[c] = 0                                          for C <= c < Cp
//
// with mean and the variance taken in fp32 over the first C channels (two
// passes over the row held in registers), rstd = 1 / sqrt(var + eps), gamma
// and beta fp32, rounded once to bf16. The input's pad is never read into
// the sums.
//
// Bound on the H100: by bytes, rows * 2 * Cp * 2 B (read once, written
// once) at 3.35 TB/s, against ~10 operations an element. So the design
// only keeps HBM busy: 8 threads a row, each with up to kMaxVec 16-byte
// vectors of it (lane, lane + 8, ...), so a warp takes 4 rows and each of
// its loads covers 4 runs of 128 contiguous bytes; the sums are shuffles
// within the 8 lanes of a row. gamma and beta (1.4 kB at C = 180) are read
// through the L1 at each row, not held in registers: held, they spilled
// (80 registers and 240 bytes of stack a thread at Cp = 184). A
// persistent, grid-stride grid of the blocks the card holds at once. No
// shared memory, no scratch buffer, no synchronisation.

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kLanes = 8;                     // threads a row
constexpr int kRowsPerWarp = 32 / kLanes;
constexpr int kMaxVec = 8;                    // vectors a thread: Cp <= 512

template <int NV>
__global__ void __launch_bounds__(kThreads)
    padded_ln_kernel(const bf16* __restrict__ x,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta, bf16* __restrict__ out,
                     long long rows, int C, int Cp, float eps) {
  using Vec = msr::Vec<bf16, 8>;
  const int lane = threadIdx.x % kLanes;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x) / 32;
  const long long step = static_cast<long long>(gridDim.x) * kThreads / 32 *
                         kRowsPerWarp;
  const int nvec = Cp / 8;
  const float inv_c = 1.f / static_cast<float>(C);
  // warp-uniform loop: every lane takes each shuffle
  for (long long r0 = warp * kRowsPerWarp; r0 < rows; r0 += step) {
    const long long row = r0 + threadIdx.x % 32 / kLanes;
    const bool live = row < rows;
    const Vec* xr = reinterpret_cast<const Vec*>(x + row * Cp);
    Vec a[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int vi = lane + v * kLanes;
      if (live && vi < nvec) a[v] = xr[vi];
    }
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = (lane + v * kLanes) * 8 + e;
        if (live && c < C) s += msr::to_float(a[v].v[e]);
      }
    }
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1)
      s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mean = s * inv_c;
    float q = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = (lane + v * kLanes) * 8 + e;
        if (live && c < C) {
          const float d = msr::to_float(a[v].v[e]) - mean;
          q += d * d;
        }
      }
    }
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1)
      q += __shfl_xor_sync(0xffffffffu, q, o);
    const float rstd = rsqrtf(q * inv_c + eps);
    if (!live) continue;
    Vec* orow = reinterpret_cast<Vec*>(out + row * Cp);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int vi = lane + v * kLanes;
      if (vi < nvec) {
        Vec o;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int c = vi * 8 + e;
          o.v[e] = __float2bfloat16(
              c < C ? (msr::to_float(a[v].v[e]) - mean) * rstd *
                              __ldg(gamma + c) + __ldg(beta + c)
                    : 0.f);
        }
        orow[vi] = o;
      }
    }
  }
}

template <int NV>
int launch(const void* x, const float* gamma, const float* beta, void* out,
           long long rows, int c, int cp, float eps, cudaStream_t stream) {
  auto kernel = padded_ln_kernel<NV>;
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
  constexpr int rows_per_block = kThreads / 32 * kRowsPerWarp;
  long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > resident[dev]) blocks = resident[dev];
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), gamma, beta, static_cast<bf16*>(out), rows,
      c, cp, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: rows x cp bf16, contiguous, 16-byte aligned; gamma, beta: (c,)
// fp32. Refuses cp not a multiple of 8 or above 8 * 8 * kMaxVec = 512, c
// outside [1, cp], or a pointer not 16-byte aligned.
extern "C" int msr_padded_layer_norm(const void* x, const float* gamma,
                                     const float* beta, void* out,
                                     long long rows, int c, int cp, float eps,
                                     void* stream) {
  if (rows < 0 || c < 1 || c > cp || cp % 8 || cp > 8 * kLanes * kMaxVec ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((cp / 8 + kLanes - 1) / kLanes) {
    case 1: return launch<1>(x, gamma, beta, out, rows, c, cp, eps, s);
    case 2: return launch<2>(x, gamma, beta, out, rows, c, cp, eps, s);
    case 3: return launch<3>(x, gamma, beta, out, rows, c, cp, eps, s);
    case 4: return launch<4>(x, gamma, beta, out, rows, c, cp, eps, s);
    case 5: return launch<5>(x, gamma, beta, out, rows, c, cp, eps, s);
    case 6: return launch<6>(x, gamma, beta, out, rows, c, cp, eps, s);
    case 7: return launch<7>(x, gamma, beta, out, rows, c, cp, eps, s);
    default: return launch<8>(x, gamma, beta, out, rows, c, cp, eps, s);
  }
}
