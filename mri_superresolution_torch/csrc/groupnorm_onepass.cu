// One-pass fused GroupNorm + LeakyReLU (+ residual) on channels-last
// activations: each image is staged on chip, so x is read from HBM once.
//
// Replaces the TPU kernel mri_superresolution_tpu/experiments/
// groupnorm_pallas.py (_pallas_forward / _make_kernel, API
// fused_group_norm_leaky), as groupnorm_leaky.cu does, with the same
// arithmetic: y = leaky(GN_G(x) * gamma + beta) [+ res], fp32 statistics
// (mean, then E[x^2] - mean^2), eps added to the variance, fp32 affine and
// activation, one cast back to x's type.
//
// Bound on the H100: bytes. The work is a few flops per element, and the
// bound is one read of x (and of the residual) and one write of y. The TPU
// kernel met it by holding the whole image in VMEM. No block can hold an
// image here (a 512^2 x 16 bf16 image is 8.4 MB, a block gets 227 KB), and
// groupnorm_leaky.cu reads x twice (a stats pass, then an apply pass):
// three passes of bytes against the bound's two. But the SMs together hold
// 132 x 227 KB, about 29 MB, so a few whole images fit on chip at once:
//   - A persistent grid of one block per SM (the dynamic shared memory is
//     the card's per-block maximum), launched with the cooperative
//     attribute, so the runtime refuses a grid that cannot be co-resident
//     instead of letting it hang.
//   - Waves of whole images. Wave w holds images w * ipw .. w * ipw +
//     ipw - 1; each image is cut into `ranges` contiguous pixel ranges of
//     chunk_px pixels (the last may be shorter), one per block: block j
//     stages range j % ranges of image w * ipw + j / ranges. In channels-
//     last a pixel range is one contiguous byte range. The host plans the
//     waves (kernels/groupnorm.py, _plan_onepass).
//   - Staging: thread 0 copies the block's range into shared memory with
//     1D bulk copies (cp.async.bulk, the TMA; no tensor map), in pieces of
//     32 KB, each completing on its own mbarrier.
//   - Statistics from shared memory, each piece as it lands: each thread
//     sums fixed channels over a fixed stride of pixels, warp shuffles add
//     the threads of the same channels, and one warp per group adds the
//     rows of partials in a fixed order. The block writes fp32 (sum, sum
//     of squares) per group to a workspace.
//   - One exchange per image: the block arrives on its image's counter
//     (release) and waits until all `ranges` blocks of that image have
//     arrived (acquire). A block waits for its own image only, so images
//     finish independently and a block starts its next wave at once. A
//     second counter lets the last block to leave reset both to zero, so
//     the next launch (or CUDA graph replay) finds them clean with no
//     memset.
//   - One finalize per image and block: a warp per group sums the image's
//     partials in double, each lane a fixed stride, then a fixed shuffle
//     tree; then the reference's fp32 formula and rsqrtf(var + eps).
//   - Apply from the staged copy, piece by piece: affine, LeakyReLU, the
//     residual (read from HBM here), one cast, 16-byte stores. As soon as
//     a piece has been read, thread 0 starts the copy of the block's next
//     wave into it, so that wave's loads fly while this one's stores drain
//     and HBM sees reads and writes together; only the exchange and the
//     finalize leave it idle.
// int8 output (kQuant; bf16 x, no residual): kernel B4's work at the unet's
// seven DoubleConv conv2 sites, done in the apply loop instead of in a
// second pass. Each fp32 z is cast to bf16 exactly as above (the GroupNorm's
// own LeakyReLU is not applied: those sites call it with slope 1.0), then
// goes through quantize.cuh's quant_code (LeakyReLU in bf16 at `slope`,
// per-channel int8 quantize), and 8 codes a vector are stored. The result
// equals B1 at slope 1.0 followed by B4, code for code, and saves the bf16
// tensor between them: 4 of the 7 bytes an element that the two kernels
// move, and a launch.
// Every sum runs in a fixed order, so results do not change from run to
// run. The wrapper takes this kernel where x, y (and the residual) are
// 16-byte aligned, C / V is a power of two and one image fits on chip;
// other shapes take groupnorm_leaky.cu.

#include "common.cuh"
#include "quantize.cuh"
#include "staging.cuh"

namespace {

using msr::kPieceBytes;
using msr::Layout;

constexpr int kThreads = msr::kStageThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 256;
constexpr int kPartEntries = 1024;     // float2 partial (sum, squares)
// the stage moves in pieces of 32 KB (staging.cuh), each on its own
// mbarrier
constexpr int kMaxPieces = 8;
// dynamic shared memory: mbarriers | stats[kMaxGroups] | part | stage
constexpr int kStatsOff = 128;
constexpr int kPartOff = kStatsOff + 8 * kMaxGroups;
constexpr int kStageOff = kPartOff + 8 * kPartEntries;
static_assert(kStageOff % 128 == 0, "stage alignment");
static_assert(8 * kMaxPieces <= kStatsOff, "mbarriers");

template <typename T, int V, bool kRes, bool kQuant>
__global__ void __launch_bounds__(kThreads, 1)
    gn_onepass_kernel(const T* __restrict__ x, const T* __restrict__ res,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta,
                      const float* __restrict__ qscale, void* __restrict__ yv,
                      float* __restrict__ ws, unsigned* __restrict__ cnt,
                      int b, long long hw, int c, int g, int chunk_px,
                      int ranges, int ipw, int waves, float eps,
                      float slope) {
  using Vec = msr::Vec<T, V>;
  static_assert(!kQuant || (V == 8 && !kRes), "int8 output: bf16, no res");
  extern __shared__ __align__(128) unsigned char smem[];
  float2* stats = reinterpret_cast<float2*>(smem + kStatsOff);
  float2* part = reinterpret_cast<float2*>(smem + kPartOff);
  const Vec* stage = reinterpret_cast<const Vec*>(smem + kStageOff);
  const uint32_t bars = msr::smem_addr(smem);
  const uint32_t dst = msr::smem_addr(stage);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const Layout L(c, g, V);
  const int cvec = t % L.vpp, r0 = t / L.vpp;
  const int slot = blockIdx.x / ranges, rng = blockIdx.x % ranges;
  if (slot >= b) return;
  const long long p0 = static_cast<long long>(rng) * chunk_px;
  const int n_px = static_cast<int>(
      p0 + chunk_px <= hw ? chunk_px : hw - p0);
  const uint32_t bytes = static_cast<uint32_t>(n_px) * c * sizeof(T);
  const int pieces = (bytes + kPieceBytes - 1) / kPieceBytes;
  const int piece_px = 4 * L.rows;
  const long long img_elems = hw * c;

  float gam[V], bet[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    gam[k] = gamma[cvec * V + k];
    bet[k] = beta[cvec * V + k];
  }
  // int8 output: each channel's scale and reciprocal, once
  float qs[V], qr[V];
  bool qfast = true;
  if constexpr (kQuant) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      qs[k] = qscale[cvec * V + k];
      qr[k] = __frcp_rn(qs[k]);
      qfast = qfast && msr::quant_fast_ok(qs[k]);
    }
  }
  if (t == 0) {
    for (int i = 0; i < pieces; ++i) msr::mbar_init(bars + 8 * i);
    for (int i = 0; i < pieces; ++i)
      msr::stage_piece(x + slot * img_elems + p0 * c, dst, bytes, i,
                       bars + 8 * i);
  }
  __syncthreads();

  for (int w = 0; w < waves; ++w) {
    const int img = w * ipw + slot;
    if (img >= b) break;
    const bool next = img + ipw < b;
    const long long base = img * img_elems + p0 * c;

    // per-thread sums of its V channels as the pieces land
    float s[V], q[V];
#pragma unroll
    for (int k = 0; k < V; ++k) s[k] = q[k] = 0.f;
    for (int i = 0; i < pieces; ++i) {
      msr::mbar_wait(bars + 8 * i, w & 1);
      const int end = min((i + 1) * piece_px, n_px);
      for (int p = i * piece_px + r0; p < end; p += L.rows) {
        const Vec v = stage[p * L.vpp + cvec];
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float f = msr::to_float(v.v[k]);
          s[k] += f;
          q[k] += f * f;
        }
      }
    }
    if (L.fold) {
#pragma unroll
      for (int k = 1; k < V; ++k) {
        s[0] += s[k];
        q[0] += q[k];
      }
    }
    // lanes l and l ^ off (off a multiple of vpp) share their channels
    for (int off = 16; off >= L.vpp; off >>= 1) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (k == 0 || !L.fold) {
          s[k] += __shfl_xor_sync(0xffffffffu, s[k], off);
          q[k] += __shfl_xor_sync(0xffffffffu, q[k], off);
        }
      }
    }
    if (L.vpp >= 32 || lane < L.vpp) {
      float2* pr = part + (t / L.span) * L.ent;
      if (L.fold) {
        pr[cvec] = make_float2(s[0], q[0]);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) pr[cvec * V + k] = make_float2(s[k], q[k]);
      }
    }
    __syncthreads();
    for (int gi = warp; gi < g; gi += kWarps) {
      float a = 0.f, a2 = 0.f;
      const int n = L.prow * L.per_group;
      for (int i = lane; i < n; i += 32) {
        const float2 v = part[(i / L.per_group) * L.ent + gi * L.per_group +
                              i % L.per_group];
        a += v.x;
        a2 += v.y;
      }
      for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        a2 += __shfl_xor_sync(0xffffffffu, a2, off);
      }
      if (lane == 0) {
        float* out = ws + ((static_cast<long long>(img) * ranges + rng) * g +
                           gi) * 2;
        out[0] = a;
        out[1] = a2;
        __threadfence();
      }
    }
    __syncthreads();

    // the exchange: wait for every block of this image
    if (t == 0)
      msr::image_exchange(cnt + 2 * static_cast<long long>(img), ranges);
    __syncthreads();

    // finalize: mean and rstd of each group of this image
    for (int gi = warp; gi < g; gi += kWarps) {
      double a = 0.0, a2 = 0.0;
      for (int j = lane; j < ranges; j += 32) {
        const float* e =
            ws + ((static_cast<long long>(img) * ranges + j) * g + gi) * 2;
        a += __ldcg(e);
        a2 += __ldcg(e + 1);
      }
      for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        a2 += __shfl_xor_sync(0xffffffffu, a2, off);
      }
      if (lane == 0) {
        const double n = static_cast<double>(hw) * L.cg;
        const float mean = static_cast<float>(a / n);
        const float var = static_cast<float>(a2 / n) - mean * mean;
        stats[gi] = make_float2(mean, rsqrtf(var + eps));
      }
    }
    __syncthreads();

    // apply from the staged copy, a piece at a time (each thread 4 pixels
    // of it); once a piece is read, the next wave's copy of it starts
    float m[V], sc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float2 st = stats[(cvec * V + k) / L.cg];
      m[k] = st.x;
      sc[k] = st.y * gam[k];
    }
    const long long col = base + cvec * V;
    for (int i = 0; i < pieces; ++i) {
      const int p = i * piece_px + r0;
      Vec r[4];
      if (kRes) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int pp = p + u * L.rows;
          if (pp < n_px)
            r[u] = *reinterpret_cast<const Vec*>(
                res + col + static_cast<long long>(pp) * c);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int pp = p + u * L.rows;
        if (pp < n_px) {
          const Vec v = stage[pp * L.vpp + cvec];
          const long long at = col + static_cast<long long>(pp) * c;
          if constexpr (kQuant) {
            float zb[V];
#pragma unroll
            for (int k = 0; k < V; ++k) {
              const float z = (msr::to_float(v.v[k]) - m[k]) * sc[k] + bet[k];
              zb[k] = msr::to_float(msr::from_float<T>(z));
            }
            uint32_t q[V];
            if (qfast) {
#pragma unroll
              for (int k = 0; k < V; ++k)
                q[k] = msr::quant_code<true, true>(zb[k], slope, qs[k], qr[k]);
            } else {
#pragma unroll
              for (int k = 0; k < V; ++k)
                q[k] = msr::quant_code<true, false>(zb[k], slope, qs[k],
                                                    qr[k]);
            }
            *reinterpret_cast<uint2*>(static_cast<int8_t*>(yv) + at) =
                make_uint2(msr::pack_codes(q[0], q[1], q[2], q[3]),
                           msr::pack_codes(q[4], q[5], q[6], q[7]));
          } else {
            Vec o;
#pragma unroll
            for (int k = 0; k < V; ++k) {
              float z = (msr::to_float(v.v[k]) - m[k]) * sc[k] + bet[k];
              z = z >= 0.f ? z : slope * z;
              if (kRes) z += msr::to_float(r[u].v[k]);
              o.v[k] = msr::from_float<T>(z);
            }
            *reinterpret_cast<Vec*>(static_cast<T*>(yv) + at) = o;
          }
        }
      }
      __syncthreads();
      if (t == 0 && next) {
        // this wave's reads of the piece come before the copy's writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        msr::stage_piece(x + base + ipw * img_elems, dst, bytes, i,
                       bars + 8 * i);
      }
    }
  }
}

template <typename T, int V, bool kRes, bool kQuant = false>
cudaError_t prepare(int smem, int* per_sm) {
  auto kernel = gn_onepass_kernel<T, V, kRes, kQuant>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                       kThreads, smem);
}

template <typename T, int V, bool kRes, bool kQuant = false>
int launch(const void* x, const void* res, const float* gamma,
           const float* beta, const float* qscale, void* y, float* ws, unsigned* cnt, int b,
           long long hw, int c, int g, int chunk_px, int ranges, int ipw,
           int waves, int stage_bytes, float eps, float slope,
           cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranges * ipw);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kStageOff + stage_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, gn_onepass_kernel<T, V, kRes, kQuant>, static_cast<const T*>(x),
      static_cast<const T*>(res), gamma, beta, qscale, y, ws, cnt, b,
      hw, c, g, chunk_px, ranges, ipw, waves, eps, slope);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Blocks of the one-pass kernel that are co-resident on the current device
// (one per SM) and the bytes of shared memory each can stage. Raises every
// instance's dynamic shared memory to the card's per-block maximum; call it
// once per device before the first launch.
extern "C" int msr_gn_onepass_capacity(int* n_blocks, int* stage_bytes) {
  int dev = 0, optin = 0, sms = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop || optin <= kStageOff) return cudaErrorNotSupported;
  const int smem = optin / 16 * 16;
  int per_sm = 1 << 30;
  int n = 0;
  cudaError_t (*instances[])(int, int*) = {
      prepare<float, 4, false>, prepare<float, 4, true>,
      prepare<__nv_bfloat16, 8, false>, prepare<__nv_bfloat16, 8, true>,
      prepare<__nv_bfloat16, 8, false, true>};
  for (auto fn : instances) {
    e = fn(smem, &n);
    if (e != cudaSuccess) return static_cast<int>(e);
    per_sm = n < per_sm ? n : per_sm;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *n_blocks = per_sm * sms;
  *stage_bytes = smem - kStageOff;
  return 0;
}

// x, res, y: (B, HW, C) channels-last, bf16 (is_bf16) or fp32, 16-byte
// aligned; res may be null. gamma, beta: (C,) fp32. qscale: null, or (C,)
// fp32 int8 scales: then x is bf16, res null, y (B, HW, C) int8 codes,
// 8-byte aligned, and slope is the quantize's LeakyReLU (the GroupNorm's
// own is not applied). ws: (B, ranges, G, 2) fp32 scratch. cnt: 2 * B unsigned counters, zero on entry and on exit.
// The plan (chunk_px, ranges, ipw, waves) is _plan_onepass's; stage_bytes
// is msr_gn_onepass_capacity's. Refuses a layout the kernel does not take.
extern "C" int msr_gn_onepass_fwd(const void* x, const void* res,
                                  const float* gamma, const float* beta,
                                  const float* qscale, void* y, float* ws,
                                  unsigned* cnt, int b, long long hw, int c,
                                  int g, int chunk_px, int ranges, int ipw,
                                  int waves,
                                  int stage_bytes, int is_bf16, float eps,
                                  float slope, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int v = is_bf16 ? 8 : 4;
  const int esize = is_bf16 ? 2 : 4;
  if (b <= 0 || hw <= 0 || c % v || g <= 0 || g > kMaxGroups || c % g)
    return cudaErrorInvalidValue;
  const Layout L(c, g, v);
  if ((L.vpp & (L.vpp - 1)) || L.vpp > kThreads ||
      (L.cg % v && v % L.cg) || L.prow * L.ent > kPartEntries ||
      static_cast<long long>(chunk_px) * c * esize > stage_bytes ||
      static_cast<long long>(chunk_px) * c * esize >
          static_cast<long long>(kMaxPieces) * kPieceBytes ||
      static_cast<long long>(chunk_px) * ranges < hw ||
      static_cast<long long>(ipw) * waves < b)
    return cudaErrorInvalidValue;
  if (qscale != nullptr) {
    if (!is_bf16 || res != nullptr) return cudaErrorInvalidValue;
    return launch<__nv_bfloat16, 8, false, true>(
        x, res, gamma, beta, qscale, y, ws, cnt, b, hw, c, g, chunk_px, ranges,
        ipw, waves, stage_bytes, eps, slope, s);
  }
  if (is_bf16) {
    if (res != nullptr)
      return launch<__nv_bfloat16, 8, true>(x, res, gamma, beta, qscale, y,
                                            ws, cnt, b, hw, c, g, chunk_px,
                                            ranges, ipw, waves, stage_bytes,
                                            eps, slope, s);
    return launch<__nv_bfloat16, 8, false>(x, res, gamma, beta, qscale, y, ws,
                                           cnt, b, hw, c, g, chunk_px, ranges,
                                           ipw, waves, stage_bytes, eps, slope,
                                           s);
  }
  if (res != nullptr)
    return launch<float, 4, true>(x, res, gamma, beta, qscale, y, ws, cnt, b,
                                  hw, c, g, chunk_px, ranges, ipw, waves,
                                  stage_bytes, eps, slope, s);
  return launch<float, 4, false>(x, res, gamma, beta, qscale, y, ws, cnt, b,
                                 hw, c, g, chunk_px, ranges, ipw, waves,
                                 stage_bytes, eps, slope, s);
}
