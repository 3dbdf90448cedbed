// One-pass backward of fused GroupNorm + LeakyReLU on channels-last
// activations: the gradient of kernel B1, with each image's x and g staged
// on chip, so that both are read from HBM once, in one launch.
//
// Replaces the backward of the TPU kernel mri_superresolution_tpu/
// experiments/groupnorm_pallas.py (`_backward`, the custom_vjp of
// fused_group_norm_leaky), as groupnorm_bwd.cu does, with the same
// arithmetic and the same bits of mean, rstd and z (that file's note says
// what is computed and why the bits of the LeakyReLU mask matter).
//
// Bound on the H100: bytes. The function reads x and g once and writes dx
// once (6 bytes an element in bf16) with about 20 flops an element.
// groupnorm_bwd.cu takes four launches a call and reads x three times and
// g twice. This kernel is laid out as B1's one-pass forward
// (groupnorm_onepass.cu, whose note says more):
//   - A persistent grid of one block per SM, launched with the cooperative
//     attribute, in waves of whole images (kernels/groupnorm.py plans them
//     with _plan_onepass from the bytes a block can stage of each tensor):
//     block j stages range j % ranges of image w * ipw + j / ranges, of x
//     and of g (g's at stage_bytes into the stage), in 32 KB pieces, each
//     on its own mbarrier, x's copies issued first.
//   - (a) Statistics from the staged x as its pieces land: per-thread sums
//     in double, warp shuffles, rows of partials summed in a fixed order,
//     (sum, sum of squares) per group and block to the workspace.
//     Exchange 1: each block arrives on the image's counter and waits for
//     all `ranges` (staging.cuh). Every block of the image sums the image's
//     partials in the same fixed order and rounds mean and rstd once, as
//     groupnorm_bwd.cu's image_stats does.
//   - (b) Per channel, partial sums of dz and dz * xhat from the staged x
//     and g, to the workspace. Exchange 2, on the same counter (2 * ranges
//     arrivals). Every block sums them over the image in double in a fixed
//     order and forms each group's m1 and m2 as groupnorm_bwd.cu's
//     gnb_reduce does; the image's first block writes the image's channel
//     sums to the workspace and arrives on the grid's counter.
//   - (c) dx from the staged copy, 16-byte stores. As soon as a piece of x
//     and g has been read, thread 0 starts the copy of the block's next
//     wave into it.
//   - The last of the image's blocks to leave its exchanges resets its
//     counters, and the last image's first block to arrive on the grid's
//     counter sums the images' channel sums into dgamma and dbeta in a
//     fixed order and resets that counter: the next launch, or CUDA graph
//     replay, finds them at zero. Each decision reads an atomic's result
//     issued before (c), so no round trip to L2 waits on the way.
// No float atomics, every sum in a fixed order: two calls give the same
// bits. The wrapper takes this kernel where x, g and dx are 16-byte
// aligned, C <= 256 channels split into 16-byte vectors in a power-of-two
// count, and one image's x and g fit on chip; other shapes take
// groupnorm_bwd.cu.

#include "common.cuh"
#include "staging.cuh"

// Phase marks for tools/bwd_phases.py, compiled in only with
// -DMSR_PHASE_MARKS: thread 0 of each of the first 132 blocks records
// clock64() at 12 points of its first two waves, and %globaltimer at its
// start and end. Without the macro they compile to nothing.
#ifdef MSR_PHASE_MARKS
__device__ unsigned long long msr_phase_marks[132 * 2 * 16];
extern "C" int msr_phase_marks_read(void* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, msr_phase_marks,
                                               sizeof(msr_phase_marks)));
}
#define PHASE_MARK(w, k)                                               \
  do {                                                                 \
    if (threadIdx.x == 0 && blockIdx.x < 132 && (w) < 2)               \
      msr_phase_marks[(blockIdx.x * 2 + (w)) * 16 + (k)] = clock64(); \
  } while (0)
#define PHASE_TIME(k)                                                 \
  do {                                                                \
    unsigned long long ns;                                            \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));            \
    if (threadIdx.x == 0 && blockIdx.x < 132)                         \
      msr_phase_marks[blockIdx.x * 2 * 16 + (k)] = ns;                \
  } while (0)
#else
#define PHASE_MARK(w, k) \
  do {                   \
  } while (0)
#define PHASE_TIME(k) \
  do {                \
  } while (0)
#endif

namespace {

using msr::kPieceBytes;
using msr::Layout;

constexpr int kThreads = msr::kStageThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChannels = 256;
constexpr int kMaxPieces = 4;          // of each of x and g
constexpr int kPartBytes = 32768;      // the rows of partials
// dynamic shared memory: mbarriers (x's pieces, then g's) and the last
// block's flag | (mean, rstd) and (m1, m2) per group | gamma-weighted image
// sums per channel (double) | part | stage: x's range, then g's
constexpr int kFlagOff = 8 * 2 * kMaxPieces;
constexpr int kStatsOff = 128;
constexpr int kMomOff = kStatsOff + 8 * kMaxChannels;
constexpr int kSumOff = kMomOff + 8 * kMaxChannels;
constexpr int kPartOff = kSumOff + 16 * kMaxChannels;
constexpr int kStageOff = kPartOff + kPartBytes;
static_assert(kStageOff % 128 == 0, "stage alignment");
static_assert(kFlagOff + 4 <= kStatsOff, "mbarriers");

// Whether the kernel takes c channels in g groups with V-wide vectors.
bool layout_ok(int c, int g, int v) {
  if (c <= 0 || c % v || c > kMaxChannels || g <= 0 || c % g) return false;
  const Layout L(c, g, v);
  return !(L.vpp & (L.vpp - 1)) && (L.cg % v == 0 || v % L.cg == 0) &&
         L.prow * L.ent * 16 <= kPartBytes && L.prow * c * 8 <= kPartBytes;
}

// xhat and dz of one element, rounded op by op as the plain version (as
// groupnorm_bwd.cu's xhat_dz).
__device__ __forceinline__ void xhat_dz(float xv, float gv, float m, float r,
                                        float ga, float be, float slope,
                                        float* xhat, float* dz) {
  const float xh = __fmul_rn(__fsub_rn(xv, m), r);
  const float z = __fadd_rn(__fmul_rn(xh, ga), be);
  *xhat = xh;
  *dz = z >= 0.f ? gv : __fmul_rn(gv, slope);
}

// dgamma and dbeta from the images' channel sums (dz, dz * xhat), summed
// over the images in order, 8 loaded at a time. Run by every thread of the
// last block to arrive on the grid's counter.
__device__ void sum_over_images(const float2* __restrict__ ws_img, int b,
                                int c, float* __restrict__ dgamma,
                                float* __restrict__ dbeta) {
  __threadfence();
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    double a = 0.0, a2 = 0.0;
    for (int i0 = 0; i0 < b; i0 += 8) {
      float2 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (i0 + u < b)
          v[u] = __ldcg(ws_img + static_cast<long long>(i0 + u) * c + ch);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (i0 + u < b) {
          a += v[u].x;
          a2 += v[u].y;
        }
      }
    }
    dbeta[ch] = static_cast<float>(a);
    dgamma[ch] = static_cast<float>(a2);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 1)
    gn_onepass_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta, T* __restrict__ dx,
                          float* __restrict__ dgamma,
                          float* __restrict__ dbeta,
                          double2* __restrict__ ws_stats,
                          float2* __restrict__ ws_part,
                          float2* __restrict__ ws_img,
                          unsigned* __restrict__ cnt, int b, long long hw,
                          int c, int g, int chunk_px, int ranges, int ipw,
                          int waves, int stage_bytes, float eps,
                          float slope) {
  PHASE_TIME(14);
  PHASE_MARK(0, 0);
  using Vec = msr::Vec<T, V>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned* last = reinterpret_cast<unsigned*>(smem + kFlagOff);
  float2* stats = reinterpret_cast<float2*>(smem + kStatsOff);
  float2* moms = reinterpret_cast<float2*>(smem + kMomOff);
  double2* csum = reinterpret_cast<double2*>(smem + kSumOff);
  double2* part_a = reinterpret_cast<double2*>(smem + kPartOff);
  float2* part_b = reinterpret_cast<float2*>(smem + kPartOff);
  const Vec* xs = reinterpret_cast<const Vec*>(smem + kStageOff);
  const Vec* gs = reinterpret_cast<const Vec*>(smem + kStageOff +
                                               stage_bytes);
  const uint32_t bars = msr::smem_addr(smem);
  const uint32_t gbars = bars + 8 * kMaxPieces;
  const uint32_t xdst = msr::smem_addr(xs), gdst = msr::smem_addr(gs);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const Layout L(c, g, V);
  const int cvec = t % L.vpp, r0 = t / L.vpp;
  const int slot = blockIdx.x / ranges, rng = blockIdx.x % ranges;
  const long long p0 = static_cast<long long>(rng) * chunk_px;
  const int n_px = static_cast<int>(
      p0 + chunk_px <= hw ? chunk_px : hw - p0);
  const uint32_t bytes = static_cast<uint32_t>(n_px) * c * sizeof(T);
  const int pieces = (bytes + kPieceBytes - 1) / kPieceBytes;
  const int piece_px = 4 * L.rows;
  const long long img_elems = hw * c;
  const double n = static_cast<double>(hw) * L.cg;
  // threads a channel in the sums over the image's ranges (c divides 512)
  const int parts = kThreads / c;

  float gam[V], bet[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    gam[k] = gamma[cvec * V + k];
    bet[k] = beta[cvec * V + k];
  }
  if (t == 0) {
    for (int i = 0; i < pieces; ++i) {
      msr::mbar_init(bars + 8 * i);
      msr::mbar_init(gbars + 8 * i);
    }
    const long long first = slot * img_elems + p0 * c;
    for (int i = 0; i < pieces; ++i)
      msr::stage_piece(x + first, xdst, bytes, i, bars + 8 * i);
    for (int i = 0; i < pieces; ++i)
      msr::stage_piece(gy + first, gdst, bytes, i, gbars + 8 * i);
  }
  __syncthreads();

  for (int w = 0; w < waves; ++w) {
    const int img = w * ipw + slot;
    if (img >= b) break;
    const bool next = img + ipw < b;
    const long long base = img * img_elems + p0 * c;
    const long long at = static_cast<long long>(img) * ranges + rng;

    // (a) per-thread sums of x and x^2 in double as x's pieces land
    double s[V], q[V];
#pragma unroll
    for (int k = 0; k < V; ++k) s[k] = q[k] = 0.0;
    for (int i = 0; i < pieces; ++i) {
      msr::mbar_wait(bars + 8 * i, w & 1);
      const int end = min((i + 1) * piece_px, n_px);
      for (int p = i * piece_px + r0; p < end; p += L.rows) {
        const Vec v = xs[p * L.vpp + cvec];
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const double f = msr::to_float(v.v[k]);
          s[k] += f;
          q[k] += f * f;
        }
      }
    }
    PHASE_MARK(w, 1);
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
      double2* pr = part_a + (t / L.span) * L.ent;
      if (L.fold) {
        pr[cvec] = make_double2(s[0], q[0]);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) pr[cvec * V + k] = make_double2(s[k], q[k]);
      }
    }
    __syncthreads();
    for (int gi = warp; gi < g; gi += kWarps) {
      double a = 0.0, a2 = 0.0;
      const int entries = L.prow * L.per_group;
      for (int i = lane; i < entries; i += 32) {
        const double2 v = part_a[(i / L.per_group) * L.ent +
                                 gi * L.per_group + i % L.per_group];
        a += v.x;
        a2 += v.y;
      }
      for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        a2 += __shfl_xor_sync(0xffffffffu, a2, off);
      }
      if (lane == 0) ws_stats[at * g + gi] = make_double2(a, a2);
    }
    __syncthreads();
    // exchange 1: every range of the image has its partials out
    unsigned* arrive = cnt + 2 * static_cast<long long>(img);
    PHASE_MARK(w, 2);
    if (t == 0) msr::arrive_and_wait(arrive, ranges);
    __syncthreads();
    PHASE_MARK(w, 3);

    // mean and rstd of each group of this image, from every range
    for (int gi = warp; gi < g; gi += kWarps) {
      double a = 0.0, a2 = 0.0;
      for (int j = lane; j < ranges; j += 32) {
        const double2 v = __ldcg(
            ws_stats + (static_cast<long long>(img) * ranges + j) * g + gi);
        a += v.x;
        a2 += v.y;
      }
      for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        a2 += __shfl_xor_sync(0xffffffffu, a2, off);
      }
      if (lane == 0) {
        const float mean = static_cast<float>(a / n);
        const float var = __fsub_rn(static_cast<float>(a2 / n),
                                    __fmul_rn(mean, mean));
        stats[gi] = make_float2(
            mean, __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps))));
      }
    }
    __syncthreads();

    PHASE_MARK(w, 4);
    // (b) per-thread sums of dz and dz * xhat of its channels
    float m[V], r[V], sa[V], sb[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float2 st = stats[(cvec * V + k) / L.cg];
      m[k] = st.x;
      r[k] = st.y;
      sa[k] = sb[k] = 0.f;
    }
    for (int i = 0; i < pieces; ++i) {
      msr::mbar_wait(gbars + 8 * i, w & 1);
      const int end = min((i + 1) * piece_px, n_px);
      for (int p = i * piece_px + r0; p < end; p += L.rows) {
        const Vec xv = xs[p * L.vpp + cvec];
        const Vec gv = gs[p * L.vpp + cvec];
#pragma unroll
        for (int k = 0; k < V; ++k) {
          float xh, dz;
          xhat_dz(msr::to_float(xv.v[k]), msr::to_float(gv.v[k]), m[k], r[k],
                  gam[k], bet[k], slope, &xh, &dz);
          sa[k] += dz;
          sb[k] += dz * xh;
        }
      }
    }
    PHASE_MARK(w, 5);
    for (int off = 16; off >= L.vpp; off >>= 1) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        sa[k] += __shfl_xor_sync(0xffffffffu, sa[k], off);
        sb[k] += __shfl_xor_sync(0xffffffffu, sb[k], off);
      }
    }
    if (L.vpp >= 32 || lane < L.vpp) {
      float2* pr = part_b + (t / L.span) * c + cvec * V;
#pragma unroll
      for (int k = 0; k < V; ++k) pr[k] = make_float2(sa[k], sb[k]);
    }
    __syncthreads();
    if (t < c) {
      float a = 0.f, a2 = 0.f;
      for (int row0 = 0; row0 < L.prow; row0 += 4) {
        float2 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (row0 + u < L.prow) v[u] = part_b[(row0 + u) * c + t];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (row0 + u < L.prow) {
            a += v[u].x;
            a2 += v[u].y;
          }
        }
      }
      ws_part[at * c + t] = make_float2(a, a2);
    }
    __syncthreads();
    // exchange 2 on the same counter; then this block leaves the image's
    // exchanges: the last to leave resets the counters once its wave is
    // done (the atomic's result is read there, off this path)
    PHASE_MARK(w, 6);
    unsigned left = 0;
    if (t == 0) {
      msr::arrive_and_wait(arrive, 2 * ranges);
      left = atomicAdd(arrive + 1, 1u);
    }
    __syncthreads();
    PHASE_MARK(w, 7);

    // the image's sums per channel: `parts` threads a channel, each a
    // fixed stride of the ranges (loaded 4 at a time), then their
    // partials in order
    // channel t's gamma (c <= 256), loaded while the sums' loads fly
    const float gam_t = t < c ? gamma[t] : 0.f;
    {
      const int ch = t % c, k0 = t / c;
      const float2* src = ws_part + static_cast<long long>(img) * ranges * c;
      double a = 0.0, a2 = 0.0;
      for (int j0 = k0; j0 < ranges; j0 += 4 * parts) {
        float2 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + u * parts;
          if (j < ranges) v[u] = __ldcg(src + static_cast<long long>(j) * c +
                                        ch);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (j0 + u * parts < ranges) {
            a += v[u].x;
            a2 += v[u].y;
          }
        }
      }
      part_a[k0 * c + ch] = make_double2(a, a2);
    }
    __syncthreads();
    if (t < c) {
      double a = 0.0, a2 = 0.0;
      for (int k = 0; k < parts; ++k) {
        const double2 v = part_a[k * c + t];
        a += v.x;
        a2 += v.y;
      }
      if (rng == 0)
        ws_img[static_cast<long long>(img) * c + t] =
            make_float2(static_cast<float>(a), static_cast<float>(a2));
      const double ga = gam_t;
      csum[t] = make_double2(ga * a, ga * a2);
    }
    __syncthreads();
    // the image's first block has written its channel sums: it arrives on
    // the grid's counter; the last of the B arrivals sums them over the
    // images after its wave (the result is read there)
    unsigned done = 0;
    if (t == 0 && rng == 0) {
      __threadfence();
      done = atomicAdd(cnt + 2 * static_cast<long long>(b), 1u);
    }
    // each group's m1, m2: a warp a group, lanes a fixed stride of its
    // channels, then a fixed shuffle tree
    for (int gi = warp; gi < g; gi += kWarps) {
      double m1 = 0.0, m2 = 0.0;
      for (int j = lane; j < L.cg; j += 32) {
        m1 += csum[gi * L.cg + j].x;
        m2 += csum[gi * L.cg + j].y;
      }
      for (int off = 16; off > 0; off >>= 1) {
        m1 += __shfl_xor_sync(0xffffffffu, m1, off);
        m2 += __shfl_xor_sync(0xffffffffu, m2, off);
      }
      if (lane == 0)
        moms[gi] = make_float2(static_cast<float>(m1 / n),
                               static_cast<float>(m2 / n));
    }
    __syncthreads();

    PHASE_MARK(w, 8);
    // (c) dx from the staged copy, a piece at a time (each thread 4 pixels
    // of it); once a piece is read, the next wave's copy of it starts
    float m1[V], m2[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float2 mm = moms[(cvec * V + k) / L.cg];
      m1[k] = mm.x;
      m2[k] = mm.y;
    }
    T* out = dx + base + cvec * V;
    for (int i = 0; i < pieces; ++i) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int pp = i * piece_px + r0 + u * L.rows;
        if (pp < n_px) {
          const Vec xv = xs[pp * L.vpp + cvec];
          const Vec gv = gs[pp * L.vpp + cvec];
          Vec o;
#pragma unroll
          for (int k = 0; k < V; ++k) {
            float xh, dz;
            xhat_dz(msr::to_float(xv.v[k]), msr::to_float(gv.v[k]), m[k],
                    r[k], gam[k], bet[k], slope, &xh, &dz);
            o.v[k] = msr::from_float<T>(r[k] *
                                        (dz * gam[k] - m1[k] - xh * m2[k]));
          }
          *reinterpret_cast<Vec*>(out + static_cast<long long>(pp) * c) = o;
        }
      }
      __syncthreads();
      if (t == 0 && next) {
        // this wave's reads of the piece come before the copies' writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        msr::stage_piece(x + base + ipw * img_elems, xdst, bytes, i,
                         bars + 8 * i);
        msr::stage_piece(gy + base + ipw * img_elems, gdst, bytes, i,
                         gbars + 8 * i);
      }
    }
    PHASE_MARK(w, 9);
    if (t == 0 && left == static_cast<unsigned>(ranges - 1)) {
      atomicExch(arrive, 0u);
      atomicExch(arrive + 1, 0u);
    }
    if (rng == 0) {
      if (t == 0) *last = done == static_cast<unsigned>(b - 1);
      __syncthreads();
      if (*last) {
        sum_over_images(ws_img, b, c, dgamma, dbeta);
        if (t == 0) atomicExch(cnt + 2 * static_cast<long long>(b), 0u);
      }
    }
    PHASE_MARK(w, 10);
  }
  PHASE_MARK(0, 11);
  PHASE_TIME(15);
}

template <typename T, int V>
cudaError_t prepare(int smem, int* per_sm) {
  auto kernel = gn_onepass_bwd_kernel<T, V>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                       kThreads, smem);
}

template <typename T, int V>
int launch(const void* x, const void* gy, const float* gamma,
           const float* beta, void* dx, float* dgamma, float* dbeta,
           void* ws, unsigned* cnt, int b, long long hw, int c, int g,
           int chunk_px, int ranges, int ipw, int waves, int stage_bytes,
           float eps, float slope, cudaStream_t stream) {
  double2* ws_stats = static_cast<double2*>(ws);
  float2* ws_part = reinterpret_cast<float2*>(
      ws_stats + static_cast<long long>(b) * ranges * g);
  float2* ws_img = ws_part + static_cast<long long>(b) * ranges * c;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranges * ipw);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kStageOff + 2 * stage_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, gn_onepass_bwd_kernel<T, V>, static_cast<const T*>(x),
      static_cast<const T*>(gy), gamma, beta, static_cast<T*>(dx), dgamma,
      dbeta, ws_stats, ws_part, ws_img, cnt, b, hw, c, g, chunk_px, ranges,
      ipw, waves, stage_bytes, eps, slope);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Blocks of the one-pass backward that are co-resident on the current
// device (one per SM) and the bytes of shared memory each can stage of
// each of x and g (a multiple of 128). Raises both instances' dynamic
// shared memory to the card's per-block maximum; call it once per device
// before the first launch.
extern "C" int msr_gn_onepass_bwd_capacity(int* n_blocks, int* stage_bytes) {
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
  if (!coop || optin <= kStageOff + 256) return cudaErrorNotSupported;
  int each = (optin - kStageOff) / 2 / 128 * 128;
  if (each > static_cast<int>(kMaxPieces * kPieceBytes))
    each = kMaxPieces * kPieceBytes;
  const int smem = kStageOff + 2 * each;
  int per_sm = 1 << 30;
  int nb = 0;
  cudaError_t (*instances[])(int, int*) = {prepare<float, 4>,
                                           prepare<__nv_bfloat16, 8>};
  for (auto fn : instances) {
    e = fn(smem, &nb);
    if (e != cudaSuccess) return static_cast<int>(e);
    per_sm = nb < per_sm ? nb : per_sm;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *n_blocks = per_sm * sms;
  *stage_bytes = each;
  return 0;
}

// x, gy, dx: (B, HW, C) channels-last, bf16 (is_bf16) or fp32, 16-byte
// aligned. gamma, beta, dgamma, dbeta: (C,) fp32. ws: scratch of
// 16 * B * ranges * G + 8 * B * ranges * C + 8 * B * C bytes, 16-byte
// aligned. cnt: 2 * B + 1 unsigned counters, zero on entry and on exit.
// The plan (chunk_px, ranges, ipw, waves) is _plan_onepass's with
// stage_bytes from msr_gn_onepass_bwd_capacity. Refuses a layout or plan
// the kernel does not take.
extern "C" int msr_gn_onepass_bwd(const void* x, const void* gy,
                                  const float* gamma, const float* beta,
                                  void* dx, float* dgamma, float* dbeta,
                                  void* ws, unsigned* cnt, int b,
                                  long long hw, int c, int g, int chunk_px,
                                  int ranges, int ipw, int waves,
                                  int stage_bytes, int is_bf16, float eps,
                                  float slope, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int v = is_bf16 ? 8 : 4;
  const long long range_bytes =
      static_cast<long long>(chunk_px) * c * (is_bf16 ? 2 : 4);
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (b <= 0 || hw <= 0 || chunk_px <= 0 || ranges <= 0 || ipw <= 0 ||
      ipw > b || !layout_ok(c, g, v) || stage_bytes % 128 ||
      range_bytes > stage_bytes ||
      range_bytes > static_cast<long long>(kMaxPieces) * kPieceBytes ||
      static_cast<long long>(chunk_px) * ranges < hw ||
      static_cast<long long>(chunk_px) * (ranges - 1) >= hw ||
      static_cast<long long>(ipw) * waves < b || misaligned(x) ||
      misaligned(gy) || misaligned(dx) || misaligned(ws))
    return cudaErrorInvalidValue;
  if (is_bf16)
    return launch<__nv_bfloat16, 8>(x, gy, gamma, beta, dx, dgamma, dbeta,
                                    ws, cnt, b, hw, c, g, chunk_px, ranges,
                                    ipw, waves, stage_bytes, eps, slope, s);
  return launch<float, 4>(x, gy, gamma, beta, dx, dgamma, dbeta, ws, cnt, b,
                          hw, c, g, chunk_px, ranges, ipw, waves, stage_bytes,
                          eps, slope, s);
}
