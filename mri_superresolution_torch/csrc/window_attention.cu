// SwinIR's shifted-window multi-head attention in one pass: from the qkv
// linear's output (B, H, W, 3C) to the attention output (B, H, W, C) at the
// tokens' own positions, ready for the block's proj. Either may lie in wider
// rows (the served forward's 16-byte rows: qkv in rows of QS >= 3C, the
// output in rows of OS >= C, whose channels from C on the kernel sets to
// zero, since proj's zero weights times unset memory could be NaN).
//
// Replaces no TPU kernel: the JAX package has no attention. The published
// SwinIR (Liang et al. 2021, models/network_swinir.py) runs, per block, a
// torch.roll by -shift, a window partition, a reshape and permute of q, k
// and v, the 64 x 64 scores of every window and head materialized in device
// memory, the bias add, the mask add and the softmax as passes of their own,
// the product with v, the reverse partition and the roll back: about 10 kB
// of traffic a token against the 8C = 1.44 kB (C = 180, bf16) of reading qkv
// once and writing the output once. Here a block of 8 warps takes one 8 x 8
// window of the frame rolled by -shift:
//
// - The roll and the windowing are index arithmetic: the window's tokens are
//   read from, and written back to, their own positions ((y' + shift) mod H).
//   In rows of 3C a window's row is two runs of 4 tokens, each contiguous
//   in the token layout and 16-byte aligned (QS a multiple of 4, shift 0 or
//   4), which cp.async copies whole into shared memory; in 16-byte rows
//   (QS a multiple of 8) each token's first 3C channels are copied into a
//   shared row of SS, which spreads the fragment loads over the banks. The
//   window's q, k and v: 64 x SS bf16.
// - Warp w takes query rows 16 (w % 4) .. +15 of heads w / 4, w / 4 + 2, ...
//   S = q k^T runs on mma.sync.m16n8k16 (bf16 in, fp32 sums) with the head
//   size zero-padded to 32 in the fragments (hd = 30 for SwinIR): the pairs
//   of a head's channels are 4-byte aligned (hd even), so fragments load as
//   32-bit words straight from the token layout, no repack.
// - The scores are scaled by 1 / sqrt(hd) in fp32, the relative-position bias
//   gathered from the (2 * 8 - 1)^2 x heads table (staged in shared memory)
//   at (dy + 7) * 15 + (dx + 7), and in a shifted block the region mask added
//   (-100 between tokens of different regions, from the tokens' rolled
//   coordinates: per axis [0, L - 8), [L - 8, L - shift), [L - shift, L)).
//   The softmax is taken in fp32 in registers (a row lives in one quad of
//   lanes), and its probabilities, rounded to bf16, are the A fragments of
//   P v as they lie (the score accumulators' layout is the A layout).
// - O = P v on mma.sync again; each warp writes its rows of its head over
//   that head's q channels in shared memory (no other warp reads them), and
//   the block writes the window's output, 64 x OS, in 8-byte vectors.
//
// Bound on the H100: by bytes. A token moves 8C bytes (2 (QS + OS) in wider
// rows: 1,456 against 1,440 at C = 180 in rows of 544 and 184) and takes
// 4 * 64 * C operations (q k^T and P v), 32 operations a byte, far below the
// ~295 at which the tensor cores would bind. So the design moves each byte
// once and keeps enough in flight: 70 kB of cp.async a block, three blocks
// an SM.
// The plain version (kernels/window_attention.py) is the published sequence;
// the kernel agrees with it to bf16 rounding (fp32 sums in another order).

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWin = 8;
constexpr int kN = kWin * kWin;          // tokens a window
constexpr int kTable = (2 * kWin - 1) * (2 * kWin - 1);
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowGroups = kN / 16;      // 16 query rows a warp
constexpr int kHeadSets = kWarps / kRowGroups;
constexpr float kMask = -100.f;
constexpr int kMaxHeads = 16;
constexpr int kMaxSmem = 232448 - 1024;  // 227 KB a block, less the static

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two consecutive bf16 of shared memory as one word (the lower index low)
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the region (0, 1, 2) of rolled coordinate p along an axis of length n
__device__ __forceinline__ int region(int p, int n, int shift) {
  return p < n - kWin ? 0 : (p < n - shift ? 1 : 2);
}

__global__ void __launch_bounds__(kThreads, 2)
    window_attention_kernel(const bf16* __restrict__ qkv,
                            const float* __restrict__ table,
                            bf16* __restrict__ out, int H, int W, int C,
                            int heads, int shift, float scale, int QS,
                            int SS, int OS) {
  extern __shared__ uint4 smem_raw[];
  bf16* s = reinterpret_cast<bf16*>(smem_raw);           // [kN][SS]
  float* tab = reinterpret_cast<float*>(s + kN * SS);     // [heads][kTable]
  __shared__ unsigned char reg_id[kN];

  const int nwx = W / kWin;
  const int wy = blockIdx.x / nwx, wx = blockIdx.x % nwx;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;

  const size_t img = static_cast<size_t>(b) * H * W;
  if (QS % 8) {
    // rows of 3C (SS == QS): 16 runs of 4 tokens (a window row's two
    // halves), each 16-byte aligned, QS / 2 chunks of 16 B
    const int cps = QS / 2;
    for (int i = tid; i < 16 * cps; i += kThreads) {
      const int run = i / cps, j = i - run * cps;
      const int r = run >> 1, x0 = (run & 1) * 4;
      const int y = (wy * kWin + r + shift) % H;
      const int x = (wx * kWin + x0 + shift) % W;
      const bf16* src = qkv + (img + static_cast<size_t>(y) * W + x) * QS;
      cp_async16(s + (r * kWin + x0) * SS + j * 8, src + j * 8);
    }
  } else {
    // 16-byte rows: each token's first 3C channels, rounded up to 16 B,
    // into a shared row of SS
    const int cpt = (3 * C + 7) / 8;
    for (int i = tid; i < kN * cpt; i += kThreads) {
      const int t = i / cpt, j = i - t * cpt;
      const int y = (wy * kWin + (t >> 3) + shift) % H;
      const int x = (wx * kWin + (t & 7) + shift) % W;
      const bf16* src = qkv + (img + static_cast<size_t>(y) * W + x) * QS;
      cp_async16(s + t * SS + j * 8, src + j * 8);
    }
  }
  for (int i = tid; i < heads * kTable; i += kThreads) {
    const int h = i / kTable, t = i - h * kTable;
    tab[i] = __ldg(table + t * heads + h);
  }
  if (tid < kN) {
    const int yr = wy * kWin + (tid >> 3), xr = wx * kWin + (tid & 7);
    reg_id[tid] = shift ? region(yr, H, shift) * 3 + region(xr, W, shift) : 0;
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rg = warp % kRowGroups;
  const int i0 = rg * 16 + g, i1 = i0 + 8;    // this lane's query rows
  // window coordinates: row i0 = 2 rg, row i1 = 2 rg + 1, column g
  const int ry0 = 2 * rg, ry1 = 2 * rg + 1, cx = g;
  const int reg0 = reg_id[i0], reg1 = reg_id[i1];
  const int hd = C / heads;
  const unsigned short* su = reinterpret_cast<const unsigned short*>(s);

  for (int h = warp / kRowGroups; h < heads; h += kHeadSets) {
    const int qo = h * hd, ko = C + h * hd, vo = 2 * C + h * hd;
    uint32_t qa[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int d = ks * 16 + 2 * tq;
      qa[ks][0] = d < hd ? ld_pair(s + i0 * SS + qo + d) : 0u;
      qa[ks][1] = d < hd ? ld_pair(s + i1 * SS + qo + d) : 0u;
      qa[ks][2] = d + 8 < hd ? ld_pair(s + i0 * SS + qo + d + 8) : 0u;
      qa[ks][3] = d + 8 < hd ? ld_pair(s + i1 * SS + qo + d + 8) : 0u;
    }
    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      const bf16* kr = s + (nt * 8 + g) * SS + ko;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int d = ks * 16 + 2 * tq;
        const uint32_t b0 = d < hd ? ld_pair(kr + d) : 0u;
        const uint32_t b1 = d + 8 < hd ? ld_pair(kr + d + 8) : 0u;
        mma_bf16(sc[nt], qa[ks], b0, b1);
      }
    }
    // scale, bias, mask; the rows' maxima
    const float* th = tab + h * kTable;
    float m0 = -3.402823466e38f, m1 = -3.402823466e38f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = nt * 8 + 2 * tq + e;   // key: window row nt
        const int kx = 2 * tq + e;
        const int rj = reg_id[j];
        float v0 = __fmul_rn(sc[nt][e], scale) +
                   th[(ry0 - nt + kWin - 1) * (2 * kWin - 1) + cx - kx +
                      kWin - 1];
        float v1 = __fmul_rn(sc[nt][2 + e], scale) +
                   th[(ry1 - nt + kWin - 1) * (2 * kWin - 1) + cx - kx +
                      kWin - 1];
        if (rj != reg0) v0 += kMask;
        if (rj != reg1) v1 += kMask;
        sc[nt][e] = v0;
        sc[nt][2 + e] = v1;
        m0 = fmaxf(m0, v0);
        m1 = fmaxf(m1, v1);
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[nt][e] = __expf(sc[nt][e] - m0);
        sc[nt][2 + e] = __expf(sc[nt][2 + e] - m1);
        l0 += sc[nt][e];
        l1 += sc[nt][2 + e];
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    // P as the A fragments of P v: keys 16 kk .. 16 kk + 15
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack(sc[2 * kk][0] * inv0, sc[2 * kk][1] * inv0);
      pa[kk][1] = pack(sc[2 * kk][2] * inv1, sc[2 * kk][3] * inv1);
      pa[kk][2] = pack(sc[2 * kk + 1][0] * inv0, sc[2 * kk + 1][1] * inv0);
      pa[kk][3] = pack(sc[2 * kk + 1][2] * inv1, sc[2 * kk + 1][3] * inv1);
    }
#pragma unroll
    for (int dn = 0; dn < 4; ++dn) {
      if (dn * 8 >= hd) break;
      const int d = dn * 8 + g;              // this lane's v channel
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b0 = 0u, b1 = 0u;
        if (d < hd) {
          const unsigned short* vc = su + vo + d;
          const int k0 = kk * 16 + 2 * tq;
          b0 = static_cast<uint32_t>(vc[k0 * SS]) |
               (static_cast<uint32_t>(vc[(k0 + 1) * SS]) << 16);
          b1 = static_cast<uint32_t>(vc[(k0 + 8) * SS]) |
               (static_cast<uint32_t>(vc[(k0 + 9) * SS]) << 16);
        }
        mma_bf16(o, pa[kk], b0, b1);
      }
      // rows i0, i1, channels dn * 8 + 2 tq, +1: over this head's q
      const int dc = dn * 8 + 2 * tq;
      if (dc < hd) {
        *reinterpret_cast<uint32_t*>(s + i0 * SS + qo + dc) = pack(o[0], o[1]);
        *reinterpret_cast<uint32_t*>(s + i1 * SS + qo + dc) = pack(o[2], o[3]);
      }
    }
  }
  __syncthreads();

  // the window's output: 16 runs of 4 tokens, OS / 4 vectors of 8 B a
  // token, those from C on zero (C % 4 == 0)
  const int vpt = OS / 4;
  for (int i = tid; i < kN * vpt; i += kThreads) {
    const int t = i / vpt, j = i - t * vpt;
    const int r = t >> 3, c = t & 7;
    const int y = (wy * kWin + r + shift) % H;
    const int x = (wx * kWin + c + shift) % W;
    const uint2 v = j * 4 < C
                        ? *reinterpret_cast<const uint2*>(s + t * SS + j * 4)
                        : make_uint2(0u, 0u);
    *reinterpret_cast<uint2*>(out + (img + static_cast<size_t>(y) * W + x) *
                                        OS + j * 4) = v;
  }
}

}  // namespace

// qkv: (b, h, w, qs) bf16, contiguous, 16-byte aligned, its first 3c
// channels q | k | v, each head-major; table: ((2 * 8 - 1)^2, heads) fp32;
// out: (b, h, w, os) bf16, 8-byte aligned, channels c .. os - 1 set to zero.
// Windows of 8 over the frame rolled by -shift. Refuses h or w not a
// multiple of 8, c not a multiple of 4 or of heads, an odd head size or one
// above 32, more than 16 heads, a shift not 0 or 4, b above 65535, qs not a
// multiple of 4 or below 3c, os not a multiple of 4 or below c.
extern "C" int msr_window_attention(const void* qkv, const float* table,
                                    void* out, int b, int h, int w, int c,
                                    int heads, int shift, int qs, int os,
                                    void* stream) {
  if (b < 1 || b > 65535 || h < kWin || w < kWin || h % kWin || w % kWin ||
      heads < 1 || heads > kMaxHeads || c % heads || c % 4 ||
      (c / heads) % 2 || c / heads > 32 || (shift != 0 && shift != 4) ||
      qs < 3 * c || qs % 4 || os < c || os % 4 ||
      reinterpret_cast<uintptr_t>(qkv) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 8)
    return cudaErrorInvalidValue;
  // the shared row: qs itself for rows of 3c; for 16-byte rows, 3c rounded
  // up to 8 channels and then to 8 mod 16, so that the fragment loads of 8
  // rows fall on distinct banks (a row of 544 put rows i and i + 2 on the
  // same banks: W took 1.22x its time)
  int ss = qs;
  if (qs % 8 == 0) {
    ss = (3 * c + 7) / 8 * 8;
    if (ss % 16 == 0) ss += 8;
  }
  const size_t smem = static_cast<size_t>(kN) * ss * sizeof(bf16) +
                      static_cast<size_t>(heads) * kTable * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const long long windows = static_cast<long long>(h / kWin) * (w / kWin);
  if (windows > 0x7fffffffLL) return cudaErrorInvalidValue;
  // the dynamic shared memory opted into on each device, raised as needed
  static size_t opted[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (smem > opted[dev]) {
    e = cudaFuncSetAttribute(window_attention_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted[dev] = smem;
  }
  const float scale = 1.f / sqrtf(static_cast<float>(c / heads));
  window_attention_kernel<<<dim3(static_cast<unsigned>(windows), b),
                            kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), table,
      static_cast<__nv_bfloat16*>(out), h, w, c, heads, shift, scale, qs, ss,
      os);
  return static_cast<int>(cudaGetLastError());
}
