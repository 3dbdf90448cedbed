// SwinIR's MLP half of a Swin block in one pass over the served token
// stream (models/swinir.py, SwinBlock.forward on the served path):
//
//   out[r, :C]   = x[r, :C] + b2 + W2 . GELU(W1 . LN(x[r, :C]) + b1)
//   out[r, C:Cp] = 0
//
// over rows of Cp bf16 channels (C = 180 in rows of 184 at the published
// widths, hidden 360): LN the LayerNorm over the first C channels (fp32
// scale gamma and shift beta), GELU the exact (erf) form.
//
// Replaces no TPU kernel: the JAX package has no transformer. The unfused
// served sequence is five passes over device memory (LN2, fc1, GELU, fc2,
// the residual add) that move ~2,728 channels a token; this kernel reads
// each row once and writes it once (2 Cp channels) and keeps the hidden on
// the SM.
//
// Bound on the H100: the work, 4 C hidden operations a row (259,200 at the
// published widths), against 4 C bytes: ~360 operations a byte, above the
// ~295 at which the tensor cores bind. So the design keeps them fed:
//
// - Persistent blocks, one an SM, walk tiles of 128 rows. Two warpgroups
//   take 64 rows each, with up to 255 registers a thread (GEMM2's 92 fp32
//   sums, GEMM1's A operand of 48 and its 32 sums). One of their threads
//   issues the Tensor Memory Accelerator's bulk copies, each completing on
//   an mbarrier, a stage as soon as both warpgroups have released it.
// - A tile's rows (contiguous) arrive in shared memory in one bulk copy
//   while the previous tile computes. Each consumer thread reads its rows'
//   channels straight into the register layout of a wgmma A operand (rows
//   g and g + 8 of its warp's 16, channel pairs 8i + 2q), takes the
//   LayerNorm's mean and variance over the first C channels in fp32 (two
//   passes; a row's 4 lanes summed by shuffles), and rounds the normalized
//   row to bf16 in place: GEMM1's A operand, K = Cp rounded up to 16
//   (192), zero from C on.
// - The weights stream through a ring of kStages stages, a chunk of 64
//   hidden columns a stage: W1's 64 rows (64 x K) and W2's 64 columns (Cp x
//   64), 48 kB at the published widths. The wrapper lays them out in
//   wgmma's K-major order with the 128-byte swizzle (rows of 64 channels,
//   atoms of 8 rows in which row n's 16-byte chunk c lies at chunk
//   c ^ (n % 8)), so one bulk copy fills a stage. The
//   hidden is zero-padded to a multiple of 64 (384) and K to 16 (192) by
//   zero rows and columns of the weights: the padding changes nothing.
// - A chunk: GEMM1 (m64n64k16, A from registers, K / 16 steps) into 32 fp32
//   sums a thread; b1 in fp32, the exact GELU (erff) in fp32, rounded once
//   to bf16. The sums' layout is the A operand's, so the hidden goes on
//   from registers into GEMM2 (m64nCpk16, 4 steps), which accumulates the
//   tile's 64 x Cp output in fp32. GEMM2 of a chunk and GEMM1 of the next
//   are in flight together.
// - The output: GEMM2's sums start from the residual plus b2 in fp32,
//   taken from the tile's rows in shared memory while the LayerNorm reads
//   them (the accumulator's layout is the A operand's, channel for
//   channel), so the epilogue reads nothing; the sums are rounded once and
//   channels C .. Cp - 1 written as zeros.
//
// The plain version (kernels/swin_mlp.py) is the same arithmetic in
// PyTorch ops; the two agree to bf16 rounding (fp32 sums in another order).

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 128;                      // rows a tile
constexpr int kThreads = 256;        // two warpgroups, 64 rows each
constexpr int kWarps = kThreads / 32;
// the thread that issues the copies (warpgroup 1's first: it releases each
// stage after warpgroup 0 has)
constexpr int kLoader = 128;
constexpr int kChunk = 64;                      // hidden columns a stage
constexpr int kStages = 3;
constexpr int kMaxHidden = 384;                 // 6 chunks
constexpr int kMaxSmem = 232448;                // 227 KB a block
constexpr float kSqrtHalf = 0.70710678118654752440f;

// The shapes of one instance: Cp = NP channels a row.
template <int NP>
struct Tile {
  static constexpr int kK = (NP + 15) / 16 * 16;  // GEMM1's K
  static constexpr int kSteps = kK / 16;          // its k-steps
  static constexpr int kW1 = kChunk * kK * 2;     // bytes of a stage's W1
  static constexpr int kStage = kW1 + NP * kChunk * 2;
  static constexpr int kX = kRows * NP * 2;       // bytes of a tile's rows
  static constexpr int kAcc = NP / 2;             // GEMM2's sums a thread

  static size_t smem(int chunks) {
    return static_cast<size_t>(kStages) * kStage + kX +
           (static_cast<size_t>(chunks) * kChunk + 3 * NP) * 4 +
           (2 * kStages + 2) * 8 + 1024;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// until the phase of ``parity`` has completed (a fresh barrier counts its
// phase of parity 1 as complete); a wait that never ends traps, so that a
// fault in the pipeline fails the launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  for (long long spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1LL << 28)) __trap();
  }
}

// ``bytes`` (a multiple of 16) from global to shared memory by the TMA,
// completing on ``bar``
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A wgmma descriptor of a K-major operand with the 128-byte swizzle at
// ``addr`` (its atom 1024-byte aligned): rows of 128 bytes, atoms of 8
// rows 1024 bytes apart along M or N; a k-step of 16 channels inside a
// row starts 32 bytes on.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}


// The registers a wgmma in flight reads or writes, kept by the compiler
// until the wait that ends it: no read moves above it, no other value
// takes the registers before it.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int M, int N>
__device__ __forceinline__ void keep(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 x N, fp32, the warpgroup's accumulator layout) = a (64 x 16 bf16 in
// registers) * b (16 x N bf16 at descriptor b) + (scale_d ? d : 0)
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2],
                                      const uint32_t (&a)[4], uint64_t b,
                                      int scale_d);

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<184>(float (&d)[92],
                                          const uint32_t (&a)[4],
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %97, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n184k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91"
      "}, {%92, %93, %94, %95}, %96, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t w) {
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

// PyTorch's exact GELU in fp32
__device__ __forceinline__ float gelu(float v) {
  return v * 0.5f * (1.f + erff(v * kSqrtHalf));
}

// The LayerNorm of the thread's two rows of the tile (``lrow`` and lrow +
// 8, live below ``here``) into GEMM1's A fragments: a[s][2 h + r] holds row
// r's channels 16 s + 8 h + 2 q and + 1. Rows past ``here`` and channels
// from C on are zeros. GEMM2's sums start as the rows plus b2 in fp32:
// acc[4 i + 2 r] and + 1 hold row r's channels 8 i + 2 q and + 1, which
// are a[i / 2][2 (i % 2) + r]'s; zero from C on.
template <int NP>
__device__ __forceinline__ void layer_norm(
    const bf16* xs, int lrow, int here, int C, float eps, const float* gs,
    const float* bs, const float* b2s, int q,
    uint32_t (&a)[Tile<NP>::kSteps][4], float (&acc)[Tile<NP>::kAcc]) {
  constexpr int S = Tile<NP>::kSteps;
  const uint32_t* row[2] = {
      reinterpret_cast<const uint32_t*>(xs + lrow * NP),
      reinterpret_cast<const uint32_t*>(xs + (lrow + 8) * NP)};
  const bool live[2] = {lrow < here, lrow + 8 < here};
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 16 * s + 8 * h + 2 * q;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        a[s][2 * h + r] = live[r] && col < NP ? row[r][col / 2] : 0u;
    }
#pragma unroll
  for (int i = 0; i < NP / 8; ++i) {
    const int col = 8 * i + 2 * q;
    const float2 bb = *reinterpret_cast<const float2*>(b2s + col);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 v = unpack(a[i / 2][2 * (i % 2) + r]);
      acc[4 * i + 2 * r] = col < C ? v.x + bb.x : 0.f;
      acc[4 * i + 2 * r + 1] = col + 1 < C ? v.y + bb.y : 0.f;
    }
  }
  const float inv_c = 1.f / static_cast<float>(C);
  float mean[2], rstd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 16 * s + 8 * h + 2 * q;
        const float2 v = unpack(a[s][2 * h + r]);
        if (col < C) sum += v.x;
        if (col + 1 < C) sum += v.y;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    mean[r] = sum * inv_c;
    float sq = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 16 * s + 8 * h + 2 * q;
        const float2 v = unpack(a[s][2 * h + r]);
        const float d0 = v.x - mean[r], d1 = v.y - mean[r];
        if (col < C) sq += d0 * d0;
        if (col + 1 < C) sq += d1 * d1;
      }
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    sq += __shfl_xor_sync(0xffffffffu, sq, 2);
    rstd[r] = rsqrtf(sq * inv_c + eps);
  }
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 16 * s + 8 * h + 2 * q;
      if (col >= C) {
        a[s][2 * h] = a[s][2 * h + 1] = 0u;
        continue;
      }
      const float2 gm = *reinterpret_cast<const float2*>(gs + col);
      const float2 bt = *reinterpret_cast<const float2*>(bs + col);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 v = unpack(a[s][2 * h + r]);
        const float lo = (v.x - mean[r]) * rstd[r] * gm.x + bt.x;
        const float hi = col + 1 < C
                             ? (v.y - mean[r]) * rstd[r] * gm.y + bt.y
                             : 0.f;
        a[s][2 * h + r] = pack(lo, hi);
      }
    }
}

// GEMM1 of a chunk: h (64 x 64) = a (64 x K) * W1's chunk at ``w1``
// (64 x K: K-blocks of 64 channels, each 64 rows of 128 bytes, 8 kB)
template <int NP>
__device__ __forceinline__ void gemm1(float (&h)[32],
                                      const uint32_t (&a)[Tile<NP>::kSteps][4],
                                      uint32_t w1) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < Tile<NP>::kSteps; ++s)
    wgmma<64>(h, a[s], desc_sw128(w1 + (s / 4) * 8192 + (s % 4) * 32),
              s > 0);
  wgmma_commit();
}

// GEMM2 of a chunk: acc (64 x NP) += p (64 x 64) * W2's chunk at ``w2``
// (NP rows of 64 channels, 128 bytes each)
template <int NP>
__device__ __forceinline__ void gemm2(float (&acc)[Tile<NP>::kAcc],
                                      const uint32_t (&p)[4][4],
                                      uint32_t w2) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s)
    wgmma<NP>(acc, p[s], desc_sw128(w2 + s * 32), 1);
  wgmma_commit();
}

// b1, the GELU and the rounding of GEMM1's sums into GEMM2's A fragments:
// sum block i (columns 8 i + 2 q, + 1 of rows g, g + 8) is k-step i / 2's
// registers 2 (i % 2) and + 1. Blocks from ``live`` columns on are the
// hidden's zero padding: GELU(0) = 0.
__device__ __forceinline__ void gelu_pack(const float (&h)[32],
                                          const float* b1c, int live, int q,
                                          uint32_t (&p)[4][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (8 * i >= live) {
      p[i / 2][2 * (i % 2)] = p[i / 2][2 * (i % 2) + 1] = 0u;
      continue;
    }
    const float2 bb = *reinterpret_cast<const float2*>(b1c + 8 * i + 2 * q);
    p[i / 2][2 * (i % 2)] =
        pack(gelu(h[4 * i] + bb.x), gelu(h[4 * i + 1] + bb.y));
    p[i / 2][2 * (i % 2) + 1] =
        pack(gelu(h[4 * i + 2] + bb.x), gelu(h[4 * i + 3] + bb.y));
  }
}

// The tile's output rows: GEMM2's sums (which began as the residual plus
// b2), rounded once; channels from C on zero
template <int NP>
__device__ __forceinline__ void write_rows(const float (&acc)[NP / 2],
                                           bf16* __restrict__ out,
                                           long long r0, int lrow, int here,
                                           int C, int q) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = lrow + 8 * r;
    if (lr >= here) continue;
    uint32_t* orow = reinterpret_cast<uint32_t*>(out + (r0 + lr) * NP);
#pragma unroll
    for (int i = 0; i < NP / 8; ++i) {
      const int col = 8 * i + 2 * q;
      orow[col / 2] = col < C ? pack(acc[4 * i + 2 * r],
                                     col + 1 < C ? acc[4 * i + 2 * r + 1]
                                                 : 0.f)
                              : 0u;
    }
  }
}

template <int NP>
__global__ void __launch_bounds__(kThreads, 1)
    swin_mlp_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta,
                    const float* __restrict__ b1,
                    const float* __restrict__ b2, bf16* __restrict__ out,
                    long long rows, int C, int hidden, int chunks,
                    float eps) {
  using T = Tile<NP>;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // [kStages][kStage] weights, [kRows][NP] rows, then fp32 b1 (chunks *
  // 64, zero past hidden), b2, gamma, beta (NP each, zero past C), then
  // the barriers
  bf16* xs = reinterpret_cast<bf16*>(smem + kStages * T::kStage);
  float* b1s = reinterpret_cast<float*>(smem + kStages * T::kStage + T::kX);
  float* b2s = b1s + chunks * kChunk;
  float* gs = b2s + NP;
  float* bs = gs + NP;
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + NP);
  uint64_t* empty = full + kStages;
  uint64_t* x_full = empty + kStages;
  uint64_t* x_empty = x_full + 1;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kWarps);
    }
    mbar_init(x_full, 1);
    mbar_init(x_empty, kWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < chunks * kChunk; i += kThreads)
    b1s[i] = i < hidden ? b1[i] : 0.f;
  for (int i = tid; i < NP; i += kThreads) {
    b2s[i] = i < C ? b2[i] : 0.f;
    gs[i] = i < C ? gamma[i] : 0.f;
    bs[i] = i < C ? beta[i] : 0.f;
  }
  __syncthreads();

  // the block's tiles k = 0, 1, .. are tiles blockIdx.x + k gridDim.x;
  // its chunks n = 0, 1, .. run through each tile's in turn, chunk n in
  // stage n % kStages
  const long long tiles = (rows + kRows - 1) / kRows;
  const long long mine = tiles > blockIdx.x
                             ? (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x
                             : 0;
  const long long total = mine * chunks;
  auto load_rows = [&](long long k) {
    const long long r0 = (blockIdx.x + k * gridDim.x) * kRows;
    const long long n = rows - r0 < kRows ? rows - r0 : kRows;
    const uint32_t bytes = static_cast<uint32_t>(n) * NP * 2;
    mbar_expect_tx(x_full, bytes);
    bulk_load(xs, x + r0 * NP, bytes, x_full);
  };
  auto load_chunk = [&](long long n) {
    const int s = static_cast<int>(n % kStages);
    mbar_expect_tx(full + s, T::kStage);
    bulk_load(smem + s * T::kStage,
              w + (n % chunks) * (T::kStage / 2), T::kStage, full + s);
  };
  if (tid == kLoader && mine > 0) {
    load_rows(0);
    for (long long n = 0; n < kStages && n < total; ++n) load_chunk(n);
  }

  // warpgroup wg takes rows 64 wg .. + 63 of each tile, its warp wq rows
  // 16 wq .. + 15 of those, the thread rows g and g + 8
  const int wg = tid / 128, wq = tid / 32 % 4, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int lrow = wg * 64 + wq * 16 + g;
  const uint32_t base = smem_addr(smem);
  float acc[T::kAcc];
  float h[32];
  uint32_t a[T::kSteps][4];
  uint32_t p[4][4];
#pragma unroll
  for (int i = 0; i < T::kAcc; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) h[i] = 0.f;

  // chunk n's stage is free once every warp has arrived: the loader then
  // fills it with chunk n + kStages
  auto release = [&](long long n) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + n % kStages);
    if (tid == kLoader && n + kStages < total) {
      mbar_wait(empty + n % kStages, (n / kStages) & 1);
      load_chunk(n + kStages);
    }
    __syncwarp();
  };
  auto wait_chunk = [&](long long n) {
    mbar_wait(full + n % kStages, (n / kStages) & 1);
    __syncwarp();
  };
  auto stage_at = [&](long long n) {
    return base + static_cast<uint32_t>(n % kStages) * T::kStage;
  };

  for (long long k = 0; k < mine; ++k) {
    const long long r0 = (blockIdx.x + k * gridDim.x) * kRows;
    const int here = rows - r0 < kRows ? static_cast<int>(rows - r0) : kRows;
    const long long n0 = k * chunks;
    mbar_wait(x_full, k & 1);
    __syncwarp();
    layer_norm<NP>(xs, lrow, here, C, eps, gs, bs, b2s, q, a, acc);
    // the rows are in registers: the loader may overwrite them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(x_empty);
    if (tid == kLoader && k + 1 < mine) {
      mbar_wait(x_empty, k & 1);
      load_rows(k + 1);
    }
    __syncwarp();

    wait_chunk(n0);
    gemm1<NP>(h, a, stage_at(n0));
    wgmma_wait<0>();
    keep(h);
    keep(a);
    gelu_pack(h, b1s, hidden, q, p);
    for (int j = 0; j < chunks; ++j) {
      const long long n = n0 + j;
      if (j + 1 < chunks) {
        wait_chunk(n + 1);
        gemm2<NP>(acc, p, stage_at(n) + T::kW1);
        gemm1<NP>(h, a, stage_at(n + 1));
        wgmma_wait<1>();  // GEMM2 of chunk n done: its stage is free
        keep(p);
        release(n);
        wgmma_wait<0>();
        keep(h);
        keep(a);
        gelu_pack(h, b1s + (j + 1) * kChunk, hidden - (j + 1) * kChunk, q,
                  p);
      } else {
        gemm2<NP>(acc, p, stage_at(n) + T::kW1);
        wgmma_wait<0>();
        keep(p);
        keep(a);
        release(n);
      }
    }
    keep(acc);
    write_rows<NP>(acc, out, r0, lrow, here, C, q);
    __syncwarp();
  }
}

template <int NP>
int launch(const void* x, const void* w, const float* gamma,
           const float* beta, const float* b1, const float* b2, void* out,
           long long rows, int c, int hidden, float eps,
           cudaStream_t stream) {
  using T = Tile<NP>;
  auto kernel = swin_mlp_kernel<NP>;
  const int chunks = (hidden + kChunk - 1) / kChunk;
  const size_t smem = T::smem(chunks);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  // the shared memory this instance may take on each device, raised once
  static size_t allowed[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (allowed[dev] < smem) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed[dev] = smem;
  }
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    smem);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long blocks = (rows + kRows - 1) / kRows;
  if (blocks > static_cast<long long>(per_sm) * sms)
    blocks = static_cast<long long>(per_sm) * sms;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), gamma, beta,
      b1, b2, static_cast<bf16*>(out), rows, c, hidden, chunks, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: rows x cp bf16, contiguous, 16-byte aligned (out a new buffer);
// w: the weights in the kernel's layout (kernels/swin_mlp.py,
// ``packed_weights``), 16-byte aligned; gamma, beta, b2: (c,) fp32; b1:
// (hidden,) fp32. Takes cp 184 (SwinIR classical's rows) and hidden up to
// kMaxHidden (the published 360); refuses anything else.
extern "C" int msr_swin_mlp(const void* x, const void* w, const float* gamma,
                            const float* beta, const float* b1,
                            const float* b2, void* out, long long rows, int c,
                            int cp, int hidden, float eps, void* stream) {
  if (rows < 0 || c < 1 || c > cp || hidden < 1 || hidden > kMaxHidden ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cp != 184) return cudaErrorInvalidValue;
  return launch<184>(x, w, gamma, beta, b1, b2, out, rows, c, hidden, eps, s);
}
