// Implicit-GEMM 3x3 convolution on the tensor cores: bf16, channels-last.
//
// Replaces the TPU kernel mri_superresolution_tpu/experiments/conv_pallas.py
// (conv3x3_packed_fwd) for bf16: a 3x3 conv, stride 1, zero padding 1, no
// bias, on (B, H, W, Ci) bf16 with the weights as (Co, 3, 3, Ci), fp32
// accumulation and one round-to-nearest-even cast of the result. In the
// unet it runs final_up_conv (32 -> 16) and final_conv1 (16 -> 16), both at
// 2H x 2W. The TPU kernel's output-column packing is not used.
//
// Bound on the H100: bytes. At Co = 16 a pixel is 9 * Ci * 16 MACs against
// (Ci + 16) * 2 bytes moved, about 96 flops a byte at Ci = 32, under the
// ~295 at which the bf16 tensor cores become the limit. The CUDA-core
// kernel (conv3x3_narrow.cu, now fp32 only) was FMA-bound far from that.
//
// GEMM view: M = output pixels, N = Co (1-8 n8 fragments), K = 9 taps x Ci,
// over channel chunks of KC = 16 or 32 zero-padded past Ci, then over dw,
// then dh. The A operand of tap (dh, dw) is the staged input tile shifted
// by (dh, dw) pixels: mma.sync.m16n8k16 fed by ldmatrix, where each lane
// gives its own row address, takes the shift for free. wgmma would buy
// nothing here: the kernel is bound by bytes, and wgmma's shared-memory
// descriptors want 8-row x 16-byte core matrices that a one-pixel shift
// breaks.
//
// Tile: TH x 32 output pixels, 8 warps as 4 row groups x 2 column halves;
// a warp owns MT output rows of 16 pixels (MT m16 tiles): MT = 4, TH = 16
// for Co <= 16; MT = 2, TH = 8 above, to keep the accumulators in
// registers. For each (dw, k16 step) a warp loads the A fragment of each of
// its MT + 2 halo rows once and uses it for every output row it feeds (up
// to 3 taps dh), which cuts the shared-memory reads of A by (MT + 2) / 3MT.
// The halo of one chunk, (TH + 2) x 34 pixels, is staged with 16-byte
// cp.async, zero-filled (src-size 0) outside the image and past Ci; where
// Ci % 8 != 0 or x is not 16-byte aligned the same kernel (VEC = false)
// stages it with element loads. The pixel stride in shared memory is KC + 8
// elements (48 or 80 bytes, an odd number of 16-byte units), so the 8 rows
// of an ldmatrix fall in distinct banks. The weights sit beside it as
// [tap][co][k] at the same stride and load as B fragments with ldmatrix.
//
// Stages: a persistent grid (as many blocks as fit on the SMs) walks the
// tiles. Where Ci fits one chunk (the unet's convs) the block loads its
// weights once and keeps two halo buffers: the next tile's cp.async loads
// fly while this tile's MMAs run. A larger Ci loads weights and halo chunk
// by chunk, one stage. Epilogue: the fp32 accumulators are cast to bf16
// (RNE), staged per warp in shared memory (in the halo buffer just used)
// and leave as 16-byte stores of each pixel's Co values, masked at the
// ragged H and W edges, so any H and W work.

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileW = 32;             // two 16-pixel column halves
constexpr int kHaloW = kTileW + 2;

template <int KC, int CO>
struct Geometry {
  static constexpr int MT = CO <= 16 ? 4 : 2;      // output rows a warp
  static constexpr int TH = 4 * MT;                // 4 row groups
  static constexpr int HALO_H = TH + 2;
  static constexpr int PS = KC + 8;                // pixel / weight-row stride
  static constexpr int OS = CO + 8;                // staged output pixel stride
  static constexpr int HALO_ELEMS = HALO_H * kHaloW * PS;
  static constexpr int STAGE_ELEMS = kWarps * 16 * OS;
  // one halo buffer, which also takes the epilogue's staging
  static constexpr int BUF_ELEMS =
      HALO_ELEMS > STAGE_ELEMS ? HALO_ELEMS : STAGE_ELEMS;
  static constexpr int W_ELEMS = 9 * CO * PS;
  static constexpr int SMEM_BYTES = 2 * (2 * BUF_ELEMS + W_ELEMS);
  static constexpr int MIN_BLOCKS = CO <= 32 ? 2 : 1;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src-size 0 writes zeros and reads nothing.
// The L2::256B hint has L2 fetch the whole 256-byte span around the
// address: a halo row is contiguous, and on the H100 the hint measured
// about 5% faster at the unet's shapes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3,
                                        uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
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

// Where a tile lies: image b, output rows y0.., columns x0..
struct Tile {
  int b, y0, x0;
};

template <int KC, int CO>
__device__ __forceinline__ Tile tile_at(int t, int h, int wd) {
  using G = Geometry<KC, CO>;
  const int tiles_x = (wd + kTileW - 1) / kTileW;
  const int tiles_y = (h + G::TH - 1) / G::TH;
  return {t / (tiles_x * tiles_y), t / tiles_x % tiles_y * G::TH,
          t % tiles_x * kTileW};
}

// The halo of channels c0.. of one tile into xs[pixel][k]: zeros outside
// the image and past Ci. cp.async (not yet waited for) when VEC.
template <int KC, int CO, bool VEC>
__device__ __forceinline__ void stage_halo(bf16* xs, const bf16* x, Tile t,
                                           int c0, int h, int wd, int ci) {
  using G = Geometry<KC, CO>;
  const bf16* xb = x + static_cast<long long>(t.b) * h * wd * ci;
  if constexpr (VEC) {
    constexpr int PIECES = KC / 8;                 // 16-byte pieces a pixel
    for (int i = threadIdx.x; i < G::HALO_H * kHaloW * PIECES;
         i += kThreads) {
      const int pc = i % PIECES;
      const int pix = i / PIECES;
      const int gy = t.y0 - 1 + pix / kHaloW;
      const int gx = t.x0 - 1 + pix % kHaloW;
      const int c = c0 + pc * 8;
      const bool ok = gy >= 0 && gy < h && gx >= 0 && gx < wd && c < ci;
      const bf16* src =
          ok ? xb + (static_cast<long long>(gy) * wd + gx) * ci + c : x;
      cp_async16(xs + pix * G::PS + pc * 8, src, ok);
    }
  } else {
    const bf16 zero = msr::from_float<bf16>(0.f);
    for (int i = threadIdx.x; i < G::HALO_H * kHaloW * KC; i += kThreads) {
      const int k = i % KC;
      const int pix = i / KC;
      const int gy = t.y0 - 1 + pix / kHaloW;
      const int gx = t.x0 - 1 + pix % kHaloW;
      bf16 v = zero;
      if (gy >= 0 && gy < h && gx >= 0 && gx < wd && c0 + k < ci)
        v = xb[(static_cast<long long>(gy) * wd + gx) * ci + c0 + k];
      xs[pix * G::PS + k] = v;
    }
  }
}

// weights (Co, 9, Ci), channels c0.. -> ws[(tap * CO + n) * PS + k], zero
// past Ci
template <int KC, int CO>
__device__ __forceinline__ void stage_weights(bf16* ws, const bf16* w,
                                              int c0, int ci) {
  using G = Geometry<KC, CO>;
  const bf16 zero = msr::from_float<bf16>(0.f);
  for (int i = threadIdx.x; i < 9 * CO * KC; i += kThreads) {
    const int k = i % KC;
    const int n = i / KC % CO;
    const int tap = i / (KC * CO);
    ws[(tap * CO + n) * G::PS + k] =
        c0 + k < ci ? w[(static_cast<long long>(n) * 9 + tap) * ci + c0 + k]
                    : zero;
  }
}

// acc[j] += this chunk's 9 taps for the warp's output row j
template <int KC, int CO>
__device__ __forceinline__ void mma_chunk(
    const bf16* xs, const bf16* ws,
    float (&acc)[Geometry<KC, CO>::MT][CO / 8][4]) {
  using G = Geometry<KC, CO>;
  constexpr int NF = CO / 8;                       // n8 fragments
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int row0 = warp / 2 * G::MT;               // first output row
  const int col0 = warp % 2 * 16;                  // first output column
  // ldmatrix row addresses of this lane. A (x4): matrices (rows 0-7, k lo),
  // (rows 8-15, k lo), (rows 0-7, k hi), (rows 8-15, k hi) = a0..a3.
  const int a_row = lane % 8 + (lane / 8) % 2 * 8;
  const int a_k = lane / 16 * 8;
  // B (x4): (n lo, k lo), (n lo, k hi), (n hi, k lo), (n hi, k hi)
  const int b_n = lane / 16 * 8 + lane % 8;
  const int b_k = (lane / 8) % 2 * 8;
  const uint32_t xs_base = smem_addr(xs);
  const uint32_t ws_base = smem_addr(ws);
#pragma unroll
  for (int dw = 0; dw < 3; ++dw) {
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t bfr[3][NF][2];
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
        const int tap = 3 * dh + dw;
#pragma unroll
        for (int nf = 0; nf + 1 < NF; nf += 2)
          ldsm_x4(bfr[dh][nf][0], bfr[dh][nf][1], bfr[dh][nf + 1][0],
                  bfr[dh][nf + 1][1],
                  ws_base + 2 * ((tap * CO + nf * 8 + b_n) * G::PS +
                                 ks * 16 + b_k));
        if constexpr (NF % 2) {
          constexpr int nf = NF - 1;
          ldsm_x2(bfr[dh][nf][0], bfr[dh][nf][1],
                  ws_base + 2 * ((tap * CO + nf * 8 + lane % 8) * G::PS +
                                 ks * 16 + b_k));
        }
      }
      // halo row r feeds output row j through tap dh = r - j
#pragma unroll
      for (int r = 0; r < G::MT + 2; ++r) {
        uint32_t a[4];
        ldsm_x4(a[0], a[1], a[2], a[3],
                xs_base + 2 * (((row0 + r) * kHaloW + col0 + dw + a_row) *
                                   G::PS +
                               ks * 16 + a_k));
#pragma unroll
        for (int j = 0; j < G::MT; ++j) {
          if (r - j < 0 || r - j > 2) continue;
#pragma unroll
          for (int nf = 0; nf < NF; ++nf)
            mma_bf16(acc[j][nf], a, bfr[r - j][nf][0], bfr[r - j][nf][1]);
        }
      }
    }
  }
}

// Cast, stage through st (a free halo buffer) and store the tile.
template <int KC, int CO>
__device__ __forceinline__ void epilogue(
    bf16* st, bf16* __restrict__ y, Tile t, int h, int wd,
    const float (&acc)[Geometry<KC, CO>::MT][CO / 8][4]) {
  using G = Geometry<KC, CO>;
  constexpr int NF = CO / 8;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int c = lane % 4;
  st += warp * 16 * G::OS;
  const int ox0 = t.x0 + warp % 2 * 16;
#pragma unroll
  for (int j = 0; j < G::MT; ++j) {
    const int oy = t.y0 + warp / 2 * G::MT + j;
    // accumulator (row g, cols 2c, 2c+1) and (row g + 8, the same cols)
#pragma unroll
    for (int nf = 0; nf < NF; ++nf) {
      __nv_bfloat162 lo, hi;
      lo.x = msr::from_float<bf16>(acc[j][nf][0]);
      lo.y = msr::from_float<bf16>(acc[j][nf][1]);
      hi.x = msr::from_float<bf16>(acc[j][nf][2]);
      hi.y = msr::from_float<bf16>(acc[j][nf][3]);
      *reinterpret_cast<__nv_bfloat162*>(st + g * G::OS + nf * 8 + 2 * c) =
          lo;
      *reinterpret_cast<__nv_bfloat162*>(st + (g + 8) * G::OS + nf * 8 +
                                         2 * c) = hi;
    }
    __syncwarp();
    for (int v = lane; v < 16 * NF; v += 32) {
      const int p = v / NF;
      const int q = v % NF;
      if (oy < h && ox0 + p < wd)
        *reinterpret_cast<uint4*>(
            y + ((static_cast<long long>(t.b) * h + oy) * wd + ox0 + p) * CO +
            q * 8) = *reinterpret_cast<const uint4*>(st + p * G::OS + q * 8);
    }
    __syncwarp();
  }
}

template <int KC, int CO, bool VEC>
__global__ void __launch_bounds__(kThreads, Geometry<KC, CO>::MIN_BLOCKS)
    conv3x3_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       bf16* __restrict__ y, int h, int wd, int ci,
                       int tiles) {
  using G = Geometry<KC, CO>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const buf = reinterpret_cast<bf16*>(smem);  // two halo buffers
  bf16* const ws = buf + 2 * G::BUF_ELEMS;

  if (ci <= KC) {
    // one chunk: weights once, two halo buffers, the next tile's loads in
    // flight while this tile's MMAs run
    stage_weights<KC, CO>(ws, w, 0, ci);
    if (blockIdx.x < tiles)
      stage_halo<KC, CO, VEC>(buf, x, tile_at<KC, CO>(blockIdx.x, h, wd), 0,
                              h, wd, ci);
    cp_async_commit();
    int s = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, s ^= 1) {
      bf16* const cur = buf + s * G::BUF_ELEMS;
      const int next = t + gridDim.x;
      if (next < tiles)
        stage_halo<KC, CO, VEC>(buf + (s ^ 1) * G::BUF_ELEMS, x,
                                tile_at<KC, CO>(next, h, wd), 0, h, wd, ci);
      cp_async_commit();
      cp_async_wait<1>();                          // this tile's group
      __syncthreads();
      float acc[G::MT][CO / 8][4] = {};
      mma_chunk<KC, CO>(cur, ws, acc);
      __syncthreads();                             // cur free to stage
      epilogue<KC, CO>(cur, y, tile_at<KC, CO>(t, h, wd), h, wd, acc);
      __syncthreads();                     // before cur takes a new tile
    }
  } else {
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile tile = tile_at<KC, CO>(t, h, wd);
      float acc[G::MT][CO / 8][4] = {};
      for (int c0 = 0; c0 < ci; c0 += KC) {
        stage_halo<KC, CO, VEC>(buf, x, tile, c0, h, wd, ci);
        stage_weights<KC, CO>(ws, w, c0, ci);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        mma_chunk<KC, CO>(buf, ws, acc);
        __syncthreads();                 // before the next chunk's stores
      }
      epilogue<KC, CO>(buf, y, tile, h, wd, acc);
      __syncthreads();
    }
  }
}

template <int KC, int CO, bool VEC>
int launch(const void* x, const void* w, void* y, int b, int h, int wd, int ci,
           cudaStream_t stream) {
  using G = Geometry<KC, CO>;
  auto kernel = conv3x3_mma_kernel<KC, CO, VEC>;
  // blocks of this kernel that fit on one SM, asked once
  static const int per_sm = [kernel] {
    int n = 0;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G::SMEM_BYTES) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, kernel, kThreads, G::SMEM_BYTES) != cudaSuccess)
      return 0;
    return n;
  }();
  if (per_sm == 0) {
    const cudaError_t e = cudaGetLastError();
    return static_cast<int>(e != cudaSuccess ? e
                                             : cudaErrorInvalidConfiguration);
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = static_cast<long long>(b) *
                          ((h + G::TH - 1) / G::TH) *
                          ((wd + kTileW - 1) / kTileW);
  if (tiles == 0) return 0;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const long long cap = static_cast<long long>(per_sm) * sms;
  const int grid = static_cast<int>(tiles < cap ? tiles : cap);
  kernel<<<grid, kThreads, G::SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(y), h, wd, ci, static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

template <int KC, bool VEC>
int dispatch(const void* x, const void* w, void* y, int b, int h, int wd,
             int ci, int co, cudaStream_t s) {
  switch (co) {
    case 8: return launch<KC, 8, VEC>(x, w, y, b, h, wd, ci, s);
    case 16: return launch<KC, 16, VEC>(x, w, y, b, h, wd, ci, s);
    case 24: return launch<KC, 24, VEC>(x, w, y, b, h, wd, ci, s);
    case 32: return launch<KC, 32, VEC>(x, w, y, b, h, wd, ci, s);
    case 40: return launch<KC, 40, VEC>(x, w, y, b, h, wd, ci, s);
    case 48: return launch<KC, 48, VEC>(x, w, y, b, h, wd, ci, s);
    case 56: return launch<KC, 56, VEC>(x, w, y, b, h, wd, ci, s);
    case 64: return launch<KC, 64, VEC>(x, w, y, b, h, wd, ci, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: (B, H, W, Ci) bf16, w: (Co, 3, 3, Ci) bf16, y: (B, H, W, Co) bf16, all
// contiguous; y 16-byte aligned. Co a multiple of 8 up to 64; k_chunk (16 or
// 32) the channels staged at a time, chosen by the wrapper.
extern "C" int msr_conv3x3_bf16(const void* x, const void* w, void* y, int b,
                                int h, int wd, int ci, int co, int k_chunk,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = ci % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (k_chunk == 16)
    return vec ? dispatch<16, true>(x, w, y, b, h, wd, ci, co, s)
               : dispatch<16, false>(x, w, y, b, h, wd, ci, co, s);
  if (k_chunk == 32)
    return vec ? dispatch<32, true>(x, w, y, b, h, wd, ci, co, s)
               : dispatch<32, false>(x, w, y, b, h, wd, ci, co, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
