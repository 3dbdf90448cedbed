// The lane-roll / stencil probe: three streaming kernels over an (R, L)
// bf16 row-major array, processed in 64-row blocks.
//
// Replaces the TPU kernels of tools/bench_roll_probe.py (build, bodies
// copy_body / roll32_body / taps3_body):
//   copy    out = x
//   roll32  out[r, l] = x[r, (l - 32) mod L]            (torch.roll(x, 32, 1))
//   taps3   in each 64-row block, for local rows r < 62:
//             out[r, l] = bf16(bf16(x[r, l] + m(l)) + x[r + 2, l]),
//             m(l) = 0 for l < 32, else x[r + 1, l - 32]
//           and the block's last two rows are copied.
// The TPU probe asked whether Mosaic could roll lanes and read sublane
// offsets near the copy rate (bf16 rolls went through an i32 bitcast).
// On the H100 neither is a layout question: a roll is an index shift, and
// a 32-lane shift is four 16-byte vectors, so every thread moves whole
// vectors. Each thread writes one 16-byte vector (8 lanes) of one row.
//
// Bound on the H100: bytes. One read of x and one write of out, 4 bytes
// per element; taps3 reads each row three times, from L2 and L1 in the
// main, so its device-memory traffic stays at the copy's. Adds are fp32
// rounded to bf16 (__float2bfloat16, round to nearest even), which is a
// correctly rounded bf16 add.
//
// The wrapper guarantees L % 8 == 0, L >= 32, R % 64 == 0 (taps3) and
// 16-byte aligned pointers.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kShiftVec = 4;    // 32 lanes / 8 lanes per vector
constexpr int kRowBlock = 64;

using Vec8 = msr::Vec<__nv_bfloat16, 8>;

inline unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

__global__ void __launch_bounds__(kThreads)
    copy_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                long long n_vec) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i < n_vec) y[i] = x[i];
}

__global__ void __launch_bounds__(kThreads)
    roll32_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                  long long n_vec, int row_vecs) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n_vec) return;
  const int j = static_cast<int>(i % row_vecs);
  const long long row0 = i - j;
  y[i] = x[row0 + (j + row_vecs - kShiftVec) % row_vecs];
}

__global__ void __launch_bounds__(kThreads)
    taps3_kernel(const Vec8* __restrict__ x, Vec8* __restrict__ y,
                 long long n_vec, int row_vecs) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n_vec) return;
  const int j = static_cast<int>(i % row_vecs);
  const long long r = i / row_vecs;
  if (r % kRowBlock >= kRowBlock - 2) {
    y[i] = x[i];
    return;
  }
  const Vec8 a = x[i];
  const Vec8 c = x[i + 2LL * row_vecs];
  Vec8 b;
  if (j >= kShiftVec) {
    b = x[i + row_vecs - kShiftVec];
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) b.v[k] = __float2bfloat16(0.f);
  }
  Vec8 o;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float ab = msr::to_float(msr::from_float<__nv_bfloat16>(
        msr::to_float(a.v[k]) + msr::to_float(b.v[k])));
    o.v[k] = msr::from_float<__nv_bfloat16>(ab + msr::to_float(c.v[k]));
  }
  y[i] = o;
}

}  // namespace

// x, y: (rows, lanes) bf16, row-major. Each returns cudaGetLastError().
extern "C" int msr_probe_copy(const void* x, void* y, int rows, int lanes,
                              void* stream) {
  const long long n_vec = static_cast<long long>(rows) * (lanes / 8);
  if (n_vec == 0) return 0;
  copy_kernel<<<blocks_for(n_vec), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y), n_vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int msr_probe_roll32(const void* x, void* y, int rows, int lanes,
                                void* stream) {
  const long long n_vec = static_cast<long long>(rows) * (lanes / 8);
  if (n_vec == 0) return 0;
  roll32_kernel<<<blocks_for(n_vec), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y), n_vec, lanes / 8);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int msr_probe_taps3(const void* x, void* y, int rows, int lanes,
                               void* stream) {
  const long long n_vec = static_cast<long long>(rows) * (lanes / 8);
  if (n_vec == 0) return 0;
  taps3_kernel<<<blocks_for(n_vec), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Vec8*>(x), static_cast<Vec8*>(y), n_vec, lanes / 8);
  return static_cast<int>(cudaGetLastError());
}
